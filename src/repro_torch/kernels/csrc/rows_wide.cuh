// The wide path of K1, K2 and K5 for Hopper (sm_90a): any feature width d
// and any column count k.
//
// The fast paths (block_sub.cu, gram_matvec.cu) keep a task's whole [d] or
// [d, k] share in registers or shared memory, which caps d and k.  All three
// products separate into a pass over rows, which needs all of d, and a pass
// over features, which needs all of the rows:
//
//   K1:      c_r = y_r * sigmoid(-y_r * <x_r, v>),   then  -sum_r c_r x_r / n
//   K2, K5:  P = X_b V ([rows, k]),                  then  (-) X_b^T P
//
// so the wide path runs them as two launches:
//
//   wide_row_kernel: one warp per window row forms c_r (K1) or P_r (K2, K5),
//   streaming the row's d floats in lane order (coalesced) against the
//   columns of V in chunks of kWideCols, and sums the lanes with a
//   __shfl_xor_sync butterfly (a fixed order).  The results go to a
//   [G, W, k] scratch, W the caller's static widest window.
//
//   wide_feature_kernel: a grid over (task, feature tile, column chunk) x
//   slab; each thread owns one feature and kWideCols columns in registers and
//   adds x_r[f] * P_r[c] over its slab's rows in row order (the block's
//   reads of a row are one coalesced range; P_r is the same address for
//   every thread).  One slab writes the result; several write partials that
//   slab_reduce_kernel sums in slab order.
//
// k columns split exactly into independent chunks of V, because
// X^T (X V[:, J]) = (X^T X V)[:, J].  No float atomics: a run repeats its
// bits.  Both passes read X once per pass, so the path is bound by bytes (2x
// the fast paths' reads); it exists so that every width the reference runs
// also runs here, not for speed.  A task is a window [start-1, start-1+width)
// of X (K1, K2), or, with starts == nullptr, the g-th run of m rows (K5's
// leading group dim).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// internal linkage: block_sub.cu and gram_matvec.cu each include this file
namespace {

constexpr int kWideSlab = 256;     // rows per slab (more where a window needs > 65535 slabs)
constexpr int kWideRowWarps = 8;   // rows per row-pass block, one warp each
constexpr int kWideTile = 128;     // features per feature-pass block, one per thread
constexpr int kWideCols = 8;       // columns of V per pass over a row
constexpr int kReduceThreads = 256;

struct Window {
  int64_t row0, width;
};

// task g's rows: the caller's (start, width), clipped to X as the fast paths
// clip them and to the W rows the scratch holds (the plain versions' pad
// width: they drop rows past it too), or the g-th run of m rows
__device__ __forceinline__ Window task_window(const int64_t* starts, const int64_t* widths,
                                              int64_t g, int64_t m, int64_t n, int64_t W) {
  Window w{starts ? starts[g] - 1 : g * m, widths ? widths[g] : m};
  if (w.row0 < 0) w.width = 0;                      // caller bug: no reads
  if (w.row0 + w.width > n) w.width = n - w.row0;   // stay inside X
  if (w.width > W) w.width = W;
  if (w.width < 0) w.width = 0;
  return w;
}

// scratch[(g*W + r)*k + c] = <x_r, V_g[:, c]>, or (kLogreg, k = 1)
// scratch[g*W + r] = y_r * sigmoid(-y_r <x_r, v_g>), for the rows r < width
// of task g's window.  V_g = V + g * v_stride ([d, k] row-major).
template <bool kLogreg>
__global__ void __launch_bounds__(32 * kWideRowWarps)
wide_row_kernel(const float* __restrict__ X, const float* __restrict__ y,
                const float* __restrict__ V, int64_t v_stride,
                const int64_t* __restrict__ starts, const int64_t* __restrict__ widths,
                float* __restrict__ scratch, int64_t n, int64_t m, int d, int k, int64_t W,
                int64_t row_blocks) {
  constexpr int KC = kLogreg ? 1 : kWideCols;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t g = blockIdx.x / row_blocks;
  const int64_t r = (blockIdx.x % row_blocks) * kWideRowWarps + warp;
  const Window win = task_window(starts, widths, g, m, n, W);
  if (r >= win.width) return;  // the whole warp leaves together
  const float* x = X + (win.row0 + r) * d;
  const float* v = V + g * v_stride;
  float* dst = scratch + (g * W + r) * k;
  for (int c0 = 0; c0 < k; c0 += KC) {
    float acc[KC];
#pragma unroll
    for (int c = 0; c < KC; ++c) acc[c] = 0.f;
    for (int j = lane; j < d; j += 32) {
      const float xj = x[j];
      const float* vj = v + (int64_t)j * k + c0;
#pragma unroll
      for (int c = 0; c < KC; ++c)
        if (c0 + c < k) acc[c] = fmaf(xj, vj[c], acc[c]);
    }
#pragma unroll
    for (int c = 0; c < KC; ++c)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
    if (lane == 0) {
      if (kLogreg) {
        const float yr = y[win.row0 + r];
        const float s = 1.f / (1.f + expf(yr * acc[0]));  // sigmoid(-z), z = y<x,v>
        dst[0] = yr * s;
      } else {
#pragma unroll
        for (int c = 0; c < KC; ++c)
          if (c0 + c < k) dst[c0 + c] = acc[c];
      }
    }
  }
}

// out[g][f][c] = sign * sum_r x_r[f] * P_r[c] / div over the rows of slab
// `slab` (slab_rows each, the last takes the window's rest), or the slab's
// sum to partial[g][slab][f][c] where there are several slabs.
template <int KC>
__global__ void __launch_bounds__(kWideTile)
wide_feature_kernel(const float* __restrict__ X, const float* __restrict__ scratch,
                    const int64_t* __restrict__ starts, const int64_t* __restrict__ widths,
                    float* __restrict__ partial, float* __restrict__ out, int64_t n, int64_t m,
                    int d, int k, int64_t W, int slabs, int64_t slab_rows, int ftiles,
                    int cchunks, float sign, float div) {
  const int64_t bx = blockIdx.x;
  const int cc = (int)(bx % cchunks);
  const int64_t rest = bx / cchunks;
  const int ft = (int)(rest % ftiles);
  const int64_t g = rest / ftiles;
  const int slab = blockIdx.y;
  const int f = ft * kWideTile + threadIdx.x;
  const int c0 = cc * KC;
  if (f >= d) return;
  const Window win = task_window(starts, widths, g, m, n, W);
  const int64_t begin = (int64_t)slab * slab_rows;
  int64_t end = slab == slabs - 1 ? win.width : begin + slab_rows;
  if (end > win.width) end = win.width;
  float acc[KC];
#pragma unroll
  for (int c = 0; c < KC; ++c) acc[c] = 0.f;
  const float* x = X + win.row0 * d + f;
  const float* p = scratch + g * W * k + c0;
#pragma unroll 4
  for (int64_t r = begin; r < end; ++r) {
    const float xr = x[r * d];
    const float* pr = p + r * k;
#pragma unroll
    for (int c = 0; c < KC; ++c)
      if (c0 + c < k) acc[c] = fmaf(xr, pr[c], acc[c]);
  }
  const int64_t dk = (int64_t)d * k;
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    if (c0 + c >= k) continue;
    const int64_t e = (int64_t)f * k + c0 + c;
    if (slabs == 1)
      out[g * dk + e] = sign * acc[c] / div;
    else
      partial[(g * slabs + slab) * dk + e] = acc[c];  // empty slabs write 0
  }
}

// out[g] = sign * (sum over slabs of partial[g][slab]) / div, in slab order:
// one thread per (task, output element), no float atomics.  sign * s is an
// exact negation or copy, so sign = -1 gives the bits of -s / div.
__global__ void slab_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                   int slabs, int64_t dk, int64_t total, float sign, float div) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int64_t g = idx / dk;
  const int64_t e = idx % dk;
  const float* p = partial + g * slabs * dk + e;
  float s = 0.f;
  for (int sl = 0; sl < slabs; ++sl) s += p[(int64_t)sl * dk];
  out[idx] = sign * s / div;
}

inline cudaError_t reduce_slabs(const float* partial, float* out, int64_t G, int64_t dk,
                                int slabs, float sign, float div, cudaStream_t s) {
  const int64_t total = G * dk;
  slab_reduce_kernel<<<(unsigned)((total + kReduceThreads - 1) / kReduceThreads),
                       kReduceThreads, 0, s>>>(partial, out, slabs, dk, total, sign, div);
  return cudaGetLastError();
}

// The wide path's launches: the row pass into scratch ([G, W, k]), the
// feature pass, and the slab reduce where slabs > 1 (partial: [G, slabs, d, k]).
inline cudaError_t launch_wide(const float* X, const float* y, const float* V, int64_t v_stride,
                               const int64_t* starts, const int64_t* widths, float* scratch,
                               float* partial, float* out, int64_t G, int64_t n, int64_t m,
                               int d, int k, int64_t W, int slabs, int64_t slab_rows,
                               bool logreg, float sign, float div, cudaStream_t s) {
  if (G <= 0 || W <= 0 || d <= 0 || k <= 0) return cudaGetLastError();
  if (slabs < 1 || slabs > 65535 || slab_rows < 1 || scratch == nullptr ||
      (slabs > 1 && partial == nullptr) || (logreg && k != 1))
    return cudaErrorInvalidValue;
  const int64_t row_blocks = (W + kWideRowWarps - 1) / kWideRowWarps;
  const int ftiles = (d + kWideTile - 1) / kWideTile;
  const int cchunks = logreg ? 1 : (k + kWideCols - 1) / kWideCols;
  const int64_t row_grid = G * row_blocks, feat_grid = G * ftiles * cchunks;
  if (row_grid > 0x7fffffff || feat_grid > 0x7fffffff) return cudaErrorInvalidValue;
  if (logreg)
    wide_row_kernel<true><<<(unsigned)row_grid, 32 * kWideRowWarps, 0, s>>>(
        X, y, V, v_stride, starts, widths, scratch, n, m, d, k, W, row_blocks);
  else
    wide_row_kernel<false><<<(unsigned)row_grid, 32 * kWideRowWarps, 0, s>>>(
        X, y, V, v_stride, starts, widths, scratch, n, m, d, k, W, row_blocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)feat_grid, (unsigned)slabs);
  if (logreg)
    wide_feature_kernel<1><<<grid, kWideTile, 0, s>>>(X, scratch, starts, widths, partial, out,
                                                      n, m, d, k, W, slabs, slab_rows, ftiles,
                                                      cchunks, sign, div);
  else
    wide_feature_kernel<kWideCols><<<grid, kWideTile, 0, s>>>(
        X, scratch, starts, widths, partial, out, n, m, d, k, W, slabs, slab_rows, ftiles,
        cchunks, sign, div);
  err = cudaGetLastError();
  if (err != cudaSuccess || slabs == 1) return err;
  return reduce_slabs(partial, out, G, (int64_t)d * k, slabs, sign, div, s);
}

}  // namespace
