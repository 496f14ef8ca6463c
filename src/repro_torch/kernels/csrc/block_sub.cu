// §3 block subgradients for Hopper (sm_90a): kernels K1 and K2.
//
// Replace the Pallas kernels repro/kernels/block_sub.py::logreg_block_sub
// (_logreg_kernel) and ::pca_block_sub (_pca_kernel).  The Pallas kernels run
// one program per task at a static power-of-two gather width (the
// width_bucket ladder that keeps XLA's reductions bit-stable) and mask the pad
// rows.  Here each task's blocks loop over exactly `width` rows starting at
// row start-1, so pad rows never exist and every task of a call is evaluated
// in one launch from its own (start, width).
//
// What bounds them on the H100: both read each window row once (d floats) and
// do O(d) (K1) or O(d*k) (K2) flops per row, far below the card's ratio of
// flops to bytes, so both are bound by bytes.  What keeps them from it is how
// many SMs a call fills.  At the sweep's grid shapes the windows are short
// (16-17 rows for logreg, 200 rows for PCA) and a call has hundreds of tasks,
// so one block per task fills the card.  A coded call has a handful of
// full-width tasks (logreg: 10 of 16384 rows; PCA: 4 of 50000): one block per
// task would stream them on 4-10 of 132 SMs, latency-bound.  So both kernels
// spread a task wider than one slab (kLogregSlab, kPcaSlab rows) over
// ceil(width / slab) blocks (grid (G, slabs); the slab count comes from the
// caller's static widest window, never from a device read): each block writes
// its slab's partial and slab_reduce_kernel sums each task's partials in slab
// order.  Where every task fits one slab the launch stays one pass.
//
// K1's block is sized from the same static width: one warp for windows of at
// most 32 rows (the grid call's 16-17), up to kLogregMaxWarps otherwise (as
// many as the 48 KB of shared memory allow: 8 at d = 29), so that a full
// slab is one 32-row pass per warp with every warp's loads in flight at once.
// A warp takes 32 consecutive rows at a time: it stages them in its own
// shared-memory slice with loads that walk each row's contiguous floats
// (coalesced), lane r forms row r's dot and coefficient c_r, and every lane
// adds c_r * x_r over its features (lane + 32*o) into registers, rows in
// order.  The warps' sums meet once, in warp order, in shared memory.
//
// Widths past these kernels' caps (K1: d > 96; K2: d*k > 1024 or more than
// 48 KB of shared memory) take the wide path of rows_wide.cuh, two passes
// with no cap on d or k; the wrappers choose the path from the shapes.
//
// Reductions run in a fixed order (no float atomics), so a run repeats its
// bits.  Every entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "rows_wide.cuh"

namespace {

constexpr int kLogregMaxWarps = 8;  // a full slab: one 32-row pass per warp
constexpr int kLogregMaxOut = 3;     // features per lane: d <= 96
constexpr int kLogregSlab = 256;     // window rows per block of a wide task
constexpr int kPcaThreads = 256;
constexpr int kPcaChunk = 64;        // window rows staged in shared memory
constexpr int kPcaMaxOut = 4;        // outputs per thread: d*k <= 1024
constexpr int kPcaSlab = 512;        // window rows per block of a wide task

// K1: -sum_r x_r * (y_r * sigmoid(-y_r * <x_r, v_g>)) / n over the rows of
// slab `slab` of task g's window (the last slab takes the window's rest).
// One slab: the block writes the result to out[g]; several: the slab's sum
// (without -1/n) to partial[g][slab].  Shared memory: v [d], then one slice
// of 32 rows x (d | 1) floats per warp (an odd row pitch keeps lane r's walk
// along its row free of bank conflicts).
__global__ void logreg_block_sub_kernel(
    const float* __restrict__ X, const float* __restrict__ y,
    const float* __restrict__ Vb, const int64_t* __restrict__ starts,
    const int64_t* __restrict__ widths, float* __restrict__ partial,
    float* __restrict__ out, int64_t n, int d, int slabs) {
  extern __shared__ float smem[];
  const int ld = d | 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  float* v = smem;
  float* xs = smem + d + warp * 32 * ld;
  const int g = blockIdx.x;
  const int slab = blockIdx.y;
  for (int j = threadIdx.x; j < d; j += blockDim.x) v[j] = Vb[(int64_t)g * d + j];
  const int64_t row0 = starts[g] - 1;
  int64_t width = widths[g];
  if (row0 < 0) width = 0;                          // caller bug: no reads
  if (row0 + width > n) width = n - row0;           // stay inside X
  const int64_t begin = (int64_t)slab * kLogregSlab;
  const int64_t slab_end = slab == slabs - 1 ? width : begin + kLogregSlab;
  const int64_t end = slab_end < width ? slab_end : width;
  float acc[kLogregMaxOut];
#pragma unroll
  for (int o = 0; o < kLogregMaxOut; ++o) acc[o] = 0.f;
  __syncthreads();
  for (int64_t c0 = begin + 32 * warp; c0 < end; c0 += 32 * nwarps) {
    const int rows = (int)(end - c0 < 32 ? end - c0 : 32);
    const float* src = X + (row0 + c0) * d;
    for (int j = lane; j < ld; j += 32) {  // rows' floats in address order
      float buf[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) buf[r] = (r < rows && j < d) ? src[r * d + j] : 0.f;
#pragma unroll
      for (int r = 0; r < 32; ++r) xs[r * ld + j] = buf[r];
    }
    __syncwarp();
    float c = 0.f;
    if (lane < rows) {
      const float* x = xs + lane * ld;
      float dot = 0.f;
      for (int j = 0; j < d; ++j) dot = fmaf(x[j], v[j], dot);
      const float yr = y[row0 + c0 + lane];
      const float s = 1.f / (1.f + expf(yr * dot));  // sigmoid(-z), z = y<x,v>
      c = yr * s;
    }
    for (int r = 0; r < rows; ++r) {
      const float cr = __shfl_sync(0xffffffffu, c, r);
#pragma unroll
      for (int o = 0; o < kLogregMaxOut; ++o) {
        const int j = lane + 32 * o;
        if (j < d) acc[o] = fmaf(xs[r * ld + j], cr, acc[o]);
      }
    }
    __syncwarp();  // the next rows overwrite xs
  }
  float* dst = slabs == 1 ? nullptr : partial + ((int64_t)g * slabs + slab) * d;
  const float nf = (float)n;
  if (nwarps == 1) {
#pragma unroll
    for (int o = 0; o < kLogregMaxOut; ++o) {
      const int j = lane + 32 * o;
      if (j >= d) continue;
      if (dst == nullptr)
        out[(int64_t)g * d + j] = -acc[o] / nf;
      else
        dst[j] = acc[o];
    }
    return;
  }
  __syncthreads();  // every warp is done with its slice: reuse it for the sums
  float* red = smem + d;  // [nwarps][d]
#pragma unroll
  for (int o = 0; o < kLogregMaxOut; ++o) {
    const int j = lane + 32 * o;
    if (j < d) red[warp * d + j] = acc[o];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    float s = red[j];
    for (int w = 1; w < nwarps; ++w) s += red[w * d + j];
    if (dst == nullptr)
      out[(int64_t)g * d + j] = -s / nf;
    else
      dst[j] = s;  // empty slabs write 0
  }
}

// K2: -X_b^T (X_b V_g) over rows [slab * kPcaSlab, end) of task g's window
// (end = the window's end for the last slab), streamed in chunks of kPcaChunk
// rows.  Per chunk: stage the rows (contiguous in X, so the load is
// coalesced), form X_b V ([rows, k]) in shared memory, then accumulate
// X_b^T (X_b V) into [d, k] with one thread per output element, in row order.
// One slab: the block writes -acc to out[g]; several: acc to
// partial[g][slab].  Shared memory: V [d*k], rows [kPcaChunk][d+1] (padded
// against bank conflicts), X_b V [kPcaChunk][k].
__global__ void pca_block_sub_kernel(
    const float* __restrict__ X, const float* __restrict__ Vb,
    const int64_t* __restrict__ starts, const int64_t* __restrict__ widths,
    float* __restrict__ partial, float* __restrict__ out, int64_t n, int d,
    int k, int slabs) {
  extern __shared__ float smem[];
  const int dk = d * k;
  const int ld = d + 1;
  float* v = smem;
  float* xs = v + dk;
  float* xv = xs + kPcaChunk * ld;
  const int g = blockIdx.x;
  const int slab = blockIdx.y;
  const int tid = threadIdx.x;
  for (int i = tid; i < dk; i += blockDim.x) v[i] = Vb[(int64_t)g * dk + i];
  float acc[kPcaMaxOut];
#pragma unroll
  for (int o = 0; o < kPcaMaxOut; ++o) acc[o] = 0.f;
  const int64_t row0 = starts[g] - 1;
  int64_t width = widths[g];
  if (row0 < 0) width = 0;
  if (row0 + width > n) width = n - row0;
  const int64_t begin = (int64_t)slab * kPcaSlab;
  const int64_t slab_end = slab == slabs - 1 ? width : begin + kPcaSlab;
  const int64_t end = slab_end < width ? slab_end : width;
  __syncthreads();
  for (int64_t c0 = begin; c0 < end; c0 += kPcaChunk) {
    const int rows = (int)(end - c0 < kPcaChunk ? end - c0 : kPcaChunk);
    const float* src = X + (row0 + c0) * d;
    for (int i = tid; i < rows * d; i += blockDim.x) {
      xs[(i / d) * ld + (i % d)] = src[i];
    }
    __syncthreads();
    for (int i = tid; i < rows * k; i += blockDim.x) {
      const int r = i / k, c = i % k;
      float s = 0.f;
      for (int j = 0; j < d; ++j) s = fmaf(xs[r * ld + j], v[j * k + c], s);
      xv[i] = s;
    }
    __syncthreads();
#pragma unroll
    for (int o = 0; o < kPcaMaxOut; ++o) {
      const int e = tid + o * blockDim.x;
      if (e < dk) {
        const int j = e / k, c = e % k;
        float s = acc[o];
        for (int r = 0; r < rows; ++r) s = fmaf(xs[r * ld + j], xv[r * k + c], s);
        acc[o] = s;
      }
    }
    __syncthreads();  // the next chunk overwrites xs and xv
  }
#pragma unroll
  for (int o = 0; o < kPcaMaxOut; ++o) {
    const int e = tid + o * blockDim.x;
    if (e >= dk) continue;
    if (slabs == 1)
      out[(int64_t)g * dk + e] = -acc[o];
    else
      partial[((int64_t)g * slabs + slab) * dk + e] = acc[o];  // empty slabs write 0
  }
}

}  // namespace

extern "C" {

// Limits the wrappers check before launching (shared memory stays under the
// 48 KB a block gets without opting in).
int dsag_logreg_max_warps() { return kLogregMaxWarps; }
int dsag_logreg_max_out() { return kLogregMaxOut; }
int dsag_logreg_slab() { return kLogregSlab; }
int dsag_pca_threads() { return kPcaThreads; }
int dsag_pca_chunk() { return kPcaChunk; }
int dsag_pca_max_out() { return kPcaMaxOut; }
int dsag_pca_slab() { return kPcaSlab; }
int dsag_wide_slab() { return kWideSlab; }

// slabs = ceil(widest window / kLogregSlab) >= 1, at most 65535; warps in
// 1..kLogregMaxWarps; partial: [G, slabs, d] scratch when slabs > 1 (unused,
// may be null, otherwise)
int dsag_logreg_block_sub(const float* X, const float* y, const float* Vb,
                          const int64_t* starts, const int64_t* widths,
                          float* partial, float* out, int64_t G, int64_t n, int d,
                          int slabs, int warps, int device, void* stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)(d + warps * 32 * (d | 1)) * sizeof(float);
  if (slabs < 1 || (slabs > 1 && partial == nullptr) || warps < 1 ||
      warps > kLogregMaxWarps || d > 32 * kLogregMaxOut || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  logreg_block_sub_kernel<<<dim3((unsigned)G, (unsigned)slabs), 32 * warps, smem, s>>>(
      X, y, Vb, starts, widths, partial, out, n, d, slabs);
  err = cudaGetLastError();
  if (err != cudaSuccess || slabs == 1) return (int)err;
  return (int)reduce_slabs(partial, out, G, d, slabs, -1.f, (float)n, s);
}

// slabs = ceil(widest window / kPcaSlab) >= 1, at most 65535; partial:
// [G, slabs, d, k] scratch when slabs > 1 (unused, may be null, otherwise)
int dsag_pca_block_sub(const float* X, const float* Vb, const int64_t* starts,
                       const int64_t* widths, float* partial, float* out,
                       int64_t G, int64_t n, int d, int k, int slabs,
                       int device, void* stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return (int)err;
  if (slabs < 1 || (slabs > 1 && partial == nullptr)) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(d * k + kPcaChunk * (d + 1) + kPcaChunk * k) * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  pca_block_sub_kernel<<<dim3((unsigned)G, (unsigned)slabs), kPcaThreads, smem, s>>>(
      X, Vb, starts, widths, partial, out, n, d, k, slabs);
  err = cudaGetLastError();
  if (err != cudaSuccess || slabs == 1) return (int)err;
  return (int)reduce_slabs(partial, out, G, (int64_t)d * k, slabs, -1.f, 1.f, s);
}

// The wide path (rows_wide.cuh) of K1 (logreg = 1: k = 1, V = Vb [G, d],
// out = -sum / n) and K2 (logreg = 0: V = Vb [G, d, k], out = -sum), for any d
// and k.  W: the static widest window; scratch: [G, W, k] floats; slabs =
// ceil(W / slab_rows) <= 65535; partial: [G, slabs, d, k] scratch when slabs
// > 1 (may be null otherwise).
int dsag_wide_block_sub(const float* X, const float* y, const float* Vb, const int64_t* starts,
                        const int64_t* widths, float* scratch, float* partial, float* out,
                        int64_t G, int64_t n, int d, int k, int64_t W, int slabs,
                        int64_t slab_rows, int logreg, int device, void* stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_wide(X, y, Vb, (int64_t)d * k, starts, widths, scratch, partial, out, G,
                         n, 0, d, k, W, slabs, slab_rows, logreg != 0, -1.f,
                         logreg ? (float)n : 1.f, (cudaStream_t)stream);
}

const char* dsag_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
