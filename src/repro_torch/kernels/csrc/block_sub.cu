// §3 block subgradients for Hopper (sm_90a): kernels K1 and K2.
//
// Replace the Pallas kernels repro/kernels/block_sub.py::logreg_block_sub
// (_logreg_kernel) and ::pca_block_sub (_pca_kernel).  The Pallas kernels run
// one program per task at a static power-of-two gather width (the
// width_bucket ladder that keeps XLA's reductions bit-stable) and mask the pad
// rows.  Here one block serves one task and loops over exactly `width` rows
// starting at row start-1, so pad rows never exist and every task of a call is
// evaluated in one launch from its own (start, width).
//
// What bounds them on the H100: both read each window row once (d floats) and
// do O(d) (K1) or O(d*k) (K2) flops per row, far below the card's ratio of
// flops to bytes, so both are bound by bytes.  What keeps them from it is how
// many SMs a call fills.  At the sweep's grid shapes the windows are short
// (16-17 rows for logreg, 200 rows for PCA) and a call has hundreds of tasks,
// so one block per task fills the card.  A coded call has a handful of
// full-width tasks (PCA: 4 of 50000 rows): one block per task would stream
// 50000 rows each on 4 of 132 SMs, latency-bound.  So K2 spreads a task wider
// than one slab of kPcaSlab rows over ceil(width / kPcaSlab) blocks (grid
// (G, slabs); the slab count comes from the caller's static widest window,
// never from a device read): each block writes its slab's [d, k] partial and
// pca_reduce_kernel sums each task's partials in slab order.  Where every
// task fits one slab the launch stays one pass.  K1's coded call keeps one
// block per task (a later change).
//
// Reductions run in a fixed order (per-thread partial sums, then a
// shared-memory tree; no float atomics), so a run repeats its bits.
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLogregThreads = 128;  // power of two: the tree halves it
constexpr int kPcaThreads = 256;
constexpr int kPcaChunk = 64;        // window rows staged in shared memory
constexpr int kPcaMaxOut = 4;        // outputs per thread: d*k <= 1024
constexpr int kPcaSlab = 512;        // window rows per block of a wide task
constexpr int kReduceThreads = 256;

// K1: out[g] = -sum_r x_r * (y_r * sigmoid(-y_r * <x_r, v_g>)) / n over the
// rows r of task g's window.  Shared memory: v [d], partials [threads][d].
__global__ void logreg_block_sub_kernel(
    const float* __restrict__ X, const float* __restrict__ y,
    const float* __restrict__ Vb, const int64_t* __restrict__ starts,
    const int64_t* __restrict__ widths, float* __restrict__ out, int64_t n,
    int d) {
  extern __shared__ float smem[];
  float* v = smem;
  float* part = smem + d;
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  for (int j = tid; j < d; j += blockDim.x) v[j] = Vb[(int64_t)g * d + j];
  float* mine = part + tid * d;  // odd d: threads hit distinct banks
  for (int j = 0; j < d; ++j) mine[j] = 0.f;
  __syncthreads();
  const int64_t row0 = starts[g] - 1;
  int64_t width = widths[g];
  if (row0 < 0) width = 0;                          // caller bug: no reads
  if (row0 + width > n) width = n - row0;           // stay inside X
  for (int64_t r = tid; r < width; r += blockDim.x) {
    const float* x = X + (row0 + r) * d;
    float dot = 0.f;
    for (int j = 0; j < d; ++j) dot = fmaf(x[j], v[j], dot);
    const float yr = y[row0 + r];
    const float s = 1.f / (1.f + expf(yr * dot));  // sigmoid(-z), z = y<x,v>
    const float c = yr * s;
    for (int j = 0; j < d; ++j) mine[j] = fmaf(x[j], c, mine[j]);
  }
  __syncthreads();
  for (int stride = blockDim.x / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
      const float* other = part + (tid + stride) * d;
      for (int j = 0; j < d; ++j) mine[j] += other[j];
    }
    __syncthreads();
  }
  const float nf = (float)n;
  for (int j = tid; j < d; j += blockDim.x) {
    out[(int64_t)g * d + j] = -part[j] / nf;
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

// out[g] = -sum over slabs of partial[g][slab], in slab order: one thread per
// (task, output element), no float atomics
__global__ void pca_reduce_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, int slabs, int dk,
                                  int64_t total) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int64_t g = idx / dk;
  const int e = (int)(idx % dk);
  const float* p = partial + g * slabs * dk + e;
  float s = 0.f;
  for (int sl = 0; sl < slabs; ++sl) s += p[(int64_t)sl * dk];
  out[idx] = -s;
}

}  // namespace

extern "C" {

// Limits the wrappers check before launching (shared memory stays under the
// 48 KB a block gets without opting in).
int dsag_logreg_threads() { return kLogregThreads; }
int dsag_pca_threads() { return kPcaThreads; }
int dsag_pca_chunk() { return kPcaChunk; }
int dsag_pca_max_out() { return kPcaMaxOut; }
int dsag_pca_slab() { return kPcaSlab; }

int dsag_logreg_block_sub(const float* X, const float* y, const float* Vb,
                          const int64_t* starts, const int64_t* widths,
                          float* out, int64_t G, int64_t n, int d, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)(kLogregThreads + 1) * d * sizeof(float);
  logreg_block_sub_kernel<<<(unsigned)G, kLogregThreads, smem,
                            (cudaStream_t)stream>>>(X, y, Vb, starts, widths,
                                                    out, n, d);
  return (int)cudaGetLastError();
}

// slabs = ceil(widest window / kPcaSlab) >= 1, at most 65535; partial:
// [G, slabs, d, k] scratch when slabs > 1 (unused, may be null, otherwise)
int dsag_pca_block_sub(const float* X, const float* Vb, const int64_t* starts,
                       const int64_t* widths, float* partial, float* out,
                       int64_t G, int64_t n, int d, int k, int slabs,
                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (slabs < 1 || (slabs > 1 && partial == nullptr)) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(d * k + kPcaChunk * (d + 1) + kPcaChunk * k) * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  pca_block_sub_kernel<<<dim3((unsigned)G, (unsigned)slabs), kPcaThreads, smem, s>>>(
      X, Vb, starts, widths, partial, out, n, d, k, slabs);
  err = cudaGetLastError();
  if (err != cudaSuccess || slabs == 1) return (int)err;
  const int64_t total = G * d * k;
  pca_reduce_kernel<<<(unsigned)((total + kReduceThreads - 1) / kReduceThreads),
                      kReduceThreads, 0, s>>>(partial, out, slabs, d * k, total);
  return (int)cudaGetLastError();
}

const char* dsag_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
