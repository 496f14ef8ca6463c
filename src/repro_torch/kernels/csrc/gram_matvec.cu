// The Gram product X^T (X V) for Hopper (sm_90a): kernel K5.
//
// Replaces the Pallas kernel repro/kernels/gram_matvec.py::gram_matvec
// (_gram_kernel).  The TPU kernel streams row blocks of X through VMEM on a
// sequential grid, forms P = X_b V on the MXU and accumulates X_b^T P into
// one [d, k] scratch carried across grid steps.  Blocks do not run in order
// on the H100, so the carry becomes two passes:
//
//   1. gram_partial_kernel: one block per (group, chunk of kGramChunk rows).
//      The chunk is staged kGramTile rows at a time in shared memory; the
//      block forms X_t V ([rows, k]) in shared memory, then adds X_t^T (X_t V)
//      into a [d, k] float32 accumulator in shared memory (one thread per
//      output element, rows in order), and writes the chunk's partial.
//   2. gram_reduce_kernel: one thread per (group, output element) sums the
//      chunks' partials in chunk order.
//
// No float atomics, so a run repeats its bits.  Both products are computed
// here, as the TPU kernel computes both in its body: no library GEMM.  A
// leading group dim ([B, m, d] x [d, k] -> [B, d, k]) evaluates every
// group's Gram product of the live PCA step in one launch.
//
// What bounds it on the H100: X is read once (m*d floats per group) for
// 4*m*d*k flops; at the live PCA shapes (d=64, k=3) that is 3 flops per
// byte, far below the card's ratio, so it is bound by bytes.  Every X row is
// loaded from device memory once, coalesced (rows are contiguous), and
// reused from shared memory for both products; V is staged once per block.
// Above 48 KB of shared memory (large d*k) the entry point opts in to
// dynamic shared memory up to the SM's 227 KB.
// Every entry point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGramThreads = 256;
constexpr int kGramTile = 32;    // rows staged in shared memory at a time
constexpr int kGramChunk = 128;  // rows per block (one partial per chunk)
constexpr int kReduceThreads = 256;

__global__ void gram_partial_kernel(const float* __restrict__ x,
                                    const float* __restrict__ v,
                                    float* __restrict__ partial, int64_t m,
                                    int d, int k, int nchunks) {
  extern __shared__ float smem[];
  const int dk = d * k;
  const int ld = d + 1;  // padded row: a column read spreads over the banks
  float* vs = smem;
  float* acc = vs + dk;
  float* xs = acc + dk;
  float* xv = xs + kGramTile * ld;
  const int chunk = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int tid = threadIdx.x;
  for (int i = tid; i < dk; i += blockDim.x) {
    vs[i] = v[i];
    acc[i] = 0.f;
  }
  const int64_t r0 = (int64_t)chunk * kGramChunk;
  const int64_t left = m - r0;
  const int total = (int)(left < kGramChunk ? left : kGramChunk);
  const float* xb = x + (b * m + r0) * d;
  __syncthreads();
  for (int t0 = 0; t0 < total; t0 += kGramTile) {
    const int rows = total - t0 < kGramTile ? total - t0 : kGramTile;
    const float* src = xb + (int64_t)t0 * d;
    for (int i = tid; i < rows * d; i += blockDim.x) {
      xs[(i / d) * ld + (i % d)] = src[i];
    }
    __syncthreads();
    for (int i = tid; i < rows * k; i += blockDim.x) {
      const int r = i / k, c = i % k;
      float s = 0.f;
      for (int j = 0; j < d; ++j) s = fmaf(xs[r * ld + j], vs[j * k + c], s);
      xv[i] = s;
    }
    __syncthreads();
    for (int e = tid; e < dk; e += blockDim.x) {
      const int j = e / k, c = e % k;
      float s = acc[e];
      for (int r = 0; r < rows; ++r) s = fmaf(xs[r * ld + j], xv[r * k + c], s);
      acc[e] = s;  // each thread owns its elements: no race
    }
    __syncthreads();  // the next tile overwrites xs and xv
  }
  float* out = partial + (b * nchunks + chunk) * dk;
  for (int e = tid; e < dk; e += blockDim.x) out[e] = acc[e];
}

__global__ void gram_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ out, int nchunks,
                                   int dk, int64_t total) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int64_t b = idx / dk;
  const int e = (int)(idx % dk);
  const float* p = partial + b * nchunks * dk + e;
  float s = 0.f;
  for (int c = 0; c < nchunks; ++c) s += p[(int64_t)c * dk];
  out[idx] = s;
}

}  // namespace

extern "C" {

int dsag_gram_chunk() { return kGramChunk; }
int dsag_gram_tile() { return kGramTile; }

// x: [B, m, d] float32; v: [d, k] float32; partial: [B, nchunks, d, k]
// scratch (nchunks = ceil(m / kGramChunk)); out: [B, d, k] float32.
int dsag_gram_matvec(const float* x, const float* v, float* partial,
                     float* out, int64_t B, int64_t m, int d, int k,
                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int nchunks = (int)((m + kGramChunk - 1) / kGramChunk);
  const int dk = d * k;
  if (B <= 0 || nchunks == 0 || dk == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)(2 * dk + kGramTile * (d + 1) + kGramTile * k) * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(gram_partial_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t s = (cudaStream_t)stream;
  gram_partial_kernel<<<dim3((unsigned)nchunks, (unsigned)B), kGramThreads, smem, s>>>(
      x, v, partial, m, d, k, nchunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t total = B * dk;
  gram_reduce_kernel<<<(unsigned)((total + kReduceThreads - 1) / kReduceThreads),
                       kReduceThreads, 0, s>>>(partial, out, nchunks, dk, total);
  return (int)cudaGetLastError();
}

}  // extern "C"
