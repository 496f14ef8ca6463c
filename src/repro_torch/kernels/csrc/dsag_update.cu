// The fused DSAG cache update for Hopper (sm_90a): kernel K4.
//
// Replaces the Pallas kernel repro/kernels/dsag_update.py::dsag_cache_update
// (_dsag_kernel).  Per element j of the flattened parameter,
//
//     acc = h[j];  for i = 0 .. p-1:  new = m_i*g_ij + (1-m_i)*c_ij,
//                                     acc += new - c_ij,  c_ij <- new
//     h[j] = acc
//
// The TPU kernel runs a (blocks, groups) grid with the group dim innermost
// and carries the h block in VMEM scratch across it.  Blocks do not run in
// order on the H100, so the carry moves inside a block.  Only the h chain
// is sequential; every new c_ij and every difference new - c_ij is
// independent of the others.  Two shapes of launch:
//
//   dsag_staged_kernel (few elements, many groups: the live steps' [100, 29],
//   [50, 192], [8, 29]): a block takes 32 columns and walks the groups in
//   chunks of kChunk.  Its 8 warps load the chunk's rows of g and c (each
//   warp a row at a time, coalesced along n), form new and new - c for every
//   element at once, store new_c and stage the differences in shared
//   memory; then one thread per column adds them to acc in group order.
//   A thread walking 100 groups of dependent global reads becomes 13 rows
//   of independent loads per warp and a chain of 100 shared-memory adds.
//
//   dsag_stream_kernel (from 132 * 256 elements, enough threads to fill
//   the card: the p=8, n=2^20 bf16 shape; the wrapper chooses): one thread per element walks the
//   groups, every load and store of a group row coalesced, nothing read
//   twice.  It is bound by bytes, and staging would only add shared-memory
//   traffic.
//
// What bounds it on the H100: bytes (each g and c read once, c written
// once, 6 flops per element and group); at the live shapes, latency.
//
// Exactness: the arithmetic is written with __fmul_rn / __fadd_rn /
// __fsub_rn, so nvcc contracts nothing into an FMA and every operator
// rounds once, as the eager plain version (kernels/dsag_update.py) does, and
// both kernels add the differences to h in group order: bit-equal to it.
// bf16 slots are widened exactly and written back with __float2bfloat16_rn
// (round to nearest even, as torch's .to()).  Every entry point returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileN = 32;                      // columns per staged block
constexpr int kRowsPerPass = kThreads / kTileN;  // group rows loaded at once
constexpr int kChunk = 256;                     // groups staged at a time: 32 KB

__device__ __forceinline__ float load_f32(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// new = m*g + (1-m)*c, each operator rounded once
__device__ __forceinline__ float blend(float m, float gi, float ci) {
  return __fadd_rn(__fmul_rn(m, gi), __fmul_rn(__fsub_rn(1.f, m), ci));
}

template <typename GT, typename CT>
__global__ void __launch_bounds__(kThreads) dsag_staged_kernel(
    const GT* __restrict__ g, const CT* __restrict__ c, const float* __restrict__ h,
    const float* __restrict__ mask, CT* __restrict__ new_c, float* __restrict__ new_h,
    int64_t p, int64_t n) {
  __shared__ float diff[kChunk][kTileN];
  const int tx = threadIdx.x % kTileN, ty = threadIdx.x / kTileN;
  const int64_t j = (int64_t)blockIdx.x * kTileN + tx;
  const bool live = j < n;
  float acc = (ty == 0 && live) ? h[j] : 0.f;
  for (int64_t i0 = 0; i0 < p; i0 += kChunk) {
    const int pc = (int)(p - i0 < kChunk ? p - i0 : kChunk);
    if (live) {
#pragma unroll 4
      for (int ii = ty; ii < pc; ii += kRowsPerPass) {
        const int64_t at = (i0 + ii) * n + j;
        const float ci = load_f32(c, at);
        const float nv = blend(mask[i0 + ii], load_f32(g, at), ci);
        store_f32(new_c, at, nv);
        diff[ii][tx] = __fsub_rn(nv, ci);
      }
    }
    __syncthreads();
    if (ty == 0 && live)
      for (int ii = 0; ii < pc; ++ii) acc = __fadd_rn(acc, diff[ii][tx]);
    __syncthreads();  // the next chunk overwrites the differences
  }
  if (ty == 0 && live) new_h[j] = acc;
}

template <typename GT, typename CT>
__global__ void __launch_bounds__(kThreads) dsag_stream_kernel(
    const GT* __restrict__ g, const CT* __restrict__ c, const float* __restrict__ h,
    const float* __restrict__ mask, CT* __restrict__ new_c, float* __restrict__ new_h,
    int64_t p, int64_t n) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  float acc = h[j];
  for (int64_t i = 0; i < p; ++i) {
    const int64_t at = i * n + j;
    const float ci = load_f32(c, at);
    const float nv = blend(mask[i], load_f32(g, at), ci);
    acc = __fadd_rn(acc, __fsub_rn(nv, ci));
    store_f32(new_c, at, nv);
  }
  new_h[j] = acc;
}

template <typename GT, typename CT>
cudaError_t launch(const void* g, const void* c, const float* h, const float* mask,
                   void* new_c, float* new_h, int64_t p, int64_t n, bool streaming,
                   cudaStream_t stream) {
  if (streaming)
    dsag_stream_kernel<GT, CT><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                                 stream>>>((const GT*)g, (const CT*)c, h, mask, (CT*)new_c,
                                           new_h, p, n);
  else
    dsag_staged_kernel<GT, CT><<<(unsigned)((n + kTileN - 1) / kTileN), kThreads, 0,
                                 stream>>>((const GT*)g, (const CT*)c, h, mask, (CT*)new_c,
                                           new_h, p, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// g, c: [p, n] (float32 or bfloat16: g_bf16 / c_bf16 = 1 for bfloat16);
// h: [n] float32; mask: [p] float32 0/1; new_c like c; new_h [n] float32;
// streaming: 1 for dsag_stream_kernel, 0 for dsag_staged_kernel.
int dsag_dsag_cache_update(const void* g, const void* c, const float* h,
                           const float* mask, void* new_c, float* new_h,
                           int64_t p, int64_t n, int g_bf16, int c_bf16, int streaming,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (g_bf16 && c_bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(g, c, h, mask, new_c, new_h, p, n, streaming != 0, s);
  else if (g_bf16)
    err = launch<__nv_bfloat16, float>(g, c, h, mask, new_c, new_h, p, n, streaming != 0, s);
  else if (c_bf16)
    err = launch<float, __nv_bfloat16>(g, c, h, mask, new_c, new_h, p, n, streaming != 0, s);
  else
    err = launch<float, float>(g, c, h, mask, new_c, new_h, p, n, streaming != 0, s);
  return (int)err;
}

}  // extern "C"
