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
// order on the H100, so the group loop moves inside the thread: one thread
// owns one element j, keeps acc in a register and walks the groups in order,
// which is the reference's accumulation order (h first, then groups 0..p-1).
//
// What bounds it on the H100: per element it reads g and c once per group
// and h once, and writes c once per group and h once, doing 6 flops per
// (group, element): far below the card's flop-to-byte ratio, so it is bound
// by bytes.  Neighbouring threads own neighbouring elements, so every load
// and store of a group row is coalesced, and nothing is read twice.
// With many groups and few elements (the live logreg step: p=100, n=29) the
// walk is latency-bound instead: 29 threads, each a chain of 100 dependent
// group steps.  Staging the group rows in shared memory in parallel before
// the in-order walk would cut that; it is left for a later change.
//
// Exactness: the arithmetic is written with __fmul_rn / __fadd_rn /
// __fsub_rn, so nvcc contracts nothing into an FMA and every operator
// rounds once, as the eager plain version (kernels/dsag_update.py) does;
// the two are bit-equal.  bf16 slots are widened exactly and written back
// with __float2bfloat16_rn (round to nearest even, as torch's .to()).
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDsagThreads = 256;

__device__ __forceinline__ float load_f32(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, int64_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <typename GT, typename CT>
__global__ void dsag_cache_update_kernel(
    const GT* __restrict__ g, const CT* __restrict__ c,
    const float* __restrict__ h, const float* __restrict__ mask,
    CT* __restrict__ new_c, float* __restrict__ new_h, int64_t p, int64_t n) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  float acc = h[j];
  for (int64_t i = 0; i < p; ++i) {
    const int64_t at = i * n + j;
    const float m = mask[i];
    const float gi = load_f32(g, at);
    const float ci = load_f32(c, at);
    const float nv = __fadd_rn(__fmul_rn(m, gi), __fmul_rn(__fsub_rn(1.f, m), ci));
    acc = __fadd_rn(acc, __fsub_rn(nv, ci));
    store_f32(new_c, at, nv);
  }
  new_h[j] = acc;
}

template <typename GT, typename CT>
cudaError_t launch(const void* g, const void* c, const float* h,
                   const float* mask, void* new_c, float* new_h, int64_t p,
                   int64_t n, cudaStream_t stream) {
  const int64_t blocks = (n + kDsagThreads - 1) / kDsagThreads;
  dsag_cache_update_kernel<GT, CT><<<(unsigned)blocks, kDsagThreads, 0, stream>>>(
      (const GT*)g, (const CT*)c, h, mask, (CT*)new_c, new_h, p, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// g, c: [p, n] (float32 or bfloat16: g_bf16 / c_bf16 = 1 for bfloat16);
// h: [n] float32; mask: [p] float32 0/1; new_c like c; new_h [n] float32.
int dsag_dsag_cache_update(const void* g, const void* c, const float* h,
                           const float* mask, void* new_c, float* new_h,
                           int64_t p, int64_t n, int g_bf16, int c_bf16,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (g_bf16 && c_bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(g, c, h, mask, new_c, new_h, p, n, s);
  else if (g_bf16)
    err = launch<__nv_bfloat16, float>(g, c, h, mask, new_c, new_h, p, n, s);
  else if (c_bf16)
    err = launch<float, __nv_bfloat16>(g, c, h, mask, new_c, new_h, p, n, s);
  else
    err = launch<float, float>(g, c, h, mask, new_c, new_h, p, n, s);
  return (int)err;
}

}  // extern "C"
