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
//
// dsag_int8_kernel: int8 slots (optim/compression.py's per-row quantized
// cache, the reference's int8 leaf update in core/dsag_pjit.py), which "the
// int8 variant dequantizes/requantizes in the same pass" of
// repro/kernels/dsag_update.py describes.  Per group i and row r of B
// elements (the parameter's last axis; one bf16 scale per row):
//
//     c, p   <- q * scale                      (dequantized, exact)
//     new    <- evict ? 0 : mask ? g : flush ? p : c
//     scale' <- absmax(new) > 0 ? absmax(new) / 127 : 1        (float32)
//     q'     <- clamp(rint(new / scale'), -127, 127); stored with bf16(scale')
//     acc    += q' * bf16(scale') - c          (the stored value's delta)
//     pend   <- take ? g : p, requantized the same way
//
// and h' = h + acc, the deltas summed over the groups in order first, as
// the reference's sum over the group axis and then + h.  Every row of every
// group is requantized, the untouched ones too, as in the reference: a
// dequantized row need not requantize to itself.  One warp per row walks
// the groups in order (so the sum keeps that order); its lanes split the
// row, absmax is a warp-shuffle max, and each lane carries its elements'
// running sums in new_h.  Rows are short on the live steps (B = 29 for
// logreg, 3 for PCA's [64, 3] iterate), so it is bound by latency.
//
// The split form, for a device mesh where a row's B elements lie on several
// ranks (a column-parallel or FSDP-split leaf) and its one scale is the
// absmax of the whole row: dsag_int8_row_max_kernel writes each (group, row)'s
// absmax of the new cache row and of the new pending row over this rank's
// shard, the caller MAX-all-reduces them over the row's ranks, and
// dsag_int8_kernel takes those maxima in place of its warp maxima.  A maximum
// is exact, so every shard quantizes as the whole row would: bit for bit the
// unsharded update, whatever the split.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

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

constexpr int kInt8Warps = 4;  // rows per block of dsag_int8_kernel

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the reference's float32 scale: absmax / 127, or 1 for an all-zero row
__device__ __forceinline__ float row_scale(float amax) {
  return amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
}

// clip(round(v / scale), -127, 127), rounding half to even as jnp.round
__device__ __forceinline__ int8_t quantize_one(float v, float scale) {
  const float r = rintf(__fdiv_rn(v, scale));
  return (int8_t)(int)fminf(fmaxf(r, -127.f), 127.f);
}

// the cache row's new value: 0 keep, 1 the gradient, 2 the pending slot, 3 zero
__device__ __forceinline__ float cache_source(int src, float gv, float cf, float pf) {
  return src == 1 ? gv : src == 2 ? pf : src == 3 ? 0.f : cf;
}

// the cache row's new value and the pending row's, from the dequantized slots
struct Int8Row {
  const float* g;
  const int8_t* cq;
  const int8_t* pq;
  float csf, psf;
  int src;
  bool take;
  __device__ __forceinline__ float cache(int64_t e, float* cf_out) const {
    const float cf = __fmul_rn((float)cq[e], csf);
    *cf_out = cf;
    return cache_source(src, g[e], cf, __fmul_rn((float)pq[e], psf));
  }
  __device__ __forceinline__ float pending(int64_t e) const {
    return take ? g[e] : __fmul_rn((float)pq[e], psf);
  }
};

__device__ __forceinline__ Int8Row int8_row(const float* g, const int8_t* cq,
                                            const __nv_bfloat16* cs, const int8_t* pq,
                                            const __nv_bfloat16* ps, uint8_t code, int64_t row,
                                            int64_t b) {
  const int64_t at = row * b;
  return Int8Row{g + at, cq + at, pq + at, __bfloat162float(cs[row]), __bfloat162float(ps[row]),
                 code & 3, ((code >> 2) & 1) != 0};
}

// this row's absmax of the new cache row and of the new pending row, over
// the lane's elements (the caller reduces over the warp)
__device__ __forceinline__ void int8_local_max(const Int8Row& w, int64_t b, int lane,
                                               float* cmax, float* pmax) {
  float cm = 0.f, pm = 0.f, cf;
  for (int64_t e = lane; e < b; e += 32) {
    cm = fmaxf(cm, fabsf(w.cache(e, &cf)));
    pm = fmaxf(pm, fabsf(w.pending(e)));
  }
  *cmax = cm;
  *pmax = pm;
}

// cmax_in / pmax_in: null, or [p, rows] float32 maxima of each whole row (the
// split form: these slots hold a shard of each row, the maxima come from
// dsag_int8_row_max_kernel on every shard, MAX-reduced across them)
__global__ void __launch_bounds__(kInt8Warps * 32) dsag_int8_kernel(
    const float* __restrict__ g, const int8_t* __restrict__ cq,
    const __nv_bfloat16* __restrict__ cs, const int8_t* __restrict__ pq,
    const __nv_bfloat16* __restrict__ ps, const float* __restrict__ h,
    const uint8_t* __restrict__ code, const float* __restrict__ cmax_in,
    const float* __restrict__ pmax_in, int8_t* __restrict__ ncq,
    __nv_bfloat16* __restrict__ ncs, int8_t* __restrict__ npq,
    __nv_bfloat16* __restrict__ nps, float* __restrict__ nh, int64_t p, int64_t rows,
    int64_t b) {
  const int lane = threadIdx.x % 32;
  const int64_t r = (int64_t)blockIdx.x * kInt8Warps + threadIdx.x / 32;
  if (r >= rows) return;
  float* acc = nh + r * b;  // each element's running sum, one lane each
  for (int64_t i = 0; i < p; ++i) {
    const int64_t row = i * rows + r, at = row * b;
    const Int8Row w = int8_row(g, cq, cs, pq, ps, code[i], row, b);
    float cmax, pmax;
    if (cmax_in != nullptr) {
      cmax = cmax_in[row];
      pmax = pmax_in[row];
    } else {
      int8_local_max(w, b, lane, &cmax, &pmax);
      cmax = warp_max(cmax);
      pmax = warp_max(pmax);
    }
    const float sc = row_scale(cmax), sp = row_scale(pmax);
    const __nv_bfloat16 sc16 = __float2bfloat16_rn(sc);
    const float scb = __bfloat162float(sc16);
    if (lane == 0) {
      ncs[row] = sc16;
      nps[row] = __float2bfloat16_rn(sp);
    }
    for (int64_t e = lane; e < b; e += 32) {
      float cf;
      const int8_t q = quantize_one(w.cache(e, &cf), sc);
      ncq[at + e] = q;
      const float d = __fsub_rn(__fmul_rn((float)q, scb), cf);
      acc[e] = __fadd_rn(i == 0 ? 0.f : acc[e], d);
      npq[at + e] = quantize_one(w.pending(e), sp);
    }
  }
  for (int64_t e = lane; e < b; e += 32) nh[r * b + e] = __fadd_rn(h[r * b + e], acc[e]);
}

// the split form's first pass: one warp per row and group writes the absmax
// of the group's new cache row and new pending row over this shard of it
__global__ void __launch_bounds__(kInt8Warps * 32) dsag_int8_row_max_kernel(
    const float* __restrict__ g, const int8_t* __restrict__ cq,
    const __nv_bfloat16* __restrict__ cs, const int8_t* __restrict__ pq,
    const __nv_bfloat16* __restrict__ ps, const uint8_t* __restrict__ code,
    float* __restrict__ cmax_out, float* __restrict__ pmax_out, int64_t p, int64_t rows,
    int64_t b) {
  const int lane = threadIdx.x % 32;
  const int64_t r = (int64_t)blockIdx.x * kInt8Warps + threadIdx.x / 32;
  if (r >= rows) return;
  for (int64_t i = 0; i < p; ++i) {
    const int64_t row = i * rows + r;
    float cmax, pmax;
    int8_local_max(int8_row(g, cq, cs, pq, ps, code[i], row, b), b, lane, &cmax, &pmax);
    cmax = warp_max(cmax);
    pmax = warp_max(pmax);
    if (lane == 0) {
      cmax_out[row] = cmax;
      pmax_out[row] = pmax;
    }
  }
}

}  // namespace

extern "C" {

int dsag_int8_rows_per_block() { return kInt8Warps; }

// int8 slots: g [p, rows, b] float32; cq, pq [p, rows, b] int8 with cs, ps
// [p, rows] bf16 scales; h [rows, b] float32; code [p] uint8 (bits 0-1 the
// cache row's source as in cache_source, bit 2: pending takes g); cmax,
// pmax null or [p, rows] float32 whole-row maxima (the split form); outputs
// of the slots' and h's shapes.  p >= 1 (the wrapper returns h itself for
// p = 0).
int dsag_dsag_cache_update_int8(const float* g, const int8_t* cq, const void* cs,
                                const int8_t* pq, const void* ps, const float* h,
                                const uint8_t* code, const float* cmax, const float* pmax,
                                int8_t* ncq, void* ncs, int8_t* npq, void* nps, float* nh,
                                int64_t p, int64_t rows, int64_t b, int device, void* stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return (int)err;
  if (p <= 0 || rows <= 0 || b <= 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((rows + kInt8Warps - 1) / kInt8Warps);
  dsag_int8_kernel<<<blocks, kInt8Warps * 32, 0, (cudaStream_t)stream>>>(
      g, cq, (const __nv_bfloat16*)cs, pq, (const __nv_bfloat16*)ps, h, code, cmax, pmax, ncq,
      (__nv_bfloat16*)ncs, npq, (__nv_bfloat16*)nps, nh, p, rows, b);
  return (int)cudaGetLastError();
}

// the split form's row maxima: inputs as above; cmax, pmax [p, rows] float32
int dsag_dsag_int8_row_max(const float* g, const int8_t* cq, const void* cs, const int8_t* pq,
                           const void* ps, const uint8_t* code, float* cmax, float* pmax,
                           int64_t p, int64_t rows, int64_t b, int device, void* stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return (int)err;
  if (p <= 0 || rows <= 0 || b <= 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)((rows + kInt8Warps - 1) / kInt8Warps);
  dsag_int8_row_max_kernel<<<blocks, kInt8Warps * 32, 0, (cudaStream_t)stream>>>(
      g, cq, (const __nv_bfloat16*)cs, pq, (const __nv_bfloat16*)ps, code, cmax, pmax, p, rows,
      b);
  return (int)cudaGetLastError();
}

// g, c: [p, n] (float32 or bfloat16: g_bf16 / c_bf16 = 1 for bfloat16);
// h: [n] float32; mask: [p] float32 0/1; new_c like c; new_h [n] float32;
// streaming: 1 for dsag_stream_kernel, 0 for dsag_staged_kernel.
int dsag_dsag_cache_update(const void* g, const void* c, const float* h,
                           const float* mask, void* new_c, float* new_h,
                           int64_t p, int64_t n, int g_bf16, int c_bf16, int streaming,
                           int device, void* stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
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
