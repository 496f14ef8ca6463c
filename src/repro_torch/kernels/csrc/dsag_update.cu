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
// K4-int8: int8 slots (optim/compression.py's per-row quantized cache, the
// reference's int8 leaf update in core/dsag_pjit.py), which "the int8
// variant dequantizes/requantizes in the same pass" of
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
// dequantized row need not requantize to itself.
//
// What bounds it on the H100: bytes (g, the two int8 slots read once per
// group, the two slots written once, h read and written once; a few flops
// and two correctly rounded divisions per element); at the live steps'
// shapes (p = 100 or 50 groups of one row of 29 or 64 rows of 3), latency.
// Three launches, chosen by shape in dsag_dsag_cache_update_int8:
//
//   dsag_int8_team_kernel (rows wider than kStagedMaxB, or few groups: the
//   mesh's leaves, p = 2 of rows of 512-1024): a team of tpr threads per
//   row (a power of two up to 256, several teams per 256-thread block)
//   walks the groups in order.  Each thread holds its part of the row in
//   registers: g, the cache and the pending payloads are read once per
//   group, as 16-byte vectors (16 int8 elements, four float4 of g) where
//   b % 16 == 0 and the pointers are aligned, else one element at a time;
//   the row's absmax is a shuffle max over the team (one warp for rows of up to 1024 elements
//   in vectors, 256 single ones; through shared memory across its warps
//   for wider rows), and the requantization reuses the registers.  Each
//   element's running sum of deltas stays in a register across the groups;
//   nh is written once.  The split form's maxima are given: one pass.
//
//   dsag_int8_staged_kernel (rows up to kStagedMaxB wide and kStagedMinP or
//   more groups: the live steps): the independent (group, row) pairs of a
//   tile of rows are spread over the teams of a 1024-thread block (a team
//   of 4-32 lanes per pair, its absmax a segment shuffle), every pair's
//   deltas staged in shared memory; then one thread per (row, element) adds
//   them in group order.  A warp walking 100 dependent groups becomes four
//   rounds of independent loads and a chain of shared-memory adds.
//
//   dsag_int8_long_kernel (rows too long for the team's registers: more than
//   8192 elements, or 2048 unvectorized): one warp per row walks the groups,
//   reading each row twice (absmax, then requantization) and carrying the
//   running sums in nh.
//
// Exactness: __fdiv_rn, rintf (half to even), the bf16 scale and __fadd_rn
// in group order, as the plain twin (kernels/dsag_update.py) rounds: every
// launch is bit for bit the plain twin's.
//
// The split form, for a device mesh where a row's B elements lie on several
// ranks (a column-parallel or FSDP-split leaf) and its one scale is the
// absmax of the whole row: dsag_int8_row_max_kernel writes each (group, row)'s
// absmax of the new cache row and of the new pending row over this rank's
// shard, the caller MAX-all-reduces them over the row's ranks, and the update
// takes those maxima in place of its own.  A maximum is exact, so every shard
// quantizes as the whole row would: bit for bit the unsharded update,
// whatever the split.

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

constexpr int kInt8Warps = 4;  // rows per block of dsag_int8_long_kernel and the row-max pass
constexpr int kTeamThreads = 256;   // block of dsag_int8_team_kernel
constexpr int kStagedThreads = 1024;  // block of dsag_int8_staged_kernel
constexpr int kStagedMaxEl = 4;     // elements per lane there: rows of up to 128
constexpr int kStagedMaxB = 32 * kStagedMaxEl;
constexpr int kStagedMinP = 4;      // groups from which the staged kernel spreads them
constexpr int kStagedFloats = 12288;  // its deltas: 48 KB of shared memory
constexpr int kTeamVec = 2;         // 16-byte parts a team thread holds
constexpr int kTeamScalars = 8;     // elements a thread holds unvectorized

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

// the cache row's new value, the pending row's and the dequantized cache
// value of one element, from its gradient and int8 payloads
__device__ __forceinline__ void int8_sources(float gv, int cqv, int pqv, float csf, float psf,
                                             int src, bool take, float* cf, float* nv,
                                             float* pv) {
  *cf = __fmul_rn((float)cqv, csf);
  const float pf = __fmul_rn((float)pqv, psf);
  *nv = cache_source(src, gv, *cf, pf);
  *pv = take ? gv : pf;
}

// dsag_int8_long_kernel: one warp per row walks the groups in order, each
// row read twice per group; the running sums live in nh.  cmax_in /
// pmax_in: null, or [p, rows] float32 maxima of each whole row (the split
// form)
__global__ void __launch_bounds__(kInt8Warps * 32) dsag_int8_long_kernel(
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

// one thread's part of a row in dsag_int8_team_kernel: VW consecutive
// elements (16: a 16-byte vector of each int8 slot and four float4 of g;
// 1: one element), as loaded
template <int VW>
struct Part;

template <>
struct Part<16> {
  float4 g[4];
  uint4 c, q;
  __device__ __forceinline__ void load(const float* gp, const int8_t* cp, const int8_t* qp) {
    const float4* g4 = reinterpret_cast<const float4*>(gp);
#pragma unroll
    for (int j = 0; j < 4; ++j) g[j] = g4[j];
    c = *reinterpret_cast<const uint4*>(cp);
    q = *reinterpret_cast<const uint4*>(qp);
  }
  static __device__ __forceinline__ float lane_of(const float4& f, int k) {
    return k == 0 ? f.x : k == 1 ? f.y : k == 2 ? f.z : f.w;
  }
  static __device__ __forceinline__ int byte_of(const uint4& w, int j) {
    const unsigned word = (j >> 2) == 0 ? w.x : (j >> 2) == 1 ? w.y : (j >> 2) == 2 ? w.z : w.w;
    return (int)(int8_t)(word >> (8 * (j & 3)));
  }
  __device__ __forceinline__ float gv(int j) const { return lane_of(g[j >> 2], j & 3); }
  __device__ __forceinline__ int cv(int j) const { return byte_of(c, j); }
  __device__ __forceinline__ int qv(int j) const { return byte_of(q, j); }
};

template <>
struct Part<1> {
  float g1;
  int c1, q1;
  __device__ __forceinline__ void load(const float* gp, const int8_t* cp, const int8_t* qp) {
    g1 = *gp;
    c1 = *cp;
    q1 = *qp;
  }
  __device__ __forceinline__ float gv(int) const { return g1; }
  __device__ __forceinline__ int cv(int) const { return c1; }
  __device__ __forceinline__ int qv(int) const { return q1; }
};

// VW int8 values packed for one store
template <int VW>
struct Packed {
  unsigned w[VW / 4];
  __device__ __forceinline__ void set(int j, int8_t v) {
    const unsigned byte = (unsigned)(uint8_t)v << (8 * (j & 3));
    w[j >> 2] = (j & 3) == 0 ? byte : w[j >> 2] | byte;
  }
  __device__ __forceinline__ void store(int8_t* p) const {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Packed<1> {
  int8_t v;
  __device__ __forceinline__ void set(int, int8_t x) { v = x; }
  __device__ __forceinline__ void store(int8_t* p) const { *p = v; }
};

template <int VW>
__device__ __forceinline__ void load_f32(const float* p, float (&out)[VW]) {
  if constexpr (VW == 16) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 f = p4[j];
      out[4 * j] = f.x;
      out[4 * j + 1] = f.y;
      out[4 * j + 2] = f.z;
      out[4 * j + 3] = f.w;
    }
  } else {
    out[0] = *p;
  }
}

template <int VW>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[VW]) {
  if constexpr (VW == 16) {
    float4* p4 = reinterpret_cast<float4*>(p);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      p4[j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  } else {
    *p = v[0];
  }
}

// a team of tpr threads (a power of two up to kTeamThreads) per row, V parts
// of VW elements per thread held in registers (see the file's comment)
template <int VW, int V>
__global__ void __launch_bounds__(kTeamThreads) dsag_int8_team_kernel(
    const float* __restrict__ g, const int8_t* __restrict__ cq,
    const __nv_bfloat16* __restrict__ cs, const int8_t* __restrict__ pq,
    const __nv_bfloat16* __restrict__ ps, const float* __restrict__ h,
    const uint8_t* __restrict__ code, const float* __restrict__ cmax_in,
    const float* __restrict__ pmax_in, int8_t* __restrict__ ncq,
    __nv_bfloat16* __restrict__ ncs, int8_t* __restrict__ npq,
    __nv_bfloat16* __restrict__ nps, float* __restrict__ nh, int64_t p, int64_t rows,
    int64_t b, int tpr) {
  __shared__ float red[2][2][kTeamThreads / 32];  // [group parity][cache, pending][warp]
  const int t = threadIdx.x % tpr;
  const int64_t r = (int64_t)blockIdx.x * (kTeamThreads / tpr) + threadIdx.x / tpr;
  const bool live = r < rows;
  const int64_t nvec = b / VW;
  bool has[V];
  float acc[V][VW];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    has[k] = live && t + (int64_t)k * tpr < nvec;
#pragma unroll
    for (int j = 0; j < VW; ++j) acc[k][j] = 0.f;
  }
  const int64_t r_at = live ? r : 0;
  for (int64_t i = 0; i < p; ++i) {
    const int ci = code[i];
    const int src = ci & 3;
    const bool take = ((ci >> 2) & 1) != 0;
    const int64_t row = i * rows + r_at;
    Part<VW> x[V];
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (has[k]) {
        const int64_t at = row * b + (t + (int64_t)k * tpr) * VW;
        x[k].load(g + at, cq + at, pq + at);
      }
    const float csf = __bfloat162float(cs[row]), psf = __bfloat162float(ps[row]);
    float cmax, pmax;
    if (cmax_in != nullptr) {
      cmax = cmax_in[row];
      pmax = pmax_in[row];
    } else {
      cmax = 0.f;
      pmax = 0.f;
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (has[k]) {
#pragma unroll
          for (int j = 0; j < VW; ++j) {
            float cf, nv, pv;
            int8_sources(x[k].gv(j), x[k].cv(j), x[k].qv(j), csf, psf, src, take, &cf, &nv,
                         &pv);
            cmax = fmaxf(cmax, fabsf(nv));
            pmax = fmaxf(pmax, fabsf(pv));
          }
        }
      for (int o = (tpr < 32 ? tpr : 32) / 2; o > 0; o >>= 1) {
        cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, o));
        pmax = fmaxf(pmax, __shfl_xor_sync(0xffffffffu, pmax, o));
      }
      if (tpr > 32) {  // across the team's warps
        const int warp = threadIdx.x / 32, buf = (int)(i & 1);
        if (threadIdx.x % 32 == 0) {
          red[buf][0][warp] = cmax;
          red[buf][1][warp] = pmax;
        }
        __syncthreads();  // (the other parity's buffer takes the next group)
        const int w0 = (threadIdx.x / tpr) * (tpr / 32);
        for (int w = w0; w < w0 + tpr / 32; ++w) {
          cmax = fmaxf(cmax, red[buf][0][w]);
          pmax = fmaxf(pmax, red[buf][1][w]);
        }
      }
    }
    const float sc = row_scale(cmax), sp = row_scale(pmax);
    const __nv_bfloat16 sc16 = __float2bfloat16_rn(sc);
    const float scb = __bfloat162float(sc16);
    if (live && t == 0) {
      ncs[row] = sc16;
      nps[row] = __float2bfloat16_rn(sp);
    }
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (has[k]) {
        Packed<VW> qc, qp;
#pragma unroll
        for (int j = 0; j < VW; ++j) {
          float cf, nv, pv;
          int8_sources(x[k].gv(j), x[k].cv(j), x[k].qv(j), csf, psf, src, take, &cf, &nv, &pv);
          const int8_t q = quantize_one(nv, sc);
          qc.set(j, q);
          acc[k][j] = __fadd_rn(acc[k][j], __fsub_rn(__fmul_rn((float)q, scb), cf));
          qp.set(j, quantize_one(pv, sp));
        }
        const int64_t at = row * b + (t + (int64_t)k * tpr) * VW;
        qc.store(ncq + at);
        qp.store(npq + at);
      }
  }
#pragma unroll
  for (int k = 0; k < V; ++k)
    if (has[k]) {
      const int64_t at = r * b + (t + (int64_t)k * tpr) * VW;
      float hv[VW];
      load_f32<VW>(h + at, hv);
#pragma unroll
      for (int j = 0; j < VW; ++j) hv[j] = __fadd_rn(hv[j], acc[k][j]);
      store_f32<VW>(nh + at, hv);
    }
}

// the live steps' shape: rt rows per block, every (group, row) pair of a
// chunk of pc groups taken by a team of `team` lanes (4-32; kStagedMaxEl
// elements per lane at most), the deltas staged in shared memory
// [pc][rt][b], then summed in group order by one thread per (row, element)
__global__ void __launch_bounds__(kStagedThreads) dsag_int8_staged_kernel(
    const float* __restrict__ g, const int8_t* __restrict__ cq,
    const __nv_bfloat16* __restrict__ cs, const int8_t* __restrict__ pq,
    const __nv_bfloat16* __restrict__ ps, const float* __restrict__ h,
    const uint8_t* __restrict__ code, const float* __restrict__ cmax_in,
    const float* __restrict__ pmax_in, int8_t* __restrict__ ncq,
    __nv_bfloat16* __restrict__ ncs, int8_t* __restrict__ npq,
    __nv_bfloat16* __restrict__ nps, float* __restrict__ nh, int64_t p, int64_t rows,
    int64_t b, int team, int rt, int pc) {
  extern __shared__ float sdelta[];
  const int lane = threadIdx.x % team, tm = threadIdx.x / team;
  const int nteams = kStagedThreads / team;
  const int64_t r0 = (int64_t)blockIdx.x * rt;
  const int own = threadIdx.x;  // this thread's (row, element) of the tile
  const bool owner = own < rt * b && r0 + own / b < rows;
  float acc = 0.f;
  for (int64_t i0 = 0; i0 < p; i0 += pc) {
    const int npc = (int)(p - i0 < pc ? p - i0 : pc);
    const int items = npc * rt;
    for (int base = 0; base < items; base += nteams) {  // uniform over the block
      const int item = base + tm;
      const int ii = item / rt, rr = item % rt;
      const bool valid = item < items && r0 + rr < rows;
      const int64_t row = valid ? (i0 + ii) * rows + r0 + rr : 0, at = row * b;
      const int ci = valid ? code[i0 + ii] : 0;
      const int src = ci & 3;
      const bool take = ((ci >> 2) & 1) != 0;
      const float csf = valid ? __bfloat162float(cs[row]) : 0.f;
      const float psf = valid ? __bfloat162float(ps[row]) : 0.f;
      float cf[kStagedMaxEl], nv[kStagedMaxEl], pv[kStagedMaxEl];
      bool has[kStagedMaxEl];
      float cmax = 0.f, pmax = 0.f;
#pragma unroll
      for (int k = 0; k < kStagedMaxEl; ++k) {
        const int64_t e = lane + (int64_t)k * team;
        has[k] = valid && e < b;
        if (has[k]) {
          int8_sources(g[at + e], cq[at + e], pq[at + e], csf, psf, src, take, &cf[k], &nv[k],
                       &pv[k]);
          cmax = fmaxf(cmax, fabsf(nv[k]));
          pmax = fmaxf(pmax, fabsf(pv[k]));
        }
      }
      if (cmax_in != nullptr) {
        cmax = valid ? cmax_in[row] : 0.f;
        pmax = valid ? pmax_in[row] : 0.f;
      } else {
        for (int o = team / 2; o > 0; o >>= 1) {
          cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, o));
          pmax = fmaxf(pmax, __shfl_xor_sync(0xffffffffu, pmax, o));
        }
      }
      const float sc = row_scale(cmax), sp = row_scale(pmax);
      const __nv_bfloat16 sc16 = __float2bfloat16_rn(sc);
      const float scb = __bfloat162float(sc16);
      if (valid && lane == 0) {
        ncs[row] = sc16;
        nps[row] = __float2bfloat16_rn(sp);
      }
#pragma unroll
      for (int k = 0; k < kStagedMaxEl; ++k)
        if (has[k]) {
          const int64_t e = lane + (int64_t)k * team;
          const int8_t q = quantize_one(nv[k], sc);
          ncq[at + e] = q;
          npq[at + e] = quantize_one(pv[k], sp);
          sdelta[((int64_t)ii * rt + rr) * b + e] = __fsub_rn(__fmul_rn((float)q, scb), cf[k]);
        }
    }
    __syncthreads();
    if (owner)
      for (int ii = 0; ii < npc; ++ii) acc = __fadd_rn(acc, sdelta[(int64_t)ii * rt * b + own]);
    __syncthreads();  // the next chunk overwrites the deltas
  }
  if (owner) nh[r0 * b + own] = __fadd_rn(h[r0 * b + own], acc);
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

// the fewest rows a block of the int8 update takes (a team of 256 threads
// per row): its grid needs at most `rows` blocks
int dsag_int8_rows_per_block() { return 1; }

// int8 slots: g [p, rows, b] float32; cq, pq [p, rows, b] int8 with cs, ps
// [p, rows] bf16 scales; h [rows, b] float32; code [p] uint8 (bits 0-1 the
// cache row's source as in cache_source, bit 2: pending takes g); cmax,
// pmax null or [p, rows] float32 whole-row maxima (the split form); outputs
// of the slots' and h's shapes.  p >= 1 (the wrapper returns h itself for
// p = 0).  The launch follows the shape (see the file's comment).
int dsag_dsag_cache_update_int8(const float* g, const int8_t* cq, const void* cs,
                                const int8_t* pq, const void* ps, const float* h,
                                const uint8_t* code, const float* cmax, const float* pmax,
                                int8_t* ncq, void* ncs, int8_t* npq, void* nps, float* nh,
                                int64_t p, int64_t rows, int64_t b, int device, void* stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return (int)err;
  if (p <= 0 || rows <= 0 || b <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const __nv_bfloat16 *csb = (const __nv_bfloat16*)cs, *psb = (const __nv_bfloat16*)ps;
  __nv_bfloat16 *ncsb = (__nv_bfloat16*)ncs, *npsb = (__nv_bfloat16*)nps;
  if (b <= kStagedMaxB && p >= kStagedMinP) {
    int team = 4;
    while (team < b && team < 32) team *= 2;
    const int64_t nteams = kStagedThreads / team;
    int64_t rt = 2 * nteams / p;  // about two rounds of the block's teams
    rt = rt < 1 ? 1 : rt > rows ? rows : rt;
    if (rt * b > kStagedThreads) rt = kStagedThreads / b;
    const int64_t pc = kStagedFloats / (rt * b) < p ? kStagedFloats / (rt * b) : p;
    dsag_int8_staged_kernel<<<(unsigned)((rows + rt - 1) / rt), kStagedThreads,
                              (size_t)(pc * rt * b) * sizeof(float), s>>>(
        g, cq, csb, pq, psb, h, code, cmax, pmax, ncq, ncsb, npq, npsb, nh, p, rows, b,
        team, (int)rt, (int)pc);
    return (int)cudaGetLastError();
  }
  const uintptr_t any = (uintptr_t)g | (uintptr_t)cq | (uintptr_t)pq | (uintptr_t)h |
                        (uintptr_t)ncq | (uintptr_t)npq | (uintptr_t)nh;
  const bool vec = b % 16 == 0 && any % 16 == 0;
  const int64_t nvec = vec ? b / 16 : b;
  // a warp per row at most, up to kTeamVec parts a thread (its absmax a
  // shuffle max); wider rows take more warps (a reduction through shared
  // memory at every group)
  const int64_t vec_per = vec ? kTeamVec : kTeamScalars;
  int tpr = 1;
  while (tpr < nvec && tpr < 32) tpr *= 2;
  while (tpr * vec_per < nvec && tpr < kTeamThreads) tpr *= 2;
  const int64_t per = (nvec + tpr - 1) / tpr;  // parts per thread
  const unsigned blocks = (unsigned)((rows + kTeamThreads / tpr - 1) / (kTeamThreads / tpr));
#define DSAG_INT8_TEAM(VW, V)                                                             \
  dsag_int8_team_kernel<VW, V><<<blocks, kTeamThreads, 0, s>>>(                           \
      g, cq, csb, pq, psb, h, code, cmax, pmax, ncq, ncsb, npq, npsb, nh, p, rows, b, tpr)
  if (vec && per == 1)
    DSAG_INT8_TEAM(16, 1);
  else if (vec && per <= kTeamVec)
    DSAG_INT8_TEAM(16, kTeamVec);
  else if (!vec && per == 1)
    DSAG_INT8_TEAM(1, 1);
  else if (!vec && per <= kTeamScalars)
    DSAG_INT8_TEAM(1, kTeamScalars);
  else
    dsag_int8_long_kernel<<<(unsigned)((rows + kInt8Warps - 1) / kInt8Warps), kInt8Warps * 32,
                            0, s>>>(g, cq, csb, pq, psb, h, code, cmax, pmax, ncq, ncsb, npq,
                                    npsb, nh, p, rows, b);
#undef DSAG_INT8_TEAM
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
