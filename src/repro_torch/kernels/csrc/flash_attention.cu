// Flash-attention forward for Hopper (sm_90a): kernel K6.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::flash_attention
// (_flash_kernel) behind the wrapper repro/kernels/ops.py::flash_attention_op.
// It computes what they compute: an online-softmax attention forward with
// float32 math inside, scores scaled by 1/sqrt(d) of the true head dim, a
// causal mask aligned bottom-right to the true lengths (key <= query + sk - sq),
// keys past sk excluded, masked scores set to -1e30 (the reference's NEG_INF,
// not -inf), running max / denominator / accumulator updated per key tile as
// the TPU kernel updates them, and a final acc / max(l, 1e-30) written in the
// input's dtype.
//
// The TPU kernel runs a (batch*head, q block, kv block) grid with the kv dim
// innermost and carries m, l and acc in VMEM scratch across it.  Blocks do not
// run in order on the H100, so the kv sweep moves inside the block: one block
// per (batch*head, tile of kBQ = 64 query rows) loops over the key tiles of
// kBK = 64 keys, keeping m, l and acc in registers.  Key tiles wholly above
// the aligned diagonal or past sk are never visited; causal query tiles are
// scheduled heaviest first.  Both kernels read the caller's batch, head and
// position strides (head dim contiguous), so the model's [b, s, h, d] tensors
// are read and the output written in place, and kv head h / groups serves
// query head h (GQA) without repeating K and V in memory.  Two kernels, picked
// by the input's dtype:
//
// bfloat16 (flash_fwd_bf16_mma_kernel), the serving path.  What bounds it: at
// the serving prefill shape ([4, 16, 2048, 64], causal) the useful work is
// 3.4e10 flops of Q.K^T and P.V on 67 MB, so the card's bound is its bf16
// tensor cores (0.035 ms at 989 TFLOP/s).  The design feeds them: 4 warps,
// each owning 16 query rows; Q goes to registers once (ldmatrix; at d = 128
// it is read again from shared memory per tile, which keeps the kernel
// under 255 registers without spills); K and V
// tiles are staged by cp.async (16 bytes a thread, zero-filled past sq and sk
// by the src-size operand, so no global read leaves the tensors) into a
// double-buffered ring, tile t+1 loading while tile t computes, in a layout
// whose 16-byte chunks are XOR-swizzled by row so that ldmatrix (K) and
// ldmatrix.trans (V) are free of bank conflicts.  S = Q.K^T runs on
// mma.sync m16n8k16 bf16 with float32 accumulators; scale, mask, row max and
// row sum stay in registers (the 4 lanes of a row reduce by __shfl_xor_sync).
// P.V cannot round P to bf16: the kernel is held to float32 rounding plus the
// output's own bf16 rounding, and P in bf16 breaks that on about a fifth of
// the outputs.  So P is split into P_hi = bf16(P) and P_lo = bf16(P - P_hi),
// both fed from registers as A fragments against one V fragment: two MMAs,
// P's error ~2^-18 relative, l summed from the float32 P.  The extra MMA makes
// P.V cost twice its useful flops (5.1e10 tensor-core flops in all at the
// serving shape).  mma.sync reaches about two thirds of the card's bf16 rate;
// wgmma with TMA and warp specialisation is the step after this one.
//
// Head dims: 64, 128 and 256 are built; the wrapper zero-pads any other d up
// to the next of them (the reference pads d to a multiple of 128 lanes).  At
// d = 256 the bf16 kernel's tiles take (64 + 4 * 64) * 256 * 2 B = 160 KiB of
// shared memory (above the 48 KiB default, so the launch raises the limit
// with cudaFuncSetAttribute, as it does for every instantiation) and its
// float32 accumulator 128 registers a thread: what -Xptxas -v reports for it,
// spills included, is printed by chip_smoke.py's phase 2.  The float32 kernel
// at d = 256 takes 217 KiB of shared memory, under the 227 KiB a block may use.
//
// float32 (flash_fwd_kernel), the correctness path (the float32 model held to
// 1e-3 of the reference's full_attention).  256 threads form a 16 x 16 grid:
// thread (ty, tx) owns query rows ty*4 .. ty*4+3, keys tx*4 .. tx*4+3 of a
// tile and output columns 64 g + tx*4 .. 64 g + tx*4+3 for g < d / 64; a row's 16
// threads are a half-warp (row max and sum by four xor shuffles).  K (
// transposed), V, Q (transposed) and P are staged in shared memory and
// multiplied on the CUDA cores in float32 (67 TFLOP/s at most).
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr float kNegInf = -1e30f;

struct Strides {
  int64_t b, h, s;  // elements between batches, heads and positions
};

// -- float32: CUDA cores ------------------------------------------------------

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kPad = 4;        // row padding of the transposed tiles (keeps float4 alignment)
constexpr int kLQ = kBQ + kPad;
constexpr int kLK = kBK + kPad;

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(D * kLQ + D * kLK + kBK * D + kBK * kLQ) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int H, int groups,
                 int64_t sq, int64_t sk, int causal, float scale, Strides qs,
                 Strides ks, Strides vs, Strides os, int nq) {
  static_assert(D % 64 == 0, "head dim must be a multiple of 64");
  constexpr int kCols = D / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [D][kLQ] Q tile, transposed
  float* Kt = Qt + D * kLQ;                     // [D][kLK] K tile, transposed
  float* Vs = Kt + D * kLK;                     // [kBK][D] V tile
  float* Pt = Vs + kBK * D;                     // [kBK][kLQ] probabilities, transposed

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int qtile = causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int64_t q0 = (int64_t)qtile * kBQ;
  const int64_t offs = sk - sq;  // bottom-right alignment of the causal mask

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + (h / groups) * ks.h;
  const float* vb = v + b * vs.b + (h / groups) * vs.h;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int64_t row = q0 + r;
    Qt[c * kLQ + r] = row < sq ? qb[row * qs.s + c] : 0.f;
  }

  // keys this query tile can see: all of them, or up to the aligned diagonal
  // of its last row
  int64_t k_end = sk;
  if (causal) {
    const int64_t last = (q0 + kBQ < sq ? q0 + kBQ : sq) - 1;
    k_end = last + offs + 1 < sk ? last + offs + 1 : sk;
  }
  const int ntiles = k_end > 0 ? (int)((k_end + kBK - 1) / kBK) : 0;

  float acc[4][kCols];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int64_t k0 = (int64_t)t * kBK;
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const int64_t key = k0 + r;
      const bool in = key < sk;  // zeros past sk: masked below, never NaN
      Kt[c * kLK + r] = in ? kb[key * ks.s + c] : 0.f;
      Vs[r * D + c] = in ? vb[key * vs.s + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[c * kLQ + ty * 4]);
      const float4 bk = *reinterpret_cast<const float4*>(&Kt[c * kLK + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t row = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t key = k0 + tx * 4 + j;
        const bool keep = key < sk && (!causal || key <= row + offs);
        s[i][j] = keep ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(&Pt[(tx * 4 + j) * kLQ + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(&Pt[kk * kLQ + ty * 4]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int g = 0; g < D / 64; ++g) {
        const float4 w = *reinterpret_cast<const float4*>(&Vs[kk * D + g * 64 + tx * 4]);
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][g * 4 + j] = fmaf(pv[i], wv[j], acc[i][g * 4 + j]);
      }
    }
    __syncthreads();  // the next tile overwrites Kt, Vs and Pt
  }

  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < D / 64; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ob[row * os.s + g * 64 + tx * 4 + j] = acc[i][g * 4 + j] / denom;
  }
}

// -- bfloat16: tensor cores (mma.sync) ----------------------------------------

constexpr int kWarps = 4;                   // each owns 16 query rows
constexpr int kMmaThreads = 32 * kWarps;
static_assert(16 * kWarps == kBQ, "one m16 row slab per warp");
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// smem holds Q [kBQ][D], then K [2][kBK][D] and V [2][kBK][D]
template <int D>
constexpr size_t mma_smem_bytes() {
  return (size_t)(kBQ + 4 * kBK) * D * sizeof(bf16);
}

// element (row, col) of a [rows][D] tile: the 16-byte chunk index (col / 8)
// is XORed with row % 8, so the 8 rows one ldmatrix reads at one column fall
// in 8 different bank groups
template <int D>
__device__ __forceinline__ int swz(int row, int col) {
  const int chunk = col >> 3;
  return row * D + (((chunk ^ row) & 7) | (chunk & ~7)) * 8 + (col & 7);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src-size 0 zero-fills without reading
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) -> hi = bf16(x), lo = bf16(x - hi), each packed low element first
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h)));
}

// the A fragment of Q for k step kk: lane (j8, r8) points ldmatrix at row
// qrow (16 rows of the warp) and dims 16 kk + 8 (j8 / 2) of the Q tile
template <int D>
__device__ __forceinline__ void load_q(const bf16* Qs, int qrow, int kk, int j8,
                                       uint32_t (&a)[4]) {
  ldsm_x4(smem_u32(Qs + swz<D>(qrow, 16 * kk + 8 * (j8 >> 1))), a[0], a[1], a[2], a[3]);
}

// rows row0 .. row0 + kBK - 1 of one head (row stride rs) into a swizzled
// [kBK][D] tile; rows at or past nrows are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base, int64_t row0,
                                          int64_t rs, int64_t nrows, int tid) {
  constexpr int kChunks = D / 8;
  static_assert(kBK * kChunks % kMmaThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < kBK * kChunks / kMmaThreads; ++it) {
    const int i = tid + it * kMmaThreads;
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool in = row0 + r < nrows;
    const bf16* src = in ? base + (row0 + r) * rs + c : base;
    cp_async16(smem_u32(dst + swz<D>(r, c)), src, in);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_bf16_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o, int H,
                          int groups, int64_t sq, int64_t sk, int causal, float scale,
                          Strides qs, Strides ks, Strides vs, Strides os, int nq) {
  static_assert(D == 64 || D == 128 || D == 256, "head dim 64, 128 or 256");
  constexpr int kKSteps = D / 16;  // k steps of Q.K^T
  constexpr int kNT = kBK / 8;     // 8-key column tiles of S
  constexpr int kND = D / 8;       // 8-wide column tiles of O
  constexpr int kTile = kBK * D;
  extern __shared__ uint4 smem_mma[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_mma);  // later: the output tile
  bf16* Ks = Qs + kBQ * D;
  bf16* Vs = Ks + 2 * kTile;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row and column pair
  const int j8 = lane >> 3, r8 = lane & 7;  // ldmatrix: which 8x8 matrix, which row
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int qtile = causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int64_t q0 = (int64_t)qtile * kBQ;
  const int64_t offs = sk - sq;  // bottom-right alignment of the causal mask

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + (h / groups) * ks.h;
  const bf16* vb = v + b * vs.b + (h / groups) * vs.h;

  int64_t k_end = sk;
  if (causal) {
    const int64_t last = (q0 + kBQ < sq ? q0 + kBQ : sq) - 1;
    k_end = last + offs + 1 < sk ? last + offs + 1 : sk;
  }
  const int ntiles = k_end > 0 ? (int)((k_end + kBK - 1) / kBK) : 0;

  load_tile<D>(Qs, qb, q0, qs.s, sq, tid);
  cp_async_commit();
  if (ntiles > 0) {
    load_tile<D>(Ks, kb, 0, ks.s, sk, tid);
    load_tile<D>(Vs, vb, 0, vs.s, sk, tid);
  }
  cp_async_commit();

  // this warp's rows: wrow + g and wrow + g + 8; a warp whose rows all lie
  // past sq still stages tiles and meets every barrier, but computes nothing
  const int64_t wrow = q0 + warp * 16;
  const bool live = wrow < sq;
  // last key each of the thread's two rows may see
  int64_t lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t row = wrow + g + 8 * i;
    lim[i] = causal && row + offs < sk - 1 ? row + offs : sk - 1;
  }

  cp_async_wait<1>();  // Q has landed
  __syncthreads();
  // Q's A fragments: held in registers at d = 64; at d = 128 and 256 they
  // would push the kernel past 255 registers into spills, so there each tile
  // reads them again from the Q tile (ldmatrix, free of bank conflicts)
  constexpr bool kQRegs = D == 64;
  const int qrow = warp * 16 + 8 * (j8 & 1) + r8;
  uint32_t qf[kQRegs ? kKSteps : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) load_q<D>(Qs, qrow, kk, j8, qf[kk]);
  }

  float acc[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's columns only

  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntiles) {  // tile t+1 into the other buffer while tile t computes
      load_tile<D>(Ks + (buf ^ 1) * kTile, kb, (int64_t)(t + 1) * kBK, ks.s, sk, tid);
      load_tile<D>(Vs + (buf ^ 1) * kTile, vb, (int64_t)(t + 1) * kBK, vs.s, sk, tid);
    }
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait<1>();  // tile t has landed
    __syncthreads();

    if (live) {
      const bf16* Kt = Ks + buf * kTile;
      const bf16* Vt = Vs + buf * kTile;
      const int64_t k0 = (int64_t)t * kBK;

      float s[kNT][4];
#pragma unroll
      for (int n = 0; n < kNT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        uint32_t qa[4];
        if constexpr (!kQRegs) load_q<D>(Qs, qrow, kk, j8, qa);
        const uint32_t(&a)[4] = kQRegs ? qf[kQRegs ? kk : 0] : qa;
#pragma unroll
        for (int n = 0; n < kNT; n += 2) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4(smem_u32(Kt + swz<D>(8 * (n + (j8 >> 1)) + r8, 16 * kk + 8 * (j8 & 1))),
                  b0, b1, b2, b3);
          mma_bf16(s[n], a, b0, b1);
          mma_bf16(s[n + 1], a, b2, b3);
        }
      }

      // scale, then mask where this tile crosses the diagonal or sk
      const bool edge = k0 + kBK - 1 > lim[0] || k0 + kBK - 1 > lim[1];
      const int lim0 = (int)(lim[0] - k0 < kBK ? lim[0] - k0 : kBK);
      const int lim1 = (int)(lim[1] - k0 < kBK ? lim[1] - k0 : kBK);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 8 * n + 2 * t4 + (e & 1);
          float x = s[n][e] * scale;
          if (edge && key > (e < 2 ? lim0 : lim1)) x = kNegInf;
          s[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = ex2((m[i] - m_new) * kLog2e);
        m[i] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = ex2((s[n][e] - m[e >> 1]) * kLog2e);
          rs[e >> 1] += s[n][e];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
      for (int n = 0; n < kND; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }

      // O += P_hi.V + P_lo.V, P taken from S's accumulators as A fragments
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t ahi[4], alo[4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], ahi[0], alo[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], ahi[1], alo[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ahi[2], alo[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ahi[3], alo[3]);
#pragma unroll
        for (int n = 0; n < kND; n += 2) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4_trans(smem_u32(Vt + swz<D>(16 * kk + 8 * (j8 & 1) + r8, 8 * (n + (j8 >> 1)))),
                        b0, b1, b2, b3);
          mma_bf16(acc[n], ahi, b0, b1);
          mma_bf16(acc[n], alo, b0, b1);
          mma_bf16(acc[n + 1], ahi, b2, b3);
          mma_bf16(acc[n + 1], alo, b2, b3);
        }
      }
    }
    __syncthreads();  // the prefetch of tile t+2 overwrites this buffer
  }
  if (!live) return;

  // the warp's 16 output rows go through its own rows of the Q tile (no
  // other warp reads them), then out as 16-byte stores
  float denom[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    denom[i] = fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < kND; ++n) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(Qs + swz<D>(warp * 16 + g + 8 * i, 8 * n + 2 * t4)) =
          __floats2bfloat162_rn(acc[n][2 * i] / denom[i], acc[n][2 * i + 1] / denom[i]);
    }
  }
  __syncwarp();
  bf16* ob = o + b * os.b + h * os.h;
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int it = 0; it < 16 * kChunks / 32; ++it) {
    const int i = lane + 32 * it;
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const int64_t row = wrow + r;
    if (row < sq)
      *reinterpret_cast<uint4*>(ob + row * os.s + c) =
          *reinterpret_cast<const uint4*>(Qs + swz<D>(warp * 16 + r, c));
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int64_t B,
                       int64_t H, int64_t sq, int64_t sk, int groups, int causal,
                       float scale, Strides qs, Strides ks, Strides vs, Strides os,
                       cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<D>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int nq = (int)((sq + kBQ - 1) / kBQ);
  kernel<<<dim3((unsigned)(B * H), (unsigned)nq), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), (int)H, groups, sq, sk, causal,
      scale, qs, ks, vs, os, nq);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int64_t B,
                        int64_t H, int64_t sq, int64_t sk, int groups, int causal,
                        float scale, Strides qs, Strides ks, Strides vs, Strides os,
                        cudaStream_t stream) {
  auto kernel = flash_fwd_bf16_mma_kernel<D>;
  const size_t smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int nq = (int)((sq + kBQ - 1) / kBQ);
  kernel<<<dim3((unsigned)(B * H), (unsigned)nq), kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), (int)H, groups, sq, sk, causal, scale, qs, ks, vs, os, nq);
  return cudaGetLastError();
}

// cp.async and the 16-byte output stores: every row start 16-byte aligned
bool aligned16(const void* p, Strides s) {
  return ((uintptr_t)p % 16) == 0 && s.b % 8 == 0 && s.h % 8 == 0 && s.s % 8 == 0;
}

}  // namespace

extern "C" {

int dsag_flash_block_q() { return kBQ; }
int dsag_flash_block_k() { return kBK; }

// q: [B, H, sq, d], k and v: [B, H / groups, sk, d], o: [B, H, sq, d], each
// addressed through its own (batch, head, position) strides in elements with
// the head dim contiguous; float32 (is_bf16 = 0: CUDA cores) or bfloat16
// (is_bf16 = 1: tensor cores; every base pointer 16-byte aligned and every
// stride a multiple of 8); d = 64, 128 or 256.  The wrapper checks shapes, strides
// and the reference's contract (causal needs sq <= sk); B * H >= 1,
// 1 <= ceil(sq / 64) <= 65535.
int dsag_flash_attention(const void* q, const void* k, const void* v, void* o,
                         int64_t B, int64_t H, int64_t sq, int64_t sk, int d,
                         int groups, int causal, int is_bf16, float scale,
                         int64_t qsb, int64_t qsh, int64_t qss, int64_t ksb,
                         int64_t ksh, int64_t kss, int64_t vsb, int64_t vsh,
                         int64_t vss, int64_t osb, int64_t osh, int64_t oss,
                         int device, void* stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return (int)err;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss}, os{osb, osh, oss};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16 && !(aligned16(q, qs) && aligned16(k, ks) && aligned16(v, vs) && aligned16(o, os)))
    return (int)cudaErrorMisalignedAddress;
  if (d == 64 && is_bf16)
    err = launch_bf16<64>(q, k, v, o, B, H, sq, sk, groups, causal, scale, qs, ks, vs, os, s);
  else if (d == 64)
    err = launch_f32<64>(q, k, v, o, B, H, sq, sk, groups, causal, scale, qs, ks, vs, os, s);
  else if (d == 128 && is_bf16)
    err = launch_bf16<128>(q, k, v, o, B, H, sq, sk, groups, causal, scale, qs, ks, vs, os, s);
  else if (d == 128)
    err = launch_f32<128>(q, k, v, o, B, H, sq, sk, groups, causal, scale, qs, ks, vs, os, s);
  else if (d == 256 && is_bf16)
    err = launch_bf16<256>(q, k, v, o, B, H, sq, sk, groups, causal, scale, qs, ks, vs, os, s);
  else if (d == 256)
    err = launch_f32<256>(q, k, v, o, B, H, sq, sk, groups, causal, scale, qs, ks, vs, os, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
