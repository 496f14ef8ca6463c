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
// input's dtype (float32 or bfloat16).
//
// The TPU kernel runs a (batch*head, q block, kv block) grid with the kv dim
// innermost and carries m, l and acc in VMEM scratch across it.  Blocks do not
// run in order on the H100, so the kv sweep moves inside the block: one block
// per (batch*head, tile of kBQ query rows) loops over the key tiles, keeping
// m, l and acc in registers.  256 threads form a 16 x 16 grid: thread (ty, tx)
// owns query rows ty*4 .. ty*4+3 of the tile, scores for keys tx*4 .. tx*4+3
// of a key tile, and output columns tx*4 .. tx*4+3 (+64 for d = 128).  The 16
// threads that share a row are the 16 lanes of one half-warp, so the row max
// and row sum of a tile are reduced with four xor shuffles: no shared memory
// and no atomics for the softmax statistics.
//
// Per key tile: K and V are staged in shared memory, widened to float32 (K
// transposed, so a thread reads its four keys of one dim as one float4); each
// thread forms its 4 x 4 scores from the staged Q (also transposed) and K,
// masks them, updates m and l, rescales its accumulator by exp(m_old - m_new),
// writes its probabilities to shared memory (transposed), and after a barrier
// adds P V for its 4 rows x (d/16) columns.  Key tiles wholly above the
// aligned diagonal or wholly past sk are never visited; query tiles are
// scheduled heaviest first (the causal ones with the most key tiles).  The
// kernel reads the caller's strides for batch, head and sequence (the head dim
// must be contiguous), so the model's [b, s, h, d] tensors are read and the
// output written in place, and kv head h / groups serves query head h (GQA)
// without repeating K and V in memory.
//
// What bounds it on the H100: at the serving prefill shape ([4, 16, 2048, 64]
// bf16, causal) the work is 2*b*h*sq*sk*d = 3.4e10 flops on 67 MB of q, k, v
// and out, so the bound is the tensor cores' 989 TFLOP/s (0.035 ms).  This
// first kernel runs on the CUDA cores in float32 (67 TFLOP/s at most); its
// inner loops load two float4s from shared memory for every 16 FMAs of the
// scores, and 1 + d/64 for every 4*d/16 FMAs of P V.
// Tensor cores (wgmma), TMA and a warp-specialised pipeline are the redesign
// that would close the gap; they are work for a later change.
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kPad = 4;        // row padding of the transposed tiles (keeps float4 alignment)
constexpr int kLQ = kBQ + kPad;
constexpr int kLK = kBK + kPad;
constexpr float kNegInf = -1e30f;

struct Strides {
  int64_t b, h, s;  // elements between batches, heads and positions
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(D * kLQ + D * kLK + kBK * D + kBK * kLQ) * sizeof(float);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int groups,
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

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + (h / groups) * ks.h;
  const T* vb = v + b * vs.b + (h / groups) * vs.h;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int64_t row = q0 + r;
    Qt[c * kLQ + r] = row < sq ? widen(qb[row * qs.s + c]) : 0.f;
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
      Kt[c * kLK + r] = in ? widen(kb[key * ks.s + c]) : 0.f;
      Vs[r * D + c] = in ? widen(vb[key * vs.s + c]) : 0.f;
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

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < D / 64; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        narrow(&ob[row * os.s + g * 64 + tx * 4 + j], acc[i][g * 4 + j] / denom);
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int64_t B, int64_t H, int64_t sq, int64_t sk, int groups,
                   int causal, float scale, Strides qs, Strides ks, Strides vs,
                   Strides os, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<D, T>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int nq = (int)((sq + kBQ - 1) / kBQ);
  kernel<<<dim3((unsigned)(B * H), (unsigned)nq), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), (int)H, groups, sq, sk, causal, scale, qs, ks, vs, os, nq);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int dsag_flash_block_q() { return kBQ; }
int dsag_flash_block_k() { return kBK; }

// q: [B, H, sq, d], k and v: [B, H / groups, sk, d], o: [B, H, sq, d], each
// addressed through its own (batch, head, position) strides in elements with
// the head dim contiguous; float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1);
// d = 64 or 128.  The wrapper checks shapes, strides and the reference's
// contract (causal needs sq <= sk); B * H >= 1, 1 <= ceil(sq / 64) <= 65535.
int dsag_flash_attention(const void* q, const void* k, const void* v, void* o,
                         int64_t B, int64_t H, int64_t sq, int64_t sk, int d,
                         int groups, int causal, int is_bf16, float scale,
                         int64_t qsb, int64_t qsh, int64_t qss, int64_t ksb,
                         int64_t ksh, int64_t kss, int64_t vsb, int64_t vsh,
                         int64_t vss, int64_t osb, int64_t osh, int64_t oss,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss}, os{osb, osh, oss};
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 64 && is_bf16)
    err = launch<64, __nv_bfloat16>(q, k, v, o, B, H, sq, sk, groups, causal, scale, qs, ks, vs, os, s);
  else if (d == 64)
    err = launch<64, float>(q, k, v, o, B, H, sq, sk, groups, causal, scale, qs, ks, vs, os, s);
  else if (d == 128 && is_bf16)
    err = launch<128, __nv_bfloat16>(q, k, v, o, B, H, sq, sk, groups, causal, scale, qs, ks, vs, os, s);
  else if (d == 128)
    err = launch<128, float>(q, k, v, o, B, H, sq, sk, groups, causal, scale, qs, ks, vs, os, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
