// The Gram product X^T (X V) for Hopper (sm_90a): kernel K5.
//
// Replaces the Pallas kernel repro/kernels/gram_matvec.py::gram_matvec
// (_gram_kernel).  The TPU kernel streams row blocks of X through VMEM on a
// sequential grid, forms P = X_b V on the MXU and accumulates X_b^T P into
// one [d, k] scratch carried across grid steps.  Blocks do not run in order
// on the H100, so the carry becomes a fixed-order sum over row chunks:
//
//   gram_kernel<K, kCluster>: one block of 256 threads per (group, chunk of
//   chunk_rows rows).  The caller picks chunk_rows from the static (B, m) so
//   that the grid holds about two waves of the 132 SMs (gram_matvec.py
//   ::gram_chunks).  The chunk streams through a kGramStages-deep
//   shared-memory ring of tiles (64 rows, fewer for wide rows) filled by
//   cp.async (16 bytes a thread where rows are 16-byte aligned, else 4): a
//   tile of consecutive rows is one contiguous byte range, and three tiles
//   are in flight while one is used.  V comes in with the first tile.  Per
//   tile, phase 1 forms P = X_t V: each thread walks one slice of d along
//   one row and the slices' partials are added in slice order; phase 2 adds
//   x[r, j] * P[r, :] into the [d, K] outputs each thread owns, in
//   registers, 16-byte reads throughout.  The threads split into row groups
//   (16 of 16 threads at d = 64), each owning all of [d, K] over every
//   groups-th row; the groups' sums are added in group order at the end.
//   Phase 1 has no warp shuffles: a __shfl_xor_sync butterfly per P entry
//   was tried first and was bound by the SMs' shuffle rate on the card.
//
// The chunks' sums meet in chunk order, with no float atomics, so a run
// repeats its bits.  Where a group has at most kGramMaxCluster chunks (the
// live PCA step: 6), its blocks form one thread-block cluster and block 0
// adds the others' sums from their shared memory (distributed shared
// memory): one launch, no partials in device memory.  Otherwise (the
// [4096, 512] bench shape: 128 chunks of one group) each block writes its
// partial and gram_reduce_kernel, a second launch on the same stream, sums
// them in a fixed order.  A last-block-reduces ticket would save that
// launch too, but needs a counter that persists between calls (and is
// shared by calls on other streams) plus a fence; clusters and a second
// pass need neither.
//
// What bounds it on the H100: X is read once (m*d floats per group) for
// 4*m*d*k flops: 3 flops per byte at the live PCA shapes (d=64, k=3), 8 at
// [4096, 512] x [512, 8], against the card's 20 (67 TFLOP/s float32 over
// 3.35 TB/s).  So it is bound by bytes, and the plain float32 FMA units are
// the right ones: the tensor cores would only add a layout pass, and TF32
// would break the float32 tolerance (rtol 1e-5) the kernel is held to.  The
// design keeps every SM streaming X once with the products under the loads.
// Both products are computed here, as the TPU kernel computes both in its
// body: no library GEMM.  A leading group dim ([B, m, d] x [d, k] ->
// [B, d, k]) evaluates every group of the live PCA step in one launch.
// Where k > kGramMaxK or d > kGramMaxJ * kGramThreads (or the group count
// is past a grid dimension), the wrapper takes the wide path of
// rows_wide.cuh instead (dsag_gram_matvec_wide): a row pass forming P = X V
// into scratch, then a feature-tiled pass, with no cap on d or k.
// Every entry point returns cudaGetLastError() after its launches.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "rows_wide.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kGramThreads = 256;
constexpr int kGramWarps = kGramThreads / 32;
constexpr int kGramStages = 4;         // ring depth
constexpr int kGramRingFloats = 36864;  // 144 KB: the ring's budget, which sets the tile rows
constexpr int kGramMaxTile = 64;       // rows per ring stage
constexpr int kGramMaxK = 8;           // columns of V
constexpr int kGramMaxJ = 4;           // features a thread owns
constexpr int kGramMaxCluster = 8;     // chunks a cluster may hold (portable size)
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Row pitch in shared memory.  Phase 1 reads down a column (lane r reads
// row r): with 16-byte reads a pitch of an odd number of 16-byte units keeps
// 8 consecutive rows on 8 distinct bank groups; with 4-byte reads an odd
// pitch in floats does the same for 32 rows.
__host__ __device__ __forceinline__ int row_pitch(int d, bool vec) {
  return vec ? d + (((d >> 2) & 1) ? 8 : 4) : (d | 1);
}

// Rows per ring stage: the largest of 64, 32, 16, 8, 4 whose kGramStages
// stages fit kGramRingFloats (64 at the live PCA shape, 16 at d = 512).
__host__ __device__ __forceinline__ int tile_rows(int d, bool vec) {
  const int ld = row_pitch(d, vec);
  int t = kGramMaxTile;
  while (t > 4 && kGramStages * t * ld > kGramRingFloats) t >>= 1;
  return t;
}

// Stage `rows` consecutive rows (one contiguous range of rows*d floats) at
// pitch ld.  A thread's copies stride by kGramThreads units: its (row,
// column) position advances by a fixed step, with no division per copy.
__device__ __forceinline__ void stage_tile(float* dst, const float* src, int rows, int d,
                                           int ld, bool vec) {
  const int w = vec ? d >> 2 : d;  // copy units per row (16 or 4 bytes)
  const int step_r = kGramThreads / w, step_c = kGramThreads % w;
  int r = threadIdx.x / w, c = threadIdx.x % w;
  for (int i = threadIdx.x; i < rows * w; i += kGramThreads) {
    if (vec)  // d % 4 == 0 and X 16-byte aligned: every row start is aligned
      cp_async16(smem_u32(dst + r * ld + 4 * c), src + 4 * i);
    else
      cp_async4(smem_u32(dst + r * ld + c), src + i);
    r += step_r;
    c += step_c;
    if (c >= w) {
      c -= w;
      ++r;
    }
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float at(const float4& q, int i) {
  return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}

// Shared memory (floats): ring [kGramStages][tile][ld] (at the end also the
// row groups' sums [groups][d*K]), V [d][KP], phase-1 partials
// [256 / tile][tile][KP], P [tile][KP], the block's sum [d*K] (cluster path);
// KP = K rounded up to 4, so V and P rows are read 16 bytes at a time.
//
// Phase 1, P = X_t V: thread t takes row t % tile, and the 256 / tile
// slots t / tile each take one slice of d: a thread walks its
// slice of its row (16-byte reads down the column, V rows broadcast) and
// writes a [K] partial; P[r] is then the sum of the slices' partials in
// slice order.
// Phase 2, X_t^T P: a thread owns 4 consecutive features (vec) or up to 4
// strided ones, and one row group of every groups-th row.
template <int K, bool kCluster>
__global__ void __launch_bounds__(kGramThreads)
gram_kernel(const float* __restrict__ x, const float* __restrict__ v,
            float* __restrict__ partial, float* __restrict__ out, int64_t m, int d,
            int chunk_rows, int nchunks, int ring_floats, int vec_flag) {
  constexpr int KP = (K + 3) & ~3;
  extern __shared__ __align__(16) float smem[];
  const bool vec = vec_flag != 0;
  const int ld = row_pitch(d, vec);
  const int tile = tile_rows(d, vec);
  float* ring = smem;
  float* vs = ring + ring_floats;
  float* pp = vs + d * KP;
  float* p = pp + kGramThreads * KP;
  float* blk = p + kGramMaxTile * KP;
  const int dk = d * K;
  const int tid = threadIdx.x;
  const int chunk = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int64_t r0 = (int64_t)chunk * chunk_rows;
  const int64_t left = m - r0;
  const int total = (int)(left < chunk_rows ? left : chunk_rows);
  const float* xb = x + (b * m + r0) * d;
  const int ntiles = (total + tile - 1) / tile;
  const int stage = tile * ld;

  // prologue: V and the first kGramStages - 1 tiles, one commit group each
  for (int i = tid; i < dk; i += kGramThreads)
    cp_async4(smem_u32(vs + (i / K) * KP + i % K), v + i);
#pragma unroll
  for (int t = 0; t < kGramStages - 1; ++t) {
    if (t < ntiles) {
      const int n = total - t * tile;
      stage_tile(ring + t * stage, xb + (int64_t)t * tile * d, n < tile ? n : tile, d, ld, vec);
    }
    cp_async_commit();  // possibly empty: keeps the group count uniform
  }
  // phase-1 slot: row r1 of the tile, slice q1 of d (consecutive lanes take
  // consecutive rows of one slice)
  const int r1 = tid % tile;
  const int slices = kGramThreads / tile;
  const int q1 = tid / tile;
  int sw = (d + slices - 1) / slices;
  if (vec) sw = (sw + 3) & ~3;
  const int jlo = q1 * sw < d ? q1 * sw : d;
  const int jhi = jlo + sw < d ? jlo + sw : d;
  // phase-2 ownership: a row group of `per` threads, each over 4 features
  const int per = vec ? d >> 2 : (d < kGramThreads ? d : kGramThreads);
  const int groups = per < kGramThreads ? kGramThreads / per : 1;
  const int grp = tid / per;
  const int f0 = tid % per;
  const bool active = grp < groups;
  float acc[kGramMaxJ][K];
#pragma unroll
  for (int jj = 0; jj < kGramMaxJ; ++jj)
#pragma unroll
    for (int c = 0; c < K; ++c) acc[jj][c] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kGramStages - 2>();  // tile t (and V) have landed
    __syncthreads();  // ... for every thread, and every thread is done with tile t-1
    const int ahead = t + kGramStages - 1;  // into the stage tile t-1 used
    if (ahead < ntiles) {
      const int n = total - ahead * tile;
      stage_tile(ring + (ahead % kGramStages) * stage, xb + (int64_t)ahead * tile * d,
                 n < tile ? n : tile, d, ld, vec);
    }
    cp_async_commit();
    const float* xs = ring + (t % kGramStages) * stage;
    const int rows = total - t * tile < tile ? total - t * tile : tile;

    // phase 1: this slot's slice of row r1, then P[r] over the slices in order
    {
      float s[KP];
#pragma unroll
      for (int c = 0; c < KP; ++c) s[c] = 0.f;
      if (r1 < rows) {
        const float* xr = xs + r1 * ld;
        if (vec) {
          for (int j = jlo; j < jhi; j += 4) {
            const float4 x4 = ld4(xr + j);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float xv = at(x4, u);
#pragma unroll
              for (int c4 = 0; c4 < KP; c4 += 4) {
                const float4 v4 = ld4(vs + (j + u) * KP + c4);
                s[c4] = fmaf(xv, v4.x, s[c4]);
                s[c4 + 1] = fmaf(xv, v4.y, s[c4 + 1]);
                s[c4 + 2] = fmaf(xv, v4.z, s[c4 + 2]);
                s[c4 + 3] = fmaf(xv, v4.w, s[c4 + 3]);
              }
            }
          }
        } else {
          for (int j = jlo; j < jhi; ++j) {
            const float xv = xr[j];
#pragma unroll
            for (int c4 = 0; c4 < KP; c4 += 4) {
              const float4 v4 = ld4(vs + j * KP + c4);
              s[c4] = fmaf(xv, v4.x, s[c4]);
              s[c4 + 1] = fmaf(xv, v4.y, s[c4 + 1]);
              s[c4 + 2] = fmaf(xv, v4.z, s[c4 + 2]);
              s[c4 + 3] = fmaf(xv, v4.w, s[c4 + 3]);
            }
          }
        }
      }
      float* mine = pp + (q1 * tile + r1) * KP;
#pragma unroll
      for (int c4 = 0; c4 < KP; c4 += 4)
        *reinterpret_cast<float4*>(mine + c4) = make_float4(s[c4], s[c4 + 1], s[c4 + 2], s[c4 + 3]);
    }
    __syncthreads();
    for (int e = tid; e < rows * K; e += kGramThreads) {
      const int r = e / K, c = e - r * K;
      float sum = 0.f;
      for (int q = 0; q < slices; ++q) sum += pp[(q * tile + r) * KP + c];
      p[r * KP + c] = sum;
    }
    __syncthreads();

    // phase 2: X_t^T P into the registers each thread owns, rows in order
    if (active) {
      for (int r = grp; r < rows; r += groups) {
        float pr[KP];
#pragma unroll
        for (int c4 = 0; c4 < KP; c4 += 4) {
          const float4 p4 = ld4(p + r * KP + c4);
          pr[c4] = p4.x;
          pr[c4 + 1] = p4.y;
          pr[c4 + 2] = p4.z;
          pr[c4 + 3] = p4.w;
        }
        float xv[kGramMaxJ];
        if (vec) {
          const float4 x4 = ld4(xs + r * ld + 4 * f0);
          xv[0] = x4.x;
          xv[1] = x4.y;
          xv[2] = x4.z;
          xv[3] = x4.w;
        } else {
#pragma unroll
          for (int jj = 0; jj < kGramMaxJ; ++jj) {
            const int j = f0 + jj * kGramThreads;
            xv[jj] = j < d ? xs[r * ld + j] : 0.f;
          }
        }
#pragma unroll
        for (int jj = 0; jj < kGramMaxJ; ++jj)
#pragma unroll
          for (int c = 0; c < K; ++c) acc[jj][c] = fmaf(xv[jj], pr[c], acc[jj][c]);
      }
    }
  }
  cp_async_wait<0>();  // only empty groups can be left; drain them all the same
  __syncthreads();     // the ring is free: it holds the row groups' sums next

  // the block's sum: the row groups' sums added in group order
  float* dst = kCluster ? blk : (nchunks == 1 ? out + b * dk : partial + (b * nchunks + chunk) * dk);
  float* red = ring;  // [groups][d*K]
  if (active) {
#pragma unroll
    for (int jj = 0; jj < kGramMaxJ; ++jj) {
      const int j = vec ? 4 * f0 + jj : f0 + jj * kGramThreads;
      if (vec || j < d) {
#pragma unroll
        for (int c = 0; c < K; ++c) red[grp * dk + j * K + c] = acc[jj][c];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < dk; e += kGramThreads) {
    float sum = red[e];
    for (int g = 1; g < groups; ++g) sum += red[g * dk + e];
    dst[e] = sum;
  }
  if constexpr (kCluster) {
    // block 0 of the cluster (chunk 0) adds the chunks' sums in chunk order
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every block's sum is in its shared memory
    if (cluster.block_rank() == 0) {
      for (int e = tid; e < dk; e += kGramThreads) {
        float sum = 0.f;
        for (int c = 0; c < nchunks; ++c) sum += cluster.map_shared_rank(blk, c)[e];
        out[b * dk + e] = sum;
      }
    }
    cluster.sync();  // no block leaves while block 0 still reads its memory
  }
}

// out[b, e] = sum over chunks of partial[b, chunk, e]: a block of 8 warps
// serves 32 outputs; warp w adds the chunks of its run [w*per, (w+1)*per)
// in chunk order, then lane e adds the 8 run sums in run order.
__global__ void __launch_bounds__(kGramThreads)
gram_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                   int nchunks, int dk, int64_t total) {
  __shared__ float runs[kGramWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t idx = (int64_t)blockIdx.x * 32 + lane;
  const int per = (nchunks + kGramWarps - 1) / kGramWarps;
  float s = 0.f;
  if (idx < total) {
    const int64_t b = idx / dk;
    const int e = (int)(idx % dk);
    const float* src = partial + b * nchunks * dk + e;
    const int c1 = (warp + 1) * per < nchunks ? (warp + 1) * per : nchunks;
#pragma unroll 4
    for (int c = warp * per; c < c1; ++c) s += src[(int64_t)c * dk];
  }
  runs[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && idx < total) {
    float sum = runs[0][lane];
#pragma unroll
    for (int w = 1; w < kGramWarps; ++w) sum += runs[w][lane];
    out[idx] = sum;
  }
}

template <int K>
cudaError_t launch_gram(const float* x, const float* v, float* partial, float* out,
                        int64_t B, int64_t m, int d, int chunk_rows, int nchunks, int vec,
                        int device, cudaStream_t s) {
  constexpr int KP = (K + 3) & ~3;
  const bool cluster = nchunks > 1 && nchunks <= kGramMaxCluster;
  const int per = vec ? d >> 2 : (d < kGramThreads ? d : kGramThreads);
  const int groups = per < kGramThreads ? kGramThreads / per : 1;
  const int ring = kGramStages * tile_rows(d, vec != 0) * row_pitch(d, vec != 0);
  int ring_floats = ring > groups * d * K ? ring : groups * d * K;
  ring_floats = (ring_floats + 3) & ~3;  // V, partials and P start 16-byte aligned
  const size_t smem =
      (size_t)(ring_floats + d * KP + kGramThreads * KP + kGramMaxTile * KP + d * K) *
      sizeof(float);
  auto kernel = cluster ? gram_kernel<K, true> : gram_kernel<K, false>;
  // the dynamic shared-memory limit is raised once per device and kernel
  static bool raised[2][kMaxDevices] = {};
  if (smem > 48 * 1024 && !raised[cluster][device]) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           232448);
    if (err != cudaSuccess) return err;
    raised[cluster][device] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)nchunks, (unsigned)B);
  cfg.blockDim = dim3(kGramThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)nchunks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, x, v, partial, out, m, d, chunk_rows, nchunks,
                            ring_floats, vec);
}

}  // namespace

extern "C" {

// rows per ring stage at width d: chunk_rows must be a multiple of it
int dsag_gram_tile_rows(int d, int vec) { return tile_rows(d, vec != 0); }
int dsag_gram_max_k() { return kGramMaxK; }
int dsag_gram_max_d() { return kGramMaxJ * kGramThreads; }
int dsag_gram_max_cluster() { return kGramMaxCluster; }

// x: [B, m, d] float32; v: [d, k] float32 (1 <= k <= kGramMaxK, d <= 1024);
// chunk_rows: a multiple of dsag_gram_tile_rows(d, vec); nchunks =
// ceil(m / chunk_rows); partial: [B, nchunks, d, k] scratch when nchunks >
// kGramMaxCluster (may be null otherwise); out: [B, d, k] float32.  vec: x
// is 16-byte aligned and d % 4 == 0.
int dsag_gram_matvec(const float* x, const float* v, float* partial, float* out,
                     int64_t B, int64_t m, int d, int k, int chunk_rows, int nchunks,
                     int vec, int device, void* stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || nchunks <= 0 || d * k == 0) return (int)cudaGetLastError();
  if (k < 1 || k > kGramMaxK || d > kGramMaxJ * kGramThreads || device < 0 ||
      device >= kMaxDevices || chunk_rows % tile_rows(d, vec != 0) != 0 ||
      (vec && d % 4 != 0) ||
      (nchunks > kGramMaxCluster && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
#define DSAG_GRAM_K(KK)                                                                   \
  case KK:                                                                                \
    err = launch_gram<KK>(x, v, partial, out, B, m, d, chunk_rows, nchunks, vec, device, s); \
    break;
    DSAG_GRAM_K(1) DSAG_GRAM_K(2) DSAG_GRAM_K(3) DSAG_GRAM_K(4)
    DSAG_GRAM_K(5) DSAG_GRAM_K(6) DSAG_GRAM_K(7) DSAG_GRAM_K(8)
#undef DSAG_GRAM_K
  }
  if (err != cudaSuccess || nchunks <= kGramMaxCluster) return (int)err;
  const int64_t total = B * d * k;
  gram_reduce_kernel<<<(unsigned)((total + 31) / 32), kGramThreads, 0, s>>>(
      partial, out, nchunks, d * k, total);
  return (int)cudaGetLastError();
}

// The wide path (rows_wide.cuh) for any d and k: x [B, m, d], v [d, k] ->
// out [B, d, k]; scratch: [B, m, k] floats; slabs = ceil(m / slab_rows) <=
// 65535; partial: [B, slabs, d, k] scratch when slabs > 1 (may be null
// otherwise).
int dsag_gram_matvec_wide(const float* x, const float* v, float* scratch, float* partial,
                          float* out, int64_t B, int64_t m, int d, int k, int slabs,
                          int64_t slab_rows, int device, void* stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_wide(x, nullptr, v, 0, nullptr, nullptr, scratch, partial, out, B, B * m,
                         m, d, k, m, slabs, slab_rows, false, 1.f, 1.f, (cudaStream_t)stream);
}

}  // extern "C"
