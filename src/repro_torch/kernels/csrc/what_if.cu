// The §6 what-if trace replay for Hopper (sm_90a): kernel K7.
//
// Not a port of a TPU kernel: the reference computes this in XLA
// (repro/lb/jit_optimizer.py::_what_if_replay, a lax.scan inside
// estimate_h), which Algorithm 1 calls once per hill-climb round.  In eager
// torch each of its K iterations is some twenty launches, so one h estimate
// is ~2000 launches; here it is one.
//
// Per scenario s (one block), per worker i (one thread), K iterations of
// the §4.2 busy/idle algebra over pre-drawn task times total[s, i, k]
// (the draws' comp + comm):
//
//   idle    = free_at <= iter_end
//   finish  = (idle ? iter_end : free_at) + total[s, i, draw_i]
//   tau_w   = the w-th smallest finish of the block (w = w_eff[s] under a
//             liveness mask, else the scalar w)
//   dead    = tau_w + margin * (tau_w - iter_end)        (or tau_w)
//   started = idle | free_at <= dead;  fresh = started & finish <= dead
//   iter_end = max(last stale or fresh event, tau_w)
//   free_at, draw_i, part_i updated for started / fresh workers
//
// and u[s, i] = part_i * (1/K).  The w-th smallest is found by rank: each
// thread counts the finishes below its own (ties broken by worker index),
// so exactly one thread holds rank w-1 and publishes its value, the value
// torch.kthvalue (or a sort and gather) returns.  The iteration end is a
// block max (exact in any order).
//
// Under churn a dead worker's draws are +inf (the caller masks them) and the
// block waits for w_eff[s] = min(w, #alive) <= #alive.  A dead worker is
// idle at iteration 0, starts, finishes at +inf, and never starts again
// (free_at = inf is past every finite deadline), so it is never fresh and
// never stale.  No NaN can arise: the w_eff-th finish has rank below #alive,
// so it is a living worker's and finite (infinities tie only among
// themselves, ordered by index), hence the deadline is finite; inf - inf
// and 0 * inf are never formed (finish = start + total adds two values that
// are each finite or +inf, and the margin multiplies a finite tau - iter_end).
//
// Exactness: every add, subtract and multiply is __dadd_rn / __dsub_rn /
// __dmul_rn, so nvcc contracts nothing into an FMA and each operator rounds
// once, as the eager plain version (kernels/what_if.py) does: bit-equal to
// it.  What bounds it: latency (K dependent iterations of N-wide rank
// counts and a block reduction); the bytes (total read once, u written
// once) are ~1 us at the lb_scan shape.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kMaxWorkers = 1024;

__global__ void what_if_kernel(const double* __restrict__ total, double* __restrict__ u,
                               const int64_t* __restrict__ w_eff, int N, int K, int w_all,
                               int use_margin, double margin, double inv_k) {
  extern __shared__ double s_fin[];          // [N] this iteration's finishes
  __shared__ double s_tau, s_end;
  __shared__ double s_warp_max[kMaxWorkers / 32];
  const int s = blockIdx.x;
  const int i = threadIdx.x;
  const int w = w_eff != nullptr ? (int)w_eff[s] : w_all;
  const bool live = i < N;
  const double* tot = total + ((int64_t)s * N + (live ? i : 0)) * K;
  double free_at = 0.0, iter_end = 0.0;
  int draw = 0, part = 0;
  const int warps = (blockDim.x + 31) / 32;
  for (int it = 0; it < K; ++it) {
    const bool idle = free_at <= iter_end;
    const double start = idle ? iter_end : free_at;
    const double finish = __dadd_rn(start, live ? tot[draw] : 0.0);
    if (live) s_fin[i] = finish;
    __syncthreads();
    if (live) {
      int rank = 0;
      for (int j = 0; j < N; ++j) {
        const double f = s_fin[j];
        rank += (f < finish) || (f == finish && j < i);
      }
      if (rank == w - 1) s_tau = finish;
    }
    __syncthreads();
    const double tau = s_tau;
    const double dead =
        use_margin ? __dadd_rn(tau, __dmul_rn(margin, __dsub_rn(tau, iter_end))) : tau;
    const bool started = idle || free_at <= dead;
    const bool fresh = started && finish <= dead;
    const bool stale = started && !idle;
    double last = fresh ? finish : (stale ? free_at : -INFINITY);
    if (!live) last = -INFINITY;
    for (int off = 16; off > 0; off >>= 1)
      last = fmax(last, __shfl_xor_sync(0xffffffffu, last, off));
    if ((i & 31) == 0) s_warp_max[i >> 5] = last;
    __syncthreads();
    if (i == 0) {
      double m = s_warp_max[0];
      for (int k = 1; k < warps; ++k) m = fmax(m, s_warp_max[k]);
      s_end = fmax(m, tau);
    }
    if (started) {
      free_at = finish;
      ++draw;
    }
    part += fresh;
    __syncthreads();
    iter_end = s_end;
  }
  if (live) u[(int64_t)s * N + i] = __dmul_rn((double)part, inv_k);
}

}  // namespace

extern "C" {

// total: [S, N, K] float64 (the draws' comp + comm); u: [S, N] float64;
// w_eff: [S] int64 per-scenario waits, or null for the scalar w of every
// scenario.  Needs 1 <= w (each w_eff[s]) <= N <= 1024 (the wrapper checks).
int dsag_what_if_replay(const double* total, double* u, const int64_t* w_eff, int64_t S,
                        int N, int K, int w, int use_margin, double margin, double inv_k,
                        int device, void* stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return (int)err;
  if (S <= 0 || N <= 0) return (int)cudaGetLastError();
  const int threads = ((N + 31) / 32) * 32;
  what_if_kernel<<<(unsigned)S, threads, N * sizeof(double), (cudaStream_t)stream>>>(
      total, u, w_eff, N, K, w, use_margin, margin, inv_k);
  return (int)cudaGetLastError();
}

int dsag_what_if_max_workers() { return kMaxWorkers; }

}  // extern "C"
