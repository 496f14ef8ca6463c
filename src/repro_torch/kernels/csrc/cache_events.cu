// §5 grid-cache event walk for Hopper (sm_90a): kernel K3.
//
// Replaces the Pallas kernel repro/kernels/cache_events.py::grid_cache_update
// (_grid_cache_kernel).  For each scenario it walks R events in rank order
// (ranked and gathered by the caller: a stable argsort on event time with
// +inf for invalid events).  An event is rejected when its slot is active
// and the slot's iteration tag is at least the event's; an accepted event
// adds v - old to the running sums, writes the value and the tag, and adds
// the slot's width to `covered` when the slot was empty.
//
// What bounds it on the H100: bytes, about 2.3 MB per call at the recipes'
// shapes (the [E, F] value tables copied into new outputs), 1.4 us at
// 3.35 TB/s.  The TPU kernel walks the ranks one after another; a block
// doing the same on the card pays two barriers and a dependent global read
// of the slot's tag per rank, about 0.5 us a rank.  The design splits the
// walk, because acceptance depends only on tags, never on values:
//
//   1. Decide every event's fate first, in shared memory, a window of at
//      most kWindow ranks at a time (state sized by the window, not by E or
//      R, so any shape runs).  Each rank finds the previous rank on its slot
//      in the window by a scan of the staged slots (at most kWindow slots, so
//      the scan's cost is linear in R); that links the ranks of one slot
//      into a chain, and chains of different slots do not interact.  One
//      thread per distinct slot walks its chain in rank order against the
//      slot's tag before the window: accepted or rejected, whether the slot
//      was active before, and the last accepted earlier rank on the slot
//      (`prevacc`).  A warp then lists the accepted ranks in rank order
//      (ballots); all threads count covered and rejected (integers: any
//      order is exact).  Where R fits one window, every walk block of a
//      scenario decides this, and each then takes a slice of the features
//      for steps 2 and 3.
//   2. Every delta is independent: delta_j[f] = v_j[f] - old, old =
//      v_prevacc[f], or the slot's value before the window for the first
//      acceptance on an active slot, or 0 on an empty one.  Every operand is
//      an input (or, past the first of several windows, a row an earlier
//      window wrote), so all threads form the deltas of a chunk of accepted
//      ranks at once into shared memory, each thread with kBatch loads in
//      flight; then each feature's thread adds them to the sums in rank
//      order with __dadd_rn, the plain version's order: the sums are
//      bit-equal to it.  The adds are written with __dsub_rn/__dadd_rn:
//      there is no multiply to contract, and the intrinsics make that
//      explicit.
//   3. Each slot an event names gets the value and tag of its last accepted
//      rank, or its old row.  Every other row is copied from values0 and
//      iters0 by the launch's extra blocks (16-byte loads where aligned),
//      which read slot_r to skip the rows the walk writes.
//
// Past one window (R > kWindow) a scenario has one walk block.  It first
// copies the sums, the counters and every named row into the outputs, then
// walks the windows in rank order, each reading the state the earlier ones
// left in the outputs and updating it in place (plain loads: the outputs
// are written within the launch).
//
// Inputs are not modified; the outputs are new tensors.  The entry point
// returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWindow = 2048;     // ranks a walk block decides at once (shared memory)
constexpr int kMaxDelta = 12288;  // staged deltas, doubles: 96 KB
constexpr int kSmemMax = 232448 - 1024;  // a block's shared memory on the H100, less
                                         // room for the static shared variables
constexpr int kBatch = 8;             // global loads a thread keeps in flight
constexpr int kCopyMaxRows = 2048;    // rows per copy block (one byte of flags each)
constexpr int kMaxDevices = 64;

constexpr uint8_t kValid = 1, kHead = 2, kAccepted = 4, kWasActive = 8;

// per rank of a window: slot, next (later: the heads' list), prevacc, last,
// accepted list (int32 each) and flags (one byte)
constexpr int kRankBytes = 5 * 4 + 1;

// the window's tags, starting tags and slot widths are staged in the delta
// buffer while it is free
static_assert(3 * kWindow <= kMaxDelta, "the staged tags overflow the delta buffer");

__host__ __device__ inline size_t walk_smem(int n) {
  return (size_t)kMaxDelta * 8 + (size_t)n * kRankBytes + 16;
}
static_assert(kMaxDelta * 8 + kWindow * kRankBytes + 16 <= kSmemMax, "a window overflows");

// Window [r0, r0 + n) of scenario s, walk block q: the fate of every event
// (every block of the scenario decides it, from the same inputs), then the
// sums and the named rows of its slice of the features [f_lo, f_hi).
// kCarry: one of several windows (one walk block per scenario), which reads
// the state before it from the outputs and updates them in place; else the
// only window, which reads the inputs.
template <bool kCarry>
__device__ void walk_window(
    int64_t s, int q, int r0, int n, int f_lo, int f_hi, const bool* __restrict__ valid_r,
    const int64_t* __restrict__ slot_r, const int64_t* __restrict__ tag_r,
    const double* __restrict__ vals_r, const double* __restrict__ sums0,
    const double* __restrict__ values0, const int64_t* __restrict__ iters0,
    const int64_t* __restrict__ covered0, const int64_t* __restrict__ rejected0,
    const int64_t* __restrict__ slot_width, double* __restrict__ sums,
    double* __restrict__ values, int64_t* __restrict__ iters, int64_t* __restrict__ covered,
    int64_t* __restrict__ rejected, int R, int E, int F, unsigned char* smem) {
  // the state before the window
  const double* sums_in = kCarry ? sums : sums0;
  const double* values_in = kCarry ? values : values0;
  const int64_t* iters_in = kCarry ? iters : iters0;
  double* delta = reinterpret_cast<double*>(smem);
  int* slot = reinterpret_cast<int*>(smem + (size_t)kMaxDelta * 8);
  int* nxt = slot + n;  // next rank on the same slot; after the walk, the heads' list
  int* prevacc = nxt + n;
  int* last = prevacc + n;
  int* accl = last + n;
  uint8_t* flags = reinterpret_cast<uint8_t*>(accl + n);
  int64_t* tag_s = reinterpret_cast<int64_t*>(smem);
  int64_t* cur_s = tag_s + n;
  int64_t* width_s = cur_s + n;
  __shared__ int n_acc, n_heads;
  __shared__ long long red[2][kThreads / 32];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int64_t sR = s * R + r0, sE = s * E;

  // 1a. stage the window's ranks
  for (int j = tid; j < n; j += nt) {
    const int64_t sl = slot_r[sR + j];
    slot[j] = (int)sl;
    flags[j] = valid_r[sR + j] ? kValid : 0;
    nxt[j] = -1;
    tag_s[j] = tag_r[sR + j];
    cur_s[j] = iters_in[sE + sl];
    width_s[j] = slot_width[sl];
  }
  __syncthreads();
  // 1b. the previous rank on each rank's slot (any validity): chain heads and
  // links; the scan reads 8 staged slots at a time
  for (int j = tid; j < n; j += nt) {
    const int sl = slot[j];
    int i = j - 1, prev = -1;
    for (; i >= 7 && prev < 0; i -= 8) {
      int sv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) sv[u] = slot[i - u];
#pragma unroll
      for (int u = 7; u >= 0; --u)
        if (sv[u] == sl) prev = i - u;  // the nearest, u = 0, is written last
    }
    for (; i >= 0 && prev < 0; --i)
      if (slot[i] == sl) prev = i;
    if (prev < 0)
      flags[j] |= kHead;
    else
      nxt[prev] = j;
  }
  __syncthreads();
  // 1c. one thread per distinct slot walks its chain in rank order
  for (int j = tid; j < n; j += nt) {
    if (!(flags[j] & kHead)) continue;
    int64_t cur = cur_s[j];
    int la = -1;
    for (int node = j; node >= 0; node = nxt[node]) {
      uint8_t f = flags[node];
      if (f & kValid) {
        const bool active = cur >= 0;
        const int64_t tag = tag_s[node];
        if (!(active && cur >= tag)) {
          f |= kAccepted | (active ? kWasActive : 0);
          prevacc[node] = la;
          la = node;
          cur = tag;
        }
        flags[node] = f;
      }
    }
    last[j] = la;
  }
  __syncthreads();
  // 1d. covered and rejected (every thread over its ranks, then the warps'
  // integer sums); warp 0 lists the accepted ranks and the chain heads in
  // rank order (ballots)
  if (q == 0) {
    long long rej = 0, cov = 0;
    for (int j = tid; j < n; j += nt) {
      const uint8_t f = flags[j];
      if ((f & kAccepted) && !(f & kWasActive)) cov += width_s[j];
      if ((f & kValid) && !(f & kAccepted)) rej += 1;
    }
    for (int off = 16; off > 0; off >>= 1) {
      rej += __shfl_down_sync(0xffffffffu, rej, off);
      cov += __shfl_down_sync(0xffffffffu, cov, off);
    }
    if (lane == 0) {
      red[0][warp] = rej;
      red[1][warp] = cov;
    }
  }
  if (warp == 0) {
    int na = 0, nh = 0;
    const unsigned below = (1u << lane) - 1u;
    for (int base = 0; base < n; base += 32) {
      const int j = base + lane;
      const uint8_t f = j < n ? flags[j] : 0;
      const unsigned acc = __ballot_sync(0xffffffffu, (f & kAccepted) != 0);
      const unsigned head = __ballot_sync(0xffffffffu, (f & kHead) != 0);
      if (f & kAccepted) accl[na + __popc(acc & below)] = j;
      if (f & kHead) nxt[nh + __popc(head & below)] = j;  // the links are spent
      na += __popc(acc);
      nh += __popc(head);
    }
    if (lane == 0) {
      n_acc = na;
      n_heads = nh;
    }
  }
  __syncthreads();
  if (q == 0 && tid == 0) {
    long long rej = 0, cov = 0;
    for (int w = 0; w < nt / 32; ++w) {
      rej += red[0][w];
      cov += red[1][w];
    }
    covered[s] = (kCarry ? covered[s] : covered0[s]) + cov;
    rejected[s] = (kCarry ? rejected[s] : rejected0[s]) + rej;
  }
  const int na = n_acc, nh = n_heads;
  const int* heads = nxt;

  // 2. the sums of this block's features: the deltas of a chunk of accepted
  // ranks at once (kBatch loads in flight per thread), then each feature's
  // thread adds them in rank order
  const int fq = f_hi - f_lo;
  const int ft = fq < nt ? fq : nt;
  for (int f0 = f_lo; f0 < f_hi; f0 += ft) {
    const int fw = f_hi - f0 < ft ? f_hi - f0 : ft;
    const int chunk = kMaxDelta / fw;
    double acc = tid < fw ? sums_in[s * F + f0 + tid] : 0.0;
    for (int a0 = 0; a0 < na; a0 += chunk) {
      const int nc = na - a0 < chunk ? na - a0 : chunk;
      const int total = nc * fw;
      for (int base = 0; base < total; base += nt * kBatch) {
        double v[kBatch], o[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = base + u * nt + tid;
          v[u] = 0.0;
          o[u] = 0.0;
          if (i < total) {
            const int f = f0 + i % fw;
            const int j = accl[a0 + i / fw];
            v[u] = vals_r[(sR + j) * F + f];
            if (flags[j] & kWasActive) {
              const int pa = prevacc[j];
              o[u] = pa >= 0 ? vals_r[(sR + pa) * F + f] : values_in[(sE + slot[j]) * F + f];
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = base + u * nt + tid;
          if (i < total) delta[i] = __dsub_rn(v[u], o[u]);
        }
      }
      __syncthreads();
      if (tid < fw) {
#pragma unroll 8
        for (int a = 0; a < nc; ++a) acc = __dadd_rn(acc, delta[a * fw + tid]);
      }
      __syncthreads();  // the next chunk overwrites the deltas (and step 3 the
                        // rows whose old values this chunk read)
    }
    if (tid < fw) sums[s * F + f0 + tid] = acc;
  }

  // 3. the rows the window's events name: the last accepted value and tag,
  // or the old row (which, past the first of several windows, is in place)
  // (R * F < 2^31: the wrapper refuses larger shapes, so int indices hold)
  const int total = nh * fq;
  for (int base = 0; base < total; base += nt * kBatch) {
    double v[kBatch];
    int64_t at[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * nt + tid;
      at[u] = -1;
      if (i < total) {
        const int h = heads[i / fq];
        const int src = last[h];
        if (!kCarry || src >= 0) {
          const int f = f_lo + i % fq;
          at[u] = (sE + slot[h]) * F + f;
          v[u] = src >= 0 ? vals_r[(sR + src) * F + f] : values0[at[u]];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (at[u] >= 0) values[at[u]] = v[u];
  }
  if (q == 0) {
    for (int i = tid; i < nh; i += nt) {
      const int h = heads[i];
      const int src = last[h];
      if (!kCarry || src >= 0) iters[sE + slot[h]] = src >= 0 ? tag_r[sR + src] : iters0[sE + slot[h]];
    }
  }
}

// Scenario s's walk, by walk block q of the scenario's wpb: one window where
// R fits, else (wpb = 1) the windows in rank order over the outputs, which
// first take the inputs' sums, counters and every named row.
__device__ void walk_scenario(
    int64_t s, int q, int f_lo, int f_hi, const bool* __restrict__ valid_r,
    const int64_t* __restrict__ slot_r, const int64_t* __restrict__ tag_r,
    const double* __restrict__ vals_r, const double* __restrict__ sums0,
    const double* __restrict__ values0, const int64_t* __restrict__ iters0,
    const int64_t* __restrict__ covered0, const int64_t* __restrict__ rejected0,
    const int64_t* __restrict__ slot_width, double* __restrict__ sums,
    double* __restrict__ values, int64_t* __restrict__ iters, int64_t* __restrict__ covered,
    int64_t* __restrict__ rejected, int R, int E, int F, unsigned char* smem) {
  if (R <= kWindow) {
    walk_window<false>(s, q, 0, R, f_lo, f_hi, valid_r, slot_r, tag_r, vals_r, sums0, values0,
                       iters0, covered0, rejected0, slot_width, sums, values, iters, covered,
                       rejected, R, E, F, smem);
    return;
  }
  const int tid = threadIdx.x, nt = blockDim.x;
  const int64_t sR = s * R, sE = s * E;
  for (int f = tid; f < F; f += nt) sums[s * F + f] = sums0[s * F + f];
  if (tid == 0) {
    covered[s] = covered0[s];
    rejected[s] = rejected0[s];
  }
  for (int j = tid; j < R; j += nt) {
    const int64_t e = sE + slot_r[sR + j];
    iters[e] = iters0[e];  // a row named twice gets the same value twice
  }
  for (int i = tid; i < R * F; i += nt) {  // R * F < 2^31
    const int64_t at = (sE + slot_r[sR + i / F]) * F + i % F;
    values[at] = values0[at];
  }
  for (int r0 = 0; r0 < R; r0 += kWindow) {
    __syncthreads();  // the window reads what the copy or the window before wrote
    walk_window<true>(s, q, r0, R - r0 < kWindow ? R - r0 : kWindow, f_lo, f_hi, valid_r,
                      slot_r, tag_r, vals_r, sums0, values0, iters0, covered0, rejected0,
                      slot_width, sums, values, iters, covered, rejected, R, E, F, smem);
  }
}

// rows [r0, r1) of scenario s that no event names: copied from the inputs
__device__ void copy_rows(int64_t s, int64_t r0, int64_t r1, const int64_t* __restrict__ slot_r,
                          const double* __restrict__ values0,
                          const int64_t* __restrict__ iters0, double* __restrict__ values,
                          int64_t* __restrict__ iters, int R, int E, int F,
                          unsigned char* named) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int64_t i = tid; i < r1 - r0; i += nt) named[i] = 0;
  __syncthreads();
  for (int j = tid; j < R; j += nt) {
    const int64_t sl = slot_r[s * R + j];
    if (sl >= r0 && sl < r1) named[sl - r0] = 1;  // a benign race: every writer writes 1
  }
  __syncthreads();
  const int64_t sE = s * E;
  for (int64_t e = r0 + tid; e < r1; e += nt)
    if (!named[e - r0]) iters[sE + e] = iters0[sE + e];
  // the rows' F doubles each: one contiguous range; 16-byte copies where
  // both tables are aligned alike
  const int64_t lo = (sE + r0) * F, hi = (sE + r1) * F;
  const bool vec = ((uintptr_t)values0 % 16 == 0) && ((uintptr_t)values % 16 == 0);
  const int64_t a = vec ? ((lo + 1) & ~(int64_t)1) : hi;  // first pair
  const int64_t b = vec ? (hi & ~(int64_t)1) : hi;         // end of the pairs
  const int64_t base = sE * F;
  auto copy1 = [&](int64_t i) {
    if (!named[(i - base) / F - r0]) values[i] = values0[i];
  };
  for (int64_t i = lo + tid; i < (a < hi ? a : hi); i += nt) copy1(i);
  for (int64_t p = a / 2 + tid; p < b / 2; p += nt) {
    const double2 v = reinterpret_cast<const double2*>(values0)[p];
    const int64_t i = 2 * p;
    const bool k0 = !named[(i - base) / F - r0], k1 = !named[(i + 1 - base) / F - r0];
    if (k0 && k1) {
      reinterpret_cast<double2*>(values)[p] = v;
    } else {
      if (k0) values[i] = v.x;
      if (k1) values[i + 1] = v.y;
    }
  }
  for (int64_t i = (b > a ? b : a) + tid; i < hi; i += nt) copy1(i);
}

// blocks [0, S * wpb): the walks, wpb per scenario over slices of the
// features; blocks [S * wpb, S * wpb + S * cps): the copies, rows_per rows of
// one scenario each
__global__ void __launch_bounds__(kThreads) grid_cache_update_kernel(
    const bool* __restrict__ valid_r, const int64_t* __restrict__ slot_r,
    const int64_t* __restrict__ tag_r, const double* __restrict__ vals_r,
    const double* __restrict__ sums0, const double* __restrict__ values0,
    const int64_t* __restrict__ iters0, const int64_t* __restrict__ covered0,
    const int64_t* __restrict__ rejected0, const int64_t* __restrict__ slot_width,
    double* __restrict__ sums, double* __restrict__ values, int64_t* __restrict__ iters,
    int64_t* __restrict__ covered, int64_t* __restrict__ rejected, int S, int R, int E, int F,
    int wpb, int rows_per, int cps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t b = blockIdx.x;
  if (b < (int64_t)S * wpb) {
    const int q = (int)(b % wpb);
    const int per = (F + wpb - 1) / wpb;
    const int f_lo = q * per < F ? q * per : F;
    const int f_hi = f_lo + per < F ? f_lo + per : F;
    walk_scenario(b / wpb, q, f_lo, f_hi, valid_r, slot_r, tag_r, vals_r, sums0, values0,
                  iters0, covered0, rejected0, slot_width, sums, values, iters, covered,
                  rejected, R, E, F, smem);
    return;
  }
  const int64_t cb = b - (int64_t)S * wpb;
  const int64_t s = cb / cps;
  const int64_t r0 = (cb % cps) * rows_per;
  const int64_t r1 = r0 + rows_per < E ? r0 + rows_per : E;
  copy_rows(s, r0, r1, slot_r, values0, iters0, values, iters, R, E, F, smem);
}

}  // namespace

extern "C" {

int dsag_cache_window() { return kWindow; }

// wpb: walk blocks per scenario (each takes a slice of the F features; 1
// where R > kWindow); rows_per: table rows per copy block (1..2048); cps =
// ceil(E / rows_per) copy blocks per scenario; R * F < 2^31; slot_r in
// [0, E).
int dsag_grid_cache_update(
    const bool* valid_r, const int64_t* slot_r, const int64_t* tag_r,
    const double* vals_r, const double* sums0, const double* values0,
    const int64_t* iters0, const int64_t* covered0, const int64_t* rejected0,
    const int64_t* slot_width, double* sums, double* values, int64_t* iters,
    int64_t* covered, int64_t* rejected, int S, int R, int E, int F, int wpb, int rows_per,
    int cps, int device, void* stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.error();
  if (err != cudaSuccess) return (int)err;
  if (S <= 0) return (int)cudaGetLastError();
  if (R < 0 || (int64_t)R * F >= (int64_t(1) << 31) || wpb < 1 || (R > kWindow && wpb != 1) ||
      rows_per < 1 || rows_per > kCopyMaxRows || cps < 0 || (int64_t)cps * rows_per < E ||
      device < 0 || device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  const size_t smem = walk_smem(R < kWindow ? R : kWindow);
  static bool raised[kMaxDevices] = {};
  if (smem > 48 * 1024 && !raised[device]) {
    err = cudaFuncSetAttribute(grid_cache_update_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return (int)err;
    raised[device] = true;
  }
  const int64_t blocks = (int64_t)S * wpb + (int64_t)S * cps;
  grid_cache_update_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      valid_r, slot_r, tag_r, vals_r, sums0, values0, iters0, covered0, rejected0, slot_width,
      sums, values, iters, covered, rejected, S, R, E, F, wpb, rows_per, cps);
  return (int)cudaGetLastError();
}

}  // extern "C"
