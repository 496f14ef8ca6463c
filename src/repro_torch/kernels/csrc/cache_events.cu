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
// Design: one block per scenario, threads over the feature axis F; ranks run
// in order inside the block, because the float64 sums must be accumulated in
// rank order to equal the plain version and the reference bit for bit.  Each
// thread owns the same features at every rank, so values and sums need no
// cross-thread synchronisation; only the slot's tag (read by every thread,
// written by thread 0) does.  The adds are written with __dsub_rn/__dadd_rn:
// there is no multiply to contract, and the intrinsics make that explicit.
//
// What bounds it on the H100: bytes.  It copies the [E, F] value table of
// each scenario once into the output and touches one row per event; the
// rank loop is sequential, so at the main path's sizes (S = 4-10 blocks,
// R = 100-200 ranks) it is latency-bound and uses few SMs.
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void grid_cache_update_kernel(
    const bool* __restrict__ valid_r, const int64_t* __restrict__ slot_r,
    const int64_t* __restrict__ tag_r, const double* __restrict__ vals_r,
    const double* __restrict__ sums0, const double* __restrict__ values0,
    const int64_t* __restrict__ iters0, const int64_t* __restrict__ covered0,
    const int64_t* __restrict__ rejected0,
    const int64_t* __restrict__ slot_width, double* __restrict__ sums,
    double* __restrict__ values, int64_t* __restrict__ iters,
    int64_t* __restrict__ covered, int64_t* __restrict__ rejected, int R,
    int E, int F) {
  const int64_t s = blockIdx.x;
  const int tid = threadIdx.x;
  const int64_t EF = (int64_t)E * F;
  double* tab = values + s * EF;
  int64_t* it = iters + s * E;
  double* sm = sums + s * F;
  // seed the output tables; the walk then updates them in place
  for (int64_t i = tid; i < EF; i += blockDim.x) tab[i] = values0[s * EF + i];
  for (int i = tid; i < E; i += blockDim.x) it[i] = iters0[s * E + i];
  for (int f = tid; f < F; f += blockDim.x) sm[f] = sums0[s * F + f];
  int64_t cov = covered0[s];
  int64_t rej = rejected0[s];
  __syncthreads();
  for (int j = 0; j < R; ++j) {
    const int64_t e = s * R + j;
    const bool valid = valid_r[e];
    const int64_t slot = slot_r[e];
    const int64_t tag = tag_r[e];
    const int64_t cur = it[slot];
    const bool active = cur >= 0;
    const bool acc = valid && !(active && cur >= tag);
    // every thread has read the slot's tag before thread 0 may rewrite it
    __syncthreads();
    if (acc) {
      double* row = tab + slot * F;
      const double* v = vals_r + e * F;
      for (int f = tid; f < F; f += blockDim.x) {
        const double delta = __dsub_rn(v[f], active ? row[f] : 0.0);
        sm[f] = __dadd_rn(sm[f], delta);
        row[f] = v[f];
      }
    }
    if (tid == 0) {
      if (acc) {
        it[slot] = tag;
        if (!active) cov += slot_width[slot];
      } else if (valid) {
        rej += 1;
      }
    }
    // the tag write is visible before the next rank reads it; the feature
    // updates need no barrier (each thread owns its features at every rank)
    __syncthreads();
  }
  if (tid == 0) {
    covered[s] = cov;
    rejected[s] = rej;
  }
}

}  // namespace

extern "C" int dsag_grid_cache_update(
    const bool* valid_r, const int64_t* slot_r, const int64_t* tag_r,
    const double* vals_r, const double* sums0, const double* values0,
    const int64_t* iters0, const int64_t* covered0, const int64_t* rejected0,
    const int64_t* slot_width, double* sums, double* values, int64_t* iters,
    int64_t* covered, int64_t* rejected, int S, int R, int E, int F,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int threads = ((F + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  if (threads < 32) threads = 32;
  grid_cache_update_kernel<<<(unsigned)S, threads, 0, (cudaStream_t)stream>>>(
      valid_r, slot_r, tag_r, vals_r, sums0, values0, iters0, covered0,
      rejected0, slot_width, sums, values, iters, covered, rejected, R, E, F);
  return (int)cudaGetLastError();
}
