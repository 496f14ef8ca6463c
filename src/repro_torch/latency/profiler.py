"""Moving-window latency profiler (paper §6.1), copied from
``repro.latency.profiler``.

For each worker the coordinator records the round-trip time between sending
an iterate and receiving the response; the worker reports its own
compute-only time inside the response.  The profiler takes the reported time
as a computation-latency sample and the difference as a
communication-latency sample, and gives mean and variance over a moving time
window (samples older than ``window`` seconds are dropped).  The scalar
``TrainingSimulator`` records every completion here.  The task-slot
:class:`MomentBuffer` is the view the §6 load balancer reads, in every
engine.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch.experiments.engine import checked_device
from repro_torch.latency.model import GammaParams
from repro_torch.lb.jit_optimizer import PROFILER_WINDOW, window_moments


@dataclasses.dataclass(frozen=True)
class LatencySample:
    worker: int
    t_recorded: float  # wall/sim time at which the sample was taken
    round_trip: float  # coordinator-observed send->receive latency
    compute: float  # worker-reported compute latency
    load: float  # computational load (c) of the task that produced this


@dataclasses.dataclass
class WorkerStats:
    e_comm: float
    v_comm: float
    e_comp: float
    v_comp: float
    mean_load: float
    num_samples: int

    @property
    def e_total(self) -> float:
        return self.e_comm + self.e_comp

    def comm_gamma(self) -> GammaParams:
        return GammaParams.from_mean_var(max(self.e_comm, 1e-12), max(self.v_comm, 1e-18))

    def comp_gamma_per_unit(self) -> GammaParams:
        """Gamma of the per-unit-load computation latency (for what-if
        re-scaling by the optimizer, paper §6.2 linearisation)."""
        e = max(self.e_comp / max(self.mean_load, 1e-12), 1e-12)
        v = max(self.v_comp / max(self.mean_load, 1e-12) ** 2, 1e-18)
        return GammaParams.from_mean_var(e, v)


@dataclasses.dataclass(frozen=True)
class ProfilerMoments:
    """Per-worker moment arrays ([N]) for the load-balancing optimizer."""

    e_comm: np.ndarray
    v_comm: np.ndarray
    e_comp: np.ndarray
    v_comp: np.ndarray
    mean_load: np.ndarray
    num_samples: np.ndarray


class MomentBuffer:
    """Task-slot sample buffers behind the engines' §6.1 profiler view.

    Dense ``[S, N, T]`` numpy arrays indexed by the *iteration that started
    the task* (each (scenario, worker, iteration) starts at most one task,
    observed at most once, so the slot is unique).  The moments come from
    :func:`repro_torch.lb.jit_optimizer.window_moments`, which the device
    engine also calls on its own slot tensors, so the §6 optimizer sees the
    same moments, bit for bit, in the scalar simulator (``S = 1``), the host
    engine and the device engine.  ``device`` is where they are computed
    (default the card, as ``EngineConfig``'s; a missing card is refused with
    ``cuda-device-unavailable``).
    """

    def __init__(self, num_scenarios: int, num_workers: int, capacity: int, *,
                 device="cuda"):
        shape = (num_scenarios, num_workers, capacity)
        self.t_rec = np.zeros(shape)
        self.comm = np.zeros(shape)
        self.comp = np.zeros(shape)
        self.valid = np.zeros(shape, dtype=bool)
        self.device = checked_device(device)

    def record(self, s, workers, titers, t_recorded, round_trip, compute) -> None:
        """Record observed completions (parallel arrays; ``s`` broadcastable).
        The communication sample is ``max(round_trip - compute, 0)``."""
        self.t_rec[s, workers, titers] = t_recorded
        self.comm[s, workers, titers] = np.maximum(
            np.asarray(round_trip, np.float64) - np.asarray(compute, np.float64), 0.0
        )
        self.comp[s, workers, titers] = compute
        self.valid[s, workers, titers] = True

    def moments(self, now, *, window: float | None = None, since=None):
        """``(e_comm, v_comm, e_comp, v_comp, counts)`` numpy arrays at the
        per-scenario times ``now``; a worker with no in-window sample
        reports count 0.  ``since`` (per scenario, optional) drops samples
        recorded before it: the churn re-profiling cutoff."""
        def t(a):
            return torch.as_tensor(a, device=self.device)

        out = window_moments(
            t(self.t_rec), t(self.comm), t(self.comp), t(self.valid),
            t(np.asarray(now, np.float64)),
            float(PROFILER_WINDOW if window is None else window),
            since=None if since is None else t(np.asarray(since, np.float64)),
        )
        return tuple(o.cpu().numpy() for o in out)


class LatencyProfiler:
    """Per-worker moving-window mean/variance of comm and comp latency."""

    def __init__(self, num_workers: int, *, window: float = 10.0):
        self.num_workers = num_workers
        self.window = window
        self._samples: list[deque] = [deque() for _ in range(num_workers)]

    def record(self, sample: LatencySample) -> None:
        if not (0 <= sample.worker < self.num_workers):
            raise ValueError(f"worker {sample.worker} out of range")
        comm = max(sample.round_trip - sample.compute, 0.0)
        dq = self._samples[sample.worker]
        dq.append((sample.t_recorded, comm, sample.compute, sample.load))

    def record_batch(
        self,
        workers: np.ndarray,
        t_recorded: np.ndarray,
        round_trip: np.ndarray,
        compute: np.ndarray,
        load: np.ndarray,
    ) -> int:
        """Bulk-insert samples from parallel arrays (batched-trace feed).

        Entries are sorted by ``t_recorded`` per worker so the moving-window
        eviction of :meth:`stats` keeps working; NaN entries (tasks that
        never ran in a replayed trace) are dropped.  Returns the number of
        samples recorded.
        """
        workers = np.asarray(workers, dtype=np.int64)
        load = np.broadcast_to(np.asarray(load, dtype=np.float64), workers.shape).ravel()
        workers = workers.ravel()
        t_recorded = np.asarray(t_recorded, dtype=np.float64).ravel()
        round_trip = np.asarray(round_trip, dtype=np.float64).ravel()
        compute = np.asarray(compute, dtype=np.float64).ravel()
        ok = ~(np.isnan(t_recorded) | np.isnan(round_trip) | np.isnan(compute))
        if not ok.all():
            workers, t_recorded, round_trip, compute, load = (
                a[ok] for a in (workers, t_recorded, round_trip, compute, load)
            )
        if workers.size == 0:
            return 0
        if np.any((workers < 0) | (workers >= self.num_workers)):
            raise ValueError("worker index out of range in batch")
        comm = np.maximum(round_trip - compute, 0.0)
        order = np.lexsort((t_recorded, workers))
        workers, t_recorded, comm, compute, load = (
            a[order] for a in (workers, t_recorded, comm, compute, load)
        )
        bounds = np.searchsorted(workers, np.arange(self.num_workers + 1))
        for i in range(self.num_workers):
            lo, hi = bounds[i], bounds[i + 1]
            if lo < hi:
                dq = self._samples[i]
                dq.extend(
                    zip(t_recorded[lo:hi], comm[lo:hi], compute[lo:hi], load[lo:hi])
                )
                if len(dq) > hi - lo and dq[-(hi - lo) - 1][0] > t_recorded[lo]:
                    # batch starts before existing samples (e.g. a second
                    # replayed scenario whose clock restarts at 0): re-sort so
                    # _evict's front-only scan keeps seeing time order
                    ordered = sorted(dq)
                    dq.clear()
                    dq.extend(ordered)
        return int(workers.size)

    def _evict(self, worker: int, now: float) -> None:
        dq = self._samples[worker]
        cutoff = now - self.window
        while dq and dq[0][0] < cutoff:
            dq.popleft()

    def stats(self, worker: int, now: float) -> WorkerStats | None:
        self._evict(worker, now)
        dq = self._samples[worker]
        if len(dq) == 0:
            return None
        arr = np.asarray(dq, dtype=np.float64)  # [k, 4]
        comm, comp, load = arr[:, 1], arr[:, 2], arr[:, 3]
        return WorkerStats(
            e_comm=float(comm.mean()),
            v_comm=float(comm.var()) if len(dq) > 1 else 1e-12,
            e_comp=float(comp.mean()),
            v_comp=float(comp.var()) if len(dq) > 1 else 1e-12,
            mean_load=float(load.mean()),
            num_samples=len(dq),
        )

    def all_stats(self, now: float) -> dict[int, WorkerStats]:
        out = {}
        for i in range(self.num_workers):
            s = self.stats(i, now)
            if s is not None:
                out[i] = s
        return out

    def moment_arrays(self, now: float) -> ProfilerMoments | None:
        """All workers' moments as [N] arrays (the §6.2 optimizer feed).

        Returns None unless every worker has at least one in-window sample —
        the gate the load-balancing loop applies before invoking Algorithm 1.
        """
        stats = self.all_stats(now)
        if len(stats) < self.num_workers:
            return None
        idx = range(self.num_workers)
        return ProfilerMoments(
            e_comm=np.array([stats[i].e_comm for i in idx]),
            v_comm=np.array([stats[i].v_comm for i in idx]),
            e_comp=np.array([stats[i].e_comp for i in idx]),
            v_comp=np.array([stats[i].v_comp for i in idx]),
            mean_load=np.array([stats[i].mean_load for i in idx]),
            num_samples=np.array([stats[i].num_samples for i in idx]),
        )
