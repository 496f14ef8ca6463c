"""Event-driven simulation of iterative w-of-N computations (paper §4.2),
copied from ``repro.latency.event_sim`` (numpy).

Workers are two-state (idle/busy) with a FILO task queue of length 1.  At the
start of each iteration the coordinator assigns a task to every *idle* worker
(busy workers keep their queued task replaced — queue length 1, freshest
iterate wins); the iteration completes once ``w`` tasks assigned *this*
iteration have finished.  A priority queue (heapq) maps workers to their next
busy→idle transition, which is exactly the paper's event-driven strategy.

This simulator is the engine behind both:
  * latency prediction for iterative computations (paper Fig. 6), and
  * the load-balancing optimizer's estimate of the contribution h(p)
    (paper §6.2, via :meth:`EventDrivenSimulator.estimate_contribution`).
"""

from __future__ import annotations

import dataclasses
import heapq
from collections.abc import Callable, Sequence

import numpy as np

from repro_torch.latency.model import ClusterLatencyModel


@dataclasses.dataclass
class SimResult:
    iteration_times: np.ndarray  # [iters] completion time of each iteration
    fresh_counts: np.ndarray  # [iters] # of workers that returned fresh results
    participation: np.ndarray  # [N] fraction of iterations each worker was fresh in


class EventDrivenSimulator:
    """Simulate ``T_w^{(1)}..T_w^{(ell)}`` for a cluster latency model.

    ``loads`` gives the per-worker computational load (c_i); with
    load balancing this is ``base_load_i / p_i`` (one subpartition per task).
    """

    def __init__(
        self,
        cluster: ClusterLatencyModel | None,
        loads: Sequence[float],
        *,
        with_bursts: bool = False,
        latency_provider: Callable[[int, float], float] | None = None,
    ):
        if cluster is None and latency_provider is None:
            raise ValueError("need a cluster model or a latency_provider")
        if cluster is not None and len(loads) != cluster.num_workers:
            raise ValueError("loads must have one entry per worker")
        self.cluster = cluster
        self.loads = np.asarray(loads, dtype=np.float64)
        self.with_bursts = with_bursts
        #: optional trace replay: ``(worker, start_time) -> latency`` consuming
        #: pre-sampled draws (e.g. ``FleetTraces.scalar_latency_provider``)
        #: instead of sampling the cluster model live.
        self.latency_provider = latency_provider

    @property
    def num_workers(self) -> int:
        return self.cluster.num_workers if self.cluster is not None else len(self.loads)

    def run(
        self,
        w: int,
        num_iterations: int,
        *,
        margin: float = 0.0,
        churn=None,
    ) -> SimResult:
        """``churn`` (a :class:`~repro_torch.latency.model.ChurnSchedule`) applies
        the elastic-fleet semantics: liveness is sampled at each iteration's
        assignment time, dead workers discard in-flight tasks (the heap event
        is invalidated via a per-worker generation counter) and the wait uses
        ``w_eff = min(w, #alive)``."""
        n = self.num_workers
        if not (1 <= w <= n):
            raise ValueError(f"w={w} not in 1..{n}")
        rng = self.cluster.rng if self.cluster is not None else None
        now = 0.0
        # (finish_time, worker, iteration_of_task, generation)
        heap: list = []
        busy_until = np.zeros(n)  # next idle time per worker
        queued_iter = -np.ones(n, dtype=np.int64)  # iteration idx of queued task
        gen = np.zeros(n, dtype=np.int64)  # bumped to discard in-flight events
        iteration_times = np.zeros(num_iterations)
        fresh_counts = np.zeros(num_iterations, dtype=np.int64)
        fresh_mask_accum = np.zeros(n, dtype=np.int64)

        def sample_latency(i: int, start: float) -> float:
            if self.latency_provider is not None:
                return float(self.latency_provider(i, start))
            wk = self.cluster.workers[i]
            if self.with_bursts:
                return wk.sample_total(self.loads[i], rng, now=start)
            return wk.sample_comm(rng) + float(
                wk.comp_per_unit.sample(rng)
            ) * self.loads[i] * wk.slowdown

        for t in range(num_iterations):
            if churn is None:
                alive = None
                w_eff = w
            else:
                alive = churn.alive_at(now)
                for i in range(n):
                    if not alive[i] and (busy_until[i] > now or queued_iter[i] >= 0):
                        # dead at assignment: discard the in-flight task and
                        # the queued one — its completion never happens
                        gen[i] += 1
                        busy_until[i] = now
                        queued_iter[i] = -1
                w_eff = min(w, int(alive.sum()))
            # assign a task for iteration t to every worker: idle workers start
            # immediately; busy workers get their length-1 queue overwritten.
            for i in range(n):
                if alive is not None and not alive[i]:
                    continue
                if busy_until[i] <= now:
                    fin = now + sample_latency(i, now)
                    busy_until[i] = fin
                    heapq.heappush(heap, (fin, i, t, int(gen[i])))
                else:
                    queued_iter[i] = t
            fresh = 0
            fresh_this_iter = np.zeros(n, dtype=bool)
            deadline = np.inf
            iter_start = now
            while fresh < w_eff or (heap and heap[0][0] <= deadline):
                if not heap:
                    break
                fin, i, task_iter, g = heapq.heappop(heap)
                if g != gen[i]:
                    continue  # discarded by a death event; must not touch `now`
                if fin > deadline:
                    # margin expired: put the event back and stop collecting
                    heapq.heappush(heap, (fin, i, task_iter, g))
                    break
                now = fin
                # worker i becomes idle; start its queued task if any
                if queued_iter[i] >= 0:
                    nfin = now + sample_latency(i, now)
                    busy_until[i] = nfin
                    heapq.heappush(heap, (nfin, i, int(queued_iter[i]), int(gen[i])))
                    queued_iter[i] = -1
                else:
                    busy_until[i] = now
                if task_iter == t:
                    fresh += 1
                    fresh_this_iter[i] = True
                    if fresh == w_eff and margin > 0.0:
                        # paper §5.1: wait `margin` (e.g. 2%) longer than this
                        # iteration took so far, collecting stragglers.
                        deadline = now + margin * (now - iter_start)
                    elif fresh == w_eff:
                        break
            iteration_times[t] = now
            fresh_counts[t] = fresh
            fresh_mask_accum += fresh_this_iter
        return SimResult(
            iteration_times=iteration_times,
            fresh_counts=fresh_counts,
            participation=fresh_mask_accum / max(num_iterations, 1),
        )

    # -- load-balancer support (paper §6.2) ------------------------------
    def estimate_participation(
        self, w: int, *, num_iterations: int = 100, margin: float = 0.02
    ) -> np.ndarray:
        """u_i(p): fraction of iterations each worker delivers a fresh result
        in, for the loads this simulator was built with (paper §6.2 —
        'u_i can be estimated via event-driven simulations')."""
        return self.run(w, num_iterations, margin=margin).participation


def estimate_contribution(
    cluster: ClusterLatencyModel,
    w: int,
    subpartitions: Sequence[int],
    samples_per_worker: Sequence[int],
    base_loads: Sequence[float],
    *,
    num_iterations: int = 100,
    margin: float = 0.02,
) -> tuple[float, np.ndarray]:
    """h(p) = Σ_i u_i(p)·n_i/(p_i·n) estimated via event-driven simulation.

    ``base_loads[i]`` is worker i's computational load when p_i = 1 (i.e. the
    whole local dataset in one task); per-task load is base_loads[i]/p_i."""
    p = np.asarray(subpartitions, dtype=np.float64)
    n_i = np.asarray(samples_per_worker, dtype=np.float64)
    n = float(n_i.sum())
    loads = np.asarray(base_loads, dtype=np.float64) / np.maximum(p, 1.0)
    sim = EventDrivenSimulator(cluster, loads)
    u = sim.estimate_participation(w, num_iterations=num_iterations, margin=margin)
    h = float(np.sum(u * n_i / (p * n)))
    return h, u


def simulate_iteration_times(
    cluster: ClusterLatencyModel,
    w: int,
    c: float,
    num_iterations: int,
    *,
    margin: float = 0.0,
) -> np.ndarray:
    """Cumulative completion times T_w^(1..ell) for uniform load c."""
    sim = EventDrivenSimulator(cluster, [c] * cluster.num_workers)
    return sim.run(w, num_iterations, margin=margin).iteration_times


def naive_iteration_times(
    cluster: ClusterLatencyModel,
    w: int,
    c: float,
    num_iterations: int,
) -> np.ndarray:
    """The §4.1 model applied per-iteration (no cross-iteration worker state):
    iteration latency = fresh i.i.d.-in-time draw of the w-th order statistic.
    Underestimates for w < N (paper Fig. 6)."""
    lat = cluster.sample_matrix(c, num_iterations)
    per_iter = np.partition(lat, w - 1, axis=1)[:, w - 1]
    return np.cumsum(per_iter)
