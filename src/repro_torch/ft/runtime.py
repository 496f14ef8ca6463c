"""Tier-2 runtime control: deadlines, failure handling, elastic rescale.

Copied from ``repro.ft.runtime`` (numpy only) with its imports pointed at
this package; the event machine, its draw order and the persistent
``default_rng(0)`` of :meth:`DeadlineController.deadline` are unchanged, so
both packages give the same step inputs for the same latencies.

This is the host-side loop that turns the paper's coordinator behavior into
the mask/flush/evict inputs of the compiled DSAG step:

* :class:`DeadlineController` — a virtual-time twin of the JAX package's
  scalar ``TrainingSimulator`` event loop.  Each call to
  :meth:`DeadlineController.step_inputs` runs one iteration of the §4.2
  two-state worker machine (length-1 FILO queues, wait-for-w collection,
  the §5.1 margin rule) and returns the (mask, flush, evict) vector the
  compiled Tier-1 step consumes.  Because it uses the same shared float
  helpers (:func:`task_finish_time`, :func:`margin_deadline`) and the same
  heap discipline as the simulator, replaying one ``FleetTraces`` scenario
  through both produces bit-identical step-input streams — the cross-layer
  pin exercised by ``tests/test_live_validation.py`` and, for this
  copy, ``tests/test_torch_live.py``.
* :class:`FailureDetector` — heartbeat bookkeeping: a group missing
  ``max_misses`` consecutive deadlines is declared failed; DSAG proceeds with
  its mask permanently 0 (that is the paper's point — missing partitions only
  freeze ξ, they do not block progress) until the group rejoins.
* :func:`elastic_remap_groups` — on a DP-degree change (node loss / rescale),
  re-map sample->group assignment with the paper's Algorithm-2 alignment so
  surviving cache entries stay aligned to partition boundaries; unaligned
  slots are invalidated (mirrors §6.3 cache evictions).
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from collections.abc import Callable

import numpy as np

from repro_torch.cluster.simulator import margin_deadline, task_finish_time
from repro_torch.latency.model import GammaParams
from repro_torch.lb.partitioner import align_partitions, p_start, p_stop

#: ``latency_of(group, now) -> (comp_latency, comm_latency)`` — called once
#: per *started* task, in worker-index assignment order then queued-restart
#: (pop) order, matching the scalar simulator's draw-consumption order.
LatencyFn = Callable[[int, float], tuple[float, float]]


@dataclasses.dataclass
class StepInputs:
    """One step's coordinator decision, as consumed by ``dsag_update``.

    ``mask[i]``  — group i delivered this step's gradient within the
    collection window (the w-th-fresh margin deadline of §5.1).
    ``flush[i]`` — a *stale* result from group i landed this step and was
    accepted into the gradient cache (§5 staleness-dominance rule).
    ``evict[i]`` — group i died this step and its cache entry was cleared
    (§6.3); ξ drops until the group refills its slot.
    """

    mask: np.ndarray  # [G] bool
    flush: np.ndarray  # [G] bool
    evict: np.ndarray  # [G] bool
    iter_start: float  # virtual time at which this step's tasks were assigned
    elapsed: float  # virtual time the collection took (now - iter_start)
    deadline: float  # §5.1 margin deadline (inf when the margin is inactive)


@dataclasses.dataclass
class DeadlineController:
    """Per-step (mask, flush, evict) selection for the live DSAG trainer.

    The controller is an event machine over virtual time: groups are the
    §4.2 two-state workers, tasks are per-step gradient computations, and
    latencies come from ``latency_of`` (a trace replay, a live sampler, or
    real measured round-trips).  ``accepts_stale=True`` gives DSAG
    semantics (stale arrivals flush into the cache and the §5.1 margin
    keeps collecting past the w-th fresh result); ``False`` gives SAG
    (stale arrivals are dropped, collection stops at the w-th fresh).
    """

    num_groups: int
    w: int  # wait for the w fastest groups
    margin: float = 0.02  # paper §5.1
    window: int = 50  # latency samples kept per group (telemetry/prediction)
    accepts_stale: bool = True  # DSAG; False = SAG-style fresh-only

    def __post_init__(self):
        if not (1 <= self.w <= self.num_groups):
            raise ValueError(f"w={self.w} not in 1..{self.num_groups}")
        self._lat: list[list[float]] = [[] for _ in range(self.num_groups)]
        self._rng = np.random.default_rng(0)  # persistent: fresh draws per call
        # ---- event-machine state (virtual-time twin of the simulator) ----
        self._now = 0.0
        self._step = 0
        self._seq = 0
        #: (finish, seq, generation, group, task_iteration, latency); a
        #: group's generation is bumped when a death discards its in-flight
        #: task, invalidating the queued heap event without disturbing the
        #: (finish, seq) pop order
        self._heap: list[tuple[float, int, int, int, int, float]] = []
        self._gen = np.zeros(self.num_groups, dtype=np.int64)
        self._busy_until = np.zeros(self.num_groups, dtype=np.float64)
        self._queued: list[int | None] = [None] * self.num_groups
        self._filled = np.zeros(self.num_groups, dtype=bool)  # cache slot held

    # ---- telemetry / §5.1 prediction ------------------------------------
    @property
    def now(self) -> float:
        """Current virtual time (completion time of the last step)."""
        return self._now

    def record(self, group: int, latency: float) -> None:
        dq = self._lat[group]
        dq.append(latency)
        if len(dq) > self.window:
            dq.pop(0)

    def deadline(self) -> float:
        """Predicted latency of the w-th fastest group, plus the margin.

        Monte-Carlo order statistic under per-group gammas (§4.1) fitted to
        the profiled moving window.  This is the *predictive* deadline used
        for reporting; the per-step collection window itself is event-driven
        (the §5.1 rule relative to the observed w-th fresh arrival).
        """
        means = np.array(
            [np.mean(l) if l else np.inf for l in self._lat], dtype=np.float64
        )
        if np.isinf(means).any():
            return np.inf  # no profile yet: wait for everyone
        stds = np.array(
            [np.std(l) if len(l) > 1 else means[i] * 0.1 for i, l in enumerate(self._lat)]
        )
        draws = np.stack(
            [
                GammaParams.from_mean_var(m, max(s, 1e-9) ** 2).sample(self._rng, 256)
                for m, s in zip(means, stds)
            ],
            axis=1,
        )
        kth = np.partition(draws, self.w - 1, axis=1)[:, self.w - 1]
        return float(kth.mean()) * (1.0 + self.margin)

    # ---- the event machine ----------------------------------------------
    def step_inputs(
        self,
        latency_of: LatencyFn,
        *,
        alive: np.ndarray | None = None,
    ) -> StepInputs:
        """Run one coordinator iteration and return its step inputs.

        ``latency_of(group, now)`` is invoked exactly once per started task
        (idle groups at assignment, then queued restarts as results pop), so
        a trace-backed callable consumes draws in the same order as the
        scalar simulator's ``TraceLatencySource``.  ``alive`` marks groups
        that are up *at assignment time*; a freshly-dead group's in-flight
        task is discarded and its cache slot eviction is reported.
        """
        G = self.num_groups
        mask = np.zeros(G, dtype=bool)
        flush = np.zeros(G, dtype=bool)
        evict = np.zeros(G, dtype=bool)
        now = self._now
        t = self._step

        if alive is None:
            w_eff = self.w
        else:
            alive = np.asarray(alive, dtype=bool)
            for i in range(G):
                if not alive[i]:
                    if self._busy_until[i] > now or self._queued[i] is not None:
                        # dead at assignment: the in-flight completion never
                        # happens and the queued task is dropped
                        self._gen[i] += 1
                        self._busy_until[i] = now
                        self._queued[i] = None
                    if self._filled[i]:
                        evict[i] = True  # §6.3: clear the dead group's slot
                        self._filled[i] = False
            w_eff = min(self.w, int(alive.sum()))

        # assignment, in group-index order (canonical draw order)
        for i in range(G):
            if alive is not None and not alive[i]:
                continue  # dead groups start nothing, consume no draws
            if self._busy_until[i] <= now:
                comp, comm = latency_of(i, now)
                fin = task_finish_time(now, comp, comm)
                heapq.heappush(
                    self._heap,
                    (fin, self._seq, int(self._gen[i]), i, t, comp + comm),
                )
                self._seq += 1
                self._busy_until[i] = fin
            else:
                self._queued[i] = t  # length-1 FILO queue: overwrite

        fresh = 0
        deadline = math.inf
        iter_start = now
        heap = self._heap
        while heap and (fresh < w_eff or heap[0][0] <= deadline):
            fin, sq, g, widx, titer, lat = heapq.heappop(heap)
            if g != self._gen[widx]:
                continue  # discarded by a death event; must not touch `now`
            if fin > deadline:
                heapq.heappush(heap, (fin, sq, g, widx, titer, lat))
                break
            now = fin
            self.record(widx, float(lat))
            # start the queued task immediately (FILO queue of length 1)
            if self._queued[widx] is not None:
                qt = self._queued[widx]
                self._queued[widx] = None
                comp, comm = latency_of(widx, now)
                nfin = task_finish_time(now, comp, comm)
                heapq.heappush(
                    heap,
                    (nfin, self._seq, int(self._gen[widx]), widx, qt, comp + comm),
                )
                self._seq += 1
                self._busy_until[widx] = nfin
            else:
                self._busy_until[widx] = now

            if titer == t:
                mask[widx] = True
                self._filled[widx] = True
                fresh += 1
                if fresh == w_eff:
                    if self.accepts_stale and self.margin > 0:
                        # paper §5.1: wait `margin` longer than the time it
                        # took to collect the w-th fresh result
                        deadline = margin_deadline(now, iter_start, self.margin)
                    else:
                        break
            elif self.accepts_stale:
                # stale arrival accepted into the cache (§5 staleness
                # dominance: per-group task iterations are monotone, so the
                # arrival always dominates the group's existing entry)
                flush[widx] = True
                self._filled[widx] = True

        self._now = now
        self._step = t + 1
        return StepInputs(
            mask=mask,
            flush=flush,
            evict=evict,
            iter_start=iter_start,
            elapsed=now - iter_start,
            deadline=deadline,
        )

    def step_masks(self, latencies: np.ndarray, step: int) -> tuple[np.ndarray, np.ndarray]:
        """Array-style wrapper over :meth:`step_inputs`.

        ``latencies[i]`` is the round-trip each group *would* take if it
        started a task this step; only groups that actually start (idle at
        assignment) consume their entry, so a straggler's old result lands
        on the step its simulated completion time falls in — not
        unconditionally one step after the miss.
        """
        lat = np.asarray(latencies, dtype=np.float64)
        if lat.shape != (self.num_groups,):
            raise ValueError(f"latencies shape {lat.shape} != ({self.num_groups},)")
        si = self.step_inputs(lambda i, now: (float(lat[i]), 0.0))
        return si.mask, si.flush


@dataclasses.dataclass
class FailureDetector:
    num_groups: int
    max_misses: int = 5

    def __post_init__(self):
        self.misses = np.zeros(self.num_groups, dtype=np.int64)
        self.failed = np.zeros(self.num_groups, dtype=bool)

    def observe(self, mask: np.ndarray) -> np.ndarray:
        """Update with this step's mask; returns the failed-group vector."""
        self.misses = np.where(mask, 0, self.misses + 1)
        self.failed = self.misses >= self.max_misses
        return self.failed

    def rejoin(self, group: int) -> None:
        self.misses[group] = 0
        self.failed[group] = False


def elastic_remap_groups(
    n_samples: int, p_old: int, p_new: int, k_old: int = 1
) -> tuple[int, np.ndarray]:
    """Re-map sample->group assignment when the group count changes.

    Returns (k_new, survivors) where survivors[i] (len p_new) marks new
    groups whose sample range exactly matches an old group's range — their
    cache slots can be carried over; the rest start unfilled (ξ drops, DSAG
    refills them over the next steps, per §6.3).  A new group survives only
    if both its start *and* end line up with one old group: matching starts
    alone would carry a coarse group spanning several old groups over a
    cache entry that covers just part of its range, silently biasing H.
    """
    k_al, k_new = align_partitions(n_samples, p_old, p_new, k_old)
    old_ranges = {
        (p_start(n_samples, p_old, i), p_stop(n_samples, p_old, i))
        for i in range(1, p_old + 1)
    }
    survivors = np.array(
        [
            (p_start(n_samples, p_new, i), p_stop(n_samples, p_new, i)) in old_ranges
            for i in range(1, p_new + 1)
        ]
    )
    return k_new, survivors
