"""DSAG gradient cache (paper §5), copied from ``repro.core.gradient_cache``.

The coordinator maintains a set 𝒴 of subgradients keyed by *sample intervals*
``[i, j]`` (1-based, inclusive, matching the paper's notation), each tagged
with the iteration index ``t`` of the iterate it was computed from.  On
receiving ``Y_{i:j}^{(t)}``:

  1. select overlapping cached entries 𝒴';
  2. if any entry of 𝒴' is at least as recent (t' >= t), discard the received
     subgradient (staleness dominance);
  3. otherwise evict 𝒴' and insert the new entry, maintaining the running sum
     ``H = Σ_{y∈𝒴} y`` incrementally:  H += Y - Σ_{y∈𝒴'} y.

Entries are stored in a sorted list keyed by interval start — the ordered-map
stand-in for the paper's tree structure; lookup/insert/delete are
O(log|𝒴| + overlap) via bisect.  The cache also tracks the *coverage*
ξ = (# samples covered)/n used to scale the gradient estimate (paper Eq. 6).

Exact-match fast path: if an entry with identical [i, j] exists, it is
updated in place (paper remark: the update then degrades to SAG's).

Everything here is numpy float64: the scalar ``TrainingSimulator`` keeps a
:class:`GradientCache`, the host engine a :class:`BatchedGradientCache`, and
both add in the order the device engine's cache walk (kernel K3) adds, so
the three agree bit for bit.  The §6 slot universe of the reference
(``SlotUniverse``, ``build_slot_universe``, ``active_slot_capacity``) comes
with the load balancer, which is not ported yet.

Example — staleness dominance and overlap eviction (paper §5):

>>> import numpy as np
>>> from repro_torch.core.gradient_cache import GradientCache
>>> cache = GradientCache(10, np.zeros(2))
>>> cache.insert(1, 5, 0, np.ones(2))       # Y_{1:5}^{(0)} accepted
True
>>> cache.insert(3, 7, 0, np.ones(2))       # overlaps an equally recent entry
False
>>> cache.insert(3, 7, 1, 2 * np.ones(2))   # newer iterate: evicts [1, 5]
True
>>> cache.coverage                           # ξ: only [3, 7] remains
0.5
>>> cache.sum.tolist()
[2.0, 2.0]
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Any

import numpy as np


def scenario_ranks(ev_s: np.ndarray) -> np.ndarray:
    """Position of each event within its scenario's subsequence.

    ``ev_s`` is the per-event scenario index of a *time-ordered* event
    batch; the result assigns 0, 1, 2, ... to each scenario's events in
    order of appearance.  Events sharing a rank belong to distinct
    scenarios, so a rank's updates can be applied as one masked vectorized
    scatter without changing any scenario's sequential semantics.

    >>> scenario_ranks(np.array([0, 1, 0, 1, 1])).tolist()
    [0, 0, 1, 1, 2]
    """
    ev_s = np.asarray(ev_s)
    order = np.argsort(ev_s, kind="stable")
    sorted_s = ev_s[order]
    ranks = np.empty(ev_s.size, dtype=np.int64)
    ranks[order] = np.arange(ev_s.size) - np.searchsorted(
        sorted_s, sorted_s, side="left"
    )
    return ranks


@dataclasses.dataclass
class CacheEntry:
    start: int  # i (inclusive, 1-based)
    stop: int  # j (inclusive, 1-based)
    iteration: int  # t
    value: Any  # the subgradient (numpy/JAX array or pytree leaf container)

    def overlaps(self, start: int, stop: int) -> bool:
        return not (self.stop < start or stop < self.start)

    @property
    def width(self) -> int:
        return self.stop - self.start + 1


class GradientCache:
    """Interval-keyed subgradient cache with incremental sum maintenance."""

    def __init__(self, num_samples: int, zero_like: Any):
        if num_samples <= 0:
            raise ValueError("num_samples must be positive")
        self.num_samples = num_samples
        self._starts: list[int] = []  # sorted entry starts
        self._entries: list[CacheEntry] = []  # parallel to _starts
        self._covered: int = 0
        self._sum = np.array(zero_like, dtype=np.float64, copy=True)
        self.evictions: int = 0  # total entries evicted by overlap (telemetry)
        self.rejected_stale: int = 0

    # -- queries ---------------------------------------------------------
    @property
    def sum(self) -> np.ndarray:
        """H = Σ_{y∈𝒴} y (maintained incrementally)."""
        return self._sum

    @property
    def coverage(self) -> float:
        """ξ: fraction of the n samples covered by cached entries."""
        return self._covered / self.num_samples

    @property
    def num_entries(self) -> int:
        return len(self._entries)

    def entries(self) -> list[CacheEntry]:
        return list(self._entries)

    def _overlapping(self, start: int, stop: int) -> tuple[int, int]:
        """Return [lo, hi) slice of entries overlapping [start, stop].

        Entries are disjoint and sorted by start, so the overlap range is
        contiguous."""
        # first entry whose stop >= start:
        lo = bisect.bisect_left(self._starts, start)
        if lo > 0 and self._entries[lo - 1].stop >= start:
            lo -= 1
        hi = bisect.bisect_right(self._starts, stop)
        return lo, hi

    # -- the §5 update rule -----------------------------------------------
    def insert(self, start: int, stop: int, iteration: int, value: Any) -> bool:
        """Apply the DSAG cache update.  Returns True iff the subgradient was
        accepted (False = discarded as stale-dominated)."""
        if not (1 <= start <= stop <= self.num_samples):
            raise ValueError(
                f"interval [{start},{stop}] outside 1..{self.num_samples}"
            )
        lo, hi = self._overlapping(start, stop)
        overlapping = self._entries[lo:hi]
        # staleness dominance: any overlapping entry at least as recent wins
        for e in overlapping:
            if e.iteration >= iteration:
                self.rejected_stale += 1
                return False
        # exact-match in-place fast path (degrades to the SAG update)
        if len(overlapping) == 1 and overlapping[0].start == start and overlapping[0].stop == stop:
            e = overlapping[0]
            self._sum += np.asarray(value, dtype=np.float64) - np.asarray(
                e.value, dtype=np.float64
            )
            e.value = value
            e.iteration = iteration
            return True
        # evict overlaps, insert new
        removed_width = 0
        for e in overlapping:
            self._sum -= np.asarray(e.value, dtype=np.float64)
            removed_width += e.width
        self.evictions += len(overlapping)
        del self._entries[lo:hi]
        del self._starts[lo:hi]
        pos = bisect.bisect_left(self._starts, start)
        self._starts.insert(pos, start)
        self._entries.insert(pos, CacheEntry(start, stop, iteration, value))
        self._sum += np.asarray(value, dtype=np.float64)
        self._covered += (stop - start + 1) - removed_width
        return True

    # -- elastic-fleet death clear ------------------------------------------
    def clear_range(self, start: int, stop: int) -> int:
        """Drop every active entry overlapping ``[start, stop]`` (1-based).

        The churn semantics: when a worker dies, its cached subgradients are
        no longer refreshable and are removed from 𝒴 at the next assignment.
        Entries are subtracted from the running sum in *interval-start
        ascending* order — the canonical float order every engine must
        reproduce for bit-exactness — and the drop does NOT count as an
        overlap eviction (``evictions`` is §5 telemetry, not churn).
        Idempotent: clearing an already-empty range removes nothing.
        Returns the number of entries removed.
        """
        lo, hi = self._overlapping(start, stop)
        removed = self._entries[lo:hi]
        for e in removed:  # slice is already start-ascending
            self._sum -= np.asarray(e.value, dtype=np.float64)
            self._covered -= e.width
        del self._entries[lo:hi]
        del self._starts[lo:hi]
        return len(removed)

    # -- invariant checks (used by property tests) -------------------------
    def check_invariants(self) -> None:
        assert self._starts == [e.start for e in self._entries]
        assert all(
            self._entries[k].stop < self._entries[k + 1].start
            for k in range(len(self._entries) - 1)
        ), "entries must be disjoint and sorted"
        width = sum(e.width for e in self._entries)
        assert width == self._covered, f"coverage mismatch {width} != {self._covered}"
        recomputed = np.zeros_like(self._sum)
        for e in self._entries:
            recomputed = recomputed + np.asarray(e.value, dtype=np.float64)
        np.testing.assert_allclose(recomputed, self._sum, rtol=1e-9, atol=1e-9)


class BatchedGradientCache:
    """S independent §5 caches sharing one interval-slot table.

    How this differs from :class:`GradientCache`: the scalar cache keys a
    sorted entry list per run; here the *interval universe* (every [i, j]
    ever inserted, across all scenarios) is a single slot table, and the
    per-scenario state is dense arrays over those slots — iteration tags
    ``[E, S]``, float64 values ``[E, S, ...]``, running sums ``[S, ...]``
    and coverage ``[S]``.  Scenarios replaying the same fleet share the
    same partition arithmetic, so their intervals coincide and the fast
    path (an active exact-match slot, the SAG-style in-place update) is a
    dict lookup + one fused add — no per-entry Python objects, no bisect.

    Per-scenario semantics are exactly the scalar cache's §5 update rule
    (staleness dominance, overlap eviction in start order, incremental sum
    maintenance), applied event-by-event so the float accumulation order —
    and therefore every bit of ``sums`` — matches a scalar
    :class:`GradientCache` fed the same per-scenario insert sequence.
    """

    def __init__(self, num_scenarios: int, num_samples: int, zero_like: Any):
        if num_scenarios <= 0 or num_samples <= 0:
            raise ValueError("num_scenarios and num_samples must be positive")
        self.num_scenarios = num_scenarios
        self.num_samples = num_samples
        zero = np.array(zero_like, dtype=np.float64, copy=True)
        self._value_shape = zero.shape
        self._sums = np.zeros((num_scenarios,) + zero.shape, dtype=np.float64)
        self._covered = np.zeros(num_scenarios, dtype=np.int64)
        self.evictions = np.zeros(num_scenarios, dtype=np.int64)
        self.rejected_stale = np.zeros(num_scenarios, dtype=np.int64)
        self._slot_of: dict = {}  # (start, stop) -> slot index
        self._intervals: list[tuple[int, int]] = []
        # parallel numpy views of the interval universe (vectorized overlap
        # tests in insert_events); rows past len(_intervals) are unused
        cap = 8
        self._int_starts = np.zeros(cap, dtype=np.int64)
        self._int_stops = np.zeros(cap, dtype=np.int64)
        self._iters = np.full((cap, num_scenarios), -1, dtype=np.int64)
        self._values = np.zeros((cap,) + self._sums.shape, dtype=np.float64)

    # -- queries ---------------------------------------------------------
    @property
    def sums(self) -> np.ndarray:
        """[S, ...] running sums H_s (same bits as scalar caches)."""
        return self._sums

    @property
    def coverage(self) -> np.ndarray:
        """[S] coverage fractions ξ_s."""
        return self._covered / self.num_samples

    def _ensure_slot(self, start: int, stop: int) -> int:
        slot = self._slot_of.get((start, stop))
        if slot is not None:
            return slot
        slot = len(self._intervals)
        if slot >= self._iters.shape[0]:
            grow = self._iters.shape[0]
            self._iters = np.concatenate(
                [self._iters, np.full((grow, self.num_scenarios), -1, np.int64)]
            )
            self._values = np.concatenate(
                [self._values, np.zeros((grow,) + self._sums.shape)]
            )
            self._int_starts = np.concatenate(
                [self._int_starts, np.zeros(grow, np.int64)]
            )
            self._int_stops = np.concatenate([self._int_stops, np.zeros(grow, np.int64)])
        self._slot_of[(start, stop)] = slot
        self._intervals.append((start, stop))
        self._int_starts[slot] = start
        self._int_stops[slot] = stop
        return slot

    def insert(self, s: int, start: int, stop: int, iteration: int, value: Any) -> bool:
        """Apply the §5 update for scenario ``s``; True iff accepted."""
        if not (1 <= start <= stop <= self.num_samples):
            raise ValueError(f"interval [{start},{stop}] outside 1..{self.num_samples}")
        exact = self._slot_of.get((start, stop))
        if exact is not None and self._iters[exact, s] >= 0:
            # active entries are disjoint, so an active exact match is the
            # ONLY overlap — the scalar fast path (SAG in-place update)
            if self._iters[exact, s] >= iteration:
                self.rejected_stale[s] += 1
                return False
            v64 = np.asarray(value, dtype=np.float64)
            self._sums[s] += v64 - self._values[exact, s]
            self._values[exact, s] = v64
            self._iters[exact, s] = iteration
            return True
        # slow path: scan active slots for overlaps (in start order, like the
        # scalar sorted-entry walk)
        overlapping = [
            slot
            for slot, (a, b) in enumerate(self._intervals)
            if self._iters[slot, s] >= 0 and not (b < start or stop < a)
        ]
        overlapping.sort(key=lambda slot: self._intervals[slot][0])
        for slot in overlapping:
            if self._iters[slot, s] >= iteration:
                self.rejected_stale[s] += 1
                return False
        v64 = np.asarray(value, dtype=np.float64)
        removed_width = 0
        for slot in overlapping:
            self._sums[s] -= self._values[slot, s]
            a, b = self._intervals[slot]
            removed_width += b - a + 1
            self._iters[slot, s] = -1
        self.evictions[s] += len(overlapping)
        target = self._ensure_slot(start, stop)
        self._iters[target, s] = iteration
        self._values[target, s] = v64
        self._sums[s] += v64
        self._covered[s] += (stop - start + 1) - removed_width
        return True

    def insert_events(
        self,
        ev_s: np.ndarray,
        ev_start: np.ndarray,
        ev_stop: np.ndarray,
        ev_iter: np.ndarray,
        values: np.ndarray,
    ) -> np.ndarray:
        """Apply a *time-ordered* batch of §5 updates as masked scatters.

        ``values`` is ``[K, ...]``; events must arrive in event-time order
        (per-scenario subsequences are what the §5 semantics depend on —
        scenarios are independent).  Events are regrouped by within-scenario
        rank (:func:`scenario_ranks`): one rank holds at most one event per
        scenario, so its updates apply as a single vectorized masked scatter
        with per-event float expressions identical to :meth:`insert` — the
        result is bit-for-bit the same as K sequential inserts, without the
        per-event Python loop.  Overlapping-but-not-exact events (which
        occur only after a §6 repartition) fall back to the scalar slow path
        at their correct sequence position.

        Returns the ``[K]`` accepted mask.
        """
        ev_s = np.asarray(ev_s, dtype=np.int64)
        ev_start = np.asarray(ev_start, dtype=np.int64)
        ev_stop = np.asarray(ev_stop, dtype=np.int64)
        ev_iter = np.asarray(ev_iter, dtype=np.int64)
        K = ev_s.size
        accepted = np.zeros(K, dtype=bool)
        if K == 0:
            return accepted
        if np.any((ev_start < 1) | (ev_stop > self.num_samples) | (ev_start > ev_stop)):
            bad = np.flatnonzero(
                (ev_start < 1) | (ev_stop > self.num_samples) | (ev_start > ev_stop)
            )[0]
            raise ValueError(
                f"interval [{ev_start[bad]},{ev_stop[bad]}] outside "
                f"1..{self.num_samples}"
            )
        ranks = scenario_ranks(ev_s)
        n_active = len(self._intervals)
        for r in range(int(ranks.max()) + 1):
            idx = np.flatnonzero(ranks == r)
            # classify each event (<= S of them): exact-active fast path,
            # overlap-free simple insert, or scalar eviction fallback
            fast, simple = [], []
            for j in idx:
                s, a, b = int(ev_s[j]), int(ev_start[j]), int(ev_stop[j])
                slot = self._slot_of.get((a, b))
                if slot is not None and self._iters[slot, s] >= 0:
                    fast.append((j, slot))
                    continue
                n_active = len(self._intervals)
                overlap = (
                    (self._iters[:n_active, s] >= 0)
                    & (self._int_starts[:n_active] <= b)
                    & (a <= self._int_stops[:n_active])
                )
                if overlap.any():
                    accepted[j] = self.insert(s, a, b, int(ev_iter[j]), values[j])
                else:
                    simple.append((j, self._ensure_slot(a, b)))
            if fast:
                j_arr = np.array([j for j, _ in fast])
                slot_arr = np.array([sl for _, sl in fast])
                s_arr = ev_s[j_arr]
                dom = self._iters[slot_arr, s_arr] >= ev_iter[j_arr]
                np.add.at(self.rejected_stale, s_arr[dom], 1)
                acc = ~dom
                if acc.any():
                    ja, sa, sl = j_arr[acc], s_arr[acc], slot_arr[acc]
                    v64 = np.asarray(values[ja], dtype=np.float64)
                    # active entries are disjoint, so an active exact match
                    # is the only overlap — the SAG-style in-place update
                    self._sums[sa] += v64 - self._values[sl, sa]
                    self._values[sl, sa] = v64
                    self._iters[sl, sa] = ev_iter[ja]
                    accepted[ja] = True
            if simple:
                j_arr = np.array([j for j, _ in simple])
                slot_arr = np.array([sl for _, sl in simple])
                s_arr = ev_s[j_arr]
                v64 = np.asarray(values[j_arr], dtype=np.float64)
                self._sums[s_arr] += v64
                self._values[slot_arr, s_arr] = v64
                self._iters[slot_arr, s_arr] = ev_iter[j_arr]
                self._covered[s_arr] += ev_stop[j_arr] - ev_start[j_arr] + 1
                accepted[j_arr] = True
        return accepted

    # -- elastic-fleet death clear ------------------------------------------
    def clear_range(self, s: int, start: int, stop: int) -> int:
        """Scenario-``s`` counterpart of :meth:`GradientCache.clear_range`.

        Active slots overlapping ``[start, stop]`` are subtracted from
        ``sums[s]`` in interval-start ascending order (the canonical churn
        float order) and deactivated; ``evictions`` is untouched.  Returns
        the number of entries removed.
        """
        n_active = len(self._intervals)
        hit = np.flatnonzero(
            (self._iters[:n_active, s] >= 0)
            & (self._int_starts[:n_active] <= stop)
            & (start <= self._int_stops[:n_active])
        )
        hit = hit[np.argsort(self._int_starts[hit], kind="stable")]
        for slot in hit:
            self._sums[s] -= self._values[slot, s]
            self._covered[s] -= self._int_stops[slot] - self._int_starts[slot] + 1
            self._iters[slot, s] = -1
        return int(hit.size)

    # -- invariant checks (used by tests) ----------------------------------
    def check_invariants(self) -> None:
        for s in range(self.num_scenarios):
            active = [
                (a, b, slot)
                for slot, (a, b) in enumerate(self._intervals)
                if self._iters[slot, s] >= 0
            ]
            active.sort()
            assert all(
                active[k][1] < active[k + 1][0] for k in range(len(active) - 1)
            ), f"scenario {s}: active entries overlap"
            width = sum(b - a + 1 for a, b, _ in active)
            assert width == self._covered[s], f"scenario {s}: coverage mismatch"
            recomputed = np.zeros(self._value_shape)
            for _, _, slot in active:
                recomputed = recomputed + self._values[slot, s]
            np.testing.assert_allclose(recomputed, self._sums[s], rtol=1e-9, atol=1e-9)
