"""Partition arithmetic and alignment (paper §6.3), copied from
``repro.lb.partitioner``.

All indices are 1-based inclusive, matching the paper:

    p_start(n, p, i) = floor((i-1)n/p) + 1
    p_stop(n, p, i)  = floor(in/p)
    p_trans(n, p, p', k) = ceil(p_start(n, p, k) * p' / n)

``align_partitions`` is Algorithm 2 (what ``ft.runtime.elastic_remap_groups``
uses to keep surviving cache entries aligned when the group count changes);
:class:`Subpartitioner` is one worker's cyclic walk over its subpartitions
(what the scalar ``TrainingSimulator`` advances per task).  The §6 p-ladder
(:func:`build_p_ladder`, :func:`ladder_intervals`) is the set of
subpartition counts Algorithm 1 climbs (:mod:`repro_torch.lb.jit_optimizer`).

>>> p_start(10, 2, 2), p_stop(10, 2, 2)
(6, 10)
"""

from __future__ import annotations

import dataclasses
import math


def p_start(n: int, p: int, i: int) -> int:
    """First (1-based) sample of the i-th of p partitions of n samples."""
    return (i - 1) * n // p + 1


def p_stop(n: int, p: int, i: int) -> int:
    """Last (1-based) sample of the i-th of p partitions of n samples."""
    return i * n // p


def p_trans(n: int, p: int, p_new: int, k: int) -> int:
    """Index of the partition (out of p_new) containing sample
    p_start(n, p, k)."""
    return math.ceil(p_start(n, p, k) * p_new / n)


def cyclic_increment(k: int, p: int) -> int:
    """k <- mod(k, p) + 1 (paper Eq. 8)."""
    return k % p + 1


#: geometric step and half-span of the default §6 p-ladder (see
#: :func:`build_p_ladder`): candidate subpartition counts range over
#: roughly ``[p0 / LADDER_SPAN, p0 * LADDER_SPAN]`` in ~35% steps.
LADDER_RATIO = 1.35
LADDER_SPAN = 4.0


def build_p_ladder(
    p0: int,
    n_cap: int,
    *,
    ratio: float = LADDER_RATIO,
    span: float = LADDER_SPAN,
) -> tuple[int, ...]:
    """The finite ladder of subpartition counts Algorithm 1 climbs on.

    A geometric grid of integers around the initial subpartition count
    ``p0`` (always a member), clipped to ``[1, n_cap]``.  Restricting the
    hill-climb to this ladder is what lets the fused-scan engine
    pre-allocate the §5 cache's slot universe: every interval any
    repartition can ever produce is one of ``sum(ladder)`` intervals per
    worker, enumerable before the scan starts (see
    :func:`repro.core.gradient_cache.build_slot_universe`).  The trade-off
    is that the optimizer can no longer take ±1% steps or hand a
    comm-bound worker exactly ``n_j`` subpartitions — it moves in ~35%
    steps and tops out at ``min(span * p0, n_cap)``.

    >>> build_p_ladder(10, 1000)
    (2, 3, 4, 5, 7, 10, 14, 18, 25, 33, 40)
    >>> build_p_ladder(10, 4)  # tiny worker: ladder clipped to [1, n_j]
    (2, 3, 4)
    """
    if p0 < 1 or n_cap < 1:
        raise ValueError(f"p0={p0} and n_cap={n_cap} must be >= 1")
    lo = min(max(1, int(math.floor(p0 / span))), n_cap)
    hi = max(lo, min(int(math.ceil(p0 * span)), n_cap))
    vals = set()
    k = 0
    while True:
        v = int(round(p0 * ratio**k))
        if v > hi:
            break
        vals.add(max(lo, v))
        k += 1
    k = -1
    while True:
        v = int(round(p0 * ratio**k))
        if v < lo:
            break
        vals.add(min(hi, v))
        k -= 1
    vals.add(min(max(p0, lo), hi))
    vals.add(lo)
    vals.add(hi)  # span top is always reachable (the minimal-work rung)
    return tuple(sorted(v for v in vals if 1 <= v <= n_cap))


def ladder_intervals(
    base_start: int, base_stop: int, ladder: tuple[int, ...]
) -> list[tuple[int, int]]:
    """Every *global* interval a worker can produce on the ladder.

    For each ladder entry ``p`` (clipped to the worker's local sample
    count), the ``p`` cyclic subpartition intervals in global 1-based
    coordinates, deduplicated (nested ladder entries share boundaries) and
    sorted by start.  This is the per-worker slice of the fused engine's
    pre-allocated slot universe.
    """
    n_local = base_stop - base_start + 1
    if n_local < 1:
        raise ValueError("empty worker range")
    seen = set()
    for raw in ladder:
        p = min(raw, n_local)
        for k in range(1, p + 1):
            lo = base_start + p_start(n_local, p, k) - 1
            hi = base_start + p_stop(n_local, p, k) - 1
            seen.add((lo, hi))
    return sorted(seen)


def _align(n: int, p: int, p_new: int, k: int) -> tuple[int, int]:
    """Algorithm 2 lines 2-6: walk down from k until boundaries align.

    Termination: at k_new = 1 the recomputed k is p_trans(n, p_new, p, 1) = 1
    and partition 1 always starts at sample 1 for any partition count, so the
    pair (1, 1) aligns.  As *printed* in the paper the loop can decrement
    k_new below 1 when the initial k_new = 1 is checked against the original
    (unrelated) k — e.g. n=2, p=2 -> p_new=1 with k=2.  We guard that edge
    case by falling back to the always-valid (1, 1) solution."""
    k_new = p_trans(n, p, p_new, k)  # line 2
    while p_start(n, p_new, k_new) != p_start(n, p, k):  # line 3
        k_new -= 1  # line 4
        if k_new < 1:
            return 1, 1  # guaranteed-aligned fallback (see docstring)
        k = p_trans(n, p_new, p, k_new)  # line 5
    return k, k_new


def align_partitions(n: int, p: int, p_new: int, k: int) -> tuple[int, int]:
    """Algorithm 2.  Returns (k_aligned_old, k_new) such that
    ``p_start(n, p_new, k_new) == p_start(n, p, k_aligned_old)``.

    ``k`` is the index of the partition the worker processed *last*; the
    algorithm first advances it cyclically (line 1), then walks down until the
    boundaries align."""
    if not (1 <= p <= n and 1 <= p_new <= n):
        raise ValueError(f"invalid partition counts p={p}, p_new={p_new} for n={n}")
    if not (1 <= k <= p):
        raise ValueError(f"k={k} out of range 1..{p}")
    k = cyclic_increment(k, p)  # line 1
    return _align(n, p, p_new, k)


@dataclasses.dataclass
class Subpartitioner:
    """Per-worker subpartition bookkeeping (paper §6.3).

    The worker owns global samples [base_start, base_stop] (1-based
    inclusive); its n_i samples are split into p subpartitions processed in
    cyclic order k = 1..p.  ``current_interval()`` maps the local subpartition
    to *global* sample indices (what the gradient-cache keys on)."""

    base_start: int
    base_stop: int
    p: int = 1
    k: int = 1  # index of the NEXT subpartition to process

    def __post_init__(self):
        if self.base_stop < self.base_start:
            raise ValueError("empty worker range")
        self.p = min(self.p, self.n_local)

    @property
    def n_local(self) -> int:
        return self.base_stop - self.base_start + 1

    def current_interval(self) -> tuple[int, int]:
        lo = p_start(self.n_local, self.p, self.k)
        hi = p_stop(self.n_local, self.p, self.k)
        return self.base_start + lo - 1, self.base_start + hi - 1

    def advance(self) -> None:
        """Move to the next subpartition (paper Eq. 8)."""
        self.k = cyclic_increment(self.k, self.p)

    def repartition(self, p_new: int) -> None:
        """Change the subpartition count using Algorithm-2 alignment so the
        next processed subpartition starts where a cached one did."""
        p_new = max(1, min(p_new, self.n_local))
        if p_new == self.p:
            return
        # ``self.k`` already points at the NEXT subpartition (advance() ran
        # after the last task), which is what Algorithm 2's line 1 produces —
        # so enter the alignment loop directly at lines 2-6.
        _, k_new = _align(self.n_local, self.p, p_new, self.k)
        self.p = p_new
        self.k = k_new

    def next_interval_and_advance(self) -> tuple[int, int]:
        iv = self.current_interval()
        self.advance()
        return iv
