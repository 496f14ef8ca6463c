"""Partition arithmetic and alignment (paper §6.3), copied from
``repro.lb.partitioner``.

All indices are 1-based inclusive, matching the paper:

    p_start(n, p, i) = floor((i-1)n/p) + 1
    p_stop(n, p, i)  = floor(in/p)
    p_trans(n, p, p', k) = ceil(p_start(n, p, k) * p' / n)

``align_partitions`` is Algorithm 2 (what ``ft.runtime.elastic_remap_groups``
uses to keep surviving cache entries aligned when the group count changes).

>>> p_start(10, 2, 2), p_stop(10, 2, 2)
(6, 10)
"""

from __future__ import annotations

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
