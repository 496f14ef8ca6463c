"""Partition arithmetic (paper §6.3), copied from ``repro.lb.partitioner``.

All indices are 1-based inclusive, matching the paper:

    p_start(n, p, i) = floor((i-1)n/p) + 1
    p_stop(n, p, i)  = floor(in/p)

>>> p_start(10, 2, 2), p_stop(10, 2, 2)
(6, 10)
"""

from __future__ import annotations


def p_start(n: int, p: int, i: int) -> int:
    """First (1-based) sample of the i-th of p partitions of n samples."""
    return (i - 1) * n // p + 1


def p_stop(n: int, p: int, i: int) -> int:
    """Last (1-based) sample of the i-th of p partitions of n samples."""
    return i * n // p
