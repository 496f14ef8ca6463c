"""Burst regimes of the §7 sweeps (``repro.experiments.grid``)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BurstRegime:
    """One burst environment of the sweep (paper §3.2 / Fig. 4)."""

    name: str
    rate: float  # burst arrivals per second per worker (0 = burst-free)
    factor_mean: float = 1.12  # mean multiplicative slowdown of a burst
    duration_mean: float = 60.0  # mean burst duration (s)


#: Heavy straggler regime: frequent multi-x slowdowns — where DSAG's
#: stale-tolerance should pay off most (paper §7.2-style stragglers).
HEAVY_BURSTS = BurstRegime("heavy_bursts", 1.0 / 20.0, 4.0, 30.0)
