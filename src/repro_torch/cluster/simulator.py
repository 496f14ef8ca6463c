"""Method semantics shared by every engine (paper §4.2, §5, §7).

The shared helpers of ``repro.cluster.simulator``: the finish-time and
margin expressions, the effective wait-for-w, and :class:`MethodConfig`.
They are written for numpy arrays and torch tensors alike (plain operators
only), so the device engine evaluates the exact same float expressions, one
rounding per operator, as the JAX package's engines.  The scalar
``TrainingSimulator`` is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math


def task_finish_time(start, comp, comm):
    """Completion time of a task: ``start + (comp + comm)``.

    The grouping matters for exact replay: the two latency components are
    added together before the start time is added.
    """
    return start + (comp + comm)


def margin_deadline(tau_w, iter_start, margin):
    """Paper §5.1: keep collecting ``margin`` longer than the time the
    first w fresh results took this iteration."""
    return tau_w + margin * (tau_w - iter_start)


def effective_w(config: MethodConfig, num_workers: int) -> int:
    """The wait-for-w actually used by a method on an N-worker fleet."""
    if config.name == "gd":
        return num_workers
    if config.name == "coded":
        return int(math.ceil(config.code_rate * num_workers))
    return min(config.w if config.w > 0 else num_workers, num_workers)


@dataclasses.dataclass
class MethodConfig:
    """One method/configuration of paper §7."""

    name: str  # gd | sgd | sag | dsag | coded
    w: int = 0  # wait-for-w (ignored by gd/coded)
    eta: float = 0.9
    margin: float = 0.02  # post-w extra wait (paper §5.1); dsag/lb methods
    subpartitions: int = 1  # initial p_i (paper: 100 for PCA, 10 for logreg)
    code_rate: float = 45.0 / 49.0  # coded only
    load_balance: bool = False
    lb_interval: float = 1.0  # how often the optimizer publishes (sim s)
    lb_startup_delay: float = 0.5  # first-solution delay (paper: 0.5-7 s)

    def __post_init__(self):
        if self.name not in ("gd", "sgd", "sag", "dsag", "coded"):
            raise ValueError(f"unknown method {self.name}")

    @property
    def uses_cache(self) -> bool:
        return self.name in ("sag", "dsag")

    @property
    def accepts_stale(self) -> bool:
        return self.name == "dsag"

    @property
    def uses_margin(self) -> bool:
        return self.name == "dsag" or self.load_balance
