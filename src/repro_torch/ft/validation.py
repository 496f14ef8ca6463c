"""Cross-layer pin of the Tier-2 control plane, copied from
``repro.ft.validation``.

The live trainer (:mod:`repro_torch.launch.train`) feeds the Tier-1
``dsag_update`` from :class:`repro_torch.ft.runtime.DeadlineController`.
This module replays one pre-sampled :class:`FleetTraces` scenario through the
controller's event machine and packages the resulting (mask, flush, evict)
streams, so tests and ``chip_smoke.py`` can hold them equal to the JAX
package's controller and scalar simulator (whose streams the tests take from
the reference subprocess) and to the trainer's own logged streams.

The equivalence holds for ``subpartitions=1`` methods (one sample range per
group, the live trainer's regime).  ``simulator_streams`` / ``pin_streams``
need the scalar ``TrainingSimulator``, which this package does not port yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.problems import FiniteSumProblem
from repro_torch.ft.runtime import DeadlineController, LatencyFn
from repro_torch.latency.model import FleetTraces
from repro_torch.lb.partitioner import p_start, p_stop


@dataclasses.dataclass
class ControlStreams:
    """Per-step coordinator decisions over a whole run ([T, G] bool)."""

    mask: np.ndarray
    flush: np.ndarray
    evict: np.ndarray
    times: np.ndarray  # [T] virtual completion time of each step
    elapsed: np.ndarray  # [T] virtual duration of each step's collection

    def __eq__(self, other) -> bool:  # stream equality is the pin
        if not isinstance(other, ControlStreams):
            return NotImplemented
        return (
            np.array_equal(self.mask, other.mask)
            and np.array_equal(self.flush, other.flush)
            and np.array_equal(self.evict, other.evict)
        )

    def mismatch_summary(self, other: "ControlStreams") -> str:
        """First differing (step, group) per stream — for pin diagnostics."""
        parts = []
        for name in ("mask", "flush", "evict"):
            a, b = getattr(self, name), getattr(other, name)
            diff = np.argwhere(a != b)
            if len(diff):
                t, g = diff[0]
                parts.append(f"{name} first diff at step {t} group {g}")
        return "; ".join(parts) if parts else "streams identical"


def group_loads(problem: FiniteSumProblem, num_groups: int) -> np.ndarray:
    """Per-group compute cost for the live regime (subpartitions=1).

    Group i processes its full base partition every task, so its load is
    the compute cost of that sample range.
    """
    n = problem.num_samples
    return np.array(
        [
            problem.compute_cost(p_start(n, num_groups, i), p_stop(n, num_groups, i))
            for i in range(1, num_groups + 1)
        ],
        dtype=np.float64,
    )


def trace_latency_fn(traces: FleetTraces, scenario: int, loads: np.ndarray) -> LatencyFn:
    """A ``latency_of`` callable replaying one trace scenario.

    Consumes each group's (comm, comp_unit) draw streams sequentially —
    the order the JAX package's ``TraceLatencySource`` consumes them — so
    the controller sees exactly the latencies the scalar simulator sees.
    """
    k = np.zeros(traces.num_workers, dtype=np.int64)

    def latency_of(group: int, now: float) -> tuple[float, float]:
        comm, comp = traces.scalar_task_latency(
            scenario, group, int(k[group]), now, float(loads[group])
        )
        k[group] += 1
        return float(comp), float(comm)

    return latency_of


def controller_streams(
    traces: FleetTraces,
    scenario: int,
    *,
    w: int,
    num_iterations: int,
    loads: np.ndarray,
    margin: float = 0.02,
    accepts_stale: bool = True,
) -> ControlStreams:
    """Replay one trace scenario through the Tier-2 controller.

    Drives :meth:`DeadlineController.step_inputs` for ``num_iterations``
    virtual steps, threading the trace's churn schedule (death/rejoin) in
    as the per-step ``alive`` vector exactly as the simulator samples it
    (once per iteration, at assignment time).
    """
    G = traces.num_workers
    ctrl = DeadlineController(
        num_groups=G, w=w, margin=margin, accepts_stale=accepts_stale
    )
    latency_of = trace_latency_fn(traces, scenario, loads)
    mask = np.zeros((num_iterations, G), dtype=bool)
    flush = np.zeros((num_iterations, G), dtype=bool)
    evict = np.zeros((num_iterations, G), dtype=bool)
    times = np.zeros(num_iterations, dtype=np.float64)
    elapsed = np.zeros(num_iterations, dtype=np.float64)
    churn = traces.churn
    for t in range(num_iterations):
        alive = churn.alive_at(ctrl.now) if churn is not None else None
        si = ctrl.step_inputs(latency_of, alive=alive)
        mask[t] = si.mask
        flush[t] = si.flush
        evict[t] = si.evict
        times[t] = ctrl.now
        elapsed[t] = si.elapsed
    return ControlStreams(mask=mask, flush=flush, evict=evict, times=times, elapsed=elapsed)
