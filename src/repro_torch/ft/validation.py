"""Cross-layer pin of the Tier-2 control plane, copied from
``repro.ft.validation``.

The live trainer (:mod:`repro_torch.launch.train`) feeds the Tier-1
``dsag_update`` from :class:`repro_torch.ft.runtime.DeadlineController`.
This module replays one pre-sampled :class:`FleetTraces` scenario through the
controller's event machine and through the port's scalar
:class:`~repro_torch.cluster.simulator.TrainingSimulator`, and packages the
resulting (mask, flush, evict) streams, so tests and ``chip_smoke.py`` can
hold them equal to each other (:func:`pin_streams`), to the JAX package's
and to the trainer's own logged streams.

The equivalence holds for ``subpartitions=1`` methods (one sample range per
group, the live trainer's regime).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.cluster.simulator import (
    MethodConfig,
    RunHistory,
    TraceLatencySource,
    TrainingSimulator,
    effective_w,
)
from repro_torch.core.problems import FiniteSumProblem
from repro_torch.experiments.engine import EngineConfig
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


def simulator_streams(
    problem: FiniteSumProblem,
    cluster,
    traces: FleetTraces,
    scenario: int,
    config: MethodConfig,
    num_iterations: int,
    *,
    seed: int = 0,
    engine: EngineConfig | None = None,
) -> tuple[ControlStreams, RunHistory]:
    """Run the scalar simulator on the same trace; return its streams and
    its :class:`RunHistory` (whose ``times`` are the predicted virtual
    schedule of the live run)."""
    sim = TrainingSimulator(
        problem,
        cluster,
        config,
        seed=seed,
        latency_source=TraceLatencySource(traces, scenario),
        engine=engine,
    )
    hist = sim.run(num_iterations)
    streams = ControlStreams(
        mask=hist.mask_stream,
        flush=hist.flush_stream,
        evict=hist.evict_stream,
        times=hist.times,
        elapsed=np.diff(np.concatenate(([0.0], hist.times))),
    )
    return streams, hist


def pin_streams(
    problem: FiniteSumProblem,
    cluster,
    traces: FleetTraces,
    scenario: int,
    config: MethodConfig,
    num_iterations: int,
    *,
    seed: int = 0,
    engine: EngineConfig | None = None,
) -> tuple[ControlStreams, ControlStreams, RunHistory]:
    """(controller, simulator) streams of one shared trace, and the
    simulator's history: the caller asserts ``ctrl == sim``, the cross-layer
    pin.  Requires ``subpartitions == 1`` (the live trainer's regime) and a
    cache method without load balancing."""
    if config.subpartitions != 1 or config.load_balance:
        raise ValueError("the Tier-2 pin covers the live regime: subpartitions=1, no LB")
    if config.name not in ("sag", "dsag"):
        raise ValueError("the live trainer runs cache methods (sag/dsag)")
    loads = group_loads(problem, traces.num_workers)
    ctrl = controller_streams(
        traces,
        scenario,
        w=effective_w(config, traces.num_workers),
        num_iterations=num_iterations,
        loads=loads,
        margin=config.margin,
        accepts_stale=config.accepts_stale,
    )
    sim, hist = simulator_streams(
        problem, cluster, traces, scenario, config, num_iterations, seed=seed, engine=engine
    )
    return ctrl, sim, hist
