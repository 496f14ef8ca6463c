"""Scenario-grid driver of the §7 iteration-time sweeps (seeds x methods x w
x burst regimes), counterpart of ``repro.experiments.grid``.

One :class:`FleetTraces` draw is shared by every method within a burst
regime (common random numbers, so method comparisons are paired across
seeds like the paper's figures pair runs on one cluster).  The scenario axis
batches the seeds; methods and w-values loop outside, each resolved on the
device by :mod:`repro_torch.experiments.sweep`.  The burst regimes are also
what the convergence sweeps draw their traces under.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections.abc import Sequence

import numpy as np

from repro_torch.experiments.engine import checked_device
from repro_torch.experiments.sweep import (
    BatchedRunResult,
    replay_batch,
    scalar_reference,
    scalar_sync_reference,
    synchronous_times_batch,
)
from repro_torch.latency.model import (
    ClusterLatencyModel,
    FleetTraces,
    make_heterogeneous_cluster,
    sample_fleet,
)


@dataclasses.dataclass(frozen=True)
class BurstRegime:
    """One burst environment of the sweep (paper §3.2 / Fig. 4)."""

    name: str
    rate: float  # burst arrivals per second per worker (0 = burst-free)
    factor_mean: float = 1.12  # mean multiplicative slowdown of a burst
    duration_mean: float = 60.0  # mean burst duration (s)


#: Burst-free cluster: straggling comes only from gamma tails.
CALM = BurstRegime("calm", 0.0)
#: The paper's measured regime (Fig. 4: ~12% slowdowns, ~1 min, every ~90 s).
PAPER_BURSTS = BurstRegime("paper_bursts", 1.0 / 90.0, 1.12, 60.0)
#: Heavy straggler regime: frequent multi-x slowdowns — where DSAG's
#: stale-tolerance should pay off most (paper §7.2-style stragglers).
HEAVY_BURSTS = BurstRegime("heavy_bursts", 1.0 / 20.0, 4.0, 30.0)

DEFAULT_REGIMES: tuple[BurstRegime, ...] = (CALM, PAPER_BURSTS, HEAVY_BURSTS)


@dataclasses.dataclass(frozen=True)
class MethodSpec:
    """One method column of the sweep, in engine terms.

    ``w = 0`` means "take the grid's w-value" (the wait-for-w sweep axis);
    ``rel_load`` is the per-task computational load relative to one
    subpartition task of the stochastic methods; ``sync`` selects the
    fully-vectorized no-queue-feedback fast path (GD / idealized coded).
    """

    name: str
    w: int
    margin: float = 0.0
    rel_load: float = 1.0
    sync: bool = False


def default_methods(
    n_workers: int,
    *,
    subpartitions: int = 10,
    code_rate: float = 45.0 / 49.0,
) -> tuple[MethodSpec, ...]:
    """The five §7 columns: GD, coded bound, SGD, SAG, DSAG.

    GD and coded process the full local block (load = subpartitions tasks,
    coded inflated by 1/rate); SAG has no staleness mechanism so it must run
    synchronously (w = N); SGD and DSAG take the swept w, DSAG with the
    §5.1 2% margin.
    """
    N = n_workers
    return (
        MethodSpec("gd", N, rel_load=float(subpartitions), sync=True),
        MethodSpec(
            "coded",
            int(math.ceil(code_rate * N)),
            rel_load=float(subpartitions) / code_rate,
            sync=True,
        ),
        MethodSpec("sgd", 0),
        MethodSpec("sag", N),
        MethodSpec("dsag", 0, margin=0.02),
    )


@dataclasses.dataclass
class SweepRow:
    """One (regime, method, w, seed) cell of the grid."""

    regime: str
    method: str
    w: int
    seed: int
    mean_iter_time: float
    total_time: float
    mean_fresh: float
    min_participation: float


@dataclasses.dataclass
class SweepOutcome:
    rows: list[SweepRow]
    n_workers: int
    n_seeds: int
    num_iterations: int
    engine_seconds: float
    results: dict[tuple[str, str, int], BatchedRunResult]
    traces: dict[str, FleetTraces]
    methods: tuple[MethodSpec, ...] = ()
    seed: int = 0  # base seed of the grid (recorded in the BENCH artifact)

    def mean_iter_time(self, regime: str, method: str, w: int | None = None) -> float:
        sel = [
            r.mean_iter_time
            for r in self.rows
            if r.regime == regime and r.method == method and (w is None or r.w == w)
        ]
        if not sel:
            raise KeyError(f"no rows for ({regime}, {method}, w={w})")
        return float(np.mean(sel))


def _run_method(
    traces: FleetTraces,
    spec: MethodSpec,
    w_eff: int,
    num_iterations: int,
    device,
) -> BatchedRunResult:
    if spec.sync:
        times, participation = synchronous_times_batch(
            traces, w_eff, num_iterations, loads=spec.rel_load,
            return_participation=True, device=device,
        )
        S = traces.num_scenarios
        return BatchedRunResult(
            iteration_times=times,
            fresh_counts=np.full((S, num_iterations), w_eff, dtype=np.int64),
            participation=participation,
        )
    return replay_batch(
        traces, w_eff, num_iterations, margin=spec.margin, loads=spec.rel_load,
        device=device,
    )


def run_sweep(
    n_workers: int = 100,
    n_seeds: int = 10,
    num_iterations: int = 100,
    *,
    w_values: Sequence[int] = (),
    w_fracs: Sequence[float] = (0.8,),
    methods: Sequence[MethodSpec] | None = None,
    regimes: Sequence[BurstRegime] = DEFAULT_REGIMES,
    subpartitions: int = 10,
    cluster: ClusterLatencyModel | None = None,
    seed: int = 0,
    device="cuda",
) -> SweepOutcome:
    """Run the full (seeds x methods x w x regimes) grid, batched over seeds,
    on ``device`` (default the card; refused with ``cuda-device-unavailable``
    where torch sees none).

    ``w_values`` (absolute) or ``w_fracs`` (fractions of N) define the
    wait-for-w axis applied to the methods with ``w == 0`` (SGD, DSAG);
    fixed-w methods (GD, coded, SAG) run once per regime.  ``engine_seconds``
    is host wall clock around the grid; each method's results are copied to
    the host inside it.
    """
    checked_device(device)
    ws = sorted(
        {min(max(int(v), 1), n_workers) for v in w_values}
        | {min(max(round(f * n_workers), 1), n_workers) for f in w_fracs}
    )
    if not ws:
        raise ValueError("need at least one w value")
    methods = tuple(methods) if methods is not None else default_methods(
        n_workers, subpartitions=subpartitions
    )
    if cluster is None:
        cluster = make_heterogeneous_cluster(n_workers, burst_rate=0.0, seed=seed)
    elif cluster.num_workers != n_workers:
        # a silent mismatch would run "synchronous" methods at w < N and
        # stamp the artifact with the wrong fleet size
        raise ValueError(
            f"cluster has {cluster.num_workers} workers but n_workers={n_workers}"
        )

    rows: list[SweepRow] = []
    results: dict[tuple[str, str, int], BatchedRunResult] = {}
    traces_by_regime: dict[str, FleetTraces] = {}
    t0 = time.perf_counter()
    for ri, regime in enumerate(regimes):
        traces = sample_fleet(
            cluster,
            n_seeds,
            num_iterations,
            burst_rate=regime.rate,
            burst_factor_mean=regime.factor_mean,
            burst_duration_mean=regime.duration_mean,
            load_hint=max(m.rel_load for m in methods),
            seed=seed + 1000 * (ri + 1),
        )
        traces_by_regime[regime.name] = traces
        for spec in methods:
            for w in ws if spec.w == 0 else (spec.w,):
                w_eff = min(max(w, 1), n_workers)
                res = _run_method(traces, spec, w_eff, num_iterations, device)
                results[(regime.name, spec.name, w_eff)] = res
                iter_means = res.mean_iteration_time
                for s in range(n_seeds):
                    rows.append(
                        SweepRow(
                            regime=regime.name,
                            method=spec.name,
                            w=w_eff,
                            seed=s,
                            mean_iter_time=float(iter_means[s]),
                            total_time=float(res.iteration_times[s, -1]),
                            mean_fresh=float(res.fresh_counts[s].mean()),
                            min_participation=float(res.participation[s].min()),
                        )
                    )
    engine_seconds = time.perf_counter() - t0
    return SweepOutcome(
        rows=rows,
        n_workers=n_workers,
        n_seeds=n_seeds,
        num_iterations=num_iterations,
        engine_seconds=engine_seconds,
        results=results,
        traces=traces_by_regime,
        methods=methods,
        seed=seed,
    )


def scalar_sweep_seconds(outcome: SweepOutcome) -> float:
    """Wall clock of the same grid through the scalar event loop (numpy).

    Replays every (regime, method, w, seed) cell of ``outcome`` one draw at
    a time — queue-feedback cells through the scalar event loop
    (:func:`scalar_reference`), sync cells through the scalar synchronous
    loop (:func:`scalar_sync_reference`), so each cell times the *same*
    dynamics its vectorized counterpart ran.  Uses the method specs the
    sweep was actually run with (margin / rel_load must match or the timing
    would compare different workloads).
    """
    specs = outcome.methods or default_methods(outcome.n_workers)
    spec_by_name = {m.name: m for m in specs}
    t0 = time.perf_counter()
    for (regime, method, w), _ in outcome.results.items():
        spec = spec_by_name[method]
        traces = outcome.traces[regime]
        for s in range(outcome.n_seeds):
            if spec.sync:
                scalar_sync_reference(
                    traces, s, w, outcome.num_iterations, loads=spec.rel_load
                )
            else:
                scalar_reference(
                    traces,
                    s,
                    w,
                    outcome.num_iterations,
                    margin=spec.margin,
                    loads=spec.rel_load,
                )
    return time.perf_counter() - t0
