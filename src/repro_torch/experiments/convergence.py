"""Batched convergence sweeps on the device engine (paper Figs. 10-12).

Counterpart of ``repro.experiments.convergence``: every method of a sweep
trains on all ``[S]`` scenarios of one shared :class:`~repro_torch.latency.
model.FleetTraces` draw (common random numbers), through the grid-cache body
of :mod:`repro_torch.experiments.fused`.  :func:`run_convergence_batch`
routes to that device engine only; the reference's numpy host engine and
scalar simulator are not ported yet.  Results come back as numpy arrays with
the reference's shapes.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.cluster.simulator import MethodConfig
from repro_torch.core.problems import FiniteSumProblem
from repro_torch.experiments.engine import EngineConfig
from repro_torch.latency.model import ClusterLatencyModel, FleetTraces, sample_fleet


@dataclasses.dataclass
class ConvergenceBatchResult:
    """Per-scenario training traces of one batched convergence run."""

    times: np.ndarray  # [S, T]
    suboptimality: np.ndarray  # [S, T] (NaN where not evaluated)
    fresh_counts: np.ndarray  # [S, T]
    per_worker_latency: np.ndarray  # [S, T, N]
    repartition_events: list[list[float]]  # per scenario (empty without §6)
    evictions: np.ndarray  # [S] (zero without §6)
    rejected_stale: np.ndarray  # [S]

    @property
    def num_scenarios(self) -> int:
        return self.times.shape[0]

    def time_to_gap(self, gap: float) -> np.ndarray:
        """[S] first sim time at which suboptimality <= gap (inf if never)."""
        ok = np.nan_to_num(self.suboptimality, nan=np.inf) <= gap
        any_ok = ok.any(axis=1)
        first = np.argmax(ok, axis=1)
        out = np.full(self.num_scenarios, np.inf)
        rows = np.flatnonzero(any_ok)
        out[rows] = self.times[rows, first[rows]]
        return out


def run_convergence_batch(
    problem: FiniteSumProblem,
    traces: FleetTraces,
    config: MethodConfig,
    num_iterations: int,
    *,
    cost_scale: float = 1.0,
    eval_every: int = 1,
    seed: int = 0,
    engine: EngineConfig | None = None,
    V0: np.ndarray | None = None,
) -> ConvergenceBatchResult:
    """Train ``config`` on every scenario of ``traces`` simultaneously.

    ``engine`` (default ``EngineConfig()``: the card, CUDA kernels) names
    the device and kernel backend; ``V0`` (numpy) overrides the problem's
    initial iterate.
    Raises :class:`~repro_torch.experiments.engine.EngineCapabilityError`
    for configurations the engine cannot run.
    """
    from repro_torch.experiments.fused import run_convergence_scan

    return run_convergence_scan(
        problem,
        traces,
        config,
        num_iterations,
        cost_scale=cost_scale,
        eval_every=eval_every,
        seed=seed,
        engine=engine,
        V0=V0,
    )


@dataclasses.dataclass
class ConvergenceSweepOutcome:
    """All methods' batched convergence runs on one shared trace draw."""

    results: dict[str, ConvergenceBatchResult]
    methods: dict[str, MethodConfig]
    traces: FleetTraces
    problem: FiniteSumProblem
    cluster: ClusterLatencyModel
    num_iterations: int
    cost_scale: float
    eval_every: int
    seed: int
    engine_seconds: float


def default_convergence_methods(
    n_workers: int,
    *,
    w: int,
    eta: float = 0.25,
    subpartitions: int = 10,
) -> dict[str, MethodConfig]:
    """The paper's §7 time-to-gap columns: DSAG, SAG (w = N), SGD, coded."""
    return {
        "dsag": MethodConfig(name="dsag", w=w, eta=eta, subpartitions=subpartitions),
        "sag": MethodConfig(name="sag", w=n_workers, eta=eta,
                            subpartitions=subpartitions),
        "sgd": MethodConfig(name="sgd", w=w, eta=eta, subpartitions=subpartitions),
        "coded": MethodConfig(name="coded", w=0, eta=1.0,
                              subpartitions=subpartitions),
    }


def run_convergence_sweep(
    problem: FiniteSumProblem,
    cluster: ClusterLatencyModel,
    methods: dict[str, MethodConfig],
    *,
    n_scenarios: int = 10,
    num_iterations: int = 100,
    cost_scale: float = 1.0,
    eval_every: int = 1,
    regime=None,
    burst_rate: float | None = None,
    burst_factor_mean: float | None = None,
    burst_duration_mean: float | None = None,
    seed: int = 0,
    engine: EngineConfig | None = None,
) -> ConvergenceSweepOutcome:
    """Run every method over one shared scenario batch (common random
    numbers: all methods see the same latency draws).

    ``regime`` is an optional :class:`~repro_torch.experiments.grid.
    BurstRegime`; explicit ``burst_*`` keywords override its fields.
    ``engine_seconds`` is host wall-clock around all methods, ending in a
    copy of the results to the host (so the device work is included).
    """
    if regime is not None:
        burst_rate = regime.rate if burst_rate is None else burst_rate
        burst_factor_mean = (
            regime.factor_mean if burst_factor_mean is None else burst_factor_mean
        )
        burst_duration_mean = (
            regime.duration_mean if burst_duration_mean is None else burst_duration_mean
        )
    traces = sample_fleet(
        cluster,
        n_scenarios,
        num_iterations,
        burst_rate=burst_rate,
        burst_factor_mean=burst_factor_mean,
        burst_duration_mean=burst_duration_mean,
        seed=seed + 1,
    )
    results: dict[str, ConvergenceBatchResult] = {}
    t0 = time.perf_counter()
    for name, cfg in methods.items():
        results[name] = run_convergence_batch(
            problem,
            traces,
            cfg,
            num_iterations,
            cost_scale=cost_scale,
            eval_every=eval_every,
            seed=seed,
            engine=engine,
        )
    engine_seconds = time.perf_counter() - t0
    return ConvergenceSweepOutcome(
        results=results,
        methods=dict(methods),
        traces=traces,
        problem=problem,
        cluster=cluster,
        num_iterations=num_iterations,
        cost_scale=cost_scale,
        eval_every=eval_every,
        seed=seed,
        engine_seconds=engine_seconds,
    )


#: The logistic-regression ``grid`` recipe of ``BENCH_convergence.json``
#: (HIGGS-like, n=16384, 100 workers x 10 heavy-burst scenarios).
GRID_LOGREG = dict(
    n_rows=16_384,
    n_workers=100,
    subpartitions=10,
    w=80,
    eta=0.25,
    gap=0.2,
    n_scenarios=10,
    num_iterations=60,
    eval_every=5,
)

#: Calibrated parameters of the paper-scale PCA convergence sweep (the
#: ``pca_paper_scale`` recipe of ``BENCH_convergence.json``).
PAPER_SCALE_PCA = dict(
    n_rows=50_000,
    n_cols=96,
    k=3,
    n_workers=50,
    subpartitions=5,
    w=40,
    eta=0.9,
    gap=1e-4,
    n_scenarios=4,
    num_iterations=80,
    eval_every=4,
)


def make_paper_scale_pca(
    n_rows: int = PAPER_SCALE_PCA["n_rows"],
    n_cols: int = PAPER_SCALE_PCA["n_cols"],
    k: int = PAPER_SCALE_PCA["k"],
    seed: int = 0,
):
    """The n≈50k synthetic genomics matrix as a :class:`PCAProblem`."""
    from repro_torch.core.problems import PCAProblem, make_genomics_like_matrix

    return PCAProblem(X=make_genomics_like_matrix(n_rows, n_cols, seed=seed), k=k)


def _recipe_sweep(prob, p, *, n_iter, n_scen, seed, regime, engine):
    from repro_torch.experiments.grid import HEAVY_BURSTS
    from repro_torch.latency.model import make_heterogeneous_cluster

    N, sp = p["n_workers"], p["subpartitions"]
    c_task = prob.compute_cost(1, max(prob.num_samples // (N * sp), 1))
    cluster = make_heterogeneous_cluster(N, seed=seed, burst_rate=0.0, load_unit=c_task)
    methods = default_convergence_methods(N, w=p["w"], eta=p["eta"], subpartitions=sp)
    return run_convergence_sweep(
        prob,
        cluster,
        methods,
        n_scenarios=n_scen,
        num_iterations=n_iter,
        eval_every=p["eval_every"],
        regime=regime if regime is not None else HEAVY_BURSTS,
        seed=seed,
        engine=engine,
    )


def paper_scale_pca_sweep(
    *,
    scale: float = 1.0,
    seed: int = 0,
    regime=None,
    engine: EngineConfig | None = None,
    n_scenarios: int | None = None,
) -> tuple[ConvergenceSweepOutcome, float]:
    """Run the calibrated paper-scale PCA convergence sweep.

    ``scale`` shrinks rows, iterations and scenarios uniformly for smoke
    tests; 1.0 is the benchmark configuration.  Returns ``(outcome, gap)``.
    """
    p = PAPER_SCALE_PCA
    n_rows = max(int(p["n_rows"] * scale), 512)
    n_iter = max(int(p["num_iterations"] * scale), 10)
    n_scen = (
        int(n_scenarios)
        if n_scenarios is not None
        else max(int(p["n_scenarios"] * scale), 2)
    )
    prob = make_paper_scale_pca(n_rows=n_rows, seed=seed)
    out = _recipe_sweep(
        prob, p, n_iter=n_iter, n_scen=n_scen, seed=seed, regime=regime, engine=engine
    )
    return out, float(p["gap"])


def grid_logreg_sweep(
    *, seed: int = 0, regime=None, engine: EngineConfig | None = None
) -> tuple[ConvergenceSweepOutcome, float]:
    """Run the ``grid`` logistic-regression recipe; returns ``(outcome, gap)``."""
    from repro_torch.core.problems import LogisticRegressionProblem, make_higgs_like

    p = GRID_LOGREG
    X, y = make_higgs_like(p["n_rows"], seed=seed)
    prob = LogisticRegressionProblem(X=X, y=y)
    out = _recipe_sweep(
        prob,
        p,
        n_iter=p["num_iterations"],
        n_scen=p["n_scenarios"],
        seed=seed,
        regime=regime,
        engine=engine,
    )
    return out, float(p["gap"])
