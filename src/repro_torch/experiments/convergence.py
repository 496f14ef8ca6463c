"""Batched convergence sweeps (paper Figs. 10-12): the device and host engines.

Counterpart of ``repro.experiments.convergence``: every method of a sweep
trains on all ``[S]`` scenarios of one shared :class:`~repro_torch.latency.
model.FleetTraces` draw (common random numbers).  :func:`run_convergence_batch`
runs one of two engines (``EngineConfig.kind``):

* ``"scan"`` (and ``"auto"``) — the device engine,
  :mod:`repro_torch.experiments.fused`: every iteration's state and
  arithmetic on the device;
* ``"host"`` — the numpy loop below: the §4.2 event algebra as ``[S, N]``
  numpy arrays, the §5 cache in a :class:`~repro_torch.core.
  gradient_cache.BatchedGradientCache`, and one masked-batch subgradient
  call per iteration through the problem's kernels (K1/K2 on the card).

For every scenario ``s`` both equal the scalar :class:`~repro_torch.cluster.
simulator.TrainingSimulator` replaying ``TraceLatencySource(traces, s)``
bit for bit — times, suboptimality, fresh counts, per-worker latencies and
cache telemetry (``tests/test_torch_engines.py``, and ``chip_smoke.py`` on
the card).  Results come back as numpy arrays with the reference's shapes.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from collections.abc import Sequence

from repro_torch.cluster.simulator import (
    MethodConfig,
    RunHistory,
    TraceLatencySource,
    TrainingSimulator,
    effective_w,
    margin_deadline,
    task_finish_time,
)
from repro_torch.core.gradient_cache import BatchedGradientCache, scenario_ranks
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

    def history(self, s: int) -> RunHistory:
        """Scenario ``s`` as a scalar :class:`RunHistory`."""
        return RunHistory(
            times=self.times[s],
            suboptimality=self.suboptimality[s],
            fresh_counts=self.fresh_counts[s],
            per_worker_latency=self.per_worker_latency[s],
            repartition_events=list(self.repartition_events[s]),
            evictions=int(self.evictions[s]),
            rejected_stale=int(self.rejected_stale[s]),
        )

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
    eval_every: int | None = None,
    seed: int = 0,
    engine: EngineConfig | None = None,
    V0: np.ndarray | None = None,
) -> ConvergenceBatchResult:
    """Train ``config`` on every scenario of ``traces`` simultaneously.

    Equivalent, scenario by scenario and bit for bit, to
    ``TrainingSimulator(problem, cluster, config, latency_source=
    TraceLatencySource(traces, s), engine=engine).run(num_iterations)``.
    ``engine`` (default ``EngineConfig()``: the card, CUDA kernels, kind
    ``"auto"``) names the engine kind, the device and the kernel backend;
    ``eval_every`` defaults to ``engine.eval_every``; ``V0`` (numpy)
    overrides the problem's initial iterate.  Raises
    :class:`~repro_torch.experiments.engine.EngineCapabilityError` for
    configurations the engines cannot run (§6 load balancing, churn), before
    any launch.
    """
    eng = EngineConfig() if engine is None else engine
    if eval_every is None:
        eval_every = eng.eval_every
    kwargs = dict(cost_scale=cost_scale, eval_every=eval_every, seed=seed, engine=eng, V0=V0)
    if eng.kind == "host":
        return _run_host(problem, traces, config, num_iterations, **kwargs)
    from repro_torch.experiments.fused import run_convergence_scan

    return run_convergence_scan(problem, traces, config, num_iterations, **kwargs)


def _run_host(
    problem: FiniteSumProblem,
    traces: FleetTraces,
    config: MethodConfig,
    num_iterations: int,
    *,
    cost_scale: float,
    eval_every: int,
    seed: int,
    engine: EngineConfig,
    V0: np.ndarray | None,
) -> ConvergenceBatchResult:
    """The host engine: one numpy pass per iteration over ``[S, N]`` arrays,
    batched kernel calls inside (``repro.experiments.convergence``'s host
    branch without §6 and churn)."""
    from repro_torch.experiments.fused import check_run

    S, N = traces.num_scenarios, traces.num_workers
    n = problem.num_samples
    T = num_iterations
    cfg = config
    spec, _ = check_run(problem, traces, cfg, T, cost_scale, engine)
    pad = spec.max_width
    w_wait = effective_w(cfg, N)
    comp_scale = spec.comp_scale
    process_full = spec.process_full

    V0 = problem.init(seed) if V0 is None else np.asarray(V0)
    vshape = V0.shape
    V = np.repeat(V0[None], S, axis=0)
    bshape = (S,) + (1,) * len(vshape)  # per-scenario scalar broadcast
    cache = (
        BatchedGradientCache(S, n, np.zeros(vshape, dtype=np.float64))
        if cfg.uses_cache
        else None
    )

    # one Subpartitioner per (scenario, worker), as integer arrays (§6.3)
    base_start = np.array(spec.base_start, dtype=np.int64)
    base_stop = np.array(spec.base_stop, dtype=np.int64)
    n_local = base_stop - base_start + 1
    sub_p = np.array(spec.sub_p, dtype=np.int64)[None, :]
    sub_k = np.ones((S, N), dtype=np.int64)

    free_at = np.zeros((S, N))
    iter_end = np.zeros(S)
    draw_idx = np.zeros((S, N), dtype=np.int64)

    # the in-flight task of each (scenario, worker): what a busy worker is
    # computing, its value taken from the iterate it was assigned
    flight_lo = np.zeros((S, N), dtype=np.int64)
    flight_hi = np.zeros((S, N), dtype=np.int64)
    flight_titer = np.full((S, N), -1, dtype=np.int64)
    flight_val: np.ndarray | None = None  # allocated at the first evaluation
    flight_comp = np.zeros((S, N))
    flight_comm = np.zeros((S, N))

    times = np.zeros((S, T))
    subopt = np.full((S, T), np.nan)
    fresh_counts = np.zeros((S, T), dtype=np.int64)
    lat_matrix = np.full((S, T, N), np.nan)

    for t in range(T):
        assign = iter_end.copy()
        idle = free_at <= assign[:, None]
        if process_full:
            lo = np.broadcast_to(base_start, (S, N))
            hi = np.broadcast_to(base_stop, (S, N))
        else:
            lo = base_start[None, :] + (sub_k - 1) * n_local[None, :] // sub_p
            hi = base_start[None, :] + sub_k * n_local[None, :] // sub_p - 1
        cost = problem.compute_cost_batch(lo, hi) * comp_scale

        # -- event resolution (the [S, N] algebra of replay_batch) ----------
        start = np.where(idle, assign[:, None], free_at)
        comm_d, comp_d = traces.task_latency_parts(draw_idx, start, cost)
        finish = task_finish_time(start, comp_d, comm_d)
        tau_w = np.partition(finish, w_wait - 1, axis=1)[:, w_wait - 1]
        if spec.margin > 0.0:
            deadline = margin_deadline(tau_w, assign, spec.margin)
        else:
            deadline = tau_w
        started = idle | (free_at <= deadline[:, None])
        fresh = started & (finish <= deadline[:, None])
        stale_done = (~idle) & (free_at <= deadline[:, None])
        fresh_counts[:, t] = fresh.sum(axis=1)

        stale_ev = np.where(stale_done, free_at, -np.inf)
        fresh_ev = np.where(fresh, finish, -np.inf)
        iter_end = np.maximum(np.maximum(stale_ev.max(axis=1), fresh_ev.max(axis=1)), tau_w)
        times[:, t] = iter_end

        st_s, st_w = np.nonzero(stale_done)
        f_s, f_w = np.nonzero(fresh)
        # latency attribution by the task's own iteration (RunHistory)
        lat_matrix[st_s, flight_titer[st_s, st_w], st_w] = (
            flight_comp[st_s, st_w] + flight_comm[st_s, st_w]
        )
        lat_matrix[f_s, t, f_w] = comp_d[f_s, f_w] + comm_d[f_s, f_w]

        # -- one masked-batch subgradient call: dsag consumes every started
        # task's value (stale ones later), sag/sgd/gd the fresh ones, coded
        # none (it recomputes the exact gradient) ----------------------------
        need = started if cfg.name == "dsag" else fresh
        val_index = np.full((S, N), -1, dtype=np.int64)
        vals: np.ndarray | None = None
        if cfg.name != "coded" and need.any():
            v_s, v_w = np.nonzero(need)
            val_index[v_s, v_w] = np.arange(v_s.size)
            vals = problem.subgradient_blocks_masked(
                V[v_s], lo[v_s, v_w], hi[v_s, v_w], pad_width=pad, engine=engine
            )

        # -- cache / gradient-accumulator updates in event-time order ------
        if cfg.uses_cache:
            if cfg.accepts_stale:
                ev_s = np.concatenate([st_s, f_s])
                ev_w = np.concatenate([st_w, f_w])
                ev_time = np.concatenate([free_at[st_s, st_w], finish[f_s, f_w]])
                ev_lo = np.concatenate([flight_lo[st_s, st_w], lo[f_s, f_w]])
                ev_hi = np.concatenate([flight_hi[st_s, st_w], hi[f_s, f_w]])
                ev_iter = np.concatenate(
                    [flight_titer[st_s, st_w], np.full(f_s.size, t, np.int64)]
                )
                n_stale = st_s.size
            else:  # sag: fresh results only
                ev_s, ev_w = f_s, f_w
                ev_time = finish[f_s, f_w]
                ev_lo, ev_hi = lo[f_s, f_w], hi[f_s, f_w]
                ev_iter = np.full(f_s.size, t, np.int64)
                n_stale = 0
            if ev_s.size:
                fresh_vals = vals[val_index[ev_s[n_stale:], ev_w[n_stale:]]]
                ev_vals = (
                    np.concatenate(
                        [flight_val[ev_s[:n_stale], ev_w[:n_stale]], fresh_vals]
                    )
                    if n_stale
                    else fresh_vals
                )
                # time-ordered masked scatters (per-scenario §5 semantics)
                order = np.argsort(ev_time, kind="stable")
                cache.insert_events(
                    ev_s[order], ev_lo[order], ev_hi[order], ev_iter[order], ev_vals[order]
                )
        elif cfg.name in ("gd", "sgd"):
            grad_acc = np.zeros((S,) + vshape, dtype=np.float64)
            covered = np.zeros(S, dtype=np.int64)
            if f_s.size:
                order = np.argsort(finish[f_s, f_w], kind="stable")
                os_, ow_ = f_s[order], f_w[order]
                ranks = scenario_ranks(os_)
                for r in range(int(ranks.max()) + 1):
                    sel = ranks == r  # <= one event per scenario: masked add
                    grad_acc[os_[sel]] += vals[val_index[os_[sel], ow_[sel]]]
            np.add.at(covered, f_s, hi[f_s, f_w] - lo[f_s, f_w] + 1)

        # -- commit worker state for started tasks --------------------------
        if not process_full:
            sub_k = np.where(started, sub_k % sub_p + 1, sub_k)
        free_at = np.where(started, finish, free_at)
        draw_idx += started
        flight_lo = np.where(started, lo, flight_lo)
        flight_hi = np.where(started, hi, flight_hi)
        flight_titer = np.where(started, t, flight_titer)
        flight_comp = np.where(started, comp_d, flight_comp)
        flight_comm = np.where(started, comm_d, flight_comm)
        if cfg.name == "dsag" and vals is not None:
            if flight_val is None:
                flight_val = np.zeros((S, N) + vshape, dtype=vals.dtype)
            flight_val[v_s, v_w] = vals

        # -- iterate update -------------------------------------------------
        if cfg.uses_cache:
            xi = np.maximum(cache.coverage, 1e-12)
            grad = cache.sums / xi.reshape(bshape) + problem.regularizer_grad(V)
        elif cfg.name == "coded":
            g = problem.subgradient_blocks(
                V, np.ones(S, np.int64), np.full(S, n, np.int64), pad_width=n, engine=engine
            ).astype(np.float64)
            grad = g + problem.regularizer_grad(V)
        elif cfg.name == "gd":
            grad = grad_acc + problem.regularizer_grad(V)
        else:  # sgd: scale the partial sum by observed coverage
            xi = np.maximum(covered / n, 1e-12)
            grad = grad_acc / xi.reshape(bshape) + problem.regularizer_grad(V)
        V = problem.project_batch(
            (V - cfg.eta * grad).astype(V.dtype, copy=False), engine=engine
        )
        if t % eval_every == 0 or t == T - 1:
            subopt[:, t] = problem.suboptimality_batch(V, engine=engine)

    return ConvergenceBatchResult(
        times=times,
        suboptimality=subopt,
        fresh_counts=fresh_counts,
        per_worker_latency=lat_matrix,
        repartition_events=[[] for _ in range(S)],
        evictions=cache.evictions.copy() if cache is not None else np.zeros(S, np.int64),
        rejected_stale=(
            cache.rejected_stale.copy() if cache is not None else np.zeros(S, np.int64)
        ),
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

    def time_to_gap(self, method: str, gap: float) -> np.ndarray:
        return self.results[method].time_to_gap(gap)


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


def scalar_convergence_run(
    outcome: ConvergenceSweepOutcome,
    method: str,
    scenario: int,
    *,
    engine: EngineConfig | None = None,
) -> RunHistory:
    """Ground truth: one scenario through the scalar TrainingSimulator, on
    ``engine``'s device and kernels (default ``EngineConfig()``)."""
    sim = TrainingSimulator(
        outcome.problem,
        outcome.cluster,
        outcome.methods[method],
        cost_scale=outcome.cost_scale,
        eval_every=outcome.eval_every,
        seed=outcome.seed,
        latency_source=TraceLatencySource(outcome.traces, scenario),
        engine=engine,
    )
    return sim.run(outcome.num_iterations)


def history_mismatches(hist: RunHistory, result: ConvergenceBatchResult, s: int) -> list[str]:
    """The fields in which scenario ``s`` of a batched result differs from a
    scalar run's history, bit for bit (NaN equal to NaN); empty when equal."""
    other = result.history(s)
    return [
        f
        for f in (
            "times", "suboptimality", "fresh_counts", "per_worker_latency",
            "evictions", "rejected_stale",
        )
        if not np.array_equal(getattr(hist, f), getattr(other, f), equal_nan=True)
    ]


def scalar_convergence_seconds(
    outcome: ConvergenceSweepOutcome,
    *,
    methods: Sequence[str] | None = None,
    max_scenarios: int | None = None,
    engine: EngineConfig | None = None,
) -> tuple[float, float]:
    """Wall clock of the same grid through the scalar training simulator.

    Replays ``max_scenarios`` scenarios (all by default) of each method
    through :class:`TrainingSimulator` on the same traces.  Returns
    ``(measured_seconds, extrapolated_seconds)``: the extrapolation scales
    the measured subset up to the full grid.
    """
    names = list(methods) if methods is not None else list(outcome.methods)
    S = outcome.traces.num_scenarios
    S_run = S if max_scenarios is None else min(max_scenarios, S)
    t0 = time.perf_counter()
    for name in names:
        for s in range(S_run):
            scalar_convergence_run(outcome, name, s, engine=engine)
    measured = time.perf_counter() - t0
    return measured, measured * (S / max(S_run, 1))
