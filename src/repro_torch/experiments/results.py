"""Results layer of the §7 sweeps: ordering verdicts, the §6.1 profiler feed
from batched traces, the ``BENCH_sweep.json`` payload, the time-to-gap
verdict of the convergence sweeps and their ``BENCH_convergence.json``
payload (:func:`convergence_payload`, :func:`write_bench_convergence`;
``repro.experiments.results``), and the
§6 ``lb_scan`` column (:func:`run_lb_scan`, then :meth:`LbScanRun.column`:
``benchmarks/bench_regression.run_lb_scan_column``), the elastic-fleet
``churn`` column (:func:`run_churn_column`: ``benchmarks/bench_regression.
run_churn_column``) and the scenario-sharded ``pca_grid_sharded`` column
(:func:`run_pca_grid_sharded_column`).

:func:`write_bench_sweep`, :func:`write_bench_convergence` and
:func:`write_json` write wherever they are told; the port's CLIs never point
them at the committed ``BENCH_*.json``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np

from repro_torch.experiments.grid import SweepOutcome
from repro_torch.experiments.sweep import BatchedRunResult
from repro_torch.latency.profiler import LatencyProfiler


def paper_ordering(outcome: SweepOutcome, regime: str) -> dict[str, float]:
    """DSAG-vs-baselines verdict for one regime (paper Figs. 8-9 ordering).

    Returns mean-iteration-time ratios (baseline / DSAG, i.e. > 1 means DSAG
    is faster) plus the boolean the benchmark gates on: DSAG faster than
    both SAG and the coded bound.  When several w values were swept, each
    method is taken at its *best* swept w (w is an operating point the
    deployer tunes; averaging across w cells would blend incomparable
    configurations and let a poorly chosen extra w flip the verdict).
    Empty when the sweep ran custom methods without a "dsag" column.
    """

    def best_cell(method: str):
        ws = {r.w for r in outcome.rows if r.regime == regime and r.method == method}
        if not ws:
            raise KeyError(method)
        cells = {w: outcome.mean_iter_time(regime, method, w) for w in ws}
        w = min(cells, key=cells.get)
        return cells[w], w

    try:
        t_dsag, dsag_w = best_cell("dsag")
    except KeyError:
        return {}
    ratios = {}
    for baseline in ("sag", "coded", "gd", "sgd"):
        try:
            ratios[f"{baseline}_over_dsag"] = best_cell(baseline)[0] / t_dsag
        except KeyError:
            continue
    ratios["dsag_mean_iter_time"] = t_dsag
    ratios["dsag_w"] = float(dsag_w)
    ratios["dsag_beats_sag_and_coded"] = float(
        ratios.get("sag_over_dsag", 0.0) > 1.0
        and ratios.get("coded_over_dsag", 0.0) > 1.0
    )
    return ratios


def feed_profiler(
    result: BatchedRunResult,
    scenario: int,
    *,
    load: float = 1.0,
    window: float = np.inf,
    profiler: LatencyProfiler | None = None,
) -> LatencyProfiler:
    """Feed one scenario's batched task records into a §6.1 profiler.

    The batched engine records (assignment, start, finish, compute) per
    (iteration, worker); this flattens them into the profiler's per-worker
    moving-window deques via :meth:`LatencyProfiler.record_batch`, giving
    the load-balancing optimizer the same moment estimates it would have
    collected live.  Requires ``replay_batch(..., record_tasks=True)``.
    """
    if result.task_finish is None:
        raise ValueError("run replay_batch with record_tasks=True to feed the profiler")
    T, N = result.task_finish.shape[1:]
    if profiler is None:
        profiler = LatencyProfiler(N, window=window)
    finish = result.task_finish[scenario]  # [T, N]
    comp = result.task_comp[scenario]
    assigned = result.task_assigned[scenario][:, None]  # [T, 1]
    workers = np.broadcast_to(np.arange(N)[None, :], (T, N))
    profiler.record_batch(
        workers=workers,
        t_recorded=finish,
        round_trip=finish - assigned,
        compute=comp,
        load=load,
    )
    return profiler


def outcome_to_dict(
    outcome: SweepOutcome,
    *,
    scalar_seconds: float | None = None,
    extra: dict | None = None,
) -> dict:
    """JSON-serializable summary of a sweep (the BENCH_sweep payload)."""
    agg: dict[str, dict] = {}
    for r in outcome.rows:
        key = f"{r.regime}/{r.method}/w{r.w}"
        agg.setdefault(key, {"mean_iter_time": [], "mean_fresh": []})
        agg[key]["mean_iter_time"].append(r.mean_iter_time)
        agg[key]["mean_fresh"].append(r.mean_fresh)
    cells = {
        key: {
            "mean_iter_time": float(np.mean(v["mean_iter_time"])),
            "std_iter_time": float(np.std(v["mean_iter_time"])),
            "mean_fresh": float(np.mean(v["mean_fresh"])),
            "n_seeds": len(v["mean_iter_time"]),
        }
        for key, v in agg.items()
    }
    regimes = sorted({r.regime for r in outcome.rows})
    payload = {
        "grid": {
            "n_workers": outcome.n_workers,
            "n_seeds": outcome.n_seeds,
            "num_iterations": outcome.num_iterations,
            "n_cells": len(outcome.results),
            "regimes": regimes,
            "seed": outcome.seed,
        },
        "engine_seconds": outcome.engine_seconds,
        "cells": cells,
        "ordering": {reg: paper_ordering(outcome, reg) for reg in regimes},
    }
    if scalar_seconds is not None:
        payload["scalar_seconds"] = scalar_seconds
        payload["speedup_vs_scalar"] = scalar_seconds / max(
            outcome.engine_seconds, 1e-12
        )
    if extra:
        payload.update(extra)
    return payload


def _json_safe(obj):
    """Replace non-finite floats with None: json.dump would otherwise emit
    the non-standard Infinity/NaN tokens and produce invalid strict JSON."""
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, float) and not np.isfinite(obj):
        return None
    return obj


def write_json(payload: dict, path: str) -> dict:
    payload = _json_safe(payload)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)
    return payload


def write_bench_sweep(
    outcome: SweepOutcome,
    path: str,
    *,
    scalar_seconds: float | None = None,
    extra: dict | None = None,
) -> dict:
    """Write the sweep summary (the ``BENCH_sweep.json`` payload) to ``path``."""
    payload = outcome_to_dict(outcome, scalar_seconds=scalar_seconds, extra=extra)
    return write_json(payload, path)



def convergence_ordering(outcome, gap: float) -> dict[str, float]:
    """Time-to-gap verdict across methods (the paper's headline numbers).

    Returns each method's median (across scenarios) time to reach
    ``suboptimality <= gap``, the ratios over DSAG, and the verdicts:
    DSAG reaching the gap before SAG and before the coded bound.
    """
    out: dict[str, float] = {"gap": gap}
    medians: dict[str, float] = {}
    for name, res in outcome.results.items():
        ttg = res.time_to_gap(gap)
        # the median of [finite..., inf] stays finite while fewer than half
        # the scenarios miss the gap; the miss rate is reported separately
        medians[name] = float(np.median(ttg))
        out[f"median_time_to_gap_{name}"] = medians[name]
        out[f"reached_gap_frac_{name}"] = float(np.isfinite(ttg).mean())
    if "dsag" in medians:
        t_dsag = medians["dsag"]
        for name, t in medians.items():
            if name != "dsag":
                out[f"{name}_over_dsag"] = (
                    t / t_dsag if np.isfinite(t_dsag) else float("nan")
                )
        # the verdict is only meaningful when both baselines actually ran
        if "sag" in medians and "coded" in medians:
            sag_t, coded_t = medians["sag"], medians["coded"]
            out["dsag_fastest_to_gap"] = float(
                np.isfinite(t_dsag) and t_dsag < sag_t and t_dsag < coded_t
            )
            out["ordering_dsag_sag_coded"] = float(
                np.isfinite(t_dsag) and t_dsag < sag_t <= coded_t
            )
    return out



def convergence_payload(outcome, gap: float) -> dict:
    """JSON-serializable summary of one convergence sweep (grid, per-method
    time-to-gap columns, and the ordering verdict): the building block of
    ``BENCH_convergence.json``; extra workloads (e.g. the paper-scale PCA
    column) nest their own payload beside the main one."""
    methods = {}
    for name, res in outcome.results.items():
        ttg = res.time_to_gap(gap)
        final_gap = res.suboptimality[:, -1]
        methods[name] = {
            "median_time_to_gap": float(np.median(ttg)),
            "mean_total_time": float(res.times[:, -1].mean()),
            "mean_final_gap": float(np.nanmean(final_gap)),
            "mean_fresh": float(res.fresh_counts.mean()),
            "w": outcome.methods[name].w,
            "load_balance": bool(outcome.methods[name].load_balance),
        }
    return {
        "grid": {
            "n_workers": outcome.traces.num_workers,
            "n_scenarios": outcome.traces.num_scenarios,
            "num_iterations": outcome.num_iterations,
            "problem": type(outcome.problem).__name__,
            "num_samples": outcome.problem.num_samples,
        },
        "gap": gap,
        "engine_seconds": outcome.engine_seconds,
        "methods": methods,
        "ordering": convergence_ordering(outcome, gap),
    }


def write_bench_convergence(
    outcome,
    path: str,
    *,
    gap: float,
    scalar_seconds: float | None = None,
    scalar_seconds_measured: float | None = None,
    scalar_methods: list | None = None,
    extra: dict | None = None,
) -> dict:
    """Write the convergence-sweep summary to ``path`` (no default: the
    committed ``BENCH_convergence.json`` is the reference's).

    ``scalar_seconds`` is the (possibly extrapolated) wall-clock through the
    scalar ``TrainingSimulator``; ``scalar_seconds_measured`` the actually
    timed subset.  When the scalar timing covers only a subset of the
    engine's methods, pass ``scalar_methods``: the top-level
    ``speedup_vs_scalar`` (scalar over ``engine_seconds``) is then omitted,
    since a subset's scalar time over the full grid's engine time compares
    unlike things.
    """
    payload = convergence_payload(outcome, gap)
    if scalar_seconds is not None:
        payload["scalar_seconds"] = scalar_seconds
        if scalar_methods is None:
            payload["speedup_vs_scalar"] = scalar_seconds / max(outcome.engine_seconds, 1e-12)
        else:
            payload["scalar_methods"] = list(scalar_methods)
    if scalar_seconds_measured is not None:
        payload["scalar_seconds_measured"] = scalar_seconds_measured
    if extra:
        payload.update(extra)
    return write_json(payload, path)

@dataclasses.dataclass
class LbScanRun:
    """One §6 DSAG config through the host and the device engine."""

    config: object  # the MethodConfig, load_balance=True
    host: object  # ConvergenceBatchResult
    scan: object
    host_seconds: float
    scan_seconds: float

    def mismatches(self) -> list[str]:
        """The fields in which the two engines differ (empty when bit-equal)."""
        from repro_torch.experiments.convergence import result_mismatches

        return result_mismatches(self.host, self.scan)

    def column(self, gap: float, base_medians: dict[str, float] | None = None) -> dict:
        """The ``lb_scan`` column: bit-equality, the publication count, and
        the DSAG-with-§6 time-to-gap verdict against the non-§6 methods'
        medians on the same traces (``base_medians``)."""
        ttg = self.scan.time_to_gap(gap)
        t_lb = float(np.median(ttg))
        ordering = {
            "gap": gap,
            "median_time_to_gap_dsag_lb": t_lb,
            "reached_gap_frac_dsag_lb": float(np.isfinite(ttg).mean()),
        }
        if base_medians:
            for name, t in base_medians.items():
                if name != "dsag" and t and t > 0:
                    ordering[f"{name}_over_dsag_lb"] = t / t_lb
            sag_t, coded_t = base_medians.get("sag"), base_medians.get("coded")
            if sag_t is not None and coded_t is not None:
                ordering["dsag_lb_fastest_to_gap"] = float(t_lb < sag_t and t_lb < coded_t)
        cfg = self.config
        return {
            "config": {
                "w": cfg.w, "subpartitions": cfg.subpartitions, "eta": cfg.eta,
                "lb_startup_delay": cfg.lb_startup_delay, "lb_interval": cfg.lb_interval,
            },
            "host_seconds": self.host_seconds,
            "scan_seconds": self.scan_seconds,
            "bitexact_scan_vs_host": not self.mismatches(),
            "repartitions_mean": float(np.mean([len(ev) for ev in self.scan.repartition_events])),
            "ordering": ordering,
        }


def run_lb_scan(problem, traces, dsag_config, *, num_iterations: int, eval_every: int,
                seed: int, engine=None, what_if_normals=None) -> LbScanRun:
    """Run ``dsag_config`` with the §6 load balancer through the host and
    the device engine (host wall clocks ending in a synchronize)."""
    import torch

    from repro_torch.experiments.convergence import run_convergence_batch
    from repro_torch.experiments.engine import EngineConfig

    eng = EngineConfig() if engine is None else engine
    cfg = dataclasses.replace(dsag_config, load_balance=True)
    out, secs = {}, {}
    for kind in ("host", "scan"):
        t0 = time.perf_counter()
        out[kind] = run_convergence_batch(
            problem, traces, cfg, num_iterations, eval_every=eval_every, seed=seed,
            engine=dataclasses.replace(eng, kind=kind), what_if_normals=what_if_normals,
        )
        if torch.device(eng.device).type == "cuda":
            torch.cuda.synchronize()
        secs[kind] = time.perf_counter() - t0
    return LbScanRun(cfg, out["host"], out["scan"], secs["host"], secs["scan"])


#: every parameter of the ``churn`` column's run
#: (``benchmarks/bench_regression.CHURN_RECIPE``; the committed column
#: carries the same dict as its ``recipe``)
CHURN_RECIPE = {
    "problem": "logreg_higgs",
    "num_samples": 4096,
    "n_workers": 40,
    "subpartitions": 4,
    "w": 32,
    "eta": 0.25,
    "n_scenarios": 5,
    "num_iterations": 40,
    "eval_every": 5,
    "regime": "heavy_bursts",
    "seed": 0,
    "gap": 0.2,
    # the elastic-fleet schedule, in fractions of the churn-free run: the
    # slowest fifth of the fleet dies at 30% of the run and half of the dead
    # rejoin at 70%
    "death_frac": 0.2,
    "death_at_frac": 0.3,
    "revive_frac": 0.5,
    "revive_at_frac": 0.7,
}


def fleet_churn(traces, w: int, num_iterations: int, *, death_frac: float,
                death_at_frac: float, revive_frac: float, revive_at_frac: float,
                device="cuda"):
    """The churn column's schedule rule on ``traces``: ``(ChurnSchedule,
    schedule dict)``.  The run length is the median over scenarios of a
    churn-free latency replay (``replay_batch``, no gradients); the slowest
    ``death_frac`` of the fleet (by static slowdown, ties by index) dies at
    ``death_at_frac`` of it, and the first ``revive_frac`` of the dead
    rejoin at ``revive_at_frac``.  Deterministic given the traces."""
    from repro_torch.experiments.sweep import replay_batch
    from repro_torch.latency.model import ChurnSchedule

    base = replay_batch(traces, w, num_iterations, device=device)
    total = float(np.median(base.iteration_times[:, -1]))
    death_at, revive_at = death_at_frac * total, revive_at_frac * total
    N = traces.num_workers
    sd = np.asarray(traces.slowdown)
    dead = np.argsort(-sd, kind="stable")[:max(1, int(round(death_frac * N)))]
    revived = dead[:int(round(revive_frac * dead.size))]
    alive = np.ones((3, N), bool)
    alive[1:, dead] = False
    alive[2, revived] = True
    churn = ChurnSchedule(times=np.array([death_at, revive_at]),
                          slowdown=np.stack([sd, sd, sd]), alive=alive)
    return churn, {"death_at": death_at, "revive_at": revive_at,
                   "dead_workers": [int(i) for i in dead],
                   "revived_workers": [int(i) for i in revived]}


@dataclasses.dataclass
class ChurnColumnRun:
    """The ``churn`` column's run: the column, and what it was made from."""

    column: dict
    problem: object
    cluster: object
    traces: object  # the churned FleetTraces
    methods: dict  # name -> MethodConfig
    runs: dict  # name -> {"host": ConvergenceBatchResult, "scan": ...}
    seconds: dict  # name -> {"host": s, "scan": s}, host wall clocks


def run_churn_column(recipe: dict | None = None, *, engine=None) -> ChurnColumnRun:
    """DSAG, SAG and coded through the column's churn schedule, host and
    device engines (``benchmarks/bench_regression.run_churn_column``).

    The heterogeneous heavy-burst fleet of the ``grid`` recipe at the
    recipe's N, S and T; the schedule from :func:`fleet_churn`; every method
    through both engines on the churned traces.  The column holds the
    schedule, whether the engines agree bit for bit, each method's median
    time-to-gap and reached fraction, and the dsag < sag < coded verdict.
    Writes nothing.
    """
    import torch

    from repro_torch.core.problems import LogisticRegressionProblem, make_higgs_like
    from repro_torch.experiments.convergence import (
        default_convergence_methods,
        result_mismatches,
        run_convergence_batch,
    )
    from repro_torch.experiments.engine import EngineConfig
    from repro_torch.experiments.grid import DEFAULT_REGIMES
    from repro_torch.latency.model import make_heterogeneous_cluster, sample_fleet

    eng = EngineConfig() if engine is None else engine
    r = dict(CHURN_RECIPE, **(recipe or {}))
    if r["problem"] != "logreg_higgs":
        raise ValueError(f"churn recipe problem {r['problem']!r} is not reproducible here")
    regime = {reg.name: reg for reg in DEFAULT_REGIMES}[r["regime"]]
    X, y = make_higgs_like(r["num_samples"], seed=r["seed"])
    prob = LogisticRegressionProblem(X=X, y=y)
    N, sp, T = r["n_workers"], r["subpartitions"], r["num_iterations"]
    c_task = prob.compute_cost(1, max(prob.num_samples // (N * sp), 1))
    cluster = make_heterogeneous_cluster(N, seed=r["seed"], burst_rate=0.0, load_unit=c_task)
    traces = sample_fleet(cluster, r["n_scenarios"], T, burst_rate=regime.rate,
                          burst_factor_mean=regime.factor_mean,
                          burst_duration_mean=regime.duration_mean, seed=r["seed"] + 1)
    churn, schedule = fleet_churn(
        traces, r["w"], T, death_frac=r["death_frac"], death_at_frac=r["death_at_frac"],
        revive_frac=r["revive_frac"], revive_at_frac=r["revive_at_frac"], device=eng.device)
    churned = traces.with_churn(churn)
    methods = default_convergence_methods(N, w=r["w"], eta=r["eta"], subpartitions=sp)
    bitexact = True
    cols, runs, secs = {}, {}, {}
    for name in ("dsag", "sag", "coded"):
        runs[name], secs[name] = {}, {}
        for kind in ("host", "scan"):
            t0 = time.perf_counter()
            runs[name][kind] = run_convergence_batch(
                prob, churned, methods[name], T, eval_every=r["eval_every"], seed=r["seed"],
                engine=dataclasses.replace(eng, kind=kind))
            if torch.device(eng.device).type == "cuda":
                torch.cuda.synchronize()
            secs[name][kind] = time.perf_counter() - t0
        bitexact = bitexact and not result_mismatches(runs[name]["host"], runs[name]["scan"])
        ttg = runs[name]["scan"].time_to_gap(r["gap"])
        med = float(np.median(ttg))
        cols[name] = {"median_time_to_gap": med if np.isfinite(med) else None,
                      "reached_gap_frac": float(np.isfinite(ttg).mean())}
    t = [cols[m]["median_time_to_gap"] for m in ("dsag", "sag", "coded")]
    finite = all(v is not None for v in t)
    ordering = {"gap": r["gap"], "ordering_dsag_sag_coded": float(finite and t[0] < t[1] < t[2])}
    if finite and t[0] > 0:
        ordering["sag_over_dsag"] = t[1] / t[0]
        ordering["coded_over_dsag"] = t[2] / t[0]
    column = {"recipe": r, "schedule": schedule, "bitexact_scan_vs_host": bitexact,
              "methods": cols, "ordering": ordering}
    return ChurnColumnRun(column, prob, cluster, churned, methods, runs, secs)


@dataclasses.dataclass
class PcaGridShardedRun:
    """The ``pca_grid_sharded`` column's run: the column, and the two
    sweeps it compares."""

    column: dict
    sharded: object  # ConvergenceSweepOutcome through the scenario mesh
    unsharded: object  # the same sweep, unsharded


def run_pca_grid_sharded_column(*, n_scenarios: int = 40, num_devices: int | None = None,
                                seed: int = 0, engine=None,
                                scale: float = 1.0) -> PcaGridShardedRun:
    """The ``pca_grid_sharded`` column (``benchmarks/bench_regression.
    run_pca_grid_sharded_column``): the paper-scale PCA grid at
    ``n_scenarios`` through the scenario-sharded device engine and through
    the unsharded one.

    The shards are ``engine.mesh`` where ``engine`` has one (``(cpu,) * n``
    on the CPU, or several shards on one card), else the first
    ``num_devices`` cards (default 4), clamped to the cards torch sees, as
    the reference clamps to its devices.  ``engine`` (default
    ``EngineConfig()``) gives the device and the kernel backend; both runs
    take the device engine.  ``scale`` shrinks rows and iterations as
    :func:`~repro_torch.experiments.convergence.paper_scale_pca_sweep` does
    (1.0 is the committed column).  The column is the sharded sweep's
    :func:`convergence_payload` plus ``num_devices`` (the shards), ``seed``,
    ``bitexact_sharded_vs_unsharded`` (every field of every method's result,
    publication times included), ``sharded_seconds``, ``unsharded_seconds``
    and ``device_scaling`` (unsharded over sharded wall clock).
    """
    import torch

    from repro_torch.experiments.convergence import paper_scale_pca_sweep, result_mismatches
    from repro_torch.experiments.engine import EngineConfig

    eng = EngineConfig() if engine is None else engine
    plain = dataclasses.replace(eng, kind="scan", num_devices=None, mesh=None)
    if eng.mesh is not None:
        sharded, D = dataclasses.replace(plain, mesh=eng.mesh), eng.mesh.size
    else:
        D = min(4 if num_devices is None else num_devices, torch.cuda.device_count())
        sharded = dataclasses.replace(plain, num_devices=D)
    kw = dict(scale=scale, seed=seed, n_scenarios=n_scenarios)
    sharded_out, gap = paper_scale_pca_sweep(engine=sharded, **kw)
    plain_out, _ = paper_scale_pca_sweep(engine=plain, **kw)
    bitexact = all(not result_mismatches(r, plain_out.results[m])
                   for m, r in sharded_out.results.items())
    column = convergence_payload(sharded_out, gap)
    column.update(
        num_devices=D,
        seed=seed,
        bitexact_sharded_vs_unsharded=bool(bitexact),
        sharded_seconds=sharded_out.engine_seconds,
        unsharded_seconds=plain_out.engine_seconds,
        device_scaling=plain_out.engine_seconds / max(sharded_out.engine_seconds, 1e-12),
    )
    return PcaGridShardedRun(column, sharded_out, plain_out)
