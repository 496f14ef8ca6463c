"""Results layer of the §7 sweeps: ordering verdicts, the §6.1 profiler feed
from batched traces, the ``BENCH_sweep.json`` payload, and the time-to-gap
verdict of the convergence sweeps (``repro.experiments.results``).

:func:`write_bench_sweep` writes wherever it is told; the port's CLI never
points it at the committed ``BENCH_sweep.json``.
"""

from __future__ import annotations

import json
import os

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


def _write_json(payload: dict, path: str) -> dict:
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
    return _write_json(payload, path)



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
