"""Run a batched §7 convergence sweep (time-to-suboptimality) on the device
engine and print each method's time-to-gap across scenarios.

  python -m repro_torch.convergence_sweep                  # on the card
  python -m repro_torch.convergence_sweep --workers 100 --scenarios 10 \\
      --iters 60 --samples 16384 --w-frac 0.8 --eval-every 5   # the grid recipe
  python -m repro_torch.convergence_sweep --paper-scale    # n=50k PCA recipe
  python -m repro_torch.convergence_sweep --device cpu --kernel-backend torch \\
      --workers 8 --scenarios 2 --iters 10 --samples 1024
  python -m repro_torch.convergence_sweep --engine host --check-scalar
  python -m repro_torch.convergence_sweep --load-balance [--slot-budget 8000]
  python -m repro_torch.convergence_sweep --lb-column --out lb.json
  python -m repro_torch.convergence_sweep --churn-column [--device cpu --kernel-backend torch]
  python -m repro_torch.convergence_sweep --scenarios 6 --load-balance --devices 2

Runs DSAG, SAG (w = N), SGD and the idealized coded bound through the full
training loop on one shared heavy-burst trace draw, like
``examples/convergence_sweep.py`` of the JAX package, and prints the same
table and the same ``sag/dsag``, ``coded/dsag`` line.  ``--engine host``
runs the numpy host loop instead of the device engine; ``--check-scalar``
replays scenario 0 of every method through the scalar ``TrainingSimulator``
on the same device and kernels and fails unless it is bit-exact.
``--load-balance`` runs DSAG with the §6 load balancer; ``--slot-budget``
caps the device engine's densely resident §6 cache slots (above it the
tiled cache runs; past even that, ``--engine auto`` runs the host engine).
``--lb-column`` runs the ``grid`` recipe and then its dsag with the §6
balancer through both engines (the ``lb_scan`` column of
``BENCH_convergence.json``), fails unless the two are bit-equal, and prints
the column.  ``--churn-column`` runs the ``churn`` column instead (dsag,
sag and coded through the host and device engines on an elastic fleet:
the slowest fifth dies mid-run, half of it rejoins), with the recipe read
from the committed ``BENCH_convergence.json``, fails unless the engines
agree bit for bit, and prints the column beside the committed one.
``--devices N`` shards the device engine's scenario axis over the first N
cards (``EngineConfig(num_devices=N)``); the results equal the unsharded
run's bit for bit.  ``--out`` writes the sweep's payload there in the layout of
``BENCH_convergence.json`` (what the reference's
``examples/convergence_sweep.py --out`` writes: ``grid``, ``gap``,
``methods``, ``ordering``, and with ``--check-scalar`` the scalar timing),
with the ``lb_scan`` column nested under its name; ``--churn-column --out``
writes ``{"churn": column}``.  Nothing writes the committed
``BENCH_*.json``.  The §6 what-if draws are the reference's for every seed
and fleet size (``repro_torch.lb.threefry``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np

from repro_torch.cluster.simulator import effective_w
from repro_torch.core.problems import (
    LogisticRegressionProblem,
    PCAProblem,
    make_genomics_like_matrix,
    make_higgs_like,
)
from repro_torch.experiments.convergence import (
    GRID_LB,
    GRID_LOGREG,
    PAPER_SCALE_PCA,
    default_convergence_methods,
    grid_logreg_sweep,
    history_mismatches,
    paper_scale_pca_sweep,
    run_convergence_sweep,
    scalar_convergence_run,
)
from repro_torch.experiments.engine import EngineConfig
from repro_torch.experiments.grid import HEAVY_BURSTS
from repro_torch.experiments.results import (
    convergence_ordering,
    run_churn_column,
    run_lb_scan,
    write_bench_convergence,
    write_json,
)
from repro_torch.latency.model import make_heterogeneous_cluster

#: the committed convergence artifact (read only): the churn recipe's source
BENCH_FILE = Path(__file__).resolve().parents[2] / "BENCH_convergence.json"


def run(argv=None):
    """Parse ``argv`` and run the sweep it names: ``(outcome, gap, args)``
(``(None, None, args)`` for ``--churn-column``, which :func:`main` runs)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--problem", choices=("logreg", "pca"), default="logreg")
    ap.add_argument("--paper-scale", action="store_true",
                    help="run the calibrated paper-scale PCA sweep (implies "
                    "--problem pca; n=50k rows, 50 workers)")
    ap.add_argument("--workers", type=int, default=40)
    ap.add_argument("--scenarios", type=int, default=6)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--samples", type=int, default=4096)
    ap.add_argument("--cols", type=int, default=96,
                    help="columns of the PCA matrix (pca only)")
    ap.add_argument("--w-frac", type=float, default=0.8)
    ap.add_argument("--subpartitions", type=int, default=10)
    ap.add_argument("--eta", type=float, default=None,
                    help="step size (default 0.25 for logreg, 0.9 for pca)")
    ap.add_argument("--gap", type=float, default=None,
                    help="time-to-gap threshold (default 0.2 logreg, 1e-4 pca)")
    ap.add_argument("--eval-every", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine state (default cuda)")
    ap.add_argument("--kernel-backend", choices=("cuda", "torch"), default="cuda",
                    help="the hand-written CUDA kernels or their plain-torch "
                    "versions")
    ap.add_argument("--engine", choices=("auto", "scan", "host"), default="auto",
                    help="the device engine (auto/scan) or the numpy host loop")
    ap.add_argument("--devices", type=int, default=None,
                    help="shard the device engine's scenario axis over this many cards "
                    "(the first N that torch sees)")
    ap.add_argument("--check-scalar", action="store_true",
                    help="replay scenario 0 of every method through the scalar "
                    "TrainingSimulator and fail unless it is bit-exact")
    ap.add_argument("--load-balance", action="store_true",
                    help="run DSAG with the §6 load balancer in the loop")
    ap.add_argument("--slot-budget", type=int, default=None,
                    help="the device engine's budget of resident §6 cache entries "
                    "(default fused.LB_MAX_SLOTS); past it --engine auto runs the host "
                    "engine and --engine scan refuses")
    ap.add_argument("--lb-column", action="store_true",
                    help="run the grid recipe, then its dsag with the §6 balancer "
                    "through the host and device engines (the lb_scan column)")
    ap.add_argument("--churn-column", action="store_true",
                    help="run the churn column (dsag, sag, coded through the host and "
                    "device engines under worker death and rejoin) from the committed "
                    "recipe, and print it beside the committed values")
    ap.add_argument("--out", default=None,
                    help="write the BENCH_convergence.json-layout payload here")
    args = ap.parse_args(argv)
    engine = EngineConfig(
        device=args.device, kernel_backend=args.kernel_backend, kind=args.engine,
        slot_budget=args.slot_budget, num_devices=args.devices,
    )

    if args.churn_column:  # its own recipe: main runs it
        return None, None, args
    if args.lb_column:
        out, default_gap = grid_logreg_sweep(seed=0, engine=engine)
        print(f"grid recipe: {GRID_LOGREG}")
    elif args.paper_scale:
        out, default_gap = paper_scale_pca_sweep(seed=0, engine=engine)
        N = out.traces.num_workers
        print(
            f"paper-scale PCA: n={out.problem.num_samples} rows, {N} workers, "
            f"{out.traces.num_scenarios} scenarios, {out.num_iterations} iters "
            f"(PAPER_SCALE_PCA={PAPER_SCALE_PCA})"
        )
    else:
        if args.problem == "pca":
            prob = PCAProblem(
                X=make_genomics_like_matrix(args.samples, args.cols, seed=0), k=3
            )
            eta = 0.9 if args.eta is None else args.eta
            default_gap = 1e-4
        else:
            X, y = make_higgs_like(args.samples, seed=0)
            prob = LogisticRegressionProblem(X=X, y=y)
            eta = 0.25 if args.eta is None else args.eta
            default_gap = 0.2
        N, sp = args.workers, args.subpartitions
        c_task = prob.compute_cost(1, max(prob.num_samples // (N * sp), 1))
        cluster = make_heterogeneous_cluster(N, seed=0, burst_rate=0.0, load_unit=c_task)
        w = min(max(round(args.w_frac * N), 1), N)
        methods = default_convergence_methods(N, w=w, eta=eta, subpartitions=sp,
                                              load_balance_dsag=args.load_balance)
        out = run_convergence_sweep(
            prob, cluster, methods,
            n_scenarios=args.scenarios, num_iterations=args.iters,
            eval_every=args.eval_every, regime=HEAVY_BURSTS, seed=0,
            engine=engine,
        )
    return out, default_gap if args.gap is None else args.gap, args


def churn_column(engine: EngineConfig) -> dict:
    """The ``churn`` column from the recipe committed in
    ``BENCH_convergence.json`` (read only); raise unless the host and
    device engines agree bit for bit.  Prints the column's values beside
    the committed ones."""
    committed = json.loads(BENCH_FILE.read_text())["churn"]
    col = run_churn_column(committed["recipe"], engine=engine).column
    if not col["bitexact_scan_vs_host"]:
        raise AssertionError("churn: the host and device engines differ")
    sch = col["schedule"]
    print(f"churn: deaths {sch['dead_workers']} at {sch['death_at']!r} s, rejoins "
          f"{sch['revived_workers']} at {sch['revive_at']!r} s; host == device bit for bit")
    for m, v in col["methods"].items():
        theirs = committed["methods"][m]
        print(f"{m:>6} median t->gap {v['median_time_to_gap']!r} (committed "
              f"{theirs['median_time_to_gap']!r}), reached {v['reached_gap_frac']} "
              f"(committed {theirs['reached_gap_frac']})")
    same = {k: col[k] == committed[k] for k in ("schedule", "methods", "ordering")}
    print(f"ordering_dsag_sag_coded {col['ordering']['ordering_dsag_sag_coded']}; equal to "
          f"the committed column: {same}")
    return col


def check_scalar(out, engine: EngineConfig) -> tuple[float, float]:
    """Replay scenario 0 of every method through the scalar simulator on
    ``engine``'s device and kernels; raise unless each equals the batched
    run bit for bit.  Returns the replays' seconds and that time scaled to
    all scenarios."""
    t0 = time.perf_counter()
    for name, res in out.results.items():
        bad = history_mismatches(scalar_convergence_run(out, name, 0, engine=engine), res, 0)
        if bad:
            raise AssertionError(f"{name}: the scalar replay of scenario 0 differs in {bad}")
    measured = time.perf_counter() - t0
    return measured, measured * out.traces.num_scenarios


def lb_column(out, gap: float, engine: EngineConfig) -> dict:
    """The ``lb_scan`` column on ``out``'s traces: its dsag with the §6
    balancer (the recipe's schedule) through both engines, which must agree
    bit for bit; the ratios are against ``out``'s medians."""
    run_ = run_lb_scan(
        out.problem, out.traces, dataclasses.replace(out.methods["dsag"], **GRID_LB),
        num_iterations=out.num_iterations, eval_every=out.eval_every, seed=out.seed,
        engine=EngineConfig(device=engine.device, kernel_backend=engine.kernel_backend,
                            slot_budget=engine.slot_budget),
    )
    bad = run_.mismatches()
    if bad:
        raise AssertionError(f"lb_scan: the host and device engines differ in {bad}")
    base = {m: float(np.median(r.time_to_gap(gap))) for m, r in out.results.items()}
    return run_.column(gap, base)


def main(argv=None) -> dict:
    out, gap, args = run(argv)
    if args.churn_column:
        col = churn_column(EngineConfig(device=args.device, kernel_backend=args.kernel_backend))
        if args.out:
            write_json({"churn": col}, args.out)
            print(f"wrote {args.out}")
        return col
    N = out.traces.num_workers
    engine = EngineConfig(device=args.device, kernel_backend=args.kernel_backend,
                          slot_budget=args.slot_budget)
    print(
        f"{len(out.methods)} methods x {out.traces.num_scenarios} scenarios x "
        f"{out.num_iterations} iterations in {out.engine_seconds:.2f}s "
        f"({args.engine} engine, device {args.device}, {args.kernel_backend} kernels)"
    )
    measured = scaled = None
    if args.check_scalar:
        measured, scaled = check_scalar(out, engine)
        print(f"scalar TrainingSimulator replay of scenario 0: bit-exact for "
              f"{len(out.results)} methods in {measured:.2f}s ({scaled:.1f}s for all "
              f"{out.traces.num_scenarios} scenarios)")
    header = f"{'method':>6} {'w':>4} {'median t->gap (s)':>18} {'final gap':>11} {'total t (s)':>12}"
    print(header)
    print("-" * len(header))
    for name, res in out.results.items():
        ttg = res.time_to_gap(gap)
        print(
            f"{name:>6} {effective_w(out.methods[name], N):>4} "
            f"{np.median(ttg):>18.4f} "
            f"{np.nanmean(res.suboptimality[:, -1]):>11.2e} "
            f"{res.times[:, -1].mean():>12.3f}"
        )
    o = convergence_ordering(out, gap)
    print(
        f"gap={gap}: sag/dsag={o['sag_over_dsag']:.2f}x "
        f"coded/dsag={o['coded_over_dsag']:.2f}x "
        f"dsag_fastest={bool(o['dsag_fastest_to_gap'])}"
    )
    extra = {}
    if args.lb_column:
        col = lb_column(out, gap, engine)
        lo = col["ordering"]
        print(
            f"lb_scan: host == device bit for bit; host {col['host_seconds']:.2f}s, device "
            f"{col['scan_seconds']:.2f}s; median t->gap dsag+lb "
            f"{lo['median_time_to_gap_dsag_lb']!r}, repartitions_mean "
            f"{col['repartitions_mean']!r}, sag/dsag_lb={lo['sag_over_dsag_lb']:.3f} "
            f"coded/dsag_lb={lo['coded_over_dsag_lb']:.3f} "
            f"fastest={bool(lo['dsag_lb_fastest_to_gap'])}"
        )
        extra["lb_scan"] = col
        o = dict(o, lb_scan=col)
    if args.out:
        # the scalar replay covers every method (scenario 0, scaled to all)
        write_bench_convergence(out, args.out, gap=gap, scalar_seconds=scaled,
                                scalar_seconds_measured=measured, extra=extra)
        print(f"wrote {args.out}")
    return o


if __name__ == "__main__":
    main()
