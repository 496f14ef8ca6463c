"""Run a batched §7 convergence sweep (time-to-suboptimality) on the device
engine and print each method's time-to-gap across scenarios.

  python -m repro_torch.convergence_sweep                  # on the card
  python -m repro_torch.convergence_sweep --workers 100 --scenarios 10 \\
      --iters 60 --samples 16384 --w-frac 0.8 --eval-every 5   # the grid recipe
  python -m repro_torch.convergence_sweep --paper-scale    # n=50k PCA recipe
  python -m repro_torch.convergence_sweep --device cpu --kernel-backend torch \\
      --workers 8 --scenarios 2 --iters 10 --samples 1024

Runs DSAG, SAG (w = N), SGD and the idealized coded bound through the full
training loop on one shared heavy-burst trace draw, like
``examples/convergence_sweep.py`` of the JAX package, and prints the same
table and the same ``sag/dsag``, ``coded/dsag`` line.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.cluster.simulator import effective_w
from repro_torch.core.problems import (
    LogisticRegressionProblem,
    PCAProblem,
    make_genomics_like_matrix,
    make_higgs_like,
)
from repro_torch.experiments.convergence import (
    PAPER_SCALE_PCA,
    default_convergence_methods,
    paper_scale_pca_sweep,
    run_convergence_sweep,
)
from repro_torch.experiments.engine import EngineConfig
from repro_torch.experiments.grid import HEAVY_BURSTS
from repro_torch.experiments.results import convergence_ordering
from repro_torch.latency.model import make_heterogeneous_cluster


def run(argv=None):
    """Parse ``argv`` and run the sweep it names: ``(outcome, gap, args)``."""
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
    args = ap.parse_args(argv)
    engine = EngineConfig(device=args.device, kernel_backend=args.kernel_backend)

    if args.paper_scale:
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
        methods = default_convergence_methods(N, w=w, eta=eta, subpartitions=sp)
        out = run_convergence_sweep(
            prob, cluster, methods,
            n_scenarios=args.scenarios, num_iterations=args.iters,
            eval_every=args.eval_every, regime=HEAVY_BURSTS, seed=0,
            engine=engine,
        )
    return out, default_gap if args.gap is None else args.gap, args


def main(argv=None) -> dict:
    out, gap, args = run(argv)
    N = out.traces.num_workers
    print(
        f"{len(out.methods)} methods x {out.traces.num_scenarios} scenarios x "
        f"{out.num_iterations} iterations in {out.engine_seconds:.2f}s "
        f"(device {args.device}, {args.kernel_backend} kernels)"
    )
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
    return o


if __name__ == "__main__":
    main()
