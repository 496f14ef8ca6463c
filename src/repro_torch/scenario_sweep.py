"""Run a §7 iteration-time sweep (paper Figs. 8-9) on the device and print
the grid.

  python -m repro_torch.scenario_sweep                      # on the card
  python -m repro_torch.scenario_sweep --workers 100 --seeds 10 --iters 100 \\
      --check-scalar --out /tmp/sweep.json                  # the BENCH_sweep grid
  python -m repro_torch.scenario_sweep --device cpu

Sweeps (seeds x methods x w x burst regimes) in one batched pass — GD, the
idealized coded bound, SGD, SAG and DSAG across the calm, paper and heavy
burst regimes — like ``examples/scenario_sweep.py`` of the JAX package, and
prints the same table and the DSAG-vs-SAG/coded ordering.  ``--out`` writes
the ``BENCH_sweep.json`` payload to the path given (nothing is written
without it).  The sweep launches none of the port's kernels: it is float64
event algebra on ``[S, N]`` tensors.
"""

from __future__ import annotations

import argparse

from repro_torch.experiments.grid import run_sweep, scalar_sweep_seconds
from repro_torch.experiments.results import paper_ordering, write_bench_sweep


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workers", type=int, default=50)
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--w-frac", type=float, nargs="+", default=[0.8])
    ap.add_argument("--out", default=None, help="write the BENCH-style JSON here")
    ap.add_argument("--check-scalar", action="store_true",
                    help="also time the scalar event-loop baseline (slow)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the sweep (default cuda)")
    args = ap.parse_args(argv)

    out = run_sweep(
        n_workers=args.workers,
        n_seeds=args.seeds,
        num_iterations=args.iters,
        w_fracs=tuple(args.w_frac),
        device=args.device,
    )
    print(f"{len(out.results)} cells x {args.seeds} seeds in "
          f"{out.engine_seconds:.3f}s (batched engine, device {args.device})")
    scalar_s = None
    if args.check_scalar:
        scalar_s = scalar_sweep_seconds(out)
        print(f"scalar event loop: {scalar_s:.2f}s "
              f"({scalar_s / out.engine_seconds:.1f}x the batched engine)")

    header = f"{'regime':>14} {'method':>6} {'w':>4} {'mean iter (ms)':>15} {'fresh':>6}"
    print(header)
    print("-" * len(header))
    seen = set()
    for r in out.rows:
        key = (r.regime, r.method, r.w)
        if key in seen:
            continue
        seen.add(key)
        print(f"{r.regime:>14} {r.method:>6} {r.w:>4} "
              f"{1e3 * out.mean_iter_time(r.regime, r.method, r.w):>15.4f} "
              f"{r.mean_fresh:>6.1f}")

    orderings = {}
    for regime in sorted({r.regime for r in out.rows}):
        o = orderings[regime] = paper_ordering(out, regime)
        print(f"{regime}: sag/dsag={o['sag_over_dsag']:.2f}x "
              f"coded/dsag={o['coded_over_dsag']:.2f}x "
              f"dsag_beats_sag_and_coded={bool(o['dsag_beats_sag_and_coded'])}")

    if args.out:
        write_bench_sweep(out, args.out, scalar_seconds=scalar_s)
        print(f"wrote {args.out}")
    return orderings


if __name__ == "__main__":
    main()
