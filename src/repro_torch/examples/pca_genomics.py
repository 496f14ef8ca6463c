"""The paper's PCA experiment (§7, Fig. 8 left): distributed power-method PCA
of a genomics-like sparse binary matrix on a simulated 16-worker cluster,
comparing GD / SAG / DSAG / coded computing under persistent stragglers, on
the card (the reference's ``examples/pca_genomics.py``).

  PYTHONPATH=src python -m repro_torch.examples.pca_genomics

Each run is the scalar ``TrainingSimulator`` on live sampling of the paper's
artificial cluster, whose four slowed workers recover at t = 1 s (a timed
``clear_slowdowns``); the subgradients run through kernel K2.  :func:`run`
is the reference's inner ``run`` at module level: it returns the history,
so a caller can run fewer iterations or another engine.
"""

from __future__ import annotations

import functools

import numpy as np

from repro_torch.cluster.simulator import MethodConfig, TrainingSimulator
from repro_torch.core.problems import PCAProblem, make_genomics_like_matrix
from repro_torch.latency.model import clear_slowdowns, make_paper_artificial_cluster

N, SP, ROWS, COLS, DENSITY, EVAL_EVERY = 16, 10, 8192, 128, 0.0536, 20
GAP = 1e-6
#: (name, w, iterations, eta) of the reference's five runs
RUNS = (
    ("gd", N, 120, 1.0),  # == the power method (paper §7)
    ("coded", N, 120, 1.0),  # idealized MDS bound, rate 45/49
    ("sag", N, 400, 0.9),
    ("sag", 4, 400, 0.9),  # stalls: straggler samples never enter
    ("dsag", 4, 400, 0.9),  # converges with w << N
)


@functools.lru_cache(maxsize=1)
def problem() -> PCAProblem:
    X = make_genomics_like_matrix(ROWS, COLS, density=DENSITY, seed=0)
    return PCAProblem(X=X, k=3)  # top-3 principal components, as the paper


def run(name: str, w: int, iters: int, eta: float, *, engine=None):
    prob = problem()
    c_task = prob.compute_cost(1, prob.num_samples // (N * SP))
    cluster = make_paper_artificial_cluster(num_workers=N, load_unit=c_task, seed=1)
    events = [(1.0, lambda c: clear_slowdowns(c, range(N - 4, N)))]
    cfg = MethodConfig(name=name, w=w, eta=eta, subpartitions=SP)
    sim = TrainingSimulator(prob, cluster, cfg, eval_every=EVAL_EVERY,
                            timed_events=events, seed=0, engine=engine)
    h = sim.run(iters)
    gap = h.suboptimality[np.isfinite(h.suboptimality)][-1]
    print(f"  {name:6s} w={w:3d}: final gap {gap:.2e}  sim time {h.times[-1]:.2f} s")
    return h


def main(engine=None) -> dict:
    X = problem().X
    print(f"PCA of {X.shape} matrix (density {X.mean():.3f}), N={N} workers:")
    hs = [run(*r, engine=engine) for r in RUNS]
    t = hs[-1].time_to_gap(GAP)
    print(f"\nDSAG time to {GAP:.0e} gap: {t:.2f} s (simulated)")
    return {"dsag": t}


if __name__ == "__main__":
    main()
