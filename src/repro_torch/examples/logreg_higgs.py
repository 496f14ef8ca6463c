"""The paper's logistic-regression experiment (§7, Fig. 8 right) with dynamic
load balancing: HIGGS-like data, 16 workers, DSAG vs DSAG-LB vs SAG, on the
card (the reference's ``examples/logreg_higgs.py``).

  PYTHONPATH=src python -m repro_torch.examples.logreg_higgs

Each run is the scalar ``TrainingSimulator`` on live sampling of the paper's
artificial cluster, whose four slowed workers recover at t = 1 s (a timed
``clear_slowdowns``); the subgradients run through kernel K1 and the §6
what-if replay through K7.  :func:`run` is the reference's inner ``run`` at
module level: it returns the history, so a caller can run fewer iterations
or another engine (``engine=EngineConfig(device="cpu",
kernel_backend="torch")`` on the CPU).
"""

from __future__ import annotations

import functools

import numpy as np

from repro_torch.cluster.simulator import MethodConfig, TrainingSimulator
from repro_torch.core.problems import LogisticRegressionProblem, make_higgs_like
from repro_torch.latency.model import clear_slowdowns, make_paper_artificial_cluster

N, SP, SAMPLES, EVAL_EVERY = 16, 10, 16384, 25
ITERS, ETA, GAP = 1200, 0.25, 1e-4


@functools.lru_cache(maxsize=1)
def problem() -> LogisticRegressionProblem:
    X, y = make_higgs_like(SAMPLES, seed=0)
    return LogisticRegressionProblem(X=X, y=y)  # lambda = 1/n, as the paper


def run(name: str, w: int, iters: int, eta: float, lb: bool = False, *, engine=None):
    prob = problem()
    c_task = prob.compute_cost(1, prob.num_samples // (N * SP))
    cluster = make_paper_artificial_cluster(num_workers=N, load_unit=c_task, seed=1)
    events = [(1.0, lambda c: clear_slowdowns(c, range(N - 4, N)))]
    cfg = MethodConfig(name=name, w=w, eta=eta, subpartitions=SP, load_balance=lb)
    sim = TrainingSimulator(prob, cluster, cfg, eval_every=EVAL_EVERY,
                            timed_events=events, seed=0, engine=engine)
    h = sim.run(iters)
    gap = h.suboptimality[np.isfinite(h.suboptimality)][-1]
    tag = name + ("-lb" if lb else "")
    print(f"  {tag:8s} w={w:3d}: gap {gap:.2e}  sim {h.times[-1]:.2f} s  "
          f"repartitions={len(h.repartition_events)}")
    return h


def main(engine=None) -> dict:
    print(f"Logistic regression, n={problem().num_samples}, N={N} workers:")
    h_sag_n = run("sag", N, ITERS, ETA, engine=engine)
    run("sag", 4, ITERS, ETA, engine=engine)
    h = run("dsag", 4, ITERS, ETA, engine=engine)
    h_lb = run("dsag", 4, ITERS, ETA, lb=True, engine=engine)
    out = {"sag": h_sag_n.time_to_gap(GAP), "dsag": h.time_to_gap(GAP),
           "dsag_lb": h_lb.time_to_gap(GAP)}
    print(f"\ntime to {GAP:.0e} gap: SAG(w=N) {out['sag']:.2f} s, "
          f"DSAG {out['dsag']:.2f} s, DSAG-LB {out['dsag_lb']:.2f} s")
    return out


if __name__ == "__main__":
    main()
