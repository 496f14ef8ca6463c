"""Elastic-fleet churn in the port, held against the JAX reference and across
the port's three engines, on the CPU.

A ``ChurnSchedule`` on the traces (time-varying slowdown rows and a
per-iteration liveness mask) runs through the scalar ``TrainingSimulator``,
the host engine and the device engine, with and without §6 load balancing;
the §7.2 ``SlowdownRemoval`` events fold into a schedule on a replayed trace.
The sizes are those of ``tests/test_churn.py``: 240 x 29 logistic
regression, 6 workers, 3 scenarios, 30-draw traces, 24 iterations (the §7.2
case: 8 workers, 40 iterations; PCA: 240 x 12, k = 2).  The schedules' times
are fractions of the churn-free run, so every death and rejoin lands
mid-run.

The reference runs in ONE subprocess for this module (``_REF_SCRIPT``),
under the jax-0.9 shim of ``tests/test_torch_parity.py``; it writes its
inputs (the schedules, the what-if draws) and outputs to an ``.npz``.  It
starts with the module's first test, so the port-only tests run meanwhile.
This process never imports ``jax`` or ``repro``.

Tolerances, and why:

* the engines' event streams against the reference's host engine (times,
  fresh counts, per-worker latencies, rejects, evictions, §6 publication
  times), and the scalar simulator's mask, flush and evict streams: exact,
  as they never depend on the iterate;
* suboptimality against the reference: ``rtol=1e-4`` (``+atol=1e-6`` for
  PCA), float32 sums in another order, as in ``tests/test_torch_engines.py``;
* the §6 functions with ``alive`` and ``since`` (window moments, h,
  Algorithm 1, the publication gate, ``lb_update``) and K7's plain version
  with per-scenario waits: exact (``np.array_equal``), as in
  ``tests/test_torch_lb.py``;
* ``run_churn_column`` at a reduced recipe against the reference's: the
  schedule, the medians, the reached fractions and the ordering equal;
* within the port, scalar == host == device bit for bit on every case,
  suboptimality included, and an all-alive schedule bit for bit the run
  without one.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch import convergence_sweep, interop
from repro_torch.cluster.simulator import MethodConfig, TraceLatencySource, TrainingSimulator
from repro_torch.core.gradient_cache import (
    BatchedGradientCache,
    GradientCache,
    active_slot_capacity,
    build_slot_universe,
)
from repro_torch.core.problems import make_genomics_like_matrix, make_higgs_like
from repro_torch.experiments import fused
from repro_torch.experiments.convergence import (
    history_mismatches,
    result_mismatches,
    run_convergence_batch,
)
from repro_torch.experiments.engine import (
    CAP_CUDA_UNAVAILABLE,
    EngineCapabilityError,
    EngineConfig,
)
from repro_torch.experiments.results import run_churn_column
from repro_torch.experiments.sweep import replay_batch
from repro_torch.kernels import cache_events, what_if
from repro_torch.latency.model import (
    ChurnSchedule,
    SlowdownRemoval,
    churn_from_removals,
    make_heterogeneous_cluster,
    make_paper_artificial_cluster,
    paper_artificial_churn,
    sample_fleet,
)
from repro_torch.latency.profiler import MomentBuffer
from repro_torch.lb import jit_optimizer as jlb
from repro_torch.lb.optimizer import LoadBalanceOptimizer, OptimizerInputs

REPO = Path(__file__).resolve().parents[1]
CPU = EngineConfig(device="cpu", kernel_backend="torch")
K = jlb.SIM_ITERATIONS
N_W, N_S, HORIZON, T_ITERS = 6, 3, 30, 24
#: the §7.2 case: workers, iterations, removal time, workers removed
ART_N, ART_T, ART_REMOVE_AT, ART_REMOVED = 8, 40, 0.04, 4
#: the engine cases: (case, traces, problem); every one runs dsag, sag, coded
CASES = (("death_only", "calm", "logreg"), ("join_only", "calm", "logreg"),
         ("death_join_drift", "bursty", "logreg"), ("removal72", "artificial", "logreg"),
         ("pca_death_join", "bursty", "pca"))
METHODS = ("dsag", "sag", "coded")
#: §6 under churn (the tiled cache): (name, method, margin)
LB_CASES = (("lb_dsag", "dsag", 0.02), ("lb_sag", "sag", 0.0))
LADDER = (2, 3, 4, 5, 7, 10, 14, 18, 25, 33, 40)
#: the §6 function cases, as in tests/test_torch_lb.py: (name, S, N, T, w, margin)
FN_CASES = (("small", 3, 6, 12, 4, 0.02), ("wide", 4, 40, 40, 32, 0.0))
#: the reduced churn column
CHURN_COLUMN = dict(num_samples=1024, n_workers=12, subpartitions=2, w=10, n_scenarios=3,
                    num_iterations=30, eval_every=2)
SUBOPT_TOL = {"logreg": (1e-4, 0.0), "pca": (1e-4, 1e-6)}  # (rtol, atol)

_REF_SCRIPT = r"""
import sys
import jax, jax.experimental
jax.experimental.enable_x64 = jax.enable_x64
from jax.experimental import pallas as pl
pl.load = lambda ref, idx: ref[idx]
def _store(ref, idx, val):
    ref[idx] = val
pl.store = _store
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, {repo!r})

import numpy as np
import jax.numpy as jnp
from benchmarks.bench_regression import run_churn_column
from repro.cluster.simulator import MethodConfig, TraceLatencySource, TrainingSimulator
from repro.core.problems import (
    LogisticRegressionProblem, PCAProblem, make_genomics_like_matrix, make_higgs_like,
)
from repro.experiments.convergence import run_convergence_batch
from repro.experiments.engine import EngineConfig
from repro.latency.model import (
    ChurnSchedule, SlowdownRemoval, make_heterogeneous_cluster, make_paper_artificial_cluster,
    sample_fleet,
)
from repro.latency.profiler import MomentBuffer
from repro.lb import jit_optimizer as R

P = {params}
out = {{}}
key = jax.random.PRNGKey(0)
HOST = EngineConfig(kind="host")

def normals(seed, N, K):
    kc, kp = jax.random.split(jax.random.PRNGKey(seed))
    return np.stack([np.asarray(jax.random.normal(k, (N, K), dtype=jnp.float64))
                     for k in (kc, kp)])

def save_run(pre, r):
    for f in ("times", "suboptimality", "fresh_counts", "per_worker_latency", "evictions",
              "rejected_stale"):
        out[pre + f] = np.asarray(getattr(r, f))
    out[pre + "events_n"] = np.array([len(e) for e in r.repartition_events])
    out[pre + "events"] = np.array([t for e in r.repartition_events for t in e], dtype=float)

# -- the engine cases --------------------------------------------------------------
N, S, H, T = P["slice"]
X, y = make_higgs_like(240, seed=0)
problems = {{"logreg": LogisticRegressionProblem(X=X, y=y),
            "pca": PCAProblem(X=make_genomics_like_matrix(240, 12, seed=0), k=2)}}
cluster = make_heterogeneous_cluster(N, seed=3, burst_rate=0.0, comp_range=(1.1e-3, 2.5e-3))
fleets = {{"calm": sample_fleet(cluster, S, H, seed=11),
          "bursty": sample_fleet(cluster, S, H, seed=11, burst_rate=3.0, burst_factor_mean=3.0,
                                 burst_duration_mean=5e-3)}}
def method(m, n_workers, kind):
    eta = 0.25 if kind == "logreg" else 0.9
    w = {{"dsag": n_workers - 2, "sag": n_workers, "coded": 0}}[m]
    return MethodConfig(name=m, w=w, eta=1.0 if m == "coded" else eta, subpartitions=2)

def ticks(kind, fleet):
    # the median end of each iteration of the churn-free dsag run: the
    # schedules' boundaries fall mid-run
    r = run_convergence_batch(problems[kind], fleets[fleet], method("dsag", N, kind), T,
                              eval_every=T, seed=0, engine=HOST)
    return np.median(r.times, axis=0)

sd = fleets["calm"].slowdown
a = np.ones((3, N), bool)
schedules = {{}}
tick = ticks("logreg", "calm")
al = a[:2].copy(); al[1, 4] = False
schedules["death_only"] = ChurnSchedule(times=tick[[6]], slowdown=np.stack([sd, sd]), alive=al)
al = a[:2].copy(); al[0, 2] = False
schedules["join_only"] = ChurnSchedule(times=tick[[8]], slowdown=np.stack([sd, sd]), alive=al)
al = a.copy(); al[1, 1] = False; al[2, 4] = False
drift = np.stack([sd, sd * np.linspace(1.0, 1.5, N), sd])
tick_b = ticks("logreg", "bursty")
schedules["death_join_drift"] = ChurnSchedule(times=tick_b[[5, 12]], slowdown=drift, alive=al)
schedules["pca_death_join"] = ChurnSchedule(times=ticks("pca", "bursty")[[5, 12]],
                                            slowdown=drift, alive=al)
for name, ch in schedules.items():
    for f in ("times", "slowdown", "alive"):
        out[f"sched/{{name}}/{{f}}"] = getattr(ch, f)
an, aT, at, ar = P["art"]
c_task = problems["logreg"].compute_cost(1, max(240 // an, 1))
art_cluster = make_paper_artificial_cluster(num_workers=an, load_unit=c_task, seed=1)
fleets["artificial"] = sample_fleet(art_cluster, S, aT, seed=7)
removal = SlowdownRemoval(time=at, workers=tuple(range(an - ar, an)))

for case, fleet, kind in P["cases"]:
    prob = problems[kind]
    for m in P["methods"]:
        if case == "removal72":
            cfg = method(m, an, kind)
            for s in range(S):
                sim = TrainingSimulator(prob, art_cluster, cfg, eval_every=2, seed=0,
                                        latency_source=TraceLatencySource(fleets[fleet], s),
                                        timed_events=[(at, removal)])
                h = sim.run(aT)
                for f in ("times", "fresh_counts", "per_worker_latency"):
                    out[f"scalar/{{case}}/{{m}}/{{s}}/{{f}}"] = getattr(h, f)
            continue
        cfg = method(m, N, kind)
        tr = fleets[fleet].with_churn(schedules[case])
        r = run_convergence_batch(prob, tr, cfg, T, eval_every=2, seed=0, engine=HOST)
        save_run(f"run/{{case}}/{{m}}/", r)
        h = TrainingSimulator(prob, cluster, cfg, eval_every=2, seed=0,
                              latency_source=TraceLatencySource(tr, 0)).run(T)
        for f in ("mask_stream", "flush_stream", "evict_stream"):
            out[f"streams/{{case}}/{{m}}/{{f}}"] = getattr(h, f)

# -- §6 under churn: the tiled-cache configs, fed these what-if draws --------------
out["normals6"] = normals(0, N, P["K"])
tr = fleets["bursty"].with_churn(schedules["death_join_drift"])
lb = dict(lb_startup_delay=float(tick_b[2]), lb_interval=float(tick_b[4] - tick_b[2]))
out["lb_params"] = np.array([lb["lb_startup_delay"], lb["lb_interval"]])
for name, m, margin in P["lb_cases"]:
    cfg = MethodConfig(name=m, w=4 if m == "dsag" else N, eta=0.25, subpartitions=2,
                       margin=margin, load_balance=True, **lb)
    save_run(f"run/{{name}}/", run_convergence_batch(problems["logreg"], tr, cfg, T,
                                                   eval_every=2, seed=0, engine=HOST))

# -- the §6 functions with alive and since -------------------------------------------
for case, (name, S_, N_, T_, w, margin) in enumerate(P["fn_cases"]):
    rng = np.random.default_rng(7 + case)
    pre = f"fn/{{name}}/"
    e_comm = rng.uniform(1e-4, 1e-3, (S_, N_)); e_comp = rng.uniform(1e-3, 5e-3, (S_, N_))
    e_comp[:, : max(N_ // 5, 1)] *= 4
    v_comm = (rng.uniform(0.05, 0.3, (S_, N_)) * e_comm) ** 2
    v_comp = (rng.uniform(0.05, 0.3, (S_, N_)) * e_comp) ** 2
    n_j = np.where(np.arange(N_) % 3 == 0, 164.0, 163.0)[None].repeat(S_, 0)
    ladder = tuple(P["ladder"])
    p_cur = rng.choice(np.array(ladder[3:7], float), size=(S_, N_))
    p_new = rng.choice(np.array(ladder, float), size=(S_, N_))
    h_min = np.where(np.arange(S_) % 2 == 0, np.nan, 0.05)
    active = np.ones(S_, bool)
    # scenario 0 all alive; the others lose more and more workers, the last
    # past w (then w_eff = #alive)
    alive = np.ones((S_, N_), bool)
    for s in range(1, S_):
        dead = rng.choice(N_, size=min(N_ - 1, (s * (N_ - w + 2)) // (S_ - 1)), replace=False)
        alive[s, dead] = False
    for k, v in dict(e_comm=e_comm, e_comp=e_comp, v_comm=v_comm, v_comp=v_comp, n_j=n_j,
                     p_cur=p_cur, p_new=p_new, h_min=h_min, alive=alive).items():
        out[pre + k] = v
    out[pre + "normals"] = normals(0, N_, P["K"])
    h = jax.jit(lambda *a: R.estimate_h(*a[:7], w=w, margin=margin, key=key, K=P["K"],
                                        alive=a[7]))
    out[pre + "h"] = np.asarray(h(e_comm, v_comm, e_comp, v_comp, n_j, p_cur, p_new, alive))
    alg = jax.jit(lambda *a: R.algorithm1(*a[:8], ladder=ladder, w=w, margin=margin, key=key,
                                          alive=a[8]))
    args = (p_cur, e_comm, v_comm, e_comp, v_comp, n_j, h_min, active)
    for k, v in zip(("idx", "p", "h_min", "last_h"), alg(*args, alive)):
        out[pre + "alg1/" + k] = np.asarray(v)
    upd = R._lb_update_jitted(ladder, w, P["K"], 0.01, 200, 0.10, margin, with_alive=True)
    for k, v in zip(("p_new", "h_min", "last_h", "publish"), upd(*args, key, alive)):
        out[pre + "upd/" + k] = np.asarray(v)
    pub = jax.jit(lambda *a: R.should_publish(*a[:4], 0.10, alive=a[4]))
    out[pre + "publish"] = np.asarray(pub(p_cur, p_new, e_comm, e_comp, alive))
    # the replay alone: K7's plain version against the reference's scan
    comm = rng.gamma(4.0, e_comm[:, :, None] / 4.0, (S_, N_, P["K"]))
    comp = rng.gamma(9.0, e_comp[:, :, None] / 9.0, (S_, N_, P["K"]))
    out[pre + "replay/comm"], out[pre + "replay/comp"] = comm, comp
    masked = np.where(alive[:, :, None], comm, np.inf)
    rep = jax.jit(lambda c, p, al: R._what_if_replay(c, p, w, P["K"], margin, alive=al))
    out[pre + "replay/u"] = np.asarray(rep(masked, comp, alive))
    # window moments with a per-scenario since cutoff, through the MomentBuffer
    buf = MomentBuffer(S_, N_, T_)
    t_rec = np.sort(rng.uniform(0, 0.4, (S_, N_, T_)), axis=-1)
    valid = rng.random((S_, N_, T_)) < 0.8
    rt = rng.uniform(1e-3, 6e-3, (S_, N_, T_)); cp = rt * rng.uniform(0.5, 1.1, (S_, N_, T_))
    s_i, n_i, t_i = np.nonzero(valid)
    buf.record(s_i, n_i, t_i, t_rec[valid], rt[valid], cp[valid])
    now = rng.uniform(0.2, 0.4, S_)
    since = np.where(np.arange(S_) == 0, -np.inf, now - rng.uniform(0.02, 0.2, S_))
    out[pre + "buf/in"] = np.stack([t_rec, rt, cp, valid.astype(float)])
    out[pre + "buf/now"], out[pre + "buf/since"] = now, since
    for k, v in zip(("e_comm", "v_comm", "e_comp", "v_comp", "cnt"),
                    buf.moments(now, window=0.3, since=since)):
        out[pre + "buf/" + k] = np.asarray(v)

# -- the churn column at a reduced recipe (host and scan engines) ---------------------
col = run_churn_column(P["column"])
out["col/death_at"] = col["schedule"]["death_at"]
out["col/revive_at"] = col["schedule"]["revive_at"]
out["col/dead"] = np.array(col["schedule"]["dead_workers"])
out["col/revived"] = np.array(col["schedule"]["revived_workers"])
out["col/bitexact"] = np.array(col["bitexact_scan_vs_host"])
for m, v in col["methods"].items():
    t = v["median_time_to_gap"]
    out[f"col/{{m}}/median"] = np.inf if t is None else t
    out[f"col/{{m}}/reached"] = v["reached_gap_frac"]
for k, v in col["ordering"].items():
    out[f"col/ordering/{{k}}"] = v
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module", autouse=True)
def ref_proc(tmp_path_factory):
    """The reference subprocess, started at the module's first test."""
    params = dict(slice=(N_W, N_S, HORIZON, T_ITERS), art=(ART_N, ART_T, ART_REMOVE_AT,
                  ART_REMOVED), cases=CASES, methods=METHODS, lb_cases=LB_CASES, K=K,
                  ladder=LADDER, fn_cases=FN_CASES, column=CHURN_COLUMN)
    path = tmp_path_factory.mktemp("jax_reference") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", _REF_SCRIPT.format(params=repr(params), repo=str(REPO)),
         str(path)],
        env=env, cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    yield proc, path
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ref(ref_proc):
    """Every reference output of this module."""
    proc, path = ref_proc
    _, err = proc.communicate(timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"reference subprocess failed:\n{err[-4000:]}")
    with np.load(path) as z:
        return dict(z)


# -- the slices -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world():
    """The problems, clusters and churn-free traces of the engine cases."""
    X, y = make_higgs_like(240, seed=0)
    problems = {"logreg": interop.problem_from_arrays("logreg", X, y),
                "pca": interop.problem_from_arrays("pca", make_genomics_like_matrix(240, 12,
                                                                                    seed=0), k=2)}
    cluster = make_heterogeneous_cluster(N_W, seed=3, burst_rate=0.0,
                                         comp_range=(1.1e-3, 2.5e-3))
    fleets = {"calm": sample_fleet(cluster, N_S, HORIZON, seed=11),
              "bursty": sample_fleet(cluster, N_S, HORIZON, seed=11, burst_rate=3.0,
                                     burst_factor_mean=3.0, burst_duration_mean=5e-3)}
    c_task = problems["logreg"].compute_cost(1, max(240 // ART_N, 1))
    art_cluster = make_paper_artificial_cluster(num_workers=ART_N, load_unit=c_task, seed=1)
    fleets["artificial"] = sample_fleet(art_cluster, N_S, ART_T, seed=7)
    return problems, cluster, art_cluster, fleets


def method(m: str, n_workers: int, kind: str = "logreg", **kw) -> MethodConfig:
    eta = 0.25 if kind == "logreg" else 0.9
    w = {"dsag": n_workers - 2, "sag": n_workers, "coded": 0}[m]
    return MethodConfig(name=m, w=w, eta=1.0 if m == "coded" else eta, subpartitions=2, **kw)


def removal() -> SlowdownRemoval:
    return SlowdownRemoval(time=ART_REMOVE_AT, workers=tuple(range(ART_N - ART_REMOVED, ART_N)))


def schedule(ref, case: str) -> ChurnSchedule:
    pre = f"sched/{case}/"
    return ChurnSchedule(times=ref[pre + "times"], slowdown=ref[pre + "slowdown"],
                         alive=ref[pre + "alive"])


def churned(ref, world, case: str, fleet: str):
    fleets = world[3]
    if case == "removal72":
        tr = fleets[fleet]
        return tr.with_churn(churn_from_removals(tr.slowdown, [removal()]))
    return fleets[fleet].with_churn(schedule(ref, case))


def three_engines(problem, cluster, traces, cfg, T, **kw):
    """Host and device results, and the scalar simulator's history of every
    scenario; fails unless all three agree bit for bit."""
    res = {kind: run_convergence_batch(problem, traces, cfg, T, eval_every=2,
                                       engine=dataclasses.replace(CPU, kind=kind), **kw)
           for kind in ("host", "scan")}
    assert result_mismatches(res["host"], res["scan"]) == []
    hists = []
    for s in range(traces.num_scenarios):
        h = TrainingSimulator(problem, cluster, cfg, eval_every=2, engine=CPU,
                              latency_source=TraceLatencySource(traces, s), **kw).run(T)
        assert history_mismatches(h, res["scan"], s) == [], s
        hists.append(h)
    return res, hists


def assert_matches_reference(ref, pre: str, r, kind: str = "logreg"):
    for f in ("times", "fresh_counts", "per_worker_latency", "evictions", "rejected_stale"):
        assert np.array_equal(getattr(r, f), ref[pre + f], equal_nan=True), f
    assert [len(e) for e in r.repartition_events] == ref[pre + "events_n"].tolist()
    assert [t for e in r.repartition_events for t in e] == ref[pre + "events"].tolist()
    ok = np.isfinite(ref[pre + "suboptimality"])
    assert np.array_equal(ok, np.isfinite(r.suboptimality))
    rtol, atol = SUBOPT_TOL[kind]
    np.testing.assert_allclose(r.suboptimality[ok], ref[pre + "suboptimality"][ok], rtol=rtol,
                               atol=atol)


# -- the engines against the reference -----------------------------------------------------


@pytest.mark.parametrize("m", METHODS)
@pytest.mark.parametrize(("case", "fleet", "kind"), CASES, ids=[c[0] for c in CASES])
def test_engines_match_reference_and_each_other(ref, world, case, fleet, kind, m):
    problems, cluster, art_cluster, fleets = world
    tr = churned(ref, world, case, fleet)
    if case == "removal72":
        cfg = method(m, ART_N, kind)
        res, _ = three_engines(problems[kind], art_cluster, tr, cfg, ART_T)
        for s in range(N_S):
            # the reference's scalar simulator folds the same timed event
            sim = TrainingSimulator(problems[kind], art_cluster, cfg, eval_every=2, engine=CPU,
                                    latency_source=TraceLatencySource(fleets[fleet], s),
                                    timed_events=[(ART_REMOVE_AT, removal())])
            h = sim.run(ART_T)
            assert history_mismatches(h, res["scan"], s) == []
            for f in ("times", "fresh_counts", "per_worker_latency"):
                assert np.array_equal(getattr(h, f), ref[f"scalar/{case}/{m}/{s}/{f}"],
                                      equal_nan=True), (s, f)
        return
    cfg = method(m, N_W, kind)
    res, hists = three_engines(problems[kind], cluster, tr, cfg, T_ITERS)
    assert_matches_reference(ref, f"run/{case}/{m}/", res["scan"], kind)
    for f in ("mask_stream", "flush_stream", "evict_stream"):
        assert np.array_equal(getattr(hists[0], f), ref[f"streams/{case}/{m}/{f}"]), f
    # not vacuous: the schedule changed the run (a dead worker's latencies
    # are NaN; under sag the times may stay, the slowest being alive)
    plain = run_convergence_batch(problems[kind], fleets[fleet], cfg, T_ITERS, eval_every=2,
                                  engine=CPU)
    assert not np.array_equal(plain.per_worker_latency, res["scan"].per_worker_latency,
                              equal_nan=True)


def test_churn_bites(ref, world):
    """The cases' deaths fall mid-run: a dead worker is never fresh after
    its death, a cleared cache slot shows in the evict stream, and the
    joiner contributes once it has joined."""
    problems, cluster, _, fleets = world
    tr = churned(ref, world, "death_only", "calm")
    res, hists = three_engines(problems["logreg"], cluster, tr, method("dsag", N_W), T_ITERS)
    died = ref["sched/death_only/times"][0]
    lat = res["scan"].per_worker_latency[:, :, 4]  # [S, T] latency of worker 4's tasks
    assigned = np.concatenate([np.zeros((N_S, 1)), res["scan"].times[:, :-1]], axis=1)
    assert (assigned >= died).any() and np.isnan(lat[assigned >= died]).all()
    assert np.isfinite(lat[assigned < died]).any()
    assert hists[0].evict_stream[:, 4].sum() == 1
    tr = churned(ref, world, "join_only", "calm")
    res, _ = three_engines(problems["logreg"], cluster, tr, method("sag", N_W), T_ITERS)
    assert (res["scan"].fresh_counts[:, 0] <= N_W - 1).all()
    assert (res["scan"].fresh_counts.max(axis=1) == N_W).all()


@pytest.mark.parametrize(("name", "m", "margin"), LB_CASES, ids=[c[0] for c in LB_CASES])
def test_lb_under_churn_matches_reference(ref, world, name, m, margin):
    """§6 under churn (the device engine's tiled cache, also at its
    tightest slot budget), fed the reference's what-if draws."""
    problems, cluster, _, fleets = world
    tr = churned(ref, world, "death_join_drift", "bursty")
    start, every = ref["lb_params"]
    cfg = MethodConfig(name=m, w=4 if m == "dsag" else N_W, eta=0.25, subpartitions=2,
                       margin=margin, load_balance=True, lb_startup_delay=float(start),
                       lb_interval=float(every))
    kw = dict(what_if_normals=ref["normals6"])
    res, _ = three_engines(problems["logreg"], cluster, tr, cfg, T_ITERS, **kw)
    assert_matches_reference(ref, f"run/{name}/", res["scan"])
    assert ref[f"run/{name}/events_n"].sum() > 0
    cap = fused.scan_capability(problems["logreg"], cfg, N_W)
    tight = run_convergence_batch(problems["logreg"], tr, cfg, T_ITERS, eval_every=2,
                                  engine=dataclasses.replace(CPU, kind="scan",
                                                             slot_budget=cap.slots_resident),
                                  **kw)
    assert result_mismatches(tight, res["scan"]) == []


# -- the §6 functions and K7's plain version with alive / since ----------------------------


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


@pytest.mark.parametrize("case", FN_CASES, ids=[c[0] for c in FN_CASES])
def test_lb_functions_with_alive_match_reference(ref, case):
    name, S, N, T, w, margin = case
    pre = f"fn/{name}/"
    g = {k: t64(ref[pre + k]) for k in ("e_comm", "e_comp", "v_comm", "v_comp", "n_j",
                                        "p_cur", "p_new", "h_min")}
    alive = torch.as_tensor(ref[pre + "alive"])
    assert (alive.sum(dim=1) < w).any() and alive[0].all()  # w_eff varies in the batch
    nz = t64(ref[pre + "normals"])
    h = jlb.estimate_h(g["e_comm"], g["v_comm"], g["e_comp"], g["v_comp"], g["n_j"],
                       g["p_cur"], g["p_new"], w=w, margin=margin, normals=nz, alive=alive)
    assert np.array_equal(h.numpy(), ref[pre + "h"])
    args = (g["p_cur"], g["e_comm"], g["v_comm"], g["e_comp"], g["v_comp"], g["n_j"],
            g["h_min"], torch.ones(S, dtype=torch.bool))
    alg = jlb.algorithm1(*args, ladder=LADDER, w=w, margin=margin, normals=nz, alive=alive)
    for k, got in zip(("idx", "p", "h_min", "last_h"), alg):
        assert np.array_equal(got.numpy(), ref[pre + "alg1/" + k], equal_nan=True), k
    upd = jlb.lb_update(*args, ladder=LADDER, w=w, margin=margin, normals=nz, alive=alive)
    for k, got in zip(("p_new", "h_min", "last_h", "publish"), upd):
        assert np.array_equal(got.numpy(), ref[pre + "upd/" + k], equal_nan=True), k
    dead = ~alive
    assert torch.equal(upd[0][dead], g["p_cur"].to(torch.int64)[dead])  # dead keep their p
    pub = jlb.should_publish(g["p_cur"], g["p_new"], g["e_comm"], g["e_comp"], 0.10,
                             alive=alive)
    assert np.array_equal(pub.numpy(), ref[pre + "publish"])
    # the optimizer's numpy entry point gives the same
    opt = LoadBalanceOptimizer(seed=0, ladder=LADDER, what_if_normals=ref[pre + "normals"],
                               device="cpu")
    inp = OptimizerInputs(*(ref[pre + k] for k in ("e_comm", "v_comm", "e_comp", "v_comp",
                                                   "n_j")), w=w, margin=margin)
    out = opt.update_batch(ref[pre + "p_cur"].astype(np.int64), inp, ref[pre + "h_min"],
                           alive=ref[pre + "alive"])
    for k, got in zip(("p_new", "h_min", "last_h", "publish"), out):
        assert np.array_equal(got, ref[pre + "upd/" + k], equal_nan=True), k


@pytest.mark.parametrize("case", FN_CASES, ids=[c[0] for c in FN_CASES])
def test_what_if_replay_with_waits_matches_reference(ref, case):
    """K7's plain version with per-scenario waits ``w_eff = min(w, #alive)``
    and dead workers' draws at +inf, against the reference's scan."""
    name, S, N, T, w, margin = case
    pre = f"fn/{name}/"
    alive = torch.as_tensor(ref[pre + "alive"])
    comm = torch.where(alive[:, :, None], t64(ref[pre + "replay/comm"]), torch.inf)
    total = t64(ref[pre + "replay/comp"]) + comm
    w_eff = torch.clamp_max(alive.sum(dim=1), w)
    u = what_if.what_if_replay(total, w_eff, margin)
    assert np.array_equal(u.numpy(), ref[pre + "replay/u"])
    assert torch.isfinite(u).all() and (u[~alive] == 0).all()
    # all alive: the per-scenario path equals the scalar w's
    full = t64(ref[pre + "replay/comp"]) + t64(ref[pre + "replay/comm"])
    assert torch.equal(what_if.what_if_replay(full, torch.full((S,), w), margin),
                       what_if.what_if_replay(full, w, margin))


@pytest.mark.parametrize("case", FN_CASES, ids=[c[0] for c in FN_CASES])
def test_moment_buffer_since_matches_reference(ref, case):
    name, S, N, T = case[:4]
    pre = f"fn/{name}/buf/"
    t_rec, rt, cp, valid = ref[pre + "in"]
    valid = valid.astype(bool)
    buf = MomentBuffer(S, N, T, device="cpu")
    s_i, n_i, t_i = np.nonzero(valid)
    buf.record(s_i, n_i, t_i, t_rec[valid], rt[valid], cp[valid])
    got = buf.moments(ref[pre + "now"], window=0.3, since=ref[pre + "since"])
    for k, v in zip(("e_comm", "v_comm", "e_comp", "v_comp", "cnt"), got):
        assert np.array_equal(v, ref[pre + k]), k
    no_since = buf.moments(ref[pre + "now"], window=0.3)
    assert np.array_equal(no_since[4][0], got[4][0])  # since = -inf cuts nothing
    assert (no_since[4][1:] > got[4][1:]).any()  # a finite since cuts samples


def test_all_alive_mask_takes_the_static_path():
    """An all-True liveness mask gives the bits of no mask at all."""
    rng = np.random.default_rng(3)
    S, N, w = 3, 10, 7
    e_comm, e_comp = rng.uniform(1e-4, 1e-3, (S, N)), rng.uniform(1e-3, 5e-3, (S, N))
    args = [t64(a) for a in (rng.choice([4.0, 5.0, 7.0], (S, N)), e_comm, (0.1 * e_comm) ** 2,
                             e_comp, (0.2 * e_comp) ** 2, np.full((S, N), 40.0),
                             np.full(S, np.nan))] + [torch.ones(S, dtype=torch.bool)]
    nz = torch.randn((2, N, K), dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    kw = dict(ladder=LADDER, w=w, margin=0.02, normals=nz)
    plain = jlb.lb_update(*args, **kw)
    masked = jlb.lb_update(*args, **kw, alive=torch.ones((S, N), dtype=torch.bool))
    for a, b in zip(plain, masked):
        assert torch.equal(a, b)


def test_k7_shape_error_with_waits():
    assert what_if.shape_error(6, torch.tensor([1, 6, 3])) is None
    assert "outside" in what_if.shape_error(6, torch.tensor([0, 4]))
    assert "outside" in what_if.shape_error(6, torch.tensor([4, 7]))


# -- the churn column --------------------------------------------------------------------------


def test_churn_column_matches_reference(ref):
    col = run_churn_column(CHURN_COLUMN, engine=CPU).column
    sch = col["schedule"]
    assert (sch["death_at"], sch["revive_at"]) == (float(ref["col/death_at"]),
                                                   float(ref["col/revive_at"]))
    assert sch["dead_workers"] == ref["col/dead"].tolist()
    assert sch["revived_workers"] == ref["col/revived"].tolist()
    assert col["bitexact_scan_vs_host"] and bool(ref["col/bitexact"])
    for m, v in col["methods"].items():
        t = v["median_time_to_gap"]
        assert (np.inf if t is None else t) == float(ref[f"col/{m}/median"]), m
        assert v["reached_gap_frac"] == float(ref[f"col/{m}/reached"]), m
    for k, v in col["ordering"].items():
        assert v == float(ref[f"col/ordering/{k}"]), k
    assert col["ordering"]["ordering_dsag_sag_coded"] in (0.0, 1.0)


def test_cli_churn_column_reproduces_the_committed_column(capsys):
    """``--churn-column`` on the CPU: the committed ``BENCH_convergence.json``
    ``churn`` column, read only, reproduced exactly."""
    import json

    committed = json.loads((REPO / "BENCH_convergence.json").read_text())["churn"]
    col = convergence_sweep.main(["--churn-column", "--device", "cpu", "--kernel-backend",
                                  "torch"])
    for k in ("schedule", "bitexact_scan_vs_host", "methods", "ordering", "recipe"):
        assert col[k] == committed[k], k
    assert "host == device bit for bit" in capsys.readouterr().out


# -- within the port ------------------------------------------------------------------------------


def test_all_alive_schedule_is_bit_identical_to_no_schedule(world):
    """Churn machinery engaged, nothing changes: every engine gives the bits
    of the run without a schedule (the sort and gather picks the static
    order statistic's element; the row lookups the same slowdowns)."""
    problems, cluster, _, fleets = world
    tr = fleets["bursty"]
    sd = tr.slowdown
    ch = ChurnSchedule(times=np.array([0.02, 0.05]), slowdown=np.stack([sd, sd, sd]),
                       alive=np.ones((3, N_W), bool))
    for m in ("dsag", "sag"):
        cfg = method(m, N_W)
        for kind in ("host", "scan"):
            eng = dataclasses.replace(CPU, kind=kind)
            a = run_convergence_batch(problems["logreg"], tr, cfg, T_ITERS, engine=eng)
            b = run_convergence_batch(problems["logreg"], tr.with_churn(ch), cfg, T_ITERS,
                                      engine=eng)
            assert result_mismatches(a, b) == [], (m, kind)


def test_slowdown_removal_folds_and_opaque_events_are_refused(world):
    problems, _, art_cluster, fleets = world
    cfg = method("dsag", ART_N)
    tr = fleets["artificial"]
    with pytest.raises(ValueError, match="timed_events"):
        TrainingSimulator(problems["logreg"], art_cluster, cfg, engine=CPU,
                          timed_events=[(1.0, lambda c: None)],
                          latency_source=TraceLatencySource(tr, 0))
    with pytest.raises(ValueError, match="already carry"):
        TrainingSimulator(problems["logreg"], art_cluster, cfg, engine=CPU,
                          timed_events=[(ART_REMOVE_AT, removal())],
                          latency_source=TraceLatencySource(
                              tr.with_churn(ChurnSchedule.static(tr.slowdown)), 0))
    src = TraceLatencySource(tr, 0)
    TrainingSimulator(problems["logreg"], art_cluster, cfg, engine=CPU,
                      timed_events=[(ART_REMOVE_AT, removal())], latency_source=src)
    assert src.traces.churn is not None and src.traces.churn.times.tolist() == [ART_REMOVE_AT]


def test_paper_artificial_churn_is_the_folded_schedule():
    churn = paper_artificial_churn(num_workers=ART_N, remove_at=ART_REMOVE_AT,
                                   num_removed=ART_REMOVED)
    assert churn.times.tolist() == [ART_REMOVE_AT]
    assert np.array_equal(churn.slowdown[0], 1.0 + (np.arange(1, ART_N + 1) / ART_N) * 0.4)
    assert (churn.slowdown[1][-ART_REMOVED:] == 1.0).all()
    assert np.array_equal(churn.slowdown[1][:-ART_REMOVED], churn.slowdown[0][:-ART_REMOVED])
    assert churn.alive.all()
    cl = make_paper_artificial_cluster(num_workers=ART_N)
    removal()(cl)
    assert [w.slowdown for w in cl.workers] == churn.slowdown[1].tolist()


def test_schedule_validation_and_row_lookup():
    sd, ok = np.ones((3, 4)), np.ones((3, 4), bool)
    with pytest.raises(ValueError, match="strictly increasing"):
        ChurnSchedule(times=np.array([0.3, 0.2]), slowdown=sd, alive=ok)
    dead = ok.copy()
    dead[1] = False
    with pytest.raises(ValueError, match="at least one worker alive"):
        ChurnSchedule(times=np.array([0.1, 0.2]), slowdown=sd, alive=dead)
    with pytest.raises(ValueError, match="state rows"):
        ChurnSchedule(times=np.array([0.1]), slowdown=sd, alive=ok)
    churn = ChurnSchedule(times=np.array([1.0, 2.0]), slowdown=sd, alive=ok)
    assert churn.row_at(0.0) == 0 and churn.row_at(1.0) == 1  # a boundary opens its row
    assert churn.row_at(np.array([0.5, 2.5])).tolist() == [0, 2]
    assert churn.boundary_before(np.array([0, 1, 2])).tolist() == [-np.inf, 1.0, 2.0]


def test_default_devices_are_the_card():
    """``MomentBuffer`` and ``LoadBalanceOptimizer`` default to the card,
    as ``EngineConfig``; without one they refuse, never run on the CPU."""
    if torch.cuda.is_available():
        assert MomentBuffer(1, 2, 3).device.type == "cuda"
        assert LoadBalanceOptimizer().device.type == "cuda"
        return
    for make in (lambda: MomentBuffer(1, 2, 3), lambda: LoadBalanceOptimizer()):
        with pytest.raises(EngineCapabilityError) as e:
            make()
        assert e.value.capability.code == CAP_CUDA_UNAVAILABLE


# -- properties ------------------------------------------------------------------------------------


@given(seed=st.integers(0, 10_000), n=st.integers(2, 8), cuts=st.integers(1, 3),
       w_frac=st.floats(0.3, 1.0))
@settings(max_examples=10, deadline=None)
def test_all_alive_replay_is_bit_identical_to_static(seed, n, cuts, w_frac):
    cl = make_heterogeneous_cluster(n, seed=seed % 5, burst_rate=0.0)
    traces = sample_fleet(cl, 2, 12, seed=seed)
    times = np.unique(np.sort(np.random.default_rng(seed).uniform(1e-4, 0.05, size=cuts)))
    churn = ChurnSchedule(times=times, slowdown=np.tile(traces.slowdown, (times.size + 1, 1)),
                          alive=np.ones((times.size + 1, n), bool))
    w = max(1, int(round(w_frac * n)))
    a = replay_batch(traces, w, 12, device="cpu")
    b = replay_batch(traces.with_churn(churn), w, 12, device="cpu")
    assert np.array_equal(a.iteration_times, b.iteration_times)
    assert np.array_equal(a.fresh_counts, b.fresh_counts)
    assert np.array_equal(a.participation, b.participation)


@given(seed=st.integers(0, 10_000), n=st.integers(3, 8), data=st.data())
@settings(max_examples=10, deadline=None)
def test_dead_workers_contribute_no_finishes_or_draws(seed, n, data):
    """Once a worker is dead at an assignment it starts nothing and finishes
    nothing."""
    cl = make_heterogeneous_cluster(n, seed=seed % 5, burst_rate=0.0)
    traces = sample_fleet(cl, 2, 16, seed=seed)
    victim = data.draw(st.integers(0, n - 1), label="victim")
    t_die = data.draw(st.floats(1e-3, 0.04), label="t_die")
    alive = np.ones((2, n), bool)
    alive[1, victim] = False
    churn = ChurnSchedule(times=np.array([t_die]), slowdown=np.tile(traces.slowdown, (2, 1)),
                          alive=alive)
    res = replay_batch(traces.with_churn(churn), max(1, n // 2), 16, record_tasks=True,
                       device="cpu")
    dead_iters = res.task_assigned >= t_die
    assert np.isnan(res.task_finish[:, :, victim][dead_iters]).all()
    assert np.isnan(res.task_start[:, :, victim][dead_iters]).all()


@given(seed=st.integers(0, 10_000), n=st.integers(2, 12), data=st.data())
@settings(max_examples=10, deadline=None)
def test_dead_workers_take_no_part_in_the_what_if_replay(seed, n, data):
    rng = np.random.default_rng(seed)
    S = 3
    total = torch.as_tensor(rng.gamma(5.0, 1e-3, (S, n, 20)))
    alive = torch.as_tensor(rng.random((S, n)) < 0.6)
    alive[:, data.draw(st.integers(0, n - 1), label="survivor")] = True
    w = data.draw(st.integers(1, n), label="w")
    w_eff = torch.clamp_max(alive.sum(dim=1), w)
    u = what_if.what_if_replay(torch.where(alive[:, :, None], total, torch.inf), w_eff, 0.02)
    assert (u[~alive] == 0).all() and torch.isfinite(u).all()
    # every iteration collects at least w_eff fresh results of the living fleet
    assert ((u * 20).round().sum(dim=1) >= w_eff * 20).all()


@given(seed=st.integers(0, 10_000), data=st.data())
@settings(max_examples=15, deadline=None)
def test_clear_range_is_exact_and_idempotent(seed, data):
    """Clearing a dead worker's range removes exactly its coverage and its
    part of the sum; clearing again removes nothing; the range then takes a
    fresh insert."""
    rng = np.random.default_rng(seed)
    n_samples, n_workers = 120, 4
    per = n_samples // n_workers
    cache = GradientCache(n_samples, np.zeros(3))
    for i in range(n_workers):
        cache.insert(i * per + 1, (i + 1) * per, 0, rng.normal(size=3))
    victim = data.draw(st.integers(0, n_workers - 1), label="victim")
    lo, hi = victim * per + 1, (victim + 1) * per
    cov = cache.coverage
    assert cache.clear_range(lo, hi) == 1
    cache.check_invariants()
    assert cache.coverage == pytest.approx(cov - per / n_samples)
    assert not any(e.overlaps(lo, hi) for e in cache.entries())
    assert cache.clear_range(lo, hi) == 0
    assert cache.insert(lo, hi, 5, rng.normal(size=3))
    cache.check_invariants()


@given(seed=st.integers(0, 10_000), n_ops=st.integers(5, 40))
@settings(max_examples=10, deadline=None)
def test_batched_cache_stays_disjoint_under_inserts_and_clears(seed, n_ops):
    """Random §5 traffic interleaved with death clears keeps every scenario's
    active set disjoint with consistent coverage and sums, and each worker's
    active entries within the tiled cache's capacity."""
    rng = np.random.default_rng(seed)
    n_samples, n_workers, S = 96, 3, 2
    per = n_samples // n_workers
    ladder = (1, 2, 4)
    base_start = [i * per + 1 for i in range(n_workers)]
    base_stop = [(i + 1) * per for i in range(n_workers)]
    cap = active_slot_capacity(build_slot_universe(base_start, base_stop, ladder))
    cache = BatchedGradientCache(S, n_samples, np.zeros(2))
    for it in range(n_ops):
        s, i = int(rng.integers(S)), int(rng.integers(n_workers))
        if rng.random() < 0.25:
            cache.clear_range(s, base_start[i], base_stop[i])
        else:
            p = int(rng.choice(ladder))
            k = int(rng.integers(1, p + 1))
            cache.insert(s, base_start[i] + (k - 1) * per // p,
                         base_start[i] + k * per // p - 1, it, rng.normal(size=2))
        cache.check_invariants()
        for s2 in range(S):
            for j in range(n_workers):
                active_j = sum(1 for slot, (a, _) in enumerate(cache._intervals)
                               if cache._iters[slot, s2] >= 0
                               and base_start[j] <= a <= base_stop[j])
                assert active_j <= cap[j]


# -- on the card ---------------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize(("S", "N", "w", "margin"), [
    (10, 100, 80, 0.02), (1, 100, 80, 0.0), (4, 50, 40, 0.02), (3, 7, 7, 0.02)])
def test_gpu_what_if_replay_with_mask_equals_plain(S, N, w, margin):
    """K7 with per-scenario waits and dead workers at +inf, against its plain
    version on the card: bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(S * N)
    e = torch.rand(S, N, 1, dtype=torch.float64, device="cuda", generator=g) * 4e-3 + 1e-3
    total = (e * (1.0 + 0.3 * torch.randn(S, N, K, dtype=torch.float64, device="cuda",
                                          generator=g))).abs()
    alive = torch.rand(S, N, device="cuda", generator=g) < 0.75
    alive[:, 0] = True
    total = torch.where(alive[:, :, None], total, torch.inf)
    w_eff = torch.clamp_max(alive.sum(dim=1), w)
    before = what_if.launch_counts["what_if_replay"]
    got = what_if.what_if_replay(total, w_eff, margin)
    assert what_if.launch_counts["what_if_replay"] == before + 1
    assert torch.equal(got, what_if.what_if_replay_plain(total, w_eff, margin))
    assert (got[~alive] == 0).all()


@pytest.mark.gpu
def test_gpu_grid_cache_update_on_a_cleared_state():
    """K3 on a cache whose cleared slots hold tag -1 and stale non-zero
    values (what ``_clear_dead_dense`` leaves): equal to its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(0)
    S, R, E, F = 4, 60, 120, 29
    dev = torch.device("cuda")
    iters = rng.integers(0, 20, size=(S, E))
    iters[:, rng.choice(E, 30, replace=False)] = -1  # cleared, values left stale
    args = (torch.as_tensor(rng.random((S, R)) < 0.8, device=dev),
            torch.as_tensor(rng.integers(0, E, size=(S, R)), device=dev),
            torch.as_tensor(rng.integers(0, 25, size=(S, R)), device=dev),
            torch.as_tensor(rng.normal(size=(S, R, F)), device=dev),
            torch.as_tensor(rng.normal(size=(S, F)), device=dev),
            torch.as_tensor(rng.normal(size=(S, E, F)), device=dev),
            torch.as_tensor(iters, device=dev),
            torch.as_tensor(rng.integers(0, 1000, size=S), device=dev),
            torch.zeros(S, dtype=torch.int64, device=dev),
            torch.as_tensor(rng.integers(1, 30, size=E), device=dev))
    for got, want in zip(cache_events.grid_cache_update(*args),
                         cache_events.grid_cache_update_plain(*args)):
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_gpu_three_engines_under_churn_with_lb(world):
    """On the card the engines call K1, K3 and K7 under churn and §6, and
    still agree bit for bit, and with the CPU run on every event and
    publication time (the schedule is the port's own: the card has no
    reference)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = EngineConfig(device="cuda", kernel_backend="cuda")
    problems, cluster, _, fleets = world
    tr = fleets["bursty"]
    tick = np.median(run_convergence_batch(problems["logreg"], tr, method("dsag", N_W), T_ITERS,
                                           engine=CPU).times, axis=0)
    alive = np.ones((3, N_W), bool)
    alive[1, 1] = False
    alive[2, 4] = False
    tr = tr.with_churn(ChurnSchedule(times=tick[[5, 12]], slowdown=np.tile(tr.slowdown, (3, 1)),
                                     alive=alive))
    cfg = MethodConfig(name="dsag", w=4, eta=0.25, subpartitions=2, load_balance=True,
                       lb_startup_delay=float(tick[2]), lb_interval=float(tick[4] - tick[2]))
    kw = dict(eval_every=2)
    res = {kd: run_convergence_batch(problems["logreg"], tr, cfg, T_ITERS,
                                     engine=dataclasses.replace(card, kind=kd), **kw)
           for kd in ("scan", "host")}
    assert result_mismatches(res["host"], res["scan"]) == []
    h = TrainingSimulator(problems["logreg"], cluster, cfg, eval_every=2, engine=card,
                          latency_source=TraceLatencySource(tr, 0)).run(T_ITERS)
    assert history_mismatches(h, res["scan"], 0) == []
    cpu = run_convergence_batch(problems["logreg"], tr, cfg, T_ITERS, engine=CPU, **kw)
    assert cpu.repartition_events == res["scan"].repartition_events
    assert sum(len(e) for e in cpu.repartition_events) > 0
    assert np.array_equal(cpu.times, res["scan"].times)
