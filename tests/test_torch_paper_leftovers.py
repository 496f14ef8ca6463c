"""The paper path's leftovers in the port, held against the JAX reference on
the CPU: the §6 what-if draws for every key (``lb/threefry.py``), the §3
latency fit, the problem helpers, the ``BENCH_convergence.json`` payload,
the package exports and the two Fig. 8 experiments.

The reference runs in ONE subprocess for this module (``_REF_SCRIPT``,
under the jax-0.9 shim of ``tests/test_torch_parity.py``); this process
never imports ``jax`` or ``repro``.

Tolerances, and why:

* The what-if draws: bit for bit (the numpy threefry, uniform and XLA's
  float64 ``erf_inv`` with its FMAs and libm's ``log``), against the shipped
  ``what_if_normals.npz`` and against ``jax.random.normal``.
* The §6 run at a key the package never shipped (N = 7): times, fresh
  counts, per-worker latencies, evictions, rejections and repartition
  (publication) times exactly equal to the reference's host engine, on the
  port's host and device engines, with the port's own draws;
  suboptimality within ``rtol=1e-4`` (as the sweeps are held).
* ``fit_gamma``, ``WorkerStats`` and ``mean_total``: exact (the same float64
  numpy expressions).
* ``explained_variance``, ``objective_batch``, ``optimum_objective``:
  ``rtol=1e-12`` (float64 matrix products summed in another order).
* ``convergence_payload`` of a small logreg and a small PCA sweep: every
  event-derived field exact (``median_time_to_gap``, ``mean_total_time``,
  ``mean_fresh``, ``w``, ``load_balance``, ``grid``, ``gap`` and the
  ordering); ``mean_final_gap`` within ``rtol=1e-4`` (plus ``atol=1e-6``
  for PCA), as the sweeps are held.
* Fig. 8 (the scalar simulator on live sampling, a timed
  ``clear_slowdowns``): times, fresh counts and repartition times exact;
  suboptimality within ``rtol=1e-4`` (logreg) and ``rtol=1e-4, atol=1e-6``
  (PCA).
"""

from __future__ import annotations

import ast
import importlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.cluster.simulator import MethodConfig
from repro_torch.core.problems import (
    PCAProblem,
    make_genomics_like_matrix,
    make_higgs_like,
)
from repro_torch.examples import logreg_higgs, pca_genomics
from repro_torch.experiments.convergence import (
    default_convergence_methods,
    run_convergence_batch,
    run_convergence_sweep,
)
from repro_torch.experiments.engine import EngineConfig, as_engine_config
from repro_torch.experiments.grid import HEAVY_BURSTS
from repro_torch.experiments.results import convergence_payload, write_bench_convergence
from repro_torch.latency.model import (
    GammaParams,
    WorkerLatencyModel,
    fit_gamma,
    make_heterogeneous_cluster,
    make_paper_artificial_cluster,
    sample_fleet,
)
from repro_torch.latency.profiler import WorkerStats
from repro_torch.lb import threefry
from repro_torch.lb.optimizer import what_if_normals

REPO = Path(__file__).resolve().parents[1]
CPU = EngineConfig(device="cpu", kernel_backend="torch")
NORMALS_FILE = REPO / "src" / "repro_torch" / "lb" / "what_if_normals.npz"
K = 100
#: what-if keys the package never shipped: (seed, N)
DRAW_KEYS = ((1, 100), (0, 40), (3, 16), (0, 7))
#: the §6 slice at a non-shipped key: N workers, S scenarios, T iterations
LB_N, LB_S, LB_T = 7, 2, 30
#: fit_gamma sample sets
FIT_SAMPLES = ((5, 0), (40, 1), (1, 2))
#: the payload sweeps: (problem, samples, cols, workers, scenarios, iterations, gap)
SWEEPS = {
    "logreg": ("logreg", 1024, 0, 12, 3, 30, 0.2),
    "pca": ("pca", 512, 32, 8, 2, 30, 1e-2),
}
#: Fig. 8 at reduced iterations: (experiment, name, w, iterations, eta, lb)
FIG8 = (
    ("logreg", "sag", 16, 60, 0.25, False),
    ("logreg", "dsag", 4, 500, 0.25, True),
    ("pca", "coded", 16, 40, 1.0, False),
    ("pca", "dsag", 4, 450, 0.9, False),
)

_REF_SCRIPT = r"""
import sys, json
import jax, jax.experimental
jax.experimental.enable_x64 = jax.enable_x64
from jax.experimental import pallas as pl
pl.load = lambda ref, idx: ref[idx]
def _store(ref, idx, val):
    ref[idx] = val
pl.store = _store
jax.config.update("jax_enable_x64", True)

import numpy as np
import jax.numpy as jnp
from repro.cluster.simulator import MethodConfig, TrainingSimulator
from repro.core.problems import (
    LogisticRegressionProblem, PCAProblem, make_genomics_like_matrix, make_higgs_like,
)
from repro.experiments.convergence import (
    default_convergence_methods, run_convergence_batch, run_convergence_sweep,
)
from repro.experiments.engine import EngineConfig
from repro.experiments.grid import HEAVY_BURSTS
from repro.experiments.results import convergence_payload
from repro.latency.model import (
    WorkerLatencyModel, GammaParams, clear_slowdowns, fit_gamma,
    make_heterogeneous_cluster, make_paper_artificial_cluster, sample_fleet,
)
from repro.latency.profiler import WorkerStats

P = {params}
out = {{}}

# -- the what-if draws --------------------------------------------------------------
for seed, N in P["draw_keys"]:
    kc, kp = jax.random.split(jax.random.PRNGKey(seed))
    out[f"draws/{{seed}}/{{N}}"] = np.stack([
        np.asarray(jax.random.normal(k, (N, P["K"]), dtype=jnp.float64)) for k in (kc, kp)])

# -- a §6 run at N = 7 (no shipped draws), the reference's host engine -------------------
X, y = make_higgs_like(480, seed=0)
prob = LogisticRegressionProblem(X=X, y=y)
N, S, T = P["lb"]
c_task = prob.compute_cost(1, max(480 // (N * 4), 1))
cluster = make_paper_artificial_cluster(num_workers=N, load_unit=c_task, seed=1)
tr = sample_fleet(cluster, S, T, seed=11)
cfg = MethodConfig(name="dsag", w=3, eta=0.25, subpartitions=4, load_balance=True,
                   lb_startup_delay=0.005, lb_interval=0.01, margin=0.02)
r = run_convergence_batch(prob, tr, cfg, T, eval_every=2, seed=0, engine=EngineConfig(kind="host"))
for f in ("times", "suboptimality", "fresh_counts", "per_worker_latency", "evictions",
          "rejected_stale"):
    out["lb/" + f] = getattr(r, f)
out["lb/events_n"] = np.array([len(e) for e in r.repartition_events])
out["lb/events"] = np.array([t for e in r.repartition_events for t in e])

# -- the §3 latency fit --------------------------------------------------------------------
for n, s in P["fit"]:
    smp = np.random.default_rng(s).gamma(4.0, 0.25, size=n)
    g = fit_gamma(smp)
    out[f"fit/{{n}}/{{s}}"] = np.array([g.shape, g.scale, g.mean, g.var])
ws = WorkerStats(e_comm=0.02, v_comm=1e-5, e_comp=0.3, v_comp=4e-4, mean_load=7.5, num_samples=9)
cg, pg = ws.comm_gamma(), ws.comp_gamma_per_unit()
out["ws"] = np.array([ws.e_total, cg.shape, cg.scale, pg.shape, pg.scale])
ws0 = WorkerStats(e_comm=0.0, v_comm=0.0, e_comp=0.0, v_comp=0.0, mean_load=0.0, num_samples=0)
cg, pg = ws0.comm_gamma(), ws0.comp_gamma_per_unit()
out["ws0"] = np.array([ws0.e_total, cg.shape, cg.scale, pg.shape, pg.scale])
wm = WorkerLatencyModel(comm=GammaParams(4.0, 0.01), comp_per_unit=GammaParams(9.0, 0.002),
                        slowdown=1.7)
out["mean_total"] = np.array([wm.mean_total(c) for c in (0.5, 3.0, 1e4)])

# -- the problem helpers --------------------------------------------------------------------
rng = np.random.default_rng(5)
pca = PCAProblem(X=make_genomics_like_matrix(256, 24, seed=0), k=3)
Vs = np.stack([np.linalg.qr(rng.normal(size=(24, 3)))[0].astype(np.float32) for _ in range(3)])
out["pca/V"] = Vs
out["pca/explained"] = np.array([pca.explained_variance(v) for v in Vs])
Xl, yl = make_higgs_like(300, seed=1)
lr = LogisticRegressionProblem(X=Xl, y=yl)
Vl = rng.normal(size=(4, Xl.shape[1])).astype(np.float32)
out["logreg/V"] = Vl
out["logreg/objective_batch"] = lr.objective_batch(Vl)
out["logreg/objective"] = np.array([lr.objective(v) for v in Vl])
out["logreg/optimum_objective"] = np.array(lr.optimum_objective)

# -- the BENCH_convergence.json payload of two small sweeps ----------------------------------
for key, (kind, n, d, N, S, T, gap) in P["sweeps"].items():
    if kind == "pca":
        pr = PCAProblem(X=make_genomics_like_matrix(n, d, seed=0), k=3)
        eta = 0.9
    else:
        Xs, ys = make_higgs_like(n, seed=0)
        pr = LogisticRegressionProblem(X=Xs, y=ys)
        eta = 0.25
    c_task = pr.compute_cost(1, max(pr.num_samples // (N * 4), 1))
    cl = make_heterogeneous_cluster(N, seed=0, burst_rate=0.0, load_unit=c_task)
    methods = default_convergence_methods(N, w=round(0.8 * N), eta=eta, subpartitions=4)
    o = run_convergence_sweep(pr, cl, methods, n_scenarios=S, num_iterations=T, eval_every=4,
                              regime=HEAVY_BURSTS, seed=0)
    out[f"payload/{{key}}"] = np.array(json.dumps(convergence_payload(o, gap)))

# -- the coded bound at pca_paper_scale through the reference's host engine ---------------
from repro.experiments.convergence import PAPER_SCALE_PCA, make_paper_scale_pca
p = PAPER_SCALE_PCA
pr = make_paper_scale_pca(n_rows=p["n_rows"], seed=0)
N, sp = p["n_workers"], p["subpartitions"]
cl = make_heterogeneous_cluster(N, seed=0, burst_rate=0.0,
                                load_unit=pr.compute_cost(1, max(pr.num_samples // (N * sp), 1)))
coded = default_convergence_methods(N, w=p["w"], eta=p["eta"], subpartitions=sp)["coded"]
o = run_convergence_sweep(pr, cl, {{"coded": coded}}, n_scenarios=p["n_scenarios"],
                          num_iterations=p["num_iterations"], eval_every=p["eval_every"],
                          regime=HEAVY_BURSTS, seed=0, engine=EngineConfig(kind="host"))
out["coded_host/times"] = o.results["coded"].times

# -- Fig. 8 at reduced iterations ----------------------------------------------------------
def fig8_problem(exp):
    if exp == "logreg":
        Xf, yf = make_higgs_like(16384, seed=0)
        return LogisticRegressionProblem(X=Xf, y=yf), 25
    return PCAProblem(X=make_genomics_like_matrix(8192, 128, density=0.0536, seed=0), k=3), 20

probs = {{}}
for i, (exp, name, w, iters, eta, lb) in enumerate(P["fig8"]):
    if exp not in probs:
        probs[exp] = fig8_problem(exp)
    pr, ev = probs[exp]
    Nf, SP = 16, 10
    c_task = pr.compute_cost(1, pr.num_samples // (Nf * SP))
    cl = make_paper_artificial_cluster(num_workers=Nf, load_unit=c_task, seed=1)
    events = [(1.0, lambda c: clear_slowdowns(c, range(Nf - 4, Nf)))]
    mc = MethodConfig(name=name, w=w, eta=eta, subpartitions=SP, load_balance=lb)
    h = TrainingSimulator(pr, cl, mc, eval_every=ev, timed_events=events, seed=0).run(iters)
    for f in ("times", "suboptimality", "fresh_counts"):
        out[f"fig8/{{i}}/{{f}}"] = np.asarray(getattr(h, f))
    out[f"fig8/{{i}}/events"] = np.asarray(h.repartition_events, dtype=np.float64)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every reference output of this module, from one JAX subprocess."""
    params = dict(draw_keys=DRAW_KEYS, K=K, lb=(LB_N, LB_S, LB_T), fit=FIT_SAMPLES,
                  sweeps=SWEEPS, fig8=FIG8)
    path = tmp_path_factory.mktemp("jax_leftovers_reference") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _REF_SCRIPT.format(params=repr(params)), str(path)],
        env=env, capture_output=True, text=True, timeout=900,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"reference subprocess failed:\n{proc.stderr[-4000:]}")
    with np.load(path) as z:
        return dict(z)


# -- the what-if draws ------------------------------------------------------------------


def test_draws_equal_the_shipped_reference_draws():
    with np.load(NORMALS_FILE) as z:
        assert sorted(z.files) == ["seed0_N100_K100", "seed0_N50_K100"]
        for name in z.files:
            N = int(name.split("_N")[1].split("_")[0])
            got = what_if_normals(0, N, K)
            assert got.dtype == torch.float64
            assert np.array_equal(got.numpy(), z[name]), name


@pytest.mark.parametrize(("seed", "N"), DRAW_KEYS)
def test_draws_equal_jax_random_normal(ref, seed, N):
    assert np.array_equal(what_if_normals(seed, N, K).numpy(), ref[f"draws/{seed}/{N}"])


def test_threefry_pieces():
    """Known values of the pieces: the raw key of a 64-bit seed, the split's
    subkeys, the bits, and the uniform's range."""
    assert threefry.PRNGKey(0).tolist() == [0, 0]
    assert threefry.PRNGKey(2**33 + 5).tolist() == [2, 5]
    keys = threefry.split(threefry.PRNGKey(0))
    assert keys.shape == (2, 2) and keys.dtype == np.uint32
    bits = threefry.random_bits(keys[0], (3, 4))
    assert bits.shape == (3, 4) and bits.dtype == np.uint64
    lo = np.nextafter(-1.0, 0.0)
    u = threefry.uniform(keys[0], (1000,), lo, 1.0)
    assert u.min() >= lo and u.max() < 1.0
    # erf_inv's edges and branches: ±1 give ±inf, 0 gives 0, odd symmetry
    x = np.array([-1.0, 0.0, 1.0, 0.3, -0.3, 0.999, -0.999999, 1e-300])
    e = threefry.erf_inv(x)
    assert np.isneginf(e[0]) and e[1] == 0.0 and np.isposinf(e[2])
    assert e[3] == -e[4] and e[7] > 0.0
    np.testing.assert_allclose(e[3], 0.2724627147267543, rtol=1e-15)  # erfinv(0.3)


def test_fma_rounds_once():
    a = np.array([1.0 + 2.0**-30])
    b = np.array([1.0 - 2.0**-30])
    c = np.array([-1.0])
    assert threefry.fma(a, b, c)[0] == -(2.0**-60)  # a·b − 1 exactly
    assert (a * b + c)[0] == 0.0  # two roundings lose it


def test_lb_run_at_a_non_shipped_key_equals_reference(ref):
    """N = 7: the port's host and device engines with the port's own draws
    against the reference's host engine."""
    X, y = make_higgs_like(480, seed=0)
    prob = interop.problem_from_arrays("logreg", X, y)
    c_task = prob.compute_cost(1, max(480 // (LB_N * 4), 1))
    cluster = make_paper_artificial_cluster(num_workers=LB_N, load_unit=c_task, seed=1)
    tr = sample_fleet(cluster, LB_S, LB_T, seed=11)
    cfg = MethodConfig(name="dsag", w=3, eta=0.25, subpartitions=4, load_balance=True,
                       lb_startup_delay=0.005, lb_interval=0.01, margin=0.02)
    for kind in ("host", "scan"):
        r = run_convergence_batch(prob, tr, cfg, LB_T, eval_every=2, seed=0,
                                  engine=EngineConfig(device="cpu", kernel_backend="torch",
                                                      kind=kind))
        for f in ("times", "fresh_counts", "per_worker_latency", "evictions",
                  "rejected_stale"):
            assert np.array_equal(getattr(r, f), ref["lb/" + f], equal_nan=True), (kind, f)
        assert [len(e) for e in r.repartition_events] == ref["lb/events_n"].tolist()
        assert [t for e in r.repartition_events for t in e] == ref["lb/events"].tolist()
        ok = np.isfinite(ref["lb/suboptimality"])
        assert np.array_equal(ok, np.isfinite(r.suboptimality))
        np.testing.assert_allclose(r.suboptimality[ok], ref["lb/suboptimality"][ok], rtol=1e-4)
    assert ref["lb/events_n"].sum() > 0


# -- the §3 latency fit ------------------------------------------------------------------


@pytest.mark.parametrize(("n", "s"), FIT_SAMPLES)
def test_fit_gamma_equals_reference(ref, n, s):
    smp = np.random.default_rng(s).gamma(4.0, 0.25, size=n)
    g = fit_gamma(smp)
    assert np.array_equal([g.shape, g.scale, g.mean, g.var], ref[f"fit/{n}/{s}"])


def test_fit_gamma_refuses_no_samples():
    with pytest.raises(ValueError):
        fit_gamma([])


def test_worker_stats_and_mean_total_equal_reference(ref):
    ws = WorkerStats(e_comm=0.02, v_comm=1e-5, e_comp=0.3, v_comp=4e-4, mean_load=7.5,
                     num_samples=9)
    ws0 = WorkerStats(e_comm=0.0, v_comm=0.0, e_comp=0.0, v_comp=0.0, mean_load=0.0,
                      num_samples=0)
    for w, key in ((ws, "ws"), (ws0, "ws0")):
        cg, pg = w.comm_gamma(), w.comp_gamma_per_unit()
        assert np.array_equal([w.e_total, cg.shape, cg.scale, pg.shape, pg.scale], ref[key])
    wm = WorkerLatencyModel(comm=GammaParams(4.0, 0.01), comp_per_unit=GammaParams(9.0, 0.002),
                            slowdown=1.7)
    assert np.array_equal([wm.mean_total(c) for c in (0.5, 3.0, 1e4)], ref["mean_total"])


# -- the problem helpers -----------------------------------------------------------------


def test_pca_explained_variance(ref):
    pca = PCAProblem(X=make_genomics_like_matrix(256, 24, seed=0), k=3)
    got = [pca.explained_variance(v, engine=CPU) for v in ref["pca/V"]]
    np.testing.assert_allclose(got, ref["pca/explained"], rtol=1e-12)
    # the suboptimality is measured on the same value
    sub = pca.suboptimality_batch(ref["pca/V"], engine=CPU)
    want = (pca.fused_kernels("cpu").optimum_value - np.array(got)) / pca._total_var
    np.testing.assert_array_equal(sub, np.maximum(want, 1e-16))


def test_logreg_objective_and_optimum(ref):
    Xl, yl = make_higgs_like(300, seed=1)
    lr = interop.problem_from_arrays("logreg", Xl, yl)
    V = ref["logreg/V"]
    np.testing.assert_allclose(lr.objective_batch(V, engine=CPU), ref["logreg/objective_batch"],
                               rtol=1e-12)
    np.testing.assert_allclose([lr.objective(v, engine=CPU) for v in V],
                               ref["logreg/objective"], rtol=1e-12)
    np.testing.assert_allclose(lr.optimum_objective, ref["logreg/optimum_objective"],
                               rtol=1e-12)
    sub = lr.suboptimality_batch(V, engine=CPU)
    assert np.array_equal(sub, np.maximum(lr.objective_batch(V, engine=CPU)
                                          - lr.optimum_objective, 1e-16))


# -- the BENCH_convergence.json payload ----------------------------------------------------


def _port_sweep(key):
    kind, n, d, N, S, T, gap = SWEEPS[key]
    if kind == "pca":
        pr = PCAProblem(X=make_genomics_like_matrix(n, d, seed=0), k=3)
        eta = 0.9
    else:
        X, y = make_higgs_like(n, seed=0)
        pr = interop.problem_from_arrays("logreg", X, y)
        eta = 0.25
    c_task = pr.compute_cost(1, max(pr.num_samples // (N * 4), 1))
    cl = make_heterogeneous_cluster(N, seed=0, burst_rate=0.0, load_unit=c_task)
    methods = default_convergence_methods(N, w=round(0.8 * N), eta=eta, subpartitions=4)
    out = run_convergence_sweep(pr, cl, methods, n_scenarios=S, num_iterations=T, eval_every=4,
                                regime=HEAVY_BURSTS, seed=0, engine=CPU)
    return out, gap


def _same(a, b) -> bool:
    """Equal, NaN equal to NaN (a ratio over a DSAG that missed the gap)."""
    return a == b or (isinstance(a, float) and isinstance(b, float) and np.isnan(a)
                      and np.isnan(b))


def assert_payload_equal(mine: dict, theirs: dict, atol: float = 0.0) -> None:
    """Every field but the wall clock exact; mean_final_gap within rtol 1e-4."""
    assert mine["grid"] == theirs["grid"] and mine["gap"] == theirs["gap"]
    assert set(mine["ordering"]) == set(theirs["ordering"])
    for k, v in theirs["ordering"].items():
        assert _same(mine["ordering"][k], v), k
    assert set(mine["methods"]) == set(theirs["methods"])
    for m, v in theirs["methods"].items():
        got = mine["methods"][m]
        assert set(got) == set(v)
        for f in ("median_time_to_gap", "mean_total_time", "mean_fresh", "w", "load_balance"):
            assert got[f] == v[f], (m, f)
        np.testing.assert_allclose(got["mean_final_gap"], v["mean_final_gap"], rtol=1e-4,
                                   atol=atol)


@pytest.mark.parametrize("key", list(SWEEPS))
def test_convergence_payload_equals_reference(ref, tmp_path, key):
    out, gap = _port_sweep(key)
    theirs = json.loads(str(ref[f"payload/{key}"]))
    mine = convergence_payload(out, gap)
    assert set(mine) == set(theirs)
    assert_payload_equal(mine, theirs, atol=1e-6 if key == "pca" else 0.0)
    # the writer: the payload plus the scalar timing, only where it is told
    path = tmp_path / "conv.json"
    written = write_bench_convergence(out, str(path), gap=gap, scalar_seconds=2.0,
                                      scalar_seconds_measured=0.5, extra={"x": 1})
    assert json.loads(path.read_text()) == written
    assert written["speedup_vs_scalar"] == 2.0 / out.engine_seconds and written["x"] == 1
    sub = write_bench_convergence(out, str(path), gap=gap, scalar_seconds=2.0,
                                  scalar_methods=["dsag", "sag"])
    assert "speedup_vs_scalar" not in sub and sub["scalar_methods"] == ["dsag", "sag"]


def test_cli_out_writes_the_payload_layout(tmp_path):
    """``--out``: the reference's payload keys, and ``lb_scan`` nested under
    its name with ``--lb-column``."""
    path = tmp_path / "conv.json"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.convergence_sweep", "--device", "cpu",
         "--kernel-backend", "torch", "--workers", "8", "--scenarios", "2", "--iters", "12",
         "--samples", "512", "--check-scalar", "--out", str(path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    got = json.loads(path.read_text())
    assert {"grid", "gap", "engine_seconds", "methods", "ordering", "scalar_seconds",
            "scalar_seconds_measured", "speedup_vs_scalar"} == set(got)
    assert got["grid"] == {"n_workers": 8, "n_scenarios": 2, "num_iterations": 12,
                           "problem": "LogisticRegressionProblem", "num_samples": 512}
    assert set(got["methods"]) == {"dsag", "sag", "sgd", "coded"}


def test_pca_paper_scale_coded_times_equal_the_reference_host_engine(ref):
    """The coded bound's event times at pca_paper_scale (full size) equal the
    reference's host engine's bit for bit, and their mean final time is the
    value ``chip_smoke.py`` phase 10 (a) holds the payload's field to (the
    committed file carries the reference's fused engine's, an ulp off)."""
    from repro_torch.experiments.convergence import PAPER_SCALE_PCA, make_paper_scale_pca

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    p = PAPER_SCALE_PCA
    pr = make_paper_scale_pca(n_rows=p["n_rows"], seed=0)
    N, sp = p["n_workers"], p["subpartitions"]
    cl = make_heterogeneous_cluster(N, seed=0, burst_rate=0.0, load_unit=pr.compute_cost(
        1, max(pr.num_samples // (N * sp), 1)))
    coded = default_convergence_methods(N, w=p["w"], eta=p["eta"], subpartitions=sp)["coded"]
    o = run_convergence_sweep(pr, cl, {"coded": coded}, n_scenarios=p["n_scenarios"],
                              num_iterations=p["num_iterations"], eval_every=p["eval_every"],
                              regime=HEAVY_BURSTS, seed=0, engine=CPU)
    times = o.results["coded"].times
    assert np.array_equal(times, ref["coded_host/times"])
    want = chip_smoke.REFERENCE_HOST_VALUES["pca_paper_scale", "coded", "mean_total_time"]
    assert float(ref["coded_host/times"][:, -1].mean()) == want
    committed = json.loads((REPO / "BENCH_convergence.json").read_text())
    assert committed["pca_paper_scale"]["methods"]["coded"]["mean_total_time"] != want


# -- the package exports -----------------------------------------------------------------


def _reference_names(pkg: str) -> list[str]:
    """The reference package's ``__all__`` (or, lacking one, the names its
    ``__init__`` imports), read with ``ast``: nothing of it is imported."""
    tree = ast.parse((REPO / "src" / "repro" / pkg / "__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "__all__":
            return [e.value for e in node.value.elts]
    return [a.name for node in tree.body if isinstance(node, ast.ImportFrom)
            for a in node.names]


@pytest.mark.parametrize("pkg", ["core", "latency", "lb", "cluster", "experiments", "optim",
                                 "checkpoint"])
def test_package_exports_cover_the_reference(pkg):
    mod = importlib.import_module(f"repro_torch.{pkg}")
    names = _reference_names(pkg)
    assert set(names) <= set(mod.__all__), set(names) - set(mod.__all__)
    for name in mod.__all__:
        assert getattr(mod, name) is not None
    if pkg == "experiments":
        assert len(names) == 42


def test_importing_the_packages_builds_no_kernel():
    code = ("import repro_torch.core, repro_torch.latency, repro_torch.lb, "
            "repro_torch.cluster, repro_torch.experiments, repro_torch.optim, "
            "repro_torch.checkpoint, sys\n"
            "from repro_torch.kernels import _build\n"
            "assert _build._lib is None and not _build.build_info\n"
            "assert not [m for m in sys.modules\n"
            "            if m == 'jax' or m.startswith(('jax.', 'repro.'))]\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert proc.returncode == 0, proc.stderr


def test_as_engine_config():
    assert as_engine_config(None) == EngineConfig()
    assert as_engine_config(CPU) is CPU
    with pytest.warns(DeprecationWarning):
        assert as_engine_config("host").kind == "host"
    with pytest.raises(TypeError):
        as_engine_config(3)


# -- Fig. 8 --------------------------------------------------------------------------------


@pytest.mark.parametrize("i", range(len(FIG8)), ids=[f"{e}-{n}{'-lb' if lb else ''}"
                                                     for e, n, _, _, _, lb in FIG8])
def test_fig8_run_equals_reference(ref, i):
    exp, name, w, iters, eta, lb = FIG8[i]
    if exp == "logreg":
        h = logreg_higgs.run(name, w, iters, eta, lb, engine=CPU)
    else:
        h = pca_genomics.run(name, w, iters, eta, engine=CPU)
    pre = f"fig8/{i}/"
    assert np.array_equal(np.asarray(h.times), ref[pre + "times"])
    assert np.array_equal(np.asarray(h.fresh_counts), ref[pre + "fresh_counts"])
    assert np.array_equal(np.asarray(h.repartition_events, dtype=np.float64),
                          ref[pre + "events"])
    want = ref[pre + "suboptimality"]
    got = np.asarray(h.suboptimality)
    ok = np.isfinite(want)
    assert np.array_equal(ok, np.isfinite(got))
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-4, atol=1e-6 if exp == "pca" else 0.0)
    if lb:
        assert len(h.repartition_events) > 0
    if iters >= 450:
        assert h.times[-1] > 1.0  # the timed clear_slowdowns fired
