"""§6 load balancing in the port, held against the JAX reference and across
the port's three engines, on the CPU.

The reference runs in ONE subprocess for this module (``_REF_SCRIPT``),
under the same jax-0.9 shim as ``tests/test_torch_parity.py``; it builds
every input from numpy seeds and writes inputs and outputs to an ``.npz``.
It is started when the module's first test runs and read by the tests at
the end of the file, so the port-only tests run meanwhile.  This process
never imports ``jax`` or ``repro``.

Tolerances, and why:

* the §6 functions (``window_moments``, ``MomentBuffer.moments``,
  ``estimate_h``, ``algorithm1``, ``lb_update``, ``should_publish``,
  ``align_batch``), fed the reference's what-if draws: every output exact,
  floats included (``np.array_equal``): the port sums in the order of XLA's
  CPU reduction and rounds the one multiply-add XLA contracts once
  (``lb/jit_optimizer.py``);
* the slot universes and the shipped what-if draws: exact (integers; the
  same float64 draws);
* the port's host engine against the reference's, fed the same draws: the
  event streams (times, fresh counts, per-worker latencies), the
  publication times and the cache telemetry exact; suboptimality within
  ``rtol=1e-4`` (float32 sums in another order, as in
  ``tests/test_torch_engines.py``);
* within the port, the scalar simulator, the host engine and the device
  engine (its tiled cache, at any slot budget it accepts) agree bit for bit
  on everything,
  suboptimality and publication times included.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convergence_sweep, interop
from repro_torch.cluster.simulator import (
    MethodConfig,
    TraceLatencySource,
    TrainingSimulator,
    task_pad_width,
)
from repro_torch.core.gradient_cache import active_slot_capacity, build_slot_universe
from repro_torch.core.problems import make_genomics_like_matrix, make_higgs_like
from repro_torch.experiments import fused
from repro_torch.experiments.convergence import (
    history_mismatches,
    result_mismatches,
    run_convergence_batch,
)
from repro_torch.experiments.engine import (
    CAP_ACTIVE_SET,
    CAP_OK,
    CAP_TILED,
    EngineCapabilityError,
    EngineConfig,
)
from repro_torch.experiments.results import run_lb_scan
from repro_torch.latency.model import (
    ChurnSchedule,
    make_heterogeneous_cluster,
    make_paper_artificial_cluster,
    sample_fleet,
)
from repro_torch.kernels import what_if
from repro_torch.latency.profiler import MomentBuffer
from repro_torch.lb import jit_optimizer as jlb
from repro_torch.lb.optimizer import (
    LoadBalanceOptimizer,
    OptimizerInputs,
    what_if_normals,
)
from repro_torch.lb.partitioner import build_p_ladder, p_start, p_stop

REPO = Path(__file__).resolve().parents[1]
#: the reference's draws for two keys, kept in the package as an oracle
NORMALS_FILE = REPO / "src" / "repro_torch" / "lb" / "what_if_normals.npz"
CPU = EngineConfig(device="cpu", kernel_backend="torch")
K = jlb.SIM_ITERATIONS
LADDER = (2, 3, 4, 5, 7, 10, 14, 18, 25, 33, 40)
#: the function-level cases: (name, S, N, T, w, margin); N = 40 and T = 40
#: take the windowed order of ordered_sum (past 32 elements)
FN_CASES = (("small", 3, 6, 12, 4, 0.02), ("wide", 4, 40, 40, 32, 0.0))
#: the engine slices, as in tests/test_lb_scan.py: 6 workers x 3 scenarios
N_W, N_S, N_T = 6, 3, 30
#: (reference universes) (n, N, p0)
UNIVERSES = ((480, 6, 4), (1000, 7, 10), (97, 5, 3))
#: the port's streams against the reference's host engine
REF_RUNS = ("dsag_margin", "sag_bursty")
#: lengths of the sums held against jnp.sum (the windowed order past 32)
SUM_LENGTHS = (1, 6, 32, 33, 40, 60, 100, 1100)

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

import numpy as np
import jax.numpy as jnp
from repro.cluster.simulator import MethodConfig
from repro.core.gradient_cache import active_slot_capacity, build_slot_universe
from repro.core.problems import (
    LogisticRegressionProblem, make_higgs_like,
)
from repro.experiments.convergence import run_convergence_batch
from repro.experiments.engine import EngineConfig
from repro.latency.model import (
    make_heterogeneous_cluster, make_paper_artificial_cluster, sample_fleet,
)
from repro.latency.profiler import MomentBuffer
from repro.lb import jit_optimizer as R
from repro.lb.partitioner import build_p_ladder, p_start, p_stop

P = {params}
out = {{}}
key = jax.random.PRNGKey(0)

def normals(seed, N, K):
    kc, kp = jax.random.split(jax.random.PRNGKey(seed))
    return np.stack([np.asarray(jax.random.normal(k, (N, K), dtype=jnp.float64))
                     for k in (kc, kp)])

for name in P["npz_keys"]:
    seed, N, K = (int(x[1:]) if x[0] != "s" else int(x[4:]) for x in name.split("_"))
    out["file/" + name] = normals(seed, N, K)

# -- jnp.sum along the last axis (the order ordered_sum reproduces) ----------------
fsum = jax.jit(lambda x: jnp.sum(x, axis=-1))
for L in P["sum_lengths"]:
    rng = np.random.default_rng(L)
    x = rng.normal(size=(3, L)) * 10.0 ** rng.uniform(-3, 3, size=(3, L))
    out[f"sum/{{L}}"] = np.asarray(fsum(x))

# -- the §6 functions on seeded inputs -------------------------------------------
for case, (name, S, N, T, w, margin) in enumerate(P["fn_cases"]):
    rng = np.random.default_rng(7 + case)
    pre = f"fn/{{name}}/"
    e_comm = rng.uniform(1e-4, 1e-3, (S, N)); e_comp = rng.uniform(1e-3, 5e-3, (S, N))
    e_comp[:, : max(N // 5, 1)] *= 4
    v_comm = (rng.uniform(0.05, 0.3, (S, N)) * e_comm) ** 2
    v_comp = (rng.uniform(0.05, 0.3, (S, N)) * e_comp) ** 2
    n_j = np.where(np.arange(N) % 3 == 0, 164.0, 163.0)[None].repeat(S, 0)
    ladder = tuple(P["ladder"])
    p_cur = rng.choice(np.array(ladder[3:7], float), size=(S, N))
    p_new = rng.choice(np.array(ladder, float), size=(S, N))
    h_min = np.where(np.arange(S) % 2 == 0, np.nan, 0.05)
    active = np.arange(S) != 1
    for k, v in dict(e_comm=e_comm, e_comp=e_comp, v_comm=v_comm, v_comp=v_comp, n_j=n_j,
                     p_cur=p_cur, p_new=p_new, h_min=h_min, active=active).items():
        out[pre + k] = v
    out[pre + "normals"] = normals(0, N, P["K"])
    out[pre + "h"] = np.asarray(R._estimate_h_jitted(w, P["K"], margin)(
        e_comm, v_comm, e_comp, v_comp, n_j, p_cur, p_new, key))
    alg = jax.jit(lambda *a: R.algorithm1(*a, ladder=ladder, w=w, margin=margin, key=key))
    for k, v in zip(("idx", "p", "h_min", "last_h"),
                    alg(p_cur, e_comm, v_comm, e_comp, v_comp, n_j, h_min, active)):
        out[pre + "alg1/" + k] = np.asarray(v)
    upd = R._lb_update_jitted(ladder, w, P["K"], 0.01, 200, 0.10, margin)
    for k, v in zip(("p_new", "h_min", "last_h", "publish"),
                    upd(p_cur, e_comm, v_comm, e_comp, v_comp, n_j, h_min, active, key)):
        out[pre + "upd/" + k] = np.asarray(v)
    out[pre + "publish"] = np.asarray(R._should_publish_jitted(0.10)(p_cur, p_new, e_comm, e_comp))
    # window moments on [S, N, T] slot buffers, through the MomentBuffer
    buf = MomentBuffer(S, N, T)
    t_rec = np.sort(rng.uniform(0, 0.4, (S, N, T)), axis=-1)
    valid = rng.random((S, N, T)) < 0.8
    rt = rng.uniform(1e-3, 6e-3, (S, N, T)); cp = rt * rng.uniform(0.5, 1.1, (S, N, T))
    s_i, n_i, t_i = np.nonzero(valid)
    buf.record(s_i, n_i, t_i, t_rec[valid], rt[valid], cp[valid])
    now = rng.uniform(0.2, 0.4, S)
    out[pre + "buf/in"] = np.stack([t_rec, rt, cp, valid.astype(float)])
    out[pre + "buf/now"] = now
    for k, v in zip(("e_comm", "v_comm", "e_comp", "v_comp", "cnt"), buf.moments(now, window=0.15)):
        out[pre + "buf/" + k] = np.asarray(v)
    # Algorithm 2 on random repartitions
    n_a = rng.integers(5, 400, size=(S, N)); p_a = np.minimum(rng.integers(1, 41, size=(S, N)), n_a)
    pn_a = np.minimum(rng.integers(1, 41, size=(S, N)), n_a); k_a = 1 + (rng.random((S, N)) * p_a).astype(np.int64)
    needs = rng.random((S, N)) < 0.8
    out[pre + "align/in"] = np.stack([n_a, p_a, pn_a, k_a, needs.astype(np.int64)])
    for k, v in zip(("k", "k_new"), jax.jit(R.align_batch)(n_a, p_a, pn_a, k_a, needs)):
        out[pre + "align/" + k] = np.asarray(v)

# -- the slot universes ------------------------------------------------------------
for j, (n, N, p0) in enumerate(P["universes"]):
    bs = [p_start(n, N, i + 1) for i in range(N)]; be = [p_stop(n, N, i + 1) for i in range(N)]
    u = build_slot_universe(bs, be, build_p_ladder(p0, max(b - a + 1 for a, b in zip(bs, be))))
    for k in ("starts", "stops", "widths", "slot_table", "owners"):
        out[f"univ/{{j}}/{{k}}"] = getattr(u, k)
    out[f"univ/{{j}}/cap"] = active_slot_capacity(u)

# -- the reference host engine on two §6 slices --------------------------------------
X, y = make_higgs_like(P["n"], seed=0)
prob = LogisticRegressionProblem(X=X, y=y)
Nw, Sw, Tw = P["slice"]
for name in P["ref_runs"]:
    if name == "dsag_margin":
        c_task = prob.compute_cost(1, max(P["n"] // (Nw * 4), 1))
        cluster = make_paper_artificial_cluster(num_workers=Nw, load_unit=c_task, seed=1)
        tr = sample_fleet(cluster, Sw, Tw, seed=11)
        cfg = MethodConfig(name="dsag", w=3, eta=0.25, subpartitions=4, load_balance=True,
                           lb_startup_delay=0.005, lb_interval=0.01, margin=0.02)
    else:
        cluster = make_heterogeneous_cluster(Nw, seed=3, burst_rate=0.0, comp_range=(1.1e-3, 2.5e-3))
        tr = sample_fleet(cluster, 2, 20, burst_rate=3.0, burst_factor_mean=3.0,
                          burst_duration_mean=5e-3, seed=11)
        cfg = MethodConfig(name="sag", w=6, eta=0.25, subpartitions=3, load_balance=True,
                           lb_startup_delay=0.002, lb_interval=0.005)
    T = tr.horizon
    r = run_convergence_batch(prob, tr, cfg, T, eval_every=2, seed=0, engine=EngineConfig(kind="host"))
    pre = f"run/{{name}}/"
    for f in ("times", "suboptimality", "fresh_counts", "per_worker_latency", "evictions",
              "rejected_stale"):
        out[pre + f] = getattr(r, f)
    out[pre + "events_n"] = np.array([len(e) for e in r.repartition_events])
    out[pre + "events"] = np.array([t for e in r.repartition_events for t in e])
out["normals6"] = normals(0, Nw, P["K"])
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module", autouse=True)
def ref_proc(tmp_path_factory):
    """The reference subprocess, started at the module's first test."""
    with np.load(NORMALS_FILE) as z:
        npz_keys = list(z.files)
    params = dict(
        npz_keys=npz_keys, fn_cases=FN_CASES, ladder=LADDER, K=K, universes=UNIVERSES,
        n=480, slice=(N_W, N_S, N_T), ref_runs=REF_RUNS, sum_lengths=SUM_LENGTHS,
    )
    path = tmp_path_factory.mktemp("jax_reference") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", _REF_SCRIPT.format(params=repr(params)), str(path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
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


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


# -- the exact building blocks --------------------------------------------------------


def _sum_input(L: int) -> np.ndarray:
    rng = np.random.default_rng(L)
    return rng.normal(size=(3, L)) * 10.0 ** rng.uniform(-3, 3, size=(3, L))


def test_fma_rounds_once():
    rng = np.random.default_rng(4)
    a, b = rng.normal(size=4000), rng.normal(size=4000) * 0.1
    c = 1.0 - rng.random(4000) * 0.01
    a[:5], b[:5], c[:5] = 1.0 + 2.0**-30, 1.0 - 2.0**-30, -1.0  # cancellation
    exact = [float(Fraction(x) * Fraction(y) + Fraction(z)) for x, y, z in zip(a, b, c)]
    assert jlb.fma(t64(a), t64(b), t64(c)).tolist() == exact
    plain = (t64(a) * t64(b) + t64(c)).tolist()
    assert plain != exact  # the single rounding is not vacuous here


def test_exact_sqrt_is_correctly_rounded():
    x = np.random.default_rng(5).uniform(1e-4, 1e-2, 20000)
    r = jlb.exact_sqrt(t64(x)).numpy()
    assert np.array_equal(r, np.sqrt(x))


def test_what_if_replay_shapes_and_plain_on_cpu(logreg_small):
    assert what_if.shape_error(100, 80) is None
    assert "outside" in what_if.shape_error(6, 7)
    assert "exceed" in what_if.shape_error(what_if.MAX_WORKERS + 1, 3)
    total = torch.rand(2, 5, 9, dtype=torch.float64)
    assert torch.equal(what_if.what_if_replay(total, 3, 0.02),
                       what_if.what_if_replay_plain(total, 3, 0.02))
    # the device engine reports K7's shapes with the other kernels' (refused
    # up front with cuda-shape-unsupported on the card)
    spec = fused._static_spec(logreg_small, lb_config("dsag"), N_W, 10, 1.0, "cuda")
    errors = fused._kernel_shape_errors(spec, logreg_small.fused_kernels("cpu"), 2, N_W)
    assert errors[-1] is None and len(errors) == 2


# -- the what-if draws ---------------------------------------------------------------


def test_what_if_draws_source_and_generator():
    """Every key draws the reference's normals (threefry in numpy): the two
    shipped keys bit for bit; any other key deterministically."""
    with np.load(NORMALS_FILE) as z:
        assert np.array_equal(what_if_normals(0, 100).numpy(), z["seed0_N100_K100"])
        assert np.array_equal(what_if_normals(0, 50).numpy(), z["seed0_N50_K100"])
    a, b = what_if_normals(3, 7), what_if_normals(3, 7)
    assert a.shape == (2, 7, K) and a.dtype == torch.float64 and torch.equal(a, b)
    assert not torch.equal(a, what_if_normals(4, 7))


def test_estimate_h_row_independent_of_batch():
    """A scenario's h depends only on its own row: S = 1 equals S = 5."""
    rng = np.random.default_rng(0)
    S, N = 5, 40
    e_comp = rng.uniform(1e-3, 3e-3, (S, N))
    e_comm = rng.uniform(1e-4, 3e-4, (S, N))
    args = [t64(a) for a in (e_comm, (0.1 * e_comm) ** 2, e_comp, (0.1 * e_comp) ** 2,
                             np.full((S, N), 80.0), np.full((S, N), 4.0),
                             rng.choice([2.0, 4.0, 8.0], size=(S, N)))]
    nz = what_if_normals(0, N)
    full = jlb.estimate_h(*args, w=30, margin=0.02, normals=nz)
    for s in range(S):
        one = jlb.estimate_h(*[a[s:s + 1] for a in args], w=30, margin=0.02, normals=nz)
        assert one.item() == full[s].item()
    opt = LoadBalanceOptimizer(seed=0, ladder=(2, 4, 8), sim_iterations=30, device="cpu")
    inp = OptimizerInputs(*(a.numpy() for a in args[:5]), w=30)
    p = np.full((S, N), 4)
    sub = OptimizerInputs(*(a.numpy()[1:] for a in args[:5]), w=30)
    assert np.array_equal(opt.update_batch(p, inp)[0][1:], opt.update_batch(p[1:], sub)[0])


# -- the port's three engines with §6 on --------------------------------------------


@pytest.fixture(scope="module")
def logreg_small():
    X, y = make_higgs_like(480, seed=0)
    return interop.problem_from_arrays("logreg", X, y)


@pytest.fixture(scope="module")
def pca_small():
    return interop.problem_from_arrays("pca", make_genomics_like_matrix(240, 48, seed=0), k=3)


def artificial_fleet(problem, n_workers=N_W, n_scenarios=N_S, horizon=N_T):
    """Persistent per-worker slowdowns: the §7.2-style showcase for §6."""
    c_task = problem.compute_cost(1, max(problem.num_samples // (n_workers * 4), 1))
    cluster = make_paper_artificial_cluster(num_workers=n_workers, load_unit=c_task, seed=1)
    return cluster, sample_fleet(cluster, n_scenarios, horizon, seed=11)


def bursty_fleet(n_workers=N_W, n_scenarios=2, horizon=20):
    cluster = make_heterogeneous_cluster(n_workers, seed=3, burst_rate=0.0,
                                         comp_range=(1.1e-3, 2.5e-3))
    traces = sample_fleet(cluster, n_scenarios, horizon, burst_rate=3.0,
                          burst_factor_mean=3.0, burst_duration_mean=5e-3, seed=11)
    return cluster, traces


def lb_config(name="dsag", w=3, sp=4, **kw):
    kw.setdefault("lb_startup_delay", 0.005)
    kw.setdefault("lb_interval", 0.01)
    kw.setdefault("eta", 0.25)
    return MethodConfig(name=name, w=w, subpartitions=sp, load_balance=True, **kw)


def assert_results_equal(a, b):
    assert result_mismatches(a, b) == []


#: (case, problem, fleet, config, scalar scenarios checked)
ENGINE_CASES = {
    "dsag_margin": ("logreg", "artificial", lb_config("dsag", margin=0.02)),
    "dsag_no_margin": ("logreg", "artificial", lb_config("dsag", margin=0.0)),
    "sag": ("logreg", "bursty", lb_config("sag", w=6, sp=3, lb_startup_delay=0.002,
                                          lb_interval=0.005)),
    "sgd": ("logreg", "bursty", lb_config("sgd", w=3, sp=3, lb_startup_delay=0.002,
                                          lb_interval=0.005)),
    "repartition_heavy": ("logreg", "bursty", lb_config("dsag", w=2, sp=3,
                                                        lb_startup_delay=0.002,
                                                        lb_interval=0.005)),
    "pca": ("pca", "bursty", lb_config("dsag", w=2, sp=3, eta=0.9, lb_startup_delay=0.002,
                                       lb_interval=0.005)),
}


@pytest.fixture(scope="module")
def engine_runs(logreg_small, pca_small):
    """Each case through the device engine and the host engine."""
    runs = {}
    for case, (kind, fleet, cfg) in ENGINE_CASES.items():
        prob = logreg_small if kind == "logreg" else pca_small
        cluster, tr = artificial_fleet(prob) if fleet == "artificial" else bursty_fleet()
        res = {kd: run_convergence_batch(prob, tr, cfg, tr.horizon, eval_every=2,
                                         engine=dataclasses.replace(CPU, kind=kd))
               for kd in ("scan", "host")}
        runs[case] = (prob, cluster, tr, cfg, res)
    return runs


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_scalar_host_device_bit_exact_with_lb(engine_runs, case):
    prob, cluster, tr, cfg, res = engine_runs[case]
    assert_results_equal(res["host"], res["scan"])
    h = TrainingSimulator(prob, cluster, cfg, eval_every=2, engine=CPU,
                          latency_source=TraceLatencySource(tr, 0)).run(tr.horizon)
    assert history_mismatches(h, res["scan"], 0) == []
    # the balancer really publishes (not a vacuous pin)
    assert sum(len(e) for e in res["scan"].repartition_events) > 0
    if case == "repartition_heavy":
        assert min(len(e) for e in res["host"].repartition_events) >= 5
        assert (res["host"].evictions > 0).any()


def test_task_pad_width_takes_every_rung():
    n, N = 16_384, 100
    assert task_pad_width(MethodConfig("dsag", subpartitions=10), n, N) == 17
    # the lb_scan recipe: ladder (2 ... 40) over 163-164 local rows
    assert task_pad_width(MethodConfig("dsag", subpartitions=10, load_balance=True), n, N) == 82
    # pca_paper_scale's ladder reaches rung 1: the whole 1000-row local range
    assert task_pad_width(MethodConfig("dsag", subpartitions=5, load_balance=True),
                          50_000, 50) == 1000


def test_tiled_cache_at_its_tightest_budget(logreg_small):
    """The device engine's only §6 cache, at the smallest slot budget that
    holds its resident entries (below the dense universe): equal to the host
    engine bit for bit, with repartitions and evictions."""
    cluster, tr = artificial_fleet(logreg_small, horizon=20)
    cfg = lb_config("dsag")
    budget = fused.scan_capability(logreg_small, cfg, N_W).slots_resident
    cap = fused.scan_capability(logreg_small, cfg, N_W, slot_budget=budget)
    assert cap.supported and cap.code == CAP_TILED
    assert cap.slots_resident == budget < cap.slots_total
    over = fused.scan_capability(logreg_small, cfg, N_W, slot_budget=budget - 1)
    assert over.code == CAP_ACTIVE_SET and not over.supported
    tiled = run_convergence_batch(logreg_small, tr, cfg, 20,
                                  engine=dataclasses.replace(CPU, kind="scan", slot_budget=budget))
    host = run_convergence_batch(logreg_small, tr, cfg, 20,
                                 engine=dataclasses.replace(CPU, kind="host"))
    assert_results_equal(host, tiled)
    assert sum(len(e) for e in tiled.repartition_events) > 0 and tiled.evictions.sum() > 0


def test_scan_capability_codes_and_auto_routing(logreg_small, monkeypatch):
    cluster, tr = artificial_fleet(logreg_small, horizon=10)
    cfg = lb_config("dsag")
    assert fused.scan_capability(logreg_small, cfg, N_W).code == CAP_TILED
    assert fused.scan_capability(logreg_small, MethodConfig("dsag"), N_W).code == CAP_OK
    assert fused.scan_capability(logreg_small, lb_config("sgd", w=3, sp=3), N_W).code == CAP_OK
    cap = fused.scan_capability(logreg_small, cfg, N_W, slot_budget=3)
    assert cap.code == CAP_ACTIVE_SET and not cap.supported and cap.slots_resident > 3
    with pytest.raises(EngineCapabilityError) as e:
        run_convergence_batch(logreg_small, tr, cfg, 10,
                              engine=dataclasses.replace(CPU, kind="scan", slot_budget=3))
    assert e.value.capability.code == CAP_ACTIVE_SET and "host" in str(e.value)
    # auto: the device engine when it can hold the cache, else the host engine
    calls = []
    real = fused.run_convergence_scan

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(fused, "run_convergence_scan", spy)
    auto = run_convergence_batch(logreg_small, tr, cfg, 10, engine=CPU)
    assert calls == [1]
    routed = run_convergence_batch(logreg_small, tr, cfg, 10,
                                   engine=dataclasses.replace(CPU, slot_budget=3))
    assert calls == [1]  # the host engine ran
    assert_results_equal(auto, routed)


def test_lb_with_churn_refused(logreg_small):
    """§6 with churn, once refused, runs: an all-alive schedule is bit for
    bit the static run on every engine, and a death mid-run goes through
    Algorithm 1 with the liveness mask, engines equal."""
    cluster, tr = artificial_fleet(logreg_small, horizon=10)
    cfg = lb_config("dsag")
    static = run_convergence_batch(logreg_small, tr, cfg, 10, engine=CPU)
    tch = tr.with_churn(ChurnSchedule.static(tr.slowdown))
    alive = np.ones((2, N_W), bool)
    alive[1, 2] = False
    dead = tr.with_churn(ChurnSchedule(times=np.array([float(static.times[0, 3])]),
                                       slowdown=np.tile(tr.slowdown, (2, 1)), alive=alive))
    for kind in ("auto", "scan", "host"):
        eng = dataclasses.replace(CPU, kind=kind)
        assert_results_equal(run_convergence_batch(logreg_small, tch, cfg, 10, engine=eng),
                             static)
        assert_results_equal(run_convergence_batch(logreg_small, dead, cfg, 10, engine=eng),
                             run_convergence_batch(logreg_small, dead, cfg, 10, engine=CPU))
    h = TrainingSimulator(logreg_small, cluster, cfg, engine=CPU,
                          latency_source=TraceLatencySource(dead, 0)).run(10)
    assert history_mismatches(h, run_convergence_batch(logreg_small, dead, cfg, 10,
                                                       engine=CPU), 0) == []


def test_lb_scan_column_on_a_small_slice(logreg_small):
    cluster, tr = artificial_fleet(logreg_small, horizon=20)
    cfg = MethodConfig("dsag", w=3, eta=0.25, subpartitions=4)
    run = run_lb_scan(logreg_small, tr, dataclasses.replace(cfg, lb_startup_delay=0.005,
                                                            lb_interval=0.01),
                      num_iterations=20, eval_every=2, seed=0, engine=CPU)
    assert run.mismatches() == [] and run.config.load_balance
    col = run.column(0.5, {"dsag": 0.05, "sag": 0.1, "coded": 0.2, "sgd": 0.04})
    assert col["bitexact_scan_vs_host"] and "what_if_draws" not in col
    assert col["repartitions_mean"] > 0
    t_lb = col["ordering"]["median_time_to_gap_dsag_lb"]
    assert col["ordering"]["sag_over_dsag_lb"] == 0.1 / t_lb
    # run_lb_scan sets load_balance itself
    assert run_lb_scan(logreg_small, tr, cfg, num_iterations=20, eval_every=2, seed=0,
                       engine=CPU).column(0.5)["bitexact_scan_vs_host"]


def test_cli_lb_column_on_a_small_sweep():
    """The CLI's lb_scan column on a small sweep: its dsag with the §6
    schedule through both engines, the ratios against the sweep's medians."""
    from repro_torch.experiments.convergence import (
        default_convergence_methods,
        run_convergence_sweep,
    )
    from repro_torch.experiments.grid import HEAVY_BURSTS

    X, y = make_higgs_like(480, seed=0)
    prob = interop.problem_from_arrays("logreg", X, y)
    cluster = make_heterogeneous_cluster(N_W, seed=0, burst_rate=0.0,
                                         load_unit=prob.compute_cost(1, 480 // (N_W * 4)))
    out = run_convergence_sweep(prob, cluster,
                                default_convergence_methods(N_W, w=4, subpartitions=4),
                                n_scenarios=2, num_iterations=12, eval_every=2,
                                regime=HEAVY_BURSTS, engine=CPU)
    col = convergence_sweep.lb_column(out, 0.5, CPU)
    assert col["bitexact_scan_vs_host"] and col["config"]["lb_interval"] == 0.1
    assert {"sag_over_dsag_lb", "coded_over_dsag_lb", "dsag_lb_fastest_to_gap"} <= set(
        col["ordering"])


def test_convergence_cli_load_balance(tmp_path, capsys):
    path = tmp_path / "conv.json"
    convergence_sweep.main([
        "--device", "cpu", "--kernel-backend", "torch", "--load-balance", "--check-scalar",
        "--workers", "6", "--scenarios", "2", "--iters", "12", "--samples", "480",
        "--slot-budget", "40", "--out", str(path)])
    printed = capsys.readouterr().out
    assert "draws" not in printed  # the reference's draws at every key: nothing to say
    assert "bit-exact for 4 methods" in printed and path.exists()
    got = json.loads(path.read_text())
    assert got["methods"]["dsag"]["load_balance"] and not got["methods"]["sag"]["load_balance"]


# -- against the reference ---------------------------------------------------------


@pytest.mark.parametrize("L", SUM_LENGTHS)
def test_ordered_sum_equals_xla_sum(ref, L):
    """The reference's compiled ``jnp.sum`` adds in ordered_sum's order."""
    assert np.array_equal(jlb.ordered_sum(t64(_sum_input(L))).numpy(), ref[f"sum/{L}"])


def test_what_if_normals_file_equals_reference_draws(ref):
    with np.load(NORMALS_FILE) as z:
        assert len(z.files) == 2
        for name in z.files:
            assert np.array_equal(z[name], ref["file/" + name]), name


@pytest.mark.parametrize("case", FN_CASES, ids=[c[0] for c in FN_CASES])
def test_lb_functions_match_reference(ref, case):
    name, S, N, T, w, margin = case
    pre = f"fn/{name}/"
    g = {k: t64(ref[pre + k]) for k in ("e_comm", "e_comp", "v_comm", "v_comp", "n_j",
                                        "p_cur", "p_new", "h_min")}
    active = torch.as_tensor(ref[pre + "active"])
    nz = t64(ref[pre + "normals"])
    h = jlb.estimate_h(g["e_comm"], g["v_comm"], g["e_comp"], g["v_comp"], g["n_j"],
                       g["p_cur"], g["p_new"], w=w, margin=margin, normals=nz)
    assert np.array_equal(h.numpy(), ref[pre + "h"])
    args = (g["p_cur"], g["e_comm"], g["v_comm"], g["e_comp"], g["v_comp"], g["n_j"],
            g["h_min"], active)
    alg = jlb.algorithm1(*args, ladder=LADDER, w=w, margin=margin, normals=nz)
    for k, got in zip(("idx", "p", "h_min", "last_h"), alg):
        assert np.array_equal(got.numpy(), ref[pre + "alg1/" + k], equal_nan=True), k
    upd = jlb.lb_update(*args, ladder=LADDER, w=w, margin=margin, normals=nz)
    for k, got in zip(("p_new", "h_min", "last_h", "publish"), upd):
        assert np.array_equal(got.numpy(), ref[pre + "upd/" + k], equal_nan=True), k
    pub = jlb.should_publish(g["p_cur"], g["p_new"], g["e_comm"], g["e_comp"], 0.10)
    assert np.array_equal(pub.numpy(), ref[pre + "publish"])
    # the LoadBalanceOptimizer wrapper gives the same
    opt = LoadBalanceOptimizer(seed=0, ladder=LADDER, what_if_normals=ref[pre + "normals"],
                               device="cpu")
    inp = OptimizerInputs(*(ref[pre + k] for k in ("e_comm", "v_comm", "e_comp", "v_comp",
                                                   "n_j")), w=w, margin=margin)
    out = opt.update_batch(ref[pre + "p_cur"].astype(np.int64), inp, ref[pre + "h_min"],
                           ref[pre + "active"])
    for k, got in zip(("p_new", "h_min", "last_h", "publish"), out):
        assert np.array_equal(got, ref[pre + "upd/" + k], equal_nan=True), k
    assert np.array_equal(opt.should_publish_batch(ref[pre + "p_cur"], ref[pre + "p_new"], inp),
                          ref[pre + "publish"])
    row = OptimizerInputs(*(ref[pre + k][0] for k in ("e_comm", "v_comm", "e_comp", "v_comp",
                                                      "n_j")), w=w, margin=margin)
    assert opt.estimate_h(row, ref[pre + "p_cur"][0], ref[pre + "p_new"][0]) == ref[pre + "h"][0]
    assert opt.should_publish(ref[pre + "p_cur"][0], ref[pre + "p_new"][0], row) == bool(
        ref[pre + "publish"][0])


@pytest.mark.parametrize("case", FN_CASES, ids=[c[0] for c in FN_CASES])
def test_moment_buffer_matches_reference(ref, case):
    name, S, N, T = case[:4]
    pre = f"fn/{name}/buf/"
    t_rec, rt, cp, valid = ref[pre + "in"]
    valid = valid.astype(bool)
    buf = MomentBuffer(S, N, T, device="cpu")
    s_i, n_i, t_i = np.nonzero(valid)
    buf.record(s_i, n_i, t_i, t_rec[valid], rt[valid], cp[valid])
    for k, got in zip(("e_comm", "v_comm", "e_comp", "v_comp", "cnt"),
                      buf.moments(ref[pre + "now"], window=0.15)):
        assert np.array_equal(got, ref[pre + k]), k
    assert ref[pre + "cnt"].max() > 1 and (ref[pre + "cnt"] < T).any()


@pytest.mark.parametrize("case", FN_CASES, ids=[c[0] for c in FN_CASES])
def test_align_batch_matches_reference(ref, case):
    pre = f"fn/{case[0]}/align/"
    n, p, pn, k, needs = (torch.as_tensor(a) for a in ref[pre + "in"])
    got = jlb.align_batch(n, p, pn, k, needs.bool())
    assert np.array_equal(got[0].numpy(), ref[pre + "k"])
    assert np.array_equal(got[1].numpy(), ref[pre + "k_new"])


@pytest.mark.parametrize("j", range(len(UNIVERSES)))
def test_slot_universe_matches_reference(ref, j):
    n, N, p0 = UNIVERSES[j]
    bs = [p_start(n, N, i + 1) for i in range(N)]
    be = [p_stop(n, N, i + 1) for i in range(N)]
    u = build_slot_universe(bs, be, build_p_ladder(p0, max(b - a + 1 for a, b in zip(bs, be))))
    for k in ("starts", "stops", "widths", "slot_table", "owners"):
        assert np.array_equal(getattr(u, k), ref[f"univ/{j}/{k}"]), k
    assert np.array_equal(active_slot_capacity(u), ref[f"univ/{j}/cap"])


@pytest.mark.parametrize("name", REF_RUNS)
def test_streams_and_repartitions_match_reference(ref, logreg_small, name):
    """The port's host and device engines, fed the reference's what-if draws,
    against the reference's host engine."""
    if name == "dsag_margin":
        cluster, tr = artificial_fleet(logreg_small)
        cfg = lb_config("dsag", margin=0.02)
    else:
        cluster, tr = bursty_fleet()
        cfg = lb_config("sag", w=6, sp=3, lb_startup_delay=0.002, lb_interval=0.005)
    pre = f"run/{name}/"
    for kind in ("host", "scan"):
        r = run_convergence_batch(logreg_small, tr, cfg, tr.horizon, eval_every=2,
                                  engine=dataclasses.replace(CPU, kind=kind),
                                  what_if_normals=ref["normals6"])
        for f in ("times", "fresh_counts", "per_worker_latency", "evictions",
                  "rejected_stale"):
            assert np.array_equal(getattr(r, f), ref[pre + f], equal_nan=True), (kind, f)
        assert [len(e) for e in r.repartition_events] == ref[pre + "events_n"].tolist()
        assert [t for e in r.repartition_events for t in e] == ref[pre + "events"].tolist()
        ok = np.isfinite(ref[pre + "suboptimality"])
        assert np.array_equal(ok, np.isfinite(r.suboptimality))
        np.testing.assert_allclose(r.suboptimality[ok], ref[pre + "suboptimality"][ok],
                                   rtol=1e-4)
    assert ref[pre + "events_n"].sum() > 0


@pytest.mark.gpu
@pytest.mark.parametrize(("S", "N", "w", "margin"), [
    (10, 100, 80, 0.02), (1, 100, 80, 0.0), (4, 50, 40, 0.02), (3, 37, 37, 0.02),
    (2, 1, 1, 0.0), (2, 1024, 900, 0.02)])
def test_gpu_what_if_replay_equals_plain(S, N, w, margin):
    """K7 against its plain version on the card: bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    e = torch.rand(S, N, 1, dtype=torch.float64, device="cuda") * 4e-3 + 1e-3
    total = (e * (1.0 + 0.3 * torch.randn(S, N, K, dtype=torch.float64, device="cuda"))).abs()
    before = dict(what_if.launch_counts)
    got = what_if.what_if_replay(total, w, margin)
    assert what_if.launch_counts["what_if_replay"] == before["what_if_replay"] + 1
    assert torch.equal(got, what_if.what_if_replay_plain(total, w, margin))


@pytest.mark.gpu
def test_gpu_scalar_host_device_bit_exact_with_lb(logreg_small):
    """On the card the three engines call K1 and run the §6 arithmetic there,
    and still agree bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = EngineConfig(device="cuda", kernel_backend="cuda")
    cluster, tr = artificial_fleet(logreg_small)
    cfg = lb_config("dsag", margin=0.02)
    res = {kd: run_convergence_batch(logreg_small, tr, cfg, N_T, eval_every=2,
                                     engine=dataclasses.replace(card, kind=kd))
           for kd in ("scan", "host")}
    assert_results_equal(res["host"], res["scan"])
    h = TrainingSimulator(logreg_small, cluster, cfg, eval_every=2, engine=card,
                          latency_source=TraceLatencySource(tr, 0)).run(N_T)
    assert history_mismatches(h, res["scan"], 0) == []
    cpu = run_convergence_batch(logreg_small, tr, cfg, N_T, eval_every=2, engine=CPU)
    # the §6 decisions do not depend on the device
    assert cpu.repartition_events == res["scan"].repartition_events
