"""Scenario sharding of the port's device engine, held against the unsharded
run and against the JAX reference's sharded run, on the CPU.

``EngineConfig(mesh=ScenarioMesh((cpu,) * D))`` splits the scenario axis of
the device engine into D shards, each run in a thread of its own: the port's
counterpart of the reference's ``shard_map`` over
``--xla_force_host_platform_device_count`` host devices.  The sizes are
those of the reference's own pins: ``tests/test_sharded.py`` (480 x 29
logistic regression, 6 workers of the paper's artificial cluster, 40-draw
traces, dsag w = 3, p = 4, 40 iterations) and ``tests/test_churn.py`` (240
x 29, 6 heterogeneous workers, 30-draw traces, 24 iterations); against the
reference, the parity tests' slice (``tests/test_torch_parity.py``: 1024
rows, 8 workers, 3 scenarios, 16 iterations, PCA at 16 columns, k = 3).

The reference runs in ONE subprocess for this module (``_REF_SCRIPT``),
under the jax-0.9 shim of ``tests/test_torch_parity.py`` and with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` set before JAX is
imported; it starts with the module's first test, so the port-only tests
run meanwhile.  This process never imports ``jax`` or ``repro``.

Tolerances, and why:

* port sharded against port unsharded: every field bit for bit (times,
  fresh counts, per-worker latencies, rejects, evictions and §6 publication
  times exactly; suboptimality with NaN equal to NaN): each scenario's
  arithmetic depends on its own row alone;
* port sharded against the reference's 4-device run: event streams exactly
  (they never depend on the iterate), suboptimality within ``SUBOPT_TOL``
  (``rtol=1e-4``, + ``atol=1e-6`` for PCA: float32 sums in another order,
  as in ``tests/test_torch_parity.py``);
* the ``pca_grid_sharded`` column at a reduced size against the
  reference's runner at the same size: the time-to-gap ranking, the reached
  fractions and the ordering verdicts equal (the medians are event times at
  a suboptimality crossing, which that tolerance may move);
* the coded bound's event times at the committed column's 40 scenarios
  against the reference's host engine: exactly (the committed column's
  coded ``mean_total_time`` is its fused engine's, an ulp off; ROADMAP §3).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.experiments as rt_experiments
import repro_torch.launch as rt_launch
from repro_torch import convergence_sweep, interop
from repro_torch.cluster.simulator import MethodConfig
from repro_torch.core.problems import make_higgs_like
from repro_torch.experiments import fused
from repro_torch.experiments.convergence import result_mismatches, run_convergence_batch
from repro_torch.experiments.engine import (
    CAP_CUDA_UNAVAILABLE,
    EngineCapabilityError,
    EngineConfig,
)
from repro_torch.experiments.results import run_pca_grid_sharded_column, write_json
from repro_torch.kernels import _build
from repro_torch.latency.model import (
    ChurnSchedule,
    make_heterogeneous_cluster,
    make_paper_artificial_cluster,
    sample_fleet,
)
from repro_torch.launch.mesh import ScenarioMesh, make_scenario_mesh

REPO = Path(__file__).resolve().parents[1]
CPU = EngineConfig(device="cpu", kernel_backend="torch", kind="scan")
CPU_DEV = torch.device("cpu")
#: the parity slice (tests/test_torch_parity.py) through the reference's 4 devices
N_ROWS, N_WORKERS, N_SCEN, N_ITERS, SUBPARTS, W = 1024, 8, 3, 16, 4, 6
PCA_COLS, PCA_K = 16, 3
REF_KINDS = ("logreg", "pca")
REF_METHODS = ("dsag", "sag", "coded")
SUBOPT_TOL = {"logreg": (1e-4, 0.0), "pca": (1e-4, 1e-6)}  # (rtol, atol)
#: the reduced pca_grid_sharded column: scale (rows and iterations) and scenarios
COL_SCALE, COL_SCEN = 0.5, 4
#: the committed column's scenarios
COL_FULL_SCEN = 40


def cpu_mesh(D: int) -> ScenarioMesh:
    return ScenarioMesh((CPU_DEV,) * D)


def _method(kind: str, m: str) -> dict:
    eta = 0.25 if kind == "logreg" else 0.9
    return {"dsag": dict(name="dsag", w=W, eta=eta, subpartitions=SUBPARTS),
            "sag": dict(name="sag", w=N_WORKERS, eta=eta, subpartitions=SUBPARTS),
            "coded": dict(name="coded", eta=1.0, subpartitions=SUBPARTS)}[m]


_REF_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.experimental
jax.experimental.enable_x64 = jax.enable_x64
from jax.experimental import pallas as pl
pl.load = lambda ref, idx: ref[idx]
def _store(ref, idx, val):
    ref[idx] = val
pl.store = _store
P = json.loads(sys.argv[2])
sys.path.insert(0, P["repo"])
assert len(jax.devices()) >= 4, jax.devices()

import numpy as np
import repro.experiments as rx
from repro.cluster.simulator import MethodConfig
from repro.core.problems import (
    LogisticRegressionProblem, PCAProblem, make_genomics_like_matrix, make_higgs_like,
)
from repro.experiments.convergence import run_convergence_batch
from repro.experiments.engine import EngineConfig
from repro.experiments.grid import HEAVY_BURSTS
from repro.latency.model import make_heterogeneous_cluster, sample_fleet

out = {}
for kind in P["kinds"]:
    if kind == "logreg":
        X, y = make_higgs_like(P["n"], seed=0)
        prob = LogisticRegressionProblem(X=X, y=y)
        out["logreg/y"] = y
    else:
        X = make_genomics_like_matrix(P["n"], P["cols"], seed=0)
        prob = PCAProblem(X=X, k=P["k"])
    out[kind + "/X"] = X
    N, sp = P["N"], P["sp"]
    c_task = prob.compute_cost(1, max(P["n"] // (N * sp), 1))
    cluster = make_heterogeneous_cluster(N, seed=0, burst_rate=0.0, load_unit=c_task)
    tr = sample_fleet(cluster, P["S"], P["T"], burst_rate=HEAVY_BURSTS.rate,
                      burst_factor_mean=HEAVY_BURSTS.factor_mean,
                      burst_duration_mean=HEAVY_BURSTS.duration_mean, seed=1)
    for f in ("comm", "comp_unit", "slowdown", "burst_start", "burst_end", "burst_factor"):
        out[kind + "/" + f] = getattr(tr, f)
    for m, cfg in P["methods"][kind].items():
        r = run_convergence_batch(prob, tr, MethodConfig(**cfg), P["T"], eval_every=1,
                                  engine=EngineConfig(kind="scan", num_devices=4))
        pre = kind + "/" + m + "/"
        for f in ("times", "suboptimality", "fresh_counts", "per_worker_latency",
                  "rejected_stale", "evictions"):
            out[pre + f] = np.asarray(getattr(r, f))

# the pca_grid_sharded runner at a reduced size: its sweep at scale < 1
sweep = rx.paper_scale_pca_sweep
rx.paper_scale_pca_sweep = lambda **kw: sweep(scale=P["col_scale"], **kw)
from benchmarks.bench_regression import run_pca_grid_sharded_column
col = run_pca_grid_sharded_column(n_scenarios=P["col_S"], num_devices=4)
out["col"] = np.array(json.dumps({k: col[k] for k in ("num_devices", "ordering",
                                                      "bitexact_sharded_vs_unsharded")}))

# the coded bound of pca_grid_sharded (40 scenarios, full size) through the
# reference's host engine: the committed column has its fused engine's times
from repro.experiments.convergence import (
    PAPER_SCALE_PCA, default_convergence_methods, make_paper_scale_pca, run_convergence_sweep,
)
p = PAPER_SCALE_PCA
pr = make_paper_scale_pca(n_rows=p["n_rows"], seed=0)
N, sp = p["n_workers"], p["subpartitions"]
cl = make_heterogeneous_cluster(N, seed=0, burst_rate=0.0,
                                load_unit=pr.compute_cost(1, max(pr.num_samples // (N * sp), 1)))
coded = default_convergence_methods(N, w=p["w"], eta=p["eta"], subpartitions=sp)["coded"]
o = run_convergence_sweep(pr, cl, {"coded": coded}, n_scenarios=P["coded_S"],
                          num_iterations=p["num_iterations"], eval_every=p["eval_every"],
                          regime=HEAVY_BURSTS, seed=0, engine=EngineConfig(kind="host"))
out["coded_host/times"] = o.results["coded"].times
# ... and its dsag through the fused engine, whose crossings the column holds
dsag = default_convergence_methods(N, w=p["w"], eta=p["eta"], subpartitions=sp)["dsag"]
o = run_convergence_sweep(pr, cl, {"dsag": dsag}, n_scenarios=P["coded_S"],
                          num_iterations=p["num_iterations"], eval_every=p["eval_every"],
                          regime=HEAVY_BURSTS, seed=0, engine=EngineConfig(kind="scan"))
out["dsag_fused/suboptimality"] = o.results["dsag"].suboptimality
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module", autouse=True)
def ref_proc(tmp_path_factory):
    """The reference subprocess, started at the module's first test."""
    params = dict(repo=str(REPO), kinds=REF_KINDS, n=N_ROWS, N=N_WORKERS, S=N_SCEN,
                  T=N_ITERS, sp=SUBPARTS, cols=PCA_COLS, k=PCA_K,
                  methods={kind: {m: _method(kind, m) for m in REF_METHODS}
                           for kind in REF_KINDS},
                  col_scale=COL_SCALE, col_S=COL_SCEN, coded_S=COL_FULL_SCEN)
    path = tmp_path_factory.mktemp("jax_reference") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen(
        [sys.executable, "-c", _REF_SCRIPT, str(path), json.dumps(params)],
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


# -- the cases of the reference's pins ---------------------------------------------------


@pytest.fixture(scope="module")
def logreg_480():
    X, y = make_higgs_like(480, seed=0)
    return interop.problem_from_arrays("logreg", X, y)


@pytest.fixture(scope="module")
def logreg_240():
    X, y = make_higgs_like(240, seed=0)
    return interop.problem_from_arrays("logreg", X, y)


def sharded_fleet(problem, n_scenarios: int):
    """tests/test_sharded.py's fleet: 6 workers of the paper's artificial
    cluster, 40 draws each."""
    c_task = problem.compute_cost(1, max(problem.num_samples // 24, 1))
    cluster = make_paper_artificial_cluster(num_workers=6, load_unit=c_task, seed=1)
    return sample_fleet(cluster, n_scenarios, 40, seed=11)


def churn_fleet(n_scenarios: int):
    """tests/test_churn.py's bursty fleet under its death_join_drift_churn:
    worker 1 dies at 0.02 s and rejoins at 0.06 s while worker 4 dies, and
    the slowdowns drift between the two."""
    cluster = make_heterogeneous_cluster(6, seed=3, burst_rate=0.0, comp_range=(1.1e-3, 2.5e-3))
    tr = sample_fleet(cluster, n_scenarios, 30, seed=11, burst_rate=3.0,
                      burst_factor_mean=3.0, burst_duration_mean=5e-3)
    sd0 = np.asarray(tr.slowdown)
    alive = np.ones((3, 6), bool)
    alive[1, 1] = False
    alive[2, 4] = False
    return tr.with_churn(ChurnSchedule(times=np.array([0.02, 0.06]),
                                       slowdown=np.stack([sd0, sd0 * np.linspace(1.0, 1.5, 6),
                                                          sd0]),
                                       alive=alive))


LB = dict(load_balance=True, lb_startup_delay=0.005, lb_interval=0.01)
#: (id, fleet, scenarios, shards, §6): tests/test_sharded.py:83-145 and
#: tests/test_churn.py:268-304
CASES = (
    ("one_shard", "sharded", 3, 1, False),
    ("two_shards_remainder", "sharded", 3, 2, False),
    ("four_shards_even", "sharded", 4, 4, False),
    ("four_shards_lb_tiled_remainder", "sharded", 5, 4, True),
    ("churn_one_shard", "churn", 3, 1, False),
    ("churn_four_shards_lb_remainder", "churn", 5, 4, True),
)


@pytest.mark.parametrize(("fleet", "S", "D", "lb"), [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_sharded_run_equals_unsharded(logreg_480, logreg_240, fleet, S, D, lb):
    if fleet == "sharded":
        problem, traces, T = logreg_480, sharded_fleet(logreg_480, S), 40
        cfg = MethodConfig(name="dsag", w=3, eta=0.25, subpartitions=4, **(LB if lb else {}))
    else:
        problem, traces, T = logreg_240, churn_fleet(S), 24
        cfg = MethodConfig(name="dsag", w=4, eta=0.25, subpartitions=2, **(LB if lb else {}))
    plain = run_convergence_batch(problem, traces, cfg, T, seed=0, engine=CPU)
    sharded = run_convergence_batch(problem, traces, cfg, T, seed=0,
                                    engine=dataclasses.replace(CPU, mesh=cpu_mesh(D)))
    assert result_mismatches(plain, sharded) == []
    assert sharded.times.shape == (S, T)
    if lb:  # vacuity guard: the balancer publishes and the tiled cache evicts
        assert any(len(ev) > 0 for ev in plain.repartition_events)
        assert plain.evictions.sum() > 0


def test_shards_run_in_threads_of_their_own(logreg_480, monkeypatch):
    """One thread per shard, each on its own rows of the padded batch; the
    shards of one device take turns."""
    seen, running, most = [], [0], [0]
    run = fused.ScanShard.run
    lock = threading.Lock()

    def spy(self, spec, eval_mask):
        with lock:
            running[0] += 1
            most[0] = max(most[0], running[0])
        seen.append((threading.get_ident(), self.V0.shape[0]))
        time.sleep(0.05)
        try:
            return run(self, spec, eval_mask)
        finally:
            with lock:
                running[0] -= 1

    monkeypatch.setattr(fused.ScanShard, "run", spy)
    cfg = MethodConfig(name="dsag", w=3, eta=0.25, subpartitions=4)
    run_convergence_batch(logreg_480, sharded_fleet(logreg_480, 5), cfg, 10, seed=0,
                          engine=dataclasses.replace(CPU, mesh=cpu_mesh(4)))
    assert len({t for t, _ in seen}) == 4
    assert threading.get_ident() not in {t for t, _ in seen}
    assert sorted(rows for _, rows in seen) == [2, 2, 2, 2]  # 5 scenarios, edge-padded to 8
    assert most[0] == 1


def test_a_failing_shard_fails_the_run(logreg_480, monkeypatch):
    """A shard's exception reaches the caller, whatever the other shards did."""
    run = fused.ScanShard.run
    calls = []

    def flaky(self, spec, eval_mask):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("shard down")
        return run(self, spec, eval_mask)

    monkeypatch.setattr(fused.ScanShard, "run", flaky)
    cfg = MethodConfig(name="dsag", w=3, eta=0.25, subpartitions=4)
    with pytest.raises(RuntimeError, match="shard down"):
        run_convergence_batch(logreg_480, sharded_fleet(logreg_480, 4), cfg, 10, seed=0,
                              engine=dataclasses.replace(CPU, mesh=cpu_mesh(4)))
    assert len(calls) == 4


def test_host_engine_ignores_the_mesh(logreg_480):
    cfg = MethodConfig(name="dsag", w=3, eta=0.25, subpartitions=4)
    traces = sharded_fleet(logreg_480, 3)
    host = dataclasses.replace(CPU, kind="host")
    a = run_convergence_batch(logreg_480, traces, cfg, 20, seed=0, engine=host)
    b = run_convergence_batch(logreg_480, traces, cfg, 20, seed=0,
                              engine=dataclasses.replace(host, mesh=cpu_mesh(2)))
    assert result_mismatches(a, b) == []


# -- refusals, before any launch ---------------------------------------------------------


@pytest.fixture
def no_launch(monkeypatch):
    """Fail the test if the device engine's body runs."""

    def refuse(*_a, **_k):
        raise AssertionError("the device engine ran")

    monkeypatch.setattr(fused, "_run_scan", refuse)


def test_config_refusals():
    with pytest.raises(ValueError, match="num_devices must be >= 1"):
        EngineConfig(num_devices=0)
    with pytest.raises(ValueError, match="num_devices counts CUDA cards"):
        EngineConfig(device="cpu", kernel_backend="torch", num_devices=2)
    with pytest.raises(ValueError, match="one type"):
        ScenarioMesh((CPU_DEV, torch.device("cuda", 0)))
    with pytest.raises(ValueError, match="must be of one type"):
        EngineConfig(device="cpu", kernel_backend="torch",
                     mesh=ScenarioMesh((torch.device("cuda", 0),)))
    with pytest.raises(ValueError, match="name each card"):
        ScenarioMesh(("cuda",))
    with pytest.raises(ValueError, match="at least one device"):
        ScenarioMesh(())
    with pytest.raises(TypeError, match="ScenarioMesh"):
        EngineConfig(device="cpu", kernel_backend="torch", mesh=(CPU_DEV,))
    # an explicit mesh takes precedence over num_devices
    eng = EngineConfig(device="cpu", kernel_backend="torch", num_devices=8, mesh=cpu_mesh(2))
    assert fused.scenario_mesh(eng) == cpu_mesh(2)


def test_make_scenario_mesh_refuses_more_cards_than_visible(logreg_480, no_launch):
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="visible"):
        make_scenario_mesh(n + 1)
    if n == 0:  # here: a CUDA mesh of any size is refused, by its capability code
        with pytest.raises(ValueError, match="visible"):
            make_scenario_mesh()
        cfg = MethodConfig(name="dsag", w=3, eta=0.25, subpartitions=4)
        traces = sharded_fleet(logreg_480, 3)
        for eng in (EngineConfig(kind="scan", num_devices=1),
                    EngineConfig(kind="scan", mesh=ScenarioMesh((torch.device("cuda", 0),)))):
            with pytest.raises(EngineCapabilityError) as err:
                run_convergence_batch(logreg_480, traces, cfg, 10, engine=eng)
            assert err.value.capability.code == CAP_CUDA_UNAVAILABLE
    else:
        eng = EngineConfig(kind="scan", num_devices=n + 1)
        with pytest.raises(ValueError, match="visible"):
            run_convergence_batch(logreg_480, sharded_fleet(logreg_480, 3),
                                  MethodConfig(name="dsag", w=3, eta=0.25, subpartitions=4),
                                  10, engine=eng)


def test_cli_devices_flag_reaches_the_engine(no_launch):
    """``--devices N`` is ``EngineConfig(num_devices=N)``: refused on the CPU
    (one torch device), and without a card by its capability code."""
    small = ["--workers", "6", "--scenarios", "3", "--iters", "5", "--samples", "480"]
    with pytest.raises(ValueError, match="num_devices counts CUDA cards"):
        convergence_sweep.run(small + ["--device", "cpu", "--kernel-backend", "torch",
                                       "--devices", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(EngineCapabilityError) as err:
            convergence_sweep.run(small + ["--engine", "scan", "--devices", "1"])
        assert err.value.capability.code == CAP_CUDA_UNAVAILABLE


def test_public_names():
    assert rt_launch.ScenarioMesh is ScenarioMesh
    assert rt_launch.make_scenario_mesh is make_scenario_mesh
    assert rt_experiments.ScenarioMesh is ScenarioMesh
    assert rt_experiments.make_scenario_mesh is make_scenario_mesh
    assert rt_experiments.run_pca_grid_sharded_column is run_pca_grid_sharded_column
    for name in ("ScenarioMesh", "make_scenario_mesh"):
        assert name in rt_launch.__all__ and name in rt_experiments.__all__
    assert "run_pca_grid_sharded_column" in rt_experiments.__all__


# -- the repairs the shards need: the build lock, the launch counters, the C guard ---------


def test_library_builds_once_under_concurrent_first_launches(monkeypatch, tmp_path):
    """Sixteen threads reach their first launch together: one compiles (into
    a temporary name of its process and thread), the others wait and load
    the same library.  The compile step is stubbed out (no nvcc here)."""
    built, tmp_names = [], []

    def fake_compile(sources, out):
        tmp_names.append(out.name)
        time.sleep(0.05)  # the others pile up on the lock meanwhile
        out.write_bytes(b"stub")
        built.append(out)
        return ""

    lib = object()
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "compile_library", fake_compile)
    monkeypatch.setattr(_build, "_load", lambda so: lib)
    monkeypatch.setattr(_build, "build_info", {})
    got = []
    barrier = threading.Barrier(16)

    def first_launch():
        barrier.wait()
        got.append(_build.library())

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=first_launch) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(built) == 1 and got == [lib] * 16
    assert f".{os.getpid()}." in tmp_names[0] and tmp_names[0].endswith(".tmp.so")
    assert list((tmp_path / "build").iterdir()) == [tmp_path / "build" / _build.build_info[
        "path"].rsplit("/", 1)[1]]


def test_temporary_build_names_differ_per_thread():
    so = Path("/nonexistent/libdsag_kernels_0.so")
    names = set()
    barrier = threading.Barrier(4)  # all four alive at once (idents are reused)

    def name():
        names.add(_build._tmp_path(so).name)
        barrier.wait()

    threads = [threading.Thread(target=name) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert len(names) == 4


def test_launch_counter_loses_no_update():
    counts = {"k": 0}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_build.count_launch(counts, "k")
                                                    for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert counts["k"] == 16 * 2000


@pytest.mark.parametrize("src", sorted(p.name for p in _build.CSRC.glob("*.cu")))
def test_every_c_entry_point_restores_the_callers_device(src):
    """Each C entry point that takes a device switches to it through
    ``DeviceGuard`` (``csrc/device_guard.cuh``), which restores the caller's
    device on every return; none calls ``cudaSetDevice`` itself."""
    text = (_build.CSRC / src).read_text()
    entries = text.count("int device, void* stream")
    assert "cudaSetDevice" not in text
    assert text.count("const DeviceGuard guard(device);") == entries
    if entries:
        assert '#include "device_guard.cuh"' in text
    guard = (_build.CSRC / "device_guard.cuh").read_text()
    assert "if (switched_) cudaSetDevice(prev_);" in guard


# -- the reference's sharded run --------------------------------------------------------


@pytest.mark.parametrize("m", REF_METHODS)
@pytest.mark.parametrize("kind", REF_KINDS)
def test_port_sharded_matches_reference_sharded(ref, kind, m):
    X = ref[f"{kind}/X"]
    prob = (interop.problem_from_arrays("logreg", X, ref["logreg/y"]) if kind == "logreg"
            else interop.problem_from_arrays("pca", X, k=PCA_K))
    traces = interop.traces_from_arrays(*(ref[f"{kind}/{f}"] for f in (
        "comm", "comp_unit", "slowdown", "burst_start", "burst_end", "burst_factor")))
    r = run_convergence_batch(prob, traces, MethodConfig(**_method(kind, m)), N_ITERS,
                              eval_every=1, seed=0,
                              engine=dataclasses.replace(CPU, mesh=cpu_mesh(4)))
    pre = f"{kind}/{m}/"
    for f in ("times", "fresh_counts", "per_worker_latency", "rejected_stale", "evictions"):
        assert np.array_equal(getattr(r, f), ref[pre + f], equal_nan=True), f
    rtol, atol = SUBOPT_TOL[kind]
    np.testing.assert_allclose(r.suboptimality, ref[pre + "suboptimality"], rtol=rtol,
                               atol=atol)


def test_pca_grid_sharded_column(ref, tmp_path):
    """The column at a reduced size on a 4-shard CPU mesh: bit-exact against
    the unsharded run, the committed column's key layout, and the
    reference runner's ranking and verdicts at the same size."""
    run = run_pca_grid_sharded_column(n_scenarios=COL_SCEN, scale=COL_SCALE,
                                      engine=dataclasses.replace(CPU, mesh=cpu_mesh(4)))
    col = run.column
    for m, r in run.sharded.results.items():
        assert result_mismatches(r, run.unsharded.results[m]) == [], m
    assert col["bitexact_sharded_vs_unsharded"] is True
    assert col["num_devices"] == 4 and col["seed"] == 0
    assert col["grid"]["n_scenarios"] == COL_SCEN
    committed = json.loads((REPO / "BENCH_convergence.json").read_text())["pca_grid_sharded"]
    assert set(col) == set(committed)
    for key in ("grid", "methods", "ordering"):
        assert set(col[key]) == set(committed[key]), key
    for m, v in col["methods"].items():
        assert set(v) == set(committed["methods"][m]), m
    # both sides as JSON (a missed gap is null there)
    write_json(col, str(tmp_path / "col.json"))
    mine = json.loads((tmp_path / "col.json").read_text())["ordering"]
    theirs = json.loads(str(ref["col"]))
    # (the reference's own flag is not compared: under jax 0.9 its sharded
    # run at this size is not bit-exact against its unsharded one)
    assert theirs["num_devices"] == 4
    want = theirs["ordering"]
    for key in ("dsag_fastest_to_gap", "ordering_dsag_sag_coded"):
        assert mine[key] == want[key], key
    methods = ("dsag", "sag", "sgd", "coded")
    for m in methods:
        assert mine[f"reached_gap_frac_{m}"] == want[f"reached_gap_frac_{m}"], m

    def ranking(o):  # a method that missed the gap ranks last
        t = {m: o[f"median_time_to_gap_{m}"] for m in methods}
        return sorted(methods, key=lambda m: np.inf if t[m] is None else t[m])

    assert ranking(mine) == ranking(want)
    assert mine["dsag_fastest_to_gap"] == 1.0  # the verdict the column is for


def test_pca_grid_sharded_coded_times_equal_the_reference_host_engine(ref):
    """The coded bound's event times at the committed column's 40 scenarios
    equal the reference's host engine's bit for bit, and their mean final
    time is the value ``chip_smoke.py`` phase 11 (a) holds the column's
    field to (the committed file carries the reference's fused engine's, an
    ulp off)."""
    from repro_torch.experiments.convergence import (
        PAPER_SCALE_PCA,
        default_convergence_methods,
        make_paper_scale_pca,
        run_convergence_sweep,
    )
    from repro_torch.experiments.grid import HEAVY_BURSTS

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    p = PAPER_SCALE_PCA
    pr = make_paper_scale_pca(n_rows=p["n_rows"], seed=0)
    N, sp = p["n_workers"], p["subpartitions"]
    cl = make_heterogeneous_cluster(N, seed=0, burst_rate=0.0, load_unit=pr.compute_cost(
        1, max(pr.num_samples // (N * sp), 1)))
    coded = default_convergence_methods(N, w=p["w"], eta=p["eta"], subpartitions=sp)["coded"]
    o = run_convergence_sweep(pr, cl, {"coded": coded}, n_scenarios=COL_FULL_SCEN,
                              num_iterations=p["num_iterations"], eval_every=p["eval_every"],
                              regime=HEAVY_BURSTS, seed=0, engine=CPU)
    assert np.array_equal(o.results["coded"].times, ref["coded_host/times"])
    want = chip_smoke.REFERENCE_HOST_VALUES["pca_grid_sharded", "coded", "mean_total_time"]
    assert float(ref["coded_host/times"][:, -1].mean()) == want
    committed = json.loads((REPO / "BENCH_convergence.json").read_text())
    assert committed["pca_grid_sharded"]["methods"]["coded"]["mean_total_time"] != want


def test_pca_grid_sharded_marginal_evaluations_are_the_references(ref):
    """The evaluations of the reference's dsag run at the committed column's
    40 scenarios that lie within the PCA tolerance of the gap are the ones
    ``chip_smoke.py`` phase 11 (a) puts back (there a time to gap may fall
    on either side); no other evaluation of that run is near the gap."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    sub = ref["dsag_fused/suboptimality"]
    gap = json.loads((REPO / "BENCH_convergence.json").read_text())["pca_grid_sharded"]["gap"]
    rtol, atol = chip_smoke.PCA_SUBOPT_TOL
    assert (rtol, atol) == SUBOPT_TOL["pca"]
    near = np.argwhere(np.abs(sub - gap) <= rtol * np.abs(sub) + atol)
    got = tuple((int(s), int(t), float(sub[s, t])) for s, t in near)
    assert got == chip_smoke.REFERENCE_MARGINAL_EVALS["pca_grid_sharded", "dsag"]
    assert set(chip_smoke.REFERENCE_MARGINAL_EVALS) == {("pca_grid_sharded", "dsag")}


# -- on the card -------------------------------------------------------------------------


@pytest.mark.gpu
def test_gpu_four_shards_on_one_card_equal_the_unsharded_run(logreg_480, logreg_240):
    """``(cuda:0,) * 4`` through K1, K3 and (with §6) K7, each shard on its
    own stream: bit for bit the unsharded run on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = EngineConfig(kind="scan")
    mesh = ScenarioMesh((torch.device("cuda", 0),) * 4)
    runs = ((logreg_480, sharded_fleet(logreg_480, 5), 40,
             MethodConfig(name="dsag", w=3, eta=0.25, subpartitions=4, **LB)),
            (logreg_240, churn_fleet(5), 24,
             MethodConfig(name="dsag", w=4, eta=0.25, subpartitions=2)))
    for problem, traces, T, cfg in runs:
        plain = run_convergence_batch(problem, traces, cfg, T, seed=0, engine=card)
        sharded = run_convergence_batch(problem, traces, cfg, T, seed=0,
                                        engine=dataclasses.replace(card, mesh=mesh))
        assert result_mismatches(plain, sharded) == []
    assert torch.cuda.current_device() == 0
