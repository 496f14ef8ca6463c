"""Port-only tests of ``repro_torch``: isolation, capability codes, kernel
wrappers and their plain versions, drivers and CLI, on the CPU.

Tests marked ``gpu`` hold the CUDA kernels against their plain versions on
the card; they decide inside the test whether a card is present and skip on
a machine without one (run them there with ``pytest -m gpu
tests/test_torch_port.py``).  Tolerances: plain versions against float64
numpy loops ``rtol=1e-5`` (float32 sums); K1/K2 kernels against the plain
versions ``rtol=1e-4`` with ``atol = 1e-5 * max|plain|`` (float32 sums in
another order); K3 and every event stream exactly.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.cluster.simulator import (
    MethodConfig,
    effective_w,
    margin_deadline,
    task_finish_time,
)
from repro_torch.convergence_sweep import main as sweep_main
from repro_torch.core.problems import (
    LogisticRegressionProblem,
    PCAProblem,
    make_genomics_like_matrix,
    make_higgs_like,
    width_bucket,
)
from repro_torch.experiments.convergence import (
    ConvergenceBatchResult,
    ConvergenceSweepOutcome,
    paper_scale_pca_sweep,
    run_convergence_batch,
)
from repro_torch.experiments.engine import (
    CAP_CUDA_DTYPE,
    CAP_CUDA_KERNELS_OFF_DEVICE,
    CAP_CUDA_SHAPE,
    CAP_CUDA_UNAVAILABLE,
    CAP_OK,
    EngineCapabilityError,
    EngineConfig,
    engine_capability,
    kernel_dtype_capability,
    kernel_shape_capability,
)
from repro_torch.experiments.results import convergence_ordering
from repro_torch.experiments import fused
from repro_torch.kernels import (
    _build,
    block_sub,
    cache_events,
    gram_matvec,
    launch_counts,
    reset_launch_counts,
    what_if,
)
from repro_torch.latency.model import ChurnSchedule, make_heterogeneous_cluster, sample_fleet

REPO = Path(__file__).resolve().parents[1]
CPU = EngineConfig(device="cpu", kernel_backend="torch")


def _small(kind: str = "logreg", n: int = 256, N: int = 4, S: int = 2, T: int = 8):
    if kind == "logreg":
        X, y = make_higgs_like(n, seed=1)
        prob = LogisticRegressionProblem(X=X, y=y)
    else:
        prob = PCAProblem(X=make_genomics_like_matrix(n, 12, seed=1), k=2)
    cl = make_heterogeneous_cluster(
        N, seed=2, burst_rate=0.0, load_unit=prob.compute_cost(1, n // (N * 2))
    )
    tr = sample_fleet(cl, S, T, burst_rate=0.05, burst_factor_mean=4.0,
                      burst_duration_mean=30.0, seed=3)
    return prob, tr


def _tasks(rng, n: int, G: int, max_w: int):
    widths = rng.integers(1, max_w + 1, size=G)
    starts = np.array([rng.integers(1, n - w + 2) for w in widths])
    return torch.as_tensor(starts), torch.as_tensor(widths)


def _cache_inputs(rng, S=3, R=15, E=7, F=4, device="cpu"):
    return tuple(torch.as_tensor(v, device=device)
                 for v in _cache_inputs_np(rng, S, R, E, F).values())


def _cache_inputs_np(rng, S, R, E, F):
    return dict(
        valid_r=rng.random((S, R)) < 0.75,
        slot_r=rng.integers(0, E, size=(S, R)),
        tag_r=rng.integers(0, 6, size=(S, R)),
        vals_r=rng.normal(size=(S, R, F)),
        sums=rng.normal(size=(S, F)),
        values=rng.normal(size=(S, E, F)),
        iters=rng.integers(-1, 4, size=(S, E)),
        covered=rng.integers(0, 40, size=S),
        rejected=rng.integers(0, 4, size=S),
        slot_width=rng.integers(1, 30, size=E),
    )


# -- isolation -------------------------------------------------------------------


def test_port_imports_neither_jax_nor_repro():
    script = r"""
import importlib, importlib.util, json, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "repro" or m.startswith("repro."))
print(json.dumps({"imported": names, "bad": bad}))
"""
    proc = subprocess.run(
        [sys.executable, "-c", script, str(REPO / "chip_smoke.py")],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    assert "repro_torch.experiments.fused" in out["imported"]
    assert "repro_torch.kernels._build" in out["imported"]


def test_port_sources_name_no_jax_import():
    for path in list((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax", "import repro.", "from repro.",
                                     "from repro import", "import repro ")), (path, s)


# -- capability codes -------------------------------------------------------------


def test_cuda_backend_on_cpu_device_raises():
    prob, tr = _small()
    with pytest.raises(EngineCapabilityError) as ei:
        run_convergence_batch(prob, tr, MethodConfig("dsag", w=3, subpartitions=2), 4,
                              engine=EngineConfig(device="cpu", kernel_backend="cuda"))
    assert ei.value.capability.code == CAP_CUDA_KERNELS_OFF_DEVICE


def test_default_engine_runs_on_the_card_or_refuses():
    cap = engine_capability(EngineConfig())
    if torch.cuda.is_available():
        assert cap.supported and cap.code == CAP_OK
        return
    assert not cap.supported and cap.code == CAP_CUDA_UNAVAILABLE
    prob, tr = _small()
    with pytest.raises(EngineCapabilityError) as ei:
        run_convergence_batch(prob, tr, MethodConfig("sag", w=4, subpartitions=2), 4)
    assert ei.value.capability.code == CAP_CUDA_UNAVAILABLE


def test_load_balance_is_refused():
    """§6 load balancing with churn, once refused before any step, runs on
    the device engine and equals the host engine bit for bit."""
    prob, tr = _small()
    cfg = MethodConfig("dsag", w=3, subpartitions=2, load_balance=True,
                       lb_startup_delay=0.0, lb_interval=0.0)
    tch = tr.with_churn(ChurnSchedule.static(tr.slowdown))
    scan = run_convergence_batch(prob, tch, cfg, 4, engine=CPU)
    host = run_convergence_batch(prob, tch, cfg, 4, engine=dataclasses.replace(CPU, kind="host"))
    assert np.array_equal(scan.times, host.times)
    assert np.array_equal(scan.suboptimality, host.suboptimality, equal_nan=True)
    assert scan.repartition_events == host.repartition_events


def test_load_balance_runs_on_the_device_engine():
    """The device engine runs §6 and equals the host engine bit for bit."""
    prob, tr = _small()
    cfg = MethodConfig("dsag", w=3, subpartitions=2, load_balance=True,
                       lb_startup_delay=0.0, lb_interval=0.0)
    scan = run_convergence_batch(prob, tr, cfg, 4, engine=CPU)
    host = run_convergence_batch(prob, tr, cfg, 4, engine=dataclasses.replace(CPU, kind="host"))
    assert np.array_equal(scan.times, host.times)
    assert np.array_equal(scan.suboptimality, host.suboptimality, equal_nan=True)
    assert scan.repartition_events == host.repartition_events


def test_churn_is_refused():
    """Churn, once refused, runs: a static schedule replays bit for bit the
    run without one."""
    prob, tr = _small()
    cfg = MethodConfig("sag", w=4, subpartitions=2)
    static = run_convergence_batch(prob, tr, cfg, 4, engine=CPU)
    churned = run_convergence_batch(prob, tr.with_churn(ChurnSchedule.static(tr.slowdown)),
                                    cfg, 4, engine=CPU)
    assert np.array_equal(static.times, churned.times)
    assert np.array_equal(static.suboptimality, churned.suboptimality, equal_nan=True)


def test_cuda_kernels_take_float32_only():
    cuda = EngineConfig(device="cuda", kernel_backend="cuda")
    assert kernel_dtype_capability(cuda, torch.float64).code == CAP_CUDA_DTYPE
    assert kernel_dtype_capability(cuda, torch.float32).supported
    assert kernel_dtype_capability(CPU, torch.float64).supported


@pytest.mark.parametrize(
    "kwargs", [dict(kernel_backend="xla"), dict(kernel_backend="pallas"), dict(device="nonsense")]
)
def test_engine_config_validates(kwargs):
    with pytest.raises((ValueError, RuntimeError)):
        EngineConfig(**kwargs)


@pytest.mark.parametrize(("kind", "G", "n", "d", "k", "W", "wide", "slabs"), [
    ("logreg", 1000, 16_384, 29, None, 17, False, 1),  # the sweep's grid call
    ("logreg", 10, 16_384, 29, None, 16_384, False, 64),  # the coded call
    ("logreg", 1000, 16_384, 96, None, 17, False, 1),  # the fast path's widest d
    ("logreg", 1000, 16_384, 97, None, 17, True, 1),
    ("logreg", 10, 16_384, 1000, None, 16_384, True, 64),
    ("pca", 200, 50_000, 96, 3, 200, False, 1),  # pca_paper_scale's grid call
    ("pca", 4, 50_000, 96, 3, 50_000, False, 98),  # ... and its coded call
    ("pca", 200, 50_000, 179, 3, 200, False, 1),  # the last d the staged rows fit
    ("pca", 200, 50_000, 180, 3, 200, True, 1),
    ("pca", 6, 4096, 180, 3, 4096, True, 16),  # the --cols 180 sweep's coded call
    ("pca", 200, 50_000, 96, 12, 200, True, 1),  # d*k past 1024
    ("pca", 2, 10**8, 96, 3, 10**8, True, 65_531),  # past 65535 slabs: 1526-row slabs
])
def test_block_sub_launch_plan(kind, G, n, d, k, W, wide, slabs):
    plan = block_sub.logreg_plan(G, n, d, W) if kind == "logreg" else block_sub.pca_plan(
        G, n, d, k, W)
    assert (plan.wide, plan.slabs) == (wide, slabs)
    assert plan.slabs <= block_sub.GRID_Y and plan.slabs * plan.slab_rows >= min(W, n)
    if wide:  # partials where there are several slabs, then the row pass's [G, W, k]
        kk = k or 1
        assert plan.W == min(W, n)
        assert plan.scratch == (G * slabs * d * kk if slabs > 1 else 0) + G * plan.W * kk
    assert block_sub.shape_error(G, n, d, k, W) is None


@pytest.mark.parametrize(("shape", "wide", "chunks", "rows"), [
    ((50, 1000, 64, 3), False, None, None),  # the live PCA step
    ((1, 4096, 512, 8), False, None, None),
    ((50, 1000, 1100, 3), True, 4, 256),  # d past 1024
    ((1, 4096, 64, 12), True, 16, 256),  # k past 8
    ((70_000, 10, 16, 3), True, 1, 256),  # more groups than the fast grid's y
])
def test_k5_launch_plan(shape, wide, chunks, rows):
    """The path from the shapes alone; the wide path's plan too (the fast
    path's chunks follow the compiled kernel's tile rows, on the card)."""
    B, m, d, k = shape
    assert gram_matvec.is_wide(B, d, k) == wide
    if wide:
        p = gram_matvec.plan(B, m, d, k, d % 4 == 0)
        assert (p.wide, p.slabs, p.slab_rows) == (True, chunks, rows)
    assert gram_matvec.shape_error(B, m, d, k) is None


@pytest.mark.parametrize(("S", "R", "E", "F", "plan"), [
    (10, 200, 1000, 29, (4, 38, 27)),  # the grid recipe's dsag walk
    (4, 100, 250, 288, (8, 4, 63)),  # pca_paper_scale's dsag walk
    (1, 8192, 10**6, 1, (1, 2048, 489)),  # four windows of ranks; many rows
    (1, 2048, 1000, 29, (4, 4, 250)),  # the most ranks one window holds
    (1, 2049, 1000, 29, (1, 4, 250)),  # two windows: one walk block carries them
    (10, 10_000, 50_000, 29, (1, 1894, 27)),  # a dsag sweep of 5000 workers
])
def test_k3_launch_plan(S, R, E, F, plan):
    assert cache_events._plan(S, R, E, F) == plan
    assert cache_events.shape_error(S, R, E, F) is None


@pytest.mark.parametrize("case", ["logreg", "pca", "gram", "cache_grid", "cache_values"])
def test_shape_errors_past_the_kernels_limits(case):
    big = 2**20
    err = {
        "logreg": lambda: block_sub.shape_error(big, big, 97, None, big),
        "pca": lambda: block_sub.shape_error(big, big, 180, 3, big),
        "gram": lambda: gram_matvec.shape_error(big, 2**14, 2048, 3),
        "cache_grid": lambda: cache_events.shape_error(2**22, 10, 2**20, 1),
        "cache_values": lambda: cache_events.shape_error(1, 8192, 10, 2**18),
    }[case]()
    assert err is not None and err.split(":")[0] in (
        "logreg_block_sub", "pca_block_sub", "gram_matvec", "grid_cache_update")
    assert kernel_shape_capability(EngineConfig(device="cuda", kernel_backend="cuda"),
                                   [None, err]).code == CAP_CUDA_SHAPE
    assert kernel_shape_capability(CPU, [err]).supported  # the plain versions take any shape


def test_cuda_shape_refused_before_any_launch(monkeypatch):
    """A dsag sweep whose cache walk needs more blocks than CUDA's grid holds
    (the limit lowered here, as no small shape reaches it): refused with
    cuda-shape-unsupported before the first launch."""
    N = 8
    monkeypatch.setattr(cache_events, "GRID_X", 4)
    X, y = make_higgs_like(2 * N, seed=1)
    prob = LogisticRegressionProblem(X=X, y=y)
    cl = make_heterogeneous_cluster(N, seed=2, burst_rate=0.0, load_unit=1.0)
    tr = sample_fleet(cl, 1, 2, seed=3)
    cpu_kernels = prob.fused_kernels("cpu")
    monkeypatch.setattr(fused, "engine_capability", lambda *a: engine_capability(CPU))
    monkeypatch.setattr(prob, "fused_kernels", lambda device: cpu_kernels)
    reset_launch_counts()
    with pytest.raises(EngineCapabilityError) as ei:
        run_convergence_batch(prob, tr, MethodConfig("dsag", w=N - 1, subpartitions=1), 1,
                              engine=EngineConfig(device="cuda", kernel_backend="cuda"))
    assert ei.value.capability.code == CAP_CUDA_SHAPE
    assert "grid_cache_update" in str(ei.value)
    assert all(v == 0 for v in launch_counts().values())
    # the same run on the plain versions is not refused
    res = run_convergence_batch(prob, tr, MethodConfig("dsag", w=N - 1, subpartitions=1), 1,
                                engine=CPU)
    assert res.times.shape == (1, 1)


def test_mirrored_limits_name_every_exported_constant():
    text = "".join(p.read_text() for p in sorted(_build.CSRC.glob("*.cu")))
    assert set(_build.CONSTANTS) == set(_build.LIMITS)
    for name in _build.LIMITS:
        assert f"int {name}()" in text, name


def test_too_many_iterations_for_the_traces():
    prob, tr = _small(T=4)
    with pytest.raises(ValueError, match="draws/worker"):
        run_convergence_batch(prob, tr, MethodConfig("sag", w=4, subpartitions=2), 5, engine=CPU)


# -- kernel wrappers on the CPU ----------------------------------------------------


def test_launch_counters_stay_zero_on_cpu():
    reset_launch_counts()
    for kind, name in (("logreg", "dsag"), ("pca", "sag"), ("logreg", "coded")):
        prob, tr = _small(kind)
        run_convergence_batch(prob, tr, MethodConfig(name, w=3, subpartitions=2), 6, engine=CPU)
    rng = np.random.default_rng(0)
    block_sub.logreg_block_sub(torch.randn(50, 5), torch.ones(50), torch.randn(3, 5),
                               *_tasks(rng, 50, 3, 9))
    cache_events.grid_cache_update(*_cache_inputs(rng))
    what_if.what_if_replay(torch.rand(2, 5, 7, dtype=torch.float64), 3, 0.02)
    from repro_torch.kernels import dsag_update
    from repro_torch.optim.compression import quantize

    q = quantize(torch.randn(2, 1, 5), block=5)
    dsag_update.dsag_cache_update_int8(torch.randn(2, 1, 5), q.q, q.scale[..., 0], q.q,
                                       q.scale[..., 0], torch.zeros(1, 5),
                                       torch.tensor([1, 6], dtype=torch.uint8))
    dsag_update.dsag_int8_row_max(torch.randn(2, 1, 5), q.q, q.scale[..., 0], q.q,
                                  q.scale[..., 0], torch.tensor([1, 6], dtype=torch.uint8))
    assert launch_counts() == {"logreg_block_sub": 0, "pca_block_sub": 0, "grid_cache_update": 0,
                               "dsag_cache_update": 0, "dsag_cache_update_int8": 0,
                               "dsag_int8_row_max": 0, "gram_matvec": 0, "flash_attention": 0,
                               "what_if_replay": 0}


def test_wrappers_on_cpu_take_the_plain_versions():
    rng = np.random.default_rng(1)
    X, y = torch.randn(60, 7), torch.sign(torch.randn(60))
    st, wd = _tasks(rng, 60, 5, 12)
    Vb = torch.randn(5, 7)
    assert torch.equal(block_sub.logreg_block_sub(X, y, Vb, st, wd),
                       block_sub.logreg_block_sub_plain(X, y, Vb, st, wd))
    V3 = torch.randn(5, 7, 2)
    assert torch.equal(block_sub.pca_block_sub(X, V3, st, wd),
                       block_sub.pca_block_sub_plain(X, V3, st, wd))
    a = _cache_inputs(rng)
    for g, p in zip(cache_events.grid_cache_update(*a), cache_events.grid_cache_update_plain(*a)):
        assert torch.equal(g, p)


def test_wrappers_refuse_devices_they_do_not_take():
    X = torch.empty(10, 3, device="meta")
    with pytest.raises(ValueError, match="devices"):
        block_sub.logreg_block_sub(X, torch.empty(10, device="meta"),
                                   torch.empty(2, 3, device="meta"),
                                   torch.ones(2, dtype=torch.int64), torch.ones(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="devices"):
        cache_events.grid_cache_update(*_cache_inputs(np.random.default_rng(2), device="meta"))


def test_require_checks_dtype_rank_device_and_layout():
    t = torch.zeros(4, 3)
    block_sub._require(t, "t", torch.float32, (4, 3), t.device)
    for bad in (t.double(), t[None], t[:, :2], torch.zeros(3, 4).T):
        with pytest.raises(ValueError):
            block_sub._require(bad, "t", torch.float32, (4, 3), t.device)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_logreg_plain_matches_numpy_loop(seed):
    rng = np.random.default_rng(seed)
    n, d, G = 80, 6, 7
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    V = rng.normal(size=(G, d)).astype(np.float32)
    st, wd = _tasks(rng, n, G, 20)
    got = block_sub.logreg_block_sub_plain(*map(torch.as_tensor, (X, y, V)), st, wd)
    for g in range(G):
        rows = slice(int(st[g]) - 1, int(st[g]) - 1 + int(wd[g]))
        x, yy = X[rows].astype(np.float64), y[rows].astype(np.float64)
        s = 1.0 / (1.0 + np.exp(yy * (x @ V[g])))
        want = -(x * (yy * s)[:, None]).sum(0) / n
        np.testing.assert_allclose(got[g].numpy(), want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pca_plain_matches_numpy_loop(seed):
    rng = np.random.default_rng(seed)
    n, d, k, G = 90, 8, 3, 6
    X = rng.normal(size=(n, d)).astype(np.float32)
    V = rng.normal(size=(G, d, k)).astype(np.float32)
    st, wd = _tasks(rng, n, G, 30)
    got = block_sub.pca_block_sub_plain(torch.as_tensor(X), torch.as_tensor(V), st, wd)
    for g in range(G):
        x = X[int(st[g]) - 1: int(st[g]) - 1 + int(wd[g])].astype(np.float64)
        np.testing.assert_allclose(got[g].numpy(), -(x.T @ (x @ V[g])), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(("max_width", "n", "slabs"), [
    (200, 16_384, 1),  # the sweep's grid calls: one pass, one block per task
    (512, 50_000, 1),  # exactly one slab
    (513, 50_000, 2),  # one slab and one row
    (511, 50_000, 1),
    (50_000, 50_000, 98),  # the coded call: ceil(50000 / 512)
    (None, 50_000, 98),  # no static width: every window fits in n rows
    (None, 300, 1),
    (10**6, 1_000, 2),  # no window is longer than n
    (0, 1_000, 1),
])
def test_pca_slab_count(max_width, n, slabs):
    assert block_sub.row_slabs(max_width, n, 512) == slabs


@pytest.mark.parametrize(("max_width", "n", "slabs", "warps"), [
    (17, 16_384, 1, 1),  # the sweep's grid call: one warp per task, one pass
    (160, 16_000, 1, 5),  # the live logreg call (n // G rows per group)
    (16_384, 16_384, 64, 8),  # the coded call: ceil(16384 / 256) slabs
    (None, 16_384, 64, 8),  # no static width: every window fits in n rows
    (32, 16_384, 1, 1),
    (33, 16_384, 1, 2),
    (256, 50_000, 1, 8),  # exactly one slab
    (257, 50_000, 2, 8),  # one slab and one row
    (10**6, 1_000, 4, 8),  # no window is longer than n
    (0, 1_000, 1, 1),
])
def test_logreg_slab_count(max_width, n, slabs, warps):
    assert block_sub.row_slabs(max_width, n, 256) == slabs
    assert block_sub.logreg_warps(max_width, n, 256, 8) == warps


def test_plain_versions_do_not_depend_on_the_pad_width():
    rng = np.random.default_rng(3)
    X, y = torch.randn(70, 5), torch.sign(torch.randn(70))
    st, wd = _tasks(rng, 70, 6, 10)
    V, V3 = torch.randn(6, 5), torch.randn(6, 5, 2)
    for pad in (16, 64):
        torch.testing.assert_close(block_sub.logreg_block_sub_plain(X, y, V, st, wd, pad),
                                   block_sub.logreg_block_sub_plain(X, y, V, st, wd))
        torch.testing.assert_close(block_sub.pca_block_sub_plain(X, V3, st, wd, pad),
                                   block_sub.pca_block_sub_plain(X, V3, st, wd))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cache_plain_equals_a_scalar_walk(seed):
    """The §5 rank walk, one event at a time in python floats: bit-equal."""
    rng = np.random.default_rng(seed)
    a = _cache_inputs(rng)
    got = cache_events.grid_cache_update_plain(*a)
    valid, slot, tag, vals, sums, values, iters, cov, rej, width = (t.numpy().copy() for t in a)
    S, R = valid.shape
    for s in range(S):
        for j in range(R):
            if not valid[s, j]:
                continue
            e = slot[s, j]
            active = iters[s, e] >= 0
            if active and iters[s, e] >= tag[s, j]:
                rej[s] += 1
                continue
            for f in range(vals.shape[2]):
                old = values[s, e, f] if active else 0.0
                sums[s, f] = sums[s, f] + (vals[s, j, f] - old)
                values[s, e, f] = vals[s, j, f]
            iters[s, e] = tag[s, j]
            if not active:
                cov[s] += width[e]
    for g, w in zip(got, (sums, values, iters, cov, rej)):
        assert np.array_equal(g.numpy(), w)


def test_kernel_sources_define_every_entry_point():
    text = "".join(p.read_text() for p in sorted(_build.CSRC.glob("*.cu")))
    assert len(list(_build.CSRC.glob("*.cu"))) == 6
    for name in list(_build.SIGNATURES) + list(_build.CONSTANTS) + ["dsag_cuda_error_string"]:
        assert f" {name}(" in text, name
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


# -- problems, engine and drivers --------------------------------------------------


def test_width_bucket_ladder():
    assert [width_bucket(m, 1000) for m in (1, 2, 3, 16, 17, 1000)] == [1, 2, 4, 16, 32, 1000]


def test_event_helpers_group_like_the_reference():
    start, comp, comm = np.array([1e16]), np.array([1.0]), np.array([1.0])
    assert task_finish_time(start, comp, comm)[0] == start[0] + 2.0  # (comp+comm) first
    t = torch.tensor([3.0], dtype=torch.float64)
    assert margin_deadline(t, torch.tensor([1.0], dtype=torch.float64), 0.5).item() == 4.0
    assert effective_w(MethodConfig("coded"), 49) == 45
    assert effective_w(MethodConfig("gd", w=3), 8) == 8


@pytest.mark.parametrize("kind", ["logreg", "pca"])
@pytest.mark.parametrize("method", ["dsag", "sag", "sgd", "gd", "coded"])
def test_engine_outputs_have_reference_shapes_and_dtypes(kind, method):
    prob, tr = _small(kind)
    res = run_convergence_batch(prob, tr, MethodConfig(method, w=3, subpartitions=2), 8,
                                eval_every=3, engine=CPU)
    S, N = tr.num_scenarios, tr.num_workers
    assert res.times.shape == (S, 8) and res.times.dtype == np.float64
    assert res.fresh_counts.dtype == np.int64 and res.rejected_stale.shape == (S,)
    assert res.per_worker_latency.shape == (S, 8, N)
    assert np.all(np.diff(res.times, axis=1) > 0)
    evaluated = np.isfinite(res.suboptimality[0])
    assert evaluated.tolist() == [t % 3 == 0 or t == 7 for t in range(8)]
    assert np.all(res.suboptimality[:, evaluated] > 0)


def test_engine_is_deterministic():
    prob, tr = _small("pca")
    cfg = MethodConfig("dsag", w=3, subpartitions=2)
    a = run_convergence_batch(prob, tr, cfg, 8, engine=CPU)
    b = run_convergence_batch(prob, tr, cfg, 8, engine=CPU)
    for f in ("times", "suboptimality", "fresh_counts", "per_worker_latency", "rejected_stale"):
        assert np.array_equal(getattr(a, f), getattr(b, f), equal_nan=True), f


def test_time_to_gap_and_ordering():
    times = np.array([[1.0, 2.0, 3.0], [1.0, 2.0, 3.0]])
    sub = np.array([[0.5, np.nan, 0.1], [0.5, 0.4, 0.3]])
    res = ConvergenceBatchResult(times, sub, np.zeros((2, 3), np.int64), np.zeros((2, 3, 1)),
                                 [[], []], np.zeros(2, np.int64), np.zeros(2, np.int64))
    assert res.time_to_gap(0.2).tolist() == [3.0, np.inf]
    assert res.time_to_gap(0.5).tolist() == [1.0, 1.0]

    def result(t):
        return ConvergenceBatchResult(np.array([[t]]), np.array([[0.0]]), None, None, [[]],
                                      None, None)

    out = ConvergenceSweepOutcome({"dsag": result(1.0), "sag": result(2.0), "coded": result(4.0)},
                                  {}, None, None, None, 1, 1.0, 1, 0, 0.0)
    o = convergence_ordering(out, 0.1)
    assert o["sag_over_dsag"] == 2.0 and o["coded_over_dsag"] == 4.0
    assert o["dsag_fastest_to_gap"] == 1.0 and o["ordering_dsag_sag_coded"] == 1.0


def test_interop_validates_its_inputs():
    with pytest.raises(ValueError, match="unknown problem"):
        interop.problem_from_arrays("svm", np.zeros((4, 2), np.float32))
    with pytest.raises(ValueError, match="labels"):
        interop.problem_from_arrays("logreg", np.zeros((4, 2), np.float32))
    z = np.zeros((2, 3, 4))
    with pytest.raises(ValueError):
        interop.traces_from_arrays(z, z[:, :, :2], np.ones(3), z, z, z)
    with pytest.raises(ValueError):
        interop.traces_from_arrays(z, z, np.ones(3), z[:1], z[:1], z[:1])
    prob = interop.problem_from_arrays("pca", make_genomics_like_matrix(64, 6), k=2, device="cpu")
    assert torch.device("cpu") in prob._kernels
    tr = interop.traces_from_arrays(z, z, np.ones(3), z[:, :, :0], z[:, :, :0], z[:, :, :0])
    assert tr.num_scenarios == 2 and not tr.has_bursts


def test_cli_runs_on_cpu(capsys):
    o = sweep_main(["--device", "cpu", "--kernel-backend", "torch", "--workers", "6",
                    "--scenarios", "2", "--iters", "10", "--samples", "600", "--eval-every", "2"])
    text = capsys.readouterr().out
    assert "sag/dsag=" in text and "coded/dsag=" in text
    assert {"median_time_to_gap_dsag", "median_time_to_gap_coded"} <= set(o)


def test_paper_scale_pca_sweep_cut_down_on_cpu():
    out, gap = paper_scale_pca_sweep(scale=0.02, engine=CPU)
    assert gap == 1e-4 and set(out.results) == {"dsag", "sag", "sgd", "coded"}
    assert out.problem.num_samples == 1000 and out.traces.num_workers == 50
    for res in out.results.values():
        assert np.isfinite(res.suboptimality[:, -1]).all()


# -- on the card --------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _assert_kernel_close(got, want):
    torch.cuda.synchronize()
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.gpu
def test_gpu_logreg_kernel_matches_plain(card):
    rng = np.random.default_rng(4)
    X, y = (torch.as_tensor(a, device=card) for a in make_higgs_like(4096, seed=2))
    st, wd = (t.to(card) for t in _tasks(rng, 4096, 300, 40))
    Vb = torch.randn(300, X.shape[1], device=card)
    before = launch_counts()["logreg_block_sub"]
    got = block_sub.logreg_block_sub(X, y, Vb, st, wd)
    assert launch_counts()["logreg_block_sub"] == before + 1
    _assert_kernel_close(got, block_sub.logreg_block_sub_plain(X, y, Vb, st, wd))


@pytest.mark.gpu
def test_gpu_pca_kernel_matches_plain(card):
    rng = np.random.default_rng(5)
    X = torch.as_tensor(make_genomics_like_matrix(5000, 96, seed=2), device=card)
    st, wd = (t.to(card) for t in _tasks(rng, 5000, 40, 700))
    Vb = torch.linalg.qr(torch.randn(40, 96, 3, device=card))[0].contiguous()
    got = block_sub.pca_block_sub(X, Vb, st, wd)
    _assert_kernel_close(got, block_sub.pca_block_sub_plain(X, Vb, st, wd))


def _window_tasks(case: str, n: int, slab: int):
    """(starts, widths, max_width) of one K2 call over wide windows."""
    if case == "coded":  # the sweep's coded call: 4 full-width tasks
        return [1] * 4, [n] * 4, n
    if case == "slab_edges":  # one slab and one row, one row short of a slab,
        # a window ending at row n, one row, exactly one slab
        widths = [slab + 1, slab - 1, 3 * slab + 7, 1, slab]
        starts = [1, 17, n - widths[2] + 1, n, 1000]
        return starts, widths, max(widths)
    if case == "mixed":  # the grid call's narrow tasks beside full-width ones
        rng = np.random.default_rng(7)
        widths = list(rng.integers(1, 201, size=30)) + [n, n - 5, 2 * slab]
        starts = [int(rng.integers(1, n - w + 2)) for w in widths]
        return starts, widths, n
    assert case == "max_width_none"
    return [1, 101, n - 4000], [n, 20_000, 4000], None


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["coded", "slab_edges", "mixed", "max_width_none"])
def test_gpu_pca_kernel_over_row_slabs(card, case):
    n = 50_000
    X = torch.as_tensor(make_genomics_like_matrix(n, 96, seed=3), device=card)
    starts, widths, max_width = _window_tasks(case, n, _build.constant("dsag_pca_slab"))
    st = torch.as_tensor(starts, dtype=torch.int64, device=card)
    wd = torch.as_tensor(widths, dtype=torch.int64, device=card)
    Vb = torch.linalg.qr(torch.randn(len(starts), 96, 3, device=card))[0].contiguous()
    before = launch_counts()["pca_block_sub"]
    got = block_sub.pca_block_sub(X, Vb, st, wd, max_width)
    again = block_sub.pca_block_sub(X, Vb, st, wd, max_width)
    assert launch_counts()["pca_block_sub"] == before + 2
    _assert_kernel_close(got, block_sub.pca_block_sub_plain(X, Vb, st, wd, max(widths)))
    assert torch.equal(got, again)  # slab partials summed in a fixed order


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["coded", "slab_edges", "mixed", "max_width_none"])
def test_gpu_logreg_kernel_over_row_slabs(card, case):
    n = 50_000
    X, y = (torch.as_tensor(a, device=card) for a in make_higgs_like(n, seed=3))
    starts, widths, max_width = _window_tasks(case, n, _build.constant("dsag_logreg_slab"))
    st = torch.as_tensor(starts, dtype=torch.int64, device=card)
    wd = torch.as_tensor(widths, dtype=torch.int64, device=card)
    Vb = 0.1 * torch.randn(len(starts), X.shape[1], device=card)
    before = launch_counts()["logreg_block_sub"]
    got = block_sub.logreg_block_sub(X, y, Vb, st, wd, max_width)
    again = block_sub.logreg_block_sub(X, y, Vb, st, wd, max_width)
    assert launch_counts()["logreg_block_sub"] == before + 2
    _assert_kernel_close(got, block_sub.logreg_block_sub_plain(X, y, Vb, st, wd, max(widths)))
    assert torch.equal(got, again)  # slab partials summed in a fixed order


#: K3's edge cases: (S, R, E, F, how the events are drawn)
K3_CASES = {
    "repeated_slots": (3, 120, 4, 5, "default"),  # long chains on few slots
    "equal_tags": (2, 60, 20, 3, "equal_tags"),  # a tag equal to the slot's: rejected
    "all_invalid": (3, 40, 10, 4, "all_invalid"),
    "negative_tags": (2, 80, 6, 3, "negative_tags"),  # an accepted tag < 0 empties the slot
    "large_E": (2, 50, 200_000, 3, "default"),  # far more rows than shared memory holds
    "F1": (4, 30, 12, 1, "default"),
    "F_past_1024": (2, 40, 30, 1500, "default"),  # more features than threads
    "S1": (1, 200, 1000, 29, "default"),
    # past one window of ranks: one walk block carries the tags, values and
    # counts from each window to the next
    "windows": (2, 8193, 5000, 3, "default"),  # four windows and one rank
    "windows_few_slots": (2, 5000, 40, 33, "rising_tags"),  # slots named in every window
    "windows_negative_tags": (2, 4500, 30, 2, "negative_tags"),  # emptied and refilled
}


def _k3_case(case: str, device):
    S, R, E, F, how = K3_CASES[case]
    rng = np.random.default_rng(sorted(K3_CASES).index(case))
    a = dict(_cache_inputs_np(rng, S, R, E, F))
    if how == "equal_tags":
        a["iters"] = np.full((S, E), 3)
        a["tag_r"] = np.full((S, R), 3)
    elif how == "all_invalid":
        a["valid_r"] = np.zeros((S, R), dtype=bool)
    elif how == "negative_tags":
        a["tag_r"] = rng.integers(-3, 4, size=(S, R))
    elif how == "rising_tags":  # accepted and stale events in every window
        a["tag_r"] = np.arange(R)[None, :] // 40 + rng.integers(0, 3, size=(S, R))
    return tuple(torch.as_tensor(v, device=device) for v in a.values())


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(K3_CASES))
def test_gpu_cache_kernel_edge_cases(card, case):
    a = _k3_case(case, card)
    before = [t.clone() for t in a]
    got = cache_events.grid_cache_update(*a)
    want = cache_events.grid_cache_update_plain(*a)
    torch.cuda.synchronize()
    for name, g, p in zip(("sums", "values", "iters", "covered", "rejected"), got, want):
        assert torch.equal(g, p), name
    for t, b in zip(a, before):  # inputs are not modified
        assert torch.equal(t, b)


@pytest.mark.gpu
@pytest.mark.parametrize(("kind", "d", "k"), [("logreg", 97, None), ("logreg", 1000, None),
                                              ("pca", 180, 3), ("pca", 96, 12)])
@pytest.mark.parametrize("case", ["grid", "coded", "slab_edges"])
def test_gpu_block_sub_wide_path(card, kind, d, k, case):
    """K1 and K2 past their fast paths' widths: the wide path, within the
    float32 tolerance of the plain versions, repeating its bits."""
    rng = np.random.default_rng(8)
    n = 16_384
    X = torch.as_tensor(rng.random((n, d)) < 0.1, dtype=torch.float32, device=card)
    y = torch.as_tensor(np.where(rng.random(n) < 0.5, -1.0, 1.0), dtype=torch.float32,
                        device=card)
    if case == "grid":
        st, wd = _tasks(rng, n, 600, 17)
        starts, widths, max_width = st.tolist(), wd.tolist(), 17
    else:
        starts, widths, max_width = _window_tasks(case, n, _build.LIMITS["dsag_wide_slab"])
    st = torch.as_tensor(starts, dtype=torch.int64, device=card)
    wd = torch.as_tensor(widths, dtype=torch.int64, device=card)
    G = len(starts)
    if kind == "logreg":
        assert block_sub.logreg_plan(G, n, d, max_width).wide
        Vb = 0.1 * torch.randn(G, d, device=card)
        got = block_sub.logreg_block_sub(X, y, Vb, st, wd, max_width)
        again = block_sub.logreg_block_sub(X, y, Vb, st, wd, max_width)
        want = block_sub.logreg_block_sub_plain(X, y, Vb, st, wd, max(widths))
    else:
        assert block_sub.pca_plan(G, n, d, k, max_width).wide
        Vb = torch.linalg.qr(torch.randn(G, d, k, device=card))[0].contiguous()
        got = block_sub.pca_block_sub(X, Vb, st, wd, max_width)
        again = block_sub.pca_block_sub(X, Vb, st, wd, max_width)
        want = block_sub.pca_block_sub_plain(X, Vb, st, wd, max(widths))
    _assert_kernel_close(got, want)
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_gpu_cache_kernel_equals_plain(card):
    a = _cache_inputs(np.random.default_rng(6), S=5, R=60, E=40, F=33, device=card)
    for g, p in zip(cache_events.grid_cache_update(*a), cache_events.grid_cache_update_plain(*a)):
        assert torch.equal(g, p)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["logreg", "pca"])
def test_gpu_engine_kernels_equal_plain_event_streams(card, kind):
    prob, tr = _small(kind, n=2048, N=8, S=3, T=12)
    for method in ("dsag", "sgd", "coded"):
        cfg = MethodConfig(method, w=6, subpartitions=4)
        k = run_convergence_batch(prob, tr, cfg, 12, engine=EngineConfig())
        p = run_convergence_batch(prob, tr, cfg, 12,
                                  engine=EngineConfig(device="cuda", kernel_backend="torch"))
        assert np.array_equal(k.times, p.times) and np.array_equal(k.fresh_counts, p.fresh_counts)
        np.testing.assert_allclose(k.suboptimality, p.suboptimality, rtol=1e-4, atol=1e-6)
