"""The port's analysis layer (``repro_torch.analysis``: roofline, cost counter)
held against the JAX reference's (``repro.analysis``) on the CPU.

The reference runs in ONE subprocess for this module (``_REF_SCRIPT``, with
the jax-0.9 shim of ``tests/test_torch_parity.py``): ``hlo.analyze_hlo`` over
a compiled scan of 5 matmuls, and ``roofline.model_flops`` /
``active_params`` over the same ``ModelConfig`` fields and every shape of
``SHAPES``.  This process never imports ``jax`` or ``repro``.  Everything is
compared exactly: FLOP and parameter counts are integers in float64.

The kernels' cost models are held to the formulas ``chip_smoke.py`` wrote
inline before the module existed, at phase 3's shapes, and the wrappers'
cost reports are checked without a card: ``_build.launch`` is stubbed and
the wrappers are told their CPU tensors are on the card.
"""

from __future__ import annotations

import ast
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map

from repro_torch import kernels
from repro_torch.analysis import kernel_costs, roofline
from repro_torch.analysis.cost import Cost, count_cost
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.kernels import (
    _build,
    block_sub,
    cache_events,
    dsag_update,
    flash_attention,
    gram_matvec,
    what_if,
)
from repro_torch.models import build_model

REPO = Path(__file__).resolve().parents[1]

#: configurations both packages count: the served dense model and an MoE
#: probe (its active parameters differ from its total)
CONFIGS = {
    "qwen1.5-0.5b": dict(name="qwen1.5-0.5b", family="dense", num_layers=24, d_model=1024,
                         num_heads=16, num_kv_heads=16, d_ff=2816, vocab_size=151936,
                         qkv_bias=True, tie_embeddings=True),
    "moe-probe": dict(name="moe-probe", family="moe", num_layers=4, d_model=64, num_heads=4,
                      num_kv_heads=2, d_ff=128, vocab_size=512, num_experts=8, top_k=2,
                      num_shared_experts=1, d_ff_expert=32),
}
NUM_PARAMS = {"qwen1.5-0.5b": 464_118_784, "moe-probe": 3_000_000}
SCAN_TRIPS, SCAN_DIM = 5, 16

_REF_SCRIPT = r"""
import json, sys
import jax, jax.experimental
jax.experimental.enable_x64 = jax.enable_x64
from jax.experimental import pallas as pl
pl.load = lambda ref, idx: ref[idx]
def _store(ref, idx, val):
    ref[idx] = val
pl.store = _store

import jax.numpy as jnp
from repro.analysis import hlo, roofline
from repro.configs.base import SHAPES, ModelConfig

P = json.loads(sys.argv[1])
out = {}
x = jnp.ones((P["dim"], P["dim"]), jnp.float32)
w = jnp.ones((P["dim"], P["dim"]), jnp.float32)
scan = jax.jit(lambda x, w: jax.lax.scan(lambda c, _: (c @ w, None), x, None,
                                         length=P["trips"])[0])
out["hlo_flops"] = hlo.analyze_hlo(scan.lower(x, w).compile().as_text()).flops
out["model_flops"], out["active"] = {}, {}
for name, fields in P["configs"].items():
    cfg = ModelConfig(**fields)
    n = P["num_params"][name]
    act = roofline.active_params(cfg, n)
    out["active"][name] = act
    out["model_flops"][name] = {s: roofline.model_flops(cfg, shape, n, act)
                                for s, shape in SHAPES.items()}
out["shapes"] = {k: [v.name, v.seq_len, v.global_batch, v.kind, v.is_training]
                 for k, v in SHAPES.items()}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref():
    """The reference's counts, from one JAX subprocess."""
    params = json.dumps(dict(dim=SCAN_DIM, trips=SCAN_TRIPS, configs=CONFIGS,
                             num_params=NUM_PARAMS))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _REF_SCRIPT, params], env=env,
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"reference subprocess failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


# -- the cost counter ----------------------------------------------------------------------


def _scan(trips: int = SCAN_TRIPS, dim: int = SCAN_DIM, extra: bool = True):
    x, w = torch.ones(dim, dim), torch.ones(dim, dim)

    def program():
        y = x
        for _ in range(trips):
            y = y @ w
        if extra:
            torch.relu(y)  # the one op outside the loop

    return program


def test_count_cost_counts_every_trip_of_a_python_loop():
    cost = count_cost(_scan())
    # each trip: 2 * 16 * 16 * 16 FLOPs; operands read (2 * 1024 B), the
    # result written and read (2 * 1024 B); relu's result written and read
    assert cost.flops == 5 * 8192
    assert cost.bytes == 5 * (2 * 1024 + 2 * 1024) + 2 * 1024
    assert cost.rows["aten.mm"].calls == 5
    assert cost.flops_at_peak == {roofline.PEAK_F32: 5 * 8192}
    top = cost.top_costs(2)
    assert top["flops"] == [(5 * 8192.0, "aten.mm", 5)]
    assert [name for _, name, _ in top["bytes"]] == ["aten.mm", "aten.relu"]


def test_counted_flops_equal_the_reference_hlo_analysis(ref):
    """The same dot-only program, a scan of 5 matmuls: ``hlo.analyze_hlo``
    over the reference's compiled HLO (trip count parsed) against the
    dispatch mode's count of the port's Python loop."""
    assert count_cost(_scan(extra=False)).flops == ref["hlo_flops"] == 5 * 8192


def test_views_bill_nothing_and_writes_bill_their_region():
    a = torch.zeros(64, 8)
    idx = torch.tensor([1, 5, 9])

    def program():
        a.t()[:, 2:4]  # views
        a[4:6].index_select(0, torch.tensor([0]))  # a gather of a slice: its result
        a[idx] = torch.ones(3, 8)  # an indexed write: 3 rows
        a[10:12] = 1.0  # a fill of a slice: 2 rows

    cost = count_cost(program)
    for view in ("aten.t", "aten.slice"):
        assert cost.rows[view].bytes == 0
    assert cost.rows["aten.index_select"].bytes == 2 * 8 * 4
    assert cost.rows["aten.index_put_"].bytes == 2 * 3 * 8 * 4
    assert cost.rows["aten.fill_"].bytes == 2 * 2 * 8 * 4


def test_attention_score_buffers_are_counted():
    from repro_torch.models.attention import full_attention

    def scores(s):
        q = torch.zeros(1, s, 2, 8)
        return count_cost(lambda: full_attention(q, q, q, causal=True)).attn_score_bytes

    assert scores(512) == 0
    assert scores(1024) > 2 * 1024 * 1024 * 2 * 4  # [1, 2, 1024, 1024] float32, several times


def test_counter_is_thread_local_and_restored():
    costs = {}

    def work(name, trips):
        costs[name] = count_cost(_scan(trips, extra=False))

    threads = [threading.Thread(target=work, args=(f"t{i}", i + 1)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert {n: c.rows["aten.mm"].calls for n, c in costs.items()} == {
        f"t{i}": i + 1 for i in range(4)}
    assert getattr(_build.cost_counter, "active", None) is None


# -- the roofline --------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_model_flops_and_active_params_equal_the_reference(ref, name):
    cfg = ModelConfig(**CONFIGS[name])
    n = NUM_PARAMS[name]
    act = roofline.active_params(cfg, n)
    assert act == ref["active"][name]
    for s, shape in SHAPES.items():
        assert roofline.model_flops(cfg, shape, n, act) == ref["model_flops"][name][s], s


def test_shapes_equal_the_reference(ref):
    assert {k: [v.name, v.seq_len, v.global_batch, v.kind, v.is_training]
            for k, v in SHAPES.items()} == ref["shapes"]


def test_the_served_model_has_the_counted_parameters():
    assert build_model(get_config("qwen1.5-0.5b")).num_params() == NUM_PARAMS["qwen1.5-0.5b"]


def test_derive_is_pinned_to_the_h100():
    assert (roofline.HBM_BW, roofline.PEAK_F32, roofline.PEAK_F64, roofline.PEAK_BF16) == (
        3.35e12, 67e12, 34e12, 989e12)
    cfg = ModelConfig(**CONFIGS["qwen1.5-0.5b"])
    shape = ShapeConfig("prefill", 2048, 4, "prefill")
    cost = Cost(flops=989e10 + 67e9, bytes=3.35e9, attn_score_bytes=0.335e9,
                flops_at_peak={roofline.PEAK_BF16: 989e10, roofline.PEAK_F32: 67e9})
    rf = roofline.derive(cfg, shape, 10**9, cost)
    assert rf.compute_s == pytest.approx(0.011, rel=1e-12)
    assert rf.memory_s == pytest.approx(0.001, rel=1e-12)
    assert rf.memory_s_flash == pytest.approx(0.0009, rel=1e-12)
    assert (rf.collective_s, rf.collectives, rf.dominant) == (0.0, {}, "compute")
    assert rf.model_flops_per_device == 2.0 * 10**9 * 2048 * 4
    assert rf.useful_flops_fraction == pytest.approx(16.384e12 / (989e10 + 67e9), rel=1e-12)
    assert rf.step_time_s == rf.compute_s
    # the model's FLOPs at the peak of the dtype doing most of the work
    assert rf.mfu == pytest.approx(16.384e12 / 989e12 / 0.011, rel=1e-12)
    measured = roofline.derive(cfg, shape, 10**9, cost, step_time_s=0.05)
    assert measured.step_time_s == 0.05
    assert measured.mfu == pytest.approx(16.384e12 / 989e12 / 0.05, rel=1e-12)
    assert roofline.bound_ms(3.35e9, 67e9, roofline.PEAK_F32) == (1.0, "bytes")
    assert roofline.bound_ms(3.35e6, 67e12, roofline.PEAK_F32) == (1000.0, "operations")


def test_product_params_of_the_served_model():
    """The mfu's N: a prefill of 4 × 2048 tokens multiplies each token by the
    layers' matrices and unembeds 4 rows; a decode step unembeds every
    token, so its N is all parameters but the norms and the q/k/v biases."""
    cfg = get_config("qwen1.5-0.5b")
    model = build_model(cfg)
    params = tree_map(lambda d: torch.empty(d.shape, device="meta"), model.decls)
    L, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff
    layer = L * (4 * d * d + 3 * d * f)
    unembed = params["embed"]["tok"].numel()
    assert roofline.serving_gemm_flops(cfg, params, 8192, 4) == 2 * layer * 8192 + 2 * unembed * 4
    norms_and_biases = L * 2 * d + d + L * 3 * d
    assert roofline.serving_gemm_flops(cfg, params, 4, 4) / 8 == (
        NUM_PARAMS["qwen1.5-0.5b"] - norms_and_biases)


def test_roofline_re_exports_the_kernel_costs():
    for name in ("HBM_BW", "PEAK_F32", "PEAK_F64", "PEAK_BF16", "bound_ms", "peak_for",
                 "logreg_block_sub_cost", "flash_attention_cost", "what_if_replay_cost"):
        assert getattr(roofline, name) is getattr(kernel_costs, name), name


def test_the_kernels_layer_imports_nothing_above_it():
    """The wrappers reach their cost models without loading configs,
    experiments or launch: only ``analysis.kernel_costs`` (numpy)."""
    code = ("import sys, repro_torch.kernels; print(' '.join(sorted(m for m in sys.modules "
            "if m.startswith('repro_torch'))))")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120, check=True).stdout.split()
    below = ("repro_torch", "repro_torch.analysis", "repro_torch.analysis.kernel_costs")
    above = [m for m in out if not m.startswith("repro_torch.kernels") and m not in below]
    assert above == []


# -- the kernels' cost models against chip_smoke.py's former inline formulas ----------------


def _old_unique_rows(starts, widths, n):
    touched = np.zeros(n + 1, dtype=np.int64)
    np.add.at(touched, starts - 1, 1)
    np.add.at(touched, starts - 1 + widths, -1)
    return int(np.count_nonzero(np.cumsum(touched)[:n]))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kind,shape", [
    ("logreg", (100, 10, 10)), ("logreg", (40, 4, 2)), ("pca", (50, 5, 4)),
    ("pca", (50, 5, 40)), ("logreg", None), ("pca", None), ("logreg", "live")])
def test_block_sub_cost_models_equal_the_former_formulas(kind, shape):
    n, d, k = (16_384, 29, None) if kind == "logreg" else (50_000, 96, 3)
    if shape is None:  # the coded call: full-width windows
        S = 10 if kind == "logreg" else 4
        starts, widths = np.ones(S, np.int64), np.full(S, n, np.int64)
    elif shape == "live":  # the paper-scale live job: 100 groups of 160 rows
        n = 16_000
        starts, widths = 1 + 160 * np.arange(100, dtype=np.int64), np.full(100, 160, np.int64)
    else:
        if shape[0] == 40:
            n = 4096
        starts, widths = _chip_smoke().grid_tasks(n, *shape, np.random.default_rng(0))
    G = starts.size
    row_bytes = d * 4 + (4 if kind == "logreg" else 0)
    vb = G * d * (1 if k is None else k)
    nbytes = _old_unique_rows(starts, widths, n) * row_bytes + 2 * vb * 4 + 16 * G
    flops = int(widths.sum()) * ((4 * d + 5) if kind == "logreg" else 4 * d * k)
    got = (roofline.logreg_block_sub_cost(starts, widths, n, d) if kind == "logreg"
           else roofline.pca_block_sub_cost(starts, widths, n, d, k))
    assert got == (nbytes, flops, roofline.PEAK_F32)


@pytest.mark.parametrize("S,R,E,F,accepted", [
    (10, 200, 1000, 29, 1500), (4, 100, 250, 288, 300), (2, 10_000, 50_000, 29, 15_000)])
def test_cache_walk_cost_model_equals_the_former_formula(S, R, E, F, accepted):
    nbytes = (S * R * (1 + 8 + 8) + S * R * F * 8 + 2 * (S * F * 8 + S * E * F * 8
              + S * E * 8 + 2 * S * 8) + E * 8)
    assert roofline.grid_cache_update_cost(S, R, E, F, accepted) == (
        nbytes, accepted * F * 2, roofline.PEAK_F64)


@pytest.mark.parametrize("p,n,sz", [(100, 29, 4), (50, 192, 4), (8, 29, 4), (8, 1 << 20, 2)])
def test_dsag_update_cost_model_equals_the_former_formula(p, n, sz):
    assert roofline.dsag_cache_update_cost(p, n, sz) == (
        p * n * 3 * sz + 2 * n * 4 + p * 4, 6 * p * n, roofline.PEAK_F32)


@pytest.mark.parametrize("p,rows,b", [(100, 1, 29), (50, 64, 3)])
def test_int8_update_cost_model_equals_the_former_formula(p, rows, b):
    n = p * rows * b
    assert roofline.dsag_cache_update_int8_cost(p, rows, b) == (
        n * 4 + 4 * n + 4 * p * rows * 2 + 2 * rows * b * 4 + p, 20 * n, roofline.PEAK_F32)


@pytest.mark.parametrize("B,m,d,k", [(50, 1000, 64, 3), (1, 4096, 512, 8),
                                     (50, 1000, 1100, 3), (1, 4096, 64, 12)])
def test_gram_cost_model_equals_the_former_formula(B, m, d, k):
    assert roofline.gram_matvec_cost(B, m, d, k) == (
        (B * m * d + d * k + B * d * k) * 4, 4 * B * m * d * k, roofline.PEAK_F32)


@pytest.mark.parametrize("b,h,kvh,sq,sk,d", [
    (4, 16, 16, 2048, 2048, 64), (1, 4, 4, 1024, 1024, 128), (4, 16, 16, 1, 2085, 64),
    (4, 16, 16, 2085, 2085, 64), (4, 16, 2, 2048, 2048, 64)])
def test_flash_cost_model_equals_the_former_formula(b, h, kvh, sq, sk, d):
    offs = sk - sq
    pairs = sum(min(sk, q + offs + 1) for q in range(sq))
    assert roofline.flash_attention_cost(b, h, kvh, sq, sk, d, True, torch.bfloat16) == (
        (2 * b * h * sq * d + 2 * b * kvh * sk * d) * 2, 4 * b * h * d * pairs,
        roofline.PEAK_BF16)


@pytest.mark.parametrize("S,N,K,live,mask", [(10, 100, 100, 1000, False),
                                             (10, 100, 100, 795, True), (2, 40, 100, 68, True)])
def test_what_if_cost_model_equals_the_former_formula(S, N, K, live, mask):
    assert roofline.what_if_replay_cost(S, N, K, live, mask) == (
        S * N * K * 8 + S * N * 8 + (S * 8 if mask else 0), K * 7 * live, roofline.PEAK_F64)


# -- the wrappers' cost reports, without a card ----------------------------------------------


@pytest.fixture
def card_stub(monkeypatch):
    """The wrappers take their kernel path on CPU tensors: ``route`` says
    ``"launch"``, ``_build.launch`` runs ``fake_launch[name]`` (or nothing), and the
    streams and compiled constants are stubbed."""
    fakes = {}
    for mod in (block_sub, cache_events, dsag_update, gram_matvec, flash_attention, what_if):
        monkeypatch.setattr(mod, "route", lambda *t, **kw: "launch")
        monkeypatch.setattr(mod, "_stream", lambda dev: 0)
    monkeypatch.setattr(_build, "launch", lambda name, *a: fakes.get(name, lambda *b: None)(*a))
    monkeypatch.setattr(_build, "constant", lambda name: _build.LIMITS[name])
    monkeypatch.setattr(gram_matvec, "plan", lambda B, m, d, k, vec: block_sub.Plan(
        False, 1, m, 0, 0, 0))
    return fakes


def _copy_into(pointers, tensors):
    for ptr, t in zip(pointers, tensors):
        ctypes.memmove(ptr, t.contiguous().data_ptr(), t.numel() * t.element_size())


def _kernel_calls(rng, fakes):
    """Each wrapper's call on small CPU tensors, with its cost model's numbers."""
    f32 = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32)  # noqa: E731
    X, y = f32(64, 29), torch.sign(f32(64))
    starts, widths = torch.tensor([1, 17, 33]), torch.tensor([11, 16, 13])
    st, wd = starts.numpy(), widths.numpy()
    calls = {
        "logreg_block_sub": (
            lambda: block_sub.logreg_block_sub(X, y, f32(3, 29), starts, widths, 16),
            roofline.logreg_block_sub_cost(st, wd, 64, 29)),
        "pca_block_sub": (lambda: block_sub.pca_block_sub(X, f32(3, 29, 2), starts, widths, 16),
                          roofline.pca_block_sub_cost(st, wd, 64, 29, 2)),
        "dsag_cache_update": (lambda: dsag_update.dsag_cache_update(
            f32(4, 8), f32(4, 8), f32(8), torch.ones(4)), roofline.dsag_cache_update_cost(4, 8, 4)),
        "gram_matvec": (lambda: gram_matvec.gram_matvec(f32(2, 16, 8), f32(8, 3)),
                        roofline.gram_matvec_cost(2, 16, 8, 3)),
    }
    q8, s8 = torch.zeros(4, 2, 8, dtype=torch.int8), torch.ones(4, 2, dtype=torch.bfloat16)
    calls["dsag_cache_update_int8"] = (lambda: dsag_update.dsag_cache_update_int8(
        f32(4, 2, 8), q8, s8, q8, s8, f32(2, 8), torch.ones(4, dtype=torch.uint8)),
        roofline.dsag_cache_update_int8_cost(4, 2, 8))
    calls["dsag_int8_row_max"] = (lambda: dsag_update.dsag_int8_row_max(
        f32(4, 2, 8), q8, s8, q8, s8, torch.ones(4, dtype=torch.uint8)),
        roofline.dsag_int8_row_max_cost(4, 2, 8))
    q = f32(2, 4, 64, 64).to(torch.bfloat16)
    calls["flash_attention"] = (lambda: flash_attention.flash_attention_op(q, q, q),
                                roofline.flash_attention_cost(2, 4, 4, 64, 64, 64, True, q.dtype))
    total = torch.as_tensor(rng.uniform(1.0, 2.0, (2, 5, 7)))
    total[1, 3] = torch.inf  # a dead worker
    calls["what_if_replay"] = (lambda: what_if.what_if_replay(total, 3, 0.02),
                               roofline.what_if_replay_cost(2, 5, 7, 9, False))
    # K3: the fake launch writes the plain version's outputs, so the cost
    # model sees the walk's real accepted count
    S, R, E, F = 3, 6, 5, 4
    k3_args = (torch.as_tensor(rng.random((S, R)) < 0.8),
               torch.as_tensor(rng.integers(0, E, (S, R))),
               torch.as_tensor(rng.integers(0, 4, (S, R))),
               torch.as_tensor(rng.normal(size=(S, R, F))),
               torch.zeros(S, F, dtype=torch.float64), torch.zeros(S, E, F, dtype=torch.float64),
               torch.full((S, E), -1), torch.zeros(S, dtype=torch.int64),
               torch.zeros(S, dtype=torch.int64), torch.ones(E, dtype=torch.int64))
    want = cache_events.grid_cache_update_plain(*k3_args)
    fakes["dsag_grid_cache_update"] = lambda *a: _copy_into(a[10:15], want)
    accepted = int(k3_args[0].sum()) - int(want[4].sum())
    calls["grid_cache_update"] = (lambda: cache_events.grid_cache_update(*k3_args),
                                  roofline.grid_cache_update_cost(S, R, E, F, accepted))
    return calls


def test_every_wrapper_reports_its_cost_model(card_stub):
    calls = _kernel_calls(np.random.default_rng(0), card_stub)
    assert set(calls) == set(kernels.launch_counts())
    for name, (call, (nbytes, flops, peak)) in calls.items():
        cost = count_cost(call)
        row = cost.rows[name]
        assert (row.calls, row.bytes, row.flops) == (1, nbytes, flops), name
        assert cost.flops_at_peak.get(peak, 0) >= flops, name


def test_cost_reports_are_per_thread_and_free_without_a_counter(card_stub, monkeypatch):
    calls = _kernel_calls(np.random.default_rng(1), card_stub)
    got = {}

    def shard(name):
        got[name] = count_cost(calls[name][0])

    names = ["logreg_block_sub", "gram_matvec", "what_if_replay", "dsag_cache_update"]
    threads = [threading.Thread(target=shard, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for name in names:
        kernels = [r for r in got[name].rows if not r.startswith("aten.")]
        assert kernels == [name]
    # no counter: the launch is counted, the cost model never called
    for mod, model in ((block_sub, "logreg_block_sub_cost"), (what_if, "what_if_replay_cost")):
        monkeypatch.setattr(kernel_costs, model, lambda *a: pytest.fail("cost model called"))
    before = dict(block_sub.launch_counts)
    calls["logreg_block_sub"][0]()
    calls["what_if_replay"][0]()
    assert block_sub.launch_counts["logreg_block_sub"] == before["logreg_block_sub"] + 1


# -- a real model through the counter --------------------------------------------------------


def test_smoke_model_prefill_products_equal_the_analytic_count():
    """The smoke qwen on the CPU (plain attention): the counted product FLOPs
    are the layers' and the unembedding's (``roofline.serving_gemm_flops``)
    plus the plain attention's two einsums per layer."""
    cfg = get_smoke_config("qwen1.5-0.5b")
    model = build_model(cfg, kernel_backend="torch")
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen)
    b, s = 2, 32
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s)))
    with torch.inference_mode():
        cost = count_cost(lambda: model.prefill(params, {"tokens": tokens}, s + 4))
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    attention = cfg.num_layers * 2 * (2 * b * h * s * s * hd)
    analytic = roofline.serving_gemm_flops(cfg, params, b * s, b) + attention
    assert cost.flops_of("aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm") == analytic
    assert cost.flops == analytic
    assert cost.bytes > sum(t.numel() * t.element_size() for t in
                            (params["embed"]["tok"],))  # the weights are read


def test_lint_exports_cover_the_reference():
    tree = ast.parse((REPO / "src" / "repro" / "analysis" / "lint" / "__init__.py").read_text())
    names = next(
        [e.value for e in node.value.elts] for node in tree.body
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "__all__")
    from repro_torch.analysis import lint

    assert set(names) <= set(lint.__all__)
    for name in lint.__all__:
        assert getattr(lint, name) is not None
