"""The MoE family on a mesh: grok-1's ffn-sharded and deepseek-v2's
expert-parallel experts, MLA, served and trained under the reference's
production layouts.

The float32 smoke configs: grok-1-314b's (4 experts, so ffn-sharded, each
``model`` rank a share of every expert's hidden dim) and deepseek-v2-236b's
with ``num_experts=16``, replaced alike in both packages: its smoke config's
8 experts never reach expert-parallel mode (the reference's ``E % 16 ==
0``), so without the change that mode would go untested here.

* **``moe_apply`` against the reference's, jitted on (2, 4)** (the
  reference in ``tests/_ref_mesh_layouts.py``, on 8 fake XLA CPU devices
  with the jax-0.9 shim, one subprocess per arch, started with the module's
  first test and run beside the port's ranks): the batch split over ``data`` as one token
  stream, in three chunkings of it: whole chunks on each rank (2 chunks of
  a batch of 4), one chunk spanning both ranks (1 chunk), and chunks that
  straddle the ranks' boundary (3 chunks of a batch of 6); the reference
  runs all three.  At capacity factor 1.25 (tokens drop: the case's
  tokens share a direction, so that some experts overflow, which the test
  checks) and 8.0.  The output within 1e-5 of the largest, the aux within
  1e-5 relative, and the gradient of ``sum(out · w) + aux`` (the mean of the
  data ranks' gradients: each carries its own probabilities against the
  stream's expert counts) of every parameter and of ``x`` within 1e-5 of
  each one's largest, against the reference's ``moe_apply`` unsharded and
  jitted on the mesh; every token's experts equal the unsharded port's.
  Where chunks straddle the ranks (a chunk count above 1 that the data axis
  does not divide), the reference's mesh run is wrong: its output is not
  its own unsharded one (ROADMAP §3), which the test shows; the port's mesh
  run holds to the unsharded value there too.
* **The production step against the reference's jitted mesh step**:
  ``zero`` groups with int8 slots and adafactor on (2, 4) and ``pod``
  groups with int8 slots on (2, 2, 2), both archs, 2 steps with group 1
  missing the second; ``tests/test_torch_mesh_layouts.py``'s bounds (losses
  and per-group losses within 1e-5 relative, the parameters' relative RMS
  below 1e-4, every int8 payload within one step of its row's scale after
  the first step), and the router's parameters after step 1 within 1e-5
  relative RMS: a group's aux gradient off by the number of ranks that
  split its batch moves them by far more.
* **Against the unsharded port**, the same bounds: ``none`` and ``dp``
  groups (deepseek-v2) and ``dsag=False`` (grok-1), so every layout of
  ``make_group_spec`` runs the MoE; these run first, beside the reference.
* **Serving**: ``Server(mesh=)`` on (2, 2), prefill and 4 decode steps,
  both archs: tokens equal to the unsharded server's, each data rank's
  prefill logits within 1e-5.
* **Collectives** by site (``count_cost``): the EP combine's all-gather
  and the ffn down-projection's all-reduce (each once forward and once
  backward), the routing all-gather where a chunk spans ranks, and the
  aux's all-reduce.
* On the card (``gpu``): K6 at grok-1's rank-local prefill heads on
  (2, 2) (24 q heads over 4 kv heads, d = 128) and K4-int8's split form
  at an expert leaf's rows, against their plain twins.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import _mesh_ranks as ranks  # noqa: E402
from test_torch_mesh_layouts import (  # noqa: E402
    PROD,
    _held,
    _int8_args,
    _rel_rms,
    _split_update,
)

from repro_torch.checkpoint.checkpoint import train_state_tree  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core.dsag_pjit import GroupSpec, init_train_state, make_train_step  # noqa: E402
from repro_torch.data import make_batch_iterator  # noqa: E402
from repro_torch.launch.mesh import RankPool  # noqa: E402
from repro_torch.launch.serve import Server, stub_batch  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
#: arch -> its smoke config's replaced fields (module docstring)
ARCHS = {"grok-1-314b": {}, "deepseek-v2-236b": {"num_experts": 16}}
#: chunking -> (moe_dispatch_chunks, batch): whole chunks per data rank, one
#: chunk spanning both, chunks straddling the ranks' boundary
CHUNKINGS = {"whole": (2, 4), "spans": (1, 4), "straddles": (3, 6)}
MOE_SEQ = 16
MOE_CASES = {f"{arch.split('-')[0]}_{chunking}_cf{cf}": (arch, chunking, cf)
             for arch in ARCHS for chunking in CHUNKINGS for cf in (1.25, 8.0)}
#: name -> (arch, mesh shape, TrainConfig fields, groups)
REF_CASES = {
    f"{arch.split('-')[0]}_{name}": (arch, shape, fields, 2)
    for arch in ARCHS for name, shape, fields in (
        ("zero_int8_adafactor", (2, 4), dict(PROD, optimizer="adafactor", dsag_cache_dtype="int8",
                                             dsag_groups="zero", dsag_num_groups=2)),
        ("pod_int8", (2, 2, 2), dict(PROD, dsag_cache_dtype="int8", dsag_groups="pod")))}
PORT_CASES = {
    "deepseek_none": ("deepseek-v2-236b", (2, 4), dict(PROD, dsag_cache_dtype="float32",
                                                       dsag_groups="none"), 1),
    "grok_no_dsag": ("grok-1-314b", (2, 4), dict(PROD, dsag=False, dsag_groups="none"), 1),
    "deepseek_dp": ("deepseek-v2-236b", (2, 2, 2), dict(PROD, dsag_cache_dtype="float32",
                                                         dsag_groups="dp"), 4),
}
STEPS = 2
BATCH_PER_GROUP, SEQ = 4, 16
#: the router's parameters after step 1, relative RMS
ROUTER_RMS = 1e-5
#: moe_apply against the reference (module docstring)
MOE_TOL = 1e-5


def _cfg(arch: str, **fields):
    return ranks.smoke_model(arch, "float32", **ARCHS[arch], **fields)[0]


def _moe_inputs(name: str):
    """A case's parameters, tokens (sharing one direction, so that the
    router favours some experts, which overflow at capacity factor 1.25) and
    output weights."""
    arch, chunking, cf = MOE_CASES[name]
    nx, b = CHUNKINGS[chunking]
    cfg = _cfg(arch, moe_dispatch_chunks=nx)
    rng = np.random.default_rng(sum(map(ord, name)))
    params = {k: (rng.normal(size=d.shape) / np.sqrt(d.shape[-2])).astype(np.float32)
              for k, d in moe_mod.moe_decls(cfg).items()}
    x = (rng.normal(size=(b, MOE_SEQ, cfg.d_model))
         + 1.5 * rng.normal(size=cfg.d_model)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    return cfg, params, x, w, cf


def _inputs(arch: str, groups: int):
    """The step cases' batches and bits: every group fresh, then group 0
    alone."""
    it = make_batch_iterator(_cfg(arch), groups, groups * BATCH_PER_GROUP, SEQ)
    batches = [next(it) for _ in range(STEPS)]
    ones, zeros = np.ones(groups, bool), np.zeros(groups, bool)
    first = np.zeros(groups, bool)
    first[0] = True
    return batches, [(ones, zeros, zeros), (first, zeros, zeros)]


@pytest.fixture(scope="module", autouse=True)
def ref_proc(tmp_path_factory):
    """The reference's runs, in two subprocesses (one per arch: XLA compiles
    each step on one core) started with the module's first test (none where
    jax is not installed)."""
    if importlib.util.find_spec("jax") is None:
        yield None
        return
    tmp = tmp_path_factory.mktemp("ref_moe")
    procs = []
    for arch in ARCHS:
        _, model = ranks.smoke_model(arch, "float32", **ARCHS[arch])
        init = ranks.state_by_path({"params": model.init(torch.Generator().manual_seed(0))})
        arrays = {f"{arch}/{k}": v for k, v in init.items()}
        cases = {}
        for name, (a, shape, fields, groups) in REF_CASES.items():
            if a != arch:
                continue
            batches, masks = _inputs(arch, groups)
            for i, (b, m) in enumerate(zip(batches, masks)):
                arrays.update({f"{name}/batch{i}/{k}": v for k, v in b.items()})
                arrays[f"{name}/bits{i}"] = np.stack(m)
            cases[name] = {"arch": arch, "shape": list(shape), "tc": fields, "steps": STEPS,
                           "cfg": ARCHS[arch]}
        for name, (a, chunking, cf) in MOE_CASES.items():
            if a != arch:
                continue
            _, params, x, w, _ = _moe_inputs(name)
            arrays.update({f"{name}/p/{k}": v for k, v in params.items()})
            arrays.update({f"{name}/x": x, f"{name}/w": w})
            cases[name] = {"kind": "moe", "arch": arch, "shape": [2, 4], "cf": cf,
                           "cfg": dict(ARCHS[arch], moe_dispatch_chunks=CHUNKINGS[chunking][0])}
        d = tmp / arch
        d.mkdir()
        np.savez(d / "inputs.npz", **arrays)
        (d / "cases.json").write_text(json.dumps(cases))
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_backend_optimization_level=0")
        with open(d / "log.txt", "w") as log:
            proc = subprocess.Popen([sys.executable, str(REPO / "tests" / "_ref_mesh_layouts.py"),
                                     str(d / "inputs.npz"), str(d / "cases.json"),
                                     str(d / "out.npz")],
                                    env=env, stdout=log, stderr=subprocess.STDOUT)
        proc.out_path, proc.log_path = d / "out.npz", d / "log.txt"
        procs.append(proc)
    yield procs
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def ref(ref_proc):
    if ref_proc is None:
        pytest.fail("the reference needs jax, which is not installed")
    out = {}
    for proc in ref_proc:
        if proc.wait(timeout=900) != 0:
            raise RuntimeError(f"reference subprocess failed:\n"
                               f"{proc.log_path.read_text()[-4000:]}")
        with np.load(proc.out_path) as f:
            out.update({k: f[k] for k in f.files})
    return out


@pytest.fixture(scope="module")
def pool():
    """One gloo world of 8 CPU ranks: (2, 4) and (2, 2, 2) meshes over it,
    one intra-op thread each (they share the cores with the reference)."""
    with RankPool(8, "cpu", timeout=300) as p:
        p.run(ranks.set_threads, 1)
        yield p


def _unsharded_routes(cfg, params, x, cf):
    """The unsharded port's routed experts [b, s, k] and the (token,
    expert) pairs its capacity drops."""
    nx = moe_mod.dispatch_chunks(cfg, x.shape[0])
    t = x.shape[0] // nx * x.shape[1]
    p = {k: torch.as_tensor(v) for k, v in params.items()}
    _, _, gate_idx = moe_mod.route(cfg, p, torch.as_tensor(x).reshape(nx, t, -1))
    cap = moe_mod.capacity_of(cfg, t, cf)
    slot_of_pair = moe_mod._index_tables(gate_idx.reshape(nx, -1), cfg.num_experts,
                                         cfg.top_k, cap)[0]
    return (gate_idx.reshape(x.shape[0], x.shape[1], -1).numpy(),
            int((slot_of_pair == cfg.num_experts * cap).sum()))


def _close(got, want, what: str, tol: float = MOE_TOL) -> None:
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * float(np.max(np.abs(want))), (what, err, float(np.max(np.abs(want))))


# -- against the unsharded port (run while the reference computes) ----------------


def test_moe_configs_keep_their_modes():
    """The two smoke configs are in the two expert modes, with the specs
    that put them there."""
    from repro_torch.models.layers import make_rules

    grok, ds = _cfg("grok-1-314b"), _cfg("deepseek-v2-236b")
    assert not moe_mod._ep_mode(grok) and moe_mod._ep_mode(ds)
    assert make_rules(grok, True)["expert_mlp"] == "model" and make_rules(grok, True)[
        "expert"] is None
    assert make_rules(ds, True)["expert"] == "model"
    # the unreplaced smoke config's 8 experts are ffn-sharded
    assert not moe_mod._ep_mode(get_smoke_config("deepseek-v2-236b"))


def _unsharded(arch, fields, groups, batches, masks):
    _, model = ranks.smoke_model(arch, "float32", **ARCHS[arch])
    tc = TrainConfig(**fields)
    gs = GroupSpec(groups, ())
    step = make_train_step(lambda p, b: model.train_loss(p, b, remat=tc.remat), tc, gs,
                           backend="torch", layout=model.layout)
    state = init_train_state(model.layout.flatten(model.init(torch.Generator().manual_seed(0))),
                             tc, gs, model.layout)
    out, states = [], []
    for b, m in zip(batches, masks):
        state, met = step(state, {k: torch.as_tensor(v) for k, v in b.items()},
                          *(torch.as_tensor(x) for x in m))
        out.append({k: np.asarray(v) for k, v in met.items()})
        states.append(ranks.state_by_path(train_state_tree(state, model.layout)))
    return out, states


@pytest.mark.parametrize("name", PORT_CASES)
def test_moe_mesh_layouts_equal_the_unsharded_port(pool, name):
    arch, shape, fields, groups = PORT_CASES[name]
    batches, masks = _inputs(arch, groups)
    got, states, _ = pool.run(ranks.layout_run, arch, TrainConfig(**fields), shape, batches,
                              masks, 0, ARCHS[arch])[0]
    want, want_states = _unsharded(arch, fields, groups, batches, masks)
    _held(got, states, want, want_states, name, fields)
    assert _router_rms(states[0], want_states[0]) < ROUTER_RMS, name


@pytest.fixture(scope="module")
def pool4():
    """A gloo world of 4 CPU ranks, for (2, 2)."""
    with RankPool(4, "cpu", timeout=300) as p:
        p.run(ranks.set_threads, 2)
        yield p


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_server_on_a_mesh_equals_the_unsharded_server(pool4, arch):
    """``Server(mesh=)`` on (2, 2) (deepseek-v2's MLA cache split over its
    sequence on ``model``): the whole batch's tokens and every data rank's
    prefill logits against the unsharded server's."""
    import repro_torch.launch.serve as serve_mod

    cfg = _cfg(arch)
    batch = stub_batch(cfg, 4, 12, seed=3)
    got = pool4.run(ranks.serve, arch, "float32", (2, 2), batch, 5, 32, 0, ARCHS[arch])
    with mock.patch.object(serve_mod, "get_smoke_config", lambda a: _cfg(a)):
        srv = Server(arch, device="cpu", kernel_backend="torch", max_len=32, dtype="float32")
    want = srv.generate(batch, 5).numpy()
    with torch.inference_mode():
        logits, _ = srv.model.prefill(srv.params, {"tokens": torch.as_tensor(
            batch["tokens"]).to(torch.int32)}, cache_len=32)
    logits = logits.float().numpy()
    for r, (toks, got_logits, _) in enumerate(got):
        assert np.array_equal(toks, want), (arch, r)
        d = r // 2  # rank r's data coordinate on (2, 2)
        _close(got_logits, logits[2 * d:2 * d + 2], f"{arch} rank {r} logits")


# -- against the reference -----------------------------------------------------------


@pytest.mark.parametrize("name", MOE_CASES)
def test_moe_apply_on_a_mesh_equals_the_reference(pool, ref, name):
    cfg, params, x, w, cf = _moe_inputs(name)
    arch, chunking, _ = MOE_CASES[name]
    got = pool.run(ranks.moe_layer, arch, dict(ARCHS[arch], moe_dispatch_chunks=cfg.
                                                moe_dispatch_chunks), (2, 4), params, x, w, cf)[0]
    gate_idx, dropped = _unsharded_routes(cfg, params, x, cf)
    assert (dropped > 0) == (cf == 1.25), (name, dropped)
    assert np.array_equal(got["gate_idx"], gate_idx), name

    def held(tag):
        pre = f"{name}/{tag}"
        _close(got["out"], ref[f"{pre}/out"], f"{pre} out")
        np.testing.assert_allclose(got["aux"], float(ref[f"{pre}/aux"]), rtol=MOE_TOL,
                                   err_msg=pre)
        _close(got["dx"], ref[f"{pre}/dx"], f"{pre} dx")
        for k, g in got["grads"].items():
            _close(g, ref[f"{pre}/grad/{k}"], f"{pre} grad {k}")

    held("plain")
    if chunking == "straddles":
        # the reference's mesh compile is wrong here (ROADMAP §3): its output
        # on the mesh is not its own unsharded one, the port's mesh run is
        with pytest.raises(AssertionError):
            _close(ref[f"{name}/mesh/out"], ref[f"{name}/plain/out"], f"{name} reference")
    else:
        held("mesh")
    # the collectives by site: the experts' mode, the routing gather only
    # where a chunk does not lie on one rank
    sites = set(got["sites"])
    mode = "moe EP combine: all-gather" if arch.startswith("deepseek") else (
        "moe ffn all-reduce: all-reduce")
    assert {mode, "moe aux: all-reduce"} <= sites, (name, sorted(sites))
    # the experts' collective runs once each way: forward and backward
    assert got["site_counts"][mode] == 2, (name, got["site_counts"])
    assert ("moe routing gather: all-gather" in sites) == (chunking != "whole"), name


def _router_rms(got_state: dict, want_state: dict) -> float:
    keys = [k for k in want_state if k.startswith("['params']") and "router" in k]
    assert keys
    return _rel_rms(got_state, want_state, keys)


@pytest.mark.parametrize("name", REF_CASES)
def test_moe_mesh_step_equals_the_reference_jitted_step(pool, ref, name):
    arch, shape, fields, groups = REF_CASES[name]
    batches, masks = _inputs(arch, groups)
    got, states, sites = pool.run(ranks.layout_run, arch, TrainConfig(**fields), shape, batches,
                                  masks, 0, ARCHS[arch])[0]
    pre = f"{name}/"
    want = [{k.split("/")[-1]: ref[k] for k in ref if k.startswith(f"{pre}metrics{i}/")}
            for i in range(STEPS)]
    want_states = [{k[len(f"{pre}state{i}/"):]: v for k, v in ref.items()
                    if k.startswith(f"{pre}state{i}/")} for i in range(STEPS)]
    _held(got, states, want, want_states, name, fields)
    assert _router_rms(states[0], want_states[0]) < ROUTER_RMS, name
    assert {"moe aux: all-reduce", "moe routing gather: all-gather"} <= set(sites), name


# -- on the card -------------------------------------------------------------------------


@pytest.mark.gpu
def test_gpu_k6_at_grok_rank_local_heads_equals_plain():
    """K6 at grok-1's rank-local prefill on (2, 2): 48 / 2 = 24 q heads over
    8 / 2 = 4 kv heads at d = 128, bf16, against the plain attention."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.flash_attention import flash_attention_bshd
    from repro_torch.models.attention import full_attention

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((2, 512, h, 128), generator=g, device="cuda").to(torch.bfloat16)
               for h in (24, 4, 4))
    got = flash_attention_bshd(q, k, v, causal=True).float()
    rep = lambda t: t.repeat_interleave(6, dim=2).float()  # noqa: E731
    want = full_attention(q.float(), rep(k), rep(v), causal=True)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 2e-2


@pytest.mark.gpu
def test_gpu_k4_int8_split_form_at_an_expert_leaf():
    """K4-int8's split form at an expert leaf's rows: ``chip_smoke.py``
    phase 19 (c)'s largest split launch, grok-1's ``w_down`` at its reduced
    widths under ``zero`` on (2, 2) (2 groups; 2 layers x 8 experts x 1536
    rows, its d_ff over ``model``; rows of 1024, d_model over ``data``),
    split in 2, against the plain twins."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import dsag_update as k4

    args = _int8_args(np.random.default_rng(19), 2, 2 * 8 * 1536, 1024)
    on_card = tuple(a.cuda() for a in args)
    got = _split_update(on_card, 2, k4.dsag_int8_row_max, k4.dsag_cache_update_int8)
    want = _split_update(args, 2, k4.dsag_int8_row_max_plain, k4.dsag_cache_update_int8_plain)
    assert all(torch.equal(a.cpu(), w) for a, w in zip(got, want))
