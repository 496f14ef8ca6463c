"""The mesh path of the port (``models/sharding.py``, the spec helpers,
``degather``, the mesh train step, ``Server(mesh=)``, sharded checkpoints)
against the reference and against the unsharded port.

* **Specs** (one reference subprocess with the jax-0.9 shim, started with
  the module's first test): ``make_rules`` and ``param_specs(fsdp)`` leaf by
  leaf for all ten archs, ``cache_specs`` without a mesh and on the
  ``(data, model)`` and ``(pod, data, model)`` axes, ``_ep_mode``,
  ``strip_axis``, ``opt_state_specs`` / ``dsag_state_specs`` /
  ``train_state_specs`` (adamw, adafactor, sgd; bf16 and int8 slots),
  ``batch_group_specs``, and ``make_group_spec`` on (16, 16), (2, 16, 16)
  and (2, 4) meshes under every ``dsag_groups``: equal.
* **Runs** on a (2, 4) mesh of 8 gloo ranks on the CPU, one world for the
  whole module (``RankPool``; the rank side is ``tests/_mesh_ranks.py``),
  qwen2-7b's smoke config (the reference's own mini dry run,
  ``tests/test_system.py``) in float32 with float32 slots:
  ``TrainConfig(dsag=True, dsag_groups="dp", fsdp=True)``, 2 steps, group 1
  masked at the second, against the unsharded port's step on the same
  inputs.  The losses, per-group losses, ξ and mask counts agree within
  1e-5 (relative), the gradient norm too, and the parameters' relative RMS
  difference over all leaves is below 1e-5: the sharded step sums the TP
  partial products, H's per-group deltas and the norm's squares in another
  order, so float32 rounding (not bits) separates them.  With
  ``quantized_fsdp_allgather`` the degathered bf16 weights equal
  ``dequantize(quantize(w))`` (one block per row) bit for bit, and float32
  leaves and vectors gather unchanged, as the reference's rule says.
* **Serving**: ``Server(mesh=)`` (K6's plain version on the CPU) generates
  the unsharded server's tokens (prefill and 3 decode steps), and its
  prefill logits agree within 1e-5 of their largest magnitude.
* **Checkpoints**: a state placed on the mesh is saved (gathered, rank 0
  writes) and restored with ``shardings=``: every rank's shard comes back
  bit for bit, and the file equals the one an unsharded save writes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import _mesh_ranks as ranks  # noqa: E402

from repro_torch.checkpoint.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.configs.base import MeshConfig, TrainConfig  # noqa: E402
from repro_torch.core.dsag_pjit import (  # noqa: E402
    GroupSpec,
    batch_group_specs,
    dsag_state_specs,
    init_train_state,
    make_group_spec,
    make_train_step,
    opt_state_specs,
    train_state_specs,
)
from repro_torch.experiments.engine import CAP_MESH, EngineCapabilityError  # noqa: E402
from repro_torch.launch.mesh import RankPool, make_production_mesh  # noqa: E402
from repro_torch.launch.serve import Server, stub_batch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.layers import make_rules  # noqa: E402
from repro_torch.models.model import cache_specs, check_mesh  # noqa: E402
from repro_torch.models.moe import _ep_mode  # noqa: E402
from repro_torch.models.sharding import P, set_mesh, strip_axis  # noqa: E402
from repro_torch.optim.compression import Quantized, dequantize, quantize  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARCH = "qwen2-7b"
SHAPE = (2, 4)
TC = TrainConfig(dsag=True, dsag_groups="dp", fsdp=True, dsag_cache_dtype="float32")
#: float32 agreement of the sharded and unsharded runs (module docstring)
RTOL = 1e-5
GROUP_MESHES = {"16x16": ((16, 16), ("data", "model")),
                "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
                "2x4": ((2, 4), ("data", "model"))}
STRIP_CASES = [P("data", "model"), P(("pod", "data"), None, "model"), P(None, ("data",)),
               P(("data", "model"), "data")]

_SHIM = r"""
import json, sys, types
import jax, jax.experimental
jax.experimental.enable_x64 = jax.enable_x64
from jax.experimental import pallas as pl
pl.load = lambda ref, idx: ref[idx]
def _store(ref, idx, val):
    ref[idx] = val
pl.store = _store
"""

_REF_SCRIPT = _SHIM + r"""
import numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs import get_config
from repro.configs.base import TrainConfig
from repro.core import dsag_pjit as D
from repro.models import build_model, sharding
from repro.models.layers import make_rules
from repro.models.model import cache_specs
from repro.models.moe import _ep_mode
from repro.optim.compression import Quantized

A = {params}

def ser(x):
    if isinstance(x, dict):
        return {{k: ser(v) for k, v in x.items()}}
    if isinstance(x, Quantized):
        return {{"q": ser(x.q), "scale": ser(x.scale)}}
    if isinstance(x, P):
        return [list(e) if isinstance(e, tuple) else e for e in x]
    return x

def mesh(shape, axes):
    return types.SimpleNamespace(axis_names=tuple(axes), devices=np.empty(shape))

out = {{"archs": {{}}, "groups": {{}}, "strip": [ser(sharding.strip_axis(P(*s))) for s in A["strip"]]}}
for arch in A["archs"]:
    cfg = get_config(arch)
    model = build_model(cfg)
    r = out["archs"][arch] = {{"rules": {{str(f): make_rules(cfg, f) for f in (False, True)}},
                              "params": {{str(f): ser(model.param_specs(f)) for f in (False, True)}},
                              "ep": bool(_ep_mode(cfg)) if cfg.num_experts else None,
                              "cache": {{}}, "state": {{}}}}
    for name, (shape, axes) in A["cache_meshes"].items():
        sharding.set_mesh(None if shape is None else mesh(shape, axes))
        r["cache"][name] = ser(cache_specs(cfg))
    sharding.set_mesh(None)
    specs = model.param_specs(True)
    for opt in ("adamw", "adafactor", "sgd"):
        for dt in ("bfloat16", "int8"):
            tc = TrainConfig(optimizer=opt, dsag_cache_dtype=dt)
            gs = D.make_group_spec(tc, mesh((2, 4), ("data", "model")))
            r["state"][opt + "/" + dt] = ser(D.train_state_specs(tc, gs, specs))
for name, (shape, axes) in A["group_meshes"].items():
    for groups in ("dp", "pod", "zero", "none"):
        for dsag in (True, False):
            gs = D.make_group_spec(TrainConfig(dsag=dsag, dsag_groups=groups), mesh(shape, axes))
            out["groups"][f"{{name}}/{{groups}}/{{dsag}}"] = [gs.num_groups, list(gs.axes),
                                                           ser(D.batch_group_specs(gs, (None, "model")))]
print(json.dumps(out))
"""


def _ser(x):
    if isinstance(x, dict):
        return {k: _ser(v) for k, v in x.items()}
    if isinstance(x, Quantized):
        return {"q": _ser(x.q), "scale": _ser(x.scale)}
    if isinstance(x, P):
        return [list(e) if isinstance(e, tuple) else e for e in x]
    return x


CACHE_MESHES = {"none": (None, None), "dm": ((2, 4), ("data", "model")),
                "pdm": ((2, 2, 4), ("pod", "data", "model"))}


@pytest.fixture(scope="module", autouse=True)
def ref_proc():
    """The reference's spec trees, computed in a subprocess started with the
    module's first test (none where jax is not installed)."""
    if importlib.util.find_spec("jax") is None:
        yield None
        return
    params = dict(archs=list(ARCHS), cache_meshes=CACHE_MESHES, group_meshes=GROUP_MESHES,
                  strip=[tuple(s) for s in STRIP_CASES])
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", _REF_SCRIPT.format(params=repr(params))],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ref(ref_proc):
    if ref_proc is None:
        pytest.fail("the reference needs jax, which is not installed")
    out, err = ref_proc.communicate(timeout=600)
    if ref_proc.returncode != 0:
        raise RuntimeError(f"reference subprocess failed:\n{err[-4000:]}")
    return json.loads(out)


@pytest.fixture(scope="module")
def pool():
    """One gloo world of 8 CPU ranks for the module's mesh runs."""
    with RankPool(SHAPE[0] * SHAPE[1], "cpu", timeout=300) as p:
        yield p


# -- specs against the reference -------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_equal_the_reference(ref, arch):
    cfg = get_config(arch)
    model = build_model(cfg, kernel_backend="torch")
    want = ref["archs"][arch]
    for fsdp in (False, True):
        assert make_rules(cfg, fsdp) == want["rules"][str(fsdp)]
        assert _ser(model.param_specs(fsdp)) == want["params"][str(fsdp)]
    assert (bool(_ep_mode(cfg)) if cfg.num_experts else None) == want["ep"]
    try:
        for name, (shape, axes) in CACHE_MESHES.items():
            set_mesh(None if shape is None else MeshConfig(shape, axes))
            assert _ser(cache_specs(cfg)) == want["cache"][name], name
    finally:
        set_mesh(None)
    specs = model.param_specs(True)
    for opt in ("adamw", "adafactor", "sgd"):
        for dt in ("bfloat16", "int8"):
            tc = TrainConfig(optimizer=opt, dsag_cache_dtype=dt)
            gs = make_group_spec(tc, MeshConfig((2, 4), ("data", "model")))
            assert _ser(train_state_specs(tc, gs, specs)) == want["state"][f"{opt}/{dt}"]
            assert train_state_specs(tc, gs, specs)["opt"] == opt_state_specs(tc, specs)
            assert train_state_specs(tc, gs, specs)["dsag"] == dsag_state_specs(tc, gs, specs)


@pytest.mark.parametrize("mesh", GROUP_MESHES)
def test_group_specs_and_strip_axis_equal_the_reference(ref, mesh):
    shape, axes = GROUP_MESHES[mesh]
    for groups in ("dp", "pod", "zero", "none"):
        for dsag in (True, False):
            gs = make_group_spec(TrainConfig(dsag=dsag, dsag_groups=groups),
                                 MeshConfig(shape, axes))
            got = [gs.num_groups, list(gs.axes), _ser(batch_group_specs(gs, (None, "model")))]
            assert got == ref["groups"][f"{mesh}/{groups}/{dsag}"], (groups, dsag)
    assert [_ser(strip_axis(s)) for s in STRIP_CASES] == ref["strip"]


def test_tp_contract_takes_the_reduce_dtype():
    """``tp_contract`` is the plain einsum, and with a reduce dtype set (the
    reference's ``bf16_reduce``) its product comes out in that dtype."""
    from repro_torch.models.layers import set_tp_reduce_dtype, tp_contract

    x, w = torch.randn(2, 3, 4), torch.randn(4, 5)
    assert torch.equal(tp_contract("bsf,fd->bsd", x, w), torch.einsum("bsf,fd->bsd", x, w))
    set_tp_reduce_dtype("bfloat16")
    try:
        out = tp_contract("bsf,fd->bsd", x, w)
    finally:
        set_tp_reduce_dtype(None)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, torch.einsum("bsf,fd->bsd", x, w).to(torch.bfloat16))


def test_production_meshes_over_a_fake_world():
    """``make_production_mesh`` builds the reference's shapes and axis names
    over a process group of 256 (512) ranks: the ``fake`` backend, one
    process standing for rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    for multi, shape, axes in ((False, (16, 16), ("data", "model")),
                               (True, (2, 16, 16), ("pod", "data", "model"))):
        torch.distributed.init_process_group("fake", store=FakeStore(), rank=0,
                                             world_size=int(np.prod(shape)))
        try:
            mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
            assert tuple(mesh.shape) == shape and mesh.mesh_dim_names == axes
        finally:
            torch.distributed.destroy_process_group()


def test_what_is_not_a_mesh_and_what_a_mesh_does_not_run_are_refused():
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_group_spec(TrainConfig(), mesh=object())
    for arch in ("grok-1-314b", "deepseek-v2-236b"):
        with pytest.raises(EngineCapabilityError) as e:
            check_mesh(get_config(arch))
        assert e.value.capability.code == CAP_MESH and "bincount" in str(e.value)
    for arch in ARCHS:
        if not get_config(arch).num_experts:
            check_mesh(get_config(arch))


# -- runs on a (2, 4) gloo mesh -----------------------------------------------------------------


def _inputs(cfg):
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (2, 2, 16))} for _ in range(2)]
    masks = [(np.array([1, 1], bool), np.zeros(2, bool), np.zeros(2, bool)),
             (np.array([1, 0], bool), np.zeros(2, bool), np.zeros(2, bool))]
    return batches, masks


def _unsharded(model, tc, batches, masks, loss=None):
    step = make_train_step(loss or (lambda p, b: model.train_loss(p, b, remat=tc.remat)), tc,
                           GroupSpec(2, ()), backend="torch", layout=model.layout)
    state = init_train_state(model.layout.flatten(model.init(torch.Generator().manual_seed(0))),
                             tc, GroupSpec(2, ()), model.layout)
    out = []
    for b, m in zip(batches, masks):
        state, met = step(state, {k: torch.as_tensor(v) for k, v in b.items()},
                          *(torch.as_tensor(x) for x in m))
        out.append({k: np.asarray(v) for k, v in met.items()})
    return out, {"/".join(k): np.asarray(v.float())
                 for k, v in ranks._flat(model.layout.tree(state["params"], cast=True))}


def _rel_rms(got: dict, want: dict) -> float:
    d = sum(float(np.sum((got[k] - want[k]) ** 2)) for k in want)
    n = sum(float(np.sum(want[k] ** 2)) for k in want)
    return (d / n) ** 0.5


def test_sharded_train_step_equals_the_unsharded_step(pool):
    cfg, model = ranks.smoke_model(ARCH, "float32")
    batches, masks = _inputs(cfg)
    got, params = pool.run(ranks.train_steps, ARCH, "float32", TC, SHAPE, batches, masks)[0]
    want, want_params = _unsharded(model, TC, batches, masks)
    for g, w in zip(got, want):
        for key in ("loss", "per_group_loss", "xi", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=RTOL, atol=0, err_msg=key)
        assert int(g["mask_count"]) == int(w["mask_count"])
    assert float(got[1]["xi"]) == 1.0 and int(got[1]["mask_count"]) == 1
    assert set(params) == set(want_params)
    assert _rel_rms(params, want_params) < RTOL


def test_trainer_on_a_mesh_replays_into_the_unsharded_step(pool):
    """``Trainer(TrainerOptions(mesh=))``: its own Tier-2 decisions (a
    stale flush among them) replayed through the unsharded step on its
    batches give its losses and parameters within the float32 bound."""
    from repro_torch.data import make_batch_iterator

    got, params = pool.run(ranks.trainer_run, ARCH, "float32", TC, SHAPE, 3, 4, 16)[0]
    assert any(f.any() for f in got["flush_stream"])
    cfg, model = ranks.smoke_model(ARCH, "float32")
    it = make_batch_iterator(cfg, 2, 4, 16, seed=0)
    batches = [next(it) for _ in range(3)]
    masks = list(zip(got["mask_stream"], got["flush_stream"], got["evict_stream"]))
    want, want_params = _unsharded(model, TC, batches, masks)
    np.testing.assert_allclose(got["loss"], [float(w["loss"]) for w in want], rtol=RTOL)
    assert got["xi"] == [float(w["xi"]) for w in want]
    assert _rel_rms(params, want_params) < RTOL


def test_quantized_allgather_gathers_the_dequantized_rows(pool):
    """bf16 weights of 2+ dims come back as ``dequantize(quantize(w))`` with
    one block per (whole) row, bit for bit; float32 leaves and vectors
    gather as they are; without quantization every leaf is unchanged."""
    cfg, model = ranks.smoke_model(ARCH, "bfloat16")
    full = {"/".join(k): v for k, v in ranks._flat(model.init(torch.Generator().manual_seed(0)))}
    for quantized in (False, True):
        got = pool.run(ranks.degathered, ARCH, "bfloat16", SHAPE, True, quantized)[0]
        for key, w in full.items():
            want = w
            if quantized and w.dim() >= 2 and w.dtype != torch.float32:
                want = dequantize(quantize(w, block=w.shape[-1]), w.dtype)
            assert np.array_equal(got[key], want.float().numpy()), (quantized, key)


def test_quantized_train_step_equals_the_unsharded_step_on_dequantized_weights(pool):
    """With ``quantized_fsdp_allgather`` the step differentiates at the
    dequantized weights and updates the stored ones (straight through):
    the unsharded step whose loss sees ``dequantize(quantize(w))`` through a
    straight-through estimator is the same step.  The model is bf16 (float32
    leaves skip the int8 gather), so the two runs agree within bf16
    rounding of the TP partial sums: losses within 2e-2 relative, the
    parameters' relative RMS within 1e-2."""
    cfg, model = ranks.smoke_model(ARCH, "bfloat16")
    tc = dataclasses.replace(TC, quantized_fsdp_allgather=True)
    batches, masks = _inputs(cfg)
    got, params = pool.run(ranks.train_steps, ARCH, "bfloat16", tc, SHAPE, batches, masks)[0]

    def st(w):
        if w.dim() < 2 or w.dtype == torch.float32:
            return w
        return w + (dequantize(quantize(w.detach(), block=w.shape[-1]), w.dtype) - w).detach()

    def loss(p, b):
        from repro_torch.models.layers import tree_map

        return model.train_loss(tree_map(st, p), b, remat=tc.remat)

    want, want_params = _unsharded(model, tc, batches, masks, loss)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["per_group_loss"], w["per_group_loss"], rtol=2e-2)
    assert _rel_rms(params, want_params) < 1e-2


def test_sharded_server_equals_the_unsharded_server(pool):
    srv = Server(ARCH, device="cpu", kernel_backend="torch", max_len=40, dtype="float32")
    batch = stub_batch(srv.cfg, 4, 12, seed=1)
    got = pool.run(ranks.serve, ARCH, "float32", SHAPE, batch, 4, 37)
    toks, _, max_len = got[0]
    assert max_len == 40  # 37 rounded up to the model axis
    assert np.array_equal(toks, srv.generate(batch, 4).numpy())
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    with torch.inference_mode():
        want, _ = srv.model.prefill(srv.params, b, cache_len=40)
    logits = np.concatenate([got[0][1], got[SHAPE[1]][1]])  # the two data ranks' halves
    np.testing.assert_allclose(logits, want.numpy(), rtol=0,
                               atol=RTOL * float(np.abs(want.numpy()).max()))


def test_kernels_refuse_a_dtensor(pool):
    """A kernel wrapper given DTensors raises: it never takes its plain
    version for them (a mesh run hands the kernels local shards)."""
    for msg in pool.run(ranks.kernels_refuse_dtensors, SHAPE)[0]:
        assert msg is not None and "local shard" in msg


def test_collectives_of_a_sharded_step_are_counted(pool):
    """``count_cost`` sees each rank's collectives: the degather's
    all-gathers, H's reduce-scatters and the TP all-reduces."""
    cfg, _ = ranks.smoke_model(ARCH, "float32")
    batch = {"tokens": np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 2, 16))}
    counts, wire, flops = pool.run(ranks.counted_step, ARCH, "float32", TC, SHAPE, batch,
                                   np.ones(2, bool))[0]
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= set(counts)
    assert all(wire[k] > 0 for k in counts) and flops > 0


def test_sharded_checkpoint_round_trips(pool, tmp_path):
    path, same = pool.run(ranks.checkpoint_round_trip, ARCH, SHAPE, str(tmp_path / "mesh"))[0]
    assert same
    _, model = ranks.smoke_model(ARCH, "bfloat16")
    plain = save_checkpoint(str(tmp_path / "plain"), 3,
                            {"params": model.init(torch.Generator().manual_seed(0))})
    with np.load(os.path.join(path, "arrays.npz")) as a, \
            np.load(os.path.join(plain, "arrays.npz")) as b:
        assert a.files == b.files and all(np.array_equal(a[f], b[f]) for f in a.files)
