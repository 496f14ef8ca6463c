"""The model zoo's DSAG training path held against the JAX reference, on the CPU.

The reference runs in ONE subprocess for this module (``_REF_SCRIPT``), under
the jax-0.9 shim of ``tests/test_torch_serve.py``, started with the module's
first test so that the port-only tests run beside it; it builds every input
from numpy seeds (the parameters and initial train states from the
reference's own ``Model.init`` / ``Trainer.init_state``) and writes inputs
and outputs to an ``.npz``.  This process never imports ``jax`` or
``repro``.  Everything runs at qwen1.5-0.5b's smoke config (2 layers,
d_model 64, vocab 512) in float32 unless a test says otherwise.

Tolerances, and why:

* ``Model.train_loss`` (fused and unfused; remat none, full and selective),
  the chunked fused loss: float32 products summed in another order,
  ``rtol=1e-5``.
* Per-group gradients against ``vmap(value_and_grad)``, leaf by leaf
  through the layout: ``rtol=1e-4`` plus ``atol = 1e-4 * max|ref|`` of the
  leaf (a backward sums over the batch and sequence in another order; a
  tiny element is a difference of large terms: measured, 6e-7 absolute
  where the leaf's largest is 1.4e-2), as ``tests/test_torch_serve.py``
  holds the smoke models' float32 outputs.  Per-group losses
  ``rtol=1e-5``.
* Batches of ``data/pipeline.py`` (LM, VLM, enc-dec): bit-equal.
* 10 trainer steps with replayed traces (dsag and sag with sgd, float32
  slots; adamw and adafactor with dsag; int8 slots with sgd): mask, flush
  and evict streams, ξ and ``mask_count`` exact.  Losses and the final
  parameters (the relative RMS difference ``||p - p_ref|| / ||p_ref||``)
  within ``RUN_TOL``: sgd ``rtol=1e-6`` and 1e-6 (measured 1.5e-7 and
  7e-9); int8 slots 1e-6 and 1e-5 (measured 8e-8 and 5e-8: a gradient
  that differs in its last bits could move a quantization step).  adamw
  and adafactor divide each gradient by its own RMS, so an element whose
  gradient is a float32 rounding away from zero moves by up to the step
  size either way, and the smoke model's random init (the reference scales
  stacked projections by ``1/sqrt(L)``) makes the gradients' rounding
  ~1e-5 relative: adamw ``rtol=2e-3`` and 3e-3 (measured 4.8e-4 and
  6.9e-4), adafactor ``rtol=3e-3`` and 1e-2 (measured 7.9e-4 and 2.7e-3).
  :func:`test_flat_optimizers_equal_per_leaf` holds the optimizers' flat
  walk against the per-leaf one bit for bit.
* A checkpoint the reference's trainer wrote (bf16 model, bf16 slots)
  restores into leaves bit-equal to the file's; the port's own save →
  restore round trip gives the state back bit for bit, and the next step
  from it equals the next step from the state in memory.

Tests marked ``gpu`` run the path on the card against the CPU and skip
without one (``pytest -m gpu tests/test_torch_train_lm.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.checkpoint.checkpoint import (
    _flatten_with_paths,
    train_state_from_tree,
    train_state_tree,
)
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.dsag_pjit import (
    CAP_GROUP_GRAD,
    GroupSpec,
    autograd_group_value_and_grad,
    make_train_step,
)
from repro_torch.data import make_batch_iterator
from repro_torch.experiments.engine import CAP_ARCH, EngineCapabilityError, EngineConfig
from repro_torch.kernels import flash_attention as k6
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch.train import Trainer, TrainerOptions
from repro_torch.models import build_model
from repro_torch.models.layers import apply_norm, get_path
from repro_torch.models.transformer import (
    backbone_forward,
    embed_inputs,
    fused_next_token_loss,
)
from repro_torch.optim.compression import Quantized
from repro_torch.optim.optimizers import apply_updates, make_optimizer

REPO = Path(__file__).resolve().parents[1]
CPU = EngineConfig(device="cpu", kernel_backend="torch")
ARCH = "qwen1.5-0.5b"
#: tokens of the loss checks; groups x per-group batch x seq of the gradients
LOSS_SHAPE, GROUPS, GRAD_B = (2, 16), 4, 2
#: the trainer runs: (method, optimizer, slot dtype, steps)
RUNS = [("dsag", "sgd", "float32", 10), ("sag", "sgd", "float32", 10),
        ("dsag", "adamw", "float32", 10), ("dsag", "adafactor", "float32", 10),
        ("dsag", "sgd", "int8", 10)]
RUN_BATCH, RUN_SEQ, RUN_LR = 8, 32, 1e-3
#: the reference's checkpointing run: bf16 model and slots, checkpoints at 9 and 11
CKPT_STEPS = 12
#: the data pipeline's layouts: reference arch per layout, steps drawn
LAYOUTS = {"lm": ARCH, "vlm": "pixtral-12b", "enc_dec": "whisper-base"}
BATCH_STEPS = 2

#: the APIs jax 0.9 removed, put back before ``repro`` is imported
_SHIM = r"""
import dataclasses, json, sys
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
import jax.numpy as jnp
import repro.launch.train as RT
from repro.configs import TrainConfig, get_smoke_config
from repro.data import make_batch_iterator
from repro.experiments.grid import HEAVY_BURSTS
from repro.latency.model import make_heterogeneous_cluster, sample_fleet
from repro.models import build_model
from repro.models.transformer import backbone_forward, embed_inputs, fused_next_token_loss
from repro.models.layers import apply_norm
from repro.optim.compression import Quantized

P = {params}
out = {{}}
rng = np.random.default_rng(5)

def export(prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            export(f"{{prefix}}/{{k}}", v)
    elif isinstance(tree, Quantized):
        out[prefix + "/#q"] = np.asarray(tree.q)
        out[prefix + "/#scale"] = np.asarray(tree.scale.astype(jnp.float32))
    else:
        a = tree
        if hasattr(a, "dtype") and a.dtype == jnp.bfloat16:
            a = a.astype(jnp.float32)
        out[prefix] = np.asarray(a)

f32_cfg = dataclasses.replace(get_smoke_config(P["arch"]), dtype="float32")
model = build_model(f32_cfg)
params = model.init(jax.random.key(0))
export("params", params)

# -- train_loss: fused and unfused, every remat mode ------------------------------
toks = rng.integers(0, f32_cfg.vocab_size, size=P["loss_shape"]).astype(np.int32)
out["loss/tokens"] = toks
batch = {{"tokens": jnp.asarray(toks)}}
for fused in (False, True):
    for remat in ("none", "full", "selective"):
        fn = jax.jit(lambda p, b: model.train_loss(p, b, remat=remat, fused_loss=fused))
        out[f"loss/{{int(fused)}}/{{remat}}"] = np.asarray(fn(params, batch))
x = embed_inputs(f32_cfg, params, jnp.asarray(toks))
pos = jnp.broadcast_to(jnp.arange(x.shape[1]), x.shape[:2])
x, _ = backbone_forward(f32_cfg, params, x, pos, remat="none")
x = apply_norm(f32_cfg, params["ln_f"], x)
out["loss/chunk128"] = np.asarray(fused_next_token_loss(f32_cfg, params, x, jnp.asarray(toks), chunk=128))

# -- per-group gradients: the reference's vmap(value_and_grad) --------------------
G, b = P["groups"], P["grad_b"]
gtoks = rng.integers(0, f32_cfg.vocab_size, size=(G, b, P["loss_shape"][1])).astype(np.int32)
out["grad/tokens"] = gtoks
losses, grads = jax.jit(jax.vmap(jax.value_and_grad(lambda p, bb: model.train_loss(p, bb)),
                                 in_axes=(None, 0)))(params, {{"tokens": jnp.asarray(gtoks)}})
out["grad/losses"] = np.asarray(losses)
export("grad/g", grads)

# -- the data pipeline's three layouts ----------------------------------------------
for layout, arch in P["layouts"].items():
    cfg = get_smoke_config(arch)
    out[f"batch/{{layout}}/cfg"] = np.array(json.dumps(dataclasses.asdict(cfg)))
    it = make_batch_iterator(cfg, 4, 8, 32, seed=3)
    for s in range(P["batch_steps"]):
        for k, v in next(it).items():
            out[f"batch/{{layout}}/{{s}}/{{k}}"] = v

# -- the trainer, traces replayed ----------------------------------------------------
cl = make_heterogeneous_cluster(4, seed=3, burst_rate=0.0)
tr = sample_fleet(cl, 1, 200, burst_rate=HEAVY_BURSTS.rate,
                  burst_factor_mean=HEAVY_BURSTS.factor_mean,
                  burst_duration_mean=HEAVY_BURSTS.duration_mean, seed=7)
for f in ("comm", "comp_unit", "slowdown", "burst_start", "burst_end", "burst_factor"):
    out[f"traces/{{f}}"] = getattr(tr, f)
_smoke = RT.get_smoke_config
DTYPE = ["float32"]
RT.get_smoke_config = lambda a: dataclasses.replace(_smoke(a), dtype=DTYPE[0])

def capture(trn):
    step = trn.step_fn
    def wrapped(*a):
        st, m = step(*a)
        trn.last_state = st
        return st, m
    trn.step_fn = wrapped

rb, rs, lr = P["run_shape"]
for method, opt, slots, steps in P["runs"]:
    tag = f"run/{{method}}/{{opt}}/{{slots}}"
    tc = TrainConfig(dsag=True, optimizer=opt, learning_rate=lr, dsag_cache_dtype=slots)
    trn = RT.Trainer(RT.TrainerOptions(
        arch=P["arch"], smoke=True, steps=steps, global_batch=rb, seq_len=rs, method=method,
        traces=tr, scenario=0, simulate_stragglers=False, train_config=tc, log_every=10**6))
    export(tag + "/init", trn.init_state())
    capture(trn)
    h = trn.run()
    for f in ("mask_stream", "flush_stream", "evict_stream"):
        out[f"{{tag}}/{{f}}"] = np.stack(h[f])
    for f in ("loss", "xi", "mask_count"):
        out[f"{{tag}}/{{f}}"] = np.asarray(h[f])
    export(tag + "/final/params", trn.last_state["params"])

# -- a checkpoint written by the reference's trainer (bf16 model and slots) ---------
DTYPE[0] = "bfloat16"
tc = TrainConfig(dsag=True, optimizer="adamw", learning_rate=1e-3, checkpoint_every=10,
                 dsag_cache_dtype="bfloat16")
RT.Trainer(RT.TrainerOptions(arch=P["arch"], smoke=True, steps=P["ckpt_steps"],
                             global_batch=rb, seq_len=rs, checkpoint_dir=sys.argv[2],
                             train_config=tc, log_every=10**6)).run()
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module", autouse=True)
def ref_proc(tmp_path_factory):
    """The reference subprocess, started at the module's first test."""
    params = dict(arch=ARCH, loss_shape=LOSS_SHAPE, groups=GROUPS, grad_b=GRAD_B,
                  layouts=LAYOUTS, batch_steps=BATCH_STEPS, runs=RUNS,
                  run_shape=(RUN_BATCH, RUN_SEQ, RUN_LR), ckpt_steps=CKPT_STEPS)
    root = tmp_path_factory.mktemp("jax_train_lm_reference")
    path, ckpt = root / "ref.npz", root / "ckpt"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", _REF_SCRIPT.format(params=repr(params)), str(path), str(ckpt)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    yield proc, path, ckpt
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ref(ref_proc):
    """Every reference output of this module."""
    proc, path, _ = ref_proc
    _, err = proc.communicate(timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"reference subprocess failed:\n{err[-4000:]}")
    with np.load(path) as z:
        return dict(z)


def _tree(ref: dict, prefix: str) -> dict:
    """The nested dict exported under ``prefix`` (an int8 slot as ``(q, scale)``)."""
    out: dict = {}
    for key, a in ref.items():
        if key.startswith(prefix + "/"):
            node = out
            parts = key[len(prefix) + 1:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = a

    def pairs(t):
        if isinstance(t, dict):
            if set(t) == {"#q", "#scale"}:
                return (t["#q"], t["#scale"])
            return {k: pairs(v) for k, v in t.items()}
        return t

    return pairs(out)


def _f32_cfg() -> ModelConfig:
    return dataclasses.replace(get_smoke_config(ARCH), dtype="float32")


def _params(ref, cfg=None):
    cfg = cfg or _f32_cfg()
    return interop.model_params_from_arrays(cfg, _tree(ref, "params"), device="cpu")


def _close(got, want, rtol, atol_rel=0.0):
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * float(np.abs(want).max(initial=0.0)))


def _np(t) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


def _traces(ref):
    return interop.traces_from_arrays(*(ref[f"traces/{f}"] for f in (
        "comm", "comp_unit", "slowdown", "burst_start", "burst_end", "burst_factor")))


def _tc(opt: str, slots: str, lr: float = RUN_LR, **kw) -> TrainConfig:
    return TrainConfig(dsag=True, optimizer=opt, learning_rate=lr, dsag_cache_dtype=slots, **kw)


# -- the flat layout ----------------------------------------------------------------------


def test_flat_layout_round_trips_and_differentiates():
    cfg = get_smoke_config(ARCH)  # bfloat16 weights, float32 norm scales
    model = build_model(cfg)
    lay = model.layout
    tree = model.init(torch.Generator().manual_seed(0))
    flat = lay.flatten(tree)
    assert flat.dtype == torch.float32 and flat.shape == (lay.numel,)
    assert all(x.offset % 64 == 0 for x in lay.leaves)
    assert sum(x.size for x in lay.leaves) == model.num_params() <= lay.numel
    back = lay.tree(flat, cast=True)
    for x in lay.leaves:
        assert torch.equal(get_path(back, x.path), get_path(tree, x.path))
        assert get_path(back, x.path).dtype == x.dtype
    assert {x.dtype for x in lay.leaves} == {torch.bfloat16, torch.float32}
    # one split: the flat gradient holds each leaf's gradient at its span, zeros between
    leaf = flat.clone().requires_grad_(True)
    views = lay.unflatten(leaf)
    loss = sum((get_path(views, x.path).float() * (i + 1)).sum()
               for i, x in enumerate(lay.leaves))
    (g,) = torch.autograd.grad(loss, leaf)
    want = torch.zeros(lay.numel)
    for i, (x, v) in enumerate(zip(lay.leaves, lay.views(want))):
        v.fill_(i + 1)
    assert torch.equal(g, want)
    # round_: a leaf of bf16 values stays put; an off-grid value rounds to its dtype
    bumped = lay.round_(flat + 1e-4)
    for x, v, v0 in zip(lay.leaves, lay.views(bumped), lay.views(flat)):
        assert torch.equal(v, (v0 + 1e-4).to(x.dtype).to(torch.float32))


@pytest.mark.parametrize("opt", ["sgd", "adamw", "adafactor"])
def test_flat_optimizers_equal_per_leaf(opt):
    """One step over the flat layout equals the same optimizer run on each
    leaf alone (the reference's tree walk), and ``apply_updates`` rounds
    each leaf to its own dtype as the reference's per-leaf cast does."""
    model = build_model(get_smoke_config(ARCH))
    lay = model.layout
    params = lay.flatten(model.init(torch.Generator().manual_seed(1)))
    grads = torch.zeros_like(params)
    for v in lay.views(grads):
        v.normal_(generator=torch.Generator().manual_seed(v.numel()))
    tc = TrainConfig(optimizer=opt, learning_rate=1e-2)
    flat_opt = make_optimizer(tc, lay)
    upd, _ = flat_opt.update(grads, flat_opt.init(params), params)
    new = apply_updates(params, upd, lay)
    leaf_opt = make_optimizer(tc)
    for x, p, g, u, n in zip(lay.leaves, lay.views(params), lay.views(grads), lay.views(upd),
                             lay.views(new)):
        want, _ = leaf_opt.update(g.clone(), leaf_opt.init(p.clone()), p.clone())
        assert torch.equal(u, want), x.path
        assert torch.equal(n, apply_updates(p.to(x.dtype), want).to(torch.float32)), x.path


# -- K6 refuses grad --------------------------------------------------------------------


@pytest.mark.parametrize("entry", ["bshd", "op"])
def test_k6_refuses_grad_on_the_card_path(monkeypatch, entry):
    """K6 writes through a raw pointer and has no backward: on the card path
    (``route`` forced to ``"launch"`` here) a grad-requiring input raises before any
    launch; under no grad the guard lets the call through to the launch."""
    monkeypatch.setattr(k6, "route", lambda *a, **kw: "launch")
    launched = []
    monkeypatch.setattr(k6, "_launch", lambda *a: launched.append(1))
    shape = (1, 8, 2, 64) if entry == "bshd" else (1, 2, 8, 64)
    fn = k6.flash_attention_bshd if entry == "bshd" else k6.flash_attention_op
    q = torch.zeros(shape, requires_grad=True)
    kv = torch.zeros(shape)
    with pytest.raises(RuntimeError, match="no backward"):
        fn(q, kv, kv)
    assert not launched
    with torch.no_grad():
        fn(q, kv, kv)
    assert launched == [1]


# -- port-only: checkpoints, the reference's system tests, refusals -----------------


def _bf16_trainer(ckpt_dir, steps, restore=False, every=10, **kw):
    tc = TrainConfig(dsag=True, optimizer="adamw", learning_rate=1e-3, checkpoint_every=every,
                     dsag_cache_dtype="bfloat16")
    return Trainer(TrainerOptions(arch=ARCH, steps=steps, global_batch=RUN_BATCH,
                                  seq_len=RUN_SEQ, checkpoint_dir=str(ckpt_dir),
                                  restore=restore, train_config=tc, log_every=10**6,
                                  engine=CPU, **kw))


def test_checkpoint_restart_continues_exactly(tmp_path, two_threads):
    t1 = _bf16_trainer(tmp_path, 4, every=2)
    t1.run()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000001", "step_00000003"]
    t2 = _bf16_trainer(tmp_path, 8, restore=True, every=2)
    fresh = t2.init_state()
    restored, start = t2.maybe_restore(fresh)
    assert start == 4
    assert not torch.equal(restored["params"], fresh["params"])
    mem = _flatten_with_paths(train_state_tree(t1.state, t1.layout))
    disk = _flatten_with_paths(train_state_tree(restored, t2.layout))
    assert [p for p, _ in mem] == [p for p, _ in disk]
    for (path, a), (_, b) in zip(mem, disk):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    assert torch.equal(train_state_from_tree(train_state_tree(restored, t2.layout),
                                             t2.layout)["params"], restored["params"])
    # the next step from the restored state equals the next step from memory
    batch = t2.batch_on_device(next(t2.data))
    bits = torch.tensor([[True, False, True, True], [False, True, False, False],
                         [False] * 4])
    a, ma = t1.step_fn(t1.state, batch, *bits)
    b, mb = t2.step_fn(restored, batch, *bits)
    assert torch.equal(ma["loss"], mb["loss"]) and torch.equal(a["params"], b["params"])
    assert torch.equal(a["dsag"]["h"], b["dsag"]["h"])


# -- the reference's system tests, on the port ---------------------------------------


@pytest.fixture
def two_threads():
    """Two torch threads while the reference subprocess works beside the
    test (eight spinning threads on a shared CPU run several times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _system_trainer(tmp, steps, lr=1e-3):
    """``tests/test_system.py``'s ``make_trainer`` on the port (the bf16 smoke
    model, adamw, bf16 slots, live-sampled stragglers)."""
    tc = TrainConfig(dsag=True, optimizer="adamw", learning_rate=lr, checkpoint_every=10,
                     dsag_cache_dtype="bfloat16")
    return Trainer(TrainerOptions(arch=ARCH, steps=steps, global_batch=8, seq_len=64,
                                  checkpoint_dir=str(tmp), train_config=tc, log_every=100,
                                  engine=CPU))


def test_loss_decreases_with_dsag_and_stragglers(tmp_path, two_threads):
    hist = _system_trainer(tmp_path, 40).run()
    assert np.mean(hist["loss"][-5:]) < np.mean(hist["loss"][:5])
    assert min(hist["mask_count"]) < 4  # straggler masks fired


def test_failed_group_does_not_block_progress(tmp_path, two_threads):
    """Permanently killing one group still trains (the paper's point)."""
    t = _system_trainer(tmp_path, 80, lr=3e-3)
    orig = t._group_latencies

    def latencies(step):
        lat = orig(step)
        lat[0] = 1e9
        return lat

    t._group_latencies = latencies
    hist = t.run()
    assert np.mean(hist["loss"][-10:]) < np.mean(hist["loss"][:10])
    assert t.failures.failed[0]
    # group 0 was evicted: its cache slot is zero, ξ counts the other three
    assert not t.state["dsag"]["cache"][0].any()
    assert hist["xi"][-1] == 0.75


def test_model_zoo_refusals():
    with pytest.raises(EngineCapabilityError) as e:
        Trainer(TrainerOptions(arch="gpt-x", engine=CPU))
    assert e.value.capability.code == CAP_ARCH
    with pytest.raises(EngineCapabilityError) as e:
        make_train_step(object(), TrainConfig(), GroupSpec(4, ()))
    assert e.value.capability.code == CAP_GROUP_GRAD
    with pytest.raises(ValueError, match="divisible"):
        Trainer(TrainerOptions(arch=ARCH, global_batch=6, engine=CPU))


# -- the data pipeline ------------------------------------------------------------------


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_batches_equal_the_reference_pipeline(ref, layout):
    cfg = ModelConfig(**json.loads(str(ref[f"batch/{layout}/cfg"])))
    it = make_batch_iterator(cfg, 4, 8, 32, seed=3)
    for s in range(BATCH_STEPS):
        batch = next(it)
        keys = sorted(k.split("/")[-1] for k in ref if k.startswith(f"batch/{layout}/{s}/"))
        assert sorted(batch) == keys
        for k in keys:
            want = ref[f"batch/{layout}/{s}/{k}"]
            assert batch[k].dtype == want.dtype and np.array_equal(batch[k], want), (layout, s, k)


# -- train_loss ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", ["none", "full", "selective"])
@pytest.mark.parametrize("fused", [False, True])
def test_train_loss_matches_reference(ref, fused, remat):
    model = build_model(_f32_cfg())
    params = _params(ref)
    batch = {"tokens": torch.as_tensor(ref["loss/tokens"])}
    got = model.train_loss(params, batch, remat=remat, fused_loss=fused)
    _close(_np(got), ref[f"loss/{int(fused)}/{remat}"], rtol=1e-5)
    # and the remat modes differentiate to the same gradient
    flat = model.layout.flatten(params).requires_grad_(True)
    loss = model.train_loss(model.layout.unflatten(flat), batch, remat=remat, fused_loss=fused)
    (g,) = torch.autograd.grad(loss, flat)
    flat0 = flat.detach().requires_grad_(True)
    (g0,) = torch.autograd.grad(model.train_loss(model.layout.unflatten(flat0), batch,
                                                 remat="none"), flat0)
    _close(_np(g), _np(g0), rtol=1e-5, atol_rel=1e-6)


def test_fused_loss_chunks_and_its_single_chunk_rule(ref):
    cfg = _f32_cfg()
    params = _params(ref)
    toks = torch.as_tensor(ref["loss/tokens"])
    x = embed_inputs(cfg, params, toks)
    pos = torch.arange(x.shape[1]).expand(x.shape[:2])
    x, _ = backbone_forward(cfg, params, x, pos, remat="none", backend="torch")
    x = apply_norm(cfg, params["ln_f"], x)
    _close(_np(fused_next_token_loss(cfg, params, x, toks, chunk=128)), ref["loss/chunk128"],
           rtol=1e-5)
    # 512 % 200 != 0: one chunk, as the reference falls back
    _close(_np(fused_next_token_loss(cfg, params, x, toks, chunk=200)), ref["loss/0/none"],
           rtol=1e-5)


def test_train_loss_refuses_other_layouts(ref):
    model = build_model(_f32_cfg())
    params = _params(ref)
    toks = torch.as_tensor(ref["loss/tokens"])
    for extra in ({"image_embed": torch.zeros(2, 8, 64)}, {"audio_embed": torch.zeros(2, 12, 64)}):
        with pytest.raises(EngineCapabilityError) as e:
            model.train_loss(params, {"tokens": toks, **extra})
        assert e.value.capability.code == CAP_ARCH


# -- per-group gradients -----------------------------------------------------------------


def test_group_gradients_match_reference_vmap(ref):
    model = build_model(_f32_cfg())
    lay = model.layout
    flat = lay.flatten(_params(ref))
    fn = autograd_group_value_and_grad(lambda p, b: model.train_loss(p, b), lay)
    losses, grads = fn(flat, {"tokens": torch.as_tensor(ref["grad/tokens"])})
    assert grads.shape == (GROUPS, lay.numel) and grads.dtype == torch.float32
    _close(_np(losses), ref["grad/losses"], rtol=1e-5)
    want = _tree(ref, "grad/g")
    for x, g in zip(lay.leaves, lay.views(grads)):
        _close(_np(g), get_path(want, x.path), rtol=1e-4, atol_rel=1e-4)
    # the gaps between leaves hold nothing
    mask = torch.ones(lay.numel, dtype=torch.bool)
    for v in lay.views(mask):
        v.fill_(False)
    assert not grads[:, mask].any()
    # bf16 slots: the gradients come out already rounded to them
    fn16 = autograd_group_value_and_grad(lambda p, b: model.train_loss(p, b), lay,
                                         torch.bfloat16)
    _, g16 = fn16(flat, {"tokens": torch.as_tensor(ref["grad/tokens"])})
    assert torch.equal(g16, grads.to(torch.bfloat16))


# -- the trainer -------------------------------------------------------------------------


def _port_run(ref, method, opt, slots, steps, *, engine=CPU, log_every=10**6):
    tag = f"run/{method}/{opt}/{slots}"
    trn = Trainer(TrainerOptions(
        arch=ARCH, dtype="float32", steps=steps, global_batch=RUN_BATCH, seq_len=RUN_SEQ,
        method=method, traces=_traces(ref), scenario=0, simulate_stragglers=False,
        train_config=_tc(opt, slots), log_every=log_every, engine=engine))
    init = _tree(ref, tag + "/init")
    state = interop.model_train_state_from_arrays(
        trn.cfg, init["params"], init["opt"], init["dsag"], int(init["step"]),
        device=engine.device, slot_dtype=torch.float32)
    trn.init_state = lambda: state
    return trn, trn.run(), tag


#: the trainer runs' tolerances: (losses' rtol, relative RMS difference of the
#: final parameters); see the module docstring
RUN_TOL = {"sgd": (1e-6, 1e-6), "int8": (1e-6, 1e-5), "adamw": (2e-3, 3e-3),
           "adafactor": (3e-3, 1e-2)}


@pytest.mark.parametrize("run", RUNS, ids=["/".join(r[:3]) for r in RUNS])
def test_trainer_matches_reference(ref, run):
    method, opt, slots, steps = run
    trn, hist, tag = _port_run(ref, *run)
    for f in ("mask_stream", "flush_stream", "evict_stream"):
        assert np.array_equal(np.stack(hist[f]), ref[f"{tag}/{f}"]), f
    assert np.array_equal(np.asarray(hist["xi"], np.float32), ref[f"{tag}/xi"].astype(np.float32))
    assert np.array_equal(hist["mask_count"], ref[f"{tag}/mask_count"])
    assert min(hist["mask_count"]) < GROUPS  # the replayed traces masked stragglers
    if method == "dsag":
        assert np.stack(hist["flush_stream"]).any()  # ... and flushed stale results
    if slots == "int8":
        assert isinstance(get_path(trn.state["dsag"]["cache"], ("embed", "tok")), Quantized)
    loss_rtol, params_rms = RUN_TOL["int8" if slots == "int8" else opt]
    _close(hist["loss"], ref[f"{tag}/loss"], rtol=loss_rtol)
    want = trn.layout.flatten(_torch_tree(_tree(ref, tag + "/final/params")))
    got = trn.state["params"]
    assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) <= params_rms


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.as_tensor(tree)


def test_checkpoint_written_by_the_reference_restores(ref, ref_proc):
    ckpt = ref_proc[2]
    trn = _bf16_trainer(ckpt, CKPT_STEPS + 2, restore=True)
    state, start = trn.maybe_restore(trn.init_state())
    assert start == CKPT_STEPS
    step_dir = ckpt / f"step_{CKPT_STEPS - 1:08d}"
    manifest = json.loads((step_dir / "manifest.json").read_text())
    flat = _flatten_with_paths(train_state_tree(state, trn.layout))
    assert [p for p, _ in flat] == manifest["paths"]
    with np.load(step_dir / "arrays.npz") as z:
        for i, ((path, leaf), dt) in enumerate(zip(flat, manifest["dtypes"])):
            a = z[f"a{i}"]
            if dt == "bfloat16":
                assert leaf.dtype == torch.bfloat16, path
                got = leaf.contiguous().view(torch.int16).numpy().view(np.uint16)
            else:
                got = leaf.numpy()
            assert got.dtype == a.dtype and np.array_equal(got, a), path
    assert state["params"].dtype == torch.float32 and state["dsag"]["cache"].dtype == torch.bfloat16
    hist = trn.run()  # two more steps from the reference's state
    assert len(hist["loss"]) == 2 and np.isfinite(hist["loss"]).all()


# -- on the card ----------------------------------------------------------------------


@pytest.mark.gpu
def test_card_trainer_matches_cpu_and_launches_k4_per_step():
    """The smoke config in float32 on the card (K4) against the port on the
    CPU from one initial state, 10 steps on replayed traces (no reference:
    the card's machine has no JAX): streams equal, losses within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.experiments.grid import HEAVY_BURSTS
    from repro_torch.latency.model import make_heterogeneous_cluster, sample_fleet

    traces = sample_fleet(make_heterogeneous_cluster(4, seed=3, burst_rate=0.0), 1, 200,
                          burst_rate=HEAVY_BURSTS.rate,
                          burst_factor_mean=HEAVY_BURSTS.factor_mean,
                          burst_duration_mean=HEAVY_BURSTS.duration_mean, seed=7)

    def trainer(engine):
        return Trainer(TrainerOptions(
            arch=ARCH, dtype="float32", steps=10, global_batch=RUN_BATCH, seq_len=RUN_SEQ,
            traces=traces, scenario=0, simulate_stragglers=False,
            train_config=_tc("sgd", "float32"), log_every=10**6, engine=engine))

    on_cpu = trainer(CPU)
    state = on_cpu.init_state()
    hp = on_cpu.run()
    on_card = trainer(EngineConfig(device="cuda", kernel_backend="cuda"))
    on_card.init_state = lambda: _state_to(state, "cuda")
    reset_launch_counts()
    hc = on_card.run()
    assert launch_counts()["dsag_cache_update"] == 10
    for f in ("mask_stream", "flush_stream", "evict_stream"):
        assert np.array_equal(np.stack(hc[f]), np.stack(hp[f]))
    assert hc["xi"] == hp["xi"] and hc["mask_count"] == hp["mask_count"]
    _close(hc["loss"], hp["loss"], rtol=1e-5)


def _state_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _state_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.gpu
def test_k6_refuses_grad_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q = torch.zeros(1, 64, 2, 64, device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        k6.flash_attention_bshd(q, q.detach(), q.detach())
