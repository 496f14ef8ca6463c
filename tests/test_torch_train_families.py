"""Training the MoE, MLA, SSM and hybrid families, held against the JAX
reference on the CPU.

The reference runs in ONE subprocess for this module (``_REF_SCRIPT``, with
the jax-0.9 shim of ``tests/test_torch_serve.py``), started with the
module's first test so that the port-only tests run beside it; it builds
every input from numpy seeds (the models' parameters and the trainers'
initial states from the reference's own ``Model.init`` /
``Trainer.init_state``) and writes inputs and outputs to an ``.npz``.  This
process never imports ``jax`` or ``repro``.  The models are the four smoke
configs: grok-1-314b (MoE, GQA), deepseek-v2-236b (MoE, MLA, shared
experts), mamba2-370m (SSM) and zamba2-2.7b (hybrid: four Mamba2 layers, the
shared GQA block applied after each pair).

Tolerances, and why:

* ``Model.train_loss`` and its per-group gradients (the trainer's
  ``autograd_group_value_and_grad`` against the reference's
  ``vmap(value_and_grad)``) in float32: losses ``rtol=1e-5``; each leaf's
  gradient ``rtol=1e-4``, ``atol = 1e-4 * max|ref| + 4 * spread``, where
  ``spread`` is the reference's own: the largest change of the reference's
  gradient of that leaf when every parameter moves by one float32 ulp
  (directions from a seed), the rule of ``tests/test_torch_registry.py``:
  measured, the largest gap is 4.4e-4 of its leaf's largest value
  (deepseek-v2's ``w_uk``, 3.1e-4 at grok's ``ln1``), past ``1e-4`` but
  within the spread; mamba2's and zamba2's within 1.6e-5.  Losses measured
  within 2.4e-7.  The MoE's aux loss ``rtol=1e-5``.
* ``moe_apply``'s gradient (inputs and every parameter) against
  ``jax.grad`` of the reference's, at capacity factors 8.0 and 0.5 (pairs
  dropped), in one and two dispatch chunks: float32 ``rtol=1e-5``, ``atol =
  1e-5 * max|ref|`` (another summation order in the einsums' backward;
  measured within 8.7e-7 of the largest value); bfloat16 with the
  reference op by op (``jax.disable_jit()``, at capacity factor 0.5 in two
  chunks): the gate
  indices equal, the gradients within two bfloat16 ulps of the largest
  value, ``atol = 2**-6 * max|ref|``, as the families' bf16 forwards
  (measured 1.5e-3).  The loss, a sum of signed terms in float32, within
  ``rtol=1e-4`` in both dtypes (measured 7.7e-6).
* The SSD at chunk 128 (a cumulative decay past float32's 88.7, asserted):
  the reference's ``_ssd_chunked`` gradient of dt and A is NaN (the fault
  this test shows), its gradient of x, B and C finite; the port's gradient
  is finite everywhere, equal to the reference's where that one is finite
  (``rtol=1e-5``, ``atol = 1e-5 * max|ref|``; measured 1.9e-6), and the
  port's ``mamba_forward`` gradient at chunk 128 equals ``jax.grad`` of the
  reference's token-by-token recurrence (``mamba_reference_recurrent``'s
  loop over the reference's ``mamba_decode_step``, as a ``lax.scan``)
  within ``rtol=1e-4``, ``atol = 1e-4 * max|ref|``, as
  ``test_torch_families.py`` holds the forwards (two algorithms:
  exponentials of cumulative sums against running products; measured
  1.3e-5).  At chunk 16 every gradient equals the reference's
  ``_ssd_chunked``'s at ``rtol=1e-5``, ``atol = 1e-5 * max|ref|`` (measured
  1.7e-6).
* ``remat`` "none", "full" and "selective": the same gradients, bit for bit
  (the recomputation runs the same ops on the same inputs).
* A few ``Trainer`` steps per family against the reference trainer (sgd,
  float32 slots, replayed traces): mask, flush and evict streams, ξ and
  ``mask_count`` exact; the losses ``rtol=1e-6`` and the final parameters'
  relative RMS difference ``1e-6``, as ``tests/test_torch_train_lm.py``
  holds sgd (measured 1.4e-7 and 8.6e-8).  The reference trainer runs with
  its ``_ssd_chunked`` repaired as the port's (the exponent masked before the
  exp, its source changed in that one line inside the subprocess): as it
  is, its smoke mamba2 trainer returns NaN from the second step (ROADMAP
  §3), which :func:`test_reference_trainer_goes_nan_where_the_port_does_not`
  shows.  The data pipeline's batches for these archs: bit-equal.

The ``gpu`` case holds the MoE backward on the card: two runs bit-equal, and
equal to the CPU's within the float32 bound above (``pytest -m gpu
tests/test_torch_train_families.py``).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core.dsag_pjit import autograd_group_value_and_grad
from repro_torch.data import make_batch_iterator
from repro_torch.experiments.engine import EngineConfig
from repro_torch.launch.train import Trainer, TrainerOptions
from repro_torch.models import build_model
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import FlatLayout, tree_map
from repro_torch.models.model import model_decls
from repro_torch.models.transformer import backbone_forward, embed_inputs

REPO = Path(__file__).resolve().parents[1]
CPU = EngineConfig(device="cpu", kernel_backend="torch")
FAMILIES = ("grok-1-314b", "deepseek-v2-236b", "mamba2-370m", "zamba2-2.7b")
MOE_ARCHS = ("grok-1-314b", "deepseek-v2-236b")
#: moe_apply's gradient: (arch, capacity factor, dispatch chunks, dtype); in
#: bfloat16 (the reference op by op) with pairs dropped in two chunks
MOE_CASES = ([(a, cf, nx, "float32") for a in MOE_ARCHS for cf in (8.0, 0.5) for nx in (1, 2)]
             + [(a, 0.5, 2, "bfloat16") for a in MOE_ARCHS])
#: per-group gradients: groups, sequences per group, tokens (two SSD chunks
#: of 16, the second padded)
GROUPS, GRAD_B, SEQ = 2, 2, 24
#: the SSD fault: b, s (one chunk of 128), heads, head dim, state
SSD_SHAPE = (1, 128, 2, 4, 8)
#: the trainer runs: global batch, tokens, steps, learning rate
RUN_BATCH, RUN_SEQ, RUN_STEPS, RUN_LR = 8, 16, 3, 1e-2
#: float32's largest exponent whose exp is finite
EXP_MAX = 88.72

#: the APIs jax 0.9 removed, put back before ``repro`` is imported
_SHIM = r"""
import dataclasses, sys
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
from repro.models import build_model, moe as moe_mod, ssm as ssm_mod
from repro.models.transformer import backbone_forward, embed_inputs

P = {params}
out = {{}}
rng = np.random.default_rng(23)
f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))

def flat(tree, prefix):
    if isinstance(tree, (dict, tuple)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for key, val in items:
            flat(val, f"{{prefix}}/{{key}}")
    else:
        a = np.asarray(tree.astype(jnp.float32) if tree.dtype == jnp.bfloat16 else tree)
        out[prefix] = a

def nudged(tree):
    # every parameter moved by one float32 ulp, up or down as a seeded draw says
    nr = np.random.default_rng(1)
    inf = np.float32(np.inf)
    return jax.tree.map(lambda a: jnp.asarray(np.nextafter(
        np.asarray(a), np.where(nr.integers(0, 2, a.shape).astype(bool), inf, -inf))), tree)

# -- train_loss and the per-group gradients (float32) ------------------------------------
G, GB, S = P["grad_shape"]
params32 = {{}}
for arch in P["archs"]:
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = build_model(cfg)
    params32[arch] = params = jax.jit(model.init)(jax.random.key(0))
    pre = f"train/{{arch}}/"
    flat(params, pre + "params")
    toks = rng.integers(0, cfg.vocab_size, size=(G, GB, S)).astype(np.int32)
    out[pre + "tokens"] = toks
    batch = {{"tokens": jnp.asarray(toks)}}
    vg = jax.jit(jax.vmap(jax.value_and_grad(lambda p, b: model.train_loss(p, b)),
                          in_axes=(None, 0)))
    losses, grads = vg(params, batch)
    out[pre + "losses"] = f32(losses)
    flat(grads, pre + "grad")
    flat(jax.tree.map(lambda g, h: np.abs(f32(g) - f32(h)).max(), grads,
                      vg(nudged(params), batch)[1]), pre + "spread")
    if cfg.num_experts:
        x = embed_inputs(cfg, params, jnp.asarray(toks[0]))
        pos = jnp.broadcast_to(jnp.arange(S), x.shape[:2])
        out[pre + "aux"] = f32(jax.jit(lambda p, x: backbone_forward(cfg, p, x, pos)[1])(params, x))
    it = make_batch_iterator(cfg, 4, 8, 32, seed=3)
    for k, v in next(it).items():
        out[f"batch/{{arch}}/{{k}}"] = v

# -- moe_apply's gradient: float32 compiled, bfloat16 op by op -----------------------------
for arch, cf, nx, dt in P["moe"]:
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dt, moe_dispatch_chunks=nx)
    p = jax.tree.map(lambda a: a[0].astype(dt), params32[arch]["blocks"]["moe"])
    x = jnp.asarray(rng.normal(size=(4, 32, cfg.d_model)).astype(np.float32)).astype(dt)
    w = jnp.asarray(rng.normal(size=(4, 32, cfg.d_model)).astype(np.float32))
    pre = f"moe/{{arch}}/{{cf}}/{{nx}}/{{dt}}/"
    out[pre + "x"], out[pre + "w"] = f32(x), f32(w)

    def loss(p, x):
        y, aux = moe_mod.moe_apply(cfg, p, x, capacity_factor=cf)
        return jnp.sum(y.astype(jnp.float32) * w) + aux

    fn = jax.value_and_grad(loss, argnums=(0, 1))
    with jax.disable_jit(dt == "bfloat16"):
        val, (gp, gx) = (jax.jit(fn) if dt == "float32" else fn)(p, x)
        tokens = x.reshape(-1, x.shape[-1])
        probs = jax.nn.softmax(jnp.einsum("td,de->te", tokens, p["router"].astype(x.dtype))
                               .astype(jnp.float32), axis=-1)
        out[pre + "gate_idx"] = np.asarray(jax.lax.top_k(probs, cfg.top_k)[1])
    out[pre + "loss"] = f32(val)
    flat(gp, pre + "grad")
    out[pre + "grad/x"] = f32(gx)

# -- the SSD at chunk 128 (a cumulative decay past 88.7) and 16 ----------------------------
b, s, h, hp, n = P["ssd"]
ssd = dict(x=rng.normal(size=(b, s, h, hp)), dt=np.log1p(np.exp(rng.normal(size=(b, s, h)))),
           A=-np.ones(h), B=rng.normal(size=(b, s, n)), C=rng.normal(size=(b, s, n)),
           wy=rng.normal(size=(b, s, h, hp)), ws=rng.normal(size=(b, h, hp, n)))
ssd = {{k: jnp.asarray(v.astype(np.float32)) for k, v in ssd.items()}}
for k, v in ssd.items():
    out["ssd/" + k] = f32(v)
for chunk in (128, 16):
    def loss(x, dt, A, B, C):
        y, st = ssm_mod._ssd_chunked(x, dt, A, B, C, chunk)
        return jnp.sum(y * ssd["wy"]) + jnp.sum(st * ssd["ws"])
    args = [ssd[k] for k in ("x", "dt", "A", "B", "C")]
    y, st = jax.jit(lambda *a: ssm_mod._ssd_chunked(*a, chunk))(*args)
    out[f"ssd/{{chunk}}/y"], out[f"ssd/{{chunk}}/state"] = f32(y), f32(st)
    g = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(*args)
    for k, v in zip(("x", "dt", "A", "B", "C"), g):
        out[f"ssd/{{chunk}}/grad/{{k}}"] = f32(v)

# -- Mamba2 at chunk 128: the chunked form and the recurrent oracle's gradients ------------
cfg = dataclasses.replace(get_smoke_config("mamba2-370m"), dtype="float32", ssm_chunk=128)
p = jax.tree.map(lambda a: a[0], params32["mamba2-370m"]["blocks"]["mamba"])
p["dt_bias"] = jnp.full_like(p["dt_bias"], 0.5)  # dt ~ 1 at A = -1: decay ~ 1 per token
flat(p, "mamba/params")
x = jnp.asarray(rng.normal(size=(1, 128, cfg.d_model)).astype(np.float32))
w = jnp.asarray(rng.normal(size=(1, 128, cfg.d_model)).astype(np.float32))
out["mamba/x"], out["mamba/w"] = f32(x), f32(w)
dt = jax.nn.softplus(jnp.einsum("bsd,dh->bsh", x, p["w_dt"]) + p["dt_bias"])
out["mamba/max_decay"] = f32((dt * jnp.exp(p["A_log"])).sum(1).max())
chunked = lambda p, x: jnp.sum(ssm_mod.mamba_forward(cfg, p, x) * w)
flat(jax.jit(jax.grad(chunked, argnums=(0, 1)))(p, x), "mamba/chunked")

def recurrent(p, x):
    # mamba_reference_recurrent's loop over mamba_decode_step from its zero
    # cache, as a lax.scan: XLA takes minutes to compile the 128 steps
    # unrolled, and op by op they take ~40 s
    b, c = x.shape[0], cfg.ssm_conv - 1
    d_inner, h, n = ssm_mod.ssm_dims(cfg)
    cache = {{"state": jnp.zeros((b, h, cfg.ssm_head_dim, n), jnp.float32),
              "conv": {{"x": jnp.zeros((b, c, d_inner), x.dtype),
                        "B": jnp.zeros((b, c, ssm_mod.N_GROUPS * n), x.dtype),
                        "C": jnp.zeros((b, c, ssm_mod.N_GROUPS * n), x.dtype)}}}}

    def step(cache, xt):
        y, cache = ssm_mod.mamba_decode_step(cfg, p, xt[:, None], cache)
        return cache, y[:, 0]

    return jnp.swapaxes(jax.lax.scan(step, cache, jnp.swapaxes(x, 0, 1))[1], 0, 1)

oracle = lambda p, x: jnp.sum(recurrent(p, x) * w)
flat(jax.jit(jax.grad(oracle, argnums=(0, 1)))(p, x), "mamba/recurrent")

# -- the trainer, traces replayed (sgd, float32) -------------------------------------------
cl = make_heterogeneous_cluster(4, seed=3, burst_rate=0.0)
tr = sample_fleet(cl, 1, 200, burst_rate=HEAVY_BURSTS.rate,
                  burst_factor_mean=HEAVY_BURSTS.factor_mean,
                  burst_duration_mean=HEAVY_BURSTS.duration_mean, seed=7)
for f in ("comm", "comp_unit", "slowdown", "burst_start", "burst_end", "burst_factor"):
    out[f"traces/{{f}}"] = getattr(tr, f)
_smoke = RT.get_smoke_config
RT.get_smoke_config = lambda a: dataclasses.replace(_smoke(a), dtype="float32")
rb, rs, steps, lr = P["run"]

def run(arch, tag):
    tc = TrainConfig(dsag=True, optimizer="sgd", learning_rate=lr, dsag_cache_dtype="float32")
    trn = RT.Trainer(RT.TrainerOptions(
        arch=arch, smoke=True, steps=steps, global_batch=rb, seq_len=rs, traces=tr, scenario=0,
        simulate_stragglers=False, train_config=tc, log_every=10**6))
    flat(trn.init_state(), tag + "/init")
    step = trn.step_fn
    final = []
    def wrapped(*a):
        st, m = step(*a)
        final[:] = [st]
        return st, m
    trn.step_fn = wrapped
    hist = trn.run()
    for f in ("mask_stream", "flush_stream", "evict_stream"):
        out[f"{{tag}}/{{f}}"] = np.stack(hist[f])
    for f in ("loss", "xi", "mask_count"):
        out[f"{{tag}}/{{f}}"] = np.asarray(hist[f])
    flat(final[0]["params"], tag + "/final")

# the reference as it is: its SSD gradient overflows on the first step's batch
run("mamba2-370m", "run_unrepaired/mamba2-370m")
# then with _ssd_chunked's exponent masked before the exp, the port's repair
# (the reference's source with that one line changed)
import inspect
src = inspect.getsource(ssm_mod._ssd_chunked)
line = "decay = jnp.exp(dA_cs[:, :, :, None, :] - dA_cs[:, :, None, :, :])"
assert line in src
src = src.replace(line, "decay = jnp.exp(jnp.where(jnp.tril(jnp.ones((L, L), bool))"
                        "[None, None, :, :, None], dA_cs[:, :, :, None, :] - "
                        "dA_cs[:, :, None, :, :], -jnp.inf))")
scope = dict(vars(ssm_mod))
exec(src, scope)
ssm_mod._ssd_chunked = scope["_ssd_chunked"]
for arch in P["archs"]:
    run(arch, f"run/{{arch}}")
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module", autouse=True)
def ref_proc(tmp_path_factory):
    """The reference subprocess, started at the module's first test (none
    where jax is not installed, as on the card's machine: the ``gpu`` case
    needs no reference)."""
    if importlib.util.find_spec("jax") is None:
        yield None
        return
    params = dict(archs=FAMILIES, grad_shape=(GROUPS, GRAD_B, SEQ), moe=MOE_CASES,
                  ssd=SSD_SHAPE, run=(RUN_BATCH, RUN_SEQ, RUN_STEPS, RUN_LR))
    path = tmp_path_factory.mktemp("jax_train_families_reference") / "ref.npz"
    # op by op, every primitive compiles once per shape: at LLVM's -O0 that
    # takes less time and computes the same bits (no fast math)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_backend_optimization_level=0")
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
    if ref_proc is None:
        pytest.fail("the reference needs jax, which is not installed")
    proc, path = ref_proc
    _, err = proc.communicate(timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"reference subprocess failed:\n{err[-4000:]}")
    with np.load(path) as z:
        return dict(z)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a, dtype=np.float32)).to(dtype)


def _np(t) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


def _close(got, want, rtol, atol_rel, err_msg=""):
    want = np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), want, rtol=rtol,
                               atol=atol_rel * float(np.abs(want).max(initial=0.0)),
                               err_msg=err_msg)


def _tree(ref: dict, prefix: str) -> dict:
    """The nested dict of numpy arrays stored under ``prefix``."""
    out: dict = {}
    for key, val in ref.items():
        if key.startswith(prefix + "/"):
            node = out
            *path, leaf = key[len(prefix) + 1:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = val
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _f32_cfg(arch: str):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


def _group_grads(model, params, tokens, remat: str = "full"):
    """(losses [P], {leaf path: gradient [P, ...]}) from the trainer's
    autograd group gradients over the flat layout."""
    layout = model.layout
    fn = autograd_group_value_and_grad(
        lambda p, b: model.train_loss(p, b, remat=remat), layout)
    losses, grads = fn(layout.flatten(params), {"tokens": torch.as_tensor(tokens)})
    return losses, {"/" + "/".join(x.path): v for x, v in zip(layout.leaves, layout.views(grads))}


# -- train_loss and its gradients ---------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_loss_and_group_gradients_match_reference(ref, arch):
    cfg, pre = _f32_cfg(arch), f"train/{arch}/"
    model = build_model(cfg)
    params = interop.model_params_from_arrays(cfg, _tree(ref, pre + "params"), device="cpu")
    losses, grads = _group_grads(model, params, ref[pre + "tokens"])
    _close(_np(losses), ref[pre + "losses"], rtol=1e-5, atol_rel=0)
    want = dict(_leaves(_tree(ref, pre + "grad")))
    spread = dict(_leaves(_tree(ref, pre + "spread")))
    assert sorted(grads) == sorted(want) == sorted(spread)
    if cfg.family == "hybrid":  # the shared block's gradient, summed over its applications
        assert any(n.startswith("/shared_attn/") for n in grads)
    for n, g in grads.items():
        w = np.asarray(want[n], dtype=np.float64)
        assert np.isfinite(_np(g)).all(), n
        np.testing.assert_allclose(_np(g), w, rtol=1e-4, err_msg=n,
                                   atol=1e-4 * float(np.abs(w).max()) + 4 * float(spread[n]))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_aux_loss_matches_reference(ref, arch):
    cfg, pre = _f32_cfg(arch), f"train/{arch}/"
    params = interop.model_params_from_arrays(cfg, _tree(ref, pre + "params"), device="cpu")
    tokens = torch.as_tensor(ref[pre + "tokens"][0])
    x = embed_inputs(cfg, params, tokens)
    pos = torch.arange(SEQ).expand(x.shape[:2])
    _, aux = backbone_forward(cfg, params, x, pos, backend="torch")
    assert float(ref[pre + "aux"]) > 0
    _close([float(aux)], [float(ref[pre + "aux"])], rtol=1e-5, atol_rel=0)


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_modes_give_the_same_gradients(arch):
    cfg = _f32_cfg(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (GROUPS, GRAD_B, SEQ))
    runs = {r: _group_grads(model, params, tokens, remat=r) for r in ("none", "full", "selective")}
    for r in ("full", "selective"):
        assert torch.equal(runs[r][0], runs["none"][0]), r
        for n, g in runs[r][1].items():
            assert torch.equal(g, runs["none"][1][n]), (r, n)


# -- the MoE's dispatch/combine backward -------------------------------------------------


def _moe_loss_and_grads(cfg, p, x, w, cf):
    p = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    x = x.detach().clone().requires_grad_(True)
    y, aux = moe_mod.moe_apply(cfg, p, x, capacity_factor=cf)
    loss = (y.to(torch.float32) * w).sum() + aux
    grads = torch.autograd.grad(loss, [x, *p.values()])
    return loss.detach(), dict(zip(["x", *p], grads))


@pytest.mark.parametrize(("arch", "cf", "nx", "dt"), MOE_CASES)
def test_moe_gradient_matches_reference(ref, arch, cf, nx, dt):
    dtype = getattr(torch, dt)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dt, moe_dispatch_chunks=nx)
    pre = f"moe/{arch}/{cf}/{nx}/{dt}/"
    p = {n: _t(a[0], dtype) for n, a in _tree(ref, f"train/{arch}/params/blocks/moe").items()}
    x, w = _t(ref[pre + "x"], dtype), _t(ref[pre + "w"])
    assert moe_mod.dispatch_chunks(cfg, x.shape[0]) == nx
    _, _, idx = moe_mod.route(cfg, p, x.reshape(-1, cfg.d_model))
    assert np.array_equal(idx.numpy(), ref[pre + "gate_idx"])
    loss, grads = _moe_loss_and_grads(cfg, p, x, w, cf)
    want = dict(_leaves(_tree(ref, pre + "grad")))
    assert sorted("/" + n for n in grads) == sorted(want)
    rtol, atol_rel = (1e-5, 1e-5) if dt == "float32" else (0, 2.0**-6)
    _close([float(loss)], [float(ref[pre + "loss"])], rtol=1e-4, atol_rel=0)
    for n, g in grads.items():
        assert g.dtype == dtype, n
        _close(_np(g), want["/" + n], rtol=rtol, atol_rel=atol_rel, err_msg=n)


def test_moe_backward_is_the_gather_pair(monkeypatch):
    """The MoE's backward runs through ``_Dispatch``/``_Combine``, never an
    accumulating ``index_put``; their gradient equals autograd through the
    indexing form bit for bit on the CPU."""
    cfg = _f32_cfg("deepseek-v2-236b")
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    p = {k: v[0] for k, v in params["blocks"]["moe"].items()}
    x = torch.randn(4, 32, cfg.d_model, generator=torch.Generator().manual_seed(1))
    w = torch.randn(4, 32, cfg.d_model, generator=torch.Generator().manual_seed(2))
    calls = []
    for fn in (moe_mod._Dispatch, moe_mod._Combine):
        monkeypatch.setattr(fn, "backward", (lambda b, name=fn.__name__: staticmethod(
            lambda ctx, *g: calls.append(name) or b(ctx, *g)))(fn.backward))
    put = torch.Tensor.index_put_

    def no_index_put(*a, **kw):
        raise AssertionError("an index_put in the MoE backward")

    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "index_put_", no_index_put)
        _, got = _moe_loss_and_grads(cfg, p, x, w, 0.5)
    assert sorted(calls) == ["_Combine", "_Dispatch"] and torch.Tensor.index_put_ is put
    _, want = _moe_loss_and_grads(cfg, p, x, w, 0.5)
    for n in got:
        assert torch.equal(got[n], want[n]), n
    assert got["x"].abs().max() > 0 and got["router"].abs().max() > 0


# -- the SSD at full chunk length -----------------------------------------------------------


def _ssd_grads(ref, chunk: int):
    args = {k: _t(ref["ssd/" + k]).requires_grad_(True) for k in ("x", "dt", "A", "B", "C")}
    y, st = ssm_mod._ssd_chunked(*args.values(), chunk)
    loss = (y * _t(ref["ssd/wy"])).sum() + (st * _t(ref["ssd/ws"])).sum()
    return y, st, dict(zip(args, torch.autograd.grad(loss, list(args.values()))))


def test_ssd_gradient_is_finite_at_full_chunk_where_the_reference_is_nan(ref):
    """The reference's fault (ROADMAP §3): at chunk 128 its ``_ssd_chunked``
    takes ``exp`` of the masked pairs' positive exponents, past 88.7 ``inf``,
    and its gradients of dt and A are NaN.  The port's are finite and its
    forward and other gradients equal the reference's."""
    decay = np.cumsum(ref["ssd/dt"] * -ref["ssd/A"], axis=1).max()
    assert decay > EXP_MAX
    want = {k: ref[f"ssd/128/grad/{k}"] for k in ("x", "dt", "A", "B", "C")}
    assert np.isnan(want["dt"]).all() and np.isnan(want["A"]).all()
    assert all(np.isfinite(want[k]).all() for k in ("x", "B", "C"))
    y, st, got = _ssd_grads(ref, 128)
    _close(_np(y), ref["ssd/128/y"], rtol=1e-5, atol_rel=1e-5)
    _close(_np(st), ref["ssd/128/state"], rtol=1e-5, atol_rel=1e-5)
    for k, g in got.items():
        assert torch.isfinite(g).all(), k
        if np.isfinite(want[k]).all():
            _close(_np(g), want[k], rtol=1e-5, atol_rel=1e-5, err_msg=k)


def test_ssd_gradient_at_full_chunk_matches_the_recurrent_oracle(ref):
    """Mamba2 at chunk 128 and a cumulative decay past 88.7: the reference's
    chunked gradient of ``dt_bias`` and ``A_log`` is NaN; the port's chunked
    gradient equals ``jax.grad`` of the reference's token-by-token
    recurrence."""
    assert float(ref["mamba/max_decay"]) > EXP_MAX
    chunked = dict(_leaves(_tree(ref, "mamba/chunked/0")))
    assert np.isnan(chunked["/dt_bias"]).all() and np.isnan(chunked["/A_log"]).all()
    cfg = dataclasses.replace(_f32_cfg("mamba2-370m"), ssm_chunk=128)
    p = {n: _t(a).requires_grad_(True) for n, a in _tree(ref, "mamba/params").items()}
    x = _t(ref["mamba/x"]).requires_grad_(True)
    loss = (ssm_mod.mamba_forward(cfg, p, x) * _t(ref["mamba/w"])).sum()
    grads = dict(zip([*("/" + n for n in p), "x"], torch.autograd.grad(loss, [*p.values(), x])))
    want = dict(_leaves(_tree(ref, "mamba/recurrent/0")))
    want["x"] = ref["mamba/recurrent/1"]
    assert sorted(grads) == sorted(want)
    for n, g in grads.items():
        assert torch.isfinite(g).all(), n
        _close(_np(g), want[n], rtol=1e-4, atol_rel=1e-4, err_msg=n)


def test_ssd_gradient_matches_reference_at_chunk_16(ref):
    _, _, got = _ssd_grads(ref, 16)
    for k, g in got.items():
        want = ref[f"ssd/16/grad/{k}"]
        assert np.isfinite(want).all(), k
        _close(_np(g), want, rtol=1e-5, atol_rel=1e-5, err_msg=k)


# -- the trainer and the data pipeline ----------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_batches_equal_the_reference_pipeline(ref, arch):
    batch = next(make_batch_iterator(get_smoke_config(arch), 4, 8, 32, seed=3))
    want = _tree(ref, f"batch/{arch}")
    assert sorted(batch) == sorted(want) == ["tokens"]
    assert batch["tokens"].dtype == want["tokens"].dtype
    assert np.array_equal(batch["tokens"], want["tokens"])


def _port_run(ref, arch, tag):
    traces = interop.traces_from_arrays(*(ref[f"traces/{f}"] for f in (
        "comm", "comp_unit", "slowdown", "burst_start", "burst_end", "burst_factor")))
    tc = TrainConfig(dsag=True, optimizer="sgd", learning_rate=RUN_LR, dsag_cache_dtype="float32")
    trn = Trainer(TrainerOptions(
        arch=arch, dtype="float32", steps=RUN_STEPS, global_batch=RUN_BATCH, seq_len=RUN_SEQ,
        traces=traces, scenario=0, simulate_stragglers=False, train_config=tc,
        log_every=10**6, engine=CPU))
    init = _tree(ref, tag + "/init")
    state = interop.model_train_state_from_arrays(
        trn.cfg, init["params"], init["opt"], init["dsag"], int(init["step"]), device="cpu",
        slot_dtype=torch.float32)
    trn.init_state = lambda: state
    return trn, trn.run()


def test_reference_trainer_goes_nan_where_the_port_does_not(ref):
    """The reference's SSD fault at the smoke config's chunk of 16: the
    first batch's gradient overflows (dt reaches ~16 at this init, and a
    16-token chunk sums past 88.7), and the reference's loss is NaN from the
    second step; the port's stays finite, its first loss the reference's."""
    tag = "run_unrepaired/mamba2-370m"
    want = ref[f"{tag}/loss"]
    assert np.isfinite(want[0]) and np.isnan(want[1:]).all()
    _, hist = _port_run(ref, "mamba2-370m", tag)
    assert np.isfinite(hist["loss"]).all()
    _close(hist["loss"][:1], want[:1], rtol=1e-5, atol_rel=0)


@pytest.mark.parametrize("arch", FAMILIES)
def test_trainer_matches_reference(ref, arch):
    """Against the reference trainer with its SSD repaired (the port's
    masked exponent); the other families run no SSD."""
    tag = f"run/{arch}"
    trn, hist = _port_run(ref, arch, tag)
    for f in ("mask_stream", "flush_stream", "evict_stream"):
        assert np.array_equal(np.stack(hist[f]), ref[f"{tag}/{f}"]), f
    assert np.array_equal(np.asarray(hist["xi"], np.float32), ref[f"{tag}/xi"].astype(np.float32))
    assert np.array_equal(hist["mask_count"], ref[f"{tag}/mask_count"])
    # the replayed traces masked a straggler and flushed its stale result
    assert min(hist["mask_count"]) < 4 and np.stack(hist["flush_stream"]).any()
    _close(hist["loss"], ref[f"{tag}/loss"], rtol=1e-6, atol_rel=0)
    layout = FlatLayout.from_decls(model_decls(trn.cfg), trn.cfg.dtype)
    want = layout.flatten(tree_map(torch.as_tensor, _tree(ref, tag + "/final")))
    got = trn.state["params"]
    assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) <= 1e-6


# -- on the card --------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_gpu_moe_backward_is_deterministic(card, arch):
    cfg = dataclasses.replace(_f32_cfg(arch), moe_dispatch_chunks=2)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    p = {k: v[0] for k, v in params["blocks"]["moe"].items()}
    x = torch.randn(4, 32, cfg.d_model, generator=torch.Generator().manual_seed(1))
    w = torch.randn(4, 32, cfg.d_model, generator=torch.Generator().manual_seed(2))
    _, cpu = _moe_loss_and_grads(cfg, p, x, w, 0.5)
    on_card = [_moe_loss_and_grads(cfg, tree_map(lambda t: t.to(card), p), x.to(card),
                                   w.to(card), 0.5)[1] for _ in range(2)]
    for n, g in cpu.items():
        assert torch.equal(on_card[0][n], on_card[1][n]), n
        _close(_np(on_card[0][n]), _np(g), rtol=1e-5, atol_rel=1e-5, err_msg=n)
