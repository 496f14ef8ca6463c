"""The rest of the model registry held against the JAX reference, on the CPU:
qwen1.5-32b and starcoder2-15b (dense; the GELU MLP), pixtral-12b (VLM: an
image prefix) and whisper-base (enc-dec: layernorm, learned positions, an
encoder and cross-attention).

The reference runs in ONE subprocess for this module (``_REF_SCRIPT``, with
the jax-0.9 shim of ``test_torch_serve.py``); it builds every input from
numpy seeds (the models' parameters from the reference's own
``Model.init(jax.random.key(0))``, the image and audio embeddings drawn as
the reference's CLI draws them, normal times 0.1 in bfloat16) and writes
inputs and outputs to an ``.npz``.  This process never imports ``jax`` or
``repro``.  The models are the four smoke configs, and whisper-base-smoke and
qwen1.5-32b-smoke with ``head_pad_to = kv_pad_to = 8`` (4 heads padded to
8: the padded heads are real heads with their own random weights, as in the
reference).

Tolerances, and why:

* ``layernorm``, the GELU MLP, ``encoder_kv``, ``cross_attention_forward``
  and ``_encode`` in float32: ``rtol=1e-5``, ``atol = 1e-5 * max|ref|``
  (another libm for tanh and rsqrt, another summation order in the means
  and einsums).
* The smoke models in float32 (prefill logits, every cache leaf with
  ``cross_k``/``cross_v``, four decode steps' logits and caches):
  ``rtol=1e-4``, ``atol = 1e-4 * max|ref|``, as ``test_torch_serve.py``
  holds the dense ones (the init scales stacked projections by
  ``1/sqrt(L)``, so activations grow through the layers and float32
  rounding with them).  Greedy tokens from ``Server.generate`` are equal.
* The smoke models in bfloat16, the reference run op by op
  (``jax.disable_jit()``, where every op rounds its result once, as the
  port's eager ops do): within two bfloat16 ulps of the largest value,
  ``atol = 2**-6 * max|ref|``, as for the other families (a sum next to a
  rounding boundary may round the other way, and later values carry it).
* ``train_loss`` in float32: ``rtol=1e-5`` (one scalar, a mean of
  logsumexps).  Its gradient, leaf by leaf against the reference's
  ``value_and_grad``: ``rtol=1e-4``, ``atol = 1e-4 * max|ref| + 4 *
  spread``, where ``spread`` is the reference's own: the largest change of
  the reference's gradient of that leaf when every parameter moves by one
  float32 ulp (directions from a seed), so the bound is set by the function,
  never by the port.  At this random init the gradient is ill-conditioned:
  layernorm over the encoder's small inputs amplifies rounding (whisper with
  padded heads: one ulp moves the encoder's layernorm gradients by 0.4% of
  their largest value), and the key biases' gradients are zero in exact
  arithmetic (a bias on every key adds one constant to a query's scores,
  which the softmax cancels), so both sides hold rounding noise there.  The
  gap beyond ``1e-4`` was measured at up to 2.5 times ``spread`` (whisper's
  key biases; 1.5 times at its padded encoder's layernorm scales).
* ``num_params`` of the four published configs: equal, counted from the
  declarations with nothing allocated.

Tests marked ``gpu`` hold the server through K6 against the server through
the plain attention in float32 on the four smoke configs (greedy tokens
equal, K6's launches per prefill and decode step counted); they skip
without a card (``pytest -m gpu tests/test_torch_registry.py``).
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

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.experiments.engine import CAP_ARCH, EngineCapabilityError
from repro_torch.interop import model_params_from_arrays
from repro_torch.kernels import flash_attention as k6
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch.serve import Server, stub_batch
from repro_torch.models import attention as attn
from repro_torch.models import build_model, cache_abstract
from repro_torch.models.layers import layernorm, mlp_apply, set_path
from repro_torch.models.model import _encode

REPO = Path(__file__).resolve().parents[1]
ARCHS = ("qwen1.5-32b", "starcoder2-15b", "pixtral-12b", "whisper-base")
#: the padded variants: (arch, head_pad_to = kv_pad_to)
PADDED = (("whisper-base", 8), ("qwen1.5-32b", 8))
#: model cases: (name, arch, pad, dtype); name keys the reference's outputs
MODEL_CASES = ([(a, a, 1, dt) for a in ARCHS for dt in ("float32", "bfloat16")]
               + [(f"{a}-pad{p}", a, p, "float32") for a, p in PADDED])
#: batch, prompt, cache slack, decode steps, generated tokens (GEN + 8 <= SLACK + STEPS)
B, S, SLACK, STEPS, GEN = 2, 12, 12, 4, 8

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
from repro.configs import get_config, get_smoke_config
from repro.launch.serve import Server
from repro.models import attention as attn, build_model
from repro.models.layers import layernorm, mlp_apply
from repro.models.model import _encode

P = {params}
out = {{}}
rng = np.random.default_rng(23)
f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))

def flat(tree, prefix):
    if isinstance(tree, dict):
        for key, val in tree.items():
            flat(val, f"{{prefix}}/{{key}}")
    else:
        out[prefix] = f32(tree)

def cfg_of(arch, pad, dt):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dt)
    return cfg if pad == 1 else dataclasses.replace(cfg, head_pad_to=pad, kv_pad_to=pad)

def layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)

# -- layers: layernorm and the GELU MLP (float32) ------------------------------------
x = jnp.asarray(rng.normal(size=(2, 5, 64)).astype(np.float32) * 3)
ln = {{"scale": jnp.asarray(rng.normal(size=(64,)).astype(np.float32)),
       "bias": jnp.asarray(rng.normal(size=(64,)).astype(np.float32))}}
mlp = {{n: jnp.asarray(rng.normal(size=s).astype(np.float32) * 0.2)
        for n, s in (("w_up", (64, 96)), ("b_up", (96,)), ("w_down", (96, 64)), ("b_down", (64,)))}}
out["layers/x"] = f32(x)
flat(ln, "layers/ln")
flat(mlp, "layers/mlp")
out["layers/layernorm"] = f32(layernorm(ln, x, 1e-5))
out["layers/gelu_mlp"] = f32(mlp_apply(mlp, x, swiglu=False))

# -- the smoke models: parameters, published sizes ---------------------------------------
B, S, SLACK, STEPS, GEN = P["sizes"]
params32 = {{}}
for name, arch, pad, dt in P["models"]:
    if dt == "float32":
        model = build_model(cfg_of(arch, pad, "float32"))
        params32[name] = jax.jit(model.init)(jax.random.key(0))
        flat(params32[name], f"model/{{name}}/params")
for arch in P["archs"]:
    out[f"num_params/{{arch}}"] = np.array(build_model(get_config(arch)).num_params())

def embeds(cfg, name):
    # the reference CLI's stub frontends: normal * 0.1 in bfloat16
    if cfg.family == "enc_dec":
        n, key = cfg.encoder_seq, "audio_embed"
    elif cfg.family == "vlm":
        n, key = cfg.num_image_tokens, "image_embed"
    else:
        return {{}}
    e = jnp.asarray(rng.normal(size=(B, n, cfg.d_model)) * 0.1, jnp.bfloat16)
    out[f"model/{{name}}/{{key}}"] = f32(e)
    return {{key: e}}

# -- whisper's parts: encoder_kv, cross_attention_forward, _encode (float32) -------------
cfg = cfg_of("whisper-base", 1, "float32")
p = params32["whisper-base"]
audio = jnp.asarray(rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)) * 0.1, jnp.bfloat16)
out["whisper/audio"] = f32(audio)
enc = jax.jit(lambda p, a: _encode(cfg, p, a))(p, audio)
out["whisper/encode"] = f32(enc)
cross = layer0(p["blocks"]["cross"])
ek, ev = attn.encoder_kv(cfg, cross, enc)
out["whisper/ek"], out["whisper/ev"] = f32(ek), f32(ev)
xq = jnp.asarray(rng.normal(size=(B, 7, cfg.d_model)).astype(np.float32))
out["whisper/xq"] = f32(xq)
out["whisper/cross"] = f32(attn.cross_attention_forward(cfg, cross, xq, ek, ev))

# -- whole models: float32 compiled, bfloat16 op by op ----------------------------------
for name, arch, pad, dt in P["models"]:
    cfg = cfg_of(arch, pad, dt)
    model = build_model(cfg)
    base = name if dt == "float32" else arch
    params = jax.tree.map(lambda a, s: a.astype(s.dtype), params32[base], model.abstract())
    pre = f"model/{{name}}/{{dt}}/"
    if dt == "float32":
        toks = rng.integers(0, cfg.vocab_size, size=(B, S + STEPS)).astype(np.int32)
        out[f"model/{{name}}/tokens"] = toks
        extra = embeds(cfg, name)
        inputs = (toks, extra)
    toks, extra = inputs
    n_img = cfg.num_image_tokens if cfg.family == "vlm" else 0
    if dt == "float32":
        prefill = jax.jit(lambda p, b: model.prefill(p, b, cache_len=S + n_img + SLACK))
        dec = jax.jit(model.decode_step)
    else:
        prefill = lambda p, b: model.prefill(p, b, cache_len=S + n_img + SLACK)
        dec = model.decode_step
    with jax.disable_jit(dt == "bfloat16"):
        logits, cache = prefill(params, dict(extra, tokens=jnp.asarray(toks[:, :S])))
        out[pre + "prefill/logits"] = f32(logits)
        flat(cache, pre + "prefill/cache")
        for t in range(STEPS):
            logits, cache = dec(params, jnp.asarray(toks[:, S + t:S + t + 1]), cache,
                                jnp.int32(S + n_img + t))
            out[pre + f"decode/{{t}}/logits"] = f32(logits)
            flat(cache, pre + f"decode/{{t}}/cache")
    if dt == "float32":
        batch = dict(extra, tokens=jnp.asarray(toks))
        vg = jax.jit(jax.value_and_grad(lambda p, b: model.train_loss(p, b)))
        loss, grads = vg(params, batch)
        out[pre + "loss"] = f32(loss)
        flat(grads, pre + "grad")
        # the reference's own spread: its gradient with every parameter moved
        # by one float32 ulp, up or down as a seeded draw says
        nr = np.random.default_rng(1)
        inf = np.float32(np.inf)
        nudged = jax.tree.map(lambda a: jnp.asarray(np.nextafter(
            np.asarray(a), np.where(nr.integers(0, 2, a.shape).astype(bool), inf, -inf))), params)
        flat(jax.tree.map(lambda g, h: np.abs(f32(g) - f32(h)).max(), grads, vg(nudged, batch)[1]),
             pre + "spread")
        # the reference's Server over these parameters and the compiled steps
        srv = Server.__new__(Server)
        srv.cfg, srv.model, srv.params, srv.max_len = cfg, model, params, S + n_img + GEN + 8
        srv._prefill = jax.jit(lambda p, b: model.prefill(p, b, cache_len=srv.max_len))
        srv._decode = dec
        out[pre + "generate"] = np.asarray(
            srv.generate(dict(extra, tokens=jnp.asarray(toks[:, :S])), GEN))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every reference output of this module, from one JAX subprocess."""
    params = dict(models=MODEL_CASES, sizes=(B, S, SLACK, STEPS, GEN), archs=ARCHS)
    path = tmp_path_factory.mktemp("jax_registry_reference") / "ref.npz"
    # op by op, every primitive compiles once per shape: at LLVM's -O0 that
    # takes a third less time and computes the same bits (no fast math)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_backend_optimization_level=0")
    proc = subprocess.run(
        [sys.executable, "-c", _REF_SCRIPT.format(params=repr(params)), str(path)],
        env=env, capture_output=True, text=True, timeout=900,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"reference subprocess failed:\n{proc.stderr[-4000:]}")
    with np.load(path) as z:
        return dict(z)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a, dtype=np.float32)).to(dtype)


def _np(t) -> np.ndarray:
    """A float32 copy (the caches are written in place after it is taken)."""
    return t.detach().to(torch.float32).cpu().numpy().copy()


def _close(got, want, rtol, atol_rel, what=""):
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * float(np.abs(want).max()),
                               err_msg=what)


def _model_close(dt: str, got, want):
    if dt == "float32":
        _close(got, want, rtol=1e-4, atol_rel=1e-4)
    else:
        _close(got, want, rtol=0, atol_rel=2.0**-6)


def _tree(ref, prefix: str, dtype=None) -> dict:
    """The nested dict stored under ``prefix`` (as tensors with ``dtype``)."""
    out: dict = {}
    for key, val in ref.items():
        if key.startswith(prefix + "/"):
            node = out
            *path, leaf = key[len(prefix) + 1:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = val if dtype is None else _t(val, dtype)
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _cfg(arch: str, pad: int, dt: str):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dt)
    return cfg if pad == 1 else dataclasses.replace(cfg, head_pad_to=pad, kv_pad_to=pad)


def _setup(ref, name: str, arch: str, pad: int, dt: str):
    """(cfg, params, prefix, tokens, embeddings) of one model case; the
    bfloat16 models' parameters are the float32 init cast, as the
    reference's."""
    cfg = _cfg(arch, pad, dt)
    base = name if dt == "float32" else arch
    params = model_params_from_arrays(cfg, _tree(ref, f"model/{base}/params"), device="cpu")
    extra = {k: _t(ref[f"model/{base}/{k}"], torch.bfloat16)
             for k in ("audio_embed", "image_embed") if f"model/{base}/{k}" in ref}
    return cfg, params, f"model/{name}/{dt}/", torch.as_tensor(ref[f"model/{base}/tokens"]), extra


# -- layers and whisper's parts -----------------------------------------------------------


@pytest.mark.parametrize("part", ["layernorm", "gelu_mlp"])
def test_layers_match_reference(ref, part):
    x = _t(ref["layers/x"])
    if part == "layernorm":
        got = layernorm(_tree(ref, "layers/ln", torch.float32), x, 1e-5)
    else:
        got = mlp_apply(_tree(ref, "layers/mlp", torch.float32), x, swiglu=False)
    assert got.dtype == torch.float32
    _close(_np(got), ref[f"layers/{part}"], rtol=1e-5, atol_rel=1e-5)


def test_layernorm_takes_the_population_variance():
    x = torch.tensor([[1.0, 2.0, 3.0, 6.0]])
    p = {"scale": torch.ones(4), "bias": torch.zeros(4)}
    want = (x - 3.0) / np.sqrt(3.5 + 1e-5)  # var = 14 / 4, not 14 / 3
    assert torch.allclose(layernorm(p, x, 1e-5), want, rtol=1e-6)


def test_whisper_encoder_and_cross_attention_match_reference(ref):
    cfg = _cfg("whisper-base", 1, "float32")
    params = model_params_from_arrays(cfg, _tree(ref, "model/whisper-base/params"), device="cpu")
    with torch.inference_mode():
        enc = _encode(cfg, params, _t(ref["whisper/audio"], torch.bfloat16), backend="torch")
        _close(_np(enc), ref["whisper/encode"], rtol=1e-5, atol_rel=1e-5)
        cross = {n: a[0] for n, a in params["blocks"]["cross"].items()}
        enc_ref = _t(ref["whisper/encode"])
        ek, ev = attn.encoder_kv(cfg, cross, enc_ref)
        _close(_np(ek), ref["whisper/ek"], rtol=1e-5, atol_rel=1e-5)
        _close(_np(ev), ref["whisper/ev"], rtol=1e-5, atol_rel=1e-5)
        got = attn.cross_attention_forward(cfg, cross, _t(ref["whisper/xq"]),
                                           _t(ref["whisper/ek"]), _t(ref["whisper/ev"]))
    _close(_np(got), ref["whisper/cross"], rtol=1e-5, atol_rel=1e-5)


# -- the smoke models -----------------------------------------------------------------


@pytest.mark.parametrize(("name", "arch", "pad", "dt"), MODEL_CASES)
def test_prefill_and_decode_match_reference(ref, name, arch, pad, dt):
    cfg, params, pre, toks, extra = _setup(ref, name, arch, pad, dt)
    model = build_model(cfg, kernel_backend="torch")
    n_img = cfg.num_image_tokens if cfg.family == "vlm" else 0
    got = {}
    with torch.inference_mode():
        logits, cache = model.prefill(params, dict(extra, tokens=toks[:, :S]),
                                      cache_len=S + n_img + SLACK)
        assert logits.dtype == getattr(torch, dt)
        got["prefill"] = (_np(logits), {n: _np(t) for n, t in _leaves(cache)})
        for t in range(STEPS):
            logits, cache = model.decode_step(params, toks[:, S + t:S + t + 1], cache,
                                              S + n_img + t)
            got[f"decode/{t}"] = (_np(logits), {n: _np(t) for n, t in _leaves(cache)})
    for step, (logits, leaves) in got.items():
        _model_close(dt, logits, ref[pre + f"{step}/logits"])
        want = dict(_leaves(_tree(ref, pre + f"{step}/cache")))
        assert leaves.keys() == want.keys()
        for leaf, t in leaves.items():
            assert t.shape == want[leaf].shape, leaf
            _model_close(dt, t, want[leaf])


def _loss_and_grads(model, params, batch):
    """(loss, {leaf path: gradient}) of ``model.train_loss``."""
    names, leaves = [], []
    for n, t in _leaves(params):
        names.append(n)
        leaves.append(t.detach().clone().requires_grad_(True))
    tree: dict = {}
    for n, t in zip(names, leaves):
        set_path(tree, tuple(n.strip("/").split("/")), t)
    loss = model.train_loss(tree, batch, remat="full")
    return loss.detach(), dict(zip(names, torch.autograd.grad(loss, leaves)))


@pytest.mark.parametrize(("name", "arch", "pad"), [(n, a, p) for n, a, p, dt in MODEL_CASES
                                                   if dt == "float32"])
def test_train_loss_and_gradient_match_reference(ref, name, arch, pad):
    cfg, params, pre, toks, extra = _setup(ref, name, arch, pad, "float32")
    model = build_model(cfg)
    batch = dict(extra, tokens=toks)
    loss, grads = _loss_and_grads(model, params, batch)
    _close([float(loss)], [float(ref[pre + "loss"])], rtol=1e-5, atol_rel=0)
    want = dict(_leaves(_tree(ref, pre + "grad")))
    spread = dict(_leaves(_tree(ref, pre + "spread")))
    assert sorted(grads) == sorted(want) == sorted(spread)
    for n, g in grads.items():
        w = np.asarray(want[n], dtype=np.float64)
        np.testing.assert_allclose(_np(g), w, rtol=1e-4, err_msg=n,
                                   atol=1e-4 * float(np.abs(w).max()) + 4 * float(spread[n]))


@pytest.mark.parametrize(("name", "arch", "pad"), [(n, a, p) for n, a, p, dt in MODEL_CASES
                                                   if dt == "float32"])
def test_server_generate_equals_reference_in_float32(ref, name, arch, pad):
    cfg, params, pre, toks, extra = _setup(ref, name, arch, pad, "float32")
    n_img = cfg.num_image_tokens if cfg.family == "vlm" else 0
    srv = Server(arch, smoke=True, max_len=S + n_img + GEN + 8, device="cpu",
                 kernel_backend="torch")
    srv.cfg, srv.model, srv.params = cfg, build_model(cfg, kernel_backend="torch"), params
    reset_launch_counts()
    got = srv.generate(dict(extra, tokens=toks[:, :S].numpy()), GEN)
    assert got.dtype == torch.int32 and got.shape == (B, GEN)
    np.testing.assert_array_equal(got.numpy(), ref[pre + "generate"])
    assert launch_counts()["flash_attention"] == 0  # CPU tensors: the plain path


@pytest.mark.parametrize("arch", ARCHS)
def test_num_params_and_cache_layout(ref, arch):
    cfg = get_config(arch)
    assert build_model(cfg).num_params() == int(ref[f"num_params/{arch}"])
    c = cache_abstract(cfg, 4, 1064)
    L, hd = cfg.num_layers, cfg.resolved_head_dim
    kvh = -(-cfg.num_kv_heads // cfg.kv_pad_to) * cfg.kv_pad_to
    assert c["k"].shape == (L, 4, 1064, kvh, hd) and c["v"].device.type == "meta"
    if cfg.family == "enc_dec":
        assert c["cross_k"].shape == (L, 4, 1500, 16, 64) and c["cross_v"].dtype == torch.bfloat16
    else:
        assert set(c) == {"k", "v"}


def test_model_params_from_arrays_carries_whispers_tree(ref):
    cfg = get_smoke_config("whisper-base")
    tree = _tree(ref, "model/whisper-base/params")
    assert {"enc_blocks", "enc_pos", "pos", "enc_ln_f"} <= set(tree)
    assert {"cross", "ln_x"} <= set(tree["blocks"])
    params = model_params_from_arrays(cfg, tree, device="cpu")
    assert params["blocks"]["cross"]["wq"].dtype == torch.bfloat16
    assert params["enc_blocks"]["ln1"]["bias"].dtype == torch.float32
    assert torch.equal(params["enc_pos"].float(),
                       _t(tree["enc_pos"]).to(torch.bfloat16).float())
    # the layout is whisper's: a tree without its encoder is refused
    bad = {k: v for k, v in tree.items() if k != "enc_blocks"}
    with pytest.raises(ValueError, match="keys"):
        model_params_from_arrays(cfg, bad, device="cpu")


# -- the CPU entry points and what stays refused ---------------------------------------------


def test_learned_positions_clamp_as_the_reference_slices():
    cfg = dataclasses.replace(get_smoke_config("whisper-base"), dtype="float32")
    model = build_model(cfg, kernel_backend="torch")
    params = model.init(torch.Generator().manual_seed(0))
    from repro_torch.models.transformer import embed_inputs

    toks = torch.zeros((1, 4), dtype=torch.long)
    n = cfg.max_position_embeddings
    tok = params["embed"]["tok"][0]
    for offset, start in ((0, 0), (5, 5), (n - 4, n - 4), (n - 2, n - 4), (n + 50, n - 4)):
        got = embed_inputs(cfg, params, toks, offset=offset)
        assert torch.equal(got[0], tok + params["pos"][start:start + 4])
    with pytest.raises(ValueError, match="learned table"):
        embed_inputs(cfg, params, torch.zeros((1, n + 1), dtype=torch.long))


def test_k6_bshd_takes_any_non_causal_key_count_and_the_op_keeps_its_refusal():
    rng = np.random.default_rng(2)
    q = torch.as_tensor(rng.normal(size=(2, 7, 4, 16)), dtype=torch.float32)
    k, v = (torch.as_tensor(rng.normal(size=(2, 150, 2, 16)), dtype=torch.float32)
            for _ in range(2))
    got = k6.flash_attention_bshd(q, k, v, causal=False)
    want = attn.full_attention(q, attn._repeat_kv(k, 2), attn._repeat_kv(v, 2), causal=False)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="block_k"):
        k6.flash_attention_op(q.transpose(1, 2), *(t.repeat_interleave(2, 2).transpose(1, 2)
                                                   for t in (k, v)), causal=False)
    with pytest.raises(ValueError, match="sq <= sk"):
        k6.flash_attention_bshd(k.repeat_interleave(2, 2), q[:, :, :2], q[:, :, :2])


def test_serve_cli_and_example_take_the_stub_frontends(capsys):
    from repro_torch.examples import serve_decode
    from repro_torch.launch import serve

    for arch in ("whisper-base", "pixtral-12b"):
        cfg = get_smoke_config(arch)
        batch = stub_batch(cfg, 2, 6)
        key = "audio_embed" if arch == "whisper-base" else "image_embed"
        n = cfg.encoder_seq if arch == "whisper-base" else cfg.num_image_tokens
        assert batch[key].shape == (2, n, 64) and batch[key].dtype == torch.bfloat16
        serve.main(["--arch", arch, "--device", "cpu", "--kernel-backend", "torch",
                    "--tokens", "4", "--batch", "2"])
        assert "generated (2, 4)" in capsys.readouterr().out
        serve_decode.main(["--arch", arch, "--device", "cpu", "--kernel-backend", "torch",
                           "--tokens", "5"])
        assert f"[{arch}] generated 4x5 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ("pixtral-12b", "whisper-base"))
def test_trainer_takes_the_vlm_and_enc_dec_batches(arch):
    from repro_torch.experiments.engine import EngineConfig
    from repro_torch.launch.train import Trainer, TrainerOptions

    tr = Trainer(TrainerOptions(arch=arch, steps=3, seq_len=32, log_every=1, dtype="float32",
                                engine=EngineConfig(device="cpu", kernel_backend="torch")))
    reset_launch_counts()
    hist = tr.run()
    assert len(hist["loss"]) == 3 and all(np.isfinite(hist["loss"]))
    assert launch_counts()["dsag_cache_update"] == 0  # CPU: K4's plain version


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_refuses_foreign_embeddings(arch):
    cfg = get_smoke_config(arch)
    model = build_model(cfg, kernel_backend="torch")
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 6), dtype=torch.long)
    foreign = ({"image_embed": torch.zeros(1, 8, 64)} if cfg.family != "vlm"
               else {"audio_embed": torch.zeros(1, 12, 64)})
    with pytest.raises(EngineCapabilityError) as e:
        model.prefill(params, {"tokens": toks, **foreign}, 16)
    assert e.value.capability.code == CAP_ARCH


# -- on the card --------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def k6_per_prefill(cfg) -> tuple[int, int]:
    """K6 launches per prefill and per decode step: each decoder layer's
    causal self-attention; whisper adds each encoder layer and each decoder
    layer's cross-attention, the latter at every decode step too."""
    if cfg.family == "enc_dec":
        return cfg.encoder_layers + 2 * cfg.num_layers, cfg.num_layers
    return cfg.num_layers, 0


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_gpu_server_through_k6_equals_plain_in_float32(card, arch):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    batch = stub_batch(cfg, 2, 12, seed=4)
    n_pre, n_dec = k6_per_prefill(cfg)
    out = {}
    for backend in ("cuda", "torch"):
        srv = Server(arch, device="cuda", kernel_backend=backend, max_len=64)
        srv.cfg, srv.model = cfg, build_model(cfg, kernel_backend=backend)
        srv.params = srv.model.init(torch.Generator(device=card).manual_seed(0))
        reset_launch_counts()
        out[backend] = srv.generate(batch, 8).cpu()
        want = n_pre + 7 * n_dec if backend == "cuda" else 0
        assert launch_counts()["flash_attention"] == want
    assert torch.equal(out["cuda"], out["torch"])
