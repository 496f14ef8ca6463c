"""The port's serving slice held against the JAX reference, on the CPU.

The reference runs in ONE subprocess for this module (``_REF_SCRIPT``); it
builds every input from numpy seeds (the models' parameters from the
reference's own ``Model.init(jax.random.key(0))``) and writes inputs and
outputs to an ``.npz``.  This process never imports ``jax`` or ``repro``.

Tolerances, and why:

* K6's plain version (``flash_attention_plain``) against the Pallas kernel in
  interpret mode and against ``ref.flash_attention_ref``: both sides compute
  in float32 and differ in summation order (the Pallas kernel also in its
  online softmax), so float32 inputs agree within ``rtol=1e-5`` plus
  ``atol = 1e-5 * max|ref|``.  bfloat16 outputs are rounded from those
  float32 results, and a float32 difference can move a value across a
  rounding boundary: they agree within one bfloat16 ulp (``rtol=2**-7``)
  plus the same ``atol``.
* ``rmsnorm``, ``apply_rope``, ``mlp_apply`` in float32: ``rtol=1e-5``,
  ``atol = 1e-5 * max|ref|`` (another libm and summation order).  In
  bfloat16: one bfloat16 ulp (``rtol=2**-7``, ``atol = 2**-7 * max|ref|``),
  since each op rounds its float32 result once, possibly on the other side.
* The smoke models in float32 (prefill logits, the whole KV cache, four
  decode steps' logits and caches, the next-token loss):
  ``rtol=1e-4``, ``atol = 1e-4 * max|ref|``; the reference's init scales
  stacked projections by ``1/sqrt(L)`` (std 0.71 at L = 2), so activations
  grow through the layers and float32 rounding with them.  Greedy tokens
  from ``Server.generate`` are equal.
* The smoke models in bfloat16 are held against the reference run op by op
  (``jax.disable_jit()``): compiled, XLA keeps float32 inside its fusions
  where the program rounds to bfloat16 (its default
  ``xla_allow_excess_precision``), while op by op every op rounds its result
  once, as the port's eager ops do.  Nearly every element is then equal; a
  sum that lands next to a rounding boundary can round the other way (0.2%
  of the cache elements at these sizes), and later values carry that one-ulp
  change.  Logits, caches and the loss agree within two bfloat16 ulps of the
  largest value: ``atol = 2**-6 * max|ref|``.

Tests marked ``gpu`` hold K6 against its plain version on the card and the
server through K6 against the server through the plain attention; they skip
without a card (``pytest -m gpu tests/test_torch_serve.py``).
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
from repro_torch.experiments.engine import (
    CAP_ARCH,
    CAP_CUDA_KERNELS_OFF_DEVICE,
    CAP_CUDA_UNAVAILABLE,
    EngineCapabilityError,
)
from repro_torch.interop import model_params_from_arrays
from repro_torch.kernels import flash_attention as k6
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch.serve import Server, stub_batch
from repro_torch.models import build_model, cache_abstract
from repro_torch.models.attention import (
    _attend,
    _repeat_kv,
    chunked_attention,
    full_attention,
)
from repro_torch.models.layers import apply_rope, mlp_apply, rmsnorm, set_path
from repro_torch.models.transformer import (
    apply_norm,
    backbone_forward,
    embed_inputs,
    lm_logits,
    next_token_loss,
)

REPO = Path(__file__).resolve().parents[1]
BF16_ULP = 2.0**-7

#: K6 cases: (b, h, sq, sk, d, causal); each in float32 and bfloat16
K6_CASES = [
    (1, 2, 64, 64, 64, True),  # causal, sq == sk
    (1, 2, 100, 130, 64, True),  # sq < sk, sk not a multiple of the block
    (2, 2, 1, 37, 64, True),  # one query row (decode-like)
    (1, 2, 128, 128, 64, False),  # non-causal
    (1, 2, 64, 64, 128, True),
    (1, 1, 100, 130, 128, True),
    (1, 2, 70, 70, 192, True),  # above 128: the reference pads d to 256 lanes
    (1, 1, 40, 96, 256, True),
]
K6_DTYPES = ("float32", "bfloat16")
#: calls at the edge of the contract: (sq, sk, causal, block_k)
K6_CONTRACT = [(8, 4, True, 128), (130, 129, True, 128), (128, 130, False, 128),
               (64, 64, False, 128), (4, 8, True, 128), (64, 256, False, 128)]
#: the dense archs (the other families: ``test_torch_families.py``)
ARCHS = ("qwen1.5-0.5b", "qwen2-7b")
#: model cases: smoke configs in both dtypes; prompt, cache slack, decode steps
MODEL_CASES = [(a, dt) for a in ARCHS for dt in ("float32", "bfloat16")]
B, S, SLACK, STEPS, GEN = 2, 12, 8, 4, 8

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
import contextlib
import numpy as np
import jax.numpy as jnp
from repro.configs import get_config, get_smoke_config
from repro.kernels import ops, ref
from repro.launch.serve import Server
from repro.models import build_model
from repro.models.layers import apply_norm, apply_rope, mlp_apply, rmsnorm
from repro.models.transformer import backbone_forward, embed_inputs, lm_logits, next_token_loss

P = {params}
out = {{}}
rng = np.random.default_rng(13)
f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
JDT = {{"float32": jnp.float32, "bfloat16": jnp.bfloat16}}

# -- K6: Pallas (interpret) and the jnp oracle -------------------------------------
for ci, (b, h, sq, sk, d, causal) in enumerate(P["k6"]):
    for dt in P["k6_dtypes"]:
        q, k, v = (jnp.asarray(rng.normal(size=(b, h, n, d)).astype(np.float32)).astype(JDT[dt])
                   for n in (sq, sk, sk))
        pre = f"k6/{{ci}}/{{dt}}/"
        out[pre + "q"], out[pre + "k"], out[pre + "v"] = f32(q), f32(k), f32(v)
        out[pre + "pallas"] = f32(ops.flash_attention_op(q, k, v, causal=causal, interpret=True))
        out[pre + "ref"] = f32(ref.flash_attention_ref(q, k, v, causal=causal))
for ci, (sq, sk, causal, bk) in enumerate(P["k6_contract"]):
    q = jnp.zeros((1, 1, sq, 64), jnp.float32)
    kv = jnp.zeros((1, 1, sk, 64), jnp.float32)
    try:
        ops.flash_attention_op(q, kv, kv, causal=causal, block_k=bk, interpret=True)
        out[f"k6_refused/{{ci}}"] = np.array(False)
    except ValueError:
        out[f"k6_refused/{{ci}}"] = np.array(True)

# -- the plain attention paths: full and query-chunked, with a query offset -----------
from repro.models.attention import chunked_attention, full_attention
qa, ka, va = (jnp.asarray(rng.normal(size=(2, n, 4, 16)).astype(np.float32)) for n in (32, 40, 40))
out["attn/q"], out["attn/k"], out["attn/v"] = f32(qa), f32(ka), f32(va)
for causal in (True, False):
    out[f"attn/full/{{causal}}"] = f32(full_attention(qa, ka, va, causal=causal, q_offset=8))
    out[f"attn/chunked/{{causal}}"] = f32(
        chunked_attention(qa, ka, va, causal=causal, q_offset=8, chunk=8))

# -- layers --------------------------------------------------------------------------
for dt in ("float32", "bfloat16"):
    x = jnp.asarray(rng.normal(size=(2, 5, 64)).astype(np.float32) * 3).astype(JDT[dt])
    scale = jnp.asarray(rng.normal(size=(64,)).astype(np.float32))
    xr = jnp.asarray(rng.normal(size=(2, 5, 3, 16)).astype(np.float32)).astype(JDT[dt])
    pos = jnp.asarray(rng.integers(0, 5000, size=(2, 5)), jnp.int32)
    mlp = {{n: jnp.asarray(rng.normal(size=s).astype(np.float32) * 0.2).astype(JDT[dt])
           for n, s in (("w_gate", (64, 96)), ("w_up", (64, 96)), ("w_down", (96, 64)))}}
    pre = f"layers/{{dt}}/"
    out[pre + "x"], out[pre + "scale"], out[pre + "xr"], out[pre + "pos"] = (
        f32(x), f32(scale), f32(xr), np.asarray(pos))
    for n, a in mlp.items():
        out[pre + n] = f32(a)
    out[pre + "rmsnorm"] = f32(rmsnorm({{"scale": scale}}, x, 1e-5))
    out[pre + "rope"] = f32(apply_rope(xr, pos, 10_000.0))
    out[pre + "mlp"] = f32(mlp_apply(mlp, x))

# -- the smoke models ------------------------------------------------------------------
def flat(tree, prefix):
    if isinstance(tree, dict):
        for key, val in tree.items():
            flat(val, f"{{prefix}}/{{key}}")
    else:
        out[prefix] = f32(tree)

B, S, SLACK, STEPS, GEN = P["sizes"]
for arch, dt in P["models"]:
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dt)
    model = build_model(cfg)
    params = model.init(jax.random.key(0))
    pre = f"model/{{arch}}/{{dt}}/"
    flat(params, pre + "params")
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + STEPS)).astype(np.int32)
    out[pre + "tokens"] = toks
    # float32 compiled; bfloat16 op by op, where every op rounds as the port's do
    with contextlib.nullcontext() if dt == "float32" else jax.disable_jit():
        logits, cache = jax.jit(lambda p, t: model.prefill(p, {{"tokens": t}}, cache_len=S + SLACK))(
            params, jnp.asarray(toks[:, :S]))
        out[pre + "prefill/logits"], out[pre + "prefill/k"], out[pre + "prefill/v"] = (
            f32(logits), f32(cache["k"]), f32(cache["v"]))
        dec = jax.jit(model.decode_step)
        for t in range(STEPS):
            logits, cache = dec(params, jnp.asarray(toks[:, S + t:S + t + 1]), cache, jnp.int32(S + t))
            out[pre + f"decode/{{t}}/logits"] = f32(logits)
            out[pre + f"decode/{{t}}/k"], out[pre + f"decode/{{t}}/v"] = f32(cache["k"]), f32(cache["v"])
        # the training forward: embed, blocks, final norm, logits, next-token loss
        x = embed_inputs(cfg, params, jnp.asarray(toks))
        positions = jnp.broadcast_to(jnp.arange(x.shape[1]), x.shape[:2])
        x, _ = backbone_forward(cfg, params, x, positions, remat="none")
        lg = lm_logits(cfg, params, apply_norm(cfg, params["ln_f"], x))
        out[pre + "loss"] = f32(next_token_loss(cfg, lg, jnp.asarray(toks)))
    if dt == "float32":
        # the server: greedy tokens from the reference's Server over these parameters
        srv = Server(arch, smoke=True, max_len=S + GEN + 8)
        srv.cfg, srv.model, srv.params = cfg, model, params
        srv._decode = jax.jit(model.decode_step, donate_argnums=(2,))
        out[pre + "generate"] = np.asarray(srv.generate({{"tokens": jnp.asarray(toks[:, :S])}}, GEN))
for arch in P["archs"]:
    out[f"num_params/{{arch}}"] = np.array(build_model(get_config(arch)).num_params())
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every reference output of this module, from one JAX subprocess."""
    params = dict(k6=K6_CASES, k6_dtypes=K6_DTYPES, k6_contract=K6_CONTRACT,
                  models=MODEL_CASES, sizes=(B, S, SLACK, STEPS, GEN), archs=ARCHS)
    path = tmp_path_factory.mktemp("jax_serve_reference") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _REF_SCRIPT.format(params=repr(params)), str(path)],
        env=env, capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"reference subprocess failed:\n{proc.stderr[-4000:]}")
    with np.load(path) as z:
        return dict(z)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a, dtype=np.float32)).to(dtype)


def _np(t) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


def _close(got, want, rtol, atol_rel):
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * float(np.abs(want).max()))


def _model_close(dt: str, got, want):
    if dt == "float32":
        _close(got, want, rtol=1e-4, atol_rel=1e-4)
    else:
        _close(got, want, rtol=0, atol_rel=2.0**-6)


# -- K6 ---------------------------------------------------------------------------------


@pytest.mark.parametrize("dt", K6_DTYPES)
@pytest.mark.parametrize("ci", range(len(K6_CASES)))
@pytest.mark.parametrize("against", ["pallas", "ref"])
def test_k6_plain_matches_reference(ref, ci, dt, against):
    causal = K6_CASES[ci][5]
    pre = f"k6/{ci}/{dt}/"
    q, k, v = (_t(ref[pre + n], _dtype(dt)) for n in "qkv")
    got = k6.flash_attention_op(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    rtol = 1e-5 if dt == "float32" else BF16_ULP
    _close(_np(got), ref[pre + against], rtol=rtol, atol_rel=1e-5)


@pytest.mark.parametrize("ci", range(len(K6_CONTRACT)))
def test_k6_refuses_what_the_reference_refuses(ref, ci):
    sq, sk, causal, bk = K6_CONTRACT[ci]
    refused = bool(ref[f"k6_refused/{ci}"])
    assert refused == (sq > sk if causal else sk % bk != 0)
    q, kv = torch.zeros(1, 1, sq, 64), torch.zeros(1, 1, sk, 64)
    if refused:
        with pytest.raises(ValueError):
            k6.flash_attention_op(q, kv, kv, causal=causal, block_k=bk)
    else:
        assert k6.flash_attention_op(q, kv, kv, causal=causal, block_k=bk).shape == q.shape


def test_k6_bshd_layout_and_gqa_equal_the_op():
    rng = np.random.default_rng(3)
    q = torch.as_tensor(rng.normal(size=(2, 37, 6, 64)), dtype=torch.float32)
    k = torch.as_tensor(rng.normal(size=(2, 37, 2, 64)), dtype=torch.float32)
    v = torch.as_tensor(rng.normal(size=(2, 37, 2, 64)), dtype=torch.float32)
    got = k6.flash_attention_bshd(q, k, v)
    want = k6.flash_attention_op(q.transpose(1, 2), _repeat_kv(k, 3).transpose(1, 2),
                                 _repeat_kv(v, 3).transpose(1, 2)).transpose(1, 2)
    assert torch.equal(got, want)
    # the model's prefill attention on the CPU is the reference's full_attention
    plain = _attend(q, k, v, causal=True)
    assert torch.equal(plain, full_attention(q, _repeat_kv(k, 3), _repeat_kv(v, 3), causal=True))
    assert torch.allclose(plain, got, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", ["full", "chunked"])
def test_plain_attention_matches_reference(ref, kind, causal):
    q, k, v = (_t(ref[f"attn/{n}"]) for n in "qkv")
    if kind == "full":
        got = full_attention(q, k, v, causal=causal, q_offset=8)
    else:
        got = chunked_attention(q, k, v, causal=causal, q_offset=8, chunk=8)
    _close(_np(got), ref[f"attn/{kind}/{causal}"], rtol=1e-5, atol_rel=1e-5)


# -- layers -----------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("layer", ["rmsnorm", "rope", "mlp"])
def test_layers_match_reference(ref, dt, layer):
    pre = f"layers/{dt}/"
    tdt = _dtype(dt)
    x = _t(ref[pre + "x"], tdt)
    if layer == "rmsnorm":
        got = rmsnorm({"scale": _t(ref[pre + "scale"])}, x, 1e-5)
    elif layer == "rope":
        got = apply_rope(_t(ref[pre + "xr"], tdt), torch.as_tensor(ref[pre + "pos"]), 10_000.0)
    else:
        got = mlp_apply({n: _t(ref[pre + n], tdt) for n in ("w_gate", "w_up", "w_down")}, x)
    assert got.dtype == tdt
    if dt == "float32":
        _close(_np(got), ref[pre + layer], rtol=1e-5, atol_rel=1e-5)
    else:
        _close(_np(got), ref[pre + layer], rtol=BF16_ULP, atol_rel=BF16_ULP)


# -- the smoke models -----------------------------------------------------------------


def _tree(ref, prefix: str) -> dict:
    out: dict = {}
    for key, val in ref.items():
        if key.startswith(prefix + "/"):
            node = out
            *path, leaf = key[len(prefix) + 1:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = val
    return out


def _setup(ref, arch: str, dt: str):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dt)
    pre = f"model/{arch}/{dt}/"
    params = model_params_from_arrays(cfg, _tree(ref, pre + "params"), device="cpu")
    return cfg, params, pre, torch.as_tensor(ref[pre + "tokens"])


@pytest.mark.parametrize(("arch", "dt"), MODEL_CASES)
def test_prefill_and_decode_match_reference(ref, arch, dt):
    cfg, params, pre, toks = _setup(ref, arch, dt)
    model = build_model(cfg)
    with torch.inference_mode():
        logits, cache = model.prefill(params, {"tokens": toks[:, :S]}, cache_len=S + SLACK)
        assert logits.shape == (B, 1, ref[pre + "prefill/logits"].shape[-1])
        assert logits.dtype == _dtype(dt) and cache["k"].dtype == _dtype(dt)
        for name in ("logits", "k", "v"):
            got = logits if name == "logits" else cache[name]
            _model_close(dt, _np(got), ref[pre + f"prefill/{name}"])
        for t in range(STEPS):
            logits, cache = model.decode_step(params, toks[:, S + t:S + t + 1], cache, S + t)
            _model_close(dt, _np(logits), ref[pre + f"decode/{t}/logits"])
            for name in ("k", "v"):
                _model_close(dt, _np(cache[name]), ref[pre + f"decode/{t}/{name}"])


@pytest.mark.parametrize(("arch", "dt"), MODEL_CASES)
def test_training_forward_loss_matches_reference(ref, arch, dt):
    cfg, params, pre, toks = _setup(ref, arch, dt)
    with torch.inference_mode():
        x = embed_inputs(cfg, params, toks)
        positions = torch.arange(x.shape[1]).expand(x.shape[:2])
        x, aux = backbone_forward(cfg, params, x, positions)
        logits = lm_logits(cfg, params, apply_norm(cfg, params["ln_f"], x))
        loss = next_token_loss(cfg, logits, toks)
    assert float(aux) == 0.0
    _model_close(dt, [float(loss)], [float(ref[pre + "loss"])])


@pytest.mark.parametrize("arch", ARCHS)
def test_server_generate_equals_reference_in_float32(ref, arch):
    cfg, params, pre, toks = _setup(ref, arch, "float32")
    srv = Server(arch, smoke=True, max_len=S + GEN + 8, device="cpu", kernel_backend="torch")
    srv.cfg, srv.model, srv.params = cfg, build_model(cfg, kernel_backend="torch"), params
    reset_launch_counts()
    got = srv.generate({"tokens": toks[:, :S].numpy()}, GEN)
    assert got.dtype == torch.int32 and got.shape == (B, GEN)
    np.testing.assert_array_equal(got.numpy(), ref[pre + "generate"])
    assert launch_counts()["flash_attention"] == 0  # CPU tensors: the plain path


@pytest.mark.parametrize("arch", ARCHS)
def test_num_params_and_cache_layout(ref, arch):
    cfg = get_config(arch)
    assert build_model(cfg).num_params() == int(ref[f"num_params/{arch}"])
    c = cache_abstract(cfg, 4, 2088)
    assert c["k"].shape == (cfg.num_layers, 4, 2088, cfg.num_kv_heads, cfg.resolved_head_dim)
    assert c["k"].dtype == torch.bfloat16 and c["v"].device.type == "meta"


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch):
    """Decoding token s from an (s-1)-token cache reproduces the teacher-forced
    logits of the s-token prefill (float32; the reference's own check)."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen)
    toks = torch.as_tensor(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 12)))
    with torch.inference_mode():
        logits_pf, _ = model.prefill(params, {"tokens": toks}, cache_len=16)
        _, cache = model.prefill(params, {"tokens": toks[:, :-1]}, cache_len=16)
        logits_dec, _ = model.decode_step(params, toks[:, -1:], cache, 11)
    np.testing.assert_allclose(_np(logits_pf[:, -1]), _np(logits_dec[:, -1]), atol=5e-4,
                               rtol=1e-3)


def test_init_is_seeded_and_copies_the_reference_rule():
    cfg = get_smoke_config("qwen1.5-0.5b")
    model = build_model(cfg)
    a = model.init(torch.Generator().manual_seed(7))
    b = model.init(torch.Generator().manual_seed(7))
    assert torch.equal(a["blocks"]["attn"]["wq"], b["blocks"]["attn"]["wq"])
    wq = a["blocks"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16 and wq.shape == (2, 64, 4, 16)
    # scaled init: fan_in = shape[0], the layer count for a stacked leaf
    assert abs(float(wq.float().std()) - 1 / np.sqrt(2)) < 0.05
    assert abs(float(a["embed"]["tok"].float().std()) - 0.02) < 0.002
    assert a["embed"]["tok"].shape == (512, 64)  # vocab padded to 256
    assert a["blocks"]["ln1"]["scale"].dtype == torch.float32
    assert torch.equal(a["blocks"]["attn"]["bq"], torch.zeros(2, 4, 16, dtype=torch.bfloat16))
    assert get_config("qwen1.5-0.5b").vocab_size == 151936
    assert build_model(get_config("qwen1.5-0.5b")).decls["embed"]["tok"].shape == (152064, 1024)


# -- refusals and the entry points ----------------------------------------------------


def _code(excinfo) -> str:
    return excinfo.value.capability.code


@pytest.mark.parametrize("arch", ["gpt-x"])
def test_unported_archs_are_refused(arch):
    with pytest.raises(EngineCapabilityError) as e:
        get_config(arch)
    assert _code(e) == CAP_ARCH and arch in str(e.value)
    with pytest.raises(EngineCapabilityError) as e:
        Server(arch, device="cpu", kernel_backend="torch")
    assert _code(e) == CAP_ARCH


@pytest.mark.parametrize("arch", ["pixtral-12b", "starcoder2-15b", "whisper-base", "qwen1.5-32b"])
def test_registry_archs_build_and_serve_on_cpu(arch):
    """The four archs that were refused before: each smoke config builds and
    serves greedy tokens on the CPU (held against the reference in
    ``tests/test_torch_registry.py``)."""
    srv = Server(arch, device="cpu", kernel_backend="torch", max_len=40)
    assert srv.cfg.name == f"{arch}-smoke" and get_config(arch).name == arch
    toks = srv.generate(stub_batch(srv.cfg, 2, 10), 4)
    assert toks.shape == (2, 4) and bool(((toks >= 0) & (toks < 512)).all())


#: the model features that were served but not trained: (smoke config,
#: fields replaced); each now trains
TRAIN_REFUSED = [("grok-1-314b", {}), ("deepseek-v2-236b", {}), ("mamba2-370m", {}),
                 ("zamba2-2.7b", {}),
                 ("qwen2-7b", dict(family="moe", num_experts=4, top_k=2, d_ff_expert=128,
                                   max_position_embeddings=64)),
                 ("pixtral-12b", dict(num_experts=4, top_k=2, d_ff_expert=128))]


@pytest.mark.parametrize(("arch", "change"), TRAIN_REFUSED,
                         ids=["moe", "mla", "ssm", "hybrid", "moe-learned-pos", "vlm-moe"])
def test_unported_model_features_are_refused(arch, change):
    """What stays refused for these features on a mesh is an object that is
    not a mesh (the experts run there: ``tests/test_torch_mesh_moe.py``);
    without one each config trains: its loss is finite, and the trainer's group gradient
    (``autograd_group_value_and_grad`` over the flat layout) is, group by
    group, the gradient of ``Model.train_loss`` on that group's batch, bit
    for bit (the four registry families are held against the reference in
    ``tests/test_torch_train_families.py``)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.dsag_pjit import (
        GroupSpec,
        autograd_group_value_and_grad,
        make_train_step,
    )

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **change)
    model = build_model(cfg, kernel_backend="torch")  # served
    params = model.init(torch.Generator().manual_seed(0))
    layout = model.layout
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_train_step(model.train_loss, TrainConfig(), GroupSpec(2, ()), mesh=object(),
                        layout=layout)
    batch = {"tokens": torch.as_tensor(
        np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 2, 12)))}
    if cfg.family == "vlm":
        batch["image_embed"] = torch.as_tensor(np.random.default_rng(4).normal(
            size=(2, 2, cfg.num_image_tokens, cfg.d_model)), dtype=torch.float32)
    losses, grads = autograd_group_value_and_grad(model.train_loss, layout)(
        layout.flatten(params), batch)
    assert torch.isfinite(losses).all() and torch.isfinite(grads).all()
    for i in range(2):
        leaves = [t.detach().clone().requires_grad_(True) for t in layout.views(
            layout.flatten(params))]
        tree: dict = {}
        for x, t in zip(layout.leaves, leaves):
            set_path(tree, x.path, t.to(x.dtype))
        loss = model.train_loss(tree, {k: v[i] for k, v in batch.items()})
        assert torch.equal(loss.detach(), losses[i])
        for x, g, want in zip(layout.leaves, layout.views(grads[i]),
                              torch.autograd.grad(loss, leaves)):
            assert torch.equal(g, want), x.path
    assert float(grads.abs().max()) > 0


@pytest.mark.parametrize("where", ["pointer", "stride"])
def test_k6_refuses_misaligned_bf16_rows_before_any_launch(monkeypatch, where):
    # a [b, s, h, d] view sliced at an odd offset: the base pointer 2 bytes
    # off a 16-byte boundary, or a head stride of 68 elements (136 bytes)
    if where == "pointer":
        q = torch.zeros(1, 64, 4, 72, dtype=torch.bfloat16)[..., 1:65]
    else:
        q = torch.zeros(1, 64, 4, 68, dtype=torch.bfloat16)[..., :64]
    k = v = torch.zeros(1, 64, 4, 64, dtype=torch.bfloat16)
    out = torch.empty(1, 64, 4, 64, dtype=torch.bfloat16)

    def no_build():
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(k6._build, "library", no_build)
    k6.check_alignment(*(t.transpose(1, 2) for t in (k, v, out)))  # aligned: passes
    with pytest.raises(ValueError, match="16-byte aligned"):
        k6.check_alignment(q.transpose(1, 2))
    with pytest.raises(ValueError, match="16-byte aligned"):
        k6._launch(*(t.transpose(1, 2) for t in (q, k, v, out)), causal=True)


def test_server_needs_a_card_or_the_cpu_asked_for():
    with pytest.raises(EngineCapabilityError) as e:
        Server("qwen1.5-0.5b", device="cpu", kernel_backend="cuda")
    assert _code(e) == CAP_CUDA_KERNELS_OFF_DEVICE
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    with pytest.raises(EngineCapabilityError) as e:
        Server("qwen1.5-0.5b")
    assert _code(e) == CAP_CUDA_UNAVAILABLE


def test_decode_refuses_an_index_past_the_cache():
    srv = Server("qwen2-7b", device="cpu", kernel_backend="torch", max_len=4)
    with pytest.raises(ValueError, match="outside the cache"):
        srv.generate({"tokens": np.zeros((1, 3), np.int64)}, 3)


def test_cli_serves_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--kernel-backend", "torch", "--tokens", "4", "--batch", "2"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "generated (2, 4)" in proc.stdout


# -- on the card --------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _k6_tolerance(got, want32):
    """Kernel vs the plain version's float32 result: float32 rounding plus,
    for bfloat16 outputs, the output's own rounding (half an ulp, 2**-8)."""
    rtol = 1e-4 if got.dtype == torch.float32 else 1e-4 + 2.0**-8
    return torch.allclose(got.float(), want32, rtol=rtol, atol=1e-5 * float(want32.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", K6_DTYPES)
@pytest.mark.parametrize("case", K6_CASES + [
    (2, 3, 200, 333, 128, True),
    (2, 4, 256, 256, 64, False),
    # the bf16 kernel's edges: lengths no multiple of its 64-row tiles, one
    # query row over a long cache, d = 128 over many key tiles, non-causal
    (1, 2, 2085, 2085, 64, True),
    (2, 4, 1, 2085, 64, True),
    (1, 2, 700, 700, 128, True),
    (1, 3, 300, 384, 64, False),
])
def test_gpu_k6_matches_plain(card, case, dt):
    b, h, sq, sk, d, causal = case
    rng = np.random.default_rng(8)
    q, k, v = (torch.as_tensor(rng.normal(size=(b, h, n, d)), dtype=torch.float32,
                               device=card).to(_dtype(dt)) for n in (sq, sk, sk))
    reset_launch_counts()
    got = k6.flash_attention_op(q, k, v, causal=causal)
    want32 = k6.flash_attention_plain(q.float(), k.float(), v.float(), causal=causal)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == 1
    assert got.dtype == q.dtype and _k6_tolerance(got, want32)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [300, 2085])
def test_gpu_k6_bshd_gqa_matches_plain(card, s):
    rng = np.random.default_rng(9)
    q = torch.as_tensor(rng.normal(size=(2, s, 8, 64)), device=card).bfloat16()
    k = torch.as_tensor(rng.normal(size=(2, s, 2, 64)), device=card).bfloat16()
    v = torch.as_tensor(rng.normal(size=(2, s, 2, 64)), device=card).bfloat16()
    got = k6.flash_attention_bshd(q, k, v)
    want32 = k6.flash_attention_plain(q.float().transpose(1, 2),
                                      _repeat_kv(k, 4).float().transpose(1, 2),
                                      _repeat_kv(v, 4).float().transpose(1, 2)).transpose(1, 2)
    torch.cuda.synchronize()
    assert _k6_tolerance(got, want32)
    # head dims below 128 run zero-padded (the smoke configs' 16), and so
    # does 192 (to the d = 256 instantiation); 256 runs as it is
    for d in (16, 192, 256):
        qkv = [torch.as_tensor(rng.normal(size=(1, 2, 40, d)), device=card) for _ in range(3)]
        for dt in (torch.float32, torch.bfloat16):
            x = [t.to(dt) for t in qkv]
            want = k6.flash_attention_plain(*(t.float() for t in x))
            assert _k6_tolerance(k6.flash_attention_op(*x), want)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", K6_DTYPES)
@pytest.mark.parametrize(("sq", "sk"), [(1500, 1500), (1024, 1500), (1, 1500), (37, 130)])
def test_gpu_k6_bshd_non_causal_takes_any_key_count(card, dt, sq, sk):
    """whisper's shapes: the encoder over 1500 frames, cross-attention at
    prefill and at a decode step; sk no multiple of the key tiles."""
    rng = np.random.default_rng(10)
    q, k, v = (torch.as_tensor(rng.normal(size=(2, n, 4, 64)), dtype=torch.float32,
                               device=card).to(_dtype(dt)) for n in (sq, sk, sk))
    reset_launch_counts()
    got = k6.flash_attention_bshd(q, k, v, causal=False)
    want32 = k6.flash_attention_plain(*(t.float().transpose(1, 2) for t in (q, k, v)),
                                      causal=False).transpose(1, 2)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == 1 and _k6_tolerance(got, want32)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_gpu_server_through_k6_equals_plain_in_float32(card, arch):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 40))
    out = {}
    for backend in ("cuda", "torch"):
        srv = Server(arch, device="cuda", kernel_backend=backend, max_len=64)
        srv.cfg, srv.model = cfg, build_model(cfg, kernel_backend=backend)
        srv.params = srv.model.init(torch.Generator(device=card).manual_seed(0))
        reset_launch_counts()
        out[backend] = srv.generate({"tokens": toks}, 8).cpu()
        assert launch_counts()["flash_attention"] == (cfg.num_layers if backend == "cuda" else 0)
    assert torch.equal(out["cuda"], out["torch"])
