"""The port's MoE, MLA, SSM and hybrid families held against the JAX
reference, on the CPU.

The reference runs in ONE subprocess for this module (``_REF_SCRIPT``, with
the jax-0.9 shim of ``test_torch_serve.py``); it builds every input from
numpy seeds (the models' parameters from the reference's own
``Model.init(jax.random.key(0))``) and writes inputs and outputs to an
``.npz``.  This process never imports ``jax`` or ``repro``.  The models are
the four smoke configs: grok-1-314b (MoE, GQA), deepseek-v2-236b (MoE, MLA,
shared experts), mamba2-370m (SSM) and zamba2-2.7b (hybrid: Mamba2 layers
and one shared GQA block).

Tolerances, and why:

* ``moe_apply`` and ``moe_reference`` in float32 on layer 0's experts: the
  gate indices are equal, exactly, at capacity factor 8.0 (no pair
  dropped) and 0.5 (pairs dropped: which ones depends on the stable sort),
  in one dispatch chunk and in two; the outputs and the aux loss within
  ``rtol=1e-5``, ``atol = 1e-5 * max|ref|`` (another summation order in the
  einsums and the means).
* MLA (``mla_forward``, ``mla_prefill_with_cache``'s cache, the absorbed
  ``mla_decode_step``) and Mamba2 (``mamba_forward``'s output, final state
  and conv tails, ``mamba_decode_step``, the recurrent oracle) in float32:
  ``rtol=1e-5``, ``atol = 1e-5 * max|ref|``; the SSD's chunked form against
  the token-by-token recurrence (the port's and the reference's):
  ``rtol=1e-4``, ``atol = 1e-4 * max|ref|`` (two algorithms, exponentials
  of cumulative sums against running products).
* The smoke models in float32 (prefill logits, every cache leaf, four
  decode steps' logits and caches): ``rtol=1e-4``, ``atol = 1e-4 *
  max|ref|``, as ``test_torch_serve.py`` holds the dense ones (the init
  scales stacked projections by ``1/sqrt(L)``, so activations grow through
  the layers and float32 rounding with them).  Greedy tokens from
  ``Server.generate`` are equal.
* The smoke models in bfloat16, the reference run op by op
  (``jax.disable_jit()``, where every op rounds its result once, as the
  port's eager ops do): within two bfloat16 ulps of the largest value,
  ``atol = 2**-6 * max|ref|``, as for the dense models; the hybrid within
  four (``2**-5``): its shared attention block reads the residual stream
  after Mamba2 layers, whose SSD state sums every earlier token's input, so
  a one-ulp change in one token's conv output moves the state and every
  later output, and the shared block's keys and values of the second group
  carry it (measured: 2 of 14336 values of that cache past two ulps, the
  largest 2.1% of the largest value; logits within 0.9%).  The router's
  logits are bfloat16 there and may tie or, rounded the other way, swap two
  experts, which no bound on the logits could absorb: the test records both
  sides' gate indices call by call, and a token whose experts differ must
  have its k-th and (k+1)-th probabilities within one bfloat16 ulp (``2**-7``
  relative) of each other in the reference's float32 probabilities; at
  these seeds no token flips, and the logits bound holds unloosened.
* ``num_params`` of the four published configs: equal, counted from the
  declarations with nothing allocated.
* One group's ``train_loss`` and gradient of each smoke model in float32
  (:func:`test_training_stays_refused`, which also holds that a mesh stays
  refused): ``rtol=1e-4``, ``atol = 1e-4 * max|ref| + 4 * spread`` per leaf,
  ``spread`` the reference's own one-ulp sensitivity (as
  ``tests/test_torch_registry.py``); leaves where the reference's gradient
  is NaN (its SSD fault, ROADMAP §3) must be finite in the port.

Tests marked ``gpu`` hold the card against the CPU on the smoke configs and
the server through K6 against the server through the plain attention; they
skip without a card (``pytest -m gpu tests/test_torch_families.py``).
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.experiments.engine import CAP_ARCH, EngineCapabilityError
from repro_torch.interop import model_params_from_arrays
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch.serve import Server
from repro_torch.models import attention as attn
from repro_torch.models import build_model, cache_abstract
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import tree_map

REPO = Path(__file__).resolve().parents[1]
BF16_ULP = 2.0**-7
FAMILIES = ("grok-1-314b", "deepseek-v2-236b", "mamba2-370m", "zamba2-2.7b")
MOE_ARCHS = ("grok-1-314b", "deepseek-v2-236b")
DTYPES = ("float32", "bfloat16")
#: moe_apply cases: (arch, capacity factor, dispatch chunks)
MOE_CASES = [(a, cf, nx) for a in MOE_ARCHS for cf in (8.0, 0.5) for nx in (1, 2)]
#: whole models: batch, prompt (three SSD chunks of 16, the last padded),
#: cache slack, decode steps, generated tokens (GEN + 8 <= SLACK)
B, S, SLACK, STEPS, GEN = 2, 40, 16, 4, 8
#: the bfloat16 models' bound, relative to the largest value, where it is
#: not two ulps (the module docstring says why)
BF16_MODEL_ATOL = {"zamba2-2.7b": 2.0**-5}

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
from repro.models import attention as attn, build_model, moe as moe_mod, ssm as ssm_mod

P = {params}
out = {{}}
rng = np.random.default_rng(17)
f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))

def flat(tree, prefix):
    if isinstance(tree, dict):
        for key, val in tree.items():
            flat(val, f"{{prefix}}/{{key}}")
    else:
        out[prefix] = f32(tree)

def layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)

def gates(cfg, p, x):
    # the reference's router, as moe_apply computes it
    tokens = x.reshape(-1, x.shape[-1])
    logits = jnp.einsum("td,de->te", tokens, p["router"].astype(x.dtype))
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    return probs, jax.lax.top_k(probs, cfg.top_k)[1]

# the smoke models' float32 parameters; the bfloat16 models' are their casts,
# as the reference's init draws in float32 and casts each leaf
params32 = {{}}
for arch in P["archs"]:
    model = build_model(dataclasses.replace(get_smoke_config(arch), dtype="float32"))
    params32[arch] = jax.jit(model.init)(jax.random.key(0))
    flat(params32[arch], f"model/{{arch}}/params")
    out[f"num_params/{{arch}}"] = np.array(build_model(get_config(arch)).num_params())

# -- moe_apply, moe_reference (float32, layer 0's experts) -----------------------------
for arch, cf, nx in P["moe"]:
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", moe_dispatch_chunks=nx)
    p = layer0(params32[arch]["blocks"]["moe"])
    x = jnp.asarray(rng.normal(size=(4, 32, cfg.d_model)).astype(np.float32))
    pre = f"moe/{{arch}}/{{cf}}/{{nx}}/"
    out[pre + "x"] = f32(x)
    y, aux = jax.jit(lambda p, x: moe_mod.moe_apply(cfg, p, x, capacity_factor=cf))(p, x)
    out[pre + "y"], out[pre + "aux"] = f32(y), f32(aux)
    out[pre + "gate_idx"] = np.asarray(jax.jit(lambda p, x: gates(cfg, p, x)[1])(p, x))
    if cf == 8.0 and nx == 1:
        out[pre + "dense"] = f32(jax.jit(lambda p, x: moe_mod.moe_reference(cfg, p, x))(p, x))

# -- MLA: forward, prefill cache, absorbed decode (float32, layer 0) ---------------------
cfg = dataclasses.replace(get_smoke_config("deepseek-v2-236b"), dtype="float32")
p = layer0(params32["deepseek-v2-236b"]["blocks"]["attn"])
x = jnp.asarray(rng.normal(size=(2, 11, cfg.d_model)).astype(np.float32))
pos = jnp.broadcast_to(jnp.arange(10), (2, 10))
out["mla/x"] = f32(x)
out["mla/forward"] = f32(jax.jit(lambda p, x: attn.mla_forward(cfg, p, x, pos))(p, x[:, :10]))
y, cache = jax.jit(lambda p, x: attn.mla_prefill_with_cache(cfg, p, x, pos, 16))(p, x[:, :10])
out["mla/prefill"], out["mla/c_kv"], out["mla/k_rope"] = f32(y), f32(cache["c_kv"]), f32(cache["k_rope"])
y, cache = jax.jit(lambda p, x, c: attn.mla_decode_step(cfg, p, x, c, jnp.int32(10)))(p, x[:, 10:], cache)
out["mla/decode"], out["mla/decode_c_kv"], out["mla/decode_k_rope"] = (
    f32(y), f32(cache["c_kv"]), f32(cache["k_rope"]))

# -- Mamba2: chunked forward with its state, one decode step, the recurrent oracle ----
cfg = dataclasses.replace(get_smoke_config("mamba2-370m"), dtype="float32")
p = layer0(params32["mamba2-370m"]["blocks"]["mamba"])
# A_log, dt_bias and D from a seed (the init's zeros and ones leave A = -1)
for name, scale in (("A_log", 0.5), ("dt_bias", 0.5), ("D", 1.0)):
    p[name] = jnp.asarray(rng.normal(size=p[name].shape).astype(np.float32) * scale)
flat(p, "ssm/params")
x = jnp.asarray(rng.normal(size=(2, 37, cfg.d_model)).astype(np.float32))
out["ssm/x"] = f32(x)
y, st = jax.jit(lambda p, x: ssm_mod.mamba_forward(cfg, p, x, return_state=True))(p, x[:, :36])
out["ssm/y"], out["ssm/state"] = f32(y), f32(st["state"])
for n in "xBC":
    out[f"ssm/conv/{{n}}"] = f32(st["conv"][n])
y, st = jax.jit(lambda p, x, c: ssm_mod.mamba_decode_step(cfg, p, x, c))(p, x[:, 36:], st)
out["ssm/decode"], out["ssm/decode_state"] = f32(y), f32(st["state"])
y, st = ssm_mod.mamba_reference_recurrent(cfg, p, x)  # eager: a compiled loop of 37 steps is slower
out["ssm/recurrent"], out["ssm/recurrent_state"] = f32(y), f32(st["state"])

# -- the smoke models: float32 compiled, bfloat16 op by op ----------------------------------
B, S, SLACK, STEPS, GEN = P["sizes"]
for arch in P["archs"]:
    toks = rng.integers(0, 512, size=(B, S + STEPS)).astype(np.int32)
    out[f"model/{{arch}}/tokens"] = toks
    for dt in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype=dt)
        model = build_model(cfg)
        params = jax.tree.map(lambda a, s: a.astype(s.dtype), params32[arch], model.abstract())
        pre = f"model/{{arch}}/{{dt}}/"
        routed = []
        if cfg.num_experts and dt == "bfloat16":  # each moe_apply call's routing (op by op)
            apply = moe_mod.moe_apply
            def recording(c, p, x, **kw):
                probs, idx = gates(c, p, x)
                routed.append((np.asarray(probs), np.asarray(idx)))
                return apply(c, p, x, **kw)
            moe_mod.moe_apply = recording
        if dt == "float32":
            prefill = jax.jit(lambda p, b: model.prefill(p, b, cache_len=S + SLACK))
            dec = jax.jit(model.decode_step)
        else:
            prefill, dec = (lambda p, b: model.prefill(p, b, cache_len=S + SLACK)), model.decode_step
        with jax.disable_jit(dt == "bfloat16"):
            logits, cache = prefill(params, {{"tokens": jnp.asarray(toks[:, :S])}})
            out[pre + "prefill/logits"] = f32(logits)
            flat(cache, pre + "prefill/cache")
            for t in range(STEPS):
                logits, cache = dec(params, jnp.asarray(toks[:, S + t:S + t + 1]), cache,
                                    jnp.int32(S + t))
                out[pre + f"decode/{{t}}/logits"] = f32(logits)
                flat(cache, pre + f"decode/{{t}}/cache")
        if routed:
            moe_mod.moe_apply = apply
            for i, (probs, idx) in enumerate(routed):
                out[pre + f"routing/{{i}}/probs"], out[pre + f"routing/{{i}}/idx"] = probs, idx
        if dt == "float32":
            # the reference's Server over these parameters and the compiled steps
            srv = Server.__new__(Server)
            srv.cfg, srv.model, srv.params, srv.max_len = cfg, model, params, S + SLACK
            srv._prefill, srv._decode = prefill, dec
            out[pre + "generate"] = np.asarray(srv.generate({{"tokens": jnp.asarray(toks[:, :S])}}, GEN))
            # one group's train_loss and its gradient over the prompt, and the
            # gradient's spread: its change when every parameter moves by one
            # float32 ulp, up or down as a seeded draw says
            vg = jax.jit(jax.value_and_grad(lambda p, b: model.train_loss(p, b)))
            batch = {{"tokens": jnp.asarray(toks[:, :S])}}
            loss, grads = vg(params, batch)
            out[pre + "train/loss"] = f32(loss)
            flat(grads, pre + "train/grad")
            nr, inf = np.random.default_rng(1), np.float32(np.inf)
            nudged = jax.tree.map(lambda a: jnp.asarray(np.nextafter(np.asarray(a), np.where(
                nr.integers(0, 2, a.shape).astype(bool), inf, -inf))), params)
            flat(jax.tree.map(lambda g, h: np.abs(f32(g) - f32(h)).max(), grads,
                              vg(nudged, batch)[1]), pre + "train/spread")
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every reference output of this module, from one JAX subprocess."""
    params = dict(moe=MOE_CASES, sizes=(B, S, SLACK, STEPS, GEN), archs=FAMILIES)
    path = tmp_path_factory.mktemp("jax_families_reference") / "ref.npz"
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


def _close(got, want, rtol, atol_rel):
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * float(np.abs(want).max()))


def _model_close(dt: str, got, want, arch: str):
    if dt == "float32":
        _close(got, want, rtol=1e-4, atol_rel=1e-4)
    else:
        _close(got, want, rtol=0, atol_rel=BF16_MODEL_ATOL.get(arch, 2.0**-6))


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


def _flip_within_one_ulp(probs: np.ndarray, idx_ref: np.ndarray, idx_got: np.ndarray,
                         k: int) -> np.ndarray:
    """Rows whose top-k experts differ; each must sit at a near-tie: the
    reference's k-th and (k+1)-th float32 probabilities within one bfloat16
    ulp.  Returns the mask of flipped rows."""
    flipped = (np.sort(idx_ref, -1) != np.sort(idx_got, -1)).any(-1)
    for row in np.flatnonzero(flipped):
        top = np.sort(probs[row])[::-1]
        margin = (top[k - 1] - top[k]) / top[k - 1]
        assert margin <= BF16_ULP, (row, idx_ref[row], idx_got[row], margin)
    return flipped


# -- MoE --------------------------------------------------------------------------------


def _layer0(ref, arch: str, part: str) -> dict:
    """Layer 0's float32 parameters of ``part`` in the smoke model of ``arch``."""
    return {n: _t(a[0]) for n, a in _tree(ref, f"model/{arch}/params/blocks/{part}").items()}


def _moe_setup(ref, arch, cf, nx):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", moe_dispatch_chunks=nx)
    pre = f"moe/{arch}/{cf}/{nx}/"
    return cfg, pre, _layer0(ref, arch, "moe"), _t(ref[pre + "x"])


@pytest.mark.parametrize(("arch", "cf", "nx"), MOE_CASES)
def test_moe_apply_matches_reference(ref, arch, cf, nx):
    cfg, pre, p, x = _moe_setup(ref, arch, cf, nx)
    assert moe_mod.dispatch_chunks(cfg, x.shape[0]) == nx
    y, aux = moe_mod.moe_apply(cfg, p, x, capacity_factor=cf)
    assert y.dtype == x.dtype and y.shape == x.shape and aux.dtype == torch.float32
    idx = moe_mod.route(cfg, p, x)[2].reshape(-1, cfg.top_k).numpy()
    np.testing.assert_array_equal(idx, ref[pre + "gate_idx"])
    # 0.5 drops pairs, 8.0 none
    cap = moe_mod.capacity_of(cfg, x.shape[0] * x.shape[1] // nx, cf)
    per_expert = np.stack([np.bincount(c, minlength=cfg.num_experts)
                           for c in idx.reshape(nx, -1)])
    assert (per_expert > cap).any() == (cf == 0.5)
    _close(_np(y), ref[pre + "y"], rtol=1e-5, atol_rel=1e-5)
    _close(_np(aux), ref[pre + "aux"], rtol=1e-5, atol_rel=0)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_reference_and_apply_agree_without_drops(ref, arch):
    cfg, pre, p, x = _moe_setup(ref, arch, 8.0, 1)
    dense = moe_mod.moe_reference(cfg, p, x)
    _close(_np(dense), ref[pre + "dense"], rtol=1e-5, atol_rel=1e-5)
    _close(_np(moe_mod.moe_apply(cfg, p, x, capacity_factor=8.0)[0]), _np(dense),
           rtol=1e-5, atol_rel=1e-5)


def test_top_k_puts_the_lower_index_first_among_ties():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    vals, idx = moe_mod.top_k(probs, 2)
    assert idx.tolist() == [[1, 2], [0, 1]]
    assert torch.equal(vals, torch.gather(probs, 1, idx))


# -- MLA ----------------------------------------------------------------------------------


def test_mla_matches_reference(ref):
    cfg = dataclasses.replace(get_smoke_config("deepseek-v2-236b"), dtype="float32")
    p = _layer0(ref, "deepseek-v2-236b", "attn")
    x = _t(ref["mla/x"])
    pos = torch.arange(10).expand(2, 10)
    _close(_np(attn.mla_forward(cfg, p, x[:, :10], pos)), ref["mla/forward"], 1e-5, 1e-5)
    y, c = attn.mla_prefill_with_cache(cfg, p, x[:, :10], pos)
    _close(_np(y), ref["mla/prefill"], 1e-5, 1e-5)
    cache = {n: torch.zeros((2, 16) + c[n].shape[2:]) for n in c}
    for n in c:
        cache[n][:, :10] = c[n]
        _close(_np(cache[n]), ref[f"mla/{n}"], 1e-5, 1e-5)
    y, out = attn.mla_decode_step(cfg, p, x[:, 10:], cache, 10)
    assert out["c_kv"] is cache["c_kv"]  # written in place
    _close(_np(y), ref["mla/decode"], 1e-5, 1e-5)
    for n in c:
        _close(_np(cache[n]), ref[f"mla/decode_{n}"], 1e-5, 1e-5)
    with pytest.raises(ValueError, match="outside the cache"):
        attn.mla_decode_step(cfg, p, x[:, 10:], cache, 16)


# -- Mamba2 -------------------------------------------------------------------------------


def test_mamba_matches_reference(ref):
    cfg = dataclasses.replace(get_smoke_config("mamba2-370m"), dtype="float32")
    p = _tree(ref, "ssm/params", torch.float32)
    x = _t(ref["ssm/x"])
    y, st = ssm_mod.mamba_forward(cfg, p, x[:, :36], return_state=True)
    assert st["state"].dtype == torch.float32 and st["conv"]["x"].shape == (2, 3, 128)
    _close(_np(y), ref["ssm/y"], 1e-5, 1e-5)
    _close(_np(st["state"]), ref["ssm/state"], 1e-5, 1e-5)
    for n in "xBC":
        _close(_np(st["conv"][n]), ref[f"ssm/conv/{n}"], 1e-5, 1e-5)
    y, st = ssm_mod.mamba_decode_step(cfg, p, x[:, 36:], st)
    _close(_np(y), ref["ssm/decode"], 1e-5, 1e-5)
    _close(_np(st["state"]), ref["ssm/decode_state"], 1e-5, 1e-5)
    y, st = ssm_mod.mamba_reference_recurrent(cfg, p, x)
    _close(_np(y), ref["ssm/recurrent"], 1e-5, 1e-5)
    _close(_np(st["state"]), ref["ssm/recurrent_state"], 1e-5, 1e-5)
    # the chunked form against the token-by-token recurrence
    full = ssm_mod.mamba_forward(cfg, p, x)
    _close(_np(full), ref["ssm/recurrent"], 1e-4, 1e-4)
    _close(_np(full), _np(y), 1e-4, 1e-4)


def test_softplus_is_logaddexp_past_torchs_threshold():
    x = torch.tensor([-30.0, -1.0, 0.0, 19.0, 21.0, 40.0])
    want = np.logaddexp(x.numpy().astype(np.float64), 0.0)
    np.testing.assert_allclose(ssm_mod.softplus(x).numpy(), want, rtol=1e-6)


# -- the smoke models -----------------------------------------------------------------


def _setup(ref, arch: str, dt: str):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dt)
    # the reference's bfloat16 init is its float32 one, each leaf cast
    params = model_params_from_arrays(cfg, _tree(ref, f"model/{arch}/params"), device="cpu")
    return cfg, params, f"model/{arch}/{dt}/", torch.as_tensor(ref[f"model/{arch}/tokens"])


class _Routing:
    """Records the router's gate indices of each ``moe_apply`` call."""

    def __init__(self):
        self.calls: list[np.ndarray] = []
        self._apply = moe_mod.moe_apply

    def __call__(self, cfg, p, x, **kw):
        self.calls.append(moe_mod.route(cfg, p, x.reshape(-1, x.shape[-1]))[2].numpy())
        return self._apply(cfg, p, x, **kw)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_match_reference(ref, arch, dt):
    cfg, params, pre, toks = _setup(ref, arch, dt)
    model = build_model(cfg, kernel_backend="torch")
    routing = _Routing()
    got = {}
    with torch.inference_mode(), mock.patch.object(moe_mod, "moe_apply", routing):
        logits, cache = model.prefill(params, {"tokens": toks[:, :S]}, cache_len=S + SLACK)
        assert logits.dtype == getattr(torch, dt)
        got["prefill"] = (_np(logits), {n: _np(t) for n, t in _leaves(cache)})
        for t in range(STEPS):
            logits, cache = model.decode_step(params, toks[:, S + t:S + t + 1], cache, S + t)
            got[f"decode/{t}"] = (_np(logits), {n: _np(t) for n, t in _leaves(cache)})
    # routing first: a flip at a near-tie would move the logits past any bound
    assert len(routing.calls) == (cfg.num_layers * (STEPS + 1) if cfg.num_experts else 0)
    if dt == "bfloat16":  # the reference records it op by op (float32 is compiled)
        for i, idx in enumerate(routing.calls):
            want = ref[pre + f"routing/{i}/idx"]
            flipped = _flip_within_one_ulp(ref[pre + f"routing/{i}/probs"], want, idx, cfg.top_k)
            assert not flipped.any(), f"call {i}: tokens {np.flatnonzero(flipped)} flipped"
    for step, (logits, leaves) in got.items():
        _model_close(dt, logits, ref[pre + f"{step}/logits"], arch)
        want = dict(_leaves(_tree(ref, pre + f"{step}/cache")))
        assert leaves.keys() == want.keys()
        for name, t in leaves.items():
            assert t.shape == want[name].shape, name
            _model_close(dt, t, want[name], arch)


@pytest.mark.parametrize("arch", FAMILIES)
def test_server_generate_equals_reference_in_float32(ref, arch):
    cfg, params, pre, toks = _setup(ref, arch, "float32")
    srv = Server(arch, smoke=True, max_len=S + GEN + 8, device="cpu", kernel_backend="torch")
    srv.cfg, srv.model, srv.params = cfg, build_model(cfg, kernel_backend="torch"), params
    reset_launch_counts()
    got = srv.generate({"tokens": toks[:, :S].numpy()}, GEN)
    assert got.dtype == torch.int32 and got.shape == (B, GEN)
    np.testing.assert_array_equal(got.numpy(), ref[pre + "generate"])
    assert launch_counts()["flash_attention"] == 0  # CPU tensors: the plain path


@pytest.mark.parametrize("arch", FAMILIES)
def test_num_params_and_cache_layout(ref, arch):
    cfg = get_config(arch)
    assert build_model(cfg).num_params() == int(ref[f"num_params/{arch}"])
    c = cache_abstract(cfg, 4, 1064)
    leaves = dict(_leaves(c))
    assert all(t.device.type == "meta" for t in leaves.values())
    L = cfg.num_layers
    if cfg.use_mla:
        assert c["c_kv"].shape == (L, 4, 1064, 512) and c["k_rope"].shape == (L, 4, 1064, 64)
    elif cfg.family == "moe":
        assert c["k"].shape == (L, 4, 1064, 8, 128)
    else:
        mamba = c if cfg.family == "ssm" else c["mamba"]
        d_inner, h, n = ssm_mod.ssm_dims(cfg)
        assert mamba["state"].shape == (L, 4, h, 64, n)
        assert mamba["state"].dtype == torch.float32
        assert mamba["conv"]["x"].shape == (L, 4, 3, d_inner)
        assert mamba["conv"]["B"].dtype == torch.bfloat16
        if cfg.family == "hybrid":
            assert c["shared"]["k"].shape == (9, 4, 1064, 32, 80)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_prefill(arch):
    """Decoding token s from an (s-1)-token cache reproduces the teacher-forced
    logits of the s-token prefill (float32, no pair dropped)."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = build_model(cfg, kernel_backend="torch")
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.as_tensor(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 35)))
    with torch.inference_mode():
        logits_pf, _ = model.prefill(params, {"tokens": toks}, cache_len=40)
        _, cache = model.prefill(params, {"tokens": toks[:, :-1]}, cache_len=40)
        logits_dec, _ = model.decode_step(params, toks[:, -1:], cache, 34)
    _close(_np(logits_dec[:, -1]), _np(logits_pf[:, -1]), rtol=1e-4, atol_rel=1e-4)


def test_recurrent_prompt_shorter_than_the_conv_tail_is_refused():
    model = build_model(get_smoke_config("mamba2-370m"), kernel_backend="torch")
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="conv"):
        model.prefill(params, {"tokens": torch.zeros((1, 2), dtype=torch.long)}, 8)


@pytest.mark.parametrize("arch", FAMILIES)
def test_training_stays_refused(ref, arch):
    """What stays refused in training these families on a mesh is the MoE
    (an object that is not a mesh is refused for every family); without one
    the smoke model's loss is finite and one group's gradient through the
    trainer's group gradients (``autograd_group_value_and_grad`` over the
    flat layout) matches the reference's ``value_and_grad`` in float32:
    ``rtol=1e-4``, ``atol = 1e-4 * max|ref| + 4 * spread`` of each leaf
    (``spread``: the reference's own change under a one-ulp nudge of every
    parameter, as ``tests/test_torch_registry.py`` holds its gradients).
    Where the reference's gradient is NaN (its SSD fault, ROADMAP §3: the
    smoke config's dt reaches ~16, and a 16-token chunk's decay passes
    88.7), the port's is finite; only the SSM families may hit it."""
    from repro_torch.core.dsag_pjit import CAP_MESH, autograd_group_value_and_grad
    from repro_torch.models.model import check_mesh
    from repro_torch.experiments.engine import EngineConfig
    from repro_torch.launch.train import Trainer, TrainerOptions

    with pytest.raises(TypeError, match="DeviceMesh"):
        Trainer(TrainerOptions(arch=arch, mesh=object(),
                               engine=EngineConfig(device="cpu", kernel_backend="torch")))
    if arch in MOE_ARCHS:  # the MoE layers do not run on a mesh (DTensor: aten.bincount)
        with pytest.raises(EngineCapabilityError) as e:
            check_mesh(get_smoke_config(arch))
        assert e.value.capability.code == CAP_MESH
    else:  # SSM and hybrid run there (tests/test_torch_mesh.py runs the dense family)
        check_mesh(get_smoke_config(arch))
    cfg, params, pre, toks = _setup(ref, arch, "float32")
    model = build_model(cfg, kernel_backend="torch")
    layout = model.layout
    fn = autograd_group_value_and_grad(model.train_loss, layout)
    tokens = toks[None, :, :S]
    losses, grads = fn(layout.flatten(params), {"tokens": tokens})
    assert torch.isfinite(losses).all()
    _close(_np(losses), [float(ref[pre + "train/loss"])], rtol=1e-5, atol_rel=0)
    want = dict(_leaves(_tree(ref, pre + "train/grad")))
    spread = dict(_leaves(_tree(ref, pre + "train/spread")))
    got = {"/" + "/".join(x.path): v[0] for x, v in zip(layout.leaves, layout.views(grads))}
    assert sorted(got) == sorted(want) == sorted(spread)
    compared = 0
    for n, g in got.items():
        assert torch.isfinite(g).all(), n
        if not np.isfinite(want[n]).all():
            assert cfg.family in ("ssm", "hybrid"), n
            continue
        compared += 1
        np.testing.assert_allclose(_np(g), want[n], rtol=1e-4, err_msg=n,
                                   atol=1e-4 * float(np.abs(want[n]).max()) + 4 * float(spread[n]))
    assert compared


def test_serve_cli_and_example_on_cpu(capsys):
    from repro_torch.examples import serve_decode
    from repro_torch.launch import serve

    for arch in FAMILIES:
        serve.main(["--arch", arch, "--device", "cpu", "--kernel-backend", "torch",
                    "--tokens", "4", "--batch", "2"])
        assert "generated (2, 4)" in capsys.readouterr().out
    serve_decode.main(["--device", "cpu", "--kernel-backend", "torch", "--tokens", "6"])
    assert "[zamba2-2.7b] generated 4x6 tokens" in capsys.readouterr().out
    # the enc-dec and VLM branches add the stub frontends' embeddings
    for arch in ("whisper-base", "pixtral-12b"):
        serve_decode.main(["--arch", arch, "--device", "cpu", "--kernel-backend", "torch",
                           "--tokens", "6"])
        assert f"[{arch}] generated 4x6 tokens" in capsys.readouterr().out


# -- on the card --------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILIES)
def test_gpu_card_equals_cpu_in_float32(card, arch):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    toks = torch.as_tensor(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 40)))
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    out = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, kernel_backend="torch" if dev == "cpu" else "cuda")
        p = tree_map(lambda a: a.to(dev), params)
        with torch.inference_mode():
            logits, cache = model.prefill(p, {"tokens": toks.to(dev)}, 48)
            steps = [logits]
            for t in range(4):
                logits, cache = model.decode_step(p, steps[-1][:, -1:].argmax(-1), cache, 40 + t)
                steps.append(logits)
        out[dev] = [s.cpu() for s in steps]
    for a, b in zip(out["cuda"], out["cpu"]):
        _close(_np(a), _np(b), rtol=1e-4, atol_rel=1e-4)
        assert torch.equal(a.argmax(-1), b.argmax(-1))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ("grok-1-314b", "zamba2-2.7b"))
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
        gqa = cfg.num_layers // cfg.attn_every if cfg.attn_every else cfg.num_layers
        assert launch_counts()["flash_attention"] == (gqa if backend == "cuda" else 0)
    assert torch.equal(out["cuda"], out["torch"])
