"""Model API over the dense, MoE, SSM and hybrid families, from
``repro.models.model``.

``build_model(cfg)`` returns a :class:`Model` exposing ``init(generator)``,
``num_params()``, ``layout`` (the parameters' :class:`FlatLayout`),
``train_loss(params, batch, *, remat, fused_loss)`` (next-token CE),
``prefill(params, batch, cache_len)`` -> ``(last_logits, cache)``,
``decode_step(params, tokens, cache, index)`` -> ``(logits, cache)`` and
``cache_abstract(batch, cache_len)``.  The caches are the reference's
(:func:`cache_abstract`): ``{"k", "v": [L, b, S, kvh, hd]}`` for GQA,
``{"c_kv", "k_rope"}`` for MLA, the Mamba2 ``{"state" (float32), "conv"}``
for SSM, and both (``"mamba"``, and ``"shared"`` with one KV cache per
shared-block application) for the hybrid family; ``decode_step`` writes
into them in place.  ``kernel_backend`` says how GQA prefill attention runs
on the card: ``"cuda"`` through kernel K6 (default), ``"torch"`` through the
reference's plain ``full_attention``; MLA takes the plain attention either
way (``models/attention.py``).  ``train_loss`` always takes the plain
attention, as the reference's does (K6 has no backward and refuses grad),
and trains the dense family only: MoE, MLA, SSM and hybrid models raise
``arch-not-ported`` there (:func:`check_trainable`), as do the enc-dec and
VLM batch layouts everywhere.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.experiments.engine import CAP_ARCH, refuse
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    FlatLayout,
    apply_norm,
    init_from_decls,
    mlp_apply,
    num_elements,
    torch_dtype,
    tree_map,
)
from repro_torch.models.transformer import (
    AUX_LOSS_COEF,
    backbone_forward,
    check_ported,
    check_trainable,
    embed_inputs,
    fused_next_token_loss,
    layer_params,
    lm_decls,
    lm_logits,
    next_token_loss,
    padded_kv_heads,
)


def cache_abstract(cfg: ModelConfig, batch: int, cache_len: int, dtype=None) -> dict:
    """The decode cache as meta tensors (shape and dtype, no storage): the
    reference's layout for this architecture."""
    check_ported(cfg)
    dt = torch_dtype(dtype or cfg.dtype)
    L, b, S = cfg.num_layers, batch, cache_len
    kv = (L, b, S, padded_kv_heads(cfg), cfg.resolved_head_dim)

    def sd(shape, d=dt):
        return torch.empty(shape, dtype=d, device="meta")

    if cfg.use_mla:
        return {"c_kv": sd((L, b, S, cfg.kv_lora_rank)), "k_rope": sd((L, b, S, cfg.qk_rope_dim))}
    if cfg.family in ("ssm", "hybrid"):
        d_inner, h, n = ssm_mod.ssm_dims(cfg)
        c, gn = cfg.ssm_conv - 1, ssm_mod.N_GROUPS * n
        mamba = {"state": sd((L, b, h, cfg.ssm_head_dim, n), torch.float32),
                 "conv": {"x": sd((L, b, c, d_inner)), "B": sd((L, b, c, gn)),
                          "C": sd((L, b, c, gn))}}
        if cfg.family == "ssm":
            return mamba
        groups = cfg.num_layers // cfg.attn_every
        shared = (groups,) + kv[1:]
        return {"mamba": mamba, "shared": {"k": sd(shared), "v": sd(shared)}}
    return {"k": sd(kv), "v": sd(kv)}


def _layer(cache: dict, i: int) -> dict:
    """Layer (or shared-block group) ``i``'s views of a stacked cache."""
    return tree_map(lambda a: a[i], cache)


def _write_prompt(cache: dict, new: dict, i: int) -> None:
    """Write a prefill's per-layer sequence cache (``[b, s, ...]``) at layer ``i``."""
    for name, t in new.items():
        cache[name][i, :, :t.shape[1]] = t


def _write_state(cache: dict, new: dict, i: int) -> None:
    """Write a Mamba2 layer's recurrent state and conv tails at layer ``i``."""
    cache["state"][i] = new["state"]
    for name, t in new["conv"].items():
        cache["conv"][name][i] = t


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    kernel_backend: str = "cuda"

    def __post_init__(self):
        if self.kernel_backend not in ("cuda", "torch"):
            raise ValueError(f"unknown kernel_backend {self.kernel_backend!r}")
        self.decls = lm_decls(self.cfg)
        self.layout = FlatLayout.from_decls(self.decls, self.cfg.dtype)

    # -- parameters -------------------------------------------------------
    def init(self, generator: torch.Generator) -> Any:
        """Parameters drawn from ``generator``, on its device."""
        return init_from_decls(self.decls, generator, self.cfg.dtype)

    def num_params(self) -> int:
        return num_elements(self.decls)

    # -- training ----------------------------------------------------------
    def train_loss(self, params, batch, *, remat: str = "full", fused_loss: bool = False):
        """Mean next-token cross-entropy of ``batch["tokens"]`` [b, s].

        Logits span the padded vocab (``embed_decls`` rounds it up to 256),
        as the reference's logsumexp does.  Attention is the plain one (the
        reference's ``_attend``), whatever ``kernel_backend`` says."""
        cfg = self.cfg
        check_trainable(cfg)
        if "audio_embed" in batch:
            raise refuse(CAP_ARCH, f"{cfg.name}: the enc-dec batch layout is not ported")
        tokens = batch["tokens"]
        x = embed_inputs(cfg, params, tokens, image_embed=batch.get("image_embed"))
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device).expand(b, s)
        x, aux = backbone_forward(cfg, params, x, positions, remat=remat, backend="torch")
        x = apply_norm(cfg, params["ln_f"], x)
        if fused_loss:
            ce = fused_next_token_loss(cfg, params, x, tokens)
        else:
            ce = next_token_loss(cfg, lm_logits(cfg, params, x), tokens)
        return ce + (AUX_LOSS_COEF * aux if cfg.num_experts else 0.0)

    # -- serving: prefill ---------------------------------------------------
    def prefill(self, params, batch, cache_len: int):
        """``batch["tokens"]`` [b, s] -> (logits [b, 1, V], cache padded to
        ``cache_len``; a recurrent state where the family has one)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = embed_inputs(cfg, params, tokens)
        b, s = x.shape[:2]
        if cfg.family in ("ssm", "hybrid") and s < cfg.ssm_conv - 1:
            raise ValueError(f"a prompt of {s} tokens is shorter than the conv's "
                             f"{cfg.ssm_conv - 1}-token tail")
        positions = torch.arange(s, device=x.device).expand(b, s)
        cache = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=x.device),
                         cache_abstract(cfg, b, cache_len, x.dtype))
        if cfg.family != "ssm":  # the reference pads the prompt's keys with zeros
            for t in (cache["shared"] if cfg.family == "hybrid" else cache).values():
                t[:, :, s:].zero_()
        if cfg.family in ("ssm", "hybrid"):
            x = self._prefill_recurrent(params, x, positions, cache)
        else:
            for i in range(cfg.num_layers):
                lp = layer_params(params["blocks"], i)
                h = apply_norm(cfg, lp["ln1"], x)
                if cfg.use_mla:
                    y, c = attn.mla_prefill_with_cache(cfg, lp["attn"], h, positions)
                else:
                    y, c = attn.gqa_prefill_with_cache(cfg, lp["attn"], h, positions,
                                                       backend=self.kernel_backend)
                x = x + y
                x = x + self._ffn(lp, apply_norm(cfg, lp["ln2"], x))
                _write_prompt(cache, c, i)
        x = apply_norm(cfg, params["ln_f"], x)
        return lm_logits(cfg, params, x[:, -1:]), cache

    def _ffn(self, lp, h):
        """The block's feed-forward: the MoE (aux loss dropped) or the MLP."""
        if self.cfg.num_experts:
            return moe_mod.moe_apply(self.cfg, lp["moe"], h)[0]
        return mlp_apply(lp["mlp"], h, swiglu=self.cfg.mlp_swiglu)

    def _mamba_layer(self, params, x, i: int, cache: dict, decode: bool):
        """Residual Mamba2 layer ``i``: the full sequence (its final state and
        conv tails written at ``i``) or one token against the state at ``i``
        (updated in place)."""
        lp = layer_params(params["blocks"], i)
        h = apply_norm(self.cfg, lp["ln"], x)
        if decode:
            y, st = ssm_mod.mamba_decode_step(self.cfg, lp["mamba"], h, _layer(cache, i))
        else:
            y, st = ssm_mod.mamba_forward(self.cfg, lp["mamba"], h, return_state=True)
        _write_state(cache, st, i)
        return x + y

    def _shared_block(self, params, x, attend):
        """zamba2's shared attention + MLP block; ``attend(h)`` -> (y, kv)."""
        sp = params["shared_attn"]
        y, kv = attend(sp["attn"], apply_norm(self.cfg, sp["ln1"], x))
        x = x + y
        return x + mlp_apply(sp["mlp"], apply_norm(self.cfg, sp["ln2"], x), swiglu=True), kv

    def _prefill_recurrent(self, params, x, positions, cache):
        cfg = self.cfg
        if cfg.family == "ssm":
            for i in range(cfg.num_layers):
                x = self._mamba_layer(params, x, i, cache, decode=False)
            return x
        # hybrid: groups of Mamba2 layers, each followed by the shared
        # attention block with its own KV cache
        k = cfg.attn_every
        for g in range(cfg.num_layers // k):
            for i in range(g * k, (g + 1) * k):
                x = self._mamba_layer(params, x, i, cache["mamba"], decode=False)
            x, kv = self._shared_block(params, x, lambda p, h: attn.gqa_prefill_with_cache(
                cfg, p, h, positions, backend=self.kernel_backend))
            _write_prompt(cache["shared"], kv, g)
        return x

    # -- serving: one decode step -------------------------------------------
    def decode_step(self, params, tokens, cache, index: int):
        """tokens [b, 1]; ``index`` tokens already in the cache, which is
        updated in place and returned."""
        cfg = self.cfg
        x = embed_inputs(cfg, params, tokens, offset=index)
        if cfg.family == "ssm":
            for i in range(cfg.num_layers):
                x = self._mamba_layer(params, x, i, cache, decode=True)
        elif cfg.family == "hybrid":
            k = cfg.attn_every
            for g in range(cfg.num_layers // k):
                for i in range(g * k, (g + 1) * k):
                    x = self._mamba_layer(params, x, i, cache["mamba"], decode=True)
                x, _ = self._shared_block(params, x, lambda p, h: attn.gqa_decode_step(
                    cfg, p, h, _layer(cache["shared"], g), index))
        else:
            step = attn.mla_decode_step if cfg.use_mla else attn.gqa_decode_step
            for i in range(cfg.num_layers):
                lp = layer_params(params["blocks"], i)
                h = apply_norm(cfg, lp["ln1"], x)
                y, _ = step(cfg, lp["attn"], h, _layer(cache, i), index)
                x = x + y
                x = x + self._ffn(lp, apply_norm(cfg, lp["ln2"], x))
        x = apply_norm(cfg, params["ln_f"], x)
        return lm_logits(cfg, params, x), cache

    def cache_abstract(self, batch: int, cache_len: int) -> dict:
        return cache_abstract(self.cfg, batch, cache_len)


def build_model(cfg: ModelConfig, kernel_backend: str = "cuda") -> Model:
    return Model(cfg, kernel_backend)
