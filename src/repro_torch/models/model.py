"""Model API of the dense GQA family, from ``repro.models.model``.

``build_model(cfg)`` returns a :class:`Model` exposing ``init(generator)``,
``num_params()``, ``layout`` (the parameters' :class:`FlatLayout`),
``train_loss(params, batch, *, remat, fused_loss)`` (next-token CE),
``prefill(params, batch, cache_len)`` -> ``(last_logits, cache)``,
``decode_step(params, tokens, cache, index)`` -> ``(logits, cache)`` and
``cache_abstract(batch, cache_len)``.  The KV cache is the reference's
``{"k": [L, b, S, kvh, hd], "v": ...}``; ``decode_step`` writes into it in
place.  ``kernel_backend`` says how prefill attention runs on the card:
``"cuda"`` through kernel K6 (default), ``"torch"`` through the reference's
plain ``full_attention``.  ``train_loss`` always takes the plain attention,
as the reference's does (K6 has no backward and refuses grad).  Families
other than dense, MLA and experts raise ``arch-not-ported``, and so do the
enc-dec and VLM batch layouts.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.experiments.engine import CAP_ARCH, refuse
from repro_torch.models.layers import (
    FlatLayout,
    apply_norm,
    init_from_decls,
    mlp_apply,
    num_elements,
    torch_dtype,
)
from repro_torch.models.transformer import (
    AUX_LOSS_COEF,
    backbone_forward,
    check_ported,
    embed_inputs,
    fused_next_token_loss,
    layer_params,
    lm_decls,
    lm_logits,
    next_token_loss,
    padded_kv_heads,
)


def cache_abstract(cfg: ModelConfig, batch: int, cache_len: int, dtype=None) -> dict:
    """The decode cache as meta tensors (shape and dtype, no storage)."""
    check_ported(cfg)
    shape = (cfg.num_layers, batch, cache_len, padded_kv_heads(cfg), cfg.resolved_head_dim)
    dt = torch_dtype(dtype or cfg.dtype)
    return {name: torch.empty(shape, dtype=dt, device="meta") for name in ("k", "v")}


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
        ``cache_len``)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = embed_inputs(cfg, params, tokens)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device).expand(b, s)
        shapes = cache_abstract(cfg, b, cache_len, x.dtype)
        cache = {n: torch.empty(t.shape, dtype=t.dtype, device=x.device)
                 for n, t in shapes.items()}
        for t in cache.values():
            t[:, :, s:].zero_()  # the reference pads the prompt's keys with zeros
        for i in range(cfg.num_layers):
            lp = layer_params(params["blocks"], i)
            h = apply_norm(cfg, lp["ln1"], x)
            y, c = attn.gqa_prefill_with_cache(cfg, lp["attn"], h, positions,
                                               backend=self.kernel_backend)
            x = x + y
            h = apply_norm(cfg, lp["ln2"], x)
            x = x + mlp_apply(lp["mlp"], h, swiglu=cfg.mlp_swiglu)
            cache["k"][i, :, :s] = c["k"]
            cache["v"][i, :, :s] = c["v"]
        x = apply_norm(cfg, params["ln_f"], x)
        return lm_logits(cfg, params, x[:, -1:]), cache

    # -- serving: one decode step -------------------------------------------
    def decode_step(self, params, tokens, cache, index: int):
        """tokens [b, 1]; ``index`` tokens already in the cache, which is
        updated in place and returned."""
        cfg = self.cfg
        x = embed_inputs(cfg, params, tokens, offset=index)
        for i in range(cfg.num_layers):
            lp = layer_params(params["blocks"], i)
            h = apply_norm(cfg, lp["ln1"], x)
            y, _ = attn.gqa_decode_step(cfg, lp["attn"], h,
                                        {"k": cache["k"][i], "v": cache["v"][i]}, index)
            x = x + y
            h = apply_norm(cfg, lp["ln2"], x)
            x = x + mlp_apply(lp["mlp"], h, swiglu=cfg.mlp_swiglu)
        x = apply_norm(cfg, params["ln_f"], x)
        return lm_logits(cfg, params, x), cache

    def cache_abstract(self, batch: int, cache_len: int) -> dict:
        return cache_abstract(self.cfg, batch, cache_len)


def build_model(cfg: ModelConfig, kernel_backend: str = "cuda") -> Model:
    return Model(cfg, kernel_backend)
