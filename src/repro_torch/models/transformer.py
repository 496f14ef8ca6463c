"""Decoder-only LM of the dense family, from ``repro.models.transformer``.

Parameters of the residual blocks are stacked along a leading layer axis as
in the reference; a Python loop over that axis takes the place of
``lax.scan``, with no rematerialization (serving runs under
``torch.inference_mode()``).  MoE, SSM and hybrid blocks, MLA, learned
positions and image prefixes are refused with ``arch-not-ported``.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.experiments.engine import CAP_ARCH, refuse
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    ParamDecl,
    apply_norm,
    embed_decls,
    embed_lookup,
    mlp_apply,
    mlp_decls,
    norm_decls,
    round_up,
    torch_dtype,
    tree_map,
    unembed,
)


def check_ported(cfg: ModelConfig) -> None:
    """Refuse every model feature outside the dense GQA family."""
    what = []
    if cfg.family != "dense":
        what.append(f"the {cfg.family} family")
    if cfg.use_mla:
        what.append("MLA")
    if cfg.num_experts:
        what.append("experts")
    if cfg.max_position_embeddings:
        what.append("learned positions")
    if not cfg.mlp_swiglu:
        what.append("the GELU MLP")
    if what:
        raise refuse(CAP_ARCH, f"{cfg.name}: {', '.join(what)} not ported; the port "
                               f"serves dense GQA models")


def stack_decls(decls, n: int):
    return tree_map(
        lambda d: ParamDecl((n,) + d.shape, ("layers",) + d.logical, d.init, d.dtype), decls
    )


def padded_kv_heads(cfg: ModelConfig) -> int:
    return round_up(cfg.num_kv_heads, max(cfg.kv_pad_to, 1))


def padded_heads(cfg: ModelConfig) -> int:
    """Query-head count padded to the reference's TP degree (cfg.head_pad_to)."""
    return round_up(cfg.num_heads, max(cfg.head_pad_to, 1))


def _block_decls(cfg: ModelConfig) -> dict[str, Any]:
    """One residual block of the stacked part of the model."""
    check_ported(cfg)
    return {
        "ln1": norm_decls(cfg),
        "ln2": norm_decls(cfg),
        "attn": attn.gqa_decls(cfg, heads=padded_heads(cfg)),
        "mlp": mlp_decls(cfg, swiglu=cfg.mlp_swiglu),
    }


def lm_decls(cfg: ModelConfig) -> dict[str, Any]:
    return {
        "embed": embed_decls(cfg),
        "blocks": stack_decls(_block_decls(cfg), cfg.num_layers),
        "ln_f": norm_decls(cfg),
    }


def layer_params(blocks, i: int):
    """Layer ``i``'s parameters: views into the stacked leaves."""
    return tree_map(lambda a: a[i], blocks)


def _apply_block(cfg: ModelConfig, bp, x, positions, *, backend: str = "cuda"):
    """Full-sequence residual block.  Returns (x, aux_loss)."""
    h = apply_norm(cfg, bp["ln1"], x)
    x = x + attn.gqa_forward(cfg, bp["attn"], h, positions, backend=backend)
    h = apply_norm(cfg, bp["ln2"], x)
    x = x + mlp_apply(bp["mlp"], h, swiglu=cfg.mlp_swiglu)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def backbone_forward(cfg: ModelConfig, params, x, positions, *, backend: str = "cuda"):
    """Run all blocks in layer order.  Returns (x, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.num_layers):
        x, a = _apply_block(cfg, layer_params(params["blocks"], i), x, positions,
                            backend=backend)
        aux = aux + a
    return x, aux


def embed_inputs(cfg: ModelConfig, params, tokens, *, image_embed=None, offset=0):
    if image_embed is not None:
        raise refuse(CAP_ARCH, f"{cfg.name}: image prefixes (the vlm family) are not ported")
    return embed_lookup(params["embed"], tokens.long(), cfg.d_model, torch_dtype(cfg.dtype))


def lm_logits(cfg: ModelConfig, params, x):
    return unembed(cfg, params["embed"], x)


def next_token_loss(cfg: ModelConfig, logits, tokens, *, text_offset: int = 0):
    """Cross-entropy of logits[:, t] against tokens[:, t+1]."""
    if text_offset:
        logits = logits[:, text_offset:]
    pred = logits[:, :-1].to(torch.float32)
    targets = tokens[:, 1:].long()
    lse = torch.logsumexp(pred, dim=-1)
    true_logit = torch.take_along_dim(pred, targets[..., None], dim=-1)[..., 0]
    return torch.mean(lse - true_logit)
