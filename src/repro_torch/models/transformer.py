"""Decoder-only LM covering the dense, MoE, SSM, hybrid and VLM families,
from ``repro.models.transformer``.

Parameters of the residual blocks are stacked along a leading layer axis as
in the reference; a Python loop over that axis (each stacked leaf unbound
once, so a backward stacks the layers' gradients in one write) takes the
place of ``lax.scan``.  The hybrid family (zamba2) adds one *shared*
attention + MLP block (``shared_attn``), applied after every group of
``attn_every`` Mamba2 layers.  ``remat`` is the reference's ``_remat``:
``"none"``, ``"full"`` (each layer under ``torch.utils.checkpoint``) or
``"selective"`` (the matmul outputs saved, the rest recomputed: the
reference's ``dots_with_no_batch_dims_saveable``); under no grad it changes
nothing.  :func:`fused_next_token_loss` is the reference's chunked online
logsumexp over vocab chunks, each chunk checkpointed.

A config with ``max_position_embeddings`` has a learned position table
(``pos``) and no RoPE; the VLM family (pixtral) prefixes the text with image
embeddings (:func:`embed_inputs`).  The enc-dec family (whisper) builds its
own tree from these blocks (``models/model.py::encdec_decls``).

Serving (``models/model.py``) and the training forward
(:func:`backbone_forward`) take every family: a block is a Mamba2 layer
(SSM, hybrid), or attention (GQA or MLA) and a feed-forward (the MLP, or
the MoE with its aux loss); the hybrid's groups of ``attn_every`` Mamba2
layers are each followed by the shared block, and ``remat`` wraps a whole
group there, as the reference's ``_remat(group_body)``.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.experiments.engine import CAP_ARCH, refuse
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
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
from repro_torch.models.sharding import is_sharded, shard_batch

AUX_LOSS_COEF = 0.01


#: the families of ``ModelConfig.family``, every one served
FAMILIES = ("dense", "moe", "ssm", "hybrid", "enc_dec", "vlm")


def check_ported(cfg: ModelConfig) -> None:
    """Refuse a family that the reference does not define."""
    if cfg.family not in FAMILIES:
        raise refuse(CAP_ARCH, f"{cfg.name}: unknown family {cfg.family!r}; the port "
                               f"serves {FAMILIES}")


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
    if cfg.family in ("ssm", "hybrid"):
        return {"ln": norm_decls(cfg), "mamba": ssm_mod.mamba_decls(cfg)}
    out: dict[str, Any] = {"ln1": norm_decls(cfg), "ln2": norm_decls(cfg)}
    if cfg.use_mla:
        out["attn"] = attn.mla_decls(cfg)
    else:
        out["attn"] = attn.gqa_decls(cfg, heads=padded_heads(cfg))
    if cfg.num_experts:
        out["moe"] = moe_mod.moe_decls(cfg)
    else:
        out["mlp"] = mlp_decls(cfg, swiglu=cfg.mlp_swiglu)
    return out


def _shared_attn_decls(cfg: ModelConfig) -> dict[str, Any]:
    """zamba2: one shared full attention + MLP block used every attn_every
    layers (weights shared across its invocations)."""
    return {
        "ln1": norm_decls(cfg),
        "attn": attn.gqa_decls(cfg, heads=padded_heads(cfg)),
        "ln2": norm_decls(cfg),
        "mlp": mlp_decls(cfg, swiglu=True),
    }


def lm_decls(cfg: ModelConfig) -> dict[str, Any]:
    decls = {
        "embed": embed_decls(cfg),
        "blocks": stack_decls(_block_decls(cfg), cfg.num_layers),
        "ln_f": norm_decls(cfg),
    }
    if cfg.family == "hybrid":
        if cfg.num_layers % cfg.attn_every:
            raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are no whole number of "
                             f"groups of {cfg.attn_every}")
        decls["shared_attn"] = _shared_attn_decls(cfg)
    if cfg.max_position_embeddings:
        decls["pos"] = ParamDecl((cfg.max_position_embeddings, cfg.d_model), ("pos", "embed"))
    return decls


def layer_params(blocks, i: int):
    """Layer ``i``'s parameters: views into the stacked leaves."""
    return tree_map(lambda a: a[i], blocks)


def _apply_block(cfg: ModelConfig, bp, x, positions, *, backend: str = "cuda"):
    """Full-sequence residual block.  Returns (x, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family in ("ssm", "hybrid"):
        h = apply_norm(cfg, bp["ln"], x)
        return x + ssm_mod.mamba_forward(cfg, bp["mamba"], h), aux
    h = apply_norm(cfg, bp["ln1"], x)
    if cfg.use_mla:
        x = x + attn.mla_forward(cfg, bp["attn"], h, positions)
    else:
        x = x + attn.gqa_forward(cfg, bp["attn"], h, positions,
                                 use_rope=not cfg.max_position_embeddings, backend=backend)
    h = apply_norm(cfg, bp["ln2"], x)
    if cfg.num_experts:
        y, aux = moe_mod.moe_apply(cfg, bp["moe"], h)
        return x + y, aux
    return x + mlp_apply(bp["mlp"], h, swiglu=cfg.mlp_swiglu), aux


def _apply_shared_attn(cfg: ModelConfig, sp, x, positions, *, backend: str = "cuda"):
    """zamba2's shared attention (RoPE on) + SwiGLU block."""
    h = apply_norm(cfg, sp["ln1"], x)
    x = x + attn.gqa_forward(cfg, sp["attn"], h, positions, backend=backend)
    h = apply_norm(cfg, sp["ln2"], x)
    return x + mlp_apply(sp["mlp"], h, swiglu=True)


def _save_products(ctx, op, *args, **kwargs):
    """Keep the outputs of products with no batch dims, recompute the rest.

    Every ``torch.einsum`` of the model runs as ``aten.bmm``; an einsum with
    no batch dims (the projections, the MLP, the unembedding) is a ``bmm``
    of batch 1, attention's scores and mixing have the ``b·h`` batch."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default) or (
            op == torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, mode: str):
    """``fn`` under the reference's rematerialization ``mode``."""
    if mode not in ("none", "full", "selective"):
        raise ValueError(f"unknown remat mode {mode!r}")
    if mode == "none":
        return fn

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        if mode == "full":
            return checkpoint(fn, *args, use_reentrant=False)
        return checkpoint(fn, *args, use_reentrant=False, context_fn=lambda: (
            create_selective_checkpoint_contexts(_save_products)))

    return wrapped


def unstack_layers(blocks, n: int) -> list:
    """The per-layer parameter trees of stacked ``blocks``: each leaf unbound
    once (views; a backward stacks the layers' gradients in one write)."""
    per_leaf = tree_map(lambda a: a.unbind(0), blocks)
    return [tree_map(lambda t, i=i: t[i], per_leaf) for i in range(n)]


def backbone_forward(cfg: ModelConfig, params, x, positions, *, remat: str = "full",
                     backend: str = "cuda"):
    """Run all blocks in layer order, each under ``remat`` (the hybrid: each
    group of ``attn_every`` Mamba2 layers and the shared block after it).
    Returns (x, aux_loss)."""
    check_ported(cfg)
    x = shard_batch(x, None, None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = unstack_layers(params["blocks"], cfg.num_layers)
    if cfg.family == "hybrid":
        k = cfg.attn_every
        for g in range(cfg.num_layers // k):
            def group(xx, group_layers=layers[g * k:(g + 1) * k]):
                for lp in group_layers:
                    xx, _ = _apply_block(cfg, lp, xx, positions, backend=backend)
                return _apply_shared_attn(cfg, params["shared_attn"], xx, positions,
                                          backend=backend)

            x = _remat(group, remat)(x)
        return x, aux
    for lp in layers:
        def body(xx, lp=lp):
            return _apply_block(cfg, lp, xx, positions, backend=backend)

        x, a = _remat(body, remat)(x)
        aux = aux + a
    return x, aux


def embed_inputs(cfg: ModelConfig, params, tokens, *, image_embed=None, offset: int = 0):
    """Token embeddings, after ``image_embed`` [b, n_img, d] where given (the
    VLM's patches prefix the text), plus the learned positions
    ``pos[offset:offset + s]`` where the config has them.  The start is
    clamped to ``[0, max_position_embeddings - s]`` as the reference's
    ``dynamic_slice_in_dim`` clamps it; a sequence longer than the table is
    refused (the reference fails to trace it)."""
    dtype = torch_dtype(cfg.dtype)
    x = embed_lookup(params["embed"], tokens.long(), cfg.d_model, dtype)
    if image_embed is not None:
        x = torch.cat([image_embed.to(dtype), x], dim=1)
    if cfg.max_position_embeddings:
        s, n = x.shape[1], cfg.max_position_embeddings
        if s > n:
            raise ValueError(f"{cfg.name}: {s} positions exceed the learned table of {n}")
        start = min(max(int(offset), 0), n - s)
        x = x + params["pos"][start:start + s][None].to(dtype)
    return x


def lm_logits(cfg: ModelConfig, params, x):
    return shard_batch(unembed(cfg, params["embed"], x), None, "model")


def fused_next_token_loss(cfg: ModelConfig, params, x, tokens, *, text_offset: int = 0,
                          chunk: int = 8192):
    """Cross-entropy fused with the unembedding, chunked over the vocab.

    Never materializes ``[b, s, V]`` logits: a loop over vocab chunks keeps
    a running (max, sumexp) pair and the target logit, each chunk's body
    checkpointed (its ``[b, s, chunk]`` logits recomputed in the backward),
    as the reference's ``lax.scan`` of ``jax.checkpoint(body)``.  A vocab
    that ``chunk`` does not divide is one chunk, as in the reference."""
    if text_offset:
        x = x[:, text_offset:]
    xs = x[:, :-1]
    targets = tokens[:, 1:].long()
    w = params["embed"]["tok"].T if cfg.tie_embeddings else params["embed"]["unembed"]
    v = w.shape[1]
    if v % chunk:
        chunk = v  # fallback: a single chunk (the smoke configs, and 152064)

    def body(m, s, tl, ci, w_blk):
        logits = torch.einsum("bsd,dv->bsv", xs, w_blk.to(xs.dtype)).to(torch.float32)
        m_new = torch.maximum(m, logits.amax(-1))
        s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[..., None]).sum(-1)
        # the target logit if it falls inside this chunk
        local = targets - ci * chunk
        hit = (local >= 0) & (local < chunk)
        got = torch.take_along_dim(logits, local.clamp(0, chunk - 1)[..., None], dim=-1)[..., 0]
        return m_new, s, torch.where(hit, got, tl)

    b, sm1 = targets.shape
    m = torch.full((b, sm1), -1e30, dtype=torch.float32, device=x.device)
    s = torch.zeros((b, sm1), dtype=torch.float32, device=x.device)
    tl = torch.zeros((b, sm1), dtype=torch.float32, device=x.device)
    step = _remat(body, "full")
    for ci in range(v // chunk):
        m, s, tl = step(m, s, tl, ci, w[:, ci * chunk:(ci + 1) * chunk])
    return torch.mean(torch.log(s) + m - tl)


def next_token_loss(cfg: ModelConfig, logits, tokens, *, text_offset: int = 0):
    """Cross-entropy of logits[:, t] against tokens[:, t+1]."""
    if text_offset:
        logits = logits[:, text_offset:]
    pred = logits[:, :-1].to(torch.float32)
    if is_sharded(pred):
        # the target logit's gather runs on whole rows (DTensor has no rule
        # for take_along_dim over a split vocab): the logits are all-gathered
        pred = shard_batch(pred, None, None)
    targets = tokens[:, 1:].long()
    lse = torch.logsumexp(pred, dim=-1)
    true_logit = torch.take_along_dim(pred, targets[..., None], dim=-1)[..., 0]
    return torch.mean(lse - true_logit)
