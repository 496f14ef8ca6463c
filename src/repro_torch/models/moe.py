"""Mixture-of-experts with chunk-local sort-based capacity dispatch, from
``repro.models.moe``: serving and training.

Tokens choose their top-k experts.  The token stream is split into
``cfg.moe_dispatch_chunks`` chunks when that divides the batch (else one),
and tokens compete for per-expert capacity only within their chunk.  The
(token, expert) pairs of a chunk are sorted by expert, stably, and a pair
past its expert's capacity is dropped; the reference's index tables follow
(``slot_of_pair``: the slot each pair landed in, or the pad slot;
``src_of_slot``: the token each slot holds, or the pad token;
``pair_of_slot``: the pair each slot holds, or the pad pair), and dispatch
and combine are plain gathers over them.  The expert FFNs are grouped
einsums over ``[x, E, C, d]``, as in the reference (cuBLAS here, XLA there:
neither is a Pallas kernel).

Dispatch and combine are the reference's ``custom_vjp`` pair, here
:class:`_Dispatch` and :class:`_Combine` (``torch.autograd.Function``):
both directions of both are gathers over the index tables, so no backward
sums through an accumulating ``index_put``, whose order of adds is its
kernel's: the dispatch's backward sums each token's k slots' cotangents
over the k axis, as the reference does, and the combine's gathers ``d_out``
by ``src_of_slot`` and scales it by the slot's gate.  The aux loss's expert counts carry no
gradient (the reference's constant scatter); its mean probabilities do.

Where the reference's order matters the port keeps it: the top k are taken
from a stable descending sort (``jax.lax.top_k`` puts the lower index first
among equal values, and bfloat16 router logits do tie; its gradient reaches
the selected entries, as ``top_k``'s does), the pairs' sort is stable
(``jnp.argsort``), and the capacity is the reference's integer and float
arithmetic.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamDecl, round_up


def moe_decls(cfg: ModelConfig) -> dict[str, ParamDecl]:
    d, e, f = cfg.d_model, cfg.num_experts, cfg.d_ff_expert
    out = {
        "router": ParamDecl((d, e), ("embed", "none"), init="scaled"),
        "w_gate": ParamDecl((e, d, f), ("expert", "embed2", "expert_mlp"), init="scaled"),
        "w_up": ParamDecl((e, d, f), ("expert", "embed2", "expert_mlp"), init="scaled"),
        "w_down": ParamDecl((e, f, d), ("expert", "expert_mlp", "embed2"), init="scaled"),
    }
    if cfg.num_shared_experts:
        fs = cfg.num_shared_experts * f
        out["shared_gate"] = ParamDecl((d, fs), ("embed", "mlp"), init="scaled")
        out["shared_up"] = ParamDecl((d, fs), ("embed", "mlp"), init="scaled")
        out["shared_down"] = ParamDecl((fs, d), ("mlp", "embed"), init="scaled")
    return out


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values, the lower
    index first among equal ones (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(cfg: ModelConfig, params, tokens):
    """Router probabilities (float32) over ``tokens`` [..., d], and the
    normalized top-k gate values and their expert indices [..., k]."""
    logits = torch.einsum("...d,de->...e", tokens, params["router"].to(tokens.dtype))
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    gate_vals, gate_idx = top_k(probs, cfg.top_k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, gate_vals, gate_idx


def _swiglu(x, w_gate, w_up, w_down, eq_in: str, eq_out: str):
    g = torch.einsum(eq_in, x, w_gate.to(x.dtype))
    u = torch.einsum(eq_in, x, w_up.to(x.dtype))
    h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    return torch.einsum(eq_out, h, w_down.to(x.dtype))


def _shared(params, tokens):
    return _swiglu(tokens, params["shared_gate"], params["shared_up"], params["shared_down"],
                   "...d,df->...f", "...f,fd->...d")


def capacity_of(cfg: ModelConfig, tokens_per_chunk: int, capacity_factor: float) -> int:
    """Slots per expert and chunk: the reference's Python arithmetic."""
    e, k = cfg.num_experts, cfg.top_k
    return round_up(max(int(math.ceil(tokens_per_chunk * k * capacity_factor / e)), 8), 8)


def dispatch_chunks(cfg: ModelConfig, batch: int) -> int:
    """Chunks of the token stream: ``moe_dispatch_chunks`` where it divides
    the batch, else one."""
    return cfg.moe_dispatch_chunks if batch % max(cfg.moe_dispatch_chunks, 1) == 0 else 1


def _take(arr, idx):
    """Batched row gather: arr [x, n, ...], idx [x, m] -> [x, m, ...] (an
    index kernel: ``take_along_dim`` would first expand ``idx`` to int64
    rows as wide as ``arr``'s, 25 GiB at grok-1's width)."""
    return arr[torch.arange(arr.shape[0], device=arr.device)[:, None], idx]


def _pad_row(a):
    """``a`` [x, n, ...] with one zero row appended along axis 1."""
    return torch.cat([a, a.new_zeros((a.shape[0], 1) + a.shape[2:])], dim=1)


class _Dispatch(torch.autograd.Function):
    """``grouped[slot] = tokens[src_of_slot]`` (the pad token: zeros); the
    backward ``d_tokens[t] = Σ_j d_grouped[slot_of_pair[t, j]]``."""

    @staticmethod
    def forward(ctx, tokens, src_of_slot, slot_of_pair):
        ctx.save_for_backward(slot_of_pair)
        ctx.tokens_per_chunk = tokens.shape[1]
        return _take(_pad_row(tokens), src_of_slot)

    @staticmethod
    def backward(ctx, d_grouped):
        (slot_of_pair,) = ctx.saved_tensors
        nx, tk = slot_of_pair.shape
        t = ctx.tokens_per_chunk
        d_pairs = _take(_pad_row(d_grouped), slot_of_pair)  # [x, t*k, d]
        return d_pairs.reshape(nx, t, tk // t, -1).sum(dim=2), None, None


class _Combine(torch.autograd.Function):
    """``out[t] = Σ_j gate[t, j] · y[slot_of_pair[t, j]]``; the backward
    ``d_y[slot] = gate_of_slot · d_out[src_of_slot]`` and ``d_gate[t, j] =
    y[slot_of_pair[t, j]] · d_out[t]`` (returned in the gates' dtype)."""

    @staticmethod
    def forward(ctx, y_flat, gates, slot_of_pair, src_of_slot, pair_of_slot):
        ctx.save_for_backward(y_flat, gates, slot_of_pair, src_of_slot, pair_of_slot)
        nx, t, k = gates.shape
        y_pairs = _take(_pad_row(y_flat), slot_of_pair).reshape(nx, t, k, -1)
        return (y_pairs * gates[..., None]).sum(dim=2)

    @staticmethod
    def backward(ctx, d_out):
        y_flat, gates, slot_of_pair, src_of_slot, pair_of_slot = ctx.saved_tensors
        nx, t, k = gates.shape
        gf_pad = _pad_row(gates.reshape(nx, t * k))
        gate_of_slot = _take(gf_pad, pair_of_slot)
        d_y = _take(_pad_row(d_out), src_of_slot) * gate_of_slot[..., None]
        y_pairs = _take(_pad_row(y_flat), slot_of_pair).reshape(nx, t, k, -1)
        d_gates = (y_pairs * d_out[:, :, None, :]).sum(dim=-1)
        return d_y, d_gates.to(gates.dtype), None, None, None


def moe_apply(cfg: ModelConfig, params, x, *, capacity_factor: float | None = None):
    """Returns (output [b, s, d], aux load-balance loss [])."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    cf = capacity_factor or cfg.capacity_factor
    nx = dispatch_chunks(cfg, b)
    t = (b // nx) * s  # tokens per chunk
    tokens = x.reshape(nx, t, d)
    dev = x.device

    probs, gate_vals, gate_idx = route(cfg, params, tokens)  # [x, t, k]

    # aux loss (Switch-style), over the full stream
    me = probs.mean(dim=(0, 1))  # [e]
    ce = torch.bincount(gate_idx.reshape(-1), minlength=e).to(torch.float32) / (nx * t * k)
    aux = (me * ce).sum() * e

    # ---- chunk-local stable sort of (token, expert) pairs ----
    flat_expert = gate_idx.reshape(nx, t * k)
    sort_idx = torch.argsort(flat_expert, dim=-1, stable=True)  # [x, tk]
    sorted_expert = torch.gather(flat_expert, 1, sort_idx)
    counts = torch.zeros((nx, e), dtype=torch.int64, device=dev).scatter_add_(
        1, flat_expert, torch.ones_like(flat_expert))
    seg_start = torch.cumsum(counts, dim=-1) - counts  # [x, e]
    pos_in_expert = (torch.arange(t * k, device=dev)[None]
                     - torch.gather(seg_start, 1, sorted_expert))

    capacity = capacity_of(cfg, t, cf)
    n_slots = e * capacity
    keep = pos_in_expert < capacity  # [x, tk]
    # kept pairs land in distinct slots (expert, position); every dropped pair
    # writes the same value into the pad column, which is cut off
    slot_sorted = torch.where(keep, sorted_expert * capacity + pos_in_expert, n_slots)
    src_token = sort_idx // k
    slot_of_pair = torch.full((nx, t * k), n_slots, dtype=torch.int64, device=dev).scatter_(
        1, sort_idx, slot_sorted)
    src_of_slot = torch.full((nx, n_slots + 1), t, dtype=torch.int64, device=dev).scatter_(
        1, slot_sorted, torch.where(keep, src_token, t))[:, :n_slots]
    pair_of_slot = torch.full((nx, n_slots + 1), t * k, dtype=torch.int64, device=dev).scatter_(
        1, slot_sorted, torch.where(keep, sort_idx, t * k))[:, :n_slots]

    # ---- gather dispatch (its backward a gather too) ----
    grouped = _Dispatch.apply(tokens, src_of_slot, slot_of_pair).reshape(nx, e, capacity, d)

    # ---- grouped expert FFN (swiglu) ----
    y_grouped = _swiglu(grouped, params["w_gate"], params["w_up"], params["w_down"],
                        "xecd,edf->xecf", "xecf,efd->xecd")

    # ---- gather combine ----
    out = _Combine.apply(y_grouped.reshape(nx, n_slots, d), gate_vals.to(x.dtype),
                         slot_of_pair, src_of_slot, pair_of_slot)

    if cfg.num_shared_experts:
        out = out + _shared(params, tokens)
    return out.reshape(b, s, d), aux


def moe_reference(cfg: ModelConfig, params, x):
    """Dense per-token loop-over-experts oracle (tests only, no capacity)."""
    b, s, d = x.shape
    tokens = x.reshape(-1, d)
    _, gate_vals, gate_idx = route(cfg, params, tokens)
    out = torch.zeros_like(tokens)
    for ei in range(cfg.num_experts):
        yi = _swiglu(tokens, params["w_gate"][ei], params["w_up"][ei], params["w_down"][ei],
                     "td,df->tf", "tf,fd->td")
        wmatch = torch.where(gate_idx == ei, gate_vals, 0.0).sum(-1)  # [t]
        out = out + yi * wmatch[:, None].to(x.dtype)
    if cfg.num_shared_experts:
        out = out + _shared(params, tokens)
    return out.reshape(b, s, d)
