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

On a mesh (``x`` a ``DTensor`` on the compute mesh, replicated over
``model``) the routing, the sort and the index tables run on the rank's
local tokens, and only the collectives below cross ranks.  The reference's
chunks are of the *whole* token stream: the batch that its ``moe_apply``
sees, which the ranks of the stream axes (:func:`~repro_torch.models.
sharding.token_stream`: the data-parallel axes in serving, a group's inner
axes in training) split in equal slices.  So the chunk count is
``dispatch_chunks`` of that whole batch.  Where the rank's slice is whole
chunks, their tables are its own; where a chunk spans ranks, the chunk's
expert choices (``[t, k]`` ints) are all-gathered over the stream
(``moe routing gather``), the chunk's tables computed whole and then cut
to the rank's own kept pairs (each expert's in the reference's order), so
the rank's experts run over its own rows only.  The experts then run in
the reference's two modes: expert-parallel (``E % 16 == 0``: deepseek-v2)
with each ``model`` rank's experts over their slots and the outputs
all-gathered over ``model`` (``moe EP combine``; its backward takes the
rank's part, and the slice of the rank's experts all-gathers its
cotangent); ffn-sharded (grok-1) with each rank's share of every
expert's hidden dim and the down-projection's partial sums all-reduced
over ``model`` (``moe ffn all-reduce``; the cotangent of the experts'
input is all-reduced in the backward).  The aux loss is of the whole
stream (``moe aux``): the expert counts are summed and the mean
probabilities averaged over the stream's ranks; its gradient on each rank
is that of its own probabilities against the stream's counts, so the mean
of the ranks' gradients (the mesh step's mean over a group's inner axes)
is the reference's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import sharding
from repro_torch.models.layers import ParamDecl, round_up, tp_contract
from repro_torch.models.sharding import P, shard


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


def _ep_mode(cfg: ModelConfig) -> bool:
    """True -> expert dim sharded over 'model' (deepseek); False -> per-
    expert ffn dim sharded (grok)."""
    return cfg.num_experts % 16 == 0


def _swiglu(x, w_gate, w_up, w_down, eq_in: str, eq_out: str):
    g = torch.einsum(eq_in, x, w_gate.to(x.dtype))
    u = torch.einsum(eq_in, x, w_up.to(x.dtype))
    h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    return tp_contract(eq_out, h, w_down.to(x.dtype))


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


def _index_tables(flat_expert, e: int, k: int, capacity: int):
    """The reference's index tables of chunks of (token, expert) pairs
    ``flat_expert`` [x, t*k]: ``slot_of_pair`` [x, t*k], ``src_of_slot`` and
    ``pair_of_slot`` [x, e*capacity] (pads: slot ``e*capacity``, token
    ``t``, pair ``t*k``)."""
    nx, tk = flat_expert.shape
    dev = flat_expert.device
    sort_idx = torch.argsort(flat_expert, dim=-1, stable=True)  # [x, tk]
    sorted_expert = torch.gather(flat_expert, 1, sort_idx)
    counts = torch.zeros((nx, e), dtype=torch.int64, device=dev).scatter_add_(
        1, flat_expert, torch.ones_like(flat_expert))
    seg_start = torch.cumsum(counts, dim=-1) - counts  # [x, e]
    pos_in_expert = (torch.arange(tk, device=dev)[None]
                     - torch.gather(seg_start, 1, sorted_expert))
    n_slots = e * capacity
    keep = pos_in_expert < capacity  # [x, tk]
    # kept pairs land in distinct slots (expert, position); every dropped pair
    # writes the same value into the pad column, which is cut off
    slot_sorted = torch.where(keep, sorted_expert * capacity + pos_in_expert, n_slots)
    src_token = sort_idx // k
    slot_of_pair = torch.full((nx, tk), n_slots, dtype=torch.int64, device=dev).scatter_(
        1, sort_idx, slot_sorted)
    src_of_slot = torch.full((nx, n_slots + 1), tk // k, dtype=torch.int64, device=dev).scatter_(
        1, slot_sorted, torch.where(keep, src_token, tk // k))[:, :n_slots]
    pair_of_slot = torch.full((nx, n_slots + 1), tk, dtype=torch.int64, device=dev).scatter_(
        1, slot_sorted, torch.where(keep, sort_idx, tk))[:, :n_slots]
    return slot_of_pair, src_of_slot, pair_of_slot


def _own_slots(own, slot_of_pair, src_of_slot, pair_of_slot, e: int, capacity: int, t: int,
               k: int):
    """The index tables cut to the slots that ``own`` [x, e*capacity] marks
    (this rank's kept pairs of chunks that span ranks), each expert's in
    their order at the front of its ``c`` slots, ``c`` the most any expert
    of any chunk keeps here: so the rank's experts run over its own rows
    only.  Every row of the expert FFN is independent, so its values are
    those of the whole chunk's slots.  Returns the tables and ``c``.

    ``c`` is read on the host; meta tensors (a dry run's, which hold no
    data) take its static bound ``capacity`` instead, the most it can be."""
    nx = own.shape[0]
    per_expert = own.reshape(nx, e, capacity)
    c = capacity if own.is_meta else max(int(per_expert.sum(-1).max()), 1)
    pad = e * c
    pos = per_expert.cumsum(-1) - 1 + torch.arange(e, device=own.device)[:, None] * c
    new = torch.where(per_expert, pos, pad).reshape(nx, e * capacity)
    remap = torch.cat([new, new.new_full((nx, 1), pad)], dim=1)  # the pad slot stays pad

    def cut(table, fill):
        return torch.full((nx, pad + 1), fill, dtype=table.dtype, device=table.device).scatter_(
            1, new, torch.where(own, table, fill))[:, :pad]

    return (torch.gather(remap, 1, slot_of_pair), cut(src_of_slot, t), cut(pair_of_slot, t * k),
            c)


# ---------------------------------------------------------------------------
# Collectives on a mesh
# ---------------------------------------------------------------------------


def _all_gather(t, group, dim: int):
    """``t`` from every rank of ``group``, concatenated along ``dim`` in the
    group's rank order (a functional all-gather: counted by ``count_cost``,
    and staged on the host where gloo runs CUDA tensors)."""
    ops = torch.ops._c10d_functional
    n = group.size()
    out = ops.wait_tensor(ops.all_gather_into_tensor(t.contiguous(), n, group.group_name))
    return torch.cat(out.chunk(n), dim=dim) if dim else out


def _all_reduce(t, group):
    """``t`` summed over the ranks of ``group`` (a functional all-reduce)."""
    ops = torch.ops._c10d_functional
    return ops.wait_tensor(ops.all_reduce(t.contiguous(), "sum", group.group_name))


class _ExpertSlice(torch.autograd.Function):
    """Expert-parallel: this ``model`` rank's experts (dim 1) of the
    replicated grouped tokens; the backward all-gathers the ranks'
    cotangents, so the dispatch's backward sees every expert's."""

    @staticmethod
    def forward(ctx, grouped, group, rank: int, n: int):
        ctx.group = group
        return grouped[:, rank * n:(rank + 1) * n]

    @staticmethod
    def backward(ctx, d_mine):
        with sharding.collective_site("moe EP combine"):
            return _all_gather(d_mine, ctx.group, 1), None, None, None


class _GatherExperts(torch.autograd.Function):
    """Expert-parallel combine: every rank's experts' outputs all-gathered
    over ``model`` along dim 1 (the reference's EP combine collective); the
    backward takes this rank's part of the replicated cotangent."""

    @staticmethod
    def forward(ctx, y_mine, group, rank: int):
        ctx.rank, ctx.n = rank, y_mine.shape[1]
        with sharding.collective_site("moe EP combine"):
            return _all_gather(y_mine, group, 1)

    @staticmethod
    def backward(ctx, d_y):
        return d_y[:, ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n], None, None


class _ReduceGrad(torch.autograd.Function):
    """ffn-sharded: the identity, whose backward sums the cotangent's
    partial sums (each rank's share of the hidden dim) over ``model``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, d_x):
        with sharding.collective_site("moe ffn all-reduce"):
            return _all_reduce(d_x, ctx.group), None


class _ReduceOut(torch.autograd.Function):
    """ffn-sharded: the down-projection's partial sums all-reduced over
    ``model`` (the reference's ``tp_contract`` psum); the backward is the
    identity (the cotangent is replicated)."""

    @staticmethod
    def forward(ctx, y, group):
        with sharding.collective_site("moe ffn all-reduce"):
            return _all_reduce(y, group)

    @staticmethod
    def backward(ctx, d_y):
        return d_y, None


def _stream_all_gather(t, mesh, axes):
    """``t`` [n, ...] from every rank along the mesh axes ``axes`` (the first
    one major), concatenated along dim 0 in the stream's order."""
    for a in reversed(axes):  # the minor axis first
        t = _all_gather(t, mesh.get_group(a), 0)
    return t


def moe_apply(cfg: ModelConfig, params, x, *, capacity_factor: float | None = None):
    """Returns (output [b, s, d], aux load-balance loss []); on a mesh, see
    the module docstring."""
    from torch.distributed.tensor import DTensor, Replicate

    e, k = cfg.num_experts, cfg.top_k
    cf = capacity_factor or cfg.capacity_factor
    names = ("router", "w_gate", "w_up", "w_down")
    cm = x.device_mesh if sharding.is_sharded(x) else None
    if cm is not None:
        x = shard(x, P(None, None, None))  # whole on every rank (a pending TP sum reduced)
        mesh, axes = sharding.get_mesh(), sharding.stream_axes()
        r, R = sharding.coordinate(mesh, axes)
        local = {name: params[name].to_local() for name in names}
        x_loc = x.to_local()
    else:
        r, R = 0, 1
        local = {name: params[name] for name in names}
        x_loc = x
    b_loc, s, d = x_loc.shape
    B = b_loc * R  # the stream's batch: the reference's b
    nx = dispatch_chunks(cfg, B)
    t = (B // nx) * s  # tokens per chunk
    n_loc = b_loc * s
    lo, hi = r * n_loc, (r + 1) * n_loc  # this rank's tokens in the stream
    c0, c1 = lo // t, (hi - 1) // t + 1  # the chunks they lie in
    before, after = lo - c0 * t, c1 * t - hi

    probs, gate_vals, gate_idx = route(cfg, local, x_loc)  # [b, s, e], [b, s, k]

    # aux loss (Switch-style) over the whole stream: its expert counts summed
    # and its mean probabilities averaged over the stream's ranks; the
    # gradient that of this rank's own probabilities against them
    flat = gate_idx.reshape(-1)
    # (a scatter, not bincount, whose size depends on the data: a dry run's
    # meta tensors have none)
    counts = torch.zeros(e, dtype=torch.int64, device=flat.device).scatter_add_(
        0, flat, torch.ones_like(flat)).to(torch.float32)
    me = probs.mean(dim=(0, 1))  # [e]
    me_all = me.detach()
    if R > 1:
        with sharding.collective_site("moe aux"):
            counts = torch.stack([counts, me_all])
            for a in axes:
                counts = _all_reduce(counts, mesh.get_group(a))
            counts, me_all = counts[0], counts[1] / R
    aux = ((me + (me_all - me).detach()) * (counts / (B * s * k))).sum() * e

    # ---- chunk-local stable sort of (token, expert) pairs, index tables ----
    if before or after:  # a chunk spans ranks: its expert choices from all of them
        with sharding.collective_site("moe routing gather"):
            stream = _stream_all_gather(gate_idx.reshape(n_loc, k), mesh, axes)
        flat_expert = stream[c0 * t:c1 * t].reshape(c1 - c0, t * k)
    else:
        flat_expert = gate_idx.reshape(c1 - c0, t * k)
    capacity = capacity_of(cfg, t, cf)
    slot_of_pair, src_of_slot, pair_of_slot = _index_tables(flat_expert, e, k, capacity)
    tok, gates = x_loc.reshape(n_loc, d), gate_vals.to(x_loc.dtype).reshape(n_loc, k)
    if before or after:
        # only this rank's kept pairs keep their slots (the other ranks' pairs
        # go to the pad slot); its tokens and gates padded to the chunks
        own = torch.zeros(((c1 - c0) * t,), dtype=torch.bool, device=tok.device)
        own[before:before + n_loc] = True
        own = own.reshape(c1 - c0, t)
        own_slot = torch.gather(torch.cat([own, own.new_zeros((c1 - c0, 1))], 1), 1, src_of_slot)
        slot_of_pair, src_of_slot, pair_of_slot, capacity = _own_slots(
            own_slot, slot_of_pair, src_of_slot, pair_of_slot, e, capacity, t, k)
        tok = torch.cat([tok.new_zeros((before, d)), tok, tok.new_zeros((after, d))])
        gates = torch.cat([gates.new_zeros((before, k)), gates, gates.new_zeros((after, k))])
    n_slots = e * capacity

    # ---- gather dispatch (its backward a gather too) ----
    grouped = _Dispatch.apply(tok.reshape(c1 - c0, t, d), src_of_slot, slot_of_pair)
    grouped = grouped.reshape(c1 - c0, e, capacity, d)

    # ---- grouped expert FFN (swiglu), in the experts' mode on a mesh ----
    w = (local["w_gate"], local["w_up"], local["w_down"])
    eq = ("xecd,edf->xecf", "xecf,efd->xecd")
    tp = 1 if cm is None else cm.size(cm.mesh_dim_names.index("model"))
    if tp == 1:
        y = _swiglu(grouped, *w, *eq)
    elif _ep_mode(cfg):
        group, rank = cm.get_group("model"), cm.get_local_rank("model")
        mine = _ExpertSlice.apply(grouped, group, rank, w[0].shape[0])
        y = _GatherExperts.apply(_swiglu(mine, *w, *eq), group, rank)
    else:
        group = cm.get_group("model")
        y = _ReduceOut.apply(_swiglu(_ReduceGrad.apply(grouped, group), *w, *eq), group)

    # ---- gather combine ----
    out = _Combine.apply(y.reshape(c1 - c0, n_slots, d), gates.reshape(c1 - c0, t, k),
                         slot_of_pair, src_of_slot, pair_of_slot)
    out = out.reshape(-1, d)[before:before + n_loc].reshape(b_loc, s, d)
    if cm is not None:
        out = DTensor.from_local(out, cm, [Replicate()] * cm.ndim, run_check=False)
        aux = DTensor.from_local(aux, cm, [Replicate()] * cm.ndim, run_check=False)
    if cfg.num_shared_experts:
        out = shard(out + _shared(params, x), P(None, None, None))
    return out, aux


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
