"""GQA attention (+RoPE, optional QKV bias) and MLA (deepseek-v2) with
prefill and KV-cached decode paths, from ``repro.models.attention``.

The math follows the reference op for op: scores are formed in the
activation dtype and softmaxed in float32, probabilities cast back, and
masked scores set to ``NEG_INF`` (-1e30).  The reference's sharding
constraints are kept at its sites (``models/sharding.py``): query heads
over ``model``, the output projection a TP contraction
(:func:`~repro_torch.models.layers.tp_contract`), and decode caches split
over their sequence on ``model``, each rank writing its own part
(:func:`~repro_torch.models.sharding.write_slice`).  Without a mesh they
are no-ops.

Prefill attention (:func:`_attend`) on CUDA tensors with the ``"cuda"``
kernel backend runs CUDA kernel K6 (``kernels/flash_attention.py``), which
reads the model's ``[b, s, h, d]`` tensors in place and serves GQA without
repeating K and V; on CPU tensors, or with the ``"torch"`` backend, it is
the reference's ``full_attention`` / ``chunked_attention`` as written.  The
same goes for whisper's non-causal calls (its encoder's self-attention and
the decoder's cross-attention, :func:`cross_attention_forward`, at prefill
and at every decode step): K6 takes any key count there, as
``full_attention`` does.
Decode attention (:func:`gqa_decode_step`) is a plain einsum over the
cache, as the reference computes it outside any Pallas kernel; it writes
the new key and value into the cache in place (the reference donates the
cache to its jitted step).

MLA (:func:`mla_forward`, :func:`mla_prefill_with_cache`, the absorbed
:func:`mla_decode_step`) attends through the plain attention on every
device (``backend="torch"``), as the reference's MLA does: its q/k head dim
(``qk_nope_dim + qk_rope_dim``, 192 at deepseek-v2) differs from its v head
dim and passes its own scale, and K6 takes neither (one head dim for q, k
and v, the default scale).  Its cache is the compressed ``c_kv`` and the
shared ``k_rope``, written in place at decode.  Cross-attention
(:func:`cross_attention_forward`) reads keys and values that
:func:`encoder_kv` projects once from the encoder's output.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels._build import route
from repro_torch.kernels.flash_attention import flash_attention_bshd
from repro_torch.models.layers import ParamDecl, apply_rope, tp_contract
from repro_torch.models.sharding import is_sharded, shard_batch, write_slice

NEG_INF = -1e30
# materialize full scores only below this many query positions
CHUNKED_ATTENTION_THRESHOLD = 8_192
QUERY_CHUNK = 1_024


# ---------------------------------------------------------------------------
# Declarations
# ---------------------------------------------------------------------------


def gqa_decls(cfg: ModelConfig, heads: int | None = None) -> dict[str, ParamDecl]:
    from repro_torch.models.transformer import padded_kv_heads

    d, hd = cfg.d_model, cfg.resolved_head_dim
    h = heads or cfg.num_heads
    kvh = padded_kv_heads(cfg)
    out = {
        "wq": ParamDecl((d, h, hd), ("embed", "heads", "head"), init="scaled"),
        "wk": ParamDecl((d, kvh, hd), ("embed", "kv_heads", "head"), init="scaled"),
        "wv": ParamDecl((d, kvh, hd), ("embed", "kv_heads", "head"), init="scaled"),
        "wo": ParamDecl((h, hd, d), ("heads", "head", "embed"), init="scaled"),
    }
    if cfg.qkv_bias:
        out["bq"] = ParamDecl((h, hd), ("heads", "head"), init="zeros")
        out["bk"] = ParamDecl((kvh, hd), ("kv_heads", "head"), init="zeros")
        out["bv"] = ParamDecl((kvh, hd), ("kv_heads", "head"), init="zeros")
    return out


def mla_decls(cfg: ModelConfig) -> dict[str, ParamDecl]:
    d, h = cfg.d_model, cfg.num_heads
    nope, rope, vh, lora = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, cfg.kv_lora_rank
    return {
        "wq": ParamDecl((d, h, nope + rope), ("embed", "heads", "head"), init="scaled"),
        "w_dkv": ParamDecl((d, lora), ("embed", "lora"), init="scaled"),
        "w_kr": ParamDecl((d, rope), ("embed", "head"), init="scaled"),
        "kv_norm": ParamDecl((lora,), ("lora",), init="ones", dtype="float32"),
        "w_uk": ParamDecl((lora, h, nope), ("lora", "heads", "head"), init="scaled"),
        "w_uv": ParamDecl((lora, h, vh), ("lora", "heads", "head"), init="scaled"),
        "wo": ParamDecl((h, vh, d), ("heads", "head", "embed"), init="scaled"),
    }


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------


def _repeat_kv(x: torch.Tensor, n: int) -> torch.Tensor:
    """[b, s, kvh, d] -> [b, s, kvh*n, d]."""
    if n == 1:
        return x
    return torch.repeat_interleave(x, n, dim=2)


def full_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                   scale: float | None = None) -> torch.Tensor:
    """q [b, sq, h, d], k [b, sk, h, d], v [b, sk, h, dv] -> [b, sq, h, dv]."""
    scale = scale or 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        qpos = torch.arange(sq, device=q.device) + q_offset
        kpos = torch.arange(sk, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        scores = torch.where(mask[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    probs = shard_batch(probs, "model", None, None)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def chunked_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                      chunk: int = QUERY_CHUNK, scale: float | None = None) -> torch.Tensor:
    """Query-chunked attention: per-chunk memory is [b, h, chunk, sk]."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = scale or 1.0 / math.sqrt(d)
    if sq % chunk != 0:
        return full_attention(q, k, v, causal=causal, q_offset=q_offset, scale=scale)
    kpos = torch.arange(sk, device=q.device)
    outs = []
    for i in range(sq // chunk):
        qblk = q[:, i * chunk:(i + 1) * chunk]
        scores = torch.einsum("bqhd,bkhd->bhqk", qblk, k).to(torch.float32) * scale
        if causal:
            qpos = i * chunk + torch.arange(chunk, device=q.device) + q_offset
            mask = kpos[None, :] <= qpos[:, None]
            scores = torch.where(mask[None, None], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", probs, v))
    return torch.cat(outs, dim=1)


def _attend(q, k, v, *, causal: bool, q_offset: int = 0, scale: float | None = None,
            backend: str = "cuda") -> torch.Tensor:
    """Attention of q [b, sq, h, d] over k, v [b, sk, kvh, d] (``h % kvh == 0``).

    CUDA tensors with the ``"cuda"`` backend go through K6, which takes the
    prefill and cross-attention calls of this model (q_offset 0, the default
    scale, sq == sk when causal, any sk when not) and refuses others;
    everything else is the reference's plain path over repeated kv heads.
    Meta tensors go where a dry run sends them (``_build.route``): K6's
    count-only path under ``dry_run("card")``, the plain path under
    ``"plain"``; outside a dry run they raise.
    On a mesh either runs on each rank's own heads (:func:`_on_local_heads`).
    """
    if is_sharded(q):
        return _on_local_heads(lambda a, b, c: _attend(
            a, b, c, causal=causal, q_offset=q_offset, scale=scale, backend=backend), q, k, v)
    if backend == "cuda" and route(q, k, v, counts=True) != "plain":
        if q_offset or scale is not None or (causal and q.shape[1] != k.shape[1]):
            raise ValueError(
                f"the flash-attention kernel serves prefill attention (q_offset 0, the "
                f"default scale, sq == sk); got q_offset={q_offset}, scale={scale}, "
                f"sq={q.shape[1]}, sk={k.shape[1]}"
            )
        return flash_attention_bshd(q, k, v, causal=causal)
    groups = q.shape[2] // k.shape[2]
    k, v = _repeat_kv(k, groups), _repeat_kv(v, groups)
    if q.shape[1] > CHUNKED_ATTENTION_THRESHOLD:
        return chunked_attention(q, k, v, causal=causal, q_offset=q_offset, scale=scale)
    return full_attention(q, k, v, causal=causal, q_offset=q_offset, scale=scale)


def _own_kv_heads(mesh, h: int, kvh: int) -> tuple[int, int]:
    """``(k0, nk)``: the kv heads ``[k0, k0 + nk)`` that this rank's query
    heads read, of ``h`` query heads split over the 1-D ``mesh`` in groups
    of ``h // kvh`` per kv head."""
    m = mesh.size(0)
    if h % m or h % kvh:
        raise ValueError(f"{h} query heads do not split over {m} ranks in groups of "
                         f"{kvh} kv heads")
    hl, start, group = h // m, mesh.get_local_rank(0) * (h // m), h // kvh
    if hl % group and group % hl:
        raise ValueError(f"a rank's {hl} query heads straddle the {group}-head kv groups")
    return start // group, max(hl // group, 1)


def _on_local_heads(fn, q, k, v):
    """``fn(q, k, v)`` on this rank's heads of ``DTensor`` q [b, s, h, d]
    (heads split over the compute mesh's ``model`` axis) and k, v [b, sk,
    kvh, d] (split the same way, or replicated: the GQA models whose kv
    heads the rules leave whole; or plain tensors that hold the rank's kv
    heads already, :func:`_project_qkv`'s ``own_kv``).  ``fn`` sees plain
    local tensors: the rank's query heads and the kv heads they read, which
    are its own shard of k and v or a slice of the replicated ones.
    Attention is independent per head, so nothing is communicated; the
    local output comes back as a ``DTensor`` laid out as q (differentiably:
    training's plain attention runs here too)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    q = shard_batch(q, None, "model", None)
    mesh = q.device_mesh
    if mesh.ndim != 1 or list(q.placements) != [Shard(2)]:
        raise ValueError(f"attention on a mesh takes q split over heads on a 1-D compute "
                         f"mesh, got {q.placements} on {mesh.mesh_dim_names}")
    m = mesh.size(0)

    def local(t):
        if not isinstance(t, DTensor):
            return t
        k0, nk = _own_kv_heads(mesh, q.shape[2], t.shape[2])
        if list(t.placements) == [Shard(2)] and t.shape[2] // m == nk and (
                mesh.get_local_rank(0) * nk == k0):
            return t.to_local()
        full = t if list(t.placements) == [Replicate()] else t.redistribute(mesh, [Replicate()])
        # each rank reads its own kv heads of the whole: their gradients are
        # one rank's addends of the whole's gradient
        return full.to_local(grad_placements=[Partial()])[:, :, k0:k0 + nk]

    out = fn(q.to_local(), local(k), local(v))
    return DTensor.from_local(out, mesh, q.placements, run_check=False)


def _decode_attend_sharded(q, k, v, index: int, scale: float, dtype):
    """Decode attention of one query position over a cache split along its
    sequence (``DTensor`` k, v [b, S, kvh, d] on the compute mesh; q [b, 1,
    h, d]), as the reference shards it: each rank scores every head against
    its own positions, and the softmax's max and sum and the weighted values
    are all-reduced (``Partial`` max and sum).  The probabilities are the
    reference's up to the order of the float32 sums; the values are summed
    in float32 before the cast to ``dtype``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = k.device_mesh
    qf = q.full_tensor() if is_sharded(q) else q
    kl, vl = k.to_local(), v.to_local()
    s_loc = kl.shape[1]
    off = mesh.get_local_rank(0) * s_loc
    groups = qf.shape[2] // kl.shape[2]
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, _repeat_kv(kl, groups)).to(torch.float32)
    scores = scores * scale
    valid = torch.arange(off, off + s_loc, device=scores.device)[None, None, None, :] <= index

    def reduced(t, op):
        return DTensor.from_local(t, mesh, [Partial(op)], run_check=False).redistribute(
            mesh, [Replicate()]).to_local()

    scores = torch.where(valid, scores, NEG_INF)
    mx = reduced(scores.amax(dim=-1, keepdim=True), "max")
    p = torch.exp(scores - mx)
    denom = reduced(p.sum(dim=-1, keepdim=True), "sum")
    probs = (p / denom).to(dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(torch.float32),
                       _repeat_kv(vl, groups).to(torch.float32))
    out = reduced(out, "sum").to(dtype)
    return DTensor.from_local(out, mesh, [Replicate()], run_check=False)


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the cotangent contiguous: einsum's
    backward views its output's cotangent, and a ``DTensor`` whose local
    shard was transposed (the attention's) cannot be viewed (DTensor plans
    the view from the global strides: at one query head per rank the local
    ones differ and the view raises)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor

        # (``g.contiguous()`` trusts the global strides, and returns g)
        return DTensor.from_local(g.to_local().contiguous(), g.device_mesh, g.placements,
                                  shape=g.shape, stride=g.stride(), run_check=False)


def _project(x, w):
    """``x`` [b, s, d] by a head projection ``w`` [d, h, k] -> [b, s, h, k]."""
    y = torch.einsum("bsd,dhk->bshk", x, w.to(x.dtype))
    return _ContiguousGrad.apply(y) if is_sharded(y) else y


def _project_qkv(cfg: ModelConfig, params, x, *, own_kv: bool = False):
    """q, k, v [b, s, heads, hd] of x [b, s, d].  With ``own_kv``, where a
    mesh splits the query heads and leaves the kv weights whole (kv heads no
    multiple of the TP degree), k and v are projected for this rank's kv
    heads only, as plain local tensors (:func:`_project_own_kv`)."""
    q = _project(x, params["wq"])
    if own_kv and _kv_replicated(q, x, params["wk"]):
        k0, nk = _own_kv_heads(q.device_mesh, q.shape[2], params["wk"].shape[1])
        k, v = (_project_own_kv(x, params[w], params[b] if cfg.qkv_bias else None, k0, nk)
                for w, b in (("wk", "bk"), ("wv", "bv")))
    else:
        k = _project(x, params["wk"])
        v = _project(x, params["wv"])
        if cfg.qkv_bias:
            k = k + params["bk"].to(x.dtype)
            v = v + params["bv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
    return q, k, v


def _kv_replicated(q, x, wk) -> bool:
    """Whether q is split over heads on a 1-D mesh where x and the kv
    weight ``wk`` are whole on every rank."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    return (isinstance(q, DTensor) and isinstance(x, DTensor) and isinstance(wk, DTensor)
            and q.device_mesh.ndim == 1 and x.device_mesh == q.device_mesh
            and wk.device_mesh == q.device_mesh and list(q.placements) == [Shard(2)]
            and list(x.placements) == [Replicate()] and list(wk.placements) == [Replicate()])


def _project_own_kv(x, w, bias, k0: int, nk: int):
    """x [b, s, d] (replicated ``DTensor``) by the kv heads ``[k0, k0 + nk)``
    of a replicated ``w`` [d, kvh, hd] (and ``bias`` [kvh, hd]): a plain
    local [b, s, nk, hd].  The cotangents of x, w and the bias are this
    rank's addends, summed over the mesh (``Partial``) where they meet the
    others'."""
    from torch.distributed.tensor import Partial

    xl = x.to_local(grad_placements=[Partial()])
    wl = w.to_local(grad_placements=[Partial()])[:, k0:k0 + nk]
    y = torch.einsum("bsd,dhk->bshk", xl, wl.to(xl.dtype))
    if bias is not None:
        y = y + bias.to_local(grad_placements=[Partial()])[k0:k0 + nk].to(xl.dtype)
    return y


def gqa_forward(cfg: ModelConfig, params, x, positions, *, causal: bool = True,
                use_rope: bool = True, backend: str = "cuda") -> torch.Tensor:
    """Training / prefill attention over a full sequence: x [b, s, d].  On a
    mesh that leaves the kv weights whole, each rank projects the kv heads
    its query heads read (``own_kv``)."""
    q, k, v = _project_qkv(cfg, params, x, own_kv=True)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = shard_batch(q, None, "model", None)
    out = _attend(q, k, v, causal=causal, backend=backend)
    out = shard_batch(out, None, "model", None)
    return tp_contract("bshk,hkd->bsd", out, params["wo"].to(x.dtype))


def gqa_prefill_with_cache(cfg: ModelConfig, params, x, positions, *,
                           use_rope: bool = True, backend: str = "cuda"):
    """Prefill that also returns the prompt's keys and values [b, s, kvh, hd]
    (unpadded: the caller writes them into its cache, whose tail it zeroes).
    On a mesh it projects every kv head, where training projects a rank's
    own: the cache is split over its sequence, so each rank stores every kv
    head at its positions, and projecting them all replaces a gather."""
    q, k, v = _project_qkv(cfg, params, x)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = _attend(q, k, v, causal=True, backend=backend)
    out = shard_batch(out, None, "model", None)
    y = tp_contract("bshk,hkd->bsd", out, params["wo"].to(x.dtype))
    return y, {"k": k, "v": v}


def gqa_decode_step(cfg: ModelConfig, params, x, cache, index: int,
                    use_rope: bool = True):
    """One token: x [b, 1, d]; cache k/v [b, S, kvh, hd], written in place at
    ``index`` (the number of tokens already in the cache)."""
    index = int(index)
    S = cache["k"].shape[1]
    if not 0 <= index < S:
        raise ValueError(f"decode index {index} outside the cache of length {S}")
    q, k_new, v_new = _project_qkv(cfg, params, x)
    if use_rope:
        pos = torch.full((x.shape[0], 1), index, dtype=torch.int32, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k_new = apply_rope(k_new, pos, cfg.rope_theta)
    k, v = cache["k"], cache["v"]
    write_slice(k, 1, index, k_new.to(k.dtype))
    write_slice(v, 1, index, v_new.to(v.dtype))
    k = shard_batch(k, "model", None, None)
    v = shard_batch(v, "model", None, None)
    if is_sharded(k):
        out = _decode_attend_sharded(q, k, v, index, 1.0 / math.sqrt(q.shape[-1]), x.dtype)
        y = tp_contract("bshk,hkd->bsd", out, params["wo"].to(x.dtype))
        return y, {"k": k, "v": v}
    groups = q.shape[2] // k.shape[2]
    kk = _repeat_kv(k, groups)
    vv = _repeat_kv(v, groups)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kk).to(torch.float32) * scale
    valid = torch.arange(S, device=x.device)[None, None, None, :] <= index
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vv)
    y = tp_contract("bshk,hkd->bsd", out, params["wo"].to(x.dtype))
    return y, {"k": k, "v": v}


# ---------------------------------------------------------------------------
# MLA (deepseek-v2): low-rank compressed KV
# ---------------------------------------------------------------------------


def _mla_q(cfg: ModelConfig, params, x, positions):
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(x.dtype))
    q_nope = q[..., :cfg.qk_nope_dim]
    q_rope = apply_rope(q[..., cfg.qk_nope_dim:], positions, cfg.rope_theta)
    return q_nope, q_rope


def _mla_ckv(cfg: ModelConfig, params, x, positions):
    c_kv = torch.einsum("bsd,dl->bsl", x, params["w_dkv"].to(x.dtype))
    # RMSNorm on the compressed kv stream (deepseek-v2)
    c32 = c_kv.to(torch.float32)
    c32 = c32 * torch.rsqrt(torch.mean(torch.square(c32), dim=-1, keepdim=True) + cfg.norm_eps)
    c_kv = (c32 * params["kv_norm"]).to(x.dtype)
    k_rope = torch.einsum("bsd,dk->bsk", x, params["w_kr"].to(x.dtype))
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def mla_scale(cfg: ModelConfig) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)


def mla_prefill_with_cache(cfg: ModelConfig, params, x, positions, *, causal: bool = True):
    """Expanded-form MLA over a full sequence, through the plain attention.
    Returns (y, {"c_kv": [b, s, lora], "k_rope": [b, s, rope]}) (unpadded:
    the caller writes them into its cache)."""
    q_nope, q_rope = _mla_q(cfg, params, x, positions)
    c_kv, k_rope = _mla_ckv(cfg, params, x, positions)
    k_nope = torch.einsum("bsl,lhn->bshn", c_kv, params["w_uk"].to(x.dtype))
    v = torch.einsum("bsl,lhn->bshn", c_kv, params["w_uv"].to(x.dtype))
    h = k_nope.shape[2]
    k_rope_b = k_rope[:, :, None, :].expand(*k_rope.shape[:2], h, k_rope.shape[-1])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_b], dim=-1)
    q = shard_batch(q, None, "model", None)
    k = shard_batch(k, None, "model", None)
    out = _attend(q, k, v, causal=causal, scale=mla_scale(cfg), backend="torch")
    out = shard_batch(out, None, "model", None)
    y = tp_contract("bshk,hkd->bsd", out, params["wo"].to(x.dtype))
    return y, {"c_kv": c_kv, "k_rope": k_rope}


def mla_forward(cfg: ModelConfig, params, x, positions, *, causal: bool = True):
    """Expanded-form MLA for training / prefill: x [b, s, d]."""
    return mla_prefill_with_cache(cfg, params, x, positions, causal=causal)[0]


def mla_decode_step(cfg: ModelConfig, params, x, cache, index: int):
    """Absorbed-matmul MLA decode: attention runs in the compressed space.
    x [b, 1, d]; cache c_kv [b, S, lora] and k_rope [b, S, rope], written in
    place at ``index``."""
    index = int(index)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    S = c_kv.shape[1]
    if not 0 <= index < S:
        raise ValueError(f"decode index {index} outside the cache of length {S}")
    pos = torch.full((x.shape[0], 1), index, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(cfg, params, x, pos)
    c_new, kr_new = _mla_ckv(cfg, params, x, pos)
    write_slice(c_kv, 1, index, c_new.to(c_kv.dtype))
    write_slice(k_rope, 1, index, kr_new.to(k_rope.dtype))
    c_kv = shard_batch(c_kv, "model", None)
    k_rope = shard_batch(k_rope, "model", None)
    # absorb W_uk into the query:  q~ = W_uk^T q_nope   [b, 1, h, lora]
    q_t = torch.einsum("bqhn,lhn->bqhl", q_nope, params["w_uk"].to(x.dtype))
    scores = (torch.einsum("bqhl,bsl->bhqs", q_t, c_kv)
              + torch.einsum("bqhr,bsr->bhqs", q_rope, k_rope)).to(torch.float32) * mla_scale(cfg)
    valid = torch.arange(S, device=x.device)[None, None, None, :] <= index
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhqs,bsl->bqhl", probs, c_kv)  # attend in compressed space
    out = torch.einsum("bqhl,lhn->bqhn", ctx, params["w_uv"].to(x.dtype))
    y = tp_contract("bshk,hkd->bsd", out, params["wo"].to(x.dtype))
    return y, {"c_kv": c_kv, "k_rope": k_rope}


# ---------------------------------------------------------------------------
# Cross-attention (whisper decoder)
# ---------------------------------------------------------------------------


def cross_attention_forward(cfg: ModelConfig, params, x, enc_k, enc_v, *,
                            backend: str = "cuda") -> torch.Tensor:
    """Decoder cross-attention of x [b, s, d] (any s: the prompt at prefill,
    one token at decode) against precomputed encoder keys and values
    [b, enc_seq, kvh, hd]: non-causal, no RoPE."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
    out = _attend(q, enc_k, enc_v, causal=False, backend=backend)
    return tp_contract("bshk,hkd->bsd", out, params["wo"].to(x.dtype))


def encoder_kv(cfg: ModelConfig, params, enc_out):
    """The cross-attention's keys and values [b, enc_seq, kvh, hd] of the
    encoder's output [b, enc_seq, d]."""
    k = torch.einsum("bsd,dhk->bshk", enc_out, params["wk"].to(enc_out.dtype))
    v = torch.einsum("bsd,dhk->bshk", enc_out, params["wv"].to(enc_out.dtype))
    if cfg.qkv_bias:
        k = k + params["bk"].to(enc_out.dtype)
        v = v + params["bv"].to(enc_out.dtype)
    return k, v
