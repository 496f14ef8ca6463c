"""Mamba2 (SSD, state-space duality) sequence mixing, from
``repro.models.ssm``.

The chunked SSD algorithm (Dao & Gu 2024): the sequence is split into
chunks of length L; within a chunk the recurrence is a masked,
decay-weighted attention-like quadratic form; chunk-final states are
carried by a sequential loop (the reference's ``lax.scan``) and injected
into the next chunk.  Decode keeps the recurrent state ``[b, h, p, n]``
(float32) and the causal conv's tails (``ssm_conv - 1`` tokens, in the model
dtype): O(1) per token.

The math follows the reference op for op: the depthwise conv adds its taps
one at a time from 0 (the reference's Python ``sum``, each add rounded in
the activation dtype), SiLU in float32, the SSD in float32, and the
softplus of the step size as ``logaddexp(x, 0)`` (``jax.nn.softplus``;
``torch.nn.functional.softplus`` returns ``x`` above its threshold).  The
reference runs all of this as plain XLA ops, outside any Pallas kernel; so
does the port, as plain torch ops.  The port has no mesh, so the
reference's sharding constraints are gone.

Training differentiates :func:`mamba_forward` with autograd.  Each ``exp``
there has a non-positive exponent (the intra-chunk decay's is masked before
the exp: :func:`_ssd_chunked`, the one departure from the reference), the
softplus is ``logaddexp``, the gated RMSNorm's ``rsqrt`` has ``norm_eps``
under it, and the conv is products and a SiLU, so the backward is finite at
the published chunk of 128.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamDecl

N_GROUPS = 1


def ssm_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    heads = d_inner // cfg.ssm_head_dim
    return d_inner, heads, cfg.ssm_state


def mamba_decls(cfg: ModelConfig) -> dict[str, ParamDecl]:
    d = cfg.d_model
    d_inner, h, n = ssm_dims(cfg)
    gn = N_GROUPS * n
    conv = cfg.ssm_conv
    return {
        "wz": ParamDecl((d, d_inner), ("embed", "d_inner"), init="scaled"),
        "wx": ParamDecl((d, d_inner), ("embed", "d_inner"), init="scaled"),
        "wB": ParamDecl((d, gn), ("embed", "state"), init="scaled"),
        "wC": ParamDecl((d, gn), ("embed", "state"), init="scaled"),
        "w_dt": ParamDecl((d, h), ("embed", "ssm_heads"), init="scaled"),
        "dt_bias": ParamDecl((h,), ("ssm_heads",), init="zeros", dtype="float32"),
        "A_log": ParamDecl((h,), ("ssm_heads",), init="zeros", dtype="float32"),
        "D": ParamDecl((h,), ("ssm_heads",), init="ones", dtype="float32"),
        "conv_x": ParamDecl((conv, d_inner), ("conv", "d_inner"), init="scaled"),
        "conv_B": ParamDecl((conv, gn), ("conv", "state"), init="scaled"),
        "conv_C": ParamDecl((conv, gn), ("conv", "state"), init="scaled"),
        "norm": ParamDecl((d_inner,), ("d_inner",), init="ones", dtype="float32"),
        "out_proj": ParamDecl((d_inner, d), ("d_inner", "embed"), init="scaled"),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` at every x."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x, w, tail=None):
    """Depthwise causal conv over [b, s, ch] with kernel [k, ch].
    ``tail`` [b, k-1, ch] prepends state from previous tokens (decode)."""
    k = w.shape[0]
    if tail is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([tail.to(x.dtype), x], dim=1)
    s = x.shape[1]
    out = sum(xp[:, i:i + s, :] * w[i][None, None, :] for i in range(k))
    return F.silu(out.to(torch.float32)).to(x.dtype)


def _ssd_chunked(x, dt, A, B, C, chunk: int):
    """SSD over a full sequence.

    x: [b, s, h, p]; dt: [b, s, h] (post-softplus); A: [h] (negative);
    B, C: [b, s, n] (single group).  Returns (y [b,s,h,p], state [b,h,p,n]).

    The one place where the port departs from the reference's arithmetic:
    the reference takes ``exp(dAcs_i - dAcs_j)`` for every (i, j) of a chunk
    and then zeroes j > i with ``where``.  There the exponent is the decay
    summed over i+1..j, positive, and past float32's 88.7 (a 128-token chunk
    at the init's A = -1 and dt ~ 0.8) the exp is ``inf``: the forward is
    still right, but the backward multiplies the ``where``'s zero cotangent
    by ``inf`` and the gradients of dt and A are NaN.  Here the exponent is
    masked to ``-inf`` before the exp: the forward is bit for bit the
    reference's (exp(-inf) is exactly 0), the gradient finite, and equal to
    the reference's wherever that one is finite."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    L = min(chunk, s)
    if s % L:
        pad = L - s % L
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    sp = x.shape[1]
    c = sp // L
    f32 = torch.float32
    xc = x.reshape(b, c, L, h, p).to(f32)
    dtc = dt.reshape(b, c, L, h).to(f32)
    Bc = B.reshape(b, c, L, n).to(f32)
    Cc = C.reshape(b, c, L, n).to(f32)

    dA = dtc * A  # [b,c,L,h], negative
    dA_cs = torch.cumsum(dA, dim=2)  # inclusive cumsum within chunk
    seg_sum = dA_cs[:, :, -1:, :]  # [b,c,1,h]

    # intra-chunk: y[i] += sum_{j<=i} C_i.B_j exp(dAcs_i - dAcs_j) dt_j x_j; the
    # exponent is masked before the exp (j > i: -inf, exp exactly 0)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    decay = torch.exp(torch.where(mask[None, None, :, :, None],
                                  dA_cs[:, :, :, None, :] - dA_cs[:, :, None, :, :],
                                  -torch.inf))  # [b,c,i,j,h]
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    attn = cb[..., None] * decay  # [b,c,i,j,h]
    dtx = dtc[..., None] * xc  # [b,c,L,h,p]
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", attn, dtx)

    # chunk-final states: S_c = sum_j B_j exp(seg - dAcs_j) dt_j x_j
    state_decay = torch.exp(seg_sum - dA_cs)  # [b,c,L,h]
    states = torch.einsum("bcln,bclh,bclhp->bchpn", Bc, state_decay * dtc, xc)

    # inter-chunk recurrence h_c = exp(seg_c) h_{c-1} + S_c; each chunk reads
    # the state *entering* it
    seg = torch.exp(seg_sum[:, :, 0, :])  # [b,c,h]
    carry = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    prev = []
    for ci in range(c):
        prev.append(carry)
        carry = carry * seg[:, ci, :, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)  # [b,c,h,p,n]

    # inter-chunk contribution: y[i] += C_i exp(dAcs_i) h_prev
    y_off = torch.einsum("bcln,bchpn,bclh->bclhp", Cc, prev_states, torch.exp(dA_cs))
    y = (y_diag + y_off).reshape(b, sp, h, p)[:, :s]
    return y, carry


def _gated_out(cfg: ModelConfig, params, y, z, dtype):
    """Gated RMSNorm of the SSD output (float32), then ``out_proj``."""
    g = y * F.silu(z.to(torch.float32))
    g = g * torch.rsqrt(torch.mean(torch.square(g), dim=-1, keepdim=True) + cfg.norm_eps)
    g = (g * params["norm"]).to(dtype)
    return torch.einsum("bse,ed->bsd", g, params["out_proj"].to(dtype))


def _project(params, x):
    """The five input projections: dt_raw, z, x, B, C (in the model dtype)."""
    return tuple(torch.einsum("bsd,de->bse", x, params[n].to(x.dtype))
                 for n in ("w_dt", "wz", "wx", "wB", "wC"))


def mamba_forward(cfg: ModelConfig, params, x, *, return_state: bool = False):
    """Full-sequence Mamba2 block (train / prefill).  x: [b, s, d].

    With ``return_state`` also the decode cache: the SSD's final state
    (float32) and the conv tails, the last ``ssm_conv - 1`` pre-conv inputs."""
    dt_raw, z, xin, Braw, Craw = _project(params, x)
    xc = _causal_conv(xin, params["conv_x"].to(x.dtype))
    Bc = _causal_conv(Braw, params["conv_B"].to(x.dtype))
    Cc = _causal_conv(Craw, params["conv_C"].to(x.dtype))

    d_inner, h, n = ssm_dims(cfg)
    p = cfg.ssm_head_dim
    xh = xc.reshape(*xc.shape[:2], h, p)
    dt = softplus(dt_raw.to(torch.float32) + params["dt_bias"])
    A = -torch.exp(params["A_log"])  # [h]

    y, state = _ssd_chunked(xh, dt, A, Bc, Cc, cfg.ssm_chunk)
    y = y + params["D"][None, None, :, None] * xh.to(torch.float32)
    y = y.reshape(*y.shape[:2], d_inner)
    out = _gated_out(cfg, params, y, z, x.dtype)
    if return_state:
        c = cfg.ssm_conv - 1
        conv_tail = {"x": xin[:, -c:, :], "B": Braw[:, -c:, :], "C": Craw[:, -c:, :]}
        return out, {"state": state, "conv": conv_tail}
    return out


def mamba_decode_step(cfg: ModelConfig, params, x, cache):
    """Single-token recurrent step.  x: [b, 1, d]; cache from prefill (not
    modified: the new state and tails are returned)."""
    d_inner, h, n = ssm_dims(cfg)
    p = cfg.ssm_head_dim
    dt_raw, z, xin, Braw, Craw = _project(params, x)

    conv = cache["conv"]
    xc = _causal_conv(xin, params["conv_x"].to(x.dtype), tail=conv["x"])
    Bc = _causal_conv(Braw, params["conv_B"].to(x.dtype), tail=conv["B"])
    Cc = _causal_conv(Craw, params["conv_C"].to(x.dtype), tail=conv["C"])
    new_conv = {name: torch.cat([conv[name].to(x.dtype), new], dim=1)[:, 1:]
                for name, new in (("x", xin), ("B", Braw), ("C", Craw))}

    f32 = torch.float32
    dt = softplus(dt_raw[:, 0].to(f32) + params["dt_bias"])  # [b,h]
    A = -torch.exp(params["A_log"])
    g_decay = torch.exp(dt * A)  # [b,h]
    xh = xc[:, 0].reshape(-1, h, p).to(f32)  # [b,h,p]
    Bv = Bc[:, 0].to(f32)  # [b,n]
    Cv = Cc[:, 0].to(f32)
    state = cache["state"] * g_decay[..., None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt, xh, Bv)
    y = torch.einsum("bhpn,bn->bhp", state, Cv) + params["D"][None, :, None] * xh
    y = y.reshape(-1, 1, d_inner)
    out = _gated_out(cfg, params, y, z, x.dtype)
    return out, {"state": state, "conv": new_conv}


def mamba_reference_recurrent(cfg: ModelConfig, params, x):
    """Token-by-token recurrence oracle (tests): must match mamba_forward."""
    b, s, d = x.shape
    d_inner, h, n = ssm_dims(cfg)
    p = cfg.ssm_head_dim
    c = cfg.ssm_conv - 1
    cache = {
        "state": torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device),
        "conv": {
            "x": torch.zeros((b, c, d_inner), dtype=x.dtype, device=x.device),
            "B": torch.zeros((b, c, N_GROUPS * n), dtype=x.dtype, device=x.device),
            "C": torch.zeros((b, c, N_GROUPS * n), dtype=x.dtype, device=x.device),
        },
    }
    outs = []
    for i in range(s):
        y, cache = mamba_decode_step(cfg, params, x[:, i:i + 1], cache)
        outs.append(y)
    return torch.cat(outs, dim=1), cache
