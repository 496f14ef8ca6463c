"""Plain float32 reference of the Mamba2 (``ssm``) and Zamba2 (``hybrid``)
language models that the benchmark trains.

Written from the published equations, in float32 with TF32 off, with no
kernel, cache or batching of the program under test; it imports nothing of
it.  Layer equations:

* Mamba2 block (arXiv:2405.21060, §7 and Listing 1): pre-norm RMSNorm; the
  input projections z, x, B, C and dt; a depthwise causal conv (width
  ``ssm_conv``) and SiLU over x, B and C; ``dt = softplus(dt_raw +
  dt_bias)``, ``A = -exp(A_log)``; the SSD over chunks of ``ssm_chunk``,
  computed as the paper's minimal listing (``segsum``, the intra-chunk
  quadratic form, chunk states, the inter-chunk decay matrix); ``y + D x``;
  the gated RMSNorm ``rmsnorm(y * silu(z)) * norm``; ``out_proj``; the
  residual add.
* Zamba2's shared block (arXiv:2411.15242): after every ``attn_every``
  Mamba2 layers, one attention + SwiGLU block whose weights are shared by
  all its applications: causal softmax attention with rotary positions
  (rotate-half pairs), then the gated MLP, each pre-norm with a residual.
* The loss: final RMSNorm, logits over the vocabulary, the mean next-token
  cross-entropy over every position but the last.

Departures from the published models, each following the model the program
defines (the configuration as it is run):

* B and C have one group (``ngroups = 1``); the three convs have no bias,
  and the input projections none.
* The vocabulary is padded to a multiple of :data:`VOCAB_PAD`, and the pad
  rows, drawn like the others, take part in the softmax.
* The query heads are padded to a multiple of ``head_pad_to`` and the kv
  heads to one of ``kv_pad_to`` (zamba2-2.7b's 32 need none).
* Zamba2's shared block takes the residual stream alone: no concatenation
  with the embeddings, no per-application LoRA adapters, and one block
  where the published model alternates two; its heads are ``head_dim``
  wide as published (``d_model / num_heads`` where the file gives none).
* mamba2 ties the unembedding to the embedding; zamba2 has its own.

Parameters are a flat dict ``{"a/b/c": tensor}`` of the same leaves,
shapes and layer stacking as the program's, so that the two can be
compared leaf by leaf; :func:`leaf_specs` lists them from the configuration
alone.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

#: the vocabulary is padded to a multiple of this many rows
VOCAB_PAD = 256


def round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def ssm_dims(cfg: dict) -> tuple[int, int, int, int]:
    """``(d_inner, heads, head_dim, state)`` of the Mamba2 blocks."""
    d_inner = cfg["ssm_expand"] * cfg["d_model"]
    return d_inner, d_inner // cfg["ssm_head_dim"], cfg["ssm_head_dim"], cfg["ssm_state"]


def attn_dims(cfg: dict) -> tuple[int, int, int]:
    """``(query heads, kv heads, head size)`` of the shared block."""
    hd = cfg.get("head_dim") or cfg["d_model"] // cfg["num_heads"]
    return (round_up(cfg["num_heads"], max(cfg.get("head_pad_to", 1), 1)),
            round_up(cfg["num_kv_heads"], max(cfg.get("kv_pad_to", 1), 1)), hd)


def leaf_specs(cfg: dict) -> list[tuple[str, tuple[int, ...], str, tuple]]:
    """``(path, shape, dtype, init)`` of every parameter, sorted by path.

    ``init`` is ``("normal", std)``, ``("ones",)``, ``("a_log",)`` (A drawn
    uniformly from [1, 16]) or ``("dt_bias",)`` (dt drawn log-uniformly
    from [1e-3, 1e-1], stored as its softplus inverse): the published
    Mamba2 initialisation, with each projection's std 1/sqrt(fan-in)."""
    if cfg["family"] not in ("ssm", "hybrid"):
        raise ValueError(f"the reference models the ssm and hybrid families, not "
                         f"{cfg['family']!r}")
    d, L, k = cfg["d_model"], cfg["num_layers"], cfg["ssm_conv"]
    di, h, _, n = ssm_dims(cfg)
    dt = cfg["dtype"]
    vp = round_up(cfg["vocab_size"], VOCAB_PAD)

    def normal(fan_in):
        return ("normal", 1.0 / math.sqrt(fan_in))

    out = [
        ("blocks/ln/scale", (L, d), "float32", ("ones",)),
        ("blocks/mamba/A_log", (L, h), "float32", ("a_log",)),
        ("blocks/mamba/D", (L, h), "float32", ("ones",)),
        ("blocks/mamba/conv_B", (L, k, n), dt, normal(k)),
        ("blocks/mamba/conv_C", (L, k, n), dt, normal(k)),
        ("blocks/mamba/conv_x", (L, k, di), dt, normal(k)),
        ("blocks/mamba/dt_bias", (L, h), "float32", ("dt_bias",)),
        ("blocks/mamba/norm", (L, di), "float32", ("ones",)),
        ("blocks/mamba/out_proj", (L, di, d), dt, normal(di)),
        ("blocks/mamba/wB", (L, d, n), dt, normal(d)),
        ("blocks/mamba/wC", (L, d, n), dt, normal(d)),
        ("blocks/mamba/w_dt", (L, d, h), dt, normal(d)),
        ("blocks/mamba/wx", (L, d, di), dt, normal(d)),
        ("blocks/mamba/wz", (L, d, di), dt, normal(d)),
        ("embed/tok", (vp, d), dt, ("normal", 0.02)),
        ("ln_f/scale", (d,), "float32", ("ones",)),
    ]
    if not cfg.get("tie_embeddings", False):
        out.append(("embed/unembed", (d, vp), dt, normal(d)))
    if cfg["family"] == "hybrid":
        if L % cfg["attn_every"]:
            raise ValueError(f"{L} layers are no whole number of groups of {cfg['attn_every']}")
        hq, hkv, hd = attn_dims(cfg)
        f = cfg["d_ff"]
        out += [
            ("shared_attn/attn/wk", (d, hkv, hd), dt, normal(d)),
            ("shared_attn/attn/wo", (hq, hd, d), dt, normal(hq * hd)),
            ("shared_attn/attn/wq", (d, hq, hd), dt, normal(d)),
            ("shared_attn/attn/wv", (d, hkv, hd), dt, normal(d)),
            ("shared_attn/ln1/scale", (d,), "float32", ("ones",)),
            ("shared_attn/ln2/scale", (d,), "float32", ("ones",)),
            ("shared_attn/mlp/w_down", (f, d), dt, normal(f)),
            ("shared_attn/mlp/w_gate", (d, f), dt, normal(d)),
            ("shared_attn/mlp/w_up", (d, f), dt, normal(d)),
        ]
    return sorted(out)


def num_params(cfg: dict) -> int:
    return sum(math.prod(shape) for _, shape, _, _ in leaf_specs(cfg))


def init_params(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every parameter drawn from ``seed`` on ``device``, each in its own
    dtype: one normal draw for all the random leaves, scaled leaf by leaf in
    place, and one uniform draw for A and dt."""
    specs = leaf_specs(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    normals = [s for s in specs if s[3][0] == "normal"]
    uniforms = [s for s in specs if s[3][0] in ("a_log", "dt_bias")]
    draw = torch.randn(sum(math.prod(s[1]) for s in normals), generator=gen,
                       dtype=torch.float32, device=device)
    unif = torch.rand(sum(math.prod(s[1]) for s in uniforms), generator=gen,
                      dtype=torch.float32, device=device)
    out: dict[str, torch.Tensor] = {}
    for group, flat in ((normals, draw), (uniforms, unif)):
        start = 0
        for path, shape, dtype, init in group:
            size = math.prod(shape)
            t = flat[start:start + size].view(shape)
            start += size
            if init[0] == "normal":
                t.mul_(init[1])
            elif init[0] == "a_log":
                t.mul_(15.0).add_(1.0).log_()
            else:
                lo, hi = math.log(1e-3), math.log(1e-1)
                t.mul_(hi - lo).add_(lo).exp_().clamp_(min=1e-4)
                t.copy_(t + torch.log(-torch.expm1(-t)))  # softplus^-1
            out[path] = t.to(getattr(torch, dtype))
        del flat
    for path, shape, dtype, init in specs:
        if init[0] == "ones":
            out[path] = torch.ones(shape, dtype=getattr(torch, dtype), device=device)
    return {path: out[path] for path, _, _, _ in specs}


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def causal_conv_silu(u, w):
    """Depthwise causal conv of ``u`` [b, s, ch] by ``w`` [k, ch], then SiLU."""
    k, ch = w.shape
    y = F.conv1d(F.pad(u.transpose(1, 2), (k - 1, 0)), w.t().unsqueeze(1), groups=ch)
    return F.silu(y.transpose(1, 2))


def segsum(a):
    """``out[..., i, j] = a[..., j+1] + ... + a[..., i]`` for i >= j, -inf above
    the diagonal (the paper's stable segment sum)."""
    t = a.shape[-1]
    x = a[..., None].expand(*a.shape, t)
    x = x.masked_fill(~torch.tril(torch.ones(t, t, dtype=torch.bool, device=a.device), -1), 0)
    x = torch.cumsum(x, dim=-2)
    return x.masked_fill(~torch.tril(torch.ones(t, t, dtype=torch.bool, device=a.device)),
                         -torch.inf)


def ssd(x, dt, A, B, C, chunk: int):
    """The SSD (Listing 1 of arXiv:2405.21060) from a zero state.

    x [b, s, h, p], dt [b, s, h], A [h], B and C [b, s, n] (one group);
    returns y [b, s, h, p]."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    pad = (-s) % chunk
    if pad:  # trailing zeros: dt = 0 there, so they touch nothing before them
        x, dt, B, C = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, dt, B, C))
    c = x.shape[1] // chunk
    X = (x * dt[..., None]).reshape(b, c, chunk, h, p)
    a = (dt * A).reshape(b, c, chunk, h).permute(0, 3, 1, 2)  # [b, h, c, l]
    Bc, Cc = B.reshape(b, c, chunk, n), C.reshape(b, c, chunk, n)
    a_cs = torch.cumsum(a, dim=-1)
    # diagonal blocks: y_l = sum_{s <= l} C_l.B_s exp(a_s+1 + ... + a_l) X_s
    W = torch.einsum("bcln,bcsn->bcls", Cc, Bc)[:, None] * torch.exp(segsum(a))
    y_diag = torch.einsum("bhcls,bcshp->bclhp", W, X)
    # each chunk's final state, then the states entering each chunk
    decay = torch.exp(a_cs[..., -1:] - a_cs)  # [b, h, c, l]
    states = torch.einsum("bcln,bclhp->bchpn", Bc, X * decay.permute(0, 2, 3, 1)[..., None])
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(segsum(F.pad(a_cs[..., -1], (1, 0))))  # [b, h, c+1, c+1]
    entering = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states)[:, :-1]
    y_off = torch.einsum("bcln,bchpn->bclhp", Cc, entering) * torch.exp(a_cs).permute(
        0, 2, 3, 1)[..., None]
    return (y_diag + y_off).reshape(b, c * chunk, h, p)[:, :s]


def mamba_block(cfg, p, x):
    """One residual Mamba2 block; ``p`` holds the layer's leaves."""
    di, h, hp, _ = ssm_dims(cfg)
    u = rmsnorm(x, p["ln"], cfg["norm_eps"])
    z = u @ p["wz"]
    xs = causal_conv_silu(u @ p["wx"], p["conv_x"])
    Bs = causal_conv_silu(u @ p["wB"], p["conv_B"])
    Cs = causal_conv_silu(u @ p["wC"], p["conv_C"])
    dt_raw = u @ p["w_dt"] + p["dt_bias"]
    dt = torch.logaddexp(dt_raw, torch.zeros_like(dt_raw))  # softplus at every x
    xh = xs.reshape(*xs.shape[:2], h, hp)
    y = ssd(xh, dt, -torch.exp(p["A_log"]), Bs, Cs, cfg["ssm_chunk"])
    y = (y + p["D"][:, None] * xh).reshape(*xs.shape[:2], di)
    g = rmsnorm(y * F.silu(z), p["norm"], cfg["norm_eps"])
    return x + g @ p["out_proj"]


def rope(x, theta: float):
    """Rotary positions on x [b, s, h, d]: the pair (x_i, x_{i+d/2}) turned by
    ``pos / theta^(2i/d)``, as one complex product."""
    s, d = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    rot = torch.polar(torch.ones_like(ang), ang).to(torch.complex64)[None, :, None, :]
    z = torch.complex(x[..., :d // 2], x[..., d // 2:]) * rot
    return torch.cat([z.real, z.imag], dim=-1)


def shared_block(cfg, p, x):
    """Zamba2's shared attention + SwiGLU block."""
    hq, hkv, hd = attn_dims(cfg)
    u = rmsnorm(x, p["ln1"], cfg["norm_eps"])
    q = rope(torch.einsum("bsd,dhk->bshk", u, p["wq"]), cfg["rope_theta"])
    k = rope(torch.einsum("bsd,dhk->bshk", u, p["wk"]), cfg["rope_theta"])
    v = torch.einsum("bsd,dhk->bshk", u, p["wv"])
    if hq != hkv:
        k, v = (t.repeat_interleave(hq // hkv, dim=2) for t in (k, v))
    s = x.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, -torch.inf), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    x = x + torch.einsum("bshk,hkd->bsd", out, p["wo"])
    u = rmsnorm(x, p["ln2"], cfg["norm_eps"])
    return x + (F.silu(u @ p["w_gate"]) * (u @ p["w_up"])) @ p["w_down"]


def _layer(params, i):
    return {"ln": params["blocks/ln/scale"][i],
            **{name.rsplit("/", 1)[1]: t[i] for name, t in params.items()
               if name.startswith("blocks/mamba/")}}


def _shared(params):
    return {"ln1": params["shared_attn/ln1/scale"], "ln2": params["shared_attn/ln2/scale"],
            **{name.rsplit("/", 1)[1]: t for name, t in params.items()
               if name.startswith(("shared_attn/attn/", "shared_attn/mlp/"))}}


def loss(cfg: dict, params: dict[str, torch.Tensor], tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy of ``tokens`` [b, s] (float32 params),
    each layer under checkpointing so that a long sequence fits."""
    x = params["embed/tok"][tokens.long()]
    every = cfg.get("attn_every") or 0
    for i in range(cfg["num_layers"]):
        x = checkpoint(lambda xx, p=_layer(params, i): mamba_block(cfg, p, xx), x,
                       use_reentrant=False)
        if cfg["family"] == "hybrid" and (i + 1) % every == 0:
            x = checkpoint(lambda xx, p=_shared(params): shared_block(cfg, p, xx), x,
                           use_reentrant=False)
    x = rmsnorm(x, params["ln_f/scale"], cfg["norm_eps"])
    w = params["embed/tok"].t() if cfg.get("tie_embeddings") else params["embed/unembed"]
    logits = x[:, :-1] @ w
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1).long())
