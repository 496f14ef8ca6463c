"""Common layers and the parameter-declaration system, from
``repro.models.layers``.

Every parameter is declared once (shape, per-dim logical axes, init) and
:func:`init_from_decls` materializes the declarations as a nested dict of
tensors drawn from an explicit ``torch.Generator``.  The logical axes map
to mesh axes through the reference's rules (:func:`make_rules`: TP over
``model``, FSDP over ``data``), and :func:`specs_from_decls` gives each
leaf its :class:`~repro_torch.models.sharding.PartitionSpec`; on a mesh the
parameters are DTensors laid out by those specs, and each rank's flat
layout (:meth:`FlatLayout.local`) is built from its own shards.  Dtype
handling follows the
reference op for op (f32 inside the norms, the rotary angles, the SiLU and
the GELU, cast back to the activation dtype), so a float32 model equals the
reference's within float32 rounding.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.models.sharding import P, local_shape, local_shard, placements, shard_batch


def torch_dtype(name) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` (or a torch dtype) as a torch dtype."""
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


# ---------------------------------------------------------------------------
# TP-reduction dtype: projections that contract a 'model'-sharded dim emit
# partial sums that are all-reduced in the product's dtype.  bf16 halves
# that wire volume.
# ---------------------------------------------------------------------------

_TP_REDUCE_DTYPE = None  # None -> the product's own dtype


def set_tp_reduce_dtype(dtype) -> None:
    global _TP_REDUCE_DTYPE
    _TP_REDUCE_DTYPE = None if dtype is None else torch_dtype(dtype)


class _SumOverRanks(torch.autograd.Function):
    """The partial sums of a TP contraction all-reduced over ``group``; the
    backward is the identity (each rank's addend takes the whole sum's
    cotangent, which is replicated)."""

    @staticmethod
    def forward(ctx, t, group):
        ops = torch.ops._c10d_functional
        return ops.wait_tensor(ops.all_reduce(t.contiguous(), "sum", group.group_name))

    @staticmethod
    def backward(ctx, g):
        return g, None


def _dim_letter(term: str, ndim: int, dim: int) -> str | None:
    """The letter of einsum ``term`` (one operand's subscript, maybe with
    ``...``) that names dim ``dim`` of an ``ndim``-dim operand, or None for
    a dim under the ellipsis."""
    pre, _, post = term.partition("...")
    if dim < len(pre):
        return pre[dim]
    tail = dim - (ndim - len(post))
    return post[tail] if tail >= 0 else None


def _split_contraction(subscript: str, x, w) -> bool:
    """Whether ``x`` and ``w`` are DTensors on one 1-D mesh, each split
    there on the dim that ``subscript`` contracts (as at every psum site).
    Split on any other dim (a kept batch, sequence or expert dim) they
    raise: each rank's local product would hold other rows, and their sum
    over ranks would add them."""
    if not (isinstance(x, DTensor) and isinstance(w, DTensor) and x.device_mesh.ndim == 1
            and w.device_mesh == x.device_mesh and isinstance(x.placements[0], Shard)
            and isinstance(w.placements[0], Shard)):
        return False
    ins, out = subscript.replace(" ", "").split("->")
    tx, tw = ins.split(",")
    lx = _dim_letter(tx, x.ndim, x.placements[0].dim)
    lw = _dim_letter(tw, w.ndim, w.placements[0].dim)
    if lx is None or lx != lw or lx in out:
        raise ValueError(f"tp_contract({subscript!r}) takes x and w split on the contracted "
                         f"dim; x is split on {x.placements[0]}, w on {w.placements[0]}")
    return True


def tp_contract(subscript: str, x, w):
    """einsum whose contraction dim is TP-sharded (the psum site): with a
    reduce dtype set, its partial sums are cast to it before the reduction
    (the reference's ``preferred_element_type``).  On a mesh each rank
    contracts its own shards and the partial sums are all-reduced here, as
    the reference's psum, into a replicated result: DTensor left to itself
    keeps a ``Partial`` residual stream (whose next layer then gathers its
    weights whole) and computes these weights' gradients unsharded."""
    if _split_contraction(subscript, x, w):
        mesh = x.device_mesh
        out = torch.einsum(subscript, x.to_local(), w.to_local())
        if _TP_REDUCE_DTYPE is not None:
            out = out.to(_TP_REDUCE_DTYPE)
        out = _SumOverRanks.apply(out, mesh.get_group(0))
        return DTensor.from_local(out, mesh, [Replicate()], run_check=False)
    out = torch.einsum(subscript, x, w)
    if _TP_REDUCE_DTYPE is not None:
        out = out.to(_TP_REDUCE_DTYPE)
    if isinstance(out, DTensor) and any(isinstance(p, Partial) for p in out.placements):
        # a replicated x by sharded w (a decode step's attention output)
        out = out.redistribute(out.device_mesh, [Replicate() if isinstance(p, Partial) else p
                                                 for p in out.placements])
    return out


# ---------------------------------------------------------------------------
# Parameter declarations
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    shape: tuple[int, ...]
    logical: tuple[str, ...]  # one logical axis name per dim
    init: str = "normal"  # normal | zeros | ones | scaled (1/sqrt(fan_in))
    dtype: str | None = None  # override model dtype (e.g. fp32 for norms)

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes {self.logical} differ in rank")


def _init_leaf(decl: ParamDecl, gen: torch.Generator, dtype, part=None) -> torch.Tensor:
    """One leaf's draw; with ``part``, ``part`` of the float32 draw, cast (a
    rank's shard: the whole leaf's cast never held)."""
    dt = torch_dtype(decl.dtype or dtype)
    dev = gen.device
    if decl.init == "zeros":
        out = torch.zeros(decl.shape, dtype=dt, device=dev)
        return out if part is None else part(out)
    if decl.init == "ones":
        out = torch.ones(decl.shape, dtype=dt, device=dev)
        return out if part is None else part(out)
    if decl.init == "scaled":
        # the reference's rule as it is: for a stacked [L, ...] leaf the fan-in
        # is the layer count
        fan_in = decl.shape[0]
        std = 1.0 / math.sqrt(max(fan_in, 1))
    elif decl.init == "normal":
        std = 0.02
    else:
        raise ValueError(decl.init)
    draw = torch.randn(decl.shape, generator=gen, dtype=torch.float32, device=dev)
    # scaled in place: a full-width MoE leaf's float32 draw is tens of GB
    draw.mul_(std)
    return (draw if part is None else part(draw)).to(dt)


def is_decl(x) -> bool:
    return isinstance(x, ParamDecl)


def _leaves(tree, prefix=()):
    """(path, leaf) pairs in the order ``jax.tree.flatten`` walks a dict."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], prefix + (key,))
    else:
        yield prefix, tree


def tree_map(fn, tree):
    """``fn`` applied to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_from_decls(decls, gen: torch.Generator, dtype, specs=None, mesh=None) -> Any:
    """Materialize ``decls`` on ``gen``'s device, drawing in leaf order.  With
    ``specs`` and ``mesh``, each leaf is drawn whole and only this rank's
    shard of it kept (a copy; the whole leaf freed before the next draw), so
    the values are the unsharded draw's and a rank never holds more than its
    shards and one whole leaf."""
    out: dict = {}
    for path, decl in _leaves(decls):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        part = None if mesh is None else (
            lambda t, spec=get_path(specs, path): local_shard(t, spec, mesh).clone())
        node[path[-1]] = _init_leaf(decl, gen, dtype, part)
    return out


def make_rules(cfg: ModelConfig, fsdp: bool) -> dict[str, str | None]:
    """Logical-axis -> mesh-axis mapping.  TP over 'model'; FSDP adds 'data'
    on the embed axis.  MoE: shard the expert dim when it divides the TP
    degree (deepseek 160/16), else shard each expert's ffn dim (grok 8e)."""
    rules: dict[str, str | None] = {
        "vocab": "model",
        "heads": "model",
        # kv weights replicated unless the (padded) kv head count is TP-
        # divisible (MHA models like qwen1.5-32b shard kv over 'model')
        "kv_heads": "model"
        if (cfg.num_kv_heads + cfg.kv_pad_to - 1) // cfg.kv_pad_to * cfg.kv_pad_to % 16 == 0
        else None,
        "head": None,
        "mlp": "model",
        "lora": None,
        "d_inner": "model",
        "ssm_heads": "model",
        "state": None,
        "groups": None,
        "conv": None,
        "layers": None,
        "pos": None,
        "none": None,
        "embed": "data" if fsdp else None,
        "embed2": "data" if fsdp else None,
        "expert": "model",
        "expert_mlp": None,
    }
    if cfg.num_experts and cfg.num_experts % 16 != 0:
        rules["expert"] = None
        rules["expert_mlp"] = "model"
    return rules


def to_spec(d: ParamDecl, rules: dict[str, str | None]) -> P:
    return P(*[rules.get(ax) for ax in d.logical])


def specs_from_decls(decls, rules: dict[str, str | None]) -> Any:
    return tree_map(lambda d: to_spec(d, rules), decls)


def num_elements(decls) -> int:
    return sum(math.prod(d.shape) for _, d in _leaves(decls))


def get_path(tree, path: tuple[str, ...]):
    for key in path:
        tree = tree[key]
    return tree


def set_path(tree: dict, path: tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


# ---------------------------------------------------------------------------
# Flat parameter layout
# ---------------------------------------------------------------------------

#: a flat layout starts every leaf at a multiple of this many elements
FLAT_ALIGN = 64


@dataclasses.dataclass(frozen=True)
class FlatLeaf:
    path: tuple[str, ...]
    shape: tuple[int, ...]
    dtype: torch.dtype  # the leaf's own dtype (the flat tensor is float32)
    offset: int

    @property
    def size(self) -> int:
        return math.prod(self.shape)


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Every leaf of a parameter tree at its own offset of one flat tensor.

    The Tier-1 step holds a model's parameters, gradients, optimizer moments
    and DSAG slots as ``[..., numel]`` tensors: one ``[n]`` row per group is
    what K4 updates in one launch, and what sgd, adamw, clipping and
    ``apply_updates`` take elementwise.  The parameters are float32 holding
    each leaf's values in its own dtype (bfloat16 weights, float32 norm
    scales), so ``p.float() + u`` rounded back to each leaf's dtype is the
    reference's ``apply_updates``.  Leaves sit in the reference's flatten
    order (dict keys sorted), each at a multiple of :data:`FLAT_ALIGN`; the
    gaps between them (and up to ``numel``) are zero and nothing reads them.
    """

    leaves: tuple[FlatLeaf, ...]
    numel: int

    @classmethod
    def from_decls(cls, decls, dtype) -> "FlatLayout":
        return cls.from_shapes([(path, tuple(d.shape), torch_dtype(d.dtype or dtype))
                                for path, d in _leaves(decls)])

    @classmethod
    def from_shapes(cls, leaves) -> "FlatLayout":
        """The layout of ``(path, shape, dtype)`` leaves, in that order."""
        out, off = [], 0
        for path, shape, dtype in leaves:
            out.append(FlatLeaf(path, tuple(shape), dtype, off))
            off = round_up(off + math.prod(shape), FLAT_ALIGN)
        return cls(tuple(out), off)

    def local(self, specs, mesh) -> "FlatLayout":
        """This rank's layout on ``mesh``: each leaf at the shape of its own
        shard under ``specs`` (every split dim dividing evenly).  K4, sgd,
        adamw and ``apply_updates`` stay elementwise on it."""
        return FlatLayout.from_shapes([
            (x.path, local_shape(x.shape, get_path(specs, x.path), mesh), x.dtype)
            for x in self.leaves])

    def dtensors(self, flat: torch.Tensor, specs, mesh, cast: bool = False) -> dict:
        """The tree of DTensors on ``mesh`` whose local shards are this
        (local) layout's views of ``flat``, each laid out by its spec (cast
        to its leaf's dtype with ``cast``, differentiably)."""
        from torch.distributed.tensor import DTensor

        tree = self.unflatten(flat) if cast else self.tree(flat)
        out: dict = {}
        for x in self.leaves:
            local = get_path(tree, x.path)
            set_path(out, x.path, DTensor.from_local(
                local, mesh, placements(get_path(specs, x.path), mesh), run_check=False))
        return out

    def views(self, flat: torch.Tensor) -> list[torch.Tensor]:
        """Each leaf's view of ``flat`` [..., numel] as [..., *shape]: no copy."""
        lead = tuple(flat.shape[:-1])
        return [flat[..., x.offset:x.offset + x.size].view(lead + x.shape) for x in self.leaves]

    def tree(self, flat: torch.Tensor, cast: bool = False) -> dict:
        """The tree of :meth:`views` (each cast to its leaf's dtype with
        ``cast``: a copy where the dtype differs)."""
        out: dict = {}
        for x, v in zip(self.leaves, self.views(flat)):
            set_path(out, x.path, v.to(x.dtype) if cast else v)
        return out

    def unflatten(self, flat: torch.Tensor) -> dict:
        """The parameter tree over ``flat`` [numel] for a loss: each leaf cast
        to its dtype, through one ``split``, so that autograd writes the flat
        gradient once (not one zero-filled ``[numel]`` tensor per leaf)."""
        sizes, end = [], 0
        for x in self.leaves:
            sizes += [x.offset - end, x.size]
            end = x.offset + x.size
        parts = torch.split(flat, sizes + [self.numel - end], dim=-1)
        out: dict = {}
        for x, part in zip(self.leaves, parts[1::2]):
            set_path(out, x.path, part.view(x.shape).to(x.dtype))
        return out

    def flatten(self, tree, dtype=torch.float32) -> torch.Tensor:
        """A new ``[..., numel]`` tensor of ``dtype`` holding ``tree``'s leaves
        (any leading dims, as ``[P, *shape]`` slots have), gaps zero."""
        first = get_path(tree, self.leaves[0].path)
        lead = tuple(first.shape[:first.dim() - len(self.leaves[0].shape)])
        out = torch.zeros(lead + (self.numel,), dtype=dtype, device=first.device)
        for x, v in zip(self.leaves, self.views(out)):
            v.copy_(get_path(tree, x.path))
        return out

    def round_(self, flat: torch.Tensor) -> torch.Tensor:
        """Round each leaf of ``flat`` to its own dtype, in place."""
        for x, v in zip(self.leaves, self.views(flat)):
            if x.dtype != flat.dtype:
                v.copy_(v.to(x.dtype))
        return flat


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------


def rmsnorm_decls(dim: int, axis: str = "embed2") -> dict[str, ParamDecl]:
    return {"scale": ParamDecl((dim,), (axis,), init="ones", dtype="float32")}


def rmsnorm(params, x, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"]).to(dt)


def layernorm_decls(dim: int, axis: str = "embed2") -> dict[str, ParamDecl]:
    return {
        "scale": ParamDecl((dim,), (axis,), init="ones", dtype="float32"),
        "bias": ParamDecl((dim,), (axis,), init="zeros", dtype="float32"),
    }


def layernorm(params, x, eps: float) -> torch.Tensor:
    """LayerNorm in float32 over the last dim: the population variance
    (``jnp.var``'s; torch's default would be the unbiased one).  On a mesh
    its input is made whole along the last dim first: a mean over a split
    dim is a ``Partial(avg)``, whose backward DTensor cannot take."""
    dt = x.dtype
    x = shard_batch(x, *([None] * (x.dim() - 1)))
    x = x.to(torch.float32)
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    x = (x - mean) * torch.rsqrt(var + eps)
    return (x * params["scale"] + params["bias"]).to(dt)


def norm_decls(cfg: ModelConfig, dim: int | None = None) -> dict[str, ParamDecl]:
    """LayerNorm for the enc-dec family (whisper), RMSNorm for every other."""
    dim = dim or cfg.d_model
    if cfg.family == "enc_dec":
        return layernorm_decls(dim)
    return rmsnorm_decls(dim)


def apply_norm(cfg: ModelConfig, params, x) -> torch.Tensor:
    if cfg.family == "enc_dec":
        return layernorm(params, x, cfg.norm_eps)
    return rmsnorm(params, x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)  # [hd/2]
    angles = positions[..., :, None].to(torch.float32) * freqs  # [..., s, hd/2]
    cos = torch.cos(angles)[..., :, None, :]  # [..., s, 1, hd/2]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (dense FFN)
# ---------------------------------------------------------------------------


def mlp_decls(cfg: ModelConfig, d_ff: int | None = None, swiglu: bool = True):
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    if swiglu:
        return {
            "w_gate": ParamDecl((d, f), ("embed", "mlp"), init="scaled"),
            "w_up": ParamDecl((d, f), ("embed", "mlp"), init="scaled"),
            "w_down": ParamDecl((f, d), ("mlp", "embed"), init="scaled"),
        }
    return {
        "w_up": ParamDecl((d, f), ("embed", "mlp"), init="scaled"),
        "b_up": ParamDecl((f,), ("mlp",), init="zeros"),
        "w_down": ParamDecl((f, d), ("mlp", "embed"), init="scaled"),
        "b_down": ParamDecl((d,), ("embed",), init="zeros"),
    }


def mlp_apply(params, x, swiglu: bool = True) -> torch.Tensor:
    """SwiGLU: ``(silu(x W_gate) in f32, cast) * x W_up``, then ``W_down``;
    or the two-matrix GELU MLP (whisper, starcoder2): ``x W_up + b_up``,
    GELU in float32 with the tanh approximation (``jax.nn.gelu``'s default),
    cast, then ``W_down + b_down``."""
    if swiglu:
        gate = torch.einsum("...d,df->...f", x, params["w_gate"])
        up = torch.einsum("...d,df->...f", x, params["w_up"])
        h = F.silu(gate.to(torch.float32)).to(x.dtype) * up
        return tp_contract("...f,fd->...d", h, params["w_down"])
    h = torch.einsum("...d,df->...f", x, params["w_up"]) + params["b_up"].to(x.dtype)
    h = F.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)
    return tp_contract("...f,fd->...d", h, params["w_down"]) + params["b_down"].to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def embed_decls(cfg: ModelConfig) -> dict[str, ParamDecl]:
    v = round_up(cfg.vocab_size, 256)  # the reference pads for vocab sharding
    out = {"tok": ParamDecl((v, cfg.d_model), ("vocab", "embed"))}
    if not cfg.tie_embeddings:
        out["unembed"] = ParamDecl((cfg.d_model, v), ("embed", "vocab"), init="scaled")
    return out


def embed_lookup(params, tokens, d_model: int, dtype) -> torch.Tensor:
    return params["tok"].to(dtype)[tokens]


def unembed(cfg: ModelConfig, params, x) -> torch.Tensor:
    """Logits over the padded vocab (tied: ``x @ tok.T``)."""
    if cfg.tie_embeddings:
        return torch.einsum("...d,vd->...v", x, params["tok"].to(x.dtype))
    return torch.einsum("...d,dv->...v", x, params["unembed"].to(x.dtype))
