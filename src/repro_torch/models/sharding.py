"""Activation and parameter sharding over a device mesh, from
``repro.models.sharding``.

The reference is single-controller GSPMD: one program sees the global
arrays, a :class:`PartitionSpec` names the mesh axes each dim is split
over, and ``shard`` is a ``with_sharding_constraint``.  The port is
multi-controller: one process per rank (``launch/mesh.py``), a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
names, and tensors as DTensors whose placements come from the specs
(:func:`placements`).

Groups and batches lie on the data-parallel axes (``pod``, ``data``): a
DSAG group's batch is split over the data-parallel ranks its group axes
leave (``core/dsag_pjit.py``), and a served batch is split over them.  So
a rank computes its own group or batch slice on the *compute mesh*, the
sub-mesh of the other axes
(``model``; :func:`compute_mesh`), and a spec's data-parallel entries are
carried by the rank itself.  :func:`shard` therefore maps a spec onto the
mesh a tensor lies on and skips the axes that mesh does not have: on the
compute mesh, ``shard_batch(x, None, "model")`` shards the last dim over
``model`` and leaves the batch dim whole, since it is this rank's slice
already.  With no mesh installed (single-device runs) every helper here is
a no-op, so the same model code runs everywhere, as in the reference.

A kernel takes raw pointers and refuses a ``DTensor``: its callers hand it
the rank's local shard (``models/attention.py`` for K6, ``core/dsag_pjit.py``
for K4).  The mesh step's own reductions run here: :func:`sum_to` (a sum
over some axes, laid out by another spec), :func:`all_reduce_over` and
:func:`all_reduce_max` over the axes :func:`dim_axes` names (a row's axes
for int8 slots' row maxima, a reduced dim's for adafactor's means).
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.optim.compression import Quantized, dequantize

#: the mesh axes that carry data parallelism, in the reference's order
DP_AXES = ("pod", "data")


class PartitionSpec(tuple):
    """The reference's ``jax.sharding.PartitionSpec``: per tensor dim, a mesh
    axis name, a tuple of names (the dim split over all of them, the first
    one major) or ``None`` (not split).  Trailing dims left out are not
    split."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)

    def __getnewargs__(self):
        return tuple(self)


P = PartitionSpec


class NamedSharding:
    """The reference's ``NamedSharding``: a mesh and a :class:`PartitionSpec`."""

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, P(*tuple(spec))

    def place(self, t: torch.Tensor) -> "DTensor":
        """This rank's shard of the full ``t``, as a ``DTensor``."""
        return DTensor.from_local(local_shard(t, self.spec, self.mesh).contiguous(), self.mesh,
                                  placements(self.spec, self.mesh), run_check=False)

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec})"

_MESH = None


def set_mesh(mesh) -> None:
    """Install ``mesh`` for this process: a ``DeviceMesh``, a
    :class:`~repro_torch.configs.base.MeshConfig` (its axes only: what the
    spec functions read), or ``None``."""
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


def _names(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else getattr(mesh, "axes", ()))


def dp_axes() -> tuple[str, ...]:
    """Mesh axes that carry data parallelism (('pod','data') when present)."""
    if _MESH is None:
        return ()
    return tuple(a for a in _names(_MESH) if a in DP_AXES)


def batch_spec(*rest) -> PartitionSpec:
    """PartitionSpec with the batch dim over all DP axes."""
    axes = dp_axes()
    lead = axes if len(axes) > 1 else (axes[0] if axes else None)
    return P(lead, *rest)


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(spec, mesh) -> list:
    """The ``DTensor`` placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` where ``spec`` names that mesh axis on tensor dim ``d``,
    else ``Replicate()``.  Axes ``mesh`` does not have are skipped: on the
    compute mesh they are the data-parallel axes the rank itself carries.
    A dim split over several axes lists them in the mesh's order (the first
    one major), as ``DTensor`` shards them."""
    names = _names(mesh)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(tuple(spec)):
        axes = [a for a in _entry_axes(entry) if a in names]
        if [names.index(a) for a in axes] != sorted(names.index(a) for a in axes):
            raise ValueError(f"{spec}: dim {dim} lists its axes out of the mesh's order {names}")
        for a in axes:
            out[names.index(a)] = Shard(dim)
    return out


def shard(x, spec):
    """Redistribute ``x`` to ``spec`` on the mesh it lies on (the reference's
    ``with_sharding_constraint``); a no-op without an installed mesh or for a
    tensor that is not a ``DTensor``.  A ``Partial`` sum becomes its
    all-reduce or reduce-scatter here (the reference's psum sites)."""
    if _MESH is None or not isinstance(x, DTensor):
        return x
    target = placements(spec, x.device_mesh)
    if list(x.placements) == target:
        return x
    return x.redistribute(x.device_mesh, target)


def shard_batch(x, *rest):
    return shard(x, batch_spec(*rest))


def strip_axis(spec, axis: str = "data") -> PartitionSpec:
    """Remove one mesh axis from every dim of a PartitionSpec."""
    out = []
    for e in tuple(spec):
        if e == axis:
            out.append(None)
        elif isinstance(e, tuple):
            kept = tuple(a for a in e if a != axis)
            out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
        else:
            out.append(e)
    return P(*out)


def compute_mesh(mesh):
    """The sub-mesh a rank computes its group or batch slice on: ``mesh``
    without its data-parallel axes (``mesh["model"]``)."""
    rest = tuple(a for a in _names(mesh) if a not in DP_AXES)
    if not rest:
        raise ValueError(f"mesh {_names(mesh)} has no axis besides the data-parallel ones")
    return mesh[rest] if len(rest) > 1 else mesh[rest[0]]


def dp_coordinate(mesh) -> tuple[int, int]:
    """``(index, count)`` of this rank along the mesh's data-parallel axes
    (the first one major)."""
    return coordinate(mesh, tuple(a for a in _names(mesh) if a in DP_AXES))


def coordinate(mesh, axes) -> tuple[int, int]:
    """``(index, count)`` of this rank along the mesh axes ``axes`` (in the
    mesh's order, the first one major); ``(0, 1)`` for none."""
    idx, count = 0, 1
    for a in _names(mesh):
        if a in axes:
            size = mesh.size(_names(mesh).index(a))
            idx = idx * size + mesh.get_local_rank(a)
            count *= size
    return idx, count


def dim_axes(spec, dim: int, mesh) -> tuple[str, ...]:
    """The axes of ``mesh`` that split tensor dim ``dim`` (negative from the
    end of a tensor of ``len(spec)`` dims) of a tensor laid out by ``spec``;
    a row's axes are ``dim_axes(spec, -1, mesh)``."""
    entries = tuple(spec)
    if dim < 0:
        dim += len(entries)
    if not 0 <= dim < len(entries):
        return ()
    return tuple(a for a in _entry_axes(entries[dim]) if a in _names(mesh)
                 and mesh.size(_names(mesh).index(a)) > 1)


def spec_axes(spec, mesh) -> tuple[str, ...]:
    """Every axis of ``mesh`` (of size > 1) that splits some dim of ``spec``."""
    return tuple(a for d in range(len(tuple(spec))) for a in dim_axes(spec, d, mesh))


_STREAM: tuple[str, ...] | None = None


@contextlib.contextmanager
def token_stream(axes):
    """Name the mesh axes whose ranks split one token stream in equal slices,
    the rank's position along them its slice's (``models/moe.py``: the
    reference's ``moe_apply`` sees the whole stream, its dispatch chunks and
    aux loss are the stream's).  Serving's stream is the batch, over the
    data-parallel axes (the default); a DSAG group's is its batch, over the
    inner axes (``core/dsag_pjit.py``).  Process-wide, as the mesh is, so a
    recomputation in the backward sees it too."""
    global _STREAM
    prev, _STREAM = _STREAM, tuple(axes)
    try:
        yield
    finally:
        _STREAM = prev


def stream_axes() -> tuple[str, ...]:
    """The axes of :func:`token_stream`; the data-parallel ones by default."""
    return dp_axes() if _STREAM is None else _STREAM


_site = threading.local()


@contextlib.contextmanager
def collective_site(name: str):
    """Name the site of the collectives this thread dispatches inside:
    ``analysis/cost.py::count_cost`` counts them under ``name`` in its
    ``coll_site_*`` (free when nothing counts)."""
    prev = getattr(_site, "name", None)
    _site.name = name
    try:
        yield
    finally:
        _site.name = prev


def collective_site_name() -> str | None:
    """The innermost :func:`collective_site` of this thread, or None."""
    return getattr(_site, "name", None)


def all_reduce_over(t: torch.Tensor, mesh, axes, op=None) -> torch.Tensor:
    """``t`` reduced in place over the ranks that differ only along the mesh
    axes ``axes`` (a sum, or ``op``, e.g. ``ReduceOp.MAX``): one all-reduce
    per axis, each over that axis's group; a no-op for no axes."""
    op = torch.distributed.ReduceOp.SUM if op is None else op
    for a in axes:
        torch.distributed.all_reduce(t, op=op, group=mesh.get_group(a))
    return t


def all_reduce_max(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``t``'s elementwise maximum over the ranks along ``axes``, in place:
    exact, whatever the order (int8 slots' row maxima across a row's shards)."""
    return all_reduce_over(t, mesh, axes, torch.distributed.ReduceOp.MAX)


def local_shape(shape, spec, mesh) -> tuple[int, ...]:
    """This rank's shard shape of a ``shape`` tensor laid out by ``spec``;
    every split dim must divide evenly."""
    out = list(shape)
    names = _names(mesh)
    for dim, entry in enumerate(tuple(spec)):
        n = math.prod(mesh.size(names.index(a)) for a in _entry_axes(entry) if a in names)
        if out[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split evenly over "
                             f"{n} ranks ({spec})")
        out[dim] //= n
    return tuple(out)


def local_shard(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's shard of the full tensor ``t`` laid out by ``spec`` (a
    view): what ``distribute_tensor`` would hand it, without communication."""
    names = _names(mesh)
    for dim, entry in enumerate(tuple(spec)):
        idx, n = 0, 1
        for a in (a for a in _entry_axes(entry) if a in names):
            size = mesh.size(names.index(a))
            idx, n = idx * size + mesh.get_local_rank(a), n * size
        if n > 1:
            if t.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split evenly over "
                                 f"{n} ranks ({spec})")
            chunk = t.shape[dim] // n
            t = t.narrow(dim, idx * chunk, chunk)
    return t


def replication(spec, mesh) -> int:
    """How many ranks of ``mesh`` hold each element of a tensor laid out by
    ``spec``: the product of the mesh axes it is not split over."""
    used = {a for e in tuple(spec) for a in _entry_axes(e)}
    names = _names(mesh)
    return math.prod(mesh.size(i) for i, a in enumerate(names) if a not in used)


def to_compute_mesh(x: DTensor):
    """``x`` (replicated over the data-parallel axes) as a ``DTensor`` on its
    mesh's compute mesh, with the same local shard: no copy."""
    mesh = x.device_mesh
    names = _names(mesh)
    keep = [p for a, p in zip(names, x.placements) if a not in DP_AXES]
    if any(not isinstance(p, Replicate) for a, p in zip(names, x.placements) if a in DP_AXES):
        raise ValueError(f"{x.placements}: only a tensor replicated over {DP_AXES} "
                         f"moves to the compute mesh")
    return DTensor.from_local(x.to_local(), compute_mesh(mesh), keep, run_check=False)


class _QuantizedGather(torch.autograd.Function):
    """The reference's ``q_gather``: quantize each row (over its whole last
    dim, while sharded), gather the int8 payload and the bfloat16 row
    scales to ``gathered``, dequantize locally.  The backward is
    straight-through: the cotangent is laid out as the stored weight."""

    @staticmethod
    def forward(ctx, w, gathered, scale_gathered, stored):
        ctx.stored = stored
        mesh = w.device_mesh
        x = w.to(torch.float32)
        # ``quantize(w, block=w.shape[-1])``: one block per row, its absmax
        # reduced over the ranks the row is split over
        absmax = x.abs().amax(dim=-1, keepdim=True)
        d = torch.full((), 127.0, dtype=torch.float32, device=x.device_mesh.device_type)
        scale = torch.where(absmax > 0, absmax / d, torch.ones((), device=d.device))
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        qv = q.redistribute(mesh, gathered).to_local()
        sc = scale.to(torch.bfloat16).redistribute(mesh, scale_gathered).to_local()
        out = dequantize(Quantized(qv, sc, qv.shape[-1]), w.dtype)
        return DTensor.from_local(out, mesh, gathered, run_check=False)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.stored), None, None, None


def degather(params, param_specs, mesh, quantized: bool = False):
    """ZeRO-3 gather-at-use: redistribute FSDP-sharded parameters (``DTensor``
    leaves on ``mesh``) to their TP-only layout (``spec`` without ``data``).
    The all-gather happens here, and autograd reduce-scatters a gradient
    through it; the stored parameters stay fully sharded.

    ``quantized=True`` compresses the weight all-gather to int8 (+bf16
    per-row scales): quantize while sharded, gather the int8 payload, and
    dequantize locally.  Gradients flow through the straight-through
    dequant.  float32 leaves and leaves of fewer than 2 dims gather as
    they are, as in the reference."""
    if mesh is None:
        return params

    def leaf(x, spec):
        gathered = placements(strip_axis(spec, "data"), mesh)
        if not quantized or x.dim() < 2 or x.dtype == torch.float32:
            return x if list(x.placements) == gathered else x.redistribute(mesh, gathered)
        scale_spec = P(*tuple(strip_axis(spec, "data"))[:x.dim() - 1], None)
        return _QuantizedGather.apply(x, gathered, placements(scale_spec, mesh),
                                      placements(spec, mesh))

    return map_specs(leaf, params, param_specs)


def map_specs(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


def is_sharded(x) -> bool:
    """Whether ``x`` is a ``DTensor`` (a tensor of a mesh run)."""
    return isinstance(x, DTensor)


def partial_sum(local: torch.Tensor, mesh, spec, over: tuple[str, ...]) -> DTensor:
    """``local``, one rank's addend of a sum over the mesh axes ``over``, as
    a ``DTensor`` laid out by ``spec`` on the other axes (``Partial`` on
    ``over``): redistributing it sums over ``over``."""
    pl = placements(spec, mesh)
    for a in over:
        pl[_names(mesh).index(a)] = Partial()
    return DTensor.from_local(local, mesh, pl, run_check=False)


def sum_to(local: torch.Tensor, mesh, spec, over: tuple[str, ...], target) -> torch.Tensor:
    """This rank's shard, laid out by ``target``, of the sum over the mesh
    axes ``over`` of every rank's ``local`` (laid out by ``spec``): an
    all-reduce over an axis ``target`` replicates (``pod`` for a ``pod``
    group's H), a reduce-scatter over one it splits (``data`` under FSDP);
    ``local`` itself (no copy) when there is nothing to sum or move."""
    src = placements(spec, mesh)
    want = placements(target, mesh)
    if not over and src == want:
        return local
    return partial_sum(local, mesh, spec, over).redistribute(mesh, want).to_local()


def write_slice(dst, dim: int, start: int, src) -> None:
    """``dst.narrow(dim, start, n).copy_(src)`` in place, also where ``dst``
    is a ``DTensor`` split along ``dim`` (a decode cache sharded over its
    sequence): each rank writes the part of ``src`` that falls in its own
    shard.  A ``DTensor`` ``src`` split on another dim that covers at
    least one shard's length (a prefill's prompt, split over heads) is
    zero-padded to ``dst``'s length and resharded straight to ``dst``'s
    layout: an all-to-all, each rank receiving its positions of every head
    (torch falls back to an all-gather on a CPU group).  A shorter one (a
    decode step's token) is made whole along ``dim`` first: a gather of
    fewer bytes than the padded all-to-all."""
    n = src.shape[dim]
    if not isinstance(dst, DTensor):
        dst.narrow(dim, start, n).copy_(src)
        return
    mesh = dst.device_mesh
    local = dst.to_local()
    chunk = local.shape[dim]
    off = 0
    for i, p in enumerate(dst.placements):
        if isinstance(p, Shard) and p.dim == dim:
            off = off * mesh.size(i) + mesh.get_local_rank(i)
    lo, hi = max(start, off * chunk), min(start + n, (off + 1) * chunk)
    if isinstance(src, DTensor):
        with collective_site("cache write"):
            split = [p.dim for p in src.placements if isinstance(p, Shard)]
            if n >= chunk and split and dim not in split:
                mine = _padded_to(src, dim, start, dst.shape[dim])
                mine = mine.redistribute(mesh, dst.placements).to_local()
                if lo < hi:
                    local.narrow(dim, lo - off * chunk, hi - lo).copy_(
                        mine.narrow(dim, lo - off * chunk, hi - lo))
                return
            want = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
                    for p in dst.placements]
            src = (src if list(src.placements) == want else src.redistribute(mesh, want))
            src = src.to_local()
    if lo < hi:
        local.narrow(dim, lo - off * chunk, hi - lo).copy_(src.narrow(dim, lo - start, hi - lo))


def _padded_to(src: DTensor, dim: int, start: int, length: int) -> DTensor:
    """``src`` (split on another dim) placed at ``[start, start + n)`` of
    zeros of ``length`` along ``dim``: each rank pads its own shard."""
    local = src.to_local()
    if start == 0 and local.shape[dim] == length:
        return src
    shape = list(local.shape)
    shape[dim] = length
    padded = local.new_zeros(shape)
    padded.narrow(dim, start, local.shape[dim]).copy_(local)
    whole = list(src.shape)
    whole[dim] = length
    return DTensor.from_local(padded, src.device_mesh, src.placements, run_check=False,
                              shape=torch.Size(whole),
                              stride=tuple(math.prod(whole[i + 1:]) for i in range(len(whole))))


def full(x):
    """A ``DTensor``'s global value on every rank (other tensors as they are)."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def tree_specs_map(fn, specs) -> Any:
    """``fn`` over every :class:`PartitionSpec` leaf of a spec tree."""
    if isinstance(specs, dict):
        return {k: tree_specs_map(fn, v) for k, v in specs.items()}
    return fn(specs)
