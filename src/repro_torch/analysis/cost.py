"""FLOPs and HBM bytes of one run of a torch program, counted op by op.

The counterpart of ``repro.analysis.hlo``.  :func:`count_cost` runs the
program once under a ``TorchDispatchMode``, which sees every ATen op that
really runs: a Python loop's trips count themselves, so nothing here parses
trip counts.  The accounting keeps ``hlo.py``'s rules:

* **FLOPs**: ``2 · prod(result) · contraction`` for ``mm``, ``bmm``,
  ``addmm``, ``baddbmm``, ``mv``, ``dot``, the ``_scaled_dot_product_*``
  attention ops (two products) and ``convolution``; ``einsum`` and
  ``matmul`` reach the dispatch mode as these.  Each product's FLOPs go to
  the peak of its operands' dtype (:func:`~repro_torch.analysis.kernel_costs.peak_for`).
* **Bytes**: an op's materialized results are written once and read once
  (twice their bytes); a product's operands are read.  Views (slices,
  transposes, aliasing reshapes, ``expand``) bill nothing, so an
  ``index_select`` or a gather of a slice bills only what it produces.  An
  in-place op or a copy into a slice bills the region it writes; an empty
  allocation bills nothing.
* **Kernels**: the port's CUDA kernels are ctypes calls, which the dispatch
  mode never sees.  Their wrappers report each launch to this thread's
  counter with the kernel's cost model
  (:mod:`repro_torch.analysis.kernel_costs`): the model bills the kernel's own
  reads, writes and FLOPs, under the kernel's name; the wrapper's torch ops
  (its output allocation, any padding or copy) are billed by the dispatch
  mode like any other op.  The counter is thread-local: the shards of a
  sharded run, each in a thread of its own, are not counted by another
  thread's counter.
* **Attention score bytes**: the bytes of results whose two trailing dims
  are equal and at least :data:`MIN_SCORE_DIM` (``[.., S, S]`` score buffers:
  the counterpart of ``hlo.sxs_buffer_bytes``), the part of the memory
  term a flash kernel keeps out of HBM.

* **Collectives** (a mesh run): every collective this rank dispatches,
  the ``_c10d_functional`` ops of a ``DTensor`` redistribution and the
  ``c10d`` ops of an explicit ``torch.distributed`` call, counted by kind
  with the reference's ring-model wire bytes (``hlo._collective_cost``):
  all-reduce ``2(n-1)/n`` of its size, all-gather ``(n-1)/n`` of its result,
  reduce-scatter ``(n-1)`` times its result, all-to-all ``(n-1)/n`` of its
  size, over the ``n`` ranks of its group, beside each kind's result and
  operand bytes (:meth:`Cost.collectives_dict`, the reference's keys).  An
  op on ``DTensor`` operands is not counted itself: the local ops and
  collectives it runs on this rank are; nor is torch's bookkeeping (:func:`not_the_programs`): the ops
  DTensor's sharding propagation runs on fake or meta tensors to learn an
  output's shape (cached, so a count would depend on what ran before) and
  a DeviceMesh's host ops on its rank table.  A caller names the site of
  the collectives it dispatches with
  ``models/sharding.py::collective_site`` (the mesh step's and the mesh
  server's degather, the step's gradient mean, H sum, int8 row max,
  adafactor means, norm and losses;
  the MoE's ``moe EP combine`` all-gather of the experts' outputs, and of
  their input's cotangent in the backward, ``moe ffn all-reduce`` of the
  down-projection's partial sums, and of the experts' input's cotangent in
  the backward, ``moe routing gather`` of a straddled chunk's expert
  choices and ``moe aux``'s all-reduce of the stream's expert counts and
  mean probabilities); the rest (the model's tensor-parallel all-reduces)
  count under ``"model"``.

What it cannot see: a kernel without a cost model; host work (the Python
interpreter, launches, synchronizations); and bytes that the caches keep
out of HBM or that an op moves beyond its inputs and outputs (a
non-contiguous operand re-read, a library's workspace).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import math
import sys
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.kernel_costs import peak_for
from repro_torch.kernels import _build
from repro_torch.models import sharding

aten = torch.ops.aten

#: the least sequence length whose ``[.., S, S]`` results count as attention scores
MIN_SCORE_DIM = 1024

#: products: op name -> index of the left operand (its last dim is the contraction)
PRODUCTS = {"mm": 0, "bmm": 0, "mv": 0, "dot": 0, "addmm": 1, "baddbmm": 1, "addmv": 1}
_ATTENTION = {
    getattr(aten, name).default
    for name in ("_scaled_dot_product_flash_attention",
                 "_scaled_dot_product_efficient_attention",
                 "_scaled_dot_product_cudnn_attention",
                 "_scaled_dot_product_flash_attention_for_cpu")
    if hasattr(aten, name)
}
#: ops that allocate without writing, or alias without a schema annotation
_FREE = {
    aten.empty.memory_format, aten.empty_strided.default, aten.empty_like.default,
    aten.new_empty.default, aten.new_empty_strided.default, aten._unsafe_view.default,
    aten.alias.default, aten.detach.default, aten._local_scalar_dense.default,
}


def composite(func) -> bool:
    """Whether ``func`` is an op that decomposes into others
    (CompositeImplicitAutograd): outside inference mode the dispatch mode
    sees only its parts."""
    return torch._C._dispatch_has_kernel_for_dispatch_key(
        func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _written(func, args, ins, outs) -> int:
    """Bytes an in-place or ``out=`` op writes: an indexed write's indexed
    elements, else the whole mutated tensor (a slice's view for a copy into
    a slice)."""
    target = next((t for t in ins if any(t is o for o in outs)), outs[0] if outs else None)
    if target is None:
        return 0
    packet = func.overloadpacket
    if packet in (aten.index_put_, aten.index_put, aten._index_put_impl_):
        idx = [i for i in args[1] if i is not None]
        rest = target.shape[len(args[1]):]
        return math.prod(torch.broadcast_shapes(*(i.shape for i in idx))) * math.prod(rest) \
            * target.element_size()
    if packet in (aten.scatter_, aten.scatter_add_, aten.scatter_reduce_):
        return args[2].numel() * target.element_size()
    return _nbytes(target)


#: collective ops (``_c10d_functional`` and ``c10d`` names) -> the reference's kind
COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}


def _group_size(func, args) -> int:
    """The ranks of a collective's group, from its group argument (a size,
    a group name, or a process group object)."""
    from torch.distributed import distributed_c10d as c10d

    for a in args:
        if isinstance(a, torch.ScriptObject):
            return int(torch.distributed.ProcessGroup.unbox(a).size())
    if isinstance(args[-1], str):
        return c10d._resolve_process_group(args[-1]).size()
    return 1


def _wire_bytes(kind: str, size: float, result: float, n: int) -> float:
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n * size
    if kind == "all-gather":
        return (n - 1) / n * result
    if kind == "reduce-scatter":
        return float(n - 1) * result
    if kind == "all-to-all":
        return (n - 1) / n * size
    return float(size)


def _operand_bytes(kind: str, result: float, n: int) -> float:
    """A collective's operand bytes from its result's, as
    ``hlo._collective_cost`` has them: an all-gather's operand is ``1/n``
    of its result, a reduce-scatter's ``n`` times it, any other's its size."""
    if kind == "all-gather":
        return result / n
    if kind == "reduce-scatter":
        return result * n
    return float(result)


@dataclasses.dataclass
class CostRow:
    """One op (``aten.<name>``) or kernel's share of a counted run."""

    name: str
    calls: int = 0
    flops: float = 0.0
    bytes: float = 0.0


@dataclasses.dataclass
class Cost:
    """What :func:`count_cost` counted: totals, FLOPs by the peak they run
    at, the attention score bytes, and one :class:`CostRow` per op or kernel."""

    flops: float = 0.0
    bytes: float = 0.0
    attn_score_bytes: float = 0.0
    flops_at_peak: dict = dataclasses.field(default_factory=dict)
    rows: dict = dataclasses.field(default_factory=dict)
    #: collectives by kind: calls, result and operand bytes, ring-model wire bytes
    coll_counts: dict = dataclasses.field(default_factory=dict)
    coll_result_bytes: dict = dataclasses.field(default_factory=dict)
    coll_operand_bytes: dict = dataclasses.field(default_factory=dict)
    coll_wire_bytes: dict = dataclasses.field(default_factory=dict)
    #: the same by ``"<site>: <kind>"`` (``sharding.collective_site``)
    coll_site_counts: dict = dataclasses.field(default_factory=dict)
    coll_site_wire_bytes: dict = dataclasses.field(default_factory=dict)

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.coll_wire_bytes.values())

    @property
    def total_operand_bytes(self) -> float:
        return sum(self.coll_operand_bytes.values())

    def collectives_dict(self) -> dict:
        """The collectives by kind under ``HloCost.as_dict()``'s keys."""
        return {
            "counts": dict(self.coll_counts),
            "result_bytes": dict(self.coll_result_bytes),
            "operand_bytes": dict(self.coll_operand_bytes),
            "wire_bytes": dict(self.coll_wire_bytes),
            "total_operand_bytes": self.total_operand_bytes,
            "total_wire_bytes": self.total_wire_bytes,
        }

    def add_collective(self, kind: str, wire: float, site: str = "model",
                       result: float = 0.0, operand: float = 0.0) -> None:
        self.coll_counts[kind] = self.coll_counts.get(kind, 0) + 1
        self.coll_result_bytes[kind] = self.coll_result_bytes.get(kind, 0.0) + result
        self.coll_operand_bytes[kind] = self.coll_operand_bytes.get(kind, 0.0) + operand
        self.coll_wire_bytes[kind] = self.coll_wire_bytes.get(kind, 0.0) + wire
        key = f"{site}: {kind}"
        self.coll_site_counts[key] = self.coll_site_counts.get(key, 0) + 1
        self.coll_site_wire_bytes[key] = self.coll_site_wire_bytes.get(key, 0.0) + wire

    def add(self, name: str, flops: float, nbytes: float, peak: float | None = None) -> None:
        row = self.rows.get(name)
        if row is None:
            row = self.rows[name] = CostRow(name)
        row.calls += 1
        row.flops += flops
        row.bytes += nbytes
        self.flops += flops
        self.bytes += nbytes
        if flops:
            self.flops_at_peak[peak] = self.flops_at_peak.get(peak, 0.0) + flops

    def top_costs(self, k: int = 15) -> dict:
        """The k rows with the most bytes and the k with the most FLOPs, each
        ``(value, name, calls)``, largest first (``hlo.top_costs``)."""
        rows = self.rows.values()
        return {
            "bytes": sorted(((r.bytes, r.name, r.calls) for r in rows), reverse=True)[:k],
            "flops": sorted(((r.flops, r.name, r.calls) for r in rows if r.flops),
                            reverse=True)[:k],
        }

    def diff(self, other: "Cost") -> list:
        """Every field of two counts that differs, as ``(name, self's,
        other's)``: the totals, FLOPs by peak, the collectives by kind and
        by site, and each row's ``(calls, flops, bytes)``."""
        out = [(f, getattr(self, f), getattr(other, f))
               for f in ("flops", "bytes", "attn_score_bytes", "flops_at_peak", "coll_counts",
                         "coll_result_bytes", "coll_operand_bytes", "coll_wire_bytes",
                         "coll_site_counts", "coll_site_wire_bytes")
               if getattr(self, f) != getattr(other, f)]
        mine = {n: (r.calls, r.flops, r.bytes) for n, r in self.rows.items()}
        theirs = {n: (r.calls, r.flops, r.bytes) for n, r in other.rows.items()}
        return out + [(n, mine.get(n), theirs.get(n)) for n in sorted(set(mine) | set(theirs))
                      if mine.get(n) != theirs.get(n)]

    def flops_of(self, *names: str) -> float:
        return sum(self.rows[n].flops for n in names if n in self.rows)


#: torch modules whose ops are bookkeeping, not work of the counted program:
#: DTensor's sharding propagation (an op run on fake or meta tensors to learn
#: its output's shape and placement; cached, so a count would depend on what
#: ran before) and a DeviceMesh's coordinates (host ops on its rank table)
BOOKKEEPING_MODULES = ("torch.distributed.tensor._sharding_prop",
                       "torch.distributed.tensor._decompositions",
                       "torch.distributed.device_mesh", "torch.distributed._mesh_layout")


def _source_file(module: str) -> str | None:
    spec = importlib.util.find_spec(module)
    return None if spec is None else spec.origin


#: the source files of :data:`BOOKKEEPING_MODULES` in this torch (a module it
#: does not have is left out; :func:`missing_bookkeeping` names it)
_BOOKKEEPING = frozenset(filter(None, map(_source_file, BOOKKEEPING_MODULES)))


def missing_bookkeeping() -> list[str]:
    """The modules of :data:`BOOKKEEPING_MODULES` that this torch does not
    have: a torch that moved one counts its ops again."""
    return [m for m in BOOKKEEPING_MODULES if _source_file(m) is None]


def not_the_programs(flat) -> bool:
    """Whether an op of these arguments (``flat``) is torch's bookkeeping
    (:data:`_BOOKKEEPING`): fake tensors, or an op dispatched from those
    modules.  The caller's frames are read only where an op may be one
    (no CUDA tensor among its arguments), so a run on the card pays little."""
    tensors = [t for t in flat if isinstance(t, torch.Tensor)]
    if any(isinstance(t, FakeTensor) for t in tensors):
        return True
    if tensors and all(t.is_cuda for t in tensors):
        return False
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename in _BOOKKEEPING:
            return True
        f = f.f_back
    return False


class LiveBytes:
    """The bytes the ops of a counted run allocate and still hold, and their
    peak (``count_cost(..., live=)``): each storage an op's result lies in,
    unless an argument's (``known``, the run's inputs) or already held, is
    held from that op until the storage dies (a weak reference's callback:
    torch keeps a storage's Python object as long as the storage lives).
    Meta storages have sizes, so a dry run over meta tensors is measured too."""

    def __init__(self, known=()):
        self.known = set(known)
        self.held: dict = {}
        self.live = self.peak = 0

    def hold(self, out) -> None:
        for t in _tensors(out):
            if isinstance(t, DTensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self.known or key in self.held:
                continue
            n = st.nbytes()
            self.held[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self.held.pop(key, 0)


class _CostMode(TorchDispatchMode):
    def __init__(self, cost: Cost, live: LiveBytes | None = None):
        super().__init__()
        self.cost = cost
        self.live = live
        self.paused = False

    def kernel(self, name: str, model) -> None:
        """A kernel wrapper's report (``_build.count_launch``): its model's
        host reads are not counted."""
        self.paused = True
        try:
            nbytes, flops, peak = model()
        finally:
            self.paused = False
        self.cost.add(name, flops, nbytes, peak)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = tree_flatten((args, kwargs))[0]
        if not_the_programs(flat):
            return func(*args, **kwargs)
        if any(isinstance(t, DTensor) for t in flat):
            # DTensor runs it: its local ops and collectives come back here
            return NotImplemented
        if composite(func):
            # under inference_mode composite ops (einsum, matmul, to) arrive
            # whole: count the ops they decompose into
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if not self.paused and func is not aten.lift_fresh.default:
            # (lift_fresh marks a constant made from a Python number: nothing
            # the device runs, and a meta constant dispatches no op at all)
            self._count(func, args, kwargs, out)
            if self.live is not None:
                self.live.hold(out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        op = func.overloadpacket.__name__
        if func.namespace in ("_c10d_functional", "c10d"):
            kind = COLLECTIVES.get(op)
            if kind is not None:
                # a c10d op's first argument is its output (or, for an
                # all-reduce, its operand): its size is the result's
                size = sum(_nbytes(t) for t in _tensors(args[:1]))
                result = sum(_nbytes(t) for t in _tensors(out)) if func.namespace == (
                    "_c10d_functional") else size
                n = _group_size(func, args)
                self.cost.add_collective(kind, _wire_bytes(kind, size, result, n),
                                         sharding.collective_site_name() or "model",
                                         result, _operand_bytes(kind, result, n))
            return
        name = f"aten.{op}"
        if func in _FREE or func.is_view:
            self.cost.add(name, 0.0, 0.0)
            return
        outs = _tensors(out)
        ins = _tensors((args, kwargs))
        flops, peak, nbytes = 0.0, None, 0.0
        if op in PRODUCTS:
            lhs = args[PRODUCTS[op]]
            flops = 2.0 * math.prod(outs[0].shape) * lhs.shape[-1]
            peak = peak_for(lhs.dtype)
            nbytes += sum(_nbytes(t) for t in ins)
        elif func in _ATTENTION:
            q, k = args[0], args[1]
            flops = 4.0 * math.prod(q.shape[:-1]) * k.shape[-2] * q.shape[-1]
            peak = peak_for(q.dtype)
            nbytes += sum(_nbytes(t) for t in args[:3])
        elif func.overloadpacket is aten.convolution:
            w, o = args[1], outs[0]
            flops = 2.0 * math.prod(o.shape) * math.prod(w.shape[1:])
            peak = peak_for(w.dtype)
            nbytes += sum(_nbytes(t) for t in ins)
        if func._schema.is_mutable:
            nbytes += 2 * _written(func, args, ins, outs)
        else:
            nbytes += 2 * sum(_nbytes(t) for t in outs)
        for t in outs:
            if t.dim() >= 2 and t.shape[-1] == t.shape[-2] >= MIN_SCORE_DIM:
                self.cost.attn_score_bytes += 2 * _nbytes(t)
        self.cost.add(name, flops, nbytes, peak)


def count_cost(fn, *args, live: LiveBytes | None = None, **kwargs) -> Cost:
    """Run ``fn(*args, **kwargs)`` once and count its FLOPs and bytes (see
    the module docstring); the kernels this thread launches meanwhile are
    billed by their cost models.  ``live`` also follows the bytes the run's
    ops hold (:class:`LiveBytes`).  ``fn``'s result is not returned: a caller
    that needs it keeps it from a closure."""
    cost = Cost()
    mode = _CostMode(cost, live)
    prev = getattr(_build.cost_counter, "active", None)
    _build.cost_counter.active = mode.kernel
    try:
        with mode:
            fn(*args, **kwargs)
    finally:
        _build.cost_counter.active = prev
    return cost
