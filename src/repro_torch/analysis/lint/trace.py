"""Record one run of an entry's torch program for the lint rules.

The counterpart of ``repro.analysis.lint.jaxpr_utils``: eager torch has no
jaxpr, so :func:`run_traced` runs the program once under a
``TorchDispatchMode`` and keeps an :class:`OpRecord` of each ATen op the
rules read (reductions, products, fused multiply-adds, and any op that
yields a float32 or narrower tensor), each operand tagged with two taints
that travel with the values through every op:

* **mask evidence** (TL003): a tensor produced by a comparison (``lt``,
  ``le``, ``gt``, ``ge``, ``eq``, ``ne``) carries it, and so does every
  tensor computed from one that does (the counterpart of
  ``jaxpr_utils.reaches_comparison``);
* **value side** (TL004): the iterate, the data and what is computed from
  them, whose arithmetic is float32 or narrower by design; a float tensor
  of fewer than 8 bytes carries it, and so does every tensor computed from
  one.  The event algebra (times, latencies, counts: float64 and int64)
  never does.

Taints flow from an op's value operands to its results, not from the index
operands of a gather, an index or an indexed write: an index selects values
and says nothing about them (as the reference follows only operand 0 of a
gather).  An in-place op adds its operands' taints to the tensor it writes.

With ``loop=(function, names)``, :func:`run_traced` also snapshots the
dtypes of the named local variables of ``function`` (its loop carries) at
each pass over its ``for`` line, i.e. at every iteration boundary, through
``sys.settrace`` in this thread.
"""

from __future__ import annotations

import dataclasses
import inspect
import sys
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.cost import PRODUCTS, composite

COMPARISONS = frozenset({"lt", "le", "gt", "ge", "eq", "ne"})
#: dtypes whose tensors are value side at the source
NARROW_FLOATS = frozenset({torch.float32, torch.bfloat16, torch.float16})
#: reductions over axes (TL003)
REDUCTIONS = frozenset({"sum", "mean", "nansum", "prod"})
#: ops that multiply and add with one rounding (or may: a BLAS product) (TL001)
FMA_OPS = frozenset({"addcmul", "addcdiv", "lerp", "addmm", "baddbmm", "addmv", "addbmm",
                     "addr"})
#: ops recorded whatever their results (the others only where they yield a
#: narrow float, what TL004 looks at)
_RECORDED = REDUCTIONS | set(PRODUCTS) | FMA_OPS
#: op -> positions of its index operands (no taint flows from them)
_INDEX_ARGS = {
    "index": (1,), "_unsafe_index": (1,), "index_select": (2,), "gather": (2,),
    "take_along_dim": (1,), "embedding": (1,), "index_put": (1,), "index_put_": (1,),
    "_index_put_impl_": (1,), "scatter": (2,), "scatter_": (2,), "scatter_add": (2,),
    "scatter_add_": (2,), "scatter_reduce": (2,), "scatter_reduce_": (2,),
    "index_add": (2,), "index_add_": (2,), "index_copy": (2,), "index_copy_": (2,),
}


@dataclasses.dataclass(frozen=True)
class Operand:
    dtype: torch.dtype
    shape: tuple
    evidence: bool
    value: bool


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One op of the run: its ATen name (``sum``, ``mm``, ...), operands and
    results, and for a reduction or a product the sizes of the axes it sums
    over (``reduced``)."""

    name: str
    inputs: tuple
    outputs: tuple
    reduced: tuple = ()


@dataclasses.dataclass
class Trace:
    ops: list
    carries: list  # per iteration boundary: {carry name: dtype name or {key: dtype name}}
    outputs: Any = None


def _tensors(args, kwargs=None) -> list:
    """The tensors among an op's arguments (and in their lists)."""
    out = []
    for a in (*args, *(kwargs or {}).values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out += [t for t in a if isinstance(t, torch.Tensor)]
    return out


def _reduced_axes(name: str, args, kwargs) -> tuple:
    x = args[0]
    if name in PRODUCTS:
        return (args[PRODUCTS[name]].shape[-1],)
    dims = args[1] if len(args) > 1 else kwargs.get("dim")
    if dims is None or (isinstance(dims, (list, tuple)) and len(dims) == 0):
        return tuple(x.shape)
    dims = [dims] if isinstance(dims, int) else dims
    return tuple(x.shape[d] for d in dims) if x.dim() else ()


def _flags(t: torch.Tensor) -> tuple:
    """``(evidence, value)`` of ``t``: its taints, kept on the tensor object."""
    ev, val = getattr(t, _TAINT, (False, False))
    return ev, val or t.dtype in NARROW_FLOATS


def _operand(t: torch.Tensor) -> Operand:
    return Operand(t.dtype, tuple(t.shape), *_flags(t))


#: the attribute that holds a tensor's taints while it lives
_TAINT = "_tracelint_taint"


class _TaintMode(TorchDispatchMode):
    def __init__(self, trace: Trace):
        super().__init__()
        self.trace = trace

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if composite(func):  # under inference_mode: trace its parts
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        skip = _INDEX_ARGS.get(name, ())
        ins = _tensors(args, kwargs)
        values = ins if not skip else _tensors(
            [a for i, a in enumerate(args) if i not in skip], kwargs)
        flags = [_flags(t) for t in values]
        ev = name in COMPARISONS or any(f[0] for f in flags)
        val = any(f[1] for f in flags)
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        for t in outs:
            old = getattr(t, _TAINT, (False, False))
            setattr(t, _TAINT, (ev or old[0], val or old[1]))
        if name in _RECORDED or any(t.dtype in NARROW_FLOATS for t in outs):
            reduced = _reduced_axes(name, args, kwargs) \
                if name in REDUCTIONS or name in PRODUCTS else ()
            self.trace.ops.append(OpRecord(name, tuple(_operand(t) for t in ins),
                                           tuple(_operand(t) for t in outs), reduced))
        return out


def _dtypes(x):
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    if isinstance(x, dict):
        return {k: _dtypes(v) for k, v in x.items() if isinstance(v, torch.Tensor)}
    return None


def _loop_line(fn) -> int:
    """The line of ``fn``'s outermost ``for`` statement (the first of the
    least indented ones)."""
    lines, first = inspect.getsourcelines(fn)
    loops = [(len(line) - len(line.lstrip()), i) for i, line in enumerate(lines)
             if line.lstrip().startswith("for ")]
    if not loops:
        raise ValueError(f"{fn.__qualname__} has no for loop")
    return first + min(loops)[1]


def run_traced(fn, loop: tuple | None = None) -> Trace:
    """Run ``fn()`` once under the taint mode (see the module docstring);
    ``loop=(function, names)`` also snapshots the carries' dtypes at each of
    ``function``'s iteration boundaries."""
    trace = Trace([], [])
    prev = sys.gettrace()
    if loop is not None:
        func, names = loop
        code, line = func.__code__, _loop_line(func)

        def local(frame, event, arg):
            if event == "line" and frame.f_lineno == line:
                trace.carries.append({n: _dtypes(frame.f_locals[n]) for n in names
                                      if n in frame.f_locals})
            return local

        def calls(frame, event, arg):
            return local if event == "call" and frame.f_code is code else None

        sys.settrace(calls)
    try:
        with _TaintMode(trace):
            trace.outputs = fn()
    finally:
        if loop is not None:
            sys.settrace(prev)
    return trace
