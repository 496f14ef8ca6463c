"""The TL001, TL003 and TL004 rules, re-stated for eager torch.

Each rule is a function ``(EntryProbe) -> list[Finding]`` over the entry's
recorded run (``entry.trace``, :mod:`repro_torch.analysis.lint.trace`) and
its card checks; rules skip entries their annotations do not apply to.
TL002 and TL005 have no port rule (:mod:`repro_torch.analysis.lint.findings`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.analysis.lint.entries import EntryProbe
from repro_torch.analysis.lint.findings import Finding
from repro_torch.analysis.lint.trace import FMA_OPS, NARROW_FLOATS, PRODUCTS, REDUCTIONS

#: the event algebra's dtypes
WIDE = frozenset({torch.float64, torch.int64})


def _fmt(operand) -> str:
    return f"{str(operand.dtype).removeprefix('torch.')}{list(operand.shape)}"


def _card(entry: EntryProbe, code: str) -> list:
    return [Finding(code, entry.name, symbol, message)
            for c, check in entry.card_checks if c == code for symbol, message in check()]


def check_fma_seam(entry: EntryProbe) -> list:
    """TL001: the latency chain and the event algebra round once per operator.

    Eager torch launches one kernel per operator and contracts nothing, so
    the port needs no ``max(x, 0)`` seam; what would break the reference's
    bits is a fused op.  Three checks: the latency chain on the entry's
    device equals numpy's float64 evaluation (one rounding per operator,
    left to right) bit for bit; no fused multiply-add op of the entry's run
    touches a float64 tensor of the event algebra (a value-side operand,
    the iterate's float64 sums, is not the chain); on the card, the card
    checks (event streams, K3's and K7's outputs against the CPU run).
    """
    findings = []
    if entry.latency_probe is not None:
        fn, batches = entry.latency_probe
        for i, (host, dev) in enumerate(batches):
            unit, cost, slowdown, factor, start, comm = host
            want = start + ((unit * cost * slowdown * factor) + comm)
            got = fn(*dev).cpu().numpy()
            bad = int(np.count_nonzero(got != want))
            if bad:
                findings.append(Finding(
                    "TL001", entry.name, f"batch{i}",
                    f"the latency chain on {entry.device} differs from numpy's op-by-op "
                    f"float64 evaluation in {bad}/{want.size} elements: the §3 product "
                    f"reaches task_finish_time fused or regrouped"))
    if entry.event_algebra and entry.trace is not None:
        seen = set()
        for op in entry.trace.ops:
            if op.name not in FMA_OPS:
                continue
            chain = [o for o in op.inputs if o.dtype == torch.float64 and not o.value]
            if chain:
                symbol = f"op:{op.name}:{','.join(_fmt(o) for o in op.inputs)}"
                if symbol not in seen:
                    seen.add(symbol)
                    findings.append(Finding(
                        "TL001", entry.name, symbol,
                        f"{op.name} fuses a multiply and an add over float64 event tensors "
                        f"({', '.join(_fmt(o) for o in chain)}): one rounding where the "
                        f"reference rounds twice"))
    return findings + _card(entry, "TL001")


def check_pad_variant_reduce(entry: EntryProbe) -> list:
    """TL003: reductions over padded axes carry mask evidence.

    Every sum, mean or product of the entry's run that sums over an axis
    whose size is one of ``padded_axis_sizes`` needs an operand computed
    from a comparison (the width mask); otherwise the pad rows (clamped
    copies of real rows) enter the sum.  A hand-written kernel is opaque to
    the dispatch mode: on the card the entry's card checks hold each kernel
    to the same result at two pad widths instead.
    """
    findings = []
    if entry.padded_axis_sizes and entry.trace is not None:
        sizes = set(entry.padded_axis_sizes)
        seen = set()
        for op in entry.trace.ops:
            if op.name not in REDUCTIONS and op.name not in PRODUCTS:
                continue
            padded = [s for s in op.reduced if s in sizes]
            operands = op.inputs if op.name in PRODUCTS else op.inputs[:1]
            if not padded or any(o.evidence for o in operands):
                continue
            symbol = f"op:{op.name}:{','.join(_fmt(o) for o in op.inputs)}"
            if symbol in seen:
                continue
            seen.add(symbol)
            findings.append(Finding(
                "TL003", entry.name, symbol,
                f"{op.name} sums over a padded axis of size {padded[0]} of "
                f"{_fmt(op.inputs[0])} and no operand has mask evidence (no comparison "
                f"upstream)"))
    return findings + _card(entry, "TL003")


def check_dtype_leak(entry: EntryProbe) -> list:
    """TL004: no dtype leak.

    Torch has no weak types; its leak is promotion: an int64 tensor
    combined with a python float gives float32, and ``.float()`` or
    ``.to(float32)`` of an event tensor drops its bits.  In an
    event-algebra entry, no op may yield a float32 or narrower tensor from
    float64 or int64 operands unless one operand is value side (the
    iterate's update casts its float64 gradient to the iterate's dtype by
    design).  The loop carries (event times, cache values, the iterate) keep
    their dtypes at every iteration boundary.  A kernel's or plain
    version's outputs have the declared dtypes.
    """
    findings = []
    trace = entry.trace
    if trace is None:
        return findings
    if entry.event_algebra:
        seen = set()
        for op in trace.ops:
            narrow = [o for o in op.outputs if o.dtype in NARROW_FLOATS]
            if not narrow or any(o.value for o in op.inputs):
                continue
            wide = [o for o in op.inputs if o.dtype in WIDE]
            if not wide:
                continue
            symbol = f"op:{op.name}:{_fmt(wide[0])}->{_fmt(narrow[0])}"
            if symbol not in seen:
                seen.add(symbol)
                findings.append(Finding(
                    "TL004", entry.name, symbol,
                    f"{op.name} turns event tensor {_fmt(wide[0])} into {_fmt(narrow[0])}: "
                    f"give the python scalar or the result an explicit float64 dtype"))
    if trace.carries:
        first = trace.carries[0]
        reported = set()
        for t, snap in enumerate(trace.carries[1:], start=1):
            for name, dtype in snap.items():
                if dtype != first.get(name, dtype) and name not in reported:
                    reported.add(name)
                    findings.append(Finding(
                        "TL004", entry.name, f"carry:{name}",
                        f"loop carry {name} changed dtype from {first[name]} to {dtype} "
                        f"by iteration boundary {t}"))
    if entry.declared_output_dtypes is not None:
        outs = trace.outputs if isinstance(trace.outputs, tuple) else (trace.outputs,)
        for i, (want, got) in enumerate(zip(entry.declared_output_dtypes, outs)):
            if got.dtype != want:
                findings.append(Finding(
                    "TL004", entry.name, f"output[{i}]:{got.dtype}",
                    f"output {i} is {got.dtype}, declared {want}: a leak into the "
                    f"engine's value buffers"))
    return findings


#: rule code -> implementation, in reporting order
ALL_RULES = (
    ("TL001", check_fma_seam),
    ("TL003", check_pad_variant_reduce),
    ("TL004", check_dtype_leak),
)
