"""The TL001–TL005 rules, re-stated for eager torch.

Each rule is a function ``(EntryProbe) -> list[Finding]`` over the entry's
recorded run (``entry.trace``, :mod:`repro_torch.analysis.lint.trace`) and
its card checks; rules skip entries their annotations do not apply to.
TL002 and TL005 read the ops run inside an entry's audited loop (its
``region``: the tiled §6 cache's per-rank walk).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.analysis.lint.entries import EntryProbe
from repro_torch.analysis.lint.findings import Finding
from repro_torch.analysis.lint.trace import (
    COPY_OPS,
    FMA_OPS,
    NARROW_FLOATS,
    PRODUCTS,
    REDUCTIONS,
    SYNC_OPS,
)

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


def _loop_findings(entry: EntryProbe, code: str, hit) -> list:
    """One finding per distinct ``hit(op)`` symbol among the ops inside the
    entry's audited loop."""
    if entry.trace is None or entry.region is None:
        return []
    findings, seen = [], set()
    for op in entry.trace.ops:
        if not op.in_loop:
            continue
        found = hit(op)
        if found and found[0] not in seen:
            seen.add(found[0])
            findings.append(Finding(code, entry.name, *found))
    return findings


def check_carry_copy(entry: EntryProbe) -> list:
    """TL002: the large tables are not copied inside the per-rank loop.

    The reference's cliff was XLA copying a scatter-updated loop carry once
    per trip; eager torch copies only when told to, so the eager form is a
    ``clone``, a ``.to``/``.contiguous`` copy or a ``copy_`` out of one of
    the loop's large tables (the §5 value table, the tiled cache's entry
    tables, or a view of them) inside the loop.  Live values are read from
    the frozen loop-entry table and the ranked event rows instead
    (``fused._apply_cache_events_tiled``)."""

    def hit(op):
        if op.name not in COPY_OPS:
            return None
        src = op.inputs[1:2] if op.name == "copy_" else op.inputs[:1]
        tables = [o for o in src if o.table]
        if not tables:
            return None
        return (f"op:{op.name}:{_fmt(tables[0])}",
                f"{op.name} copies the loop's table {_fmt(tables[0])} once per rank: read "
                f"the live values from the frozen table and the ranked event rows")

    return _loop_findings(entry, "TL002", hit)


def check_cond_capture(entry: EntryProbe) -> list:
    """TL005: no host synchronisation inside the per-rank loop.

    The reference's cliff was a ``lax.cond`` deep in the rank loop copying
    its captures on every trip.  Eager torch's counterpart of a per-trip
    stall is the host waiting for the device: ``.item()``/``int()``/``bool()``
    of a tensor (``_local_scalar_dense``), an op whose result's size depends
    on the data (``nonzero``, ``masked_select``, ``unique``), or a copy from
    the card to the host, once per rank.  A loop's trip count is read once,
    before the loop."""

    def hit(op):
        d2h = op.name in ("_to_copy", "copy_") and any(o.device == "cuda" for o in op.inputs) \
            and any(o.device == "cpu" for o in op.outputs + op.inputs[:1])
        if op.name not in SYNC_OPS and not d2h:
            return None
        what = ", ".join(_fmt(o) for o in op.inputs[:1])
        return (f"op:{op.name}:{what}",
                f"{op.name} of {what} makes the host wait for the device once per rank")

    return _loop_findings(entry, "TL005", hit)


#: rule code -> implementation, in reporting order
ALL_RULES = (
    ("TL001", check_fma_seam),
    ("TL002", check_carry_copy),
    ("TL003", check_pad_variant_reduce),
    ("TL004", check_dtype_leak),
    ("TL005", check_cond_capture),
)
