"""Spans from the benchmark's own wrappers, and the reduction of a profiler
trace to device operations, busy time and idle gaps.

A span is a host interval (``time.perf_counter``) around one call into the
program, kept in memory; while the profiler labels a step it is also a
``record_function`` range named ``perfbench.<span>``, so the trace can tell
what the host was doing when the device went idle.  :func:`device_ops` and
:func:`idle_gaps` read the profiler's events once (no per-op tables).
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from collections import defaultdict

import torch

from harness import yardstick

PREFIX = "perfbench."


class Spans:
    """Named host intervals, each flagged when it fell in a profiled
    stretch; ``labels`` turns the ``record_function`` ranges on."""

    def __init__(self):
        self.items: dict[str, list[tuple[float, float, bool]]] = defaultdict(list)
        self.profiling = False
        self.labels = False

    def wrap(self, name: str, fn):
        def span(*args, **kwargs):
            rf = torch.profiler.record_function(PREFIX + name) if self.labels else None
            if rf is not None:
                rf.__enter__()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                t1 = time.perf_counter()
                if rf is not None:
                    rf.__exit__(None, None, None)
                self.items[name].append((t0, t1, self.profiling))

        return span

    def durations(self, name: str) -> list[float]:
        """Seconds of each ``name`` span outside the profiled stretches."""
        return [t1 - t0 for t0, t1, profiled in self.items.get(name, ()) if not profiled]


@dataclasses.dataclass
class Profile:
    """The profiled stretches of a window: the device's operations over
    ``steps`` steps traced with the device's activity alone (the host runs
    as it does untraced), and the device's idle time by what the host was
    doing over one more step traced with the host's operators too."""

    stretch_ns: int  # the device stretch, on the host's clock
    steps: int
    ops: list[tuple[str, int, int]]  # name, start, end (ns)
    idle_by_host: dict[str, int]  # host label -> idle ns in the labelled step
    label_ns: int  # the labelled step's length

    @property
    def busy_ns(self) -> int:
        return yardstick.union_ns((s, e) for _, s, e in self.ops)

    def kernels(self) -> list[tuple[str, int, int]]:
        return [op for op in self.ops if not op[0].startswith(("Memcpy", "Memset"))]

    def time_by_name(self) -> dict[str, int]:
        out: dict[str, int] = defaultdict(int)
        for name, s, e in self.ops:
            out[name] += e - s
        return out


def _events(prof):
    """``(on device, name, start_ns, end_ns, id, linked id)`` of every event
    of the profiler's kineto results (a device op's linked id is the id of
    the host op that launched it)."""
    from torch.autograd import DeviceType

    return [(e.device_type() != DeviceType.CPU, e.name(), e.start_ns(), e.end_ns(),
             e.correlation_id(), e.linked_correlation_id())
            for e in prof.profiler.kineto_results.events()]


def device_ops(prof) -> list[tuple[str, int, int]]:
    """Every device operation of ``prof``, in order of start."""
    return sorted(((name, s, e) for dev, name, s, e, *_ in _events(prof) if dev),
                  key=lambda op: op[1])


def idle_gaps(prof) -> tuple[int, dict[str, int]]:
    """``(length, idle ns by host label)`` of the ``perfbench.stretch``
    range of ``prof``: each gap in which the device ran nothing is labelled
    by the span the host was in and the host op that launched the device
    op ending the gap."""
    events = _events(prof)
    stretch = [(s, e) for dev, name, s, e, *_ in events
               if not dev and name == PREFIX + "stretch"]
    if not stretch:
        raise RuntimeError("the trace holds no perfbench.stretch range")
    lo, hi = stretch[0]
    ops, ops_by_id, spans = [], {}, []
    for dev, name, s, e, cid, linked in events:
        if dev:
            if not name.startswith(PREFIX) and e > lo and s < hi:
                ops.append((name, max(s, lo), min(e, hi), linked))
        elif name.startswith(PREFIX):
            if name != PREFIX + "stretch":
                spans.append((s, e, name[len(PREFIX):]))
        else:
            ops_by_id[cid] = name
    ops.sort(key=lambda op: op[1])
    spans.sort()
    starts = [s for s, _, _ in spans]
    idle: dict[str, int] = defaultdict(int)
    reach = lo
    for _, s, e, linked in ops:
        if s > reach:
            i = bisect.bisect_right(starts, s) - 1
            span = spans[i][2] if i >= 0 and spans[i][1] >= s else "loop"
            idle[f"{span}: {ops_by_id.get(linked, 'no host op')}"] += s - reach
        reach = max(reach, e)
    if hi > reach:
        idle["end of stretch"] += hi - reach
    return hi - lo, dict(idle)
