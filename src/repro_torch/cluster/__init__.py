"""Simulated distributed cluster (Tier 3; counterpart of ``repro.cluster``):
the paper's coordinator/worker protocol run in event time over the §3
latency model, with every subgradient computed by the problem's kernels."""

from repro_torch._exports import lazy_exports

#: the reference's public names -> the submodule that holds each
_EXPORTS = {
    "LatencySource": "simulator",
    "MethodConfig": "simulator",
    "ModelLatencySource": "simulator",
    "RunHistory": "simulator",
    "TraceLatencySource": "simulator",
    "TrainingSimulator": "simulator",
}
__all__ = list(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
