"""Latency modeling (paper §3-§4; counterpart of ``repro.latency``):
per-worker gamma comm/comp latency, bursts, Monte-Carlo order statistics,
event-driven iterative simulation, and the moving-window profiler used by
the load balancer."""

from repro_torch._exports import lazy_exports

#: the reference's public names -> the submodule that holds each
_EXPORTS = {
    "GammaParams": "model",
    "WorkerLatencyModel": "model",
    "ClusterLatencyModel": "model",
    "fit_gamma": "model",
    "make_heterogeneous_cluster": "model",
    "make_paper_artificial_cluster": "model",
    "predict_order_statistic": "order_stats",
    "predict_order_statistics_iid": "order_stats",
    "empirical_order_statistic": "order_stats",
    "EventDrivenSimulator": "event_sim",
    "simulate_iteration_times": "event_sim",
    "LatencyProfiler": "profiler",
    "LatencySample": "profiler",
}
__all__ = list(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
