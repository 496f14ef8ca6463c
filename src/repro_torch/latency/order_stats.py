"""Order-statistic latency prediction (paper §4.1), copied from
``repro.latency.order_stats`` (numpy).

Predict the latency of the ``w``-th fastest worker out of ``N`` via Monte
Carlo integration: draw one latency per worker per trial and select the
``w``-th smallest (``np.partition`` — linear-time selection, the numpy
analogue of Quickselect).  Also provides the commonly-adopted-but-wrong
i.i.d. predictor (global mean/variance pooled across workers) that the paper
shows mispredicts badly (Fig. 5).
"""

from __future__ import annotations

import numpy as np

from repro_torch.latency.model import ClusterLatencyModel, GammaParams


def predict_order_statistic(
    cluster: ClusterLatencyModel,
    w: int,
    c: float,
    *,
    num_trials: int = 1000,
    seed: int = 0,
) -> float:
    """E[latency of the w-th fastest of N workers], Monte Carlo, non-iid."""
    if not (1 <= w <= cluster.num_workers):
        raise ValueError(f"w={w} out of range 1..{cluster.num_workers}")
    rng = np.random.default_rng(seed)
    n = cluster.num_workers
    comm_shape = np.array([wk.comm.shape for wk in cluster.workers])
    comm_scale = np.array([wk.comm.scale for wk in cluster.workers])
    comp_shape = np.array([wk.comp_per_unit.shape for wk in cluster.workers])
    comp_scale = np.array([wk.comp_per_unit.scale for wk in cluster.workers])
    slow = np.array([wk.slowdown for wk in cluster.workers])
    # vectorised over (trials, workers); bursts excluded (steady state, §4.1)
    y = rng.gamma(comm_shape, comm_scale, size=(num_trials, n))
    z = rng.gamma(comp_shape, comp_scale, size=(num_trials, n)) * c * slow
    total = y + z
    kth = np.partition(total, w - 1, axis=1)[:, w - 1]
    return float(kth.mean())


def predict_order_statistics_all(
    cluster: ClusterLatencyModel,
    c: float,
    *,
    num_trials: int = 1000,
    seed: int = 0,
) -> np.ndarray:
    """E[latency of w-th fastest] for every w=1..N in one pass."""
    rng = np.random.default_rng(seed)
    n = cluster.num_workers
    comm_shape = np.array([wk.comm.shape for wk in cluster.workers])
    comm_scale = np.array([wk.comm.scale for wk in cluster.workers])
    comp_shape = np.array([wk.comp_per_unit.shape for wk in cluster.workers])
    comp_scale = np.array([wk.comp_per_unit.scale for wk in cluster.workers])
    slow = np.array([wk.slowdown for wk in cluster.workers])
    y = rng.gamma(comm_shape, comm_scale, size=(num_trials, n))
    z = rng.gamma(comp_shape, comp_scale, size=(num_trials, n)) * c * slow
    return np.sort(y + z, axis=1).mean(axis=0)


def predict_order_statistics_iid(
    cluster: ClusterLatencyModel,
    c: float,
    *,
    num_trials: int = 1000,
    seed: int = 0,
) -> np.ndarray:
    """The i.i.d. baseline predictor (paper Fig. 5): every worker is modeled
    by a single gamma with the *pooled* mean and variance."""
    rng = np.random.default_rng(seed)
    n = cluster.num_workers
    # pooled moments of the total latency across workers
    means = np.array([wk.comm.mean + wk.comp_per_unit.mean * c * wk.slowdown
                      for wk in cluster.workers])
    vars_ = np.array([wk.comm.var + wk.comp_per_unit.var * (c * wk.slowdown) ** 2
                      for wk in cluster.workers])
    pooled_mean = means.mean()
    # law of total variance: within-worker + between-worker
    pooled_var = vars_.mean() + means.var()
    g = GammaParams.from_mean_var(pooled_mean, pooled_var)
    total = rng.gamma(g.shape, g.scale, size=(num_trials, n))
    return np.sort(total, axis=1).mean(axis=0)


def empirical_order_statistic(latency_matrix: np.ndarray) -> np.ndarray:
    """Empirical E[w-th order statistic] from an [iters, N] latency matrix."""
    return np.sort(latency_matrix, axis=1).mean(axis=0)
