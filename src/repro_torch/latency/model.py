"""Per-worker latency model (paper §3), copied from ``repro.latency.model``.

The latency of worker ``i`` for an iteration with computational load ``c`` is
``X_i = Y_i + Z_i`` with independent, non-identically distributed gamma
communication (``Y_i``) and per-unit-load computation (``Z_i``) terms, plus
multiplicative bursts (§3.2) that arrive as a Poisson process and last an
exponentially distributed time.

Everything here is numpy: the traces are drawn on the host with
``np.random.default_rng`` and handed to the device engine as tensors.  The
samplers are copied verbatim from the JAX package so that the same seed gives
the same arrays in both packages (pinned by ``tests/test_torch_parity.py``);
this package must not import the JAX one, not even its numpy-only modules.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Sequence

import numpy as np


def comp_latency_expr(comp_unit_draw, load, slowdown, factor):
    """THE §3 computation-latency expression: ``unit * load * slowdown * factor``.

    The multiplication order is load-bearing for exact replay: evaluated left
    to right, one rounding per product, by numpy here and by eager torch in
    :mod:`repro_torch.experiments.fused`.
    """
    return comp_unit_draw * load * slowdown * factor


@dataclasses.dataclass(frozen=True)
class GammaParams:
    """Gamma distribution parameterised by (shape, scale).

    Paper footnote 12: a gamma r.v. with mean ``e`` and variance ``v`` has
    shape ``e^2/v`` and scale ``v/e``.
    """

    shape: float
    scale: float

    @staticmethod
    def from_mean_var(mean: float, var: float) -> GammaParams:
        if mean <= 0:
            raise ValueError(f"gamma mean must be positive, got {mean}")
        var = max(var, 1e-18)  # degenerate -> near-deterministic
        return GammaParams(shape=mean * mean / var, scale=var / mean)

    @property
    def mean(self) -> float:
        return self.shape * self.scale

    @property
    def var(self) -> float:
        return self.shape * self.scale**2

    def sample(self, rng: np.random.Generator, size=None) -> np.ndarray:
        return rng.gamma(self.shape, self.scale, size=size)


def fit_gamma(samples: Sequence[float]) -> GammaParams:
    """Method-of-moments gamma fit (what the profiler/optimizer use)."""
    arr = np.asarray(samples, dtype=np.float64)
    if arr.size == 0:
        raise ValueError("cannot fit gamma to zero samples")
    mean = float(arr.mean())
    var = float(arr.var()) if arr.size > 1 else 1e-12
    return GammaParams.from_mean_var(mean, max(var, 1e-18))


@dataclasses.dataclass
class BurstState:
    """Multiplicative latency burst (paper §3.2 / Fig. 4)."""

    active: bool = False
    factor: float = 1.0
    ends_at: float = 0.0


@dataclasses.dataclass
class WorkerLatencyModel:
    """Latency model of one worker.

    ``comm`` models Y_i; ``comp_per_unit`` models Z_i per unit of
    computational load, so a load ``c`` has mean ``c * shape * scale`` of
    ``comp_per_unit`` (paper Fig. 1).  :func:`sample_fleet` draws whole
    trace grids from the parameters; :meth:`sample_total` is the scalar
    sampler with the lazily thinned burst process, which the live trainer's
    straggler simulation draws from (``ClusterLatencyModel.sample_all``).
    """

    comm: GammaParams
    comp_per_unit: GammaParams
    burst_rate: float = 0.0  # bursts per second (Poisson)
    burst_factor_mean: float = 1.12  # paper Fig. 4: ~12% slowdown
    burst_duration_mean: float = 60.0  # paper Fig. 4: ~1 minute
    # artificial *persistent* slowdown (paper §7.2 artificial scenario)
    slowdown: float = 1.0

    _burst: BurstState = dataclasses.field(default_factory=BurstState)

    # -- burst process --------------------------------------------------
    def _start_burst(self, now: float, rng: np.random.Generator) -> float:
        factor = 1.0 + rng.exponential(self.burst_factor_mean - 1.0)
        self._burst = BurstState(
            active=True,
            factor=factor,
            ends_at=now + rng.exponential(self.burst_duration_mean),
        )
        return factor

    def _burst_factor(self, now: float, rng: np.random.Generator) -> float:
        if self._burst.active:
            if now >= self._burst.ends_at:
                # the idle-gap clock restarts when the burst ends
                self._last_query_t = self._burst.ends_at
                self._burst = BurstState()
            else:
                return self._burst.factor
        if self.burst_rate > 0.0:
            last = getattr(self, "_last_query_t", None)
            if last is None:
                # stationary start: the fleet was running long before t=0, so
                # a worker is mid-burst with probability dur/(idle+dur); the
                # residual duration is again exponential (memorylessness)
                self._last_query_t = now
                lam_m = self.burst_rate * self.burst_duration_mean
                if rng.random() < lam_m / (1.0 + lam_m):
                    return self._start_burst(now, rng)
                return 1.0
            # burst arrivals sampled lazily at query time by thinning the
            # Poisson process over the elapsed idle gap (memorylessness)
            p_start = 1.0 - math.exp(-self.burst_rate * max(now - last, 0.0))
            self._last_query_t = now
            if rng.random() < p_start:
                return self._start_burst(now, rng)
        return 1.0

    # -- sampling --------------------------------------------------------
    def sample_comm(self, rng: np.random.Generator) -> float:
        return float(self.comm.sample(rng))

    def sample_comp(self, c: float, rng: np.random.Generator, now: float = 0.0) -> float:
        base = float(self.comp_per_unit.sample(rng)) * c
        return base * self.slowdown * self._burst_factor(now, rng)

    def sample_total(self, c: float, rng: np.random.Generator, now: float = 0.0) -> float:
        return self.sample_comm(rng) + self.sample_comp(c, rng, now)

    def mean_total(self, c: float) -> float:
        """Expected total latency at load ``c`` (the §6.2 e'_{X,i})."""
        return self.comm.mean + self.comp_per_unit.mean * c * self.slowdown


@dataclasses.dataclass
class ClusterLatencyModel:
    """A set of per-worker latency models (non-i.i.d. across workers)."""

    workers: list  # list[WorkerLatencyModel]
    seed: int = 0

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)

    @property
    def num_workers(self) -> int:
        return len(self.workers)

    def sample_all(self, c: float, now: float = 0.0) -> np.ndarray:
        """One latency draw per worker for a single iteration."""
        return np.array(
            [w.sample_total(c, self.rng, now) for w in self.workers], dtype=np.float64
        )

    def sample_matrix(self, c: float, iters: int) -> np.ndarray:
        """[iters, N] latency draws (steady state, no cross-iteration state)."""
        return np.stack([self.sample_all(c) for _ in range(iters)])


#: Approximate latency ranges from paper Table 1 (AWS logistic regression):
#: comm 1e-4..6e-4 s, comp 1.1e-3..1.3e-3 s.
AWS_LOGREG_COMM = (1e-4, 6e-4)
AWS_LOGREG_COMP = (1.1e-3, 1.3e-3)


def make_heterogeneous_cluster(
    num_workers: int,
    *,
    comm_range=AWS_LOGREG_COMM,
    comp_range=AWS_LOGREG_COMP,
    load_unit: float = 1.0,
    cv_comm: float = 0.35,
    cv_comp: float = 0.15,
    burst_rate: float = 1.0 / 90.0,
    seed: int = 0,
) -> ClusterLatencyModel:
    """Cluster with per-worker means drawn uniformly from the paper's measured
    ranges and fixed coefficients of variation — independent but NOT
    identically distributed workers (the paper's central modeling point)."""
    rng = np.random.default_rng(seed)
    workers = []
    for _ in range(num_workers):
        e_y = rng.uniform(*comm_range)
        e_z = rng.uniform(*comp_range) / load_unit  # per unit load
        workers.append(
            WorkerLatencyModel(
                comm=GammaParams.from_mean_var(e_y, (cv_comm * e_y) ** 2),
                comp_per_unit=GammaParams.from_mean_var(e_z, (cv_comp * e_z) ** 2),
                burst_rate=burst_rate,
            )
        )
    return ClusterLatencyModel(workers=workers, seed=seed + 1)


def make_paper_artificial_cluster(
    num_workers: int = 49,
    *,
    comp_mean: float = 2.0e-3,
    comm_mean: float = 1.0e-5,
    cv_comm: float = 0.3,
    cv_comp: float = 0.1,
    load_unit: float = 1.0,
    seed: int = 0,
) -> ClusterLatencyModel:
    """The paper's §7.2 artificial scenario on eX3: worker ``i`` (1-based) is
    slowed by a factor ``1 + (i/N)*0.4``; a timed event of the scalar
    ``TrainingSimulator`` (:func:`clear_slowdowns`) removes the slowdown of
    the last 10 workers after 1 s.

    ``load_unit`` calibrates the model: a task with computational load
    ``c = load_unit`` has expected computation latency ``comp_mean`` (the
    paper's Table-1 eX3 values) — pass the typical per-task ops count."""
    e_z = comp_mean / load_unit
    workers = [
        WorkerLatencyModel(
            comm=GammaParams.from_mean_var(comm_mean, (cv_comm * comm_mean) ** 2),
            comp_per_unit=GammaParams.from_mean_var(e_z, (cv_comp * e_z) ** 2),
            burst_rate=0.0,
            slowdown=1.0 + (i / num_workers) * 0.4,
        )
        for i in range(1, num_workers + 1)
    ]
    return ClusterLatencyModel(workers=workers, seed=seed + 1)


def clear_slowdowns(cluster: ClusterLatencyModel, worker_indices) -> None:
    """Remove the artificial slowdown of the given workers (paper §7.2:
    'we remove this artificial latency for workers 40 through 49 after one
    second')."""
    for i in worker_indices:
        cluster.workers[i].slowdown = 1.0


@dataclasses.dataclass
class ChurnSchedule:
    """Piecewise-constant fleet state over time: slowdowns and liveness.

    ``times`` ([C], strictly increasing, all > 0) are the change boundaries,
    shared across scenarios; row ``r`` of ``slowdown`` / ``alive``
    ([C+1, N]) applies on ``[times[r-1], times[r])`` (row 0 before the
    first boundary).  When a :class:`FleetTraces` carries a schedule, its
    slowdown rows replace the static ``traces.slowdown`` field, looked up at
    each task's start time (the burst factor's query time).

    Liveness is sampled once per iteration at assignment time: a worker
    dead at the iteration's assignment discards any in-flight task (no
    stale completion, no cache write, no profiler sample, no latency
    attribution), starts nothing, consumes no draws, and has its §5 cache
    entries cleared; the wait-for-w order statistic uses
    ``w_eff = min(w, #alive)``.  A revived or late-joining worker re-enters
    idle with empty cache slots at its next assignment.  Every row must keep
    at least one worker alive.  Every engine of this package replays it (the
    scalar simulator, the host engine, the device engine, the batched
    sweeps) and so does the live trainer's controller.

    A trivial schedule (:meth:`static`) gathers the same float64 slowdowns
    through the same :func:`comp_latency_expr`, so its replay is bit for bit
    the replay without a schedule.
    """

    times: np.ndarray  # [C] float64, strictly increasing, > 0
    slowdown: np.ndarray  # [C+1, N] float64
    alive: np.ndarray  # [C+1, N] bool

    def __post_init__(self):
        self.times = np.asarray(self.times, dtype=np.float64).reshape(-1)
        self.slowdown = np.asarray(self.slowdown, dtype=np.float64)
        self.alive = np.asarray(self.alive, dtype=bool)
        C = self.times.shape[0]
        if self.slowdown.ndim != 2 or self.alive.shape != self.slowdown.shape:
            raise ValueError(
                "slowdown and alive must both be [C+1, N] with matching shapes"
            )
        if self.slowdown.shape[0] != C + 1:
            raise ValueError(
                f"{C} boundaries need {C + 1} state rows, "
                f"got {self.slowdown.shape[0]}"
            )
        if C and (not np.all(np.diff(self.times) > 0) or self.times[0] <= 0.0):
            raise ValueError("churn times must be strictly increasing and > 0")
        if not np.all(np.isfinite(self.slowdown)) or np.any(self.slowdown <= 0):
            raise ValueError("churn slowdowns must be finite and > 0")
        if not np.all(self.alive.any(axis=1)):
            raise ValueError("every churn row must keep at least one worker alive")

    @property
    def num_workers(self) -> int:
        return self.slowdown.shape[1]

    @classmethod
    def static(cls, slowdown) -> ChurnSchedule:
        """The trivial all-alive schedule replaying a static slowdown field."""
        sd = np.asarray(slowdown, dtype=np.float64).reshape(1, -1)
        return cls(
            times=np.zeros(0), slowdown=sd, alive=np.ones_like(sd, dtype=bool)
        )

    def row_at(self, t):
        """Row index active at time(s) ``t`` (scalar or array)."""
        return np.searchsorted(self.times, t, side="right")

    def alive_at(self, t) -> np.ndarray:
        """Liveness row(s) at time(s) ``t`` (scalar -> [N], [S] -> [S, N])."""
        return self.alive[self.row_at(t)]

    def slowdown_at(self, start: np.ndarray) -> np.ndarray:
        """Per-task slowdown at start times ``start`` ([S, N] -> [S, N])."""
        rows = self.row_at(np.asarray(start, dtype=np.float64))
        return self.slowdown[rows, np.arange(self.slowdown.shape[1])[None, :]]

    def boundary_before(self, row) -> np.ndarray:
        """Time of the boundary that opened ``row`` (-inf for row 0): the
        ``since`` cutoff from which the §6 profiler re-reads its window after
        a fleet change (samples of the previous fleet state are left out)."""
        padded = np.concatenate(([-np.inf], self.times))
        return padded[np.asarray(row)]


@dataclasses.dataclass(frozen=True)
class SlowdownRemoval:
    """The §7.2 timed event: clear some workers' slowdown at ``time``.

    Callable on a :class:`ClusterLatencyModel` (live sampling), and folded
    into a :class:`ChurnSchedule` by :func:`churn_from_removals` (trace
    replay): that fold is how the scalar ``TrainingSimulator`` replays the
    paper's artificial-slowdown scenario from pre-sampled traces.
    """

    time: float
    workers: tuple  # 0-based worker indices

    def __call__(self, cluster: ClusterLatencyModel) -> None:
        clear_slowdowns(cluster, self.workers)


def churn_from_removals(slowdown: np.ndarray,
                        removals: Sequence[SlowdownRemoval]) -> ChurnSchedule:
    """The churn schedule equivalent to applying ``removals`` to a fleet
    with static per-worker ``slowdown`` (all workers alive)."""
    sd = np.asarray(slowdown, dtype=np.float64)
    events = sorted(removals, key=lambda e: e.time)
    rows = [sd.copy()]
    for ev in events:
        nxt = rows[-1].copy()
        nxt[list(ev.workers)] = 1.0
        rows.append(nxt)
    sd_rows = np.stack(rows)
    return ChurnSchedule(times=np.array([e.time for e in events], dtype=np.float64),
                         slowdown=sd_rows, alive=np.ones_like(sd_rows, dtype=bool))


def paper_artificial_churn(num_workers: int = 49, *, remove_at: float = 60.0,
                           num_removed: int = 10) -> ChurnSchedule:
    """The §7.2 artificial scenario as a churn schedule: worker ``i``
    (1-based) slowed by ``1 + (i/N)*0.4``, the last ``num_removed`` workers'
    slowdown removed at ``remove_at`` (the paper: after one minute)."""
    sd = 1.0 + (np.arange(1, num_workers + 1) / num_workers) * 0.4
    removal = SlowdownRemoval(time=remove_at,
                              workers=tuple(range(num_workers - num_removed, num_workers)))
    return churn_from_removals(sd, [removal])


@dataclasses.dataclass
class FleetTraces:
    """Pre-sampled latency traces for a whole (scenario x worker x task) grid.

    ``comm[s, i, k]`` / ``comp_unit[s, i, k]`` hold the k-th communication /
    per-unit-load computation draw of worker ``i`` in scenario ``s``; a
    worker consumes its draws sequentially, one per *started* task.  Bursts
    are non-overlapping multiplicative windows per (scenario, worker).
    """

    comm: np.ndarray  # [S, N, K] float64
    comp_unit: np.ndarray  # [S, N, K] float64, per unit computational load
    slowdown: np.ndarray  # [N] persistent per-worker slowdown factors
    burst_start: np.ndarray  # [S, N, M] (M == 0 when burst-free)
    burst_end: np.ndarray  # [S, N, M]
    burst_factor: np.ndarray  # [S, N, M]
    seed: int = 0
    churn: ChurnSchedule | None = None

    @property
    def num_scenarios(self) -> int:
        return self.comm.shape[0]

    @property
    def num_workers(self) -> int:
        return self.comm.shape[1]

    @property
    def horizon(self) -> int:
        return self.comm.shape[2]

    @property
    def has_bursts(self) -> bool:
        return self.burst_start.shape[2] > 0

    def with_churn(self, churn: ChurnSchedule | None) -> FleetTraces:
        """Copy of these traces carrying ``churn`` (None clears it)."""
        if churn is not None and churn.num_workers != self.num_workers:
            raise ValueError(
                f"churn schedule has {churn.num_workers} workers "
                f"but the traces have {self.num_workers}"
            )
        return dataclasses.replace(self, churn=churn)

    def burst_factor_at(self, t: np.ndarray) -> np.ndarray:
        """Active burst factor at times ``t`` ([S, N] -> [S, N])."""
        if not self.has_bursts:
            return np.ones_like(t, dtype=np.float64)
        tt = np.asarray(t, dtype=np.float64)[:, :, None]
        active = (self.burst_start <= tt) & (tt < self.burst_end)
        # windows are non-overlapping, so at most one factor is selected
        return np.where(active, self.burst_factor, 1.0).max(axis=2)

    def _scalar_burst_factor(self, s: int, i: int, t: float) -> float:
        """Same lookup as :meth:`burst_factor_at` for one (scenario, worker)."""
        if not self.has_bursts:
            return 1.0
        starts = self.burst_start[s, i]
        idx = int(np.searchsorted(starts, t, side="right")) - 1
        if idx >= 0 and t < self.burst_end[s, i, idx]:
            return float(self.burst_factor[s, i, idx])
        return 1.0

    def task_latency_parts(self, k: np.ndarray, start: np.ndarray, loads) -> tuple:
        """(comm, comp) latency of each worker's next task across scenarios.

        ``k`` [S, N] is the per-(scenario, worker) draw index, ``start``
        [S, N] the task start time, ``loads`` a scalar / [N] / [S, N]
        computational load.  The product goes through
        :func:`comp_latency_expr`, as in :meth:`scalar_task_latency`, so the
        batched and scalar replays agree bit for bit.
        """
        S, N, K = self.comm.shape
        k = np.asarray(k)
        if k.size and int(k.max()) >= K:
            # same invariant as scalar_task_latency: silently reusing the
            # last draw would fake a deterministic worker
            raise ValueError(
                f"trace draws exhausted (draw {int(k.max())} of horizon {K}); "
                "sample a longer fleet"
            )
        s_idx = np.arange(S)[:, None]
        n_idx = np.arange(N)[None, :]
        factor = self.burst_factor_at(start)
        slowdown = (
            self.slowdown[None, :] if self.churn is None else self.churn.slowdown_at(start)
        )
        comp = comp_latency_expr(
            self.comp_unit[s_idx, n_idx, k],
            np.asarray(loads, dtype=np.float64),
            slowdown,
            factor,
        )
        return self.comm[s_idx, n_idx, k], comp

    def task_latency(self, k: np.ndarray, start: np.ndarray, loads) -> np.ndarray:
        """Total latency (comm + comp) of each worker's next task."""
        comm, comp = self.task_latency_parts(k, start, loads)
        return comm + comp

    def scalar_task_latency(
        self, scenario: int, worker: int, k: int, start: float, load: float
    ) -> tuple:
        """(comm, comp) of the ``k``-th draw of one worker, started at ``start``.

        The scalar replay the live trainer's controller consumes
        (``ft.validation.trace_latency_fn``); the product goes through
        :func:`comp_latency_expr`, as every replay path does.  Raises when a
        worker's draw stream is exhausted; silently reusing the last draw
        would fake a deterministic worker.
        """
        if k >= self.horizon:
            raise ValueError(
                f"trace draws exhausted for worker {worker} "
                f"(horizon {self.horizon}); sample a longer fleet"
            )
        factor = self._scalar_burst_factor(scenario, worker, start)
        if self.churn is None:
            slowdown = self.slowdown[worker]
        else:
            slowdown = self.churn.slowdown[int(self.churn.row_at(start)), worker]
        comp = comp_latency_expr(
            self.comp_unit[scenario, worker, k], load, slowdown, factor
        )
        return self.comm[scenario, worker, k], comp

    def scalar_latency_provider(self, scenario: int, loads):
        """A ``(worker, start_time) -> latency`` closure consuming this
        scenario's draws in per-worker order — plug into
        :class:`~repro_torch.latency.event_sim.EventDrivenSimulator` to
        replay a pre-sampled trace through the scalar event loop."""
        if np.ndim(loads) <= 1:
            loads_arr = np.broadcast_to(
                np.asarray(loads, dtype=np.float64), (self.num_workers,)
            ).copy()
        else:
            loads_arr = np.asarray(loads[scenario], dtype=np.float64)
        counters = np.zeros(self.num_workers, dtype=np.int64)

        def provider(i: int, start: float) -> float:
            k = int(counters[i])
            counters[i] += 1
            comm, comp = self.scalar_task_latency(scenario, i, k, start, loads_arr[i])
            return comm + comp

        return provider


def sample_fleet(
    cluster: ClusterLatencyModel,
    n_scenarios: int,
    horizon: int,
    *,
    burst_rate: float | None = None,
    burst_factor_mean: float | None = None,
    burst_duration_mean: float | None = None,
    time_horizon: float | None = None,
    load_hint: float = 1.0,
    max_bursts: int = 4096,
    seed: int = 0,
) -> FleetTraces:
    """Draw the full (scenario x worker x task) latency grid at once.

    Vectorizes the §3 gamma model and the §3.2 burst process over
    ``n_scenarios`` independent scenarios and ``horizon`` tasks per worker.
    The ``burst_*`` keywords override the cluster's burst parameters
    uniformly (how the sweep realizes burst *regimes*).  ``time_horizon``
    bounds the burst renewal process in simulated seconds; if omitted it is
    twice the expected makespan of ``horizon`` tasks of load ``load_hint`` on
    the slowest worker.
    """
    N = cluster.num_workers
    rng = np.random.default_rng(seed)
    shape_c = np.array([w.comm.shape for w in cluster.workers])
    scale_c = np.array([w.comm.scale for w in cluster.workers])
    shape_z = np.array([w.comp_per_unit.shape for w in cluster.workers])
    scale_z = np.array([w.comp_per_unit.scale for w in cluster.workers])
    slowdown = np.array([w.slowdown for w in cluster.workers], dtype=np.float64)

    comm = rng.gamma(shape_c[None, :, None], scale_c[None, :, None],
                     size=(n_scenarios, N, horizon))
    comp_unit = rng.gamma(shape_z[None, :, None], scale_z[None, :, None],
                          size=(n_scenarios, N, horizon))

    rates = np.array(
        [burst_rate if burst_rate is not None else w.burst_rate for w in cluster.workers],
        dtype=np.float64,
    )
    f_means = np.array(
        [
            burst_factor_mean if burst_factor_mean is not None else w.burst_factor_mean
            for w in cluster.workers
        ],
        dtype=np.float64,
    )
    d_means = np.array(
        [
            burst_duration_mean
            if burst_duration_mean is not None
            else w.burst_duration_mean
            for w in cluster.workers
        ],
        dtype=np.float64,
    )

    if np.all(rates <= 0.0):
        empty = np.zeros((n_scenarios, N, 0))
        return FleetTraces(comm, comp_unit, slowdown, empty, empty.copy(),
                           empty.copy(), seed=seed)

    if time_horizon is None:
        per_task = np.max(
            (shape_c * scale_c) + (shape_z * scale_z) * load_hint * slowdown
        )
        # bursts inflate the realized makespan; without accounting for the
        # duty cycle a high-duty regime would outrun its sampled windows
        duty = (rates * d_means) / (1.0 + rates * d_means)
        inflation = 1.0 + float(np.max(duty * (f_means - 1.0)))
        time_horizon = 2.0 * horizon * float(per_task) * inflation
    max_rate = float(np.max(rates))
    mean_cycle = 1.0 / max_rate + float(np.min(d_means))
    M = int(math.ceil(1.5 * time_horizon / mean_cycle) + 6)
    if M > max_bursts:
        raise ValueError(
            f"{M} burst windows needed to cover time_horizon={time_horizon:g} "
            f"but max_bursts={max_bursts}; raise max_bursts or pass a smaller "
            "time_horizon"
        )

    safe_scale = np.where(rates > 0.0, 1.0 / np.maximum(rates, 1e-30), 1.0)
    gaps = rng.exponential(safe_scale[None, :, None], size=(n_scenarios, N, M))
    gaps = np.where(rates[None, :, None] > 0.0, gaps, np.inf)
    durations = rng.exponential(d_means[None, :, None], size=(n_scenarios, N, M))
    # stationary start: a worker begins mid-burst with probability
    # dur/(idle+dur) — zero out the first idle gap for those pairs
    duty = (rates * d_means) / (1.0 + rates * d_means)
    in_burst_at_0 = rng.random((n_scenarios, N)) < duty[None, :]
    gaps[:, :, 0] = np.where(in_burst_at_0, 0.0, gaps[:, :, 0])
    factors = 1.0 + rng.exponential(
        np.maximum(f_means - 1.0, 1e-12)[None, :, None], size=(n_scenarios, N, M)
    )
    # alternating renewal: start_m = sum_{j<=m} gap_j + sum_{j<m} dur_j
    starts = np.cumsum(gaps, axis=2) + np.cumsum(durations, axis=2) - durations
    ends = starts + durations
    return FleetTraces(comm, comp_unit, slowdown, starts, ends, factors, seed=seed)
