"""Event-time simulation of the paper's distributed methods (§5, §7).

Counterpart of ``repro.cluster.simulator``.  Workers follow the two-state
busy/idle model of §4.2 with a length-1 FILO task queue; the coordinator
runs GD, ignoring-stragglers SGD, SAG (w <= N), DSAG (stale integration and
the §5.1 margin) and the idealized-MDS coded bound of §7.1.  Per-task
latencies come from the §3 model, live (:class:`ModelLatencySource`) or
replayed from pre-sampled traces (:class:`TraceLatencySource`); per-task
values are real subgradients, computed on the engine's device through the
problem's kernels (K1/K2 on the card), one task per call.

The shared helpers at the top (the finish-time and margin expressions, the
effective wait-for-w, the static pad width, :class:`MethodConfig`) are
written for numpy arrays and torch tensors alike (plain operators only), so
the scalar :class:`TrainingSimulator`, the host engine and the device engine
evaluate the exact same float expressions, one rounding per operator.

§6 load balancing plugs in as in the reference: every completion is
recorded into a task-slot :class:`~repro_torch.latency.profiler.
MomentBuffer`; Algorithm 1 (:class:`~repro_torch.lb.optimizer.
LoadBalanceOptimizer`) runs every ``lb_interval`` simulated seconds after a
``lb_startup_delay``, and a published p reaches each worker with its next
task, where Algorithm 2 aligns it.

Churn comes in through replayed traces that carry a ``ChurnSchedule`` (or
through §7.2 ``SlowdownRemoval`` timed events, which fold into one): at
each assignment a dead worker's queued heap event is invalidated by a
per-worker generation counter, its cache entries are cleared in worker
order (``evict_stream``), it starts nothing and consumes no draws, and the
wait is for ``min(w, #alive)`` fresh results; at a change of churn row the
§6 contribution floor is dropped and the profiler window restarts at the
boundary.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from collections.abc import Callable

import numpy as np

from repro_torch.core.gradient_cache import GradientCache
from repro_torch.core.problems import FiniteSumProblem
from repro_torch.experiments.engine import (
    EngineCapabilityError,
    EngineConfig,
    as_engine_config,
    engine_capability,
    kernel_dtype_capability,
)
from repro_torch.latency.model import (
    ClusterLatencyModel,
    FleetTraces,
    SlowdownRemoval,
    churn_from_removals,
)
from repro_torch.latency.profiler import LatencyProfiler, LatencySample, MomentBuffer
from repro_torch.lb.optimizer import LoadBalanceOptimizer, OptimizerInputs
from repro_torch.lb.partitioner import Subpartitioner, build_p_ladder, p_start, p_stop


def task_finish_time(start, comp, comm):
    """Completion time of a task: ``start + (comp + comm)``.

    The grouping matters for exact replay: the two latency components are
    added together before the start time is added.
    """
    return start + (comp + comm)


def margin_deadline(tau_w, iter_start, margin):
    """Paper §5.1: keep collecting ``margin`` longer than the time the
    first w fresh results took this iteration."""
    return tau_w + margin * (tau_w - iter_start)


def effective_w(config: MethodConfig, num_workers: int) -> int:
    """The wait-for-w actually used by a method on an N-worker fleet."""
    if config.name == "gd":
        return num_workers
    if config.name == "coded":
        return int(math.ceil(config.code_rate * num_workers))
    return min(config.w if config.w > 0 else num_workers, num_workers)


def lb_ladder_for(config: MethodConfig, n_local) -> tuple:
    """The §6 p-ladder of a run: every engine climbs the same rungs.

    Built from the configured initial subpartition count and the largest
    per-worker sample count; the scalar simulator, the host engine and the
    device engine (and its slot universe) all take their ladder from here.
    """
    return build_p_ladder(max(int(config.subpartitions), 1), int(np.max(n_local)))


def make_optimizer_inputs(e_comm, v_comm, e_comp, v_comp, samples_per_worker, w: int,
                          margin: float) -> OptimizerInputs:
    """§6.1 profiler moments -> Algorithm-1 inputs (variance floors applied);
    ``[N]`` arrays (scalar simulator) or ``[S, N]`` (host engine)."""
    return OptimizerInputs(
        e_comm=np.asarray(e_comm, dtype=np.float64),
        v_comm=np.maximum(np.asarray(v_comm, dtype=np.float64), 1e-18),
        e_comp=np.asarray(e_comp, dtype=np.float64),
        v_comp=np.maximum(np.asarray(v_comp, dtype=np.float64), 1e-18),
        samples_per_worker=np.asarray(samples_per_worker, dtype=np.float64),
        w=w,
        margin=margin,
    )


def _local_widths(n_local: int, p: int, full: bool) -> set:
    if full:
        return {n_local}
    return {k * n_local // p - (k - 1) * n_local // p for k in range(1, p + 1)}


def task_pad_width(config: MethodConfig, num_samples: int, num_workers: int) -> int:
    """The static pad width of a run's tasks: its widest task window.

    Every engine passes this one width to the §3 block-subgradient call of
    every task (K1's slab count and warps and the plain versions' gather
    width follow it), so a task's value does not depend on how many tasks
    share its call.  Under §6 load balancing every ladder rung's widths
    count (any of them can appear once repartitions start).  The coded
    bound's full-range call pads to ``num_samples``.
    """
    n, N = num_samples, num_workers
    full = config.name in ("gd", "coded")
    n_locals = [p_stop(n, N, i) - p_start(n, N, i) + 1 for i in range(1, N + 1)]
    rungs = [config.subpartitions]
    if config.load_balance and not full:
        rungs += list(lb_ladder_for(config, n_locals))
    widths: set = set()
    for n_local in n_locals:
        for p in rungs:
            widths |= _local_widths(n_local, min(p, n_local), full)
    return max(widths)


@dataclasses.dataclass
class MethodConfig:
    """One method/configuration of paper §7."""

    name: str  # gd | sgd | sag | dsag | coded
    w: int = 0  # wait-for-w (ignored by gd/coded)
    eta: float = 0.9
    margin: float = 0.02  # post-w extra wait (paper §5.1); dsag/lb methods
    subpartitions: int = 1  # initial p_i (paper: 100 for PCA, 10 for logreg)
    code_rate: float = 45.0 / 49.0  # coded only
    load_balance: bool = False
    lb_interval: float = 1.0  # how often the optimizer publishes (sim s)
    lb_startup_delay: float = 0.5  # first-solution delay (paper: 0.5-7 s)

    def __post_init__(self):
        if self.name not in ("gd", "sgd", "sag", "dsag", "coded"):
            raise ValueError(f"unknown method {self.name}")

    @property
    def uses_cache(self) -> bool:
        return self.name in ("sag", "dsag")

    @property
    def accepts_stale(self) -> bool:
        return self.name == "dsag"

    @property
    def uses_margin(self) -> bool:
        return self.name == "dsag" or self.load_balance


class LatencySource:
    """Where per-task (comp, comm) latencies come from: sampled live from the
    §3 model or replayed from a pre-sampled trace."""

    def task_latency(self, worker: int, cost: float, now: float) -> tuple[float, float]:
        """Return ``(comp_latency, comm_latency)`` of one task."""
        raise NotImplementedError


class ModelLatencySource(LatencySource):
    """Live sampling from a :class:`ClusterLatencyModel` (the default).

    Reads the cluster on every draw, so timed events that mutate worker
    state (the §7.2 slowdown removal, :func:`~repro_torch.latency.model.
    clear_slowdowns`) take effect.
    """

    def __init__(self, cluster: ClusterLatencyModel):
        self.cluster = cluster

    def task_latency(self, worker: int, cost: float, now: float) -> tuple[float, float]:
        wk = self.cluster.workers[worker]
        comp = wk.sample_comp(cost, self.cluster.rng, now=now)
        comm = wk.sample_comm(self.cluster.rng)
        return comp, comm


class TraceLatencySource(LatencySource):
    """Replay one scenario of pre-sampled :class:`FleetTraces`.

    Each worker consumes its (comm, comp_unit) draws in order, one per
    started task — the order the batched engines consume them, so a run
    replayed through this source sees exactly the latencies of the
    corresponding scenario.
    """

    def __init__(self, traces: FleetTraces, scenario: int):
        if not (0 <= scenario < traces.num_scenarios):
            raise ValueError(f"scenario {scenario} out of range")
        self.traces = traces
        self.scenario = scenario
        self._k = np.zeros(traces.num_workers, dtype=np.int64)

    def task_latency(self, worker: int, cost: float, now: float) -> tuple[float, float]:
        k = int(self._k[worker])
        self._k[worker] += 1
        comm, comp = self.traces.scalar_task_latency(self.scenario, worker, k, now, cost)
        return float(comp), float(comm)


@dataclasses.dataclass
class RunHistory:
    """Convergence trace of one training run.

    ``per_worker_latency[t, i]`` is the total (comp + comm) latency of the
    task worker ``i`` *started for iteration t*: a stale DSAG result lands in
    the row of the iteration it was assigned in (NaN where the worker never
    started that iteration's task, or where the run ended before the result
    returned).
    """

    times: np.ndarray  # [T] completion time of each iteration (sim s)
    suboptimality: np.ndarray  # [T] gap after each iteration (subsampled = nan)
    fresh_counts: np.ndarray  # [T]
    per_worker_latency: np.ndarray  # [T, N] latency of the task started at t
    repartition_events: list[float]  # sim times at which a new p was published
    evictions: int = 0
    rejected_stale: int = 0
    #: [T, N] bool coordinator decision streams, the step inputs the live
    #: ``dsag_update`` sees: mask — a fresh (titer == t) result within
    #: iteration t's collection window; flush — a stale result accepted into
    #: the gradient cache; evict — a death cleared the worker's entry
    mask_stream: np.ndarray | None = None
    flush_stream: np.ndarray | None = None
    evict_stream: np.ndarray | None = None

    def time_to_gap(self, gap: float) -> float:
        """First sim time at which suboptimality <= gap (inf if never)."""
        ok = np.where(np.nan_to_num(self.suboptimality, nan=np.inf) <= gap)[0]
        return float(self.times[ok[0]]) if len(ok) else float("inf")


@dataclasses.dataclass
class _Task:
    iteration: int
    iterate: np.ndarray
    assigned_at: float


class _SimWorker:
    """Two-state worker with a length-1 FILO task queue (paper §4.2)."""

    def __init__(self, idx: int, sub: Subpartitioner):
        self.idx = idx
        self.sub = sub
        self.busy_until = 0.0
        self.queued: _Task | None = None
        self.pending_p: int | None = None  # §6 update, applied at the next task

    def start_task(self, task: _Task, now: float, sim: TrainingSimulator, comp_scale: float):
        """Begin processing; returns (finish_time, result tuple)."""
        if self.pending_p is not None:
            self.sub.repartition(self.pending_p)  # Algorithm-2 alignment
            self.pending_p = None
        if sim.process_full:
            interval = (self.sub.base_start, self.sub.base_stop)
        else:
            interval = self.sub.next_interval_and_advance()
        start, stop = interval
        # coded recomputes the exact gradient: its task values are never read
        value = (
            None
            if sim.config.name == "coded"
            else sim.problem.subgradient(
                task.iterate, start, stop, pad_width=sim.pad_width, engine=sim.engine
            )
        )
        cost = sim.problem.compute_cost(start, stop) * comp_scale
        comp_lat, comm_lat = sim.latency_source.task_latency(self.idx, cost, now)
        finish = task_finish_time(now, comp_lat, comm_lat)
        self.busy_until = finish
        result = (self.idx, interval, task.iteration, value, comp_lat, comm_lat, task.assigned_at)
        return finish, result


class TrainingSimulator:
    """Run one method to completion, one heap event at a time, and record its
    convergence trace.

    ``engine`` (default ``EngineConfig()``: the card, CUDA kernels) names the
    device and kernel backend of the subgradients, projections and
    suboptimality, and the device of the §6 optimizer's float64 arithmetic.
    ``what_if_normals`` (``[2, N, K]``) overrides the §6 what-if draws
    (:func:`~repro_torch.lb.optimizer.what_if_normals`).  Raises
    :class:`~repro_torch.experiments.engine.EngineCapabilityError` at
    construction for a missing card.  ``timed_events`` on a replayed trace
    must all be :class:`~repro_torch.latency.model.SlowdownRemoval`: they
    are folded into a churn schedule on the trace source (other callables
    mutate the cluster, which a replayed trace never reads, and are
    refused).
    """

    def __init__(
        self,
        problem: FiniteSumProblem,
        cluster: ClusterLatencyModel,
        config: MethodConfig,
        *,
        cost_scale: float = 1.0,
        eval_every: int = 1,
        timed_events: list[tuple[float, Callable]] | None = None,
        seed: int = 0,
        latency_source: LatencySource | None = None,
        engine: EngineConfig | None = None,
        what_if_normals=None,
    ):
        self.problem = problem
        self.cluster = cluster
        self.config = config
        self.cost_scale = cost_scale
        self.eval_every = eval_every
        self.engine = as_engine_config(engine, _stacklevel=3)
        #: live model sampling by default; a TraceLatencySource replays one
        #: pre-sampled scenario through the full training simulator
        self.latency_source = latency_source or ModelLatencySource(cluster)
        traces = (
            self.latency_source.traces
            if isinstance(self.latency_source, TraceLatencySource)
            else None
        )
        cap = engine_capability(self.engine)
        if cap.supported:
            cap = kernel_dtype_capability(
                self.engine, problem.fused_kernels(self.engine.device).value_dtype
            )
        if not cap.supported:
            raise EngineCapabilityError(cap)
        if timed_events and traces is not None:
            if not all(isinstance(fn, SlowdownRemoval) for _, fn in timed_events):
                # opaque events mutate the cluster model, which a pre-sampled
                # trace never re-reads: ignoring them would fake the §7.2
                # scenarios
                raise ValueError(
                    "timed_events require live model sampling; a replayed trace "
                    "cannot react to cluster mutations (use SlowdownRemoval events "
                    "or traces.with_churn for the replayable §7.2 path)"
                )
            if traces.churn is not None:
                raise ValueError(
                    "traces already carry a churn schedule; fold the slowdown "
                    "removals into it instead of passing timed_events"
                )
            # the §7.2 scenario replays exactly as a churn schedule whose
            # rows replace the static slowdowns at each task's start
            removals = [SlowdownRemoval(time=t, workers=fn.workers) for t, fn in timed_events]
            traces = traces.with_churn(churn_from_removals(traces.slowdown, removals))
            self.latency_source.traces = traces
            timed_events = []
        if traces is not None and traces.num_workers != cluster.num_workers:
            raise ValueError(
                f"trace has {traces.num_workers} workers but the cluster has "
                f"{cluster.num_workers}"
            )
        #: (sim_time, fn(cluster)) hooks, e.g. the §7.2 slowdown removal at 1 s
        self.timed_events = sorted(timed_events or [], key=lambda e: e[0])
        self.seed = seed
        n = problem.num_samples
        N = cluster.num_workers
        self.process_full = config.name in ("gd", "coded")
        self.pad_width = task_pad_width(config, n, N)
        self.workers = [
            _SimWorker(
                i,
                Subpartitioner(
                    base_start=p_start(n, N, i + 1),
                    base_stop=p_stop(n, N, i + 1),
                    p=config.subpartitions,
                ),
            )
            for i in range(N)
        ]
        self.profiler = LatencyProfiler(N, window=10.0)
        if config.load_balance:
            n_local = np.array([w.sub.n_local for w in self.workers])
            self.lb_optimizer = LoadBalanceOptimizer(
                seed=seed, ladder=lb_ladder_for(config, n_local),
                what_if_normals=what_if_normals, device=self.engine.device,
                kernel_backend=self.engine.kernel_backend,
            )
        else:
            self.lb_optimizer = None
        self._next_lb_time = config.lb_startup_delay if config.load_balance else math.inf
        self._lb_buffer: MomentBuffer | None = None  # allocated per run()

    def run(self, num_iterations: int) -> RunHistory:
        cfg = self.config
        problem = self.problem
        eng = self.engine
        N = self.cluster.num_workers
        n = problem.num_samples
        w_wait = effective_w(cfg, N)
        comp_scale = self.cost_scale * (1.0 / cfg.code_rate if cfg.name == "coded" else 1.0)

        V = problem.init(self.seed)
        cache = (
            GradientCache(n, np.zeros_like(V, dtype=np.float64)) if cfg.uses_cache else None
        )
        # churn comes in through the replayed traces (live sampling models
        # fleet changes as timed_events mutating the cluster instead)
        churn = (
            self.latency_source.traces.churn
            if isinstance(self.latency_source, TraceLatencySource)
            else None
        )
        now = 0.0
        # (finish, seq, generation, result): a death bumps the worker's
        # generation, which invalidates its queued event without disturbing
        # the (finish, seq) pop order
        heap: list[tuple[float, int, int, tuple]] = []
        seq = 0
        gen = np.zeros(N, dtype=np.int64)
        times = np.zeros(num_iterations)
        subopt = np.full(num_iterations, np.nan)
        fresh_counts = np.zeros(num_iterations, dtype=np.int64)
        lat_matrix = np.full((num_iterations, N), np.nan)
        mask_stream = np.zeros((num_iterations, N), dtype=bool)
        flush_stream = np.zeros((num_iterations, N), dtype=bool)
        evict_stream = np.zeros((num_iterations, N), dtype=bool)
        repartition_events: list[float] = []
        event_ptr = 0
        current_p = np.full(N, cfg.subpartitions, dtype=np.int64)
        self._lb_buffer = (
            MomentBuffer(1, N, num_iterations, device=eng.device) if cfg.load_balance else None
        )
        prev_row = int(churn.row_at(now)) if churn is not None else 0
        lb_since = float(churn.boundary_before(prev_row)) if churn is not None else None

        for t in range(num_iterations):
            # fire timed environment events (e.g. the §7.2 slowdown removal)
            while event_ptr < len(self.timed_events) and self.timed_events[event_ptr][0] <= now:
                self.timed_events[event_ptr][1](self.cluster)
                event_ptr += 1

            alive, w_eff = None, w_wait
            if churn is not None:
                # liveness sampled once per iteration, at the assignment
                alive = churn.alive_at(now)
                row = int(churn.row_at(now))
                if row != prev_row:
                    # the fleet changed: the §6 optimizer re-baselines its
                    # contribution floor and re-profiles from the boundary
                    if self.lb_optimizer is not None:
                        self.lb_optimizer.h_min = None
                    lb_since = float(churn.boundary_before(row))
                    prev_row = row
                for i, wk in enumerate(self.workers):
                    if alive[i]:
                        continue
                    if wk.busy_until > now or wk.queued is not None:
                        # dead at the assignment: the in-flight completion
                        # never happens and the queued task is dropped
                        gen[i] += 1
                        wk.busy_until = now
                        wk.queued = None
                    # worker order is interval-start order (base ranges are
                    # disjoint and worker-ordered); clearing is idempotent
                    if cache is not None and cache.clear_range(wk.sub.base_start,
                                                               wk.sub.base_stop):
                        evict_stream[t, i] = True
                w_eff = min(w_wait, int(alive.sum()))

            task = _Task(iteration=t, iterate=V, assigned_at=now)
            for wk in self.workers:
                if alive is not None and not alive[wk.idx]:
                    continue  # dead workers start nothing and consume no draws
                if wk.busy_until <= now:
                    fin, result = wk.start_task(task, now, self, comp_scale)
                    heapq.heappush(heap, (fin, seq, int(gen[wk.idx]), result))
                    seq += 1
                else:
                    wk.queued = task

            fresh = 0
            fresh_values: list[tuple[tuple[int, int], np.ndarray]] = []  # gd / sgd
            deadline = math.inf
            iter_start = now
            while heap and (fresh < w_eff or heap[0][0] <= deadline):
                fin, sq, g, result = heapq.heappop(heap)
                if g != gen[result[0]]:
                    continue  # discarded by a death: must not move `now`
                if fin > deadline:
                    heapq.heappush(heap, (fin, sq, g, result))
                    break
                now = fin
                widx, interval, titer, value, comp_lat, comm_lat, assigned_at = result
                wk = self.workers[widx]
                # attribute the latency to the task's own iteration (RunHistory)
                lat_matrix[titer, widx] = comp_lat + comm_lat
                self.profiler.record(
                    LatencySample(
                        worker=widx,
                        t_recorded=now,
                        round_trip=now - assigned_at,
                        compute=comp_lat,
                        load=problem.compute_cost(*interval) * comp_scale,
                    )
                )
                if self._lb_buffer is not None:
                    # the task-slot twin of the sample above (the §6 view)
                    self._lb_buffer.record(0, widx, titer, now, now - assigned_at, comp_lat)
                # start the queued task at once (FILO queue of length 1)
                if wk.queued is not None:
                    qt, wk.queued = wk.queued, None
                    nfin, nresult = wk.start_task(qt, now, self, comp_scale)
                    heapq.heappush(heap, (nfin, seq, int(gen[widx]), nresult))
                    seq += 1
                else:
                    wk.busy_until = now

                is_fresh = titer == t
                if cfg.uses_cache:
                    if is_fresh or cfg.accepts_stale:
                        inserted = cache.insert(interval[0], interval[1], titer, value)
                        if inserted and not is_fresh:
                            flush_stream[t, widx] = True  # §5 stale flush
                elif is_fresh:  # gd / sgd / coded take fresh results only
                    fresh_values.append((interval, value))
                if is_fresh:
                    mask_stream[t, widx] = True
                    fresh += 1
                    if fresh == w_eff:
                        if cfg.uses_margin and cfg.margin > 0:
                            # paper §5.1: wait `margin` longer than the w-th
                            # fresh result took this iteration
                            deadline = margin_deadline(now, iter_start, cfg.margin)
                        else:
                            break

            # ---- iterate update -------------------------------------------
            if cfg.uses_cache:
                xi = max(cache.coverage, 1e-12)
                grad = cache.sum / xi + problem.regularizer_grad(V)
            elif cfg.name == "coded":
                # idealized MDS bound (§7.1): the exact gradient from any
                # ceil(rN) results at no decoding cost; the wait above only
                # sets the latency
                grad = problem.subgradient(V, 1, n, pad_width=n, engine=eng).astype(np.float64)
                grad = grad + problem.regularizer_grad(V)
            else:  # gd sums the fresh values; sgd also scales by coverage
                grad = np.zeros_like(V, dtype=np.float64)
                for _, val in fresh_values:
                    grad += val
                if cfg.name == "sgd":
                    covered = sum(iv[1] - iv[0] + 1 for iv, _ in fresh_values)
                    grad = grad / max(covered / n, 1e-12)
                grad = grad + problem.regularizer_grad(V)
            V = problem.project((V - cfg.eta * grad).astype(V.dtype, copy=False), engine=eng)

            times[t] = now
            fresh_counts[t] = fresh
            if t % self.eval_every == 0 or t == num_iterations - 1:
                subopt[t] = problem.suboptimality(V, engine=eng)

            # ---- load balancing (the background loop, simulated) ----------
            if cfg.load_balance and now >= self._next_lb_time:
                published = self._run_load_balancer(now, current_p, w_wait, alive=alive,
                                                     since=lb_since)
                if published is not None:
                    current_p = published
                    repartition_events.append(now)
                self._next_lb_time = now + cfg.lb_interval

        return RunHistory(
            times=times,
            suboptimality=subopt,
            fresh_counts=fresh_counts,
            per_worker_latency=lat_matrix,
            repartition_events=repartition_events,
            evictions=cache.evictions if cache else 0,
            rejected_stale=cache.rejected_stale if cache else 0,
            mask_stream=mask_stream,
            flush_stream=flush_stream,
            evict_stream=evict_stream,
        )

    def _run_load_balancer(self, now: float, current_p: np.ndarray, w_wait: int, *,
                           alive: np.ndarray | None = None,
                           since: float | None = None) -> np.ndarray | None:
        """One Algorithm-1 call on the window at ``now`` (samples from
        ``since`` on); the published p, or None (a living worker without a
        sample in the window, or no publication)."""
        e_comm, v_comm, e_comp, v_comp, cnt = self._lb_buffer.moments(
            np.array([now]), since=None if since is None else np.array([since]))
        ready = cnt[0] >= 1
        if alive is not None:
            ready = ready | ~alive  # dead workers produce no samples
        if not ready.all():
            return None  # every living worker needs a sample in the window
        n_i = np.array([w.sub.n_local for w in self.workers], dtype=np.float64)
        inputs = make_optimizer_inputs(
            e_comm[0], v_comm[0], e_comp[0], v_comp[0], n_i, w_wait, self.config.margin
        )
        lb = self.lb_optimizer
        hm = np.array([np.nan if lb.h_min is None else lb.h_min])
        p_new, h_min, last_h, publish = lb.update_batch(
            np.asarray(current_p, np.int64)[None, :], inputs.as_batch(), hm,
            alive=None if alive is None else np.asarray(alive, bool)[None, :],
        )
        lb.h_min = float(h_min[0])
        lb.last_h = float(last_h[0])
        if not publish[0]:
            return None
        for i, wk in enumerate(self.workers):
            if p_new[0, i] != current_p[i]:
                wk.pending_p = int(p_new[0, i])
        return p_new[0]
