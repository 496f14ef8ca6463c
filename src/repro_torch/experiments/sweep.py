"""Batched iteration-time sweeps (paper Figs. 8-9) on a torch device.

Counterpart of ``repro.experiments.sweep``.  The scalar event loops
(:class:`~repro_torch.latency.event_sim.EventDrivenSimulator`,
:class:`~repro_torch.cluster.simulator.TrainingSimulator`) replay the §4.2
busy/idle fleet one heap event at a time; here the latency draws are
pre-sampled (:func:`~repro_torch.latency.model.sample_fleet`) and every
iteration's event dynamics are resolved for all scenarios at once with
``[S, N]`` float64 tensors on the device: the w-th order statistic of the
candidate finish times is the scalar loop's w-th fresh arrival, and the
rest (margin deadline, which workers started, the iteration's end) are
elementwise operations and reductions.

Exactness: :func:`replay_batch` and :func:`synchronous_times_batch` equal
the scalar references (:func:`scalar_reference`,
:func:`scalar_sync_reference`, numpy) and the JAX package's batched numpy
engine bit for bit (``tests/test_torch_sweep.py``).  That holds because

* the §3 latency product is evaluated left to right, one rounding per
  operator (eager torch launches one kernel per operator: nothing is fused
  into an FMA), through :func:`~repro_torch.latency.model.comp_latency_expr`;
* ``np.partition(x, w - 1)[w - 1]`` becomes ``torch.kthvalue(x, w)``: both
  select the same element;
* sums over iterations are folded in order: the burst loop adds on the
  device one iteration at a time, the burst-free cumulative sum is taken on
  the host from the exact per-iteration array (a CUDA ``cumsum`` would add
  in another order), and means are formed on the host from integer counts.

Traces carrying a ``ChurnSchedule`` are refused (``churn-not-ported``).
The device engine of the convergence sweep takes its latency lookups from
here (:func:`trace_tensors`, :func:`task_latency_parts`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.cluster.simulator import margin_deadline, task_finish_time
from repro_torch.experiments.engine import (
    CAP_CHURN,
    CAP_CUDA_UNAVAILABLE,
    refuse,
)
from repro_torch.latency.event_sim import EventDrivenSimulator, SimResult
from repro_torch.latency.model import FleetTraces, comp_latency_expr

F64, I64 = torch.float64, torch.int64


@dataclasses.dataclass
class BatchedRunResult:
    """Per-scenario traces of one batched method run (numpy).

    ``iteration_times`` matches the scalar simulator's
    ``SimResult.iteration_times`` per scenario; the ``task_*`` arrays (only
    filled with ``record_tasks=True``) hold per-(scenario, iteration, worker)
    samples for the §6.1 profiler feed (NaN where the worker never started
    that iteration's task).
    """

    iteration_times: np.ndarray  # [S, T] completion time of each iteration
    fresh_counts: np.ndarray  # [S, T]
    participation: np.ndarray  # [S, N] fraction of iterations fresh
    task_assigned: np.ndarray | None = None  # [S, T] assignment time
    task_start: np.ndarray | None = None  # [S, T, N]
    task_finish: np.ndarray | None = None  # [S, T, N]
    task_comp: np.ndarray | None = None  # [S, T, N] compute-only latency

    @property
    def mean_iteration_time(self) -> np.ndarray:
        """[S] mean per-iteration latency of each scenario."""
        t = self.iteration_times
        return t[:, -1] / t.shape[1]


def sweep_device(device) -> torch.device:
    """The torch device of a sweep; refuses a missing card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise refuse(
            CAP_CUDA_UNAVAILABLE,
            f"device={device!r} requested but torch sees no CUDA device; pass "
            "device='cpu' to run on the CPU",
        )
    return dev


def trace_tensors(traces: FleetTraces, device) -> dict:
    """The trace arrays as float64 tensors on ``device``: ``comm`` and
    ``comp_unit`` [S, N, K], ``slowdown`` [N], ``burst_start`` /
    ``burst_end`` / ``burst_factor`` [S, N, M]."""

    def f64(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)

    return dict(
        comm=f64(traces.comm),
        comp_unit=f64(traces.comp_unit),
        slowdown=f64(traces.slowdown),
        burst_start=f64(traces.burst_start),
        burst_end=f64(traces.burst_end),
        burst_factor=f64(traces.burst_factor),
    )


def burst_factor_at(tr: dict, start):
    """Active burst factor at task start times ``start`` [S, N] (windows do
    not overlap: at most one factor is selected)."""
    if tr["burst_start"].shape[2] == 0:
        return torch.ones_like(start)
    tt = start[:, :, None]
    active = (tr["burst_start"] <= tt) & (tt < tr["burst_end"])
    return torch.where(active, tr["burst_factor"], 1.0).amax(dim=2)


def task_latency_parts(tr: dict, k, start, loads):
    """(comm, comp) of each worker's ``k``-th draw [S, N], started at
    ``start`` [S, N] with load ``loads`` ([S, N] float64): the tensor form of
    ``FleetTraces.task_latency_parts``, the same product order."""
    comm = tr["comm"].gather(2, k[:, :, None])[:, :, 0]
    unit = tr["comp_unit"].gather(2, k[:, :, None])[:, :, 0]
    comp = comp_latency_expr(unit, loads, tr["slowdown"][None, :], burst_factor_at(tr, start))
    return comm, comp


def _checked(traces: FleetTraces, w: int, num_iterations: int, device) -> torch.device:
    S, N, K = traces.comm.shape
    if traces.churn is not None:
        raise refuse(CAP_CHURN, "traces with a ChurnSchedule are not ported yet")
    if not (1 <= w <= N):
        raise ValueError(f"w={w} not in 1..{N}")
    if num_iterations > K:
        raise ValueError(
            f"traces hold {K} draws/worker but {num_iterations} iterations requested"
        )
    return sweep_device(device)


def _loads(loads, S: int, N: int, dev):
    return torch.as_tensor(
        np.broadcast_to(np.asarray(loads, dtype=np.float64), (S, N)).copy(), device=dev
    )


def replay_batch(
    traces: FleetTraces,
    w: int,
    num_iterations: int,
    *,
    margin: float = 0.0,
    loads=1.0,
    record_tasks: bool = False,
    device="cuda",
) -> BatchedRunResult:
    """Run the §4.2 w-of-N event dynamics for every scenario at once.

    Equal bit for bit (up to measure-zero event-time ties) to running
    :class:`EventDrivenSimulator` per scenario with
    ``traces.scalar_latency_provider`` (:func:`scalar_reference`).
    """
    S, N, _ = traces.comm.shape
    T = num_iterations
    dev = _checked(traces, w, T, device)
    tr = trace_tensors(traces, dev)
    loads_b = _loads(loads, S, N, dev)

    free_at = torch.zeros((S, N), dtype=F64, device=dev)  # when each task ends
    iter_end = torch.zeros((S,), dtype=F64, device=dev)  # last event of t - 1
    draw_idx = torch.zeros((S, N), dtype=I64, device=dev)
    times = torch.zeros((S, T), dtype=F64, device=dev)
    fresh_counts = torch.zeros((S, T), dtype=I64, device=dev)
    part_accum = torch.zeros((S, N), dtype=I64, device=dev)
    if record_tasks:
        rec = dict(
            assigned=torch.zeros((S, T), dtype=F64, device=dev),
            start=torch.zeros((S, T, N), dtype=F64, device=dev),
            finish=torch.zeros((S, T, N), dtype=F64, device=dev),
            comp=torch.zeros((S, T, N), dtype=F64, device=dev),
        )

    for t in range(T):
        assign = iter_end  # idle workers start now; busy ones queue
        idle = free_at <= assign[:, None]
        start = torch.where(idle, assign[:, None], free_at)
        comm_d, comp_d = task_latency_parts(tr, draw_idx, start, loads_b)
        finish = task_finish_time(start, comp_d, comm_d)
        # the w-th fresh arrival: a busy worker among the first w has
        # free_at < finish <= tau_w, so its queued task provably started
        tau_w = torch.kthvalue(finish, w, dim=1).values
        # paper §5.1: keep collecting `margin` longer than the first w took
        deadline = margin_deadline(tau_w, assign, margin) if margin > 0.0 else tau_w
        started = idle | (free_at <= deadline[:, None])
        fresh = started & (finish <= deadline[:, None])
        fresh_counts[:, t] = fresh.sum(dim=1)
        part_accum += fresh
        # the iteration ends at the last event <= deadline: a fresh
        # completion or a busy -> idle transition that started a queued task
        stale_ev = torch.where(~idle & (free_at <= deadline[:, None]), free_at, -torch.inf)
        fresh_ev = torch.where(fresh, finish, -torch.inf)
        iter_end = torch.maximum(
            torch.maximum(stale_ev.amax(dim=1), fresh_ev.amax(dim=1)), tau_w
        )
        times[:, t] = iter_end
        if record_tasks:
            rec["assigned"][:, t] = assign
            rec["start"][:, t] = torch.where(started, start, torch.nan)
            rec["finish"][:, t] = torch.where(started, finish, torch.nan)
            rec["comp"][:, t] = torch.where(started, comp_d, torch.nan)
        free_at = torch.where(started, finish, free_at)
        draw_idx = draw_idx + started.to(I64)

    recs = {k: v.cpu().numpy() for k, v in rec.items()} if record_tasks else {}
    return BatchedRunResult(
        iteration_times=times.cpu().numpy(),
        fresh_counts=fresh_counts.cpu().numpy(),
        participation=part_accum.cpu().numpy() / max(T, 1),
        task_assigned=recs.get("assigned"),
        task_start=recs.get("start"),
        task_finish=recs.get("finish"),
        task_comp=recs.get("comp"),
    )


def synchronous_times_batch(
    traces: FleetTraces,
    w: int,
    num_iterations: int,
    *,
    loads=1.0,
    return_participation: bool = False,
    device="cuda",
):
    """[S, T] cumulative iteration times for methods *without* queue feedback.

    Fully synchronized rounds (GD, the §7.1 idealized coded bound): every
    worker starts each iteration at the sync point and stragglers' leftover
    work is abandoned, so an iteration takes the w-th order statistic of N
    fresh draws.  Burst-free traces resolve every iteration at once; with
    bursts the factor depends on the running clock, so iterations are folded
    in order, ``[S, N]`` at a time.
    """
    S, N, _ = traces.comm.shape
    T = num_iterations
    dev = _checked(traces, w, T, device)
    tr = trace_tensors(traces, dev)
    loads_b = _loads(loads, S, N, dev)
    if not traces.has_bursts:
        d = tr["comm"][:, :, :T] + (
            tr["comp_unit"][:, :, :T] * loads_b[:, :, None] * tr["slowdown"][None, :, None]
        )
        per_iter = torch.kthvalue(d, w, dim=1).values  # [S, T]
        times = np.cumsum(per_iter.cpu().numpy(), axis=1)
        if return_participation:
            counts = (d <= per_iter[:, None, :]).sum(dim=2)
            return times, counts.cpu().numpy() / T
        return times
    times = torch.zeros((S, T), dtype=F64, device=dev)
    clock = torch.zeros((S,), dtype=F64, device=dev)
    part_accum = torch.zeros((S, N), dtype=I64, device=dev)
    for t in range(T):
        idx = torch.full((S, N), t, dtype=I64, device=dev)
        comm, comp = task_latency_parts(tr, idx, clock[:, None].expand(S, N), loads_b)
        d = comm + comp
        kth = torch.kthvalue(d, w, dim=1).values
        part_accum += d <= kth[:, None]
        clock = clock + kth
        times[:, t] = clock
    if return_participation:
        return times.cpu().numpy(), part_accum.cpu().numpy() / max(T, 1)
    return times.cpu().numpy()


def scalar_reference(
    traces: FleetTraces,
    scenario: int,
    w: int,
    num_iterations: int,
    *,
    margin: float = 0.0,
    loads=1.0,
) -> SimResult:
    """Replay one scenario through the *scalar* event loop (ground truth):
    the same trace arrays and draw order, one heap event at a time (numpy)."""
    if num_iterations > traces.horizon:
        raise ValueError(
            f"traces hold {traces.horizon} draws/worker but "
            f"{num_iterations} iterations requested"
        )
    N = traces.num_workers
    loads_arr = np.broadcast_to(
        np.asarray(loads, dtype=np.float64),
        (traces.num_scenarios, N) if np.ndim(loads) == 2 else (N,),
    )
    if loads_arr.ndim == 2:
        loads_arr = loads_arr[scenario]
    sim = EventDrivenSimulator(
        None,
        loads_arr,
        latency_provider=traces.scalar_latency_provider(scenario, loads),
    )
    return sim.run(w, num_iterations, margin=margin, churn=traces.churn)


def scalar_sync_reference(
    traces: FleetTraces,
    scenario: int,
    w: int,
    num_iterations: int,
    *,
    loads=1.0,
) -> np.ndarray:
    """Scalar counterpart of :func:`synchronous_times_batch` (one scenario,
    numpy): per iteration, draw every worker's latency at the sync point and
    advance the clock by the w-th smallest."""
    if num_iterations > traces.horizon:
        raise ValueError(
            f"traces hold {traces.horizon} draws/worker but "
            f"{num_iterations} iterations requested"
        )
    N = traces.num_workers
    loads_arr = np.broadcast_to(np.asarray(loads, dtype=np.float64), (N,))
    clock = 0.0
    times = np.empty(num_iterations)
    for t in range(num_iterations):
        d = np.empty(N)
        for i in range(N):
            comm, comp = traces.scalar_task_latency(scenario, i, t, clock, loads_arr[i])
            d[i] = comm + comp
        clock = clock + np.sort(d)[w - 1]
        times[t] = clock
    return times
