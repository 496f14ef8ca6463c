"""The fused convergence engine's grid-cache body, on a torch device.

Counterpart of ``repro.experiments.fused`` for ``cache_mode`` ``"grid"``
(sag, dsag) and ``"none"`` (sgd, gd, coded), without §6 load balancing and
without churn (both refused with a reason code, see
:mod:`repro_torch.experiments.engine`).  Each training iteration does, on
``[S, N]`` scenario x worker tensors:

* §3 trace replay and the §4.2 event algebra with the §5.1 margin;
* §3 block subgradients for every task, in one call (kernel K1/K2);
* the iteration's §5 cache events in event-time order (kernel K3), or the
  sgd/gd fresh-result accumulation;
* the iterate update, the projection and, where ``eval_mask`` says so, the
  suboptimality.

State lives on the device and a Python loop over iterations replaces
``lax.scan``.  The grid body has no data-dependent host branch, so the loop
never reads a device value (no ``.item()``, no ``.cpu()``) until the results
are copied out at the end.  The lat table and the per-iteration outputs are
updated in place; the cache tables are replaced by the walk's outputs.

Exactness: event times, fresh counts, per-worker latencies and rejects do
not depend on the iterate, so they equal the reference exactly
(``tests/test_torch_parity.py``).  That needs float64 event state with
explicit dtypes (torch's default float is float32, and an int64 tensor
combined with a python float gives float32), and the §3 latency chain
evaluated one rounding per operator, left to right.  Eager torch launches
one kernel per operator and contracts nothing into an FMA, so the
reference's ``max(x, 0)`` seam against contraction is not needed here; do
not fuse the chain (``torch.compile``, a custom kernel) without a seam of
the same kind.  Subgradients, iterates and suboptimality differ from the
reference by float32 rounding of other summation orders and agree within a
stated tolerance.  Against the port's host engine and scalar simulator every
output is equal bit for bit (``tests/test_torch_engines.py``): each task's
subgradient is padded to the run's ``task_pad_width``, the iterates are
projected and evaluated one at a time (``core.problems``), and the coverage
is divided as numpy divides (:func:`exact_div`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.cluster.simulator import (
    MethodConfig,
    effective_w,
    margin_deadline,
    task_finish_time,
    task_pad_width,
)
from repro_torch.core.problems import FiniteSumProblem, FusedKernels
from repro_torch.experiments.engine import (
    EngineCapabilityError,
    EngineConfig,
    engine_capability,
    kernel_dtype_capability,
    kernel_shape_capability,
)
from repro_torch.experiments.sweep import task_latency_parts, trace_tensors
from repro_torch.kernels import block_sub, cache_events
from repro_torch.latency.model import FleetTraces
from repro_torch.lb.partitioner import p_start, p_stop

F64, I64 = torch.float64, torch.int64


@dataclasses.dataclass(frozen=True)
class _StaticSpec:
    """Static configuration of one run (``repro.experiments.fused._StaticSpec``
    restricted to the grid and none cache modes: ``uses_cache`` selects the
    grid cache)."""

    name: str
    w_wait: int
    eta: float
    margin: float  # effective margin (0.0 when unused)
    comp_scale: float
    process_full: bool
    uses_cache: bool
    accepts_stale: bool
    num_iterations: int
    base_start: tuple[int, ...]
    base_stop: tuple[int, ...]
    sub_p: tuple[int, ...]  # per-worker subpartition count p_i
    slot_offsets: tuple[int, ...]  # per-worker first slot (grid cache)
    slot_width: tuple[int, ...]  # per-slot interval width (grid cache)
    num_slots: int
    max_width: int  # the run's static pad width (task_pad_width)
    kernel_backend: str  # "cuda" | "torch"


def _static_spec(
    problem: FiniteSumProblem,
    config: MethodConfig,
    num_workers: int,
    num_iterations: int,
    cost_scale: float,
    kernel_backend: str,
) -> _StaticSpec:
    n = problem.num_samples
    N = num_workers
    cfg = config
    base_start = tuple(p_start(n, N, i + 1) for i in range(N))
    base_stop = tuple(p_stop(n, N, i + 1) for i in range(N))
    n_local = [b - a + 1 for a, b in zip(base_start, base_stop)]
    process_full = cfg.name in ("gd", "coded")
    sub_p = tuple(min(cfg.subpartitions, nl) for nl in n_local)
    if cfg.uses_cache:
        offsets = np.concatenate([[0], np.cumsum(sub_p)])
        slot_offsets = tuple(int(o) for o in offsets[:-1])
        num_slots = int(offsets[-1])
        sw = []
        for nl, p in zip(n_local, sub_p):
            sw.extend([k * nl // p - (k - 1) * nl // p for k in range(1, p + 1)])
        slot_width = tuple(sw)
    else:
        slot_offsets = (0,) * N
        num_slots = 0
        slot_width = ()
    margin_eff = cfg.margin if (cfg.uses_margin and cfg.margin > 0) else 0.0
    return _StaticSpec(
        name=cfg.name,
        w_wait=effective_w(cfg, N),
        eta=float(cfg.eta),
        margin=float(margin_eff),
        comp_scale=float(
            cost_scale * (1.0 / cfg.code_rate if cfg.name == "coded" else 1.0)
        ),
        process_full=process_full,
        uses_cache=cfg.uses_cache,
        accepts_stale=cfg.accepts_stale,
        num_iterations=num_iterations,
        base_start=base_start,
        base_stop=base_stop,
        sub_p=sub_p,
        slot_offsets=slot_offsets,
        slot_width=slot_width,
        num_slots=num_slots,
        max_width=task_pad_width(cfg, n, N),
        kernel_backend=kernel_backend,
    )


def _kernel_shape_errors(spec: _StaticSpec, kernels: FusedKernels, S: int, N: int) -> list:
    """What K1/K2 and K3 report of this run's launch shapes (None where
    they take them): the per-iteration subgradient call over S*N tasks, the
    coded call's S full-width tasks, and the cache walk over the events of
    an iteration (in-flight and fresh results for dsag, fresh ones for sag)."""
    n = kernels.num_samples
    vshape = kernels.value_shape
    d, k = vshape[0], (vshape[1] if len(vshape) == 2 else None)
    calls = [(S * N, spec.max_width)] + ([(S, n)] if spec.name == "coded" else [])
    errors = [block_sub.shape_error(G, n, d, k, W) for G, W in calls]
    if spec.uses_cache:
        R = 2 * N if spec.accepts_stale else N
        errors.append(cache_events.shape_error(S, R, spec.num_slots, int(np.prod(vshape))))
    return errors


def exact_div(a, n: int):
    """``a / n`` in float64 with one rounding, as numpy divides: a CUDA
    tensor divided by a python number is multiplied by its reciprocal
    instead, which can be an ulp off, so the divisor goes in as a tensor
    (filled on the device: no copy, no sync)."""
    return a.to(F64) / torch.full((), float(n), dtype=F64, device=a.device)


def _bcast(mask, value_ndim: int):
    """Reshape a mask so it broadcasts over trailing value dimensions."""
    return mask.reshape(mask.shape + (1,) * value_ndim)


def _subgradients(kernels: FusedKernels, spec: _StaticSpec, V, lo, hi):
    """``[S, N, ...]`` block subgradients of every task, in one call.

    The reference loops over its static width-bucket ladder (one dispatch
    per bucket); the kernels here loop over each task's exact width, so one
    call covers all widths.  Every task of the call is padded to the run's
    ``task_pad_width``, as in the host engine and the scalar simulator, so
    each task's value equals theirs bit for bit.
    """
    S, N = lo.shape
    vshape = kernels.value_shape
    # reshape of the expanded view may itself be a stride-0 view (S == 1):
    # the kernels take contiguous operands only
    Vb = V[:, None].expand((S, N) + vshape).reshape((S * N,) + vshape).contiguous()
    out = kernels.sub_blocks(
        Vb,
        lo.reshape(-1).contiguous(),
        (hi - lo + 1).reshape(-1),
        spec.kernel_backend,
        spec.max_width,
    )
    return out.reshape((S, N) + vshape)


def _apply_cache_events(
    spec: _StaticSpec,
    slot_width,
    cache_state,
    ev_valid,
    ev_time,
    ev_slot,
    ev_tag,
    ev_vals,
):
    """The §5 grid-cache update for one iteration's events.

    Events are ranked per scenario by a stable argsort on event time (+inf
    where invalid) and gathered into rank order outside the walk, as the
    reference's ``_apply_cache_events_pallas`` does; the walk itself is K3
    (``kernel_backend="cuda"``) or its plain version.  With a fixed slot
    grid an active exact-match slot is the only possible overlap, so the
    walk reduces to staleness dominance + in-place update.
    """
    st = cache_state
    S, R = ev_time.shape
    E = spec.num_slots
    vshape = st["values"].shape[2:]
    F = int(np.prod(vshape))
    order = torch.argsort(
        torch.where(ev_valid, ev_time, torch.inf), dim=1, stable=True
    )
    valid_r = ev_valid.gather(1, order)
    slot_r = ev_slot.gather(1, order).clamp(0, E - 1)
    tag_r = ev_tag.gather(1, order)
    vals_r = (
        ev_vals.reshape(S, R, F)
        .gather(1, order[:, :, None].expand(S, R, F))
        .to(F64)
    )
    walk = (
        cache_events.grid_cache_update
        if spec.kernel_backend == "cuda"
        else cache_events.grid_cache_update_plain
    )
    sums, values, iters, covered, rejected = walk(
        valid_r,
        slot_r,
        tag_r,
        vals_r,
        st["sums"].reshape(S, F),
        st["values"].reshape(S, E, F),
        st["iters"],
        st["covered"],
        st["rejected"],
        slot_width,
    )
    return dict(
        sums=sums.reshape(st["sums"].shape),
        values=values.reshape(st["values"].shape),
        iters=iters,
        covered=covered,
        rejected=rejected,
    )


def _fresh_accumulate(kernels, fresh, finish, vals):
    """gd/sgd: sum fresh values per scenario in event-time order."""
    S, N = fresh.shape
    vdim = len(kernels.value_shape)
    order = torch.argsort(torch.where(fresh, finish, torch.inf), dim=1, stable=True)
    valid_r = fresh.gather(1, order)
    vals_r = vals.gather(1, _bcast(order, vdim).expand(vals.shape)).to(F64)
    grad = torch.zeros((S,) + kernels.value_shape, dtype=F64, device=fresh.device)
    for j in range(N):
        grad = torch.where(_bcast(valid_r[:, j], vdim), grad + vals_r[:, j], grad)
    return grad


def _run_grid(kernels: FusedKernels, spec: _StaticSpec, tr: dict, V0, eval_mask):
    """THE per-iteration body and its driver loop (grid / none cache modes).

    ``tr`` holds the trace tensors (``comm``, ``comp_unit`` [S, N, K],
    ``slowdown`` [N], ``burst_start``/``burst_end``/``burst_factor``
    [S, N, M]) on the engine's device, all float64.  Returns device tensors
    ``(times [S, T], subopt [S, T], fresh_counts [S, T], lat [S, T, N],
    rejected [S])``.
    """
    dev = kernels.device
    S, N, _K = tr["comm"].shape
    T = spec.num_iterations
    n = kernels.num_samples
    vshape = kernels.value_shape
    vdim = len(vshape)
    base_start = torch.tensor(spec.base_start, dtype=I64, device=dev)
    base_stop = torch.tensor(spec.base_stop, dtype=I64, device=dev)
    n_local = base_stop - base_start + 1
    sub_p = torch.tensor(spec.sub_p, dtype=I64, device=dev)
    offsets = torch.tensor(spec.slot_offsets, dtype=I64, device=dev)
    slot_width = torch.tensor(spec.slot_width, dtype=I64, device=dev)
    E = spec.num_slots
    s_idx2 = torch.arange(S, device=dev)[:, None]
    w_idx2 = torch.arange(N, device=dev)[None, :]

    # -- carry (explicit dtypes throughout: torch's default float is f32) --
    V = V0
    free_at = torch.zeros((S, N), dtype=F64, device=dev)
    iter_end = torch.zeros((S,), dtype=F64, device=dev)
    draw_idx = torch.zeros((S, N), dtype=I64, device=dev)
    sub_k = torch.ones((S, N), dtype=I64, device=dev)
    flight_slot = torch.full((S, N), -1, dtype=I64, device=dev)
    flight_titer = torch.full((S, N), -1, dtype=I64, device=dev)
    flight_comp = torch.zeros((S, N), dtype=F64, device=dev)
    flight_comm = torch.zeros((S, N), dtype=F64, device=dev)
    flight_val = torch.zeros((S, N) + vshape, dtype=kernels.value_dtype, device=dev)
    if spec.uses_cache:  # the grid cache
        cache = dict(
            sums=torch.zeros((S,) + vshape, dtype=F64, device=dev),
            values=torch.zeros((S, max(E, 1)) + vshape, dtype=F64, device=dev),
            iters=torch.full((S, max(E, 1)), -1, dtype=I64, device=dev),
            covered=torch.zeros((S,), dtype=I64, device=dev),
            rejected=torch.zeros((S,), dtype=I64, device=dev),
        )
    else:
        cache = dict(rejected=torch.zeros((S,), dtype=I64, device=dev))
    lat = torch.full((S, T, N), torch.nan, dtype=F64, device=dev)
    times = torch.zeros((S, T), dtype=F64, device=dev)
    subopt = torch.full((S, T), torch.nan, dtype=F64, device=dev)
    fresh_counts = torch.zeros((S, T), dtype=I64, device=dev)

    for t in range(T):
        assign = iter_end
        idle = free_at <= assign[:, None]

        # -- the (lo, hi, slot) source: the fixed subpartition grid ---------
        if spec.process_full:
            lo = base_start.expand(S, N)
            hi = base_stop.expand(S, N)
        else:
            lo = base_start[None, :] + (sub_k - 1) * n_local[None, :] // sub_p[None, :]
            hi = base_start[None, :] + sub_k * n_local[None, :] // sub_p[None, :] - 1
        # int64 rows to float64 first: int64 * python float is float32 in torch
        cost = (kernels.cost_per_row * (hi - lo + 1).to(F64)) * spec.comp_scale

        # -- §3 trace replay (the latency lookups of replay_batch) ----------
        start = torch.where(idle, assign[:, None], free_at)
        comm_d, comp_d = task_latency_parts(tr, draw_idx, start, cost)

        # -- event resolution (the shared method-semantics helpers) ---------
        finish = task_finish_time(start, comp_d, comm_d)
        tau_w = torch.sort(finish, dim=1).values[:, spec.w_wait - 1]
        if spec.margin > 0.0:
            deadline = margin_deadline(tau_w, assign, spec.margin)
        else:
            deadline = tau_w
        started = idle | (free_at <= deadline[:, None])
        fresh = started & (finish <= deadline[:, None])
        stale_done = (~idle) & (free_at <= deadline[:, None])
        stale_ev = torch.where(stale_done, free_at, -torch.inf)
        fresh_ev = torch.where(fresh, finish, -torch.inf)
        iter_end_new = torch.maximum(
            torch.maximum(stale_ev.amax(dim=1), fresh_ev.amax(dim=1)), tau_w
        )

        # -- latency attribution by the task's own iteration ----------------
        titer_safe = flight_titer.clamp(0, T - 1)
        cur = lat[s_idx2, titer_safe, w_idx2]
        lat[s_idx2, titer_safe, w_idx2] = torch.where(
            stale_done, flight_comp + flight_comm, cur
        )
        lat[:, t, :] = torch.where(fresh, comp_d + comm_d, lat[:, t, :])

        # -- batched subgradients (skipped entirely for coded) --------------
        vals = _subgradients(kernels, spec, V, lo, hi) if spec.name != "coded" else None

        # -- §5 cache / gradient accumulation -------------------------------
        slot_cur = None
        if spec.uses_cache:
            slot_cur = offsets[None, :] + sub_k - 1
            tag_now = torch.full((S, N), t, dtype=I64, device=dev)
            if spec.accepts_stale:  # dsag: stale half then fresh half
                ev_valid = torch.cat([stale_done, fresh], dim=1)
                ev_time = torch.cat([free_at, finish], dim=1)
                ev_slot = torch.cat([flight_slot, slot_cur], dim=1)
                ev_tag = torch.cat([flight_titer, tag_now], dim=1)
                ev_vals = torch.cat([flight_val, vals], dim=1)
            else:  # sag: fresh results only
                ev_valid, ev_time, ev_slot, ev_tag, ev_vals = (
                    fresh, finish, slot_cur, tag_now, vals
                )
            cache = _apply_cache_events(
                spec, slot_width, cache, ev_valid, ev_time, ev_slot, ev_tag, ev_vals
            )
            xi = torch.clamp_min(exact_div(cache["covered"], n), 1e-12)
            grad = cache["sums"] / _bcast(xi, vdim) + kernels.regularizer_grad(V)
        elif spec.name == "coded":
            # idealized MDS bound: exact gradient at full-range width (the
            # CUDA QR of the PCA projection returns a non-contiguous V)
            g = kernels.sub_blocks(
                V.contiguous(),
                torch.ones((S,), dtype=I64, device=dev),
                torch.full((S,), n, dtype=I64, device=dev),
                spec.kernel_backend,
                n,
            ).to(F64)
            grad = g + kernels.regularizer_grad(V)
        elif spec.name == "gd":
            grad = _fresh_accumulate(kernels, fresh, finish, vals) + (
                kernels.regularizer_grad(V)
            )
        else:  # sgd: scale the partial sum by observed coverage
            grad_acc = _fresh_accumulate(kernels, fresh, finish, vals)
            covered_f = torch.where(fresh, hi - lo + 1, 0).sum(dim=1)
            xi = torch.clamp_min(exact_div(covered_f, n), 1e-12)
            grad = grad_acc / _bcast(xi, vdim) + kernels.regularizer_grad(V)

        # -- iterate update + suboptimality ---------------------------------
        # V stays in its float32 dtype; grad is float64
        V_new = kernels.project((V - spec.eta * grad).to(V.dtype))
        if eval_mask[t]:
            subopt[:, t] = kernels.suboptimality(V_new)

        # -- commit worker state for started tasks --------------------------
        if not spec.process_full:
            sub_k = torch.where(started, sub_k % sub_p[None, :] + 1, sub_k)
        free_at = torch.where(started, finish, free_at)
        draw_idx = draw_idx + started.to(I64)
        if spec.uses_cache:
            flight_slot = torch.where(started, slot_cur, flight_slot)
        flight_titer = torch.where(started, t, flight_titer)
        flight_comp = torch.where(started, comp_d, flight_comp)
        flight_comm = torch.where(started, comm_d, flight_comm)
        if spec.accepts_stale:
            flight_val = torch.where(_bcast(started, vdim), vals, flight_val)
        V = V_new
        iter_end = iter_end_new
        times[:, t] = iter_end_new
        fresh_counts[:, t] = fresh.sum(dim=1)

    return times, subopt, fresh_counts, lat, cache["rejected"]


def check_run(
    problem: FiniteSumProblem,
    traces: FleetTraces,
    config: MethodConfig,
    num_iterations: int,
    cost_scale: float,
    engine: EngineConfig,
):
    """The capability checks of a convergence run, shared by the device and
    host engines, before any launch: ``(spec, kernels)`` or
    :class:`~repro_torch.experiments.engine.EngineCapabilityError`."""
    cap = engine_capability(engine, config, traces)
    if not cap.supported:
        raise EngineCapabilityError(cap)
    if num_iterations > traces.horizon:
        raise ValueError(
            f"traces hold {traces.horizon} draws/worker but {num_iterations} "
            "iterations requested"
        )
    kernels = problem.fused_kernels(engine.device)
    dcap = kernel_dtype_capability(engine, kernels.value_dtype)
    if not dcap.supported:
        raise EngineCapabilityError(dcap)
    spec = _static_spec(
        problem, config, traces.num_workers, num_iterations, cost_scale,
        engine.kernel_backend,
    )
    errors = _kernel_shape_errors(spec, kernels, traces.num_scenarios, traces.num_workers)
    scap = kernel_shape_capability(engine, errors)
    if not scap.supported:
        raise EngineCapabilityError(scap)
    return spec, kernels


def prepare_scan_inputs(
    problem: FiniteSumProblem,
    traces: FleetTraces,
    config: MethodConfig,
    num_iterations: int,
    *,
    cost_scale: float = 1.0,
    eval_every: int = 1,
    seed: int = 0,
    engine: EngineConfig | None = None,
    V0: np.ndarray | None = None,
):
    """Capability checks, static spec, kernels, and the device operands.

    Raises :class:`~repro_torch.experiments.engine.EngineCapabilityError`
    for configurations the engine cannot run.  ``V0`` overrides the
    problem's initial iterate (numpy; broadcast over scenarios).
    """
    eng = EngineConfig() if engine is None else engine
    T = num_iterations
    spec, kernels = check_run(problem, traces, config, T, cost_scale, eng)
    S = traces.num_scenarios
    dev = kernels.device
    v0 = problem.init(seed) if V0 is None else np.asarray(V0)
    V0_stack = torch.as_tensor(np.repeat(v0[None], S, axis=0), device=dev)
    eval_mask = np.zeros(T, dtype=bool)
    eval_mask[::eval_every] = True
    eval_mask[T - 1] = True

    return spec, kernels, trace_tensors(traces, dev), V0_stack, eval_mask


def run_convergence_scan(
    problem: FiniteSumProblem,
    traces: FleetTraces,
    config: MethodConfig,
    num_iterations: int,
    *,
    cost_scale: float = 1.0,
    eval_every: int = 1,
    seed: int = 0,
    engine: EngineConfig | None = None,
    V0: np.ndarray | None = None,
):
    """Train ``config`` on every scenario of ``traces`` on the engine's device.

    Returns a :class:`~repro_torch.experiments.convergence.
    ConvergenceBatchResult` of numpy arrays with the reference's shapes.
    """
    from repro_torch.experiments.convergence import ConvergenceBatchResult

    spec, kernels, tr, V0_stack, eval_mask = prepare_scan_inputs(
        problem,
        traces,
        config,
        num_iterations,
        cost_scale=cost_scale,
        eval_every=eval_every,
        seed=seed,
        engine=engine,
        V0=V0,
    )
    times, subopt, fresh, lat, rejected = (
        o.cpu().numpy() for o in _run_grid(kernels, spec, tr, V0_stack, eval_mask)
    )
    S = traces.num_scenarios
    return ConvergenceBatchResult(
        times=times,
        suboptimality=subopt,
        fresh_counts=fresh.astype(np.int64),
        per_worker_latency=lat,
        repartition_events=[[] for _ in range(S)],
        evictions=np.zeros(S, dtype=np.int64),
        rejected_stale=rejected.astype(np.int64),
    )
