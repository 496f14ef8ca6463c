"""The fused convergence engine's body, on a torch device.

Counterpart of ``repro.experiments.fused``.  Each training iteration does,
on ``[S, N]`` scenario x worker tensors:

* under churn (traces carrying a ``ChurnSchedule``), the liveness at
  assignment: dead workers' in-flight tasks are discarded and their §5
  cache entries cleared (:func:`_clear_dead_dense`,
  :func:`_clear_dead_tiled`), and under §6 a change of churn row drops the
  contribution floor and restarts the profiler window at the boundary;
* under §6 load balancing, the Algorithm-2 alignment of pending
  repartitions at assignment (the (lo, hi, slot) source is then the
  aligned candidate instead of the fixed subpartition grid);
* §3 trace replay (under churn, the slowdown row at each task's start) and
  the §4.2 event algebra with the §5.1 margin (under churn, the wait is for
  ``min(w, #alive)`` of the living fleet, by a sort and a gather);
* §3 block subgradients for every task, in one call (kernel K1/K2);
* the iteration's §5 cache events in event-time order, by
  ``spec.cache_mode``: ``"grid"`` (no §6: kernel K3) or ``"tiled"`` (§6:
  per-worker active-entry tables over the ladder's slot universe); or the
  sgd/gd fresh-result accumulation;
* the iterate update, the projection and, where ``eval_mask`` says so, the
  suboptimality;
* under §6, the profiler feed into task slots and, when a scenario is due,
  one batched Algorithm-1 call (:mod:`repro_torch.lb.jit_optimizer`).

State lives on the device and a Python loop over iterations replaces
``lax.scan``.  The grid body has no data-dependent host branch, so the loop
never reads a device value (no ``.item()``, no ``.cpu()``) until the results
are copied out at the end; under churn with deaths it reads one per
iteration, the clears' trip count (the deepest per-scenario clear).  The §6
body reads a few (whether a scenario is due, the walks' rank counts,
Algorithm 1's loop conditions): the reference's ``while_loop``s and
``lax.cond``s are host branches here.  The
tiled walk is plain torch (the reference has no TPU kernel for it); like
the reference's it keeps the big value table write-only inside the rank
loop and reads live values from the ranked event table or a frozen copy of
the loop-entry table.  The reference also has a dense walk over the whole
slot universe for universes within its slot budget; the port keeps only
the tiled one, which holds every config the dense one does (a worker's
active entries never outnumber its universe) in fewer resident entries.

Scenario sharding (``EngineConfig(num_devices=...)`` or ``mesh=``, the
reference's ``shard_map`` over its ``"data"`` axis): the batch is
edge-padded to a multiple of the mesh's D shards and split, each shard runs
this body on its own device in a thread of its own (on a card, on a stream
of its own; shards that share a device take turns), and the outputs are
gathered in shard order and sliced back (:func:`prepare_scan_inputs`,
:func:`run_convergence_scan`).

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
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.cluster.simulator import (
    MethodConfig,
    effective_w,
    lb_ladder_for,
    margin_deadline,
    task_finish_time,
    task_pad_width,
)
from repro_torch.core.gradient_cache import (
    SlotUniverse,
    active_slot_capacity,
    build_slot_universe,
)
from repro_torch.core.problems import FiniteSumProblem, FusedKernels
from repro_torch.experiments.engine import (
    CAP_ACTIVE_SET,
    CAP_OK,
    CAP_TILED,
    EngineCapability,
    EngineCapabilityError,
    EngineConfig,
    engine_capability,
    kernel_dtype_capability,
    kernel_shape_capability,
    scenario_mesh,
)
from repro_torch.experiments.sweep import churn_rows, task_latency_parts, trace_tensors, wait_for
from repro_torch.kernels import block_sub, cache_events, what_if
from repro_torch.latency.model import FleetTraces
from repro_torch.lb import jit_optimizer as jlb
from repro_torch.lb.optimizer import what_if_normals as default_what_if_normals
from repro_torch.lb.partitioner import p_start, p_stop

F64, I64 = torch.float64, torch.int64
_IMAX = torch.iinfo(torch.int64).max

#: default budget on the tiled §6 cache's resident entries per scenario:
#: configs whose active-entry footprint exceeds it are unsupported by the
#: device engine.  Override per run with ``EngineConfig(slot_budget=...)``.
LB_MAX_SLOTS = 250_000


@dataclasses.dataclass(frozen=True)
class _StaticSpec:
    """Static configuration of one run (``repro.experiments.fused._StaticSpec``)."""

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
    cache_mode: str = "none"  # "none" | "grid" | "tiled"
    active_cap: int = 0  # per-worker entry capacity of the tiled cache
    # §6 load balancing (empty/zero without it)
    load_balance: bool = False
    ladder: tuple[int, ...] = ()  # the p-ladder Algorithm 1 climbs
    lb_interval: float = 0.0
    lb_startup_delay: float = 0.0
    lb_margin: float = 0.0  # optimizer-input margin (= config.margin)
    lb_p0: int = 0  # the optimizer-facing initial p (config.subpartitions)
    # elastic-fleet churn: the traces carry a ChurnSchedule
    has_churn: bool = False


def _static_spec(
    problem: FiniteSumProblem,
    config: MethodConfig,
    num_workers: int,
    num_iterations: int,
    cost_scale: float,
    kernel_backend: str,
    universe: SlotUniverse | None = None,
    active_cap: int = 0,
    has_churn: bool = False,
) -> _StaticSpec:
    n = problem.num_samples
    N = num_workers
    cfg = config
    base_start = tuple(p_start(n, N, i + 1) for i in range(N))
    base_stop = tuple(p_stop(n, N, i + 1) for i in range(N))
    n_local = [b - a + 1 for a, b in zip(base_start, base_stop)]
    process_full = cfg.name in ("gd", "coded")
    sub_p = tuple(min(cfg.subpartitions, nl) for nl in n_local)
    if cfg.uses_cache and cfg.load_balance:
        # slots come from the universe tables (the host engine builds none)
        slot_offsets = (0,) * N
        num_slots = 0 if universe is None else universe.num_slots
        slot_width = ()
        cache_mode = "tiled"
    elif cfg.uses_cache:
        cache_mode = "grid"
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
        cache_mode = "none"
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
        cache_mode=cache_mode,
        active_cap=int(active_cap),
        load_balance=bool(cfg.load_balance),
        ladder=lb_ladder_for(cfg, np.asarray(n_local)) if cfg.load_balance else (),
        lb_interval=float(cfg.lb_interval),
        lb_startup_delay=float(cfg.lb_startup_delay),
        lb_margin=float(cfg.margin),
        lb_p0=int(cfg.subpartitions),
        has_churn=bool(has_churn),
    )


def _kernel_shape_errors(spec: _StaticSpec, kernels: FusedKernels, S: int, N: int) -> list:
    """What K1/K2 and K3 report of this run's launch shapes (None where
    they take them): the per-iteration subgradient call over S*N tasks, the
    coded call's S full-width tasks, and the cache walk over the events of
    an iteration (in-flight and fresh results for dsag, fresh ones for sag;
    the grid cache only: the §6 walks are plain torch), and under §6 K7's
    what-if replay over the fleet."""
    n = kernels.num_samples
    vshape = kernels.value_shape
    d, k = vshape[0], (vshape[1] if len(vshape) == 2 else None)
    calls = [(S * N, spec.max_width)] + ([(S, n)] if spec.name == "coded" else [])
    errors = [block_sub.shape_error(G, n, d, k, W) for G, W in calls]
    if spec.cache_mode == "grid":
        R = 2 * N if spec.accepts_stale else N
        errors.append(cache_events.shape_error(S, R, spec.num_slots, int(np.prod(vshape))))
    if spec.load_balance:
        errors.append(what_if.shape_error(N, spec.w_wait))
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


def _rank_events(ev_valid, ev_time, ev_slot, ev_tag, ev_vals, E: int):
    """The event tables in per-scenario event-time rank order (a stable
    argsort on time, +inf where invalid): valid, slot, tag, float64 values."""
    S, R = ev_time.shape
    vdim = ev_vals.dim() - 2
    order = torch.argsort(torch.where(ev_valid, ev_time, torch.inf), dim=1, stable=True)
    valid_r = ev_valid.gather(1, order)
    slot_r = ev_slot.gather(1, order).clamp(0, E - 1)
    tag_r = ev_tag.gather(1, order)
    vals_r = ev_vals.gather(1, _bcast(order, vdim).expand(ev_vals.shape)).to(F64)
    return order, valid_r, slot_r, tag_r, vals_r


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
    _, valid_r, slot_r, tag_r, vals_r = _rank_events(
        ev_valid, ev_time, ev_slot, ev_tag, ev_vals, E)
    walk = (
        cache_events.grid_cache_update
        if spec.kernel_backend == "cuda"
        else cache_events.grid_cache_update_plain
    )
    sums, values, iters, covered, rejected = walk(
        valid_r,
        slot_r,
        tag_r,
        vals_r.reshape(S, R, F),
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


def _apply_cache_events_tiled(spec: _StaticSpec, tabs: dict, ev_worker, cache_state,
                              ev_valid, ev_time, ev_slot, ev_tag, ev_vals):
    """The §5 update over per-worker active-entry tables, the tiled §6 cache
    (``repro.experiments.fused._apply_cache_events_tiled``).

    Each worker owns ``spec.active_cap`` entry rows (``slots``, ``iters``,
    values): the greedy bound on simultaneously active disjoint intervals
    of its universe.  Overlaps are tested at run time against the event
    worker's own entries from the universe's start/stop tables; eviction
    subtraction runs in interval-start order, and the insert lands in the
    exact active entry (in-place delta) or the first free row.  The value
    table ``[S, N, A, ...]`` is only written inside the rank loop: the live
    value of an entry is the ranked event row of its last accepted write
    this iteration (``wmap``), or the frozen loop-entry table ``values0``.
    """
    st = cache_state
    S, R = ev_time.shape
    E = spec.num_slots
    starts, stops, widths = tabs["starts"], tabs["stops"], tabs["widths"]
    values0 = st["values"]  # [S, N, A, *vshape], frozen (read-only below)
    values = values0.clone()
    N, A = values.shape[1], values.shape[2]
    vdim = values.dim() - 3
    dev = ev_time.device
    order, valid_r, slot_r, tag_r, vals_r = _rank_events(
        ev_valid, ev_time, ev_slot, ev_tag, ev_vals, E)
    worker_r = ev_worker[None, :].expand(S, R).gather(1, order)
    sums, iters, slots = st["sums"], st["iters"].clone(), st["slots"].clone()
    covered, rejected, evictions = st["covered"], st["rejected"], st["evictions"]
    wmap = torch.full((S, N, A), -1, dtype=I64, device=dev)
    s_idx = torch.arange(S, device=dev)
    s_col = s_idx[:, None]
    a_idx = torch.arange(A, device=dev)
    n_ranks = int(valid_r.sum(dim=1).max())
    for j in range(n_ranks):
        valid, slot, tag, v64 = valid_r[:, j], slot_r[:, j], tag_r[:, j], vals_r[:, j]
        w_e = worker_r[:, j]
        # the event worker's entry rows: [S, A] gathers of small tables
        es = slots[s_idx, w_e]
        ei = iters[s_idx, w_e]
        wm = wmap[s_idx, w_e]
        active = ei >= 0
        es_safe = es.clamp(0, E - 1)
        e_lo, e_hi = starts[es_safe], stops[es_safe]
        ev_lo, ev_hi = starts[slot][:, None], stops[slot][:, None]
        ovl = active & (e_lo <= ev_hi) & (ev_lo <= e_hi)
        exact = ovl & (es == slot[:, None])
        dom = (ovl & (ei >= tag[:, None])).any(dim=1)
        acc = valid & ~dom
        rej = valid & dom
        evict = ovl & ~exact & acc[:, None]
        # live entry values, reconstructed (write-only table discipline)
        v_live = torch.where(_bcast(wm >= 0, vdim), vals_r[s_col, wm.clamp(0, R - 1)],
                             values0[s_col, w_e[:, None], a_idx[None, :]])  # [S, A, ...]
        # eviction subtraction in interval-start order (distinct starts)
        ord_e = torch.argsort(torch.where(evict, e_lo, _IMAX), dim=1, stable=True)
        n_sub = int(evict.sum(dim=1).max())
        for o in range(n_sub):
            eidx = ord_e[:, o]
            m = evict[s_idx, eidx]
            sums = torch.where(_bcast(m, vdim), sums - v_live[s_idx, eidx], sums)
        ei = torch.where(evict, -1, ei)
        removed = torch.where(evict, widths[es_safe], 0).sum(dim=1)
        evictions = evictions + evict.sum(dim=1)
        # insert target: the exact active entry, else the first free row
        exact_any = exact.any(dim=1)
        tgt = torch.where(exact_any, torch.argmax(exact.to(torch.int8), dim=1),
                          torch.argmax((ei < 0).to(torch.int8), dim=1))
        own_live = v_live[s_idx, tgt]
        delta = v64 - torch.where(_bcast(exact_any, vdim), own_live, 0.0)
        sums = torch.where(_bcast(acc, vdim), sums + delta, sums)
        values[s_idx, w_e, tgt] = torch.where(_bcast(acc, vdim), v64, own_live)
        ei[s_idx, tgt] = torch.where(acc, tag, ei[s_idx, tgt])
        es[s_idx, tgt] = torch.where(acc, slot, es[s_idx, tgt])
        wm[s_idx, tgt] = torch.where(acc, j, wm[s_idx, tgt])
        iters[s_idx, w_e] = ei
        slots[s_idx, w_e] = es
        wmap[s_idx, w_e] = wm
        covered = covered + torch.where(
            acc, torch.where(exact_any, 0, widths[slot]) - removed, 0)
        rejected = rejected + rej
    return dict(sums=sums, values=values, iters=iters, slots=slots, covered=covered,
                rejected=rejected, evictions=evictions)


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


def _subtract_in_order(sums, values_f, clear_f, order_key):
    """``sums`` minus every cleared entry of ``values_f`` ``[S, E, ...]``
    (``clear_f`` ``[S, E]``), one entry at a time in ascending
    ``order_key``, the host caches' float grouping.  Reads the trip count,
    the deepest per-scenario clear, on the host (0: nothing to do)."""
    S = clear_f.shape[0]
    vdim = values_f.dim() - 2
    n_clear = int(clear_f.sum(dim=1).max())
    if n_clear:
        s_idx = torch.arange(S, device=clear_f.device)
        order = torch.argsort(torch.where(clear_f, order_key, _IMAX), dim=1, stable=True)
        for j in range(n_clear):
            e = order[:, j]
            sums = torch.where(_bcast(clear_f[s_idx, e], vdim), sums - values_f[s_idx, e], sums)
    return sums, n_clear


def _clear_dead_dense(slot_width, cache_state, clear, order_key):
    """Drop dead workers' active §5 entries from the grid cache ``[S, E]``
    (``repro.experiments.fused._clear_dead_dense``, an XLA ``fori_loop``
    there, eager torch here: no TPU kernel to port).

    The churn twin of ``GradientCache.clear_range``: ``clear`` marks the
    entries to remove, and the sums subtract them one at a time in interval
    start order (``order_key``: the slot index, which is start order in the
    grid).  The host caches clear per dead worker in worker order over
    disjoint, worker-ordered base ranges, each worker's entries start
    ascending, so one start-ascending walk has their float grouping.  A
    batched sum would not.  Clearing is not an eviction.  Cleared slots
    keep their stale values: tag -1 makes them empty to the next walk (K3
    takes an inactive slot's old value as 0).
    """
    st = cache_state
    sums, n_clear = _subtract_in_order(st["sums"], st["values"], clear, order_key[None, :])
    if not n_clear:
        return st
    return dict(st, sums=sums,
                covered=st["covered"] - torch.where(clear, slot_width[None, :], 0).sum(dim=1),
                iters=torch.where(clear, -1, st["iters"]))


def _clear_dead_tiled(spec: _StaticSpec, tabs: dict, cache_state, dead):
    """Dead workers' §5 clear in the tiled §6 cache's per-worker entry
    tables (``repro.experiments.fused._clear_dead_tiled``): the order
    contract of :func:`_clear_dead_dense`, with each entry's interval start
    from the universe tables as the key.  Cleared rows keep their stale
    slot and value; ``iters == -1`` hides them from the overlap test and
    the free-row search."""
    st = cache_state
    iters = st["iters"]  # [S, N, A]
    S, N, A = iters.shape
    clear = dead[:, :, None] & (iters >= 0)
    es_safe = st["slots"].clamp(0, spec.num_slots - 1)
    values_f = st["values"].reshape((S, N * A) + st["values"].shape[3:])
    sums, n_clear = _subtract_in_order(st["sums"], values_f, clear.reshape(S, N * A),
                                       tabs["starts"][es_safe].reshape(S, N * A))
    if not n_clear:
        return st
    return dict(st, sums=sums,
                covered=st["covered"] - torch.where(clear, tabs["widths"][es_safe], 0)
                .sum(dim=(1, 2)),
                iters=torch.where(clear, -1, iters))


def _cache_state0(spec: _StaticSpec, S: int, N: int, vshape, dev) -> dict:
    E = max(spec.num_slots, 1)

    def zeros(shape, dtype=F64):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def empty_tags(shape):
        return torch.full(shape, -1, dtype=I64, device=dev)

    counters = dict(covered=zeros((S,), I64), rejected=zeros((S,), I64))
    if spec.cache_mode == "grid":
        return dict(sums=zeros((S,) + vshape), values=zeros((S, E) + vshape),
                    iters=empty_tags((S, E)), **counters)
    if spec.cache_mode == "tiled":
        A = max(spec.active_cap, 1)
        return dict(sums=zeros((S,) + vshape), values=zeros((S, N, A) + vshape),
                    iters=empty_tags((S, N, A)), slots=empty_tags((S, N, A)),
                    evictions=zeros((S,), I64), **counters)
    return dict(rejected=zeros((S,), I64))


def _run_scan(kernels: FusedKernels, spec: _StaticSpec, tr: dict, V0, eval_mask,
              tabs: dict, normals):
    """THE per-iteration body and its loop over iterations, for every configuration.

    ``tr`` holds the trace tensors (``comm``, ``comp_unit`` [S, N, K],
    ``slowdown`` [N], ``burst_start``/``burst_end``/``burst_factor``
    [S, N, M], float64; under churn the schedule's tables, see
    :func:`~repro_torch.experiments.sweep.trace_tensors`) on the engine's
    device; ``tabs`` the §6 slot
    universe's tables (``slot_table`` [N, L, Pmax], ``widths``, ``starts``,
    ``stops`` [E]; empty without §6) and
    ``normals`` the what-if draws' ``[2, N, K]`` base (None without §6).
    Returns device tensors ``(times [S, T], subopt [S, T], fresh_counts
    [S, T], lat [S, T, N], rejected [S], evictions [S], published [S, T])``.
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
    s_idx2 = torch.arange(S, device=dev)[:, None]
    w_idx2 = torch.arange(N, device=dev)[None, :]
    ev_worker = torch.arange(N, device=dev).repeat(2 if spec.accepts_stale else 1)

    lb = spec.load_balance
    churn = spec.has_churn
    if churn:
        # boundary_before: the time that opened each churn row (-inf for row
        # 0), the §6 re-profiling cutoff after a fleet change
        churn_bound = torch.cat([torch.full((1,), -torch.inf, dtype=F64, device=dev),
                                 tr["churn_times"]])
        # a schedule without deaths (a §7.2 slowdown removal) clears nothing
        deaths = not bool(tr["churn_alive"].all())
        if spec.cache_mode == "grid":
            # per-worker contiguous slot blocks: index order is start order
            owner_of_slot = torch.repeat_interleave(
                torch.arange(N, device=dev), torch.tensor(spec.sub_p, device=dev))
            clear_key = torch.arange(spec.num_slots, dtype=I64, device=dev)
    if lb:
        L = len(spec.ladder)
        raw = torch.tensor(spec.ladder, dtype=I64, device=dev)
        # the per-worker effective ladder (the int twin of ladder_tables)
        eff = torch.minimum(raw[None, :], n_local[:, None])  # [N, L]
        idx_cap = torch.clamp_max((raw[None, :] < n_local[:, None]).sum(dim=1), L - 1)
        n_j_b = n_local.to(F64).expand(S, N)

        def snap_int(p_vals):
            """Ladder index of exact-member p values ([S, N] int)."""
            cnt = (eff[None, :, :] <= p_vals[:, :, None]).sum(dim=-1)
            return torch.minimum(torch.clamp_min(cnt - 1, 0), idx_cap[None, :])

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
    cache = _cache_state0(spec, S, N, vshape, dev)
    lat = torch.full((S, T, N), torch.nan, dtype=F64, device=dev)
    times = torch.zeros((S, T), dtype=F64, device=dev)
    subopt = torch.full((S, T), torch.nan, dtype=F64, device=dev)
    fresh_counts = torch.zeros((S, T), dtype=I64, device=dev)
    published = torch.zeros((S, T), dtype=torch.bool, device=dev)
    if lb:
        idx0 = torch.clamp(
            (eff <= sub_p[:, None]).sum(dim=1) - 1, min=0
        ).minimum(idx_cap)
        sub_idx = idx0.expand(S, N).clone()
        pending_p = torch.full((S, N), -1, dtype=I64, device=dev)
        # current_p is the optimizer's view of the published p
        current_p = torch.full((S, N), spec.lb_p0, dtype=I64, device=dev)
        h_min = torch.full((S,), torch.nan, dtype=F64, device=dev)
        next_lb = torch.full((S,), spec.lb_startup_delay, dtype=F64, device=dev)
        flight_assigned = torch.zeros((S, N), dtype=F64, device=dev)
        prof_t = torch.zeros((S, N, T), dtype=F64, device=dev)
        prof_comm = torch.zeros((S, N, T), dtype=F64, device=dev)
        prof_comp = torch.zeros((S, N, T), dtype=F64, device=dev)
        prof_valid = torch.zeros((S, N, T), dtype=torch.bool, device=dev)
        if churn:
            # churn times are > 0, so row 0 is active at t = 0, opened at -inf
            prev_row = torch.zeros((S,), dtype=I64, device=dev)
            lb_since = torch.full((S,), -torch.inf, dtype=F64, device=dev)

    for t in range(T):
        assign = iter_end
        if churn:
            # liveness sampled once per iteration, at the assignment: a worker
            # dead now has its in-flight completion discarded (idle, with no
            # stale event, cache write or profiler sample)
            rows_assign = churn_rows(tr, assign)
            alive = tr["churn_alive"][rows_assign]
            free_at = torch.where(alive, free_at, assign[:, None])
            if lb:
                # the fleet changed: drop the contribution floor so Algorithm
                # 1 re-baselines, and re-profile from the churn boundary
                changed = rows_assign != prev_row
                h_min = torch.where(changed, torch.nan, h_min)
                lb_since = torch.where(changed, churn_bound[rows_assign], lb_since)
                prev_row = rows_assign
            if spec.uses_cache and deaths:
                if spec.cache_mode == "tiled":
                    cache = _clear_dead_tiled(spec, tabs, cache, ~alive)
                else:
                    clear = (~alive)[:, owner_of_slot] & (cache["iters"] >= 0)
                    cache = _clear_dead_dense(slot_width, cache, clear, clear_key)
        idle = free_at <= assign[:, None]

        # -- the (lo, hi, slot) source --------------------------------------
        if lb:
            # Algorithm-2 alignment of pending repartitions (tentative: the
            # new (p, k) is committed only for workers that start a task)
            cur_p = eff[w_idx2, sub_idx]
            p_req = torch.minimum(torch.clamp_min(pending_p, 1), n_local[None, :])
            needs = (pending_p >= 0) & (p_req != cur_p)
            if bool(needs.any()):
                _, k_new = jlb.align_batch(n_local[None, :], cur_p, p_req, sub_k, needs)
                cand_idx = torch.where(needs, snap_int(p_req), sub_idx)
                cand_k = torch.where(needs, k_new, sub_k)
                cand_p = torch.where(needs, p_req, cur_p)
            else:
                cand_idx, cand_k, cand_p = sub_idx, sub_k, cur_p
        else:
            cand_k, cand_p = sub_k, sub_p[None, :]
        if spec.process_full:
            lo = base_start.expand(S, N)
            hi = base_stop.expand(S, N)
        else:
            lo = base_start[None, :] + (cand_k - 1) * n_local[None, :] // cand_p
            hi = base_start[None, :] + cand_k * n_local[None, :] // cand_p - 1
        # int64 rows to float64 first: int64 * python float is float32 in torch
        cost = (kernels.cost_per_row * (hi - lo + 1).to(F64)) * spec.comp_scale

        # -- §3 trace replay (the latency lookups of replay_batch) ----------
        start = torch.where(idle, assign[:, None], free_at)
        comm_d, comp_d = task_latency_parts(tr, draw_idx, start, cost)

        # -- event resolution (the shared method-semantics helpers) ---------
        finish = task_finish_time(start, comp_d, comm_d)
        if churn:  # the w_eff-th finish of the living fleet
            tau_w = wait_for(finish, spec.w_wait, alive)
        else:
            tau_w = torch.sort(finish, dim=1).values[:, spec.w_wait - 1]
        if spec.margin > 0.0:
            deadline = margin_deadline(tau_w, assign, spec.margin)
        else:
            deadline = tau_w
        started = idle | (free_at <= deadline[:, None])
        if churn:
            started = started & alive
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

        if lb:
            # -- §6.1 profiler feed: one task-slot sample per observed
            # completion (the MomentBuffer's slots and expressions)
            stale_comm = torch.clamp_min((free_at - flight_assigned) - flight_comp, 0.0)
            for buf, val in ((prof_t, free_at), (prof_comm, stale_comm), (prof_comp, flight_comp)):
                buf[s_idx2, w_idx2, titer_safe] = torch.where(
                    stale_done, val, buf[s_idx2, w_idx2, titer_safe])
            prof_valid[s_idx2, w_idx2, titer_safe] |= stale_done
            fresh_comm = torch.clamp_min((finish - assign[:, None]) - comp_d, 0.0)
            for buf, val in ((prof_t, finish), (prof_comm, fresh_comm), (prof_comp, comp_d)):
                buf[:, :, t] = torch.where(fresh, val, buf[:, :, t])
            prof_valid[:, :, t] |= fresh

        # -- batched subgradients (skipped entirely for coded) --------------
        vals = _subgradients(kernels, spec, V, lo, hi) if spec.name != "coded" else None

        # -- §5 cache / gradient accumulation -------------------------------
        slot_cur = None
        if spec.uses_cache:
            if lb:
                slot_cur = tabs["slot_table"][w_idx2, cand_idx, cand_k - 1]
            else:
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
            events = (ev_valid, ev_time, ev_slot, ev_tag, ev_vals)
            if spec.cache_mode == "tiled":
                cache = _apply_cache_events_tiled(spec, tabs, ev_worker, cache, *events)
            else:
                cache = _apply_cache_events(spec, slot_width, cache, *events)
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
        if lb:
            sub_idx = torch.where(started, cand_idx, sub_idx)
            pending_p = torch.where(started, -1, pending_p)
            flight_assigned = torch.where(started, assign[:, None], flight_assigned)
            if spec.process_full:
                sub_k = torch.where(started, cand_k, sub_k)
        if not spec.process_full:
            sub_k = torch.where(started, cand_k % cand_p + 1, sub_k)
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

        # -- §6 background load balancer (Algorithm 1) ----------------------
        if lb:
            due = iter_end_new >= next_lb
            if bool(due.any()):
                e_cm, v_cm, e_cp, v_cp, cnt = jlb.window_moments(
                    prof_t, prof_comm, prof_comp, prof_valid, iter_end_new,
                    jlb.PROFILER_WINDOW, since=lb_since if churn else None,
                )
                ready = cnt >= 1
                if churn:
                    ready = ready | ~alive  # dead workers produce no samples
                ready = ready.all(dim=1)
                next_lb = torch.where(due, iter_end_new + spec.lb_interval, next_lb)
                act = due & ready
                if bool(act.any()):
                    # the make_optimizer_inputs variance floors
                    p_new, h_min, _, publish = jlb.lb_update(
                        current_p.to(F64), e_cm, torch.clamp_min(v_cm, 1e-18), e_cp,
                        torch.clamp_min(v_cp, 1e-18), n_j_b, h_min, act,
                        ladder=spec.ladder, w=spec.w_wait, margin=spec.lb_margin,
                        normals=normals, kernel_backend=spec.kernel_backend,
                        alive=alive if churn else None,
                    )
                    changed = publish[:, None] & (p_new != current_p)
                    pending_p = torch.where(changed, p_new, pending_p)
                    current_p = torch.where(publish[:, None], p_new, current_p)
                    published[:, t] = publish

    evictions = cache.get("evictions", torch.zeros((S,), dtype=I64, device=dev))
    return times, subopt, fresh_counts, lat, cache["rejected"], evictions, published


def scan_capability(problem: FiniteSumProblem, config: MethodConfig, num_workers: int, *,
                    slot_budget: int | None = None) -> EngineCapability:
    """How the device engine would hold this config's §6 cache
    (``repro.experiments.fused.scan_capability``).

    * ``ok`` — supported, no §6 cache (no load balancing, or sgd/gd);
    * ``slot-universe-tiled`` — supported; the §6 cache is held in
      per-worker active-entry tables whose resident entries fit
      ``slot_budget`` (default :data:`LB_MAX_SLOTS`);
    * ``active-slots-exceed-budget`` — unsupported: the tiled cache's
      resident entries exceed the budget (``kind="auto"`` runs the host
      engine; ``kind="scan"`` raises).

    The bounds are cheap overestimates (no universe is built): the slot
    universe ``N * sum(min(rung, max n_local))`` (``slots_total``, reported
    only); the resident entries, per worker, the count of its narrowest
    intervals that fit its range, which the exact greedy capacity never
    exceeds.  Unlike the reference, the port keeps no dense cache over the
    whole universe for small universes: the tiled one holds every config
    the dense one would, so the budget only decides whether the device
    engine runs the config at all.
    """
    budget = int(LB_MAX_SLOTS if slot_budget is None else slot_budget)
    if not (config.load_balance and config.uses_cache):
        return EngineCapability(True, CAP_OK, "the device engine runs this config",
                                slot_budget=budget)
    n = problem.num_samples
    N = num_workers
    n_local = np.array([p_stop(n, N, i + 1) - p_start(n, N, i + 1) + 1 for i in range(N)])
    ladder = lb_ladder_for(config, n_local)
    total = int(sum(min(int(r), int(n_local.max())) for r in ladder)) * N
    p_top = max(int(r) for r in ladder)
    cap = 0
    for nl in n_local:
        w_min = max(int(nl) // min(p_top, int(nl)), 1)
        cap = max(cap, int(nl) // w_min)
    resident = N * cap
    if resident <= budget:
        return EngineCapability(
            True, CAP_TILED,
            f"§6 cache: the tiled active-slot tables hold <= {resident} resident "
            f"entries (slot budget {budget}) of a slot universe of up to {total}",
            slots_total=total, slots_resident=resident, slot_budget=budget,
        )
    return EngineCapability(
        False, CAP_ACTIVE_SET,
        f"the tiled active-slot cache needs up to {resident} resident entries "
        f"(> slot budget {budget}); the device engine cannot hold this config: use "
        f"EngineConfig(kind='host') or raise slot_budget",
        slots_total=total, slots_resident=resident, slot_budget=budget,
    )


def check_run(
    problem: FiniteSumProblem,
    traces: FleetTraces,
    config: MethodConfig,
    num_iterations: int,
    cost_scale: float,
    engine: EngineConfig,
    universe: SlotUniverse | None = None,
    active_cap: int = 0,
    num_scenarios: int | None = None,
    device=None,
):
    """The capability checks of a convergence run, shared by the device and
    host engines, before any launch: ``(spec, kernels)`` or
    :class:`~repro_torch.experiments.engine.EngineCapabilityError`.  The
    kernels' launch shapes are checked at ``num_scenarios`` (default: the
    traces'; a shard's for a sharded run), the kernels built on ``device``
    (default ``engine.device``)."""
    cap = engine_capability(engine)
    if not cap.supported:
        raise EngineCapabilityError(cap)
    if num_iterations > traces.horizon:
        raise ValueError(
            f"traces hold {traces.horizon} draws/worker but {num_iterations} "
            "iterations requested"
        )
    kernels = problem.fused_kernels(engine.device if device is None else device)
    dcap = kernel_dtype_capability(engine, kernels.value_dtype)
    if not dcap.supported:
        raise EngineCapabilityError(dcap)
    spec = _static_spec(
        problem, config, traces.num_workers, num_iterations, cost_scale,
        engine.kernel_backend, universe=universe, active_cap=active_cap,
        has_churn=traces.churn is not None,
    )
    S = traces.num_scenarios if num_scenarios is None else num_scenarios
    errors = _kernel_shape_errors(spec, kernels, S, traces.num_workers)
    scap = kernel_shape_capability(engine, errors)
    if not scap.supported:
        raise EngineCapabilityError(scap)
    return spec, kernels


def scenario_rows(traces: FleetTraces, rows) -> FleetTraces:
    """The scenarios ``rows`` (an index array; repeats allowed) of ``traces``:
    every ``[S, ...]`` array indexed, the static slowdowns and the churn
    schedule shared."""
    return dataclasses.replace(
        traces, comm=traces.comm[rows], comp_unit=traces.comp_unit[rows],
        burst_start=traces.burst_start[rows], burst_end=traces.burst_end[rows],
        burst_factor=traces.burst_factor[rows])


def shard_rows(num_scenarios: int, num_shards: int) -> list[np.ndarray]:
    """Each shard's scenario rows: the axis edge-padded with copies of the
    last scenario to a multiple of ``num_shards`` (``(-S) % D`` of them, as
    the reference pads for ``shard_map``), then split into equal shards."""
    S = num_scenarios
    rows = np.concatenate([np.arange(S), np.full((-S) % num_shards, S - 1)])
    return np.split(rows, num_shards)


@dataclasses.dataclass
class ScanShard:
    """One shard's operands on its device: the problem's kernels there, the
    trace tensors and initial iterates of its scenarios, and the replicated
    §6 slot tables and what-if draws."""

    kernels: FusedKernels
    tr: dict
    V0: torch.Tensor
    tabs: dict
    normals: torch.Tensor | None

    def run(self, spec: _StaticSpec, eval_mask) -> tuple[np.ndarray, ...]:
        """:func:`_run_scan` over this shard, its outputs copied to the host."""
        return tuple(o.cpu().numpy() for o in _run_scan(
            self.kernels, spec, self.tr, self.V0, eval_mask, self.tabs, self.normals))


@dataclasses.dataclass
class ScanInputs:
    """What :func:`prepare_scan_inputs` returns: the static spec, the
    evaluation mask, each shard's operands, the unpadded scenario count and
    whether the run is sharded (a mesh: one thread per shard)."""

    spec: _StaticSpec
    eval_mask: np.ndarray
    shards: list[ScanShard]
    num_scenarios: int
    sharded: bool


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
    what_if_normals=None,
) -> ScanInputs:
    """Capability checks, static spec, and every shard's device operands.

    Without a scenario mesh on ``engine`` one shard holds the whole batch on
    ``engine.device``.  With a mesh of D devices
    (:func:`~repro_torch.experiments.engine.scenario_mesh`) the scenario axis
    is edge-padded to a multiple of D and split into D equal shards, one per
    mesh entry (:func:`shard_rows`): the ``[S, ...]`` trace arrays and the
    ``V0`` stack are split, the slowdowns, the churn schedule, the §6 slot
    tables, the what-if draws and ``eval_mask`` replicated (the reference's
    ``in_specs``).  The checks run once, at a shard's S, and every shard's
    kernels and draws are built here, before any launch and before any shard
    starts.

    Raises :class:`~repro_torch.experiments.engine.EngineCapabilityError`
    for configurations the engine cannot run (a missing card, a §6 cache
    past the slot budget included), and ``ValueError`` for a mesh of more
    cards than are visible.  ``V0`` overrides the problem's initial iterate
    (numpy; broadcast over scenarios); ``what_if_normals`` the §6 what-if
    draws (:func:`~repro_torch.lb.optimizer.what_if_normals`).
    """
    eng = EngineConfig() if engine is None else engine
    T = num_iterations
    N = traces.num_workers
    S = traces.num_scenarios
    cap = engine_capability(eng)
    if not cap.supported:
        raise EngineCapabilityError(cap)
    mesh = scenario_mesh(eng)
    groups = [np.arange(S)] if mesh is None else shard_rows(S, mesh.size)
    cap = scan_capability(problem, config, N, slot_budget=eng.slot_budget)
    if not cap.supported:
        raise EngineCapabilityError(cap)
    universe = None
    active_cap = 0
    if config.load_balance and config.uses_cache:
        n = problem.num_samples
        base_start = [p_start(n, N, i + 1) for i in range(N)]
        base_stop = [p_stop(n, N, i + 1) for i in range(N)]
        n_local = np.asarray(base_stop) - np.asarray(base_start) + 1
        universe = build_slot_universe(base_start, base_stop, lb_ladder_for(config, n_local))
        active_cap = int(active_slot_capacity(universe).max())
    spec, kernels = check_run(problem, traces, config, T, cost_scale, eng,
                              universe=universe, active_cap=active_cap,
                              num_scenarios=len(groups[0]),
                              device=None if mesh is None else mesh.devices[0])
    devices = (kernels.device,) if mesh is None else mesh.devices
    v0 = problem.init(seed) if V0 is None else np.asarray(V0)
    eval_mask = np.zeros(T, dtype=bool)
    eval_mask[::eval_every] = True
    eval_mask[T - 1] = True
    shards = []
    for dev, rows in zip(devices, groups):
        k = problem.fused_kernels(dev)
        dev = k.device
        tabs = {}
        if universe is not None:
            tabs = {
                name: torch.as_tensor(getattr(universe, name), dtype=I64, device=dev)
                for name in ("slot_table", "widths", "starts", "stops")
            }
        normals = None
        if config.load_balance:
            normals = (
                default_what_if_normals(seed, N, jlb.SIM_ITERATIONS, dev)
                if what_if_normals is None
                else torch.as_tensor(np.asarray(what_if_normals), dtype=F64, device=dev)
            )
        part = traces if mesh is None else scenario_rows(traces, rows)
        V0_stack = torch.as_tensor(np.repeat(v0[None], len(rows), axis=0), device=dev)
        shards.append(ScanShard(k, trace_tensors(part, dev), V0_stack, tabs, normals))
    return ScanInputs(spec, eval_mask, shards, S, sharded=mesh is not None)


def _run_sharded(spec: _StaticSpec, eval_mask, shards: list[ScanShard]) -> list[tuple]:
    """Every shard's run in a thread of its own, on a card on a stream of its
    own; each shard's outputs in shard order.  Shards on distinct devices
    run at once; shards that share a device take turns (a lock per device):
    their threads would only contend for the host, which bounds every path
    (pca_paper_scale's dsag at 40 scenarios on one H100: four free threads
    3.9-4.6 s, the same four shards in turns 1.2-1.6 s, unsharded 0.7 s;
    ``PERF.md``).  A shard's exception is
    re-raised here once every shard has stopped: a run never succeeds on
    part of its shards."""
    streams = []
    for sh in shards:
        stream = None
        if sh.kernels.device.type == "cuda":
            dev = sh.kernels.device
            stream = torch.cuda.Stream(device=dev)
            # the operands were made on the caller's stream
            stream.wait_stream(torch.cuda.current_stream(dev))
        streams.append(stream)
    turns = {sh.kernels.device: threading.Lock() for sh in shards}

    def work(shard: ScanShard, stream):
        with turns[shard.kernels.device]:
            if stream is None:
                return shard.run(spec, eval_mask)
            with torch.cuda.device(stream.device), torch.cuda.stream(stream):
                return shard.run(spec, eval_mask)

    with ThreadPoolExecutor(max_workers=len(shards), thread_name_prefix="scenario-shard") as pool:
        futures = [pool.submit(work, sh, st) for sh, st in zip(shards, streams)]
        return [f.result() for f in futures]


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
    what_if_normals=None,
):
    """Train ``config`` on every scenario of ``traces`` on the engine's device,
    or on its scenario mesh's devices, one shard each
    (:func:`prepare_scan_inputs`).

    Returns a :class:`~repro_torch.experiments.convergence.
    ConvergenceBatchResult` of numpy arrays with the reference's shapes,
    the shards' outputs concatenated in shard order and sliced back to the
    traces' S.  Every per-scenario value equals the unsharded run's bit for
    bit: each scenario's arithmetic depends on its own row alone, and the
    batch-level host branches (Algorithm 2's ``needs``, the §6 cadence and
    Algorithm 1's rounds, the walks' and clears' trip counts) only skip
    work that is an exact no-op for the rows that do not need it.
    """
    from repro_torch.experiments.convergence import ConvergenceBatchResult

    inputs = prepare_scan_inputs(
        problem,
        traces,
        config,
        num_iterations,
        cost_scale=cost_scale,
        eval_every=eval_every,
        seed=seed,
        engine=engine,
        V0=V0,
        what_if_normals=what_if_normals,
    )
    if inputs.sharded:
        parts = _run_sharded(inputs.spec, inputs.eval_mask, inputs.shards)
    else:
        parts = [inputs.shards[0].run(inputs.spec, inputs.eval_mask)]
    S = inputs.num_scenarios
    times, subopt, fresh, lat, rejected, evictions, published = (
        np.concatenate(outs, axis=0)[:S] for outs in zip(*parts))
    return ConvergenceBatchResult(
        times=times,
        suboptimality=subopt,
        fresh_counts=fresh.astype(np.int64),
        per_worker_latency=lat,
        repartition_events=[
            [float(times[s, t]) for t in np.flatnonzero(published[s])] for s in range(S)
        ],
        evictions=evictions.astype(np.int64),
        rejected_stale=rejected.astype(np.int64),
    )
