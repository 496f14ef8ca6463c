"""§5 grid-cache event walk: CUDA kernel K3 and its plain-torch version.

``grid_cache_update`` replaces ``repro/kernels/cache_events.py::
grid_cache_update`` (Pallas, one program per scenario walking the event
ranks in a ``fori_loop``).  The CUDA version (``csrc/cache_events.cu``)
decides every event's fate from the tags alone first (in shared memory,
1–8 blocks per scenario), then forms every delta at once and adds them
to the sums in rank order with float64 adds, so it equals the plain version
(and the reference's ``ref.grid_cache_update_ref``) bit for bit; extra
blocks of the same launch copy the table rows no event names.  It is bound
by bytes: it copies each scenario's value table once and touches one table
row per event.  A walk decides its ranks in shared memory, a window of at
most ``dsag_cache_window`` ranks at a time; past one window a scenario has
one walk block, which carries the state from each window to the next in
the outputs, so every R, E and F runs (:func:`shape_error` names the grid
limits that remain).

Events arrive rank-ordered: the caller ranks them with a stable argsort on
event time (+inf where invalid) and gathers, and pre-clips the slots to
``[0, E)``.  Inputs are not modified; the outputs are new tensors.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.analysis import kernel_costs
from repro_torch.kernels import _build
from repro_torch.kernels._build import route
from repro_torch.kernels.block_sub import _require, _stream

#: kernel launches per wrapper (counted only where a kernel is launched)
launch_counts = {"grid_cache_update": 0}


def grid_cache_update_plain(
    valid_r, slot_r, tag_r, vals_r, sums, values, iters, covered, rejected,
    slot_width,
):
    """The rank walk as masked per-rank scatters over all scenarios."""
    S, R = valid_r.shape
    s_idx = torch.arange(S, device=valid_r.device)
    values = values.clone()
    iters = iters.clone()
    for j in range(R):
        valid = valid_r[:, j]
        slot = slot_r[:, j]
        tag = tag_r[:, j]
        v = vals_r[:, j]
        cur_it = iters[s_idx, slot]
        active = cur_it >= 0
        dom = active & (cur_it >= tag)
        acc = valid & ~dom
        rej = valid & dom
        old = values[s_idx, slot]
        delta = v - torch.where(active[:, None], old, 0.0)
        sums = torch.where(acc[:, None], sums + delta, sums)
        values[s_idx, slot] = torch.where(acc[:, None], v, old)
        iters[s_idx, slot] = torch.where(acc, tag, cur_it)
        covered = covered + torch.where(acc & ~active, slot_width[slot], 0)
        rejected = rejected + rej.to(rejected.dtype)
    return sums, values, iters, covered, rejected


#: CUDA's limit on a grid's x dimension
GRID_X = 2**31 - 1
#: copy blocks K3 aims at beside its walks: two waves of the H100's 132 SMs
TARGET_COPY_BLOCKS = 2 * 132
#: table rows a copy block takes at most (one byte of flags each in shared memory)
MAX_COPY_ROWS = 2048


def walk_blocks(R: int, F: int) -> int:
    """K3's walk blocks per scenario: one per 8 features, at most 8 (each
    decides the scenario's events and takes a slice of the features), where
    the R ranks fit one window; else one, which walks the windows in order."""
    if R > _build.LIMITS["dsag_cache_window"]:
        return 1
    return min(8, max(1, -(-F // 8)))


def copy_plan(S: int, E: int) -> tuple[int, int]:
    """``(rows per copy block, copy blocks per scenario)``: about
    :data:`TARGET_COPY_BLOCKS` blocks over the ``[S, E]`` rows, whole rows
    of one scenario each.  A pure function of the shapes."""
    rows = min(MAX_COPY_ROWS, max(1, -(-S * E // TARGET_COPY_BLOCKS)))
    return rows, -(-E // rows)


def shape_error(S: int, R: int, E: int, F: int) -> str | None:
    """Why K3 cannot take S scenarios of R ranked events over an ``[E, F]``
    table, or None (``cuda-shape-unsupported``): its int indices into a
    scenario's event values, and the grid that holds the walks and the copy
    blocks."""
    if R * F >= 2**31:
        return f"grid_cache_update: R*F = {R * F} event values per scenario, 2**31 or more"
    blocks = S * walk_blocks(R, F) + S * copy_plan(S, E)[1]
    if blocks > GRID_X:
        return f"grid_cache_update: {blocks} blocks, past CUDA's grid limit {GRID_X}"
    return None


_DTYPES = (torch.bool, torch.int64, torch.int64, torch.float64, torch.float64, torch.float64,
           torch.int64, torch.int64, torch.int64, torch.int64)
_NAMES = ("valid_r", "slot_r", "tag_r", "vals_r", "sums", "values", "iters", "covered",
          "rejected", "slot_width")


@functools.lru_cache(maxsize=64)
def _plan(S: int, R: int, E: int, F: int) -> tuple[int, int, int]:
    """``(walk blocks per scenario, rows per copy block, copy blocks per
    scenario)``; ValueError where K3 does not take the shape."""
    err = shape_error(S, R, E, F)
    if err is not None:
        raise ValueError(err)
    return (walk_blocks(R, F), *copy_plan(S, E))


def _check(args) -> None:
    """Raise unless the ten operands are contiguous tensors of the kernel's
    dtypes and consistent shapes on one device (one fast test first)."""
    valid_r, vals_r, values = args[0], args[3], args[5]
    S, R = valid_r.shape
    E, F = values.shape[1], values.shape[-1]
    dev = valid_r.device
    shapes = ((S, R), (S, R), (S, R), (S, R, F), (S, F), (S, E, F), (S, E), (S,), (S,), (E,))
    if all(t.dtype == dt and t.device == dev and t.shape == sh and t.is_contiguous()
           for t, dt, sh in zip(args, _DTYPES, shapes)):
        return
    if vals_r.dim() != 3 or values.dim() != 3:
        raise ValueError(f"vals_r and values must be [S, R, F] and [S, E, F], got "
                         f"{tuple(vals_r.shape)} and {tuple(values.shape)}")
    for t, name, dt, sh in zip(args, _NAMES, _DTYPES, shapes):
        _require(t, name, dt, sh, dev)


def grid_cache_update(
    valid_r,  # [S, R] bool, rank-ordered event validity
    slot_r,  # [S, R] int64, rank-ordered slots in [0, E)
    tag_r,  # [S, R] int64, rank-ordered iteration tags
    vals_r,  # [S, R, F] float64, rank-ordered event values
    sums,  # [S, F] float64 running sums
    values,  # [S, E, F] float64 value table
    iters,  # [S, E] int64 iteration table (-1 = inactive)
    covered,  # [S] int64 covered rows
    rejected,  # [S] int64 rejected events
    slot_width,  # [E] int64 per-slot interval widths
):
    """Apply rank-ordered §5 events; returns ``(sums, values, iters,
    covered, rejected)``.  CPU tensors take :func:`grid_cache_update_plain`;
    CUDA tensors launch K3."""
    args = (valid_r, slot_r, tag_r, vals_r, sums, values, iters, covered,
            rejected, slot_width)
    if route(*args) == "plain":
        return grid_cache_update_plain(*args)
    _check(args)
    S, R = valid_r.shape
    E, F = values.shape[1], values.shape[-1]
    dev = valid_r.device
    wpb, rows_per, cps = _plan(S, R, E, F)
    # one allocation for the five outputs (all 8-byte elements), the value
    # table first so that it is 16-byte aligned for the copy blocks; views
    # by as_strided, the cheapest on the host
    EF = E * F
    at_sums, at_iters = S * EF, S * EF + S * F
    buf = torch.empty(at_iters + S * E + 2 * S, dtype=torch.float64, device=dev)
    ibuf = buf.view(torch.int64)
    outs = (
        torch.as_strided(buf, (S, F), (F, 1), at_sums),
        torch.as_strided(buf, (S, E, F), (EF, F, 1), 0),
        torch.as_strided(ibuf, (S, E), (E, 1), at_iters),
        torch.as_strided(ibuf, (S,), (1,), at_iters + S * E),
        torch.as_strided(ibuf, (S,), (1,), at_iters + S * E + S),
    )
    if S == 0:
        return outs
    _build.launch(
        "dsag_grid_cache_update",
        *(t.data_ptr() for t in args),
        *(t.data_ptr() for t in outs),
        S, R, E, F, wpb, rows_per, cps, dev.index or 0, _stream(dev),
    )
    _build.count_launch(
        launch_counts, "grid_cache_update", cost=lambda: kernel_costs.grid_cache_update_cost(
            S, R, E, F, int(valid_r.sum()) - int((outs[4] - rejected).sum())))
    return outs
