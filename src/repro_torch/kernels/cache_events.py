"""§5 grid-cache event walk: CUDA kernel K3 and its plain-torch version.

``grid_cache_update`` replaces ``repro/kernels/cache_events.py::
grid_cache_update`` (Pallas, one program per scenario walking the event
ranks in a ``fori_loop``).  The CUDA version (``csrc/cache_events.cu``) runs
one block per scenario with threads over the feature axis, ranks in order
inside the block, and float64 adds in rank order, so it equals the plain
version (and the reference's ``ref.grid_cache_update_ref``) bit for bit.  It
is bound by bytes: it copies each scenario's value table once and touches
one table row per event.

Events arrive rank-ordered: the caller ranks them with a stable argsort on
event time (+inf where invalid) and gathers, and pre-clips the slots to
``[0, E)``.  Inputs are not modified; the outputs are new tensors.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.block_sub import _on_cpu, _require, _stream

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
    if _on_cpu(*args):
        return grid_cache_update_plain(*args)
    S, R = valid_r.shape
    E, F = values.shape[1], values.shape[-1]
    dev = valid_r.device
    i64, f64 = torch.int64, torch.float64
    _require(valid_r, "valid_r", torch.bool, (S, R), dev)
    _require(slot_r, "slot_r", i64, (S, R), dev)
    _require(tag_r, "tag_r", i64, (S, R), dev)
    _require(vals_r, "vals_r", f64, (S, R, F), dev)
    _require(sums, "sums", f64, (S, F), dev)
    _require(values, "values", f64, (S, E, F), dev)
    _require(iters, "iters", i64, (S, E), dev)
    _require(covered, "covered", i64, (S,), dev)
    _require(rejected, "rejected", i64, (S,), dev)
    _require(slot_width, "slot_width", i64, (E,), dev)
    outs = (
        torch.empty_like(sums),
        torch.empty_like(values),
        torch.empty_like(iters),
        torch.empty_like(covered),
        torch.empty_like(rejected),
    )
    if S == 0:
        return outs
    _build.launch(
        "dsag_grid_cache_update",
        *(t.data_ptr() for t in args),
        *(t.data_ptr() for t in outs),
        S, R, E, F, dev.index or 0, _stream(dev),
    )
    launch_counts["grid_cache_update"] += 1
    return outs
