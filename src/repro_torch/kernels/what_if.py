"""The §6 what-if trace replay: CUDA kernel K7 and its plain-torch version.

Not a port of a TPU kernel: the reference runs this in XLA
(``repro/lb/jit_optimizer.py::_what_if_replay``, a ``lax.scan`` inside
``estimate_h``), and Algorithm 1 calls it once per hill-climb round, up to
some hundreds of times per optimizer call.  The plain version is that scan
as a Python loop of about twenty eager ops per iteration, so an h estimate
costs ~2000 launches; the CUDA version (``csrc/what_if.cu``) runs all K
iterations of a scenario in one block, one thread per worker.

Given ``total`` ``[S, N, K]`` float64 (each what-if task's comp + comm), the
wait-for-``w`` and the §5.1 ``margin``, it returns each worker's fresh
participation over the K iterations, ``part * (1/K)`` ``[S, N]`` float64.
``w`` is an int (every scenario waits for the w-th finish), or under churn
an ``[S]`` int64 tensor ``w_eff = min(w, #alive)`` of per-scenario waits,
with the dead workers' ``total`` set to +inf (``lb.jit_optimizer.
estimate_h``): a dead worker never finishes, so it is never fresh, and the
``w_eff``-th finish is a living worker's.  Both versions round every
operator once, in the same order (no FMA): they are bit-equal
(``chip_smoke.py`` phase 3; ``tests/test_torch_lb.py`` and
``tests/test_torch_churn.py`` on the card).  The kernel takes up to
``MAX_WORKERS`` workers (one block of threads); larger fleets, and waits
outside ``1..N``, are refused before the launch.
"""

from __future__ import annotations

import torch

from repro_torch.analysis import kernel_costs
from repro_torch.kernels import _build
from repro_torch.kernels._build import route
from repro_torch.kernels.block_sub import _require, _stream

#: kernel launches per wrapper (counted only where a kernel is launched)
launch_counts = {"what_if_replay": 0}
#: one block of threads per scenario (mirrored as ``dsag_what_if_max_workers``)
MAX_WORKERS = _build.LIMITS["dsag_what_if_max_workers"]


def what_if_replay_plain(total, w, margin: float):
    """The replay as eager torch ops (one rounding per operator).  An int
    ``w`` takes ``kthvalue``; a per-scenario ``w`` tensor a sort and a
    gather, which pick the same element."""
    from repro_torch.cluster.simulator import margin_deadline

    S, N, K = total.shape
    dev = total.device
    free_at = torch.zeros((S, N), dtype=total.dtype, device=dev)
    iter_end = torch.zeros((S,), dtype=total.dtype, device=dev)
    draw_idx = torch.zeros((S, N, 1), dtype=torch.int64, device=dev)
    part = torch.zeros((S, N), dtype=torch.int64, device=dev)
    for _ in range(K):
        idle = free_at <= iter_end[:, None]
        start = torch.where(idle, iter_end[:, None], free_at)
        finish = start + total.gather(2, draw_idx)[:, :, 0]
        if isinstance(w, int):
            tau_w = torch.kthvalue(finish, w, dim=1).values
        else:
            tau_w = torch.sort(finish, dim=1).values.gather(1, w[:, None] - 1)[:, 0]
        deadline = margin_deadline(tau_w, iter_end, margin) if margin > 0.0 else tau_w
        started = idle | (free_at <= deadline[:, None])
        fresh = started & (finish <= deadline[:, None])
        # the iteration ends at its last stale or fresh event (a worker with
        # both finishes its fresh task after its stale one), or at tau_w
        stale = started & ~idle
        last = torch.where(fresh, finish, torch.where(stale, free_at, -torch.inf))
        iter_end = torch.maximum(last.amax(dim=1), tau_w)
        free_at = torch.where(started, finish, free_at)
        draw_idx = draw_idx + started[:, :, None]
        part = part + fresh
    # the reference's compiled form multiplies by the reciprocal of K
    return part.to(total.dtype) * (1.0 / max(K, 1))


def shape_error(N: int, w) -> str | None:
    """Why K7 cannot take ``N`` workers waiting for ``w``, an int or an
    ``[S]`` tensor of per-scenario waits (None if it can).  A tensor's range
    is read on the host: one synchronisation."""
    lo, hi = (w, w) if isinstance(w, int) else torch.stack(torch.aminmax(w)).tolist()
    if not (1 <= lo and hi <= N):
        return f"what_if_replay: w={w if isinstance(w, int) else (lo, hi)} outside 1..N={N}"
    if N > MAX_WORKERS:
        return f"what_if_replay: {N} workers exceed one block's {MAX_WORKERS} threads"
    return None


def what_if_replay(total, w, margin: float):
    """Each worker's fresh participation over K what-if iterations, ``[S,
    N]`` float64; ``w`` an int or an ``[S]`` int64 tensor of per-scenario
    waits.  CPU tensors take :func:`what_if_replay_plain`; CUDA tensors
    launch K7 (or raise for shapes it refuses)."""
    per_scenario = not isinstance(w, int)
    if route(total, *((w,) if per_scenario else ())) == "plain":
        return what_if_replay_plain(total, w, margin)
    S, N, K = total.shape
    _require(total, "total", torch.float64, (S, N, K), total.device)
    if per_scenario:
        _require(w, "w_eff", torch.int64, (S,), total.device)
    err = shape_error(N, w)
    if err is not None:
        raise ValueError(err)
    u = torch.empty((S, N), dtype=torch.float64, device=total.device)
    _build.launch(
        "dsag_what_if_replay", total.data_ptr(), u.data_ptr(),
        w.data_ptr() if per_scenario else None, S, N, K, 0 if per_scenario else w,
        int(margin > 0.0), float(margin), 1.0 / max(K, 1),
        total.device.index or 0, _stream(total.device),
    )
    # dead workers' latencies are +inf: the living ones are the finite rows
    _build.count_launch(
        launch_counts, "what_if_replay", cost=lambda: kernel_costs.what_if_replay_cost(
            S, N, K, int(torch.isfinite(total[:, :, 0]).sum()), per_scenario))
    return u
