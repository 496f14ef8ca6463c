"""§3 block subgradients: CUDA kernels K1/K2 and their plain-torch versions.

``logreg_block_sub`` replaces ``repro/kernels/block_sub.py::logreg_block_sub``
and ``pca_block_sub`` replaces ``repro/kernels/block_sub.py::pca_block_sub``
(Pallas, one program per task at a static pow2 ``width_bucket`` gather width).
The CUDA versions (``csrc/block_sub.cu``) loop over exactly ``width`` rows
from row ``start - 1``: pad rows never exist, so the port does not inherit
the width-bucket ladder (it exists for XLA's bit contract) and evaluates
every task of an iteration in one launch from per-task ``(start, width)``.
Both kernels read each window row once and do O(d) or O(d*k) flops per row,
so they are bound by bytes; see the source for the design.  Both spread a
task wider than one slab of rows over several blocks and sum their partials
in a second pass (:func:`row_slabs` counts the slabs from the caller's
static widest window, never from the card); K1 sizes its block from the
same width (:func:`logreg_warps`).  Feature widths past the fast paths'
caps take the wide path (``csrc/rows_wide.cuh``: a row pass, then a
feature-tiled pass), so every width the reference runs runs here too;
:func:`logreg_plan` and :func:`pca_plan` choose the path from the shapes
alone, with the kernels' limits mirrored in ``_build.LIMITS``.
Results agree with the plain versions within float32 rounding of a
different summation order (tolerances are stated where they are compared:
``tests/test_torch_port.py`` and ``chip_smoke.py``).

Plain versions gather a padded ``[G, W, d]`` window (``W`` the widest task,
or ``max_width`` when the caller knows it statically, which avoids a device
sync) and mask the rows past each width, like the JAX reference.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.analysis import kernel_costs
from repro_torch.kernels import _build

#: kernel launches per wrapper (counted only where a kernel is launched)
launch_counts = {"logreg_block_sub": 0, "pca_block_sub": 0}


def _window(starts, widths, n: int, max_width: int | None):
    W = int(widths.max()) if max_width is None else int(max_width)
    ar = torch.arange(W, device=starts.device)
    idx = (starts[:, None] - 1 + ar[None, :]).clamp(0, n - 1)
    mask = ar[None, :] < widths[:, None]
    return idx, mask


def _each_task(fn, *batch):
    """``fn`` over a batch of tasks (each argument's leading axis).  On the
    CPU each task gets a call of its own: there torch and MKL choose a call's
    code by its whole shape (an ``exp``'s vector body or scalar tail, a long
    reduction or product split across threads), so a task's bits would
    follow the tasks beside it.  One call per task keeps every task's result
    independent of its batch, which the scalar simulator, the host engine,
    the device engine and the device engine's scenario shards need to agree
    bit for bit.  On the card the plain versions are held to the kernels
    within a tolerance only: one call."""
    if batch[0].is_cuda:
        return fn(*batch)
    return torch.cat([fn(*(a[g:g + 1] for a in batch)) for g in range(batch[0].shape[0])])


def _logreg_tasks(xg, yg, Vb, n: int):
    z = yg * (xg * Vb[:, None, :]).sum(2)
    s = torch.sigmoid(-z)
    return -(xg * (yg * s)[:, :, None]).sum(1) / n


def _pca_tasks(xg, Vb):
    return -(xg.transpose(1, 2) @ (xg @ Vb))


def logreg_block_sub_plain(X, y, Vb, starts, widths, max_width=None):
    """``[G, d]`` logreg block subgradients, reduce form (plain torch).
    A task's result depends on its window and ``W`` only (``max_width``, else
    the widest task)."""
    n = X.shape[0]
    if Vb.shape[0] == 0:
        return torch.zeros_like(Vb)
    idx, mask = _window(starts, widths, n, max_width)
    xg = X[idx]  # [G, W, d]
    yg = y[idx] * mask.to(y.dtype)
    return _each_task(functools.partial(_logreg_tasks, n=n), xg, yg, Vb)


def pca_block_sub_plain(X, Vb, starts, widths, max_width=None):
    """``[G, d, k]`` PCA block subgradients ``-X_b^T (X_b V)`` (plain torch)."""
    n = X.shape[0]
    if Vb.shape[0] == 0:
        return torch.zeros_like(Vb)
    idx, mask = _window(starts, widths, n, max_width)
    xg = X[idx] * mask[:, :, None].to(X.dtype)  # [G, W, d]
    return _each_task(_pca_tasks, xg, Vb)


def _require(t: torch.Tensor, what: str, dtype, shape: tuple, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (what the kernels take)."""
    if t.dtype == dtype and t.shape == shape and t.device == device and t.is_contiguous():
        return
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{what}: expected {dtype} of shape {tuple(shape)}, got "
            f"{t.dtype} of shape {tuple(t.shape)}"
        )
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    raise ValueError(f"{what} must be contiguous")


def _on_cpu(*tensors) -> bool:
    if all(t.is_cuda for t in tensors):
        return False
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return True
    raise ValueError(f"tensors on mixed or unsupported devices: {devices}")


def _stream(device) -> int:
    """The raw handle of ``device``'s current stream (without building a
    ``torch.cuda.Stream`` object: the wrappers call this on every launch)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def row_slabs(max_width: int | None, n: int, slab_rows: int) -> int:
    """K1's and K2's blocks per task: ``ceil(W / slab_rows)``, ``W`` the
    widest window (``max_width``, else ``n``; no window is longer than
    ``n``), at least 1.  One slab means one pass with one block per task."""
    W = n if max_width is None else min(int(max_width), n)
    return max(1, -(-W // slab_rows))


def logreg_warps(max_width: int | None, n: int, slab_rows: int, max_warps: int) -> int:
    """K1's warps per block: one per 32 rows of the widest slab a block
    walks, from 1 (windows of at most 32 rows) to ``max_warps``."""
    W = n if max_width is None else min(int(max_width), n)
    return min(max_warps, max(1, -(-min(W, slab_rows) // 32)))


#: CUDA's grid limits: x up to 2**31 - 1 blocks, y up to 65535
GRID_X, GRID_Y = 2**31 - 1, 65_535


class Plan(NamedTuple):
    """One K1/K2/K5 launch: the fast path or the wide one (``wide``), slabs
    of ``slab_rows`` rows per task, K1's warps per block (fast path), the
    rows ``W`` of the wide path's row-pass scratch, and the floats the
    wrapper allocates after the result (partials, then that scratch)."""

    wide: bool
    slabs: int
    slab_rows: int
    warps: int
    W: int
    scratch: int


def wide_plan(G: int, W: int, d: int, k: int, logreg: bool) -> Plan:
    """The wide path (``csrc/rows_wide.cuh``) for G tasks of at most W rows:
    slabs of at least ``dsag_wide_slab`` rows, more where the window would
    need more than 65535 slabs.  ValueError past a grid limit."""
    W = max(1, W)
    slab_rows = max(_build.LIMITS["dsag_wide_slab"], -(-W // GRID_Y))
    slabs = max(1, -(-W // slab_rows))
    row_grid = G * -(-W // 8)
    feat_grid = G * -(-d // 128) * (1 if logreg else -(-k // 8))
    if max(row_grid, feat_grid) > GRID_X:
        raise ValueError(f"{G} tasks of up to {W} rows at d={d}, k={k} need "
                         f"{max(row_grid, feat_grid)} blocks, past CUDA's grid limit {GRID_X}")
    partial = G * slabs * d * k if slabs > 1 else 0
    return Plan(True, slabs, slab_rows, 0, W, partial + G * W * k)


@functools.lru_cache(maxsize=256)
def logreg_plan(G: int, n: int, d: int, max_width: int | None) -> Plan:
    """K1's launch for G tasks over ``X [n, d]``: the fast path where a
    warp's 32 rows of (d | 1) floats fit 48 KB of shared memory and a lane
    holds its features (d <= 96), else the wide path.  A pure function of
    the shapes; ValueError only past a grid limit."""
    lim = _build.LIMITS
    slab = lim["dsag_logreg_slab"]
    fit = (12_288 - d) // (32 * (d | 1))
    slabs = row_slabs(max_width, n, slab)
    if d <= 32 * lim["dsag_logreg_max_out"] and fit >= 1 and slabs <= GRID_Y:
        warps = logreg_warps(max_width, n, slab, min(fit, lim["dsag_logreg_max_warps"]))
        return Plan(False, slabs, slab, warps, 0, G * d * slabs if slabs > 1 else 0)
    W = n if max_width is None else min(int(max_width), n)
    return wide_plan(G, W, d, 1, True)


@functools.lru_cache(maxsize=256)
def pca_plan(G: int, n: int, d: int, k: int, max_width: int | None) -> Plan:
    """K2's launch for G tasks over ``X [n, d]`` and ``[d, k]`` iterates:
    the fast path where a thread's outputs cover d*k and the staged rows fit
    48 KB of shared memory, else the wide path.  A pure function of the
    shapes; ValueError only past a grid limit."""
    lim = _build.LIMITS
    chunk = lim["dsag_pca_chunk"]
    smem = (d * k + chunk * (d + 1) + chunk * k) * 4
    slabs = row_slabs(max_width, n, lim["dsag_pca_slab"])
    if (d * k <= lim["dsag_pca_threads"] * lim["dsag_pca_max_out"] and smem <= 48 * 1024
            and slabs <= GRID_Y):
        return Plan(False, slabs, lim["dsag_pca_slab"], 0, 0,
                    G * d * k * slabs if slabs > 1 else 0)
    W = n if max_width is None else min(int(max_width), n)
    return wide_plan(G, W, d, k, False)


def shape_error(G: int, n: int, d: int, k: int | None, max_width: int | None) -> str | None:
    """Why K1 (``k is None``) or K2 cannot take G tasks of at most
    ``max_width`` rows over ``X [n, d]``, or None: what the engines check
    before their first launch (``cuda-shape-unsupported``)."""
    try:
        logreg_plan(G, n, d, max_width) if k is None else pca_plan(G, n, d, k, max_width)
    except ValueError as e:
        return f"{'logreg' if k is None else 'pca'}_block_sub: {e}"
    return None


def _block_cost(starts, widths, n: int, d: int, k: int | None):
    """K1's (``k is None``) or K2's cost model at one launch's windows (read
    on the host: only an active cost counter asks)."""
    st, wd = starts.cpu().numpy(), widths.cpu().numpy()
    if k is None:
        return kernel_costs.logreg_block_sub_cost(st, wd, n, d)
    return kernel_costs.pca_block_sub_cost(st, wd, n, d, k)


def _launch_wide(X, y, Vb, starts, widths, plan: Plan, G: int, n: int, d: int, k: int,
                 out_shape: tuple, logreg: bool):
    """One allocation (the result, then the partials and the row-pass
    scratch) and the wide path's launches, counted under K1 or K2."""
    dev = X.device
    size = G * d * k
    buf = torch.empty(size + plan.scratch, dtype=torch.float32, device=dev)
    out = buf[:size].view(out_shape)
    base = buf.data_ptr() + size * 4
    partial = base if plan.slabs > 1 else None
    scratch = base + (G * plan.slabs * d * k * 4 if plan.slabs > 1 else 0)
    if G == 0:
        return out
    _build.launch(
        "dsag_wide_block_sub",
        X.data_ptr(), None if y is None else y.data_ptr(), Vb.data_ptr(), starts.data_ptr(),
        widths.data_ptr(), scratch, partial, out.data_ptr(), G, n, d, k, plan.W, plan.slabs,
        plan.slab_rows, int(logreg), dev.index, _stream(dev),
    )
    _build.count_launch(launch_counts, "logreg_block_sub" if logreg else "pca_block_sub",
                        cost=lambda: _block_cost(starts, widths, n, d, None if logreg else k))
    return out


def logreg_block_sub(X, y, Vb, starts, widths, max_width=None):
    """§3 logreg block subgradients ``[G, d]`` for G (iterate, window) tasks.

    ``X`` [n, d] and ``y`` [n] float32, ``Vb`` [G, d] float32, ``starts`` /
    ``widths`` [G] int64 (1-based starts; rows ``start-1 .. start+width-2``);
    ``max_width`` bounds every width (a static int: it sets the slab count
    and the block size without reading the card).  CPU tensors take
    :func:`logreg_block_sub_plain`; CUDA tensors launch K1 (its wide path
    past d = 96, :func:`logreg_plan`).
    """
    if _on_cpu(X, y, Vb, starts, widths):
        return logreg_block_sub_plain(X, y, Vb, starts, widths, max_width)
    n, d = X.shape
    G = Vb.shape[0]
    dev = X.device
    _require(X, "X", torch.float32, (n, d), dev)
    _require(y, "y", torch.float32, (n,), dev)
    _require(Vb, "Vb", torch.float32, (G, d), dev)
    _require(starts, "starts", torch.int64, (G,), dev)
    _require(widths, "widths", torch.int64, (G,), dev)
    plan = logreg_plan(G, n, d, None if max_width is None else int(max_width))
    if plan.wide:
        return _launch_wide(X, y, Vb, starts, widths, plan, G, n, d, 1, (G, d), True)
    if plan.scratch:  # one allocation: the result, then the slabs' partials
        buf = torch.empty(G * d + plan.scratch, dtype=torch.float32, device=dev)
        out, partial = buf[:G * d].view(G, d), buf.data_ptr() + G * d * 4
    else:
        out, partial = torch.empty((G, d), dtype=torch.float32, device=dev), None
    if G == 0:
        return out
    _build.launch(
        "dsag_logreg_block_sub",
        X.data_ptr(), y.data_ptr(), Vb.data_ptr(), starts.data_ptr(), widths.data_ptr(),
        partial, out.data_ptr(), G, n, d, plan.slabs, plan.warps, dev.index, _stream(dev),
    )
    _build.count_launch(launch_counts, "logreg_block_sub",
                        cost=lambda: _block_cost(starts, widths, n, d, None))
    return out


def pca_block_sub(X, Vb, starts, widths, max_width=None):
    """§3 PCA block subgradients ``-X_b^T (X_b V_g)``, ``[G, d, k]``.

    ``X`` [n, d] float32, ``Vb`` [G, d, k] float32, ``starts`` / ``widths``
    [G] int64; ``max_width`` bounds every width (a static int: it sets the
    slab count without reading the card).  CPU tensors take
    :func:`pca_block_sub_plain`; CUDA tensors launch K2 (its wide path past
    d*k = 1024 or 48 KB of shared memory, :func:`pca_plan`).
    """
    if _on_cpu(X, Vb, starts, widths):
        return pca_block_sub_plain(X, Vb, starts, widths, max_width)
    n, d = X.shape
    G, k = Vb.shape[0], Vb.shape[-1]
    dev = X.device
    _require(X, "X", torch.float32, (n, d), dev)
    _require(Vb, "Vb", torch.float32, (G, d, k), dev)
    _require(starts, "starts", torch.int64, (G,), dev)
    _require(widths, "widths", torch.int64, (G,), dev)
    plan = pca_plan(G, n, d, k, None if max_width is None else int(max_width))
    if plan.wide:
        return _launch_wide(X, None, Vb, starts, widths, plan, G, n, d, k, (G, d, k), False)
    if plan.scratch:  # one allocation: the result, then the slabs' partials
        buf = torch.empty(G * d * k + plan.scratch, dtype=torch.float32, device=dev)
        out, partial = buf[:G * d * k].view(G, d, k), buf.data_ptr() + G * d * k * 4
    else:
        out, partial = torch.empty((G, d, k), dtype=torch.float32, device=dev), None
    if G == 0:
        return out
    _build.launch(
        "dsag_pca_block_sub",
        X.data_ptr(), Vb.data_ptr(), starts.data_ptr(), widths.data_ptr(),
        partial, out.data_ptr(), G, n, d, k, plan.slabs, dev.index or 0, _stream(dev),
    )
    _build.count_launch(launch_counts, "pca_block_sub",
                        cost=lambda: _block_cost(starts, widths, n, d, k))
    return out
