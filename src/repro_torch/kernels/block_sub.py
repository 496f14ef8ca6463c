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
same width (:func:`logreg_warps`).
Results agree with the plain versions within float32 rounding of a
different summation order (tolerances are stated where they are compared:
``tests/test_torch_port.py`` and ``chip_smoke.py``).

Plain versions gather a padded ``[G, W, d]`` window (``W`` the widest task,
or ``max_width`` when the caller knows it statically, which avoids a device
sync) and mask the rows past each width, like the JAX reference.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build

#: kernel launches per wrapper (counted only where a kernel is launched)
launch_counts = {"logreg_block_sub": 0, "pca_block_sub": 0}


def _window(starts, widths, n: int, max_width: int | None):
    W = int(widths.max()) if max_width is None else int(max_width)
    ar = torch.arange(W, device=starts.device)
    idx = (starts[:, None] - 1 + ar[None, :]).clamp(0, n - 1)
    mask = ar[None, :] < widths[:, None]
    return idx, mask


def logreg_block_sub_plain(X, y, Vb, starts, widths, max_width=None):
    """``[G, d]`` logreg block subgradients, reduce form (plain torch)."""
    n = X.shape[0]
    if Vb.shape[0] == 0:
        return torch.zeros_like(Vb)
    idx, mask = _window(starts, widths, n, max_width)
    xg = X[idx]  # [G, W, d]
    yg = y[idx] * mask.to(y.dtype)
    z = yg * (xg * Vb[:, None, :]).sum(2)
    s = torch.sigmoid(-z)
    return -(xg * (yg * s)[:, :, None]).sum(1) / n


def pca_block_sub_plain(X, Vb, starts, widths, max_width=None):
    """``[G, d, k]`` PCA block subgradients ``-X_b^T (X_b V)`` (plain torch)."""
    n = X.shape[0]
    if Vb.shape[0] == 0:
        return torch.zeros_like(Vb)
    idx, mask = _window(starts, widths, n, max_width)
    xg = X[idx] * mask[:, :, None].to(X.dtype)  # [G, W, d]
    return -(xg.transpose(1, 2) @ (xg @ Vb))


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


@functools.lru_cache(maxsize=256)
def _logreg_plan(n: int, d: int, max_width: int | None) -> tuple[int, int]:
    """``(slabs, warps)`` of one K1 launch; ValueError where K1 does not take
    the shape.  A block keeps 32 rows of (d | 1) floats per warp in at most
    48 KB of shared memory."""
    fit = (12_288 - d) // (32 * (d | 1))
    if d > 96 or fit < 1:
        raise ValueError(f"logreg_block_sub supports d <= 96, got {d}")
    slab = _build.constant("dsag_logreg_slab")
    slabs = row_slabs(max_width, n, slab)
    if slabs > 65_535:
        raise ValueError(f"logreg_block_sub supports windows of at most {65_535 * slab} rows, "
                         f"got {slabs} slabs of {slab}")
    return slabs, logreg_warps(max_width, n, slab,
                               min(fit, _build.constant("dsag_logreg_max_warps")))


def logreg_block_sub(X, y, Vb, starts, widths, max_width=None):
    """§3 logreg block subgradients ``[G, d]`` for G (iterate, window) tasks.

    ``X`` [n, d] and ``y`` [n] float32, ``Vb`` [G, d] float32, ``starts`` /
    ``widths`` [G] int64 (1-based starts; rows ``start-1 .. start+width-2``);
    ``max_width`` bounds every width (a static int: it sets the slab count
    and the block size without reading the card).  CPU tensors take
    :func:`logreg_block_sub_plain`; CUDA tensors launch K1.
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
    slabs, warps = _logreg_plan(n, d, None if max_width is None else int(max_width))
    if slabs > 1:  # one allocation: the result, then the slabs' partials
        buf = torch.empty(G * d * (1 + slabs), dtype=torch.float32, device=dev)
        out, partial = buf[:G * d].view(G, d), buf.data_ptr() + G * d * 4
    else:
        out, partial = torch.empty((G, d), dtype=torch.float32, device=dev), None
    if G == 0:
        return out
    _build.launch(
        "dsag_logreg_block_sub",
        X.data_ptr(), y.data_ptr(), Vb.data_ptr(), starts.data_ptr(), widths.data_ptr(),
        partial, out.data_ptr(), G, n, d, slabs, warps, dev.index, _stream(dev),
    )
    launch_counts["logreg_block_sub"] += 1
    return out


def pca_block_sub(X, Vb, starts, widths, max_width=None):
    """§3 PCA block subgradients ``-X_b^T (X_b V_g)``, ``[G, d, k]``.

    ``X`` [n, d] float32, ``Vb`` [G, d, k] float32, ``starts`` / ``widths``
    [G] int64; ``max_width`` bounds every width (a static int: it sets the
    slab count without reading the card).  CPU tensors take
    :func:`pca_block_sub_plain`; CUDA tensors launch K2.
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
    threads = _build.constant("dsag_pca_threads")
    chunk = _build.constant("dsag_pca_chunk")
    max_out = _build.constant("dsag_pca_max_out")
    smem = (d * k + chunk * (d + 1) + chunk * k) * 4
    if d * k > threads * max_out or smem > 48 * 1024:
        raise ValueError(
            f"pca_block_sub supports d*k <= {threads * max_out} and "
            f"{smem} <= 49152 bytes of shared memory; got d={d}, k={k}"
        )
    slab = _build.constant("dsag_pca_slab")
    slabs = row_slabs(max_width, n, slab)
    if slabs > 65_535:
        raise ValueError(f"pca_block_sub supports windows of at most {65_535 * slab} rows, "
                         f"got {slabs} slabs of {slab}")
    out = torch.empty((G, d, k), dtype=torch.float32, device=dev)
    if G == 0:
        return out
    partial = torch.empty((G, slabs, d, k), dtype=torch.float32, device=dev) if slabs > 1 else None
    _build.launch(
        "dsag_pca_block_sub",
        X.data_ptr(), Vb.data_ptr(), starts.data_ptr(), widths.data_ptr(),
        None if partial is None else partial.data_ptr(), out.data_ptr(),
        G, n, d, k, slabs, dev.index or 0, _stream(dev),
    )
    launch_counts["pca_block_sub"] += 1
    return out
