"""The Gram product ``Xᵀ(X V)``: CUDA kernel K5 and its plain-torch version.

``gram_matvec`` replaces ``repro/kernels/gram_matvec.py::gram_matvec``
(Pallas, a sequential row-block grid carrying a ``[d, k]`` float32
accumulator in VMEM).  The CUDA version (``csrc/gram_matvec.cu``) splits
each group's rows into chunks (:func:`gram_chunks`: enough blocks for about
two waves of the H100's SMs); a block streams its chunk through a
``cp.async`` ring and forms both products with its ``[d, k]`` share in
registers.  The chunks' sums meet in chunk order: inside a thread-block
cluster where a group has at most 8 chunks (one launch), else through
float32 partials and a second launch.  No float atomics, so a run repeats
its bits.  It reads X once and is bound by bytes.  Past its register caps
(k > 8 or d > 1024) it takes the wide path of ``csrc/rows_wide.cuh`` (a row
pass forming ``X V``, then a feature-tiled pass), so every width runs;
:func:`is_wide` chooses from the shapes alone.

An optional leading group dim evaluates every group of the live PCA step in
one call: ``x [B, m, d]``, ``v [d, k]`` → ``[B, d, k]``, each slice equal to
``gram_matvec(x[b], v)``.  The plain version is the two einsums of
``repro/kernels/ref.py::gram_matvec_ref``; kernel and plain version agree
within float32 rounding of another summation order (tolerances are stated
where they are compared: ``tests/test_torch_live.py``, ``chip_smoke.py``).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.analysis import kernel_costs
from repro_torch.kernels import _build
from repro_torch.kernels._build import route
from repro_torch.kernels.block_sub import GRID_Y, Plan, _require, _stream, wide_plan

#: kernel launches per wrapper (counted only where a kernel is launched)
launch_counts = {"gram_matvec": 0}

#: blocks K5 aims at: two waves of the H100's 132 SMs
TARGET_BLOCKS = 2 * 132


def gram_chunks(B: int, m: int, tile: int) -> tuple[int, int]:
    """K5's ``(chunks per group, rows per chunk)`` for ``[B, m, d]``: about
    ``TARGET_BLOCKS / B`` chunks per group, each a multiple of ``tile``
    rows.  A pure function of the shapes, never of the card."""
    per_group = max(1, -(-TARGET_BLOCKS // max(B, 1)))
    rows = -(-max(m, 1) // per_group)
    rows = -(-rows // tile) * tile
    return -(-m // rows), rows


def is_wide(B: int, d: int, k: int) -> bool:
    """Whether K5 takes the wide path (``csrc/rows_wide.cuh``): k or d past
    its register caps (``dsag_gram_max_k``, ``dsag_gram_max_d``), or B past
    the fast grid's y.  A pure function of the shapes."""
    lim = _build.LIMITS
    return k > lim["dsag_gram_max_k"] or d > lim["dsag_gram_max_d"] or B > GRID_Y


@functools.lru_cache(maxsize=256)
def plan(B: int, m: int, d: int, k: int, vec: bool) -> Plan:
    """One K5 call's launch: chunks as ``slabs`` of ``slab_rows`` rows, and
    the scratch floats after the result.  The fast path's chunks are whole
    ring stages of the compiled kernel (``dsag_gram_tile_rows``: this needs
    the built library); the wide path is :func:`block_sub.wide_plan`, which
    raises ValueError past a grid limit."""
    if is_wide(B, d, k):
        return wide_plan(B, m, d, k, False)
    # chunks of whole tiles, at least 32 rows (narrower chunks only add partials)
    tile = _build.library().dsag_gram_tile_rows(d, int(vec))
    nchunks, rows = gram_chunks(B, m, max(32, tile))
    scratch = B * nchunks * d * k if nchunks > _build.LIMITS["dsag_gram_max_cluster"] else 0
    return Plan(False, nchunks, rows, 0, 0, scratch)


def shape_error(B: int, m: int, d: int, k: int) -> str | None:
    """Why K5 cannot take ``[B, m, d]·[d, k]``, or None (``cuda-shape-unsupported``):
    only the wide path has a limit, CUDA's grid."""
    if not is_wide(B, d, k):
        return None
    try:
        wide_plan(B, m, d, k, False)
    except ValueError as e:
        return f"gram_matvec: {e}"
    return None


def gram_matvec_plain(x, v):
    """``Xᵀ(X V)`` in float32: ``[m, d]`` → ``[d, k]``, ``[B, m, d]`` → ``[B, d, k]``."""
    xf = x.to(torch.float32)
    xv = torch.einsum("...nd,dk->...nk", xf, v.to(torch.float32))
    return torch.einsum("...nd,...nk->...dk", xf, xv)


def gram_matvec(x, v):
    """``Xᵀ(X V)``, float32, with an optional leading group dim.

    ``x`` [m, d] or [B, m, d] float32, ``v`` [d, k] float32.  CPU tensors
    take :func:`gram_matvec_plain`; CUDA tensors launch K5.
    """
    if route(x, v) == "plain":
        return gram_matvec_plain(x, v)
    shape = x.shape
    if len(shape) not in (2, 3) or v.dim() != 2:
        raise ValueError(f"expected x [m, d] or [B, m, d] and v [d, k], got "
                         f"{tuple(shape)} and {tuple(v.shape)}")
    B, m, d = shape if len(shape) == 3 else (1, *shape)
    k = v.shape[1]
    dev = x.device
    _require(x, "x", torch.float32, shape, dev)
    _require(v, "v", torch.float32, (d, k), dev)
    vec = d % 4 == 0 and x.data_ptr() % 16 == 0
    p = plan(B, m, d, k, vec)
    out_shape = (B, d, k) if len(shape) == 3 else (d, k)
    if m == 0 or d == 0 or k == 0 or B == 0:
        return torch.zeros(out_shape, dtype=torch.float32, device=dev)
    if p.scratch:  # one allocation: the result, then the partials (and the wide path's P)
        buf = torch.empty(B * d * k + p.scratch, dtype=torch.float32, device=dev)
        out, partial = buf[:B * d * k].view(out_shape), buf.data_ptr() + B * d * k * 4
    else:
        out, partial = torch.empty(out_shape, dtype=torch.float32, device=dev), None
    if p.wide:  # partials first where there are several slabs, then P [B, m, k]
        several = p.slabs > 1
        p_rows = partial + (B * p.slabs * d * k * 4 if several else 0)
        _build.launch(
            "dsag_gram_matvec_wide",
            x.data_ptr(), v.data_ptr(), p_rows, partial if several else None,
            out.data_ptr(), B, m, d, k, p.slabs, p.slab_rows, dev.index, _stream(dev),
        )
    else:
        _build.launch(
            "dsag_gram_matvec",
            x.data_ptr(), v.data_ptr(), partial, out.data_ptr(),
            B, m, d, k, p.slab_rows, p.slabs, int(vec), dev.index, _stream(dev),
        )
    _build.count_launch(launch_counts, "gram_matvec",
                        cost=lambda: kernel_costs.gram_matvec_cost(B, m, d, k))
    return out
