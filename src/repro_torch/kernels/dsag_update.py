"""The fused DSAG cache update: CUDA kernel K4 and its plain-torch version.

``dsag_cache_update`` replaces ``repro/kernels/dsag_update.py::
dsag_cache_update`` (Pallas, a (blocks, groups) grid carrying the h block
in VMEM scratch).  Over flattened ``[p, n]`` slots it computes

    new_c_i = m_i·g_i + (1 − m_i)·c_i          (stored in c's dtype)
    new_h   = h + Σ_i (new_c_i − c_i)           h first, then groups in order

in float32, which is ``h += Σ m_i (g_i − c_i)``, ``c_i ← m_i ? g_i : c_i``
for a 0/1 mask.  The CUDA version (``csrc/dsag_update.cu``) forms every
new c and every difference at once, staging a chunk of groups' differences
for a tile of 32 elements in shared memory, and adds them to h in group
order, one thread per element; from :data:`STREAM_MIN_N` elements one
thread per element walks the groups instead (enough threads to fill the
card).  Both round exactly as the plain version's loop does: the two
are bit-equal.  It is bound by bytes (each g and c element read once, c
written once); at the live steps' shapes, by latency.  g and c are
float32 or bfloat16; h and the mask are float32.  Unlike the Pallas kernel,
n needs no padding to a block.

``dsag_cache_update_int8`` is K4's int8-slot entry (the reference's int8
leaf update in ``repro/core/dsag_pjit.py``, which the Pallas module's
docstring describes as dequantizing and requantizing in the same pass):
slots of ``rows`` rows of ``b`` int8 elements, one bfloat16 scale per row
(``optim/compression.py`` with ``block = b``).  Per group it forms the new
cache row (kept, the gradient, the pending slot, or zero), requantizes every
row, takes H's delta from the stored, dequantized value, and requantizes the
pending slot (kept or the gradient); ``h + Σ_i delta_i``, the groups summed
in order first, as the reference does.  The plain version
:func:`dsag_cache_update_int8_plain` quantizes through
:func:`repro_torch.optim.compression.quantize`; the kernel is bit-equal to it.

Its split form serves a device mesh, where the slots hold a shard of each
row (the row's scale is the absmax of the whole row, as the reference's
``_cache_like`` has it): :func:`dsag_int8_row_max` (a second kernel) writes
each (group, row)'s absmax of the new cache and pending rows over the shard,
the caller MAX-all-reduces them over the row's ranks, and
``dsag_cache_update_int8(..., maxima=)`` scales each row by them.  A maximum
is exact, so the split form is bit for bit the unsharded update whatever the
split; plain twins :func:`dsag_int8_row_max_plain` and
``dsag_cache_update_int8_plain(..., maxima=)``.

Inside ``_build.dry_run("card")`` every entry takes meta tensors: it checks
them as its launch does, reports the launch to the cost counter with its
cost model and returns meta outputs, launching nothing.
"""

from __future__ import annotations

import torch

from repro_torch.analysis import kernel_costs
from repro_torch.kernels import _build
from repro_torch.kernels._build import route
from repro_torch.kernels.block_sub import _require, _stream

#: kernel launches per wrapper (counted only where a kernel is launched)
launch_counts = {"dsag_cache_update": 0, "dsag_cache_update_int8": 0, "dsag_int8_row_max": 0}

_SLOT_DTYPES = (torch.float32, torch.bfloat16)
#: elements from which K4 streams (one thread per element walks the groups):
#: one thread per element fills the H100's 132 SMs with 256-thread blocks;
#: below it, the staged kernel (measured on both sides in ``chip_smoke.py``)
STREAM_MIN_N = 132 * 256


def dsag_cache_update_plain(g, c, h, mask):
    """``(new_c [p, n], new_h [n])``: the kernel's group loop in eager torch."""
    m = mask.to(torch.float32)
    acc = h.to(torch.float32, copy=True)
    new_c = torch.empty_like(c)
    for i in range(g.shape[0]):
        gi = g[i].to(torch.float32)
        ci = c[i].to(torch.float32)
        new = m[i] * gi + (1.0 - m[i]) * ci  # no FMA: eager ops round once each
        acc = acc + (new - ci)
        new_c[i] = new.to(c.dtype)
    return new_c, acc


def _check(g, c, h, mask) -> None:
    """Raise unless the operands are what K4 takes: contiguous ``[p, n]``
    float32/bfloat16 slots, ``[n]`` and ``[p]`` float32, on one device."""
    p, n = g.shape if g.dim() == 2 else (-1, -1)
    dev = g.device
    if (g.dtype in _SLOT_DTYPES and c.dtype in _SLOT_DTYPES and c.shape == g.shape
            and h.dtype == torch.float32 and h.shape == (n,) and mask.dtype == torch.float32
            and mask.shape == (p,) and c.device == dev and h.device == dev
            and mask.device == dev and g.is_contiguous() and c.is_contiguous()
            and h.is_contiguous() and mask.is_contiguous()):
        return
    for t, what in ((g, "g"), (c, "c")):
        if t.dtype not in _SLOT_DTYPES:
            raise ValueError(f"{what}: expected float32 or bfloat16, got {t.dtype}")
    if g.dim() != 2:
        raise ValueError(f"g: expected [p, n], got {tuple(g.shape)}")
    _require(g, "g", g.dtype, (p, n), dev)
    _require(c, "c", c.dtype, (p, n), dev)
    _require(h, "h", torch.float32, (n,), dev)
    _require(mask, "mask", torch.float32, (p,), dev)


def dsag_cache_update(g, c, h, mask):
    """Fused masked DSAG cache update over flattened ``[p, n]`` slots.

    ``g`` / ``c`` [p, n] float32 or bfloat16, ``h`` [n] float32, ``mask``
    [p] float32 0/1.  Returns new tensors ``(new_c, new_h)``; the inputs are
    not modified.  CPU tensors take :func:`dsag_cache_update_plain`; CUDA
    tensors launch K4.  ``p == 0`` returns ``h`` unchanged (a copy), as the
    reference's op does.
    """
    how = route(g, c, h, mask, counts=True)
    if how == "plain":
        return dsag_cache_update_plain(g, c, h, mask)
    _check(g, c, h, mask)
    p, n = g.shape
    dev = g.device
    if p == 0:
        return torch.empty((0, n), dtype=c.dtype, device=dev), h.clone()
    # one allocation: new_c (in c's dtype), then new_h at a 16-byte boundary
    # (as_strided views: the cheapest on the host)
    c_words = -(-p * n * c.element_size() // 16) * 4  # float32 words
    buf = torch.empty(c_words + n, dtype=torch.float32, device=dev)
    cbuf = buf if c.dtype == torch.float32 else buf.view(c.dtype)
    new_c = torch.as_strided(cbuf, (p, n), (n, 1))
    new_h = torch.as_strided(buf, (n,), (1,), c_words)
    if n == 0:
        return new_c, new_h
    if how == "launch":  # a dry run's meta tensors: counted, not launched
        _build.launch(
            "dsag_dsag_cache_update",
            g.data_ptr(), c.data_ptr(), h.data_ptr(), mask.data_ptr(),
            new_c.data_ptr(), new_h.data_ptr(), p, n,
            int(g.dtype == torch.bfloat16), int(c.dtype == torch.bfloat16),
            int(n >= STREAM_MIN_N), dev.index or 0, _stream(dev),
        )
    _build.count_launch(launch_counts, "dsag_cache_update",
                        cost=lambda: kernel_costs.dsag_cache_update_cost(p, n, g.element_size()),
                        launched=how == "launch")
    return new_c, new_h


#: the int8 entry's cache-row sources (bits 0-1 of ``code``); bit 2 makes the
#: pending slot take the gradient
KEEP, TAKE_G, TAKE_PENDING, ZERO = 0, 1, 2, 3
TAKE_NEW = 4


def _requantize(x: torch.Tensor, absmax=None):
    """``(q [p, rows, b] int8, scale [p, rows] bf16)``: each row one block;
    with ``absmax`` [p, rows], each row's scale from that (the whole row's,
    when ``x`` holds a shard of each row)."""
    from repro_torch.optim.compression import quantize, quantize_rows

    qx = (quantize(x, block=x.shape[-1]) if absmax is None
          else quantize_rows(x, absmax, x.shape[-1]))
    return qx.q, qx.scale[..., 0]


def _int8_sources(g, cq, cs, pq, ps, code):
    """The int8 update's dequantized slots and the two rows it requantizes:
    ``(cache, new cache row, new pending row)``, float32 ``[p, rows, b]``."""
    cf = cq.to(torch.float32) * cs.to(torch.float32)[..., None]
    pf = pq.to(torch.float32) * ps.to(torch.float32)[..., None]
    src = (code & 3).reshape(-1, 1, 1)
    zero = torch.zeros((), dtype=torch.float32, device=g.device)
    new = torch.where(src == TAKE_G, g,
                      torch.where(src == TAKE_PENDING, pf, torch.where(src == ZERO, zero, cf)))
    take = (code & TAKE_NEW).reshape(-1, 1, 1) != 0
    return cf, new, torch.where(take, g, pf)


def dsag_int8_row_max_plain(g, cq, cs, pq, ps, code):
    """``(cmax, pmax)`` [p, rows] float32: the absmax of each group's new
    cache row and new pending row over this shard of the rows (the split
    form's first pass; MAX-reduced over the row's shards, they are the
    whole rows' absmax)."""
    _, new, pend = _int8_sources(g, cq, cs, pq, ps, code)
    return new.abs().amax(dim=-1), pend.abs().amax(dim=-1)


def dsag_cache_update_int8_plain(g, cq, cs, pq, ps, h, code, maxima=None):
    """``(new_cq, new_cs, new_pq, new_ps, new_h)``: the int8 update in eager
    torch (every select and quantization at once, then the deltas summed
    over the groups in order and added to h).  ``maxima = (cmax, pmax)``
    [p, rows] gives each row's absmax (the split form: the slots hold a
    shard of each row) instead of taking it over ``b``."""
    cf, new, pend = _int8_sources(g, cq, cs, pq, ps, code)
    cmax, pmax = maxima if maxima is not None else (None, None)
    new_cq, new_cs = _requantize(new, cmax)
    delta = new_cq.to(torch.float32) * new_cs.to(torch.float32)[..., None] - cf
    acc = torch.zeros_like(h)
    for i in range(g.shape[0]):
        acc = acc + delta[i]
    new_pq, new_ps = _requantize(pend, pmax)
    return new_cq, new_cs, new_pq, new_ps, h + acc


#: rows per block of the int8 kernel (one warp per row)
INT8_ROWS_PER_BLOCK = _build.LIMITS["dsag_int8_rows_per_block"]
_MAX_GRID_X = 2**31 - 1


def int8_shape_error(rows: int) -> str | None:
    """Why the int8 kernel cannot take ``rows`` rows per group (its grid is
    one block per 4 rows), or None."""
    if -(-rows // INT8_ROWS_PER_BLOCK) > _MAX_GRID_X:
        return (f"dsag_cache_update_int8: {rows} rows need more than {_MAX_GRID_X} blocks "
                f"of {INT8_ROWS_PER_BLOCK}")
    return None


def _check_int8(g, cq, cs, pq, ps, h, code, maxima=None) -> None:
    """Raise unless the operands are what the int8 entry takes: contiguous
    ``[p, rows, b]`` float32 g and int8 slots, ``[p, rows]`` bfloat16
    scales, ``[rows, b]`` float32 h (``None`` for the row-max pass), a
    ``[p]`` uint8 code and, for the split form, ``[p, rows]`` float32
    maxima, on one device."""
    if g.dim() != 3:
        raise ValueError(f"g: expected [p, rows, b], got {tuple(g.shape)}")
    p, rows, b = g.shape
    dev = g.device
    _require(g, "g", torch.float32, (p, rows, b), dev)
    for t, what in ((cq, "cache q"), (pq, "pending q")):
        _require(t, what, torch.int8, (p, rows, b), dev)
    for t, what in ((cs, "cache scale"), (ps, "pending scale")):
        _require(t, what, torch.bfloat16, (p, rows), dev)
    if h is not None:
        _require(h, "h", torch.float32, (rows, b), dev)
    _require(code, "code", torch.uint8, (p,), dev)
    for t, what in zip(maxima or (), ("cache row maxima", "pending row maxima")):
        _require(t, what, torch.float32, (p, rows), dev)
    err = int8_shape_error(rows)
    if err:
        raise ValueError(err)


def dsag_int8_row_max(g, cq, cs, pq, ps, code):
    """The split form's first pass (kernel ``dsag_int8_row_max_kernel``):
    ``(cmax, pmax)`` [p, rows] float32, each group's new cache row's and
    new pending row's absmax over this shard of the rows; see
    :func:`dsag_int8_row_max_plain` (what CPU tensors take)."""
    how = route(g, cq, cs, pq, ps, code, counts=True)
    if how == "plain":
        return dsag_int8_row_max_plain(g, cq, cs, pq, ps, code)
    _check_int8(g, cq, cs, pq, ps, None, code)
    p, rows, b = g.shape
    maxima = torch.empty((2, p, rows), dtype=torch.float32, device=g.device)
    if p == 0 or rows == 0:
        return maxima[0], maxima[1]
    if b == 0:
        maxima.zero_()
        return maxima[0], maxima[1]
    dev = g.device
    cmax, pmax = maxima[0], maxima[1]  # (views: a dry run bills them as a launch does)
    if how == "launch":
        _build.launch(
            "dsag_dsag_int8_row_max",
            *(t.data_ptr() for t in (g, cq, cs, pq, ps, code)), cmax.data_ptr(),
            pmax.data_ptr(), p, rows, b, dev.index or 0, _stream(dev),
        )
    _build.count_launch(launch_counts, "dsag_int8_row_max",
                        cost=lambda: kernel_costs.dsag_int8_row_max_cost(p, rows, b),
                        launched=how == "launch")
    return maxima[0], maxima[1]


def dsag_cache_update_int8(g, cq, cs, pq, ps, h, code, maxima=None):
    """K4 over int8 slots; see the module docstring and
    :func:`dsag_cache_update_int8_plain` (what CPU tensors take).  With
    ``maxima = (cmax, pmax)`` (the split form: each row's absmax over all
    its shards, from :func:`dsag_int8_row_max` and a MAX all-reduce) the
    kernel scales each row by those instead of its own warp's maximum.
    Returns new tensors; the inputs are not modified.  ``p == 0`` returns
    the slots and ``h`` unchanged (copies)."""
    operands = (g, cq, cs, pq, ps, h, code, *(maxima or ()))
    how = route(*operands, counts=True)
    if how == "plain":
        return dsag_cache_update_int8_plain(g, cq, cs, pq, ps, h, code, maxima)
    _check_int8(g, cq, cs, pq, ps, h, code, maxima)
    p, rows, b = g.shape
    if p == 0 or rows == 0 or b == 0:
        return cq.clone(), cs.clone(), pq.clone(), ps.clone(), h.clone()
    outs = (torch.empty_like(cq), torch.empty_like(cs), torch.empty_like(pq),
            torch.empty_like(ps), torch.empty_like(h))
    dev = g.device
    if how == "launch":
        cmax, pmax = (t.data_ptr() for t in maxima) if maxima is not None else (None, None)
        _build.launch(
            "dsag_dsag_cache_update_int8",
            *(t.data_ptr() for t in (g, cq, cs, pq, ps, h, code)), cmax, pmax,
            *(t.data_ptr() for t in outs), p, rows, b, dev.index or 0, _stream(dev),
        )
    _build.count_launch(launch_counts, "dsag_cache_update_int8",
                        cost=lambda: kernel_costs.dsag_cache_update_int8_cost(
                            p, rows, b, split=maxima is not None), launched=how == "launch")
    return outs
