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
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.block_sub import _on_cpu, _require, _stream

#: kernel launches per wrapper (counted only where a kernel is launched)
launch_counts = {"dsag_cache_update": 0}

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
    if _on_cpu(g, c, h, mask):
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
    _build.launch(
        "dsag_dsag_cache_update",
        g.data_ptr(), c.data_ptr(), h.data_ptr(), mask.data_ptr(),
        new_c.data_ptr(), new_h.data_ptr(), p, n,
        int(g.dtype == torch.bfloat16), int(c.dtype == torch.bfloat16),
        int(n >= STREAM_MIN_N), dev.index or 0, _stream(dev),
    )
    launch_counts["dsag_cache_update"] += 1
    return new_c, new_h
