"""The Gram product ``Xᵀ(X V)``: CUDA kernel K5 and its plain-torch version.

``gram_matvec`` replaces ``repro/kernels/gram_matvec.py::gram_matvec``
(Pallas, a sequential row-block grid carrying a ``[d, k]`` float32
accumulator in VMEM).  The CUDA version (``csrc/gram_matvec.cu``) gives each
(group, 128-row chunk) one block that forms both products from the rows it
stages in shared memory and writes a float32 partial; a second launch sums
the partials in chunk order.  No float atomics, so a run repeats its bits.
It reads X once and is bound by bytes at the live PCA shapes.

An optional leading group dim evaluates every group of the live PCA step in
one call: ``x [B, m, d]``, ``v [d, k]`` → ``[B, d, k]``, each slice equal to
``gram_matvec(x[b], v)``.  The plain version is the two einsums of
``repro/kernels/ref.py::gram_matvec_ref``; kernel and plain version agree
within float32 rounding of another summation order (tolerances are stated
where they are compared: ``tests/test_torch_live.py``, ``chip_smoke.py``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.block_sub import _on_cpu, _require, _stream

#: kernel launches per wrapper (counted only where a kernel is launched)
launch_counts = {"gram_matvec": 0}

#: shared memory one H100 block can opt in to (227 KB)
_MAX_SMEM = 232_448


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
    if _on_cpu(x, v):
        return gram_matvec_plain(x, v)
    batched = x.dim() == 3
    if x.dim() not in (2, 3) or v.dim() != 2:
        raise ValueError(f"expected x [m, d] or [B, m, d] and v [d, k], got "
                         f"{tuple(x.shape)} and {tuple(v.shape)}")
    B, m, d = x.shape if batched else (1, *x.shape)
    k = v.shape[1]
    dev = x.device
    _require(x, "x", torch.float32, tuple(x.shape), dev)
    _require(v, "v", torch.float32, (d, k), dev)
    chunk = _build.constant("dsag_gram_chunk")
    tile = _build.constant("dsag_gram_tile")
    smem = (2 * d * k + tile * (d + 1) + tile * k) * 4
    if smem > _MAX_SMEM or B > 65_535:
        raise ValueError(
            f"gram_matvec supports {smem} <= {_MAX_SMEM} bytes of shared memory "
            f"and B <= 65535; got B={B}, d={d}, k={k}"
        )
    out_shape = (B, d, k) if batched else (d, k)
    if m == 0 or d == 0 or k == 0 or B == 0:
        return torch.zeros(out_shape, dtype=torch.float32, device=dev)
    nchunks = -(-m // chunk)
    partial = torch.empty((B, nchunks, d, k), dtype=torch.float32, device=dev)
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    _build.launch(
        "dsag_gram_matvec",
        x.data_ptr(), v.data_ptr(), partial.data_ptr(), out.data_ptr(),
        B, m, d, k, dev.index or 0, _stream(dev),
    )
    launch_counts["gram_matvec"] += 1
    return out
