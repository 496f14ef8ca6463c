"""Block-wise int8 quantization of the DSAG cache slots, from
``repro.optim.compression``.

Symmetric per-block scaling: each contiguous block of ``block`` elements
along the last axis shares one bfloat16 scale, ``absmax / 127``.  The
reference's rounding is kept exactly: ``q = clip(round(x / scale), ±127)``
divides by the **float32** scale (rounding half to even, as ``jnp.round``),
while the stored scale, and so :func:`dequantize`, is that scale rounded to
**bfloat16**.  The divisions are tensor by tensor, because CUDA turns a
division by a Python number into a product with its reciprocal.

On a device mesh a row may be split over ranks (a DSAG slot of a
column-parallel or FSDP-split leaf): :func:`quantize_rows` quantizes a
rank's part of each row with the whole row's absmax, reduced over the
row's shards by the caller.

The trees of this package are dicts of tensors (the live trainer holds one
parameter tensor per slot), so :func:`quantize_tree` and
:func:`dequantize_tree` map over nested dicts.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

DEFAULT_BLOCK = 256


@dataclasses.dataclass(frozen=True)
class Quantized:
    """int8 payload and bfloat16 per-block scales."""

    q: torch.Tensor  # int8, [..., n]
    scale: torch.Tensor  # bfloat16, [..., ceil(n / block)]
    block: int


def _pad_to_block(x: torch.Tensor, block: int) -> tuple[torch.Tensor, int]:
    n = x.shape[-1]
    pad = (-n) % block
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x, n


def _blocks(x: torch.Tensor, block: int) -> tuple[torch.Tensor, int]:
    xp, n = _pad_to_block(x.to(torch.float32), block)
    return xp.reshape(*xp.shape[:-1], xp.shape[-1] // block, block), n


def _scale_f32(absmax: torch.Tensor) -> torch.Tensor:
    """``absmax / 127`` in float32 (1 where the block is zero)."""
    d = torch.full((), 127.0, dtype=torch.float32, device=absmax.device)
    return torch.where(absmax > 0, absmax / d, torch.ones((), device=absmax.device))


def quantize(x: torch.Tensor, block: int = DEFAULT_BLOCK) -> Quantized:
    shaped, n = _blocks(x, block)
    scale = _scale_f32(shaped.abs().amax(dim=-1, keepdim=True))
    q = torch.clamp(torch.round(shaped / scale), -127, 127).to(torch.int8)
    q = q.reshape(*shaped.shape[:-2], -1)[..., :n]  # stored at the original length
    return Quantized(q=q, scale=scale[..., 0].to(torch.bfloat16), block=block)


def quantize_rows(x: torch.Tensor, absmax: torch.Tensor, block: int) -> Quantized:
    """:func:`quantize` of a shard of rows (``x`` [..., b], the rank's part
    of each row of ``block`` elements) given each whole row's ``absmax``
    [...] (float32, from every shard of the row): the same payload and
    scales as quantizing the whole rows, since each element depends only on
    its value and its row's scale."""
    scale = _scale_f32(absmax.to(torch.float32))[..., None]
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127).to(torch.int8)
    return Quantized(q=q, scale=scale.to(torch.bfloat16), block=block)


def dequantize(qx: Quantized, dtype=torch.bfloat16) -> torch.Tensor:
    shaped, n = _blocks(qx.q, qx.block)
    out = shaped * qx.scale[..., None].to(torch.float32)
    return out.reshape(*shaped.shape[:-2], -1)[..., :n].to(dtype)


def quantize_tree(tree: Any, block: int = DEFAULT_BLOCK) -> Any:
    if isinstance(tree, dict):
        return {k: quantize_tree(v, block) for k, v in tree.items()}
    return quantize(tree, block)


def dequantize_tree(tree: Any, dtype=torch.bfloat16) -> Any:
    if isinstance(tree, dict):
        return {k: dequantize_tree(v, dtype) for k, v in tree.items()}
    return dequantize(tree, dtype)


def quantization_error_bound(x: torch.Tensor, block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Per-block worst case ``|x − dequantize(quantize(x))|``: absmax / 254."""
    shaped, _ = _blocks(x, block)
    return shaped.abs().amax(dim=-1) / 127.0 / 2.0 + 1e-7
