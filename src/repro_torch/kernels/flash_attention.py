"""Flash-attention forward: CUDA kernel K6 and its plain-torch version.

``flash_attention_op`` replaces ``repro/kernels/ops.py::flash_attention_op``
over the Pallas kernel ``repro/kernels/flash_attention.py::flash_attention``
(a (batch*head, q block, kv block) grid carrying the online-softmax state in
VMEM, head dim padded to 128 lanes).  It keeps the reference's contract:
``[b, h, s, d]`` in and out, causal mask aligned bottom-right to the true
lengths, float32 math inside, the output in the input's dtype, and the same
two refusals (causal with ``sq > sk``; non-causal with ``sk % block_k``).
Head dims 64, 128 and 256 are built; any other d up to 256 runs zero-padded
to the next of them with the true d's scale, as the reference pads d to a
multiple of 128 lanes.
``block_q`` / ``block_k`` take part only in that contract: the CUDA kernels
(``csrc/flash_attention.cu``) pick their own tiles.  bfloat16 runs on the
tensor cores (``mma.sync``, K and V staged by ``cp.async``), which needs every
base pointer 16-byte aligned and every batch, head and position stride a
multiple of 8 elements (:func:`check_alignment`); float32 runs on the CUDA
cores.

:func:`flash_attention_bshd` is the model's entry: ``[b, s, h, d]`` queries
and ``[b, s, kvh, d]`` keys and values, read and written in place through
their strides, with kv head ``i // (h / kvh)`` serving query head ``i``
instead of a repeated copy (``models/attention.py`` calls it for prefill,
for whisper's encoder and for its cross-attention).  It keeps the causal
refusal but not the non-causal ``sk % block_k`` one: that refusal is the
reference op's (its Pallas kernel would let zero-padded keys into the
softmax), while the reference model calls ``full_attention`` over exactly
``sk`` keys, and K6 drops every key past ``sk`` in both modes.

The plain version is the twin of ``repro/kernels/ref.py::flash_attention_ref``:
a full float32 softmax.  Kernel and plain version agree within float32
rounding of another summation order (tolerances are stated where they are
compared: ``tests/test_torch_serve.py``, ``chip_smoke.py``).

Inside ``_build.dry_run("card")`` both entries take meta tensors: they check
them as the launch does (the head-dim pad and the copy out of a padded
target run as torch ops, as for a real launch), report the launch to the
cost counter with K6's cost model and return meta outputs, launching
nothing.
"""

from __future__ import annotations

import math

import torch

from repro_torch.analysis import kernel_costs
from repro_torch.kernels import _build
from repro_torch.kernels._build import route
from repro_torch.kernels.block_sub import _stream

#: kernel launches per wrapper (counted only where a kernel is launched)
launch_counts = {"flash_attention": 0}

#: the reference's mask value (not -inf)
NEG_INF = -1e30
#: head dims the kernel is built for (d = v dim); smaller ones are zero-padded
HEAD_DIMS = (64, 128, 256)


def _check_contract(sq: int, sk: int, causal: bool, block_k: int | None) -> None:
    """The reference wrapper's two refusals (the non-causal one only with a
    ``block_k``)."""
    if not causal and block_k is not None and sk % block_k != 0:
        # zero-padded keys would enter a non-causal softmax in the reference
        raise ValueError(f"non-causal flash requires sk % block_k == 0, got {sk}")
    if causal and sq > sk:
        # bottom-right alignment gives the leading sq - sk query rows no key
        raise ValueError(
            f"causal flash requires sq <= sk (bottom-right alignment), "
            f"got sq={sq} > sk={sk}"
        )


def flash_attention_plain(q, k, v, *, causal: bool = True):
    """Attention over ``[b, h, s, d]`` with a full float32 softmax."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), k.to(torch.float32))
    s = s * scale
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        kpos = torch.arange(sk, device=q.device)
        qpos = torch.arange(sq, device=q.device)
        mask = kpos[None, :] <= (qpos[:, None] + (sk - sq))
        s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.to(torch.float32)).to(q.dtype)


def check_alignment(*tensors) -> None:
    """Raise unless each ``[b, h, s, d]`` view can feed the bfloat16 kernel:
    ``cp.async`` and its output stores move 16 bytes, so each base pointer
    and each batch, head and position stride (in bytes) is a multiple of 16."""
    for t in tensors:
        nbytes = [s * t.element_size() for s in t.stride()[:3]]
        if t.data_ptr() % 16 or any(n % 16 for n in nbytes):
            raise ValueError(
                f"bfloat16 flash attention needs 16-byte aligned rows: base pointer "
                f"{t.data_ptr():#x}, strides {tuple(t.stride()[:3])} elements of "
                f"{t.element_size()} bytes"
            )


def _launch(q, k, v, out, causal: bool) -> None:
    """K6 over ``[b, h, s, d]`` views (any batch/head/position strides, head
    dim contiguous); k and v may have ``h / groups`` heads."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    dev = q.device
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash attention kernel takes float32 or bfloat16, got {q.dtype}")
    for t, what in ((k, "k"), (v, "v"), (out, "out")):
        if t.dtype != q.dtype or t.device != dev:
            raise ValueError(f"{what}: expected {q.dtype} on {dev}, got {t.dtype} on {t.device}")
    if d > HEAD_DIMS[-1]:
        raise ValueError(f"flash attention kernel supports head dims up to "
                         f"{HEAD_DIMS[-1]}, got {d}")
    if (k.shape[0], k.shape[3]) != (b, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must be [b, kvh, sk, {d}] with b={b}; got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if kvh == 0 or h % kvh != 0:
        raise ValueError(f"{h} query heads are not a multiple of {kvh} kv heads")
    if tuple(out.shape) != (b, h, sq, d):
        raise ValueError(f"out must be {(b, h, sq, d)}, got {tuple(out.shape)}")
    for t, what in ((q, "q"), (k, "k"), (v, "v"), (out, "out")):
        if t.stride(3) != 1:
            raise ValueError(f"{what}: the head dim must be contiguous")
    if b * h == 0 or sq == 0:
        return
    target = out
    if d not in HEAD_DIMS:
        # zero columns change no dot product: run the next built head dim with
        # the true one's scale, as the reference pads d to 128 lanes
        dp = next(n for n in HEAD_DIMS if n > d)
        q, k, v = (torch.nn.functional.pad(t, (0, dp - d)) for t in (q, k, v))
        target = torch.empty((b, h, sq, dp), dtype=q.dtype, device=dev)
    if q.dtype == torch.bfloat16:
        check_alignment(q, k, v, target)
    # a dry run's meta tensors: the mirrored limit (the library is not built)
    block_q = (_build.LIMITS["dsag_flash_block_q"] if q.is_meta
               else _build.constant("dsag_flash_block_q"))
    if -(-sq // block_q) > 65_535:
        raise ValueError(f"flash attention kernel supports sq <= {65_535 * block_q}, got {sq}")
    if not q.is_meta:  # meta tensors are counted, not launched
        _build.launch(
            "dsag_flash_attention",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), target.data_ptr(),
            b, h, sq, sk, q.shape[3], h // kvh, int(causal), int(q.dtype == torch.bfloat16),
            1.0 / math.sqrt(d),  # the true head dim, as the reference's wrapper
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *target.stride()[:3],
            dev.index or 0, _stream(dev),
        )
    _build.count_launch(
        launch_counts, "flash_attention", cost=lambda: kernel_costs.flash_attention_cost(
            b, h, kvh, sq, sk, d, causal, q.dtype), launched=not q.is_meta)
    if target is not out:
        out.copy_(target[..., :d])


def refuse_grad(*tensors) -> None:
    """Raise if autograd would record through K6: it writes its output
    through a raw pointer and has no backward (neither has the reference's
    Pallas kernel), so the output would carry no ``grad_fn`` and every
    attention weight's gradient would come out zero.  Training takes the
    plain attention (``gqa_forward(..., backend="torch")``)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "the flash-attention kernel (K6) has no backward: call it under "
            "torch.no_grad() / torch.inference_mode(), or take the plain attention "
            "(backend='torch') where a gradient is needed"
        )


def flash_attention_op(q, k, v, *, causal: bool = True, block_q: int = 128,
                       block_k: int = 128):
    """Flash attention over ``[b, h, s, d]`` (the reference's contract).

    CPU tensors take :func:`flash_attention_plain`; CUDA tensors launch K6
    (float32 or bfloat16, head dims up to 256; bfloat16 16-byte aligned) or
    raise, also when grad mode is on and an input requires grad
    (:func:`refuse_grad`).
    """
    _check_contract(q.shape[2], k.shape[2], causal, block_k)
    if route(q, k, v, counts=True) == "plain":
        return flash_attention_plain(q, k, v, causal=causal)
    refuse_grad(q, k, v)
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"q has {q.shape[1]} heads, k has {k.shape[1]}")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch(q, k, v, out, causal)
    return out


def flash_attention_bshd(q, k, v, *, causal: bool = True):
    """Flash attention in the model's layout: ``q`` [b, sq, h, d], ``k`` and
    ``v`` [b, sk, kvh, d] with ``h % kvh == 0`` → [b, sq, h, d].

    CPU tensors take :func:`flash_attention_plain` over repeated kv heads;
    CUDA tensors launch K6 on the tensors as they lie, or raise (as
    :func:`flash_attention_op` does, grad-requiring inputs included).
    Non-causal calls take any ``sk`` (the model's ``full_attention``
    contract, not the op's).
    """
    _check_contract(q.shape[1], k.shape[1], causal, None)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if route(q, k, v, counts=True) == "plain":
        groups = q.shape[2] // k.shape[2]
        kt = kt.repeat_interleave(groups, dim=1)
        vt = vt.repeat_interleave(groups, dim=1)
        return flash_attention_plain(qt, kt, vt, causal=causal).transpose(1, 2)
    refuse_grad(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(qt, kt, vt, out.transpose(1, 2), causal)
    return out
