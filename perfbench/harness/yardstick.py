"""The benchmark's frozen arithmetic, copied so that a later change to the
program's own analysis code does not move the yardstick.

* Peaks of one NVIDIA H100 SXM (the data sheet's dense rates, at 700 W):
  989 TFLOP/s in bfloat16, 3.35 TB/s of HBM3.
* :func:`train_flops`: the model FLOPs of a training step, 6·N·D, with N
  every parameter and D the tokens (the analysis layer's ``model_flops``
  for ``kind="train"``).  Attention's s² term and the SSD's chunk products
  are not counted.
* :func:`k4_bytes`: kernel K4's HBM traffic, the bytes its inputs need read
  and its outputs written once (the analysis layer's
  ``dsag_cache_update_cost``): g and the cache read and the cache written
  (``[p, n]`` slots), H read and written, the ``[p]`` mask.
* :func:`union_ns`: the time covered by a set of intervals, which is the
  device's busy time when the intervals are its operations.
* :data:`GEMM_PATTERNS`: substrings of the names of the matrix-multiply
  kernels cuBLAS and CUTLASS launch on Hopper (``nvjet_*``,
  ``sm90_xmma_gemm_*``, ``cutlass*gemm*``, the ``gemv`` family and
  cuBLAS's split-K reduction).
* :data:`K4_KERNELS`: the names of K4's bfloat16/float32 kernels.
"""

from __future__ import annotations

PEAK_BF16 = 989e12  # FLOP/s
HBM_BW = 3.35e12  # bytes/s

GEMM_PATTERNS = ("gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas", "splitKreduce")
K4_KERNELS = ("dsag_stream_kernel", "dsag_staged_kernel")


def train_flops(num_params: int, tokens: int) -> float:
    return 6.0 * num_params * tokens


def k4_bytes(p: int, n: int, slot_bytes: int) -> int:
    return p * n * 3 * slot_bytes + 2 * n * 4 + p * 4


def is_gemm(name: str) -> bool:
    low = name.lower()
    return any(pat.lower() in low for pat in GEMM_PATTERNS)


def is_k4(name: str) -> bool:
    return any(k in name for k in K4_KERNELS)


def union_ns(intervals) -> int:
    """Length covered by ``(start, end)`` intervals."""
    total, reach = 0, None
    for start, end in sorted(intervals):
        if reach is None or start > reach:
            total += end - start
            reach = end
        elif end > reach:
            total += end - reach
            reach = end
    return total
