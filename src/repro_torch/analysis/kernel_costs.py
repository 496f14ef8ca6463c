"""The H100's peaks and one cost model per hand-written kernel (K1–K7).

The card is an NVIDIA H100 80GB HBM3 at a 700 W limit (``nvidia-smi
--query-gpu=name,power.limit``); its peaks are the SXM data sheet's:

  HBM3                               3.35 TB/s
  NDR InfiniBand, one port per card    50 GB/s each way (:data:`LINK_BW`)
  float32 outside the tensor cores     67 TFLOP/s
  float64 outside the tensor cores     34 TFLOP/s
  bfloat16 dense, tensor cores        989 TFLOP/s

Each kernel's cost model takes the shapes (and, where the work depends on
the data, the data) its wrapper sees and returns ``(bytes, flops, peak)``
under one convention: every input read once, every output written once,
the operations the function needs on these inputs (not what the kernel's
own design adds).  :func:`bound_ms` turns them into the least time the
card could take.  The kernel wrappers report these models to an active
cost counter (:func:`repro_torch.analysis.cost.count_cost`), so this module
imports numpy only: the kernels layer depends on nothing above it.
"""

from __future__ import annotations

import numpy as np

#: bytes/s of HBM3
HBM_BW = 3.35e12
#: bytes/s each way of the link a collective of the production mesh crosses:
#: one NDR InfiniBand port per GPU, 400 Gb/s = 50 GB/s (a DGX H100 has eight
#: ConnectX-7 for its eight cards).  Every group of the 16x16 and 2x16x16
#: meshes spans nodes of eight cards (``model`` is 16 contiguous ranks,
#: ``data`` and ``pod`` are strided), so the ring runs at the slowest link on
#: it; NVLink 4 inside a node (450 GB/s each way) is not used here
LINK_BW = 50e9
#: FLOP/s: float32 and float64 outside the tensor cores, bfloat16 dense on them
PEAK_F32 = 67e12
PEAK_F64 = 34e12
PEAK_BF16 = 989e12
#: the peak of each floating dtype's products (float16 runs at bfloat16's rate)
PEAKS = {"float64": PEAK_F64, "float32": PEAK_F32, "bfloat16": PEAK_BF16,
         "float16": PEAK_BF16}


def peak_for(dtype) -> float:
    """The peak FLOP/s of products in ``dtype`` (a torch dtype or its name);
    float32's for any dtype not in :data:`PEAKS`."""
    return PEAKS.get(str(dtype).removeprefix("torch."), PEAK_F32)


def bound_ms(nbytes: float, flops: float, peak: float) -> tuple[float, str]:
    """The least milliseconds the card could take: the larger of the bytes
    over the HBM rate and the FLOPs over ``peak``, and which one it is."""
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- the kernels' cost models: (bytes, flops, peak) per launch ---------------------------


def unique_rows(starts: np.ndarray, widths: np.ndarray, n: int) -> int:
    """Rows of ``X [n, d]`` that at least one window ``[start-1, start-1+width)``
    covers: each is read once however many windows share it."""
    touched = np.zeros(n + 1, dtype=np.int64)
    np.add.at(touched, np.asarray(starts) - 1, 1)
    np.add.at(touched, np.asarray(starts) - 1 + np.asarray(widths), -1)
    return int(np.count_nonzero(np.cumsum(touched)[:n]))


def logreg_block_sub_cost(starts, widths, n: int, d: int) -> tuple[int, int, float]:
    """K1: the covered rows of X and y once, Vb read and the result written
    (``[G, d]`` float32 each), the windows' (start, width); per row of each
    window a dot product, a sigmoid and an axpy, ``4d + 5`` float32 FLOPs."""
    G = len(starts)
    nbytes = unique_rows(starts, widths, n) * (d * 4 + 4) + 2 * G * d * 4 + 16 * G
    return nbytes, int(np.sum(widths)) * (4 * d + 5), PEAK_F32


def pca_block_sub_cost(starts, widths, n: int, d: int, k: int) -> tuple[int, int, float]:
    """K2: the covered rows of X once, Vb read and the result written
    (``[G, d, k]`` float32 each), the windows' (start, width); per row of each
    window ``x·V`` and ``xᵀ(x·V)``, ``4dk`` float32 FLOPs."""
    G = len(starts)
    nbytes = unique_rows(starts, widths, n) * d * 4 + 2 * G * d * k * 4 + 16 * G
    return nbytes, int(np.sum(widths)) * 4 * d * k, PEAK_F32


def grid_cache_update_cost(S: int, R: int, E: int, F: int, accepted: int) -> tuple[int, int, float]:
    """K3: the rank-ordered events (valid, slot, tag; ``[S, R, F]`` float64
    values) read, the state (sums, value table, tags, covered, rejected)
    read and written, the slot widths read; one float64 subtract and add
    per feature of each accepted event."""
    nbytes = (S * R * (1 + 8 + 8) + S * R * F * 8
              + 2 * (S * F * 8 + S * E * F * 8 + S * E * 8 + 2 * S * 8) + E * 8)
    return nbytes, accepted * F * 2, PEAK_F64


def dsag_cache_update_cost(p: int, n: int, slot_bytes: int) -> tuple[int, int, float]:
    """K4: g and c read and c written (``[p, n]`` slots), h read and
    written, the ``[p]`` mask; six float32 FLOPs per slot element."""
    return p * n * 3 * slot_bytes + 2 * n * 4 + p * 4, 6 * p * n, PEAK_F32


def dsag_cache_update_int8_cost(p: int, rows: int, b: int,
                                split: bool = False) -> tuple[int, int, float]:
    """K4's int8 entry: g (float32) and two int8 slots read, two written;
    four bfloat16 scale rows; h read and written; the per-group code.  Two
    dequantizations, two absmax, two divisions, the delta and its sum: 20
    float32 FLOPs per element.  The split form (``split``) reads each row's
    two maxima instead of taking them: 18 FLOPs per element, ``[2, p,
    rows]`` float32 more read."""
    n = p * rows * b
    nbytes = n * 4 + 4 * n + 4 * p * rows * 2 + 2 * rows * b * 4 + p
    if split:
        return nbytes + 2 * p * rows * 4, 18 * n, PEAK_F32
    return nbytes, 20 * n, PEAK_F32


def dsag_int8_row_max_cost(p: int, rows: int, b: int) -> tuple[int, int, float]:
    """K4-int8's row-max pass (its split form's first kernel): g (float32)
    and two int8 slots read with their bfloat16 scales, the code; ``[2, p,
    rows]`` float32 maxima written.  Two dequantizations and two absmax: 4
    float32 FLOPs per element."""
    n = p * rows * b
    return n * 4 + 2 * n + 2 * p * rows * 2 + p + 2 * p * rows * 4, 4 * n, PEAK_F32


def gram_matvec_cost(B: int, m: int, d: int, k: int) -> tuple[int, int, float]:
    """K5: X (``[B, m, d]``) and V read once, ``[B, d, k]`` written;
    ``Xᵀ(X V)`` is ``4·B·m·d·k`` float32 FLOPs."""
    return (B * m * d + d * k + B * d * k) * 4, 4 * B * m * d * k, PEAK_F32


def causal_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs a causal mask aligned bottom-right leaves, per head."""
    if not causal:
        return sq * sk
    offs = sk - sq
    return sum(min(sk, q + offs + 1) for q in range(sq))


def flash_attention_cost(b: int, h: int, kvh: int, sq: int, sk: int, d: int, causal: bool,
                         dtype) -> tuple[int, int, float]:
    """K6: q read and the output written (``[b, h, sq, d]``), k and v read
    once (``[b, kvh, sk, d]``: GQA reads each kv head once); two products
    of ``2d`` FLOPs per (query, key) pair the mask keeps, at ``dtype``'s
    peak (bfloat16 on the tensor cores)."""
    elem = 2 if str(dtype).removeprefix("torch.") in ("bfloat16", "float16") else 4
    nbytes = (2 * b * h * sq * d + 2 * b * kvh * sk * d) * elem
    return nbytes, 4 * b * h * d * causal_pairs(sq, sk, causal), peak_for(dtype)


def what_if_replay_cost(S: int, N: int, K: int, live: int,
                        per_scenario: bool) -> tuple[int, int, float]:
    """K7: the ``[S, N, K]`` float64 latencies read once, ``[S, N]``
    participation written (and the per-scenario waits); per what-if
    iteration ~6 float64 operations per living worker and one selection of
    the w-th smallest finish, linear work (one compare each): ``7·K·live``.
    The kernel's N-wide rank count per worker is its own choice, not work
    the function needs."""
    return S * N * K * 8 + S * N * 8 + (S * 8 if per_scenario else 0), K * 7 * live, PEAK_F64
