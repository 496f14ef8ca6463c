#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py            # the full check (needs one CUDA card)
    python3 chip_smoke.py --quick    # build and hold the kernels only
    python3 chip_smoke.py --profile  # kernels, then where the card's time goes
    python3 chip_smoke.py --build-times  # one nvcc call against one per source

Phases (any failure raises and the script exits non-zero):

1. fail unless torch sees a CUDA card; print the card's name and power limit;
2. build every kernel from ``src/repro_torch/kernels/csrc`` with nvcc and
   print each kernel's registers, spills and shared memory (``-Xptxas -v``);
   hold the kernels' limits mirrored in ``_build.LIMITS`` (and K5's tile
   rows) against the compiled ones;
3. at the main paths' shapes: hold each kernel against its plain-torch
   version on the card (K1/K2/K5: float32 tolerance; K3/K4: ``torch.equal``;
   K6: :data:`K6_RTOL`, also at a length no multiple of its tiles and with
   GQA; K1/K2/K5 must also repeat their bits) and time kernel, plain
   version and, where one PyTorch call computes the same function (K2, K5,
   K6), that call; beside each event time, the kernel's device time per
   call from ``torch.profiler`` (event times of small calls include the
   wrapper's host time); then K1, K2 and K5 past their fast paths' widths
   (the wide path: K1 at d = 97 and 1000, K2 at d = 180 and at k = 12, K5
   at d = 1100 and at k = 12), held and timed the same way; K4 on its other
   path too (staged or streaming), equal to the plain version, device time
   beside the chosen one's; K1 and K2 at the scalar simulator's single task
   and the host engine's median batch (:data:`HOST_BATCH`); last, K3 at
   10000 events per scenario (its plain version's launches, like phases
   4-7, leave the profiler without device times for later calls);
4. slice 1, the convergence sweep: run the ``grid`` (logreg, n=16384, 100
   workers x 10 scenarios) and ``pca_paper_scale`` (n=50000, 50 workers x 4
   scenarios) recipes at full size through the kernels, all four methods,
   with every launch counter set to 0 just before and read just after;
   check ``dsag < sag < coded`` median time-to-gap and print it beside the
   committed ``BENCH_convergence.json`` values; rerun the grid recipe's dsag
   and sag with the plain versions on the card: event times and fresh
   counts must be equal, suboptimality within ``rtol=1e-4``; then the CLI
   ``python -m repro_torch.convergence_sweep --problem pca --cols 180`` (K2's
   wide path) with the counters set to 0 just before and read just after,
   and again with ``--kernel-backend torch``: event streams equal,
   suboptimality within ``rtol=1e-4`` + ``atol=1e-6``;
5. slice 2, the live two-tier trainer (``repro_torch.launch.train``), with
   the counters set to 0 just before and read just after: the committed
   ``live_validation`` recipe (logreg 512 x 29, 8 groups) for dsag and sag,
   and the paper-scale logreg (16000 x 29, 100 groups) and PCA (50000 x 64,
   50 groups) jobs, through K1, K4 and K5; streams, fresh/flush counts,
   final gaps, losses and max ξ against the JAX reference's values; the
   logreg paper-scale dsag run again through the plain versions on the card;
6. slice 3, serving (``repro_torch.launch.serve``): qwen1.5-0.5b at full
   width and depth (seeded random weights), 4 prompts of 2048 tokens, prefill
   and 32 greedy tokens through K6, with the counters set to 0 just before
   and read just after ``Server.generate``; then, over the same weights,
   prefill and 31 teacher-forced decode steps through K6, through the plain
   ``full_attention`` and through the float32 model (the yardstick), held
   to :data:`SERVE_TOL`; the float32 model through K6 against it through
   ``full_attention`` (:data:`SERVE_F32_TOL`); decode of token s from an
   (s-1)-token cache against the s-token prefill, in bfloat16 and in float32,
   and (the witness of the bfloat16 gap) from the K6 cache with the decode's
   scores kept in float32;
   K6 against its plain version on layer 0's real q, k, v; K6 launches = 24
   per prefill;
7. slice 7, the engines and the iteration-time sweeps, with the counters set
   to 0 just before each path and read just after: the ``grid`` recipe's
   dsag, sag, sgd and coded through the host engine (all 10 scenarios) and
   the scalar ``TrainingSimulator`` (scenario 0), through K1, held equal to
   the device engine's phase-4 runs bit for bit (times, fresh counts,
   per-worker latencies, rejects, evictions and suboptimality); the same for
   ``pca_paper_scale``'s dsag and sag at :data:`PCA_ENGINE_DEPTH` iterations
   through K2; each engine's wall clock; the host engine's median K1/K2
   batch equal to :data:`HOST_BATCH` (phase 3 holds and times K1 and K2
   there and at the scalar simulator's single task, as no device time can
   be taken after phase 3's windowed K3 check);
   the live pin without the reference (the port's controller equals the
   port's simulator on the ``live_validation`` recipe and the paper-scale
   logreg job, dsag and sag); the ``BENCH_sweep.json`` grid (100 workers x
   10 seeds x 100 iterations, 3 regimes) on the card, every cell and the
   three orderings equal to the committed file, beside the scalar event
   loop's seconds;
8. print one ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 and float64
#: FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_F64 = 34e12
#: bf16 dense tensor-core FLOP/s (the bound of attention's matrix products)
PEAK_BF16 = 989e12
F32_RTOL = 1e-4  # kernel vs plain: float32 sums in another order
F32_ATOL_REL = 1e-5  # ... plus this times the largest |plain| value

#: the JAX reference's live trainer (``repro.launch.train`` on the CPU) on
#: the paper-scale jobs of :func:`paper_live_opts`: final gap (step 79),
#: virtual seconds at step 79, loss at steps 0 and 79, max ξ, Σ fresh, Σ flush
PAPER_LIVE = {
    ("logreg", "dsag"): (0.06209114794638987, 0.45683806155687146, 0.6931475400924683,
                         0.27441734075546265, 1.0, 6420, 1213),
    ("logreg", "sag"): (0.06065378725356596, 0.45328783348307056, 0.6931475400924683,
                        0.27296364307403564, 0.8899999856948853, 6400, 0),
    ("pca", "dsag"): (5.4318966143239383e-05, 0.43198621088886074, -3762.041748046875,
                      -17223.625, 1.0, 3211, 540),
    ("pca", "sag"): (0.0001726642506709912, 0.4317791705027311, -3762.041748046875,
                     -17213.455078125, 0.9399999976158142, 3200, 0),
}
#: paper-scale jobs: (samples, groups, w, eta)
PAPER_JOBS = {"logreg": (16_000, 100, 80, 0.25), "pca": (50_000, 50, 40, 0.9)}
#: live path tolerances against the reference: relative, on the final gap
#: (logreg; PCA's gap near 5e-5 comes from a float32 iterate re-projected by
#: a QR whose last bits differ from LAPACK's) and on the losses
LIVE_GAP_RTOL = {"logreg": 1e-4, "pca": 1e-2}
LIVE_LOSS_RTOL = 1e-4
#: K6 against its plain version's float32 result: float32 rounding, plus half
#: a bfloat16 ulp (2**-8 relative) where the output is bfloat16
K6_RTOL = {"float32": 1e-4, "bfloat16": 1e-4 + 2.0**-8}
K6_ATOL_REL = 1e-5
#: the serving cell: batch, prompt length, generated tokens
SERVE_B, SERVE_PROMPT, SERVE_TOKENS = 4, 2048, 32
#: logits of the K6 run against the plain-attention run, bfloat16: the plain
#: path rounds scores to bfloat16 before its float32 softmax (the reference's
#: full_attention), K6 keeps them in float32, and at this init (projection
#: std 1/sqrt(24)) scores reach a few hundred, where a bfloat16 ulp is 1 to 4:
#: close keys' probabilities move, and 24 layers of random weights carry it
#: on (measured on the H100: 0.42).  The same holds for decode from an
#: (s-1)-token cache against a K6 prefill: the decode step's attention is the
#: plain one (0.38; against the plain prefill 0.07).  Bounds on the relative
#: RMS difference ||a - b|| / ||b|| of each logit vector (two unrelated logit
#: vectors give ~1.4).  The K6 run must also be no further from the float32
#: run than the plain run is; the float32 checks below are the tight ones.
SERVE_TOL = {"k6_vs_plain": 0.5, "decode_vs_prefill": 0.5}
#: the model in float32 through K6 against it through full_attention, and its
#: decode against its prefill: float32 rounding only
SERVE_F32_TOL = 1e-3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_pair(torch, kernel, plain, reps: int, plain_reps: int) -> tuple[float, float]:
    """Kernel and plain times, taken in turns: plain, kernel, kernel, plain."""
    p1 = cuda_ms(torch, plain, plain_reps)
    k1 = cuda_ms(torch, kernel, reps)
    k2 = cuda_ms(torch, kernel, reps)
    p2 = cuda_ms(torch, plain, plain_reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound_ms(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def unique_rows(starts: np.ndarray, widths: np.ndarray, n: int) -> int:
    touched = np.zeros(n + 1, dtype=np.int64)
    np.add.at(touched, starts - 1, 1)
    np.add.at(touched, starts - 1 + widths, -1)
    return int(np.count_nonzero(np.cumsum(touched)[:n]))


def grid_tasks(n: int, N: int, p: int, S: int, rng) -> tuple[np.ndarray, np.ndarray]:
    """Per-task (start, width) of S*N grid tasks at random sub-block indices."""
    from repro_torch.lb.partitioner import p_start, p_stop

    base = np.array([p_start(n, N, i + 1) for i in range(N)])
    n_loc = np.array([p_stop(n, N, i + 1) for i in range(N)]) - base + 1
    k = rng.integers(1, p + 1, size=(S, N))
    lo = base[None, :] + (k - 1) * n_loc[None, :] // p
    hi = base[None, :] + k * n_loc[None, :] // p - 1
    return lo.reshape(-1).astype(np.int64), (hi - lo + 1).reshape(-1).astype(np.int64)


def device_ms(torch, fn, calls: int) -> tuple[float | None, str]:
    """Device time per call of ``fn`` under ``torch.profiler``: the CUDA
    kernels' time in ``key_averages()`` over ``calls`` calls, divided by
    ``calls`` (no host time in it), and the kernels' names with their
    launches per call.  None where the profiler recorded no device time, or
    dropped some of the launches, in three tries."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then drops device events: try again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        us = sum(e.self_device_time_total for e in kern)
        if us > 0 and min(e.count for e in kern) >= calls:
            names = ", ".join(f"{e.key[:40]} x{e.count / calls:g}" for e in kern)
            return us / 1e3 / calls, names
    return None, "the profiler recorded no device time"


def fmt_ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def check_block_sub(torch, kind: str, X, y, rng, shapes=None, k: int = 3) -> list:
    """Phase 3 for K1 (logreg: grid, live and coded calls) or K2 (pca: grid
    and coded calls) at the main paths' shapes, or at ``shapes`` (call ->
    grid layout (N, p, S), or (N, p, S, G): the first G tasks of that layout
    padded to its widest window, as the scalar simulator and the host engine
    call the kernels) with ``X``'s width and, for K2, ``k`` columns."""
    from repro_torch.cluster.simulator import MethodConfig, task_pad_width
    from repro_torch.core.problems import make_higgs_like
    from repro_torch.kernels import block_sub

    dev = X.device
    d = X.shape[1]
    if kind == "logreg":
        # grid: the sweep's per-iteration call; live: the paper-scale live
        # logreg job's call (100 groups of n // G = 160 rows over n = 16000,
        # launch/paper_jobs.py); coded: the sweep's full-width call
        shapes = shapes or {"grid": (100, 10, 10), "live": (16_000, 100), "coded": None}
        S_coded, k = 10, None
    else:
        shapes = shapes or {"grid": (50, 5, 4), "coded": None}
        S_coded = 4
    rows = []
    for call, shp in shapes.items():
        Xc, yc = X, y
        if shp is None:
            n = X.shape[0]
            starts = np.ones(S_coded, dtype=np.int64)
            widths = np.full(S_coded, n, dtype=np.int64)
        elif call == "live":
            n, G = shp
            Xl, yl = make_higgs_like(n, seed=0)
            Xc, yc = torch.as_tensor(Xl, device=dev), torch.as_tensor(yl, device=dev)
            starts = 1 + (n // G) * np.arange(G, dtype=np.int64)
            widths = np.full(G, n // G, dtype=np.int64)
        else:
            n = X.shape[0]
            N, p, S = shp[:3]
            starts, widths = grid_tasks(n, N, p, S, rng)
            pad = task_pad_width(MethodConfig("dsag", subpartitions=p), n, N)
            if len(shp) == 4:
                starts, widths = starts[:shp[3]], widths[:shp[3]]
        G = starts.size
        if kind == "logreg":
            Vb = torch.as_tensor(0.1 * rng.normal(size=(G, d)), dtype=torch.float32, device=dev)
        else:
            q, _ = np.linalg.qr(rng.normal(size=(G, d, k)))
            Vb = torch.as_tensor(q, dtype=torch.float32, device=dev).contiguous()
        st = torch.as_tensor(starts, device=dev)
        wd = torch.as_tensor(widths, device=dev)
        # the static widest window, as the sweep (fused.py) and the live job pass it
        W = pad if shp is not None and call != "live" else int(widths.max())
        if kind == "logreg":
            def kernel():
                return block_sub.logreg_block_sub(Xc, yc, Vb, st, wd, W)

            def plain():
                return block_sub.logreg_block_sub_plain(Xc, yc, Vb, st, wd, W)
        else:
            def kernel():
                return block_sub.pca_block_sub(Xc, Vb, st, wd, W)

            def plain():
                return block_sub.pca_block_sub_plain(Xc, Vb, st, wd, W)
        got = kernel()
        want = plain()
        again = kernel()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        if not torch.isfinite(got).all() or not torch.allclose(
            got, want, rtol=F32_RTOL, atol=F32_ATOL_REL * scale
        ):
            fail(f"{kind}_block_sub ({call}) disagrees with its plain version: "
                 f"max |diff| {err:.3e} at max |plain| {scale:.3e}")
        if not torch.equal(got, again):
            fail(f"{kind}_block_sub ({call}) does not repeat its bits")
        k_ms, p_ms = timed_pair(torch, kernel, plain, reps=50, plain_reps=20)
        dev_ms, dev_kernels = device_ms(torch, kernel, 50)
        lib_ms = None
        if kind == "pca":
            ar = torch.arange(W, device=dev)
            idx = (st[:, None] - 1 + ar[None, :]).clamp(0, n - 1)
            xg = Xc[idx] * (ar[None, :] < wd[:, None])[:, :, None].float()
            lib_ms = cuda_ms(torch, lambda: -torch.bmm(xg.transpose(1, 2), torch.bmm(xg, Vb)), 20)
        row_bytes = d * 4 + (4 if kind == "logreg" else 0)
        total_rows = int(widths.sum())
        nbytes = unique_rows(starts, widths, n) * row_bytes + 2 * Vb.numel() * 4 + 16 * G
        flops = total_rows * ((4 * d + 5) if kind == "logreg" else 4 * d * k)
        b_ms, b_by = bound_ms(nbytes, flops, PEAK_F32)
        plan = (block_sub.logreg_plan(G, n, d, W) if kind == "logreg"
                else block_sub.pca_plan(G, n, d, k, W))
        path = "wide" if plan.wide else "fast"
        rows.append(dict(call=call, G=G, d=d, k=k, max_width=W, path=path, max_abs_err=err,
                         ms=k_ms, device_ms=dev_ms, plain_ms=p_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by))
        print(f"  {kind}_block_sub [{call}] G={G} d={d}{'' if k is None else f' k={k}'} "
              f"width<={W} ({path} path): "
              f"max|diff|={err:.3e} (|plain|<={scale:.3e}), repeats its bits; kernel "
              f"{k_ms:.4f} ms (device {fmt_ms(dev_ms)}: {dev_kernels}), "
              f"plain {p_ms:.4f} ms, bmm pair {lib_ms if lib_ms is None else round(lib_ms, 4)} ms, "
              f"bound {b_ms:.4f} ms ({b_by})")
    return rows


def check_cache_walk(torch, S: int, R: int, E: int, F: int, T: int, rng,
                     plain_reps: int = 3) -> dict:
    """Phase 3 for K3 at one dsag shape; exact equality."""
    from repro_torch.kernels import cache_events

    dev = torch.device("cuda")
    order = np.argsort(rng.random((S, R)), axis=1)
    args = dict(
        valid_r=torch.as_tensor(rng.random((S, R)) < 0.8, device=dev),
        slot_r=torch.as_tensor(rng.integers(0, E, size=(S, R)), device=dev),
        tag_r=torch.as_tensor(np.sort(rng.integers(0, T, size=(S, R)), axis=1)[
            np.arange(S)[:, None], order], device=dev),
        vals_r=torch.as_tensor(rng.normal(size=(S, R, F)), device=dev),
        sums=torch.as_tensor(rng.normal(size=(S, F)), device=dev),
        values=torch.as_tensor(rng.normal(size=(S, E, F)), device=dev),
        iters=torch.as_tensor(rng.integers(-1, T, size=(S, E)), device=dev),
        covered=torch.as_tensor(rng.integers(0, 1000, size=S), device=dev),
        rejected=torch.as_tensor(rng.integers(0, 10, size=S), device=dev),
        slot_width=torch.as_tensor(rng.integers(1, 300, size=E), device=dev),
    )
    a = tuple(args.values())
    got = cache_events.grid_cache_update(*a)
    # the device time before the plain version runs: after its ~10^5 small
    # launches at R = 10000 the profiler recorded no device time for a while
    dev_ms, dev_kernels = device_ms(torch, lambda: cache_events.grid_cache_update(*a), 50)
    want = cache_events.grid_cache_update_plain(*a)
    torch.cuda.synchronize()
    names = ("sums", "values", "iters", "covered", "rejected")
    for name, g, w in zip(names, got, want):
        if not torch.equal(g, w):
            fail(f"grid_cache_update output {name} is not equal to its plain version")
    k_ms, p_ms = timed_pair(torch, lambda: cache_events.grid_cache_update(*a),
                            lambda: cache_events.grid_cache_update_plain(*a),
                            reps=50, plain_reps=plain_reps)
    n_valid = int(args["valid_r"].sum())
    n_rej = int((got[4] - args["rejected"]).sum())
    accepted = n_valid - n_rej
    nbytes = (S * R * (1 + 8 + 8) + S * R * F * 8 + 2 * (S * F * 8 + S * E * F * 8
              + S * E * 8 + 2 * S * 8) + E * 8)
    flops = accepted * F * 2  # one float64 sub and one add per accepted feature
    b_ms, b_by = bound_ms(nbytes, flops, PEAK_F64)
    print(f"  grid_cache_update S={S} R={R} E={E} F={F}: equal (accepted {accepted}, "
          f"rejected {n_rej}); kernel {k_ms:.4f} ms (device {fmt_ms(dev_ms)}: {dev_kernels}), "
          f"plain {p_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    return dict(call=f"S{S}_R{R}_E{E}_F{F}", max_abs_err=0.0, ms=k_ms, device_ms=dev_ms,
                plain_ms=p_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by)


def k4_launch(torch, g, c, h, mask, streaming: bool):
    """K4's kernel on a given path, launched directly (for the comparison of
    its two paths; not counted): ``(new_c, new_h)``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.block_sub import _stream

    p, n = g.shape
    new_c, new_h = torch.empty_like(c), torch.empty_like(h)
    _build.launch("dsag_dsag_cache_update", g.data_ptr(), c.data_ptr(), h.data_ptr(),
                  mask.data_ptr(), new_c.data_ptr(), new_h.data_ptr(), p, n,
                  int(g.dtype == torch.bfloat16), int(c.dtype == torch.bfloat16),
                  int(streaming), g.device.index or 0, _stream(g.device))
    return new_c, new_h


def check_dsag_update(torch, p: int, n: int, slot_dtype, rng) -> dict:
    """Phase 3 for K4 at one shape; exact equality with the plain version."""
    from repro_torch.kernels import dsag_update

    dev = torch.device("cuda")
    g = torch.as_tensor(rng.normal(size=(p, n)), dtype=torch.float32, device=dev).to(slot_dtype)
    c = torch.as_tensor(rng.normal(size=(p, n)), dtype=torch.float32, device=dev).to(slot_dtype)
    h = torch.as_tensor(rng.normal(size=n), dtype=torch.float32, device=dev)
    mask = torch.as_tensor(rng.random(p) < 0.7, dtype=torch.float32, device=dev)
    got = dsag_update.dsag_cache_update(g, c, h, mask)
    want = dsag_update.dsag_cache_update_plain(g, c, h, mask)
    torch.cuda.synchronize()
    for name, a, b in zip(("new_c", "new_h"), got, want):
        if not torch.equal(a, b):
            fail(f"dsag_cache_update [{p}, {n}] {slot_dtype}: {name} is not equal "
                 f"to its plain version")
    k_ms, p_ms = timed_pair(torch, lambda: dsag_update.dsag_cache_update(g, c, h, mask),
                            lambda: dsag_update.dsag_cache_update_plain(g, c, h, mask),
                            reps=50, plain_reps=10)
    dev_ms, dev_kernels = device_ms(torch, lambda: dsag_update.dsag_cache_update(g, c, h, mask), 50)
    sz = g.element_size()
    nbytes = p * n * 3 * sz + 2 * n * 4 + p * 4  # g, c read; c written; h read, written
    flops = 6 * p * n
    b_ms, b_by = bound_ms(nbytes, flops, PEAK_F32)
    dt = str(slot_dtype).removeprefix("torch.")
    # the path the wrapper does not take here, held and timed beside it
    streaming = n >= dsag_update.STREAM_MIN_N
    path, other = ("stream", "staged") if streaming else ("staged", "stream")
    for name, a, b in zip(("new_c", "new_h"), k4_launch(torch, g, c, h, mask, not streaming),
                          want):
        if not torch.equal(a, b):
            fail(f"dsag_cache_update [{p}, {n}] {slot_dtype} ({other} path): {name} is not "
                 f"equal to its plain version")
    other_ms, _ = device_ms(torch, lambda: k4_launch(torch, g, c, h, mask, not streaming), 50)
    print(f"  dsag_cache_update [{p}, {n}] {dt} ({path}): equal; kernel {k_ms:.4f} ms (device "
          f"{fmt_ms(dev_ms)}: {dev_kernels}), plain {p_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}); "
          f"the {other} path, equal too: device {fmt_ms(other_ms)}")
    return dict(call=f"p{p}_n{n}_{dt}", path=path, max_abs_err=0.0, ms=k_ms, device_ms=dev_ms,
                other_path_device_ms=other_ms,
                plain_ms=p_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by)


def check_gram_matvec(torch, x, v) -> dict:
    """Phase 3 for K5 at one shape (``x`` [m, d] or [B, m, d])."""
    from repro_torch.kernels import gram_matvec

    got = gram_matvec.gram_matvec(x, v)
    want = gram_matvec.gram_matvec_plain(x, v)
    again = gram_matvec.gram_matvec(x, v)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    shape = "x".join(str(s) for s in x.shape) + "·" + "x".join(str(s) for s in v.shape)
    if not torch.isfinite(got).all() or not torch.allclose(
        got, want, rtol=F32_RTOL, atol=F32_ATOL_REL * scale
    ):
        fail(f"gram_matvec {shape} disagrees with its plain version: max |diff| "
             f"{err:.3e} at max |plain| {scale:.3e}")
    if not torch.equal(got, again):
        fail(f"gram_matvec {shape} does not repeat its bits")
    k_ms, p_ms = timed_pair(torch, lambda: gram_matvec.gram_matvec(x, v),
                            lambda: gram_matvec.gram_matvec_plain(x, v), reps=50, plain_reps=20)
    dev_ms, dev_kernels = device_ms(torch, lambda: gram_matvec.gram_matvec(x, v), 50)
    if x.dim() == 3:
        vb = v.expand(x.shape[0], *v.shape)
        lib_ms = cuda_ms(torch, lambda: torch.bmm(x.transpose(1, 2), torch.bmm(x, vb)), 20)
    else:
        lib_ms = cuda_ms(torch, lambda: x.T @ (x @ v), 20)
    B = x.shape[0] if x.dim() == 3 else 1
    m, d = x.shape[-2:]
    k = v.shape[1]
    nbytes = (B * m * d + d * k + B * d * k) * 4
    flops = 4 * B * m * d * k
    b_ms, b_by = bound_ms(nbytes, flops, PEAK_F32)
    path = "wide" if gram_matvec.is_wide(B, d, k) else "fast"
    print(f"  gram_matvec {shape} ({path} path): max|diff|={err:.3e} "
          f"(|plain|<={scale:.3e}); kernel "
          f"{k_ms:.4f} ms (device {fmt_ms(dev_ms)}: {dev_kernels}), plain {p_ms:.4f} ms, "
          f"matmul pair {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    return dict(call=shape, path=path, max_abs_err=err, ms=k_ms, device_ms=dev_ms,
                plain_ms=p_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)


def causal_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs a causal mask aligned bottom-right leaves, per head."""
    if not causal:
        return sq * sk
    offs = sk - sq
    return sum(min(sk, q + offs + 1) for q in range(sq))


def k6_within_tolerance(torch, got, want32) -> bool:
    rtol = K6_RTOL[str(got.dtype).removeprefix("torch.")]
    return bool(torch.isfinite(got).all()) and torch.allclose(
        got.float(), want32, rtol=rtol, atol=K6_ATOL_REL * float(want32.abs().max()))


def check_flash(torch, b: int, h: int, sq: int, sk: int, d: int, rng,
                causal: bool = True, dtype=None, kvh: int | None = None) -> dict:
    """Phase 3 for K6 at one shape (bfloat16 by default): ``[b, h, s, d]``
    through ``flash_attention_op``, or with ``kvh`` kv heads (GQA) in the
    model's ``[b, s, h, d]`` layout through ``flash_attention_bshd``."""
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    from repro_torch.kernels import flash_attention as k6

    dtype = dtype or torch.bfloat16
    dev = torch.device("cuda")
    kvh = kvh or h

    def draw(n, heads):
        return torch.as_tensor(rng.normal(size=(b, n, heads, d)), dtype=torch.float32,
                               device=dev).to(dtype)

    if kvh == h:
        q, k, v = (draw(n, h).transpose(1, 2).contiguous() for n in (sq, sk, sk))
        qh, kh, vh = q, k, v  # [b, h, s, d]

        def kernel():
            return k6.flash_attention_op(q, k, v, causal=causal)
    else:
        q, k, v = draw(sq, h), draw(sk, kvh), draw(sk, kvh)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))

        def kernel():
            return k6.flash_attention_bshd(q, k, v, causal=causal).transpose(1, 2)
    # the plain version takes the kv heads repeated (its CPU path does the same)
    kr, vr = (t.repeat_interleave(h // kvh, dim=1) for t in (kh, vh))

    def plain():
        return k6.flash_attention_plain(qh, kr, vr, causal=causal)

    got = kernel()
    want = plain()
    want32 = k6.flash_attention_plain(qh.float(), kr.float(), vr.float(), causal=causal)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    heads = f"{h}" if kvh == h else f"{h} q / {kvh} kv"
    shape = f"[{b}, {heads}, {sq}/{sk}, {d}] {str(dtype).removeprefix('torch.')}"
    if not k6_within_tolerance(torch, got, want32):
        fail(f"flash_attention {shape} disagrees with its plain version: max |diff| "
             f"{float((got.float() - want32).abs().max()):.3e}")
    k_ms, p_ms = timed_pair(torch, kernel, plain, reps=20, plain_reps=5)
    dev_ms, dev_kernels = device_ms(torch, kernel, 20)
    # the library call: SDPA with K6's bottom-right causal mask (its
    # is_causal=True is top-left, the same only where sq == sk), on the same
    # kv heads (enable_gqa) and layout
    mask = causal_lower_right(sq, sk) if causal else None
    gqa = {"enable_gqa": True} if kvh != h else {}

    def library():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask, **gqa)

    lib = library()
    lib_err = float((lib.float() - want32).abs().max())
    if lib_err > 0.05 * float(want32.abs().max()):  # a bf16 call, not another function
        fail(f"SDPA with a bottom-right causal mask disagrees with K6's function at {shape}: "
             f"max |diff| {lib_err:.3e}")
    lib_ms = cuda_ms(torch, library, 20)
    nbytes = (2 * b * h * sq * d + 2 * b * kvh * sk * d) * q.element_size()
    flops = 4 * b * h * d * causal_pairs(sq, sk, causal)
    b_ms, b_by = bound_ms(nbytes, flops, PEAK_BF16)
    print(f"  flash_attention {shape} causal={causal}: max|diff|={err:.3e} vs plain "
          f"({str(dtype).removeprefix('torch.')} out); kernel {k_ms:.4f} ms (device "
          f"{fmt_ms(dev_ms)}: {dev_kernels}), plain {p_ms:.4f} ms, SDPA {lib_ms:.4f} ms "
          f"(max |SDPA - float32 plain| {lib_err:.3e}), "
          f"kernel/SDPA {k_ms / lib_ms:.2f}, bound {b_ms:.5f} ms ({b_by}, {flops:.3e} flops, "
          f"{flops / k_ms * 1e-9:.1f} TFLOP/s)")
    return dict(call=shape, max_abs_err=err, ms=k_ms, device_ms=dev_ms, plain_ms=p_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)


def committed_ttg() -> dict:
    bench = json.loads((ROOT / "BENCH_convergence.json").read_text())
    return {
        "grid": {m: v["median_time_to_gap"] for m, v in bench["methods"].items()},
        "pca_paper_scale": {
            m: v["median_time_to_gap"] for m, v in bench["pca_paper_scale"]["methods"].items()
        },
    }


def run_recipes(torch) -> tuple[dict, dict]:
    """Phase 4: both recipes through the kernels, then the plain rerun."""
    from repro_torch.experiments.convergence import (
        grid_logreg_sweep,
        paper_scale_pca_sweep,
        run_convergence_batch,
    )
    from repro_torch.experiments.engine import EngineConfig
    from repro_torch.experiments.results import convergence_ordering
    from repro_torch.kernels import launch_counts, reset_launch_counts

    committed = committed_ttg()
    counts = {}
    outcomes = {}
    reset_launch_counts()
    for recipe, sweep in (("grid", grid_logreg_sweep), ("pca_paper_scale", paper_scale_pca_sweep)):
        before = launch_counts()
        t0 = time.perf_counter()
        out, gap = sweep(seed=0, engine=EngineConfig(device="cuda", kernel_backend="cuda"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = launch_counts()
        counts[recipe] = {k: after[k] - before[k] for k in after}
        outcomes[recipe] = (out, gap)
        o = convergence_ordering(out, gap)
        print(f"  {recipe}: 4 methods x {out.traces.num_scenarios} scenarios x "
              f"{out.num_iterations} iters in {wall:.2f} s host wall clock "
              f"(engine {out.engine_seconds:.2f} s); launches {counts[recipe]}")
        print(f"    {'method':>6} {'port t->gap (sim s)':>22} {'committed (JAX, CPU)':>22} equal")
        for m in out.results:
            mine = o[f"median_time_to_gap_{m}"]
            theirs = committed[recipe].get(m)
            same = mine == (np.inf if theirs is None else theirs)
            print(f"    {m:>6} {mine!r:>22} {theirs!r:>22} {same}")
        for m, res in out.results.items():
            S, T = res.times.shape
            if res.suboptimality.shape != (S, T) or res.per_worker_latency.shape[:2] != (S, T):
                fail(f"{recipe}/{m}: result shapes {res.times.shape}, {res.suboptimality.shape}")
            if not np.isfinite(res.times).all() or not np.isfinite(res.suboptimality[:, -1]).all():
                fail(f"{recipe}/{m}: non-finite times or final suboptimality")
        t = {m: o[f"median_time_to_gap_{m}"] for m in ("dsag", "sag", "coded")}
        if not (np.isfinite(t["dsag"]) and t["dsag"] < t["sag"] < t["coded"]):
            fail(f"{recipe}: median time-to-gap ordering dsag < sag < coded broken: {t}")
        print(f"    dsag < sag < coded holds: sag/dsag={o['sag_over_dsag']:.3f} "
              f"coded/dsag={o['coded_over_dsag']:.3f}")
    total = launch_counts()
    for name in ("logreg_block_sub", "pca_block_sub", "grid_cache_update"):
        if total[name] == 0:
            fail(f"kernel {name} was never launched on the sweep path")
    if counts["grid"]["logreg_block_sub"] == 0 or counts["pca_paper_scale"]["pca_block_sub"] == 0:
        fail("a recipe ran without its block-subgradient kernel")
    if counts["grid"]["grid_cache_update"] == 0 or counts["pca_paper_scale"]["grid_cache_update"] == 0:
        fail("a recipe ran without the cache-walk kernel")

    # the grid recipe's dsag and sag once more, through the plain versions
    out, _ = outcomes["grid"]
    plain_engine = EngineConfig(device="cuda", kernel_backend="torch")
    for m in ("dsag", "sag"):
        ref = run_convergence_batch(out.problem, out.traces, out.methods[m], out.num_iterations,
                                    eval_every=out.eval_every, seed=out.seed, engine=plain_engine)
        res = out.results[m]
        if not (np.array_equal(ref.times, res.times)
                and np.array_equal(ref.fresh_counts, res.fresh_counts)
                and np.array_equal(ref.rejected_stale, res.rejected_stale)
                and np.array_equal(ref.per_worker_latency, res.per_worker_latency, equal_nan=True)):
            fail(f"grid/{m}: kernel and plain runs differ in their event streams")
        ok = np.isfinite(ref.suboptimality)
        rel = np.abs(res.suboptimality[ok] - ref.suboptimality[ok]) / np.abs(ref.suboptimality[ok])
        if not np.array_equal(ok, np.isfinite(res.suboptimality)) or rel.max() > 1e-4:
            fail(f"grid/{m}: suboptimality differs from the plain run by {rel.max():.3e}")
        print(f"  grid/{m} kernels vs plain on the card: event streams equal, "
              f"suboptimality max rel diff {rel.max():.3e} (tolerance 1e-4)")
    return total, counts, outcomes


#: the wide-feature sweep: the CLI at its default sizes with a PCA width past
#: K2's fast path (d*k > 1024 or 48 KB of shared memory from d = 180 at k = 3)
WIDE_SWEEP_ARGV = ["--problem", "pca", "--cols", "180"]


def run_wide_sweep(torch) -> dict:
    """Phase 4, last: ``python -m repro_torch.convergence_sweep --problem pca
    --cols 180`` through the kernels (K2's wide path, K3), with the counters
    set to 0 just before and read just after, then through
    ``--kernel-backend torch`` on the card: event streams equal,
    suboptimality within rtol 1e-4 + atol 1e-6."""
    from repro_torch import convergence_sweep
    from repro_torch.kernels import block_sub, launch_counts, reset_launch_counts

    reset_launch_counts()
    t0 = time.perf_counter()
    out, gap, _ = convergence_sweep.run(WIDE_SWEEP_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    plain, _, _ = convergence_sweep.run(WIDE_SWEEP_ARGV + ["--kernel-backend", "torch"])
    S, N = out.traces.num_scenarios, out.traces.num_workers
    d, k = out.problem.X.shape[1], out.problem.k
    if not block_sub.pca_plan(S * N, out.problem.num_samples, d, k, None).wide:
        fail(f"--cols {d}: K2 took its fast path, not the wide one")
    for name in ("pca_block_sub", "grid_cache_update"):
        if counts[name] == 0:
            fail(f"--cols {d} sweep: kernel {name} was never launched")
    worst = 0.0
    for m, res in out.results.items():
        ref = plain.results[m]
        if not (np.array_equal(ref.times, res.times)
                and np.array_equal(ref.fresh_counts, res.fresh_counts)
                and np.array_equal(ref.rejected_stale, res.rejected_stale)
                and np.array_equal(ref.per_worker_latency, res.per_worker_latency, equal_nan=True)):
            fail(f"--cols {d} sweep/{m}: kernel and plain runs differ in their event streams")
        if not np.allclose(res.suboptimality, ref.suboptimality, rtol=1e-4, atol=1e-6,
                           equal_nan=True):
            fail(f"--cols {d} sweep/{m}: suboptimality differs from the plain run")
        ok = np.isfinite(ref.suboptimality)
        worst = max(worst, float(np.max(np.abs(res.suboptimality[ok] - ref.suboptimality[ok]))))
    print(f"  convergence_sweep {' '.join(WIDE_SWEEP_ARGV)} (n={out.problem.num_samples}, d={d}, "
          f"k={k}, {N} workers x {S} scenarios x {out.num_iterations} iters): {wall:.2f} s host; "
          f"launches {counts}; event streams equal to the plain run on the card, "
          f"suboptimality max |diff| {worst:.3e} (rtol 1e-4, atol 1e-6)")
    return counts


def paper_live_opts(arch: str, method: str, engine, steps: int = 80):
    """Trainer options of one paper-scale live job: heavy-burst traces of a
    ``make_heterogeneous_cluster`` fleet normalised to one group's load, 2
    scenarios (scenario 0 replayed), margin 0.02, eval every 10 steps."""
    from repro_torch.core.problems import (
        LogisticRegressionProblem,
        PCAProblem,
        make_genomics_like_matrix,
        make_higgs_like,
    )
    from repro_torch.experiments.grid import HEAVY_BURSTS
    from repro_torch.latency.model import make_heterogeneous_cluster, sample_fleet
    from repro_torch.launch.paper_jobs import paper_train_config
    from repro_torch.launch.train import TrainerOptions

    n, G, w, eta = PAPER_JOBS[arch]
    if arch == "logreg":
        X, y = make_higgs_like(n, seed=0)
        prob = LogisticRegressionProblem(X=X, y=y)
    else:
        prob = PCAProblem(X=make_genomics_like_matrix(n, 64, seed=0))
    cluster = make_heterogeneous_cluster(G, seed=3, burst_rate=0.0,
                                         load_unit=prob.compute_cost(1, n // G))
    traces = sample_fleet(cluster, 2, 4 * steps, burst_rate=HEAVY_BURSTS.rate,
                          burst_factor_mean=HEAVY_BURSTS.factor_mean,
                          burst_duration_mean=HEAVY_BURSTS.duration_mean, seed=7)
    return TrainerOptions(
        arch=arch, steps=steps, samples=n, num_groups=G, dsag_w=w, method=method,
        traces=traces, scenario=0, train_config=paper_train_config(eta),
        simulate_stragglers=False, failure_max_misses=10**6, eval_every=10,
        log_every=10**6, seed=0, engine=engine,
    )


def timed_run(torch, opts):
    """(trainer, history, host seconds of ``run()`` ending in a synchronize)."""
    from repro_torch.launch.train import Trainer

    trainer = Trainer(opts)
    t0 = time.perf_counter()
    hist = trainer.run()
    torch.cuda.synchronize()
    return trainer, hist, time.perf_counter() - t0


def run_live(torch) -> dict:
    """Phase 5: the live two-tier trainer through K1, K4 and K5."""
    import dataclasses

    from repro_torch.core.problems import LogisticRegressionProblem, make_higgs_like
    from repro_torch.experiments.engine import EngineConfig
    from repro_torch.experiments.grid import HEAVY_BURSTS
    from repro_torch.ft.validation import controller_streams, group_loads
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.latency.model import make_heterogeneous_cluster, sample_fleet
    from repro_torch.launch.paper_jobs import paper_train_config
    from repro_torch.launch.train import TrainerOptions, check_history

    card = EngineConfig(device="cuda", kernel_backend="cuda")
    live_committed = json.loads((ROOT / "BENCH_convergence.json").read_text())["live_validation"]
    r = live_committed["recipe"]
    reset_launch_counts()

    # 5.1 the committed live_validation recipe
    n, G, T = r["num_samples"], r["n_workers"], r["num_iterations"]
    X, y = make_higgs_like(n, seed=r["seed"])
    prob = LogisticRegressionProblem(X=X, y=y)
    cluster = make_heterogeneous_cluster(G, seed=r["seed"] + 3, burst_rate=0.0,
                                         load_unit=prob.compute_cost(1, n // G))
    traces = sample_fleet(cluster, r["n_scenarios"], 4 * T, burst_rate=HEAVY_BURSTS.rate,
                          burst_factor_mean=HEAVY_BURSTS.factor_mean,
                          burst_duration_mean=HEAVY_BURSTS.duration_mean, seed=r["seed"] + 7)
    first_virtual = {}
    print(f"  live_validation recipe (logreg {n} x 29, {G} groups, w={r['w']}, {T} steps, "
          f"margin {r['margin']}):")
    for m in ("dsag", "sag"):
        opts = TrainerOptions(
            arch="logreg", steps=T, samples=n, num_groups=G, dsag_w=r["w"], method=m,
            traces=traces, scenario=r["scenario"],
            train_config=dataclasses.replace(paper_train_config(r["eta"]),
                                             dsag_margin=r["margin"]),
            simulate_stragglers=False, failure_max_misses=10**6,
            eval_every=r["eval_every"], log_every=10**6, seed=r["seed"], engine=card,
        )
        _, hist, wall = timed_run(torch, opts)
        cs = controller_streams(traces, r["scenario"], w=r["w"], num_iterations=T,
                                loads=group_loads(prob, G), margin=r["margin"],
                                accepts_stale=m == "dsag")
        for f in ("mask", "flush", "evict"):
            if not np.array_equal(np.stack(hist[f"{f}_stream"]), getattr(cs, f)):
                fail(f"live_validation/{m}: the trainer's {f} stream differs from "
                     f"controller_streams")
        gap = hist["eval"][-1][3]
        want = live_committed["methods"][m]["final_gap_live"]
        rel = abs(gap - want) / want
        first_virtual[m] = next((v for (_s, _w, v, g) in hist["eval"] if g <= r["gap"]), np.inf)
        print(f"    {m}: streams equal controller_streams; final gap {gap!r} vs committed "
              f"{want!r} (rel diff {rel:.2e}, tolerance 1e-4); first eval at gap <= "
              f"{r['gap']} at virtual {first_virtual[m]:.6f} s (simulator's time-to-gap "
              f"{live_committed['methods'][m]['virtual_time_to_gap']:.6f} s); "
              f"{wall:.2f} s host, {wall / T * 1e3:.2f} ms/step")
        if not np.isfinite(gap) or rel > 1e-4:
            fail(f"live_validation/{m}: final gap {gap} vs committed {want}")
    if not first_virtual["dsag"] <= first_virtual["sag"]:
        fail(f"live_validation: dsag reached the gap later than sag: {first_virtual}")

    # 5.2 the paper-scale jobs
    finals = {}
    print(f"    {'job':>12} {'port final gap':>24} {'reference':>24} {'loss 0 -> 79':>24} "
          f"{'max xi':>7} {'fresh/flush':>11} {'host s':>7} {'ms/step':>8}")
    for arch in PAPER_JOBS:
        for m in ("dsag", "sag"):
            trainer, hist, wall = timed_run(torch, paper_live_opts(arch, m, card))
            gap_ref, virt_ref, l0_ref, l79_ref, xi_ref, fresh_ref, flush_ref = PAPER_LIVE[arch, m]
            gap = hist["eval"][-1][3]
            fresh = int(np.sum(hist["mask_stream"]))
            flush = int(np.sum(hist["flush_stream"]))
            xi = max(hist["xi"])
            loss0, loss79 = hist["loss"][0], hist["loss"][-1]
            print(f"    {arch + '/' + m:>12} {gap!r:>24} {gap_ref!r:>24} "
                  f"{f'{loss0:.6g} -> {loss79:.6g}':>24} {xi:>7.3f} {f'{fresh}/{flush}':>11} "
                  f"{wall:>7.3f} {wall / len(hist['loss']) * 1e3:>8.3f}")
            if (fresh, flush) != (fresh_ref, flush_ref) or xi != xi_ref:
                fail(f"{arch}/{m}: fresh/flush {fresh}/{flush}, max xi {xi} vs the "
                     f"reference's {fresh_ref}/{flush_ref}, {xi_ref}")
            if hist["virtual"][-1] != virt_ref:
                fail(f"{arch}/{m}: virtual time {hist['virtual'][-1]!r} vs {virt_ref!r}")
            if not np.isclose(gap, gap_ref, rtol=LIVE_GAP_RTOL[arch], atol=0.0):
                fail(f"{arch}/{m}: final gap {gap!r} vs the reference's {gap_ref!r}")
            for got, want in ((loss0, l0_ref), (loss79, l79_ref)):
                if not np.isclose(got, want, rtol=LIVE_LOSS_RTOL, atol=0.0):
                    fail(f"{arch}/{m}: loss {got!r} vs the reference's {want!r}")
            if m == "dsag":
                ok, msg = check_history(hist)
                if not ok:
                    fail(f"{arch}/dsag: {msg}")
            finals[arch, m] = (trainer.state["params"], hist)
    print(f"    gap tolerance rtol {LIVE_GAP_RTOL}; loss rtol {LIVE_LOSS_RTOL}; fresh, "
          f"flush, max xi and virtual time exact; dsag passes --check")
    counts = launch_counts()
    for name in ("logreg_block_sub", "dsag_cache_update", "gram_matvec"):
        if counts[name] == 0:
            fail(f"kernel {name} was never launched on the live path")
    print(f"  live path launches: {counts}")

    # 5.3 the logreg paper-scale dsag run through the plain versions on the card
    plain = EngineConfig(device="cuda", kernel_backend="torch")
    trainer, hist, wall = timed_run(torch, paper_live_opts("logreg", "dsag", plain))
    V_k, hist_k = finals["logreg", "dsag"]
    for f in ("mask_stream", "flush_stream", "evict_stream"):
        if not np.array_equal(np.stack(hist[f]), np.stack(hist_k[f])):
            fail(f"logreg/dsag: kernel and plain runs differ in {f}")
    V_p = trainer.state["params"]
    err = float((V_k - V_p).abs().max())
    if not torch.allclose(V_k, V_p, rtol=1e-4, atol=1e-5 * float(V_p.abs().max())):
        fail(f"logreg/dsag: kernel and plain final params differ by {err:.3e}")
    print(f"  logreg/dsag through the plain versions on the card: streams equal, final "
          f"params max |diff| {err:.3e} (rtol 1e-4, atol 1e-5 max|V|); {wall:.2f} s host")
    return counts


#: phase 7: iterations of the pca_paper_scale recipe held scalar == host ==
#: device (the recipe runs 80; the scalar simulator walks one event at a time)
PCA_ENGINE_DEPTH = 20
#: the host engine's median K1/K2 batch (tasks per masked call) on the grid
#: recipe's dsag, sag and sgd and on pca_paper_scale's dsag and sag at
#: PCA_ENGINE_DEPTH: phase 3 times the kernels there, phase 7 checks the
#: medians (the event streams, hence the batches, are deterministic)
HOST_BATCH = {"logreg_block_sub": 947, "pca_block_sub": 200}


def engines_equal(label: str, scalar, batched: dict, scenario: int = 0) -> None:
    """Fail unless every batched result (engine -> ConvergenceBatchResult)
    equals the scalar history on ``scenario``, and the batched results equal
    each other on every scenario, bit for bit."""
    from repro_torch.experiments.convergence import history_mismatches

    (first, res0), *rest = batched.items()
    bad = history_mismatches(scalar, res0, scenario)
    if bad:
        fail(f"{label}: the scalar simulator differs from the {first} engine in {bad}")
    for name, res in rest:
        for s in range(res.num_scenarios):
            bad = history_mismatches(res0.history(s), res, s)
            if bad:
                fail(f"{label}: the {name} engine differs from the {first} engine "
                     f"on scenario {s} in {bad}")


def recording(block_sub, name: str, sizes: list):
    """``mock.patch`` of a K1/K2 wrapper that records each masked-batch
    call's task count (not the coded bound's full-range calls)."""
    real = getattr(block_sub, name)

    def wrapper(X, *args):
        Vb, max_width = args[-4], args[-1]
        if max_width != X.shape[0]:
            sizes.append(Vb.shape[0])
        return real(X, *args)

    return mock.patch.object(block_sub, name, wrapper)


def run_engines(torch, outcomes: dict) -> dict:
    """Phase 7: the scalar simulator and the host engine through K1/K2 against
    the device engine (bit for bit), the live pin without the reference, and
    the ``BENCH_sweep.json`` grid on the card.  Returns the K1/K2 launches
    of the host and scalar runs."""
    import dataclasses

    from repro_torch.cluster.simulator import MethodConfig
    from repro_torch.core.problems import LogisticRegressionProblem, make_higgs_like
    from repro_torch.experiments.convergence import run_convergence_batch, scalar_convergence_run
    from repro_torch.experiments.engine import EngineConfig
    from repro_torch.experiments.grid import HEAVY_BURSTS, run_sweep, scalar_sweep_seconds
    from repro_torch.experiments.results import outcome_to_dict
    from repro_torch.ft.validation import pin_streams
    from repro_torch.kernels import block_sub, launch_counts, reset_launch_counts
    from repro_torch.latency.model import make_heterogeneous_cluster, sample_fleet

    card = EngineConfig(device="cuda", kernel_backend="cuda")
    host = dataclasses.replace(card, kind="host")
    counts = {"logreg_block_sub": 0, "pca_block_sub": 0}
    host_G = {"logreg_block_sub": [], "pca_block_sub": []}

    # (a) scalar == host == device through K1/K2
    for recipe, kname, methods, depth in (
        ("grid", "logreg_block_sub", ("dsag", "sag", "sgd", "coded"), None),
        ("pca_paper_scale", "pca_block_sub", ("dsag", "sag"), PCA_ENGINE_DEPTH),
    ):
        out, _ = outcomes[recipe]
        T = depth or out.num_iterations
        out = dataclasses.replace(out, num_iterations=T,
                                  methods={m: out.methods[m] for m in methods})
        runs = {"scan": {}, "host": {}}
        walls = {}
        for kind, eng in (("scan", card), ("host", host)):
            if kind == "scan" and depth is None:  # phase 4's runs at full depth
                runs[kind] = {m: out.results[m] for m in methods}
                walls[kind] = None
                continue
            reset_launch_counts()
            t0 = time.perf_counter()
            with recording(block_sub, kname, host_G[kname] if kind == "host" else []):
                for m in methods:
                    runs[kind][m] = run_convergence_batch(
                        out.problem, out.traces, out.methods[m], T,
                        eval_every=out.eval_every, seed=out.seed, engine=eng)
            torch.cuda.synchronize()
            walls[kind] = time.perf_counter() - t0
            if kind == "host":
                n_host = launch_counts()[kname]
                counts[kname] += n_host
        reset_launch_counts()
        t0 = time.perf_counter()
        scalar = {m: scalar_convergence_run(out, m, 0, engine=card) for m in methods}
        walls["scalar"] = time.perf_counter() - t0
        n_scalar = launch_counts()[kname]
        counts[kname] += n_scalar
        if n_host == 0 or n_scalar == 0:
            fail(f"{recipe}: {kname} was not launched on the host ({n_host}) or the "
                 f"scalar ({n_scalar}) path")
        for m in methods:
            engines_equal(f"{recipe}/{m}", scalar[m], {k: runs[k][m] for k in ("scan", "host")})
        S = out.traces.num_scenarios
        scan_wall = (f"{walls['scan']:.2f} s" if walls["scan"] is not None
                     else f"{outcomes[recipe][0].engine_seconds:.2f} s (phase 4, all 4 methods)")
        print(f"  {recipe} ({len(methods)} methods, {T} iterations, scenario 0 of {S}): "
              f"scalar == host == device bit for bit (times, fresh counts, per-worker "
              f"latencies, rejects, evictions, suboptimality); host and device equal on "
              f"all {S} scenarios")
        print(f"    wall clock: device engine {scan_wall}; host engine {walls['host']:.2f} s "
              f"({n_host} {kname} launches, tasks per launch median "
              f"{int(np.median(host_G[kname]))}); scalar simulator {walls['scalar']:.2f} s "
              f"for scenario 0 ({n_scalar} launches), {walls['scalar'] * S:.2f} s scaled to "
              f"{S} scenarios (scalar_convergence_seconds' extrapolation)")

    # phase 3 held and timed K1/K2 at these batches
    medians = {k: int(np.median(v)) for k, v in host_G.items()}
    if medians != HOST_BATCH:
        fail(f"the host engine's median K1/K2 batches {medians} are not phase 3's {HOST_BATCH}")

    # (b) the live pin: the port's controller == the port's scalar simulator
    live = json.loads((ROOT / "BENCH_convergence.json").read_text())["live_validation"]
    r = live["recipe"]
    n, G, T = r["num_samples"], r["n_workers"], r["num_iterations"]
    X, y = make_higgs_like(n, seed=r["seed"])
    prob = LogisticRegressionProblem(X=X, y=y)
    cluster = make_heterogeneous_cluster(G, seed=r["seed"] + 3, burst_rate=0.0,
                                         load_unit=prob.compute_cost(1, n // G))
    traces = sample_fleet(cluster, r["n_scenarios"], 4 * T, burst_rate=HEAVY_BURSTS.rate,
                          burst_factor_mean=HEAVY_BURSTS.factor_mean,
                          burst_duration_mean=HEAVY_BURSTS.duration_mean, seed=r["seed"] + 7)
    jobs = [("live_validation", prob, cluster, traces, r["scenario"], T, r["w"], r["eta"],
             r["margin"], r["seed"])]
    n, G, w, eta = PAPER_JOBS["logreg"]
    X, y = make_higgs_like(n, seed=0)
    prob = LogisticRegressionProblem(X=X, y=y)
    cluster = make_heterogeneous_cluster(G, seed=3, burst_rate=0.0,
                                         load_unit=prob.compute_cost(1, n // G))
    traces = sample_fleet(cluster, 2, 4 * 80, burst_rate=HEAVY_BURSTS.rate,
                          burst_factor_mean=HEAVY_BURSTS.factor_mean,
                          burst_duration_mean=HEAVY_BURSTS.duration_mean, seed=7)
    jobs.append(("paper-scale logreg", prob, cluster, traces, 0, 80, w, eta, 0.02, 0))
    for label, prob, cluster, traces, scen, T, w, eta, margin, seed in jobs:
        for m in ("dsag", "sag"):
            cfg = MethodConfig(name=m, w=w, eta=eta, margin=margin, subpartitions=1)
            t0 = time.perf_counter()
            ctrl, sim, hist = pin_streams(prob, cluster, traces, scen, cfg, T, seed=seed,
                                          engine=card)
            wall = time.perf_counter() - t0
            if not (ctrl == sim and np.array_equal(ctrl.times, sim.times)):
                fail(f"pin {label}/{m}: controller and simulator differ: "
                     f"{ctrl.mismatch_summary(sim)}")
            msg = ""
            if label == "live_validation":
                want = live["methods"][m]["virtual_time_to_gap"]
                got = hist.time_to_gap(r["gap"])
                msg = (f"; simulator time-to-gap {got!r} (the reference's {want!r}, "
                       f"equal: {got == want})")
            print(f"  pin {label}/{m} ({traces.num_workers} groups, {T} steps): controller "
                  f"== simulator (mask, flush, evict, virtual times; Σ fresh "
                  f"{int(sim.mask.sum())}, Σ flush {int(sim.flush.sum())}) in {wall:.2f} s{msg}")

    # (c) the BENCH_sweep.json grid on the card
    committed = json.loads((ROOT / "BENCH_sweep.json").read_text())
    g = committed["grid"]
    sweep = run_sweep(n_workers=g["n_workers"], n_seeds=g["n_seeds"],
                      num_iterations=g["num_iterations"], w_fracs=(0.8,), device="cuda")
    mine = outcome_to_dict(sweep)
    fields = ("mean_iter_time", "std_iter_time", "mean_fresh", "n_seeds")
    if set(mine["cells"]) != set(committed["cells"]):
        fail(f"sweep cells {sorted(mine['cells'])} vs committed {sorted(committed['cells'])}")
    for key, cell in committed["cells"].items():
        for f in fields:
            if mine["cells"][key][f] != cell[f]:
                fail(f"sweep cell {key}: {f} {mine['cells'][key][f]!r} vs committed {cell[f]!r}")
    if mine["ordering"] != committed["ordering"]:
        fail(f"sweep orderings differ from the committed ones: {mine['ordering']}")
    scalar_s = scalar_sweep_seconds(sweep)
    print(f"  BENCH_sweep grid ({g['n_workers']} workers x {g['n_seeds']} seeds x "
          f"{g['num_iterations']} iterations, {len(mine['cells'])} cells, 3 regimes): "
          f"{', '.join(fields)} and the 3 orderings equal the committed file; engine "
          f"{sweep.engine_seconds:.3f} s on the card, scalar_sweep_seconds {scalar_s:.2f} s "
          f"({scalar_s / sweep.engine_seconds:.1f}x)")
    return counts


def logit_diff(torch, got, want) -> tuple[float, float]:
    """(max |got - want| / max |want|, ||got - want|| / ||want||), float32."""
    got, want = got.float(), want.float()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        fail("non-finite logits")
    d = got - want
    return float(d.abs().max() / want.abs().max()), float(d.norm() / want.norm())


def decode_step_f32_scores(cfg, params, x, cache, index: int):
    """``models.attention.gqa_decode_step`` with its scores and probabilities
    kept in float32, as K6's prefill keeps them: K6's plain version over the
    cache's first ``index + 1`` positions."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models.attention import _project_qkv, _repeat_kv
    from repro_torch.models.layers import apply_rope

    q, k_new, v_new = _project_qkv(cfg, params, x)
    pos = torch.full((x.shape[0], 1), index, dtype=torch.int32, device=x.device)
    q, k_new = apply_rope(q, pos, cfg.rope_theta), apply_rope(k_new, pos, cfg.rope_theta)
    k, v = cache["k"], cache["v"]
    k[:, index:index + 1] = k_new.to(k.dtype)
    v[:, index:index + 1] = v_new.to(v.dtype)
    groups = q.shape[2] // k.shape[2]
    kk, vv = (_repeat_kv(t[:, :index + 1], groups).transpose(1, 2) for t in (k, v))
    out = flash_attention_plain(q.transpose(1, 2), kk, vv).transpose(1, 2)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype)), cache


def serving_prompts(vocab: int):
    return np.random.default_rng(0).integers(0, vocab, (SERVE_B, SERVE_PROMPT))


def run_serving(torch) -> dict:
    """Phase 6: serve qwen1.5-0.5b at full width and depth through K6."""
    import dataclasses

    from repro_torch.kernels import flash_attention as k6
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import Server
    from repro_torch.models import attention as attn
    from repro_torch.models import build_model
    from repro_torch.models.layers import apply_norm, apply_rope, tree_map
    from repro_torch.models.transformer import embed_inputs, layer_params

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    max_len = SERVE_PROMPT + SERVE_TOKENS + 8
    srv = Server("qwen1.5-0.5b", smoke=False, max_len=max_len, device="cuda", seed=0)
    cfg, params, L = srv.cfg, srv.params, srv.cfg.num_layers
    prompts = serving_prompts(cfg.vocab_size)
    print(f"  {cfg.name}: {L} layers, d_model {cfg.d_model}, {cfg.num_heads} heads x "
          f"{cfg.resolved_head_dim}, {srv.model.num_params() / 1e6:.1f} M params "
          f"(bf16, seed 0); batch {SERVE_B} x prompt {SERVE_PROMPT}, {SERVE_TOKENS} tokens, "
          f"cache {max_len}")
    srv.generate({"tokens": prompts[:, :128]}, 2)  # warm the libraries (not counted)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    toks = srv.generate({"tokens": prompts}, SERVE_TOKENS)
    counts = launch_counts()
    t = srv.timings
    if counts["flash_attention"] != L:
        fail(f"serving: {counts['flash_attention']} flash_attention launches for one "
             f"prefill, expected {L}")
    vocab_padded = params["embed"]["tok"].shape[0]
    if toks.shape != (SERVE_B, SERVE_TOKENS) or not bool(((toks >= 0) & (toks < vocab_padded)).all()):
        fail(f"serving: generated tokens of shape {tuple(toks.shape)} outside [0, {vocab_padded})")
    decode_ms = t["decode"] / (SERVE_TOKENS - 1) * 1e3
    tok_s = SERVE_B * SERVE_TOKENS / (t["prefill"] + t["decode"])
    print(f"  generate through K6 ({smi}): prefill {t['prefill']:.4f} s "
          f"({SERVE_B * SERVE_PROMPT / t['prefill']:.0f} prompt tok/s), decode "
          f"{decode_ms:.3f} ms/token step ({SERVE_B / decode_ms * 1e3:.0f} tok/s), "
          f"{tok_s:.1f} generated tok/s end to end; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {counts}")
    out = {"launches": counts["flash_attention"], "prefill_s": t["prefill"],
           "decode_ms_per_token": decode_ms, "tokens_per_s": tok_s}
    k6_prefills = 1

    with torch.inference_mode():
        # three runs over the same weights, teacher-forced with the plain run's
        # tokens: bf16 through K6, bf16 through full_attention, and the float32
        # model through full_attention as the yardstick of both
        tokens = torch.as_tensor(prompts, device="cuda")
        batch = {"tokens": tokens}
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        p32 = tree_map(lambda a: a.float(), params)
        runs = {"k6": (srv.model, params),
                "plain": (build_model(cfg, kernel_backend="torch"), params),
                "f32": (build_model(cfg32, kernel_backend="torch"), p32)}
        logits, caches, prefill_s = {}, {}, {}
        for name, (model, p) in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, caches[name] = model.prefill(p, batch, max_len)
            torch.cuda.synchronize()
            prefill_s[name] = time.perf_counter() - t0
            logits[name] = [lg[:, -1]]
        k6_prefills += 1
        tok = logits["plain"][0].argmax(-1)[:, None]
        for step in range(SERVE_TOKENS - 1):
            for name, (model, p) in runs.items():
                lg, caches[name] = model.decode_step(p, tok, caches[name], SERVE_PROMPT + step)
                logits[name].append(lg[:, -1])
            tok = logits["plain"][-1].argmax(-1)[:, None]
        rms = {pair: [logit_diff(torch, a, b)[1] for a, b in zip(logits[pair[0]], logits[pair[1]])]
               for pair in (("k6", "plain"), ("k6", "f32"), ("plain", "f32"))}
        agree = float(np.mean([float((a.argmax(-1) == b.argmax(-1)).float().mean())
                               for a, b in zip(logits["k6"], logits["plain"])]))
        tol = SERVE_TOL["k6_vs_plain"]
        worst = max(rms["k6", "plain"])
        err_k6, err_plain = float(np.mean(rms["k6", "f32"])), float(np.mean(rms["plain", "f32"]))
        print(f"  prefill + {SERVE_TOKENS - 1} teacher-forced steps (prefill s: K6 "
              f"{prefill_s['k6']:.4f}, plain {prefill_s['plain']:.4f}, float32 plain "
              f"{prefill_s['f32']:.4f}): rel RMS of logits K6 vs plain worst {worst:.4f} "
              f"(tolerance {tol}); against the float32 run, mean K6 {err_k6:.4f} and plain "
              f"{err_plain:.4f} (K6 must be no further); greedy tokens K6 vs plain agree "
              f"{agree:.3f} of {SERVE_B * SERVE_TOKENS}")
        if worst > tol:
            fail(f"serving: K6 and plain runs differ by rel RMS {worst} (tolerance {tol})")
        if err_k6 > err_plain:
            fail(f"serving: the K6 run is further from the float32 run ({err_k6}) than "
                 f"the plain run ({err_plain})")
        out.update(k6_vs_plain_rel_rms=worst, k6_vs_f32_rel_rms=err_k6,
                   plain_vs_f32_rel_rms=err_plain, greedy_agree=agree,
                   plain_prefill_s=prefill_s["plain"])
        del caches

        # the float32 model through K6 against the float32 model through full_attention
        k6_32 = build_model(cfg32, kernel_backend="cuda")
        lg, cache = k6_32.prefill(p32, batch, max_len)
        del cache
        k6_prefills += 1
        lg_f32k6 = lg[:, -1]
        d32 = logit_diff(torch, lg_f32k6, logits["f32"][0])
        print(f"  float32 model through K6 vs through full_attention: prefill logits "
              f"max|diff|/max {d32[0]:.3e}, rel RMS {d32[1]:.3e} (tolerance {SERVE_F32_TOL})")
        if max(d32) > SERVE_F32_TOL:
            fail(f"serving: float32 K6 and plain prefills differ by {d32}")
        out.update(f32_max_rel=d32[0], f32_rel_rms=d32[1])

        # decode of token s from an (s-1)-token cache against the s-token prefill:
        # bf16 through K6, bf16 with no kernel (prefill and decode attention
        # alike), and float32 through K6
        cases = (("bf16 K6", srv.model, params, logits["k6"][0], SERVE_TOL["decode_vs_prefill"]),
                 ("bf16 plain", runs["plain"][0], params, logits["plain"][0], None),
                 ("float32 K6", k6_32, p32, lg_f32k6, SERVE_F32_TOL))
        for label, model, p, want, tol in cases:
            _, cache_m1 = model.prefill(p, {"tokens": tokens[:, :-1]}, max_len)
            k6_prefills += model.kernel_backend == "cuda"
            lg_d, _ = model.decode_step(p, tokens[:, -1:], cache_m1, SERVE_PROMPT - 1)
            del cache_m1
            dp = logit_diff(torch, lg_d[:, -1], want)[1]
            print(f"  {label}: decode of token {SERVE_PROMPT} from a {SERVE_PROMPT - 1}-token "
                  f"cache vs the {SERVE_PROMPT}-token prefill: rel RMS {dp:.3e} "
                  f"(tolerance {tol if tol is not None else 'none: printed beside K6'})")
            if tol is not None and dp > tol:
                fail(f"serving: {label} decode-vs-prefill logits differ by rel RMS {dp} "
                     f"(tolerance {tol})")
            out[f"decode_vs_prefill_rel_rms_{label.replace(' ', '_')}"] = dp
        # the witness of the bf16 K6 gap: the same decode from the K6 cache with
        # its scores kept in float32 (K6's plain version over the cache)
        _, cache_m1 = srv.model.prefill(params, {"tokens": tokens[:, :-1]}, max_len)
        k6_prefills += 1
        with mock.patch.object(attn, "gqa_decode_step", decode_step_f32_scores):
            lg_d, _ = srv.model.decode_step(params, tokens[:, -1:], cache_m1, SERVE_PROMPT - 1)
        del cache_m1
        dp = logit_diff(torch, lg_d[:, -1], logits["k6"][0])[1]
        print(f"  bf16 K6, decode with float32 scores (witness): decode vs prefill rel RMS "
              f"{dp:.3e} (none: printed beside the bf16 K6 and plain rows)")
        out["decode_vs_prefill_rel_rms_bf16_K6_f32_scores"] = dp
        del logits
    total = launch_counts()["flash_attention"]
    if total != L * k6_prefills:
        fail(f"serving: {total} flash_attention launches for {k6_prefills} prefills")
    print(f"  flash_attention launches in phase 6: {total} = {L} x {k6_prefills} prefills")
    with torch.inference_mode():
        # K6 on layer 0's real activations (scores of a few hundred at this init)
        lp = layer_params(params["blocks"], 0)
        h = apply_norm(cfg, lp["ln1"], embed_inputs(cfg, params, tokens))
        q, k, v = attn._project_qkv(cfg, lp["attn"], h)
        pos = torch.arange(SERVE_PROMPT, device="cuda").expand(SERVE_B, SERVE_PROMPT)
        q, k = apply_rope(q, pos, cfg.rope_theta), apply_rope(k, pos, cfg.rope_theta)
        got = k6.flash_attention_bshd(q, k, v)
        want32 = k6.flash_attention_plain(*(x.float().transpose(1, 2) for x in (q, k, v)))
        if not k6_within_tolerance(torch, got, want32.transpose(1, 2)):
            fail("flash_attention on layer 0's activations disagrees with its plain version")
        print(f"  K6 on layer 0's q, k, v (|q| <= {float(q.abs().max()):.1f}): within "
              f"tolerance of its plain version, max |diff| "
              f"{float((got.float() - want32.transpose(1, 2)).abs().max()):.3e}")

    return out


def profile_run(torch, label: str, setup, iters: int) -> dict | None:
    """One warm run under ``torch.profiler``: host wall clock (ending in a
    synchronize), the union of device kernel intervals (busy time), the idle
    share, kernel count, and the kernels that take the most time.
    ``setup()`` returns the run to time (set-up stays outside the window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    setup()()  # warm
    torch.cuda.synchronize()
    run = setup()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        print(f"  profile {label}: the profiler recorded no device time (not measured)")
        return None
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    by_name: dict[str, float] = {}
    for s, e, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    busy_ms = busy / 1e3
    window_ms = (spans[-1][1] - spans[0][0]) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"  profile {label} ({iters} iters, profiler on): host wall {wall_ms:.1f} ms, "
          f"device busy {busy_ms:.2f} ms over a {window_ms:.1f} ms kernel window, "
          f"idle share {1 - busy_ms / window_ms:.3f}; {len(spans)} device kernels "
          f"({len(spans) / iters:.0f} per iteration)")
    for name, us in top:
        print(f"    {us / 1e3:8.3f} ms  {name[:90]}")
    return {"busy_ms": busy_ms, "window_ms": window_ms, "by_name_us": by_name}


def profile_paths(torch) -> None:
    """``--profile``: the grid recipe's dsag column (60 iterations) and the
    paper-scale live logreg and PCA dsag jobs (80 steps each)."""
    from repro_torch.experiments.convergence import grid_logreg_sweep, run_convergence_batch
    from repro_torch.experiments.engine import EngineConfig
    from repro_torch.launch.train import Trainer

    out, _ = grid_logreg_sweep(seed=0, engine=EngineConfig())  # problem, traces, methods
    cfg, T = out.methods["dsag"], out.num_iterations
    profile_run(torch, "grid/dsag", lambda: lambda: run_convergence_batch(
        out.problem, out.traces, cfg, T, eval_every=out.eval_every, engine=EngineConfig()), T)
    for arch in PAPER_JOBS:
        opts = paper_live_opts(arch, "dsag", EngineConfig())
        profile_run(torch, f"live {arch}/dsag", lambda: Trainer(opts).run, opts.steps)


def profile_serving(torch) -> None:
    """``--profile``: the serving cell's prefill (K6's share of device time)
    and one decode step (the device's idle share)."""
    from repro_torch.launch.serve import Server

    max_len = SERVE_PROMPT + SERVE_TOKENS + 8
    srv = Server("qwen1.5-0.5b", smoke=False, max_len=max_len, device="cuda", seed=0)
    batch = {"tokens": torch.as_tensor(serving_prompts(srv.cfg.vocab_size), device="cuda")}
    params, model = srv.params, srv.model

    @torch.inference_mode()
    def prefill():
        return model.prefill(params, batch, max_len)

    prof = profile_run(torch, "serve prefill", lambda: prefill, 1)
    if prof is not None:
        k6_us = sum(us for name, us in prof["by_name_us"].items() if "flash_fwd" in name)
        print(f"    K6 share of prefill device time: {k6_us / 1e3 / prof['busy_ms']:.3f} "
              f"({k6_us / 1e3:.3f} of {prof['busy_ms']:.3f} ms)")
    logits, cache = prefill()
    tok = logits[:, -1].argmax(-1)[:, None]

    @torch.inference_mode()
    def step():
        return model.decode_step(params, tok, cache, SERVE_PROMPT)

    profile_run(torch, "serve decode step", lambda: step, 1)


def ptxas_report(log: str) -> list[str]:
    """``-Xptxas -v``'s registers, spills and shared memory, one line per
    kernel and line of the report, under the kernel's (template) name."""
    import re

    lines, name = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            # _ZN <len><anonymous namespace> <len><kernel> [I Li<D> E ...]
            name = entry.group(1)
            parts = re.match(r"_ZN(\d+)", name)
            if parts:
                rest = name[parts.end() + int(parts.group(1)):]
                m = re.match(r"(\d+)", rest)
                if m:
                    rest = rest[m.end():]
                    tmpl = re.match(r"IL[ib](\d+)E", rest[int(m.group(1)):])
                    name = rest[:int(m.group(1))] + (f"<{tmpl.group(1)}>" if tmpl else "")
        elif name and ("spill" in line or "Used" in line):
            lines.append(f"{name}: {line.split(' : ', 1)[-1].strip()}")
    return lines


def build_times(_build) -> None:
    """``--build-times``: the kernel library built from scratch by one ``nvcc``
    call over every source, against ``_build.compile_library`` (one ``nvcc``
    per source, started together, then a link), in turns."""
    import tempfile

    sources = sorted(_build.CSRC.glob("*.cu"))
    one_call = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared"]
    times: dict[str, list[float]] = {"one nvcc call": [], "one nvcc per source": []}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        for rep in range(2):
            for label in (times if rep == 0 else reversed(times)):
                out = Path(tmp) / f"{rep}_{len(times[label])}_{label[-6:]}.so"
                t0 = time.perf_counter()
                if label == "one nvcc call":
                    subprocess.run([*one_call, "-o", str(out), *map(str, sources)],
                                   capture_output=True, check=True)
                else:
                    _build.compile_library(sources, out)
                times[label].append(time.perf_counter() - t0)
    print(f"  build from scratch, {len(sources)} sources, s: " + "; ".join(
        f"{label} {', '.join(f'{t:.2f}' for t in ts)}" for label, ts in times.items()))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.problems import make_genomics_like_matrix, make_higgs_like
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.library()
    print(f"phase 2: built {_build.build_info['path']} in {time.perf_counter() - t0:.1f} s")
    for line in ptxas_report(_build.build_info.get("log", "")):
        print(f"  ptxas: {line}")

    # the launch plans and the engines' capability checks read the kernels'
    # limits from Python mirrors: hold each against the compiled value
    bad = _build.mirror_mismatches()
    if bad:
        fail(f"mirrored kernel limits differ from the compiled ones (mirrored, compiled): {bad}")
    print(f"  {len(_build.LIMITS)} mirrored limits equal the compiled ones")

    if "--build-times" in sys.argv[1:]:
        build_times(_build)

    print("phase 3: kernels against their plain versions at the recipes' shapes")
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    Xh, yh = make_higgs_like(16_384, seed=0)
    Xh, yh = torch.as_tensor(Xh, device=dev), torch.as_tensor(yh, device=dev)
    Xg = torch.as_tensor(make_genomics_like_matrix(50_000, 96, seed=0), device=dev)
    # the wide paths (any feature width): K1 on the grid call's task layout
    # at d = 97 and 1000, K2 at d = 180 (k = 3) and k = 12 (d = 96)
    Xw = {d: torch.as_tensor(rng.normal(size=(16_384, d)), dtype=torch.float32, device=dev)
          for d in (97, 1000)}
    X180 = torch.as_tensor(make_genomics_like_matrix(50_000, 180, seed=0), device=dev)
    per_kernel = {
        "logreg_block_sub": check_block_sub(torch, "logreg", Xh, yh, rng) + [
            row for d in (97, 1000) for row in check_block_sub(
                torch, "logreg", Xw[d], yh, rng, shapes={f"grid d={d}": (100, 10, 10)})],
        "pca_block_sub": check_block_sub(torch, "pca", Xg, None, rng)
        + check_block_sub(torch, "pca", X180, None, rng, shapes={"grid d=180": (50, 5, 4)})
        + check_block_sub(torch, "pca", Xg, None, rng, shapes={"grid k=12": (50, 5, 4)}, k=12),
        "grid_cache_update": [
            check_cache_walk(torch, 10, 200, 1000, 29, 60, rng),
            check_cache_walk(torch, 4, 100, 250, 288, 80, rng),
        ],
        # the live path's shapes: logreg paper scale, PCA paper scale (50
        # groups x 64 x 3), live_validation; then the bf16 kernels_bench shape
        "dsag_cache_update": [
            check_dsag_update(torch, 100, 29, torch.float32, rng),
            check_dsag_update(torch, 50, 192, torch.float32, rng),
            check_dsag_update(torch, 8, 29, torch.float32, rng),
            check_dsag_update(torch, 8, 1 << 20, torch.bfloat16, rng),
        ],
        "gram_matvec": [
            check_gram_matvec(
                torch,
                torch.as_tensor(make_genomics_like_matrix(50_000, 64, seed=0),
                                device=dev).view(50, 1000, 64),
                torch.as_tensor(np.linalg.qr(rng.normal(size=(64, 3)))[0],
                                dtype=torch.float32, device=dev).contiguous()),
            check_gram_matvec(
                torch,
                torch.as_tensor(rng.normal(size=(4096, 512)), dtype=torch.float32, device=dev),
                torch.as_tensor(rng.normal(size=(512, 8)), dtype=torch.float32, device=dev)),
            # the wide path: d past 1024, k past 8
            check_gram_matvec(
                torch,
                torch.as_tensor(make_genomics_like_matrix(50_000, 1100, seed=0),
                                device=dev).view(50, 1000, 1100),
                torch.as_tensor(np.linalg.qr(rng.normal(size=(1100, 3)))[0],
                                dtype=torch.float32, device=dev).contiguous()),
            check_gram_matvec(
                torch,
                torch.as_tensor(rng.normal(size=(4096, 64)), dtype=torch.float32, device=dev),
                torch.as_tensor(rng.normal(size=(64, 12)), dtype=torch.float32, device=dev)),
        ],
        # the serving prefill (24 launches per prefill), the kernels_bench
        # shape, a decode-like single query row over the full cache, a length
        # that is no multiple of the tiles, and GQA (16 q heads over 2 kv
        # heads) in the model's [b, s, h, d] layout
        "flash_attention": [
            check_flash(torch, SERVE_B, 16, SERVE_PROMPT, SERVE_PROMPT, 64, rng),
            check_flash(torch, 1, 4, 1024, 1024, 128, rng),
            check_flash(torch, SERVE_B, 16, 1, SERVE_PROMPT + SERVE_TOKENS + 5, 64, rng),
            check_flash(torch, SERVE_B, 16, 2085, 2085, 64, rng),
            check_flash(torch, SERVE_B, 16, SERVE_PROMPT, SERVE_PROMPT, 64, rng, kvh=2),
        ],
    }
    # K1 and K2 at the scalar simulator's single task and the host engine's
    # median masked batch (phase 7 fails unless the host engine's batches
    # have that median), padded to the run's task_pad_width
    G_log, G_pca = HOST_BATCH["logreg_block_sub"], HOST_BATCH["pca_block_sub"]
    per_kernel["logreg_block_sub"] += check_block_sub(
        torch, "logreg", Xh, yh, rng,
        shapes={"scalar G=1": (100, 10, 10, 1), f"host G={G_log}": (100, 10, 10, G_log)})
    per_kernel["pca_block_sub"] += check_block_sub(
        torch, "pca", Xg, None, rng,
        shapes={"scalar G=1": (50, 5, 4, 1), f"host G={G_pca}": (50, 5, 4, G_pca)})
    # K3 at a dsag sweep of 5000 workers (p = 10): five windows of ranks, one
    # walk block per scenario; last, as its plain version's many launches
    # leave the profiler without device times for the kernels after it (so do
    # phases 4-7: every device time is taken in phase 3)
    per_kernel["grid_cache_update"].append(check_cache_walk(
        torch, 2, 10_000, 50_000, 29, 60, np.random.default_rng(1), plain_reps=1))
    if "--profile" in sys.argv[1:]:
        profile_paths(torch)
        profile_serving(torch)
    if {"--quick", "--profile", "--build-times"} & set(sys.argv[1:]):
        print(json.dumps({"per_kernel": per_kernel}))
        return

    print("phase 4: the grid and pca_paper_scale recipes through the kernels")
    sweep_launches, _, outcomes = run_recipes(torch)
    wide_launches = run_wide_sweep(torch)
    print("phase 5: the live two-tier trainer through the kernels")
    live_launches = run_live(torch)
    print("phase 6: serving qwen1.5-0.5b at full width and depth through K6")
    serving = run_serving(torch)
    print("phase 7: the scalar simulator and the host engine against the device engine, "
          "the live pin, the BENCH_sweep grid")
    t0 = time.perf_counter()
    engine_launches = run_engines(torch, outcomes)
    print(f"  phase 7 took {time.perf_counter() - t0:.1f} s")
    launches = {k: sweep_launches[k] + live_launches[k] + wide_launches[k]
                + engine_launches.get(k, 0) for k in sweep_launches}
    launches["flash_attention"] = serving["launches"]

    meta = {
        "logreg_block_sub": ("src/repro_torch/kernels/csrc/block_sub.cu",
                             "src/repro/kernels/block_sub.py:134"),
        "pca_block_sub": ("src/repro_torch/kernels/csrc/block_sub.cu",
                          "src/repro/kernels/block_sub.py:99"),
        "grid_cache_update": ("src/repro_torch/kernels/csrc/cache_events.cu",
                              "src/repro/kernels/cache_events.py:107"),
        "dsag_cache_update": ("src/repro_torch/kernels/csrc/dsag_update.cu",
                              "src/repro/kernels/dsag_update.py:47"),
        "gram_matvec": ("src/repro_torch/kernels/csrc/gram_matvec.cu",
                        "src/repro/kernels/gram_matvec.py:41"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:78"),
    }
    kernels = []
    for name, rows in per_kernel.items():
        main_row = rows[0]  # the per-iteration call of the first recipe / job
        source, replaces = meta[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], launches_sweep=sweep_launches.get(name, 0),
            launches_wide_sweep=wide_launches.get(name, 0),
            launches_live=live_launches.get(name, 0),
            launches_engines=engine_launches.get(name, 0),
            launches_serve=serving["launches"] if name == "flash_attention" else 0,
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=main_row["ms"], kernel_ms=main_row["ms"], plain_ms=main_row["plain_ms"],
            bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"], calls=rows,
        ))
    print(json.dumps({"serving": serving}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
