"""Registered entry points the lint rules run against.

Each entry builds a small but production-shaped probe at the reference's
sizes (``repro.analysis.lint.entries``: 4 workers, 2 scenarios, 6
iterations; the kernels at n = 64, pad 16, widths 11/16/13): the fused
entries run the real device engine (``run_convergence_scan``), the kernel
entries the real ``FusedKernels.sub_blocks`` closures and wrappers, and so
on, on the device the lint runs on.  On the CPU every kernel is its plain
version; on the card the ``*_cuda`` fused entries (the counterparts of the
reference's ``*_pallas`` entries) run the device engine through the CUDA
kernels, and each entry adds the checks only the card can make
(``card_checks``): its event streams and kernel outputs against the CPU
run (TL001), its kernels' results at two pad widths (TL003).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from repro_torch.cluster import simulator
from repro_torch.cluster.simulator import MethodConfig
from repro_torch.configs.base import TrainConfig
from repro_torch.core import dsag_pjit
from repro_torch.core.problems import (
    LogisticRegressionProblem,
    PCAProblem,
    make_genomics_like_matrix,
    make_higgs_like,
)
from repro_torch.experiments import fused
from repro_torch.experiments.engine import EngineConfig
from repro_torch.kernels import cache_events, dsag_update, gram_matvec, what_if
from repro_torch.latency import model as latency_model
from repro_torch.latency.model import ChurnSchedule, make_heterogeneous_cluster, sample_fleet
from repro_torch.lb import jit_optimizer as jlb
from repro_torch.lb.optimizer import what_if_normals

CPU = torch.device("cpu")
F64 = torch.float64

#: the device engine's loop carries that TL004 holds to their dtype: event
#: times, in-flight latencies and values, the cache, the iterate
SCAN_CARRIES = ("free_at", "iter_end", "draw_idx", "flight_comp", "flight_comm",
                "flight_titer", "flight_val", "cache", "V")
#: the tiled §6 cache's per-rank walk (TL002, TL005) and its large tables:
#: the value table (frozen at loop entry, and its write copy) and the entry tables
TILED_WALK = (lambda: fused._apply_cache_events_tiled,
              ("values0", "values", "iters", "slots", "wmap"))
#: float32 tolerance of K1, K2 and K5 against themselves at another pad width
PAD_RTOL, PAD_ATOL_REL = 1e-4, 1e-5


@dataclasses.dataclass
class EntryProbe:
    """One registered entry point on one device, annotated for the rules.

    ``run`` is the entry's torch program, run once under the trace
    (:mod:`repro_torch.analysis.lint.trace`); ``event_algebra`` says that
    TL001's fused-multiply-add scan and TL004's leak scan apply to its ops.
    ``latency_probe`` is ``(fn, batches)`` for TL001's comparison with
    numpy, ``loop`` ``(function, carry names)`` for TL004's carries,
    ``region`` ``(getter of a function, table names)`` for the per-rank loop
    TL002 and TL005 audit,
    ``padded_axis_sizes`` the pad widths TL003 audits reductions over, and
    ``declared_output_dtypes`` the dtypes of ``run``'s tensor outputs, in
    order (TL004).  ``card_checks`` are ``(code, check)`` pairs: ``check()``
    returns ``[(symbol, message), ...]`` of violations; ``notes`` collects
    what the checks report besides (e.g. which kernels are bit-equal).
    """

    name: str
    description: str
    device: torch.device
    run: Callable[[], Any] | None = None
    event_algebra: bool = False
    latency_probe: tuple | None = None
    loop: tuple | None = None
    region: tuple | None = None
    padded_axis_sizes: tuple = ()
    declared_output_dtypes: tuple | None = None
    card_checks: list = dataclasses.field(default_factory=list)
    notes: list = dataclasses.field(default_factory=list)
    trace: Any = None  # filled by the runner


# --------------------------------------------------------------------------
# shared probe fixtures (small, deterministic, CPU-cheap)
# --------------------------------------------------------------------------

_PROBE_WORKERS = 4
_PROBE_SCENARIOS = 2
_PROBE_ITERS = 6
#: the kernel probe: windows at n = 64 padded to width_bucket 16, and the next rung
_PAD, _NEXT_PAD = 16, 32
_STARTS, _WIDTHS = (1, 17, 33), (11, 16, 13)


@functools.lru_cache(maxsize=None)
def _probe_logreg():
    X, y = make_higgs_like(64, seed=0)
    return LogisticRegressionProblem(X=X, y=y)


@functools.lru_cache(maxsize=None)
def _probe_pca():
    return PCAProblem(X=make_genomics_like_matrix(64, 24, seed=0), k=2)


@functools.lru_cache(maxsize=None)
def _probe_traces():
    cluster = make_heterogeneous_cluster(
        _PROBE_WORKERS, seed=3, burst_rate=0.0, comp_range=(1.1e-3, 2.5e-3)
    )
    return sample_fleet(cluster, _PROBE_SCENARIOS, 10, burst_rate=0.0, seed=11)


@functools.lru_cache(maxsize=None)
def _probe_churn_traces():
    """The probe fleet under elastic churn: one death inside the probe
    horizon plus a slowdown drift, so the run takes the liveness mask,
    per-start slowdown rows and dead-entry cache clears."""
    traces = _probe_traces()
    sd = np.asarray(traces.slowdown)
    alive0 = np.ones(_PROBE_WORKERS, bool)
    alive1 = alive0.copy()
    alive1[3] = False
    return traces.with_churn(ChurnSchedule(
        times=np.array([0.004]),
        slowdown=np.stack([sd, sd * 1.2]),
        alive=np.stack([alive0, alive1]),
    ))


@contextlib.contextmanager
def recording(module, name: str):
    """Record every call of ``module.name`` meanwhile: a list of ``(args,
    outputs)``, both cloned at the call (the engine may reuse its buffers)."""
    calls = []
    fn = getattr(module, name)

    def wrapped(*args):
        out = fn(*args)
        calls.append((tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args),
                      tuple(o.clone() for o in (out if isinstance(out, tuple) else (out,)))))
        return out

    setattr(module, name, wrapped)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def _cpu(x):
    return x.cpu() if isinstance(x, torch.Tensor) else x


def _against_plain(calls, plain, what: str) -> list:
    """A kernel's recorded card outputs against its plain version on the
    CPU, on the same inputs: ``torch.equal`` for every output."""
    bad = []
    for i, (args, outs) in enumerate(calls):
        want = plain(*(_cpu(a) for a in args))
        want = want if isinstance(want, tuple) else (want,)
        for j, (g, w) in enumerate(zip(outs, want)):
            if not torch.equal(g.cpu(), w):
                bad.append((f"{what}:call{i}:output{j}",
                            f"{what}'s output {j} on the card differs from its plain version "
                            f"on the CPU (call {i} of {len(calls)})"))
    return bad


# --------------------------------------------------------------------------
# the fused (device engine) entries
# --------------------------------------------------------------------------

_STREAMS = ("times", "fresh_counts", "per_worker_latency", "rejected_stale", "evictions")


def _fused_probe(name: str, description: str, device, problem, config, *, traces=None,
                 backend: str = "torch", slot_budget: int | None = None) -> EntryProbe:
    traces = _probe_traces() if traces is None else traces

    def scan(dev, kernel_backend):
        return fused.run_convergence_scan(
            problem, traces, config, _PROBE_ITERS,
            engine=EngineConfig(device=str(dev), kernel_backend=kernel_backend,
                                slot_budget=slot_budget))

    probe = EntryProbe(name, description, device, event_algebra=True,
                       loop=(fused._run_scan, SCAN_CARRIES), region=TILED_WALK)
    k3 = []

    def run():
        if backend != "cuda":
            return scan(device, backend)
        with recording(cache_events, "grid_cache_update") as calls:
            out = scan(device, backend)
        k3.extend(calls)
        return out

    probe.run = run

    def streams_match_cpu():
        mine, cpu = probe.trace.outputs, scan(CPU, "torch")
        bad = [(f"stream:{f}", f"{f} on {device} ({backend} kernels) differs from the CPU run")
               for f in _STREAMS
               if not np.array_equal(getattr(mine, f), getattr(cpu, f), equal_nan=True)]
        if mine.repartition_events != cpu.repartition_events:
            bad.append(("stream:repartition_events",
                        f"§6 publication times on {device} differ from the CPU run"))
        bad += _against_plain(k3, cache_events.grid_cache_update_plain, "grid_cache_update")
        if backend == "cuda" and not k3:
            bad.append(("grid_cache_update:launches", "the run launched no K3"))
        if not bad:
            probe.notes.append(f"event streams equal to the CPU run's"
                               + (f"; {len(k3)} K3 calls equal to its plain version on the CPU"
                                  if k3 else ""))
        return bad

    if device.type != "cpu":
        probe.card_checks.append(("TL001", streams_match_cpu))
    return probe


def _dsag(load_balance: bool = False) -> MethodConfig:
    return MethodConfig(name="dsag", w=3, subpartitions=2, load_balance=load_balance)


def _build_fused_logreg_grid(device) -> EntryProbe:
    return _fused_probe("fused_logreg_grid", "device engine, logreg, grid §5 cache", device,
                        _probe_logreg(), _dsag())


def _build_fused_logreg_lb(device) -> EntryProbe:
    return _fused_probe("fused_logreg_lb", "device engine, logreg, §6 (tiled cache)", device,
                        _probe_logreg(), _dsag(True))


def _build_fused_logreg_tiled(device) -> EntryProbe:
    cfg = _dsag(True)
    prob = _probe_logreg()
    # the tightest budget that still holds the tiled cache's resident entries
    cap = fused.scan_capability(prob, cfg, _PROBE_WORKERS)
    return _fused_probe("fused_logreg_tiled", "device engine, logreg, §6, tightest slot budget",
                        device, prob, cfg, slot_budget=cap.slots_resident)


def _build_fused_logreg_churn(device) -> EntryProbe:
    return _fused_probe("fused_logreg_churn", "device engine, logreg, §6 under fleet churn",
                        device, _probe_logreg(), _dsag(True), traces=_probe_churn_traces())


def _build_fused_pca_grid(device) -> EntryProbe:
    return _fused_probe("fused_pca_grid", "device engine, PCA, grid §5 cache", device,
                        _probe_pca(), _dsag())


def _build_fused_logreg_grid_cuda(device) -> EntryProbe:
    return _fused_probe("fused_logreg_grid_cuda",
                        "device engine, logreg, grid §5 cache, CUDA kernels (K1, K3)", device,
                        _probe_logreg(), _dsag(), backend="cuda")


def _build_fused_pca_grid_cuda(device) -> EntryProbe:
    return _fused_probe("fused_pca_grid_cuda",
                        "device engine, PCA, grid §5 cache, CUDA kernels (K2, K3)", device,
                        _probe_pca(), _dsag(), backend="cuda")


# --------------------------------------------------------------------------
# the §3 latency chain (TL001)
# --------------------------------------------------------------------------


def _latency_chain(unit, cost, slowdown, factor, start, comm):
    # looked up through the modules, so that a regression test can
    # monkeypatch the chain and watch TL001 fire
    comp = latency_model.comp_latency_expr(unit, cost, slowdown, factor)
    return simulator.task_finish_time(start, comp, comm)


def _build_latency(device) -> EntryProbe:
    """TL001 probe: the §3 product feeding ``task_finish_time``, on four
    seeds × 64 draws in U(0.1, 3.0); the rule compares it with numpy's
    float64 evaluation, one rounding per operator, bit for bit."""
    batches = []
    for seed in (0, 1, 2, 3):
        rng = np.random.default_rng(seed)
        batches.append(tuple(rng.uniform(0.1, 3.0, size=64) for _ in range(6)))
    on_device = [tuple(torch.tensor(a, dtype=F64, device=device) for a in b) for b in batches]
    return EntryProbe(
        name="latency",
        description="§3 latency product -> task_finish_time (FMA seam)",
        device=device,
        run=lambda: _latency_chain(*on_device[0]),
        event_algebra=True,
        latency_probe=(_latency_chain, list(zip(batches, on_device))),
    )


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------


def _pad_invariance(name: str, fn, probe: EntryProbe) -> list:
    """``fn(pad)`` at the probe's pad width and the next rung: equal within
    float32 tolerance, and noted whether bit-equal."""
    a, b = fn(_PAD), fn(_NEXT_PAD)
    bits = torch.equal(a, b)
    probe.notes.append(f"{name}: pad {_PAD} vs {_NEXT_PAD} "
                       f"{'bit-equal' if bits else 'within tolerance, not bit-equal'}")
    scale = float(a.abs().max())
    if bits or torch.allclose(b, a, rtol=PAD_RTOL, atol=PAD_ATOL_REL * scale):
        return []
    return [(f"{name}:pad{_PAD}-vs-{_NEXT_PAD}",
             f"{name} differs between pad widths {_PAD} and {_NEXT_PAD} beyond float32 "
             f"tolerance: max |diff| {float((a - b).abs().max()):.3e} at max |value| {scale:.3e}")]


def _kernels_probe(problem, name: str, description: str, device) -> EntryProbe:
    kernels = problem.fused_kernels(device)
    backend = "torch" if device.type == "cpu" else "cuda"
    starts = torch.tensor(_STARTS, dtype=torch.int64, device=device)
    widths = torch.tensor(_WIDTHS, dtype=torch.int64, device=device)
    Vb = torch.zeros((3,) + kernels.value_shape, dtype=kernels.value_dtype, device=device)
    probe = EntryProbe(
        name=name,
        description=description,
        device=device,
        run=lambda: kernels.sub_blocks(Vb, starts, widths, backend, max_width=_PAD),
        padded_axis_sizes=(_PAD,),
        declared_output_dtypes=(kernels.value_dtype,),
    )
    if device.type != "cpu":
        rng = np.random.default_rng(5)
        Vr = torch.as_tensor(rng.normal(size=Vb.shape), dtype=Vb.dtype, device=device)
        kname = "logreg_block_sub" if len(kernels.value_shape) == 1 else "pca_block_sub"
        probe.card_checks.append(("TL003", lambda: _pad_invariance(
            kname, lambda pad: kernels.sub_blocks(Vr, starts, widths, "cuda", max_width=pad),
            probe)))
    return probe


def _build_kernels_logreg(device) -> EntryProbe:
    return _kernels_probe(_probe_logreg(), "kernels_logreg",
                          "FusedKernels.sub_blocks, logreg (K1 / its plain version)", device)


def _build_kernels_pca(device) -> EntryProbe:
    return _kernels_probe(_probe_pca(), "kernels_pca",
                          "FusedKernels.sub_blocks, PCA (K2 / its plain version)", device)


def _build_kernels_ops(device) -> EntryProbe:
    """K5 and K4 (float32 slots, and its int8 entry) through their wrappers:
    the kernels on the card, the plain versions on the CPU."""
    rng = np.random.default_rng(9)

    def f32(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32, device=device)

    x, v = f32(32, 8), f32(8, 4)
    g, c, h = f32(4, 64), f32(4, 64), f32(64)
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0], device=device)
    q8 = torch.zeros((4, 2, 8), dtype=torch.int8, device=device)
    s8 = torch.ones((4, 2), dtype=torch.bfloat16, device=device)
    code = torch.tensor([1, 5, 2, 3], dtype=torch.uint8, device=device)

    def run():
        gram = gram_matvec.gram_matvec(x, v)
        new_c, new_h = dsag_update.dsag_cache_update(g, c, h, mask)
        int8 = dsag_update.dsag_cache_update_int8(f32(4, 2, 8), q8, s8, q8, s8, f32(2, 8), code)
        return (gram, new_c, new_h) + tuple(int8)

    probe = EntryProbe(
        name="kernels_ops",
        description="kernel wrappers: gram_matvec (K5), dsag_cache_update (K4, K4-int8)",
        device=device,
        run=run,
        declared_output_dtypes=(torch.float32,) * 3 + (torch.int8, torch.bfloat16, torch.int8,
                                                        torch.bfloat16, torch.float32),
    )
    if device.type != "cpu":
        # K5 over the same 32 real rows padded with zero rows to 32 and 64
        probe.card_checks.append(("TL003", lambda: _pad_invariance(
            "gram_matvec", lambda pad: gram_matvec.gram_matvec(
                torch.cat([x, x.new_zeros(pad * 2 - 32, 8)]), v), probe)))
    return probe


def _build_lb_update(device) -> EntryProbe:
    S, N = _PROBE_SCENARIOS, _PROBE_WORKERS
    rng = np.random.default_rng(7)
    host = (
        np.full((S, N), 2.0),  # p_cur
        rng.uniform(1e-3, 5e-3, (S, N)),  # e_comm
        rng.uniform(1e-7, 1e-6, (S, N)),  # v_comm
        rng.uniform(1e-2, 5e-2, (S, N)),  # e_comp
        rng.uniform(1e-5, 1e-4, (S, N)),  # v_comp
        np.full((S, N), 16.0),  # n_j
        np.full((S,), np.nan),  # h_min
        np.ones((S,), bool),  # active
    )

    def update(dev, backend):
        args = tuple(torch.as_tensor(a, device=dev) for a in host)
        return jlb.lb_update(*args, ladder=(1, 2, 4, 8, 16), w=3, margin=0.02,
                             normals=what_if_normals(0, N, jlb.SIM_ITERATIONS, dev),
                             kernel_backend=backend)

    backend = "torch" if device.type == "cpu" else "cuda"
    probe = EntryProbe(name="lb_update",
                       description="§6 optimizer round (Algorithm 1 + publication gate)",
                       device=device, event_algebra=True)
    k7 = []

    def run():
        with recording(what_if, "what_if_replay") as calls:
            out = update(device, backend)
        k7.extend(calls)
        return out

    probe.run = run

    def match_cpu():
        mine, cpu = probe.trace.outputs, update(CPU, "torch")
        bad = [(f"output[{i}]", f"lb_update output {i} on {device} differs from the CPU run")
               for i, (a, b) in enumerate(zip(mine, cpu)) if not torch.equal(a.cpu(), b)]
        bad += _against_plain(k7, what_if.what_if_replay_plain, "what_if_replay")
        if not k7:
            bad.append(("what_if_replay:launches", "the round launched no K7"))
        if not bad:
            probe.notes.append(f"outputs equal to the CPU run's; {len(k7)} K7 calls equal to "
                               f"its plain version on the CPU")
        return bad

    if device.type != "cpu":
        probe.card_checks.append(("TL001", match_cpu))
    return probe


def _build_dsag_pjit(device) -> EntryProbe:
    """The live DSAG cache rule (``core/dsag_pjit.dsag_update``) through K4:
    ``TrainConfig()``'s bfloat16 slots and int8 slots."""
    gs = dsag_pjit.GroupSpec(num_groups=4, axes=())
    params = torch.zeros((8, 16), dtype=torch.float32, device=device)
    grads = torch.as_tensor(np.random.default_rng(3).normal(size=(4, 8, 16)),
                            dtype=torch.float32, device=device)
    mask = torch.tensor([True, False, True, True], device=device)
    flush = torch.zeros(4, dtype=torch.bool, device=device)

    def run():
        outs = []
        for tc in (TrainConfig(), TrainConfig(dsag_cache_dtype="int8")):
            state = dsag_pjit.init_dsag_state(params, gs, tc)
            new, _, _ = dsag_pjit.dsag_update(state, grads, mask, flush)
            for slot in (new["cache"], new["pending"]):
                outs += [slot.q, slot.scale] if tc.dsag_cache_dtype == "int8" else [slot]
            outs.append(new["h"])
        return tuple(outs)

    return EntryProbe(
        name="dsag_pjit",
        description="live-system DSAG cache rule (core/dsag_pjit.dsag_update), bf16 and int8",
        device=device,
        run=run,
        declared_output_dtypes=(torch.bfloat16, torch.bfloat16, torch.float32, torch.int8,
                                torch.bfloat16, torch.int8, torch.bfloat16, torch.float32),
    )


#: name -> builder (device -> probe).  Names are stable API (baselines key
#: on them); keep additions append-only.
ENTRIES: dict[str, Callable[[torch.device], EntryProbe]] = {
    "latency": _build_latency,
    "fused_logreg_grid": _build_fused_logreg_grid,
    "fused_logreg_lb": _build_fused_logreg_lb,
    "fused_logreg_tiled": _build_fused_logreg_tiled,
    "fused_logreg_churn": _build_fused_logreg_churn,
    "fused_pca_grid": _build_fused_pca_grid,
    "fused_logreg_grid_cuda": _build_fused_logreg_grid_cuda,
    "fused_pca_grid_cuda": _build_fused_pca_grid_cuda,
    "kernels_logreg": _build_kernels_logreg,
    "kernels_pca": _build_kernels_pca,
    "lb_update": _build_lb_update,
    "kernels_ops": _build_kernels_ops,
    "dsag_pjit": _build_dsag_pjit,
}
#: entries that only the card runs (the CUDA kernels)
CARD_ONLY = frozenset({"fused_logreg_grid_cuda", "fused_pca_grid_cuda"})


def entry_names(names, device) -> list[str]:
    """The registry keys ``names`` stands for ('all' or an iterable): with
    'all', the card-only entries only on a card."""
    device = torch.device(device)
    if names == "all" or list(names) == ["all"]:
        return [n for n in ENTRIES if device.type != "cpu" or n not in CARD_ONLY]
    names = list(names)
    unknown = [n for n in names if n not in ENTRIES]
    if unknown:
        raise KeyError(f"unknown lint entries {unknown}; known: {sorted(ENTRIES)}")
    if device.type == "cpu" and CARD_ONLY & set(names):
        raise ValueError(f"entries {sorted(CARD_ONLY & set(names))} run on the card only")
    return names


def build_entries(names, device="cuda") -> list:
    """Build the named probes ('all' or an iterable of registry keys) on ``device``."""
    device = torch.device(device)
    return [ENTRIES[n](device) for n in entry_names(names, device)]
