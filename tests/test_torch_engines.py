"""The port's scalar simulator, host engine and gradient cache, held against
the JAX reference and against the port's device engine, on the CPU.

The reference runs in ONE subprocess for this module (``_REF_SCRIPT``), under
the same jax-0.9 shim as ``tests/test_torch_parity.py``; it builds every input
from numpy seeds and writes inputs and outputs to an ``.npz``.  This process
never imports ``jax`` or ``repro``.

Tolerances, and why:

* the §5 gradient caches (``GradientCache``, ``BatchedGradientCache``) are
  numpy float64 adds in the reference's order: sums, coverage, accepts,
  rejects and evictions are compared for exact equality;
* the scalar ``TrainingSimulator`` against the reference's: times, fresh
  counts, per-worker latencies, cache telemetry and the mask, flush and
  evict streams do not depend on the iterate and are exact; suboptimality
  within ``rtol=1e-4`` (+``atol=1e-6`` for PCA), as in
  ``tests/test_torch_parity.py`` (float32 sums in another order);
* the §7.2 timed-event run samples latencies live from the cluster's numpy
  generator: times and streams exact;
* the ``LatencyProfiler`` windows are numpy means and variances over the
  same samples: exact;
* within the port, the scalar simulator, the host engine and the device
  engine agree bit for bit on everything, suboptimality included
  (``np.array_equal``): each task's subgradient is padded to the run's
  ``task_pad_width``, iterates are projected and evaluated one at a time.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convergence_sweep, interop
from repro_torch.cluster.simulator import (
    MethodConfig,
    ModelLatencySource,
    TraceLatencySource,
    TrainingSimulator,
    task_pad_width,
)
from repro_torch.core.gradient_cache import BatchedGradientCache, GradientCache, scenario_ranks
from repro_torch.core.problems import make_genomics_like_matrix, make_higgs_like
from repro_torch.experiments.convergence import (
    ConvergenceSweepOutcome,
    history_mismatches,
    result_mismatches,
    run_convergence_batch,
    scalar_convergence_run,
    scalar_convergence_seconds,
)
from repro_torch.experiments.engine import EngineConfig
from repro_torch.ft.validation import pin_streams
from repro_torch.latency.model import (
    ChurnSchedule,
    clear_slowdowns,
    make_heterogeneous_cluster,
    make_paper_artificial_cluster,
)
from repro_torch.latency.profiler import LatencyProfiler, LatencySample
from repro_torch.lb.partitioner import Subpartitioner, build_p_ladder, ladder_intervals

REPO = Path(__file__).resolve().parents[1]
CPU = EngineConfig(device="cpu", kernel_backend="torch")

#: the slice at a small size, as in tests/test_torch_parity.py
N_ROWS, N_WORKERS, N_SCEN, N_ITERS, SUBPARTS, W = 1024, 8, 3, 16, 4, 6
PCA_COLS, PCA_K = 16, 3
KINDS = ("logreg", "pca")
METHODS = ("dsag", "dsag_nomargin", "sag", "sgd", "gd", "coded")
SUBOPT_TOL = {"logreg": (1e-4, 0.0), "pca": (1e-4, 1e-6)}  # (rtol, atol)
#: the live pin: 8 groups, 60 steps, (method, margin)
PIN_CASES = (("dsag", 0.02), ("dsag", 0.0), ("sag", 0.0))
PIN_STEPS = 60
#: random cache walks: (scalar inserts over n samples), (S scenarios, events)
CACHE_N, CACHE_INSERTS, CACHE_S, CACHE_EVENTS = 60, 300, 3, 240
#: the §7.2 timed-event run: workers, iterations, removal time
ART_N, ART_T, ART_REMOVE_AT = 8, 30, 0.02


def _method_configs(kind: str) -> dict[str, dict]:
    eta = 0.25 if kind == "logreg" else 0.9
    return {
        "dsag": dict(name="dsag", w=W, eta=eta, subpartitions=SUBPARTS),
        "dsag_nomargin": dict(name="dsag", w=W, eta=eta, subpartitions=SUBPARTS, margin=0.0),
        "sag": dict(name="sag", w=N_WORKERS, eta=eta, subpartitions=SUBPARTS),
        "sgd": dict(name="sgd", w=W, eta=eta, subpartitions=SUBPARTS),
        "gd": dict(name="gd", eta=eta, subpartitions=SUBPARTS),
        "coded": dict(name="coded", eta=1.0, subpartitions=SUBPARTS),
    }


_REF_SCRIPT = r"""
import sys
import jax, jax.experimental
jax.experimental.enable_x64 = jax.enable_x64
from jax.experimental import pallas as pl
pl.load = lambda ref, idx: ref[idx]
def _store(ref, idx, val):
    ref[idx] = val
pl.store = _store

import numpy as np
from repro.cluster.simulator import MethodConfig, TraceLatencySource, TrainingSimulator
from repro.core.gradient_cache import BatchedGradientCache, GradientCache
from repro.core.problems import (
    LogisticRegressionProblem, PCAProblem, make_genomics_like_matrix, make_higgs_like,
)
from repro.experiments.grid import HEAVY_BURSTS
from repro.latency.model import (
    clear_slowdowns, make_heterogeneous_cluster, make_paper_artificial_cluster, sample_fleet,
)
from repro.latency.profiler import LatencyProfiler, LatencySample

P = {params}
out = {{}}
rng = np.random.default_rng(21)

# -- the scalar gradient cache under random overlapping inserts ----------------
n = P["cache_n"]
starts = rng.integers(1, n + 1, size=P["cache_inserts"])
stops = np.minimum(starts + rng.integers(0, 12, size=starts.size), n)
iters = rng.integers(0, 40, size=starts.size)
vals = rng.normal(size=(starts.size, 3))
clears = rng.random(starts.size) < 0.05
c = GradientCache(n, np.zeros(3))
acc, sums, cov = [], [], []
for j in range(starts.size):
    if clears[j]:
        acc.append(-1 - c.clear_range(int(starts[j]), int(stops[j])))
    else:
        acc.append(int(c.insert(int(starts[j]), int(stops[j]), int(iters[j]), vals[j])))
    sums.append(c.sum.copy())
    cov.append(c.coverage)
out["cache/in"] = np.stack([starts, stops, iters, clears.astype(np.int64)], axis=1)
out["cache/vals"] = vals
out["cache/accepted"] = np.array(acc)
out["cache/sums"] = np.array(sums)
out["cache/coverage"] = np.array(cov)
out["cache/telemetry"] = np.array([c.evictions, c.rejected_stale, c.num_entries])

# -- the batched cache: the grid's exact-match events, then overlapping ones ----
S, K = P["cache_s"], P["cache_events"]
ev_s = rng.integers(0, S, size=K)
grid = [(1 + 10 * i, 10 * (i + 1)) for i in range(6)]
pick = rng.integers(0, len(grid), size=K)
ev_lo = np.array([grid[p][0] for p in pick])
ev_hi = np.array([grid[p][1] for p in pick])
ev_it = rng.integers(0, 30, size=K)
ev_v = rng.normal(size=(K, 2)).astype(np.float32)
b = BatchedGradientCache(S, n, np.zeros(2))
out["bcache/accepted_events"] = b.insert_events(ev_s, ev_lo, ev_hi, ev_it, ev_v)
out["bcache/events"] = np.stack([ev_s, ev_lo, ev_hi, ev_it], axis=1)
out["bcache/vals"] = ev_v
ov_s = rng.integers(0, S, size=40)
ov_lo = rng.integers(1, n - 8, size=40)
ov_hi = ov_lo + rng.integers(0, 8, size=40)
ov_it = rng.integers(0, 40, size=40)
ov_v = rng.normal(size=(40, 2))
out["bcache/overlap"] = np.stack([ov_s, ov_lo, ov_hi, ov_it], axis=1)
out["bcache/overlap_vals"] = ov_v
out["bcache/accepted_overlap"] = np.array(
    [b.insert(int(ov_s[j]), int(ov_lo[j]), int(ov_hi[j]), int(ov_it[j]), ov_v[j]) for j in range(40)])
out["bcache/cleared"] = np.array([b.clear_range(s, 15, 32) for s in range(S)])
out["bcache/sums"] = b.sums.copy()
out["bcache/coverage"] = b.coverage.copy()
out["bcache/evictions"] = b.evictions.copy()
out["bcache/rejected"] = b.rejected_stale.copy()

# -- the profiler's moving windows ---------------------------------------------
prof = LatencyProfiler(4, window=0.5)
t_rec = np.sort(rng.random(200) * 3.0)
smp = np.stack([rng.integers(0, 4, size=200), t_rec, rng.random(200) * 0.01,
                rng.random(200) * 0.008, 1.0 + rng.integers(0, 3, size=200)], axis=1)
out["prof/samples"] = smp
stats = []
for i, row in enumerate(smp):
    prof.record(LatencySample(int(row[0]), row[1], row[2], row[3], row[4]))
    if i % 20 == 19:
        for wk in range(4):
            st = prof.stats(wk, row[1])
            stats.append([np.nan] * 6 if st is None else
                         [st.e_comm, st.v_comm, st.e_comp, st.v_comp, st.mean_load, st.num_samples])
out["prof/stats"] = np.array(stats)

# -- the scalar TrainingSimulator on the slice -----------------------------------
for kind in ("logreg", "pca"):
    if kind == "logreg":
        X, y = make_higgs_like(P["n"], seed=0)
        prob = LogisticRegressionProblem(X=X, y=y)
    else:
        prob = PCAProblem(X=make_genomics_like_matrix(P["n"], P["cols"], seed=0), k=P["k"])
    N, sp = P["N"], P["sp"]
    c_task = prob.compute_cost(1, max(P["n"] // (N * sp), 1))
    cluster = make_heterogeneous_cluster(N, seed=0, burst_rate=0.0, load_unit=c_task)
    tr = sample_fleet(cluster, P["S"], P["T"], burst_rate=HEAVY_BURSTS.rate,
                      burst_factor_mean=HEAVY_BURSTS.factor_mean,
                      burst_duration_mean=HEAVY_BURSTS.duration_mean, seed=1)
    for name, cfg in P["methods"][kind].items():
        for s in range(P["S"]):
            sim = TrainingSimulator(prob, cluster, MethodConfig(**cfg),
                                    latency_source=TraceLatencySource(tr, s))
            h = sim.run(P["T"])
            pre = f"sim/{{kind}}/{{name}}/{{s}}/"
            for f in ("times", "suboptimality", "fresh_counts", "per_worker_latency",
                      "mask_stream", "flush_stream", "evict_stream"):
                out[pre + f] = getattr(h, f)
            out[pre + "telemetry"] = np.array([h.evictions, h.rejected_stale])

# -- the §7.2 artificial scenario with a timed slowdown removal (live sampling) --
X, y = make_higgs_like(P["n"], seed=0)
prob = LogisticRegressionProblem(X=X, y=y)
N, T, at = P["art"]
cluster = make_paper_artificial_cluster(N, load_unit=prob.compute_cost(1, P["n"] // (N * 2)), seed=2)
ev = [(at, lambda cl: clear_slowdowns(cl, range(N - 3, N)))]
sim = TrainingSimulator(prob, cluster, MethodConfig(name="dsag", w=N - 2, eta=0.25, subpartitions=2),
                        timed_events=ev)
h = sim.run(T)
for f in ("times", "fresh_counts", "per_worker_latency", "mask_stream", "flush_stream"):
    out[f"art/{{f}}"] = getattr(h, f)
out["art/suboptimality"] = h.suboptimality
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every reference output of this module, from one JAX subprocess."""
    params = dict(
        n=N_ROWS, N=N_WORKERS, S=N_SCEN, T=N_ITERS, sp=SUBPARTS, cols=PCA_COLS, k=PCA_K,
        methods={kind: _method_configs(kind) for kind in KINDS},
        cache_n=CACHE_N, cache_inserts=CACHE_INSERTS, cache_s=CACHE_S,
        cache_events=CACHE_EVENTS, art=(ART_N, ART_T, ART_REMOVE_AT),
    )
    path = tmp_path_factory.mktemp("jax_reference") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _REF_SCRIPT.format(params=repr(params)), str(path)],
        env=env, capture_output=True, text=True, timeout=900,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"reference subprocess failed:\n{proc.stderr[-4000:]}")
    with np.load(path) as z:
        return dict(z)


# -- the §5 gradient caches: exact --------------------------------------------------


def test_gradient_cache_matches_reference(ref):
    inp, vals = ref["cache/in"], ref["cache/vals"]
    c = GradientCache(CACHE_N, np.zeros(3))
    acc, sums, cov = [], [], []
    for (start, stop, it, clear), v in zip(inp, vals):
        if clear:
            acc.append(-1 - c.clear_range(int(start), int(stop)))
        else:
            acc.append(int(c.insert(int(start), int(stop), int(it), v)))
        c.check_invariants()
        sums.append(c.sum.copy())
        cov.append(c.coverage)
    assert np.array_equal(acc, ref["cache/accepted"])
    assert np.array_equal(np.array(sums), ref["cache/sums"])
    assert np.array_equal(cov, ref["cache/coverage"])
    assert [c.evictions, c.rejected_stale, c.num_entries] == list(ref["cache/telemetry"])
    # the walk exercised every branch: accepts, rejects, evictions, clears
    assert c.evictions > 0 and c.rejected_stale > 0 and (ref["cache/accepted"] < -1).any()


def test_batched_gradient_cache_matches_reference(ref):
    ev, ev_v = ref["bcache/events"], ref["bcache/vals"]
    b = BatchedGradientCache(CACHE_S, CACHE_N, np.zeros(2))
    acc = b.insert_events(ev[:, 0], ev[:, 1], ev[:, 2], ev[:, 3], ev_v)
    assert np.array_equal(acc, ref["bcache/accepted_events"])
    ov, ov_v = ref["bcache/overlap"], ref["bcache/overlap_vals"]
    acc_ov = [b.insert(int(s), int(lo), int(hi), int(it), v)
              for (s, lo, hi, it), v in zip(ov, ov_v)]
    assert np.array_equal(acc_ov, ref["bcache/accepted_overlap"])
    cleared = [b.clear_range(s, 15, 32) for s in range(CACHE_S)]
    assert np.array_equal(cleared, ref["bcache/cleared"])
    b.check_invariants()
    for name, got in (("sums", b.sums), ("coverage", b.coverage),
                      ("evictions", b.evictions), ("rejected", b.rejected_stale)):
        assert np.array_equal(got, ref[f"bcache/{name}"]), name
    assert b.evictions.sum() > 0 and b.rejected_stale.sum() > 0


def test_batched_cache_equals_scalar_caches_per_scenario(ref):
    """insert_events's rank-grouped scatters give each scenario the bits of a
    scalar cache fed its events in order."""
    ev, ev_v = ref["bcache/events"], ref["bcache/vals"]
    b = BatchedGradientCache(CACHE_S, CACHE_N, np.zeros(2))
    b.insert_events(ev[:, 0], ev[:, 1], ev[:, 2], ev[:, 3], ev_v)
    for s in range(CACHE_S):
        c = GradientCache(CACHE_N, np.zeros(2))
        for (es, lo, hi, it), v in zip(ev, ev_v):
            if es == s:
                c.insert(int(lo), int(hi), int(it), v)
        assert np.array_equal(c.sum, b.sums[s])
        assert c.coverage == b.coverage[s] and c.rejected_stale == b.rejected_stale[s]


def test_scenario_ranks():
    assert scenario_ranks(np.array([0, 1, 0, 1, 1])).tolist() == [0, 0, 1, 1, 2]


# -- partition bookkeeping and the profiler -------------------------------------------


def test_subpartitioner_and_ladder():
    sub = Subpartitioner(base_start=11, base_stop=20, p=3)
    assert [sub.next_interval_and_advance() for _ in range(4)] == [
        (11, 13), (14, 16), (17, 20), (11, 13)]
    # Algorithm 2: 3 -> 5 with sample 14 next walks down to a shared boundary
    sub.repartition(5)
    assert (sub.p, sub.k, sub.current_interval()) == (5, 1, (11, 12))
    assert build_p_ladder(10, 1000) == (2, 3, 4, 5, 7, 10, 14, 18, 25, 33, 40)
    assert build_p_ladder(10, 4) == (2, 3, 4)
    assert ladder_intervals(1, 10, (2, 3)) == [(1, 3), (1, 5), (4, 6), (6, 10), (7, 10)]


def test_latency_profiler_windows_match_reference(ref):
    smp = ref["prof/samples"]
    prof = LatencyProfiler(4, window=0.5)
    stats = []
    for i, row in enumerate(smp):
        prof.record(LatencySample(int(row[0]), row[1], row[2], row[3], row[4]))
        if i % 20 == 19:
            for wk in range(4):
                st = prof.stats(wk, row[1])
                stats.append([np.nan] * 6 if st is None else [
                    st.e_comm, st.v_comm, st.e_comp, st.v_comp, st.mean_load, st.num_samples])
    assert np.array_equal(np.array(stats), ref["prof/stats"], equal_nan=True)


def test_latency_profiler_batch_feed_and_gate():
    prof = LatencyProfiler(2, window=1.0)
    assert prof.moment_arrays(0.0) is None
    prof.record_batch(np.array([0, 1, 0]), np.array([0.1, 0.2, 0.3]),
                      np.array([0.05, 0.04, np.nan]), np.array([0.01, 0.02, 0.03]), 2.0)
    m = prof.moment_arrays(0.5)
    assert m is not None and m.num_samples.tolist() == [1, 1]  # the NaN row is dropped
    assert m.e_comm.tolist() == [0.05 - 0.01, 0.04 - 0.02]
    assert prof.moment_arrays(1.25) is None  # worker 0's sample left the window


# -- the scalar simulator against the reference's ------------------------------------


def _problem(kind: str):
    if kind == "logreg":
        X, y = make_higgs_like(N_ROWS, seed=0)
        return interop.problem_from_arrays("logreg", X, y)
    X = make_genomics_like_matrix(N_ROWS, PCA_COLS, seed=0)
    return interop.problem_from_arrays("pca", X, k=PCA_K)


@pytest.fixture(scope="module")
def slices():
    """(problem, cluster, traces) of each kind: the reference's recipe."""
    from repro_torch.experiments.grid import HEAVY_BURSTS
    from repro_torch.latency.model import sample_fleet

    out = {}
    for kind in KINDS:
        prob = _problem(kind)
        c_task = prob.compute_cost(1, max(N_ROWS // (N_WORKERS * SUBPARTS), 1))
        cluster = make_heterogeneous_cluster(N_WORKERS, seed=0, burst_rate=0.0, load_unit=c_task)
        tr = sample_fleet(cluster, N_SCEN, N_ITERS, burst_rate=HEAVY_BURSTS.rate,
                          burst_factor_mean=HEAVY_BURSTS.factor_mean,
                          burst_duration_mean=HEAVY_BURSTS.duration_mean, seed=1)
        out[kind] = (prob, cluster, tr)
    return out


@pytest.fixture(scope="module")
def port_runs(slices):
    """The port's three engines on every (kind, method): scalar histories per
    scenario, and the host and device engines' batched results."""
    runs = {}
    for kind in KINDS:
        prob, cluster, tr = slices[kind]
        for name, cfg in _method_configs(kind).items():
            mc = MethodConfig(**cfg)
            scalar = [
                TrainingSimulator(prob, cluster, mc, engine=CPU,
                                  latency_source=TraceLatencySource(tr, s)).run(N_ITERS)
                for s in range(N_SCEN)
            ]
            batched = {
                kd: run_convergence_batch(prob, tr, mc, N_ITERS,
                                          engine=dataclasses.replace(CPU, kind=kd))
                for kd in ("scan", "host")
            }
            runs[kind, name] = (scalar, batched)
    return runs


CASES = [(k, m) for k in KINDS for m in METHODS]


@pytest.mark.parametrize(("kind", "method"), CASES)
def test_scalar_simulator_streams_match_reference(ref, port_runs, kind, method):
    scalar, _ = port_runs[kind, method]
    for s, h in enumerate(scalar):
        pre = f"sim/{kind}/{method}/{s}/"
        for f in ("times", "fresh_counts", "per_worker_latency", "mask_stream",
                  "flush_stream", "evict_stream"):
            assert np.array_equal(getattr(h, f), ref[pre + f], equal_nan=True), (s, f)
        assert [h.evictions, h.rejected_stale] == list(ref[pre + "telemetry"])


@pytest.mark.parametrize(("kind", "method"), CASES)
def test_scalar_simulator_suboptimality_within_tolerance(ref, port_runs, kind, method):
    scalar, _ = port_runs[kind, method]
    rtol, atol = SUBOPT_TOL[kind]
    for s, h in enumerate(scalar):
        want = ref[f"sim/{kind}/{method}/{s}/suboptimality"]
        assert np.all(np.isfinite(h.suboptimality))
        np.testing.assert_allclose(h.suboptimality, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize(("kind", "method"), CASES)
def test_scalar_host_device_bit_exact(port_runs, kind, method):
    scalar, batched = port_runs[kind, method]
    for s, h in enumerate(scalar):
        for engine, res in batched.items():
            assert history_mismatches(h, res, s) == [], (engine, s)
    host, scan = batched["host"], batched["scan"]
    assert np.array_equal(host.suboptimality, scan.suboptimality)
    assert np.all(np.isfinite(scan.suboptimality))


def test_timed_events_match_reference(ref):
    """The §7.2 artificial cluster with a timed slowdown removal, latencies
    sampled live from the cluster's generator, as in the reference."""
    prob = _problem("logreg")
    cluster = make_paper_artificial_cluster(
        ART_N, load_unit=prob.compute_cost(1, N_ROWS // (ART_N * 2)), seed=2)
    ev = [(ART_REMOVE_AT, lambda cl: clear_slowdowns(cl, range(ART_N - 3, ART_N)))]
    sim = TrainingSimulator(prob, cluster, MethodConfig(name="dsag", w=ART_N - 2, eta=0.25,
                                                        subpartitions=2),
                            timed_events=ev, engine=CPU)
    assert isinstance(sim.latency_source, ModelLatencySource)
    h = sim.run(ART_T)
    for f in ("times", "fresh_counts", "per_worker_latency", "mask_stream", "flush_stream"):
        assert np.array_equal(getattr(h, f), ref[f"art/{f}"], equal_nan=True), f
    np.testing.assert_allclose(h.suboptimality, ref["art/suboptimality"], rtol=1e-4)
    assert [w.slowdown for w in cluster.workers[-3:]] == [1.0] * 3  # the event fired
    assert ART_REMOVE_AT < h.times[-1]


def test_timed_events_refused_on_replayed_traces(slices):
    prob, cluster, tr = slices["logreg"]
    with pytest.raises(ValueError, match="live model sampling"):
        TrainingSimulator(prob, cluster, MethodConfig(name="dsag", w=W), engine=CPU,
                          latency_source=TraceLatencySource(tr, 0),
                          timed_events=[(0.1, lambda cl: None)])


# -- the pad width: a task's value must not depend on its batch ------------------------


def test_task_pad_width_matches_the_partition():
    cfg = MethodConfig(name="dsag", w=W, subpartitions=4)
    # 1000 rows over 8 workers: 125 each, subpartitions of 31 and 32 rows
    assert task_pad_width(cfg, 1000, 8) == 32
    assert task_pad_width(MethodConfig(name="gd"), 1000, 7) == 143  # full blocks
    assert task_pad_width(MethodConfig(name="sgd", subpartitions=500), 10, 2) == 1


@pytest.mark.parametrize("kind", KINDS)
def test_single_task_equals_its_row_in_a_full_batch(kind):
    """G = 1 (the scalar simulator) against G = S*N (the device engine) at the
    run's shared pad width: equal bit for bit.  At a task's own, narrower width
    some logreg values differ (the plain version's sum over the gathered rows
    groups them differently; on the card K1's slabs and warps follow the pad),
    which is why every engine passes the same pad."""
    from repro_torch.lb.partitioner import p_start, p_stop

    n, N, S, p = 1000, 8, 3, 4
    if kind == "logreg":
        X, y = make_higgs_like(n, seed=5)
        prob = interop.problem_from_arrays("logreg", X, y)
    else:
        prob = interop.problem_from_arrays(
            "pca", make_genomics_like_matrix(n, PCA_COLS, seed=5), k=PCA_K)
    rng = np.random.default_rng(3)
    base = np.array([p_start(n, N, i + 1) for i in range(N)])
    n_loc = np.array([p_stop(n, N, i + 1) for i in range(N)]) - base + 1
    k = rng.integers(1, p + 1, size=(S, N))
    lo = (base[None] + (k - 1) * n_loc[None] // p).reshape(-1)
    hi = (base[None] + k * n_loc[None] // p - 1).reshape(-1)
    shape = (S * N,) + prob.init(0).shape
    V = rng.normal(size=shape).astype(np.float32) * 0.1
    pad = task_pad_width(MethodConfig(name="dsag", subpartitions=p), n, N)
    batch = prob.subgradient_blocks_masked(V, lo, hi, pad_width=pad, engine=CPU)
    alone = np.stack([prob.subgradient(V[g], lo[g], hi[g], pad_width=pad, engine=CPU)
                      for g in range(S * N)])
    assert np.array_equal(alone, batch)
    own = np.stack([prob.subgradient(V[g], lo[g], hi[g], engine=CPU) for g in range(S * N)])
    narrow = (hi - lo + 1) < pad
    assert narrow.any()
    if kind == "logreg":
        assert not np.array_equal(own[narrow], batch[narrow])
    np.testing.assert_allclose(own, batch, rtol=1e-5, atol=1e-6 * np.abs(batch).max())


def test_iterate_batch_rows_equal_single_iterates(slices):
    for kind in KINDS:
        prob = slices[kind][0]
        rng = np.random.default_rng(9)
        V = rng.normal(size=(5,) + prob.init(0).shape).astype(np.float32)
        sub = prob.suboptimality_batch(V, engine=CPU)
        proj = prob.project_batch(V, engine=CPU)
        for s in range(5):
            assert sub[s] == prob.suboptimality(V[s], engine=CPU)
            assert np.array_equal(proj[s], prob.project(V[s], engine=CPU))


# -- capability refusals: up front, by every engine ------------------------------------


def _death_and_rejoin(tr, t_die: float, t_back: float):
    """Worker 1 dies at ``t_die`` and rejoins at ``t_back``; worker 3 dies
    at ``t_back`` for good."""
    n = tr.num_workers
    alive = np.ones((3, n), bool)
    alive[1, 1] = False
    alive[2, 3] = False
    return tr.with_churn(ChurnSchedule(times=np.array([t_die, t_back]),
                                       slowdown=np.tile(tr.slowdown, (3, 1)), alive=alive))


def test_load_balance_refused_by_every_engine(slices):
    """§6 under churn, once refused by every engine, runs on every engine and
    the scalar simulator, all equal bit for bit; the live pin still refuses
    §6, as the reference's ``pin_streams`` does."""
    prob, cluster, tr = slices["logreg"]
    cfg = MethodConfig(name="dsag", w=W, subpartitions=SUBPARTS, load_balance=True,
                       lb_startup_delay=0.002, lb_interval=0.004)
    base = run_convergence_batch(prob, tr, cfg, N_ITERS, engine=CPU)
    tch = _death_and_rejoin(tr, float(base.times[0, 2]), float(base.times[0, 8]))
    res = {kind: run_convergence_batch(prob, tch, cfg, N_ITERS,
                                       engine=dataclasses.replace(CPU, kind=kind))
           for kind in ("auto", "scan", "host")}
    h = TrainingSimulator(prob, cluster, cfg, engine=CPU,
                          latency_source=TraceLatencySource(tch, 0)).run(N_ITERS)
    for kind, r in res.items():
        assert history_mismatches(h, r, 0) == [], kind
        assert result_mismatches(r, res["scan"]) == [], kind
    assert h.evict_stream.any()  # the deaths cleared cache entries
    with pytest.raises(ValueError, match="no LB"):
        pin_streams(prob, cluster, tr, 0, dataclasses.replace(cfg, subpartitions=1), N_ITERS,
                    engine=CPU)


def test_load_balance_runs_on_every_engine(slices):
    """§6 load balancing runs on every engine, and all agree bit for bit
    (``tests/test_torch_lb.py`` holds §6 against the reference)."""
    prob, cluster, tr = slices["logreg"]
    cfg = MethodConfig(name="dsag", w=W, subpartitions=SUBPARTS, load_balance=True,
                       lb_startup_delay=0.002, lb_interval=0.004)
    res = {kind: run_convergence_batch(prob, tr, cfg, N_ITERS,
                                       engine=dataclasses.replace(CPU, kind=kind))
           for kind in ("auto", "scan", "host")}
    h = TrainingSimulator(prob, cluster, cfg, engine=CPU,
                          latency_source=TraceLatencySource(tr, 0)).run(N_ITERS)
    for kind, r in res.items():
        assert history_mismatches(h, r, 0) == [], kind
        assert r.repartition_events == res["scan"].repartition_events
    assert sum(len(e) for e in res["scan"].repartition_events) > 0


def test_churn_refused_by_every_engine(slices):
    """Churn, once refused by every engine, runs on every engine and the
    scalar simulator, all equal bit for bit (``tests/test_torch_churn.py``
    holds it against the reference)."""
    prob, cluster, tr = slices["logreg"]
    cfg = MethodConfig(name="dsag", w=W, subpartitions=SUBPARTS)
    base = run_convergence_batch(prob, tr, cfg, N_ITERS, engine=CPU)
    tch = _death_and_rejoin(tr, float(base.times[0, 2]), float(base.times[0, 8]))
    res = {kind: run_convergence_batch(prob, tch, cfg, N_ITERS,
                                       engine=dataclasses.replace(CPU, kind=kind))
           for kind in ("auto", "scan", "host")}
    for s in range(tch.num_scenarios):
        h = TrainingSimulator(prob, cluster, cfg, engine=CPU,
                              latency_source=TraceLatencySource(tch, s)).run(N_ITERS)
        for kind, r in res.items():
            assert history_mismatches(h, r, s) == [], (kind, s)
    assert not np.array_equal(res["scan"].times, base.times)  # the churn bit


def test_engine_config_kind_and_cadence():
    assert EngineConfig().kind == "auto" and EngineConfig().eval_every == 1
    with pytest.raises(ValueError, match="engine kind"):
        EngineConfig(kind="fused")
    with pytest.raises(ValueError, match="eval_every"):
        EngineConfig(eval_every=0)


def test_eval_cadence_from_the_engine_config(slices):
    prob, _, tr = slices["logreg"]
    cfg = MethodConfig(name="sag", w=N_WORKERS, subpartitions=SUBPARTS)
    for kind in ("scan", "host"):
        res = run_convergence_batch(prob, tr, cfg, N_ITERS,
                                    engine=dataclasses.replace(CPU, kind=kind, eval_every=5))
        assert np.array_equal(np.flatnonzero(np.isfinite(res.suboptimality[0])), [0, 5, 10, 15])


# -- the live pin, within the port -----------------------------------------------------


@pytest.mark.parametrize("scenario", [0, 1])
@pytest.mark.parametrize(("name", "margin"), PIN_CASES)
def test_pin_streams_controller_equals_simulator(name, margin, scenario):
    from repro_torch.latency.model import sample_fleet

    X, y = make_higgs_like(512, seed=0)
    prob = interop.problem_from_arrays("logreg", X, y)
    cluster = make_heterogeneous_cluster(8, seed=3, burst_rate=0.0,
                                         load_unit=prob.compute_cost(1, 512 // 8))
    traces = sample_fleet(cluster, 2, 4 * PIN_STEPS, seed=7, burst_rate=0.05,
                          burst_factor_mean=4.0, burst_duration_mean=0.05)
    cfg = MethodConfig(name=name, w=6, eta=0.25, margin=margin, subpartitions=1)
    ctrl, sim, hist = pin_streams(prob, cluster, traces, scenario, cfg, PIN_STEPS, engine=CPU)
    assert ctrl == sim, ctrl.mismatch_summary(sim)
    assert np.array_equal(ctrl.times, sim.times)
    assert np.array_equal(sim.times, hist.times)
    assert not sim.mask.all()  # stragglers miss deadlines: the pin is not vacuous
    if name == "dsag":
        assert sim.flush.any()


def test_pin_streams_refuses_outside_the_live_regime():
    prob = _problem("logreg")
    with pytest.raises(ValueError, match="subpartitions=1"):
        pin_streams(prob, None, None, 0, MethodConfig(name="dsag", subpartitions=4), 4)
    with pytest.raises(ValueError, match="cache methods"):
        pin_streams(prob, None, None, 0, MethodConfig(name="sgd"), 4)


# -- the drivers -------------------------------------------------------------------------


def test_scalar_convergence_helpers_and_history(slices, port_runs):
    prob, cluster, tr = slices["logreg"]
    methods = {m: MethodConfig(**c) for m, c in _method_configs("logreg").items()
               if m in ("dsag", "sag")}
    results = {m: port_runs["logreg", m][1]["scan"] for m in methods}
    out = ConvergenceSweepOutcome(
        results=results, methods=methods, traces=tr, problem=prob, cluster=cluster,
        num_iterations=N_ITERS, cost_scale=1.0, eval_every=1, seed=0, engine_seconds=0.0)
    h = scalar_convergence_run(out, "dsag", 1, engine=CPU)
    assert history_mismatches(h, results["dsag"], 1) == []
    assert results["dsag"].history(1).time_to_gap(0.2) == h.time_to_gap(0.2)
    measured, scaled = scalar_convergence_seconds(out, max_scenarios=1, engine=CPU)
    assert 0.0 < measured and scaled == pytest.approx(measured * N_SCEN)


@pytest.mark.parametrize("engine", ["host", "scan"])
def test_convergence_cli_check_scalar(engine, capsys):
    o = convergence_sweep.main([
        "--device", "cpu", "--kernel-backend", "torch", "--engine", engine,
        "--check-scalar", "--workers", "8", "--scenarios", "2", "--iters", "10",
        "--samples", "1024"])
    printed = capsys.readouterr().out
    assert "scalar TrainingSimulator replay of scenario 0: bit-exact for 4 methods" in printed
    assert f"({engine} engine" in printed
    assert "median_time_to_gap_dsag" in o


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
def test_gpu_scalar_host_device_bit_exact_through_the_kernels(slices, kind):
    """On the card the three engines call K1/K2 and still agree bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = EngineConfig(device="cuda", kernel_backend="cuda")
    prob, cluster, tr = slices[kind]
    for name in ("dsag", "sgd"):
        mc = MethodConfig(**_method_configs(kind)[name])
        scalar = TrainingSimulator(prob, cluster, mc, engine=card,
                                   latency_source=TraceLatencySource(tr, 0)).run(N_ITERS)
        for kd in ("scan", "host"):
            res = run_convergence_batch(prob, tr, mc, N_ITERS,
                                        engine=dataclasses.replace(card, kind=kd))
            assert history_mismatches(scalar, res, 0) == [], (name, kd)
