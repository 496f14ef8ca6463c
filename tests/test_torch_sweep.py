"""The port's iteration-time sweeps (paper Figs. 8-9) held against the JAX
reference, on the CPU.

The reference runs in ONE subprocess for this module (``_REF_SCRIPT``), under
the same jax-0.9 shim as ``tests/test_torch_parity.py``; its sweep modules are
numpy, so the shim only lets ``repro`` import.  It builds every input from
numpy seeds and writes inputs and outputs to an ``.npz``.  This process never
imports ``jax`` or ``repro``.

Every comparison is exact (``np.array_equal``): the §4.2 event algebra is
float64 elementwise arithmetic in the reference's operator order, order
statistics select an element, and sums over iterations are folded in order.
``run_sweep`` at the committed grid's size reproduces every cell and ordering
of ``BENCH_sweep.json`` (read, never written).  The ``gpu``-marked case
repeats that on the card and skips without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import interop, scenario_sweep
from repro_torch.experiments.engine import (
    CAP_CHURN,
    CAP_CUDA_UNAVAILABLE,
    EngineCapabilityError,
)
from repro_torch.experiments.grid import (
    DEFAULT_REGIMES,
    MethodSpec,
    default_methods,
    run_sweep,
    scalar_sweep_seconds,
)
from repro_torch.experiments.results import (
    feed_profiler,
    outcome_to_dict,
    paper_ordering,
    write_bench_sweep,
)
from repro_torch.experiments.sweep import (
    replay_batch,
    scalar_reference,
    scalar_sync_reference,
    synchronous_times_batch,
)
from repro_torch.latency import event_sim, order_stats
from repro_torch.latency.model import (
    ChurnSchedule,
    make_heterogeneous_cluster,
    make_paper_artificial_cluster,
)

REPO = Path(__file__).resolve().parents[1]
#: traces of the small cases: scenarios, workers, draws; (w, margin) replays
S, N, K = 4, 12, 30
REPLAYS = ((9, 0.0), (9, 0.02), (12, 0.0), (1, 0.02))
SYNC_W = (6, 11, 12)
#: loads of the replays: a scalar, then one per (scenario, worker)
LOADS = ("scalar", "grid")
#: the committed iteration-time grid
BENCH = dict(n_workers=100, n_seeds=10, num_iterations=100, w_fracs=(0.8,))

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
from repro.experiments.sweep import (
    replay_batch, scalar_reference, scalar_sync_reference, synchronous_times_batch,
)
from repro.latency import event_sim, order_stats
from repro.latency.model import (
    make_heterogeneous_cluster, make_paper_artificial_cluster, sample_fleet,
)

P = {params}
out = {{}}
S, N, K = P["shape"]
cl = make_heterogeneous_cluster(N, seed=4, burst_rate=0.0, load_unit=3.0)
grid_loads = 1.0 + np.random.default_rng(2).integers(0, 3, size=(S, N)).astype(np.float64)
for regime, kw in (("calm", dict(burst_rate=0.0)),
                   ("bursty", dict(burst_rate=50.0, burst_factor_mean=3.0,
                                   burst_duration_mean=0.004))):
    tr = sample_fleet(cl, S, K, seed=6, load_hint=3.0, **kw)
    for f in ("comm", "comp_unit", "slowdown", "burst_start", "burst_end", "burst_factor"):
        out[f"tr/{{regime}}/{{f}}"] = getattr(tr, f)
    for lname in P["loads"]:
        loads = 3.0 if lname == "scalar" else grid_loads
        for w, margin in P["replays"]:
            pre = f"{{regime}}/{{lname}}/replay/{{w}}/{{margin}}/"
            r = replay_batch(tr, w, K, margin=margin, loads=loads, record_tasks=True)
            for f in ("iteration_times", "fresh_counts", "participation", "task_assigned",
                      "task_start", "task_finish", "task_comp"):
                out[pre + f] = getattr(r, f)
            for s in range(S):
                sr = scalar_reference(tr, s, w, K, margin=margin, loads=loads)
                out[pre + f"scalar/{{s}}/times"] = sr.iteration_times
                out[pre + f"scalar/{{s}}/fresh"] = sr.fresh_counts
                out[pre + f"scalar/{{s}}/part"] = sr.participation
    for w in P["sync_w"]:
        t, part = synchronous_times_batch(tr, w, K, loads=3.0, return_participation=True)
        out[f"{{regime}}/sync/{{w}}/times"], out[f"{{regime}}/sync/{{w}}/part"] = t, part
        out[f"{{regime}}/sync/{{w}}/scalar"] = np.stack(
            [scalar_sync_reference(tr, s, w, K, loads=3.0) for s in range(S)])
out["grid_loads"] = grid_loads

# -- the scalar event simulator sampling live, and the §4.1 predictors ----------
cl = make_heterogeneous_cluster(N, seed=8, burst_rate=0.5, load_unit=2.0)
sim = event_sim.EventDrivenSimulator(cl, [2.0] * N, with_bursts=True)
r = sim.run(8, 40, margin=0.02)
out["es/times"], out["es/fresh"], out["es/part"] = r.iteration_times, r.fresh_counts, r.participation
h, u = event_sim.estimate_contribution(make_heterogeneous_cluster(N, seed=9, load_unit=2.0), 8,
                                       [1, 2, 3] * (N // 3), [50] * N, [4.0] * N, num_iterations=30)
out["es/h"], out["es/u"] = np.array([h]), u
art = make_paper_artificial_cluster(N, seed=1)
out["es/sim_times"] = event_sim.simulate_iteration_times(art, 9, 1.0, 25, margin=0.02)
out["es/naive"] = event_sim.naive_iteration_times(make_paper_artificial_cluster(N, seed=1), 9, 1.0, 25)
cl = make_heterogeneous_cluster(N, seed=10, load_unit=2.0)
out["os/one"] = np.array([order_stats.predict_order_statistic(cl, 7, 2.0, num_trials=300, seed=3)])
out["os/all"] = order_stats.predict_order_statistics_all(cl, 2.0, num_trials=300, seed=3)
out["os/iid"] = order_stats.predict_order_statistics_iid(cl, 2.0, num_trials=300, seed=3)
out["os/emp"] = order_stats.empirical_order_statistic(
    np.random.default_rng(4).gamma(2.0, 1.0, size=(50, N)))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every reference output of this module, from one subprocess."""
    params = dict(shape=(S, N, K), replays=REPLAYS, sync_w=SYNC_W, loads=LOADS)
    path = tmp_path_factory.mktemp("jax_reference") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _REF_SCRIPT.format(params=repr(params)), str(path)],
        env=env, capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"reference subprocess failed:\n{proc.stderr[-4000:]}")
    with np.load(path) as z:
        return dict(z)


def _traces(ref, regime):
    return interop.traces_from_arrays(*(ref[f"tr/{regime}/{f}"] for f in (
        "comm", "comp_unit", "slowdown", "burst_start", "burst_end", "burst_factor")))


def _loads(ref, lname):
    return 3.0 if lname == "scalar" else ref["grid_loads"]


REPLAY_CASES = [(rg, ln, w, m) for rg in ("calm", "bursty") for ln in LOADS for w, m in REPLAYS]


def test_bursty_traces_slow_the_run(ref):
    """The bursty case is not vacuous: its bursts change the iteration times."""
    tr = _traces(ref, "bursty")
    empty = np.zeros((S, N, 0))
    calm = interop.traces_from_arrays(tr.comm, tr.comp_unit, tr.slowdown, empty, empty, empty)
    t_burst = replay_batch(tr, 9, K, loads=3.0, device="cpu").iteration_times
    t_calm = replay_batch(calm, 9, K, loads=3.0, device="cpu").iteration_times
    assert tr.has_bursts and (t_burst[:, -1] > t_calm[:, -1]).all()


@pytest.mark.parametrize(("regime", "lname", "w", "margin"), REPLAY_CASES)
def test_replay_batch_matches_reference(ref, regime, lname, w, margin):
    r = replay_batch(_traces(ref, regime), w, K, margin=margin, loads=_loads(ref, lname),
                     record_tasks=True, device="cpu")
    pre = f"{regime}/{lname}/replay/{w}/{margin}/"
    for f in ("iteration_times", "fresh_counts", "participation", "task_assigned",
              "task_start", "task_finish", "task_comp"):
        assert np.array_equal(getattr(r, f), ref[pre + f], equal_nan=True), f
    assert r.fresh_counts.dtype == np.int64 and r.iteration_times.dtype == np.float64


@pytest.mark.parametrize(("regime", "lname", "w", "margin"), REPLAY_CASES)
def test_scalar_reference_matches_reference_and_batch(ref, regime, lname, w, margin):
    tr = _traces(ref, regime)
    loads = _loads(ref, lname)
    batch = replay_batch(tr, w, K, margin=margin, loads=loads, device="cpu")
    pre = f"{regime}/{lname}/replay/{w}/{margin}/scalar/"
    for s in range(S):
        sr = scalar_reference(tr, s, w, K, margin=margin, loads=loads)
        assert np.array_equal(sr.iteration_times, ref[pre + f"{s}/times"])
        assert np.array_equal(sr.fresh_counts, ref[pre + f"{s}/fresh"])
        assert np.array_equal(sr.participation, ref[pre + f"{s}/part"])
        assert np.array_equal(sr.iteration_times, batch.iteration_times[s])
        assert np.array_equal(sr.fresh_counts, batch.fresh_counts[s])


@pytest.mark.parametrize("regime", ["calm", "bursty"])
@pytest.mark.parametrize("w", SYNC_W)
def test_synchronous_times_batch_matches_reference(ref, regime, w):
    tr = _traces(ref, regime)
    t, part = synchronous_times_batch(tr, w, K, loads=3.0, return_participation=True,
                                      device="cpu")
    assert np.array_equal(t, ref[f"{regime}/sync/{w}/times"])
    assert np.array_equal(part, ref[f"{regime}/sync/{w}/part"])
    assert np.array_equal(synchronous_times_batch(tr, w, K, loads=3.0, device="cpu"), t)
    scalar = np.stack([scalar_sync_reference(tr, s, w, K, loads=3.0) for s in range(S)])
    assert np.array_equal(scalar, ref[f"{regime}/sync/{w}/scalar"])
    assert np.array_equal(scalar, t)


def test_event_simulator_matches_reference(ref):
    cl = make_heterogeneous_cluster(N, seed=8, burst_rate=0.5, load_unit=2.0)
    r = event_sim.EventDrivenSimulator(cl, [2.0] * N, with_bursts=True).run(8, 40, margin=0.02)
    assert np.array_equal(r.iteration_times, ref["es/times"])
    assert np.array_equal(r.fresh_counts, ref["es/fresh"])
    assert np.array_equal(r.participation, ref["es/part"])
    h, u = event_sim.estimate_contribution(
        make_heterogeneous_cluster(N, seed=9, load_unit=2.0), 8, [1, 2, 3] * (N // 3),
        [50] * N, [4.0] * N, num_iterations=30)
    assert h == ref["es/h"][0] and np.array_equal(u, ref["es/u"])
    art = make_paper_artificial_cluster(N, seed=1)
    assert np.array_equal(event_sim.simulate_iteration_times(art, 9, 1.0, 25, margin=0.02),
                          ref["es/sim_times"])
    assert np.array_equal(
        event_sim.naive_iteration_times(make_paper_artificial_cluster(N, seed=1), 9, 1.0, 25),
        ref["es/naive"])


def test_order_statistics_match_reference(ref):
    cl = make_heterogeneous_cluster(N, seed=10, load_unit=2.0)
    assert order_stats.predict_order_statistic(cl, 7, 2.0, num_trials=300, seed=3) == ref["os/one"][0]
    assert np.array_equal(order_stats.predict_order_statistics_all(cl, 2.0, num_trials=300,
                                                                   seed=3), ref["os/all"])
    assert np.array_equal(order_stats.predict_order_statistics_iid(cl, 2.0, num_trials=300,
                                                                   seed=3), ref["os/iid"])
    emp = np.random.default_rng(4).gamma(2.0, 1.0, size=(50, N))
    assert np.array_equal(order_stats.empirical_order_statistic(emp), ref["os/emp"])
    with pytest.raises(ValueError, match="out of range"):
        order_stats.predict_order_statistic(cl, N + 1, 2.0)


# -- refusals -----------------------------------------------------------------------


def test_churn_refused_by_the_batched_sweeps(ref):
    tr = _traces(ref, "calm")
    tch = tr.with_churn(ChurnSchedule.static(tr.slowdown))
    for fn in (replay_batch, synchronous_times_batch):
        with pytest.raises(EngineCapabilityError) as e:
            fn(tch, 6, K, device="cpu")
        assert e.value.capability.code == CAP_CHURN


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_missing_card_refused():
    with pytest.raises(EngineCapabilityError) as e:
        run_sweep(n_workers=10, n_seeds=2, num_iterations=5)
    assert e.value.capability.code == CAP_CUDA_UNAVAILABLE


def test_sweep_arguments_checked(ref):
    tr = _traces(ref, "calm")
    with pytest.raises(ValueError, match="not in 1"):
        replay_batch(tr, N + 1, K, device="cpu")
    with pytest.raises(ValueError, match="draws/worker"):
        synchronous_times_batch(tr, 3, K + 1, device="cpu")


# -- the grid, its results layer and the committed artifact ----------------------------------


@pytest.fixture(scope="module")
def bench_cpu():
    return run_sweep(**BENCH, device="cpu")


def _assert_reproduces_committed(out) -> None:
    committed = json.loads((REPO / "BENCH_sweep.json").read_text())
    mine = outcome_to_dict(out)
    assert set(mine["cells"]) == set(committed["cells"])
    assert len(mine["cells"]) == 15
    for key, cell in committed["cells"].items():
        for f in ("mean_iter_time", "std_iter_time", "mean_fresh", "n_seeds"):
            assert mine["cells"][key][f] == cell[f], (key, f)
    assert mine["ordering"] == committed["ordering"]
    assert {k: mine["grid"][k] for k in committed["grid"]} == committed["grid"]


def test_run_sweep_reproduces_committed_bench(bench_cpu):
    _assert_reproduces_committed(bench_cpu)


def test_paper_ordering_holds_in_every_regime(bench_cpu):
    for regime in DEFAULT_REGIMES:
        o = paper_ordering(bench_cpu, regime.name)
        assert o["dsag_beats_sag_and_coded"] == 1.0, regime.name
        assert o["sag_over_dsag"] > 1.0 and o["coded_over_dsag"] > 1.0


@pytest.mark.gpu
def test_gpu_run_sweep_reproduces_committed_bench():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _assert_reproduces_committed(run_sweep(**BENCH, device="cuda"))


def test_sweep_rows_and_methods():
    specs = default_methods(20)
    assert [m.name for m in specs] == ["gd", "coded", "sgd", "sag", "dsag"]
    out = run_sweep(n_workers=20, n_seeds=3, num_iterations=12, w_fracs=(0.5, 0.8),
                    regimes=DEFAULT_REGIMES[:1], device="cpu")
    # gd, coded and sag once, sgd and dsag at both w values: 7 cells x 3 seeds
    assert len(out.results) == 7 and len(out.rows) == 21
    assert {r.w for r in out.rows if r.method == "dsag"} == {10, 16}
    assert out.mean_iter_time("calm", "dsag", 10) > 0
    with pytest.raises(KeyError):
        out.mean_iter_time("calm", "nope")
    custom = run_sweep(n_workers=20, n_seeds=2, num_iterations=6, regimes=DEFAULT_REGIMES[:1],
                       methods=(MethodSpec("sag", 20),), device="cpu")
    assert paper_ordering(custom, "calm") == {}
    with pytest.raises(ValueError, match="workers"):
        run_sweep(n_workers=20, cluster=make_heterogeneous_cluster(5), device="cpu")


def test_scalar_sweep_seconds_replays_every_cell():
    out = run_sweep(n_workers=12, n_seeds=2, num_iterations=8, regimes=DEFAULT_REGIMES[:2],
                    device="cpu")
    assert scalar_sweep_seconds(out) > 0.0


def test_feed_profiler_from_recorded_tasks(ref):
    tr = _traces(ref, "calm")
    res = replay_batch(tr, 9, K, margin=0.02, loads=3.0, record_tasks=True, device="cpu")
    prof = feed_profiler(res, 1, load=3.0)
    m = prof.moment_arrays(float(np.nanmax(res.task_finish[1])))
    started = np.isfinite(res.task_finish[1])
    assert m is not None and np.array_equal(m.num_samples, started.sum(axis=0))
    comm = np.maximum(res.task_finish[1] - res.task_assigned[1][:, None] - res.task_comp[1], 0)
    assert np.allclose(m.e_comm, [comm[started[:, i], i].mean() for i in range(N)], rtol=1e-12)
    with pytest.raises(ValueError, match="record_tasks"):
        feed_profiler(replay_batch(tr, 9, K, device="cpu"), 0)


def test_write_bench_sweep_and_cli(tmp_path, capsys):
    out = run_sweep(n_workers=12, n_seeds=2, num_iterations=8, device="cpu")
    path = tmp_path / "sweep.json"
    payload = write_bench_sweep(out, str(path), scalar_seconds=1.5)
    assert json.loads(path.read_text()) == payload
    assert payload["speedup_vs_scalar"] == 1.5 / out.engine_seconds
    cli_out = tmp_path / "cli.json"
    orderings = scenario_sweep.main(["--device", "cpu", "--workers", "12", "--seeds", "2",
                                     "--iters", "8", "--out", str(cli_out)])
    printed = capsys.readouterr().out
    assert "dsag_beats_sag_and_coded" in printed and f"wrote {cli_out}" in printed
    assert set(orderings) == {r.name for r in DEFAULT_REGIMES}
    assert json.loads(cli_out.read_text())["grid"]["n_workers"] == 12
