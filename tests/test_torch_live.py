"""The port's live two-tier trainer held against the JAX reference, on the CPU.

The reference runs in ONE subprocess for this module (``_REF_SCRIPT``), under
the same jax-0.9 shim as ``tests/test_torch_parity.py``; it builds every input
from numpy seeds and writes inputs and outputs to an ``.npz``.  This process
never imports ``jax`` or ``repro``.

Tolerances, and why:

* K4 (``dsag_cache_update``): the plain version equals the Pallas kernel in
  interpret mode bit for bit (same operator order; a 0/1 mask makes every
  product exact).  Against ``ref.dsag_update_ref``, which sums the deltas
  before adding h, ``new_c`` is exact and ``new_h`` agrees within float32
  rounding of the other order: ``|diff| <= 4 * eps32 * (|h| + Σ_i |delta_i|)``
  per element.
* K5 (``gram_matvec``): float32 sums in another order, ``rtol=1e-5`` with
  ``atol = 1e-5 * max|ref|``.
* ``dsag_update``: cache, pending, ``pending_valid``, ``filled`` and ξ exact;
  ``h`` and ``h_hat`` within ``rtol=1e-5``, ``atol = 1e-5 * max|h|`` (H is
  accumulated in K4's order, the reference sums deltas first); H == Σ cache
  within the same tolerance.
* Tier-2 streams (mask, flush, evict), ``mask_count``, ξ and virtual times:
  exact.
* Trainer losses ``rtol=1e-5``; suboptimality ``rtol=1e-4`` for logreg and
  ``rtol=1e-3, atol=1e-7`` for PCA (the gap comes from a float32 iterate
  re-projected by a QR whose last bits differ between LAPACK builds).
* One step from the reference's state at step 20: the step's gradients
  differ from the reference's autodiff in float32 rounding, so the new
  cache, pending, h and params are within ``rtol=1e-5``, ``atol = 1e-6 *
  max|ref|``; ``filled``, ``pending_valid`` and ξ are exact.

Tests marked ``gpu`` hold K4 and K5 against their plain versions on the card
and skip without one (``pytest -m gpu tests/test_torch_live.py``).
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

from repro_torch import interop
from repro_torch.configs.base import MeshConfig, TrainConfig
from repro_torch.core.dsag_pjit import (
    CAP_GROUP_GRAD,
    GroupSpec,
    dsag_update,
    init_dsag_state,
    make_group_spec,
    make_train_step,
)
from repro_torch.experiments.engine import (
    CAP_CUDA_KERNELS_OFF_DEVICE,
    CAP_CUDA_SHAPE,
    EngineCapabilityError,
    EngineConfig,
    engine_capability,
)
from repro_torch.ft.runtime import FailureDetector, elastic_remap_groups
from repro_torch.ft.validation import controller_streams
from repro_torch.kernels import dsag_update as k4
from repro_torch.kernels import gram_matvec as k5
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.latency.model import ChurnSchedule
from repro_torch.launch.paper_jobs import make_paper_job, paper_train_config
from repro_torch.launch.train import CAP_ARCH, Trainer, TrainerOptions
from repro_torch.lb.partitioner import align_partitions
from repro_torch.optim.compression import Quantized, dequantize
from repro_torch.optim.optimizers import make_optimizer

REPO = Path(__file__).resolve().parents[1]
CPU = EngineConfig(device="cpu", kernel_backend="torch")
EPS32 = float(np.finfo(np.float32).eps)

#: K4 cases: (slot dtype, p, n, mask kind)
K4_CASES = [
    ("float32", 1, 4096, "ones"), ("float32", 8, 4096, "random"),
    ("float32", 8, 4096, "zeros"), ("float32", 8, 29, "random"),
    ("bfloat16", 1, 4096, "ones"), ("bfloat16", 8, 4096, "random"),
    ("bfloat16", 8, 4096, "zeros"),
]
#: dsag_update script: groups, parameter shape, steps, the flush+evict step
DU_P, DU_SHAPE, DU_STEPS, DU_RACE = 6, (4, 3), 30, 12
#: controller streams: fleet of the reference's own pin tests
CS_N, CS_STEPS = 8, 30
CS_CASES = [("dsag", 0.02), ("dsag", 0.0), ("sag", 0.02)]
#: the live slice: (arch, samples, groups, w, eta) x (dsag, sag), traces replayed
LIVE = {"logreg": (512, 8, 6, 0.25), "pca": (512, 8, 6, 0.9)}
LIVE_STEPS, LIVE_EVAL, ONE_STEP_AT = 40, 5, 20
LIVE_CASES = [(a, m) for a in LIVE for m in ("dsag", "sag")]
#: the eviction case: a failure detector that declares stragglers failed
EVICT_MISSES = 3


#: the APIs jax 0.9 removed, put back before ``repro`` is imported
_SHIM = r"""
import dataclasses, sys
import jax, jax.experimental
jax.experimental.enable_x64 = jax.enable_x64
from jax.experimental import pallas as pl
pl.load = lambda ref, idx: ref[idx]
def _store(ref, idx, val):
    ref[idx] = val
pl.store = _store
"""

_REF_SCRIPT = _SHIM + r"""
import numpy as np
import jax.numpy as jnp
from repro.cluster.simulator import MethodConfig
from repro.configs import TrainConfig
from repro.core.dsag_pjit import GroupSpec, dsag_update, init_dsag_state
from repro.core.problems import (
    LogisticRegressionProblem, PCAProblem, make_genomics_like_matrix, make_higgs_like,
)
from repro.experiments.grid import HEAVY_BURSTS
from repro.ft.validation import controller_streams, group_loads, pin_streams
from repro.kernels import ops, ref
from repro.latency.model import ChurnSchedule, make_heterogeneous_cluster, sample_fleet
from repro.launch.paper_jobs import paper_train_config
from repro.launch.train import Trainer, TrainerOptions

P = {params}
out = {{}}
rng = np.random.default_rng(21)
f32 = lambda a: np.asarray(a, dtype=np.float32)

# -- K4: Pallas (interpret) and the jnp oracle ---------------------------------
for ci, (dt, p, n, mk) in enumerate(P["k4"]):
    jdt = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
    g = jnp.asarray(rng.normal(size=(p, n)).astype(np.float32)).astype(jdt)
    c = jnp.asarray(rng.normal(size=(p, n)).astype(np.float32)).astype(jdt)
    h = jnp.asarray(rng.normal(size=(n,)).astype(np.float32))
    if mk == "ones":
        m = np.ones(p, np.float32)
    elif mk == "zeros":
        m = np.zeros(p, np.float32)
    else:
        m = np.zeros(p, np.float32)
        m[rng.permutation(p)[: p // 2 + 1]] = 1.0
    m = jnp.asarray(m)
    kc, kh = ops.dsag_cache_update_op(g, c, h, m, interpret=True)
    rc, rh = jax.jit(ref.dsag_update_ref)(g, c, h, m)
    for name, a in (("g", g), ("c", c), ("h", h), ("mask", m), ("pallas_c", kc),
                    ("pallas_h", kh), ("ref_c", rc), ("ref_h", rh)):
        out[f"k4/{{ci}}/{{name}}"] = f32(a)

# -- K5 --------------------------------------------------------------------------
x = rng.normal(size=(300, 16)).astype(np.float32)
v = rng.normal(size=(16, 3)).astype(np.float32)
out["k5/x"], out["k5/v"] = x, v
out["k5/pallas"] = f32(ops.gram_matvec_op(jnp.asarray(x), jnp.asarray(v), interpret=True))
out["k5/ref"] = f32(jax.jit(ref.gram_matvec_ref)(jnp.asarray(x), jnp.asarray(v)))
xb = (rng.random((3, 200, 12)) < 0.1).astype(np.float32)
vb = np.linalg.qr(rng.normal(size=(12, 2)))[0].astype(np.float32)
out["k5b/x"], out["k5b/v"] = xb, vb
out["k5b/pallas"] = np.stack([f32(ops.gram_matvec_op(jnp.asarray(xb[b]), jnp.asarray(vb),
                                                      interpret=True)) for b in range(3)])
out["k5b/ref"] = np.stack([f32(ref.gram_matvec_ref(jnp.asarray(xb[b]), jnp.asarray(vb)))
                           for b in range(3)])

# -- dsag_update over a scripted 30-step run --------------------------------------
Pg, shape, T, race = P["du"]
upd = jax.jit(dsag_update)
for dt in ("float32", "bfloat16"):
    tc = TrainConfig(dsag=True, dsag_cache_dtype=dt)
    st = init_dsag_state(jnp.zeros(shape, jnp.float32), GroupSpec(Pg, ()), tc)
    for t in range(T):
        g = rng.normal(size=(Pg,) + tuple(shape)).astype(np.float32)
        mask = rng.random(Pg) < 0.6
        flush = rng.random(Pg) < 0.4
        evict = rng.random(Pg) < 0.08
        if t == race - 1:
            mask[0] = False  # group 0 parks a gradient in pending
        if t == race:
            mask[0], flush[0], evict[0] = False, True, True  # flush and evict race
        st, h_hat, xi = upd(st, jnp.asarray(g), jnp.asarray(mask), jnp.asarray(flush),
                            jnp.asarray(evict))
        pre = f"du/{{dt}}/{{t}}/"
        for name, a in (("g", g), ("mask", mask), ("flush", flush), ("evict", evict),
                        ("h_hat", h_hat), ("xi", xi)):
            out[pre + name] = np.asarray(a) if a.dtype == bool else f32(a)
        for name in ("cache", "pending", "h"):
            out[pre + name] = f32(st[name])
        for name in ("pending_valid", "filled"):
            out[pre + name] = np.asarray(st[name])

# -- Tier-2 controller streams vs the scalar simulator ----------------------------
N, STEPS = P["cs"]
X, y = make_higgs_like(512, seed=0)
prob = LogisticRegressionProblem(X=X, y=y)
c_task = prob.compute_cost(1, max(prob.num_samples // N, 1))
cluster = make_heterogeneous_cluster(N, seed=3, burst_rate=0.0, load_unit=c_task)
traces = sample_fleet(cluster, 2, 800, seed=7)
for f in ("comm", "comp_unit", "slowdown", "burst_start", "burst_end", "burst_factor"):
    out[f"cs/traces/{{f}}"] = getattr(traces, f)
out["cs/loads"] = group_loads(prob, N)
for name, margin in P["cs_cases"]:
    cfg = MethodConfig(name=name, w=6, eta=0.25, margin=margin, subpartitions=1)
    for s in range(2):
        ctrl, sim, _ = pin_streams(prob, cluster, traces, s, cfg, STEPS)
        for src, cs in (("ctrl", ctrl), ("sim", sim)):
            for f in ("mask", "flush", "evict", "times"):
                out[f"cs/{{name}}/{{margin}}/{{s}}/{{src}}/{{f}}"] = getattr(cs, f)
base = controller_streams(traces, 0, w=6, num_iterations=STEPS, loads=group_loads(prob, N))
alive = np.ones((3, N), dtype=bool)
alive[1, [2, 5]] = False
alive[2, 5] = False
churn = ChurnSchedule(times=np.array([float(base.times[STEPS // 3]), float(base.times[2 * STEPS // 3])]),
                      slowdown=np.tile(traces.slowdown, (3, 1)), alive=alive)
out["cs/churn/times"], out["cs/churn/alive"] = churn.times, churn.alive
tch = traces.with_churn(churn)
for name in ("dsag", "sag"):
    cfg = MethodConfig(name=name, w=6, eta=0.25, subpartitions=1)
    ctrl, sim, _ = pin_streams(prob, cluster, tch, 0, cfg, STEPS)
    for src, cs in (("ctrl", ctrl), ("sim", sim)):
        for f in ("mask", "flush", "evict", "times"):
            out[f"cs/churn/{{name}}/{{src}}/{{f}}"] = getattr(cs, f)

# -- the live trainer, traces replayed ------------------------------------------
def live_setup(arch):
    n, G, w, eta = P["live"][arch]
    if arch == "logreg":
        Xa, ya = make_higgs_like(n, seed=0)
        pr = LogisticRegressionProblem(X=Xa, y=ya)
    else:
        pr = PCAProblem(X=make_genomics_like_matrix(n, 64, seed=0))
    cl = make_heterogeneous_cluster(G, seed=3, burst_rate=0.0,
                                    load_unit=pr.compute_cost(1, max(n // G, 1)))
    tr = sample_fleet(cl, 2, 4 * P["steps"], burst_rate=HEAVY_BURSTS.rate,
                      burst_factor_mean=HEAVY_BURSTS.factor_mean,
                      burst_duration_mean=HEAVY_BURSTS.duration_mean, seed=7)
    return n, G, w, eta, tr

def live_opts(arch, method, misses):
    n, G, w, eta, tr = live_setup(arch)
    return TrainerOptions(arch=arch, steps=P["steps"], samples=n, num_groups=G, dsag_w=w,
                          method=method, traces=tr, scenario=0,
                          train_config=paper_train_config(eta), simulate_stragglers=False,
                          failure_max_misses=misses, eval_every=P["eval"], log_every=10**6,
                          seed=0)

for arch in P["live"]:
    tr = live_setup(arch)[4]
    for f in ("comm", "comp_unit", "slowdown", "burst_start", "burst_end", "burst_factor"):
        out[f"live/{{arch}}/traces/{{f}}"] = getattr(tr, f)
for arch, method, misses, tag in P["live_runs"]:
    h = Trainer(live_opts(arch, method, misses)).run()
    pre = f"live/{{tag}}/"
    for f in ("mask_stream", "flush_stream", "evict_stream"):
        out[pre + f] = np.stack(h[f])
    for f in ("loss", "xi", "mask_count", "virtual"):
        out[pre + f] = np.asarray(h[f])
    out[pre + "eval"] = np.array([(s, v, g) for (s, _w, v, g) in h["eval"]])

# one step from the reference's own state at step k
for arch in P["live"]:
    trn = Trainer(live_opts(arch, "dsag", 10**6))
    state = trn.init_state()
    for step in range(P["one_step_at"] + 1):
        batch = next(trn.data)
        m, f, e, _ = trn._step_inputs(step)
        if step == P["one_step_at"]:
            pre = f"one/{{arch}}/before/"
            out[f"one/{{arch}}/inputs"] = np.stack([m, f, e])
            for name, a in (("params", state["params"]), ("mu", state["opt"]["mu"]),
                            ("step", state["step"])):
                out[pre + name] = np.asarray(a)
            for name in ("cache", "pending", "pending_valid", "filled", "h"):
                out[pre + name] = np.asarray(state["dsag"][name])
        state, metrics = trn.step_fn(state, jax.tree.map(jnp.asarray, batch), jnp.asarray(m),
                                     jnp.asarray(f), jnp.asarray(e))
    pre = f"one/{{arch}}/after/"
    out[pre + "params"] = np.asarray(state["params"])
    out[pre + "loss"] = np.asarray(metrics["loss"])
    out[pre + "xi"] = np.asarray(metrics["xi"])
    for name in ("cache", "pending", "pending_valid", "filled", "h"):
        out[pre + name] = np.asarray(state["dsag"][name])
np.savez(sys.argv[1], **out)
"""


def _live_runs():
    runs = [(a, m, 10**6, f"{a}/{m}") for a, m in LIVE_CASES]
    return runs + [("logreg", "dsag", EVICT_MISSES, "evict")]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every reference output of this module, from one JAX subprocess."""
    params = dict(
        k4=K4_CASES, du=(DU_P, DU_SHAPE, DU_STEPS, DU_RACE), cs=(CS_N, CS_STEPS),
        cs_cases=CS_CASES, live=LIVE, steps=LIVE_STEPS, eval=LIVE_EVAL,
        live_runs=_live_runs(), one_step_at=ONE_STEP_AT,
    )
    path = tmp_path_factory.mktemp("jax_live_reference") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _REF_SCRIPT.format(params=repr(params)), str(path)],
        env=env, capture_output=True, text=True, timeout=900,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"reference subprocess failed:\n{proc.stderr[-4000:]}")
    with np.load(path) as z:
        return dict(z)


def _t(a, dtype=None):
    t = torch.as_tensor(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def _slot_dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def _close(got, want, rtol=1e-5, scale=1e-5):
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=scale * float(np.abs(want).max()))


# -- K4 -------------------------------------------------------------------------


def _k4_inputs(ref, ci):
    dt = _slot_dtype(K4_CASES[ci][0])
    p = f"k4/{ci}/"
    return (_t(ref[p + "g"], dt), _t(ref[p + "c"], dt), _t(ref[p + "h"]), _t(ref[p + "mask"]))


@pytest.mark.parametrize("ci", range(len(K4_CASES)))
def test_k4_plain_bit_equal_to_pallas_interpret(ref, ci):
    g, c, h, m = _k4_inputs(ref, ci)
    new_c, new_h = k4.dsag_cache_update_plain(g, c, h, m)
    assert new_c.dtype == c.dtype and new_h.dtype == torch.float32
    assert np.array_equal(new_c.float().numpy(), ref[f"k4/{ci}/pallas_c"])
    assert np.array_equal(new_h.numpy(), ref[f"k4/{ci}/pallas_h"])


@pytest.mark.parametrize("ci", range(len(K4_CASES)))
def test_k4_plain_matches_oracle(ref, ci):
    g, c, h, m = _k4_inputs(ref, ci)
    before = (g.clone(), c.clone(), h.clone())
    new_c, new_h = k4.dsag_cache_update(g, c, h, m)  # CPU tensors: the plain version
    assert np.array_equal(new_c.float().numpy(), ref[f"k4/{ci}/ref_c"])
    # the oracle adds h after the group sum; K4 adds the groups to h in order
    delta = (new_c.float() - c.float()).abs().sum(0)
    atol = 4 * EPS32 * (h.abs() + delta).numpy()
    assert np.all(np.abs(new_h.numpy() - ref[f"k4/{ci}/ref_h"]) <= atol)
    for a, b in zip((g, c, h), before):  # inputs are not modified
        assert torch.equal(a, b)


def test_k4_empty_groups_return_h():
    h = torch.arange(5, dtype=torch.float32)
    for update in (k4.dsag_cache_update, k4.dsag_cache_update_plain):
        new_c, new_h = update(torch.zeros(0, 5), torch.zeros(0, 5), h, torch.zeros(0))
        assert new_c.shape == (0, 5) and torch.equal(new_h, h) and new_h is not h


# -- K5 -------------------------------------------------------------------------


@pytest.mark.parametrize("against", ["pallas", "ref"])
@pytest.mark.parametrize("batched", [False, True])
def test_k5_plain_matches_reference(ref, against, batched):
    p = "k5b/" if batched else "k5/"
    got = k5.gram_matvec(_t(ref[p + "x"]), _t(ref[p + "v"]))  # CPU: the plain version
    assert got.dtype == torch.float32 and got.shape == ref[p + against].shape
    _close(got.numpy(), ref[p + against])


@pytest.mark.parametrize(("B", "m", "align", "chunks", "rows"), [
    (50, 1000, 64, 6, 192),  # the live PCA step (64-row tiles at d = 64): 300 blocks
    (1, 4096, 32, 128, 32),  # kernels_bench [4096, 512]·[512, 8]: 128 chunks of 32 rows
    (2, 37, 32, 2, 32),  # tiny: the last chunk holds 5 rows
    (1, 50_000, 64, 261, 192),
    (1, 1, 32, 1, 32),
    (300, 64, 64, 1, 64),  # more groups than target blocks: one chunk a group
])
def test_k5_chunk_count(B, m, align, chunks, rows):
    assert k5.gram_chunks(B, m, align) == (chunks, rows)


def test_k5_batched_slices_equal_unbatched(ref):
    x, v = _t(ref["k5b/x"]), _t(ref["k5b/v"])
    full = k5.gram_matvec_plain(x, v)
    for b in range(x.shape[0]):
        _close(full[b].numpy(), k5.gram_matvec_plain(x[b], v).numpy(), rtol=1e-6, scale=1e-6)


# -- dsag_update ------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_dsag_update_matches_reference_script(ref, dt, backend):
    tc = TrainConfig(dsag=True, dsag_cache_dtype=dt)
    st = init_dsag_state(torch.zeros(DU_SHAPE), GroupSpec(DU_P, ()), tc)
    assert st["cache"].dtype == _slot_dtype(dt)
    raced = False
    for t in range(DU_STEPS):
        p = f"du/{dt}/{t}/"
        mask, flush, evict = (_t(ref[p + n]) for n in ("mask", "flush", "evict"))
        st, h_hat, xi = dsag_update(st, _t(ref[p + "g"]), mask, flush, evict, backend=backend)
        for name in ("cache", "pending"):
            assert st[name].dtype == _slot_dtype(dt)
            assert np.array_equal(st[name].float().numpy(), ref[p + name]), (t, name)
        for name in ("pending_valid", "filled"):
            assert np.array_equal(st[name].numpy(), ref[p + name]), (t, name)
        assert xi.dtype == torch.float32 and float(xi) == float(ref[p + "xi"])
        _close(st["h"].numpy(), ref[p + "h"])
        _close(h_hat.numpy(), ref[p + "h_hat"])
        # the SAG invariant H == Σ_i cache_i, the port's form of the
        # reference's test_dsag_pjit pin
        _close(st["h"].numpy(), st["cache"].float().sum(0).numpy())
        raced |= bool((flush & evict).any())
    assert raced, "the script never raced a flush against an eviction"


def test_dsag_update_race_evicts_after_flush(ref):
    """The step where flush and evict hit group 0: the slot is zero and the
    group's pending gradient is dropped, as in the reference."""
    p = f"du/float32/{DU_RACE}/"
    assert ref[p + "flush"][0] and ref[p + "evict"][0]
    assert not ref[f"du/float32/{DU_RACE - 1}/mask"][0]
    assert np.all(ref[p + "cache"][0] == 0.0)
    assert not ref[p + "pending_valid"][0]


# -- the copied controller -----------------------------------------------------------


def _cs_traces(ref, churn=False):
    tr = interop.traces_from_arrays(*(ref[f"cs/traces/{f}"] for f in (
        "comm", "comp_unit", "slowdown", "burst_start", "burst_end", "burst_factor")))
    if churn:
        sd = np.tile(tr.slowdown, (3, 1))
        tr = tr.with_churn(ChurnSchedule(times=ref["cs/churn/times"], slowdown=sd,
                                         alive=ref["cs/churn/alive"]))
    return tr


@pytest.mark.parametrize("scenario", [0, 1])
@pytest.mark.parametrize(("name", "margin"), CS_CASES)
def test_controller_streams_equal_reference_and_simulator(ref, name, margin, scenario):
    cs = controller_streams(_cs_traces(ref), scenario, w=6, num_iterations=CS_STEPS,
                            loads=ref["cs/loads"], margin=margin,
                            accepts_stale=name == "dsag")
    pre = f"cs/{name}/{margin}/{scenario}/"
    for src in ("ctrl", "sim"):
        for f in ("mask", "flush", "evict"):
            assert np.array_equal(getattr(cs, f), ref[f"{pre}{src}/{f}"]), (src, f)
        assert np.array_equal(cs.times, ref[f"{pre}{src}/times"])
    assert not cs.mask.all()


@pytest.mark.parametrize("name", ["dsag", "sag"])
def test_controller_streams_under_churn(ref, name):
    cs = controller_streams(_cs_traces(ref, churn=True), 0, w=6, num_iterations=CS_STEPS,
                            loads=ref["cs/loads"], accepts_stale=name == "dsag")
    pre = f"cs/churn/{name}/"
    for src in ("ctrl", "sim"):
        for f in ("mask", "flush", "evict", "times"):
            assert np.array_equal(getattr(cs, f), ref[f"{pre}{src}/{f}"]), (src, f)
    assert cs.evict.sum() == 2  # both deaths cleared a cache slot


# -- the whole slice: the live Trainer ---------------------------------------------------


def _live_opts(ref, arch, method, misses, engine=CPU):
    n, G, w, eta = LIVE[arch]
    tr = interop.traces_from_arrays(*(ref[f"live/{arch}/traces/{f}"] for f in (
        "comm", "comp_unit", "slowdown", "burst_start", "burst_end", "burst_factor")))
    return TrainerOptions(
        arch=arch, steps=LIVE_STEPS, samples=n, num_groups=G, dsag_w=w, method=method,
        traces=tr, scenario=0, train_config=paper_train_config(eta),
        simulate_stragglers=False, failure_max_misses=misses, eval_every=LIVE_EVAL,
        log_every=10**6, seed=0, engine=engine,
    )


@pytest.fixture(scope="module")
def port_live(ref):
    return {tag: Trainer(_live_opts(ref, a, m, misses)).run()
            for a, m, misses, tag in _live_runs()}


@pytest.mark.parametrize("tag", [t for *_, t in _live_runs()])
def test_live_trainer_streams_xi_virtual_exact(ref, port_live, tag):
    h, pre = port_live[tag], f"live/{tag}/"
    for f in ("mask_stream", "flush_stream", "evict_stream"):
        assert np.array_equal(np.stack(h[f]), ref[pre + f]), f
    assert np.array_equal(np.asarray(h["mask_count"]), ref[pre + "mask_count"])
    assert np.array_equal(np.asarray(h["xi"], dtype=np.float32), ref[pre + "xi"].astype(np.float32))
    assert np.array_equal(np.asarray(h["virtual"]), ref[pre + "virtual"])
    if tag == "evict":
        assert np.stack(h["evict_stream"]).any(), "the detector evicted no group"


@pytest.mark.parametrize("tag", [t for *_, t in _live_runs()])
def test_live_trainer_loss_and_gap_within_tolerance(ref, port_live, tag):
    h, pre = port_live[tag], f"live/{tag}/"
    np.testing.assert_allclose(h["loss"], ref[pre + "loss"], rtol=1e-5)
    ev = np.array([(s, v, g) for (s, _w, v, g) in h["eval"]])
    want = ref[pre + "eval"]
    assert np.array_equal(ev[:, :2], want[:, :2])  # eval steps and virtual times
    rtol, atol = (1e-4, 0.0) if tag.startswith(("logreg", "evict")) else (1e-3, 1e-7)
    np.testing.assert_allclose(ev[:, 2], want[:, 2], rtol=rtol, atol=atol)
    assert h["loss"][-1] < h["loss"][0]


@pytest.mark.parametrize("arch", list(LIVE))
def test_one_step_from_reference_state(ref, arch):
    """From the reference's train state at step 20 and its step-20 inputs,
    one port step lands on the reference's step-21 state: no drift can hide
    a wrong rule."""
    b, a = f"one/{arch}/before/", f"one/{arch}/after/"
    n, G, w, eta = LIVE[arch]
    job = make_paper_job(arch, G, samples=n, seed=0, engine=CPU)
    tc = paper_train_config(eta)
    step_fn = make_train_step(job, tc, GroupSpec(G, ()),
                              project_fn=job.project_fn if arch == "pca" else None,
                              backend="torch")
    state = interop.train_state_from_arrays(
        *(ref[b + k] for k in ("params", "cache", "pending", "pending_valid", "filled", "h",
                               "mu", "step")), device="cpu")
    mask, flush, evict = _t(ref[f"one/{arch}/inputs"])
    new, metrics = step_fn(state, next(job.batch_iterator()), mask, flush, evict)
    for name in ("pending_valid", "filled"):
        assert np.array_equal(new["dsag"][name].numpy(), ref[a + name]), name
    assert float(metrics["xi"]) == float(ref[a + "xi"])
    assert int(new["step"]) == int(ref[b + "step"]) + 1
    for name in ("cache", "pending", "h"):
        _close(new["dsag"][name].numpy(), ref[a + name], scale=1e-6)
    _close(new["params"].numpy(), ref[a + "params"], scale=1e-6)
    assert new["params"].is_contiguous()  # what the kernels take on the card
    np.testing.assert_allclose(float(metrics["loss"]), float(ref[a + "loss"]), rtol=1e-5)


# -- port-only ------------------------------------------------------------------------------


def _code(excinfo) -> str:
    return excinfo.value.capability.code


def test_capability_codes(tmp_path):
    """What stays refused (an arch the registry does not hold, a mesh, a job
    without a loss or group gradients, CUDA kernels off the card), and what
    now runs: checkpoints,
    the int8 cache and adamw/adafactor each build and run one step."""
    with pytest.raises(EngineCapabilityError) as e:
        Trainer(TrainerOptions(arch="gpt-x", engine=CPU))
    assert _code(e) == CAP_ARCH
    trn = Trainer(TrainerOptions(checkpoint_dir=str(tmp_path), steps=1, engine=CPU))
    assert len(trn.run()["loss"]) == 1 and (tmp_path / "step_00000000").is_dir()
    st = init_dsag_state(torch.zeros(3), GroupSpec(2, ()), TrainConfig(dsag_cache_dtype="int8"))
    assert isinstance(st["cache"], Quantized) and st["cache"].q.dtype == torch.int8
    ones = torch.ones(2, dtype=torch.bool)
    new, _, xi = dsag_update(st, torch.ones(2, 3), ones, ~ones, ~ones)
    # H is the sum of the stored (dequantized) slots: 2 within the int8 step
    assert float(xi) == 1.0
    assert torch.equal(new["h"], dequantize(new["cache"], torch.float32).sum(0))
    assert torch.allclose(new["h"], torch.full((3,), 2.0), rtol=1 / 127)
    for name in ("adamw", "adafactor"):
        opt = make_optimizer(TrainConfig(optimizer=name))
        upd, state = opt.update(torch.ones(3), opt.init(torch.zeros(3)), torch.zeros(3))
        assert upd.shape == (3,) and int(state["step"]) == 1 and bool((upd < 0).all())
    # a mesh's groups lie on its data axes; what is not a mesh is refused
    assert make_group_spec(TrainConfig(), MeshConfig((2, 4), ("data", "model"))) == GroupSpec(
        2, ("data",))
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_group_spec(TrainConfig(), mesh=object())
    with pytest.raises(EngineCapabilityError) as e:
        make_train_step(object(), paper_train_config(0.1), GroupSpec(2, ()))
    assert _code(e) == CAP_GROUP_GRAD
    with pytest.raises(EngineCapabilityError) as e:
        make_paper_job("logreg", 4, samples=64,
                       engine=EngineConfig(device="cpu", kernel_backend="cuda"))
    assert _code(e) == CAP_CUDA_KERNELS_OFF_DEVICE


@pytest.mark.parametrize("arch", ["logreg", "pca"])
def test_live_job_refuses_shapes_past_the_kernels_limits(monkeypatch, arch):
    """The live trainer checks its K1/K5 launch shapes when the job is made,
    before any launch (cuda-shape-unsupported); here the kernels' shape
    reports are forced, and the device check is passed over on the CPU."""
    from repro_torch.kernels import block_sub
    from repro_torch.launch import paper_jobs

    monkeypatch.setattr(paper_jobs, "engine_capability", lambda *a: engine_capability(CPU))
    monkeypatch.setattr(block_sub, "shape_error", lambda *a: "logreg_block_sub: past a limit")
    monkeypatch.setattr(k5, "shape_error", lambda *a: "gram_matvec: past a limit")
    with pytest.raises(EngineCapabilityError) as e:
        make_paper_job(arch, 4, samples=64,
                       engine=EngineConfig(device="cuda", kernel_backend="cuda"))
    assert _code(e) == CAP_CUDA_SHAPE
    assert make_paper_job(arch, 4, samples=64, engine=CPU).num_groups == 4  # plain: any shape


def test_launch_counters_stay_zero_on_cpu():
    reset_launch_counts()
    opts = TrainerOptions(arch="pca", steps=3, samples=64, num_groups=4, engine=CPU,
                          train_config=paper_train_config(0.9))
    Trainer(opts).run()
    opts = dataclasses.replace(opts, arch="logreg", train_config=paper_train_config(0.25))
    Trainer(opts).run()
    counts = launch_counts()
    assert {"dsag_cache_update", "gram_matvec", "logreg_block_sub"} <= set(counts)
    assert all(v == 0 for v in counts.values()), counts


def test_live_sampled_path_and_failure_detector():
    h = Trainer(TrainerOptions(arch="logreg", steps=12, samples=256, num_groups=4,
                               engine=CPU, train_config=paper_train_config(0.25))).run()
    assert len(h["loss"]) == 12 and len(h["mask_stream"]) == 12
    assert all(m.sum() >= 3 for m in h["mask_stream"])  # w = 3 of 4
    fd = FailureDetector(3, max_misses=2)
    fd.observe(np.array([True, False, False]))
    assert fd.observe(np.array([True, False, True])).tolist() == [False, True, False]
    fd.rejoin(1)
    assert not fd.failed.any()


def test_elastic_remap_and_alignment():
    assert align_partitions(10, 2, 5, 1) == (1, 1)
    k_new, survivors = elastic_remap_groups(16, 8, 4)
    assert survivors.shape == (4,) and not survivors.any()  # halved ranges match no old group
    _, same = elastic_remap_groups(16, 4, 4)
    assert same.all()


def test_no_dsag_step_is_plain_mean():
    job = make_paper_job("logreg", 4, samples=64, engine=CPU)
    tc = dataclasses.replace(paper_train_config(0.5), dsag=False)
    step = make_train_step(job, tc, GroupSpec(4, ()), backend="torch")
    from repro_torch.core.dsag_pjit import init_train_state

    state = init_train_state(job.init_params(0), tc, GroupSpec(4, ()))
    ones = torch.ones(4, dtype=torch.bool)
    new, metrics = step(state, next(job.batch_iterator()), ones, ~ones, ~ones)
    _, grads = job.group_value_and_grad(state["params"], next(job.batch_iterator()))
    want = state["params"] - 0.5 * grads.mean(0)
    assert torch.allclose(new["params"], want, rtol=1e-6, atol=1e-7)
    assert float(metrics["xi"]) == 1.0


def test_cli_check_passes_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "logreg",
         "--device", "cpu", "--kernel-backend", "torch", "--steps", "20", "--check"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[check]" in proc.stdout and "OK" in proc.stdout


# -- on the card ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize(("gdt", "cdt"), [("float32", "float32"), ("bfloat16", "bfloat16"),
                                          ("bfloat16", "float32"), ("float32", "bfloat16")])
@pytest.mark.parametrize(("p", "n"), [
    (100, 29), (50, 192), (8, 29),  # the live steps' shapes
    (8, 1 << 16), (8, 132 * 256),  # one thread per element walks the groups (from 33792)
    (1, 29), (1, 1000),  # one group
    (300, 45), (600, 100),  # more groups than one staged chunk (256); n no multiple of 32
])
def test_gpu_k4_bit_equal_to_plain(card, gdt, cdt, p, n):
    rng = np.random.default_rng(5)
    g = torch.as_tensor(rng.normal(size=(p, n)), dtype=torch.float32,
                        device=card).to(_slot_dtype(gdt))
    c = torch.as_tensor(rng.normal(size=(p, n)), dtype=torch.float32,
                        device=card).to(_slot_dtype(cdt))
    h = torch.as_tensor(rng.normal(size=n), dtype=torch.float32, device=card)
    m = torch.as_tensor(rng.random(p) < 0.5, device=card).float()
    before = launch_counts()["dsag_cache_update"]
    kc, kh = k4.dsag_cache_update(g, c, h, m)
    pc, ph = k4.dsag_cache_update_plain(g, c, h, m)
    torch.cuda.synchronize()
    assert launch_counts()["dsag_cache_update"] == before + 1
    assert kc.dtype == c.dtype and kh.dtype == torch.float32
    assert torch.equal(kc, pc) and torch.equal(kh, ph)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    (50, 1000, 64, 3), (1, 4096, 512, 8), (2, 37, 5, 2),
    (1, 5003, 96, 5),  # m no multiple of the chunk (157 chunks of 32 rows)
    (1, 50_000, 64, 3),  # one group of 50000 rows: 261 chunks
    (4, 777, 16, 4),  # d*k = 64, fewer than one block's 256 threads
    (50, 1000, 1100, 3),  # the wide path: d past 1024
    (1, 4096, 64, 12),  # the wide path: k past 8
    (3, 700, 1030, 9),  # the wide path: both, two column chunks
])
def test_gpu_k5_matches_plain(card, shape):
    B, m, d, k = shape
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.random((B, m, d)) < 0.1, dtype=torch.float32, device=card)
    v = torch.as_tensor(rng.normal(size=(d, k)), dtype=torch.float32, device=card)
    got = k5.gram_matvec(x if B > 1 else x[0], v)
    want = k5.gram_matvec_plain(x if B > 1 else x[0], v)
    torch.cuda.synchronize()
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    assert torch.equal(got, k5.gram_matvec(x if B > 1 else x[0], v))  # repeats its bits


#: ``PYTHONPATH=src python tests/test_torch_live.py``: the JAX reference's live trainer on
#: the paper-scale jobs that ``chip_smoke.py`` holds the port against
#: (``PAPER_LIVE`` there; the recipe is ``chip_smoke.paper_live_opts``)
_PAPER_SCRIPT = _SHIM + r"""
import numpy as np
from repro.core.problems import (
    LogisticRegressionProblem, PCAProblem, make_genomics_like_matrix, make_higgs_like,
)
from repro.experiments.grid import HEAVY_BURSTS
from repro.latency.model import make_heterogeneous_cluster, sample_fleet
from repro.launch.paper_jobs import paper_train_config
from repro.launch.train import Trainer, TrainerOptions

for arch, n, G, w, eta in (("logreg", 16000, 100, 80, 0.25), ("pca", 50000, 50, 40, 0.9)):
    if arch == "logreg":
        X, y = make_higgs_like(n, seed=0)
        prob = LogisticRegressionProblem(X=X, y=y)
    else:
        prob = PCAProblem(X=make_genomics_like_matrix(n, 64, seed=0))
    cluster = make_heterogeneous_cluster(G, seed=3, burst_rate=0.0,
                                         load_unit=prob.compute_cost(1, n // G))
    traces = sample_fleet(cluster, 2, 4 * 80, burst_rate=HEAVY_BURSTS.rate,
                          burst_factor_mean=HEAVY_BURSTS.factor_mean,
                          burst_duration_mean=HEAVY_BURSTS.duration_mean, seed=7)
    for m in ("dsag", "sag"):
        opts = TrainerOptions(arch=arch, steps=80, samples=n, num_groups=G, dsag_w=w, method=m,
                              traces=traces, scenario=0, train_config=paper_train_config(eta),
                              simulate_stragglers=False, failure_max_misses=10**6,
                              eval_every=10, log_every=10**6, seed=0)
        h = Trainer(opts).run()
        print(repr((arch, m)), repr((h["eval"][-1][3], h["virtual"][-1], h["loss"][0],
              h["loss"][-1], max(h["xi"]), int(np.sum(h["mask_stream"])),
              int(np.sum(h["flush_stream"])))))
"""


if __name__ == "__main__":
    subprocess.run([sys.executable, "-c", _PAPER_SCRIPT], check=True,
                   env=dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu"))
