"""The live trainer's rest in the port, held against the JAX reference on the
CPU: adamw and adafactor, int8 compression, the int8 DSAG cache (through
K4's int8 entry's plain version), checkpoints and ``Trainer`` restore.

The reference runs in ONE subprocess for this module (``_REF_SCRIPT``,
under the jax-0.9 shim of ``tests/test_torch_parity.py``), after the port
has written the checkpoints it restores; this process never imports ``jax``
or ``repro``.

Tolerances, and why:

* adamw / adafactor: one update on identical inputs within ``rtol=1e-6``
  (XLA contracts some products into FMAs; the port rounds each operator).
* ``quantize`` / ``dequantize``: bit for bit (``q`` and the bf16 scale's
  bits) on rows built to sit at the rounding edges (zero rows, ties at .5,
  ±127 after rounding, values a float32 ulp either side of a tie) and on
  random rows, with and without block padding.
* ``dsag_update`` with int8 slots over a scripted run: cache and pending
  ``q`` and scales, ``filled``, ``pending_valid`` and ξ exact; H and Ĥ
  within float32 rounding (``rtol=1e-5``, ``atol = 1e-5 · max|H|``): the
  port sums the groups' deltas in order, XLA's reduction may not.
* Live runs (traces replayed; int8 slots, adamw with bf16 slots, adafactor,
  PCA with int8 slots): mask / flush / evict streams, ``mask_count``, ξ and
  virtual times exact; losses within ``rtol=1e-4``.  The iterates drift
  apart by float32 rounding only until a rounding step of a quantized or
  bf16 slot falls differently (then by one step, 1/127 or 2⁻⁸ of a row's
  absmax), so the bound is the live tests' ``rtol=1e-5`` loosened tenfold,
  not more.
* Checkpoints: the manifest's ``paths`` and ``dtypes`` equal to the
  reference's for the same state; a checkpoint of either package restored
  by the other, and the resumed run's streams equal to the other package's
  resumed run from the same files, its losses within ``rtol=1e-4`` and its
  final iterate within ``rtol=1e-4``, ``atol = 1e-4 · max|V|``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.checkpoint import (
    CheckpointManager,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.configs.base import TrainConfig
from repro_torch.core.dsag_pjit import (
    CAP_MESH,
    GroupSpec,
    dsag_update,
    init_dsag_state,
    init_train_state,
)
from repro_torch.experiments.engine import EngineCapabilityError, EngineConfig
from repro_torch.experiments.grid import HEAVY_BURSTS
from repro_torch.kernels import dsag_update as k4
from repro_torch.latency.model import make_heterogeneous_cluster, sample_fleet
from repro_torch.core.problems import make_genomics_like_matrix, make_higgs_like
from repro_torch.launch.paper_jobs import paper_train_config
from repro_torch.launch.train import Trainer, TrainerOptions
from repro_torch.optim.compression import (
    Quantized,
    dequantize,
    quantization_error_bound,
    quantize,
)
from repro_torch.optim.optimizers import adafactor, adamw

REPO = Path(__file__).resolve().parents[1]
CPU = EngineConfig(device="cpu", kernel_backend="torch")
#: optimizer cases: parameter shapes
OPT_SHAPES = ((29,), (64, 3))
#: dsag_update script: groups, steps, the flush+evict step, parameter shapes
DU_P, DU_STEPS, DU_RACE = 6, 30, 12
DU_SHAPES = ((29,), (4, 3))
#: the live slice: (samples, groups, w, eta) per arch, as tests/test_torch_live.py
LIVE = {"logreg": (512, 8, 6, 0.25), "pca": (512, 8, 6, 0.9)}
LIVE_STEPS, LIVE_EVAL = 40, 5
#: live runs: tag -> (arch, TrainConfig fields over paper_train_config(eta))
LIVE_RUNS = {
    "int8": ("logreg", {"dsag_cache_dtype": "int8"}),
    "adamw": ("logreg", {"optimizer": "adamw", "learning_rate": 0.01, "beta1": 0.9,
                         "dsag_cache_dtype": "bfloat16"}),
    "adafactor": ("logreg", {"optimizer": "adafactor", "learning_rate": 0.05}),
    "pca_int8": ("pca", {"dsag_cache_dtype": "int8"}),
}
#: checkpointed runs: tag -> (arch, TrainConfig fields); saved every 10 of
#: CKPT_STEPS steps, then resumed to CKPT_STEPS + CKPT_MORE
CKPT_RUNS = {
    "logreg": ("logreg", {"optimizer": "adamw", "learning_rate": 0.01, "beta1": 0.9,
                          "dsag_cache_dtype": "int8", "checkpoint_every": 10}),
    "pca": ("pca", {"optimizer": "adafactor", "learning_rate": 0.05,
                    "dsag_cache_dtype": "bfloat16", "checkpoint_every": 10}),
}
CKPT_STEPS, CKPT_MORE = 20, 20
#: manifest cases: (optimizer, slot dtype, parameter shape)
MANIFESTS = (("adamw", "int8", (29,)), ("adafactor", "bfloat16", (64, 3)),
             ("sgd", "float32", (29,)), ("adafactor", "int8", (29,)))
TRACE_FIELDS = ("comm", "comp_unit", "slowdown", "burst_start", "burst_end", "burst_factor")

_REF_SCRIPT = r"""
import dataclasses, json, os, shutil, sys, tempfile
import jax, jax.experimental
jax.experimental.enable_x64 = jax.enable_x64
from jax.experimental import pallas as pl
pl.load = lambda ref, idx: ref[idx]
def _store(ref, idx, val):
    ref[idx] = val
pl.store = _store

import numpy as np
import jax.numpy as jnp
from repro.checkpoint.checkpoint import save_checkpoint
from repro.configs import TrainConfig
from repro.core.problems import (
    LogisticRegressionProblem, PCAProblem, make_genomics_like_matrix, make_higgs_like,
)
from repro.core.dsag_pjit import GroupSpec, dsag_update, init_dsag_state, init_train_state
from repro.experiments.grid import HEAVY_BURSTS
from repro.latency.model import make_heterogeneous_cluster, sample_fleet
from repro.launch.paper_jobs import paper_train_config
from repro.launch.train import Trainer, TrainerOptions
from repro.optim.compression import quantize, dequantize
from repro.optim.optimizers import adafactor, adamw

P = {params}
out = {{}}
rng = np.random.default_rng(21)
f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))

# -- one adamw and one adafactor update ---------------------------------------------------
for shape in P["opt_shapes"]:
    key = "x".join(map(str, shape))
    p = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    m = rng.normal(size=shape).astype(np.float32) * 0.1
    v = rng.random(shape).astype(np.float32) * 0.1 + 1e-3
    for name, a in (("p", p), ("g", g), ("m", m), ("v", v)):
        out[f"opt/{{key}}/{{name}}"] = a
    upd, st = adamw(0.01, weight_decay=0.1).update(
        jnp.asarray(g), {{"m": jnp.asarray(m), "v": jnp.asarray(v), "step": jnp.int32(3)}},
        jnp.asarray(p))
    out[f"opt/{{key}}/adamw/upd"] = f32(upd)
    out[f"opt/{{key}}/adamw/m"], out[f"opt/{{key}}/adamw/v"] = f32(st["m"]), f32(st["v"])
    if len(shape) >= 2:
        vr = rng.random(shape[:-1]).astype(np.float32) + 0.1
        vc = rng.random(shape[-1:]).astype(np.float32) + 0.1
        out[f"opt/{{key}}/vr"], out[f"opt/{{key}}/vc"] = vr, vc
        stats = {{"vr": jnp.asarray(vr), "vc": jnp.asarray(vc)}}
    else:
        stats = {{"v": jnp.asarray(v)}}
    upd, st = adafactor(0.05, weight_decay=0.01).update(
        jnp.asarray(g), {{"stats": stats, "step": jnp.int32(3)}}, jnp.asarray(p))
    out[f"opt/{{key}}/adafactor/upd"] = f32(upd)
    for k, a in st["stats"].items():
        out[f"opt/{{key}}/adafactor/{{k}}"] = f32(a)

# -- quantize at the rounding edges ---------------------------------------------------------
for name, (x, block) in P["quant"].items():
    x = np.asarray(x, np.float32)
    qx = quantize(jnp.asarray(x), block=block)
    out[f"quant/{{name}}/q"] = np.asarray(qx.q)
    out[f"quant/{{name}}/scale"] = f32(qx.scale)
    out[f"quant/{{name}}/deq"] = f32(dequantize(qx, jnp.float32))
    jq = jax.jit(lambda a: quantize(a, block=block))(jnp.asarray(x))
    out[f"quant/{{name}}/jit_q"] = np.asarray(jq.q)
    out[f"quant/{{name}}/jit_scale"] = f32(jq.scale)

# -- dsag_update with int8 slots over a scripted run ----------------------------------------
Pg, T, race = P["du"]
upd_fn = jax.jit(dsag_update)
for shape in P["du_shapes"]:
    key = "x".join(map(str, shape))
    tc = TrainConfig(dsag=True, dsag_cache_dtype="int8")
    st = init_dsag_state(jnp.zeros(shape, jnp.float32), GroupSpec(Pg, ()), tc)
    for t in range(T):
        g = rng.normal(size=(Pg,) + tuple(shape)).astype(np.float32) * (1 + t % 3)
        mask = rng.random(Pg) < 0.6
        flush = rng.random(Pg) < 0.4
        evict = rng.random(Pg) < 0.08
        if t == race - 1:
            mask[0] = False
        if t == race:
            mask[0], flush[0], evict[0] = False, True, True
        st, h_hat, xi = upd_fn(st, jnp.asarray(g), jnp.asarray(mask), jnp.asarray(flush),
                               jnp.asarray(evict))
        pre = f"du/{{key}}/{{t}}/"
        for name, a in (("g", g), ("mask", mask), ("flush", flush), ("evict", evict)):
            out[pre + name] = a
        out[pre + "h_hat"], out[pre + "xi"], out[pre + "h"] = f32(h_hat), f32(xi), f32(st["h"])
        for slot in ("cache", "pending"):
            out[pre + slot + "/q"] = np.asarray(st[slot].q)
            out[pre + slot + "/scale"] = f32(st[slot].scale)
        for name in ("pending_valid", "filled"):
            out[pre + name] = np.asarray(st[name])

# -- the manifests of a saved train state ----------------------------------------------------
for opt, dt, shape in P["manifests"]:
    tc = TrainConfig(optimizer=opt, dsag_cache_dtype=dt)
    state = init_train_state(jnp.zeros(shape, jnp.float32), tc, GroupSpec(4, ()))
    path = save_checkpoint(tempfile.mkdtemp(), 7, state)
    m = json.load(open(os.path.join(path, "manifest.json")))
    out[f"manifest/{{opt}}/{{dt}}/{{len(shape)}}"] = np.array(json.dumps([m["paths"], m["dtypes"]]))

# -- the live trainer, traces replayed ----------------------------------------------------
def live_opts(arch, fields, steps, **kw):
    n, G, w, eta = P["live"][arch]
    tr = traces[arch]
    tc = dataclasses.replace(paper_train_config(eta), **fields)
    return TrainerOptions(arch=arch, steps=steps, samples=n, num_groups=G, dsag_w=w,
                          method="dsag", traces=tr, scenario=0, train_config=tc,
                          simulate_stragglers=False, eval_every=P["eval"], log_every=10**6,
                          seed=0, **kw)

def record(pre, h):
    for f in ("mask_stream", "flush_stream", "evict_stream"):
        out[pre + f] = np.stack(h[f])
    for f in ("loss", "xi", "mask_count", "virtual"):
        out[pre + f] = np.asarray(h[f])

def final_params(d):
    steps = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    path = os.path.join(d, steps[-1])
    m = json.load(open(os.path.join(path, "manifest.json")))
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return z["a%d" % m["paths"].index("['params']")]

traces = {{}}
for arch, (n, G, w, eta) in P["live"].items():
    if arch == "logreg":
        Xa, ya = make_higgs_like(n, seed=0)
        pr = LogisticRegressionProblem(X=Xa, y=ya)
    else:
        pr = PCAProblem(X=make_genomics_like_matrix(n, 64, seed=0))
    cl = make_heterogeneous_cluster(G, seed=3, burst_rate=0.0,
                                    load_unit=pr.compute_cost(1, max(n // G, 1)))
    traces[arch] = sample_fleet(cl, 2, 4 * (P["ckpt"][0] + P["ckpt"][1]),
                                burst_rate=HEAVY_BURSTS.rate,
                                burst_factor_mean=HEAVY_BURSTS.factor_mean,
                                burst_duration_mean=HEAVY_BURSTS.duration_mean, seed=7)
    for f in P["trace_fields"]:
        out[f"traces/{{arch}}/{{f}}"] = getattr(traces[arch], f)

for tag, (arch, fields) in P["live_runs"].items():
    record(f"live/{{tag}}/", Trainer(live_opts(arch, fields, P["steps"])).run())

steps0, more = P["ckpt"]
for tag, (arch, fields) in P["ckpt_runs"].items():
    ref_dir = P["dirs"][f"ref/{{tag}}"]
    Trainer(live_opts(arch, fields, steps0, checkpoint_dir=ref_dir)).run()
    for src in ("ref", "port"):
        work = tempfile.mkdtemp()
        shutil.copytree(P["dirs"][f"{{src}}/{{tag}}"], work, dirs_exist_ok=True)
        h = Trainer(live_opts(arch, fields, steps0 + more, checkpoint_dir=work,
                              restore=True)).run()
        record(f"resume/{{tag}}/{{src}}/", h)
        out[f"resume/{{tag}}/{{src}}/params"] = final_params(work)
np.savez(sys.argv[1], **out)
"""


def _edge_rows() -> dict[str, tuple[np.ndarray, int]]:
    """Rows at quantize's rounding edges, and random rows."""
    rng = np.random.default_rng(3)
    rows = []
    base = np.zeros(29, np.float32)
    rows.append(base.copy())  # all zero: scale 1, q 0
    r = base.copy()
    r[:8] = [127.0, 0.5, -0.5, 1.5, -2.5, 63.5, -126.5, 3.0]  # scale 1: ties at .5
    rows.append(r)
    r = base.copy()
    r[:6] = [-127.0, 126.5, -126.5, 0.25, 2.5, 64.5]
    rows.append(r)
    for s in (2.0**-3, 3.0, 1e-20):  # scaled copies: exact ties again
        rows.append((rows[1] * np.float32(s)).astype(np.float32))
    r = rows[1].copy()  # a float32 ulp either side of the ties
    r[1:6] = np.nextafter(r[1:6], np.float32(np.inf))
    rows.append(r)
    r = rows[1].copy()
    r[1:6] = np.nextafter(r[1:6], np.float32(-np.inf))
    rows.append(r)
    r = base.copy()
    r[0] = 1.0  # a lone element: q = ±127
    r[1] = -1.0
    rows.append(r)
    rows += list(rng.normal(size=(20, 29)).astype(np.float32) * rng.uniform(1e-3, 1e3, (20, 1))
                 .astype(np.float32))
    x = np.stack(rows).astype(np.float32)
    padded = rng.normal(size=(3, 70)).astype(np.float32)
    padded[0, :32] = 0.0
    padded[1, 64:] = [127.0, 0.5, -0.5, 2.5, 63.5, -1.0]
    return {"rows": (x, 29), "padded": (padded, 32), "wide": (padded, 256)}


def _trainer_config(arch: str, fields: dict) -> TrainConfig:
    return dataclasses.replace(paper_train_config(LIVE[arch][3]), **fields)


def _port_traces(arch: str):
    n, G, _, _ = LIVE[arch]
    if arch == "logreg":
        prob = interop.problem_from_arrays("logreg", *make_higgs_like(n, seed=0))
    else:
        prob = interop.problem_from_arrays("pca", make_genomics_like_matrix(n, 64, seed=0))
    cl = make_heterogeneous_cluster(G, seed=3, burst_rate=0.0,
                                    load_unit=prob.compute_cost(1, max(n // G, 1)))
    return sample_fleet(cl, 2, 4 * (CKPT_STEPS + CKPT_MORE), burst_rate=HEAVY_BURSTS.rate,
                        burst_factor_mean=HEAVY_BURSTS.factor_mean,
                        burst_duration_mean=HEAVY_BURSTS.duration_mean, seed=7)


def _live_opts(arch: str, fields: dict, steps: int, traces, **kw) -> TrainerOptions:
    n, G, w, _ = LIVE[arch]
    return TrainerOptions(arch=arch, steps=steps, samples=n, num_groups=G, dsag_w=w,
                          method="dsag", traces=traces, scenario=0,
                          train_config=_trainer_config(arch, fields),
                          simulate_stragglers=False, eval_every=LIVE_EVAL, log_every=10**6,
                          seed=0, engine=CPU, **kw)


@pytest.fixture(scope="module")
def port_ckpt(tmp_path_factory):
    """The port's checkpoints, written before the reference restores them,
    and empty directories for the reference's."""
    root = tmp_path_factory.mktemp("ckpt")
    dirs = {}
    for tag, (arch, fields) in CKPT_RUNS.items():
        dirs[f"port/{tag}"] = str(root / f"port_{tag}")
        dirs[f"ref/{tag}"] = str(root / f"ref_{tag}")
        Trainer(_live_opts(arch, fields, CKPT_STEPS, _port_traces(arch),
                           checkpoint_dir=dirs[f"port/{tag}"])).run()
    return dirs


@pytest.fixture(scope="module")
def ref(tmp_path_factory, port_ckpt):
    """Every reference output of this module, from one JAX subprocess."""
    params = dict(
        opt_shapes=OPT_SHAPES, quant={k: (v[0].tolist(), v[1]) for k, v in _edge_rows().items()},
        du=(DU_P, DU_STEPS, DU_RACE), du_shapes=DU_SHAPES, manifests=MANIFESTS, live=LIVE,
        steps=LIVE_STEPS, eval=LIVE_EVAL, live_runs=LIVE_RUNS, ckpt_runs=CKPT_RUNS,
        ckpt=(CKPT_STEPS, CKPT_MORE), dirs=port_ckpt, trace_fields=TRACE_FIELDS,
    )
    path = tmp_path_factory.mktemp("jax_ckpt_reference") / "ref.npz"
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


def _close(got, want, rtol=1e-5, scale=1e-5):
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=scale * float(np.abs(want).max()))


def _ref_traces(ref, arch):
    return interop.traces_from_arrays(*(ref[f"traces/{arch}/{f}"] for f in TRACE_FIELDS))


# -- adamw and adafactor -------------------------------------------------------------


@pytest.mark.parametrize("shape", OPT_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_adamw_update_equals_reference(ref, shape):
    key = "opt/" + "x".join(map(str, shape)) + "/"
    state = {"m": _t(ref[key + "m"]), "v": _t(ref[key + "v"]),
             "step": torch.tensor(3, dtype=torch.int32)}
    upd, new = adamw(0.01, weight_decay=0.1).update(_t(ref[key + "g"]), state, _t(ref[key + "p"]))
    assert int(new["step"]) == 4 and upd.dtype == torch.float32
    np.testing.assert_allclose(upd.numpy(), ref[key + "adamw/upd"], rtol=1e-6)
    np.testing.assert_allclose(new["m"].numpy(), ref[key + "adamw/m"], rtol=1e-6)
    np.testing.assert_allclose(new["v"].numpy(), ref[key + "adamw/v"], rtol=1e-6)


@pytest.mark.parametrize("shape", OPT_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_adafactor_update_equals_reference(ref, shape):
    key = "opt/" + "x".join(map(str, shape)) + "/"
    opt = adafactor(0.05, weight_decay=0.01)
    init = opt.init(_t(ref[key + "p"]))
    factored = len(shape) >= 2
    assert set(init["stats"]) == ({"vr", "vc"} if factored else {"v"})
    stats = ({"vr": _t(ref[key + "vr"]), "vc": _t(ref[key + "vc"])} if factored
             else {"v": _t(ref[key + "v"])})
    upd, new = opt.update(_t(ref[key + "g"]), {"stats": stats,
                                              "step": torch.tensor(3, dtype=torch.int32)},
                          _t(ref[key + "p"]))
    np.testing.assert_allclose(upd.numpy(), ref[key + "adafactor/upd"], rtol=1e-6)
    for k, a in new["stats"].items():
        np.testing.assert_allclose(a.numpy(), ref[key + f"adafactor/{k}"], rtol=1e-6)


# -- int8 compression ------------------------------------------------------------------


@pytest.mark.parametrize("name", list(_edge_rows()))
def test_quantize_bit_equal_to_reference(ref, name):
    x, block = _edge_rows()[name]
    qx = quantize(torch.from_numpy(x), block=block)
    assert qx.q.dtype == torch.int8 and qx.scale.dtype == torch.bfloat16
    pre = f"quant/{name}/"
    for q_key, s_key in (("q", "scale"), ("jit_q", "jit_scale")):  # eager and jitted
        assert np.array_equal(qx.q.numpy(), ref[pre + q_key])
        assert np.array_equal(qx.scale.float().numpy(), ref[pre + s_key])
    assert np.array_equal(dequantize(qx, torch.float32).numpy(), ref[pre + "deq"])


def test_quantize_edges_hit_what_they_aim_at(ref):
    """The edge rows do reach ±127 and round ties to even."""
    q = ref["quant/rows/q"]
    assert q[1, :8].tolist() == [127, 0, 0, 2, -2, 64, -126, 3]
    assert (q[0] == 0).all() and q[8, 0] == 127 and q[8, 1] == -127


def test_quantize_roundtrip_bound_and_zeros():
    """The reference's compression properties (tests/test_checkpoint_ft.py)."""
    rng = np.random.default_rng(0)
    for n, scale, block in ((1, 1e-6, 64), (300, 1.0, 256), (1500, 1e6, 1024), (77, 3.0, 64)):
        x = torch.tensor(rng.normal(size=(n,)) * scale, dtype=torch.float32)
        back = dequantize(quantize(x, block=block), torch.float32)
        bound = np.repeat(quantization_error_bound(x, block).numpy(), block)[:n]
        assert (np.abs(back.numpy() - x.numpy())
                <= bound + 0.01 * np.abs(x.numpy()) + 1e-6).all()
    assert torch.equal(dequantize(quantize(torch.zeros(3, 512))).float(), torch.zeros(3, 512))
    q = quantize(torch.ones(4, 4096), block=256)
    assert q.q.numel() + q.scale.numel() * 2 < 4 * 4096 * 4 / 3.5


# -- the int8 DSAG cache ------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("shape", DU_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_int8_dsag_update_matches_reference_script(ref, shape, backend):
    key = "x".join(map(str, shape))
    st = init_dsag_state(torch.zeros(shape), GroupSpec(DU_P, ()),
                         TrainConfig(dsag_cache_dtype="int8"))
    assert st["cache"].block == shape[-1]
    assert st["cache"].scale.shape == (DU_P,) + tuple(shape[:-1]) + (1,)
    raced = False
    for t in range(DU_STEPS):
        p = f"du/{key}/{t}/"
        mask, flush, evict = (_t(ref[p + n]) for n in ("mask", "flush", "evict"))
        st, h_hat, xi = dsag_update(st, _t(ref[p + "g"]), mask, flush, evict, backend=backend)
        for slot in ("cache", "pending"):
            assert isinstance(st[slot], Quantized)
            assert np.array_equal(st[slot].q.numpy(), ref[p + slot + "/q"]), (t, slot)
            assert np.array_equal(st[slot].scale.float().numpy(), ref[p + slot + "/scale"]), (
                t, slot)
        for name in ("pending_valid", "filled"):
            assert np.array_equal(st[name].numpy(), ref[p + name]), (t, name)
        assert float(xi) == float(ref[p + "xi"])
        _close(st["h"].numpy(), ref[p + "h"])
        _close(h_hat.numpy(), ref[p + "h_hat"])
        # H == Σ_i dequantized cache_i
        _close(st["h"].numpy(), dequantize(st["cache"], torch.float32).sum(0).numpy())
        raced |= bool((flush & evict).any())
    assert raced


def test_int8_plain_update_by_rows():
    """The plain K4 int8 entry: each source, the pending rule, H in group order."""
    rng = np.random.default_rng(1)
    P, R, B = 4, 3, 5
    g = torch.tensor(rng.normal(size=(P, R, B)), dtype=torch.float32)
    c = quantize(torch.tensor(rng.normal(size=(P, R, B)), dtype=torch.float32), block=B)
    pe = quantize(torch.tensor(rng.normal(size=(P, R, B)), dtype=torch.float32), block=B)
    h = torch.tensor(rng.normal(size=(R, B)), dtype=torch.float32)
    code = torch.tensor([k4.KEEP, k4.TAKE_G | k4.TAKE_NEW, k4.TAKE_PENDING, k4.ZERO],
                        dtype=torch.uint8)
    cq, cs, pq, ps, nh = k4.dsag_cache_update_int8(g, c.q, c.scale[..., 0], pe.q,
                                                   pe.scale[..., 0], h, code)
    cf = dequantize(c, torch.float32)
    pf = dequantize(pe, torch.float32)
    new = torch.stack([cf[0], g[1], pf[2], torch.zeros(R, B)])
    want = quantize(new, block=B)
    assert torch.equal(cq, want.q) and torch.equal(cs, want.scale[..., 0])
    wp = quantize(torch.stack([pf[0], g[1], pf[2], pf[3]]), block=B)
    assert torch.equal(pq, wp.q) and torch.equal(ps, wp.scale[..., 0])
    deq = cq.float() * cs.float()[..., None]
    acc = torch.zeros(R, B)
    for i in range(P):
        acc = acc + (deq[i] - cf[i])
    assert torch.equal(nh, h + acc)
    with pytest.raises(ValueError):
        k4._check_int8(g, c.q, c.scale, pe.q, pe.scale[..., 0], h, code)  # scale not [p, rows]


# -- live runs -----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_live(ref):
    return {tag: Trainer(_live_opts(arch, fields, LIVE_STEPS, _ref_traces(ref, arch))).run()
            for tag, (arch, fields) in LIVE_RUNS.items()}


def _streams_equal(h, ref, pre):
    for f in ("mask_stream", "flush_stream", "evict_stream"):
        assert np.array_equal(np.stack(h[f]), ref[pre + f]), f
    assert np.array_equal(np.asarray(h["mask_count"]), ref[pre + "mask_count"])
    assert np.array_equal(np.asarray(h["xi"], dtype=np.float32),
                          ref[pre + "xi"].astype(np.float32))
    assert np.array_equal(np.asarray(h["virtual"]), ref[pre + "virtual"])


@pytest.mark.parametrize("tag", list(LIVE_RUNS))
def test_live_run_streams_exact_losses_close(ref, port_live, tag):
    h, pre = port_live[tag], f"live/{tag}/"
    _streams_equal(h, ref, pre)
    np.testing.assert_allclose(h["loss"], ref[pre + "loss"], rtol=1e-4)
    assert h["loss"][-1] < h["loss"][0]


def test_default_trainer_runs_adamw_with_bf16_slots():
    """``TrainerOptions()``'s own config (adamw, bf16 slots, live-sampled
    stragglers), as the reference's trainer runs it."""
    trn = Trainer(TrainerOptions(steps=6, engine=CPU))
    assert trn.opts.train_config.optimizer == "adamw"
    h = trn.run()
    assert len(h["loss"]) == 6 and set(trn.state["opt"]) == {"m", "v", "step"}
    assert trn.state["dsag"]["cache"].dtype == torch.bfloat16


# -- checkpoints ------------------------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones(2, dtype=torch.bfloat16),
                  "step": torch.tensor(7, dtype=torch.int32)}}
    path = save_checkpoint(str(tmp_path), 7, tree)
    restored = restore_checkpoint(path, tree)
    assert torch.equal(restored["a"], tree["a"])
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(restored["b"]["c"], tree["b"]["c"])
    assert torch.equal(restored["b"]["step"], tree["b"]["step"])


def test_checkpoint_quantized_state_roundtrips(tmp_path):
    q = quantize(torch.linspace(-3, 5, 512).reshape(2, 256))
    path = save_checkpoint(str(tmp_path), 1, {"cache": q})
    restored = restore_checkpoint(path, {"cache": q})
    assert torch.equal(q.q, restored["cache"].q) and torch.equal(q.scale, restored["cache"].scale)


def test_checkpoint_atomicity_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, {"w": torch.ones(4)}, blocking=True)
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]
    assert latest_checkpoint(str(tmp_path)).endswith("step_00000004")


def test_checkpoint_async_save_then_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tree = {"w": torch.full((8,), 3.0)}
    mgr.save(11, tree, blocking=False)
    restored, step = mgr.restore_latest(tree)
    assert step == 11 and torch.equal(restored["w"], tree["w"])


def test_checkpoint_restore_missing_returns_none(tmp_path):
    restored, step = CheckpointManager(str(tmp_path / "empty")).restore_latest({"w": torch.ones(1)})
    assert restored is None and step == -1


def test_checkpoint_shape_mismatch_and_mesh_refused(tmp_path):
    path = save_checkpoint(str(tmp_path), 0, {"w": torch.ones(4)})
    with pytest.raises(ValueError):
        restore_checkpoint(path, {"w": torch.ones(5)})
    with pytest.raises(EngineCapabilityError) as e:
        restore_checkpoint(path, {"w": torch.ones(4)}, shardings={"w": None})
    assert e.value.capability.code == CAP_MESH


@pytest.mark.parametrize("case", MANIFESTS, ids=lambda c: f"{c[0]}-{c[1]}-{len(c[2])}d")
def test_manifest_equals_reference(ref, tmp_path, case):
    opt, dt, shape = case
    tc = TrainConfig(optimizer=opt, dsag_cache_dtype=dt)
    state = init_train_state(torch.zeros(shape), tc, GroupSpec(4, ()))
    path = save_checkpoint(str(tmp_path), 7, state)
    m = json.loads((Path(path) / "manifest.json").read_text())
    assert [m["paths"], m["dtypes"]] == json.loads(str(ref[f"manifest/{opt}/{dt}/{len(shape)}"]))


@pytest.mark.parametrize("arch", list(LIVE))
def test_port_traces_equal_reference(ref, arch):
    """The checkpointed runs' traces, sampled by each package itself."""
    tr = _port_traces(arch)
    for f in TRACE_FIELDS:
        assert np.array_equal(getattr(tr, f), ref[f"traces/{arch}/{f}"]), f


@pytest.mark.parametrize("src", ["ref", "port"])
@pytest.mark.parametrize("tag", list(CKPT_RUNS))
def test_resume_across_packages(ref, port_ckpt, tmp_path, tag, src):
    """The port resumes from ``src``'s checkpoint files; the reference
    resumed from the same files: equal streams, close losses and iterate."""
    arch, fields = CKPT_RUNS[tag]
    work = tmp_path / "work"
    shutil.copytree(port_ckpt[f"{src}/{tag}"], work)
    assert latest_checkpoint(str(work)).endswith(f"step_{CKPT_STEPS - 1:08d}")
    trn = Trainer(_live_opts(arch, fields, CKPT_STEPS + CKPT_MORE, _ref_traces(ref, arch),
                             checkpoint_dir=str(work), restore=True))
    h = trn.run()
    pre = f"resume/{tag}/{src}/"
    assert len(h["loss"]) == CKPT_MORE
    _streams_equal(h, ref, pre)
    np.testing.assert_allclose(h["loss"], ref[pre + "loss"], rtol=1e-4)
    _close(trn.state["params"].numpy(), ref[pre + "params"], rtol=1e-4, scale=1e-4)
    slots = trn.state["dsag"]["cache"]
    if fields["dsag_cache_dtype"] == "int8":
        assert isinstance(slots, Quantized) and slots.q.dtype == torch.int8
    else:
        assert slots.dtype == torch.bfloat16


# -- on the card ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize(("P", "R", "B"), [
    (100, 1, 29), (50, 64, 3),  # the live logreg and paper-scale PCA slots
    (8, 1, 29), (3, 5, 70), (7, 3, 33), (1, 1, 1), (300, 2, 64),  # rows past a warp
])
def test_gpu_k4_int8_bit_equal_to_plain(card, P, R, B):
    rng = np.random.default_rng(P * 1000 + B)

    def f32(shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32, device=card)

    c, pe = quantize(f32((P, R, B)), block=B), quantize(f32((P, R, B)), block=B)
    code = torch.tensor(rng.integers(0, 8, size=P), dtype=torch.uint8, device=card)
    args = (f32((P, R, B)), c.q, c.scale[..., 0].contiguous(), pe.q,
            pe.scale[..., 0].contiguous(), f32((R, B)), code)
    before = k4.launch_counts["dsag_cache_update_int8"]
    got = k4.dsag_cache_update_int8(*args)
    want = k4.dsag_cache_update_int8_plain(*args)
    torch.cuda.synchronize()
    assert k4.launch_counts["dsag_cache_update_int8"] == before + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    on_cpu = k4.dsag_cache_update_int8_plain(*(a.cpu() for a in args))
    for a, b in zip(got, on_cpu):
        assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
def test_gpu_int8_trainer_checkpoint_roundtrip(card, tmp_path):
    """The live trainer with int8 slots on the card: saved every 10 steps,
    the latest restored equal to the saved tensors, then 10 more steps."""
    tc = dataclasses.replace(paper_train_config(0.25), dsag_cache_dtype="int8",
                             checkpoint_every=10)
    opts = TrainerOptions(arch="logreg", steps=20, num_groups=16, train_config=tc,
                          checkpoint_dir=str(tmp_path))
    trn = Trainer(opts)
    trn.run()
    saved = trn.state
    restored, step = trn.ckpt.restore_latest(trn.init_state())
    assert step == 19
    assert torch.equal(restored["dsag"]["cache"].q, saved["dsag"]["cache"].q)
    assert torch.equal(restored["dsag"]["cache"].scale, saved["dsag"]["cache"].scale)
    assert torch.equal(restored["params"], saved["params"])
    h = Trainer(dataclasses.replace(opts, steps=30, restore=True)).run()
    assert len(h["loss"]) == 10
