"""The reference's production DSAG layouts on a mesh: the ``zero``, ``pod``
and ``none`` groups, ``dsag=False``, int8 slots (K4-int8's split form, row
maxima MAX-reduced across a row's shards), adafactor over shards, and a mesh
trainer's checkpoints.

* **Against the reference's jitted mesh step** (one subprocess,
  ``tests/_ref_mesh_layouts.py``, on 8 fake XLA CPU devices with the jax-0.9
  shim, started with the module's first test and run beside the port's
  ranks): the float32 smoke models from the port's initial parameters, on
  the same seeded batches and Tier-2 bits, 2 steps (group 1 missing the
  second), for (a) ``TrainConfig(optimizer="adafactor", fsdp=True,
  dsag_cache_dtype="int8", dsag_groups="zero", dsag_num_groups=2)`` on
  (2, 4), (b) ``pod`` groups with int8 slots and adamw on (2, 2, 2), (c)
  ``none`` and ``dsag=False`` on (2, 4), and ``none`` for the VLM (its loss
  skips the image prefix) and enc-dec families: each group's batch is split
  over the data ranks, whose means average to the group's, since every
  slice predicts the same number of tokens.  Bounds: losses and per-group
  losses within 1e-5 relative, the gradient norm within 1e-4 (an int8 slot
  that rounds the other way moves H by one step of its row); ξ, mask
  counts, ``filled`` and ``pending_valid`` equal; the parameters' relative
  RMS over all leaves below 1e-4; every int8 slot element's dequantized
  value within one step (its row's scale) of the reference's; float slots
  and H within 1e-4 relative RMS.
* **Against the unsharded port**, the same bounds: ``dp`` groups with bf16
  slots and adafactor on (2, 2, 2); ``zero`` groups with bf16 slots and
  adamw on (2, 4).
* **Specs**: ``opt_state_specs`` and ``dsag_state_specs`` for adafactor and
  int8 slots under ``zero`` and ``pod``, all ten archs: the reference's.
* **K4-int8's split form** (plain): rows split over 2 and 4 shards, their
  row maxima MAX-reduced, equal bit for bit to the whole rows' update; on
  the card (``gpu``) the kernels against the plain twins at a split and at a
  whole row.
* **Checkpoints**: a mesh ``Trainer`` saves (gathered, rank 0 writes),
  restores by the state's specs and runs on, bit for bit its uninterrupted
  run; the mesh's file restores into the unsharded port leaf for leaf, and
  an unsharded checkpoint restores onto the mesh.
* **Collectives** by site (``count_cost``): the int8 row max, adafactor's
  means, ``pod``'s H all-reduce and the gradient mean over the inner axes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import _mesh_ranks as ranks  # noqa: E402

from repro_torch.checkpoint.checkpoint import (  # noqa: E402
    restore_checkpoint,
    save_checkpoint,
    train_state_from_tree,
    train_state_tree,
)
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.configs.base import MeshConfig, TrainConfig  # noqa: E402
from repro_torch.core.dsag_pjit import (  # noqa: E402
    GroupSpec,
    dsag_state_specs,
    init_train_state,
    make_group_spec,
    make_train_step,
    opt_state_specs,
)
from repro_torch.data import make_batch_iterator  # noqa: E402
from repro_torch.kernels import dsag_update as k4  # noqa: E402
from repro_torch.launch.mesh import RankPool  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim.compression import quantize  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
#: float32 agreement with the reference's jitted step and the unsharded port
RTOL = 1e-5
NORM_RTOL = 1e-4
PARAMS_RMS = 1e-4
#: bf16 slots, H and the moments built from them: the gradients' float32
#: rounding flips some slots' bf16 rounding, each by 2^-8 relative
BF16_SLOTS_RMS = 2.0**-8
#: after an adafactor or adamw update (each gradient element divided by its
#: own RMS, so a near-zero element's float32 rounding moves its parameter by
#: up to the step size), the next gradients differ by more than rounding in
#: rows whose values are tiny: int8 payloads more than one apart at most in
#: this share of elements, H within this relative RMS
INT8_FAR_SHARE = 1e-3
INT8_H_RMS = 1e-2
#: whisper-base's gradient norm and its gradients (the slots, H, the
#: moments): ill-conditioned at random init, its gradient moves ~2e-4
#: relative under float32 rounding alone, ~5e-3 after one adamw update
#: (the unsharded port against the reference too; ``tests/test_torch_registry.py``
#: holds its gradient by its own one-ulp spread for the same reason); its
#: losses and parameters keep the bounds above
ENC_DEC_TOL = (5e-3, 1e-2)
PROD = dict(fsdp=True, dsag=True, remat="full")
#: name -> (arch, mesh shape, TrainConfig fields, groups)
REF_CASES = {
    "a_zero_int8_adafactor": ("qwen2-7b", (2, 4), dict(
        PROD, optimizer="adafactor", dsag_cache_dtype="int8", dsag_groups="zero",
        dsag_num_groups=2), 2),
    "b_pod_int8_adamw": ("qwen2-7b", (2, 2, 2), dict(
        PROD, dsag_cache_dtype="int8", dsag_groups="pod"), 2),
    "c_none": ("qwen2-7b", (2, 4), dict(PROD, dsag_cache_dtype="float32",
                                         dsag_groups="none"), 1),
    "c_no_dsag": ("qwen2-7b", (2, 4), dict(PROD, dsag=False, dsag_groups="none"), 1),
    "vlm_none": ("pixtral-12b", (2, 4), dict(PROD, dsag_cache_dtype="float32",
                                              dsag_groups="none"), 1),
    "encdec_none": ("whisper-base", (2, 4), dict(PROD, dsag_cache_dtype="float32",
                                                  dsag_groups="none"), 1),
}
PORT_CASES = {
    "dp_bf16_adafactor": ("qwen2-7b", (2, 2, 2), dict(
        PROD, optimizer="adafactor", dsag_cache_dtype="bfloat16", dsag_groups="dp"), 4),
    "zero_bf16_adamw": ("qwen2-7b", (2, 4), dict(
        PROD, dsag_cache_dtype="bfloat16", dsag_groups="zero", dsag_num_groups=2), 2),
}
STEPS = 2
BATCH_PER_GROUP, SEQ = 4, 16


def _inputs(arch: str, groups: int):
    """The case's batches (the trainer's synthetic pipeline) and bits: every
    group fresh, then group 0 alone."""
    cfg = ranks.smoke_model(arch, "float32")[0]
    it = make_batch_iterator(cfg, groups, groups * BATCH_PER_GROUP, SEQ)
    batches = [next(it) for _ in range(STEPS)]
    ones, zeros = np.ones(groups, bool), np.zeros(groups, bool)
    first = np.zeros(groups, bool)
    first[0] = True
    return batches, [(ones, zeros, zeros), (first, zeros, zeros)]


def _init_params(arch: str) -> dict:
    _, model = ranks.smoke_model(arch, "float32")
    return ranks.state_by_path({"params": model.init(torch.Generator().manual_seed(0))})


@pytest.fixture(scope="module", autouse=True)
def ref_proc(tmp_path_factory):
    """The reference's runs, in a subprocess started with the module's first
    test (none where jax is not installed)."""
    if importlib.util.find_spec("jax") is None:
        yield None
        return
    tmp = tmp_path_factory.mktemp("ref_layouts")
    arrays, cases = {}, {}
    for arch in {c[0] for c in REF_CASES.values()}:
        arrays.update({f"{arch}/{k}": v for k, v in _init_params(arch).items()})
    for name, (arch, shape, fields, groups) in REF_CASES.items():
        batches, masks = _inputs(arch, groups)
        for i, (b, m) in enumerate(zip(batches, masks)):
            arrays.update({f"{name}/batch{i}/{k}": v for k, v in b.items()})
            arrays[f"{name}/bits{i}"] = np.stack(m)
        cases[name] = {"arch": arch, "shape": list(shape), "tc": fields, "steps": STEPS}
    np.savez(tmp / "inputs.npz", **arrays)
    (tmp / "cases.json").write_text(json.dumps(cases))
    # optimization level 0 compiles each step a third faster
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_backend_optimization_level=0")
    # XLA's partitioner warns at length: its output goes to a file, not a pipe
    with open(tmp / "log.txt", "w") as log:
        proc = subprocess.Popen([sys.executable, str(REPO / "tests" / "_ref_mesh_layouts.py"),
                                 str(tmp / "inputs.npz"), str(tmp / "cases.json"),
                                 str(tmp / "out.npz")],
                                env=env, stdout=log, stderr=subprocess.STDOUT)
    proc.out_path, proc.log_path = tmp / "out.npz", tmp / "log.txt"
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def ref(ref_proc):
    if ref_proc is None:
        pytest.fail("the reference needs jax, which is not installed")
    if ref_proc.wait(timeout=900) != 0:
        raise RuntimeError(f"reference subprocess failed:\n"
                           f"{ref_proc.log_path.read_text()[-4000:]}")
    with np.load(ref_proc.out_path) as f:
        out = {k: f[k] for k in f.files}
    out["specs"] = json.loads(out["specs"].tobytes().decode())
    return out


@pytest.fixture(scope="module")
def pool():
    """One gloo world of 8 CPU ranks: (2, 4) and (2, 2, 2) meshes over it."""
    with RankPool(8, "cpu", timeout=300) as p:
        yield p


def _tc(fields: dict) -> TrainConfig:
    return TrainConfig(**fields)


def _run(pool, arch, shape, fields, groups):
    batches, masks = _inputs(arch, groups)
    return pool.run(ranks.layout_run, arch, _tc(fields), shape, batches, masks)[0]


def _rel_rms(got: dict, want: dict, keys) -> float:
    d = sum(float(np.sum((got[k].astype(np.float64) - want[k]) ** 2)) for k in keys)
    n = sum(float(np.sum(want[k].astype(np.float64) ** 2)) for k in keys)
    return (d / n) ** 0.5 if n else d ** 0.5


def _held(got_metrics, got_states, want_metrics, want_states, what: str, fields: dict,
          norm_rtol: float = NORM_RTOL, grad_rms: float = PARAMS_RMS) -> None:
    """The module docstring's bounds: the metrics of each step, then the
    train state after each step."""
    for i, (g, w) in enumerate(zip(got_metrics, want_metrics)):
        for key in ("loss", "per_group_loss"):
            np.testing.assert_allclose(g[key], w[key], rtol=RTOL, atol=0,
                                       err_msg=f"{what} step {i} {key}")
        assert float(g["xi"]) == float(w["xi"]) and int(g["mask_count"]) == int(
            w["mask_count"]), (what, i)
        slack = norm_rtol * float(w["grad_norm"])
        h_keys = [k for k in want_states[i] if k.startswith("['dsag']/['h']")]
        if i and any(k.endswith(Q) for k in want_states[i]):
            # |‖Ĥ‖ - ‖Ĥ_ref‖| <= ‖H - H_ref‖ / (ξ P): the slots' rounding
            groups = want_states[i]["['dsag']/['filled']"].size
            slack += _dist(got_states[i], want_states[i], h_keys) / (float(w["xi"]) * groups)
        assert abs(float(g["grad_norm"]) - float(w["grad_norm"])) <= slack, (what, i)
    for i, (got, want) in enumerate(zip(got_states, want_states)):
        _held_state(got, want, f"{what} step {i}", fields, i == 0, grad_rms)


def _held_state(got: dict, want: dict, what: str, fields: dict, first: bool,
                grad_rms: float) -> None:
    assert sorted(got) == sorted(want), what
    for key in ("['dsag']/['filled']", "['dsag']/['pending_valid']", "['step']",
                "['opt']/['step']"):
        assert np.array_equal(got[key], want[key]), (what, key)
    params = [k for k in want if k.startswith("['params']")]
    assert _rel_rms(got, want, params) < PARAMS_RMS, what
    slots = [k for k in want if k.startswith(("['dsag']/['cache']", "['dsag']/['pending']"))]
    q_keys = [k for k in slots if k.endswith(Q)]
    h_keys = [k for k in want if k.startswith("['dsag']/['h']")]
    if not q_keys:  # float slots: the slots, H and the optimizer's state
        opt = [k for k in want if k.startswith("['opt']") and not k.endswith("['step']")]
        bound = BF16_SLOTS_RMS if fields.get("dsag_cache_dtype") == "bfloat16" else grad_rms
        for keys in (slots, h_keys, opt):
            assert _rel_rms(got, want, keys) < bound, what
        return
    if not first:  # int8 after an update: see the module docstring
        far = sum(int(np.sum(np.abs(got[k].astype(np.int32) - want[k]) > 1)) for k in q_keys)
        assert far <= INT8_FAR_SHARE * sum(want[k].size for k in q_keys), (what, far)
        assert _rel_rms(got, want, h_keys) < INT8_H_RMS, what
        return
    for qk in q_keys:  # int8: each element within one step of the reference's
        sk = qk[:-len(Q)] + S
        assert np.abs(got[qk].astype(np.int32) - want[qk]).max() <= 1, (what, qk)
        assert np.all(np.abs(got[sk] - want[sk]) <= _bf16_ulp(np.maximum(got[sk], want[sk]))), (
            what, sk)
        a = got[qk].astype(np.float64) * got[sk]
        b = want[qk].astype(np.float64) * want[sk]
        assert np.all(np.abs(a - b) <= _step(got, want, sk)), (what, qk)
    for hk in h_keys:  # H is the sum of the stored cache: within the groups' steps
        sk = "['dsag']/['cache']" + hk[len("['dsag']/['h']"):] + "/" + S
        bound = _step(got, want, sk).sum(axis=0)
        scale = np.abs(want[hk]).max()
        assert np.all(np.abs(got[hk] - want[hk].astype(np.float64)) <= bound + RTOL * scale), (
            what, hk)


Q, S = "[<flat index 0>]", "[<flat index 1>]"


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bfloat16 ulp at ``x`` (8 significant bits)."""
    return np.exp2(np.floor(np.log2(np.maximum(x, np.finfo(np.float32).tiny))) - 7)


def _step(got_state, want_state, scale_key) -> np.ndarray:
    """The most two int8 slot elements may differ by: a payload one apart,
    and the bf16 row scales one bf16 ulp apart (the float32 scale of a row
    whose absmax moves by float32 rounding can round to the neighbouring
    bf16 value), ``s + 127 ulp(s)`` for the larger scale ``s``."""
    s = np.maximum(got_state[scale_key], want_state[scale_key]).astype(np.float64)
    return (s + 127 * _bf16_ulp(s)) * (1 + 1e-6)


def _dist(got: dict, want: dict, keys) -> float:
    return sum(float(np.sum((got[k].astype(np.float64) - want[k]) ** 2)) for k in keys) ** 0.5


def _ref_case(ref, name):
    pre = f"{name}/"
    metrics = [{k.split("/")[-1]: ref[k] for k in ref if k.startswith(f"{pre}metrics{i}/")}
               for i in range(STEPS)]
    states = [{k[len(f"{pre}state{i}/"):]: v for k, v in ref.items()
               if isinstance(v, np.ndarray) and k.startswith(f"{pre}state{i}/")}
              for i in range(STEPS)]
    return metrics, states


def _unsharded(arch, fields, groups, batches, masks):
    """The unsharded port's step on the same inputs: metrics and the final
    state by checkpoint path."""
    _, model = ranks.smoke_model(arch, "float32")
    tc = _tc(fields)
    gs = GroupSpec(groups, ())
    step = make_train_step(lambda p, b: model.train_loss(p, b, remat=tc.remat), tc, gs,
                           backend="torch", layout=model.layout)
    state = init_train_state(model.layout.flatten(model.init(torch.Generator().manual_seed(0))),
                             tc, gs, model.layout)
    out, states = [], []
    for b, m in zip(batches, masks):
        state, met = step(state, {k: torch.as_tensor(v) for k, v in b.items()},
                          *(torch.as_tensor(x) for x in m))
        out.append({k: np.asarray(v) for k, v in met.items()})
        states.append(ranks.state_by_path(train_state_tree(state, model.layout)))
    return out, states, state, model


@pytest.mark.parametrize("name", PORT_CASES)
def test_mesh_layouts_equal_the_unsharded_port(pool, name):
    arch, shape, fields, groups = PORT_CASES[name]
    got, states, _ = _run(pool, arch, shape, fields, groups)
    want, want_states, _, _ = _unsharded(arch, fields, groups, *_inputs(arch, groups))
    _held(got, states, want, want_states, name, fields)


def _int8_args(rng, p, rows, b):
    def f32(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32)

    c, pe = quantize(f32(p, rows, b), block=b), quantize(f32(p, rows, b), block=b)
    code = torch.as_tensor(rng.integers(0, 8, size=p), dtype=torch.uint8)
    return (f32(p, rows, b), c.q, c.scale[..., 0].contiguous(), pe.q,
            pe.scale[..., 0].contiguous(), f32(rows, b), code)


def _split_update(args, shards, row_max, update):
    """K4-int8's split form over ``shards`` column shards of every row: each
    shard's row maxima, their max (the MAX all-reduce), each shard's update;
    the shards' outputs put back together."""
    b = args[0].shape[-1] // shards
    parts = [tuple(a[..., i * b:(i + 1) * b].contiguous() if a.dim() >= 2 and a.dtype in (
        torch.float32, torch.int8) else a for a in args) for i in range(shards)]
    maxima = [row_max(*part[:5], part[6]) for part in parts]
    cmax = torch.stack([m[0] for m in maxima]).amax(0)
    pmax = torch.stack([m[1] for m in maxima]).amax(0)
    outs = [update(*part, (cmax, pmax)) for part in parts]
    for o in outs[1:]:  # every shard writes its rows' one scale
        assert torch.equal(o[1], outs[0][1]) and torch.equal(o[3], outs[0][3])
    return (torch.cat([o[0] for o in outs], -1), outs[0][1],
            torch.cat([o[2] for o in outs], -1), outs[0][3], torch.cat([o[4] for o in outs], -1))


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize(("p", "rows", "b"), [(2, 3, 64), (4, 1, 1024), (1, 24, 96)])
def test_k4_int8_split_form_equals_the_whole_rows(p, rows, b, shards):
    args = _int8_args(np.random.default_rng(p * 100 + b + shards), p, rows, b)
    want = k4.dsag_cache_update_int8_plain(*args)
    got = _split_update(args, shards, k4.dsag_int8_row_max_plain, k4.dsag_cache_update_int8_plain)
    for name, a, w in zip(("cache q", "cache scale", "pending q", "pending scale", "h"), got, want):
        assert a.dtype == w.dtype and torch.equal(a, w), name
    # the wrappers on CPU tensors are the plain twins
    got = _split_update(args, shards, k4.dsag_int8_row_max, k4.dsag_cache_update_int8)
    assert all(torch.equal(a, w) for a, w in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_gpu_k4_int8_split_form_equals_its_plain_twin(shards):
    """The row-max kernel and the update given maxima against their plain
    twins on the card, at a split row (2, 4 shards) and at a whole row (1:
    the row-max pass feeding the split form, and the kernel's own maxima)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = _int8_args(np.random.default_rng(shards), 3, 40, 512)
    on_card = tuple(a.cuda() for a in args)
    before = dict(k4.launch_counts)
    got = _split_update(on_card, shards, k4.dsag_int8_row_max, k4.dsag_cache_update_int8)
    torch.cuda.synchronize()
    assert k4.launch_counts["dsag_int8_row_max"] == before["dsag_int8_row_max"] + shards
    want = _split_update(args, shards, k4.dsag_int8_row_max_plain,
                         k4.dsag_cache_update_int8_plain)
    whole = k4.dsag_cache_update_int8(*on_card)
    for a, w, u in zip(got, want, whole):
        assert torch.equal(a.cpu(), w) and torch.equal(u.cpu(), w)


def test_mesh_checkpoints_resume_and_cross_the_unsharded_trainer(pool, tmp_path):
    """Layout (a) on (2, 4), 4 steps: saved after 2 and resumed, bit for bit
    the uninterrupted run; the file restores into the unsharded port equal
    leaf for leaf to the gathered mesh state; an unsharded checkpoint
    restores onto the mesh leaf for leaf."""
    arch, shape, fields, groups = REF_CASES["a_zero_int8_adafactor"]
    tc = dataclasses.replace(_tc(fields), checkpoint_every=10**6)
    cfg = ranks.smoke_model(arch, "float32")[0]
    it = make_batch_iterator(cfg, groups, groups * BATCH_PER_GROUP, SEQ, seed=1)
    batches = [next(it) for _ in range(4)]
    z = np.zeros(groups, bool)
    masks = [(np.ones(groups, bool), z, z), (np.array([1, 0], bool), z, z),
             (np.array([0, 1], bool), np.array([0, 0], bool), z),
             (np.array([1, 0], bool), np.array([0, 1], bool), z)]
    # the unsharded trainer's checkpoint after 2 steps, for the mesh to restore
    _, want_states, state, model = _unsharded(arch, fields, groups, batches[:2], masks[:2])
    want_state = want_states[-1]
    save_checkpoint(str(tmp_path / "plain"), 1, train_state_tree(state, model.layout))
    same, loop_steps, saved, other = pool.run(
        ranks.checkpoint_resume, arch, tc, shape, batches, masks, str(tmp_path / "mesh"),
        str(tmp_path / "plain"))[0]
    assert same and loop_steps == 2
    assert (tmp_path / "mesh" / "loop" / "step_00000001").is_dir()
    assert sorted(other) == sorted(want_state)
    assert all(np.array_equal(other[k], want_state[k]) for k in want_state)
    # the mesh's file into the unsharded port
    like = init_train_state(model.layout.flatten(model.init(torch.Generator().manual_seed(0))),
                            tc, GroupSpec(groups, ()), model.layout)
    back = restore_checkpoint(str(tmp_path / "mesh" / "step_00000001"),
                              train_state_tree(like, model.layout))
    flat = train_state_from_tree(back, model.layout)
    got = ranks.state_by_path(train_state_tree(flat, model.layout))
    assert sorted(got) == sorted(saved)
    assert all(np.array_equal(got[k], saved[k]) for k in saved)


# -- against the reference (its subprocess ran beside the tests above) -------------------


@pytest.mark.parametrize("name", REF_CASES)
def test_mesh_step_equals_the_reference_jitted_step(pool, ref, name):
    arch, shape, fields, groups = REF_CASES[name]
    got, states, sites = _run(pool, arch, shape, fields, groups)
    want, want_states = _ref_case(ref, name)
    _held(got, states, want, want_states, name, fields,
          *(ENC_DEC_TOL if arch == "whisper-base" else (NORM_RTOL, PARAMS_RMS)))
    # the collectives of each layout, by site (count_cost, last step)
    want_sites = {"a_zero_int8_adafactor": ("int8 row max: all-reduce",
                                            "adafactor means: all-reduce",
                                            "gradient mean: reduce-scatter"),
                  "b_pod_int8_adamw": ("int8 row max: all-reduce", "H sum: all-reduce",
                                       "gradient mean: reduce-scatter"),
                  "c_none": ("gradient mean: reduce-scatter",)}.get(name, ())
    assert set(want_sites) <= set(sites), (name, sorted(sites))
    assert not any(s.startswith("H sum") for s in sites) or "pod" in name
    if not fields["dsag"]:
        assert not any(s.startswith(("H sum", "int8 row max")) for s in sites)


def test_state_specs_for_adafactor_and_int8_equal_the_reference(ref):
    from test_torch_mesh import _ser

    meshes = {"zero": MeshConfig((2, 4), ("data", "model")),
              "pod": MeshConfig((2, 2, 4), ("pod", "data", "model"))}
    for arch in ARCHS:
        specs = build_model(get_config(arch), kernel_backend="torch").param_specs(True)
        for groups, mesh in meshes.items():
            tc = TrainConfig(optimizer="adafactor", dsag_cache_dtype="int8",
                             dsag_groups=groups, dsag_num_groups=2)
            gs = make_group_spec(tc, mesh)
            want = ref["specs"][f"{arch}/{groups}"]
            assert [gs.num_groups, list(gs.axes)] == want["gs"], (arch, groups)
            assert _ser(opt_state_specs(tc, specs)) == want["opt"], (arch, groups)
            assert _ser(dsag_state_specs(tc, gs, specs)) == want["dsag"], (arch, groups)
