"""The dry run (``repro_torch.launch.dryrun``): one step of a cell counted
on rank 0 of a fake world over meta tensors.

* **Against the reference** (one subprocess, ``tests/_ref_dryrun.py``, on 8
  host devices at ``--xla_backend_optimization_level=0`` with the jax-0.9
  shim, started with the module's first test): ``cell_is_runnable`` over
  every arch and shape; ``input_specs`` (shapes, dtypes, specs, without a
  mesh and on the 16x16 and 2x16x16 axes) for one arch of each family;
  ``default_train_config`` at every arch's published size, single and
  multi-pod; ``sanitize_spec`` and the grouped batch on the production
  meshes; ``derive``'s model FLOPs per device.  All exact.
* **The dry run equals a concrete run**: the smoke qwen1.5-0.5b on a (2, 2)
  mesh, dry (``dry_run("plain")``, a fake world of 4) against rank 0 of the
  same step really run by 4 gloo CPU ranks (``RankPool``): FLOPs, bytes,
  every row (calls, FLOPs, bytes), the collectives by kind and by site and
  ``argument_bytes``, equal, for a train step of each layout the default
  config picks (``dp`` with bf16 slots; ``zero`` with int8 slots and
  adafactor), a prefill and a decode step.
* **Against XLA's count** of the same smoke cells compiled on (2, 4)
  (``hlo.analyze_hlo``): with 16 kv heads (split over ``model``) the train
  step's and the prefill's product FLOPs per device equal XLA's within
  1 %; with the smoke config's 4 (kv weights replicated, as the rules leave
  them) too in training, where each rank projects the kv heads it reads,
  as XLA does; the port's served prefill projects every kv head (its cache
  is split over the sequence), and its excess is exactly those products.
  The kinds of collectives differ (XLA turns reshards into all-to-alls,
  ``PERF.md``).
* **The loss** keeps the vocab split on a mesh: no all-gather at its site
  and a lower peak than with the logits replicated.
* **Production cells** on 16x16: one cheap cell per kind (a decode, the SSM's
  long context, grok-1's train step at one layer) through ``run_cell``;
  every runnable cell (32) is ``test_every_production_cell`` (``slow``:
  several minutes; it runs where ``DRYRUN_ALL_CELLS=1`` is set).
* **Guards**: a meta tensor at K4, K4-int8 or K6 outside a dry run raises,
  and at a kernel with no count-only path inside ``dry_run("card")``;
  inside it, K4, K4-int8 and K6 report their cost models, return meta
  outputs and add nothing to their launch counts; the module imports
  neither ``jax`` nor ``repro``.
"""

from __future__ import annotations

import ast
import contextlib
import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import kernel_costs, roofline
from repro_torch.analysis.cost import Cost, count_cost
from repro_torch.configs import ARCHS, SHAPES, cell_is_runnable, get_config, get_smoke_config, \
    input_specs
from repro_torch.configs.base import MeshConfig, ShapeConfig
from repro_torch.core.dsag_pjit import make_group_spec
from repro_torch.kernels import _build, dsag_update, flash_attention, launch_counts
from repro_torch.kernels.block_sub import logreg_block_sub
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import RankPool
from repro_torch.models import build_model
from repro_torch.models.sharding import P

REPO = Path(__file__).resolve().parents[1]
MESHES = {"16x16": MeshConfig((16, 16), ("data", "model")),
          "2x16x16": MeshConfig((2, 16, 16), ("pod", "data", "model"))}
#: the smoke cell of the concrete and XLA comparisons (tests/_ref_dryrun.py)
ARCH = "qwen1.5-0.5b"
SMOKE = {"train": ShapeConfig("smoke", 64, 8, "train"),
         "prefill": ShapeConfig("smoke", 64, 4, "prefill"),
         "decode": ShapeConfig("smoke", 64, 4, "decode")}
XLA_CELLS = {"smoke": {}, "kv16": {"num_heads": 16, "num_kv_heads": 16}}


@pytest.fixture(scope="module", autouse=True)
def ref_proc(tmp_path_factory):
    """The reference subprocess, started at the module's first test (none
    where jax is not installed)."""
    if importlib.util.find_spec("jax") is None:
        yield None
        return
    out = tmp_path_factory.mktemp("ref_dryrun") / "ref.json"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_backend_optimization_level=0")
    proc = subprocess.Popen([sys.executable, str(REPO / "tests" / "_ref_dryrun.py"), str(out)],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    proc.out_path = out
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ref(ref_proc):
    if ref_proc is None:
        pytest.fail("the reference needs jax, which is not installed")
    log, _ = ref_proc.communicate(timeout=600)
    if ref_proc.returncode != 0:
        raise RuntimeError(f"reference subprocess failed:\n{log[-4000:]}")
    return json.loads(ref_proc.out_path.read_text())


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, "cpu", timeout=300) as p:
        yield p


def _entry(e):
    if isinstance(e, tuple):
        return list(e) if len(e) > 1 else e[0]
    return e


def _spec(spec):
    return None if spec is None else [_entry(e) for e in tuple(spec)]


def _dtype(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


# -- the guards (run while the reference computes) ---------------------------------------


def _k4_meta(p=4, n=1000):
    m = dict(device="meta")
    return (torch.empty(p, n, dtype=torch.bfloat16, **m),
            torch.empty(p, n, dtype=torch.bfloat16, **m), torch.empty(n, **m),
            torch.empty(p, **m))


def _int8_meta(p=2, rows=6, b=32):
    m = dict(device="meta")
    return (torch.empty(p, rows, b, **m), torch.empty(p, rows, b, dtype=torch.int8, **m),
            torch.empty(p, rows, dtype=torch.bfloat16, **m),
            torch.empty(p, rows, b, dtype=torch.int8, **m),
            torch.empty(p, rows, dtype=torch.bfloat16, **m))


def _qkv_meta(b=2, s=128, h=4, kvh=2, d=96):
    m = dict(device="meta", dtype=torch.bfloat16)
    return (torch.empty(b, s, h, d, **m), torch.empty(b, s, kvh, d, **m),
            torch.empty(b, s, kvh, d, **m))


def test_meta_tensors_at_a_kernel_raise_outside_a_dry_run():
    code = torch.zeros(2, dtype=torch.uint8, device="meta")
    g, cq, cs, pq, ps = _int8_meta()
    h = torch.empty(6, 32, device="meta")
    calls = [lambda: dsag_update.dsag_cache_update(*_k4_meta()),
             lambda: dsag_update.dsag_cache_update_int8(g, cq, cs, pq, ps, h, code),
             lambda: dsag_update.dsag_int8_row_max(g, cq, cs, pq, ps, code),
             lambda: flash_attention.flash_attention_bshd(*_qkv_meta())]
    for call in calls:
        with pytest.raises(ValueError, match="only inside a dry run"):
            call()
    # a kernel without a count-only path is refused inside the card mode too
    with _build.dry_run("card"), pytest.raises(ValueError, match="no count-only path"):
        logreg_block_sub(*(torch.empty(s, device="meta") for s in ((8, 3), (8,), (2, 3))),
                         torch.ones(2, dtype=torch.int64, device="meta"),
                         torch.ones(2, dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError, match="dry-run mode"):
        with _build.dry_run("cuda"):
            pass


def test_card_mode_counts_each_kernel_by_its_cost_model():
    """Inside ``dry_run("card")`` K4, K4-int8 (whole and split, with the
    row-max pass) and K6 (at a padded head dim) check their meta operands,
    return meta outputs of the launch's shapes, report their cost models
    and launch nothing; the K6 wrapper's pad and copy are torch ops, billed
    as for a launch."""
    before = launch_counts()
    g, cq, cs, pq, ps = _int8_meta()
    h = torch.empty(6, 32, device="meta")
    code = torch.zeros(2, dtype=torch.uint8, device="meta")
    q, k, v = _qkv_meta()
    out: dict = {}

    def run():
        out["k4"] = dsag_update.dsag_cache_update(*_k4_meta())
        out["max"] = dsag_update.dsag_int8_row_max(g, cq, cs, pq, ps, code)
        out["split"] = dsag_update.dsag_cache_update_int8(g, cq, cs, pq, ps, h, code, out["max"])
        out["whole"] = dsag_update.dsag_cache_update_int8(g, cq, cs, pq, ps, h, code)
        out["k6"] = flash_attention.flash_attention_bshd(q, k, v, causal=True)

    with _build.dry_run("card"):
        cost = count_cost(run)
    assert launch_counts() == before
    assert [tuple(t.shape) for t in out["k4"]] == [(4, 1000), (1000,)]
    assert [tuple(t.shape) for t in out["whole"]] == [(2, 6, 32), (2, 6), (2, 6, 32), (2, 6),
                                                       (6, 32)]
    assert out["k6"].shape == q.shape and out["k6"].is_meta
    rows = cost.rows
    assert (rows["dsag_cache_update"].calls, rows["dsag_cache_update"].bytes) == (
        1, kernel_costs.dsag_cache_update_cost(4, 1000, 2)[0])
    split, whole = (kernel_costs.dsag_cache_update_int8_cost(2, 6, 32, split=s) for s in (1, 0))
    assert rows["dsag_cache_update_int8"].calls == 2
    assert rows["dsag_cache_update_int8"].bytes == split[0] + whole[0]
    assert rows["dsag_int8_row_max"].flops == kernel_costs.dsag_int8_row_max_cost(2, 6, 32)[1]
    want = kernel_costs.flash_attention_cost(2, 4, 2, 128, 128, 96, True, torch.bfloat16)
    assert (rows["flash_attention"].calls, rows["flash_attention"].flops) == (1, want[1])
    assert "aten.constant_pad_nd" in rows and "aten.copy_" in rows  # d = 96 runs at 128


#: _build.route's cases: (devices of the operands, dry-run mode, counts=) ->
#: its answer, or the error it raises
ROUTES = {
    "cpu": (("cpu", "cpu"), None, False, "plain"),
    "cpu in a dry run": (("cpu",), "card", True, "plain"),
    "meta outside a dry run": (("meta",), None, True, "only inside a dry run"),
    "meta, plain mode": (("meta", "meta"), "plain", False, "plain"),
    "meta, card mode, a count-only path": (("meta", "meta"), "card", True, "count"),
    "meta, card mode, no count-only path": (("meta",), "card", False, "no count-only path"),
    "mixed": (("cpu", "meta"), "plain", True, "mixed"),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_route_decides_every_wrapper(case):
    """``_build.route`` is the one place a wrapper (and ``_attend``) learns
    where its operands go: the plain twin, a launch, or a dry run's count."""
    devices, mode, counts, want = ROUTES[case]
    tensors = [torch.empty(2, device=d) for d in devices]
    ctx = _build.dry_run(mode) if mode else contextlib.nullcontext()
    with ctx:
        if want in ("plain", "launch", "count"):
            assert _build.route(*tensors, counts=counts) == want
        else:
            with pytest.raises(ValueError, match=want):
                _build.route(*tensors, counts=counts)


def test_attend_sends_meta_tensors_where_the_dry_run_says():
    """``_attend`` on meta tensors: K6's count under ``"card"``, the plain
    path (no K6 row) under ``"plain"``, a refusal outside a dry run."""
    from repro_torch.models.attention import _attend

    q, k, v = _qkv_meta()
    with pytest.raises(ValueError, match="only inside a dry run"):
        _attend(q, k, v, causal=True)
    for mode, k6 in (("card", 1), ("plain", 0)):
        with _build.dry_run(mode):
            cost = count_cost(lambda: _attend(q, k, v, causal=True))
        row = cost.rows.get("flash_attention")
        assert (row.calls if row else 0) == k6, mode


#: tp_contract's operands on a 1-D mesh of 2: (subscript, x's shape and split
#: dim, w's shape and split dim) -> whether it contracts the split dim
SPLITS = {
    "the contracted dim": ("bsf,fd->bsd", (2, 4, 6), 2, (6, 3), 0, True),
    "under an ellipsis": ("...f,fd->...d", (2, 4, 6), 2, (6, 3), 0, True),
    "x on a kept dim": ("bsf,fd->bsd", (2, 4, 6), 1, (6, 3), 0, False),
    "x on a dim under the ellipsis": ("...f,fd->...d", (2, 4, 6), 0, (6, 3), 0, False),
    "w on a kept dim": ("bsf,fd->bsd", (2, 4, 6), 2, (6, 4), 1, False),
    "both on a kept dim": ("ef,efd->ed", (4, 6), 0, (4, 6, 3), 0, False),
}


@pytest.mark.parametrize("case", list(SPLITS))
def test_tp_contract_takes_only_a_split_contraction(case):
    """``tp_contract`` sums each rank's local product over the ranks only
    where x and w are split on the dim the subscript contracts; split on a
    kept dim it raises (that sum would add the ranks' rows)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.models.layers import tp_contract

    sub, xs, xd, ws, wd, ok = SPLITS[case]
    with dryrun.fake_world(2):
        mesh = dryrun.make_test_mesh((1, 2), device_type="cpu")["model"]

        def split(shape, dim):
            local = list(shape)
            local[dim] //= 2
            return DTensor.from_local(torch.ones(local), mesh, [Shard(dim)], run_check=False)

        x, w = split(xs, xd), split(ws, wd)
        if ok:
            out = tp_contract(sub, x, w)
            assert list(out.placements) == [Replicate()]
            assert out.shape == torch.einsum(sub, torch.ones(xs), torch.ones(ws)).shape
        else:
            with pytest.raises(ValueError, match="split on the contracted dim"):
                tp_contract(sub, x, w)


def test_the_bookkeeping_modules_are_in_this_torch():
    """``count_cost`` leaves out the ops of torch's bookkeeping modules by
    their source files: a torch that moved one would count its ops again
    without an error, so each must resolve (``chip_smoke.py`` phase 20
    checks the card's torch the same way)."""
    from repro_torch.analysis import cost as cost_mod

    assert cost_mod.missing_bookkeeping() == []
    assert len(cost_mod._BOOKKEEPING) == len(cost_mod.BOOKKEEPING_MODULES)
    for name in cost_mod.BOOKKEEPING_MODULES:
        assert importlib.import_module(name).__file__ in cost_mod._BOOKKEEPING


def test_the_dry_run_imports_neither_jax_nor_repro():
    tree = ast.parse(Path(dryrun.__file__).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert not [m for m in names if m.split(".")[0] in ("jax", "repro")], names
    code = ("import sys, repro_torch.launch.dryrun\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env=dict(os.environ, PYTHONPATH=str(REPO / "src")))


def test_derive_bills_the_collectives_at_the_link_rate():
    cfg, shape = get_config(ARCH), SHAPES["train_4k"]
    cost = Cost(flops=989e9, bytes=3.35e9, flops_at_peak={roofline.PEAK_BF16: 989e9})
    cost.add_collective("all-reduce", 2e9, "model", result=1.6e9, operand=1.6e9)
    cost.add_collective("all-gather", 1e9, "degather", result=1.2e9, operand=0.3e9)
    rl = roofline.derive(cfg, shape, 10**9, cost, num_devices=256)
    assert roofline.LINK_BW == kernel_costs.LINK_BW == 50e9
    assert rl.collective_s == pytest.approx(3e9 / 50e9, rel=1e-12)
    assert (rl.dominant, rl.step_time_s) == ("collective", rl.collective_s)
    assert rl.collectives == {
        "counts": {"all-reduce": 1, "all-gather": 1},
        "result_bytes": {"all-reduce": 1.6e9, "all-gather": 1.2e9},
        "operand_bytes": {"all-reduce": 1.6e9, "all-gather": 0.3e9},
        "wire_bytes": {"all-reduce": 2e9, "all-gather": 1e9},
        "total_operand_bytes": 1.9e9, "total_wire_bytes": 3e9}
    assert rl.model_flops_per_device == 6.0 * 10**9 * 256 * 4096 / 256


def test_one_query_head_per_rank_trains():
    """The backward at one query head per rank (qwen1.5-0.5b's 16 heads on
    16x16): einsum's backward views a transposed DTensor cotangent, which
    raised until the projections' cotangents were made contiguous
    (``models/attention.py::_ContiguousGrad``); real CPU tensors on a fake
    world of 16."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), num_heads=16, num_kv_heads=16,
                              dtype="float32")
    with dryrun.fake_world(16):
        mesh = dryrun.make_test_mesh((1, 16), device_type="cpu")
        out = dryrun.count_on_mesh(cfg, ShapeConfig("one head", 32, 2, "train"), mesh,
                                   device="cpu")
    assert out["cost"].flops > 0


def test_run_all_resumes_and_records_failures(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    monkeypatch.setattr(dryrun, "ARCHS", ("mamba2-370m", "qwen2-7b"))
    done = tmp_path / "16x16" / "mamba2-370m__train_4k.json"
    done.parent.mkdir()
    done.write_text(json.dumps({"status": "ok"}))
    ran = []

    def fake(arch, shape, multi_pod):
        ran.append((arch, shape))
        if shape == "prefill_32k":
            raise RuntimeError("boom")
        return {"arch": arch, "shape": shape, "status": "ok", "count_s": 0.0,
                "memory": {"peak_estimate_bytes": 0},
                "roofline": {k: 0.0 for k in ("compute_s", "memory_s", "collective_s", "mfu")}
                | {"dominant": "compute"}}

    monkeypatch.setattr(dryrun, "run_cell", fake)
    assert dryrun.run_all(False) == 2
    # long_500k runs only for the SSM; the ok file is resumed
    assert ran == [("mamba2-370m", s) for s in ("prefill_32k", "decode_32k", "long_500k")] + [
        ("qwen2-7b", s) for s in ("train_4k", "prefill_32k", "decode_32k")]
    failed = json.loads((tmp_path / "16x16" / "qwen2-7b__prefill_32k.json").read_text())
    assert failed["status"] == "fail" and "boom" in failed["error"]


# -- production cells on 16x16 ---------------------------------------------------------

#: one cheap cell of each kind (grok-1 at one layer: its published widths)
CHEAP_CELLS = {"decode": ("qwen1.5-0.5b", "decode_32k", None),
               "long": ("mamba2-370m", "long_500k", None),
               "train": ("grok-1-314b", "train_4k", 1)}
REFERENCE_KEYS = {"arch", "shape", "mesh", "status", "num_params", "memory", "cost", "roofline",
                  "train_config", "num_groups"}


def _check_cell(result: dict, kind: str) -> None:
    want = REFERENCE_KEYS if kind == "train" else REFERENCE_KEYS - {"train_config", "num_groups"}
    assert want <= set(result) and result["status"] == "ok" and "count_s" in result
    mem, rl = result["memory"], result["roofline"]
    assert mem["peak_estimate_bytes"] == (mem["argument_bytes"] + mem["output_bytes"]
                                          + mem["temp_bytes"] - mem["alias_bytes"]) > 0
    assert rl["collective_s"] > 0 and rl["collectives"]["total_wire_bytes"] > 0
    assert set(rl["collectives"]) == {"counts", "result_bytes", "operand_bytes", "wire_bytes",
                                      "total_operand_bytes", "total_wire_bytes"}
    assert rl["dominant"] in ("compute", "memory", "collective") and rl["step_time_s"] > 0


@pytest.mark.parametrize("kind", list(CHEAP_CELLS))
def test_a_production_cell_counts(kind, monkeypatch, tmp_path):
    arch, shape, layers = CHEAP_CELLS[kind]
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    result = dryrun.run_cell(arch, shape, False, cfg=cfg)
    _check_cell(result, kind)
    if kind == "train":
        # above 50 B: adafactor, int8 slots split over the row's ranks, zero
        # groups; K4-int8 launches per leaf, its row-max pass where split
        tc = result["train_config"]
        assert (tc["optimizer"], tc["dsag_cache_dtype"], tc["dsag_groups"], tc["fsdp"]) == (
            "adafactor", "int8", "zero", True) and result["num_groups"] == 2
        assert {"dsag_cache_update_int8", "dsag_int8_row_max"} <= set(result["cost"]["kernels"])
    # the CLI writes the same keys where RESULTS_DIR says
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    if layers is None:
        dryrun.main(["--arch", arch, "--shape", shape])
        written = json.loads((tmp_path / "16x16" / f"{arch}__{shape}.json").read_text())
        assert set(written) == set(result) and written["memory"] == result["memory"]
        row = next(r for r in dryrun.table(False).splitlines() if r.startswith(f"| {arch} |"))
        assert f"{result['memory']['peak_estimate_bytes'] / 2**30:.1f} GiB" in row


@pytest.mark.slow
@pytest.mark.skipif(os.environ.get("DRYRUN_ALL_CELLS") != "1",
                    reason="every production cell takes minutes: DRYRUN_ALL_CELLS=1 runs it")
@pytest.mark.parametrize("multi_pod", [False])
def test_every_production_cell(multi_pod):
    cells = [(a, s) for a in ARCHS for s, sh in SHAPES.items()
             if cell_is_runnable(get_config(a), sh)]
    assert len(cells) == 32
    for arch, shape in cells:
        _check_cell(dryrun.run_cell(arch, shape, multi_pod), SHAPES[shape].kind)


# -- the dry run against a concrete run ------------------------------------------------

CONCRETE = {"train dp": ("train", None), "train zero": ("train", 100e9),
            "prefill": ("prefill", None), "decode": ("decode", None)}


@pytest.mark.parametrize("case", list(CONCRETE))
def test_the_dry_run_equals_a_gloo_run(pool, case):
    kind, size = CONCRETE[case]
    cfg = get_smoke_config(ARCH)
    tc = None if size is None else dryrun.default_train_config(size, False)
    real = pool.run(dryrun.count_rank, cfg, SMOKE[kind], (2, 2), tc)[0]
    dry = dryrun.dry_count(cfg, SMOKE[kind], (2, 2), tc, mode="plain")
    assert real["cost"].diff(dry["cost"]) == []
    assert real["memory"]["argument_bytes"] == dry["memory"]["argument_bytes"] > 0
    cost = dry["cost"]
    if case == "train zero":
        assert {"int8 row max: all-reduce", "adafactor means: all-reduce"} <= set(
            cost.coll_site_counts)
    assert cost.flops > 0 and cost.coll_counts


def _replicated_logits_loss(cfg, logits, tokens, *, text_offset: int = 0):
    """The loss as the mesh step took it before its vocab-parallel form:
    the logits all-gathered over ``model``, then each rank's loss on whole
    rows."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.models import transformer
    from repro_torch.models.sharding import collective_site, shard_batch

    with collective_site("loss"):
        whole = shard_batch(logits, None, None)
    loss = transformer.next_token_loss(cfg, whole.to_local(), tokens, text_offset=text_offset)
    return DTensor.from_local(loss, whole.device_mesh, [Replicate()], run_check=False)


def test_the_loss_keeps_the_vocab_split(monkeypatch):
    """The smoke qwen train step on (2, 4): the loss all-reduces its max,
    sum and target logit and gathers no logits; its peak estimate is below
    the count with the logits replicated over ``model`` (each rank held
    ``[b, s - 1, V]`` float32 there, ``[b, s - 1, V / 4]`` here)."""
    from repro_torch.models import model as model_mod

    cfg = get_smoke_config(ARCH)
    tc = dryrun.default_train_config(build_model(cfg).num_params(), False)
    split = dryrun.dry_count(cfg, SMOKE["train"], (2, 4), tc, mode="plain")
    monkeypatch.setattr(model_mod, "next_token_loss", _replicated_logits_loss)
    whole = dryrun.dry_count(cfg, SMOKE["train"], (2, 4), tc, mode="plain")
    sites = split["cost"].coll_site_counts
    assert {k for k in sites if k.startswith("loss: ")} == {"loss: all-reduce"}, sites
    assert sites["loss: all-reduce"] == 3
    assert "loss: all-gather" in whole["cost"].coll_site_counts
    gathered = split["cost"].coll_wire_bytes.get("all-gather", 0.0)
    assert gathered < whole["cost"].coll_wire_bytes["all-gather"]
    assert split["memory"]["peak_estimate_bytes"] < whole["memory"]["peak_estimate_bytes"]


# -- against the reference --------------------------------------------------------------


def test_cell_is_runnable_equals_the_reference(ref):
    assert {f"{a}|{s}": cell_is_runnable(get_config(a), sh)
            for a in ARCHS for s, sh in SHAPES.items()} == ref["runnable"]


def test_input_specs_equal_the_reference(ref):
    got = {}
    for key in ref["input_specs"]:
        arch, s, mname = key.split("|")
        mesh = None if mname == "None" else MESHES[mname]
        got[key] = {k: [list(v.shape), _dtype(v.dtype), _spec(v.spec)]
                    for k, v in input_specs(get_config(arch), SHAPES[s], mesh=mesh).items()}
    assert got == ref["input_specs"]


def test_default_train_config_equals_the_reference(ref):
    for arch in ARCHS:
        assert build_model(get_config(arch)).num_params() == ref["num_params"][arch], arch
    assert {f"{a}|{mp}": dataclasses.asdict(dryrun.default_train_config(n, mp == "True"))
            for a, n in ref["num_params"].items() for mp in ("False", "True")} == \
        ref["train_config"]


def test_sanitize_spec_and_the_grouped_batch_equal_the_reference(ref):
    for key, (spec, shape, want) in ref["sanitize"].items():
        spec = P(*(tuple(e) if isinstance(e, list) else e for e in spec))
        assert _spec(dryrun.sanitize_spec(spec, shape, MESHES[key.split("|")[0]])) == want, key
    for key, want in ref["grouped"].items():
        mname, arch, mp = key.split("|")
        tc = dryrun.default_train_config(ref["num_params"][arch], mp == "True")
        gs = make_group_spec(tc, MESHES[mname])
        batch = dryrun._grouped_batch_abstract(get_config(arch), SHAPES["train_4k"], gs,
                                               MESHES[mname])
        assert {"groups": [gs.num_groups, list(gs.axes)],
                "batch": {k: [list(v.shape), _dtype(v.dtype), _spec(v.spec)]
                          for k, v in batch.items()}} == want, key


def test_model_flops_per_device_equal_the_reference(ref):
    for key, want in ref["model_flops_per_device"].items():
        arch, s, nd = key.split("|")
        rl = roofline.derive(get_config(arch), SHAPES[s], ref["num_params"][arch], Cost(),
                             num_devices=int(nd))
        assert rl.model_flops_per_device == want, key


def _kv_projection_excess(cfg, tokens: int, model: int) -> float:
    """The products of projecting the kv heads a rank does not read: a
    served prefill projects all of them where their weights are replicated
    (its cache is split over the sequence and stores every kv head at the
    rank's positions); training projects the rank's own."""
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return 2 * 2.0 * tokens * cfg.d_model * (kvh - kvh // model) * hd * cfg.num_layers


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_product_flops_against_xla(ref, kind):
    """Per device on (2, 4): the product FLOPs equal XLA's within 1 % where
    both compute the same products: in training always, in the prefill with
    16 kv heads (split over ``model``); with 4 kv heads the prefill's excess
    is the replicated kv projections' (``gqa_prefill_with_cache`` projects
    every kv head, a deliberate departure: ROADMAP §3).  Both sides count
    collectives; their kinds differ (PERF.md)."""
    for name, fields in XLA_CELLS.items():
        cfg = dataclasses.replace(get_smoke_config(ARCH), **fields)
        shape = dataclasses.replace(SMOKE[kind], global_batch=8)
        tc = None
        if kind == "train":
            tc = dryrun.default_train_config(build_model(cfg).num_params(), False)
            assert dataclasses.asdict(tc) == ref["xla"][name]["train_config"]
        cost = dryrun.dry_count(cfg, shape, (2, 4), tc, mode="plain")["cost"]
        xla = ref["xla" if kind == "train" else "xla_prefill"][name]
        excess = _kv_projection_excess(cfg, 4 * shape.seq_len, 4) \
            if name == "smoke" and kind == "prefill" else 0.0
        assert cost.flops - excess == pytest.approx(xla["flops"], rel=1e-2), (
            name, cost.flops, xla["flops"])
        assert cost.coll_counts and xla["counts"]
