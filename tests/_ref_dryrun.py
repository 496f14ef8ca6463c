"""The reference side of ``tests/test_torch_dryrun.py``: run in a subprocess
with 8 host devices (``XLA_FLAGS`` from the parent); writes one JSON.

  python tests/_ref_dryrun.py <out.json>

The jax backend is initialized before ``repro.launch.dryrun`` is imported:
that module sets ``XLA_FLAGS`` to 512 host devices at import, which then no
longer applies.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import types

import jax
import jax.experimental

# the jax-0.9 shim of tests/test_torch_parity.py
jax.experimental.enable_x64 = jax.enable_x64
from jax.experimental import pallas as pl  # noqa: E402

pl.load = lambda ref, idx: ref[idx]


def _store(ref, idx, val):
    ref[idx] = val


pl.store = _store
assert len(jax.devices()) == 8, jax.devices()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P  # noqa: E402

from repro.analysis import hlo, roofline  # noqa: E402
from repro.configs import (  # noqa: E402
    ARCHS,
    SHAPES,
    cell_is_runnable,
    get_config,
    get_smoke_config,
    input_specs,
)
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.core.dsag_pjit import (  # noqa: E402
    init_train_state,
    make_group_spec,
    make_train_step,
    train_state_specs,
)
from repro.launch import dryrun  # noqa: E402
from repro.launch.mesh import make_test_mesh  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models.sharding import set_mesh  # noqa: E402

#: one arch of each family
FAMILY_ARCHS = ("qwen2-7b", "grok-1-314b", "deepseek-v2-236b", "mamba2-370m", "zamba2-2.7b",
                "pixtral-12b", "whisper-base")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def entry(e):
    if isinstance(e, tuple):
        return list(e) if len(e) > 1 else e[0]
    return e


def spec_json(spec):
    return [entry(e) for e in tuple(spec)]


def duck_mesh(name):
    """What ``sanitize_spec`` and ``make_group_spec`` read of a mesh: its axis
    names and its devices' shape (no 256 devices made)."""
    shape, axes = MESHES[name]
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape, dtype=object))


def main(out_path: str) -> None:
    out: dict = {}
    # -- cell_is_runnable over every arch and shape -------------------------
    out["runnable"] = {f"{a}|{s}": cell_is_runnable(get_config(a), sh)
                       for a in ARCHS for s, sh in SHAPES.items()}
    # -- input_specs without and with a mesh ----------------------------------
    specs = {}
    for arch in FAMILY_ARCHS:
        cfg = get_config(arch)
        for s, sh in SHAPES.items():
            for mname in (None, *MESHES):
                mesh = None if mname is None else AbstractMesh(*MESHES[mname])
                got = input_specs(cfg, sh, mesh=mesh)
                specs[f"{arch}|{s}|{mname}"] = {
                    k: [list(v.shape), str(v.dtype),
                        None if mesh is None else spec_json(v.sharding.spec)]
                    for k, v in got.items()}
    out["input_specs"] = specs
    # -- default_train_config at every arch's published size ----------------
    out["num_params"] = {a: build_model(get_config(a)).num_params() for a in ARCHS}
    out["train_config"] = {f"{a}|{mp}": dataclasses.asdict(dryrun.default_train_config(n, mp))
                           for a, n in out["num_params"].items() for mp in (False, True)}
    # -- sanitize_spec and the grouped batch on the production meshes --------
    cases = [(P("data", None), (256, 4096)), (P("data", None), (1, 1)),
             (P(("pod", "data"), None), (1, 1)), (P(("pod", "data"), None), (128, 1)),
             (P(None, "data", "model", None, None), (24, 1, 32768, 16, 64)),
             (P(None, ("pod", "data"), "model"), (48, 128, 24)), (P("model"), (8, 3)),
             (P(None, "model", None), (2, 40, 7))]
    out["sanitize"] = {}
    for mname in MESHES:
        for i, (spec, shape) in enumerate(cases):
            if "pod" in str(spec) and mname == "16x16":
                continue
            got = dryrun.sanitize_spec(spec, shape, duck_mesh(mname))
            out["sanitize"][f"{mname}|{i}"] = [spec_json(spec), list(shape), spec_json(got)]
    # the reference's NamedSharding over an abstract mesh of the same axes
    dryrun.NamedSharding = lambda mesh, spec: NamedSharding(
        AbstractMesh(mesh.devices.shape, mesh.axis_names), spec)
    grouped = {}
    for mname in MESHES:
        for arch in ("qwen2-7b", "grok-1-314b", "pixtral-12b", "whisper-base"):
            cfg = get_config(arch)
            for mp in (False, True):
                tc = dryrun.default_train_config(out["num_params"][arch], mp)
                gs = make_group_spec(tc, duck_mesh(mname))
                got = dryrun._grouped_batch_abstract(cfg, SHAPES["train_4k"], gs, duck_mesh(mname))
                grouped[f"{mname}|{arch}|{mp}"] = {
                    "groups": [gs.num_groups, list(gs.axes)],
                    "batch": {k: [list(v.shape), str(v.dtype), spec_json(v.sharding.spec)]
                              for k, v in got.items()}}
    out["grouped"] = grouped
    dryrun.NamedSharding = NamedSharding
    # -- model FLOPs per device ---------------------------------------------
    out["model_flops_per_device"] = {}
    for arch in ARCHS:
        cfg = get_config(arch)
        for s, sh in SHAPES.items():
            for nd in (1, 256, 512):
                rl = roofline.derive(cfg, sh, out["num_params"][arch], {}, "", nd)
                out["model_flops_per_device"][f"{arch}|{s}|{nd}"] = rl.model_flops_per_device
    # -- one smoke train cell compiled on (2, 4): XLA's per-device count ------
    out["xla"] = {name: xla_train_cell(fields) for name, fields in XLA_CELLS.items()}
    out["xla_prefill"] = {name: xla_prefill_cell(fields) for name, fields in XLA_CELLS.items()}
    with open(out_path, "w") as f:
        json.dump(out, f)


#: the smoke cells held against XLA's count (tests/test_torch_dryrun.py):
#: the smoke config as it is (4 kv heads: kv weights replicated, as the
#: rules leave a kv-head count that 16 does not divide) and with 16 kv heads
#: (split over ``model``)
XLA_ARCH, XLA_SHAPE = "qwen1.5-0.5b", (64, 8)
XLA_CELLS = {"smoke": {}, "kv16": {"num_heads": 16, "num_kv_heads": 16}}


def xla_train_cell(fields: dict) -> dict:
    """The reference's ``run_cell`` train branch for ``XLA_ARCH``'s smoke
    config (``fields`` replaced) on a (2, 4) mesh of the 8 host devices:
    ``analyze_hlo`` of the compiled step."""
    cfg = dataclasses.replace(get_smoke_config(XLA_ARCH), **fields)
    shape = ShapeConfig("smoke", XLA_SHAPE[0], XLA_SHAPE[1], "train")
    mesh = make_test_mesh((2, 4))
    set_mesh(mesh)
    model = build_model(cfg)
    tc = dryrun.default_train_config(model.num_params(), False)
    gs = make_group_spec(tc, mesh)
    param_specs = model.param_specs(tc.fsdp)
    step = make_train_step(
        lambda p, b: model.train_loss(p, b, remat=tc.remat, fused_loss=tc.fused_loss),
        tc, gs, mesh, param_specs)
    state_abs = jax.eval_shape(lambda pa: init_train_state(pa, tc, gs), model.abstract())
    state_in = dryrun._attach(state_abs, train_state_specs(tc, gs, param_specs), mesh)
    batch_in = dryrun._grouped_batch_abstract(cfg, shape, gs, mesh)
    mask_in = jax.ShapeDtypeStruct((gs.num_groups,), jnp.bool_,
                                   sharding=NamedSharding(mesh, P()))
    compiled = jax.jit(step).lower(state_in, batch_in, mask_in, mask_in).compile()
    cost = hlo.analyze_hlo(compiled.as_text())
    set_mesh(None)
    return {"train_config": dataclasses.asdict(tc), **cost.as_dict()}


def xla_prefill_cell(fields: dict) -> dict:
    """The reference's ``run_cell`` prefill branch for the same smoke config
    and batch on (2, 4): ``analyze_hlo`` of the compiled prefill."""
    from repro.models.sharding import degather

    cfg = dataclasses.replace(get_smoke_config(XLA_ARCH), **fields)
    shape = ShapeConfig("smoke", XLA_SHAPE[0], XLA_SHAPE[1], "prefill")
    mesh = make_test_mesh((2, 4))
    set_mesh(mesh)
    model = build_model(cfg)
    param_specs = model.param_specs(model.num_params() > 1e9)
    params_in = dryrun._attach(model.abstract(), param_specs, mesh)
    batch_in = input_specs(cfg, shape, mesh=mesh)

    def prefill(p, b):
        return model.prefill(degather(p, param_specs, mesh), b, cache_len=shape.seq_len)

    compiled = jax.jit(prefill).lower(params_in, batch_in).compile()
    cost = hlo.analyze_hlo(compiled.as_text())
    set_mesh(None)
    return cost.as_dict()


if __name__ == "__main__":
    main(sys.argv[1])
