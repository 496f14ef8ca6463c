"""The reference's jitted mesh step on 8 fake XLA CPU devices, for
``tests/test_torch_mesh_layouts.py`` and ``tests/test_torch_mesh_moe.py``
(run as a subprocess with the jax-0.9 shim: ``python _ref_mesh_layouts.py
<inputs.npz> <cases.json> <out.npz>``).

Each case trains an arch's float32 smoke model (its ``cfg`` fields
replaced) from the port's initial parameters (read from the inputs) for a
few steps on the given batches and Tier-2 bits, under the reference's
``make_group_spec`` / ``train_state_specs`` placement (the dry run's
flatten-order ``_attach``), and writes each step's metrics and train state
(by the checkpoint's path strings).  A case of kind ``"moe"`` runs
``moe_apply`` jitted on the mesh instead (the parameters placed by the
MoE's FSDP specs, the batch over ``data``) and unsharded, and writes each
one's output, aux loss and gradient of ``sum(out · w) + aux``.  It also writes the reference's
``opt_state_specs`` and ``dsag_state_specs`` for adafactor and int8 slots
under the ``zero`` and ``pod`` layouts, for every arch.
"""

import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402
import jax.experimental  # noqa: E402

jax.experimental.enable_x64 = jax.enable_x64
from jax.experimental import pallas as pl  # noqa: E402

pl.load = lambda ref, idx: ref[idx]


def _store(ref, idx, val):
    ref[idx] = val


pl.store = _store

import dataclasses  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402
import types  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from repro.configs import ARCHS, get_config, get_smoke_config  # noqa: E402
from repro.configs.base import TrainConfig  # noqa: E402
from repro.core import dsag_pjit as D  # noqa: E402
from repro.launch.mesh import make_test_mesh  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.models.sharding import set_mesh  # noqa: E402
from repro.optim.compression import Quantized  # noqa: E402


def _paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(str(k) for k in path), leaf) for path, leaf in flat]


def _ser(x):
    if isinstance(x, dict):
        return {k: _ser(v) for k, v in x.items()}
    if isinstance(x, Quantized):
        return {"q": _ser(x.q), "scale": _ser(x.scale)}
    if isinstance(x, P):
        return [list(e) if isinstance(e, tuple) else e for e in x]
    return x


def run_case(name, case, inputs, out):
    mesh = make_test_mesh(tuple(case["shape"]))
    set_mesh(mesh)
    try:
        cfg = dataclasses.replace(get_smoke_config(case["arch"]), dtype="float32",
                                  **case.get("cfg", {}))
        model = build_model(cfg)
        tc = TrainConfig(**case["tc"])
        gs = D.make_group_spec(tc, mesh)
        specs = model.param_specs(tc.fsdp)
        step = jax.jit(D.make_train_step(lambda p, b: model.train_loss(p, b, remat=tc.remat),
                                         tc, gs, mesh, specs))
        params = jax.tree_util.tree_map_with_path(
            lambda path, x: jnp.asarray(inputs[case["arch"] + "/['params']/" + "/".join(
                str(k) for k in path)], x.dtype),
            model.init(jax.random.key(0)))
        state = D.init_train_state(params, tc, gs)
        leaves, tdef = jax.tree_util.tree_flatten(state)
        sl = jax.tree_util.tree_leaves(D.train_state_specs(tc, gs, specs),
                                       is_leaf=lambda s: isinstance(s, P))
        state = jax.tree_util.tree_unflatten(
            tdef, [jax.device_put(x, NamedSharding(mesh, s)) for x, s in zip(leaves, sl)])
        for i in range(case["steps"]):
            batch = {k.split("/")[-1]: jnp.asarray(inputs[k]) for k in inputs.files
                     if k.startswith(f"{name}/batch{i}/")}
            bits = [jnp.asarray(inputs[f"{name}/bits{i}"][j]) for j in range(3)]
            state, met = step(state, batch, *bits)
            for k, v in met.items():
                out[f"{name}/metrics{i}/{k}"] = np.asarray(v)
            for path, leaf in _paths(state):
                out[f"{name}/state{i}/{path}"] = np.asarray(
                    leaf.astype(jnp.float32) if leaf.dtype == jnp.bfloat16 else leaf)
    finally:
        set_mesh(None)


def run_moe_case(name, case, inputs, out):
    from repro.models import moe
    from repro.models.layers import make_rules

    mesh = make_test_mesh(tuple(case["shape"]))
    set_mesh(mesh)
    try:
        cfg = dataclasses.replace(get_smoke_config(case["arch"]), dtype="float32",
                                  **case.get("cfg", {}))
        rules = make_rules(cfg, True)
        decls = moe.moe_decls(cfg)
        params = {k: jax.device_put(jnp.asarray(inputs[f"{name}/p/{k}"]), NamedSharding(
            mesh, P(*[rules.get(a) for a in d.logical]))) for k, d in decls.items()}
        x = jax.device_put(jnp.asarray(inputs[f"{name}/x"]), NamedSharding(mesh, P("data")))
        w = jnp.asarray(inputs[f"{name}/w"])

        def f(p, x):
            y, aux = moe.moe_apply(cfg, p, x, capacity_factor=case["cf"])
            return jnp.sum(y * w) + aux, (y, aux)

        def run(tag, p, x):
            (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                f, argnums=(0, 1), has_aux=True))(p, x)
            out[f"{name}/{tag}/out"], out[f"{name}/{tag}/aux"] = np.asarray(y), np.asarray(aux)
            out[f"{name}/{tag}/dx"] = np.asarray(gx)
            for k, v in gp.items():
                out[f"{name}/{tag}/grad/{k}"] = np.asarray(v)

        run("mesh", params, x)
    finally:
        set_mesh(None)
    # the same function unsharded (no mesh installed: no sharding constraint)
    run("plain", {k: jnp.asarray(np.asarray(v)) for k, v in params.items()},
        jnp.asarray(np.asarray(x)))


def spec_trees():
    """opt_state_specs / dsag_state_specs for adafactor + int8 under zero
    and pod, on (2, 4) and (2, 2, 4) meshes (only their axes are read)."""
    def mesh(shape, axes):
        return types.SimpleNamespace(axis_names=tuple(axes), devices=np.empty(shape))

    meshes = {"zero": mesh((2, 4), ("data", "model")),
              "pod": mesh((2, 2, 4), ("pod", "data", "model"))}
    out = {}
    for arch in ARCHS:
        specs = build_model(get_config(arch)).param_specs(True)
        for groups, m in meshes.items():
            tc = TrainConfig(optimizer="adafactor", dsag_cache_dtype="int8",
                             dsag_groups=groups, dsag_num_groups=2)
            gs = D.make_group_spec(tc, m)
            out[f"{arch}/{groups}"] = {"gs": [gs.num_groups, list(gs.axes)],
                                       "opt": _ser(D.opt_state_specs(tc, specs)),
                                       "dsag": _ser(D.dsag_state_specs(tc, gs, specs))}
    return out


def main():
    inputs_path, cases_path, out_path = sys.argv[1:4]
    with open(cases_path) as f:
        cases = json.load(f)
    out = {"specs": np.frombuffer(json.dumps(spec_trees()).encode(), dtype=np.uint8)}
    with np.load(inputs_path) as inputs:
        for name, case in cases.items():
            t0 = time.perf_counter()
            (run_moe_case if case.get("kind") == "moe" else run_case)(name, case, inputs, out)
            print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
    np.savez(out_path, **out)


if __name__ == "__main__":
    main()
