"""Functions the mesh tests run on every rank of a ``RankPool`` (spawned
processes import them from here by name)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core.dsag_pjit import (
    gather_mesh_params,
    init_mesh_train_state,
    make_group_spec,
    make_train_step,
)
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import build_model
from repro_torch.models.sharding import set_mesh


def smoke_model(arch: str, dtype: str, **fields):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype, **fields)
    return cfg, build_model(cfg, kernel_backend="torch")


def train_steps(arch: str, dtype: str, tc: TrainConfig, shape, batches, masks, seed: int = 0):
    """Run the mesh step of ``arch``'s smoke model from the seeded init over
    ``batches`` / ``masks`` ([(mask, flush, evict)] numpy); rank 0 returns
    the metrics per step and the final full parameters (numpy float32)."""
    mesh = make_test_mesh(shape, device_type="cpu")
    set_mesh(mesh)
    try:
        cfg, model = smoke_model(arch, dtype)
        gs = make_group_spec(tc, mesh)
        step = make_train_step(lambda p, b: model.train_loss(p, b, remat=tc.remat), tc, gs,
                               mesh, model.param_specs(tc.fsdp), backend="torch",
                               layout=model.layout)
        state = init_mesh_train_state(
            model.init(torch.Generator().manual_seed(seed), step.layouts.specs, mesh), tc, gs,
            step.layouts, mesh)
        out = []
        for batch, (m, f, e) in zip(batches, masks):
            state, met = step(state, {k: torch.as_tensor(v) for k, v in batch.items()},
                              *(torch.as_tensor(x) for x in (m, f, e)))
            out.append({k: np.asarray(v.detach()) for k, v in met.items()})
        params = gather_mesh_params(state, step.layouts, mesh)
        if torch.distributed.get_rank() != 0:
            return None
        return out, {"/".join(k): np.asarray(v.float()) for k, v in _flat(params)}
    finally:
        set_mesh(None)


def set_threads(n: int) -> int:
    """This rank's intra-op threads (ranks of one CPU share its cores)."""
    torch.set_num_threads(n)
    return torch.get_num_threads()


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def serve(arch: str, dtype: str, shape, batch, num_tokens: int, max_len: int, seed: int = 0,
          cfg_fields: dict | None = None):
    """``Server(mesh=)`` on ``arch``'s smoke model (``cfg_fields``
    replaced): the whole batch's generated tokens, and the prefill's last
    logits of this rank's batch slice."""
    from unittest import mock

    from torch.distributed.tensor.experimental import implicit_replication

    import repro_torch.launch.serve as serve_mod
    from repro_torch.models.sharding import dp_coordinate, full

    mesh = make_test_mesh(shape, device_type="cpu")
    try:
        with mock.patch.object(serve_mod, "get_smoke_config", lambda a: dataclasses.replace(
                get_smoke_config(a), **(cfg_fields or {}))):
            srv = serve_mod.Server(arch, device="cpu", kernel_backend="torch", max_len=max_len,
                                   seed=seed, mesh=mesh, dtype=dtype)
        toks = srv.generate(batch, num_tokens)
        idx, n = dp_coordinate(mesh)
        b = batch["tokens"].shape[0] // n
        local = {k: torch.as_tensor(v)[idx * b:(idx + 1) * b] for k, v in batch.items()}
        with torch.inference_mode(), implicit_replication():
            logits, _ = srv.model.prefill(srv._weights(), local, cache_len=srv.max_len)
        return np.asarray(toks), np.asarray(full(logits).float()), srv.max_len
    finally:
        set_mesh(None)


def counted_step(arch: str, dtype: str, tc: TrainConfig, shape, batch, mask):
    """One mesh step under ``count_cost``: this rank's collectives by kind
    and their ring-model wire bytes."""
    from repro_torch.analysis.cost import count_cost

    mesh = make_test_mesh(shape, device_type="cpu")
    set_mesh(mesh)
    try:
        cfg, model = smoke_model(arch, dtype)
        gs = make_group_spec(tc, mesh)
        step = make_train_step(lambda p, b: model.train_loss(p, b, remat=tc.remat), tc, gs,
                               mesh, model.param_specs(tc.fsdp), backend="torch",
                               layout=model.layout)
        state = init_mesh_train_state(
            model.init(torch.Generator().manual_seed(0), step.layouts.specs, mesh), tc, gs,
            step.layouts, mesh)
        m = torch.as_tensor(mask)
        cost = count_cost(step, state, {k: torch.as_tensor(v) for k, v in batch.items()},
                          m, torch.zeros_like(m), torch.zeros_like(m))
        return dict(cost.coll_counts), dict(cost.coll_wire_bytes), cost.flops
    finally:
        set_mesh(None)


def degathered(arch: str, dtype: str, shape, fsdp: bool, quantized: bool, seed: int = 0):
    """The model's weights placed by ``param_specs(fsdp)`` and degathered
    (int8 with ``quantized``), each gathered whole: rank 0 returns them
    (numpy float32, by path)."""
    from repro_torch.models.sharding import NamedSharding, degather, map_specs

    mesh = make_test_mesh(shape, device_type="cpu")
    set_mesh(mesh)
    try:
        cfg, model = smoke_model(arch, dtype)
        specs = model.param_specs(fsdp)
        full = model.init(torch.Generator().manual_seed(seed))
        placed = map_specs(lambda t, s: NamedSharding(mesh, s).place(t), full, specs)
        out = degather(placed, specs, mesh, quantized=quantized)
        gathered = {"/".join(k): np.asarray(v.full_tensor().float()) for k, v in _flat(out)}
        return gathered if torch.distributed.get_rank() == 0 else None
    finally:
        set_mesh(None)


def checkpoint_round_trip(arch: str, shape, directory: str, seed: int = 0):
    """Save the placed weights (DTensors, rank 0 writes) and restore them
    with ``shardings=``: every rank's restored shard against the shard it
    saved, bit for bit; returns the path and whether all matched."""
    from repro_torch.checkpoint.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.models.sharding import NamedSharding, map_specs

    mesh = make_test_mesh(shape, device_type="cpu")
    set_mesh(mesh)
    try:
        cfg, model = smoke_model(arch, "bfloat16")
        specs = model.param_specs(True)
        full = model.init(torch.Generator().manual_seed(seed))
        shardings = map_specs(lambda t, s: NamedSharding(mesh, s), full, specs)
        placed = map_specs(lambda t, s: s.place(t), full, shardings)
        path = save_checkpoint(directory, 3, {"params": placed})
        like = {"params": map_specs(lambda t, s: torch.empty_like(t), full, specs)}
        back = restore_checkpoint(path, like, {"params": shardings})["params"]
        same = all(torch.equal(a.to_local(), b.to_local()) and a.placements == b.placements
                   for (_, a), (_, b) in zip(_flat(placed), _flat(back)))
        return path, same
    finally:
        set_mesh(None)


def trainer_run(arch: str, dtype: str, tc: TrainConfig, shape, steps: int, batch: int,
                seq: int):
    """``Trainer(TrainerOptions(mesh=))`` on ``arch``'s smoke model for
    ``steps`` steps (its own Tier-2 controller): rank 0 returns the history
    and the final full parameters."""
    from repro_torch.experiments.engine import EngineConfig
    from repro_torch.launch.train import Trainer, TrainerOptions

    mesh = make_test_mesh(shape, device_type="cpu")
    try:
        trn = Trainer(TrainerOptions(arch=arch, steps=steps, global_batch=batch, seq_len=seq,
                                     dtype=dtype, mesh=mesh, train_config=tc, log_every=10**6,
                                     engine=EngineConfig(device="cpu", kernel_backend="torch")))
        hist = trn.run()
        params = gather_mesh_params(trn.state, trn.step_fn.layouts, mesh)
        if torch.distributed.get_rank() != 0:
            return None
        keep = ("loss", "xi", "mask_count", "mask_stream", "flush_stream", "evict_stream")
        return ({k: hist[k] for k in keep},
                {"/".join(k): np.asarray(v.float()) for k, v in _flat(params)})
    finally:
        set_mesh(None)


def kernels_refuse_dtensors(shape):
    """K4's and K6's wrappers given DTensors: each raises ``TypeError``
    (no drop to the plain version); returns the messages."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.kernels.dsag_update import dsag_cache_update
    from repro_torch.kernels.flash_attention import flash_attention_bshd

    mesh = make_test_mesh(shape, device_type="cpu")

    def dt(*s):
        return DTensor.from_local(torch.zeros(s), mesh, [Replicate(), Replicate()])

    out = []
    for call in (lambda: dsag_cache_update(dt(1, 8), dt(1, 8), dt(8), dt(1)),
                 lambda: flash_attention_bshd(dt(1, 4, 2, 8), dt(1, 4, 2, 8), dt(1, 4, 2, 8))):
        try:
            call()
            out.append(None)
        except TypeError as e:
            out.append(str(e))
    return out


def state_by_path(tree) -> dict:
    """A train-state tree (the reference's layout; ``DTensor`` leaves
    gathered, every rank taking part) as numpy by checkpoint path, bf16
    widened to float32."""
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths
    from repro_torch.models.sharding import full

    out = {}
    for path, leaf in _flatten_with_paths(tree):
        t = full(leaf).detach()
        out[path] = np.asarray(t.float() if t.dtype == torch.bfloat16 else t)
    return out


def layout_run(arch: str, tc: TrainConfig, shape, batches, masks, seed: int = 0,
               cfg_fields: dict | None = None):
    """The mesh step of ``arch``'s float32 smoke model under ``tc`` on a
    ``shape`` mesh, from the seeded init, over ``batches`` / ``masks``; the
    last step runs under ``count_cost``.  Rank 0 returns each step's
    metrics and train state by checkpoint path (gathered), and the counted
    step's collectives by site."""
    from repro_torch.analysis.cost import count_cost
    from repro_torch.checkpoint.checkpoint import mesh_train_state_tree
    from repro_torch.core.dsag_pjit import train_state_specs

    mesh = make_test_mesh(shape, device_type="cpu")
    set_mesh(mesh)
    try:
        cfg, model = smoke_model(arch, "float32", **(cfg_fields or {}))
        gs = make_group_spec(tc, mesh)
        specs = model.param_specs(tc.fsdp)
        step = make_train_step(lambda p, b: model.train_loss(p, b, remat=tc.remat), tc, gs,
                               mesh, specs, backend="torch", layout=model.layout)
        state = init_mesh_train_state(
            model.init(torch.Generator().manual_seed(seed), step.layouts.specs, mesh), tc, gs,
            step.layouts, mesh)
        out, states, held = [], [], {}
        for i, (batch, bits) in enumerate(zip(batches, masks)):
            args = ({k: torch.as_tensor(v) for k, v in batch.items()},
                    *(torch.as_tensor(x) for x in bits))
            if i == len(batches) - 1:
                cost = count_cost(lambda: held.update(out=step(state, *args)))
                state, met = held.pop("out")
            else:
                state, met = step(state, *args)
            out.append({k: np.asarray(v.detach()) for k, v in met.items()})
            states.append(state_by_path(mesh_train_state_tree(
                state, step.layouts, train_state_specs(tc, gs, specs), mesh)))
        if torch.distributed.get_rank() != 0:
            return None
        return out, states, dict(cost.coll_site_wire_bytes)
    finally:
        set_mesh(None)


def checkpoint_resume(arch: str, tc: TrainConfig, shape, batches, masks, directory: str,
                      restore_from: str | None = None):
    """A mesh ``Trainer``'s checkpoints.  Its step runs ``batches`` /
    ``masks`` through; the state after half of them is saved by the
    trainer's manager (gathered; rank 0 writes), restored by
    ``maybe_restore`` (each rank's shards, by the state's specs) and run on.
    ``Trainer.run`` also saves through its own loop.  Rank 0 returns whether
    every rank's resumed state equals its uninterrupted state bit for bit,
    the checkpoint's path, the saved state by path and, with
    ``restore_from`` (an unsharded trainer's checkpoint directory), the
    state restored from there by path."""
    from repro_torch.experiments.engine import EngineConfig
    from repro_torch.launch.train import Trainer, TrainerOptions

    mesh = make_test_mesh(shape, device_type="cpu")
    try:
        half = len(batches) // 2
        trn = Trainer(TrainerOptions(arch=arch, steps=half, dtype="float32", mesh=mesh,
                                     train_config=tc, log_every=10**6,
                                     checkpoint_dir=directory, restore=True,
                                     engine=EngineConfig(device="cpu", kernel_backend="torch")))

        def run(state, lo, hi):
            for batch, bits in zip(batches[lo:hi], masks[lo:hi]):
                state, _ = trn.step_fn(state, {k: torch.as_tensor(v) for k, v in batch.items()},
                                       *(torch.as_tensor(x) for x in bits))
            return state

        state = run(trn.init_state(), 0, half)
        trn.ckpt.save(half - 1, trn._tree(state), blocking=True)
        saved = state_by_path(trn._tree(state))
        whole = run(state, half, len(batches))
        restored, start = trn.maybe_restore(trn.init_state())
        resumed = run(restored, start, len(batches))
        same = start == half and all(
            torch.equal(a, b) for a, b in zip(_tensors(whole), _tensors(resumed)))
        same = torch.tensor([int(same)])
        torch.distributed.all_reduce(same, op=torch.distributed.ReduceOp.MIN)
        trn.opts.restore = False
        trn.ckpt = type(trn.ckpt)(directory + "/loop")
        hist = trn.run()  # the loop's own saves (every rank gathers, rank 0 writes)
        other = None
        if restore_from is not None:
            trn.opts.restore = True
            trn.ckpt = type(trn.ckpt)(restore_from)
            back, _ = trn.maybe_restore(trn.init_state())
            other = state_by_path(trn._tree(back))
        if torch.distributed.get_rank() != 0:
            return None
        return bool(same.item()), len(hist["loss"]), saved, other
    finally:
        set_mesh(None)


def _tensors(tree):
    from repro_torch.optim.compression import Quantized

    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tensors(tree[k])
    elif isinstance(tree, Quantized):
        yield tree.q
        yield tree.scale
    else:
        yield tree


def moe_layer(arch: str, cfg_fields: dict, shape, params: dict, x, w, cf: float):
    """``moe_apply`` of ``arch``'s float32 smoke config (``cfg_fields``
    replaced) on a ``shape`` mesh: the parameters (numpy, by name) placed by
    the MoE's specs (FSDP) and degathered, ``x`` [b, s, d] split over the
    data-parallel ranks (one token stream).  Each rank's loss is ``R ·
    sum(out · w)`` over its slice plus the aux, so the mean of the ranks'
    gradients is the gradient of ``sum(out · w) + aux`` over the whole
    batch.  Rank 0 returns the whole output, the aux, that mean gradient
    (by parameter, and of ``x``), the routed experts and the collectives
    (``count_cost``'s sites: bytes and counts)."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.analysis.cost import count_cost
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import sharding
    from repro_torch.models.layers import make_rules, specs_from_decls

    mesh = make_test_mesh(shape, device_type="cpu")
    set_mesh(mesh)
    try:
        cfg = smoke_model(arch, "float32", **cfg_fields)[0]
        specs = specs_from_decls(moe_mod.moe_decls(cfg), make_rules(cfg, True))
        cm = sharding.compute_mesh(mesh)
        placed = {k: sharding.NamedSharding(mesh, specs[k]).place(torch.as_tensor(v))
                  for k, v in params.items()}
        # the leaves the gradient is taken of: the degathered ones (the mesh
        # step's TP layout), each rank's gradient its own slice's
        tp = {k: DTensor.from_local(v.to_local().detach().requires_grad_(True), cm,
                                    v.placements[-cm.ndim:], run_check=False)
              for k, v in sharding.degather(placed, specs, mesh).items()}
        idx, R = sharding.dp_coordinate(mesh)
        b = x.shape[0] // R
        x_loc = torch.as_tensor(x[idx * b:(idx + 1) * b]).requires_grad_(True)
        xd = DTensor.from_local(x_loc, cm, [Replicate()] * cm.ndim, run_check=False)
        routes = []
        real_route = moe_mod.route

        def route(*a):
            out = real_route(*a)
            routes.append(out[2].detach().clone())
            return out

        held = {}

        def run():
            with implicit_replication(), sharding.token_stream(sharding.dp_axes()):
                out, aux = moe_mod.moe_apply(cfg, tp, xd, capacity_factor=cf)
                loc = out.to_local()
                loss = R * (loc * torch.as_tensor(w[idx * b:(idx + 1) * b])).sum() \
                    + aux.to_local()
                grads = torch.autograd.grad(loss, [x_loc] + list(tp.values()))
            held.update(out=loc.detach(), aux=aux.to_local().detach(), grads=grads)

        moe_mod.route = route
        try:
            cost = count_cost(run)
        finally:
            moe_mod.route = real_route
        # the minor axis first: a concatenation's order is the stream's
        group = [mesh.get_group(a) for a in reversed(sharding.dp_axes())]

        def over_dp(t, op):
            t = t.contiguous()
            for g in group:
                if op == "cat":
                    parts = [torch.empty_like(t) for _ in range(g.size())]
                    torch.distributed.all_gather(parts, t, group=g)
                    t = torch.cat(parts)
                else:
                    torch.distributed.all_reduce(t, group=g)
            return t

        out = over_dp(held["out"], "cat")
        dx = over_dp(held["grads"][0], "cat") / R
        dparams = {}
        for k, g in zip(tp, held["grads"][1:]):
            dparams[k] = over_dp(g.full_tensor(), "sum") / R
        gate_idx = over_dp(routes[0].reshape(b, -1, cfg.top_k), "cat")
        if torch.distributed.get_rank() != 0:
            return None
        return {"out": np.asarray(out), "aux": float(held["aux"]), "dx": np.asarray(dx),
                "grads": {k: np.asarray(v) for k, v in dparams.items()},
                "gate_idx": np.asarray(gate_idx), "sites": dict(cost.coll_site_wire_bytes),
                "site_counts": dict(cost.coll_site_counts)}
    finally:
        set_mesh(None)


def vocab_parallel_loss(shape, logits, tokens, text_offset: int):
    """``next_token_loss`` of ``logits`` [b, s, V] (numpy float32) split over
    the vocab on the compute mesh (``model``), as ``lm_logits`` lays them
    out: rank 0 returns the loss and the whole gradient of the logits."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.models.sharding import compute_mesh
    from repro_torch.models.transformer import next_token_loss

    mesh = make_test_mesh(shape, device_type="cpu")
    set_mesh(mesh)
    try:
        cm = compute_mesh(mesh)
        x = distribute_tensor(torch.as_tensor(logits), cm, [Shard(2)]).requires_grad_()
        loss = next_token_loss(None, x, torch.as_tensor(tokens), text_offset=text_offset)
        loss.backward()
        grad = x.grad.full_tensor()
        local = x.grad.to_local().shape
        if torch.distributed.get_rank() != 0:
            return None
        return float(loss.to_local()), grad.numpy(), tuple(local)
    finally:
        set_mesh(None)


def cache_write(shape, src, cache_len: int, start: int):
    """``write_slice`` of ``src`` [b, n, kvh, hd] (numpy), split over heads
    on the compute mesh, into a zero cache [b, cache_len, kvh, hd] split over
    its sequence there: rank 0 returns the whole cache."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.models.sharding import compute_mesh, write_slice

    mesh = make_test_mesh(shape, device_type="cpu")
    try:
        cm = compute_mesh(mesh)
        s = torch.as_tensor(src)
        cache = distribute_tensor(torch.zeros(s.shape[0], cache_len, *s.shape[2:]), cm,
                                  [Shard(1)])
        write_slice(cache, 1, start, distribute_tensor(s, cm, [Shard(2)]))
        whole = cache.full_tensor()
        return whole.numpy() if torch.distributed.get_rank() == 0 else None
    finally:
        set_mesh(None)


#: what :func:`warm_up` left in this rank's process
WARMED: list = []


def warm_up() -> int:
    """A ``RankPool`` warm-up task: leaves a mark a later task reads."""
    WARMED.append(torch.distributed.get_rank())
    return WARMED[-1]


def warm_up_failing() -> int:
    """A warm-up task that fails on rank 1."""
    if torch.distributed.get_rank() == 1:
        raise ValueError("warm-up failed on purpose")
    return 0


def warmed() -> list:
    return list(WARMED)
