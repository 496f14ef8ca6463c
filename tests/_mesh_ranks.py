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


def smoke_model(arch: str, dtype: str):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
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
        tree = model.init(torch.Generator().manual_seed(seed))
        state = init_mesh_train_state(tree, tc, gs, step.layouts, mesh)
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


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def serve(arch: str, dtype: str, shape, batch, num_tokens: int, max_len: int, seed: int = 0):
    """``Server(mesh=)`` on ``arch``'s smoke model: the whole batch's
    generated tokens, and the prefill's last logits of this rank's batch
    slice."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.serve import Server
    from repro_torch.models.sharding import dp_coordinate, full

    mesh = make_test_mesh(shape, device_type="cpu")
    try:
        srv = Server(arch, device="cpu", kernel_backend="torch", max_len=max_len, seed=seed,
                     mesh=mesh, dtype=dtype)
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
        state = init_mesh_train_state(model.init(torch.Generator().manual_seed(0)), tc, gs,
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
