"""Multi-pod dry run: count one step of every (arch x shape) cell on the
production mesh, on rank 0 of a fake world, over meta tensors; the
counterpart of ``repro.launch.dryrun``.

The reference lowers and compiles each cell's step for 256 (16x16) or 512
(2x16x16) host devices and reads XLA's memory and cost analyses.  The port
runs the step itself, as one rank of that mesh: a ``fake`` process group of
256 or 512 ranks, whose collectives move nothing, ``make_production_mesh``
over it, and every parameter, optimizer slot, cache and batch a meta tensor
of rank 0's local shape (shapes and dtypes, no storage).  The step runs
under :func:`~repro_torch.analysis.cost.count_cost`, which counts its FLOPs,
HBM bytes and collectives op by op, inside ``kernels._build.dry_run("card")``,
where K4, K4-int8 and K6 check their meta operands as their launch would,
report the launch with their cost models and launch nothing.  So a cell
counts in seconds on a CPU; no card is needed or used.

What each kind of cell counts:

* *train*: the mesh step of ``core/dsag_pjit.py::make_train_step`` under
  :func:`default_train_config`, from the meta train state of
  ``init_mesh_train_state`` (nothing drawn), over the grouped batch
  ``[P, B/P, ...]`` and the ``[P]`` mask, flush and evict bits;
* *prefill*: ``Server(mesh=)``'s prefill at ``cache_len = seq_len``: the
  weights degathered layer by layer as the port serves
  (``launch/serve.py::mesh_weights``), where the reference degathers all of
  them at once inside its jitted prefill;
* *decode*: one ``decode_step`` over the cache of ``cache_abstract(cfg,
  global_batch, seq_len)``, after the serving path's one gather of each
  layer (counted, as the reference's decode degathers inside its step).

Serving cells run under ``no_grad`` where ``Server.generate`` takes
``inference_mode``: the ops counted are the same (``count_cost`` splits a
composite op into its parts either way), and the host time is a fifth.

Each cell writes one JSON with the reference's keys (``count_s`` replaces
``lower_s`` and ``compile_s``); ``roofline`` is ``analysis/roofline.py``'s
``derive`` with ``num_devices`` the mesh's ranks: the H100's three terms,
collectives at ``LINK_BW``.  ``memory`` stands in for XLA's
``memory_analysis``: rank 0's local bytes of the step's arguments and
outputs, the outputs that share storage with an argument, and the peak of
the bytes that the step's own ops allocate and still hold (``count_cost``'s
``live``: :class:`~repro_torch.analysis.cost.LiveBytes`, storage lifetimes
seen from its dispatch mode).  It counts no fusion, no buffer
reuse beyond what the ops' own lifetimes give, and no allocator rounding.

  one cell:  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
                 --arch qwen2-7b --shape train_4k [--multi-pod]
  all cells: PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--force]
             (the cells one after another in this process; resumes from
             existing ``ok`` files; a cell that raises writes ``status: "fail"``)
  the table: PYTHONPATH=src python -m repro_torch.launch.dryrun --table [--multi-pod]

Results land in ``experiments/dryrun_torch/<mesh>/<arch>__<shape>.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from pathlib import Path
from typing import Any

import torch
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_flatten

from repro_torch.analysis import roofline as roofline_mod
from repro_torch.analysis.cost import LiveBytes, count_cost
from repro_torch.configs import (
    ARCHS,
    SHAPES,
    TrainConfig,
    cell_is_runnable,
    get_config,
    input_specs,
)
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.dsag_pjit import (
    GroupSpec,
    init_mesh_train_state,
    make_group_spec,
    make_train_step,
    mesh_sizes,
)
from repro_torch.kernels import _build
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.launch.serve import kept_weights, mesh_weights
from repro_torch.models import build_model
from repro_torch.models import sharding
from repro_torch.models.layers import set_tp_reduce_dtype
from repro_torch.models.model import sharded_cache
from repro_torch.models.sharding import P, local_shape, map_specs, placements, set_mesh
from repro_torch.optim.compression import Quantized

RESULTS_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
#: the seed of a concrete run's weights and inputs (:func:`count_on_mesh` off meta)
SEED = 0


# ---------------------------------------------------------------------------
# Per-arch training configuration heuristics (production defaults)
# ---------------------------------------------------------------------------


def default_train_config(num_params: int, multi_pod: bool,
                         overrides: dict | None = None) -> TrainConfig:
    """The reference's production defaults: adafactor above 50 B parameters
    (adamw below), FSDP above 1 B, int8 DSAG slots above 10 B (bfloat16
    below), ``pod`` (multi-pod) or ``zero`` (single pod) groups of 2 above
    50 B, ``dp`` groups below, full remat; ``overrides`` replaces fields."""
    big = num_params > 50e9
    kwargs: dict[str, Any] = dict(
        optimizer="adafactor" if big else "adamw",
        fsdp=num_params > 1e9,
        dsag=True,
        dsag_cache_dtype="int8" if num_params > 10e9 else "bfloat16",
        remat="full",
    )
    if big:
        kwargs.update(dsag_groups="pod" if multi_pod else "zero", dsag_num_groups=2)
    else:
        kwargs.update(dsag_groups="dp")
    if overrides:
        kwargs.update(overrides)
    return TrainConfig(**kwargs)


def sanitize_spec(spec, shape, mesh) -> P:
    """Drop mesh axes from dims they do not evenly divide (e.g. batch=1 cells
    cannot shard the batch axis).  ``mesh``: a ``DeviceMesh`` or a
    :class:`~repro_torch.configs.base.MeshConfig`."""
    sizes = mesh_sizes(mesh)
    ent = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, e in zip(shape, ent):
        axes = e if isinstance(e, tuple) else (e,) if e else ()
        factor = math.prod(sizes[a] for a in axes)
        out.append(e if factor and dim % factor == 0 else None)
    return P(*out)


def _grouped_batch_abstract(cfg: ModelConfig, shape: ShapeConfig, gs: GroupSpec, mesh) -> dict:
    """``[P, B/P, ...]`` train-batch stand-ins (:class:`~repro_torch.configs.
    InputSpec`) with the group spec and the inner data-parallel axes."""
    from repro_torch.configs import InputSpec

    flat = input_specs(cfg, shape, mesh=None)
    pcount = gs.num_groups
    inner_dp = tuple(a for a in mesh_sizes(mesh) if a in ("pod", "data") and a not in gs.axes)
    inner = inner_dp if len(inner_dp) > 1 else (inner_dp[0] if inner_dp else None)
    out = {}
    for name, sds in flat.items():
        b = sds.shape[0]
        if b % pcount:
            raise ValueError(f"{name}: a batch of {b} does not split into {pcount} groups")
        shape_g = (pcount, b // pcount) + sds.shape[1:]
        spec = P(gs.group_partition, inner, *([None] * (len(sds.shape) - 1)))
        out[name] = InputSpec(torch.empty(shape_g, dtype=sds.dtype, device="meta"), spec)
    return out


# ---------------------------------------------------------------------------
# The fake world and the memory estimate
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_world(size: int):
    """This process as rank 0 of a ``fake`` process group of ``size`` ranks:
    its collectives return at once and move nothing (meta tensors hold no
    data anyway).  The group is destroyed on exit, so cells run one after
    another in one process."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist = torch.distributed
    if dist.is_initialized():
        raise RuntimeError("a dry run makes its own fake process group; this process "
                           "already has one")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _plain_tensors(tree) -> list[torch.Tensor]:
    """The plain tensors of a tree of dicts, lists, :class:`Quantized` and
    ``DTensor`` leaves (a DTensor's local shard)."""
    out = []
    for x in tree_flatten(tree)[0]:
        if isinstance(x, Quantized):
            out += [x.q, x.scale]
        elif isinstance(x, DTensor):
            out.append(x.to_local())
        elif isinstance(x, torch.Tensor):
            out.append(x)
    return out


def _key(t: torch.Tensor):
    return t.untyped_storage()._cdata


def _local_bytes(tree) -> int:
    """The bytes of a tree's tensors (each a rank's local shard), a tensor
    counted once however many leaves hold it."""
    seen = {}
    for t in _plain_tensors(tree):
        seen[(_key(t), t.storage_offset(), tuple(t.shape), tuple(t.stride()))] = (
            t.numel() * t.element_size())
    return sum(seen.values())


def _memory(inputs, outputs, live: LiveBytes) -> dict:
    """The reference's ``memory`` fields from a counted step's ``inputs``,
    ``outputs`` and :class:`LiveBytes`: ``temp_bytes`` is the peak of the
    held bytes less the outputs' own (the outputs are held at the end), so
    ``peak_estimate_bytes`` = arguments + that peak."""
    arg = _local_bytes(inputs)
    keys = {_key(t) for t in _plain_tensors(inputs)}
    out_t = _plain_tensors(outputs)
    out = _local_bytes(outputs)
    alias = _local_bytes([t for t in out_t if _key(t) in keys])
    temp = max(live.peak - (out - alias), 0)
    return {"argument_bytes": arg, "output_bytes": out, "temp_bytes": temp,
            "alias_bytes": alias, "peak_estimate_bytes": arg + out + temp - alias}


# ---------------------------------------------------------------------------
# One step of a cell, counted on this rank
# ---------------------------------------------------------------------------


def _meta_shards(abstract, specs, mesh):
    """This rank's shard of each leaf of ``abstract`` under ``specs``, as
    meta tensors."""
    return map_specs(lambda t, spec: torch.empty(local_shape(t.shape, spec, mesh),
                                                 dtype=t.dtype, device="meta"),
                     abstract, specs)


def _input(spec_in, gen: torch.Generator | None, cfg: ModelConfig, device) -> torch.Tensor:
    """A model input of ``spec_in``'s shape and dtype: the meta tensor
    itself, or drawn from ``gen`` on ``device`` (token ids below the vocab,
    embeddings ~ N(0, 0.1²) as the stub frontends draw them)."""
    if gen is None:
        return spec_in.meta
    if spec_in.dtype == torch.int32:
        return torch.randint(0, cfg.vocab_size, spec_in.shape, generator=gen,
                             dtype=torch.int32).to(device)
    return (torch.randn(spec_in.shape, generator=gen) * 0.1).to(spec_in.dtype).to(device)


def _serve_rows(b: int, mesh) -> tuple[slice, tuple[str, ...]]:
    """This rank's rows of a served batch of ``b`` and the axes of its token
    stream: its slice over the data-parallel axes, or, where
    :func:`sanitize_spec` drops them (``long_500k``'s batch of 1), the whole
    batch on every data rank."""
    dp = sharding.dp_axes()
    if sanitize_spec(P(dp if len(dp) > 1 else dp[0]), (b,), mesh)[0] is None:
        return slice(0, b), ()
    idx, n = sharding.dp_coordinate(mesh)
    return slice(idx * (b // n), (idx + 1) * (b // n)), dp


def count_on_mesh(cfg: ModelConfig, shape: ShapeConfig, mesh, tc: TrainConfig | None = None,
                  *, mode: str = "card", device: str = "meta") -> dict:
    """Count one step of the (``cfg`` x ``shape``) cell on this rank of
    ``mesh`` (every rank of its process group calls it).  ``device="meta"``
    is the dry run: every input a meta tensor, the kernels under
    ``_build.dry_run(mode)``; any other device runs the same step on inputs
    drawn from :data:`SEED` there (the comparison a dry run is held to).
    ``tc`` is the train cell's config (:func:`default_train_config` if
    None).  Returns ``{"cost", "memory", "extra", "count_s"}``."""
    meta = device == "meta"
    gen = None if meta else torch.Generator().manual_seed(SEED)
    model = build_model(cfg)
    nparams = model.num_params()
    set_mesh(mesh)
    result: dict = {}
    try:
        if shape.kind == "train":
            tc = tc or default_train_config(nparams, "pod" in mesh_sizes(mesh))
            if tc.bf16_reduce:
                set_tp_reduce_dtype(torch.bfloat16)
            gs = make_group_spec(tc, mesh)
            param_specs = model.param_specs(tc.fsdp)
            step = make_train_step(
                lambda p, b: model.train_loss(p, b, remat=tc.remat, fused_loss=tc.fused_loss),
                tc, gs, mesh, param_specs, backend="cuda", layout=model.layout)
            L = step.layouts
            shards = (_meta_shards(model.abstract(), L.specs, mesh) if meta else
                      model.init(torch.Generator(device=device).manual_seed(SEED), L.specs, mesh))
            state = init_mesh_train_state(shards, tc, gs, L, mesh)
            del shards
            batch = {k: _input(v, gen, cfg, device)
                     for k, v in _grouped_batch_abstract(cfg, shape, gs, mesh).items()}
            bits = torch.ones(gs.num_groups, dtype=torch.bool, device=device)
            masks = (bits, torch.zeros_like(bits), torch.zeros_like(bits))
            inputs = [state, {k: L.local_batch(v) for k, v in batch.items()}, masks]

            def run():
                return step(state, batch, *masks)

            ctx = contextlib.nullcontext()
            result["extra"] = {"train_config": dataclasses.asdict(tc),
                               "num_groups": gs.num_groups}
        else:
            from torch.distributed.tensor.experimental import implicit_replication

            param_specs = model.param_specs(nparams > 1e9)
            stored = (_meta_shards(model.abstract(), param_specs, mesh) if meta else
                      model.init(torch.Generator(device=device).manual_seed(SEED), param_specs,
                                 mesh))
            params = map_specs(lambda t, spec: DTensor.from_local(
                t, mesh, placements(spec, mesh), run_check=False), stored, param_specs)
            del stored
            rows, stream = _serve_rows(shape.global_batch, mesh)
            flat = input_specs(cfg, shape)
            batch = {k: _input(v, gen, cfg, device)[rows] for k, v in flat.items()}
            if shape.kind == "prefill":
                inputs = [params, batch]

                def run():
                    weights = mesh_weights(params, param_specs, mesh)
                    return model.prefill(weights, batch, cache_len=shape.seq_len)
            else:
                cmesh = sharding.compute_mesh(mesh)
                b = batch["tokens"].shape[0]
                cache = sharded_cache(cfg, b, shape.seq_len, cmesh, torch.device(device))
                tokens = batch["tokens"]
                inputs = [params, tokens, cache]

                def run():
                    weights = kept_weights(mesh_weights(params, param_specs, mesh))
                    return model.decode_step(weights, tokens, cache, shape.seq_len - 1)

            # no_grad where the Server takes inference_mode: the same ops are
            # counted, and DTensor meets each composite op (einsum) in its
            # parts, not whole through its sharding propagation by
            # decomposition, which costs the host several times over
            ctx = contextlib.ExitStack()
            for c in (torch.no_grad(), implicit_replication(), sharding.token_stream(stream)):
                ctx.enter_context(c)
            result["extra"] = {"degather": "layer by layer, as launch/serve.py serves "
                                           "(the reference: all weights at once)"}
        held: dict = {}
        t0 = time.perf_counter()
        live = LiveBytes(_key(t) for t in _plain_tensors(inputs))
        with ctx, _build.dry_run(mode):
            cost = count_cost(lambda: held.update(out=run()), live=live)
        result["count_s"] = time.perf_counter() - t0
        result["cost"] = cost
        result["memory"] = _memory(inputs, held["out"], live)
        return result
    finally:
        set_mesh(None)
        set_tp_reduce_dtype(None)


def dry_count(cfg: ModelConfig, shape: ShapeConfig, mesh_shape, tc: TrainConfig | None = None,
              *, mode: str = "card") -> dict:
    """:func:`count_on_mesh` over meta tensors on rank 0 of a fake world of
    ``prod(mesh_shape)`` ranks laid out as ``make_test_mesh(mesh_shape)``
    (``(16, 16)`` and ``(2, 16, 16)`` are the production meshes)."""
    with fake_world(math.prod(mesh_shape)):
        mesh = make_test_mesh(tuple(mesh_shape), device_type="cpu")
        return count_on_mesh(cfg, shape, mesh, tc, mode=mode, device="meta")


def count_rank(cfg: ModelConfig, shape: ShapeConfig, mesh_shape,
               tc: TrainConfig | None = None) -> dict | None:
    """The concrete twin of :func:`dry_count`, run on every rank of a real
    process group of CPU ranks (``launch/mesh.py::RankPool``): the same step
    on inputs drawn on the CPU, counted; rank 0 returns its count, the
    others None."""
    mesh = make_test_mesh(tuple(mesh_shape), device_type="cpu")
    out = count_on_mesh(cfg, shape, mesh, tc, device="cpu")
    return out if torch.distributed.get_rank() == 0 else None


# ---------------------------------------------------------------------------
# Cell runners
# ---------------------------------------------------------------------------


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch: str, shape_name: str, multi_pod: bool, overrides=None,
             cfg: ModelConfig | None = None) -> dict:
    """One cell on the production mesh: its JSON as a dict.  ``overrides``
    replaces :func:`default_train_config`'s fields; ``cfg`` replaces the
    arch's published config (a cut depth: the train config is still the
    published size's)."""
    shape = SHAPES[shape_name]
    published = build_model(get_config(arch)).num_params()
    cfg = cfg or get_config(arch)
    nparams = build_model(cfg).num_params()
    tc = (default_train_config(published, multi_pod, overrides) if shape.kind == "train"
          else None)
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        out = count_on_mesh(cfg, shape, mesh, tc, mode="card", device="meta")
        num_devices = mesh.size()
    cost = out["cost"]
    rl = roofline_mod.derive(cfg, shape, nparams, cost, num_devices=num_devices)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": _mesh_name(multi_pod),
        "status": "ok",
        "num_params": nparams,
        "count_s": out["count_s"],
        "memory": out["memory"],
        "cost": {"flops": cost.flops, "bytes accessed": cost.bytes,
                 "flops by peak": {str(k): v for k, v in cost.flops_at_peak.items()},
                 "kernels": {r.name: dataclasses.asdict(r) for r in cost.rows.values()
                             if not r.name.startswith("aten.")},
                 "collective sites": dict(cost.coll_site_wire_bytes)},
        "roofline": rl.as_dict(),
        **out["extra"],
    }


def result_path(arch: str, shape_name: str, multi_pod: bool) -> str:
    d = RESULTS_DIR / _mesh_name(multi_pod)
    d.mkdir(parents=True, exist_ok=True)
    return str(d / f"{arch}__{shape_name}.json")


def summary(result: dict) -> str:
    """The one-line summary of a cell's JSON."""
    mem_gb = result["memory"]["peak_estimate_bytes"] / 2**30
    rl = result["roofline"]
    return (f"[dryrun] {result['arch']} x {result['shape']} OK: count {result['count_s']:.1f}s, "
            f"~{mem_gb:.2f} GiB/device, terms c/m/x = "
            f"{rl['compute_s']:.4f}/{rl['memory_s']:.4f}/{rl['collective_s']:.4f} s, "
            f"dominant={rl['dominant']}, mfu={rl['mfu']:.3f}")


def run_all(multi_pod: bool, force: bool = False) -> int:
    """Every runnable cell, one after another in this process (the fake
    world is made and destroyed per cell); resume-safe: a cell with an
    ``ok`` file is skipped unless ``force``.  Returns the failures."""
    failures = 0
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape_name, shape in SHAPES.items():
            if not cell_is_runnable(cfg, shape):
                continue
            path = result_path(arch, shape_name, multi_pod)
            if os.path.exists(path) and not force:
                with open(path) as f:
                    if json.load(f).get("status") == "ok":
                        print(f"[dryrun] skip (done): {arch} x {shape_name}")
                        continue
            print(f"[dryrun] {arch} x {shape_name} ({_mesh_name(multi_pod)}) ...", flush=True)
            try:
                result = run_cell(arch, shape_name, multi_pod)
            except Exception:  # noqa: BLE001 - recorded in the cell's file
                failures += 1
                err = traceback.format_exc()[-2000:]
                result = {"arch": arch, "shape": shape_name, "status": "fail",
                          "mesh": _mesh_name(multi_pod), "error": err}
                print(f"[dryrun]   FAIL:\n{err}")
            else:
                print(summary(result), flush=True)
            with open(path, "w") as f:
                json.dump(result, f, indent=2)
    return failures


def table(multi_pod: bool) -> str:
    """The mesh's result files as a markdown table, one row per arch, one
    column per shape: peak GiB per rank; the compute, memory and collective
    terms (s, at the H100's peaks: a count, not a timing); the dominant
    term; mfu; wire GiB per rank by kind (all-gather / all-reduce /
    reduce-scatter)."""
    lines = ["| arch | " + " | ".join(SHAPES) + " |", "| --- " * (len(SHAPES) + 1) + "|"]
    for arch in ARCHS:
        cells = []
        for shape_name in SHAPES:
            path = RESULTS_DIR / _mesh_name(multi_pod) / f"{arch}__{shape_name}.json"
            r = json.loads(path.read_text()) if path.exists() else {"status": "—"}
            if r["status"] != "ok":
                cells.append(r["status"])
                continue
            rl, wire = r["roofline"], r["roofline"]["collectives"].get("wire_bytes", {})
            cells.append(
                f"{r['memory']['peak_estimate_bytes'] / 2**30:.1f} GiB; "
                f"{rl['compute_s']:.3g} / {rl['memory_s']:.3g} / {rl['collective_s']:.3g} s "
                f"({rl['dominant'][0]}); mfu {rl['mfu']:.2g}; " + " / ".join(
                    f"{wire.get(k, 0.0) / 2**30:.3g}"
                    for k in ("all-gather", "all-reduce", "reduce-scatter")))
        lines.append(f"| {arch} | " + " | ".join(cells) + " |")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=list(ARCHS))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--table", action="store_true",
                    help="print the mesh's result files as a markdown table")
    args = ap.parse_args(argv)

    if args.table:
        print(table(args.multi_pod))
        return

    if args.all:
        failures = run_all(args.multi_pod, force=args.force)
        sys.exit(1 if failures else 0)

    if not (args.arch and args.shape):
        ap.error("--arch and --shape required (or --all)")
    result = run_cell(args.arch, args.shape, args.multi_pod)
    with open(result_path(args.arch, args.shape, args.multi_pod), "w") as f:
        json.dump(result, f, indent=2)
    print(summary(result))


if __name__ == "__main__":
    main()
