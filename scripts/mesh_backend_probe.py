#!/usr/bin/env python3
"""Which torch.distributed backend carries the collectives of several ranks
that share one CUDA card, and which functional collectives gloo runs there.

    python3 scripts/mesh_backend_probe.py        # on a machine with a card, ~3 min

Four processes on ``cuda:0`` (spawned, one file store per world):

1. per backend (NCCL, gloo), ``all_reduce``, ``all_gather_into_tensor`` and
   ``reduce_scatter_tensor`` of 4 MiB float32 tensors through the c10d API,
   three times each: right or the error, and the seconds of each call;
2. gloo, on the ``data`` axis of a (data=2, model=2) ``DeviceMesh``: each
   functional collective (``all_reduce``, ``all_gather_into_tensor``,
   ``reduce_scatter_tensor``, ``all_to_all_single``: what a ``DTensor``
   redistribution runs) as it is and staged through the host by
   ``repro_torch.launch.mesh.stage_gloo_cuda_collectives``, each in a world
   of its own, since a case may kill its ranks: right, the rank's exit
   code, or the seconds of four calls.

Prints one JSON object per case and the card's name and power limit; what
it found decides ``launch/mesh.py::choose_backend`` and
``GLOO_CUDA_STAGED``.
"""

from __future__ import annotations

import datetime
import json
import multiprocessing as mp
import os
import queue
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
FUNCTIONAL = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
              "all_to_all_single")


def _c10d(torch, dist, world: int) -> dict:
    out = {}
    for name in ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor"):
        secs, ok = [], None
        try:
            for _ in range(3):
                x = torch.full((1 << 20,), float(dist.get_rank() + 1), device="cuda")
                t0 = time.perf_counter()
                if name == "all_reduce":
                    dist.all_reduce(x)
                    ok = float(x[0]) == world * (world + 1) / 2
                elif name == "all_gather_into_tensor":
                    y = torch.empty(world << 20, device="cuda")
                    dist.all_gather_into_tensor(y, x)
                    ok = float(y[-1]) == world
                else:
                    y = torch.empty((1 << 20) // world, device="cuda")
                    dist.reduce_scatter_tensor(y, x)
                    ok = float(y[0]) == world * (world + 1) / 2
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            out[name] = {"ok": ok, "s": secs}
        except Exception as e:  # noqa: BLE001 - the probe reports what the backend refuses
            out[name] = {"error": repr(e)[:240]}
    return out


def _functional(torch, name: str, staged: bool) -> dict:
    import torch.distributed._functional_collectives as fc
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import stage_gloo_cuda_collectives

    if staged:
        stage_gloo_cuda_collectives(all_ops=True)
    group = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model")).get_group("data")
    rank = torch.distributed.get_rank()
    x = torch.arange(8, dtype=torch.float32, device="cuda") + rank
    secs = []
    for _ in range(4):
        t0 = time.perf_counter()
        if name == "all_reduce":
            y = fc.all_reduce(x, "sum", group)
        elif name == "all_gather_into_tensor":
            y = fc.all_gather_tensor(x, 0, group)
        elif name == "reduce_scatter_tensor":
            y = fc.reduce_scatter_tensor(x, "sum", 0, group)
        else:
            y = fc.all_to_all_single(x, None, None, group)
        y = fc.wait_tensor(y)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return {"values": y.cpu().tolist(), "s": secs}


def _rank(rank: int, backend: str, store: str, case, results) -> None:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{store}", world_size=WORLD,
                            rank=rank, timeout=datetime.timedelta(seconds=60))
    try:
        res = _c10d(torch, dist, WORLD) if case is None else _functional(torch, *case)
        results.put((rank, res))
    finally:
        dist.destroy_process_group()


def run(backend: str, case=None) -> dict:
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="probe") as tmp:
        procs = [ctx.Process(target=_rank, args=(r, backend, os.path.join(tmp, "store"), case,
                                                 results), daemon=True) for r in range(WORLD)]
        for p in procs:
            p.start()
        got, deadline = {}, time.monotonic() + 180
        while len(got) < WORLD and time.monotonic() < deadline:
            try:
                rank, res = results.get(timeout=1.0)
                got[rank] = res
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        return {"rank0": got.get(0), "exit_codes": [p.exitcode for p in procs]}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, NCCL "
          f"{torch.cuda.nccl.version() if torch.distributed.is_nccl_available() else None}")
    for backend in ("nccl", "gloo"):
        print(json.dumps({"c10d": backend, **run(backend)}), flush=True)
    for name in FUNCTIONAL:
        for staged in (False, True):
            print(json.dumps({"functional": name, "staged": staged,
                              **run("gloo", (name, staged))}), flush=True)


if __name__ == "__main__":
    main()
