"""Meshes: the scenario mesh of the device engine (counterpart of
``repro.launch.mesh.make_scenario_mesh``) and the model zoo's device mesh
(``make_production_mesh``, ``make_test_mesh``) with the processes that run
it (:class:`RankPool`).

The reference shards the ``[S, ...]`` scenario batch of its fused scan over
a 1-D ``jax.sharding.Mesh`` with ``shard_map``.  The port's mesh is the
tuple of torch devices the shards run on, one shard per entry, in shard
order.  An entry may repeat: ``(cpu,) * 4`` runs four shards on the CPU
(the counterpart of ``--xla_force_host_platform_device_count=4``), and
``(cuda:0,) * 4`` four shards on one card, each on its own stream.  CUDA
entries name their card (``cuda:k``): the shards never depend on a
thread's current device.

The model zoo's mesh is a ``torch.distributed.device_mesh.DeviceMesh``
with the reference's shapes and axis names, ``("data", "model")`` or
``("pod", "data", "model")``.  The reference is one program over every
device; the port runs one process per rank, each of which builds the same
``DeviceMesh`` over the process group (:func:`make_test_mesh`) and runs the
trainer or the server on it (``models/sharding.py`` says how the work is
split).  :class:`RankPool` starts those processes (``spawn``), joins them
in a process group whose backend :func:`choose_backend` picks, runs
functions on every rank and returns each rank's result to the caller.
Several ranks may share a card: NCCL refuses two ranks on one device
("Duplicate GPU detected"), so such a world runs over gloo, which stages
CUDA tensors through the host; the one functional collective gloo cannot
run on CUDA tensors, the all-gather, is staged by hand
(:func:`stage_gloo_cuda_collectives`).
"""

from __future__ import annotations

import dataclasses
import datetime
import faulthandler
import multiprocessing as mp
import os
import queue
import tempfile
import threading
import time
import traceback
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ScenarioMesh:
    """The devices of a scenario-sharded run, one shard each, in shard order."""

    devices: tuple[torch.device, ...]

    def __post_init__(self):
        devices = tuple(torch.device(d) for d in self.devices)
        if not devices:
            raise ValueError("a ScenarioMesh needs at least one device")
        types = {d.type for d in devices}
        if len(types) > 1:
            raise ValueError(f"a ScenarioMesh's devices must be of one type, got {sorted(types)}")
        if types - {"cpu", "cuda"}:
            raise ValueError(f"a ScenarioMesh runs on cpu or cuda devices, got {sorted(types)}")
        if any(d.type == "cuda" and d.index is None for d in devices):
            raise ValueError("name each card of a ScenarioMesh (cuda:k), not cuda")
        object.__setattr__(self, "devices", devices)

    @property
    def size(self) -> int:
        """The number of shards."""
        return len(self.devices)

    @property
    def device_type(self) -> str:
        return self.devices[0].type


def make_scenario_mesh(num_devices: int | None = None) -> ScenarioMesh:
    """The first ``num_devices`` visible cards (all of them for ``None``),
    one shard each.  Raises ``ValueError``, before any launch, when more are
    asked for than ``torch.cuda.device_count()`` sees."""
    avail = torch.cuda.device_count()
    if num_devices is None:
        num_devices = avail
    if not 1 <= num_devices <= avail:
        raise ValueError(
            f"make_scenario_mesh: requested {num_devices} devices but only {avail} CUDA "
            f"devices are visible (several shards on one device: pass "
            f"ScenarioMesh((torch.device('cuda', 0),) * n))"
        )
    return ScenarioMesh(tuple(torch.device("cuda", k) for k in range(num_devices)))


# ---------------------------------------------------------------------------
# The model zoo's device mesh, and the processes that run it
# ---------------------------------------------------------------------------

#: several ranks on one card, or a backend this torch lacks
CAP_MESH_BACKEND = "mesh-backend-unavailable"


def _device_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device_type: str | None):
    from torch.distributed.device_mesh import init_device_mesh

    if not torch.distributed.is_initialized():
        raise RuntimeError("a device mesh needs the process group of its ranks: run it "
                           "inside RankPool (or init_process_group yourself)")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None):
    """Single pod: 16x16 = 256 ranks (data, model).
    Multi-pod: 2x16x16 = 512 ranks (pod, data, model).  Built over the
    current process group, which must have that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(shape, axes, device_type)


def make_test_mesh(devices_per_axis=(2, 4), device_type: str | None = None):
    """Small mesh over the current process group (8 ranks by default):
    ``("data", "model")`` for two axes, ``("pod", "data", "model")`` for three."""
    axes = ("data", "model") if len(devices_per_axis) == 2 else ("pod", "data", "model")
    return _device_mesh(tuple(devices_per_axis), axes, device_type)


def card_turns(fn, device: torch.device):
    """``fn()`` on this rank, the ranks whose ``device`` is the same card
    taking turns (one at a time, a barrier after each turn), so that a
    transient as large as a whole full-width leaf's draw is on the card once,
    not once per rank; a single turn where every rank has a card of its own,
    and on the CPU.  Every rank of the process group calls it.  Returns
    ``fn()``."""
    dist = torch.distributed
    key = (os.uname().nodename, device.index) if device.type == "cuda" else None
    keys: list = [None] * dist.get_world_size()
    dist.all_gather_object(keys, key)
    mine = [r for r, k in enumerate(keys) if k == key and key is not None]
    turns = max((keys.count(k) for k in keys if k is not None), default=1)
    turn = mine.index(dist.get_rank()) if mine else 0
    out = None
    for t in range(turns):
        if t == turn:
            out = fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
                torch.cuda.empty_cache()
        if turns > 1:
            dist.barrier()
    return out


def choose_backend(device_type: str, world: int) -> str:
    """The process group's backend for ``world`` ranks on ``device_type``:
    gloo on the CPU; on CUDA, NCCL when every rank has a card of its own,
    else gloo (NCCL refuses two ranks on one device).  Refused with
    :data:`CAP_MESH_BACKEND` (or ``cuda-device-unavailable``) before any
    process starts when this torch or machine cannot run it."""
    from repro_torch.experiments.engine import CAP_CUDA_UNAVAILABLE, refuse

    dist = torch.distributed
    if device_type == "cpu":
        backend = "gloo"
    elif device_type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise refuse(CAP_CUDA_UNAVAILABLE, "a CUDA mesh needs a card; torch sees none")
        backend = "nccl" if world <= cards and dist.is_nccl_available() else "gloo"
    else:
        raise ValueError(f"a mesh runs on cpu or cuda, got {device_type!r}")
    if not dist.is_available() or (backend == "gloo" and not dist.is_gloo_available()):
        raise refuse(CAP_MESH_BACKEND, f"{world} ranks on {device_type} need the {backend} "
                                       f"backend, which this torch lacks")
    return backend


#: the functional collectives that gloo does not run on CUDA tensors: in
#: torch 2.11 ``all_gather_into_tensor`` kills the rank (SIGSEGV in its
#: ``wait_tensor``), while ``all_reduce``, ``reduce_scatter_tensor`` and
#: ``all_to_all_single`` run (``scripts/mesh_backend_probe.py`` on an H100)
GLOO_CUDA_STAGED = ("all_gather_into_tensor",)
_staged_libs: list = []


def stage_gloo_cuda_collectives(all_ops: bool = False) -> None:
    """Run :data:`GLOO_CUDA_STAGED` (every functional collective with
    ``all_ops``: ``scripts/mesh_backend_probe.py``'s comparison) on host
    copies of CUDA tensors: the kernel registered for their CUDA inputs
    copies the input to the host, runs the CPU collective, waits for it and
    copies the result back (what gloo does inside for the collectives it
    runs on CUDA tensors).  For a process whose group is gloo over CUDA
    tensors (several ranks on one card); done once per process."""
    if _staged_libs:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    ops = torch.ops._c10d_functional
    names = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
             "all_to_all_single") if all_ops else GLOO_CUDA_STAGED
    for name in names:
        op = getattr(ops, name)

        def staged(x, *args, _op=op):
            return ops.wait_tensor(_op(x.cpu(), *args)).to(x.device)

        lib.impl(name, staged, "CUDA")
    _staged_libs.append(lib)


def _rank_main(rank: int, world: int, backend: str, device_type: str, store: str,
               tasks, results, timeout: float) -> None:
    """One rank: join the process group, then run the parent's tasks until
    it sends ``None``.  Each result (or the traceback) goes back tagged with
    the rank; a task still running after ``timeout`` seconds prints every
    thread's stack to stderr (the parent gives up on it then)."""
    faulthandler.enable()
    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        torch.distributed.init_process_group(
            backend, init_method=f"file://{store}", world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=600))
        if backend == "gloo" and device_type == "cuda":
            stage_gloo_cuda_collectives()
    except Exception:  # noqa: BLE001 - reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        return
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args, kwargs = task
            faulthandler.dump_traceback_later(timeout, exit=False)
            try:
                results.put((rank, True, fn(*args, **kwargs)))
            except Exception:  # noqa: BLE001 - reported to the parent, which raises
                results.put((rank, False, traceback.format_exc()))
            finally:
                faulthandler.cancel_dump_traceback_later()
    finally:
        torch.distributed.destroy_process_group()


class RankPool:
    """``world`` processes joined in one process group, reused for many runs.

    ``run(fn, *args)`` calls ``fn(*args)`` on every rank (``fn`` is pickled
    by its import path) and returns the ranks' results in rank order; a
    rank that raises makes ``run`` raise with its traceback, and the pool is
    then closed (the other ranks may wait in a collective); a rank whose
    task outlasts ``timeout`` prints its stacks and the run raises.  Each CUDA rank
    takes card ``rank % device_count``.  The kernels are built in this
    process first (``device_type="cuda"``), so the ranks load the library
    and never build it side by side.  ``warm``: a task every rank runs in a
    background thread from the start (first-use costs paid while the caller
    does other work); the first ``run`` waits for it, and a rank's failure
    there makes :meth:`wait_warm` (so that ``run``) raise.  Use as a context
    manager or call :meth:`close`: every process is stopped.
    """

    def __init__(self, world: int, device_type: str = "cuda", timeout: float = 900.0,
                 warm=None):
        self.world, self.device_type, self.timeout = world, device_type, timeout
        self.backend = choose_backend(device_type, world)
        if device_type == "cuda":
            from repro_torch.kernels import _build

            _build.library()
        ctx = mp.get_context("spawn")
        self._dir = tempfile.TemporaryDirectory(prefix="rankpool")
        store = os.path.join(self._dir.name, "store")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(world)]
        self._procs = [ctx.Process(target=_rank_main, daemon=True,
                                   args=(r, world, self.backend, device_type, store,
                                         self._tasks[r], self._results, timeout))
                       for r in range(world)]
        for p in self._procs:
            p.start()
        self._warm_error: BaseException | None = None
        self._warming = None
        if warm is not None:
            self._warming = threading.Thread(target=self._warm, args=(warm,), daemon=True)
            self._warming.start()

    def _warm(self, fn) -> None:
        try:
            self._run(fn)
        except BaseException as e:  # handed to the caller by wait_warm
            self._warm_error = e

    def wait_warm(self) -> None:
        """Wait for the ``warm`` task; raise its failure, once."""
        if self._warming is None:
            return
        self._warming.join()
        self._warming = None
        if self._warm_error is not None:
            raise RuntimeError("the rank pool's warm-up failed") from self._warm_error

    def run(self, fn, *args, **kwargs) -> list:
        self.wait_warm()
        return self._run(fn, *args, **kwargs)

    def _run(self, fn, *args, **kwargs) -> list:
        if not self._procs:
            raise RuntimeError("the rank pool is closed")
        for q in self._tasks:
            q.put((fn, args, kwargs))
        out: dict[int, Any] = {}
        failed = []
        deadline = time.monotonic() + self.timeout
        while len(out) + len(failed) < self.world:
            try:
                rank, ok, value = self._results.get(timeout=1.0)
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(self._procs)
                        if p.exitcode is not None]
                if dead or time.monotonic() > deadline:
                    self.close()
                    what = (f"rank {dead[0][0]} died (exit code {dead[0][1]})" if dead else
                            f"{self.world - len(out)} ranks gave no result within "
                            f"{self.timeout} s")
                    raise TimeoutError(f"{fn.__name__}: {what}") from None
                continue
            if ok:
                out[rank] = value
            else:
                failed.append((rank, value))
                break
        if failed:
            self.close()
            rank, tb = failed[0]
            raise RuntimeError(f"{fn.__name__} failed on rank {rank}:\n{tb}")
        return [out[r] for r in range(self.world)]

    def close(self) -> None:
        if self._warming not in (None, threading.current_thread()):
            self._warming.join()  # a failing warm-up closes the pool from its thread
        for q, p in zip(self._tasks, self._procs):
            if p.is_alive():
                q.put(None)
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        self._procs = []
        self._dir.cleanup()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

