"""The two-tier DSAG trainer, from ``repro.launch.train``.

Wires together

    model zoo / paper problem -> Tier-1 step (group gradients, K4 cache
    update, optimizer, QR for PCA) -> Tier-2 deadline controller
    (mask/flush/evict) -> failure detector -> (optional) straggler simulation
    -> (optional) checkpoints

on the card by default.  Two kinds of jobs share the loop: the model zoo's
ten archs, every family (``--arch qwen1.5-0.5b``, ``qwen2-7b``,
``qwen1.5-32b``, ``starcoder2-15b``, ``grok-1-314b``, ``deepseek-v2-236b``,
``mamba2-370m``, ``zamba2-2.7b``, ``pixtral-12b``, ``whisper-base``; the
smoke config unless ``--full``), whose per-group gradients come from
autograd over ``Model.train_loss`` (the MoE's aux loss included) on the
reference's synthetic batches (``repro_torch.data``: image or audio
embeddings beside the tokens where the family takes them), with the
parameters, moments and DSAG slots flat (``FlatLayout``) so K4 updates
every parameter in one launch per step; and the paper problems (``--arch
logreg`` / ``--arch pca``, K1/K5 group gradients).  Replaying a
``FleetTraces`` scenario through the
controller (``TrainerOptions.traces``) gives the (mask, flush, evict)
streams of the JAX package's controller and scalar simulator bit for bit;
``time_scale > 0`` turns the virtual straggler waits into real sleeps.
The host syncs where the reference does: metrics are drained every
``log_every`` steps, and an evaluation pulls one float to the host.

With ``checkpoint_dir`` set, the train state is saved every
``checkpoint_every`` steps on a background thread and once more, blocking,
after the last step (the reference's files: :mod:`repro_torch.checkpoint`);
``restore`` resumes from the newest checkpoint there, at the step after it.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b --full \\
      --steps 8 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b --steps 40 \\
      --device cpu --kernel-backend torch --check
  PYTHONPATH=src python -m repro_torch.launch.train --arch logreg --steps 20 --check
  PYTHONPATH=src python -m repro_torch.launch.train --arch pca --groups 8 \\
      --samples 512 --device cpu --kernel-backend torch
  PYTHONPATH=src python -m repro_torch.launch.train --arch logreg --steps 40 \\
      --checkpoint-dir ckpt [--restore]

On a device mesh (``TrainerOptions(mesh=)``: a ``DeviceMesh`` with the
axes ``("data", "model")``, one trainer per rank, run through
``repro_torch.launch.mesh.RankPool``) a model-zoo arch trains with the
reference's sharding: one DSAG group per data rank, parameters placed by
``Model.param_specs(fsdp)``, the step of ``core/dsag_pjit.py``'s mesh
branch; every rank runs the same Tier-2 controller on the same draws, so
their decisions agree.  The paper problems ignore the mesh, as the
reference's trainer does.  What a mesh does not run is refused with
``mesh-not-ported`` before any launch: the MoE family, the ``zero`` and
``none`` group layouts, int8 slots, adafactor, and checkpoints of a mesh
trainer (``restore_checkpoint(shardings=)`` restores a state onto a mesh).
An arch the registry does not hold is refused with :data:`CAP_ARCH`.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.checkpoint import train_state_from_tree, train_state_tree
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core.dsag_pjit import (
    GroupSpec,
    check_mesh_step,
    init_mesh_train_state,
    init_train_state,
    make_group_spec,
    make_train_step,
)
from repro_torch.data import make_batch_iterator
from repro_torch.experiments.engine import (
    CAP_ARCH,
    CAP_MESH,
    EngineCapabilityError,
    EngineConfig,
    engine_capability,
    refuse,
)
from repro_torch.ft.runtime import DeadlineController, FailureDetector
from repro_torch.ft.validation import trace_latency_fn
from repro_torch.latency.model import make_heterogeneous_cluster
from repro_torch.launch.paper_jobs import PAPER_ARCHES, make_paper_job, paper_train_config
from repro_torch.models import build_model
from repro_torch.models.model import check_mesh
from repro_torch.models.sharding import set_mesh

__all__ = ["CAP_ARCH", "Trainer", "TrainerOptions", "check_history", "main"]


@dataclasses.dataclass
class TrainerOptions:
    arch: str = "logreg"
    #: model-zoo archs: the reduced config (else the published widths)
    smoke: bool = True
    steps: int = 50
    global_batch: int = 8  # model-zoo archs: sequences per step, over all groups
    seq_len: int = 128
    #: model-zoo archs: the config's dtype replaced (e.g. "float32"); None keeps it
    dtype: str | None = None
    seed: int = 0
    checkpoint_dir: str | None = None
    restore: bool = False
    mesh: Any | None = None
    train_config: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    #: simulate straggling groups: per-step latency draws feed the deadline
    #: controller exactly like real step timings would
    simulate_stragglers: bool = True
    dsag_w: int | None = None  # wait-for-w groups (default: 3/4 of P)
    log_every: int = 10
    num_groups: int | None = None  # paper archs: group count (default 4)
    samples: int = 1024  # paper archs: problem size
    method: str = "dsag"  # dsag | sag (controller stale-acceptance mode)
    #: replay a pre-sampled FleetTraces scenario through the controller
    #: instead of live-sampling the straggler cluster (the pinned path)
    traces: Any | None = None
    scenario: int = 0
    #: seconds of real sleep per unit of virtual straggler time
    time_scale: float = 0.0
    eval_every: int = 0  # suboptimality eval cadence (0 = off)
    failure_max_misses: int = 5
    #: where the step runs: the card and its kernels unless asked otherwise
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)


class Trainer:
    def __init__(self, opts: TrainerOptions):
        self.opts = opts
        tc = opts.train_config
        if opts.method not in ("dsag", "sag"):
            raise ValueError(f"method {opts.method!r} not in ('dsag', 'sag')")
        self.job = None
        self.layout = None
        backend = opts.engine.kernel_backend
        if opts.arch in PAPER_ARCHES:
            G = opts.num_groups or 4
            self.gs = GroupSpec(num_groups=G, axes=())
            self.job = make_paper_job(opts.arch, G, samples=opts.samples, seed=opts.seed,
                                      engine=opts.engine)
            self.device = self.job.device
            self.data = self.job.batch_iterator()
            project_fn = self.job.project_fn if opts.arch == "pca" else None
            self.step_fn = make_train_step(self.job, tc, self.gs, None,
                                           project_fn=project_fn, backend=backend)
        else:
            cap = engine_capability(opts.engine)
            if not cap.supported:
                raise EngineCapabilityError(cap)
            cfg = get_smoke_config(opts.arch) if opts.smoke else get_config(opts.arch)
            if opts.dtype is not None:
                cfg = dataclasses.replace(cfg, dtype=opts.dtype)
            self.cfg = cfg
            self.model = build_model(cfg)
            self.layout = self.model.layout
            self.device = torch.device(opts.engine.device)
            if self.device.type == "cuda" and self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            self.gs = make_group_spec(tc, opts.mesh)
            param_specs = None
            if opts.mesh is not None:
                check_mesh(cfg)
                check_mesh_step(tc, self.gs, opts.mesh)
                if opts.checkpoint_dir:
                    raise refuse(CAP_MESH, "checkpoints of a mesh trainer")
                set_mesh(opts.mesh)
                param_specs = self.model.param_specs(tc.fsdp)
            if opts.global_batch % self.gs.num_groups:
                raise ValueError(f"global batch {opts.global_batch} not divisible by "
                                 f"{self.gs.num_groups} DSAG groups")
            self.data = make_batch_iterator(cfg, self.gs.num_groups, opts.global_batch,
                                            opts.seq_len, seed=opts.seed)

            def loss_fn(params, batch):
                return self.model.train_loss(params, batch, remat=tc.remat)

            self.step_fn = make_train_step(loss_fn, tc, self.gs, opts.mesh, param_specs,
                                           backend=backend, layout=self.layout)
        G = self.gs.num_groups

        # Tier-2 control plane
        w = opts.dsag_w or max(1, (3 * G) // 4)
        self.deadlines = DeadlineController(
            G, w=w, margin=tc.dsag_margin, accepts_stale=opts.method == "dsag"
        )
        self.failures = FailureDetector(G, max_misses=opts.failure_max_misses)
        self.ckpt = (
            CheckpointManager(opts.checkpoint_dir, keep=tc.keep_checkpoints)
            if opts.checkpoint_dir
            else None
        )
        if opts.traces is not None:
            loads = self.job.loads if self.job is not None else np.ones(G)
            self._latency_of = trace_latency_fn(opts.traces, opts.scenario, loads)
            self._churn = opts.traces.churn
            self.straggler_sim = None
        else:
            self._latency_of = None
            self._churn = None
            self.straggler_sim = (
                make_heterogeneous_cluster(
                    G,
                    comp_range=(0.9, 1.4),
                    comm_range=(0.01, 0.05),
                    cv_comp=0.08,
                    seed=opts.seed + 3,
                )
                if opts.simulate_stragglers
                else None
            )

    @property
    def _rank(self) -> int:
        """This process's rank in a mesh run (0 otherwise): only rank 0 logs."""
        if self.opts.mesh is None:
            return 0
        return torch.distributed.get_rank()

    # -- lifecycle ---------------------------------------------------------
    def init_state(self):
        """A fresh train state; a model's parameters drawn from a seeded
        ``torch.Generator`` on the trainer's device."""
        if self.job is not None:
            params = self.job.init_params(self.opts.seed)
        else:
            gen = torch.Generator(device=self.device).manual_seed(self.opts.seed)
            tree = self.model.init(gen)
            if self.opts.mesh is not None:  # every rank draws the same, keeps its shard
                return init_mesh_train_state(tree, self.opts.train_config, self.gs,
                                             self.step_fn.layouts, self.opts.mesh)
            params = self.layout.flatten(tree)
        return init_train_state(params, self.opts.train_config, self.gs, self.layout)

    def _tree(self, state):
        """What a checkpoint holds: a model's state as the reference's tree."""
        return state if self.layout is None else train_state_tree(state, self.layout)

    def maybe_restore(self, state):
        """``(state, first step)``: the newest checkpoint's state and the
        step after it when ``restore`` is set and one exists."""
        if self.ckpt is None or not self.opts.restore:
            return state, 0
        restored, step = self.ckpt.restore_latest(self._tree(state))
        if restored is None:
            return state, 0
        if self.layout is not None:
            restored = train_state_from_tree(restored, self.layout)
        print(f"[train] restored checkpoint at step {step}")
        return restored, step + 1

    def batch_on_device(self, batch):
        """A model-zoo batch (numpy, every leaf [P, ...]) on the trainer's
        device; a paper job's batch as its iterator gives it."""
        if self.job is not None:
            return batch
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    def _group_latencies(self, step: int) -> np.ndarray:
        if self.straggler_sim is None:
            return np.ones(self.gs.num_groups)
        return self.straggler_sim.sample_all(c=1.0, now=float(step))

    def _step_inputs(self, step: int):
        """One Tier-2 decision: (mask, flush, evict, virtual elapsed)."""
        if self._latency_of is not None:
            alive = (
                self._churn.alive_at(self.deadlines.now)
                if self._churn is not None
                else None
            )
            si = self.deadlines.step_inputs(self._latency_of, alive=alive)
            mask_np, flush_np, evict_np = si.mask, si.flush, si.evict
            elapsed = si.elapsed
        else:
            lat = self._group_latencies(step)
            mask_np, flush_np = self.deadlines.step_masks(lat, step)
            evict_np = np.zeros(self.gs.num_groups, dtype=bool)
            elapsed = 0.0
        was_failed = self.failures.failed.copy()
        self.failures.observe(mask_np)
        # failed groups cannot flush; newly-failed groups get their cache
        # entry evicted (paper §6.3) so H stays unbiased
        flush_np = np.logical_and(flush_np, ~self.failures.failed)
        evict_np = np.logical_or(
            evict_np, np.logical_and(self.failures.failed, ~was_failed)
        )
        return mask_np, flush_np, evict_np, elapsed

    # -- main loop ----------------------------------------------------------
    def run(self) -> dict[str, list]:
        """Train up to ``opts.steps`` steps from a fresh state (or the
        restored one); the final train state is kept as ``self.state``."""
        opts = self.opts
        tc = opts.train_config
        state, start_step = self.maybe_restore(self.init_state())
        history: dict[str, list] = {
            "loss": [],
            "xi": [],
            "mask_count": [],
            "step_time": [],
            "virtual": [],
            "eval": [],  # (step, wall s, virtual s, suboptimality)
            # per-step Tier-2 decisions, for the cross-layer pin
            "mask_stream": [],
            "flush_stream": [],
            "evict_stream": [],
        }
        #: device-side metrics, materialized every log_every steps (and at
        #: the end) so the host never forces a per-step sync
        pending: list[tuple[int, dict, float]] = []

        def drain():
            for s, m, dt in pending:
                history["loss"].append(float(m["loss"]))
                history["xi"].append(float(m["xi"]))
                history["mask_count"].append(int(m["mask_count"]))
                history["step_time"].append(dt)
            pending.clear()

        G = self.gs.num_groups
        dev = self.device
        wall0 = time.perf_counter()
        for step in range(start_step, opts.steps):
            batch = next(self.data)
            if tc.dsag:
                mask_np, flush_np, evict_np, elapsed = self._step_inputs(step)
                history["mask_stream"].append(mask_np.copy())
                history["flush_stream"].append(flush_np.copy())
                history["evict_stream"].append(evict_np.copy())
            else:
                mask_np = np.ones(G, bool)
                flush_np = np.zeros(G, bool)
                evict_np = flush_np
                elapsed = 0.0
            if opts.time_scale > 0 and elapsed > 0:
                # make the virtual straggler wait real
                time.sleep(elapsed * opts.time_scale)
            t0 = time.perf_counter()
            bits = torch.from_numpy(np.stack([mask_np, flush_np, evict_np]))
            if dev.type == "cuda":
                # one copy of the [3, G] decision per step, from pinned memory
                # so it queues behind the previous step instead of waiting
                bits = bits.pin_memory().to(dev, non_blocking=True)
            state, metrics = self.step_fn(state, self.batch_on_device(batch),
                                          bits[0], bits[1], bits[2])
            pending.append((step, metrics, time.perf_counter() - t0))
            history["virtual"].append(float(self.deadlines.now))
            if (self.job is not None and opts.eval_every > 0
                    and (step % opts.eval_every == 0 or step == opts.steps - 1)):
                # pulls the params (a sync point): keep the cadence coarse
                gap = self.job.suboptimality(state["params"])
                history["eval"].append(
                    (step, time.perf_counter() - wall0, float(self.deadlines.now), gap)
                )
            if step % opts.log_every == 0:
                drain()
                if self._rank == 0:
                    print(
                        f"[train] step {step:5d} loss {history['loss'][-1]:.4f} "
                        f"xi {history['xi'][-1]:.2f} "
                        f"fresh {history['mask_count'][-1]}/{G} "
                        f"({history['step_time'][-1]*1e3:.0f} ms)"
                    )
            if self.ckpt and (step + 1) % tc.checkpoint_every == 0:
                self.ckpt.save(step, self._tree(state))
        drain()
        if self.ckpt and opts.steps > start_step:
            self.ckpt.save(opts.steps - 1, self._tree(state), blocking=True)
        history["wall_seconds"] = [time.perf_counter() - wall0]
        self.state = state
        return history


def check_history(hist: dict) -> tuple[bool, str]:
    """The ``--check`` gate: ξ reached 1 and the loss decreased (first
    quarter of the steps against the last quarter)."""
    if not hist["loss"]:
        return False, "[check] FAILED: no steps ran"
    q = max(1, len(hist["loss"]) // 4)
    first = float(np.mean(hist["loss"][:q]))
    last = float(np.mean(hist["loss"][-q:]))
    xi_max = max(hist["xi"])
    ok = last < first and xi_max >= 1.0 - 1e-6
    return ok, (f"[check] loss {first:.4f} -> {last:.4f}; max xi {xi_max:.3f}: "
                f"{'OK' if ok else 'FAILED'}")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="logreg",
                    help=f"a model-zoo arch (e.g. qwen1.5-0.5b, mamba2-370m) or one of "
                         f"{PAPER_ARCHES}")
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="model-zoo archs: the published widths (default: the smoke config)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8, help="model-zoo archs: global batch")
    ap.add_argument("--seq", type=int, default=128, help="model-zoo archs: sequence length")
    ap.add_argument("--samples", type=int, default=1024)
    ap.add_argument("--groups", type=int, default=None)
    ap.add_argument("--method", default="dsag", choices=["dsag", "sag"])
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--no-dsag", action="store_true")
    ap.add_argument("--optimizer", default="adamw",
                    help="model-zoo archs: adamw | adafactor | sgd")
    ap.add_argument("--lr", type=float, default=None,
                    help="step size (default: 3e-4 for a model, eta = 0.25 for the paper archs)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--kernel-backend", default="cuda", choices=["cuda", "torch"],
                    help="the CUDA kernels (default) or their plain-torch versions")
    ap.add_argument("--check", action="store_true",
                    help="assert ξ reached 1.0 and the loss decreased (smoke gate)")
    args = ap.parse_args(argv)
    if args.arch in PAPER_ARCHES:
        tc = paper_train_config(0.25 if args.lr is None else args.lr, dsag=not args.no_dsag)
    else:
        tc = TrainConfig(dsag=not args.no_dsag, optimizer=args.optimizer,
                         learning_rate=3e-4 if args.lr is None else args.lr)
    opts = TrainerOptions(
        arch=args.arch,
        smoke=args.smoke,
        steps=args.steps,
        global_batch=args.batch,
        seq_len=args.seq,
        samples=args.samples,
        num_groups=args.groups,
        method=args.method,
        seed=args.seed,
        checkpoint_dir=args.checkpoint_dir,
        restore=args.restore,
        train_config=tc,
        engine=EngineConfig(device=args.device, kernel_backend=args.kernel_backend),
    )
    hist = Trainer(opts).run()
    if hist["loss"]:
        print(f"[train] done; final loss {hist['loss'][-1]:.4f}")
    else:
        print("[train] done; no steps to run")
    if args.check:
        ok, msg = check_history(hist)
        print(msg)
        if not ok:
            raise SystemExit(1)


if __name__ == "__main__":
    main()
