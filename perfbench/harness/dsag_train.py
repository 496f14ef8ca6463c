"""Runner of the DSAG training cells (``"runner": "dsag_train"``).

The window drives ``repro_torch.launch.train.Trainer.run`` at the
configuration file's sizes, with the traffic file's batch, sequence length,
train config and latency model.  The benchmark hands the trainer what it
draws from ``--seed`` through three of the instance's attributes: the
weights through ``init_state`` (later calls return the state the last
``run()`` left, so set-up and window are one training run of one state),
the batches through ``data``, and the group latencies through
``straggler_sim``.  Its wrappers around ``data``, ``_step_inputs`` (the
Tier-2 decision) and ``step_fn`` (the DSAG step) record the spans, the
decisions and, in set-up, each step's group losses and Ĥ norm.

Set-up (:meth:`Session.warm`) builds the trainer, makes the weights and
runs the first ``check_steps`` steps through ``run()`` (one, then the
rest): every shape, the kernel build and the allocator's pool warm up there,
the reference later follows exactly these steps, and their timing fixes the
window's step count to last about ``--seconds``.  The window
(:meth:`Session.window`) is one ``run()`` of those steps and a final
``synchronize``.  With ``--trace 1`` the profiler records the device's
activity over ``profile_steps[1]`` steps from window step
``profile_steps[0]`` on, then one step with the host's activity too
(:class:`_Probe`), and the rest of the window runs as untraced.

After the window the program's state is freed and :func:`reference`
recomputes the checked steps in plain float32 (``reference/``) from the
same seed's weights, batches and latencies; :mod:`harness.judge` compares.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import math
import sys
import time

import numpy as np
import torch

from harness import trace
from harness import traffic as gen
from harness import yardstick
from reference import dsag as dsag_ref


@dataclasses.dataclass
class Run:
    """What the metric readers read (``metrics/<name>.py``)."""

    setup_s: float
    window_s: float
    steps: int
    tokens_per_step: int
    peak_bytes: int
    num_params: int
    k4_bytes: int
    spans: trace.Spans
    profile: trace.Profile | None
    profiled_s: float  # host seconds of the profiled stretch, start to stop
    profiled_steps: int


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def program_config(config: dict):
    """The program's ``ModelConfig`` at the configuration file's sizes: the
    registry's entry with every field the file gives replaced."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ModelConfig

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    return dataclasses.replace(get_config(config["name"]),
                               **{k: v for k, v in config.items() if k in fields})


def _nest(flat: dict[str, torch.Tensor]) -> dict:
    out: dict = {}
    for path, t in flat.items():
        node = out
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t
    return out


def _leaf_norms(layout, flat: torch.Tensor, minus: dict | None = None) -> dict[str, float]:
    out = {}
    for leaf, view in zip(layout.leaves, layout.views(flat)):
        path = "/".join(leaf.path)
        t = view if minus is None else view - minus[path].to(view.dtype)
        out[path] = float(torch.linalg.vector_norm(t, dtype=torch.float64))
    return out


class _Probe:
    """Profiles two stretches of the window, each synchronized at both
    ends: ``count`` steps from window step ``first`` with the device's
    activity alone (its operations, busy and idle time, with the host
    slowed as little as the profiler can), then one step with the host's
    operators and the benchmark's spans too, which labels the device's idle
    gaps by what the host was doing."""

    def __init__(self, spans: trace.Spans, first: int, count: int, cuda: bool):
        self.spans, self.first, self.count, self.cuda = spans, first, count, cuda
        self.prof = self.rf = None
        self.device = self.labels = None  # (profiler, inner seconds)
        self.outer_s = 0.0  # host seconds of both stretches, start to stop
        self.t_outer = self.t_inner = 0.0

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def step(self, k: int) -> None:
        if k == self.first:
            self._start(labels=False)
        elif k == self.first + self.count:
            self._stop()
            self._start(labels=True)
        elif k == self.first + self.count + 1:
            self._stop()

    def _start(self, labels: bool) -> None:
        self.t_outer = time.perf_counter()
        self._sync()
        acts = [torch.profiler.ProfilerActivity.CUDA] if self.cuda else []
        if labels or not self.cuda:
            acts.insert(0, torch.profiler.ProfilerActivity.CPU)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        if labels:
            self.rf = torch.profiler.record_function(trace.PREFIX + "stretch")
            self.rf.__enter__()
            self.spans.labels = True
        self.spans.profiling = True
        self.t_inner = time.perf_counter()

    def _stop(self) -> None:
        if self.prof is None:
            return
        self._sync()
        inner = time.perf_counter() - self.t_inner
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        self.prof.stop()
        self.spans.profiling = self.spans.labels = False
        if self.rf is None:
            self.device = (self.prof, inner)
        else:
            self.labels = (self.prof, inner)
        self.prof = self.rf = None
        self.outer_s += time.perf_counter() - self.t_outer

    stop = _stop

    def profile(self) -> trace.Profile | None:
        if self.device is None:
            return None
        prof, inner = self.device
        label_ns, idle = trace.idle_gaps(self.labels[0]) if self.labels else (0, {})
        return trace.Profile(int(inner * 1e9), self.count, trace.device_ops(prof), idle,
                             label_ns)


class Session:
    """One trainer of a cell, fed from ``seed``."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        import repro_torch.launch.train as train_mod
        from repro_torch.configs.base import TrainConfig
        from repro_torch.core.dsag_pjit import init_train_state
        from repro_torch.experiments.engine import EngineConfig

        self.config, self.traffic, self.seed = config, traffic, seed
        self.model = importlib.import_module(f"reference.{config['reference']}")
        self.cuda = device.startswith("cuda")
        self.dev = torch.device(device)
        self.tc = tc = TrainConfig(**traffic["train_config"])
        opts = train_mod.TrainerOptions(
            arch=config["name"], smoke=False, steps=1, global_batch=traffic["global_batch"],
            seq_len=traffic["seq_len"], seed=seed, train_config=tc, dsag_w=traffic["w"],
            failure_max_misses=traffic["failure_max_misses"],
            engine=EngineConfig(device=device, kernel_backend="cuda" if self.cuda else "torch"))
        cfg = program_config(config)
        real_get_config = train_mod.get_config
        train_mod.get_config = lambda name: cfg
        try:
            self.trainer = trainer = train_mod.Trainer(opts)
        finally:
            train_mod.get_config = real_get_config
        if trainer.gs.num_groups != traffic["groups"]:
            raise ValueError(f"the trainer runs {trainer.gs.num_groups} groups, the traffic "
                             f"file {traffic['groups']}")
        specs = [(p, tuple(s), d) for p, s, d, _ in self.model.leaf_specs(config)]
        prog = [("/".join(x.path), tuple(x.shape), str(x.dtype).removeprefix("torch."))
                for x in trainer.layout.leaves]
        if specs != prog:
            raise ValueError(f"the reference's leaves {specs} are not the program's {prog}")

        self.weights = self.model.init_params(config, gen.weight_seed(seed), self.dev)
        self.latencies = gen.latencies(traffic, seed)
        self.batches = [self._tokens(k) for k in range(traffic["check_steps"])]
        self.spans = trace.Spans()
        self.decisions: list[np.ndarray] = []
        self.captured: list[tuple[torch.Tensor, torch.Tensor]] = []
        self.in_window = False
        self.window_step = 0
        self.probe: _Probe | None = None
        session = self

        class Feed:
            """The batches, one a step; in the window it also starts and
            stops the profiler."""

            def __iter__(self):
                return self

            def __next__(self):
                if session.in_window:
                    if session.probe is not None:
                        session.probe.step(session.window_step)
                    session.window_step += 1
                t0 = time.perf_counter()
                batch = {"tokens": session.batches.pop(0)}
                session.spans.items["data"].append(
                    (t0, time.perf_counter(), session.spans.profiling))
                return batch

        class Stragglers:
            """Each step's group latencies, drawn from the seed."""

            def __init__(self):
                self.k = 0

            def sample_all(self, c=1.0, now=0.0):
                self.k += 1
                return session.latencies[self.k - 1]

        def init_state():
            state = getattr(trainer, "state", None)
            if state is None:
                params = trainer.layout.flatten(_nest(session.weights))
                return init_train_state(params, tc, trainer.gs, trainer.layout)
            trainer.state = None
            return state

        step_inputs = trainer._step_inputs

        def decide(step):
            mask, flush, evict, elapsed = step_inputs(step)
            session.decisions.append(np.stack([mask, flush, evict]))
            return mask, flush, evict, elapsed

        step_fn = trainer.step_fn

        def step(state, batch, mask, flush, evict=None):
            new_state, metrics = step_fn(state, batch, mask, flush, evict)
            if not session.in_window:
                session.captured.append((metrics["per_group_loss"], metrics["grad_norm"]))
            return new_state, metrics

        trainer.init_state = init_state
        trainer.data = Feed()
        trainer.straggler_sim = Stragglers()
        trainer._step_inputs = self.spans.wrap("tier2", decide)
        trainer.step_fn = self.spans.wrap("step", step)

    def _tokens(self, step: int) -> torch.Tensor:
        return gen.tokens(self.traffic, self.config["vocab_size"], self.seed, step, self.dev)

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def warm(self) -> tuple[dict, float]:
        """The set-up steps: ``(the program's readings of them, seconds a
        step of the last ones took)``."""
        trainer, tc, n = self.trainer, self.tc, self.traffic["check_steps"]
        trainer.opts.steps = 1
        trainer.run()
        readings = {"first_grad": {k: v / (1 - tc.beta1) for k, v in _leaf_norms(
            trainer.layout, trainer.state["opt"]["m"]).items()},
            "change1": _leaf_norms(trainer.layout, trainer.state["params"], self.weights)}
        trainer.opts.steps = n - 1
        self.sync()
        t0 = time.perf_counter()
        trainer.run()
        self.sync()
        step_s = (time.perf_counter() - t0) / max(n - 1, 1)
        state = trainer.state
        readings["change"] = _leaf_norms(trainer.layout, state["params"], self.weights)
        readings["h"] = _leaf_norms(trainer.layout, state["dsag"]["h"])
        readings["losses"] = [[float(x) for x in loss.cpu()] for loss, _ in self.captured]
        readings["grad_norm"] = [float(g) for _, g in self.captured]
        self.weights = None
        self.captured = []
        return readings, step_s

    def window(self, steps: int, traced: bool) -> tuple[dict, float, float, int]:
        """``steps`` steps in one ``run()``: ``(history, its start on the
        host clock, its seconds, peak bytes)``; with ``traced`` the profiler
        records a stretch of it."""
        base = self.traffic["check_steps"]
        self.batches.extend(self._tokens(base + k) for k in range(steps))
        if traced:
            self.probe = _Probe(self.spans, *self.traffic["profile_steps"], self.cuda)
        gc.collect()
        self.spans.items.clear()  # the window's spans alone
        self.trainer.opts.steps = steps
        self.in_window = True
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()
        self.sync()
        t0 = time.perf_counter()
        hist = self.trainer.run()
        if self.probe is not None:
            self.probe.stop()
        self.sync()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if self.cuda else 0
        self.in_window = False
        return hist, t0, seconds, peak

    def close(self) -> None:
        """Free the program's state."""
        self.trainer = None
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()


def reference(config: dict, traffic: dict, seed: int, device: str, steps_run: int) -> dict:
    """The reference's readings of the checked steps, and its Tier-2
    decisions for ``steps_run`` steps."""
    model = importlib.import_module(f"reference.{config['reference']}")
    dev = torch.device(device)
    tc = traffic["train_config"]
    latencies = gen.latencies(traffic, seed)
    n = traffic["check_steps"]
    allow = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        decide = dsag_ref.decisions(latencies[:steps_run], traffic["w"], tc["dsag_margin"],
                                    traffic["failure_max_misses"])
        ref = dsag_ref.train(
            model, config, tc, model.init_params(config, gen.weight_seed(seed), dev),
            [gen.tokens(traffic, config["vocab_size"], seed, k, dev) for k in range(n)],
            decide[:n], traffic["reference_rows"])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = allow
    ref["decisions"] = decide
    return ref


def run(config: dict, traffic: dict, seed: int, seconds: float, traced: bool, device: str,
        t_start: float) -> tuple[dict, dict, Run]:
    """One run of a cell: ``(program readings, reference readings, Run)``."""
    s = Session(config, traffic, seed, device)
    readings, step_s = s.warm()
    steps = max(1, round(seconds / step_s))
    if traced:  # the profiled stretches, and a step outside them
        first, count = traffic["profile_steps"]
        steps = max(steps, first + count + 2)
    log(f"set-up: {traffic['check_steps']} steps, {step_s:.3f} s a step; the window runs "
        f"{steps}")
    hist, t_w0, window_s, peak = s.window(steps, traced)
    log(f"setup_s {t_w0 - t_start:.3f}; the window {window_s:.3f} s, {len(hist['loss'])} steps, "
        f"peak {peak / 2**30:.3f} GiB")
    log("host seconds of each untraced step of the window: "
        + " ".join(f"{d:.3f}" for d in s.spans.durations("step")))
    readings["decisions"] = np.stack(s.decisions)
    readings["nonfinite"] = int(sum(not math.isfinite(x) for x in hist["loss"]))
    profile, profiled_s, profiled_steps = None, 0.0, 0
    probe = s.probe
    if probe is not None:
        profile = probe.profile()
        profiled_s, profiled_steps = probe.outer_s, probe.count + (probe.labels is not None)
    if profile is not None:
        untraced = (window_s - profiled_s) / max(len(hist["loss"]) - profiled_steps, 1)
        traced_s = profile.stretch_ns / 1e9 / profile.steps
        log(f"seconds a step: {untraced:.4f} untraced, {traced_s:.4f} with the device traced, "
            f"{profile.label_ns / 1e9:.4f} with the host traced too")
    slot_bytes = 2 if s.tc.dsag_cache_dtype == "bfloat16" else 4
    k4 = yardstick.k4_bytes(traffic["groups"], s.trainer.layout.numel, slot_bytes)
    result = Run(t_w0 - t_start, window_s, len(hist["loss"]),
                 traffic["global_batch"] * traffic["seq_len"], peak,
                 s.model.num_params(config), k4, s.spans, profile, profiled_s, profiled_steps)
    s.close()
    del s, hist, probe
    gc.collect()
    t_r0 = time.perf_counter()
    ref = reference(config, traffic, seed, device, len(readings["decisions"]))
    log(f"reference: {time.perf_counter() - t_r0:.1f} s")
    return readings, ref, result
