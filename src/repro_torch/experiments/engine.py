"""Execution configuration and capability codes of the engines.

Counterpart of ``repro.experiments.engine``.  :class:`EngineConfig` names the
engine kind, the torch device, the kernel backend and the scenario mesh of
the device engine; :func:`engine_capability`
reports, with a stable reason code, why a configuration cannot run, and the
engines (device, host and the scalar simulator) raise
:class:`EngineCapabilityError` carrying that report.  Nothing falls back
silently: a missing card, CUDA kernels asked for on the CPU, and the parts
of the reference not ported yet are all refused.  The one documented route
is ``kind="auto"`` sending a §6 configuration whose resident cache entries
exceed ``slot_budget`` to the host engine
(:func:`repro_torch.experiments.fused.scan_capability`).
"""

from __future__ import annotations

import dataclasses
import warnings

import torch

from repro_torch.launch.mesh import ScenarioMesh, make_scenario_mesh

#: capability reason codes (stable API — tests compare these, not prose)
CAP_OK = "ok"
#: device="cuda" requested but torch sees no CUDA device
CAP_CUDA_UNAVAILABLE = "cuda-device-unavailable"
#: kernel_backend="cuda" requested on a non-CUDA device
CAP_CUDA_KERNELS_OFF_DEVICE = "cuda-kernels-need-cuda-device"
#: kernel_backend="cuda" for a problem whose in-flight values are not float32
CAP_CUDA_DTYPE = "cuda-unsupported-dtype"
#: a §6 cache: the device engine holds it in tiled per-worker active-slot
#: tables within the slot budget (supported, informational)
CAP_TILED = "slot-universe-tiled"
#: the tiled cache's resident entries exceed the budget: the device engine
#: cannot hold the config (kind="auto" runs the host engine)
CAP_ACTIVE_SET = "active-slots-exceed-budget"
#: a model architecture (or a model feature) the port does not run yet
CAP_ARCH = "arch-not-ported"
#: kernel_backend="cuda" for shapes past a CUDA kernel's remaining limits
#: (a grid dimension past CUDA's, K3's event ranks past its shared memory)
CAP_CUDA_SHAPE = "cuda-shape-unsupported"

_KERNEL_BACKENDS = ("torch", "cuda")
_KINDS = ("auto", "scan", "host")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Execution configuration of one convergence-batch run.

    ``kind`` selects the engine of ``run_convergence_batch``: ``"scan"`` —
    the device engine (``experiments.fused``: every iteration's state and
    arithmetic on the device), ``"host"`` — the numpy loop over iterations
    with batched kernel calls inside (``experiments.convergence``), ``"auto"``
    (default) — ``"scan"``, unless
    :func:`~repro_torch.experiments.fused.scan_capability` reports that the
    device engine cannot hold the config's §6 cache within ``slot_budget``
    (then ``"host"``).
    ``device`` is the torch device of the state and the kernels (default
    ``"cuda"``).  ``kernel_backend`` selects how the §3 block subgradients and
    the §5 grid-cache walk run: ``"cuda"`` — the hand-written kernels
    (default; the host engine and the scalar simulator call K1/K2 too),
    ``"torch"`` — their plain-torch versions (what the CPU tests ask for; also
    runs on the card).  ``eval_every`` is the suboptimality cadence.
    ``slot_budget`` caps how many §6 cache entries the device engine keeps
    resident per scenario (default ``fused.LB_MAX_SLOTS``); a config whose
    tiled cache needs more is refused (``kind="scan"``) or runs on the
    host engine (``kind="auto"``).

    ``num_devices`` / ``mesh`` shard the device engine's scenario axis:
    ``mesh`` (a :class:`~repro_torch.launch.mesh.ScenarioMesh`, its devices
    of ``device``'s type; it takes precedence) or the first ``num_devices``
    cards (:func:`~repro_torch.launch.mesh.make_scenario_mesh`; CUDA only:
    the CPU is one torch device, so pass ``mesh=ScenarioMesh((cpu,) * n)``
    there).  Each shard runs on its device, in a thread of its own (shards
    of one device take turns), and the per-scenario results equal the
    unsharded run's bit for bit; a batch
    that does not divide is edge-padded with copies of its last scenario
    and sliced back.  ``None`` for both runs unsharded on ``device``.  The
    host engine ignores them, as the reference's does.
    """

    device: str = "cuda"
    kernel_backend: str = "cuda"
    kind: str = "auto"
    eval_every: int = 1
    slot_budget: int | None = None
    num_devices: int | None = None
    mesh: ScenarioMesh | None = None

    def __post_init__(self):
        if self.kernel_backend not in _KERNEL_BACKENDS:
            raise ValueError(
                f"unknown kernel_backend {self.kernel_backend!r}; expected "
                f"one of {_KERNEL_BACKENDS}"
            )
        if self.kind not in _KINDS:
            raise ValueError(f"unknown engine kind {self.kind!r}; expected one of {_KINDS}")
        if self.eval_every < 1:
            raise ValueError("eval_every must be >= 1")
        if self.slot_budget is not None and self.slot_budget < 1:
            raise ValueError("slot_budget must be >= 1")
        if self.num_devices is not None and self.num_devices < 1:
            raise ValueError("num_devices must be >= 1")
        dev = torch.device(self.device)  # raises on a malformed device string
        if self.mesh is not None:
            if not isinstance(self.mesh, ScenarioMesh):
                raise TypeError(f"mesh must be a ScenarioMesh, got {type(self.mesh).__name__}")
            if self.mesh.device_type != dev.type:
                raise ValueError(
                    f"the mesh's devices are {self.mesh.device_type} devices but the "
                    f"engine's device is {self.device!r}: they must be of one type")
        elif self.num_devices is not None and dev.type != "cuda":
            raise ValueError(
                f"num_devices counts CUDA cards; device={self.device!r} is one torch "
                f"device: pass mesh=ScenarioMesh((torch.device({dev.type!r}),) * n) "
                f"to run n shards on it")


@dataclasses.dataclass(frozen=True)
class EngineCapability:
    """Structured report of whether the device engine can run a config.

    For §6 configs, ``slots_total`` is the ladder universe's slot count,
    ``slots_resident`` how many entries the chosen cache layout keeps per
    scenario, ``slot_budget`` the budget they were held against."""

    supported: bool
    code: str
    detail: str = ""
    slots_total: int = 0
    slots_resident: int = 0
    slot_budget: int = 0


class EngineCapabilityError(ValueError):
    """Raised by the engines for configurations they cannot run.

    Carries the structured :class:`EngineCapability` as ``.capability`` so
    callers branch on ``capability.code`` instead of the message text.
    """

    def __init__(self, capability: EngineCapability):
        super().__init__(capability.detail)
        self.capability = capability


def as_engine_config(engine, *, _stacklevel: int = 2) -> EngineConfig:
    """Coerce ``engine`` to an :class:`EngineConfig`: an :class:`EngineConfig`
    (returned unchanged), ``None`` (the defaults), or a legacy
    ``"auto"|"scan"|"host"`` string, the deprecated alias for
    ``EngineConfig(kind=...)`` (with a ``DeprecationWarning`` attributed
    ``_stacklevel`` frames up)."""
    if engine is None:
        return EngineConfig()
    if isinstance(engine, EngineConfig):
        return engine
    if isinstance(engine, str):
        warnings.warn(f"engine={engine!r} strings are deprecated; pass "
                      f"EngineConfig(kind={engine!r}) instead",
                      DeprecationWarning, stacklevel=_stacklevel)
        return EngineConfig(kind=engine)
    raise TypeError(f"engine must be an EngineConfig, None or a kind string, got {engine!r}")


def refuse(code: str, detail: str) -> EngineCapabilityError:
    """The error a port entry point raises for a part it does not run."""
    return EngineCapabilityError(EngineCapability(False, code, detail))


def checked_device(device) -> torch.device:
    """``device`` as a torch device; refuses (``cuda-device-unavailable``) a
    CUDA device when torch sees no card, as the engines do."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise refuse(
            CAP_CUDA_UNAVAILABLE,
            f"device={device!r} requested but torch sees no CUDA device; pass "
            "device='cpu' to run on the CPU",
        )
    return dev


def engine_capability(engine: EngineConfig) -> EngineCapability:
    """Whether ``engine``'s device and kernel backend can run (any engine
    kind; the device engine's §6 slot budget is
    :func:`~repro_torch.experiments.fused.scan_capability`'s)."""
    dev = torch.device(engine.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        return EngineCapability(
            False,
            CAP_CUDA_UNAVAILABLE,
            f"device={engine.device!r} requested but torch sees no CUDA "
            f"device; pass EngineConfig(device='cpu', kernel_backend='torch') "
            f"to run the plain versions on the CPU",
        )
    if engine.kernel_backend == "cuda" and dev.type != "cuda":
        return EngineCapability(
            False,
            CAP_CUDA_KERNELS_OFF_DEVICE,
            f"kernel_backend='cuda' launches CUDA kernels and needs a CUDA "
            f"device, got device={engine.device!r}; use kernel_backend='torch'",
        )
    if engine.mesh is not None and dev.type == "cuda":
        count = torch.cuda.device_count()
        missing = sorted({str(d) for d in engine.mesh.devices if d.index >= count})
        if missing:
            return EngineCapability(
                False,
                CAP_CUDA_UNAVAILABLE,
                f"the scenario mesh names {missing} but torch sees {count} CUDA devices",
            )
    return EngineCapability(True, CAP_OK, "supported")


def scenario_mesh(engine: EngineConfig) -> ScenarioMesh | None:
    """The device engine's scenario mesh: ``engine.mesh``, else the first
    ``engine.num_devices`` cards, else None (unsharded).  Raises
    ``ValueError`` when more cards are asked for than are visible."""
    if engine.mesh is not None:
        return engine.mesh
    if engine.num_devices is not None:
        return make_scenario_mesh(engine.num_devices)
    return None


def kernel_dtype_capability(engine: EngineConfig, value_dtype) -> EngineCapability:
    """The CUDA kernels take float32 data and in-flight values only."""
    if engine.kernel_backend == "cuda" and value_dtype != torch.float32:
        return EngineCapability(
            False,
            CAP_CUDA_DTYPE,
            f"kernel_backend='cuda' supports float32 data only, got {value_dtype}",
        )
    return EngineCapability(True, CAP_OK, "supported")


def kernel_shape_capability(engine: EngineConfig, errors) -> EngineCapability:
    """Whether the CUDA kernels take the shapes of a run: ``errors`` are the
    kernels' ``shape_error`` reports (a reason, or None), pure functions of
    the shapes, so a run is refused before its first launch."""
    if engine.kernel_backend == "cuda":
        for err in errors:
            if err is not None:
                return EngineCapability(False, CAP_CUDA_SHAPE, err)
    return EngineCapability(True, CAP_OK, "supported")
