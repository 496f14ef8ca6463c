"""Execution configuration and capability codes of the engines.

Counterpart of ``repro.experiments.engine``.  :class:`EngineConfig` names the
engine kind, the torch device and the kernel backend; :func:`engine_capability`
reports, with a stable reason code, why a configuration cannot run, and the
engines (device, host and the scalar simulator) raise
:class:`EngineCapabilityError` carrying that report.  Nothing falls back: a
missing card, CUDA kernels asked for on the CPU, and the parts of the
reference not ported yet are all refused.
"""

from __future__ import annotations

import dataclasses

import torch

#: capability reason codes (stable API — tests compare these, not prose)
CAP_OK = "ok"
#: device="cuda" requested but torch sees no CUDA device
CAP_CUDA_UNAVAILABLE = "cuda-device-unavailable"
#: kernel_backend="cuda" requested on a non-CUDA device
CAP_CUDA_KERNELS_OFF_DEVICE = "cuda-kernels-need-cuda-device"
#: kernel_backend="cuda" for a problem whose in-flight values are not float32
CAP_CUDA_DTYPE = "cuda-unsupported-dtype"
#: §6 load balancing is not ported yet
CAP_LOAD_BALANCE = "load-balance-not-ported"
#: traces carrying a ChurnSchedule are not ported yet
CAP_CHURN = "churn-not-ported"
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
    (default) — ``"scan"``, which runs every configuration the port runs.
    ``device`` is the torch device of the state and the kernels (default
    ``"cuda"``).  ``kernel_backend`` selects how the §3 block subgradients and
    the §5 grid-cache walk run: ``"cuda"`` — the hand-written kernels
    (default; the host engine and the scalar simulator call K1/K2 too),
    ``"torch"`` — their plain-torch versions (what the CPU tests ask for; also
    runs on the card).  ``eval_every`` is the suboptimality cadence.
    """

    device: str = "cuda"
    kernel_backend: str = "cuda"
    kind: str = "auto"
    eval_every: int = 1

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
        torch.device(self.device)  # raises on a malformed device string


@dataclasses.dataclass(frozen=True)
class EngineCapability:
    """Structured report of whether the device engine can run a config."""

    supported: bool
    code: str
    detail: str = ""


class EngineCapabilityError(ValueError):
    """Raised by the engines for configurations they cannot run.

    Carries the structured :class:`EngineCapability` as ``.capability`` so
    callers branch on ``capability.code`` instead of the message text.
    """

    def __init__(self, capability: EngineCapability):
        super().__init__(capability.detail)
        self.capability = capability


def refuse(code: str, detail: str) -> EngineCapabilityError:
    """The error a port entry point raises for a part it does not run."""
    return EngineCapabilityError(EngineCapability(False, code, detail))


def engine_capability(engine: EngineConfig, config=None, traces=None) -> EngineCapability:
    """Whether ``engine`` can run ``config`` (a MethodConfig) on ``traces``
    (any engine kind: they run the same configurations)."""
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
    if config is not None and config.load_balance:
        return EngineCapability(
            False,
            CAP_LOAD_BALANCE,
            "§6 load balancing is not ported to the torch engine yet",
        )
    if traces is not None and traces.churn is not None:
        return EngineCapability(
            False,
            CAP_CHURN,
            "traces with a ChurnSchedule are not ported to the torch engine yet",
        )
    return EngineCapability(True, CAP_OK, "supported")


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
