"""Optimizers of the live trainer, from ``repro.optim.optimizers``.

Optax-like ``(init, update)`` pairs over a single parameter tensor (the
paper problems' iterate ``V``; the port's Tier-1 state holds one tensor per
slot, not a pytree).  :func:`sgd` keeps the reference's operator order —
``mu = momentum * mu + g`` then ``upd = -lr * (mu + weight_decay * p)`` — so
with ``beta1 = 0`` and ``weight_decay = 0`` (``paper_train_config``) the
iterate rule is ``V - η·Ĥ`` in the same float32 steps as the reference.
``adamw`` and ``adafactor`` belong to the model zoo, which this package does
not port yet: :func:`make_optimizer` refuses them with
:data:`CAP_OPTIMIZER`.
"""

from __future__ import annotations

from collections.abc import Callable
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.experiments.engine import refuse

#: adamw / adafactor asked for: they serve the model zoo, not ported yet
CAP_OPTIMIZER = "optimizer-not-ported"


class Optimizer(NamedTuple):
    init: Callable[[torch.Tensor], Any]
    update: Callable[[torch.Tensor, Any, torch.Tensor], tuple[torch.Tensor, Any]]


def global_norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.square(x.to(torch.float32))))


def clip_by_global_norm(grads: torch.Tensor, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return grads.to(torch.float32) * scale, norm


def sgd(lr: float, momentum: float = 0.9, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {
            "mu": torch.zeros(params.shape, dtype=torch.float32, device=params.device),
            "step": torch.zeros((), dtype=torch.int32, device=params.device),
        }

    def update(grads, state, params):
        mu = momentum * state["mu"] + grads.to(torch.float32)
        upd = -lr * (mu + weight_decay * params.to(torch.float32))
        return upd, {"mu": mu, "step": state["step"] + 1}

    return Optimizer(init, update)


def make_optimizer(tc: TrainConfig) -> Optimizer:
    if tc.optimizer == "sgd":
        return sgd(tc.learning_rate, momentum=tc.beta1, weight_decay=tc.weight_decay)
    if tc.optimizer in ("adamw", "adafactor"):
        raise refuse(
            CAP_OPTIMIZER,
            f"optimizer {tc.optimizer!r} serves the model zoo, which is not "
            f"ported yet; the paper problems run optimizer='sgd'",
        )
    raise ValueError(f"unknown optimizer {tc.optimizer}")


def apply_updates(params: torch.Tensor, updates: torch.Tensor) -> torch.Tensor:
    return (params.to(torch.float32) + updates).to(params.dtype)
