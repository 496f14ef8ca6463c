"""Optimizers of the live trainer, from ``repro.optim.optimizers``.

Optax-like ``(init, update)`` pairs over a single parameter tensor (the
paper problems' iterate ``V``, or a model's flat parameters: the port's
Tier-1 state holds one tensor per slot, not a pytree), each in the
reference's float32 operator order.  sgd and adamw are elementwise, so the
flat tensor of a :class:`~repro_torch.models.layers.FlatLayout` is all they
need; adafactor and :func:`apply_updates` take the layout and walk its
leaves, as the reference walks its tree.
:func:`sgd` computes ``mu = momentum * mu + g`` then ``upd = -lr * (mu +
weight_decay * p)``, so with ``beta1 = 0`` and ``weight_decay = 0``
(``paper_train_config``) the iterate rule is ``V - η·Ĥ`` in the same float32
steps as the reference.  :func:`global_norm` sums the flat tensor at once
where the reference sums per-leaf sums: equal within float32 rounding.  :func:`adamw` is ``TrainConfig()``'s default, and so
the live trainer's (its bias corrections ``1 - beta ** step`` in float32);
:func:`adafactor` factors the second moment of a parameter of rank ≥ 2
(PCA's ``[d, k]`` iterate; logreg's ``[d]`` keeps a full one) and clips the
update by its RMS.
"""

from __future__ import annotations

from collections.abc import Callable
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.layers import get_path, set_path


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


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def adamw(lr: float, beta1: float = 0.9, beta2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        def z():
            return torch.zeros(params.shape, dtype=torch.float32, device=params.device)

        return {"m": z(), "v": z(),
                "step": torch.zeros((), dtype=torch.int32, device=params.device)}

    def update(grads, state, params):
        step = state["step"] + 1
        stepf = step.to(torch.float32)
        b1c = 1.0 - torch.pow(_f32(beta1, stepf), stepf)
        b2c = 1.0 - torch.pow(_f32(beta2, stepf), stepf)
        g = grads.to(torch.float32)
        m = beta1 * state["m"] + (1 - beta1) * g
        v = beta2 * state["v"] + (1 - beta2) * torch.square(g)
        upd = -lr * ((m / b1c) / (torch.sqrt(v / b2c) + eps)
                     + weight_decay * params.to(torch.float32))
        return upd, {"m": m, "v": v, "step": step}

    return Optimizer(init, update)


class LocalMeans:
    """The means adafactor takes over one leaf that is whole on this rank:
    ``torch.mean`` itself.  On a device mesh a leaf is a shard, and its
    means also sum over the ranks that split the reduced dim
    (``core/dsag_pjit.py::MeshMeans``)."""

    def mean(self, x: torch.Tensor, dim: int, pdim: int, keepdim: bool = False):
        """``x``'s mean over its ``dim``, which is the parameter's ``pdim``."""
        return x.mean(dim=dim, keepdim=keepdim)

    def mean_all(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` (laid out as the parameter) over all of it."""
        return torch.mean(x)


def adafactor(lr: float, decay: float = 0.99, eps: float = 1e-30, weight_decay: float = 0.0,
              clip_threshold: float = 1.0, layout=None, means=None) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern), no first moment.

    With ``layout`` the parameters are a flat tensor of that layout: every
    leaf keeps its own statistics (a tree, as the reference's) and its own
    RMS clip, and the update is written into the leaf's span.  ``means(path)``
    gives a leaf's means (:class:`LocalMeans` without it): on a mesh the
    layout holds this rank's shards, and the row and column means of the
    squared gradient, ``r_factor``'s mean of ``vr`` and the RMS clip sum
    over the ranks that split the dim they reduce."""
    local = LocalMeans()

    def _factored(shape) -> bool:
        return len(shape) >= 2

    def leaf_init(shape, device):
        def z(shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)

        return ({"vr": z(shape[:-1]), "vc": z(shape[:-2] + shape[-1:])}
                if _factored(shape) else {"v": z(shape)})

    def leaf_update(g, s, p, m=local):
        g = g.to(torch.float32)
        g2 = torch.square(g) + eps
        if _factored(g.shape):
            vr = decay * s["vr"] + (1 - decay) * m.mean(g2, -1, -1)
            vc = decay * s["vc"] + (1 - decay) * m.mean(g2, -2, -2)
            r_factor = torch.rsqrt(vr / torch.clamp(m.mean(vr, -1, -2, keepdim=True), min=1e-30))
            c_factor = torch.rsqrt(vc)
            u = g * r_factor[..., None] * c_factor[..., None, :]
            new_s = {"vr": vr, "vc": vc}
        else:
            v = decay * s["v"] + (1 - decay) * g2
            u = g * torch.rsqrt(v)
            new_s = {"v": v}
        # update clipping (RMS)
        rms = torch.sqrt(m.mean_all(torch.square(u)) + 1e-30)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        return -lr * (u + weight_decay * p.to(torch.float32)), new_s

    def init(params):
        dev = params.device
        if layout is None:
            stats = leaf_init(tuple(params.shape), dev)
        else:
            stats = {}
            for x in layout.leaves:
                set_path(stats, x.path, leaf_init(x.shape, dev))
        return {"stats": stats, "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params):
        step = state["step"] + 1
        if layout is None:
            upd, stats = leaf_update(grads, state["stats"], params)
            return upd, {"stats": stats, "step": step}
        upd = torch.zeros(params.shape, dtype=torch.float32, device=params.device)
        stats = {}
        for x, g, p, u in zip(layout.leaves, layout.views(grads), layout.views(params),
                              layout.views(upd)):
            leaf_u, leaf_s = leaf_update(g, get_path(state["stats"], x.path), p,
                                         local if means is None else means(x.path))
            u.copy_(leaf_u)
            set_path(stats, x.path, leaf_s)
        return upd, {"stats": stats, "step": step}

    return Optimizer(init, update)


def make_optimizer(tc: TrainConfig, layout=None, means=None) -> Optimizer:
    """``tc``'s optimizer; ``layout`` when the parameters are a flat tensor of
    a :class:`~repro_torch.models.layers.FlatLayout`, and ``means`` a leaf's
    means on a mesh (only adafactor reads them)."""
    if tc.optimizer == "adamw":
        return adamw(tc.learning_rate, tc.beta1, tc.beta2, tc.eps, tc.weight_decay)
    if tc.optimizer == "adafactor":
        return adafactor(tc.learning_rate, weight_decay=tc.weight_decay, layout=layout,
                         means=means)
    if tc.optimizer == "sgd":
        return sgd(tc.learning_rate, momentum=tc.beta1, weight_decay=tc.weight_decay)
    raise ValueError(f"unknown optimizer {tc.optimizer}")


def apply_updates(params: torch.Tensor, updates: torch.Tensor, layout=None) -> torch.Tensor:
    """``(p.float() + u)`` cast back to the parameters' dtype: with ``layout``
    each leaf of the flat float32 tensor is rounded to its own dtype."""
    new = params.to(torch.float32) + updates
    if layout is not None:
        return layout.round_(new)
    return new.to(params.dtype)
