"""DSAG's Tier-1 training step (paper Eq. 6), from ``repro.core.dsag_pjit``.

Groups are the paper's partitions.  Per step the Tier-2 controller hands in
``mask`` (fresh within the deadline), ``flush`` (a stale result landed) and
``evict`` (the group failed) as ``[P]`` bool tensors, and the step applies
the SAG cache rule in its incremental form

    H  <- H + Σ_i m_i (g_i - c_i)          c_i <- m_i ? g_i : c_i
    ξ  <- coverage(filled groups)          Ĥ = H / (ξ P)

then the optimizer step on Ĥ and, for PCA, the re-projection.  A missed
group's gradient parks in a *pending* slot; a later flush bit moves it into
the cache.  The cache and H update runs through kernel K4
(:mod:`repro_torch.kernels.dsag_update`).

The port's state holds one parameter tensor: the paper problems' iterate
``V``, or a model's parameters flattened by a
:class:`~repro_torch.models.layers.FlatLayout` (``layout=``).  Every float
slot is a tensor with a leading group dim, ``[P, n]`` for K4, which
updates all of a model's parameters in one launch.  With
``dsag_cache_dtype="int8"`` a slot is a
:class:`~repro_torch.optim.compression.Quantized` of the reference's layout
(one bfloat16 scale per row of the parameter's last axis) and K4's int8
entry updates it; for a model, a tree of them, one per leaf (a leaf's rows
are its own last axis, which the flat view does not have), each its own
launch.  Per-group gradients come from the job's ``group_value_and_grad``
or, for the reference's ``loss_fn(params, batch)``, from autograd, one
group at a time (:func:`autograd_group_value_and_grad`).  What is not
ported is refused with a capability code: a mesh (:data:`CAP_MESH`) and a
job that offers neither a loss nor per-group gradients
(:data:`CAP_GROUP_GRAD`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.experiments.engine import refuse
from repro_torch.kernels import dsag_update as k4
from repro_torch.models.layers import get_path, set_path, tree_map
from repro_torch.optim.compression import Quantized
from repro_torch.optim.optimizers import (
    apply_updates,
    clip_by_global_norm,
    global_norm,
    make_optimizer,
)

#: a device mesh (sharded groups, ZeRO slots)
CAP_MESH = "mesh-not-ported"
#: a job with neither a ``loss_fn`` nor ``group_value_and_grad``
CAP_GROUP_GRAD = "group-grad-required"

_SLOT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    num_groups: int
    axes: tuple[str, ...]  # mesh axes the group dim is sharded over (() = none)


def make_group_spec(tc: TrainConfig, mesh=None) -> GroupSpec:
    """The single-device group geometry (``mesh=None``) of the reference."""
    if mesh is not None:
        raise refuse(CAP_MESH, "sharded DSAG groups over a mesh are not ported yet")
    return GroupSpec(num_groups=1 if not tc.dsag else 4, axes=())


def _cache_like(params: torch.Tensor, gs: GroupSpec, dtype: str, layout=None):
    """An empty slot: a leading group dim on the parameter's shape; int8
    slots carry one bfloat16 scale per row of the last axis (the
    reference's ``_cache_like``), one slot per leaf of ``layout``."""
    if dtype == "int8" and layout is not None:
        tree: dict = {}
        for x, view in zip(layout.leaves, layout.views(params)):
            set_path(tree, x.path, _cache_like(view, gs, dtype))
        return tree
    shape = (gs.num_groups,) + tuple(params.shape)
    dev = params.device
    if dtype == "int8":
        block = params.shape[-1] if params.dim() else 1
        nblocks = max((shape[-1] + block - 1) // block, 1)
        return Quantized(q=torch.zeros(shape, dtype=torch.int8, device=dev),
                         scale=torch.zeros(shape[:-1] + (nblocks,), dtype=torch.bfloat16,
                                           device=dev),
                         block=block)
    if dtype not in _SLOT_DTYPES:
        raise ValueError(f"unknown dsag_cache_dtype {dtype!r}")
    return torch.zeros(shape, dtype=_SLOT_DTYPES[dtype], device=dev)


def init_dsag_state(params: torch.Tensor, gs: GroupSpec, tc: TrainConfig, layout=None) -> dict:
    dev = params.device
    return {
        "cache": _cache_like(params, gs, tc.dsag_cache_dtype, layout),
        "pending": _cache_like(params, gs, tc.dsag_cache_dtype, layout),
        "pending_valid": torch.zeros(gs.num_groups, dtype=torch.bool, device=dev),
        "filled": torch.zeros(gs.num_groups, dtype=torch.bool, device=dev),
        "h": torch.zeros(params.shape, dtype=torch.float32, device=dev),
    }


def _bmask(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Broadcast a [P] mask against [P, ...]."""
    return m.reshape((-1,) + (1,) * (x.dim() - 1))


def _update_slots(dsag, group_grads, mask, eff_flush, evict, take_new, backend):
    """float32 / bfloat16 slots through K4: ``(cache, pending, h)``."""
    p = mask.shape[0]
    cache, pending = dsag["cache"], dsag["pending"]
    dt = cache.dtype
    g = group_grads
    g_slot = g.to(dt)  # rounded once, as the reference stores a float32 gradient
    zero = torch.zeros((), dtype=dt, device=g.device)
    g_in = torch.where(_bmask(mask, g), g_slot,
                       torch.where(_bmask(eff_flush, g), pending, zero))
    g_in = torch.where(_bmask(evict, g), zero, g_in)
    m_in = (mask | eff_flush | evict).to(torch.float32)
    update = k4.dsag_cache_update if backend == "cuda" else k4.dsag_cache_update_plain
    new_c, new_h = update(g_in.reshape(p, -1), cache.reshape(p, -1),
                          dsag["h"].reshape(-1), m_in)
    new_pending = torch.where(_bmask(take_new, g), g_slot, pending)
    return new_c.reshape(cache.shape), new_pending, new_h.reshape(dsag["h"].shape)


def _update_int8(dsag, group_grads, mask, eff_flush, evict, take_new, backend):
    """int8 slots through K4's int8 entry: ``(cache, pending, h)``.

    Each group's cache row becomes ``evict ? 0 : mask ? g : flush ? pending
    : cache`` (the reference's ``mf·g + ff·p + (1 − mf − ff)·c``, then
    ``· (1 − evict)``: every product is by 0 or 1, so exact), requantized,
    with H's delta taken from the stored, dequantized value; the pending
    slot is requantized too.  Every row of every group is requantized each
    step, as in the reference.
    """
    cache, pending = dsag["cache"], dsag["pending"]
    p, b = mask.shape[0], cache.block
    code = torch.where(evict, k4.ZERO, torch.where(
        mask, k4.TAKE_G, torch.where(eff_flush, k4.TAKE_PENDING, k4.KEEP)))
    code = (code + torch.where(take_new, k4.TAKE_NEW, 0)).to(torch.uint8)
    update = (k4.dsag_cache_update_int8 if backend == "cuda"
              else k4.dsag_cache_update_int8_plain)
    cq, cs, pq, ps, new_h = update(
        group_grads.to(torch.float32).reshape(p, -1, b).contiguous(),
        cache.q.reshape(p, -1, b), cache.scale.reshape(p, -1),
        pending.q.reshape(p, -1, b), pending.scale.reshape(p, -1),
        dsag["h"].reshape(-1, b), code)
    return (Quantized(cq.reshape(cache.q.shape), cs.reshape(cache.scale.shape), b),
            Quantized(pq.reshape(pending.q.shape), ps.reshape(pending.scale.shape), b),
            new_h.reshape(dsag["h"].shape))


def _update_int8_leaves(dsag, group_grads, mask, eff_flush, evict, take_new, backend,
                        layout):
    """A model's int8 slots (a tree of one :class:`Quantized` per leaf of
    ``layout``): :func:`_update_int8` per leaf, ``(cache tree, pending
    tree, flat h)``."""
    cache, pending = {}, {}
    new_h = torch.zeros_like(dsag["h"])
    for x, g, h, out in zip(layout.leaves, layout.views(group_grads), layout.views(dsag["h"]),
                            layout.views(new_h)):
        leaf = {"cache": get_path(dsag["cache"], x.path),
                "pending": get_path(dsag["pending"], x.path), "h": h}
        c, pend, hh = _update_int8(leaf, g, mask, eff_flush, evict, take_new, backend)
        set_path(cache, x.path, c)
        set_path(pending, x.path, pend)
        out.copy_(hh)
    return cache, pending, new_h


def dsag_update(dsag: dict, group_grads: torch.Tensor, mask, flush, evict=None,
                backend: str = "cuda", layout=None):
    """Apply the DSAG cache rule; returns ``(new_dsag, h_hat, xi)``.

    ``group_grads`` [P, ...] float32 (or already in the float slots'
    dtype: the cache rule rounds them to it first); ``mask`` / ``flush`` /
    ``evict`` [P] bool; ``layout`` the flat layout of a model's int8
    slots.  ``backend="cuda"`` runs the cache and H update through the K4
    wrapper (the kernel on CUDA tensors, its plain version on CPU tensors),
    ``"torch"`` through the plain version everywhere.

    For float32 / bfloat16 slots the reference's rule is folded into K4's
    inputs (int8 slots: :func:`_update_int8`):

    * ``m' = mask | eff_flush | evict`` with ``mask`` excluding ``evict``
      and ``eff_flush = flush & ~mask & pending_valid``;
    * ``g' = evict ? 0 : (mask ? g : (eff_flush ? pending : 0))``, stored
      in the cache's dtype before K4 sees it.  Evict is applied last, since
      ``eff_flush`` does not exclude an evicted group and the reference
      zeroes such a slot after its flush was selected.

    K4's ``c <- m' ? g' : c`` and ``h += Σ m'(g' - c)`` are then the
    reference's ``stored`` slot and its delta, bf16 slots included: the
    reference takes the delta from the stored, rounded value, and the
    pre-rounded ``g'`` gives K4 the same value.  The cache, pending slots,
    ``filled``, ``pending_valid`` and ξ equal the reference's exactly.  H is
    accumulated in K4's order (h first, then the groups in order), where
    the reference sums the deltas first and adds h last, so H agrees with
    the reference within float32 rounding, not bit for bit.
    """
    p = mask.shape[0]
    if evict is None:
        evict = torch.zeros_like(mask)
    # the masks stay bool tensors: torch refuses `~` on a float tensor and
    # `1 - bool_tensor`, so every float use below casts explicitly
    mask = mask & ~evict
    # a flush is only meaningful if the slot was pending and not fresh now
    eff_flush = flush & ~mask & dsag["pending_valid"]
    # pending: keep the oldest in-flight gradient unless fresh/flushed now
    take_new = mask | eff_flush | ~dsag["pending_valid"]
    if isinstance(dsag["cache"], Quantized):
        new_cache, new_pending, new_h = _update_int8(
            dsag, group_grads, mask, eff_flush, evict, take_new, backend)
    elif isinstance(dsag["cache"], dict):
        new_cache, new_pending, new_h = _update_int8_leaves(
            dsag, group_grads, mask, eff_flush, evict, take_new, backend, layout)
    else:
        new_cache, new_pending, new_h = _update_slots(
            dsag, group_grads, mask, eff_flush, evict, take_new, backend)

    arrived = mask | eff_flush
    new_filled = (dsag["filled"] | arrived) & ~evict
    # after a fresh arrival nothing is in flight; every other group has
    # this step's gradient in flight (after a flush too), unless it was
    # evicted: its in-flight gradient died with it.  (The reference's
    # where(arrived, True, valid | ~mask), cleared where mask or evict,
    # reduces to this.)
    new_pending_valid = ~mask & ~evict

    # ξ = clip(mean(filled), 1e-6, 1): XLA computes the reference's mean as
    # the count times the float32 reciprocal of P, and so does this (a
    # division rounds differently, e.g. 5/6), so ξ equals the reference's
    xi = torch.clamp(new_filled.to(torch.float32).sum() * (1.0 / p), 1e-6, 1.0)
    h_hat = new_h / (xi * p)
    new_dsag = {
        "cache": new_cache,
        "pending": new_pending,
        "pending_valid": new_pending_valid,
        "filled": new_filled,
        "h": new_h,
    }
    return new_dsag, h_hat, xi


def autograd_group_value_and_grad(loss_fn, layout=None, grad_dtype=torch.float32):
    """``group_value_and_grad`` of the reference's ``loss_fn(params, batch)``.

    The returned function takes the parameters (a tensor; with ``layout``,
    the flat tensor of that layout, whose tree ``loss_fn`` sees) and a batch
    whose every leaf is ``[P, ...]``, and returns ``(losses [P] float32,
    grads [P, n] grad_dtype)``: what the reference's
    ``vmap(value_and_grad)`` returns.  The groups run one at a time through
    ``torch.autograd.grad``, so one group's activations and logits are alive
    at a time; ``grad_dtype`` is the float DSAG slots' dtype, into which
    the cache rule rounds each gradient first anyway (float32 otherwise).
    """

    def group_value_and_grad(params, batch):
        p = _num_groups(batch)
        losses = torch.empty(p, dtype=torch.float32, device=params.device)
        grads = torch.empty((p,) + tuple(params.shape), dtype=grad_dtype, device=params.device)
        for i in range(p):
            with torch.enable_grad():
                leaf = params.detach().requires_grad_(True)
                tree = layout.unflatten(leaf) if layout is not None else leaf
                loss = loss_fn(tree, tree_map(lambda a, i=i: a[i], batch))
                (grad,) = torch.autograd.grad(loss, leaf)
            grads[i] = grad
            losses[i] = loss.detach()
        return losses, grads

    return group_value_and_grad


def _num_groups(batch) -> int:
    while isinstance(batch, dict):
        batch = next(iter(batch.values()))
    return batch.shape[0]


def make_train_step(job: Any, tc: TrainConfig, gs: GroupSpec, mesh=None,
                    project_fn=None, backend: str = "cuda", layout=None):
    """Build ``step(state, batch, mask, flush, evict=None) -> (state, metrics)``.

    ``job`` is the reference's ``loss_fn(params, batch)`` (the per-group
    mean loss; its gradients come from :func:`autograd_group_value_and_grad`)
    or a job whose ``group_value_and_grad(params, batch)`` returns ``(losses
    [P], grads [P, ...])`` itself.  ``layout`` is the
    :class:`~repro_torch.models.layers.FlatLayout` of flat model parameters
    (``loss_fn`` then sees their tree).  ``project_fn``, when given,
    re-projects the updated parameters (the paper's PCA
    orthonormalization).  ``backend`` selects the kernels (``"cuda"``) or
    their plain versions (``"torch"``) for the cache update.
    """
    if mesh is not None:
        raise refuse(CAP_MESH, "a mesh-sharded train step is not ported yet")
    group_value_and_grad = getattr(job, "group_value_and_grad", None)
    if group_value_and_grad is None:
        if not callable(job):
            raise refuse(
                CAP_GROUP_GRAD,
                "the train step needs the reference's loss_fn(params, batch) or a job "
                "with group_value_and_grad(params, batch)",
            )
        float_slots = tc.dsag and tc.dsag_cache_dtype in _SLOT_DTYPES
        group_value_and_grad = autograd_group_value_and_grad(
            job, layout, _SLOT_DTYPES[tc.dsag_cache_dtype] if float_slots else torch.float32)
    opt = make_optimizer(tc, layout)

    def step(state, batch, mask, flush, evict=None):
        params = state["params"]
        losses, grads = group_value_and_grad(params, batch)
        if tc.dsag:
            new_dsag, h_hat, xi = dsag_update(
                state["dsag"], grads, mask, flush, evict, backend=backend, layout=layout
            )
        else:
            new_dsag = state["dsag"]
            xi = torch.ones((), dtype=torch.float32, device=params.device)
            h_hat = grads.to(torch.float32).mean(dim=0)

        if tc.grad_clip > 0:
            h_hat, gnorm = clip_by_global_norm(h_hat, tc.grad_clip)
        else:
            gnorm = global_norm(h_hat)

        updates, new_opt = opt.update(h_hat, state["opt"], params)
        new_params = apply_updates(params, updates, layout)
        if project_fn is not None:
            new_params = project_fn(new_params)
        new_state = {
            "params": new_params,
            "opt": new_opt,
            "dsag": new_dsag,
            "step": state["step"] + 1,
        }
        metrics = {
            "loss": losses.mean(),
            "per_group_loss": losses,
            "grad_norm": gnorm,
            "xi": xi,
            "mask_count": mask.sum(),
        }
        return new_state, metrics

    return step


def init_train_state(params: torch.Tensor, tc: TrainConfig, gs: GroupSpec,
                     layout=None) -> dict:
    opt = make_optimizer(tc, layout)
    return {
        "params": params,
        "opt": opt.init(params),
        "dsag": init_dsag_state(params, gs, tc, layout),
        "step": torch.zeros((), dtype=torch.int32, device=params.device),
    }
