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
group at a time (:func:`autograd_group_value_and_grad`).  A job that
offers neither a loss nor per-group gradients is refused
(:data:`CAP_GROUP_GRAD`).

On a ``(data, model)`` or ``(pod, data, model)`` device mesh (``mesh=``,
``param_specs=``) every rank runs the step on its own shards
(:func:`make_train_step`; the layout is ``models/sharding.py``'s), under any
group layout of :func:`make_group_spec`.  The groups lie on the group axes G
(``data`` or ``(pod, data)`` for ``dp``, ``pod`` for ``pod``, none for
``zero`` and ``none``); the other data-parallel axes D split each group's
batch.  A rank computes the groups its coordinate along G owns (``dp``: one;
``pod``: its pod's; ``zero``, ``none``: every group, one after another), each
on its slice of the group's batch along D, over its parameters all-gathered
to their TP-only layout (``degather``, int8 with
``quantized_fsdp_allgather``) as DTensors on the ``model`` axis.  Each
group's gradient is averaged over D into the *slot layout*, the parameter
specs with G stripped (a reduce-scatter over ``data`` where FSDP splits it;
every slice is the same size, so the mean of the ranks' means is the
group's), and K4 (or K4-int8) updates the rank's cache and pending slots
``[k, n_slot]`` in place.  int8 slots hold a shard of each row of a leaf
whose last dim G does not strip: K4-int8's split form takes the row maxima
MAX-reduced over the row's ranks (exact: bit for bit the unsharded form).
H takes the deltas summed over G: a reduce-scatter over ``data`` for
``dp``, an all-reduce over ``pod`` for ``pod`` (H's spec has no ``pod``),
nothing for ``zero`` and ``none``, whose slots are laid out as H.  Without
DSAG (``dsag=False``) Ĥ is the mean gradient and no K4 launches.  H, the
optimizer state and the parameters stay sharded as ``train_state_specs``
says; adafactor's means sum over the ranks that split the dim they reduce
(:class:`MeshMeans`).  The spec functions (``opt_state_specs``,
``dsag_state_specs``, ``train_state_specs``, ``batch_group_specs``) are the
reference's.  A projected (PCA) step on a mesh is refused with
:data:`CAP_MESH` (the reference's trainer never puts a paper problem on a
mesh).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.configs.base import MeshConfig, TrainConfig
from repro_torch.experiments.engine import CAP_MESH, refuse
from repro_torch.kernels import dsag_update as k4
from repro_torch.models import sharding
from repro_torch.models.layers import get_path, set_path, tree_map
from repro_torch.models.sharding import P, strip_axis
from repro_torch.optim.compression import Quantized
from repro_torch.optim.optimizers import (
    LocalMeans,
    apply_updates,
    clip_by_global_norm,
    global_norm,
    make_optimizer,
)

#: a job with neither a ``loss_fn`` nor ``group_value_and_grad``
CAP_GROUP_GRAD = "group-grad-required"

_SLOT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    num_groups: int
    axes: tuple[str, ...]  # mesh axes the group dim is sharded over (() = none)

    @property
    def group_partition(self):
        if not self.axes:
            return None
        return self.axes if len(self.axes) > 1 else self.axes[0]


def mesh_sizes(mesh) -> dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` or a :class:`MeshConfig` (a mesh's
    description); anything else is refused with ``TypeError``."""
    if isinstance(mesh, MeshConfig):
        return dict(zip(mesh.axes, mesh.shape))
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh) or mesh.mesh_dim_names is None:
        raise TypeError(f"a mesh is a DeviceMesh with named axes (launch/mesh.py) or a "
                        f"MeshConfig, got {type(mesh).__name__}")
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def make_group_spec(tc: TrainConfig, mesh=None) -> GroupSpec:
    """The reference's group geometry: without a mesh, 4 groups (1 without
    DSAG), replicated; on a mesh, by ``tc.dsag_groups``: ``dp`` one group
    per data-parallel rank, ``pod`` one per pod, ``zero`` an unsharded group
    dim of ``dsag_num_groups``, ``none`` (or ``dsag=False``) one group."""
    if mesh is None:  # single-device runs: any P, replicated
        return GroupSpec(num_groups=1 if not tc.dsag else 4, axes=())
    sizes = mesh_sizes(mesh)
    if not tc.dsag or tc.dsag_groups == "none":
        return GroupSpec(1, ())
    if tc.dsag_groups == "pod" and "pod" in sizes:
        return GroupSpec(sizes["pod"], ("pod",))
    if tc.dsag_groups == "zero":
        # group dim unsharded, cache/pending param dims ZeRO-sharded over all
        # axes via param_specs; groups are time-sliced
        return GroupSpec(tc.dsag_num_groups, ())
    dp = tuple(a for a in sizes if a in sharding.DP_AXES)
    n = 1
    for a in dp:
        n *= sizes[a]
    return GroupSpec(n, dp)


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


def _update_int8(dsag, group_grads, mask, eff_flush, evict, take_new, backend,
                 reduce_max=None):
    """int8 slots through K4's int8 entry: ``(cache, pending, h)``.

    Each group's cache row becomes ``evict ? 0 : mask ? g : flush ? pending
    : cache`` (the reference's ``mf·g + ff·p + (1 − mf − ff)·c``, then
    ``· (1 − evict)``: every product is by 0 or 1, so exact), requantized,
    with H's delta taken from the stored, dequantized value; the pending
    slot is requantized too.  Every row of every group is requantized each
    step, as in the reference.  ``reduce_max`` (a mesh, where these slots
    hold a shard of each row) MAX-reduces the shard's ``[2, p, rows]`` row
    maxima over the row's ranks in place; K4-int8's split form then scales
    each row by them.
    """
    cache, pending = dsag["cache"], dsag["pending"]
    p = mask.shape[0]
    b = cache.q.shape[-1] if cache.q.dim() > 1 else 1  # this shard's part of a row
    code = torch.where(evict, k4.ZERO, torch.where(
        mask, k4.TAKE_G, torch.where(eff_flush, k4.TAKE_PENDING, k4.KEEP)))
    code = (code + torch.where(take_new, k4.TAKE_NEW, 0)).to(torch.uint8)
    cuda = backend == "cuda"
    update = k4.dsag_cache_update_int8 if cuda else k4.dsag_cache_update_int8_plain
    args = (group_grads.to(torch.float32).reshape(p, -1, b).contiguous(),
            cache.q.reshape(p, -1, b), cache.scale.reshape(p, -1),
            pending.q.reshape(p, -1, b), pending.scale.reshape(p, -1))
    maxima = None
    if reduce_max is not None:
        row_max = k4.dsag_int8_row_max if cuda else k4.dsag_int8_row_max_plain
        cmax, pmax = row_max(*args, code)
        both = torch.stack([cmax, pmax])
        reduce_max(both)
        maxima = (both[0], both[1])
    cq, cs, pq, ps, new_h = update(*args, dsag["h"].reshape(-1, b), code, maxima)
    return (Quantized(cq.reshape(cache.q.shape), cs.reshape(cache.scale.shape), cache.block),
            Quantized(pq.reshape(pending.q.shape), ps.reshape(pending.scale.shape), cache.block),
            new_h.reshape(dsag["h"].shape))


def _update_int8_leaves(dsag, group_grads, mask, eff_flush, evict, take_new, backend,
                        layout, reducers=None):
    """A model's int8 slots (a tree of one :class:`Quantized` per leaf of
    ``layout``): :func:`_update_int8` per leaf, ``(cache tree, pending
    tree, flat h)``; ``reducers(path)``, on a mesh, a split leaf's row-max
    reduction (None for a leaf whose rows are whole on the rank)."""
    cache, pending = {}, {}
    new_h = torch.zeros_like(dsag["h"])
    for x, g, h, out in zip(layout.leaves, layout.views(group_grads), layout.views(dsag["h"]),
                            layout.views(new_h)):
        leaf = {"cache": get_path(dsag["cache"], x.path),
                "pending": get_path(dsag["pending"], x.path), "h": h}
        c, pend, hh = _update_int8(leaf, g, mask, eff_flush, evict, take_new, backend,
                                   None if reducers is None else reducers(x.path))
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

    return _finish_update(dsag, new_cache, new_pending, new_h, mask, eff_flush, evict)


def _finish_update(dsag, new_cache, new_pending, new_h, mask, eff_flush, evict):
    """The cache rule's flags, ξ and Ĥ after the slots and H are updated
    (``mask`` already excludes ``evict``): ``(new_dsag, h_hat, xi)``."""
    p = mask.shape[0]
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


def make_train_step(job: Any, tc: TrainConfig, gs: GroupSpec, mesh=None, param_specs=None,
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

    With ``mesh`` (a ``DeviceMesh``), ``param_specs`` (the model's
    ``param_specs(tc.fsdp)``) and ``layout``, the step runs on this rank's
    shards (:func:`_make_mesh_step`; the state from
    :func:`init_mesh_train_state`).
    """
    if mesh is not None:
        mesh_sizes(mesh)
        return _make_mesh_step(job, tc, gs, mesh, param_specs, project_fn, backend, layout)
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


# ---------------------------------------------------------------------------
# Sharding specs for the full train state
# ---------------------------------------------------------------------------


def opt_state_specs(tc: TrainConfig, param_specs) -> Any:
    if tc.optimizer == "adamw":
        return {"m": param_specs, "v": param_specs, "step": P()}
    if tc.optimizer == "sgd":
        return {"mu": param_specs, "step": P()}
    if tc.optimizer == "adafactor":

        def leaf(spec):
            t = tuple(spec)
            if len(t) >= 2:
                return {"vr": P(*t[:-1]), "vc": P(*(t[:-2] + t[-1:]))}
            return {"v": spec}

        return {"stats": sharding.tree_specs_map(leaf, param_specs), "step": P()}
    raise ValueError(tc.optimizer)


def _slot_spec(gs: GroupSpec, spec) -> P:
    for a in gs.axes:  # group axes cannot repeat in the param dims
        spec = strip_axis(spec, a)
    return P(gs.group_partition, *tuple(spec))


def dsag_state_specs(tc: TrainConfig, gs: GroupSpec, param_specs) -> Any:
    gaxes = gs.group_partition

    def slot(spec):
        t = tuple(_slot_spec(gs, spec))[1:]
        if tc.dsag_cache_dtype == "int8":
            scale_spec = P(gaxes, *t[:-1], None) if t else P(gaxes, None)
            return Quantized(q=P(gaxes, *t), scale=scale_spec, block=0)
        return P(gaxes, *t)

    cache = sharding.tree_specs_map(slot, param_specs)
    return {
        "cache": cache,
        "pending": cache,
        "pending_valid": P(),
        "filled": P(),
        "h": param_specs,
    }


def train_state_specs(tc: TrainConfig, gs: GroupSpec, param_specs) -> Any:
    return {
        "params": param_specs,
        "opt": opt_state_specs(tc, param_specs),
        "dsag": dsag_state_specs(tc, gs, param_specs),
        "step": P(),
    }


def batch_group_specs(gs: GroupSpec, inner_spec_tail=(None,)) -> P:
    """Spec of a batch leaf [P, b/P, ...]: group dim over the group axes,
    inner batch dim over remaining dp axes (none left when groups = dp)."""
    return P(gs.group_partition, *inner_spec_tail)


# ---------------------------------------------------------------------------
# The step on a mesh
# ---------------------------------------------------------------------------


def check_mesh_step(tc: TrainConfig, gs: GroupSpec, mesh) -> None:
    """Refuse, before any launch, a group geometry no mesh step lays out:
    group axes that are not data-parallel axes of ``mesh``, or groups that
    do not split evenly over them (``make_group_spec`` makes neither)."""
    dp = tuple(a for a in mesh.mesh_dim_names if a in sharding.DP_AXES)
    if any(a not in dp for a in gs.axes):
        raise refuse(CAP_MESH, f"groups on {gs.axes}: a mesh's groups lie on its "
                               f"data-parallel axes {dp}")
    _, n = sharding.coordinate(mesh, gs.axes)
    if gs.num_groups % n:
        raise refuse(CAP_MESH, f"{gs.num_groups} groups do not split evenly over the {n} ranks "
                               f"of {gs.axes}")


@dataclasses.dataclass(frozen=True)
class MeshLayouts:
    """A rank's flat layouts of the global ``full`` one, and its share of
    the groups.

    ``store``: its shards under the parameter specs (parameters, optimizer
    moments, H).  ``tp``: the data-parallel axes stripped (the degathered
    parameters, and each group's gradient as autograd gives it).  ``slot``:
    the group axes stripped (the DSAG slots, and each group's gradient after
    its mean over ``inner_axes``): ``tp`` for ``dp`` groups, ``store`` for
    ``pod``, ``zero`` and ``none``.  The rank computes groups ``rows`` (its
    coordinate along ``group_axes``), each on slice ``inner`` of ``n_inner``
    of the group's batch (its coordinate along ``inner_axes``, the
    data-parallel axes the groups do not take)."""

    full: Any
    store: Any
    tp: Any
    slot: Any
    specs: Any
    tp_specs: Any
    slot_specs: Any
    group_axes: tuple
    inner_axes: tuple
    rows: slice
    inner: int
    n_inner: int

    def local_batch(self, a: torch.Tensor) -> torch.Tensor:
        """This rank's part of a global batch leaf ``[P, b, ...]``: its groups,
        and its slice of each one's ``b`` (the reference's
        ``P(group axes, inner axes)`` batch layout)."""
        a = a[self.rows]
        if self.n_inner == 1:
            return a
        if a.shape[1] % self.n_inner:
            raise ValueError(f"a group's batch of {a.shape[1]} does not split over the "
                             f"{self.n_inner} ranks of {self.inner_axes}")
        b = a.shape[1] // self.n_inner
        return a.narrow(1, self.inner * b, b)


def _strip(spec, axes):
    for a in axes:  # group axes cannot repeat in the param dims
        spec = strip_axis(spec, a)
    return spec


def mesh_layouts(layout, param_specs, mesh, gs: GroupSpec) -> MeshLayouts:
    """The rank's layouts of the global ``layout`` under ``param_specs`` and
    its groups under ``gs``."""
    tp_specs = sharding.tree_specs_map(lambda s: _strip(s, sharding.DP_AXES), param_specs)
    slot_specs = sharding.tree_specs_map(lambda s: _strip(s, gs.axes), param_specs)
    g_idx, n_g = sharding.coordinate(mesh, gs.axes)
    k = gs.num_groups // n_g
    inner_axes = tuple(a for a in mesh.mesh_dim_names
                       if a in sharding.DP_AXES and a not in gs.axes)
    d_idx, n_d = sharding.coordinate(mesh, inner_axes)
    return MeshLayouts(layout, layout.local(param_specs, mesh), layout.local(tp_specs, mesh),
                       layout.local(slot_specs, mesh), param_specs, tp_specs, slot_specs,
                       tuple(gs.axes), inner_axes, slice(g_idx * k, (g_idx + 1) * k), d_idx, n_d)


def init_mesh_train_state(shards, tc: TrainConfig, gs: GroupSpec, layouts: MeshLayouts,
                          mesh) -> dict:
    """A rank's train state from its shards of the parameter tree
    (``Model.init(gen, layouts.specs, mesh)``): its shard of the parameters,
    zero optimizer state and H (all in the ``store`` layout), and its
    groups' empty cache and pending slots ``[k, n_slot]`` in the slot layout
    (int8: a tree of :class:`Quantized` shards, each keeping its whole row's
    length as ``block``)."""
    params = layouts.store.flatten(shards)
    k = layouts.rows.stop - layouts.rows.start
    state = init_train_state(params, tc, GroupSpec(k, ()), layouts.store)
    dev = params.device
    dsag = init_dsag_state(torch.zeros(layouts.slot.numel, device=dev), GroupSpec(k, ()), tc,
                           layouts.slot)
    if tc.dsag_cache_dtype == "int8":
        for key in ("cache", "pending"):
            for x in layouts.full.leaves:
                q = get_path(dsag[key], x.path)
                set_path(dsag[key], x.path, Quantized(q.q, q.scale, x.shape[-1] if x.shape else 1))
    dsag.update(pending_valid=torch.zeros(gs.num_groups, dtype=torch.bool, device=dev),
                filled=torch.zeros(gs.num_groups, dtype=torch.bool, device=dev),
                h=state["dsag"]["h"])
    state["dsag"] = dsag
    return state


def gather_mesh_params(state, layouts: MeshLayouts, mesh) -> dict:
    """The full parameter tree (each leaf in its dtype) on every rank."""
    tree = layouts.store.dtensors(state["params"], layouts.specs, mesh, cast=True)
    return tree_map(lambda t: t.full_tensor(), tree)


def mesh_global_norm(x: torch.Tensor, layouts: MeshLayouts, mesh) -> torch.Tensor:
    """The global norm of a ``store``-layout tensor: each leaf's squares
    counted once however many ranks hold it, summed over every rank."""
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for leaf, view in zip(layouts.store.leaves, layouts.store.views(x)):
        rep = sharding.replication(get_path(layouts.specs, leaf.path), mesh)
        total = total + torch.sum(torch.square(view.to(torch.float32))) / rep
    torch.distributed.all_reduce(total)
    return torch.sqrt(total)


class MeshMeans(LocalMeans):
    """adafactor's means over one leaf's shard on a mesh (the reference's
    statistics specs: ``vr`` drops the last dim's axes, ``vc`` the
    second-to-last's): a mean over a dim the leaf's spec splits is the
    local sum, all-reduced over the ranks along that dim's axes, over the
    dim's global size; the RMS clip's mean over the whole leaf sums over
    every axis the spec splits, so it counts each element once however many
    ranks replicate it."""

    def __init__(self, spec, shape: tuple, mesh):
        self.spec, self.shape, self.mesh = spec, shape, mesh

    def mean(self, x, dim, pdim, keepdim=False):
        axes = sharding.dim_axes(self.spec, pdim, self.mesh)
        if not axes:
            return super().mean(x, dim, pdim, keepdim)
        total = x.sum(dim=dim, keepdim=keepdim)
        with sharding.collective_site("adafactor means"):
            sharding.all_reduce_over(total, self.mesh, axes)
        return total / self.shape[pdim]

    def mean_all(self, x):
        axes = sharding.spec_axes(self.spec, self.mesh)
        if not axes:
            return super().mean_all(x)
        total = torch.sum(x)
        with sharding.collective_site("adafactor means"):
            sharding.all_reduce_over(total, self.mesh, axes)
        return total / math.prod(self.shape)


def mesh_value_and_grad(loss_fn, layouts: MeshLayouts, mesh, grad_dtype):
    """Per-group ``(losses [k], grads [k, n_tp])`` of this rank's ``k``
    groups on its slice of each group's batch: each group's loss over the
    degathered parameters as ``DTensor`` leaves on the compute mesh, through
    autograd, one group at a time.  The group's batch is one token stream
    over the inner axes (``sharding.token_stream``): the MoE's dispatch
    chunks and aux loss are the whole group's, as the reference's."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication

    cmesh = sharding.compute_mesh(mesh)

    def fn(flat_tp, batch):
        k = _num_groups(batch)
        losses = torch.empty(k, dtype=torch.float32, device=flat_tp.device)
        grads = torch.empty((k, flat_tp.shape[0]), dtype=grad_dtype, device=flat_tp.device)
        for i in range(k):
            with torch.enable_grad(), implicit_replication(), \
                    sharding.token_stream(layouts.inner_axes):
                leaf = flat_tp.detach().requires_grad_(True)
                tree = layouts.tp.dtensors(leaf, layouts.tp_specs, cmesh, cast=True)
                loss = loss_fn(tree, tree_map(lambda a, i=i: a[i], batch))
                if isinstance(loss, DTensor):
                    # a mean over a split dim is Partial(avg) (whisper's
                    # loss): its gradient comes back replicated
                    loss = loss.full_tensor(grad_placements=[Replicate()] * cmesh.ndim)
                (grad,) = torch.autograd.grad(loss, leaf)
            grads[i] = grad
            losses[i] = loss.detach()
        return losses, grads

    return fn


def _make_mesh_step(job, tc: TrainConfig, gs: GroupSpec, mesh, param_specs, project_fn,
                    backend: str, layout):
    """The step of one rank of ``mesh``: see the module docstring."""
    if param_specs is None or layout is None or not callable(job):
        raise ValueError("a mesh step needs the model's loss_fn, param_specs and layout")
    if project_fn is not None:
        raise refuse(CAP_MESH, "a projected (PCA) step on a mesh")
    check_mesh_step(tc, gs, mesh)
    if not tc.dsag and gs != GroupSpec(1, ()):
        raise ValueError(f"a mesh step without DSAG takes make_group_spec's one group on no "
                         f"axes, not {gs}")
    L = mesh_layouts(layout, param_specs, mesh, gs)
    G, D = L.group_axes, L.inner_axes
    full_shape = {x.path: x.shape for x in layout.leaves}
    opt = make_optimizer(tc, L.store, means=lambda path: MeshMeans(
        get_path(param_specs, path), full_shape[path], mesh))
    float_slots = tc.dsag and tc.dsag_cache_dtype in _SLOT_DTYPES
    # a group's gradient is rounded to its float slots' dtype at once, unless
    # it is first averaged over the inner axes (in float32)
    grad_dtype = _SLOT_DTYPES[tc.dsag_cache_dtype] if float_slots and not D else torch.float32
    value_and_grad = mesh_value_and_grad(job, L, mesh, grad_dtype)

    def lead(spec) -> P:
        return P(None, *tuple(spec))

    def mean_over_inner(grads: torch.Tensor) -> torch.Tensor:
        """``[k, n_tp]`` per-rank gradients to ``[k, n_slot]``: each group's
        gradient averaged over the inner axes (every rank's slice is the
        same size, so the mean of their means is the group's)."""
        if not D:
            return grads  # the slot layout is the TP one
        out = torch.zeros((grads.shape[0], L.slot.numel), dtype=torch.float32,
                          device=grads.device)
        with sharding.collective_site("gradient mean"):
            for x, g, o in zip(L.tp.leaves, L.tp.views(grads), L.slot.views(out)):
                o.copy_(sharding.sum_to(g, mesh, lead(get_path(L.tp_specs, x.path)), D,
                                        lead(get_path(L.slot_specs, x.path))))
        return out.div_(L.n_inner)

    def sum_over_groups(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """A slot-layout ``[n_slot]`` tensor summed over the group axes, laid
        out as H (``like``): a reduce-scatter over ``data`` for ``dp``
        groups, an all-reduce over ``pod`` for ``pod``; for ``zero`` and
        ``none`` every group is on the rank and the layouts agree."""
        if not G:
            return x
        out = torch.zeros_like(like)
        with sharding.collective_site("H sum"):
            for x_, v, o in zip(L.slot.leaves, L.slot.views(x), L.store.views(out)):
                o.copy_(sharding.sum_to(v, mesh, get_path(L.slot_specs, x_.path), G,
                                        get_path(param_specs, x_.path)))
        return out

    def row_reducer(path):
        axes = sharding.dim_axes(get_path(L.slot_specs, path), -1, mesh)
        if not axes:
            return None

        def reduce(maxima):
            with sharding.collective_site("int8 row max"):
                sharding.all_reduce_max(maxima, mesh, axes)

        return reduce

    def update(dsag, g, mask, flush, evict):
        """The cache rule on this rank's groups and slot shards (K4 or
        K4-int8), H from their deltas summed over the group axes."""
        mask = mask & ~evict
        eff_flush = flush & ~mask & dsag["pending_valid"]
        take_new = mask | eff_flush | ~dsag["pending_valid"]
        r = L.rows
        # with no group axes H is laid out as the slots: K4 adds into it
        h_in = dsag["h"] if not G else torch.zeros(L.slot.numel, dtype=torch.float32,
                                                   device=g.device)
        local = {"cache": dsag["cache"], "pending": dsag["pending"], "h": h_in}
        if isinstance(dsag["cache"], dict):
            new_c, new_pending, h_out = _update_int8_leaves(
                local, g, mask[r], eff_flush[r], evict[r], take_new[r], backend, L.slot,
                row_reducer)
        else:
            new_c, new_pending, h_out = _update_slots(
                local, g, mask[r], eff_flush[r], evict[r], take_new[r], backend)
        new_h = h_out if not G else dsag["h"] + sum_over_groups(h_out, dsag["h"])
        return _finish_update(dsag, new_c, new_pending, new_h, mask, eff_flush, evict)

    def step(state, batch, mask, flush, evict=None):
        params = state["params"]
        tree = L.store.dtensors(params, param_specs, mesh, cast=True)
        with sharding.collective_site("degather"):
            gathered = sharding.degather(tree, param_specs, mesh,
                                         quantized=tc.quantized_fsdp_allgather)
        flat_tp = L.tp.flatten(tree_map(lambda t: t.to_local(), gathered))
        losses_l, grads = value_and_grad(flat_tp, tree_map(L.local_batch, batch))
        g = mean_over_inner(grads)
        mask_count = mask.sum()
        if evict is None:
            evict = torch.zeros_like(mask)
        if tc.dsag:
            new_dsag, h_hat, xi = update(state["dsag"], g, mask, flush, evict)
        else:  # the reference's branch: Ĥ is the (one group's) gradient, no cache
            new_dsag = state["dsag"]
            xi = torch.ones((), dtype=torch.float32, device=params.device)
            h_hat = g[0].to(torch.float32)

        with sharding.collective_site("norm"):
            gnorm = mesh_global_norm(h_hat, L, mesh)
        if tc.grad_clip > 0:
            h_hat = h_hat * torch.clamp(tc.grad_clip / (gnorm + 1e-9), max=1.0)
        updates, new_opt = opt.update(h_hat, state["opt"], params)
        new_params = apply_updates(params, updates, L.store)
        with sharding.collective_site("losses"):
            losses = sharding.partial_sum(losses_l, mesh, P(gs.group_partition),
                                          D).full_tensor() / L.n_inner
        new_state = {"params": new_params, "opt": new_opt, "dsag": new_dsag,
                     "step": state["step"] + 1}
        metrics = {"loss": losses.mean(), "per_group_loss": losses, "grad_norm": gnorm,
                   "xi": xi, "mask_count": mask_count}
        return new_state, metrics

    step.layouts = L
    return step
