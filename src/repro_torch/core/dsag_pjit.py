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

On a ``(data, model)`` device mesh (``mesh=``, ``param_specs=``) every rank
runs the step on its own shards (:func:`make_train_step`; the layout is
``models/sharding.py``'s).  The groups lie on the data axes, one group per
data rank: the rank all-gathers its parameters over ``data`` to their
TP-only layout (``degather``, int8 with ``quantized_fsdp_allgather``),
computes its group's gradient over DTensors on the ``model`` axis,
and updates its own cache and pending slot with K4 over its local ``[1,
n]`` shard.  H is the sum of the groups' deltas: each rank's delta is
reduce-scattered over ``data`` to H's FSDP layout, so H, the optimizer
moments and the parameters stay sharded as ``train_state_specs`` says.
The spec functions (``opt_state_specs``, ``dsag_state_specs``,
``train_state_specs``, ``batch_group_specs``) are the reference's.  What a
mesh step does not run is refused before any launch with
:data:`CAP_MESH`: groups off the data axes (the ``zero`` and ``none``
layouts, and ``dsag=False``), int8 slots and adafactor (their per-row
statistics span shards).
"""

from __future__ import annotations

import dataclasses
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
    """Refuse, before any launch, what a mesh step does not run."""
    dp = tuple(a for a in mesh.mesh_dim_names if a in sharding.DP_AXES)
    if not tc.dsag or gs.axes != dp:
        raise refuse(CAP_MESH, f"a mesh step runs DSAG with one group per data-parallel rank "
                               f"(dsag_groups='dp'); got dsag={tc.dsag}, groups on {gs.axes}")
    if tc.dsag_cache_dtype == "int8":
        raise refuse(CAP_MESH, "int8 DSAG slots on a mesh: their per-row scales span the "
                               "row's TP shards")
    if tc.optimizer == "adafactor":
        raise refuse(CAP_MESH, "adafactor on a mesh: its factored statistics span shards")


@dataclasses.dataclass(frozen=True)
class MeshLayouts:
    """A rank's two flat layouts: ``store`` (its shards under the parameter
    specs: parameters, moments, H) and ``tp`` (its shards with the
    data-parallel axes stripped: the degathered parameters, its group's
    gradient and cache slots)."""

    store: Any
    tp: Any
    specs: Any
    tp_specs: Any


def mesh_layouts(layout, param_specs, mesh) -> MeshLayouts:
    """The rank's layouts of the global ``layout`` under ``param_specs``."""

    def strip_dp(spec):
        for a in sharding.DP_AXES:
            spec = strip_axis(spec, a)
        return spec

    tp_specs = sharding.tree_specs_map(strip_dp, param_specs)
    return MeshLayouts(layout.local(param_specs, mesh), layout.local(tp_specs, mesh),
                       param_specs, tp_specs)


def _shards(layout, tree, specs, mesh) -> dict:
    out: dict = {}
    for x in layout.leaves:
        set_path(out, x.path, sharding.local_shard(get_path(tree, x.path),
                                                   get_path(specs, x.path), mesh))
    return out


def init_mesh_train_state(params_tree, tc: TrainConfig, gs: GroupSpec, layouts: MeshLayouts,
                          mesh) -> dict:
    """A rank's train state from the full parameter tree (the same on every
    rank): its shard of the parameters, zero moments and H (all in the
    ``store`` layout), its group's empty cache and pending slot ``[k, n_tp]``
    in the slots' dtype."""
    params = layouts.store.flatten(_shards(layouts.store, params_tree, layouts.specs, mesh))
    k = gs.num_groups // sharding.dp_coordinate(mesh)[1]
    state = init_train_state(params, tc, GroupSpec(k, ()), layouts.store)
    dev = params.device
    slot = torch.zeros((k, layouts.tp.numel), dtype=_SLOT_DTYPES[tc.dsag_cache_dtype], device=dev)
    state["dsag"].update(cache=slot, pending=slot.clone(),
                         pending_valid=torch.zeros(gs.num_groups, dtype=torch.bool, device=dev),
                         filled=torch.zeros(gs.num_groups, dtype=torch.bool, device=dev))
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


def mesh_value_and_grad(loss_fn, layouts: MeshLayouts, mesh, grad_dtype):
    """Per-group ``(losses [k], grads [k, n_tp])`` of this rank's ``k``
    groups: each group's loss over the degathered parameters as ``DTensor``
    leaves on the compute mesh, through autograd, one group at a time."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    cmesh = sharding.compute_mesh(mesh)

    def fn(flat_tp, batch):
        k = _num_groups(batch)
        losses = torch.empty(k, dtype=torch.float32, device=flat_tp.device)
        grads = torch.empty((k, flat_tp.shape[0]), dtype=grad_dtype, device=flat_tp.device)
        for i in range(k):
            with torch.enable_grad(), implicit_replication():
                leaf = flat_tp.detach().requires_grad_(True)
                tree = layouts.tp.dtensors(leaf, layouts.tp_specs, cmesh, cast=True)
                loss = loss_fn(tree, tree_map(lambda a, i=i: a[i], batch))
                if isinstance(loss, DTensor):
                    loss = loss.full_tensor()
                (grad,) = torch.autograd.grad(loss, leaf)
            grads[i] = grad
            losses[i] = loss.detach()
        return losses, grads

    return fn


def _make_mesh_step(job, tc: TrainConfig, gs: GroupSpec, mesh, param_specs, project_fn,
                    backend: str, layout):
    """The step of one rank of ``mesh``: see the module docstring."""
    from torch.distributed.tensor import DTensor

    if param_specs is None or layout is None or not callable(job):
        raise ValueError("a mesh step needs the model's loss_fn, param_specs and layout")
    if project_fn is not None:
        raise refuse(CAP_MESH, "a projected (PCA) step on a mesh")
    check_mesh_step(tc, gs, mesh)
    layouts = mesh_layouts(layout, param_specs, mesh)
    opt = make_optimizer(tc, layouts.store)
    value_and_grad = mesh_value_and_grad(job, layouts, mesh, _SLOT_DTYPES[tc.dsag_cache_dtype])
    g_idx, n_dp = sharding.dp_coordinate(mesh)
    k = gs.num_groups // n_dp
    rows = slice(g_idx * k, (g_idx + 1) * k)

    def reduce_delta(delta_tp: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """Σ over the data-parallel ranks of each one's delta, laid out as H."""
        out = torch.empty_like(like)
        for x, d, o in zip(layouts.tp.leaves, layouts.tp.views(delta_tp),
                           layouts.store.views(out)):
            summed = sharding.partial_sum(d, mesh, get_path(layouts.tp_specs, x.path), gs.axes)
            o.copy_(summed.redistribute(mesh, sharding.placements(
                get_path(layouts.specs, x.path), mesh)).to_local())
        return out

    def step(state, batch, mask, flush, evict=None):
        params = state["params"]
        tree = layouts.store.dtensors(params, param_specs, mesh, cast=True)
        gathered = sharding.degather(tree, param_specs, mesh,
                                     quantized=tc.quantized_fsdp_allgather)
        flat_tp = layouts.tp.flatten(tree_map(lambda t: t.to_local(), gathered))
        local_batch = tree_map(lambda a: a[rows], batch)
        losses_l, grads = value_and_grad(flat_tp, local_batch)

        dsag = state["dsag"]
        mask_count = mask.sum()
        if evict is None:
            evict = torch.zeros_like(mask)
        mask = mask & ~evict
        eff_flush = flush & ~mask & dsag["pending_valid"]
        take_new = mask | eff_flush | ~dsag["pending_valid"]
        local = {"cache": dsag["cache"], "pending": dsag["pending"],
                 "h": torch.zeros(layouts.tp.numel, dtype=torch.float32, device=params.device)}
        new_c, new_pending, delta = _update_slots(
            local, grads, mask[rows], eff_flush[rows], evict[rows], take_new[rows], backend)
        new_h = dsag["h"] + reduce_delta(delta, dsag["h"])
        new_dsag, h_hat, xi = _finish_update(dsag, new_c, new_pending, new_h, mask, eff_flush,
                                             evict)

        gnorm = mesh_global_norm(h_hat, layouts, mesh)
        if tc.grad_clip > 0:
            h_hat = h_hat * torch.clamp(tc.grad_clip / (gnorm + 1e-9), max=1.0)
        updates, new_opt = opt.update(h_hat, state["opt"], params)
        new_params = apply_updates(params, updates, layouts.store)
        losses = DTensor.from_local(losses_l, mesh, sharding.placements(
            P(gs.group_partition), mesh), run_check=False).full_tensor()
        new_state = {"params": new_params, "opt": new_opt, "dsag": new_dsag,
                     "step": state["step"] + 1}
        metrics = {"loss": losses.mean(), "per_group_loss": losses, "grad_norm": gnorm,
                   "xi": xi, "mask_count": mask_count}
        return new_state, metrics

    step.layouts = layouts
    return step

