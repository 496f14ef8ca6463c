"""Carry the reference's state across: problem data, traces, initial iterate,
the live trainer's train state, a served model's parameters and a
model-zoo train state.

This system has no weights.  Its state is the problem data and the latency
traces, so these helpers rebuild the port's problem and
:class:`~repro_torch.latency.model.FleetTraces` from plain numpy arrays (as
the JAX package holds them), and the initial iterate ``V0`` travels as a
numpy array (``run_convergence_batch(..., V0=...)``).  The model zoo's
parameters travel as the reference's nested dicts of numpy arrays.  The
parity tests hand the reference's exact inputs to the port through them.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import train_state_from_tree
from repro_torch.core.problems import (
    FiniteSumProblem,
    LogisticRegressionProblem,
    PCAProblem,
)
from repro_torch.latency.model import FleetTraces
from repro_torch.models.layers import FlatLayout, ParamDecl, tree_map, torch_dtype
from repro_torch.models.model import model_decls
from repro_torch.optim.compression import Quantized


def problem_from_arrays(
    kind: str, X, y=None, k: int = 3, lam: float | None = None, device=None
) -> FiniteSumProblem:
    """A ``"logreg"`` or ``"pca"`` problem over the given numpy data.

    With ``device`` set, the problem's kernels are built there at once (the
    data moved to the device, the logreg optimum solved).
    """
    X = np.asarray(X)
    if kind == "logreg":
        if y is None:
            raise ValueError("logreg needs labels y")
        prob: FiniteSumProblem = LogisticRegressionProblem(X=X, y=np.asarray(y), lam=lam)
    elif kind == "pca":
        prob = PCAProblem(X=X, k=k)
    else:
        raise ValueError(f"unknown problem kind {kind!r}; expected 'logreg' or 'pca'")
    if device is not None:
        prob.fused_kernels(device)
    return prob


def traces_from_arrays(
    comm, comp_unit, slowdown, burst_start, burst_end, burst_factor, seed: int = 0
) -> FleetTraces:
    """:class:`FleetTraces` over the given ``[S, N, K]`` / ``[N]`` /
    ``[S, N, M]`` float64 arrays (no churn)."""

    def f64(a):
        return np.asarray(a, dtype=np.float64)

    comm, comp_unit = f64(comm), f64(comp_unit)
    if comm.shape != comp_unit.shape or comm.ndim != 3:
        raise ValueError("comm and comp_unit must be [S, N, K] of one shape")
    bs, be, bf = f64(burst_start), f64(burst_end), f64(burst_factor)
    if not (bs.shape == be.shape == bf.shape) or bs.shape[:2] != comm.shape[:2]:
        raise ValueError("burst tables must be [S, N, M] matching the traces")
    return FleetTraces(comm, comp_unit, f64(slowdown), bs, be, bf, seed=seed)


def train_state_from_arrays(
    params, cache, pending, pending_valid, filled, h, mu, step, device="cuda",
    slot_dtype=torch.float32,
) -> dict:
    """The live trainer's train state from numpy arrays of the reference's.

    ``params`` and ``h`` are float32; ``cache`` / ``pending`` [P, ...] are
    float32 arrays stored as ``slot_dtype`` (bfloat16 slots travel as
    float32 holding bfloat16 values, so the conversion is exact), or the
    reference's int8 slots as ``(q, scale)`` pairs (the bfloat16 scales as
    float32 arrays; one block per row of the last axis); ``pending_valid`` /
    ``filled`` [P] bool; ``step`` an int.  ``mu`` is the sgd momentum array,
    or the reference's whole optimizer state as a dict of numpy arrays
    (adamw's ``m``, ``v``, ``step``; adafactor's ``stats``, ``step``).
    """
    dev = torch.device(device)

    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)

    def slot(a):
        if isinstance(a, (tuple, list)):
            q, scale = a
            q = torch.as_tensor(np.asarray(q, dtype=np.int8), device=dev)
            return Quantized(q=q, scale=f32(scale).to(torch.bfloat16), block=q.shape[-1])
        return f32(a).to(slot_dtype)

    def opt_tree(t):
        if isinstance(t, dict):
            return {k: opt_tree(v) for k, v in t.items()}
        a = np.asarray(t)
        if np.issubdtype(a.dtype, np.integer):
            return torch.as_tensor(a.astype(np.int32), device=dev)
        return f32(a)

    step_t = torch.tensor(int(step), dtype=torch.int32, device=dev)
    opt = (opt_tree(mu) if isinstance(mu, dict)
           else {"mu": f32(mu), "step": step_t.clone()})
    return {
        "params": f32(params),
        "opt": opt,
        "dsag": {
            "cache": slot(cache),
            "pending": slot(pending),
            "pending_valid": torch.as_tensor(np.asarray(pending_valid, dtype=bool), device=dev),
            "filled": torch.as_tensor(np.asarray(filled, dtype=bool), device=dev),
            "h": f32(h),
        },
        "step": step_t,
    }


def model_params_from_arrays(cfg, tree, device="cuda") -> dict:
    """The port's parameters of ``cfg``'s model from the reference's tree.

    ``tree`` is the reference's parameter tree as nested dicts of numpy
    arrays (the same keys, stacked ``[L, ...]`` block leaves; whisper's
    ``enc_blocks``, ``enc_pos``, ``cross`` and ``ln_x`` included).  Each leaf is
    stored in its declared dtype; bfloat16 leaves travel as float32 arrays
    holding bfloat16 values, so the conversion is exact.
    """
    dev = torch.device(device)

    def convert(decl, a, path):
        if isinstance(decl, ParamDecl):
            a = np.asarray(a)
            if tuple(a.shape) != tuple(decl.shape):
                raise ValueError(f"{path}: expected shape {decl.shape}, got {a.shape}")
            t = torch.as_tensor(a.astype(np.float32), device=dev)
            return t.to(torch_dtype(decl.dtype or cfg.dtype))
        if set(decl) != set(a):
            raise ValueError(f"{path or 'params'}: keys {sorted(a)} differ from the "
                             f"declared {sorted(decl)}")
        return {k: convert(decl[k], a[k], f"{path}/{k}") for k in decl}

    return convert(model_decls(cfg), tree, "")


def model_train_state_from_arrays(cfg, params, opt, dsag, step, device="cuda",
                                  slot_dtype=torch.bfloat16) -> dict:
    """The port's flat model-zoo train state from the reference's trees.

    ``params`` as :func:`model_params_from_arrays` takes it; ``opt`` the
    reference's optimizer state (adamw's ``m``, ``v``, ``step``; sgd's
    ``mu``, ``step``; adafactor's ``stats``, ``step``) and ``dsag`` its DSAG
    state (``cache`` / ``pending`` trees of ``[P, ...]`` slots, ``h``,
    ``pending_valid``, ``filled``), all nested dicts of numpy arrays.  Float
    slots are float32 arrays holding ``slot_dtype``'s values (bfloat16 by
    default, ``TrainConfig()``'s), so the conversion is exact; an int8 slot
    leaf is a ``(q, scale)`` pair (scales as float32 arrays, one block per
    row of the leaf's last axis).  ``step`` is an int.
    """
    dev = torch.device(device)
    layout = FlatLayout.from_decls(model_decls(cfg), cfg.dtype)

    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)

    def array(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.integer):
            return torch.as_tensor(a.astype(np.int32), device=dev)
        return f32(a)

    def slots(tree):
        if isinstance(tree, dict):
            return {k: slots(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            q, scale = tree
            q = torch.as_tensor(np.asarray(q, dtype=np.int8), device=dev)
            return Quantized(q=q, scale=f32(scale).to(torch.bfloat16), block=q.shape[-1])
        return f32(tree).to(slot_dtype)

    def flags(a):
        return torch.as_tensor(np.asarray(a, dtype=bool), device=dev)

    tree = {
        "params": model_params_from_arrays(cfg, params, device=dev),
        "opt": tree_map(array, opt),
        "dsag": {"cache": slots(dsag["cache"]), "pending": slots(dsag["pending"]),
                 "pending_valid": flags(dsag["pending_valid"]), "filled": flags(dsag["filled"]),
                 "h": tree_map(f32, dsag["h"])},
        "step": torch.tensor(int(step), dtype=torch.int32, device=dev),
    }
    return train_state_from_tree(tree, layout)
