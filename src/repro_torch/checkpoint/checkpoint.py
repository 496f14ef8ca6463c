"""Atomic, async, retention-managed checkpoints of the live trainer's state,
from ``repro.checkpoint.checkpoint``; the files are the reference's.

Layout:  ``<dir>/step_<n:08d>/``  ``arrays.npz`` + ``manifest.json``
(``step``, ``paths``, ``dtypes``, ``time``).  Leaves are written in
``jax.tree_util.tree_flatten``'s order for the same state (dict keys sorted,
a :class:`~repro_torch.optim.compression.Quantized` slot as ``q`` then
``scale``), under the same path strings (``['dsag']/['cache']/[<flat index
0>]``), so either package restores what the other wrote.  bfloat16 leaves are
stored as their uint16 bits and tagged ``"bfloat16"`` (npz holds no
bfloat16).  A model's train state, whose tensors are flat (one
:class:`~repro_torch.models.layers.FlatLayout` row per group), is written as
the reference's tree of leaves (:func:`train_state_tree`: parameters in
their own dtypes; optimizer moments, DSAG cache, pending and H per leaf) and
read back by :func:`train_state_from_tree`, so a checkpoint of the
reference's model-zoo trainer restores in the port and the other way
round.  Writes go to ``step_<n>.tmp`` and are renamed into place; a
:class:`CheckpointManager` writes on a background thread, at most one write
in flight, and keeps the newest ``keep``.  On a mesh, saving gathers each
``DTensor`` leaf's full value (every rank takes part; rank 0 writes), so a
checkpoint is the same with or without a mesh, and ``restore_checkpoint(...,
shardings=)`` reads full arrays and gives each rank its shard, laid out by
a tree of :class:`~repro_torch.models.sharding.NamedSharding`.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.models import sharding
from repro_torch.optim.compression import Quantized


def _encode(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host numpy array and its dtype tag (bfloat16 as its uint16 bits)."""
    t = sharding.full(t.detach()).cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _decode(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _flatten_with_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` in the reference's flatten order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_with_paths(tree[k], f"{prefix}/[{k!r}]" if prefix else f"[{k!r}]")
        return out
    if isinstance(tree, Quantized):
        return [(f"{prefix}/[<flat index 0>]", tree.q), (f"{prefix}/[<flat index 1>]", tree.scale)]
    return [(prefix, tree)]


def _unflatten(like, leaves: list):
    """``like``'s structure holding ``leaves`` (consumed in flatten order)."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, Quantized):
        q = leaves.pop(0)
        return Quantized(q=q, scale=leaves.pop(0), block=like.block)
    return leaves.pop(0)


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, Quantized):
        return Quantized(_to_host(tree.q), _to_host(tree.scale), tree.block)
    return sharding.full(tree.detach()).to("cpu", copy=True)


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    """Blocking atomic save.  Returns the final checkpoint path.  A tree of
    DTensors is gathered on every rank and written by rank 0 (all ranks
    call this; they leave it once the file is in place)."""
    final = os.path.join(directory, f"step_{step:08d}")
    if any(sharding.is_sharded(leaf) for _, leaf in _flatten_with_paths(tree)):
        tree = _to_host(tree)
        if torch.distributed.get_rank() == 0:
            save_checkpoint(directory, step, tree)
        torch.distributed.barrier()
        return final
    os.makedirs(directory, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten_with_paths(tree)
    encoded = [_encode(leaf) for _, leaf in flat]
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"a{i}": a for i, (a, _) in enumerate(encoded)})
    manifest = {
        "step": step,
        "paths": [p for p, _ in flat],
        "dtypes": [d for _, d in encoded],
        "time": time.time(),
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _steps(directory: str) -> list[str]:
    return sorted(d for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_checkpoint(directory: str) -> str | None:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return os.path.join(directory, steps[-1]) if steps else None


def restore_checkpoint(path: str, like: Any, shardings: Any | None = None) -> Any:
    """Restore into the structure of ``like``, each leaf on ``like``'s
    leaf's device; with ``shardings`` (a tree like ``like`` of
    :class:`~repro_torch.models.sharding.NamedSharding`), each leaf as a
    ``DTensor`` holding this rank's shard."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat_like = [leaf for _, leaf in _flatten_with_paths(like)]
    with np.load(os.path.join(path, "arrays.npz")) as data:
        if len(data.files) != len(flat_like):
            raise ValueError(f"checkpoint has {len(data.files)} leaves, expected "
                             f"{len(flat_like)}")
        arrays = [data[f"a{i}"] for i in range(len(data.files))]
    leaves = []
    for a, dt, leaf in zip(arrays, manifest["dtypes"], flat_like):
        if tuple(a.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch {a.shape} vs {tuple(leaf.shape)}")
        leaves.append(_decode(a, dt, leaf.device))
    restored = _unflatten(like, leaves)
    if shardings is not None:
        restored = _place(restored, shardings)
    return restored


def _place(tree, shardings):
    if isinstance(tree, dict):
        return {k: _place(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, Quantized):
        return Quantized(_place(tree.q, shardings.q), _place(tree.scale, shardings.scale),
                         tree.block)
    if not isinstance(shardings, sharding.NamedSharding):
        raise TypeError(f"shardings holds a NamedSharding per leaf "
                        f"(repro_torch.models.sharding), got {type(shardings).__name__}")
    return shardings.place(tree)


#: optimizer entries that are flat like the parameters (adafactor's ``stats``
#: are a tree already)
_FLAT_OPT = ("m", "v", "mu")


def train_state_tree(state: dict, layout) -> dict:
    """A model's flat train state as the reference's tree (views of the
    flat tensors; the parameters cast to their leaves' dtypes)."""
    dsag = dict(state["dsag"])
    for k in ("cache", "pending"):
        if torch.is_tensor(dsag[k]):  # int8 slots are a tree of leaves already
            dsag[k] = layout.tree(dsag[k])
    dsag["h"] = layout.tree(dsag["h"])
    return {
        "params": layout.tree(state["params"], cast=True),
        "opt": {k: layout.tree(v) if k in _FLAT_OPT else v for k, v in state["opt"].items()},
        "dsag": dsag,
        "step": state["step"],
    }


def train_state_from_tree(tree: dict, layout) -> dict:
    """The flat train state of a tree in :func:`train_state_tree`'s layout
    (new tensors; float DSAG slots keep the tree's dtype)."""
    dsag = dict(tree["dsag"])
    for k in ("cache", "pending"):
        first = dsag[k]
        while isinstance(first, dict):
            first = next(iter(first.values()))
        if torch.is_tensor(first):  # int8 slots stay a tree of leaves
            dsag[k] = layout.flatten(dsag[k], first.dtype)
    dsag["h"] = layout.flatten(dsag["h"])
    return {
        "params": layout.flatten(tree["params"]),
        "opt": {k: layout.flatten(v) if k in _FLAT_OPT else v for k, v in tree["opt"].items()},
        "dsag": dsag,
        "step": tree["step"],
    }


class CheckpointManager:
    """Async save + retention.  ``save`` returns immediately; the previous
    in-flight save is joined first (at most one outstanding write)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.saved_steps: list[int] = []

    def _gc(self) -> None:
        if not os.path.isdir(self.directory):
            return
        steps = _steps(self.directory)
        for d in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, d), ignore_errors=True)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        self.wait()
        # copied to the host before the writer thread sees it
        host_tree = _to_host(tree)

        def run():
            save_checkpoint(self.directory, step, host_tree)
            self._gc()

        if blocking:
            run()
        else:
            self._thread = threading.Thread(target=run, daemon=True)
            self._thread.start()
        self.saved_steps.append(step)

    def restore_latest(self, like: Any, shardings: Any | None = None):
        self.wait()
        path = latest_checkpoint(self.directory)
        if path is None:
            return None, -1
        with open(os.path.join(path, "manifest.json")) as f:
            step = json.load(f)["step"]
        return restore_checkpoint(path, like, shardings), step
