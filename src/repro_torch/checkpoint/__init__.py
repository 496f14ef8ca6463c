"""Fault-tolerant checkpointing (counterpart of ``repro.checkpoint``)."""

from repro_torch._exports import lazy_exports

#: the reference's public names -> the submodule that holds each
_EXPORTS = {
    "CheckpointManager": "checkpoint",
    "latest_checkpoint": "checkpoint",
    "restore_checkpoint": "checkpoint",
    "save_checkpoint": "checkpoint",
}
__all__ = list(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
