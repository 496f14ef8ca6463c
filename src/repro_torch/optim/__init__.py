"""Optimizers and int8 compression (counterpart of ``repro.optim``)."""

from repro_torch._exports import lazy_exports

#: the reference's public names -> the submodule that holds each
_EXPORTS = {
    "Optimizer": "optimizers",
    "adafactor": "optimizers",
    "adamw": "optimizers",
    "apply_updates": "optimizers",
    "clip_by_global_norm": "optimizers",
    "global_norm": "optimizers",
    "make_optimizer": "optimizers",
    "sgd": "optimizers",
    "Quantized": "compression",
    "dequantize": "compression",
    "dequantize_tree": "compression",
    "quantize": "compression",
    "quantize_tree": "compression",
}
__all__ = list(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
