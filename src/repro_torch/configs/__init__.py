"""Configuration dataclasses of the port and the registry of the model archs
it serves: ``get_config(arch)`` / ``get_smoke_config(arch)``.

Every arch of the JAX package's registry is here: the dense family
(qwen1.5-0.5b, qwen2-7b, qwen1.5-32b, starcoder2-15b), MoE (grok-1-314b;
deepseek-v2-236b, with MLA), SSM (mamba2-370m), hybrid (zamba2-2.7b), VLM
(pixtral-12b) and enc-dec (whisper-base).  All of them serve and train.
An unknown name is refused with :data:`~repro_torch.experiments.engine.CAP_ARCH`.
:func:`cell_is_runnable` and :func:`input_specs` describe the reference's
(arch x shape) cells, which ``repro_torch.launch.dryrun`` counts.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any

import torch

from repro_torch.configs.base import SHAPES, MeshConfig, ModelConfig, ShapeConfig, TrainConfig
from repro_torch.experiments.engine import CAP_ARCH, refuse

_MODULES: dict[str, str] = {
    "qwen1.5-0.5b": "repro_torch.configs.qwen1_5_0_5b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "grok-1-314b": "repro_torch.configs.grok1_314b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
    "qwen1.5-32b": "repro_torch.configs.qwen1_5_32b",
    "starcoder2-15b": "repro_torch.configs.starcoder2_15b",
    "pixtral-12b": "repro_torch.configs.pixtral_12b",
    "whisper-base": "repro_torch.configs.whisper_base",
}

ARCHS = tuple(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise refuse(CAP_ARCH, f"arch {name!r} is not in the registry; the port serves {ARCHS}")
    return importlib.import_module(_MODULES[name])


def get_config(name: str) -> ModelConfig:
    return _module(name).config()


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config()


def cell_is_runnable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k runs only for sub-quadratic (SSM/hybrid) archs."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False
    return True


@dataclasses.dataclass(frozen=True)
class InputSpec:
    """One model input of a cell: a meta tensor of its global shape and dtype
    (no storage) and, with a mesh, its :class:`~repro_torch.models.sharding.
    PartitionSpec` (the reference's ``ShapeDtypeStruct`` and its sharding)."""

    meta: torch.Tensor
    spec: Any = None

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.meta.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.meta.dtype


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh=None) -> dict[str, InputSpec]:
    """Abstract model inputs for one cell (training batch or prefill batch):
    the reference's shapes, dtypes and specs (tokens int32, the batch over
    the mesh's ``pod``/``data`` axes, embeddings bfloat16).  ``mesh`` is a
    ``DeviceMesh`` or a :class:`MeshConfig` (its axis names are read);
    without one the specs are None.  The port's models take int32 tokens, as
    the reference's.

    Decode-cell *cache* stand-ins come from ``Model.cache_abstract``."""
    from repro_torch.models.sharding import P

    b, s = shape.global_batch, shape.seq_len
    names = () if mesh is None else tuple(
        getattr(mesh, "mesh_dim_names", None) or getattr(mesh, "axes", ()))
    dp = tuple(a for a in names if a in ("pod", "data")) or None
    dp = dp if dp is None or len(dp) > 1 else dp[0]

    def sharded(shp, dtype, spec):
        return InputSpec(torch.empty(shp, dtype=dtype, device="meta"),
                         None if mesh is None else spec)

    if shape.kind == "decode":
        return {"tokens": sharded((b, 1), torch.int32, P(dp, None))}
    if cfg.family == "enc_dec":
        return {
            "tokens": sharded((b, s), torch.int32, P(dp, None)),
            "audio_embed": sharded((b, cfg.encoder_seq, cfg.d_model), torch.bfloat16,
                                   P(dp, None, None)),
        }
    if cfg.family == "vlm":
        return {
            "tokens": sharded((b, s - cfg.num_image_tokens), torch.int32, P(dp, None)),
            "image_embed": sharded((b, cfg.num_image_tokens, cfg.d_model), torch.bfloat16,
                                   P(dp, None, None)),
        }
    return {"tokens": sharded((b, s), torch.int32, P(dp, None))}


__all__ = ["ARCHS", "SHAPES", "InputSpec", "MeshConfig", "ModelConfig", "ShapeConfig",
           "TrainConfig", "cell_is_runnable", "get_config", "get_smoke_config", "input_specs"]
