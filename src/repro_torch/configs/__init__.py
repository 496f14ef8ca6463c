"""Configuration dataclasses of the port and the registry of the model archs
it serves: ``get_config(arch)`` / ``get_smoke_config(arch)``.

Every arch of the JAX package's registry is here: the dense family
(qwen1.5-0.5b, qwen2-7b, qwen1.5-32b, starcoder2-15b), MoE (grok-1-314b;
deepseek-v2-236b, with MLA), SSM (mamba2-370m), hybrid (zamba2-2.7b), VLM
(pixtral-12b) and enc-dec (whisper-base).  All of them serve and train.
An unknown name is refused with :data:`~repro_torch.experiments.engine.CAP_ARCH`.
"""

from __future__ import annotations

import importlib

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


__all__ = ["ARCHS", "SHAPES", "MeshConfig", "ModelConfig", "ShapeConfig", "TrainConfig",
           "get_config", "get_smoke_config"]
