"""Configuration dataclasses of the port."""

from repro_torch.configs.base import TrainConfig

__all__ = ["TrainConfig"]
