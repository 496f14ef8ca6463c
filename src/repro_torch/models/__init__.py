"""The model zoo's dense, MoE, SSM and hybrid families behind the reference's
model API."""

from repro_torch.models.model import Model, build_model, cache_abstract

__all__ = ["Model", "build_model", "cache_abstract"]
