"""The model zoo's families (dense, MoE, MLA, SSM, hybrid, VLM, enc-dec)
behind the reference's model API."""

from repro_torch.models.model import Model, build_model, cache_abstract

__all__ = ["Model", "build_model", "cache_abstract"]
