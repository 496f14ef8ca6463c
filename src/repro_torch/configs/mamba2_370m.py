"""mamba2-370m [ssm]: 48L, d_model=1024, attention-free, vocab=50280,
ssm_state=128 — SSD (state-space duality).  [arXiv:2405.21060]

Copied field for field from ``repro.configs.mamba2_370m``, the smoke config included."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        family="ssm",
        num_layers=48,
        d_model=1024,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        tie_embeddings=True,
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,  # d_inner=2048 -> 32 SSD heads
        ssm_chunk=128,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m-smoke",
        family="ssm",
        num_layers=2,
        d_model=64,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=512,
        tie_embeddings=True,
        ssm_state=16,
        ssm_expand=2,
        ssm_head_dim=16,
        ssm_chunk=16,
    )
