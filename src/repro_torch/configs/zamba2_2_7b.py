"""zamba2-2.7b [hybrid]: 54 Mamba2 layers, d_model=2560, a single SHARED
attention block (32H) applied every 6 layers, d_ff=10240, vocab=32000,
ssm_state=64.  [arXiv:2411.15242]

Copied field for field from ``repro.configs.zamba2_2_7b``, the smoke config included."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        num_layers=54,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        d_ff=10240,
        vocab_size=32000,
        head_pad_to=16,
        kv_pad_to=16,
        attn_every=6,
        ssm_state=64,
        ssm_expand=2,
        ssm_head_dim=64,  # d_inner=5120 -> 80 SSD heads
        ssm_chunk=128,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b-smoke",
        family="hybrid",
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        attn_every=2,
        ssm_state=16,
        ssm_expand=2,
        ssm_head_dim=16,
        ssm_chunk=16,
    )
