"""starcoder2-15b [dense]: 40L, d_model=6144, 48H (GQA kv=4), d_ff=24576,
vocab=49152 — GQA, RoPE, biases, GELU MLP.  [arXiv:2402.19173]

Copied from ``repro.configs.starcoder2_15b``."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b",
        family="dense",
        num_layers=40,
        d_model=6144,
        num_heads=48,
        num_kv_heads=4,
        d_ff=24576,
        vocab_size=49152,
        qkv_bias=True,
        mlp_swiglu=False,
        rope_theta=100_000.0,
        head_pad_to=16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        qkv_bias=True,
        mlp_swiglu=False,
    )
