"""qwen1.5-0.5b [dense]: 24L, d_model=1024, 16H (kv=16), d_ff=2816,
vocab=151936 — QKV bias, tied embeddings.  [hf:Qwen/Qwen1.5-0.5B]

Copied from ``repro.configs.qwen1_5_0_5b``."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b",
        family="dense",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=2816,
        vocab_size=151936,
        qkv_bias=True,
        tie_embeddings=True,
        head_pad_to=16,
        kv_pad_to=16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        qkv_bias=True,
        tie_embeddings=True,
    )
