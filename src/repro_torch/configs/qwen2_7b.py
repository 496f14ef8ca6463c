"""qwen2-7b [dense]: 28L, d_model=3584, 28H (GQA kv=4), d_ff=18944,
vocab=152064 — GQA, QKV bias.  Heads padded 28->32 for TP=16.
[arXiv:2407.10671]

Copied from ``repro.configs.qwen2_7b``."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b",
        family="dense",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        d_ff=18944,
        vocab_size=152064,
        qkv_bias=True,
        head_pad_to=16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        qkv_bias=True,
    )
