"""qwen1.5-32b [dense]: 64L, d_model=5120, 40H (kv=40, MHA), d_ff=27392,
vocab=152064 — QKV bias.  Heads (q and kv) padded 40->48 for TP=16.
[hf:Qwen/Qwen1.5-32B]

Copied from ``repro.configs.qwen1_5_32b``."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b",
        family="dense",
        num_layers=64,
        d_model=5120,
        num_heads=40,
        num_kv_heads=40,
        d_ff=27392,
        vocab_size=152064,
        head_dim=128,
        qkv_bias=True,
        head_pad_to=16,
        kv_pad_to=16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        head_dim=16,
        qkv_bias=True,
    )
