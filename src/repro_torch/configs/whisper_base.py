"""whisper-base [audio]: 6L enc + 6L dec, d_model=512, 8H, d_ff=2048,
vocab=51865 — encoder-decoder; conv/mel frontend is a stub (input_specs
provides 1500 precomputed frame embeddings).  [arXiv:2212.04356]

Copied from ``repro.configs.whisper_base``."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base",
        family="enc_dec",
        num_layers=6,
        encoder_layers=6,
        d_model=512,
        num_heads=8,
        num_kv_heads=8,
        d_ff=2048,
        vocab_size=51865,
        qkv_bias=True,
        mlp_swiglu=False,
        encoder_seq=1500,
        max_position_embeddings=32_768,  # assigned shapes exceed 448
        head_pad_to=16,
        kv_pad_to=16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base-smoke",
        family="enc_dec",
        num_layers=2,
        encoder_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        qkv_bias=True,
        mlp_swiglu=False,
        encoder_seq=12,
        max_position_embeddings=128,
    )
