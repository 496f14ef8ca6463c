"""pixtral-12b [vlm]: 40L, d_model=5120, 32H (GQA kv=8), d_ff=14336,
vocab=131072 — pixtral-ViT frontend stubbed (input_specs provides 256 patch
embeddings per sample).  [hf:mistralai/Pixtral-12B-2409]

Copied from ``repro.configs.pixtral_12b``."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b",
        family="vlm",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=131072,
        head_dim=128,
        rope_theta=1_000_000_000.0,
        head_pad_to=16,
        num_image_tokens=256,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b-smoke",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        head_dim=16,
        num_image_tokens=8,
    )
