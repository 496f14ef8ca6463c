"""grok-1-314b [moe]: 64L, d_model=6144, 48H (GQA kv=8), vocab=131072,
MoE 8 experts top-2, expert d_ff=32768.  [hf:xai-org/grok-1]

Copied field for field from ``repro.configs.grok1_314b``, the smoke config included."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b",
        family="moe",
        num_layers=64,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=32768,
        vocab_size=131072,
        head_pad_to=16,
        num_experts=8,  # 8 % 16 != 0 -> per-expert ffn dim TP-sharded
        top_k=2,
        d_ff_expert=32768,
        moe_dispatch_chunks=16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        num_experts=4,
        top_k=2,
        capacity_factor=8.0,  # no token drops in smoke tests
        d_ff_expert=128,
    )
