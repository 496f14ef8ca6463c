"""deepseek-v2-236b [moe]: 60L, d_model=5120, 128H, MLA kv_lora=512,
vocab=102400, MoE 2 shared + 160 routed top-6, expert d_ff=1536.
[arXiv:2405.04434]

Copied field for field from ``repro.configs.deepseek_v2_236b``, the smoke config included."""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        num_layers=60,
        d_model=5120,
        num_heads=128,
        num_kv_heads=128,
        d_ff=1536,
        vocab_size=102400,
        head_pad_to=16,
        use_mla=True,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        num_experts=160,
        num_shared_experts=2,
        top_k=6,
        d_ff_expert=1536,
        moe_dispatch_chunks=16,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=64,
        vocab_size=512,
        use_mla=True,
        kv_lora_rank=32,
        qk_nope_dim=16,
        qk_rope_dim=8,
        v_head_dim=16,
        num_experts=8,
        num_shared_experts=2,
        top_k=2,
        capacity_factor=8.0,  # no token drops in smoke tests
        d_ff_expert=64,
    )
