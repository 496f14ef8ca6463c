"""Configuration dataclasses, copied from ``repro.configs.base``.

The same frozen dataclasses with the same fields, defaults and properties,
so a configuration reads the same in both packages.  :class:`ModelConfig`
describes the model zoo, every family of which the port serves
(``repro_torch.launch.serve``: dense, MoE, MLA, SSM, hybrid, VLM and
enc-dec) and trains through the model-zoo branch of
``repro_torch.launch.train``.  :class:`TrainConfig` configures the live trainer, for the paper
problems (``launch/paper_jobs.py``) and the model zoo; fields that
configure the model zoo's sharding are kept for parity and must stay at
their defaults here (a mesh is refused by ``core/dsag_pjit.py``).
:class:`MeshConfig` is the reference's mesh description, kept for parity:
nothing in the port builds a mesh from it yet.  :class:`ShapeConfig` names
one input shape (what :func:`repro_torch.analysis.roofline.model_flops`
counts), and :data:`SHAPES` the reference's cells.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | enc_dec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    head_pad_to: int = 1  # pad query heads up to a multiple of this (TP)
    kv_pad_to: int = 1  # pad kv heads (MHA models shard kv over 'model')
    qkv_bias: bool = False
    mlp_swiglu: bool = True  # False -> 2-matrix GELU MLP (whisper/starcoder2)
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_noise: float = 0.0
    moe_dispatch_chunks: int = 1

    # --- MLA (deepseek-v2) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- SSM (mamba2 SSD) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128

    # --- hybrid (zamba2): one shared attention block every `attn_every` ---
    attn_every: int = 0

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0  # stub frontend emits this many frame embeddings

    # --- VLM (pixtral): stub frontend emits this many patch embeddings ---
    num_image_tokens: int = 0

    # Max positions for learned-absolute embeddings (0 -> RoPE, no table)
    max_position_embeddings: int = 0

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing -> long_500k cell runs."""
        return self.family in ("ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_training(self) -> bool:
        return self.kind == "train"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Distributed-training configuration (Tier 1)."""

    optimizer: str = "adamw"  # adamw | adafactor | sgd
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0

    # DSAG
    dsag: bool = True
    dsag_groups: str = "dp"  # dp | pod | zero | none  (partition granularity)
    dsag_num_groups: int = 4  # group count for the "zero" layout
    dsag_cache_dtype: str = "bfloat16"  # bfloat16 | int8 | float32
    dsag_cache_layout: str = "group"  # group (P over dp axes) | zero (dims over all)
    dsag_cache_placement: str = "device"  # device | host (host is TPU-only)
    dsag_margin: float = 0.02

    # sharding
    fsdp: bool = False  # shard params/optimizer state over the data axis
    seq_shard_activations: bool = False  # sequence-sharded residual stream
    quantized_fsdp_allgather: bool = False  # int8 weight all-gather
    remat: str = "full"  # full | selective | none
    fused_loss: bool = False  # chunked-vocab CE fused with unembedding
    bf16_reduce: bool = False  # bf16 tensor-parallel all-reduces
    microbatches: int = 1  # grad-accumulation steps inside the jit step

    # fault tolerance
    checkpoint_every: int = 200
    keep_checkpoints: int = 3


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    shape: tuple[int, ...] = (16, 16)
    axes: tuple[str, ...] = ("data", "model")

    @property
    def multi_pod(self) -> bool:
        return "pod" in self.axes

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def dp_axes(self) -> tuple[str, ...]:
        return tuple(a for a in self.axes if a in ("pod", "data"))
