"""Tier-1 training configuration, copied from ``repro.configs.base``.

The same frozen dataclass with the same fields and defaults, so a
configuration reads the same in both packages.  The live trainer of this
package runs the paper problems only (``launch/paper_jobs.py``); fields that
configure the model zoo's sharding are kept for parity and must stay at
their defaults here (a mesh is refused by :mod:`repro_torch.launch.train`).
"""

from __future__ import annotations

import dataclasses


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
