"""The H100's roofline: model FLOPs, three terms and an mfu.

The card and its peaks are :mod:`repro_torch.analysis.kernel_costs`'s
(NVIDIA H100 80GB HBM3, 700 W; the SXM data sheet's rates), re-exported
here with the kernels' cost models and :func:`bound_ms`:

  compute term    = Σ FLOPs of each dtype / that dtype's peak
  memory term     = bytes / HBM rate
  collective term = ring-model wire bytes / LINK_BW   (per rank: the
                    collectives one rank of a mesh run dispatches, over
                    50 GB/s each way, one NDR InfiniBand port per card;
                    0 on one card, where nothing crosses a link)

The counted work comes from :func:`repro_torch.analysis.cost.count_cost`,
one rank's on a mesh; ``num_devices`` divides the model's FLOPs into each
rank's share, as the reference's ``derive`` does.  ``mfu`` divides that
share at the peak of the dtype that does most of the counted work by the
step time: the largest term, or a measured step time where the caller
passes one.
"""

from __future__ import annotations

import dataclasses

from repro_torch.analysis.kernel_costs import (  # noqa: F401  (re-exported)
    HBM_BW,
    LINK_BW,
    PEAK_BF16,
    PEAK_F32,
    PEAK_F64,
    PEAKS,
    bound_ms,
    causal_pairs,
    dsag_cache_update_cost,
    dsag_cache_update_int8_cost,
    dsag_int8_row_max_cost,
    flash_attention_cost,
    gram_matvec_cost,
    grid_cache_update_cost,
    logreg_block_sub_cost,
    pca_block_sub_cost,
    peak_for,
    unique_rows,
    what_if_replay_cost,
)
from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collectives: dict
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_per_device: float
    useful_flops_fraction: float
    step_time_s: float
    mfu: float
    attn_score_bytes: float = 0.0
    memory_s_flash: float = 0.0  # memory term with score traffic fused away

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def model_flops(
    cfg: ModelConfig, shape: ShapeConfig, num_params: int, active_params: int | None
) -> float:
    """MODEL_FLOPS = 6·N·D for training (N = active params for MoE),
    2·N·D for inference forward passes (D = processed tokens)."""
    n = active_params or num_params
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def active_params(cfg: ModelConfig, num_params: int) -> int | None:
    """Active parameters per token for MoE models (shared + top-k routed)."""
    if not cfg.num_experts:
        return None
    full_expert = 3 * cfg.d_model * cfg.d_ff_expert  # swiglu
    routed_total = cfg.num_experts * full_expert * cfg.num_layers
    routed_active = cfg.top_k * full_expert * cfg.num_layers
    return num_params - routed_total + routed_active


def derive(
    cfg: ModelConfig,
    shape: ShapeConfig,
    num_params: int,
    cost,
    *,
    num_devices: int = 1,
    step_time_s: float | None = None,
) -> Roofline:
    """The three terms of a counted run (``cost``: a
    :class:`~repro_torch.analysis.cost.Cost`, one rank's on a mesh of
    ``num_devices`` ranks) and the rank's share of the model FLOPs.

    ``step_time_s`` is a measured step time; without one the step is the
    largest term (the roofline's own), as the reference's ``derive``.
    """
    compute_s = sum(f / peak for peak, f in cost.flops_at_peak.items())
    memory_s = cost.bytes / HBM_BW
    collective_s = cost.total_wire_bytes / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mf_dev = model_flops(cfg, shape, num_params, active_params(cfg, num_params)) / num_devices
    step = max(terms.values()) if step_time_s is None else float(step_time_s)
    peak = max(cost.flops_at_peak, key=cost.flops_at_peak.get) if cost.flops_at_peak else PEAK_BF16
    return Roofline(
        attn_score_bytes=cost.attn_score_bytes,
        memory_s_flash=max(cost.bytes - cost.attn_score_bytes, 0.0) / HBM_BW,
        flops_per_device=cost.flops,
        bytes_per_device=cost.bytes,
        # a run with no collectives (one card) keeps the empty dict
        collectives=cost.collectives_dict() if cost.coll_counts else {},
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops_per_device=mf_dev,
        useful_flops_fraction=mf_dev / cost.flops if cost.flops else 0.0,
        step_time_s=step,
        mfu=(mf_dev / peak) / step if step > 0 else 0.0,
    )


def serving_gemm_flops(cfg: ModelConfig, params: dict, tokens: int, logits_rows: int) -> int:
    """The product FLOPs of a dense model's forward over ``tokens`` tokens:
    2 × the parameters of each layer's matrices (q, k, v, o, gate, up, down)
    × the tokens, plus 2 × the unembedding's parameters × the rows it is
    applied to (a prefill's last position of each sequence, every token of a
    decode step).  Attention's own products are K6's (its cost model) or the
    plain path's.  ``serving_gemm_flops(...) / (2 · tokens)`` is the
    parameter count a step multiplies each token by: the ``num_params`` that
    makes :func:`derive`'s mfu the share of products the card runs."""
    blocks = params["blocks"]
    layer = sum(blocks["attn"][w].numel() for w in ("wq", "wk", "wv", "wo")) + sum(
        blocks["mlp"][w].numel() for w in ("w_gate", "w_up", "w_down"))
    unembed = params["embed"]["tok" if cfg.tie_embeddings else "unembed"].numel()
    return 2 * layer * tokens + 2 * unembed * logits_rows
