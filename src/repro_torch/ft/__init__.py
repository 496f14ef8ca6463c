"""Tier-2 runtime control (deadlines, failures, elastic remap) and its
cross-layer pin, copied from ``repro.ft``."""

from repro_torch.ft.runtime import (
    DeadlineController,
    FailureDetector,
    StepInputs,
    elastic_remap_groups,
)

__all__ = ["DeadlineController", "FailureDetector", "StepInputs", "elastic_remap_groups"]
