"""Time-to-gap verdicts across methods (``repro.experiments.results``)."""

from __future__ import annotations

import numpy as np


def convergence_ordering(outcome, gap: float) -> dict[str, float]:
    """Time-to-gap verdict across methods (the paper's headline numbers).

    Returns each method's median (across scenarios) time to reach
    ``suboptimality <= gap``, the ratios over DSAG, and the verdicts:
    DSAG reaching the gap before SAG and before the coded bound.
    """
    out: dict[str, float] = {"gap": gap}
    medians: dict[str, float] = {}
    for name, res in outcome.results.items():
        ttg = res.time_to_gap(gap)
        # the median of [finite..., inf] stays finite while fewer than half
        # the scenarios miss the gap; the miss rate is reported separately
        medians[name] = float(np.median(ttg))
        out[f"median_time_to_gap_{name}"] = medians[name]
        out[f"reached_gap_frac_{name}"] = float(np.isfinite(ttg).mean())
    if "dsag" in medians:
        t_dsag = medians["dsag"]
        for name, t in medians.items():
            if name != "dsag":
                out[f"{name}_over_dsag"] = (
                    t / t_dsag if np.isfinite(t_dsag) else float("nan")
                )
        # the verdict is only meaningful when both baselines actually ran
        if "sag" in medians and "coded" in medians:
            sag_t, coded_t = medians["sag"], medians["coded"]
            out["dsag_fastest_to_gap"] = float(
                np.isfinite(t_dsag) and t_dsag < sag_t and t_dsag < coded_t
            )
            out["ordering_dsag_sag_coded"] = float(
                np.isfinite(t_dsag) and t_dsag < sag_t <= coded_t
            )
    return out
