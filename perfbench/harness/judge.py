"""The comparison that decides ``correct``: the program's readings of the
steps the reference followed, against the reference's, each number against
its limit from the cell's limits file.

* ``loss`` — the widest relative gap of a group's loss, over the steps;
* ``grad_norm`` — the widest relative gap of Ĥ's global norm before
  clipping, over the steps;
* ``first_grad``, ``change``, ``h`` — by the worst leaf, the gap between
  the program's norm and the reference's, over the reference's norm of the
  leaf or of the median leaf, whichever is larger: of the first gradient
  adamw takes, of the parameters' change after the last step and of H
  after it.  A leaf whose first gradient in the reference is under a
  thousandth of the median leaf's moves by round-off alone and is left
  out;
* ``decisions`` — Tier-2 bits (mask, flush, evict) of every step run that
  differ from the reference rule's on the same latencies;
* ``nonfinite`` — steps of the window whose loss is not finite.
"""

from __future__ import annotations

import math

import numpy as np

#: a leaf whose reference gradient is under this share of the median leaf's
#: is left out of the leaf gaps
NOUGHT = 1e-3


def leaf_gap(prog: dict[str, float], ref: dict[str, float], kept) -> float:
    med = float(np.median([ref[k] for k in kept]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in kept)


def numbers(prog: dict, ref: dict) -> dict[str, float]:
    grads = ref["first_grad"]
    med = float(np.median(list(grads.values())))
    kept = sorted(k for k, g in grads.items() if g >= NOUGHT * med)
    loss = max(abs(p - r) / abs(r) for ps, rs in zip(prog["losses"], ref["losses"])
               for p, r in zip(ps, rs))
    gnorm = max(abs(p - r) / r for p, r in zip(prog["grad_norm"], ref["grad_norm"]))
    return {
        "loss": loss,
        "grad_norm": gnorm,
        "first_grad": leaf_gap(prog["first_grad"], grads, kept),
        "change": leaf_gap(prog["change"], ref["change"], kept),
        "change1": leaf_gap(prog["change1"], ref["change1"], kept),
        "h": leaf_gap(prog["h"], ref["h"], kept),
        "decisions": float(np.sum(prog["decisions"] != ref["decisions"])),
        "nonfinite": float(prog["nonfinite"]),
    }


def verdict(values: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: every number the limits
    name finite and at most its limit."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in values if k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
