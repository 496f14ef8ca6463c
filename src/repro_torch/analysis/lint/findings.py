"""Finding record + the rule catalogue (stable codes).

The codes and names are the reference's (``repro.analysis.lint.findings``);
each invariant is re-stated for eager torch.  TL002 (carry-copy) and TL005
(cond-capture) name XLA behaviours (copy-on-read of loop carries,
``lax.cond`` copying its captures) that eager torch does not have; the port
checks their eager counterparts in the tiled §6 cache's per-rank walk: no
copy of a large table, and no host synchronization, once per rank.
"""

from __future__ import annotations

import dataclasses

#: rule code -> (short name, one-line invariant).  Codes are stable API:
#: baselines and the regression tests key on them.
RULES = {
    "TL001": (
        "fma-seam",
        "the §3 latency chain and the event algebra round once per operator: the "
        "port's chain equals a numpy float64 op-by-op evaluation bit for bit, no "
        "fused multiply-add op touches a float64 event tensor, and on the card the "
        "event streams (K3's sums, K7's replay) equal the CPU run's",
    ),
    "TL002": (
        "carry-copy",
        "the per-rank loop copies none of its large tables (the §5 value table, the "
        "tiled cache's entry tables): live values come from the frozen loop-entry "
        "table and the ranked event rows",
    ),
    "TL003": (
        "pad-variant-reduce",
        "a sum, mean or product over a padded axis must have an operand with mask "
        "evidence; on the card a kernel's result must not depend on its pad width",
    ),
    "TL004": (
        "dtype-leak",
        "no event-algebra op turns float64 or int64 into float32 or narrower, loop "
        "carries keep their dtype across iterations, and kernel outputs match the "
        "declared value_dtype",
    ),
    "TL005": (
        "cond-capture",
        "the per-rank loop never makes the host wait for the device (no .item(), "
        "data-sized op or device-to-host copy per rank): trip counts are read "
        "once, before the loop",
    ),
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one location of one entry's run.

    ``symbol`` is a stable within-entry locator (an op name with its
    operands, a carry, an output index, a check); baseline suppressions can
    narrow on it by substring.
    """

    code: str
    entry: str
    symbol: str
    message: str

    @property
    def rule_name(self) -> str:
        return RULES[self.code][0]

    def as_dict(self) -> dict:
        return {
            "code": self.code,
            "rule": self.rule_name,
            "entry": self.entry,
            "symbol": self.symbol,
            "message": self.message,
        }

    def render(self) -> str:
        return f"{self.code} [{self.rule_name}] {self.entry} :: {self.symbol}\n    {self.message}"
