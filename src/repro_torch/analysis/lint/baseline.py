"""The lint baseline: per-rule suppressions, the port's own file.

The default is ``baseline.toml`` beside this module (never the reference's
``tracelint.toml``), read with :mod:`tomllib`:

.. code-block:: toml

    [tracelint]
    version = 1

    [[suppress]]
    code = "TL004"
    entry = "fused_logreg_grid"
    contains = "free_at"          # optional: substring of symbol/message
    reason = "why this finding is accepted"

A suppression must carry a non-empty ``reason``: the baseline documents
accepted debt, it is not a mute button.
"""

from __future__ import annotations

import dataclasses
import tomllib
from pathlib import Path

DEFAULT_BASELINE = Path(__file__).with_name("baseline.toml")


@dataclasses.dataclass(frozen=True)
class Suppression:
    code: str
    entry: str = "*"  # "*" matches every entry
    contains: str = ""  # substring of the finding's symbol or message
    reason: str = ""

    def matches(self, finding) -> bool:
        if self.code != finding.code:
            return False
        if self.entry not in ("*", finding.entry):
            return False
        return not self.contains or (
            self.contains in finding.symbol or self.contains in finding.message)


def parse_baseline(text: str) -> list:
    supps = []
    for i, raw in enumerate(tomllib.loads(text).get("suppress", [])):
        if not raw.get("code"):
            raise ValueError(f"suppress[{i}]: missing 'code'")
        if not str(raw.get("reason", "")).strip():
            raise ValueError(
                f"suppress[{i}] ({raw.get('code')}): a suppression must carry a "
                f"non-empty 'reason'"
            )
        supps.append(Suppression(
            code=str(raw["code"]),
            entry=str(raw.get("entry", "*")),
            contains=str(raw.get("contains", "")),
            reason=str(raw["reason"]),
        ))
    return supps


def load_baseline(path=DEFAULT_BASELINE) -> list:
    """Suppressions from a baseline file (an empty list if it is absent)."""
    p = Path(path)
    if not p.exists():
        return []
    return parse_baseline(p.read_text())
