"""Run the rules over the registered entries and render findings."""

from __future__ import annotations

import dataclasses
import json

from repro_torch.analysis.lint.baseline import DEFAULT_BASELINE, load_baseline
from repro_torch.analysis.lint.entries import build_entries
from repro_torch.analysis.lint.rules import ALL_RULES
from repro_torch.analysis.lint.trace import run_traced


@dataclasses.dataclass
class LintReport:
    """Partitioned outcome of one lint run.

    ``findings`` are active (build-failing); ``suppressed`` pairs each
    baselined finding with the suppression that matched it; ``notes`` are
    what the card checks report besides (``entry: note``).
    """

    entries_run: list
    findings: list
    suppressed: list  # (Finding, Suppression)
    notes: list = dataclasses.field(default_factory=list)
    device: str = "cpu"

    @property
    def exit_code(self) -> int:
        return 1 if self.findings else 0

    def render_text(self) -> str:
        lines = [f.render() for f in self.findings]
        lines += [f"suppressed {f.code} {f.entry} :: {f.symbol} ({s.reason})"
                  for f, s in self.suppressed]
        lines += [f"note {n}" for n in self.notes]
        lines.append(f"tracelint ({self.device}): {len(self.entries_run)} entries, "
                     f"{len(self.findings)} finding(s), {len(self.suppressed)} suppressed")
        return "\n".join(lines)

    def render_json(self) -> str:
        return json.dumps({
            "device": self.device,
            "entries": self.entries_run,
            "findings": [f.as_dict() for f in self.findings],
            "suppressed": [{**f.as_dict(), "reason": s.reason} for f, s in self.suppressed],
            "notes": self.notes,
        }, indent=2, sort_keys=True)


def run_lint(entries="all", baseline_path=DEFAULT_BASELINE, device="cuda",
             rules=ALL_RULES) -> LintReport:
    """Build the probes on ``device``, run each once under the trace, apply
    every rule, partition by the baseline (``None``: no baseline)."""
    suppressions = load_baseline(baseline_path) if baseline_path else []
    probes = build_entries(entries, device)
    active, suppressed, notes = [], [], []
    for probe in probes:
        probe.trace = run_traced(probe.run, probe.loop, probe.region)
        for _, rule in rules:
            for finding in rule(probe):
                match = next((s for s in suppressions if s.matches(finding)), None)
                if match is None:
                    active.append(finding)
                else:
                    suppressed.append((finding, match))
        notes += [f"{probe.name}: {n}" for n in probe.notes]
    return LintReport(entries_run=[p.name for p in probes], findings=active,
                      suppressed=suppressed, notes=notes, device=str(device))
