"""CLI: ``python -m repro_torch.analysis.lint --entry all [--device cuda|cpu] [--json]``.

Exits 1 on any finding that the baseline does not suppress.  The entries
run on the card unless ``--device cpu`` is given (there the kernels are
their plain versions and the card-only entries and checks are skipped).
The baseline defaults to the port's ``baseline.toml`` beside this module;
``--no-baseline`` audits everything.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.analysis.lint.baseline import DEFAULT_BASELINE
from repro_torch.analysis.lint.entries import ENTRIES
from repro_torch.analysis.lint.runner import run_lint


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="tracelint for the PyTorch port: rules TL001, TL003, TL004",
    )
    parser.add_argument("--entry", action="append", default=None,
                        help=f"entry to lint (repeatable; 'all' = every one of {sorted(ENTRIES)})")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    parser.add_argument("--json", action="store_true", help="print the report as JSON")
    parser.add_argument("--baseline", default=str(DEFAULT_BASELINE),
                        help="suppression file (default: the port's baseline.toml)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="ignore the baseline and report every finding")
    args = parser.parse_args(argv)
    entries = args.entry or ["all"]
    if "all" in entries:
        entries = "all"
    report = run_lint(entries=entries, device=args.device,
                      baseline_path=None if args.no_baseline else args.baseline)
    print(report.render_json() if args.json else report.render_text())
    return report.exit_code


if __name__ == "__main__":
    sys.exit(main())
