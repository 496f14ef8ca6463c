"""tracelint for the PyTorch port: the counterpart of ``repro.analysis.lint``.

The port's cross-engine bit-exactness rests on invariants that ordinary
tests see only when they happen to compare streams.  The lint runs each
registered entry point once under a dispatch mode
(:mod:`~repro_torch.analysis.lint.trace`), on the card or the CPU, and
checks them with the reference's stable codes:

=======  ==================  ==============================================
code     name                invariant
=======  ==================  ==============================================
TL001    fma-seam            the §3 latency chain equals numpy's float64
                             op-by-op evaluation bit for bit, no fused
                             multiply-add op touches a float64 event
                             tensor, and on the card the event streams
                             (K3's sums, K7's replay) equal the CPU run's
TL003    pad-variant-reduce  sums, means and products over padded axes
                             have an operand with mask evidence (a
                             comparison upstream); on the card K1, K2 and
                             K5 give the same result at two pad widths
TL004    dtype-leak          no event-algebra op turns float64 or int64
                             into float32 or narrower; loop carries keep
                             their dtypes; kernel outputs have the declared
                             dtypes
=======  ==================  ==============================================

TL002 (carry-copy) and TL005 (cond-capture) are XLA behaviours with no
port rule yet (:mod:`~repro_torch.analysis.lint.findings`).

Run ``python -m repro_torch.analysis.lint --entry all`` (on the card; add
``--device cpu`` on the CPU).  Accepted findings are suppressed, each with a
reason, in the port's ``baseline.toml`` beside this module.
"""

from repro_torch.analysis.lint.baseline import Suppression, load_baseline
from repro_torch.analysis.lint.entries import ENTRIES, EntryProbe, build_entries
from repro_torch.analysis.lint.findings import RULES, Finding
from repro_torch.analysis.lint.runner import LintReport, run_lint

__all__ = [
    "ENTRIES",
    "RULES",
    "EntryProbe",
    "Finding",
    "LintReport",
    "Suppression",
    "build_entries",
    "load_baseline",
    "run_lint",
]
