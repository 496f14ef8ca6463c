"""tier2_host_ms: the mean host time of the Tier-2 decision
(``Trainer._step_inputs``: the deadline controller and failure detector),
over the window's steps outside the profiled stretches."""

import statistics


def read(run):
    d = run.spans.durations("tier2")
    return statistics.fmean(d) * 1e3 if d else None
