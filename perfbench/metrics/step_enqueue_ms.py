"""step_enqueue_ms: the mean host time from the call of the DSAG step
(``Trainer.step_fn``) to its return, which is the time to enqueue the step's
work, over the window's steps outside the profiled stretches."""

import statistics


def read(run):
    d = run.spans.durations("step")
    return statistics.fmean(d) * 1e3 if d else None
