"""kernels_per_step: device kernels (no copies or fills) in the profiled
stretch over its steps."""


def read(run):
    p = run.profile
    if p is None or not p.steps:
        return None
    n = len(p.kernels())
    return n / p.steps if n else None
