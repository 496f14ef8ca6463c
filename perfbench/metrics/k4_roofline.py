"""k4_roofline: kernel K4's share of its roofline, in percent: the least time
its bytes take at the HBM's 3.35 TB/s (``harness.yardstick.k4_bytes``) over
its mean device time in the profiled stretch."""

from harness import yardstick


def read(run):
    p = run.profile
    times = [e - s for name, s, e in p.kernels() if yardstick.is_k4(name)] if p else []
    if not times:
        return None
    mean_s = sum(times) / len(times) / 1e9
    return 100.0 * run.k4_bytes / yardstick.HBM_BW / mean_s
