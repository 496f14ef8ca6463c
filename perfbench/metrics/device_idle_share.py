"""device_idle_share: the share of the profiled stretch in which no
operation ran on the device (one minus the union of their intervals over
the stretch), in percent.  The stretch is traced with the device's activity
alone, so the host runs it about as fast as an untraced step."""


def read(run):
    p = run.profile
    if p is None or not p.busy_ns:
        return None
    return 100.0 * (1.0 - p.busy_ns / p.stretch_ns)
