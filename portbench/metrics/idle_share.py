"""Device: the share of a record's wall in which no operation ran on the
device, %: 1 minus the union of the device operations' intervals in the
profiled record, over that same record's wall when it runs again untraced
after the window (same record, same masks).  The traced run's
own wall is not the divisor: tracing slows this launch-bound host 1.8-2.9
fold, and that time would read as idle."""


def read(run):
    if run.trace is None or not run.trace.ops or not run.profiled.untraced_wall_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_ns() / 1e9 / run.profiled.untraced_wall_s)
