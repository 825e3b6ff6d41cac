"""Engine: the 95th percentile (nearest rank) of the adapt step, in ms.  A
sample is the interval between successive calls into the model within one
record, read from CUDA events that a forward pre-hook records on the
compute stream; intervals across a record boundary and the profiled
record's are left out."""

from portbench.yardstick import p95


def read(run):
    steps = [ms for r in run.records if not r.profiled for ms in r.step_ms]
    return p95(steps) if steps else None
