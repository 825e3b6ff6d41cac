"""Optimizer: device ms of the kernels launched inside the optimizer's
``step`` (the benchmark's span from a global optimizer step pre-hook to its
post-hook; each kernel tied to its launch by the profiler's correlation
id), per adapted window of the profiled record."""


def read(run):
    if run.trace is None:
        return None
    ms = run.trace.ms_launched_in("optimizer")
    return None if not ms else ms / len(run.profiled.windows)
