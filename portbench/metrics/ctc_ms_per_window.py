"""Ops: device ms of the CTC loss kernels (``ctc_loss*``, forward and
backward), per adapted window of the profiled record."""


def read(run):
    if run.trace is None:
        return None
    ms = run.trace.ms_where(lambda n: "ctc_loss" in n)
    return ms / len(run.profiled.windows) if ms else None
