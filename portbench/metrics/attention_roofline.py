"""Kernels: the bf16 flash-attention kernels' share of their roofline, %.

The least time of the work the profiled record's windows need (every layer
a forward and a backward over the valid query-key pairs of both copies of
the window, at 989 TFLOP/s or 3.35 TB/s, the larger), over the device time
of the kernels ``tc_attention_*`` (forward, delta, backward)."""

from portbench.yardstick import attention_work, bound_s

KERNELS = "(anonymous namespace)::tc_attention_"


def read(run):
    if run.trace is None:
        return None
    ms = run.trace.ms_where(lambda n: KERNELS in n)
    if not ms:
        return None
    m = run.model
    f, W = m["subsampling_factor"], run.profiled.windows[0]
    T = -(-W // f)
    least = 0.0
    for n in run.profiled.windows:
        valid = -(-n // f)
        work = attention_work(2, T, m["n_heads"], m["head_dim"], [valid, valid])
        least += m["n_layers"] * sum(bound_s(*work[k]) for k in ("fwd", "bwd"))
    return 100.0 * least * 1e3 / ms
