"""Kernels: the bf16 fused subsampling kernels' share of their roofline, %.

The least time of each window's forward and backward (no input gradient)
over the valid frames of both copies of the window, at 989 TFLOP/s or
3.35 TB/s, the larger (``yardstick.subsample_work``), over the device time
of the kernels of ``fused_subsample_bf16.cu``."""

from portbench.yardstick import bound_s, subsample_work

KERNELS = ("tc_pw_kernel", "tc_wgrad_kernel", "dw_bwd_kernel", "weights_kernel", "gx_kernel",
           "reduce_kernel")


def _ours(name):
    return "(anonymous namespace)::" in name and any(k in name for k in KERNELS)


def read(run):
    if run.trace is None:
        return None
    ms = run.trace.ms_where(_ours)
    if not ms:
        return None
    m = run.model
    least = 0.0
    for n in run.profiled.windows:
        work = subsample_work(2, n, m["feat_in"], m["subsampling_conv_channels"])
        least += bound_s(*work["fwd"]) + bound_s(*work["bwd"])
    return 100.0 * least * 1e3 / ms
