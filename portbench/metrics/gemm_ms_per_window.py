"""Model: device ms of the GEMM kernels (cuBLAS ``nvjet*``, ``*gemm*``
such as ``sm80_xmma_gemm*``, CUTLASS), per adapted window of the profiled
record."""

FAMILIES = ("nvjet", "gemm", "cutlass")


def read(run):
    if run.trace is None:
        return None
    ms = run.trace.ms_where(lambda n: any(f in n for f in FAMILIES))
    return ms / len(run.profiled.windows) if ms else None
