"""Device: the window's peak of allocated device memory, GB:
``torch.cuda.max_memory_allocated()`` after ``reset_peak_memory_stats()``
at the window's start."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
