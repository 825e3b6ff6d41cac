"""What the host did around the measured window, from the process's own
clocks and the kernel's counters (read only).

The cells are launch-bound: one host thread launches every kernel and the
card idles most of the time, so a run's pace is the host's.  These readings
say, for each run, whether a slow one was slow because its launching thread
got less of a core (steal by the hypervisor and other work in the machine,
where its ``/proc/stat`` counters advance; involuntary switches) or because
the core itself ran slower (``probe_ms``: a fixed pure-Python loop, timed
before and after the window).
"""

from __future__ import annotations

import gc
import os
import resource
import time
from contextlib import contextmanager
from typing import Dict, Optional

# /proc/stat's first line: cpu user nice system idle iowait irq softirq steal ...
BUSY = (0, 1, 2, 5, 6)  # user, nice, system, irq, softirq
IDLE = (3, 4)  # idle, iowait
STEAL = 7


def _cpu_ticks() -> Optional[list]:
    try:
        with open("/proc/stat") as f:
            return [int(x) for x in f.readline().split()[1:9]]
    except (OSError, ValueError):
        return None


def probe_ms(loops: int = 3, n: int = 300_000) -> float:
    """The fastest of ``loops`` timings of a fixed integer loop, ms."""
    best = float("inf")
    for _ in range(loops):
        t = time.perf_counter()
        x = 0
        for i in range(n):
            x += i * i
        best = min(best, time.perf_counter() - t)
    return best * 1e3


def sample() -> Dict:
    usage = resource.getrusage(getattr(resource, "RUSAGE_THREAD", resource.RUSAGE_SELF))
    times = os.times()
    return {"t": time.perf_counter(), "thread_cpu": time.thread_time(),
            "process_cpu": times.user + times.system, "ticks": _cpu_ticks(),
            "nivcsw": usage.ru_nivcsw, "nvcsw": usage.ru_nvcsw}


def between(a: Dict, b: Dict) -> Dict[str, float]:
    """Readings over the interval from sample ``a`` to sample ``b``."""
    wall = b["t"] - a["t"]
    out = {"wall_s": wall,
           "launcher_cpu_share": (b["thread_cpu"] - a["thread_cpu"]) / wall,
           "process_cores": (b["process_cpu"] - a["process_cpu"]) / wall,
           "launcher_involuntary_switches": b["nivcsw"] - a["nivcsw"],
           "launcher_voluntary_switches": b["nvcsw"] - a["nvcsw"]}
    d = [y - x for x, y in zip(a["ticks"] or [], b["ticks"] or [])]
    total = sum(d[i] for i in BUSY + IDLE) + d[STEAL] if d else 0
    if total:  # where the machine's counters advance
        busy_cores = sum(d[i] for i in BUSY) / os.sysconf("SC_CLK_TCK") / wall
        out["steal_share"] = d[STEAL] / total
        out["machine_busy_cores"] = busy_cores
        out["other_busy_cores"] = busy_cores - out["process_cores"]
    return out


@contextmanager
def quiet_collector():
    """For the window: the cyclic garbage collector off, everything made in
    set-up frozen out of its scans; undone on exit.  (The launching thread
    is left unpinned: pinned to one core, a run's pace was that one core's,
    and runs spread wider.)"""
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.unfreeze()
