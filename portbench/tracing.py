"""The device trace of one record, read from ``torch.profiler``'s events.

The profiler records the device alone (``ProfilerActivity.CUDA``: kernels,
copies and memsets, and the CUDA runtime calls that launched them), which
costs the host little; recording every host operation as well slowed a
record 3.8-fold and made the device look idle for the profiler's own time.
What the host was doing comes instead from the benchmark's spans around the
calls into the model and the optimizer (``Hooks``), on the same clock
(epoch nanoseconds).

:class:`Trace` keeps, in nanoseconds: every device operation (name, start,
end, correlation id), the runtime calls by correlation id (name, start,
end), and the spans (name, start, end).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from portbench.yardstick import union_length

TOP = 10  # entries of each list of the breakdown
GAP_NAMES = {("forward", "optimizer"): "labels, CTC loss, backward",
             ("optimizer", "forward"): "stitch, next window",
             (None, "forward"): "driver: load, hand-off",
             ("forward", None): "driver: decode, word errors",
             ("optimizer", None): "driver: decode, word errors"}


class Trace:
    def __init__(self, ops: List[Tuple[str, int, int, int]],
                 runtime: Dict[int, Tuple[str, int, int]], spans: List[Tuple[str, int, int]]):
        self.ops = sorted(ops, key=lambda o: o[1])
        self.runtime = runtime
        self.spans = sorted(spans, key=lambda s: s[1])

    @classmethod
    def from_profiler(cls, prof, spans) -> "Trace":
        ops, runtime = [], {}
        for e in prof.profiler.kineto_results.events():
            start, dur = e.start_ns(), e.duration_ns()
            if "CUDA" in str(e.device_type()):
                if not e.is_user_annotation():
                    ops.append((e.name(), start, start + dur, e.correlation_id()))
            elif e.name().startswith("cuda"):
                runtime[e.correlation_id()] = (e.name(), start, start + dur)
        return cls(ops, runtime, spans)

    def busy_ns(self) -> float:
        """Time in which some operation ran on the device."""
        return union_length((s, e) for _, s, e, _ in self.ops)

    def ms_where(self, keep) -> float:
        """Device milliseconds of the operations whose name ``keep`` accepts."""
        return sum(e - s for n, s, e, _ in self.ops if keep(n)) / 1e6

    def ms_launched_in(self, span_name: str) -> Optional[float]:
        """Device milliseconds of the operations whose runtime call the host
        made inside a span of that name; None where there is no such span or
        no runtime call was recorded."""
        spans = [(s, e) for n, s, e in self.spans if n == span_name]
        if not spans or not self.runtime:
            return None
        starts = [s for s, _ in spans]
        total = 0
        for _, s, e, corr in self.ops:
            call = self.runtime.get(corr)
            if call is None:
                continue
            i = bisect.bisect_right(starts, call[1]) - 1
            if i >= 0 and call[1] <= spans[i][1]:
                total += e - s
        return total / 1e6

    def top_ops(self, n: int = TOP) -> List[List]:
        by: Dict[str, float] = defaultdict(float)
        for name, s, e, _ in self.ops:
            by[name[:120]] += (e - s) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def phase(self, t: int) -> str:
        """What the host was doing at t, by the benchmark's spans: inside a
        span its name, else the pair of spans around it."""
        starts = [s for _, s, _ in self.spans]
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= self.spans[i][2]:
            return self.spans[i][0]
        before = self.spans[i][0] if i >= 0 else None
        after = self.spans[i + 1][0] if i + 1 < len(self.spans) else None
        return GAP_NAMES.get((before, after), f"after {before}, before {after}")

    def idle_gaps(self, n: int = TOP) -> List[List]:
        """Device idle time, summed by what the host was doing at the middle
        of each gap: its phase, and the runtime call in progress, if any."""
        gaps, end = [], None
        for _, s, e, _ in self.ops:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        calls = sorted(self.runtime.values(), key=lambda c: c[1])
        starts = [c[1] for c in calls]
        by: Dict[str, float] = defaultdict(float)
        for g0, g1 in gaps:
            mid = (g0 + g1) // 2
            name = self.phase(mid)
            i = bisect.bisect_right(starts, mid) - 1
            if i >= 0 and calls[i][2] >= mid:
                name += f" ({calls[i][0]})"
            by[name] += (g1 - g0) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
