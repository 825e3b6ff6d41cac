"""Spans of the port's host work: named, nested intervals kept in memory.

``span(name, **attrs)`` is a context manager around one piece of work;
``start()`` turns recording on, ``stop()`` turns it off and returns the
spans recorded since, in the order they opened.  Each :class:`Span` holds
its id, its parent's id, its root's id (the outermost span open when it
opened: for the engine, the record's ``engine.record``, which every span of
one recording shares), its name, its start and end, and its attributes.

The clock is ``time.time_ns()``: epoch nanoseconds, the clock on which
``torch.profiler`` stamps its events (``start_ns()`` of kineto's events), so
a span lines up with a profiler trace of the same work as it stands.
``time.perf_counter`` and ``time.monotonic`` are another clock.

Off, which is the default, ``span`` returns one shared object that does
nothing: no span is made and no clock is read.  An open span's attributes
can change (``add``, ``set``): a count is an attribute of the span at whose
boundary it is made, as ``engine.record``'s ``windows``.  A span never
synchronises the device nor reads a device tensor, and the recorder prints
and writes nothing.  Spans nest by the order they open in, so one thread at
a time records (the engine runs on one).
"""

from __future__ import annotations

import itertools
import time
from typing import Dict, List, Optional


class Span:
    """One recorded interval; ``end_ns`` is None while it is open."""

    __slots__ = ("id", "parent", "root", "name", "start_ns", "end_ns", "attrs", "_open")

    def __init__(self, id: int, name: str, attrs: Dict, open_spans: List["Span"]):
        self.id, self.name, self.attrs, self._open = id, name, attrs, open_spans
        self.parent = open_spans[-1].id if open_spans else None
        self.root = open_spans[0].id if open_spans else id
        self.start_ns: Optional[int] = None
        self.end_ns: Optional[int] = None

    def __enter__(self) -> "Span":
        self._open.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        if self._open and self._open[-1] is self:
            self._open.pop()
        return False

    def add(self, key: str, n: int = 1) -> None:
        self.attrs[key] = self.attrs.get(key, 0) + n

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def as_dict(self) -> Dict:
        return {"id": self.id, "parent": self.parent, "root": self.root, "name": self.name,
                "start_ns": self.start_ns, "end_ns": self.end_ns, "attrs": dict(self.attrs)}


class _Off:
    """What ``span`` returns while the recorder is off."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def add(self, key: str, n: int = 1) -> None:
        pass

    def set(self, **attrs) -> None:
        pass


OFF = _Off()


class Recorder:
    def __init__(self):
        self._spans: Optional[List[Span]] = None
        self._open: List[Span] = []
        self._ids = itertools.count(1)

    def span(self, name: str, **attrs):
        """A span to open with ``with``, recorded when the recorder is on;
        else :data:`OFF`."""
        if self._spans is None:
            return OFF
        s = Span(next(self._ids), name, attrs, self._open)
        self._spans.append(s)
        return s

    def start(self) -> None:
        self._spans, self._open = [], []

    def stop(self) -> List[Span]:
        out, self._spans, self._open = self._spans or [], None, []
        return out


RECORDER = Recorder()
span = RECORDER.span
start = RECORDER.start
stop = RECORDER.stop
