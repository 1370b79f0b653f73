"""Span tracing on `time.perf_counter`, exportable as Chrome trace
events (DESIGN.md Sec. 12).

`Tracer.span(name)` is the repo's ONE wall-clock primitive: it times on
the monotonic `time.perf_counter` (never `time.time()`, which steps
under NTP adjustments), works as a plain stopwatch even when event
recording is disabled, and — when enabled — appends a complete event to
a bounded ring.  `to_chrome_trace()` emits the Chrome trace-event JSON
format (`ph: "X"` complete events, microsecond timestamps), which loads
directly in Perfetto (ui.perfetto.dev) or chrome://tracing.

Single-threaded by design, like the serving loop it instruments: spans
nest via a plain stack, and nesting shows up in Perfetto through
ts/duration containment on one track.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import deque


class Span:
    """One timed region.  Usable as a bare stopwatch: `duration_s` after
    the `with` block, `elapsed_s` inside it (both perf_counter-based).

    Implements the with-statement protocol directly rather than via a
    `@contextmanager` generator: this sits on the serving hot path, and
    the generator machinery costs more than the timing itself."""

    __slots__ = ("name", "cat", "args", "depth", "t0", "t1", "_tracer")

    def __init__(self, name: str, cat: str, args: dict, tracer=None):
        self.name = name
        self.cat = cat
        self.args = args
        self.depth = 0
        self._tracer = tracer
        self.t0 = time.perf_counter()
        self.t1: float | None = None

    def __enter__(self) -> "Span":
        tr = self._tracer
        if tr is not None:
            self.depth = len(tr._stack)
            tr._stack.append(self.name)
        self.t0 = time.perf_counter()  # re-arm: timing starts at entry
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.t1 = time.perf_counter()
        tr = self._tracer
        if tr is not None:
            tr._stack.pop()
            if tr.enabled:
                tr._events.append((
                    "X", self.name, self.cat, (self.t0 - tr._t0) * 1e6,
                    (self.t1 - self.t0) * 1e6, self.depth, self.args,
                ))
        return False

    @property
    def elapsed_s(self) -> float:
        """Seconds since the span opened (live reads mid-span)."""
        return time.perf_counter() - self.t0

    @property
    def duration_s(self) -> float:
        return (self.t1 if self.t1 is not None
                else time.perf_counter()) - self.t0

    @property
    def duration_us(self) -> float:
        return self.duration_s * 1e6


class Tracer:
    """Bounded ring of spans + instants; see the module docstring."""

    def __init__(self, enabled: bool = True, capacity: int = 65536):
        self.enabled = enabled
        self._events: deque = deque(maxlen=capacity)
        self._stack: list[str] = []
        self._t0 = time.perf_counter()  # trace epoch (ts are relative)

    @property
    def depth(self) -> int:
        """Current span-nesting depth (0 outside any span)."""
        return len(self._stack)

    def now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def span(self, name: str, cat: str = "serve", **args) -> Span:
        """A `with`-able Span; recorded into the ring on exit."""
        return Span(name, cat, args, tracer=self)

    def instant(self, name: str, cat: str = "serve", **args) -> None:
        """A zero-duration marker (anomalies, state events)."""
        if self.enabled:
            self._events.append(
                ("i", name, cat, self.now_us(), 0.0, len(self._stack), args))

    def events(self) -> list:
        return list(self._events)

    def clear(self) -> None:
        self._events.clear()

    def to_chrome_trace(self) -> dict:
        pid = os.getpid()
        out = []
        for ph, name, cat, ts, dur, depth, args in self._events:
            ev = dict(name=name, cat=cat, ph=ph, ts=ts, pid=pid, tid=0,
                      args=dict(args, depth=depth))
            if ph == "X":
                ev["dur"] = dur
            else:
                ev["s"] = "t"  # thread-scoped instant
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)


def span_or_null(tracer: Tracer | None, name: str, **args):
    """`tracer.span(...)` when a tracer is present, else a no-op context —
    the idiom instrumented code uses so the obs-off path stays bare."""
    if tracer is None:
        return contextlib.nullcontext()
    return tracer.span(name, **args)
