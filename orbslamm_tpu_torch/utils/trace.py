"""Tracing: named stages for the profiler, the Tracer's report, and one
span log on the profiler's clock.

* ``stage(name, **attrs)`` marks a stage of the device path: always a
  ``torch.profiler`` range, and while a ``StageTimer`` is active also a
  synchronized wall clock. The timer drains the device at each stage's
  start and end, so a stage's time holds the device work it launched;
  nested stages (``ba.pose_optimize`` inside ``track.local_map``) each
  report their inclusive time. With no timer active a stage costs one
  profiler range and one entry of the span log. A timer made with
  ``prefixes`` times only the stages whose first dotted part is one of
  them (``"loop"`` takes ``loop.verify``), so the rest of the path runs
  without the extra drains.
* ``Tracer`` (port of orbslamm_tpu/utils/trace.py): span timing
  (``with tracer.span("track")``; per-span count, total, median, p90, p99
  and max), a bounded structured event log (the reference's
  state-transition prints), counters and gauges. The process-wide
  ``get_tracer()`` is the one the sessions, the MultiMapper, the bank and
  the bridge write to, under the JAX package's span, event and counter
  names, so a run of either package writes a ``trace_report.json`` with
  the same keys (``driver.run_robots`` saves it). A span is also a
  profiler range of its own name. Neither a span nor a stage
  synchronizes the device: its time is the host's, launches included,
  device work only where the host waited on it.
* The span log: while the process Tracer is enabled, every ``stage`` and
  every ``Tracer.span`` leaves one ``Span`` entry (name, start and end in
  ``time.time_ns()``, the clock ``torch.profiler`` stamps its events with,
  the enclosing entry on the same thread, the thread, attributes), so the
  log joins the device trace without the profiler's host activity. It
  keeps the newest ``max_spans`` entries and counts the ones it let go
  (``dropped``). Both context managers yield their attribute dict: keys
  set inside become the entry's attributes at its end.
  ``save_chrome_trace`` writes the log for Perfetto. ``stage_summary``
  and ``trace_report.json`` hold the Tracer's spans alone.

Where a stage and a span wrap the same region they nest (``merge`` around
``merge.apply``, ``loop_correct`` around ``loop.correct``).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator, NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

_timer: StageTimer | None = None


class StageTimer:
    """Per-stage call counts and synchronized wall seconds while active
    (``with StageTimer(device) as t: ...``; then ``t.seconds``, ``t.calls``)."""

    def __init__(self, device, prefixes: tuple[str, ...] | None = None):
        self.device = torch.device(device)
        self.prefixes = prefixes
        self.seconds: dict[str, float] = defaultdict(float)
        self.calls: dict[str, int] = defaultdict(int)

    def times(self, name: str) -> bool:
        return self.prefixes is None or name.split(".")[0] in self.prefixes

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self) -> StageTimer:
        global _timer
        _timer = self
        return self

    def __exit__(self, *exc):
        global _timer
        _timer = None


@contextlib.contextmanager
def stage(name: str, **attrs) -> Iterator[dict]:
    timer = _timer
    tr = _default
    with record_function(name):
        tok = tr._enter() if tr.enabled else None
        try:
            if timer is None or not timer.times(name):
                yield attrs
            else:
                timer.sync()
                t0 = time.perf_counter()
                try:
                    yield attrs
                finally:
                    timer.sync()
                    timer.seconds[name] += time.perf_counter() - t0
                    timer.calls[name] += 1
        finally:
            if tok is not None:
                tr._exit(name, tok, attrs)


class Span(NamedTuple):
    """One entry of the span log; times in ns of ``time.time_ns()``."""

    name: str
    start_ns: int
    end_ns: int
    id: int  # entries are numbered in the order they open
    parent: int  # the id of the entry open around it on its thread, -1 for none
    thread: int  # threading.get_ident()
    attrs: dict


@dataclass
class SpanStats:
    count: int = 0
    total_s: float = 0.0
    samples: deque = field(default_factory=lambda: deque(maxlen=2048))

    def add(self, dt: float) -> None:
        self.count += 1
        self.total_s += dt
        self.samples.append(dt)

    def summary(self) -> dict:
        arr = np.asarray(self.samples) if self.samples else np.zeros(1)
        return {
            "count": self.count,
            "total_s": round(self.total_s, 6),
            "mean_ms": round(float(arr.mean()) * 1e3, 3),
            "median_ms": round(float(np.median(arr)) * 1e3, 3),
            "p90_ms": round(float(np.percentile(arr, 90)) * 1e3, 3),
            "p99_ms": round(float(np.percentile(arr, 99)) * 1e3, 3),
            "max_ms": round(float(arr.max()) * 1e3, 3),
        }


class Tracer:
    """Span timing, the span log, structured events and counters.
    Thread-safe; a disabled tracer records nothing (one branch per call)."""

    def __init__(self, enabled: bool = True, max_events: int = 10000,
                 max_spans: int = 1 << 16):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._stats: dict[str, SpanStats] = defaultdict(SpanStats)
        self._events: deque = deque(maxlen=max_events)
        self._counters: dict[str, float] = defaultdict(float)
        self._gauges: dict[str, float] = {}
        self._log: deque = deque(maxlen=max_spans)
        self.dropped = 0  # entries the log let go since the last reset
        self._ids = itertools.count()
        self._local = threading.local()  # .stack: the ids open on this thread
        self._t0 = time.perf_counter()

    # -- spans ------------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, **attrs) -> Iterator[dict]:
        if not self.enabled:
            yield attrs
            return
        with record_function(name):
            tok = self._enter()
            try:
                yield attrs
            finally:
                self._exit(name, tok, attrs, stats=True)

    def _enter(self) -> tuple[int, int, int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        sid = next(self._ids)
        parent = stack[-1] if stack else -1
        stack.append(sid)
        return sid, parent, time.time_ns()

    def _exit(self, name: str, tok: tuple[int, int, int], attrs: dict,
              stats: bool = False) -> None:
        end = time.time_ns()
        sid, parent, start = tok
        self._local.stack.pop()
        entry = Span(name, start, end, sid, parent, threading.get_ident(), attrs)
        with self._lock:
            if len(self._log) == self._log.maxlen:
                self.dropped += 1
            self._log.append(entry)
            if stats:
                self._stats[name].add((end - start) / 1e9)

    def spans(self) -> list[Span]:
        """The span log, oldest end first."""
        with self._lock:
            return list(self._log)

    # -- events (the state-transition log) ---------------------------------
    def event(self, kind: str, **fields) -> None:
        if not self.enabled:
            return
        rec = {"t": time.perf_counter() - self._t0, "kind": kind, **fields}
        with self._lock:
            self._events.append(rec)

    # -- counters / gauges --------------------------------------------------
    def incr(self, name: str, by: float = 1.0) -> None:
        if self.enabled:
            with self._lock:
                self._counters[name] += by

    def gauge(self, name: str, value: float) -> None:
        if self.enabled:
            with self._lock:
                self._gauges[name] = float(value)

    # -- reporting ---------------------------------------------------------
    def stage_summary(self) -> dict:
        with self._lock:
            return {k: v.summary() for k, v in sorted(self._stats.items())}

    def metrics(self) -> dict:
        with self._lock:
            return {"counters": dict(self._counters), "gauges": dict(self._gauges)}

    def events(self, kind: str | None = None) -> list[dict]:
        with self._lock:
            evs = list(self._events)
        return [e for e in evs if kind is None or e["kind"] == kind]

    def report(self) -> dict:
        return {"stages": self.stage_summary(), **self.metrics()}

    def save_report(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.report(), indent=1))

    def save_chrome_trace(self, path: str | Path) -> None:
        """Write the span log, spans and stages, as Chrome trace-event JSON
        (Perfetto nests each thread's entries by time): ``ts`` and ``dur`` in
        us on the profiler's clock, the attributes as ``args``."""
        evs = [{"name": s.name, "ph": "X", "pid": 0, "tid": s.thread, "ts": s.start_ns / 1e3,
                "dur": (s.end_ns - s.start_ns) / 1e3, "args": s.attrs} for s in self.spans()]
        Path(path).write_text(json.dumps({"traceEvents": evs}))

    def save_events(self, path: str | Path) -> None:
        Path(path).write_text("\n".join(json.dumps(e) for e in self.events()) + "\n")

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()
            self._events.clear()
            self._counters.clear()
            self._gauges.clear()
            self._log.clear()
            self.dropped = 0
            self._t0 = time.perf_counter()


_default = Tracer(enabled=True)


def get_tracer() -> Tracer:
    return _default

