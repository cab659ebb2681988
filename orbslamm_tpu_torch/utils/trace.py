"""Tracing: named stages for the profiler, and the Tracer's report.

Two layers, which answer different questions and so both stay:

* ``stage(name)`` marks a stage of the device path: always a
  ``torch.profiler`` range, and while a ``StageTimer`` is active also a
  synchronized wall clock. The timer drains the device at each stage's
  start and end, so a stage's time holds the device work it launched;
  nested stages (``ba.pose_optimize`` inside ``track.local_map``) each
  report their inclusive time. With no timer active a stage costs one
  profiler range. A timer made with ``prefixes`` times only the stages
  whose first dotted part is one of them (``"loop"`` takes
  ``loop.verify``), so the rest of the path runs without the extra drains.
* ``Tracer`` (port of orbslamm_tpu/utils/trace.py): span timing on the
  host's clock (``with tracer.span("track")``; per-span count, total,
  median, p90, p99 and max), a bounded structured event log (the
  reference's state-transition prints), counters and gauges, and a
  Chrome-trace export. The process-wide ``get_tracer()`` is the one the
  sessions, the MultiMapper, the bank and the bridge write to, under the
  JAX package's span, event and counter names, so a run of either package
  writes a ``trace_report.json`` with the same keys (``driver.run_robots``
  saves it). A span never synchronizes the device: it is the host's wall
  time, launches included, device work only where the host waited on it.

Where a stage and a span wrap the same region they nest (``merge`` around
``merge.apply``, ``loop_correct`` around ``loop.correct``).
``torch_profile(logdir)`` is the counterpart of the JAX package's
``jax_profile``: a ``torch.profiler`` session around a region, its Chrome
trace written into ``logdir``.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator

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
def stage(name: str):
    timer = _timer
    with record_function(name):
        if timer is None or not timer.times(name):
            yield
            return
        timer.sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            timer.sync()
            timer.seconds[name] += time.perf_counter() - t0
            timer.calls[name] += 1


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
    """Span timing, structured events and counters. Thread-safe; a disabled
    tracer records nothing (one branch per call)."""

    def __init__(self, enabled: bool = True, max_events: int = 10000):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._stats: dict[str, SpanStats] = defaultdict(SpanStats)
        self._events: deque = deque(maxlen=max_events)
        self._counters: dict[str, float] = defaultdict(float)
        self._gauges: dict[str, float] = {}
        self._trace_events: list[dict] = []  # Chrome trace-event format
        self._t0 = time.perf_counter()
        self.keep_chrome_trace = False

    # -- spans ------------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, **attrs) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self._stats[name].add(t1 - t0)
                if self.keep_chrome_trace:
                    self._trace_events.append({
                        "name": name, "ph": "X", "pid": 0,
                        "tid": threading.get_ident() % 1000,
                        "ts": (t0 - self._t0) * 1e6,
                        "dur": (t1 - t0) * 1e6,
                        "args": attrs,
                    })

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
        """Write the kept spans as Chrome trace-event JSON (Perfetto)."""
        with self._lock:
            evs = list(self._trace_events)
        Path(path).write_text(json.dumps({"traceEvents": evs}))

    def save_events(self, path: str | Path) -> None:
        Path(path).write_text("\n".join(json.dumps(e) for e in self.events()) + "\n")

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()
            self._events.clear()
            self._counters.clear()
            self._gauges.clear()
            self._trace_events.clear()
            self._t0 = time.perf_counter()


_default = Tracer(enabled=True)


def get_tracer() -> Tracer:
    return _default


@contextlib.contextmanager
def torch_profile(logdir: str | Path) -> Iterator[torch.profiler.profile]:
    """A ``torch.profiler`` session around a region (host operations, and
    the card's kernels when CUDA is available); its Chrome trace goes to
    ``logdir/trace.json``. The Tracer covers the host's stage timing, this
    covers what runs on the device."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
