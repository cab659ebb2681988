"""Named stages of the main path.

``stage(name)`` marks a stage: always a ``torch.profiler`` range, and while
a ``StageTimer`` is active also a synchronized wall clock. The timer drains
the device at each stage's start and end, so a stage's time holds the device
work it launched; nested stages (``ba.pose_optimize`` inside
``track.local_map``) each report their inclusive time. With no timer active
a stage costs one profiler range. A timer made with ``prefixes`` times only
the stages whose first dotted part is one of them (``"loop"`` takes
``loop.verify``), so the rest of the path runs without the extra drains.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

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
