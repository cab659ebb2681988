"""The traced window: ``torch.profiler`` over the window, reduced to what
the per-layer metrics read.

The raw events are read once (``kineto_results.events()``, no event tree is
built) into: the window (the ``bench.window`` range the harness opens), the
device's operations inside it (kernels, copies and fills; the profiler's
copies of host ranges onto the device's timeline excluded), and every host
range the program opens with ``utils/trace.stage`` (``orb.*``, ``track.*``,
``ba.pose_optimize``, ``mapping.*``, ``bank.*``, ``merge.*``, ...).
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

WINDOW = "bench.window"


def profile(device: str):
    from torch.profiler import ProfilerActivity, profile as _profile

    acts = [ProfilerActivity.CPU]
    if device.startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    return _profile(activities=acts, record_shapes=False, with_stack=False)


def union_s(iv: np.ndarray) -> float:
    """Seconds covered by the union of [start, end) intervals [n, 2] (ns)."""
    if len(iv) == 0:
        return 0.0
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    total, cur_s, cur_e = 0, iv[0, 0], iv[0, 1]
    for s, e in iv[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    return float(total + cur_e - cur_s) / 1e9


@dataclass
class TraceWindow:
    t0: int  # ns, the window's range
    t1: int
    dev_names: list = field(default_factory=list)
    dev_iv: np.ndarray = None  # [n, 2] ns, clipped to the window
    dev_kind: list = field(default_factory=list)  # "kernel" / "memcpy" / "memset"
    ranges: dict = field(default_factory=dict)  # name -> [n, 2] ns host ranges
    busy_s: float = 0.0
    window_s: float = 0.0
    breakdown: dict = field(default_factory=dict)

    def kernels(self) -> int:
        return sum(k == "kernel" for k in self.dev_kind)

    def device_seconds(self, pred) -> float:
        sel = [i for i, n in enumerate(self.dev_names) if pred(n)]
        if not sel:
            return 0.0
        iv = self.dev_iv[sel]
        return float((iv[:, 1] - iv[:, 0]).sum()) / 1e9

    def range_iv(self, pred) -> np.ndarray:
        parts = [iv for n, iv in self.ranges.items() if pred(n)]
        return np.concatenate(parts) if parts else np.zeros((0, 2), np.int64)


def _device_kind(ev) -> str | None:
    """The kind of a device event ("kernel", "memcpy", "memset"), or None
    for a host range the profiler mirrors onto the device's timeline."""
    if ev.is_user_annotation():
        return None
    act = str(ev.activity_type()).lower() if hasattr(ev, "activity_type") else ""
    if "annotation" in act or "runtime" in act or "driver" in act:
        return None
    name = ev.name().lower()
    for k in ("memcpy", "memset"):
        if k in act or k in name:
            return k
    return "kernel"


def reduce(prof) -> TraceWindow:
    from torch.autograd import DeviceType

    cuda = DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    win = None
    dev = []
    host = defaultdict(list)
    for ev in events:
        if ev.device_type() == cuda:
            kind = _device_kind(ev)
            if kind is not None:
                s = ev.start_ns()
                dev.append((s, s + ev.duration_ns(), ev.name(), kind))
        elif ev.is_user_annotation():
            s = ev.start_ns()
            name = ev.name()
            if name == WINDOW:
                win = (s, s + ev.duration_ns())
            else:
                host[name].append((s, s + ev.duration_ns()))
    if win is None:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    t0, t1 = win
    dev = [(max(s, t0), min(e, t1), n, k) for s, e, n, k in dev if e > t0 and s < t1]
    tw = TraceWindow(t0=t0, t1=t1)
    tw.dev_iv = np.array([[s, e] for s, e, _, _ in dev], np.int64).reshape(-1, 2)
    tw.dev_names = [n for _, _, n, _ in dev]
    tw.dev_kind = [k for _, _, _, k in dev]
    tw.ranges = {n: np.array([iv for iv in v if iv[1] > t0 and iv[0] < t1],
                             np.int64).reshape(-1, 2) for n, v in host.items()}
    tw.window_s = (t1 - t0) / 1e9
    tw.busy_s = union_s(tw.dev_iv)
    tw.breakdown = breakdown(tw)
    return tw


def breakdown(tw: TraceWindow, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps of the
    device summed by the innermost host range that holds each gap's middle
    (``host`` where the program had no range open)."""
    by_op = defaultdict(int)
    for (s, e), n in zip(tw.dev_iv, tw.dev_names):
        by_op[n] += int(e - s)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    iv = tw.dev_iv[np.argsort(tw.dev_iv[:, 0], kind="stable")] if len(tw.dev_iv) else tw.dev_iv
    gaps = []
    cur = tw.t0
    for s, e in iv:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if tw.t1 > cur:
        gaps.append((cur, tw.t1))
    # one sweep over range starts and ends and gap middles: the program's
    # ranges nest, so the innermost open range is the newest still open
    marks = []
    for n, v in tw.ranges.items():
        for s, e in v:
            marks.append((int(s), 2, n, 0))
            marks.append((int(e), 0, n, 0))
    for a, b in gaps:
        marks.append(((a + b) // 2, 1, None, int(b - a)))
    marks.sort(key=lambda m: (m[0], m[1]))
    by_host = defaultdict(int)
    open_ranges: list[str] = []
    for _, kind, n, length in marks:
        if kind == 2:
            open_ranges.append(n)
        elif kind == 0:
            if n in open_ranges:
                del open_ranges[len(open_ranges) - 1 - open_ranges[::-1].index(n)]
        else:
            by_host[open_ranges[-1] if open_ranges else "host"] += length
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v / 1e9] for n, v in ops],
            "idle_gaps": [[n, v / 1e9] for n, v in idle]}
