"""The readers of the port's span log (``benchmark/spans.py``,
``metrics/track_frame_ms.py``, ``metrics/pose_launches_per_call.py``) on a
synthetic traced window and span list, and on a traced run at test size on
the CPU.

    python -m pytest -q benchmark/tests/test_bench_spans.py
"""

import os
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from benchmark import harness, spans  # noqa: E402
from benchmark.trace import TraceWindow  # noqa: E402
from orbslamm_tpu_torch.utils import trace as ttrace  # noqa: E402

track_frame_ms = harness.load_reader("track_frame_ms")
pose_launches_per_call = harness.load_reader("pose_launches_per_call")

T0, T1 = 1_000, 100_000  # the window, ns


def _span(name, s, e, **attrs):
    return ttrace.Span(name, s, e, 0, -1, 1, attrs)


def _run(dev_starts=(), window=(T0, T1)):
    tw = TraceWindow(t0=window[0], t1=window[1])
    tw.dev_iv = np.array([[s, s + 5] for s in dev_starts], np.int64).reshape(-1, 2)
    return SimpleNamespace(trace=tw)


POSE = [_span("ba.pose_optimize", 2_000, 3_000, B=2, N=900),
        _span("ba.pose_optimize", 5_000, 6_000, B=1, N=700),
        _span("ba.pose_optimize", 99_500, 100_500, B=1, N=700),  # ends after the window
        _span("ba.pose_optimize", 200_000, 201_000, B=1, N=700),  # after it
        _span("orb.extract", 3_500, 4_500)]
# 3 operations in the first solve, 1 in the second, the rest outside either
DEVICE = [1_500, 2_100, 2_500, 2_999, 3_001, 3_600, 5_500, 99_700, 200_500]


def test_launches_count_only_inside_the_window_s_pose_spans():
    assert pose_launches_per_call(_run(DEVICE), log=(POSE, 0)) == 2.0


def test_launches_without_device_operations_or_pose_spans_give_none():
    assert pose_launches_per_call(_run(()), log=(POSE, 0)) is None
    assert pose_launches_per_call(_run(DEVICE), log=(POSE[3:], 0)) is None


FRAMES = [_span("frame", 2_000, 12_000, frame_id=1, state="OK", kf=False),  # 10 us
          _span("frame", 12_000, 52_000, frame_id=2, state="OK", kf=True),  # a keyframe
          _span("frame", 52_000, 56_000, frame_id=3, state="OK", kf=False),  # 4 us
          _span("frame", 56_000, 57_000, frame_id=4, state="LOST", kf=False),  # lost
          _span("frame", 57_000, 63_000, frame_id=5, state="OK", kf=False),  # 6 us
          _span("frame", 63_000, 63_500, frame_id=6, state="NOT_INITIALIZED", kf=False),
          _span("frame", 99_000, 101_000, frame_id=7, state="OK", kf=False),  # past the end
          _span("ba.pose_optimize", 3_000, 4_000, B=2, N=900)]


def test_frame_median_skips_keyframes_and_frames_not_ok():
    assert track_frame_ms(_run(), log=(FRAMES, 0)) == pytest.approx(0.006)


@pytest.mark.parametrize("case", ["dropped in the window", "no frame spans", "no log",
                                  "no trace"])
def test_readers_give_none(case, monkeypatch):
    run, log = _run(DEVICE), (FRAMES + POSE, 0)
    if case == "dropped in the window":  # the oldest end kept lies inside the window
        log = (FRAMES[2:] + POSE, 4)
    elif case == "no frame spans":
        log = (POSE, 0)
    elif case == "no log":  # a program whose Tracer keeps no span log
        monkeypatch.setattr(ttrace, "get_tracer", lambda: SimpleNamespace(enabled=True))
        log = None
    else:
        run = SimpleNamespace(trace=None)
    assert track_frame_ms(run, log=log) is None
    if case != "no frame spans":
        assert pose_launches_per_call(run, log=log) is None


def test_entries_dropped_before_the_window_leave_it_whole():
    log = ([_span("x", 0, 900)] + FRAMES + POSE, 1000)
    assert spans.window_spans(_run().trace, log) == [
        e for e in FRAMES + POSE if T0 <= e.start_ns and e.end_ns <= T1]
    assert track_frame_ms(_run(), log=log) == pytest.approx(0.006)


def test_a_traced_run_reads_its_frames_from_the_process_tracer():
    """At test size on the CPU: the window's tracking frames are read from
    the process Tracer; the CPU trace has no device operations, so the
    launch count is left out."""
    from test_bench_faults import tiny_cell

    torch.set_num_threads(min(4, os.cpu_count() or 1))
    res = harness.execute(tiny_cell("tum_rgbd.stream"), 7, 3, True, "cpu")
    assert res["metrics"]["track_frame_ms"]["value"] > 0
    assert "pose_launches_per_call" not in res["metrics"]
    log = ttrace.get_tracer().spans()
    frames = [e for e in log if e.name == "frame"]
    assert frames and all({"frame_id", "state", "kf"} <= set(e.attrs) for e in frames)
