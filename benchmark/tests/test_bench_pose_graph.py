"""The reader of ``pose_graph_replay_share`` (``metrics/pose_graph_replay_share.py``)
on a hand-made traced window and span log.

    python -m pytest -q benchmark/tests/test_bench_pose_graph.py
"""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import harness  # noqa: E402
from benchmark.trace import TraceWindow  # noqa: E402
from orbslamm_tpu_torch.utils import trace as ttrace  # noqa: E402

replay_share = harness.load_reader("pose_graph_replay_share")

T0, T1 = 1_000, 100_000  # the window, ns


def _span(name, s, e, **attrs):
    return ttrace.Span(name, s, e, 0, -1, 1, attrs)


def _run():
    return SimpleNamespace(trace=TraceWindow(t0=T0, t1=T1))


LOG = [_span("ba.pose_optimize", 500, 900, B=2, N=2048, graph="capture"),  # before the window
       _span("ba.pose_optimize", 2_000, 3_000, B=2, N=2048, graph="replay"),
       _span("ba.pose_optimize", 4_000, 5_000, B=1, N=2048, graph="replay"),
       _span("ba.pose_optimize", 6_000, 7_000, B=1, N=700, graph="capture"),
       _span("ba.pose_optimize", 8_000, 9_000, B=2, N=2048, graph="replay"),
       _span("orb.extract", 9_500, 9_900),
       _span("ba.pose_optimize", 99_500, 100_500, B=1, N=2048, graph="capture")]  # past it


def test_share_counts_the_window_s_replays():
    assert replay_share(_run(), log=(LOG, 0)) == pytest.approx(75.0)


def test_every_solve_replayed_reads_100():
    log = [e for e in LOG if e.attrs.get("graph") != "capture"]
    assert replay_share(_run(), log=(log, 0)) == pytest.approx(100.0)


def test_eager_solves_count_against_the_share():
    log = [e._replace(attrs=dict(e.attrs, graph="eager")) for e in LOG]
    assert replay_share(_run(), log=(log, 0)) == 0.0


@pytest.mark.parametrize("case", ["dropped in the window", "no solves", "no graph attribute",
                                  "no trace"])
def test_reader_gives_none(case):
    run, log = _run(), (LOG, 0)
    if case == "dropped in the window":  # the oldest end kept lies inside the window
        log = (LOG[2:], 3)
    elif case == "no solves":
        log = ([e for e in LOG if e.name != "ba.pose_optimize"], 0)
    elif case == "no graph attribute":  # a program without the graphs
        log = ([e._replace(attrs={"B": 1, "N": 2048}) for e in LOG], 0)
    else:
        run = SimpleNamespace(trace=None)
    assert replay_share(run, log=log) is None
