"""The port's Tracer (orbslamm_tpu_torch/utils/trace.py) against the JAX
package's (orbslamm_tpu/utils/trace.py): tests/test_trace.py's cases on the
port's, one sequence of calls on both giving equal reports and events, the
port's call sites writing the JAX package's names, and a short driver run
on the CPU populating the report. Then the port's span log: its entries on
the profiler's clock, their nesting, bound, attributes and Chrome trace,
and the ``frame`` and ``ba.pose_optimize`` entries of an RGB-D session."""

import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from orbslamm_tpu.utils import trace as jtrace
from orbslamm_tpu_torch.utils import trace as ttrace
from orbslamm_tpu_torch.utils.config import (
    CameraConfig, CapacityConfig, OrbConfig, SlamConfig, TrackingConfig,
)

torch.set_num_threads(2)

TRACERS = {"port": ttrace.Tracer, "jax": jtrace.Tracer}
CAM = CameraConfig(width=320, height=240, fx=260, fy=260, cx=160, cy=120)
# tests/test_trace.py's configuration
CFG = SlamConfig(
    camera=CAM,
    orb=OrbConfig(n_features=600, max_keypoints=1024, n_levels=4),
    capacity=CapacityConfig(max_keyframes=64, max_landmarks=4096),
    tracking=TrackingConfig(pixel_noise=1.2, min_matches_init=55, init_min_triangulated=30,
                            init_min_parallax_deg=0.4, new_kf_max_frames=4),
)


def test_span_stats_and_report(tmp_path):
    tr = ttrace.Tracer()
    for _ in range(5):
        with tr.span("stage_a"):
            time.sleep(0.001)
    with tr.span("stage_b"):
        pass
    s = tr.stage_summary()
    assert s["stage_a"]["count"] == 5
    assert s["stage_a"]["median_ms"] >= 1.0
    assert s["stage_b"]["count"] == 1
    tr.save_report(tmp_path / "r.json")
    rep = json.loads((tmp_path / "r.json").read_text())
    assert "stage_a" in rep["stages"]


def test_events_counters_gauges(tmp_path):
    tr = ttrace.Tracer()
    tr.event("loop_closed", map_id=0, slot=12)
    tr.event("map_merge", absorbed=1, base=0)
    tr.incr("keyframes_inserted")
    tr.incr("keyframes_inserted")
    tr.gauge("n_landmarks", 1234)
    assert len(tr.events("map_merge")) == 1
    assert tr.metrics()["counters"]["keyframes_inserted"] == 2
    assert tr.metrics()["gauges"]["n_landmarks"] == 1234
    tr.save_events(tmp_path / "e.jsonl")
    lines = (tmp_path / "e.jsonl").read_text().splitlines()
    assert len(lines) == 2 and json.loads(lines[0])["kind"] == "loop_closed"


def test_chrome_trace_export(tmp_path):
    tr = ttrace.Tracer()
    with tr.span("jitted_step", frame=3):
        pass
    tr.save_chrome_trace(tmp_path / "t.json")
    evs = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    assert evs and evs[0]["name"] == "jitted_step" and evs[0]["ph"] == "X"


def test_disabled_tracer_is_noop():
    tr = ttrace.Tracer(enabled=False)
    with tr.span("x"):
        pass
    tr.event("y")
    tr.incr("z")
    tr.gauge("g", 1.0)
    assert tr.stage_summary() == {} and tr.events() == []
    assert tr.metrics() == {"counters": {}, "gauges": {}}


def test_thread_safety():
    tr = ttrace.Tracer()

    def work():
        for _ in range(200):
            with tr.span("s"):
                pass
            tr.incr("c")

    threads = [threading.Thread(target=work) for _ in range(4)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    assert tr.stage_summary()["s"]["count"] == 800
    assert tr.metrics()["counters"]["c"] == 800


def _drive(tr):
    """One sequence of calls: spans (nested, repeated), events, counters,
    gauges, a reset, then more of each."""
    if isinstance(tr, jtrace.Tracer):  # the port's Tracer always keeps its span log
        tr.keep_chrome_trace = True
    with tr.span("dropped"):
        tr.event("dropped_event", x=1)
    tr.incr("dropped_counter")
    tr.reset()
    for i in range(3):
        with tr.span("track", robot="r0", chunk=8):
            with tr.span("local_mapping", map_id=0, slot=i):
                pass
        tr.incr("keyframes_inserted")
        tr.event("keyframe", map_id=0, slot=i, frame_id=4 * i, ts=0.1 * i)
    tr.incr("map_merges", by=2.5)
    tr.gauge("n_landmarks", 77)
    tr.event("map_merge", absorbed=1, base=0, slot_b=3, slot_a=5)


def test_one_call_sequence_gives_equal_reports(tmp_path):
    """The same calls on both Tracers: equal report keys, span counts,
    counters, gauges, events (the host clock's ``t`` aside), Chrome trace
    span names and arguments, and the same lines in the events file but
    for ``t``."""
    out = {}
    for pkg, cls in TRACERS.items():
        tr = cls()
        _drive(tr)
        rep = tr.report()
        tr.save_events(tmp_path / f"{pkg}.jsonl")
        tr.save_chrome_trace(tmp_path / f"{pkg}_trace.json")
        trace = json.loads((tmp_path / f"{pkg}_trace.json").read_text())["traceEvents"]
        lines = [json.loads(x) for x in (tmp_path / f"{pkg}.jsonl").read_text().splitlines()]
        out[pkg] = dict(
            keys=sorted(rep), stats_keys={k: sorted(v) for k, v in rep["stages"].items()},
            counts={k: v["count"] for k, v in rep["stages"].items()},
            counters=rep["counters"], gauges=rep["gauges"],
            events=[{k: v for k, v in e.items() if k != "t"} for e in tr.events()],
            lines=[{k: v for k, v in e.items() if k != "t"} for e in lines],
            trace=[(e["name"], e["ph"], e["args"]) for e in trace])
    assert out["port"] == out["jax"]
    assert out["port"]["counts"] == {"local_mapping": 3, "track": 3}
    assert out["port"]["counters"] == {"keyframes_inserted": 3.0, "map_merges": 2.5}
    assert len(out["port"]["events"]) == 4


def test_call_sites_write_the_jax_names():
    """The multi-map toggle, a new map on loss, an early-loss reset, a
    converged global BA, a bank event and a bridge import reach the
    process Tracer under the JAX package's names and fields."""
    from orbslamm_tpu_torch.models.multimap import MultiMapper
    from orbslamm_tpu_torch.models.system import TrackingState
    from orbslamm_tpu_torch.parallel.multihost_mapper import HostMapperBridge
    from orbslamm_tpu_torch.parallel.streams import StreamBank

    tr = ttrace.get_tracer()
    tr.reset()
    mm = MultiMapper(CFG, device="cpu")
    t = mm.add_robot("r0")
    mm.set_multi_mapping(False)
    mm.set_multi_mapping(True)
    assert [e["on"] for e in tr.events("multi_mapping_toggled")] == [False, True]
    # an established map kept on loss: the robot continues in a new map
    t.mapctx.n_kf = CFG.tracking.min_kfs_for_new_map
    old = t.mapctx
    mm._handle_loss(t, 1.5)
    assert t.mapctx is not old and tr.metrics()["counters"]["new_maps_on_loss"] == 1
    (ev,) = tr.events("new_map_on_loss")
    assert ev["robot"] == "r0" and ev["map_id"] == t.mapctx.map_id and ev["ts"] == 1.5
    # a young map lost on its own tracker is reset
    t.auto_reset_young, t.state = True, TrackingState.LOST
    young = t.mapctx.map_id
    t._maybe_reset_young_map()
    (ev,) = tr.events("early_loss_reset")
    assert ev == {**ev, "map_id": young, "robot": "r0"}
    # a global-BA schedule whose cost stalls
    mc = t.mapctx
    mc.schedule_gba(first_cost=10.0)
    mc.gba_resolve_cost(10.0)
    (ev,) = tr.events("gba_converged")
    assert ev["cost"] == 10.0 and ev["slices_left"] == mc.gba_max_slices
    # the bank's events helper
    bank = StreamBank(CFG, [t], device="cpu")
    bank._event("bank_follower", follower=1, owner=0, map_id=mc.map_id)
    assert bank.count("bank_follower") == 1
    assert tr.events("bank_follower")[0]["owner"] == 0
    # the bridge importing a packed map
    bridge = HostMapperBridge(mm)
    got = bridge._unpack_map(bridge._pack_map(old), src_proc=1)
    (ev,) = tr.events("multihost_map_received")
    assert ev["src_proc"] == 1 and ev["local_map"] == got.map_id and bridge.events


def test_pipeline_emits_trace(tmp_path):
    """tests/test_trace.py's pipeline case on the port: a short driver run
    populates the ``track`` span and keyframe events through the default
    tracer and writes the report and event log."""
    from orbslamm_tpu_torch.driver import RobotFeed, run_robots
    from orbslamm_tpu_torch.io.synthetic import make_sequence

    seq = make_sequence(n_frames=16, n_points=1400, cam=CAM, seed=7)

    def gen():
        for i in range(16):
            yield seq.timestamps[i], np.asarray(seq.images[i])

    run_robots(CFG, [RobotFeed(gen(), "r0")], out_dir=tmp_path / "out", verbose=False,
               device="cpu")
    tr = ttrace.get_tracer()
    # one span per per-frame dispatch, one per chunk
    assert tr.stage_summary()["track"]["count"] >= 2
    assert tr.events("keyframe")
    assert tr.metrics()["counters"]["keyframes_inserted"] >= 1
    assert (tmp_path / "out" / "trace_report.json").exists()
    assert (tmp_path / "out" / "events.jsonl").exists()


# -- the span log ----------------------------------------------------------

def _profiled(body):
    """Run ``body`` under a CPU profiler with the process Tracer reset;
    returns (log entries, {name: sorted [start, end] ns of its ranges})."""
    tr = ttrace.get_tracer()
    tr.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        body(tr)
    ranges = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.is_user_annotation():
            ranges.setdefault(ev.name(), []).append((ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    return tr.spans(), {k: sorted(v) for k, v in ranges.items()}


def _stage_body(tr):
    for i in range(20):
        with ttrace.stage("orb.extract", i=i):
            torch.ones(64, 64) @ torch.ones(64, 64)


def _span_body(tr):
    for i in range(20):
        with tr.span("track", i=i):
            torch.ones(64, 64) @ torch.ones(64, 64)


def _nested_body(tr):
    for i in range(20):
        with tr.span("local_mapping", slot=i), ttrace.stage("mapping.fuse"):
            with ttrace.stage("ba.pose_optimize", B=1, N=8):
                torch.ones(64, 64) @ torch.ones(64, 64)


@pytest.mark.parametrize("body", [_stage_body, _span_body, _nested_body],
                         ids=["stage", "span", "nested"])
def test_log_entries_meet_their_profiler_ranges(body):
    """Each entry of the log is stamped on the profiler's clock: at both
    ends within 50 us of its ``record_function`` event (a preempted host
    may stretch one gap in ten), and never further than 5 ms."""
    _profiled(body)  # the profiler's first ranges pay for its warm-up
    log, ranges = _profiled(body)
    names = {e.name for e in log}
    assert names and len(log) == sum(len(ranges[n]) for n in names)
    gaps = []
    for n in names:
        mine = sorted((e.start_ns, e.end_ns) for e in log if e.name == n)
        for (s, e), (ps, pe) in zip(mine, ranges[n]):
            gaps += [abs(s - ps), abs(pe - e)]
    gaps = np.asarray(gaps) / 1e3
    assert gaps.max() < 5000, gaps.max()
    assert (gaps <= 50).mean() >= 0.9, np.sort(gaps)[-10:]


def test_log_parents_follow_nesting_and_threads():
    tr = ttrace.get_tracer()
    tr.reset()
    ready = threading.Barrier(2)

    def work(k):
        with tr.span("track", robot=k):
            ready.wait()
            with ttrace.stage("orb.extract"):
                with ttrace.stage("matching.match_tables"):
                    ready.wait()

    threads = [threading.Thread(target=work, args=(k,)) for k in range(2)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    log = tr.spans()
    assert len(log) == 6
    by_id = {e.id: e for e in log}
    for e in log:
        if e.name == "track":
            assert e.parent == -1
        else:
            up = by_id[e.parent]
            assert up.thread == e.thread
            assert up.name == {"orb.extract": "track", "matching.match_tables": "orb.extract"}[e.name]
            assert up.start_ns <= e.start_ns <= e.end_ns <= up.end_ns
    assert len({e.thread for e in log}) == 2


def test_log_bound_drops_the_oldest():
    tr = ttrace.Tracer(max_spans=4)
    for i in range(7):
        with tr.span("s", i=i):
            pass
    assert [e.attrs["i"] for e in tr.spans()] == [3, 4, 5, 6]
    assert tr.dropped == 3
    assert tr.stage_summary()["s"]["count"] == 7


@pytest.mark.parametrize("how", ["disabled", "reset"])
def test_disabled_or_reset_leaves_no_entry(how):
    tr = ttrace.get_tracer()
    tr.reset()
    if how == "disabled":
        tr.enabled = False
    try:
        with tr.span("track"), ttrace.stage("orb.extract") as attrs:
            attrs["n"] = 1
    finally:
        tr.enabled = True
    if how == "reset":
        assert len(tr.spans()) == 2
        tr.dropped = 5
        tr.reset()
    assert tr.spans() == [] and tr.dropped == 0


@pytest.mark.parametrize("kind", ["stage", "span"])
def test_attributes_set_inside_are_kept(kind):
    tr = ttrace.get_tracer()
    tr.reset()
    cm = ttrace.stage("frame", frame_id=3) if kind == "stage" else tr.span("track", robot="r0")
    with cm as attrs:
        attrs["kf"] = True
    (e,) = tr.spans()
    assert e.attrs == ({"frame_id": 3, "kf": True} if kind == "stage"
                       else {"robot": "r0", "kf": True})


def test_chrome_trace_holds_the_nested_stages(tmp_path):
    tr = ttrace.get_tracer()
    tr.reset()
    with tr.span("local_mapping", slot=2):
        with ttrace.stage("mapping.triangulate"):
            with ttrace.stage("matching.match_tables"):
                pass
        with ttrace.stage("mapping.fuse"):
            pass
    tr.save_chrome_trace(tmp_path / "t.json")
    evs = {e["name"]: e for e in json.loads((tmp_path / "t.json").read_text())["traceEvents"]}
    assert set(evs) == {"local_mapping", "mapping.triangulate", "matching.match_tables",
                        "mapping.fuse"}
    assert evs["local_mapping"]["args"] == {"slot": 2}
    assert len({e["tid"] for e in evs.values()}) == 1 and all(e["ph"] == "X" for e in evs.values())

    def inside(a, b):  # us stamps of ns: allow their rounding
        return (evs[b]["ts"] - 1e-3 <= evs[a]["ts"]
                and evs[a]["ts"] + evs[a]["dur"] <= evs[b]["ts"] + evs[b]["dur"] + 1e-3)
    assert inside("mapping.triangulate", "local_mapping")
    assert inside("matching.match_tables", "mapping.triangulate")
    assert inside("mapping.fuse", "local_mapping")
    assert evs["mapping.fuse"]["ts"] >= evs["mapping.triangulate"]["ts"] + evs["mapping.triangulate"]["dur"] - 1e-3


# tests/test_stereo_rgbd.py's camera and configuration
RGBD_CAM = CameraConfig(width=320, height=240, fx=260, fy=260, cx=160, cy=120, fps=30,
                        bf=130.0, th_depth=60.0, depth_map_factor=1.0)
RGBD_CFG = SlamConfig(
    camera=RGBD_CAM,
    orb=OrbConfig(n_features=400, max_keypoints=1024, n_levels=4),
    capacity=CapacityConfig(max_keyframes=64, max_landmarks=4096),
    tracking=TrackingConfig(pixel_noise=1.2, min_matches_init=60, init_min_triangulated=30,
                            init_min_parallax_deg=0.4),
)


def test_rgbd_session_logs_frames_and_pose_solves(monkeypatch):
    """A short RGB-D session: one ``frame`` entry a frame, consecutive
    ``frame_id``s and the record's state, ``kf`` on exactly the frames
    that raised ``keyframes_inserted``, and one ``ba.pose_optimize`` entry
    a call with ``B`` and ``N`` its arguments' shapes."""
    from orbslamm_tpu_torch.io.synthetic import make_sequence
    from orbslamm_tpu_torch.models.system import RGBDSession
    from orbslamm_tpu_torch.ops import ba

    seq = make_sequence(n_frames=12, n_points=900, cam=RGBD_CAM, seed=7, motion="forward",
                        with_depth=True)
    shapes = []
    solve = ba.pose_optimize

    def counted(T_init, K, pts_w, *args, **kw):
        shapes.append((T_init.shape[0] if T_init.ndim == 3 else 1, pts_w.shape[0]))
        return solve(T_init, K, pts_w, *args, **kw)

    monkeypatch.setattr(ba, "pose_optimize", counted)
    tr = ttrace.get_tracer()
    tr.reset()
    sess = RGBDSession(RGBD_CFG, device="cpu")
    recs, kf = [], []
    for i in range(len(seq.images)):
        before = tr.metrics()["counters"].get("keyframes_inserted", 0)
        recs.append(sess.process_frame(seq.images[i], seq.depths[i], float(seq.timestamps[i])))
        kf.append(tr.metrics()["counters"].get("keyframes_inserted", 0) > before)
    frames = [e for e in tr.spans() if e.name == "frame"]
    assert [e.attrs["frame_id"] for e in frames] == list(range(len(seq.images)))
    assert [e.attrs["state"] for e in frames] == [r.state for r in recs]
    assert [e.attrs["kf"] for e in frames] == kf and any(kf)
    assert all(e.parent == -1 for e in frames)
    solves = [e for e in tr.spans() if e.name == "ba.pose_optimize"]
    assert shapes and {b for b, _ in shapes} == {1, 2}
    assert [(e.attrs["B"], e.attrs["N"]) for e in solves] == shapes
    # the CPU never captures a CUDA graph: every solve eager, both counters unset
    assert all(e.attrs["graph"] == "eager" for e in solves) and len(ba._pose_graphs._graphs) == 0
    assert not {"ba.pose_graph_captures", "ba.pose_graph_replays"} & set(tr.metrics()["counters"])
    frame_ids = {e.id for e in frames}
    by_id = {e.id: e for e in tr.spans()}

    def top(e):
        while e.parent in by_id:
            e = by_id[e.parent]
        return e.id
    assert all(top(e) in frame_ids for e in solves)
