"""The tracker's ``use_fused`` and ``defer_sync`` switches in the port
(orbslamm_tpu_torch/models/system.py, models/multimap.py) against the JAX
package, on the CPU.

Scenario: tests/test_viewer.py's configuration (320x240, 400 features, 4
levels, 64 keyframes, 4096 landmarks) on ``make_sequence(24, 900 points,
seed 7, "forward")``, frame by frame through ``MonocularSession``, loop
closing off. Tolerances:
  * from the JAX session's state at its initialization (frame 3), carried
    across with ``orbslamm_tpu_torch.convert``, both packages run frames
    4-11 with ``use_fused`` off (the host-sequenced ``_track``) and with
    ``defer_sync`` on: per frame the tracking state and the keyframe
    decision are equal (exact); inlier counts are not compared, the port
    extracts its own features (level 0 bit-exact, others >= 98 %);
  * the port alone from scratch on frames 0-15, fused / host / deferred
    (through chip_smoke.py's host_path phase): the same states
    and keyframe count, the host path's inlier counts equal to the fused
    step's, the deferred counts the fused ones one frame late, Sim3 ATE
    below 0.45 m (tests/test_slam_e2e.py's bound);
  * ``MultiMapper.process_frames`` with ``use_fused`` off dispatches no
    chunk;
  * a loss under ``defer_sync``, the deferred runs above going on: frame 12
    blank on the young map, which is reset and initialized again; the JAX package's first frame after the
    new initialization reads the summary left pending from the old map and
    loses the new map at once; the port drops the pending summary at the
    reset, so its first record after the new initialization belongs to the
    new map (its pose, the warm-up count);
  * a relocalization under ``defer_sync``: the same run on a grown map
    (``min_kfs_for_new_map`` 4, so the map of 5 keyframes is kept) with the
    vocabulary file's keyframe database, the frames after the blank one
    showing the views of REVISIT frames earlier; both packages lose
    tracking and relocalize on the map; the JAX package's
    first frame after the relocalization reads the failed summary left
    pending at the loss and is lost again at once; the port drops it when
    the relocalization succeeds and records the relocalized pose;
  * a merge under ``defer_sync`` (the port alone): r0 maps frames 0 to
    MERGE_END - 1 with the fused step, r1 starts at frame MERGE_B0 with
    ``defer_sync`` on, and the MultiMapper's own scan merges r1's map into
    r0's (``min_kfs_for_merge`` 4); the summary pending at
    ``adopt_merged_map`` (r1's old world) is dropped, and r1's first record
    after the merge holds the adopted pose in the merged world, with no
    reference keyframe: its camera centre lies within one frame's motion
    (MERGE_TOL) of the next record's, the first to read a summary of the
    merged map, where the dropped summary's lies farther than 3 x
    MERGE_TOL from it.
"""

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from orbslamm_tpu.models.system import MonocularSession as JaxSession
from orbslamm_tpu.utils import config as jc
from orbslamm_tpu_torch import convert
from orbslamm_tpu_torch.io.synthetic import make_sequence
from orbslamm_tpu_torch.models.system import MonocularSession, RobotTracker, TrackingState
from orbslamm_tpu_torch.utils import config as tc

torch.set_num_threads(2)

# frames 4 to PARITY_END - 1 are compared with the JAX package; under
# defer_sync frame BLANK is blank, on a map of 5 keyframes (young: fewer
# than min_kfs_for_new_map)
N_FRAMES, INIT_FRAME, PARITY_END, BLANK = 24, 3, 12, 12
SCRATCH_FRAMES = 16  # the port's from-scratch runs
# the relocalization scenario: after the blank frame the camera shows the
# views of REVISIT frames earlier (the forward motion leaves the mapped
# views behind: from frame BLANK + 2 on, neither package relocalizes)
REVISIT = 4
VOCAB = Path(__file__).resolve().parents[1] / "orbslamm_tpu" / "data" / "vocab_10x4.npz"
# the merge scenario: r1's first frame, the frames each robot runs to, and
# one frame's motion at the merge in the merged map's units (about 0.015)
MERGE_B0, MERGE_END, MERGE_TOL = 6, 19, 0.015


def _cfg(c):
    cam = c.CameraConfig(width=320, height=240, fx=260, fy=260, cx=160, cy=120, fps=30)
    return c.SlamConfig(
        camera=cam,
        orb=c.OrbConfig(n_features=400, max_keypoints=1024, n_levels=4),
        capacity=c.CapacityConfig(max_keyframes=64, max_landmarks=4096),
        tracking=c.TrackingConfig(pixel_noise=1.2, min_matches_init=55,
                                  init_min_triangulated=30, init_min_parallax_deg=0.4),
    )


def _grown_cfg(c):
    """_cfg with a map counted as grown (kept on a loss, scanned for a
    merge) at 4 keyframes and the vocabulary file's keyframe database."""
    base = _cfg(c)
    return base.replace(
        tracking=dataclasses.replace(base.tracking, min_kfs_for_new_map=4),
        loop=dataclasses.replace(base.loop, min_kfs_for_merge=4),
        vocabulary_path=str(VOCAB))


CFG, JCFG = _cfg(tc), _cfg(jc)
GROWN, JGROWN = _grown_cfg(tc), _grown_cfg(jc)
SEQ = make_sequence(n_frames=N_FRAMES, n_points=900, cam=CFG.camera, seed=7, motion="forward")


def _np(tree):
    return jax.tree.map(np.array, tree)


def _session(pkg, mode, grown=False):
    s = (JaxSession(JGROWN if grown else JCFG) if pkg == "jax"
         else MonocularSession(GROWN if grown else CFG, device="cpu"))
    s.enable_loop_closing = False
    s.tracker.use_fused = mode != "host"
    s.tracker.defer_sync = mode == "defer"
    return s


def _step(sess, k, image=None):
    """One frame; the record and whether the frame inserted a keyframe (as
    the host sees it: one frame late under defer_sync)."""
    n_kf = sess.tracker.mapctx.n_kf
    rec = sess.process_frame(SEQ.images[k] if image is None else image,
                             float(SEQ.timestamps[k]))
    return rec, sess.tracker.mapctx.n_kf > n_kf


def _take_over(tt: RobotTracker, jt):
    """The port's tracker takes over the JAX map and tracking state."""
    tt.mapctx.map = convert.map_state_from_numpy(_np(jt.mapctx.map)._asdict(), device="cpu")
    tt.mapctx.n_kf = jt.mapctx.n_kf
    tt.T_cw, tt.velocity, tt.last_T = (torch.as_tensor(np.array(a))
                                       for a in (jt.T_cw, jt.velocity, jt.last_T))
    tt.last_feats = convert.features_from_numpy(_np(jt.last_feats)._asdict(), device="cpu")
    tt.last_lm = torch.as_tensor(np.array(jt.last_lm))
    for name in ("frame_id", "frames_since_kf", "peak_inliers_since_kf", "prev_inliers",
                 "last_kf_inliers"):
        setattr(tt, name, getattr(jt, name))
    tt._last_ref = (jt._last_ref[0], None if jt._last_ref[1] is None else np.array(jt._last_ref[1]))
    tt.state = TrackingState.OK


def _jax_boot(mode, grown=False):
    js = _session("jax", mode, grown)
    k = 0
    while js.state.name != "OK":
        js.process_frame(SEQ.images[k], float(SEQ.timestamps[k]))
        k += 1
    assert k - 1 == INIT_FRAME and js.tracker._ts is None and js.tracker._pending is None
    return js


def test_host_path_matches_jax_from_its_state():
    js = _jax_boot("host")
    port = _session("port", "host")
    _take_over(port.tracker, js.tracker)
    got, want = [], []
    for k in range(INIT_FRAME + 1, PARITY_END):
        rj, kf_j = _step(js, k)
        rt, kf_t = _step(port, k)
        want.append((k, rj.state, kf_j))
        got.append((k, rt.state, kf_t))
    assert got == want
    assert all(s == "OK" for _, s, _ in got) and sum(kf for *_, kf in got) >= 3
    assert port.n_kf == js.n_kf


@pytest.fixture(scope="module")
def deferred():
    """JAX and port under defer_sync from the JAX state at init: frames 4
    to PARITY_END - 1, then a blank frame on the young map, then the rest
    of the sequence. Per package and frame: (frame, state, keyframe seen,
    map id, the summary pending before the frame, the one after)."""
    return _deferred_logs(grown=False)


def _deferred_logs(grown):
    js = _jax_boot("defer", grown)
    port = _session("port", "defer", grown)
    _take_over(port.tracker, js.tracker)
    if grown:  # the database rows of the keyframes taken over
        port.tracker.mapctx.update_bow_rows(list(range(port.n_kf)))
    blank = np.zeros_like(SEQ.images[0])
    logs = {"jax": [], "port": []}
    for k in range(INIT_FRAME + 1, N_FRAMES):
        image = blank if k == BLANK else None
        if grown and k > BLANK:  # back where the map was built
            image = SEQ.images[k - REVISIT]
        for pkg, sess in (("jax", js), ("port", port)):
            before = sess.tracker._pending
            rec, kf = _step(sess, k, image)
            logs[pkg].append((k, rec.state, kf, rec.map_id, before, sess.tracker._pending,
                              rec.n_inliers, rec.T_cw))
    return logs


@pytest.fixture(scope="module")
def relocalized():
    """As ``deferred``, on the grown configuration: the blank frame's loss
    keeps the map, and the tracker relocalizes on it."""
    return _deferred_logs(grown=True)


def test_defer_sync_matches_jax_from_its_state(deferred):
    """Up to the blank frame: the same states and keyframe decisions; the
    first frame read nothing in either package (the warm-up count)."""
    want, got = ([r[:3] for r in deferred[p] if r[0] < BLANK] for p in ("jax", "port"))
    assert got == want and len(got) == BLANK - INIT_FRAME - 1
    assert all(s == "OK" for _, s, _ in got) and sum(kf for *_, kf in got) >= 3
    for p in ("jax", "port"):
        assert deferred[p][0][4] is None
        assert deferred[p][0][6] == CFG.tracking.min_inliers_local_map


def test_port_switches_from_scratch(monkeypatch):
    """The port alone on frames 0 to SCRATCH_FRAMES - 1, fused, host and
    deferred, through chip_smoke.host_path_phase (its gates included, at
    this configuration)."""
    import sys
    from collections import Counter
    from pathlib import Path
    from types import SimpleNamespace

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "bench_cfg", lambda: CFG)
    ph = SimpleNamespace(launches=0, launches_by_shape=Counter())
    res = chip_smoke.host_path_phase(torch, ph, "cpu", SEQ, INIT_FRAME, 1.0, "cpu",
                                     after_init=SCRATCH_FRAMES - INIT_FRAME - 1)
    runs = res["runs"]
    assert res["frames"] == SCRATCH_FRAMES and res["launches"] == 0  # the plain matcher
    for r in runs.values():  # the same states: every frame after init tracked
        assert r["init_frame"] == INIT_FRAME and r["tracked_share"] == 1.0
        assert r["frames_after_init"] == SCRATCH_FRAMES - INIT_FRAME - 1
        assert r["ate_m"] < 0.45
    assert runs["host"]["keyframes"] == runs["deferred"]["keyframes"] \
        == runs["fused"]["keyframes"] >= 4
    assert runs["host"]["inliers"] == runs["fused"]["inliers"]
    # deferred: the warm-up frame, then every count one frame late
    assert runs["deferred"]["inliers"] == ([CFG.tracking.min_inliers_local_map]
                                           + runs["fused"]["inliers"][:-1])


def test_multimapper_without_fused_takes_no_chunk(monkeypatch):
    """The MultiMapper's chunk driver, ``use_fused`` off: every frame of a
    span takes the per-frame host path, none is dispatched as a chunk."""
    from orbslamm_tpu_torch.models.multimap import MultiMapper

    def no_chunk(*a, **k):
        raise AssertionError("a chunk was dispatched")

    monkeypatch.setattr(RobotTracker, "_dispatch_chunk", no_chunk)
    mm = MultiMapper(CFG, device="cpu")
    t = mm.add_robot("r0")
    t.use_fused = False
    n = 16
    recs = mm.process_frames(0, list(SEQ.images[:n]), SEQ.timestamps[:n])
    first_ok = [r.state for r in recs].index("OK")
    assert first_ok <= INIT_FRAME and len(t.frames) == n
    assert all(r.state == "OK" for r in recs[first_ok:])
    assert t.mapctx.n_kf >= 3
    mm.robots[0].use_fused = True  # the same span, fused, would chunk
    with pytest.raises(AssertionError, match="chunk"):
        mm.process_frames(0, list(SEQ.images[n:N_FRAMES]), SEQ.timestamps[n:N_FRAMES])


def test_defer_sync_after_a_loss_reads_only_the_new_map(deferred):
    """Shown on both packages: see the module docstring."""
    def after_blank(pkg):
        log = [r for r in deferred[pkg] if r[0] > BLANK]
        lost = next(i for i, r in enumerate(log) if r[1] != "OK")
        init = next(i for i, r in enumerate(log) if i > lost and r[1] == "OK")
        return log, lost, init

    jlog, jlost, jinit = after_blank("jax")
    tlog, tlost, tinit = after_blank("port")
    # both see the loss one frame after the blank and reset the young map
    assert jlog[jlost][0] == tlog[tlost][0] == BLANK + 1
    for pkg, log, lost in (("jax", jlog, jlost), ("port", tlog, tlost)):
        assert log[lost][3] != next(r for r in deferred[pkg] if r[0] == BLANK)[3]
    assert jinit + 1 < len(jlog) and tinit + 1 < len(tlog)
    # JAX: the summary left pending at the loss is still there after the new
    # init; the next frame reads it (a failed frame of the old map) and
    # loses the new map at once
    stale = jlog[jlost][5]
    assert stale is not None and jlog[jinit + 1][4] is stale
    assert not bool(np.asarray(stale.tracking_ok))
    assert jlog[jinit + 1][1] != "OK" and jlog[jinit + 1][3] != jlog[jinit][3]
    # the port: nothing pending after the reset; the first frame after the
    # new init reads nothing and records the new map's pose
    assert tlog[tlost][5] is None and tlog[tinit + 1][4] is None
    first, init = tlog[tinit + 1], tlog[tinit]
    assert first[1] == "OK" and first[3] == init[3]
    assert first[6] == CFG.tracking.min_inliers_local_map
    assert np.array_equal(first[7], init[7])
    assert first[5] is not None  # the frame's own summary, read at the next frame


def test_defer_sync_after_a_relocalization_reads_only_the_new_pose(relocalized):
    """Shown on both packages: see the module docstring."""
    def after_blank(pkg):
        log = [r for r in relocalized[pkg] if r[0] > BLANK]
        lost = next(i for i, r in enumerate(log) if r[1] != "OK")
        reloc = next(i for i, r in enumerate(log) if i > lost and r[1] == "OK")
        return log, lost, reloc

    jlog, jlost, jreloc = after_blank("jax")
    tlog, tlost, treloc = after_blank("port")
    assert jlog[jlost][0] == tlog[tlost][0] == BLANK + 1
    blank_map = next(r for r in relocalized["port"] if r[0] == BLANK)[3]
    # the map is kept (grown): every record after the blank is on it
    assert all(r[3] == blank_map for r in tlog[:treloc + 2])
    assert jreloc + 1 < len(jlog) and treloc + 1 < len(tlog)
    # JAX: the summary pending at the loss (a failed frame) survives the
    # relocalization; the next frame reads it and is lost again
    stale = jlog[jlost][5]
    assert stale is not None and not bool(np.asarray(stale.tracking_ok))
    assert jlog[jreloc][5] is stale and jlog[jreloc + 1][4] is stale
    assert jlog[jreloc + 1][1] != "OK"
    # the port: the relocalization drops it; the next frame reads nothing
    # and records the relocalized pose with the warm-up count
    assert tlog[treloc][4] is not None and tlog[treloc][5] is None
    first, reloc = tlog[treloc + 1], tlog[treloc]
    assert first[4] is None and first[1] == "OK"
    assert first[6] == CFG.tracking.min_inliers_local_map
    assert np.array_equal(first[7], reloc[7])


def _centre(T):
    T = np.asarray(T, np.float64)
    return -T[:3, :3].T @ T[:3, 3]


def test_defer_sync_after_a_merge_records_the_merged_world():
    """The port alone: see the module docstring."""
    from orbslamm_tpu_torch.models.multimap import MultiMapper

    mm = MultiMapper(GROWN, device="cpu")
    r0, r1 = mm.add_robot("r0"), mm.add_robot("r1")
    r1.defer_sync = True
    for k in range(MERGE_END):
        mm.process_frame(0, SEQ.images[k], float(SEQ.timestamps[k]))
    assert r0.state == TrackingState.OK and r0.mapctx.n_kf >= 4
    base = r0.mapctx.map_id
    adopted = []
    adopt = r1.adopt_merged_map

    def spy(*args):  # the summary pending when the merge is adopted
        adopted.append((r1.frame_id, r1._pending))
        adopt(*args)

    r1.adopt_merged_map = spy
    recs = [mm.process_frame(1, SEQ.images[k], float(SEQ.timestamps[k]))
            for k in range(MERGE_B0, MERGE_END)]
    assert mm.merges and mm.merges[0][1] == base and len(adopted) == 1
    fid, stale = adopted[0]
    assert stale is not None and r1.mapctx.map_id == base
    # the merge frame's record and the next (which reads nothing): on the
    # base map, no reference keyframe of the absorbed map's numbering, the
    # adopted pose; the frame after them reads a summary of the merged map
    merge_rec, first = recs[fid], recs[fid + 1]
    assert first.state == "OK" and first.map_id == base and first.ref_slot == -1
    assert first.n_inliers == GROWN.tracking.min_inliers_local_map
    assert merge_rec.map_id == base and merge_rec.ref_slot == -1
    assert np.array_equal(first.T_cw, merge_rec.T_cw)
    # the next record reads the merged map's first summary: one frame on
    # from the adopted pose, where the dropped summary (the same frame as
    # the adopted pose, in r1's old world) lies farther off
    nxt = recs[fid + 2]
    assert nxt.state == "OK" and nxt.map_id == base and nxt.ref_slot >= 0
    step = np.linalg.norm(_centre(first.T_cw) - _centre(nxt.T_cw))
    assert step < MERGE_TOL
    assert np.linalg.norm(_centre(np.asarray(stale.T_cw)) - _centre(nxt.T_cw)) > 3 * MERGE_TOL
    assert all(r.state == "OK" and r.map_id == base for r in recs[fid + 2:])
