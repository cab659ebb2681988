"""The port's map renderings (orbslamm_tpu_torch/io/viz.py) and live viewer
(orbslamm_tpu_torch/io/viewer.py) against the JAX package's, on the CPU.

  * ``viz.map_arrays``, what ``draw_map`` draws, on one map built in both
    packages by ``fabricate_map`` from one seed (a keyframe slot left
    invalid): the landmarks and the covisibility edges (JAX's
    ``ms.covisibility``, weight >= 30 between valid keyframes) equal, the
    keyframe and trajectory centres within 1e-5; the PNGs decode;
  * the viewer on tests/test_viewer.py's scenario: ``/state`` equal, field
    by field, to the JAX viewer's ``_state_json`` of the same MultiMapper,
    ``/map.png``, ``/`` and both toggles;
  * a localization toggle posted while ``run_robots`` runs in another
    thread lands between spans and the run ends whole.
"""

import io
import json
import socket
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslamm_tpu.io import synthetic as jsyn
from orbslamm_tpu.io import viz as jviz
from orbslamm_tpu.io.viewer import LiveViewer as JLiveViewer
from orbslamm_tpu.models import map_state as jms
from orbslamm_tpu_torch.io import synthetic as tsyn
from orbslamm_tpu_torch.io import viz
from orbslamm_tpu_torch.io.viewer import LiveViewer
from orbslamm_tpu_torch.utils import config as tc

torch.set_num_threads(2)
PIL_Image = pytest.importorskip("PIL.Image")

PNG = b"\x89PNG\r\n\x1a\n"
# tests/test_viewer.py's configuration
CAM = tc.CameraConfig(width=320, height=240, fx=260, fy=260, cx=160, cy=120, fps=30)
CFG = tc.SlamConfig(
    camera=CAM,
    orb=tc.OrbConfig(n_features=400, max_keypoints=1024, n_levels=4),
    capacity=tc.CapacityConfig(max_keyframes=64, max_landmarks=4096),
    tracking=tc.TrackingConfig(pixel_noise=1.2, min_matches_init=55, init_min_triangulated=30,
                               init_min_parallax_deg=0.4),
)
N_FRAMES = 16


def _maps(seed=3, n_kf=6, n_pts=400):
    """One map from both packages' fabricate_map: keyframes along x and z,
    each seeing a window of the points and a random 15 % of the rest, so
    neighbours share more than 30 landmarks and others fewer; slot 2
    invalid."""
    rng = np.random.default_rng(seed)
    T = np.tile(np.eye(4, dtype=np.float32), (n_kf, 1, 1))
    T[:, 0, 3] = 0.3 * np.arange(n_kf)
    T[:, 2, 3] = -0.4 * np.arange(n_kf)
    pts = rng.uniform(-3, 3, (n_pts, 3)).astype(np.float32)
    pts[:, 2] += 8
    desc = rng.integers(0, 256, (n_pts, 32), dtype=np.uint8)
    col = np.arange(n_pts)[None, :]
    lo = 60 * np.arange(n_kf)[:, None]
    mask = ((col >= lo) & (col < lo + 120)) | (rng.random((n_kf, n_pts)) < 0.15)
    m_j = jsyn.fabricate_map(CFG, T, pts, desc, seed=seed, kf_point_mask=mask)[0]
    m_t = tsyn.fabricate_map(CFG, T, pts, desc, seed=seed, kf_point_mask=mask, device="cpu")[0]
    kv = np.asarray(m_j.kf_valid).copy()
    kv[2] = False
    m_j = m_j._replace(kf_valid=jnp.asarray(kv))
    m_t = m_t._replace(kf_valid=torch.as_tensor(kv))
    return m_j, m_t, T


def test_map_arrays_match_jax(tmp_path):
    m_j, m_t, T = _maps()
    traj = T[::-1].copy()  # a frame trajectory: the keyframe poses in reverse
    got = viz.map_arrays(m_t, trajectory=traj)
    # what the JAX package's draw_map plots, from its own map and covisibility
    kv, lv = np.asarray(m_j.kf_valid), np.asarray(m_j.lm_valid)
    want_pts = np.asarray(m_j.lm_pos)[lv]
    want_C = jviz._centers(np.asarray(m_j.kf_pose)[kv])
    W = np.asarray(jms.covisibility(m_j))
    idx = np.nonzero(kv)[0]
    want_edges = [(a, b) for a in range(len(idx)) for b in range(a + 1, len(idx))
                  if W[idx[a], idx[b]] >= 30]
    assert np.array_equal(got.landmarks_xz, want_pts[:, [0, 2]])
    np.testing.assert_allclose(got.centers, want_C, rtol=0, atol=1e-5)
    assert [tuple(e) for e in got.edges.tolist()] == want_edges
    assert 0 < len(want_edges) < len(idx) * (len(idx) - 1) // 2  # some pairs fall below 30
    np.testing.assert_allclose(got.trajectory, jviz._centers(traj), rtol=0, atol=1e-5)
    assert (got.n_kf, got.n_lm) == (int(kv.sum()), int(lv.sum())) == (5, len(want_pts))
    assert len(viz.map_arrays(m_t, show_covisibility=False).edges) == 0

    viz.draw_map(m_t, tmp_path / "map.png", trajectory=traj, title="map 0")
    img = PIL_Image.open(tmp_path / "map.png")
    assert (tmp_path / "map.png").read_bytes()[:8] == PNG and img.size == viz.MAP_SIZE
    colors = {tuple(c) for c in np.asarray(img.convert("RGB")).reshape(-1, 3).tolist()}
    assert {(255, 255, 255), viz._GREY, viz._KF, viz._TRAJ} <= colors


def test_draw_frame_writes_a_png(tmp_path):
    from orbslamm_tpu_torch.ops.orb import make_extractor

    seq = tsyn.make_sequence(n_frames=2, n_points=900, cam=CAM, seed=7, motion="forward")
    feats = make_extractor(CFG.orb, CAM, device="cpu")(torch.as_tensor(seq.images[0]))
    lm = torch.where(torch.arange(CFG.orb.max_keypoints) % 2 == 0, 5, -1)
    for status in ("", "TRACKING 12 inliers"):
        viz.draw_frame(seq.images[0], feats, lm, tmp_path / "frame.png", status=status)
        img = PIL_Image.open(tmp_path / "frame.png")
        assert img.format == "PNG" and img.size == (CAM.width, CAM.height + 20)
    viz.draw_frame(seq.images[0], feats, None, tmp_path / "free.png")
    assert (tmp_path / "free.png").read_bytes()[:8] == PNG


@pytest.fixture(scope="module")
def mapper():
    """tests/test_viewer.py's scenario on the port: 16 forward frames, one
    robot, frame by frame."""
    from orbslamm_tpu_torch.models.multimap import MultiMapper
    from orbslamm_tpu_torch.models.system import TrackingState

    seq = tsyn.make_sequence(n_frames=N_FRAMES, n_points=900, cam=CAM, seed=7, motion="forward")
    mm = MultiMapper(CFG, device="cpu")
    mm.add_robot("r0")
    for i in range(N_FRAMES):
        mm.process_frame(0, seq.images[i], float(seq.timestamps[i]))
    assert mm.robots[0].state == TrackingState.OK
    return mm


def _get(url):
    return urllib.request.urlopen(url, timeout=60).read()


def _post(url):
    return urllib.request.urlopen(urllib.request.Request(url, method="POST"), timeout=60).status


def test_live_viewer_serves_the_jax_state_and_toggles(mapper):
    mm = mapper
    viewer = LiveViewer(mm, port=0).start()
    try:
        base = f"http://127.0.0.1:{viewer.port}"
        state = json.loads(_get(f"{base}/state"))
        want = json.loads(JLiveViewer(mm, port=0)._state_json())
        assert sorted(state) == sorted(want) == ["maps", "merges", "robots"]
        for key in want:
            assert len(state[key]) == len(want[key]), key
            for got_row, want_row in zip(state[key], want[key]):
                assert got_row == want_row, key
        assert state["robots"][0]["state"] == "OK" and state["robots"][0]["frames"] == N_FRAMES
        assert state["maps"][0]["n_kf"] >= 2
        png = _get(f"{base}/map.png")
        assert png[:8] == PNG
        assert PIL_Image.open(io.BytesIO(png)).size == viz.MAP_SIZE
        assert b"orbslamm_tpu" in _get(f"{base}/")
        assert _post(f"{base}/localization/on") == 200 and mm.robots[0].localization_only
        assert _post(f"{base}/localization/off") == 200 and not mm.robots[0].localization_only
        assert _post(f"{base}/multimapping/off") == 200
        assert not mm.multi_mapping_enabled and mm.robots[0].reloc_on_loss
        assert _post(f"{base}/multimapping/on") == 200
        assert mm.multi_mapping_enabled and not mm.robots[0].reloc_on_loss
        with pytest.raises(urllib.error.HTTPError):
            _post(f"{base}/nothing")
    finally:
        viewer.stop()
    with pytest.raises(urllib.error.URLError):
        _get(f"{base}/state")


def test_viewer_under_concurrent_requests_and_spans(mapper, monkeypatch):
    """More client threads than cores and a short switch interval, while a
    driver thread runs spans: every request is answered, every toggle
    lands outside a span, and the spans all run."""
    import os
    import sys

    viewer = LiveViewer(mapper, port=0).start()
    base = f"http://127.0.0.1:{viewer.port}"
    n_threads, per, n_spans = 2 * (os.cpu_count() or 4), 3, 40
    inside, toggled_inside, errors, answers = [False], [], [], []
    toggle = LiveViewer.set_localization

    def set_localization(v, on):
        toggled_inside.append(inside[0])
        toggle(v, on)

    monkeypatch.setattr(LiveViewer, "set_localization", set_localization)

    def driver():
        for _ in range(n_spans):
            with viewer.span():
                inside[0] = True
                threading.Event().wait(0.002)
                inside[0] = False

    def client(k):
        for i in range(per):
            try:
                if (k + i) % 3 == 0:
                    answers.append(_post(f"{base}/localization/{'on' if i % 2 else 'off'}"))
                else:
                    answers.append(json.loads(_get(f"{base}/state"))["robots"][0]["name"])
            except Exception as e:  # noqa: BLE001 — collected and asserted below
                errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=driver)]
        threads += [threading.Thread(target=client, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        assert len(answers) == n_threads * per and set(answers) == {200, "r0"}
        assert toggled_inside and not any(toggled_inside)
    finally:
        sys.setswitchinterval(old)
        viewer.stop()
        mapper.robots[0].localization_only = False


def test_localization_toggle_during_run_robots(tmp_path, monkeypatch):
    """``run_robots(viewer_port=...)`` in another thread, three spans of 8
    frames: a POST of /localization/on sent as the second span's frames are
    pulled waits for the viewer's lock, lands between spans, and the run
    ends with every frame recorded, no keyframe after the toggle, and its
    outputs written; /state answers while it runs."""
    from orbslamm_tpu_torch.driver import RobotFeed, run_robots
    from orbslamm_tpu_torch.utils.trace import get_tracer

    n = 24
    seq = tsyn.make_sequence(n_frames=n, n_points=900, cam=CAM, seed=7, motion="forward")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    pulled = threading.Event()

    def feed():
        for k in range(n):
            if k == 8:
                pulled.set()
            yield seq.timestamps[k], seq.images[k]

    out, err, toggled_at = {}, [], []
    toggle = LiveViewer.set_localization

    def set_localization(viewer, on):  # the frames recorded when the toggle lands
        toggled_at.append(len(viewer.mm.robots[0].frames))
        toggle(viewer, on)

    monkeypatch.setattr(LiveViewer, "set_localization", set_localization)

    def run():
        try:
            out["mm"], out["report"] = run_robots(
                CFG, [RobotFeed(feed(), "r0")], out_dir=tmp_path / "out", verbose=False,
                span_chunks=1, viewer_port=port, device="cpu")
        except BaseException as e:  # noqa: BLE001 — reported below
            err.append(e)

    th = threading.Thread(target=run)
    th.start()
    assert pulled.wait(120)
    base = f"http://127.0.0.1:{port}"
    assert _post(f"{base}/localization/on") == 200
    assert json.loads(_get(f"{base}/state"))["robots"][0]["name"] == "r0"
    th.join(300)
    assert not th.is_alive() and not err, err
    mm = out["mm"]
    t = mm.robots[0]
    assert t.localization_only and len(t.frames) == n
    # the toggle came between two spans of 8 frames, and no keyframe after it
    assert toggled_at in ([8], [16]), toggled_at
    kf_frames = [e["frame_id"] for e in get_tracer().events() if e["kind"] == "keyframe"]
    assert kf_frames and max(kf_frames) < toggled_at[0]
    assert out["report"].states["r0"].count("OK") >= n - 4
    for mc in mm.live_maps():
        assert (tmp_path / "out" / f"map{mc.map_id}.png").read_bytes()[:8] == PNG
    with pytest.raises(urllib.error.URLError):  # the run stopped its viewer
        _get(f"{base}/state")
