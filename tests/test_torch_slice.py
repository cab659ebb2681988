"""Slice parity: the port's tracking, keyframe mapping and fused chunk step,
run on a map and tracking state that the JAX package built.

A JAX ``MonocularSession`` (320x240, 400 features, 4 levels, 64 keyframes,
4096 landmarks; strafe motion, loop closing off) is bootstrapped once per
module, and its map and TrackState are carried across with
``orbslamm_tpu_torch.convert``. Tolerances:
  * tracking: n_inliers within +-2, per-feature landmark ids >= 99% equal,
    T_cw <= 1e-3 — float32 LM solves reduce in another order, which can move
    a borderline chi2 gate by one or two observations;
  * keyframe mapping: valid-landmark count within +-2% (triangulation
    gates and culls sit on float thresholds), keyframe validity exact;
  * one 8-frame chunk: tracking_ok and new_kf equal per frame — the port
    extracts its own features (level 0 bit-exact, other levels >= 98%);
  * a port-only session from scratch: initializes, ATE < 0.45 m (the bound
    of tests/test_slam_e2e.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslamm_tpu.eval.ate import ate_from_poses
from orbslamm_tpu.io.synthetic import make_sequence
from orbslamm_tpu.models import local_mapping as jlm
from orbslamm_tpu.models import map_state as jms
from orbslamm_tpu.models import tracking as jtrk
from orbslamm_tpu.models.system import MonocularSession as JaxSession
from orbslamm_tpu.utils.config import (
    CameraConfig, CapacityConfig, OrbConfig, SlamConfig, TrackingConfig,
)
from orbslamm_tpu_torch import convert
from orbslamm_tpu_torch.models import fused as tfused
from orbslamm_tpu_torch.models import local_mapping as tlm
from orbslamm_tpu_torch.models import map_state as tms
from orbslamm_tpu_torch.models import tracking as ttrk
from orbslamm_tpu_torch.models.system import MonocularSession as TorchSession
from orbslamm_tpu_torch.ops import orb as torb

torch.set_num_threads(2)

CAM = CameraConfig(width=320, height=240, fx=260, fy=260, cx=160, cy=120, fps=30)
CFG = SlamConfig(
    camera=CAM,
    orb=OrbConfig(n_features=400, max_keypoints=1024, n_levels=4),
    capacity=CapacityConfig(max_keyframes=64, max_landmarks=4096),
    tracking=TrackingConfig(pixel_noise=1.2, min_matches_init=55,
                            init_min_triangulated=30, init_min_parallax_deg=0.4),
)


def _np(tree):
    return jax.tree.map(np.array, tree)


@pytest.fixture(scope="module")
def boot():
    seq = make_sequence(n_frames=60, n_points=900, cam=CAM, seed=7, motion="strafe")
    sess = JaxSession(CFG)
    sess.enable_loop_closing = False
    i, streak = 0, 0
    while streak < 3 and i < 28:
        r = sess.process_frame(seq.images[i], float(seq.timestamps[i]))
        streak = streak + 1 if r.state == "OK" else 0
        i += 1
    assert sess.state.name == "OK", "JAX bootstrap failed"
    tracker = sess.tracker
    tracker._sync_from_ts()
    ts = tracker._make_ts()
    return dict(seq=seq, sess=sess, i=i, map=_np(sess.map), ts=_np(ts), jts=ts,
                K=np.asarray(CFG.camera.K()))


def _track_both(boot):
    """Motion model + local map on frame i, JAX and port, from the same
    features (the JAX extractor's, converted)."""
    seq, i, m_np, ts_np = boot["seq"], boot["i"], boot["map"], boot["ts"]
    sess = boot["sess"]
    K = jnp.asarray(boot["K"])
    m_j = jms.MapState(**{k: jnp.asarray(v) for k, v in m_np._asdict().items()})
    ts_j = boot["jts"]
    feats_j = sess.tracker.extract(jnp.asarray(seq.images[i]))
    T_pred = ts_j.velocity @ ts_j.last_T
    r1j = jtrk.track_motion_model(CFG, m_j, feats_j, T_pred, K, ts_j.last_feats,
                                  ts_j.last_lm, T_last=ts_j.last_T)
    r2j, mj2 = jtrk.track_local_map(CFG, m_j, feats_j, r1j.T_cw, K, r1j.feat_lm)

    m_t = convert.map_state_from_numpy(m_np, device="cpu")
    ts_t = convert.track_state_from_numpy(ts_np, device="cpu")
    feats_t = convert.features_from_numpy(_np(feats_j), device="cpu")
    Kt = torch.as_tensor(boot["K"])
    r1t = ttrk.track_motion_model(CFG, m_t, feats_t, ts_t.velocity @ ts_t.last_T, Kt,
                                  ts_t.last_feats, ts_t.last_lm, T_last=ts_t.last_T)
    r2t, mt2 = ttrk.track_local_map(CFG, m_t, feats_t, r1t.T_cw, Kt, r1t.feat_lm)
    return (r1j, r2j, mj2, feats_j), (r1t, r2t, mt2, feats_t)


def _assert_track_close(rt, rj):
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= 2
    assert (rt.feat_lm.numpy() == np.asarray(rj.feat_lm)).mean() >= 0.99
    np.testing.assert_allclose(rt.T_cw.numpy(), np.asarray(rj.T_cw), rtol=0, atol=1e-3)


def test_track_motion_model_and_local_map(boot):
    (r1j, r2j, mj2, _), (r1t, r2t, mt2, _) = _track_both(boot)
    assert int(r1j.n_inliers) >= CFG.tracking.min_inliers_track
    _assert_track_close(r1t, r1j)
    _assert_track_close(r2t, r2j)
    assert int(r2j.n_inliers) >= CFG.tracking.min_inliers_local_map
    # visible/found counters are integers: exact when the associations agree
    if np.array_equal(r2t.feat_lm.numpy(), np.asarray(r2j.feat_lm)):
        assert np.array_equal(mt2.lm_visible.numpy(), np.asarray(mj2.lm_visible))
        assert np.array_equal(mt2.lm_found.numpy(), np.asarray(mj2.lm_found))


def test_map_state_queries(boot):
    """Read-only queries on the JAX-built map: integer results exact (0/1
    indicator products sum exactly in float32), keyframe centres <= 1e-5
    relative (one 3x3 product each)."""
    m_np = boot["map"]
    m_j = jms.MapState(**{k: jnp.asarray(v) for k, v in m_np._asdict().items()})
    m_t = convert.map_state_from_numpy(m_np, device="cpu")
    ind_j, ind_t = jms.lm_indicator(m_j), tms.lm_indicator(m_t)
    assert np.array_equal(ind_t.numpy(), np.asarray(ind_j))
    for slot in (0, 1, int(boot["ts"].n_kf) - 1):
        assert np.array_equal(tms.indicator_row(m_t, slot).numpy(),
                              np.asarray(jms.indicator_row(m_j, jnp.int32(slot))))
    W = tms.covisibility(m_t, ind_t).numpy()
    assert W.max() > 0
    assert np.array_equal(W, np.asarray(jms.covisibility(m_j, ind_j)))
    assert np.array_equal(tms.lm_obs_count(m_t, ind_t).numpy(),
                          np.asarray(jms.lm_obs_count(m_j, ind_j)))
    assert np.array_equal(tms.spanning_parent(m_t).numpy(), np.asarray(jms.spanning_parent(m_j)))
    np.testing.assert_allclose(tms.keyframe_centers(m_t).numpy(),
                               np.asarray(jms.keyframe_centers(m_j)), rtol=1e-5, atol=1e-6)
    assert np.array_equal(tms.free_lm_slots(m_t, 256).numpy(),
                          np.asarray(jms.free_lm_slots(m_j, 256)))


def test_process_new_keyframe_cached(boot):
    """Insert frame i as a keyframe (JAX's tracked pose and associations)
    and run the mapping pipeline on both sides."""
    (_, r2j, mj2, feats_j), _ = _track_both(boot)
    slot = int(boot["ts"].n_kf)
    K = jnp.asarray(boot["K"])
    m_in = jms.insert_keyframe(mj2, jnp.int32(slot), r2j.T_cw, K, feats_j, r2j.feat_lm,
                               boot["i"], float(boot["seq"].timestamps[boot["i"]]))
    m_np = _np(m_in)
    ind_np = np.array(jms.lm_indicator(mj2))
    mj, indj = jlm.process_new_keyframe_cached(CFG, m_in, jnp.int32(slot), jnp.asarray(ind_np))
    mt, indt = tlm.process_new_keyframe_cached(
        CFG, convert.map_state_from_numpy(m_np, device="cpu"), slot,
        torch.as_tensor(ind_np))
    n_j = int(np.asarray(mj.lm_valid).sum())
    n_t = int(mt.lm_valid.sum())
    n_before = int(m_np.lm_valid.sum())
    assert n_j != n_before  # the pipeline did create or cull landmarks
    assert abs(n_t - n_j) <= max(1, 0.02 * n_j), (n_t, n_j)
    assert np.array_equal(mt.kf_valid.numpy(), np.asarray(mj.kf_valid))
    # the carried indicator stays consistent with the map it describes
    assert torch.equal(indt, tms.lm_indicator(mt))


def test_fused_chunk_of_eight_frames(boot):
    """One 8-frame chunk from the bootstrapped state: the JAX package's fused
    frame step (the body its chunk scans) against the port's chunk step."""
    seq, i = boot["seq"], boot["i"]
    tracker = boot["sess"].tracker
    m_j = jms.MapState(**{k: jnp.asarray(v) for k, v in boot["map"]._asdict().items()})
    ts_j = boot["jts"]
    ok_j, kf_j = [], []
    for j in range(i, i + 8):
        m_j, ts_j, s = tracker._frame_step(m_j, ts_j, jnp.asarray(seq.images[j]),
                                           jnp.int32(j), jnp.float32(seq.timestamps[j]),
                                           jnp.asarray(True))
        ok_j.append(bool(s.tracking_ok))
        kf_j.append(bool(s.new_kf))
    K = torch.as_tensor(boot["K"])
    chunk = tfused.make_chunk_step(CFG, torb.make_extractor(CFG.orb, CAM, device="cpu"), K)
    m_t, ts_t, st = chunk(convert.map_state_from_numpy(boot["map"], device="cpu"),
                          convert.track_state_from_numpy(boot["ts"], device="cpu"),
                          list(seq.images[i:i + 8]), list(range(i, i + 8)),
                          [float(t) for t in np.asarray(seq.timestamps[i:i + 8], np.float32)])
    assert st.tracking_ok.tolist() == ok_j
    assert st.new_kf.tolist() == kf_j
    assert all(ok_j) and any(kf_j)
    assert int(ts_t.n_kf) == int(ts_j.n_kf)


def test_port_session_from_scratch():
    """The port alone, on the CPU: two-view init frame by frame, then the
    chunk path, on 60 strafe frames."""
    seq = make_sequence(n_frames=60, n_points=900, cam=CAM, seed=7, motion="strafe")
    sess = TorchSession(CFG, device="cpu")
    sess.enable_loop_closing = False
    i = 0
    while sess.state.name != "OK" and i < 30:
        sess.process_frame(seq.images[i], float(seq.timestamps[i]))
        i += 1
    assert sess.state.name == "OK"
    sess.process_frames(seq.images[i:], seq.timestamps[i:])
    ts, est = sess.frame_trajectory()
    assert len(est) > 30
    assert sess.n_kf >= 3
    ate = ate_from_poses(est, seq.poses_cw[[int(round(t * CAM.fps)) for t in ts]])
    assert np.isfinite(ate) and ate < 0.45, ate
    kts, kposes = sess.keyframe_trajectory()
    assert len(kts) == int(sess.map.kf_valid.sum()) and kposes.shape[1:] == (4, 4)
