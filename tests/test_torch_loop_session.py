"""Session-level parity of the port with a vocabulary: the with_bow chunk
step on a map and tracking state the JAX package built, then the port's
MonocularSession alone on the CPU.

Tolerances:
  * with_bow chunk (JAX's features injected into the port's chunk, so both
    extract nothing of their own): per frame ``tracking_ok`` and ``new_kf``
    equal; ``loop_scores`` and ``loop_min_score`` within 1e-5 (L1 sums over
    10^4 words in another order); the new keyframes' database rows within
    1e-6;
  * the port-only session: see its test.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslamm_tpu.io.synthetic import make_sequence
from orbslamm_tpu.models import fused as jfused
from orbslamm_tpu.models.system import MonocularSession as JaxSession
from orbslamm_tpu.utils.config import (
    CameraConfig, CapacityConfig, OrbConfig, SlamConfig, TrackingConfig,
)
from orbslamm_tpu_torch import convert
from orbslamm_tpu_torch.models import fused as tfused

torch.set_num_threads(2)

VOCAB = Path(__file__).resolve().parents[1] / "orbslamm_tpu" / "data" / "vocab_10x4.npz"
CAM = CameraConfig(width=320, height=240, fx=260, fy=260, cx=160, cy=120, fps=30)
CFG = SlamConfig(
    camera=CAM,
    orb=OrbConfig(n_features=400, max_keypoints=1024, n_levels=4),
    capacity=CapacityConfig(max_keyframes=64, max_landmarks=4096),
    tracking=TrackingConfig(pixel_noise=1.2, min_matches_init=55,
                            init_min_triangulated=30, init_min_parallax_deg=0.4),
    vocabulary_path=str(VOCAB),
)


def _np(tree):
    return jax.tree.map(np.array, tree)


def test_with_bow_chunk_matches_jax():
    """A JAX session (vocabulary loaded, loop closing on) bootstraps on the
    strafe sequence; then 8 frames go through the JAX package's with_bow
    frame body and through the port's with_bow chunk step, from the same
    converted state, database and features."""
    seq = make_sequence(n_frames=60, n_points=900, cam=CAM, seed=7, motion="strafe")
    sess = JaxSession(CFG)
    i = 0
    while i < 30 and not (sess.state.name == "OK" and sess.n_kf >= 4):
        sess.process_frame(seq.images[i], float(seq.timestamps[i]))
        i += 1
    assert sess.state.name == "OK" and sess.n_kf >= 4, "JAX bootstrap failed"
    tracker = sess.tracker
    tracker._sync_from_ts()
    ts_j = tracker._make_ts()
    mc = tracker.mapctx
    state = dict(map=_np(sess.map), ts=_np(ts_j), kf_bow=np.array(mc.kf_bow))

    feats_j = [tracker.extract(jnp.asarray(seq.images[j])) for j in range(i, i + 8)]
    body = jax.jit(functools.partial(jfused._make_frame_body(CFG, tracker.extract, with_bow=True),
                                     K=tracker.K))
    m_j, bow_j = sess.map, mc.kf_bow
    want = []
    for k, j in enumerate(range(i, i + 8)):
        m_j, ts_j, bow_j, s = body(m_j, ts_j, bow_j, mc.voc, feats_j[k], jnp.int32(j),
                                   jnp.float32(seq.timestamps[j]))
        want.append(jax.device_get(s))

    voc_t = convert.vocabulary_from_numpy(_np(mc.voc), device="cpu")
    feats_t = [convert.features_from_numpy(_np(f), device="cpu") for f in feats_j]
    chunk = tfused.make_chunk_step(CFG, lambda k: feats_t[k], torch.as_tensor(np.asarray(tracker.K)),
                                   with_bow=True)
    m_t, ts_t, bow_t, st = chunk(
        convert.map_state_from_numpy(state["map"], device="cpu"),
        convert.track_state_from_numpy(state["ts"], device="cpu"),
        convert.kf_bow_from_numpy(state["kf_bow"], device="cpu"), voc_t, list(range(8)),
        list(range(i, i + 8)), [float(t) for t in np.asarray(seq.timestamps[i:i + 8], np.float32)])
    assert st.tracking_ok.tolist() == [bool(s.tracking_ok) for s in want]
    assert st.new_kf.tolist() == [bool(s.new_kf) for s in want]
    assert any(bool(s.new_kf) for s in want)
    ls_j = np.stack([s.loop_scores for s in want])
    np.testing.assert_allclose(st.loop_scores.numpy(), ls_j, atol=1e-5)
    np.testing.assert_allclose(st.loop_min_score.numpy(),
                               np.array([s.loop_min_score for s in want]), atol=1e-5)
    # on the strafe every older keyframe is covisible (scores masked to -1),
    # so the minScore normalizer over the covisible keyframes carries the
    # BoW similarities here; the map-level candidate masks are held in
    # tests/test_torch_loop_closing.py
    for s in want:
        if bool(s.new_kf):
            assert 0.0 < float(s.loop_min_score) < 1.0
            slot = int(s.kf_slot)
            np.testing.assert_allclose(bow_t[slot].numpy(), np.asarray(bow_j[slot]), atol=1e-6)
    assert int(ts_t.n_kf) == int(ts_j.n_kf)
    assert int(m_t.kf_valid.sum()) == int(np.asarray(m_j.kf_valid).sum())


# ---------------------------------------------------------------------------
# The port alone: loop events, relocalization, localization mode
# ---------------------------------------------------------------------------

N_FRAMES, LOOP_AT, RELOC_FRAME = 120, 104, 15


def _revisit_candidates(cfg, m, slot, k=5):
    """The ``k`` keyframes older than the loop gap that share the most
    landmarks with keyframe ``slot`` (chip_smoke.py drives its loop path's
    events the same way)."""
    from orbslamm_tpu_torch.models import map_state as ms
    from orbslamm_tpu_torch.ops.matching import _top_k

    w = ms.covisibility(m)[slot]
    ok = m.kf_valid & (torch.arange(w.shape[0]) < slot - cfg.loop.kfs_between_loops + 1)
    vals, idx = _top_k(torch.where(ok, w, torch.full_like(w, -1)), k)
    return [int(i) for v, i in zip(vals.tolist(), idx.tolist()) if v > 0]


def _np_pose(T):
    return T.detach().cpu().numpy().astype(np.float64)


@pytest.fixture(scope="module")
def port_run():
    """The port's MonocularSession on the CPU at tests/test_trajectory.py's
    size (320x240, 600 features, outback seed 14, vocabulary on): stream to
    LOOP_AT, close the loop at the revisit (the return leg re-associates the
    outbound landmarks, so the detection scan, which excludes covisible
    keyframes, finds no candidate in either package; the revisit keyframes
    sharing the most landmarks go to ``verify_and_correct_loop`` and the
    tracking state is rebased, as after a loop detected in a chunk;
    tests/test_torch_loop_closing.py holds detection itself against the
    JAX package), stream the rest
    (overlapped global-BA slices at chunk boundaries), lose tracking on
    three blank frames and come back on outbound frames; then localization
    mode over the return leg again."""
    from orbslamm_tpu_torch.models.system import MonocularSession, resolve_frame_poses
    from orbslamm_tpu_torch.ops.geometry import T_inv

    cfg = CFG.replace(orb=OrbConfig(n_features=600, max_keypoints=1024, n_levels=4))
    seq = make_sequence(n_frames=N_FRAMES, n_points=1600, cam=CAM, seed=14, motion="outback")
    sess = MonocularSession(cfg, device="cpu")
    mc = sess.tracker.mapctx
    out = {"seq": seq, "sess": sess}
    sess.process_frames(seq.images[:LOOP_AT], seq.timestamps[:LOOP_AT])
    pre = [f for f in sess.frames if f.state == "OK"]
    out["pre"], out["pre_resolved"] = pre, np.stack(resolve_frame_poses(pre))
    slot = mc.n_kf - 1
    out["cands"] = _revisit_candidates(cfg, mc.map, slot)
    # the camera relative to the loop keyframe, before and after the
    # correction (the tracking state rides the corrected keyframe). The
    # relative pose takes the rigid inverse, as the rebase does: in both
    # packages tracked poses drift off SO(3) by a few 1e-2
    tr = sess.tracker
    rel = lambda: [_np_pose(T @ T_inv(mc.map.kf_pose[slot]))  # noqa: E731
                   for T in (tr.T_cw, tr._ts.T_cw, tr._ts.last_T)]
    assert tr._ts is not None  # the chunk path's device state is live
    out["rel_before"] = rel()
    pose_before = mc.map.kf_pose[slot].clone()
    out["closed"] = mc.verify_and_correct_loop(slot, out["cands"], tr.generator)
    if out["closed"]:
        tr._rebase_after_loop(pose_before, mc.map.kf_pose[slot])
    out["rel_after"] = rel()
    sess.process_frames(seq.images[LOOP_AT:], seq.timestamps[LOOP_AT:])
    out["loops"], out["gba"] = list(sess.loops_closed), mc.gba_slices_run
    out["streamed"] = list(sess.frames)
    t = float(seq.timestamps[-1])
    reloc = [sess.process_frame(np.zeros_like(seq.images[0]), t + k / 30).state for k in (1, 2, 3)]
    for k in range(3):
        rec = sess.process_frame(seq.images[RELOC_FRAME + k], t + (4 + k) / 30)
        reloc.append(rec.state)
        if rec.state == "OK":
            break
    out["reloc"] = reloc
    n_kf, kv = mc.n_kf, mc.map.kf_valid.clone()
    sess.activate_localization_mode()
    loc = sess.process_frames(seq.images[RELOC_FRAME + 3:RELOC_FRAME + 27],
                              seq.timestamps[RELOC_FRAME + 3:RELOC_FRAME + 27] + t)
    out["loc"] = dict(states=[r.state for r in loc], n_kf=(n_kf, mc.n_kf),
                      kf_valid_same=bool(torch.equal(kv, mc.map.kf_valid)))
    return out


def test_port_session_closes_loop(port_run):
    """The loop verifies and corrects, the overlapped global BA runs at the
    chunk boundaries after it (>= 2 slices with the immediate one), >= 90 %
    of the frames track, and frames recorded before the loop ride the
    corrected keyframes (resolve_frame_poses)."""
    from orbslamm_tpu_torch.models.system import resolve_frame_poses

    r = port_run
    assert r["closed"] and len(r["loops"]) == 1, (r["cands"], r["loops"])
    # the correction moves the camera with the loop keyframe; float32
    # products of three poses, so 1e-4
    np.testing.assert_allclose(r["rel_after"], r["rel_before"], atol=1e-4)
    assert r["gba"] >= 2
    frames = r["streamed"]
    assert sum(f.state == "OK" for f in frames) >= 0.9 * N_FRAMES
    moved = np.abs(np.stack(resolve_frame_poses(r["pre"])) - r["pre_resolved"]).max(axis=(1, 2))
    assert (moved > 1e-5).any(), "pre-loop frames did not ride the correction"


def test_port_session_relocalizes(port_run):
    """Three blank frames lose tracking (the map is not young, so no reset);
    an outbound frame relocalizes within 3 frames."""
    reloc = port_run["reloc"]
    assert reloc[:3] == ["LOST"] * 3 and reloc[-1] == "OK" and len(reloc) <= 6, reloc


def test_localization_mode_inserts_no_keyframes(port_run):
    """Localization mode over 24 more frames through the chunk path: the
    frames track, no keyframe is inserted, keyframe validity unchanged."""
    loc = port_run["loc"]
    assert loc["n_kf"][0] == loc["n_kf"][1]
    assert loc["kf_valid_same"]
    assert loc["states"].count("OK") >= 20, loc["states"]
