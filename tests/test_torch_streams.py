"""Parity of the port's robot-parallel bank pieces with the JAX package: the
deferred-mapping chunk, the follower keyframe replay, and the bank's copies.

A JAX ``MonocularSession`` (320x240, 400 features, 4 levels, 64 keyframes,
4096 landmarks; strafe motion, loop closing off) is bootstrapped once per
module and its map and TrackState are carried across with
``orbslamm_tpu_torch.convert``. The JAX package runs its
``make_multistream_chunk_step`` with R = 1 on its CPU backend (one 4-frame
segment per call); both sides track the same features (the JAX extractor's,
converted). Tolerances:
  * per frame, ``tracking_ok``, ``new_kf``, ``kf_slot`` and ``ref_slot``
    exact, the queued events' frame indices and slots exact, and the
    TrackState's ``n_kf`` exact: the keyframe decisions and the queue are
    integer logic on the tracked counts;
  * ``n_inliers`` within +-2 and ``T_cw`` within 1e-3, as in
    tests/test_torch_slice.py: float32 LM solves reduce in another order,
    which can move a borderline chi2 gate by an observation or two;
  * valid landmarks after the chunk within +-2 %: triangulation gates and
    culls sit on float thresholds (tests/test_torch_slice.py);
  * the events' loop scores and minScore within 1e-5: L1 distances of
    float32 BoW rows, summed in another order;
  * the follower replay: ``kf_obs_lm`` after the association filter and
    ``n_kf`` exact (integer bookkeeping on the same fabricated maps, the
    seam fuse held exact in tests/test_torch_multimap.py), BoW rows within
    1e-6 (float32 tf-idf normalisation).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslamm_tpu.io.synthetic import fabricate_map, make_landmark_field, make_sequence
from orbslamm_tpu.models import fused as jfused
from orbslamm_tpu.models import map_state as jms
from orbslamm_tpu.models.system import MonocularSession as JaxSession
from orbslamm_tpu.ops import bow as jbow
from orbslamm_tpu.parallel import streams as jstreams
from orbslamm_tpu.utils.config import (
    CameraConfig, CapacityConfig, OrbConfig, SlamConfig, TrackingConfig,
)
from orbslamm_tpu_torch import convert
from orbslamm_tpu_torch.io import synthetic as tsynthetic
from orbslamm_tpu_torch.models import map_state as tms
from orbslamm_tpu_torch.models.system import MapContext, RobotTracker
from orbslamm_tpu_torch.ops import bow as tbow
from orbslamm_tpu_torch.parallel import streams as tstreams

torch.set_num_threads(2)

CAM = CameraConfig(width=320, height=240, fx=260, fy=260, cx=160, cy=120, fps=30)
CFG = SlamConfig(
    camera=CAM,
    orb=OrbConfig(n_features=400, max_keypoints=1024, n_levels=4),
    capacity=CapacityConfig(max_keyframes=64, max_landmarks=4096),
    tracking=TrackingConfig(pixel_noise=1.2, min_matches_init=55,
                            init_min_triangulated=30, init_min_parallax_deg=0.4),
)
VOCAB = Path(__file__).resolve().parents[1] / "orbslamm_tpu" / "data" / "vocab_10x4.npz"
CHUNK = 8


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
    # a few more frames map keyframes: right after the two-view init the
    # map holds about 45 landmarks, and a chunk that maps its keyframes only
    # at segment ends loses them by its second frame (in both packages)
    for _ in range(8):
        sess.process_frame(seq.images[i], float(seq.timestamps[i]))
        i += 1
    assert sess.state.name == "OK", "JAX bootstrap failed"
    tracker = sess.tracker
    tracker._sync_from_ts()
    ts = tracker._make_ts()
    images = jnp.asarray(np.stack(seq.images[i:i + CHUNK]))
    feats = [_np(tracker.extract(img))._asdict() for img in images]
    m_np = _np(sess.map)
    voc_t = tbow.load_vocabulary_npz(VOCAB, device="cpu")
    kf_bow = tbow.update_bow_rows(
        voc_t, torch.as_tensor(m_np.kf_desc), torch.as_tensor(m_np.kf_feat_valid),
        torch.zeros((CFG.capacity.max_keyframes, voc_t.n_words)),
        list(range(int(ts.n_kf)))).numpy()
    return dict(seq=seq, tracker=tracker, i=i, map=m_np, ts=_np(ts), jts=ts, images=images,
                feats=feats,
                K=np.asarray(CFG.camera.K()), kf_bow=kf_bow, voc_t=voc_t)


def _feeder(feats):
    """The port's extractor stand-in: the JAX extractor's features of the
    chunk's frames, in order."""
    it = iter(feats)
    return lambda image: convert.features_from_numpy(next(it), device="cpu")


def _run_both(boot, cfg, with_bow, C=CHUNK):
    """One C-frame chunk of the bank's step with R = 1, JAX and port. The
    JAX side runs its step on the chunk's 4-frame segments in turn: its
    deferred chunk is these segments in sequence (a Python loop over
    segments in ``_chunk_body_deferred``), and one compiled 4-frame program
    costs half the compile time of an 8-frame one."""
    i = boot["i"]
    fids = np.arange(i, i + C, dtype=np.int32)
    stamps = np.asarray(boot["seq"].timestamps[i:i + C], np.float32)
    voc_j = jbow.load_vocabulary_npz(VOCAB) if with_bow else None
    m_j = jstreams.stack_trees([jms.MapState(**{k: jnp.asarray(v)
                                                for k, v in boot["map"]._asdict().items()})])
    ts_j = jstreams.stack_trees([boot["jts"]])
    bow_j = jnp.asarray(boot["kf_bow"])[None] if with_bow else jnp.zeros((1,), jnp.float32)
    jstep = jstreams.make_multistream_chunk_step(cfg, boot["tracker"].extract,
                                                 with_bow=with_bow)
    parts = []
    for lo in range(0, C, 4):
        m_j, ts_j, bow_j, s_seg, ev_seg = jstep(
            m_j, ts_j, bow_j, jnp.asarray(boot["K"])[None], boot["images"][None, lo:lo + 4],
            jnp.asarray(fids[lo:lo + 4])[None], jnp.asarray(stamps[lo:lo + 4])[None],
            jnp.asarray([True]), voc_j)
        # the segment's events count frames from the chunk's start
        ev_seg = ev_seg._replace(j=jnp.where(ev_seg.j >= 0, ev_seg.j + lo, -1))
        parts.append((s_seg, ev_seg))
    s_j, ev_j = jax.tree.map(lambda *xs: np.concatenate([np.asarray(x)[0] for x in xs]), *parts)
    m_j, ts_j = jax.tree.map(lambda a: np.asarray(a)[0], (m_j, ts_j))

    tstep = tstreams.make_multistream_chunk_step(cfg, _feeder(boot["feats"]), with_bow=with_bow)
    out_t = tstep([convert.map_state_from_numpy(boot["map"], device="cpu")],
                  [convert.track_state_from_numpy(boot["ts"], device="cpu")],
                  [convert.kf_bow_from_numpy(boot["kf_bow"], device="cpu") if with_bow else None],
                  [torch.as_tensor(boot["K"])], [list(boot["seq"].images[i:i + C])],
                  [fids.tolist()], [stamps.tolist()], [True],
                  boot["voc_t"] if with_bow else None)
    m_t, ts_t, _, s_t, ev_t = (x[0] for x in out_t)
    return (m_j, ts_j, s_j, ev_j), (m_t, ts_t, s_t, ev_t)


def _assert_chunk_close(jax_out, port_out):
    m_j, ts_j, s_j, ev_j = jax_out
    m_t, ts_t, s_t, ev_t = port_out
    for f in ("tracking_ok", "new_kf", "kf_slot", "ref_slot"):
        assert np.array_equal(getattr(s_t, f).numpy(), getattr(s_j, f)), f
    assert np.abs(s_t.n_inliers.numpy() - s_j.n_inliers).max() <= 2
    np.testing.assert_allclose(s_t.T_cw.numpy(), s_j.T_cw, rtol=0, atol=1e-3)
    # the events carried across both ways (convert.py): the JAX package's
    # as the port's tuple, the port's as the JAX package's
    ev_jt = convert.chunk_kf_events_from_numpy(ev_j, device="cpu")
    assert torch.equal(ev_t.j, ev_jt.j) and torch.equal(ev_t.slot, ev_jt.slot)
    ev_tj = jfused.ChunkKFEvents(**convert.chunk_kf_events_to_numpy(ev_t))
    assert np.array_equal(ev_tj.j, ev_j.j) and np.array_equal(ev_tj.slot, ev_j.slot)
    assert int(ts_t.n_kf) == int(ts_j.n_kf)
    n_j, n_t = int(m_j.lm_valid.sum()), int(m_t.lm_valid.sum())
    assert abs(n_t - n_j) <= max(1, 0.02 * n_j), (n_t, n_j)
    assert np.array_equal(m_t.kf_valid.numpy(), m_j.kf_valid)
    # the carried indicator describes the mapped map
    assert torch.equal(ts_t.obs_ind, tms.lm_indicator(m_t))


@pytest.mark.parametrize("with_bow", [False, True], ids=["no_vocabulary", "vocabulary"])
def test_deferred_chunk_matches_jax(boot, with_bow):
    """One 8-frame deferred chunk (two 4-frame segments, each tracked and
    then mapped) against the JAX package's."""
    jax_out, port_out = _run_both(boot, CFG, with_bow)
    _assert_chunk_close(jax_out, port_out)
    s_j, ev_j = jax_out[2], jax_out[3]
    ev_t = port_out[3]
    assert s_j.tracking_ok.all() and s_j.new_kf.any()
    assert (ev_j.j >= 0).sum() == s_j.new_kf.sum()  # no decision was dropped
    if with_bow:
        np.testing.assert_allclose(ev_t.loop_scores.numpy(), ev_j.loop_scores, rtol=0, atol=1e-5)
        np.testing.assert_allclose(ev_t.loop_min_score.numpy(), ev_j.loop_min_score, rtol=0,
                                   atol=1e-5)
        assert (ev_j.loop_min_score[ev_j.j >= 0] > 0).all()
    else:
        assert ev_t.loop_scores is None and ev_t.loop_min_score is None


def test_deferred_chunk_backpressure_matches_jax(boot):
    """``new_kf_max_frames = 1``: every tracked frame wants a keyframe, and
    the segment's queue takes kmax = 2; the dropped decisions are the JAX
    package's. One 4-frame segment (a chunk of one segment)."""
    cfg = CFG.replace(tracking=dataclasses.replace(CFG.tracking, new_kf_max_frames=1))
    jax_out, port_out = _run_both(boot, cfg, with_bow=False, C=4)
    _assert_chunk_close(jax_out, port_out)
    s_j, ev_j = jax_out[2], jax_out[3]
    assert s_j.tracking_ok.all()
    assert port_out[2].new_kf.tolist() == [True, True, False, False]
    assert ev_j.j.tolist() == [0, 1]


def _replay_maps(n0, n, seed=3):
    """A strafing row of ``n`` keyframes over one landmark field: the
    authoritative map holds the first ``n0``, the follower's copy all ``n``.
    Some landmarks are dead in the authoritative map and some were born
    after the last refresh (``base_valid``), so the association filter has
    work. Returns the JAX and port maps and base_valid."""
    pts = make_landmark_field(1800, extent=6.0, depth_range=(4.0, 9.0), seed=seed)
    desc = np.random.default_rng(seed).integers(0, 256, (len(pts), 32), dtype=np.uint8)
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[:, 0, 3] = -0.08 * np.arange(n)
    out = {}
    for name, k in (("A", n0), ("B", n)):
        out[name + "_j"] = fabricate_map(CFG, poses[:k], pts, desc, seed=seed)[0]
        out[name + "_t"] = tsynthetic.fabricate_map(CFG, poses[:k], pts, desc, seed=seed,
                                                    device="cpu")[0]
    L = CFG.capacity.max_landmarks
    dead = np.zeros(L, bool)
    dead[7:L:11] = True
    mA = _np(out["A_j"])._replace(lm_valid=np.asarray(out["A_j"].lm_valid) & ~dead)
    out["A_j"] = jms.MapState(**{k: jnp.asarray(v) for k, v in mA._asdict().items()})
    out["A_t"] = convert.map_state_from_numpy(mA, device="cpu")
    base_valid = mA.lm_valid & (np.arange(L) % 13 != 5)
    return out, base_valid


@pytest.mark.parametrize("n0,n,src,n_allowed", [
    (6, 11, [6, 7, 8, 9, 10], 5),  # roomy: every copy keyframe goes in
    (62, 64, [62, 63], 2),  # the capacity clamp: the pool's last slot stays free
], ids=["roomy", "capacity_clamp"])
def test_replay_follower_keyframes_matches_jax(n0, n, src, n_allowed):
    maps, base_valid = _replay_maps(n0, n)
    voc_j = jbow.load_vocabulary_npz(VOCAB)
    voc_t = tbow.load_vocabulary_npz(VOCAB, device="cpu")
    mA_np = convert.map_state_to_numpy(maps["A_t"])
    bowA = tbow.update_bow_rows(voc_t, maps["A_t"].kf_desc, maps["A_t"].kf_feat_valid,
                                torch.zeros((CFG.capacity.max_keyframes, voc_t.n_words)),
                                list(range(n0)))
    # the JAX package's replay program takes a fixed 16 slots, -1 padded;
    # the port's host loop skips the padding
    padded = (src + [-1] * 16)[:16]
    mA_j, bow_j = jstreams._replay_kfs_device(
        CFG, maps["A_j"], jnp.asarray(bowA.numpy()), voc_j, maps["B_j"],
        jnp.asarray(padded, jnp.int32), jnp.asarray(base_valid), jnp.int32(n0),
        jnp.int32(n_allowed), True)
    mA_t, bow_t = tstreams._replay_kfs_device(
        CFG, maps["A_t"], bowA, voc_t, maps["B_t"], padded, torch.as_tensor(base_valid), n0,
        n_allowed, True)
    n_kf = min(n0 + n_allowed, CFG.capacity.max_keyframes - 1)
    assert int(mA_t.n_kf) == int(mA_j.n_kf) == n_kf
    assert np.array_equal(mA_t.kf_obs_lm.numpy(), np.asarray(mA_j.kf_obs_lm))
    assert np.array_equal(mA_t.kf_valid.numpy(), np.asarray(mA_j.kf_valid))
    np.testing.assert_allclose(bow_t.numpy(), np.asarray(bow_j), rtol=0, atol=1e-6)
    # every association of an inserted keyframe names a landmark alive in
    # A, and most of the copy's survived the filter
    for slot in range(n0, n_kf):
        obs = mA_t.kf_obs_lm[slot].numpy()
        assert mA_np["lm_valid"][obs[obs >= 0]].all()
        copy_obs = maps["B_t"].kf_obs_lm[src[slot - n0]].numpy()
        assert ((copy_obs >= 0) & (obs == copy_obs)).sum() > 100
    assert (bow_t[n0:n_kf].sum(-1) - 1.0).abs().max() < 1e-5  # a row per inserted keyframe
    assert bool((bow_t[n_kf:] == 0).all())


def test_follower_copy_shares_no_storage_with_the_owner(boot):
    """After a shared refresh, one chunk in the follower's copy leaves every
    tensor of the owner's map (its slice and the shared context's map)
    equal to before, and no tensor of the follower's slice shares storage
    with them."""
    mc = MapContext(CFG, device="cpu")
    mc.map = convert.map_state_from_numpy(boot["map"], device="cpu")
    mc.n_kf = int(boot["ts"].n_kf)
    ts = convert.track_state_from_numpy(boot["ts"], device="cpu")
    trackers = []
    for name in ("owner", "follower"):
        t = RobotTracker(CFG, mc, name, device="cpu")
        t._ts = ts
        trackers.append(t)
    bank = tstreams.StreamBank(CFG, trackers, device="cpu")
    bank.followers[1] = 0
    bank._refresh_shared(0)
    owner_before = tstreams._copy(bank.m_all[0])

    def storages(tree):
        return {x.untyped_storage().data_ptr() for x in tree if torch.is_tensor(x)}

    assert not storages(bank.m_all[1]) & (storages(bank.m_all[0]) | storages(mc.map))
    i = boot["i"]
    step = tstreams.make_multistream_chunk_step(CFG, _feeder(boot["feats"]))
    m2, ts2, _, s, _ = step([bank.m_all[1]], [bank.ts_all[1]], [None],
                            [torch.as_tensor(boot["K"])], [list(boot["seq"].images[i:i + CHUNK])],
                            [list(range(i, i + CHUNK))],
                            [[float(x) for x in boot["seq"].timestamps[i:i + CHUNK]]], [True])
    assert bool(s[0].new_kf.any())  # the follower's copy mapped keyframes
    assert int(ts2[0].n_kf) > mc.n_kf
    for name, before, now, ctx in zip(tms.MapState._fields, owner_before, bank.m_all[0], mc.map):
        assert torch.equal(before, now), name
        assert torch.equal(before, ctx), name


def test_bank_refuses_a_chunk_of_another_size(boot):
    """A bank built with ``chunk_size`` takes chunks of that many frames and
    refuses others before it dispatches anything."""
    mc = MapContext(CFG, device="cpu")
    mc.map = convert.map_state_from_numpy(boot["map"], device="cpu")
    t = RobotTracker(CFG, mc, "r0", device="cpu")
    t._ts = convert.track_state_from_numpy(boot["ts"], device="cpu")
    bank = tstreams.StreamBank(CFG, [t], device="cpu", chunk_size=CHUNK)
    i = boot["i"]
    images = np.stack(boot["seq"].images[i:i + 4])[None]
    fid = t.frame_id
    with pytest.raises(ValueError, match="chunk_size 8"):
        bank.process_chunk(images, np.asarray(boot["seq"].timestamps[i:i + 4])[None])
    assert bank._pending is None and t.frame_id == fid and not t.frames
