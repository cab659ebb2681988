"""The per-frame tracking+mapping step and its chunked form (port of the
monocular, synchronous parts of orbslamm_tpu/models/fused.py).

    motion-model track -> local-map track -> keyframe decision
    -> (keyframe insert + mapping pipeline [+ BoW row + loop-candidate scan])
    -> state update + summary

The JAX package keeps the keyframe decision on the device under
``lax.cond`` and scans the chunk with ``lax.scan``. Here the decision is
read on the host — one ``.item()`` per frame — and the chunk is a Python
loop over frames; extraction runs per frame. Every tensor shape stays
fixed, so the step can later be captured in a CUDA graph.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orbslamm_tpu.utils.config import SlamConfig
from orbslamm_tpu_torch.models import local_mapping as lm_stage
from orbslamm_tpu_torch.models import loop_closing as lc_stage
from orbslamm_tpu_torch.models import map_state as ms
from orbslamm_tpu_torch.models import tracking as trk
from orbslamm_tpu_torch.ops import bow as bow_ops
from orbslamm_tpu_torch.ops import geometry as geo
from orbslamm_tpu_torch.ops.orb import Features
from orbslamm_tpu_torch.utils.trace import stage


class TrackState(NamedTuple):
    """Device-resident tracking state (the RobotTracker hot fields)."""

    T_cw: torch.Tensor  # [4,4]
    velocity: torch.Tensor  # [4,4]
    last_T: torch.Tensor  # [4,4]
    last_feats: Features
    last_lm: torch.Tensor  # [M] int32
    frames_since_kf: torch.Tensor  # i32
    peak_inliers: torch.Tensor  # i32
    prev_inliers: torch.Tensor  # i32 — last frame's inlier count (collapse gate)
    n_kf: torch.Tensor  # i32 — next keyframe slot
    # latched on the first failed frame: tracking stays frozen for the rest
    # of the chunk until the host state machine rebuilds the state
    lost: torch.Tensor  # bool
    obs_ind: torch.Tensor  # [K,L] f32 carried observation indicator
    last_kf_T: torch.Tensor  # [4,4] pose of the newest keyframe


class FrameSummary(NamedTuple):
    T_cw: torch.Tensor  # [4,4]
    n_inliers: torch.Tensor  # i32
    tracking_ok: torch.Tensor  # bool
    new_kf: torch.Tensor  # bool
    kf_slot: torch.Tensor  # i32 (valid when new_kf)
    ref_slot: torch.Tensor  # i32 — keyframe slot the pose is relative to
    T_rel: torch.Tensor  # [4,4] camera-from-refKF
    # in-step loop-candidate scan at keyframe insertion: [K] BoW similarity
    # per database keyframe, -1 where inadmissible (covisible, too recent,
    # invalid) or when no keyframe was inserted; None without a vocabulary
    loop_scores: torch.Tensor | None = None
    loop_min_score: torch.Tensor | None = None  # minScore normalizer (f32)


def _insert(cfg, m, ind, feats, feat_lm, T_cw, frame_id, timestamp, slot, K):
    """Keyframe insert + the full mapping pipeline with the carried
    indicator (triangulate -> fuse -> local BA -> culls)."""
    m = ms.insert_keyframe(m, slot, T_cw, K, feats, feat_lm, frame_id, timestamp)
    return lm_stage.process_new_keyframe_cached(cfg, m, slot, ind)


def _bow_insert(cfg, m, ind, kf_bow, voc, feats, slot):
    """The new keyframe's BoW row into the database, and its loop-candidate
    scores with the minScore normalizer (KeyFrameDatabase::
    DetectLoopCandidates + LoopClosing.cc:131). Returns (kf_bow, scores
    with -1 where inadmissible, min_score)."""
    with stage("bow.insert"):
        row = bow_ops.bow_vector(voc, bow_ops.assign_words(voc, feats.desc, feats.valid))
        kf_bow = kf_bow.clone()
        kf_bow[slot] = row
        scores = bow_ops.bow_score(row, kf_bow)  # [K]
        # connected through the carried indicator, the new keyframe itself
        # included (as the JAX package's in-chunk scan)
        conn = (ind @ ind[slot]) > 0
        allowed, mn = lc_stage.admissible_candidates(
            cfg, m, scores[None], conn[None], torch.as_tensor(slot, device=kf_bow.device).reshape(1),
            cfg.loop.kfs_between_loops)
        return kf_bow, torch.where(allowed[0], scores, torch.full_like(scores, -1.0)), mn[0]


def frame_body(cfg: SlamConfig, m: ms.MapState, ts: TrackState, feats: Features,
               frame_id, timestamp, K, kf_bow=None, voc=None, allow_kf=True):
    """One tracked frame. Returns (map, TrackState, FrameSummary), or
    (map, TrackState, kf_bow, FrameSummary) when a vocabulary is given:
    then an inserted keyframe's BoW row goes into ``kf_bow`` and the summary
    carries its loop-candidate scan. ``allow_kf`` False is localization
    mode: track against the frozen map, never insert a keyframe."""
    dev = K.device
    T_pred = ts.velocity @ ts.last_T
    with stage("track.motion_model"):
        r1 = trk.track_motion_model(cfg, m, feats, T_pred, K, ts.last_feats,
                                    ts.last_lm, T_last=ts.last_T)
    # too few motion inliers: retry the local map from the last pose with
    # wide windows (the TrackReferenceKeyFrame analog)
    weak = r1.n_inliers < cfg.tracking.min_inliers_track
    T_start = torch.where(weak, ts.last_T, r1.T_cw)
    feat_lm0 = torch.where(weak, torch.full_like(r1.feat_lm, -1), r1.feat_lm)
    with stage("track.local_map"):
        r2, m = trk.track_local_map(cfg, m, feats, T_start, K, feat_lm0,
                                    radius_scale=torch.where(weak, 3.0, 1.0))
    n2 = r2.n_inliers.to(torch.float32)
    ok = (r2.n_inliers >= cfg.tracking.min_inliers_local_map) & (
        n2 >= cfg.tracking.min_track_inlier_ratio * r2.n_matches.to(torch.float32))
    # a wide-window recovery must look like a real re-lock
    recovery_bar = torch.clamp_max(0.5 * ts.prev_inliers.to(torch.float32),
                                   2.0 * cfg.tracking.min_inliers_local_map)
    ok &= ~weak | (n2 >= recovery_bar)
    # sudden-collapse gate: a >4x single-frame inlier drop is a loss
    ok &= n2 >= 0.25 * ts.prev_inliers.to(torch.float32)
    # once lost, stay lost for the rest of the chunk
    ok &= ~ts.lost
    lost_next = ts.lost | ~ok

    peak = torch.maximum(ts.peak_inliers, r2.n_inliers)
    fsk = ts.frames_since_kf + 1
    need_kf = ok & (
        (fsk >= cfg.tracking.new_kf_max_frames)
        | ((fsk >= 1) & (r2.n_inliers > 15)
           & (n2 < cfg.tracking.new_kf_tracked_ratio * peak.to(torch.float32)))
    )
    need_kf &= ts.n_kf < cfg.capacity.max_keyframes - 1
    need_kf &= bool(allow_kf)
    # never mint a keyframe from a wide-window recovery frame
    need_kf &= ~weak
    slot = ts.n_kf

    ind = ts.obs_ind
    with_bow = voc is not None
    if with_bow:
        lscores = torch.full((cfg.capacity.max_keyframes,), -1.0, dtype=torch.float32,
                             device=dev)
        lmin = torch.zeros((), dtype=torch.float32, device=dev)
    if need_kf.item():  # the frame's one host sync
        m, ind = _insert(cfg, m, ind, feats, r2.feat_lm, r2.T_cw, frame_id,
                         timestamp, slot, K)
        if with_bow:
            kf_bow, lscores, lmin = _bow_insert(cfg, m, ind, kf_bow, voc, feats, slot)

    T_new = r2.T_cw
    eye4 = torch.eye(4, dtype=torch.float32, device=dev)
    ref_prev = torch.clamp_min(ts.n_kf - 1, 0)
    ref_slot = torch.where(need_kf, slot, ref_prev)
    T_rel = torch.where(need_kf, eye4, T_new @ geo.T_inv(ts.last_kf_T))
    vel = T_new @ geo.T_inv(ts.last_T)
    keep = {
        f: (torch.where(ok.reshape((1,) * new.ndim), new, old)
            if new is not None else None)
        for f, new, old in zip(Features._fields, feats, ts.last_feats)
    }
    ts_next = TrackState(
        T_cw=torch.where(ok, T_new, ts.T_cw),
        velocity=torch.where(ok, vel, ts.velocity),
        last_T=torch.where(ok, T_new, ts.last_T),
        last_feats=Features(**keep),
        last_lm=torch.where(ok, r2.feat_lm, ts.last_lm),
        frames_since_kf=torch.where(need_kf, 0, torch.where(ok, fsk, ts.frames_since_kf)),
        peak_inliers=torch.where(need_kf, r2.n_inliers,
                                 torch.where(ok, peak, ts.peak_inliers)),
        prev_inliers=torch.where(ok, r2.n_inliers, ts.prev_inliers),
        n_kf=torch.where(need_kf, ts.n_kf + 1, ts.n_kf),
        lost=lost_next,
        obs_ind=ind,
        # refreshed from the post-mapping map: local BA refined the new pose
        last_kf_T=torch.where(need_kf, m.kf_pose[slot], ts.last_kf_T),
    )
    summary = FrameSummary(T_cw=T_new, n_inliers=r2.n_inliers, tracking_ok=ok,
                           new_kf=need_kf, kf_slot=slot, ref_slot=ref_slot,
                           T_rel=T_rel,
                           loop_scores=lscores if with_bow else None,
                           loop_min_score=lmin if with_bow else None)
    if with_bow:
        return m, ts_next, kf_bow, summary
    return m, ts_next, summary


def rebase_track_state(ts: TrackState, T_kf_old: torch.Tensor,
                       T_kf_new: torch.Tensor) -> TrackState:
    """Re-express the tracking state after a loop correction moved the map:
    camera poses ride the corrected keyframe through the relative chain
    T_rel = T_cw inv(T_kf_old), T_cw' = T_rel T_kf_new (System.cc:470-499)."""
    A = geo.T_inv(T_kf_old) @ T_kf_new
    return ts._replace(T_cw=ts.T_cw @ A, last_T=ts.last_T @ A, last_kf_T=ts.last_kf_T @ A)


def make_frame_step(cfg: SlamConfig, extract_fn, K: torch.Tensor):
    """step(m, ts, image, frame_id, timestamp, allow_kf=True) -> (m, ts,
    summary). The single-frame step carries no BoW work, as in the JAX
    package: the host updates the database after a keyframe."""

    def step(m, ts, image, frame_id, timestamp, allow_kf=True):
        return frame_body(cfg, m, ts, extract_fn(image), frame_id, timestamp, K,
                          allow_kf=allow_kf)

    return step


def _stack(summaries) -> FrameSummary:
    return FrameSummary(*(None if xs[0] is None else torch.stack(xs)
                          for xs in zip(*summaries)))


def make_chunk_step(cfg: SlamConfig, extract_fn, K: torch.Tensor, with_bow: bool = False):
    """The chunked step: extraction per frame, then the frame body over the
    chunk in order.

    Without a vocabulary: chunk(m, ts, images [N,H,W], frame_ids [N],
    timestamps [N], allow_kf=True) -> (m, ts, FrameSummary stacked along
    dim 0). With ``with_bow`` (the JAX package's signature):
    chunk(m, ts, kf_bow, voc, images, frame_ids, timestamps, allow_kf=True)
    -> (m, ts, kf_bow, stacked FrameSummary with the loop scans)."""

    def run(m, ts, kf_bow, voc, images, frame_ids, timestamps, allow_kf):
        with stage("orb.extract"):
            feats_all = [extract_fn(img) for img in images]
        summaries = []
        for feats, fid, t in zip(feats_all, frame_ids, timestamps):
            out = frame_body(cfg, m, ts, feats, fid, t, K, kf_bow=kf_bow, voc=voc,
                             allow_kf=allow_kf)
            if with_bow:
                m, ts, kf_bow, s = out
            else:
                m, ts, s = out
            summaries.append(s)
        return m, ts, kf_bow, _stack(summaries)

    if with_bow:
        def chunk_bow(m, ts, kf_bow, voc, images, frame_ids, timestamps, allow_kf=True):
            return run(m, ts, kf_bow, voc, images, frame_ids, timestamps, allow_kf)

        return chunk_bow

    def chunk(m, ts, images, frame_ids, timestamps, allow_kf=True):
        m, ts, _, stacked = run(m, ts, None, None, images, frame_ids, timestamps, allow_kf)
        return m, ts, stacked

    return chunk
