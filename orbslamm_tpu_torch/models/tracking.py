"""Tracking stages (port of orbslamm_tpu/models/tracking.py).

Pure functions over (MapState, Features, poses), as in the JAX package:
motion-model tracking projects the last frame's landmarks at the predicted
pose and matches them in windows; local-map tracking projects the whole
landmark pool, keeps the frustum-visible candidates and matches the
unassociated features against them; both finish with motion-only BA.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orbslamm_tpu_torch.utils.config import SlamConfig
from orbslamm_tpu_torch.models import map_state as ms
from orbslamm_tpu_torch.models.map_state import MapState
from orbslamm_tpu_torch.ops import ba, geometry as geo, matching
from orbslamm_tpu_torch.ops.matching import _top_k
from orbslamm_tpu_torch.ops.orb import Features


class TrackResult(NamedTuple):
    T_cw: torch.Tensor  # [4,4] optimized pose
    feat_lm: torch.Tensor  # [M] int32 — landmark id per current feature (-1 none)
    n_matches: torch.Tensor  # int32 matches fed to the optimizer
    n_inliers: torch.Tensor  # int32 surviving inliers


def _sigma2(level, scale: float, pixel_noise: float = 1.0):
    return (pixel_noise * scale ** level.to(torch.float32)) ** 2


def _neg1(x: torch.Tensor) -> torch.Tensor:
    return torch.full_like(x, -1)


def track_motion_model(cfg: SlamConfig, m: MapState, feats: Features, T_pred, K,
                       last_feats: Features, last_lm, T_last=None) -> TrackResult:
    """Project last frame's landmarks at the predicted pose and match."""
    if T_last is None:
        T_last = T_pred
    has_lm = last_feats.valid & (last_lm >= 0)
    lm_idx = torch.where(has_lm, last_lm, torch.zeros_like(last_lm))
    pos = m.lm_pos[lm_idx]
    alive = has_lm & m.lm_valid[lm_idx]
    pc = geo.transform_points(T_pred, pos)
    uv = geo.project(K, pc)
    vis = alive & (pc[..., 2] > 0.1)
    radius = cfg.tracking.search_radius_motion * (
        cfg.orb.scale_factor ** last_feats.level.to(torch.float32))
    # per-CANDIDATE (column) radius: the window depends on the landmark's octave
    res = matching.match_windowed(
        feats.desc, last_feats.desc, feats.valid, vis,
        xy_a=feats.xy, xy_b=uv, radius_b=radius,
        level_a=feats.level, level_b=last_feats.level, lvl_lo=-1.0, lvl_hi=1.0,
        max_dist=float(cfg.matcher.th_high), ratio=cfg.matcher.nn_ratio_tracking,
        angles_a=feats.angle, angles_b=last_feats.angle,
    )
    res = matching.resolve_duplicates(res, last_feats.valid.shape[0])
    feat_lm = torch.where(res.ok, last_lm[res.idx], _neg1(res.idx))
    # pose optimization from BOTH the constant-velocity prediction and the
    # last pose (a batch of two), keeping the basin with more inliers
    use = feat_lm >= 0
    pos_f = m.lm_pos[torch.where(use, feat_lm, torch.zeros_like(feat_lm))]
    s2 = _sigma2(feats.level, cfg.orb.scale_factor, cfg.tracking.pixel_noise)
    both = ba.pose_optimize(torch.stack([T_pred, T_last]), K, pos_f, feats.xy, use,
                            sigma2=s2)
    sel = torch.where(both.n_inliers[0] >= both.n_inliers[1], 0, 1)
    opt_inliers = both.inliers[sel]
    feat_lm = torch.where(opt_inliers, feat_lm, _neg1(feat_lm))
    return TrackResult(T_cw=both.T_cw[sel], feat_lm=feat_lm,
                       n_matches=use.sum().to(torch.int32),
                       n_inliers=both.n_inliers[sel])


def track_local_map(cfg: SlamConfig, m: MapState, feats: Features, T_cw, K, feat_lm,
                    n_candidates: int = 4096, radius_scale=1.0):
    """Match unassociated features against the frustum-visible landmark
    pool, then run the final pose optimization over all associations.
    Returns (TrackResult, map with updated visible/found counters).

    ``radius_scale`` widens the projection windows (the recovery retry
    passes 3 when the motion model failed)."""
    L = m.lm_pos.shape[0]
    dev = m.lm_pos.device
    pc = geo.transform_points(T_cw, m.lm_pos)
    uv = geo.project(K, pc)
    z = pc[..., 2]
    H = 2.0 * K[1, 2]
    W = 2.0 * K[0, 2]
    C = -T_cw[:3, :3].T @ T_cw[:3, 3]
    ray = m.lm_pos - C
    dist = torch.linalg.norm(ray, dim=-1)
    cos_view = (ray * m.lm_normal).sum(-1) / torch.clamp_min(dist, 1e-9)
    vis = (
        m.lm_valid
        & (z > 0.1)
        & (uv[:, 0] >= 0) & (uv[:, 0] < W)
        & (uv[:, 1] >= 0) & (uv[:, 1] < H)
        & (dist >= 0.8 * m.lm_dist_min) & (dist <= 1.2 * m.lm_dist_max)
        & (cos_view > 0.5)
    )
    # already-associated landmarks are not re-matched
    assoc = ms.mark(L, feat_lm, feat_lm >= 0)
    vis = vis & ~assoc

    # the n_candidates best, visible first, recently created first among
    # them; ties go to the lowest slot, as with lax.top_k
    recency = m.lm_first_kf.to(torch.float32) / float(m.kf_pose.shape[0])
    key = vis.to(torch.float32) * (1.0 + recency)
    _, cand = _top_k(key, n_candidates)
    cand_ok = vis[cand]
    log_scale = torch.log(torch.tensor(cfg.orb.scale_factor, dtype=torch.float32, device=dev))
    pred_level = torch.clamp(
        torch.floor(torch.log(torch.clamp_min(
            m.lm_dist_max[cand] / torch.clamp_min(dist[cand], 1e-6), 1e-6)) / log_scale),
        0, cfg.orb.n_levels - 1,
    )
    radius_base = torch.where(cos_view[cand] > 0.998, 2.5, 4.0)
    radius = radius_base * cfg.orb.scale_factor ** pred_level * radius_scale

    free = feats.valid & (feat_lm < 0)
    # level band: feat.level - pred_level in [-1, 2]  <=>  lb - la in [-2, 1]
    res = matching.match_windowed(
        feats.desc, m.lm_desc[cand], free, cand_ok,
        xy_a=feats.xy, xy_b=uv[cand], radius_b=radius,
        level_a=feats.level, level_b=pred_level, lvl_lo=-2.0, lvl_hi=1.0,
        max_dist=float(cfg.matcher.th_high), ratio=0.8,
    )
    res = matching.resolve_duplicates(res, n_candidates)
    new_lm = torch.where(res.ok, cand[res.idx].to(torch.int32), _neg1(res.idx))
    feat_lm = torch.where(feat_lm >= 0, feat_lm, new_lm)

    use = feat_lm >= 0
    pos_f = m.lm_pos[torch.where(use, feat_lm, torch.zeros_like(feat_lm))]
    opt = ba.pose_optimize(
        T_cw, K, pos_f, feats.xy, use,
        sigma2=_sigma2(feats.level, cfg.orb.scale_factor, cfg.tracking.pixel_noise),
    )
    feat_lm = torch.where(opt.inliers, feat_lm, _neg1(feat_lm))

    # visibility / found counters (MapPoint::IncreaseVisible/Found): every
    # frustum-visible landmark, associated ones included, counts as visible
    vis_all = vis | (assoc & m.lm_valid)
    found = opt.inliers & (feat_lm >= 0)
    found_idx = torch.where(found, feat_lm, torch.full_like(feat_lm, L)).long()
    lm_found = torch.cat([m.lm_found, m.lm_found.new_zeros(1)]).index_add(
        0, found_idx, torch.ones_like(found_idx, dtype=torch.int32))[:L]
    m = m._replace(lm_visible=m.lm_visible + vis_all.to(torch.int32), lm_found=lm_found)
    return TrackResult(T_cw=opt.T_cw, feat_lm=feat_lm,
                       n_matches=use.sum().to(torch.int32),
                       n_inliers=opt.n_inliers), m


def match_for_init(cfg: SlamConfig, ref: Features, cur: Features):
    """Level-0 windowed matching for the two-view bootstrap (reference
    SearchForInitialization, ORBmatcher.cc:407) — the dense matcher."""
    lvl0 = (ref.level[:, None] == 0) & (cur.level[None, :] == 0)
    allowed = matching.window_mask(ref.xy_raw, cur.xy_raw, 100.0) & lvl0
    res = matching.match(
        ref.desc, cur.desc, ref.valid, cur.valid, allowed=allowed,
        max_dist=float(cfg.matcher.th_low), ratio=cfg.matcher.nn_ratio_init,
        mutual=True, angles_a=ref.angle, angles_b=cur.angle,
    )
    return matching.resolve_duplicates(res, cur.valid.shape[0])
