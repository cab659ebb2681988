"""Local-mapping stage (port of orbslamm_tpu/models/local_mapping.py).

One call of ``process_new_keyframe_cached`` is the work the reference's
LocalMapping thread does per keyframe: triangulate new landmarks against
covisible neighbours, fuse observations across the neighbourhood, run the
window Schur BA, cull landmarks and keyframes. The [K, L] keyframe→landmark
indicator is carried in and maintained by every stage (``ind``), as in the
JAX package. The pair matches of triangulation and fuse go through the
fused matcher (``ops/cuda/hamming.py``).

Scalar indices such as neighbour slots stay on the device: no stage
branches on a tensor value.
"""

from __future__ import annotations

import torch

from orbslamm_tpu_torch.utils.config import SlamConfig
from orbslamm_tpu_torch.models import map_state as ms
from orbslamm_tpu_torch.ops import ba, geometry as geo, matching
from orbslamm_tpu_torch.ops.matching import _top_k
from orbslamm_tpu_torch.utils.trace import stage


def _fundamental_from_poses(T_a, T_b, K_a, K_b):
    """F such that x_b' F x_a = 0 (pixels), from camera-from-world poses."""
    T_ba = T_b @ geo.T_inv(T_a)
    R, t = T_ba[:3, :3], T_ba[:3, 3]
    E = geo.skew(t) @ R
    return torch.linalg.inv_ex(K_b)[0].T @ E @ torch.linalg.inv_ex(K_a)[0]


def _ind_row(obs_row, feat_valid_row, L: int) -> torch.Tensor:
    """[M] observation row (or [R, M] rows) -> [L] (or [R, L]) indicator."""
    if obs_row.ndim == 1:
        return ms._indicator_rows(obs_row[None], feat_valid_row[None], L)[0]
    return ms._indicator_rows(obs_row, feat_valid_row, L)


def _triangulate_pair(cfg: SlamConfig, m: ms.MapState, slot_a, slot_b, max_new: int):
    """Match unassociated features of keyframes a, b along epipolar bands
    and triangulate (reference CreateNewMapPoints, LocalMapping.cc:207).

    Returns (points [max_new,3], ok, feat_a, feat_b, desc, normal, dmin,
    dmax) — a fixed-size candidate block."""
    T_a, T_b = m.kf_pose[slot_a], m.kf_pose[slot_b]
    K_a, K_b = m.kf_K[slot_a], m.kf_K[slot_b]
    xy_a, xy_b = m.kf_xy[slot_a], m.kf_xy[slot_b]
    lvl_a, lvl_b = m.kf_level[slot_a], m.kf_level[slot_b]
    free_a = m.kf_feat_valid[slot_a] & (m.kf_obs_lm[slot_a] < 0)
    free_b = m.kf_feat_valid[slot_b] & (m.kf_obs_lm[slot_b] < 0)

    F_ab = _fundamental_from_poses(T_a, T_b, K_a, K_b)
    # no ratio test, like SearchForTriangulation: the epipolar band is the
    # selective filter and the geometric gates below remove wrong pairs
    res = matching.match_epipolar(
        m.kf_desc[slot_a], m.kf_desc[slot_b], free_a, free_b, F12=F_ab,
        xy_a=xy_a, xy_b=xy_b, level_a=lvl_a, level_b=lvl_b,
        scale=cfg.orb.scale_factor, lvl_lo=-2.0, lvl_hi=2.0,
        max_dist=float(cfg.matcher.th_high), ratio=1.0,
    )
    res = matching.resolve_duplicates(res, xy_b.shape[0])

    P_a = K_a @ T_a[:3, :]
    P_b = K_b @ T_b[:3, :]
    uv_b = xy_b[res.idx]
    X = geo.triangulate_dlt(P_a, P_b, xy_a, uv_b)  # [M,3] world
    pc_a = geo.transform_points(T_a, X)
    pc_b = geo.transform_points(T_b, X)
    C_a = -T_a[:3, :3].T @ T_a[:3, 3]
    C_b = -T_b[:3, :3].T @ T_b[:3, 3]
    r1 = X - C_a
    r2 = X - C_b
    d1 = torch.linalg.norm(r1, dim=-1)
    d2 = torch.linalg.norm(r2, dim=-1)
    cosp = (r1 * r2).sum(-1) / torch.clamp_min(d1 * d2, 1e-9)
    e_a = ((geo.project(K_a, pc_a) - xy_a) ** 2).sum(-1)
    e_b = ((geo.project(K_b, pc_b) - uv_b) ** 2).sum(-1)
    pn = cfg.tracking.pixel_noise
    sf = cfg.orb.scale_factor
    lvl_af = lvl_a.to(torch.float32)
    lvl_bf = lvl_b[res.idx].to(torch.float32)
    s2a = (pn * sf ** lvl_af) ** 2
    s2b = (pn * sf ** lvl_bf) ** 2
    # scale consistency (reference ratioDist vs ratioOctave, LocalMapping.cc:400)
    ratio_dist = d2 / torch.clamp_min(d1, 1e-9)
    ratio_oct = sf ** lvl_af / sf ** lvl_bf
    rf = sf * 1.5
    # baseline / median scene depth guard (LocalMapping.cc:255)
    baseline = torch.linalg.norm(C_a - C_b)
    obs_a = m.kf_obs_lm[slot_a]
    lm_z = geo.transform_points(T_a, m.lm_pos[torch.clamp_min(obs_a, 0)])[:, 2]
    z_ok = (obs_a >= 0) & m.kf_feat_valid[slot_a]
    zs = torch.sort(torch.where(z_ok, lm_z, torch.full_like(lm_z, float("inf")))).values
    med_depth = zs[torch.clamp_min((z_ok.sum() - 1) // 2, 0)]
    pair_ok = baseline > 0.02 * torch.where(torch.isfinite(med_depth), med_depth,
                                            torch.full_like(med_depth, 1e9))
    ok = (
        res.ok & pair_ok
        & (pc_a[:, 2] > 0.02) & (pc_b[:, 2] > 0.02)
        & (cosp < 0.9998)
        & (e_a < 5.991 * s2a) & (e_b < 5.991 * s2b)
        & (ratio_dist < ratio_oct * rf) & (ratio_dist * rf > ratio_oct)
    )
    # pack the best max_new candidates
    score = torch.where(ok, -res.dist, torch.full_like(res.dist, -1e9))
    _, pick = _top_k(score, max_new)
    normal = (r1 / torch.clamp_min(d1[:, None], 1e-9))[pick]
    dist_a = d1[pick]
    dmax = dist_a * sf ** lvl_af[pick]
    dmin = dmax / sf ** (cfg.orb.n_levels - 1)
    return (X[pick], ok[pick], pick.to(torch.int32), res.idx[pick],
            m.kf_desc[slot_a][pick], normal, dmin, dmax)


def _triangulate(cfg, m, kf_slot, ind, n_neighbors: int, max_new: int):
    """New landmarks between the new keyframe and its top covisible
    neighbours. Consumes and maintains the [K, L] indicator."""
    W = ms.covisibility(m, ind)
    K_pool = W.shape[0]
    ar = torch.arange(K_pool, device=W.device)
    row = torch.where(m.kf_valid & (ar != kf_slot), W[kf_slot], torch.full_like(W[0], -1))
    _, nbrs = _top_k(row, n_neighbors)
    nbr_ok = row[nbrs] > 0
    L = m.lm_pos.shape[0]
    for i in range(n_neighbors):
        slot_b = nbrs[i]
        X, okp, feat_a, feat_b, desc, normal, dmin, dmax = _triangulate_pair(
            cfg, m, kf_slot, slot_b, max_new)
        okp = okp & nbr_ok[i]
        slots = ms.free_lm_slots(m, max_new)
        okp = okp & ~m.lm_valid[slots]  # a still-valid slot means the pool is full
        m = ms.add_landmarks(m, slots, okp, X, desc, normal, dmin, dmax, kf_slot)
        obs = ms.set_row_cols(m.kf_obs_lm, kf_slot, feat_a, slots, okp)
        obs = ms.set_row_cols(obs, slot_b, feat_b, slots, okp)
        m = m._replace(kf_obs_lm=obs)
        # the new landmark columns light up for both keyframes; a reused
        # slot may carry a stale column from a culled landmark
        col = ms.mark(L, slots, okp)
        ind = ind * ~col[None, :]
        ind[kf_slot] = torch.where(col, 1.0, ind[kf_slot])
        ind[slot_b] = torch.where(col, 1.0, ind[slot_b])
    return m, ind


def _local_ba(cfg, m, kf_slot, ind, window: int, n_fixed: int, iters: int):
    """Windowed Schur BA around the new keyframe (Optimizer.cc:475): the
    top-``window`` covisible keyframes are free, the next ``n_fixed`` are
    fixed anchors that pin the window's gauge and scale."""
    Wc = ms.covisibility(m, ind)
    K_pool, Mfeat = m.kf_obs_lm.shape
    dev = Wc.device
    total = window + n_fixed
    row = torch.where(m.kf_valid, Wc[kf_slot], torch.full_like(Wc[0], -1))
    row[kf_slot] = 1 << 30
    _, win = _top_k(row, total)  # kf_slot first
    win_ok = (row[win] > 0) & m.kf_valid[win]
    ar = torch.arange(total, device=dev)
    oldest = torch.argmin(torch.where(win_ok, win, torch.full_like(win, 1 << 30)))
    fixed = m.kf_fixed[win] | (ar == oldest) | (ar >= window)

    obs_lm = m.kf_obs_lm[win]  # [W,M]
    feat_ok = m.kf_feat_valid[win] & (obs_lm >= 0)
    lm_idx = torch.where(feat_ok, obs_lm, torch.zeros_like(obs_lm))
    feat_ok = feat_ok & m.lm_valid[lm_idx]
    sigma2 = (cfg.tracking.pixel_noise
              * cfg.orb.scale_factor ** m.kf_level[win].to(torch.float32)) ** 2
    res = ba.bundle_adjust_window(
        T_cw=m.kf_pose[win], K=m.kf_K[win], cam_valid=win_ok, cam_fixed=fixed,
        points=m.lm_pos, point_valid=m.lm_valid, obs_point=lm_idx,
        obs_uv=m.kf_xy[win], obs_sigma2=sigma2,
        obs_valid=feat_ok & win_ok[:, None], iters=iters,
    )
    m = m._replace(kf_pose=ms.set_rows(m.kf_pose, win, res.T_cw, win_ok & ~fixed),
                   lm_pos=res.points)
    # remove observations that ended as BA outliers
    out = (~res.obs_inlier) & feat_ok
    old_rows = m.kf_obs_lm[win]
    new_rows = torch.where(out, torch.full_like(old_rows, -1), old_rows)
    new_rows = torch.where(win_ok[:, None], new_rows, old_rows)
    m = m._replace(kf_obs_lm=ms.set_rows(m.kf_obs_lm, win, new_rows))
    rows = _ind_row(new_rows, m.kf_feat_valid[win], m.lm_pos.shape[0]) \
        * (m.kf_valid[win] & win_ok)[:, None].to(torch.float32)
    ind = ms.set_rows(ind, win, rows, win_ok)
    return m, ind


def _cull_landmarks(cfg, m, kf_slot, ind):
    """MapPointCulling (LocalMapping.cc:170): drop landmarks with a bad
    found/visible ratio or too few observations soon after creation."""
    obs = ms.lm_obs_count(m, ind)
    ratio = m.lm_found.to(torch.float32) / torch.clamp_min(m.lm_visible, 1).to(torch.float32)
    age = kf_slot - m.lm_first_kf
    bad = m.lm_valid & (
        ((ratio < cfg.mapping.culling_found_ratio) & (m.lm_visible >= 8))
        | ((age >= 3) & (obs <= 2))
    )
    m = m._replace(lm_valid=m.lm_valid & ~bad)
    dangling = (m.kf_obs_lm >= 0) & ~m.lm_valid[torch.clamp_min(m.kf_obs_lm, 0)]
    m = m._replace(kf_obs_lm=torch.where(dangling, -1, m.kf_obs_lm))
    return m, ind * ~bad[None, :]


def _fuse_into_kf(cfg: SlamConfig, m: ms.MapState, slot, lm_mask):
    """Project the masked landmark set into keyframe ``slot`` and claim
    unassociated features as new observations (ORBmatcher::Fuse)."""
    T = m.kf_pose[slot]
    K = m.kf_K[slot]
    pc = geo.transform_points(T, m.lm_pos)
    uv = geo.project(K, pc)
    z = pc[..., 2]
    Wpx = 2.0 * K[0, 2]
    Hpx = 2.0 * K[1, 2]
    C = -T[:3, :3].T @ T[:3, 3]
    ray = m.lm_pos - C
    dist = torch.linalg.norm(ray, dim=-1)
    cosv = (ray * m.lm_normal).sum(-1) / torch.clamp_min(dist, 1e-9)
    vis = (
        lm_mask & m.lm_valid & (z > 0.1)
        & (uv[:, 0] >= 0) & (uv[:, 0] < Wpx)
        & (uv[:, 1] >= 0) & (uv[:, 1] < Hpx)
        & (dist >= 0.8 * m.lm_dist_min) & (dist <= 1.2 * m.lm_dist_max)
        & (cosv > 0.5)
    )
    L = m.lm_pos.shape[0]
    obs_row = m.kf_obs_lm[slot]
    vis = vis & ~ms.mark(L, obs_row, obs_row >= 0)  # already observed here

    free = m.kf_feat_valid[slot] & (obs_row < 0)
    log_scale = torch.log(torch.tensor(cfg.orb.scale_factor, dtype=torch.float32,
                                       device=dist.device))
    pred_level = torch.clamp(
        torch.floor(torch.log(torch.clamp_min(
            m.lm_dist_max / torch.clamp_min(dist, 1e-6), 1e-6)) / log_scale),
        0, cfg.orb.n_levels - 1,
    )
    radius = 3.0 * cfg.orb.scale_factor ** pred_level
    res = matching.match_windowed(
        m.kf_desc[slot], m.lm_desc, free, vis,
        xy_a=m.kf_xy[slot], xy_b=uv, radius_b=radius,
        level_a=m.kf_level[slot], level_b=pred_level, lvl_lo=-2.0, lvl_hi=1.0,
        max_dist=float(cfg.matcher.th_low), ratio=1.0,
    )
    res = matching.resolve_duplicates(res, L)
    obs = m.kf_obs_lm.clone()
    obs[slot] = torch.where(res.ok, res.idx, obs_row)
    return m._replace(kf_obs_lm=obs)


def _fuse(cfg, m, kf_slot, ind, n_neighbors: int):
    """SearchInNeighbors (LocalMapping.cc:454): fuse the new keyframe's
    landmarks into its covisible neighbours and every landmark into the new
    keyframe."""
    W = ms.covisibility(m, ind)
    ar = torch.arange(W.shape[0], device=W.device)
    row = torch.where(m.kf_valid & (ar != kf_slot), W[kf_slot], torch.full_like(W[0], -1))
    _, nbrs = _top_k(row, n_neighbors)
    nbr_ok = row[nbrs] > 0
    L = m.lm_pos.shape[0]
    own_row = m.kf_obs_lm[kf_slot]
    own = ms.mark(L, own_row, own_row >= 0)
    touched = [kf_slot]
    for i in range(n_neighbors):
        # an invalid neighbour gets an empty landmark set
        m = _fuse_into_kf(cfg, m, nbrs[i], own & nbr_ok[i])
        touched.append(nbrs[i])
    m = _fuse_into_kf(cfg, m, kf_slot, torch.ones(L, dtype=torch.bool, device=own.device))
    ind = ind.clone()
    for s in touched:
        ind[s] = _ind_row(m.kf_obs_lm[s], m.kf_feat_valid[s], L) * m.kf_valid[s]
    return m, ind


def _cull_keyframes(cfg, m, kf_slot, ind, n_check: int):
    """KeyFrameCulling (LocalMapping.cc:632): invalidate covisible keyframes
    whose landmarks are >= 90% seen by enough other keyframes; the origin
    and the newest keyframe are never culled."""
    W = ms.covisibility(m, ind)
    obs_count = ms.lm_obs_count(m, ind)
    ar = torch.arange(W.shape[0], device=W.device)
    row = torch.where(m.kf_valid & (ar != kf_slot), W[kf_slot], torch.full_like(W[0], -1))
    _, cands = _top_k(row, n_check)

    kf_valid = m.kf_valid.clone()
    for i in range(n_check):
        slot = cands[i]
        obs = m.kf_obs_lm[slot]
        has = m.kf_feat_valid[slot] & (obs >= 0)
        lm = torch.clamp_min(obs, 0)
        has = has & m.lm_valid[lm]
        # seen by >= 4 OTHER keyframes (stricter than the reference's 3; see
        # the JAX package)
        redundant = has & (obs_count[lm] >= 5)
        n_obs = has.sum()
        ratio = redundant.sum().to(torch.float32) / torch.clamp_min(n_obs, 1).to(torch.float32)
        cull = (
            (row[slot] > 0) & kf_valid[slot] & ~m.kf_fixed[slot]
            & (slot != kf_slot) & (slot != 0)
            & (ratio > cfg.mapping.kf_culling_redundancy) & (n_obs > 40)
        )
        kf_valid[slot] = kf_valid[slot] & ~cull
    m = m._replace(kf_valid=kf_valid)
    dangling = ~kf_valid[:, None] & (m.kf_obs_lm >= 0)
    m = m._replace(kf_obs_lm=torch.where(dangling, -1, m.kf_obs_lm))
    return m, ind * kf_valid[:, None].to(torch.float32)


def process_new_keyframe_cached(cfg: SlamConfig, m: ms.MapState, kf_slot, ind,
                                n_neighbors: int = 2, max_new: int = 256,
                                fuse_neighbors_n: int = 4, ba_window: int = 12,
                                ba_fixed: int = 8, ba_iters: int = 8,
                                cull_check: int = 6):
    """The per-keyframe mapping pipeline with the carried [K, L]
    observation indicator (refreshed for the inserted keyframe, then
    maintained by every stage). Returns (map, indicator)."""
    kf_slot = torch.as_tensor(kf_slot, dtype=torch.int32, device=m.kf_pose.device)
    ind = ms.refresh_indicator_row(m, ind, kf_slot)
    with stage("mapping.triangulate"):
        m, ind = _triangulate(cfg, m, kf_slot, ind, n_neighbors, max_new)
    with stage("mapping.fuse"):
        m, ind = _fuse(cfg, m, kf_slot, ind, fuse_neighbors_n)
    with stage("mapping.local_ba"):
        m, ind = _local_ba(cfg, m, kf_slot, ind, ba_window, ba_fixed, ba_iters)
    with stage("mapping.cull"):
        m, ind = _cull_landmarks(cfg, m, kf_slot, ind)
        m, ind = _cull_keyframes(cfg, m, kf_slot, ind, cull_check)
    return m, ind


def fuse_neighbors(cfg: SlamConfig, m: ms.MapState, kf_slot, n_neighbors: int = 4) -> ms.MapState:
    """Stand-alone fuse around keyframe ``kf_slot`` (the merge seam's),
    indicator built on demand."""
    kf_slot = torch.as_tensor(kf_slot, dtype=torch.int32, device=m.kf_pose.device)
    with stage("mapping.fuse"):
        m, _ = _fuse(cfg, m, kf_slot, ms.lm_indicator(m), n_neighbors)
    return m


def local_bundle_adjustment(cfg: SlamConfig, m: ms.MapState, kf_slot, window: int = 12,
                            n_fixed: int = 8, iters: int = 8) -> ms.MapState:
    """Stand-alone local BA (the init path's), indicator built on demand."""
    kf_slot = torch.as_tensor(kf_slot, dtype=torch.int32, device=m.kf_pose.device)
    m, _ = _local_ba(cfg, m, kf_slot, ms.lm_indicator(m), window, n_fixed, iters)
    return m
