"""Loop detection, verification, correction and relocalization, and the
MultiMapper's cross-map scan and Sim3 (port of
orbslamm_tpu/models/loop_closing.py).

Per new keyframe:
  1. BoW candidate retrieval against the keyframe database (one score row +
     masks) with the reference's minScore normalization, then
     covisibility-group accumulation.
  2. Geometric verification: masked descriptor matching between the
     landmark-bearing features of the two keyframes, Sim3 RANSAC, a
     SearchBySim3 harvest, nonlinear Sim3 refinement and a second harvest.
  3. Correction: Sim3 pose graph over the essential graph with the matched
     keyframe fixed, landmarks carried by their reference keyframes; then
     slices of a matrix-free global BA.

Random draws come from a caller-owned ``torch.Generator``; ``draw``
(a callable ``(valid, n_hyp, k) -> [n_hyp, k]`` indices) overrides them so
tests can inject the JAX package's draws. The cross-map functions
(``merge_scan_scores``, ``batched_merge_scan_scores``,
``compute_loop_sim3_cross``) score one map's keyframes against another
map's database and verify a pair with the same Sim3 ladder.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orbslamm_tpu_torch.utils.config import SlamConfig
from orbslamm_tpu_torch.models import map_state as ms
from orbslamm_tpu_torch.ops import ba, bow, geometry as geo, matching, ransac
from orbslamm_tpu_torch.ops.matching import _top_k


def _drawer(generator, draw):
    if draw is not None:
        return draw
    return lambda valid, n_hyp, k: ransac._sample_indices(generator, valid, n_hyp, k)


# ---------------------------------------------------------------------------
# Detection
# ---------------------------------------------------------------------------

def admissible_candidates(cfg: SlamConfig, m: ms.MapState, scores, connected, slots,
                          min_gap: int = 10):
    """Which keyframes may be loop candidates of the keyframes ``slots`` [B]
    (valid, older than the loop gap, not ``connected`` [B,K] to the query),
    and the minScore normalizer: the lowest of the score rows ``scores``
    [B,K] over the connected keyframes (LoopClosing.cc:131). Returns
    (allowed [B,K], min_score [B])."""
    ids = torch.arange(scores.shape[-1], device=scores.device)
    allowed = (m.kf_valid[None, :] & (ids[None, :] != slots[:, None]) & ~connected
               & (ids[None, :] < slots[:, None] - min_gap + 1))
    cov = torch.where(connected & m.kf_valid[None, :], scores,
                      torch.full_like(scores, float("inf")))
    min_score = torch.clamp_max(cov.amin(-1), 1.0)
    min_score = torch.where(torch.isfinite(min_score), min_score, torch.full_like(min_score, 0.05))
    return allowed, min_score


def batched_loop_candidates(cfg: SlamConfig, m: ms.MapState, kf_bow: torch.Tensor, slots,
                            min_gap: int = 10):
    """Scores + admissibility masks for loop candidates of the keyframes
    ``slots`` [B]. Returns (scores [B,K], allowed [B,K], min_score [B])."""
    slots = torch.as_tensor(slots, device=kf_bow.device).long()
    scores = bow.bow_score(kf_bow[slots], kf_bow)  # [B,K]
    connected = ms.covisibility(m)[slots] > 0
    allowed, min_score = admissible_candidates(cfg, m, scores, connected, slots, min_gap)
    return scores, allowed, min_score


def loop_candidates(cfg: SlamConfig, m: ms.MapState, kf_bow, slot, min_gap: int = 10):
    """Returns (scores [K], allowed [K], min_score scalar) for one keyframe."""
    s, a, mn = batched_loop_candidates(cfg, m, kf_bow, [int(slot)], min_gap)
    return s[0], a[0], mn[0]


def candidate_groups(cfg: SlamConfig, m: ms.MapState, scores: torch.Tensor, n_group: int = 10):
    """Covisibility-group score accumulation (KeyFrameDatabase.cc:129-200):
    each candidate's score summed over its top-``n_group`` covisible
    neighbours; only groups within 0.75x of the best survive.

    Returns (acc [K], neighbors [K,K] bool incl. self)."""
    neighbors = _group_neighbors(m, n_group)
    return _accumulate_groups(neighbors, scores), neighbors


def _group_neighbors(m: ms.MapState, n_group: int) -> torch.Tensor:
    """[K,K] bool: each keyframe's top-``n_group`` covisible neighbours and
    itself."""
    W = ms.covisibility(m)
    topw, _ = _top_k(W, n_group)
    thresh = torch.clamp_min(topw[:, -1:], 1)
    neighbors = (W >= thresh) & (W > 0) & m.kf_valid[None, :]
    return neighbors | torch.eye(W.shape[0], dtype=torch.bool, device=W.device)


def _accumulate_groups(neighbors: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """[K] group-accumulated scores, -1 outside 0.75x of the best."""
    s = torch.clamp_min(scores, 0.0)
    acc = neighbors.to(torch.float32) @ s
    acc = torch.where(scores > 0, acc, torch.full_like(acc, -1.0))
    best = acc.amax()
    return torch.where(acc >= 0.75 * best, acc, torch.full_like(acc, -1.0))


def relocalization_candidates(cfg: SlamConfig, m: ms.MapState, kf_bow, v):
    """Scores of a lost frame's BoW vector against the keyframe database."""
    scores = bow.bow_score(v, kf_bow)
    return torch.where(m.kf_valid, scores, torch.full_like(scores, -1.0))


# ---------------------------------------------------------------------------
# Sim3 verification
# ---------------------------------------------------------------------------

class LoopSim3(NamedTuple):
    success: torch.Tensor
    S_ba: torch.Tensor  # packed sim3: slot_a camera coords -> slot_b camera coords
    n_inliers: torch.Tensor


def _nanmedian(x: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Median of ``x[ok]`` with ``jnp.nanmedian``'s rule: for an even count
    the two middle values weighted 0.5 each (``torch.nanmedian`` returns
    the lower one). NaN when nothing is ok. No host sync."""
    xs = torch.sort(torch.where(ok, x, torch.full_like(x, float("inf")))).values
    n = ok.sum()
    pos = 0.5 * (n - 1).to(torch.float32)
    lo = torch.clamp_min(torch.floor(pos), 0).long()
    hi = torch.clamp_min(torch.ceil(pos), 0).long()
    frac = pos - torch.floor(pos)
    med = xs[lo] * (1.0 - frac) + xs[hi] * frac
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))


def _sim3_between_feature_sets(cfg: SlamConfig, desc_b, angle_b, pb, has_b,
                               desc_a, angle_a, pa, has_a, K_b, K_a, draw,
                               fix_scale: bool = False):
    """Staged relative Sim3 between two landmark-bearing feature sets (3D
    points in each keyframe's camera frame) with the reference's acceptance
    ladder (LoopClosing::ComputeSim3 / MultiMapper.cc:209-362): appearance
    matches >= min_bow_matches; Sim3 RANSAC sampled from the depth-ratio
    consistent matches; SearchBySim3 harvest + refit; nonlinear refinement
    whose inliers must reach min_sim3_inliers; a second harvest whose total
    must reach min_total_matches. Returns (success, S b->a, n)."""
    res = matching.match(desc_b, desc_a, has_b, has_a, max_dist=float(cfg.matcher.th_low),
                         ratio=0.75, mutual=True, angles_a=angle_b, angles_b=angle_a)
    res = matching.resolve_duplicates(res, has_a.shape[0])
    pa_m = pa[res.idx.long()]
    nb_ = torch.clamp_min(torch.linalg.norm(pb, dim=-1), 1e-9)
    rho = torch.linalg.norm(pa_m, dim=-1) / nb_
    rho_med = _nanmedian(rho, res.ok)
    rho_med = torch.where(torch.isfinite(rho_med), rho_med, torch.ones_like(rho_med))
    consistent = res.ok & (rho > 0.7 * rho_med) & (rho < 1.43 * rho_med)
    sample_ok = torch.where(consistent.sum() >= 8, consistent, res.ok)
    idx = draw(sample_ok, 256, 3)
    s3 = ransac.sim3_ransac(pb, pa_m, sample_ok, K_b, K_a, min_inliers=8, n_hyp=256,
                            fix_scale=fix_scale, idx=idx)
    S = s3.S21  # b-cam -> a-cam
    uv_a = geo.project(K_a, pa)

    def count_inliers(S_, pa2, ok):
        pb2a = geo.sim3_apply(S_, pb)
        e_a = ((geo.project(K_a, pb2a) - geo.project(K_a, pa2)) ** 2).sum(-1)
        return ok & (e_a < 9.86) & (pb2a[:, 2] > 0.05)

    def extend(S):
        pb_in_a = geo.sim3_apply(S, pb)
        uv_a_pred = geo.project(K_a, pb_in_a)
        vis = has_b & (pb_in_a[:, 2] > 0.1)
        allowed = ((uv_a_pred[:, None, :] - uv_a[None, :, :]).abs().amax(-1) <= 9.0) \
            & vis[:, None] & has_a[None, :]
        r2 = matching.match(desc_b, desc_a, vis, has_a, allowed=allowed,
                            max_dist=float(cfg.matcher.th_high), ratio=1.0)
        r2 = matching.resolve_duplicates(r2, has_a.shape[0])
        pa2 = pa[r2.idx.long()]
        rho2 = torch.linalg.norm(pa2, dim=-1) / nb_
        med2 = _nanmedian(rho2, r2.ok)
        med2 = torch.where(torch.isfinite(med2), med2, torch.ones_like(med2))
        cons2 = r2.ok & (rho2 > 0.7 * med2) & (rho2 < 1.43 * med2)
        fit_ok = torch.where(cons2.sum() >= 8, cons2, r2.ok)
        s_f, R_f, t_f = geo.umeyama_alignment(pb, pa2, mask=fit_ok, with_scale=not fix_scale)
        S_new = geo.sim3_make(s_f, R_f, t_f)
        inl_old = count_inliers(S, pa2, r2.ok)
        inl_new = count_inliers(S_new, pa2, r2.ok)
        take = inl_new.sum() > inl_old.sum()
        S1 = torch.where(take, S_new, S)
        inl1 = torch.where(take, inl_new, inl_old)
        # one IRLS round: refit on the current inlier set
        s_2, R_2, t_2 = geo.umeyama_alignment(pb, pa2, mask=inl1 & (inl1.sum() >= 4),
                                              with_scale=not fix_scale)
        S2 = geo.sim3_make(s_2, R_2, t_2)
        inl2 = count_inliers(S2, pa2, r2.ok)
        take2 = inl2.sum() > inl1.sum()
        return torch.where(take2, S2, S1), torch.where(take2, inl2, inl1), r2.ok, pa2

    S, inl, r2_ok, pa2 = extend(S)
    ref = ba.sim3_refine(S, pb, pa2, r2_ok, K_b, K_a, fix_scale=fix_scale)
    n_opt = ref.n_inliers
    S = torch.where(n_opt >= inl.sum(), ref.S, S)
    S, inl, r2_ok2, _ = extend(S)
    n = inl.sum().to(torch.int32)
    n_total = r2_ok2.sum().to(torch.int32)
    success = ((res.ok.sum() >= cfg.loop.min_bow_matches)
               & (torch.maximum(n_opt, n) >= cfg.loop.min_sim3_inliers)
               & (n_total >= cfg.loop.min_total_matches))
    return success, S, n


def _landmark_side(m: ms.MapState, slot):
    has = m.kf_feat_valid[slot] & (m.kf_obs_lm[slot] >= 0)
    lm = torch.clamp_min(m.kf_obs_lm[slot], 0).long()
    has = has & m.lm_valid[lm]
    return has, geo.transform_points(m.kf_pose[slot], m.lm_pos[lm])


def compute_loop_sim3(cfg: SlamConfig, m: ms.MapState, slot_a, slot_b,
                      generator: torch.Generator | None = None, draw=None) -> LoopSim3:
    """Relative Sim3 between keyframes of the same map (ComputeSim3,
    LoopClosing.cc:237). S_ba maps slot_a camera -> slot_b camera."""
    has_a, pa = _landmark_side(m, slot_a)
    has_b, pb = _landmark_side(m, slot_b)
    success, S, n = _sim3_between_feature_sets(
        cfg,
        m.kf_desc[slot_a], m.kf_angle[slot_a], pa, has_a,
        m.kf_desc[slot_b], m.kf_angle[slot_b], pb, has_b,
        m.kf_K[slot_a], m.kf_K[slot_b], _drawer(generator, draw),
        # stereo/RGB-D pin metric scale (Sim3Solver mbFixScale)
        fix_scale=cfg.sensor != "mono",
    )
    return LoopSim3(success=success, S_ba=S, n_inliers=n)


# ---------------------------------------------------------------------------
# Correction
# ---------------------------------------------------------------------------

def essential_graph(cfg: SlamConfig, m: ms.MapState, slot_a, slot_b, S_ba,
                    max_cov_edges: int = 256):
    """The Sim3 pose graph of a loop correction: spanning-tree edges, the
    ``max_cov_edges`` strongest covisibility edges, every recorded loop
    edge and the new one, with keyframe ``slot_b`` fixed. Returns
    (PoseGraphProblem, the loop-edge table with the new edge recorded)."""
    K = m.kf_pose.shape[0]
    dev = m.kf_pose.device
    a, b = int(slot_a), int(slot_b)
    S_old = geo.sim3_from_se3(m.kf_pose)  # [K,8]
    # corrected current-KF node: S_aw = S_ba^-1 o S_bw
    S_aw_corr = geo.sim3_compose(geo.sim3_inv(S_ba), S_old[b])
    S_init = S_old.clone()
    S_init[a] = S_aw_corr

    # --- edges: spanning tree, strongest covisibility, past and new loops
    parent = ms.spanning_parent(m)
    ids = torch.arange(K, dtype=torch.int32, device=dev)
    span_j = torch.clamp_min(parent, 0)
    span_ok = (parent >= 0) & m.kf_valid
    W = ms.covisibility(m)
    kv = m.kf_valid.to(torch.int32)
    flat = (torch.triu(W, diagonal=1) * kv[:, None] * kv[None, :]).reshape(-1)
    # lax.top_k's tie rule (most entries are 0 or equal small counts)
    _, top = _top_k(flat, max_cov_edges)
    cov_i = (top // K).to(torch.int32)
    cov_j = (top % K).to(torch.int32)
    cov_ok = flat[top] >= cfg.loop.essential_graph_min_weight

    # persist the new loop edge (KeyFrame::AddLoopEdge) and keep every
    # recorded past loop edge in this graph (Optimizer.cc:1126-1139)
    le = m.loop_edges.clone()
    E = le.shape[0]
    free_row = torch.argmax((le[:, 0] < 0).to(torch.int32))
    le[free_row] = torch.tensor([a, b], dtype=torch.int32, device=dev)
    past_i = torch.clamp_min(le[:, 0], 0)
    past_j = torch.clamp_min(le[:, 1], 0)
    past_ok = ((le[:, 0] >= 0) & (torch.arange(E, device=dev) != free_row)
               & m.kf_valid[past_i.long()] & m.kf_valid[past_j.long()])

    one = torch.ones(1, dtype=torch.int32, device=dev)
    edge_i = torch.cat([ids, cov_i, past_i, a * one])
    edge_j = torch.cat([span_j, cov_j, past_j, b * one])
    edge_ok = torch.cat([span_ok, cov_ok, past_ok, torch.ones(1, dtype=torch.bool, device=dev)])
    # measurements from OLD poses, except the loop edge (the measured Sim3)
    M = geo.sim3_compose(S_old[edge_i.long()], geo.sim3_inv(S_old[edge_j.long()]))
    M[-1] = geo.sim3_compose(S_aw_corr, geo.sim3_inv(S_old[b]))
    weight = torch.ones(edge_i.shape[0], dtype=torch.float32, device=dev)
    weight[-1] = 5.0
    # past loop edges keep an elevated weight: verified constraints
    weight[-(E + 1):-1] = torch.where(past_ok, 3.0, 1.0)
    fixed = torch.zeros(K, dtype=torch.bool, device=dev)
    fixed[b] = True
    prob = ba.PoseGraphProblem(S_iw=S_init, node_valid=m.kf_valid, node_fixed=fixed,
                               edge_i=edge_i, edge_j=edge_j, edge_Sij=M,
                               edge_valid=edge_ok, edge_weight=weight)
    return prob, le


def correct_loop(cfg: SlamConfig, m: ms.MapState, slot_a, slot_b, S_ba,
                 max_cov_edges: int = 256, iters: int = 20) -> ms.MapState:
    """Essential-graph Sim3 optimization + landmark correction
    (LoopClosing::CorrectLoop -> OptimizeEssentialGraph)."""
    K = m.kf_pose.shape[0]
    prob, le = essential_graph(cfg, m, slot_a, slot_b, S_ba, max_cov_edges)
    S_old = geo.sim3_from_se3(m.kf_pose)
    # CG budget scales with graph size (about one edge hop per iteration)
    S_new = ba.pose_graph_optimize(prob, iters=iters, cg_iters=max(50, min(400, K // 2)))

    # --- apply: poses
    kf_pose = torch.where(m.kf_valid[:, None, None], geo.sim3_to_se3(S_new), m.kf_pose)
    # --- apply: landmarks through their reference keyframe, keeping each
    # landmark's position in its reference camera invariant
    ref = torch.clamp(m.lm_ref_kf, 0, K - 1).long()
    S_corr = geo.sim3_compose(geo.sim3_inv(S_new[ref]), S_old[ref])
    lv = m.lm_valid
    lm_pos = torch.where(lv[:, None], geo.sim3_apply(S_corr, m.lm_pos), m.lm_pos)
    # viewing normals rotate and the distance band scales with the
    # correction (reference UpdateNormalAndDepth, MapPoint.cc:330)
    s_c, R_c, _ = geo.sim3_parts(S_corr)
    lm_normal = torch.where(lv[:, None], torch.einsum("lij,lj->li", R_c, m.lm_normal),
                            m.lm_normal)
    return m._replace(kf_pose=kf_pose, lm_pos=lm_pos, lm_normal=lm_normal,
                      lm_dist_min=torch.where(lv, m.lm_dist_min * s_c, m.lm_dist_min),
                      lm_dist_max=torch.where(lv, m.lm_dist_max * s_c, m.lm_dist_max),
                      loop_edges=le)


def global_bundle_adjust(cfg: SlamConfig, m: ms.MapState, iters: int = 10, cg_iters: int = 30,
                         obs_per_kf: int = 512):
    """Full-map BA with the matrix-free Schur solver (GBA analog) on a
    compacted edge list: each keyframe's top-``obs_per_kf`` valid
    observation slots (lowest feature index first; the key is tie-free).
    With a stereo rig (``camera.bf > 0``) the edges carry their right-x
    measurements. Returns (map, cost)."""
    K, Mfeat = m.kf_obs_lm.shape
    dev = m.kf_pose.device
    obs_lm = m.kf_obs_lm
    lm_idx = torch.clamp_min(obs_lm, 0)
    feat_ok = m.kf_feat_valid & (obs_lm >= 0) & m.kf_valid[:, None] & m.lm_valid[lm_idx.long()]
    sigma2 = (cfg.tracking.pixel_noise * cfg.orb.scale_factor ** m.kf_level.to(torch.float32)) ** 2
    xy, ur = m.kf_xy, m.kf_ur
    E_kf = min(obs_per_kf, Mfeat)
    if E_kf < Mfeat:
        key = feat_ok.to(torch.float32) * 2.0 - torch.arange(
            Mfeat, dtype=torch.float32, device=dev) / Mfeat
        _, sel = _top_k(key, E_kf)  # [K, E_kf]
        lm_idx = lm_idx.gather(1, sel)
        feat_ok = feat_ok.gather(1, sel)
        xy = xy.gather(1, sel[..., None].expand(-1, -1, 2))
        sigma2 = sigma2.gather(1, sel)
        ur = ur.gather(1, sel)
    stereo = cfg.camera.bf > 0
    obs_cam = torch.arange(K, dtype=torch.int32, device=dev)[:, None].expand(K, E_kf)
    prob = ba.BAProblem(
        T_cw=m.kf_pose, K=m.kf_K, cam_valid=m.kf_valid, cam_fixed=m.kf_fixed,
        points=m.lm_pos, point_valid=m.lm_valid,
        obs_cam=obs_cam.reshape(-1), obs_point=lm_idx.reshape(-1).to(torch.int32),
        obs_uv=xy.reshape(-1, 2), obs_sigma2=sigma2.reshape(-1),
        obs_valid=feat_ok.reshape(-1),
        obs_ur=ur.reshape(-1) if stereo else None,
        bf=torch.full((K,), cfg.camera.bf, dtype=torch.float32, device=dev) if stereo else None,
    )
    res = ba.bundle_adjust_cg(prob, iters=iters, cg_iters=cg_iters)
    return m._replace(kf_pose=torch.where(m.kf_valid[:, None, None], res.T_cw, m.kf_pose),
                      lm_pos=res.points), res.cost


# ---------------------------------------------------------------------------
# Relocalization
# ---------------------------------------------------------------------------

def relocalize_against_kf(cfg: SlamConfig, m: ms.MapState, feats, K, cand,
                          generator: torch.Generator | None = None, draw=None):
    """PnP relocalization of a frame against keyframe ``cand``
    (Tracking::Relocalization: SearchByBoW -> PnP RANSAC ->
    PoseOptimization). Returns (success, T_cw, feat_lm, n_inliers)."""
    has = m.kf_feat_valid[cand] & (m.kf_obs_lm[cand] >= 0)
    lm = torch.clamp_min(m.kf_obs_lm[cand], 0)
    has = has & m.lm_valid[lm.long()]
    res = matching.match(feats.desc, m.kf_desc[cand], feats.valid, has,
                         max_dist=float(cfg.matcher.th_low), ratio=0.75, mutual=True,
                         angles_a=feats.angle, angles_b=m.kf_angle[cand])
    res = matching.resolve_duplicates(res, has.shape[0])
    feat_lm = torch.where(res.ok, lm[res.idx.long()], torch.full_like(res.idx, -1))
    use = feat_lm >= 0
    pts = m.lm_pos[torch.clamp_min(feat_lm, 0).long()]
    idx = _drawer(generator, draw)(use, 128, 6)
    pnp = ransac.pnp_ransac(pts, feats.xy, use, K, min_inliers=10, idx=idx)
    sigma2 = (cfg.tracking.pixel_noise * cfg.orb.scale_factor ** feats.level.to(torch.float32)) ** 2
    opt = ba.pose_optimize(pnp.T_cw, K, pts, feats.xy, use & pnp.inliers, sigma2=sigma2)
    feat_lm = torch.where(opt.inliers, feat_lm, torch.full_like(feat_lm, -1))
    return pnp.success & (opt.n_inliers >= 30), opt.T_cw, feat_lm, opt.n_inliers


# ---------------------------------------------------------------------------
# Cross-map scan and verification (the MultiMapper's)
# ---------------------------------------------------------------------------

def batched_merge_scan_scores(cfg: SlamConfig, m_b: ms.MapState, bow_b: torch.Tensor, slots,
                              m_a: ms.MapState, bow_a: torch.Tensor):
    """Cross-map candidate retrieval for a batch of query keyframes
    ``slots`` [Q] of map B against map A's database (MultiMapper::DetectLoop,
    MultiMapper.cc:124-165): raw scores, the minScore normalizer from each
    query's B-covisible keyframes (MultiMapper.cc:145-162) and A-side
    covisibility-group accumulation.

    Returns (scores [Q,K_A], min_score [Q], acc [Q,K_A], neighbors
    [Q,K_A,K_A])."""
    slots = torch.as_tensor(slots, device=bow_b.device).long()
    v = bow_b[slots]  # [Q, n_words]
    scores = bow.bow_score(v, bow_a)
    scores = torch.where(m_a.kf_valid[None, :], scores, torch.full_like(scores, -1.0))
    conn = (ms.covisibility(m_b)[slots] > 0) & m_b.kf_valid[None, :]
    own = bow.bow_score(v, bow_b)
    min_score = torch.clamp_max(
        torch.where(conn, own, torch.full_like(own, float("inf"))).amin(-1), 1.0)
    min_score = torch.where(torch.isfinite(min_score), min_score,
                            torch.full_like(min_score, 0.05))
    nb = _group_neighbors(m_a, 10)  # candidate_groups' default group size
    acc = torch.stack([_accumulate_groups(nb, s) for s in scores])
    return scores, min_score, acc, nb.expand(len(slots), -1, -1)


def merge_scan_scores(cfg: SlamConfig, m_b: ms.MapState, bow_b: torch.Tensor, slot,
                      m_a: ms.MapState, bow_a: torch.Tensor):
    """``batched_merge_scan_scores`` for one query keyframe. Returns
    (scores [K_A], min_score, acc [K_A], neighbors [K_A,K_A])."""
    return tuple(x[0] for x in batched_merge_scan_scores(cfg, m_b, bow_b, [int(slot)],
                                                         m_a, bow_a))


def compute_loop_sim3_cross(cfg: SlamConfig, m_b: ms.MapState, m_a: ms.MapState, slot_b,
                            slot_a, generator: torch.Generator | None = None,
                            draw=None) -> LoopSim3:
    """Cross-map Sim3: keyframe ``slot_b`` of map B against ``slot_a`` of
    map A (the MultiMapper's merge verification, MultiMapper.cc:209-316).
    S_ba maps B-keyframe camera coords -> A-keyframe camera coords."""
    has_b, pb = _landmark_side(m_b, slot_b)
    has_a, pa = _landmark_side(m_a, slot_a)
    success, S, n = _sim3_between_feature_sets(
        cfg,
        m_b.kf_desc[slot_b], m_b.kf_angle[slot_b], pb, has_b,
        m_a.kf_desc[slot_a], m_a.kf_angle[slot_a], pa, has_a,
        m_b.kf_K[slot_b], m_a.kf_K[slot_a], _drawer(generator, draw),
        fix_scale=cfg.sensor != "mono",
    )
    return LoopSim3(success=success, S_ba=S, n_inliers=n)
