"""Nonlinear least squares (port of orbslamm_tpu/ops/ba.py, monocular edges):
motion-only BA, window Schur BA, the Sim3 pose graph, Sim3 refinement and
the edge-list BAs, with a dense Schur solve (``bundle_adjust``) and with a
matrix-free one (``bundle_adjust_cg``, global BA). Each edge-list BA is an
edge pass per block of edges (residuals, Jacobians, partial normal-equation
blocks) and one solve on the poses' device; ``*_shards`` take the edges in
blocks on any devices (``parallel/dist_ba.py``), and one block is the
single-device call.

All are fixed-count Levenberg–Marquardt loops. Where the JAX package skips
the iterations after convergence with ``lax.cond`` inside ``lax.scan``, a
converged carry is frozen with ``torch.where`` here, so no decision ever
leaves the device; where it runs every iteration (pose graph, Sim3
refinement, global BA) so does the port. Linear solves use ``solve_ex`` /
``inv_ex`` (no error check, hence no host sync). Every float segment sum
(edge to camera, point, (camera, point) pair or pose-graph node) runs over a
plan of the solve's static edge list (``ops/cuda/segsum.py``), made once per
solve: on the card the sorted segment-sum kernel, which adds in one fixed
order with no atomics, so a solve gives the same bits on every run; on the
CPU ``index_add_`` in edge order. Stereo
and RGB-D observations add the reference's third residual row
``u - bf/z - u_r`` (EdgeStereoSE3Project*) with the 3-DoF chi2 gate; a
monocular problem (``ur_obs``/``obs_ur`` None) runs the 2-row code alone.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orbslamm_tpu_torch.ops import geometry as geo
from orbslamm_tpu_torch.ops.cuda import segsum as seg
from orbslamm_tpu_torch.utils.trace import stage

CHI2_MONO = 5.991  # 2-DoF 95% (reference Optimizer.cc chi2Mono)
CHI2_STEREO = 7.815  # 3-DoF 95% (reference Optimizer.cc chi2Stereo)


def _project_and_residual(T_cw, K, pts_w, uv_obs):
    pc = geo.transform_points(T_cw, pts_w)
    uv = geo.project(K, pc)
    return uv - uv_obs, pc


def _pose_jacobian(K, pc, bf=0.0, has_ur=None):
    """d(residual)/d(se3 left-perturbation of T_cw): [..., N, D, 6], D = 2,
    or 3 with the stereo row d(u - bf/z) (zero where ``has_ur`` is False)."""
    fx, fy = K[0, 0], K[1, 1]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    zi = 1.0 / torch.clamp_min(z, 1e-6)
    zi2 = zi * zi
    zero = torch.zeros_like(x)
    du = torch.stack([fx * zi, zero, -fx * x * zi2], dim=-1)
    dv = torch.stack([zero, fy * zi, -fy * y * zi2], dim=-1)
    rows = [du, dv]
    if has_ur is not None:
        # d(u - bf/z)/dpc = du/dpc + [0, 0, bf/z^2]
        rows.append(torch.stack([fx * zi, zero, -fx * x * zi2 + bf * zi2], dim=-1)
                    * has_ur[..., None])
    dpd = torch.stack(rows, dim=-2)  # [..., N, D, 3]
    px = geo.skew(pc)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand_as(px)
    dpc = torch.cat([eye, -px], dim=-1)  # [..., N, 3, 6]
    return dpd @ dpc


class PoseOptResult(NamedTuple):
    T_cw: torch.Tensor  # [4,4] (or [B,4,4])
    inliers: torch.Tensor  # [N] bool (or [B,N])
    n_inliers: torch.Tensor  # int32 (or [B])


def _freeze(done, old, new):
    """Keep ``old`` where the (per-batch) ``done`` flag is set."""
    d = done.reshape(done.shape + (1,) * (new.ndim - done.ndim))
    return torch.where(d, old, new)


def pose_optimize(T_init, K, pts_w, uv_obs, valid, sigma2=1.0, rounds: int = 4,
                  iters: int = 10, chi2_th: float = CHI2_MONO, ur_obs=None,
                  bf: float = 0.0) -> PoseOptResult:
    """Motion-only bundle adjustment (reference Optimizer::PoseOptimization:
    4 rounds x 10 LM iterations, Huber, chi2 re-classification between
    rounds).

    ``T_init`` is [4,4] or a batch [B,4,4] of starting poses optimized
    independently against the same observations (the motion model's two
    basins). pts_w [N,3], uv_obs [N,2], valid [N], sigma2 scalar or [N].
    ``ur_obs`` [N]: stereo right-x measurements (-1 = a monocular
    observation) add the row ``u - bf/z - u_r``
    (EdgeStereoSE3ProjectXYZOnlyPose), which pins metric scale every frame;
    stereo rows are gated by the 3-DoF threshold.
    """
    with stage("ba.pose_optimize"):
        return _pose_optimize(T_init, K, pts_w, uv_obs, valid, sigma2, rounds, iters,
                              chi2_th, ur_obs, bf)


def _pose_optimize(T_init, K, pts_w, uv_obs, valid, sigma2, rounds, iters, chi2_th,
                   ur_obs=None, bf=0.0):
    batched = T_init.ndim == 3
    T = T_init if batched else T_init[None]
    B = T.shape[0]
    dev = T.device
    sigma2 = torch.as_tensor(sigma2, dtype=torch.float32, device=dev).expand(valid.shape)
    inv_s2 = 1.0 / sigma2
    has_ur = None if ur_obs is None else ur_obs >= 0.0
    if ur_obs is not None:
        chi2_th = torch.where(has_ur, torch.as_tensor(CHI2_STEREO, device=dev),
                              torch.as_tensor(chi2_th, dtype=torch.float32, device=dev))
    delta_h = torch.sqrt(chi2_th * sigma2)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)

    def residual(T):
        r, pc = _project_and_residual(T, K, pts_w, uv_obs)  # [B,N,2], [B,N,3]
        if ur_obs is None:
            return r, pc
        z = torch.clamp_min(pc[..., 2], 1e-6)
        u = r[..., 0] + uv_obs[:, 0]  # the projected u
        r3 = (u - bf / z - ur_obs) * has_ur
        return torch.cat([r, r3[..., None]], dim=-1), pc


    def cost_of(r, pc, mask):
        rrn2 = (r * r).sum(-1) * inv_s2
        hub = torch.where(rrn2 <= chi2_th, rrn2,
                          2.0 * torch.sqrt(chi2_th * rrn2) - chi2_th)
        return torch.where(mask & (pc[..., 2] > 1e-3), hub, torch.zeros_like(hub)).sum(-1)

    def lm_body(T, lam, mask):
        r, pc = residual(T)
        use = mask & ~(pc[..., 2] < 1e-3)
        J = _pose_jacobian(K, pc, bf, has_ur)  # [B,N,D,6]
        rn = torch.linalg.norm(r, dim=-1)
        w = torch.where(rn > delta_h, delta_h / torch.clamp_min(rn, 1e-9),
                        torch.ones_like(rn)) * inv_s2
        w = torch.where(use, w, torch.zeros_like(w))
        Jw = J * w[..., None, None]
        H = torch.einsum("znia,znib->zab", Jw, J)
        g = torch.einsum("znia,zni->za", Jw, r)
        H_lm = H + lam[:, None, None] * torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1)) \
            + 1e-8 * eye6
        dx = -torch.linalg.solve_ex(H_lm, g[..., None])[0][..., 0]
        T_new = geo.se3_exp(dx) @ T
        c_old = cost_of(r, pc, mask)
        r2, pc2 = residual(T_new)
        c_new = cost_of(r2, pc2, mask)
        better = c_new < c_old
        T_next = _freeze(~better, T, T_new)
        lam_next = torch.where(better, torch.clamp_min(lam * 0.5, 1e-6),
                               torch.clamp_max(lam * 4.0, 1e4))
        done = (better & (c_old - c_new <= 1e-5 * c_old)
                & ((dx * dx).sum(-1) < 1e-10)) | (~better & (lam_next >= 1e4))
        return T_next, lam_next, done

    def chi2_mask(T):
        r, pc = residual(T)
        chi2 = (r * r).sum(-1) * inv_s2
        return valid & (chi2 <= chi2_th) & (pc[..., 2] > 1e-3)

    mask = valid.expand(B, -1)
    for _ in range(rounds):
        lam = torch.full((B,), 1e-2, dtype=torch.float32, device=dev)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        for _ in range(iters):
            T_n, lam_n, done_n = lm_body(T, lam, mask)
            T = _freeze(done, T, T_n)
            lam = torch.where(done, lam, lam_n)
            done = done | done_n
        mask = chi2_mask(T)
    n_inl = mask.sum(-1).to(torch.int32)
    if not batched:
        return PoseOptResult(T_cw=T[0], inliers=mask[0], n_inliers=n_inl[0])
    return PoseOptResult(T_cw=T, inliers=mask, n_inliers=n_inl)


# ---------------------------------------------------------------------------
# Window-structured Schur BA (the local-mapping hot path)
# ---------------------------------------------------------------------------

class WindowBAResult(NamedTuple):
    T_cw: torch.Tensor  # [W,4,4]
    points: torch.Tensor  # [P,3]
    obs_inlier: torch.Tensor  # [W,M]
    cost: torch.Tensor


def _inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Batched closed-form (adjugate) 3x3 inverse; callers damp the diagonal
    first, so det > 0."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    inv_det = 1.0 / torch.where(det.abs() > 1e-20, det, torch.full_like(det, 1e-20))
    adj = torch.stack(
        [
            torch.stack([co00, co01, co02], -1),
            torch.stack([co10, co11, co12], -1),
            torch.stack([co20, co21, co22], -1),
        ],
        -2,
    )
    return adj * inv_det[..., None, None]


def _window_incidence(obs_point, obs_valid, P: int):
    """[W,P] feature-slot lookup: idx[w,p] = the lowest of camera w's M
    feature slots that observes point p (M = none).

    One formulation: a scatter-min of the slot index into a [W, P+1] table
    (invalid observations land in the spare column). The JAX package builds
    the same table as a [W,M,P] compare+min, which XLA fuses on the TPU;
    eagerly that would materialise W*M*P elements."""
    W, M = obs_point.shape
    key = torch.where(obs_valid, obs_point, torch.full_like(obs_point, P)).long()
    marr = torch.arange(M, dtype=torch.int64, device=obs_point.device).expand(W, M)
    idx = torch.full((W, P + 1), M, dtype=torch.int64, device=obs_point.device)
    idx = idx.scatter_reduce(1, key, marr, "amin")[:, :P]
    return idx, idx < M


def bundle_adjust_window(T_cw, K, cam_valid, cam_fixed, points, point_valid,
                         obs_point, obs_uv, obs_sigma2, obs_valid, iters: int = 8,
                         chi2_th: float = CHI2_MONO, lam0: float = 1e-4, obs_ur=None,
                         bf=None) -> WindowBAResult:
    """Schur-complement LM for a covisibility window (reference
    LocalBundleAdjustment, Optimizer.cc:475), in the window's [W,M]
    observation layout: camera blocks reduce over each camera's own
    features, point blocks gather through the [W,P] incidence table.

    T_cw [W,4,4], K [W,3,3], cam_valid/cam_fixed [W], points [P,3],
    point_valid [P], obs_point [W,M] int, obs_uv [W,M,2], obs_sigma2 [W,M],
    obs_valid [W,M]; stereo edges (EdgeStereoSE3ProjectXYZ): obs_ur [W,M]
    right-x (-1 = monocular) and bf [W].
    """
    W, M = obs_point.shape
    P = points.shape[0]
    dev = points.device
    chi2_e = chi2_th if obs_ur is None else torch.where(
        obs_ur >= 0.0, torch.as_tensor(CHI2_STEREO, device=dev),
        torch.as_tensor(chi2_th, dtype=torch.float32, device=dev))
    idx_wp, _ = _window_incidence(obs_point, obs_valid, P)

    def gather_wp(X):
        """[W,M,F] -> [W,P,F], zero where camera w does not observe p."""
        Xp = torch.cat([X, torch.zeros_like(X[:, :1])], dim=1)
        return Xp.gather(1, idx_wp[:, :, None].expand(-1, -1, X.shape[-1]))

    pt_of = torch.clamp(obs_point, 0, P - 1).long()
    free = ~cam_fixed
    fx = K[:, 0, 0][:, None]
    fy = K[:, 1, 1][:, None]
    cx = K[:, 0, 2][:, None]
    cy = K[:, 1, 2][:, None]
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    lock = cam_fixed | ~cam_valid
    lockv = lock.repeat_interleave(6)
    lock_mat = lockv[:, None] | lockv[None, :]
    eyeW6 = torch.eye(W * 6, dtype=torch.float32, device=dev)
    ar = torch.arange(W, device=dev)

    def residual(T_all, pts):
        pw = pts[pt_of]  # [W,M,3]
        R, t = T_all[:, :3, :3], T_all[:, :3, 3]
        pc = torch.einsum("wij,wmj->wmi", R, pw) + t[:, None, :]
        z = torch.clamp_min(pc[..., 2], 1e-6)
        u = fx * pc[..., 0] / z + cx
        v = fy * pc[..., 1] / z + cy
        r = torch.stack([u, v], -1) - obs_uv
        if obs_ur is not None:
            r3 = (u - bf[:, None] / z - obs_ur) * (obs_ur >= 0.0)
            r = torch.cat([r, r3[..., None]], -1)
        return r, pc

    def jacobians(pc, T_all):
        x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
        zi = 1.0 / torch.clamp_min(z, 1e-6)
        zi2 = zi * zi
        zero = torch.zeros_like(x)
        du = torch.stack([fx * zi, zero, -fx * x * zi2], -1)
        dv = torch.stack([zero, fy * zi, -fy * y * zi2], -1)
        rows = [du, dv]
        if obs_ur is not None:
            dur = torch.stack([fx * zi, zero, -fx * x * zi2 + bf[:, None] * zi2], -1)
            rows.append(dur * (obs_ur >= 0.0).to(pc.dtype)[..., None])
        dpd = torch.stack(rows, -2)  # [W,M,D,3]
        px = geo.skew(pc)
        Jc = dpd @ torch.cat([eye3.expand_as(px), -px], -1)  # [W,M,D,6]
        Jp = dpd @ T_all[:, None, :3, :3]  # [W,M,D,3]
        return Jc, Jp

    def cost_of(r, pc, use):
        chi2 = (r * r).sum(-1) / obs_sigma2
        hub = torch.where(chi2 <= chi2_e, chi2, 2.0 * torch.sqrt(chi2_e * chi2) - chi2_e)
        return torch.where(use & (pc[..., 2] > 1e-3), hub, torch.zeros_like(hub)).sum()

    base_use = obs_valid & cam_valid[:, None] & point_valid[pt_of]

    def step_body(T_all, pts, lam):
        r, pc = residual(T_all, pts)
        use = base_use & (pc[..., 2] > 1e-3)
        rn = torch.linalg.norm(r, dim=-1)
        delta = torch.sqrt(chi2_e * obs_sigma2)
        w = torch.where(rn > delta, delta / torch.clamp_min(rn, 1e-9),
                        torch.ones_like(rn)) / obs_sigma2
        w = torch.where(use, w, torch.zeros_like(w))
        Jc, Jp = jacobians(pc, T_all)
        Jc = Jc * free[:, None, None, None]
        wJc = Jc * w[..., None, None]
        wJp = Jp * w[..., None, None]

        Hcc = torch.einsum("wmia,wmib->wab", wJc, Jc)
        gc = torch.einsum("wmia,wmi->wa", wJc, r)
        opp = torch.einsum("wmia,wmib->wmab", wJp, Jp).reshape(W, M, 9)
        gp_ = torch.einsum("wmia,wmi->wma", wJp, r)
        ocp = torch.einsum("wmia,wmib->wmab", wJc, Jp).reshape(W, M, 18)
        G = gather_wp(torch.cat([opp, gp_, ocp, w[..., None]], dim=-1))  # [W,P,31]
        Hpp = G[..., 0:9].sum(0).reshape(P, 3, 3)
        gp = G[..., 9:12].sum(0)
        Wd = G[..., 12:30].reshape(W, P, 6, 3)

        tr_c = torch.diagonal(Hcc, dim1=-2, dim2=-1).sum(-1)
        Hcc_d = Hcc + ((lam + 1e-5) * eye6)[None] * torch.clamp_min(tr_c / 6.0, 1.0)[:, None, None]
        tr_p = torch.diagonal(Hpp, dim1=-2, dim2=-1).sum(-1)
        Hpp_d = Hpp + ((lam + 1e-5) * eye3)[None] * torch.clamp_min(tr_p / 3.0, 1.0)[:, None, None]
        observed = G[..., 30].sum(0) > 1e-9
        Hpp_d = torch.where(observed[:, None, None], Hpp_d, eye3[None])
        Hpp_inv = _inv3x3(Hpp_d)

        WHinv = torch.einsum("wpab,pbd->wpad", Wd, Hpp_inv)
        S = torch.einsum("wpad,vpbd->wvab", WHinv, Wd)
        Sfull = -S
        Sfull[ar, ar] += Hcc_d
        rhs = gc - torch.einsum("wpad,pd->wa", WHinv, gp)
        Smat = Sfull.permute(0, 2, 1, 3).reshape(W * 6, W * 6)
        Smat = torch.where(lock_mat, eyeW6, Smat)
        rhsv = torch.where(lockv, torch.zeros_like(lockv, dtype=rhs.dtype), rhs.reshape(-1))
        dc = -torch.linalg.solve_ex(Smat, rhsv[:, None])[0][:, 0].reshape(W, 6)
        Wt_dc = torch.einsum("wpab,wa->pb", Wd, dc)
        dp = -torch.einsum("pab,pb->pa", Hpp_inv, gp + Wt_dc)
        dp = dp * (point_valid & observed)[:, None]

        T_new = geo.se3_exp(dc) @ T_all
        T_new = torch.where(lock[:, None, None], T_all, T_new)
        pts_new = pts + dp

        c_old = cost_of(r, pc, base_use)
        r2, pc2 = residual(T_new, pts_new)
        c_new = cost_of(r2, pc2, base_use)
        finite = torch.isfinite(c_new) & torch.isfinite(T_new).all() & torch.isfinite(pts_new).all()
        better = (c_new < c_old) & finite
        T_next = torch.where(better, T_new, T_all)
        pts_next = torch.where(better, pts_new, pts)
        lam_next = torch.where(better, torch.clamp_min(lam * 0.3, 1e-8),
                               torch.clamp_max(lam * 5.0, 1e3))
        step_sq = (dc * dc).sum() + (dp * dp).sum()
        done = (better & (c_old - c_new <= 1e-5 * c_old) & (step_sq < 1e-10)) \
            | (~better & (lam_next >= 1e3))
        return T_next, pts_next, lam_next, done

    T_all, pts = T_cw, points
    lam = torch.tensor(lam0, dtype=torch.float32, device=dev)
    done = torch.tensor(False, device=dev)
    for _ in range(iters):
        T_n, pts_n, lam_n, done_n = step_body(T_all, pts, lam)
        T_all = torch.where(done, T_all, T_n)
        pts = torch.where(done, pts, pts_n)
        lam = torch.where(done, lam, lam_n)
        done = done | done_n
    r, pc = residual(T_all, pts)
    chi2 = (r * r).sum(-1) / obs_sigma2
    inlier = obs_valid & (chi2 <= chi2_e) & (pc[..., 2] > 1e-3)
    return WindowBAResult(T_cw=T_all, points=pts, obs_inlier=inlier,
                          cost=cost_of(r, pc, base_use))


# ---------------------------------------------------------------------------
# Sim3 pose-graph optimization (essential graph)
# ---------------------------------------------------------------------------

class PoseGraphProblem(NamedTuple):
    """Sim3 pose graph (reference Optimizer::OptimizeEssentialGraph): nodes
    are keyframe Sim3 poses (world -> KF), edges relative Sim3 measurements
    from the spanning tree, strong covisibility and loop closures."""

    S_iw: torch.Tensor  # [C,8] packed sim3 node poses (node-from-world)
    node_valid: torch.Tensor  # [C]
    node_fixed: torch.Tensor  # [C]
    edge_i: torch.Tensor  # [E] int32
    edge_j: torch.Tensor  # [E] int32
    edge_Sij: torch.Tensor  # [E,8] measured S_i o S_j^-1
    edge_valid: torch.Tensor  # [E]
    edge_weight: torch.Tensor  # [E] information scale


def _pg_residual(S_i, S_j, M_ij):
    """r = log(M_ij o S_j o S_i^-1): zero when S_i o S_j^-1 == M_ij."""
    return geo.sim3_log(geo.sim3_compose(M_ij, geo.sim3_compose(S_j, geo.sim3_inv(S_i))))


def _pg_edge_residual(xi_i, xi_j, S_i, S_j, M):
    return _pg_residual(geo.sim3_compose(geo.sim3_exp(xi_i), S_i),
                        geo.sim3_compose(geo.sim3_exp(xi_j), S_j), M)


def _jacfwd_batched(f, x: torch.Tensor) -> torch.Tensor:
    """Forward-mode Jacobian of a function batched over a leading axis:
    x [B, D] -> f(x) [B, R]; returns [B, R, D], one JVP per input dimension
    (under ``torch.func.vmap``), the derivatives ``jax.jacfwd`` computes.
    Every tensor keeps its batch axis: forward-mode AD promotes the tangent
    of a 0-d tensor combined with a Python float to float64."""
    B, D = x.shape
    basis = torch.eye(D, dtype=x.dtype, device=x.device)[:, None, :].expand(D, B, D)
    J = torch.func.vmap(lambda t: torch.func.jvp(f, (x,), (t,))[1])(basis)  # [D,B,R]
    return J.permute(1, 2, 0)


def _seg_add(plan: seg.SegmentPlan, vals: torch.Tensor, form: str = "scatter") -> torch.Tensor:
    """Segment sum of edge values over ``plan`` (``seg.segment_plan``): on
    a CUDA tensor the fixed-order kernel; on the CPU ``index_add_`` in edge
    order, or with ``form="sorted"`` the JAX package's sorted form."""
    return seg.segment_sum(plan, vals.contiguous(), form)


def _seg_add_pair(plan: seg.SegmentPlan, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` summed over the pair plan's first edge list plus ``b`` over its
    second (``seg.segment_plan_pair``): one kernel launch on the card; on
    the CPU ``index_add_`` of each in edge order, then one add."""
    return seg.segment_sum_pair(plan, a.contiguous(), b.contiguous())


def pose_graph_optimize(p: PoseGraphProblem, iters: int = 20, lam0: float = 1e-4,
                        cg_iters: int = 50) -> torch.Tensor:
    """Matrix-free LM over the Sim3 pose graph; returns optimized S_iw [C,8].

    Per-edge Jacobians are exact forward-mode derivatives (as the JAX
    package's ``vmap(jacfwd)``), computed for all edges at once. H x is
    two edge gathers and one segment sum over both ends of every edge (a
    pair plan: one kernel launch on the card), solved by a fixed count of
    block-Jacobi preconditioned CG iterations. Like the JAX
    package's ``lax.scan``, every LM and CG iteration runs; a rejected step
    leaves S unchanged."""
    with stage("ba.pose_graph"):
        return _pose_graph_optimize(p, iters, lam0, cg_iters)


def _pose_graph_optimize(p, iters, lam0, cg_iters):
    C = p.S_iw.shape[0]
    E = p.edge_i.shape[0]
    dev = p.S_iw.device
    ei, ej = p.edge_i.long(), p.edge_j.long()
    seg_ij = seg.segment_plan_pair(ei, ej, C)  # each product sums over both ends at once
    zeros = torch.zeros((E, 7), dtype=torch.float32, device=dev)

    def jac(Si, Sj):
        J = _jacfwd_batched(
            lambda x: _pg_edge_residual(x[:, :7], x[:, 7:], Si, Sj, p.edge_Sij),
            torch.zeros((E, 14), dtype=torch.float32, device=dev))
        return J[..., :7], J[..., 7:]

    lock = p.node_fixed | ~p.node_valid
    w = torch.where(p.edge_valid, p.edge_weight, torch.zeros_like(p.edge_weight))
    eye7 = torch.eye(7, dtype=torch.float32, device=dev)

    def total_cost(S):
        r = _pg_edge_residual(zeros, zeros, S[ei], S[ej], p.edge_Sij)
        return (w * (r * r).sum(-1)).sum()

    S = p.S_iw
    lam = torch.tensor(lam0, dtype=torch.float32, device=dev)
    for _ in range(iters):
        Si, Sj = S[ei], S[ej]
        r = _pg_edge_residual(zeros, zeros, Si, Sj, p.edge_Sij)  # [E,7]
        Ji, Jj = jac(Si, Sj)  # [E,7,7] each
        wJi = Ji * w[:, None, None]
        wJj = Jj * w[:, None, None]
        g = _seg_add_pair(seg_ij, torch.einsum("eia,ei->ea", wJi, r),
                          torch.einsum("eia,ei->ea", wJj, r))
        Hd = _seg_add_pair(seg_ij, torch.einsum("eia,eib->eab", wJi, Ji),
                           torch.einsum("eia,eib->eab", wJj, Jj))
        damp = (lam + 1e-6) * torch.clamp_min(torch.diagonal(Hd, dim1=-2, dim2=-1), 1.0)

        def mv(x, Ji=Ji, Jj=Jj, wJi=wJi, wJj=wJj, damp=damp):
            y = torch.einsum("eab,eb->ea", Ji, x[ei]) + torch.einsum("eab,eb->ea", Jj, x[ej])
            out = _seg_add_pair(seg_ij, torch.einsum("eab,ea->eb", wJi, y),
                                torch.einsum("eab,ea->eb", wJj, y))
            return torch.where(lock[:, None], x, out + damp * x)

        Hd_damped = torch.where(lock[:, None, None], eye7, Hd + torch.diag_embed(damp))
        Minv = torch.linalg.inv_ex(Hd_damped + 1e-8 * eye7)[0]
        rhs = torch.where(lock[:, None], torch.zeros_like(g), -g)
        x = torch.zeros((C, 7), dtype=torch.float32, device=dev)
        rr = rhs
        pv = torch.einsum("cab,cb->ca", Minv, rhs)
        rz = (rr * pv).sum()
        for _ in range(cg_iters):
            Ap = mv(pv)
            alpha = rz / torch.clamp_min((pv * Ap).sum(), 1e-12)
            x = x + alpha * pv
            rr = rr - alpha * Ap
            z = torch.einsum("cab,cb->ca", Minv, rr)
            rz_new = (rr * z).sum()
            beta = rz_new / torch.clamp_min(rz, 1e-12)
            pv = z + beta * pv
            rz = rz_new
        dx = torch.where(lock[:, None], torch.zeros_like(x), x)
        S_new = geo.sim3_compose(geo.sim3_exp(dx), S)
        S_new = torch.where(lock[:, None], S, S_new)
        c_old = total_cost(S)
        c_new = total_cost(S_new)
        better = (c_new < c_old) & torch.isfinite(c_new)
        S = torch.where(better, S_new, S)
        lam = torch.where(better, torch.clamp_min(lam * 0.3, 1e-7), torch.clamp_max(lam * 5.0, 1e4))
    return S


# ---------------------------------------------------------------------------
# Sim3 refinement (OptimizeSim3)
# ---------------------------------------------------------------------------

class Sim3RefineResult(NamedTuple):
    S: torch.Tensor  # [8] refined packed Sim3 (frame-1 points -> frame-2 coords)
    inliers: torch.Tensor  # [N] bool — both-direction chi2 survivors
    n_inliers: torch.Tensor  # int32


def sim3_refine(S21, pts1, pts2, valid, K1, K2, sigma2=1.0, iters: int = 8,
                chi2_th: float = 10.0, fix_scale: bool = False) -> Sim3RefineResult:
    """Nonlinear Sim3 refinement with bidirectional projection edges (the
    reference Optimizer::OptimizeSim3 analog): a forward edge (point 1
    through S21 into image 2) and a backward edge (point 2 through S21^-1
    into image 1) per correspondence, each Huber-weighted and truncated far
    outside the Huber zone; LM on the 7-DoF tangent (6 with ``fix_scale``).
    Inliers pass ``chi2_th`` in both directions at the refined transform."""
    dev = pts1.device
    sigma2 = torch.as_tensor(sigma2, dtype=torch.float32, device=dev).expand(valid.shape)
    inv_s2 = 1.0 / sigma2
    uv1 = geo.project(K1, pts1)
    uv2 = geo.project(K2, pts2)
    delta = chi2_th ** 0.5
    eye7 = torch.eye(7, dtype=torch.float32, device=dev)

    def residuals(S):
        p12 = geo.sim3_apply(S, pts1)
        p21 = geo.sim3_apply(geo.sim3_inv(S), pts2)
        return geo.project(K2, p12) - uv2, geo.project(K1, p21) - uv1, p12[..., 2], p21[..., 2]

    def cost(S_):
        rf, rb, zf, zb = residuals(S_)
        c2f = (rf * rf).sum(-1) * inv_s2
        c2b = (rb * rb).sum(-1) * inv_s2
        cap = 2.0 * delta * (36.0 * chi2_th) ** 0.5 - chi2_th

        def hub(c2):
            h = torch.where(c2 <= chi2_th, c2, 2.0 * delta * torch.sqrt(c2) - chi2_th)
            return torch.clamp_max(h, cap)

        ok = valid & (zf > 1e-3) & (zb > 1e-3)
        return torch.where(ok, hub(c2f) + hub(c2b), torch.zeros_like(c2f)).sum()

    S = S21
    lam = torch.tensor(1e-4, dtype=torch.float32, device=dev)
    zero = torch.zeros((1, 7), dtype=torch.float32, device=dev)
    for _ in range(iters):
        def r_of(xi, S=S):  # [1,7] -> [1, N*4]; S keeps a batch axis of 1
            r_f, r_b, _, _ = residuals(geo.sim3_compose(geo.sim3_exp(xi), S[None]))
            return torch.cat([r_f, r_b], dim=-1).reshape(1, -1)

        N = pts1.shape[0]
        r = r_of(zero).reshape(N, 4)
        J = _jacfwd_batched(r_of, zero).reshape(N, 4, 7)
        if fix_scale:
            J = torch.cat([J[..., :6], torch.zeros_like(J[..., 6:])], -1)
        r_f, r_b, z_f, z_b = residuals(S)
        use = valid & (z_f > 1e-3) & (z_b > 1e-3)
        nf = torch.sqrt((r_f * r_f).sum(-1) * inv_s2 + 1e-12)
        nb = torch.sqrt((r_b * r_b).sum(-1) * inv_s2 + 1e-12)
        w_f = torch.where(nf > delta, delta / nf, torch.ones_like(nf)) * inv_s2
        w_b = torch.where(nb > delta, delta / nb, torch.ones_like(nb)) * inv_s2
        w_f = torch.where(nf > 6.0 * delta, torch.zeros_like(w_f), w_f)
        w_b = torch.where(nb > 6.0 * delta, torch.zeros_like(w_b), w_b)
        w4 = torch.stack([w_f, w_f, w_b, w_b], -1) * use[:, None]
        Jw = J * w4[..., None]
        H = torch.einsum("nia,nib->ab", Jw, J) + 1e-6 * eye7
        g = torch.einsum("nia,ni->a", Jw, r)
        H = H + lam * torch.diag(torch.diagonal(H))
        if fix_scale:
            H = H.clone()
            H[6, 6] = 1.0
        dx = -torch.linalg.solve_ex(H, g[:, None])[0][:, 0]
        if fix_scale:
            dx = torch.cat([dx[:6], torch.zeros_like(dx[6:])])
        S_new = geo.sim3_compose(geo.sim3_exp(dx), S)
        better = (cost(S_new) < cost(S)) & torch.isfinite(S_new).all()
        S = torch.where(better, S_new, S)
        lam = torch.where(better, torch.clamp_min(lam * 0.3, 1e-7), torch.clamp_max(lam * 5.0, 1e4))
    r_f, r_b, z_f, z_b = residuals(S)
    c2f = (r_f * r_f).sum(-1) * inv_s2
    c2b = (r_b * r_b).sum(-1) * inv_s2
    inl = valid & (c2f < chi2_th) & (c2b < chi2_th) & (z_f > 1e-3) & (z_b > 1e-3)
    return Sim3RefineResult(S=S, inliers=inl, n_inliers=inl.sum().to(torch.int32))


# ---------------------------------------------------------------------------
# Edge-list bundle adjustment with a matrix-free Schur solve (global BA)
# ---------------------------------------------------------------------------

class BAProblem(NamedTuple):
    """Fixed-capacity bundle-adjustment problem in edge-list form. Stereo
    edges (EdgeStereoSE3ProjectXYZ) carry a right-x measurement in
    ``obs_ur`` (-1 = a monocular edge) and their camera's ``bf``; both None
    make a monocular problem."""

    T_cw: torch.Tensor  # [C,4,4] camera poses
    K: torch.Tensor  # [C,3,3] per-camera intrinsics
    cam_valid: torch.Tensor  # [C] bool
    cam_fixed: torch.Tensor  # [C] bool — gauge anchors
    points: torch.Tensor  # [P,3]
    point_valid: torch.Tensor  # [P] bool
    obs_cam: torch.Tensor  # [E] int32
    obs_point: torch.Tensor  # [E] int32
    obs_uv: torch.Tensor  # [E,2]
    obs_sigma2: torch.Tensor  # [E]
    obs_valid: torch.Tensor  # [E] bool
    obs_ur: torch.Tensor | None = None  # [E]
    bf: torch.Tensor | None = None  # [C]


class BAResult(NamedTuple):
    T_cw: torch.Tensor
    points: torch.Tensor
    obs_inlier: torch.Tensor  # [E] final chi2 classification
    cost: torch.Tensor


def _ba_residuals(T_cw, K, points, p: BAProblem):
    oc, op = p.obs_cam.long(), p.obs_point.long()
    Tc = T_cw[oc]  # [E,4,4]
    Kc = K[oc]
    pc = torch.einsum("eij,ej->ei", Tc[:, :3, :3], points[op]) + Tc[:, :3, 3]
    uv = geo.project(Kc, pc)
    r = uv - p.obs_uv
    if p.obs_ur is not None:
        # stereo third row (u - bf/z) - u_r, zero on monocular edges
        z = torch.clamp_min(pc[:, 2], 1e-6)
        r3 = (uv[:, 0] - p.bf[oc] / z - p.obs_ur) * (p.obs_ur >= 0.0)
        r = torch.cat([r, r3[:, None]], -1)  # [E,3]
    return r, pc, Tc, Kc


def _ba_jacobians(Kc, Tc, pc, p: BAProblem):
    """Per-edge J wrt camera twist [E,D,6] and wrt point [E,D,3] (D = 2
    monocular, 3 with the stereo row)."""
    fx, fy = Kc[:, 0, 0], Kc[:, 1, 1]
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    zi = 1.0 / torch.clamp_min(z, 1e-6)
    zi2 = zi * zi
    zero = torch.zeros_like(x)
    du = torch.stack([fx * zi, zero, -fx * x * zi2], -1)
    dv = torch.stack([zero, fy * zi, -fy * y * zi2], -1)
    rows = [du, dv]
    if p.obs_ur is not None:
        bf_e = p.bf[p.obs_cam.long()]
        # d(u - bf/z)/dpc = du/dpc + [0, 0, bf/z^2]
        dur = torch.stack([fx * zi, zero, -fx * x * zi2 + bf_e * zi2], -1)
        rows.append(dur * (p.obs_ur >= 0.0).to(pc.dtype)[:, None])
    dpd = torch.stack(rows, -2)  # [E,D,3]
    px = geo.skew(pc)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand_as(px)
    Jc = dpd @ torch.cat([eye, -px], -1)
    Jp = dpd @ Tc[:, :3, :3]
    return Jc, Jp


def _chi2_per_edge(p: BAProblem, chi2_th):
    """Per-edge chi2 gate: the 3-DoF threshold on stereo edges."""
    if p.obs_ur is None:
        return chi2_th
    return torch.where(p.obs_ur >= 0.0, torch.as_tensor(CHI2_STEREO, device=p.obs_ur.device),
                       torch.as_tensor(chi2_th, dtype=torch.float32, device=p.obs_ur.device))


def _robust_weights(r, sigma2, use, chi2_th):
    """Huber IRLS weight times information (1/sigma2)."""
    rn = torch.linalg.norm(r, dim=-1)
    delta = torch.sqrt(chi2_th * sigma2)
    w = torch.where(rn > delta, delta / torch.clamp_min(rn, 1e-9), torch.ones_like(rn)) / sigma2
    return torch.where(use, w, torch.zeros_like(w))


def _ba_cost_from_residual(r, pc, p: BAProblem, use, chi2_th):
    chi2 = (r * r).sum(-1) / p.obs_sigma2
    hub = torch.where(chi2 <= chi2_th, chi2, 2.0 * torch.sqrt(chi2_th * chi2) - chi2_th)
    return torch.where(use & (pc[:, 2] > 1e-3), hub, torch.zeros_like(hub)).sum()


def _ba_cost(T_cw, K, points, p: BAProblem, use, chi2_th):
    r, pc, _, _ = _ba_residuals(T_cw, K, points, p)
    return _ba_cost_from_residual(r, pc, p, use, chi2_th)


def _sum_to(parts, dev):
    """Per-shard partial sums added on ``dev`` in shard order (the all-reduce
    that GSPMD inserts in the JAX package). One part is returned as it is."""
    out = parts[0].to(dev)
    for x in parts[1:]:
        out = out + x.to(dev)
    return out


def _to_shards(x, shards):
    """``x`` on every shard's device (no copy where it already lies there)."""
    return [x.to(s.obs_cam.device) for s in shards]


def _place_shards(p: BAProblem, shards) -> list:
    """Each edge shard with the static camera and point fields of ``p``
    (intrinsics, validity, gauge, stereo baseline) on the shard's device.
    The poses and points change every LM step and are passed on their own."""
    out = []
    for s in shards:
        dev = s.obs_cam.device
        out.append(s._replace(
            K=p.K.to(dev), cam_valid=p.cam_valid.to(dev), cam_fixed=p.cam_fixed.to(dev),
            point_valid=p.point_valid.to(dev), bf=None if p.bf is None else p.bf.to(dev)))
    return out


class EdgePlans(NamedTuple):
    """The segment plans of one shard's static edge list."""

    cam: seg.SegmentPlan  # edges by camera
    point: seg.SegmentPlan  # edges by point
    pair: seg.SegmentPlan | None  # edges by (camera, point) pair: the dense Schur's W
    form: str  # the CPU's segment-sum form, "scatter" or "sorted"


def _edge_plans(s: BAProblem, C: int, Pn: int, dense: bool, form: str = "scatter") -> EdgePlans:
    oc, op = s.obs_cam.long(), s.obs_point.long()
    return EdgePlans(cam=seg.segment_plan(oc, C), point=seg.segment_plan(op, Pn),
                     pair=seg.segment_plan(oc * Pn + op, C * Pn) if dense else None,
                     form=form)


def _edge_pass(T_cw, points, s: BAProblem, chi2_e, plans: EdgePlans):
    """One shard's edge pass at the current poses and points: residuals,
    robust weights and Jacobians of its edges, reduced over the shard's
    ``plans`` into the partial normal-equation blocks. Returns (partials,
    Wcp): partials are ``Hcc`` [C,6,6], ``Hpp`` [P,3,3], ``gc`` [C,6],
    ``gp`` [P,3], ``w_per_pt`` [P], the current cost and, with a pair plan,
    ``Wd`` [C,P,6,3]; ``Wcp`` [E,6,3] is the per-edge camera-point block,
    which stays on the shard (the CG's edge products read it)."""
    C, Pn = T_cw.shape[0], points.shape[0]
    oc, op = s.obs_cam.long(), s.obs_point.long()
    r, pc, Tc, Kc = _ba_residuals(T_cw, s.K, points, s)
    use = s.obs_valid & s.cam_valid[oc] & s.point_valid[op] & (pc[:, 2] > 1e-3)
    w = _robust_weights(r, s.obs_sigma2, use, chi2_e)
    Jc, Jp = _ba_jacobians(Kc, Tc, pc, s)
    # fixed cameras' Jacobians are zero: no update, no Schur coupling
    Jc = Jc * (~s.cam_fixed)[oc][:, None, None]
    wJc = Jc * w[:, None, None]
    wJp = Jp * w[:, None, None]
    f = plans.form
    parts = {
        "Hcc": _seg_add(plans.cam, torch.einsum("eia,eib->eab", wJc, Jc), f),
        "Hpp": _seg_add(plans.point, torch.einsum("eia,eib->eab", wJp, Jp), f),
        "gc": _seg_add(plans.cam, torch.einsum("eia,ei->ea", wJc, r), f),
        "gp": _seg_add(plans.point, torch.einsum("eia,ei->ea", wJp, r), f),
        "w_per_pt": _seg_add(plans.point, w, f),
        "cost": _ba_cost_from_residual(r, pc, s, s.obs_valid, chi2_e),
    }
    Wcp = torch.einsum("eia,eib->eab", wJc, Jp)  # [E,6,3]
    if plans.pair is not None:
        parts["Wd"] = _seg_add(plans.pair, Wcp, f).reshape(C, Pn, 6, 3)
    return parts, Wcp


def _reduce(partials, dev) -> dict:
    return {k: _sum_to([pt[k] for pt in partials], dev) for k in partials[0]}


def _damped_blocks(red, lam):
    """LM damping (an absolute floor keeps barely observed blocks
    invertible); points without an effective observation get an identity
    block. Returns (Hcc_d, Hpp_inv, observed)."""
    dev = red["Hcc"].device
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    Hcc, Hpp = red["Hcc"], red["Hpp"]
    tr_c = torch.diagonal(Hcc, dim1=-2, dim2=-1).sum(-1)
    Hcc_d = Hcc + ((lam + 1e-5) * eye6)[None] * torch.clamp_min(tr_c / 6.0, 1.0)[:, None, None]
    tr_p = torch.diagonal(Hpp, dim1=-2, dim2=-1).sum(-1)
    Hpp_d = Hpp + ((lam + 1e-5) * eye3)[None] * torch.clamp_min(tr_p / 3.0, 1.0)[:, None, None]
    observed = red["w_per_pt"] > 1e-9
    Hpp_d = torch.where(observed[:, None, None], Hpp_d, eye3[None])
    return Hcc_d, _inv3x3(Hpp_d), observed


def _trial_cost(T_new, pts_new, shards, chi2s, dev):
    parts = [_ba_cost(Tn, s.K, pn, s, s.obs_valid, c2)
             for Tn, pn, s, c2 in zip(_to_shards(T_new, shards), _to_shards(pts_new, shards),
                                      shards, chi2s)]
    return _sum_to(parts, dev)


def _final_pass(T_cw, points, shards, chi2s, dev, with_cost: bool):
    """Per-shard chi2 inlier masks at the solution, and with ``with_cost``
    the summed robust cost there (else None)."""
    inliers, costs = [], []
    for Tn, pn, s, c2 in zip(_to_shards(T_cw, shards), _to_shards(points, shards), shards, chi2s):
        r, pc, _, _ = _ba_residuals(Tn, s.K, pn, s)
        chi2 = (r * r).sum(-1) / s.obs_sigma2
        inliers.append(s.obs_valid & (chi2 <= c2) & (pc[:, 2] > 1e-3))
        if with_cost:
            costs.append(_ba_cost_from_residual(r, pc, s, s.obs_valid, c2))
    return tuple(inliers), _sum_to(costs, dev) if with_cost else None


def bundle_adjust(p: BAProblem, iters: int = 10, chi2_th: float = CHI2_MONO,
                  lam0: float = 1e-4) -> BAResult:
    """Levenberg–Marquardt BA with a dense Schur-complement camera solve
    (reference Optimizer::BundleAdjustment / LocalBundleAdjustment,
    Optimizer.cc:67/:475): per-point 3x3 blocks inverted in batch, the
    reduced camera system a dense [6C, 6C] solve, fixed cameras constrain
    but receive no update. Stops early as the JAX package does: a step
    that is accepted, tiny and gains nothing, or a rejected step at the
    damping cap, freezes the carry for the remaining iterations."""
    with stage("ba.dense"):
        res = bundle_adjust_shards(p, [p], iters, chi2_th, lam0)
    return res._replace(obs_inlier=res.obs_inlier[0])


def bundle_adjust_shards(p: BAProblem, shards, iters: int = 10, chi2_th: float = CHI2_MONO,
                         lam0: float = 1e-4) -> BAResult:
    """``bundle_adjust`` with the observation edges split into ``shards``
    (BAProblems whose edge fields are one block of the edge list each, on
    any device; their other fields are not read). The poses, points and the
    solve live on ``p``'s device; each LM step runs every shard's edge pass
    on its own device and sums the partial blocks there, in shard order.
    With ``shards == [p]`` this is ``bundle_adjust``. Returns a BAResult
    whose ``obs_inlier`` holds one mask per shard."""
    dev = p.T_cw.device
    C, Pn = p.T_cw.shape[0], p.points.shape[0]
    shards = _place_shards(p, shards)
    chi2s = [_chi2_per_edge(s, chi2_th) for s in shards]
    plans = [_edge_plans(s, C, Pn, dense=True) for s in shards]
    lock = p.cam_fixed | ~p.cam_valid
    lockv = lock.repeat_interleave(6)
    eyeC = torch.eye(C * 6, dtype=torch.float32, device=dev)
    T_cw, points = p.T_cw, p.points
    lam = torch.tensor(lam0, dtype=torch.float32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(iters):
        parts = [_edge_pass(Tn, pn, s, c2, pl)[0]
                 for Tn, pn, s, c2, pl in zip(_to_shards(T_cw, shards),
                                              _to_shards(points, shards), shards, chi2s, plans)]
        red = _reduce(parts, dev)
        Hcc_d, Hpp_inv, observed = _damped_blocks(red, lam)
        Wd, gc, gp = red["Wd"], red["gc"], red["gp"]
        # S = Hcc - W Hpp^-1 W^T ; rhs = gc - W Hpp^-1 gp
        WHinv = torch.einsum("cpab,pbd->cpad", Wd, Hpp_inv)
        Sfull = -torch.einsum("cpad,qpbd->cqab", WHinv, Wd)  # [C,C,6,6]
        ar = torch.arange(C, device=dev)
        Sfull[ar, ar] += Hcc_d
        rhs = gc - torch.einsum("cpad,pd->ca", WHinv, gp)
        Smat = Sfull.permute(0, 2, 1, 3).reshape(C * 6, C * 6)
        # fixed or invalid cameras: identity rows, no update
        Smat = torch.where(lockv[:, None] | lockv[None, :], eyeC, Smat)
        rhsv = torch.where(lockv, torch.zeros_like(lockv, dtype=torch.float32), rhs.reshape(-1))
        dc = -torch.linalg.solve_ex(Smat, rhsv[:, None])[0][:, 0].reshape(C, 6)
        # back-substitute the points: dp = -Hpp^-1 (gp + W^T dc)
        Wt_dc = torch.einsum("cpab,ca->pb", Wd, dc)
        dp = -torch.einsum("pab,pb->pa", Hpp_inv, gp + Wt_dc)
        dp = dp * (p.point_valid & observed)[:, None]

        T_new = geo.se3_exp(dc) @ T_cw
        T_new = torch.where(lock[:, None, None], T_cw, T_new)
        pts_new = points + dp
        c_old = red["cost"]
        c_new = _trial_cost(T_new, pts_new, shards, chi2s, dev)
        finite = torch.isfinite(c_new) & torch.isfinite(T_new).all() & torch.isfinite(pts_new).all()
        better = (c_new < c_old) & finite
        lam_new = torch.where(better, torch.clamp_min(lam * 0.3, 1e-8),
                              torch.clamp_max(lam * 5.0, 1e3))
        # converged (both a tiny accepted step and a negligible gain), or
        # pinned damping with no acceptable step: the carry freezes
        step_sq = (dc * dc).sum() + (dp * dp).sum()
        done_new = ((better & (c_old - c_new <= 1e-5 * c_old) & (step_sq < 1e-10))
                    | (~better & (lam_new >= 1e3)))
        T_cw = _freeze(done, T_cw, torch.where(better, T_new, T_cw))
        points = _freeze(done, points, torch.where(better, pts_new, points))
        lam = _freeze(done, lam, lam_new)
        done = done | done_new
    inliers, cost = _final_pass(T_cw, points, shards, chi2s, dev, with_cost=True)
    return BAResult(T_cw=T_cw, points=points, obs_inlier=inliers, cost=cost)


def bundle_adjust_cg(p: BAProblem, iters: int = 10, cg_iters: int = 30,
                     chi2_th: float = CHI2_MONO, lam0: float = 1e-4,
                     segsum: str = "scatter") -> BAResult:
    """LM bundle adjustment with a matrix-free Schur solve (reference
    RunGlobalBundleAdjustment): the reduced camera system is solved by a
    fixed count of block-Jacobi preconditioned CG iterations whose
    matrix-vector product is three edge-wise segment sums.
    ``cost`` is the last iteration's trial cost, as in the JAX package.

    ``segsum`` is the JAX package's parameter: on the CPU "scatter"
    (default) sums with ``index_add_`` in edge order and "sorted" with the
    JAX package's sorted form (``_make_sorted_segsum``: gather in sorted
    order, a float64 running sum, boundary differences). On the card both
    run the one fixed-order segment-sum kernel: both compute the same
    segment sum, so both give the same bits. Any other value raises."""
    with stage("ba.global_cg"):
        res = bundle_adjust_cg_shards(p, [p], iters, cg_iters, chi2_th, lam0, segsum)
    return res._replace(obs_inlier=res.obs_inlier[0])


def bundle_adjust_cg_shards(p: BAProblem, shards, iters: int = 10, cg_iters: int = 30,
                            chi2_th: float = CHI2_MONO, lam0: float = 1e-4,
                            segsum: str = "scatter") -> BAResult:
    """``bundle_adjust_cg`` with the observation edges split into ``shards``
    (as in ``bundle_adjust_shards``). Each shard keeps its edges' Jacobian
    blocks and segment plans; once per LM step its partial blocks are
    summed on ``p``'s device, and once per CG iteration the [P,3] and [C,6]
    partials of its edge products. With ``shards == [p]`` this is
    ``bundle_adjust_cg``. ``obs_inlier`` holds one mask per shard;
    ``segsum`` is ``bundle_adjust_cg``'s."""
    if segsum not in seg.FORMS:
        raise ValueError(f"segsum={segsum!r}: expected one of {seg.FORMS}")
    C = p.T_cw.shape[0]
    dev = p.points.device
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    shards = _place_shards(p, shards)
    chi2s = [_chi2_per_edge(s, chi2_th) for s in shards]
    ocs = [s.obs_cam.long() for s in shards]
    ops = [s.obs_point.long() for s in shards]
    Pn = p.points.shape[0]
    plans = [_edge_plans(s, C, Pn, dense=False, form=segsum) for s in shards]
    lock = p.cam_fixed | ~p.cam_valid

    T_cw, points = p.T_cw, p.points
    lam = torch.tensor(lam0, dtype=torch.float32, device=dev)
    c_new = None
    for _ in range(iters):
        passes = [_edge_pass(Tn, pn, s, c2, pl)
                  for Tn, pn, s, c2, pl in zip(_to_shards(T_cw, shards),
                                               _to_shards(points, shards), shards, chi2s, plans)]
        Wcps = [w for _, w in passes]
        red = _reduce([pt for pt, _ in passes], dev)
        Hcc_d, Hpp_inv, observed = _damped_blocks(red, lam)
        gc, gp = red["gc"], red["gp"]
        Hpp_invs = _to_shards(Hpp_inv, shards)

        def edge_pt(x, Wcps=Wcps):  # [C,6] -> sum over edges of W^T x, [P,3]
            return _sum_to([_seg_add(pl.point, torch.einsum("eab,ea->eb", Wcp, xs[oc]), segsum)
                            for Wcp, xs, oc, pl in zip(Wcps, _to_shards(x, shards), ocs, plans)],
                           dev)

        def edge_cam(z, Wcps=Wcps):  # [P,3] -> sum over edges of W z, [C,6]
            return _sum_to([_seg_add(pl.cam, torch.einsum("eab,eb->ea", Wcp, zs[op]), segsum)
                            for Wcp, zs, op, pl in zip(Wcps, _to_shards(z, shards), ops, plans)],
                           dev)

        def schur_mv(x, Hpp_inv=Hpp_inv, Hcc_d=Hcc_d, edge_pt=edge_pt, edge_cam=edge_cam):
            z = torch.einsum("pab,pb->pa", Hpp_inv, edge_pt(x))
            return torch.einsum("cab,cb->ca", Hcc_d, x) - edge_cam(z)

        # exact Schur diagonal blocks for the block-Jacobi preconditioner
        Sdiag = Hcc_d - _sum_to([
            _seg_add(pl.cam, torch.einsum("eab,ebd,ecd->eac", Wcp, Hi[op], Wcp), segsum)
            for Wcp, Hi, op, pl in zip(Wcps, Hpp_invs, ops, plans)], dev)
        Sdiag = torch.where(lock[:, None, None], eye6[None], Sdiag)
        Minv = torch.linalg.inv_ex(Sdiag + 1e-6 * eye6[None])[0]
        zp = torch.einsum("pab,pb->pa", Hpp_inv, gp)
        rhs = -(gc - edge_cam(zp))
        rhs = torch.where(lock[:, None], torch.zeros_like(rhs), rhs)

        x = torch.zeros((C, 6), dtype=torch.float32, device=dev)
        rr = rhs
        pvec = torch.einsum("cab,cb->ca", Minv, rr)
        rz = (rr * pvec).sum()
        for _ in range(cg_iters):
            Ap = torch.where(lock[:, None], pvec, schur_mv(pvec))
            alpha = rz / torch.clamp_min((pvec * Ap).sum(), 1e-12)
            x = x + alpha * pvec
            rr = rr - alpha * Ap
            znew = torch.einsum("cab,cb->ca", Minv, rr)
            rz_new = (rr * znew).sum()
            beta = rz_new / torch.clamp_min(rz, 1e-12)
            pvec = znew + beta * pvec
            rz = rz_new
        dc = torch.where(lock[:, None], torch.zeros_like(x), x)
        dp = -torch.einsum("pab,pb->pa", Hpp_inv, gp + edge_pt(dc))
        dp = dp * (p.point_valid & observed)[:, None]

        T_new = geo.se3_exp(dc) @ T_cw
        T_new = torch.where(lock[:, None, None], T_cw, T_new)
        pts_new = points + dp
        c_old = red["cost"]
        c_new = _trial_cost(T_new, pts_new, shards, chi2s, dev)
        finite = torch.isfinite(c_new) & torch.isfinite(T_new).all() & torch.isfinite(pts_new).all()
        better = (c_new < c_old) & finite
        T_cw = torch.where(better, T_new, T_cw)
        points = torch.where(better, pts_new, points)
        lam = torch.where(better, torch.clamp_min(lam * 0.3, 1e-8), torch.clamp_max(lam * 5.0, 1e3))
    inliers, _ = _final_pass(T_cw, points, shards, chi2s, dev, with_cost=False)
    return BAResult(T_cw=T_cw, points=points, obs_inlier=inliers, cost=c_new)
