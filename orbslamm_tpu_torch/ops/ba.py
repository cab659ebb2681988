"""Nonlinear least squares: motion-only BA and window Schur BA (port of the
``pose_optimize`` and ``bundle_adjust_window`` parts of orbslamm_tpu/ops/ba.py).

Both are fixed-count Levenberg–Marquardt loops. The JAX package skips the
iterations after convergence with ``lax.cond`` inside ``lax.scan``; here
every iteration runs and a converged carry is frozen with ``torch.where``,
so no decision ever leaves the device. Linear solves use ``solve_ex``
(no error check, hence no host sync). Monocular edges only; the stereo
``u_r`` residual comes with the stereo port.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orbslamm_tpu_torch.ops import geometry as geo
from orbslamm_tpu_torch.utils.trace import stage

CHI2_MONO = 5.991  # 2-DoF 95% (reference Optimizer.cc chi2Mono)
CHI2_STEREO = 7.815  # 3-DoF 95% (reference Optimizer.cc chi2Stereo)


def _project_and_residual(T_cw, K, pts_w, uv_obs):
    pc = geo.transform_points(T_cw, pts_w)
    uv = geo.project(K, pc)
    return uv - uv_obs, pc


def _pose_jacobian(K, pc):
    """d(residual)/d(se3 left-perturbation of T_cw): [..., N, 2, 6]."""
    fx, fy = K[0, 0], K[1, 1]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    zi = 1.0 / torch.clamp_min(z, 1e-6)
    zi2 = zi * zi
    zero = torch.zeros_like(x)
    du = torch.stack([fx * zi, zero, -fx * x * zi2], dim=-1)
    dv = torch.stack([zero, fy * zi, -fy * y * zi2], dim=-1)
    dpd = torch.stack([du, dv], dim=-2)  # [..., N, 2, 3]
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
                  iters: int = 10, chi2_th: float = CHI2_MONO) -> PoseOptResult:
    """Motion-only bundle adjustment (reference Optimizer::PoseOptimization:
    4 rounds x 10 LM iterations, Huber, chi2 re-classification between
    rounds).

    ``T_init`` is [4,4] or a batch [B,4,4] of starting poses optimized
    independently against the same observations (the motion model's two
    basins). pts_w [N,3], uv_obs [N,2], valid [N], sigma2 scalar or [N].
    """
    with stage("ba.pose_optimize"):
        return _pose_optimize(T_init, K, pts_w, uv_obs, valid, sigma2, rounds, iters,
                              chi2_th)


def _pose_optimize(T_init, K, pts_w, uv_obs, valid, sigma2, rounds, iters, chi2_th):
    batched = T_init.ndim == 3
    T = T_init if batched else T_init[None]
    B = T.shape[0]
    dev = T.device
    sigma2 = torch.as_tensor(sigma2, dtype=torch.float32, device=dev).expand(valid.shape)
    inv_s2 = 1.0 / sigma2
    delta_h = torch.sqrt(chi2_th * sigma2)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)

    def residual(T):
        return _project_and_residual(T, K, pts_w, uv_obs)  # [B,N,2], [B,N,3]

    def cost_of(r, pc, mask):
        rrn2 = (r * r).sum(-1) * inv_s2
        hub = torch.where(rrn2 <= chi2_th, rrn2,
                          2.0 * torch.sqrt(chi2_th * rrn2) - chi2_th)
        return torch.where(mask & (pc[..., 2] > 1e-3), hub, torch.zeros_like(hub)).sum(-1)

    def lm_body(T, lam, mask):
        r, pc = residual(T)
        use = mask & ~(pc[..., 2] < 1e-3)
        J = _pose_jacobian(K, pc)  # [B,N,2,6]
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
                         chi2_th: float = CHI2_MONO, lam0: float = 1e-4) -> WindowBAResult:
    """Schur-complement LM for a covisibility window (reference
    LocalBundleAdjustment, Optimizer.cc:475), in the window's [W,M]
    observation layout: camera blocks reduce over each camera's own
    features, point blocks gather through the [W,P] incidence table.

    T_cw [W,4,4], K [W,3,3], cam_valid/cam_fixed [W], points [P,3],
    point_valid [P], obs_point [W,M] int, obs_uv [W,M,2], obs_sigma2 [W,M],
    obs_valid [W,M].
    """
    W, M = obs_point.shape
    P = points.shape[0]
    dev = points.device
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
        return torch.stack([u, v], -1) - obs_uv, pc

    def jacobians(pc, T_all):
        x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
        zi = 1.0 / torch.clamp_min(z, 1e-6)
        zi2 = zi * zi
        zero = torch.zeros_like(x)
        du = torch.stack([fx * zi, zero, -fx * x * zi2], -1)
        dv = torch.stack([zero, fy * zi, -fy * y * zi2], -1)
        dpd = torch.stack([du, dv], -2)  # [W,M,2,3]
        px = geo.skew(pc)
        Jc = dpd @ torch.cat([eye3.expand_as(px), -px], -1)  # [W,M,2,6]
        Jp = dpd @ T_all[:, None, :3, :3]  # [W,M,2,3]
        return Jc, Jp

    def cost_of(r, pc, use):
        chi2 = (r * r).sum(-1) / obs_sigma2
        hub = torch.where(chi2 <= chi2_th, chi2, 2.0 * torch.sqrt(chi2_th * chi2) - chi2_th)
        return torch.where(use & (pc[..., 2] > 1e-3), hub, torch.zeros_like(hub)).sum()

    base_use = obs_valid & cam_valid[:, None] & point_valid[pt_of]

    def step_body(T_all, pts, lam):
        r, pc = residual(T_all, pts)
        use = base_use & (pc[..., 2] > 1e-3)
        rn = torch.linalg.norm(r, dim=-1)
        delta = torch.sqrt(chi2_th * obs_sigma2)
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
    inlier = obs_valid & (chi2 <= chi2_th) & (pc[..., 2] > 1e-3)
    return WindowBAResult(T_cw=T_all, points=pts, obs_inlier=inlier,
                          cost=cost_of(r, pc, base_use))
