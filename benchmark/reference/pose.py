"""Plain motion-only bundle adjustment (ORB-SLAM2's PoseOptimization as the
port states it): ``rounds`` rounds of ``iters`` Levenberg-Marquardt steps
on the Huber-robust reprojection cost, the observations re-classified by
their chi-square after each round.

A step: residuals ``proj(T X) - uv`` (plus ``u - bf/z - u_r`` where an
observation has a right coordinate), the Jacobian of a left se(3)
perturbation ``[rho, phi]``, Huber weights ``min(1, delta/|r|) / sigma^2``
with ``delta = sqrt(chi2 sigma^2)``, ``H = J'WJ``, ``g = J'Wr``, the damped
system ``(H + lam diag(H) + 1e-8 I) dx = -g``, ``T <- exp(dx) T``; the step
is kept only where it lowers the robust cost, ``lam`` halves (down to 1e-6)
or quadruples (up to 1e4), and a solve stops when a kept step gains less
than 1e-5 of the cost with ``|dx|^2 < 1e-10``, or when ``lam`` reaches 1e4
on a refused step. Points closer than 1 mm in front of the camera take no
part.
"""

from __future__ import annotations

import torch

from benchmark.reference.precision import Precision

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def _skew(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def se3_exp(xi):
    """[B, 6] twists [rho, phi] -> [B, 4, 4]."""
    rho, phi = xi[:, :3], xi[:, 3:]
    th = torch.linalg.norm(phi, dim=-1)[:, None, None]
    W = _skew(phi)
    W2 = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand_as(W)
    small = th < 1e-6
    ths = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 1.0 - th ** 2 / 6, torch.sin(ths) / ths)
    b = torch.where(small, 0.5 - th ** 2 / 24, (1 - torch.cos(ths)) / ths ** 2)
    c = torch.where(small, 1 / 6 - th ** 2 / 120, (ths - torch.sin(ths)) / ths ** 3)
    R = eye + a * W + b * W2
    V = eye + b * W + c * W2
    T = torch.zeros((xi.shape[0], 4, 4), dtype=xi.dtype, device=xi.device)
    T[:, :3, :3] = R
    T[:, :3, 3] = (V @ rho[:, :, None])[:, :, 0]
    T[:, 3, 3] = 1.0
    return T


def pose_optimize(T_init, K, pts_w, uv_obs, valid, sigma2=1.0, rounds=4, iters=10,
                  chi2_th=CHI2_MONO, ur_obs=None, bf=0.0, *, prec: Precision):
    """Returns (T [B, 4, 4], inliers [B, N]) for starting poses ``T_init``
    ([4, 4] or [B, 4, 4]) against the same observations."""
    dt = prec.dtype
    T = T_init.to(dt).reshape(-1, 4, 4).clone()
    B = T.shape[0]
    dev = T.device
    K = K.to(dt)
    X = pts_w.to(dt)
    uv = uv_obs.to(dt)
    valid = valid.bool()
    N = X.shape[0]
    s2 = torch.as_tensor(sigma2, device=dev).to(dt).expand(N)
    inv_s2 = 1.0 / s2
    has_ur = None if ur_obs is None else (ur_obs.to(dt) >= 0)
    chi2 = torch.full((N,), chi2_th, dtype=dt, device=dev)
    if has_ur is not None:
        chi2 = torch.where(has_ur, torch.full_like(chi2, CHI2_STEREO), chi2)
    delta = torch.sqrt(chi2 * s2)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    def residual(T):
        pc = prec.einsum("nj,bij->bni", X, T[:, :3, :3]) + T[:, None, :3, 3]
        z = pc[..., 2]
        zs = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
        u = fx * pc[..., 0] / zs + cx
        v = fy * pc[..., 1] / zs + cy
        r = torch.stack([u - uv[:, 0], v - uv[:, 1]], -1)
        if has_ur is not None:
            r3 = (u - bf / torch.clamp_min(z, 1e-6) - ur_obs.to(dt)) * has_ur
            r = torch.cat([r, r3[..., None]], -1)
        return r, pc

    def cost(r, pc, mask):
        e = (r * r).sum(-1) * inv_s2
        hub = torch.where(e <= chi2, e, 2.0 * torch.sqrt(chi2 * e) - chi2)
        return torch.where(mask & (pc[..., 2] > 1e-3), hub, torch.zeros_like(hub)).sum(-1)

    def jacobian(pc):
        x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
        zi = 1.0 / torch.clamp_min(z, 1e-6)
        o = torch.zeros_like(x)
        rows = [torch.stack([fx * zi, o, -fx * x * zi * zi], -1),
                torch.stack([o, fy * zi, -fy * y * zi * zi], -1)]
        if has_ur is not None:
            rows.append(torch.stack([fx * zi, o, -fx * x * zi * zi + bf * zi * zi], -1)
                        * has_ur[..., None])
        dpd = torch.stack(rows, -2)  # [B, N, D, 3]
        eye = torch.eye(3, dtype=dt, device=dev).expand(*pc.shape[:-1], 3, 3)
        dpc = torch.cat([eye, -_skew(pc)], -1)  # [B, N, 3, 6]
        return prec.einsum("bnda,bnae->bnde", dpd, dpc)

    mask = valid[None, :].expand(B, N)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    for _ in range(rounds):
        lam = torch.full((B,), 1e-2, dtype=dt, device=dev)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        for _ in range(iters):
            r, pc = residual(T)
            use = mask & (pc[..., 2] >= 1e-3)
            J = jacobian(pc)
            rn = torch.linalg.norm(r, dim=-1)
            w = torch.where(rn > delta, delta / torch.clamp_min(rn, 1e-9),
                            torch.ones_like(rn)) * inv_s2
            w = torch.where(use, w, torch.zeros_like(w))
            Jw = J * w[..., None, None]
            H = prec.einsum("bnda,bndc->bac", Jw, J)
            g = prec.einsum("bnda,bnd->ba", Jw, r)
            Hd = H + lam[:, None, None] * torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1)) \
                + 1e-8 * eye6
            dx = -torch.linalg.solve(Hd, g[..., None])[..., 0]
            Tn = se3_exp(dx) @ T
            c_old = cost(r, pc, mask)
            r2, pc2 = residual(Tn)
            c_new = cost(r2, pc2, mask)
            better = c_new < c_old
            lam_n = torch.where(better, torch.clamp_min(lam * 0.5, 1e-6),
                                torch.clamp_max(lam * 4.0, 1e4))
            stop = (better & (c_old - c_new <= 1e-5 * c_old) & ((dx * dx).sum(-1) < 1e-10)) \
                | (~better & (lam_n >= 1e4))
            step = better & ~done
            T = torch.where(step[:, None, None], Tn, T)
            lam = torch.where(done, lam, lam_n)
            done = done | stop
        r, pc = residual(T)
        e = (r * r).sum(-1) * inv_s2
        mask = valid[None, :] & (e <= chi2) & (pc[..., 2] > 1e-3)
    return T, mask


def project(T, K, X):
    """[B, N, 2] pixels of points X [N, 3] under poses T [B, 4, 4], float64,
    and [B, N] whether each lies 0.3 m or more in front."""
    T, K, X = T.double(), K.double(), X.double()
    pc = torch.einsum("nj,bij->bni", X, T[:, :3, :3]) + T[:, None, :3, 3]
    z = pc[..., 2]
    zs = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    uv = torch.stack([K[0, 0] * pc[..., 0] / zs + K[0, 2],
                      K[1, 1] * pc[..., 1] / zs + K[1, 2]], -1)
    return uv, z > 0.3
