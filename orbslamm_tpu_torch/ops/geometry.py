"""Batched Lie-group / projective geometry (port of orbslamm_tpu/ops/geometry.py).

Same conventions as the JAX package: poses are camera-from-world ``Tcw``
[..., 4, 4]; ``x_cam = R @ x_world + t``; pixel = K @ (x_cam / z); se3
tangent order [rho(3), phi(3)]. Every function broadcasts over leading batch
axes and has no data-dependent control flow.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _eye(n, like: torch.Tensor, batch=()) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device).expand(*batch, n, n)


def skew(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [..., 3] axis-angle -> [..., 3, 3] rotation (series near 0)."""
    theta2 = (phi * phi).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / (theta2 + _EPS))
    W = skew(phi)
    WW = W @ W
    return _eye(3, phi, W.shape[:-2]) + a[..., None, None] * W + b[..., None, None] * WW


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 4] quaternion (x, y, z, w), w >= 0 (branch-free
    Shepperd: the candidate with the largest weight wins)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    qw2 = torch.clamp_min(1.0 + m00 + m11 + m22, 0.0)
    qx2 = torch.clamp_min(1.0 + m00 - m11 - m22, 0.0)
    qy2 = torch.clamp_min(1.0 - m00 + m11 - m22, 0.0)
    qz2 = torch.clamp_min(1.0 - m00 - m11 + m22, 0.0)
    cw = torch.stack([m21 - m12, m02 - m20, m10 - m01, qw2], dim=-1)
    cx = torch.stack([qx2, m01 + m10, m02 + m20, m21 - m12], dim=-1)
    cy = torch.stack([m01 + m10, qy2, m12 + m21, m02 - m20], dim=-1)
    cz = torch.stack([m02 + m20, m12 + m21, qz2, m10 - m01], dim=-1)
    mags = torch.stack([qw2, qx2, qy2, qz2], dim=-1)
    best = torch.argmax(mags, dim=-1)
    cands = torch.stack([cw, cx, cy, cz], dim=-2)  # [..., 4, 4]
    q = torch.gather(cands, -2, best[..., None, None].expand(*best.shape, 1, 4))[..., 0, :]
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + _EPS)
    return q * torch.sign(q[..., 3:4] + _EPS)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (x, y, z, w) -> [..., 3, 3]."""
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + _EPS)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1)
    row1 = torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1)
    row2 = torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation -> [..., 3] axis-angle with theta in [0, pi],
    through the quaternion (robust near both 0 and pi)."""
    q = rot_to_quat(R)
    v = q[..., :3]
    w = q[..., 3]
    nv = torch.linalg.norm(v, dim=-1)
    theta = 2.0 * torch.atan2(nv, w)
    small = nv < 1e-6
    scale = torch.where(small, 2.0 / torch.clamp_min(w, _EPS), theta / torch.clamp_min(nv, _EPS))
    return scale[..., None] * v


def _so3_left_jacobian_terms(phi: torch.Tensor):
    """Coefficients for V = I + b W + c WW used by se3 exp/log."""
    theta2 = (phi * phi).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / (theta2 + _EPS))
    c = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (theta2 * theta + _EPS)
    )
    return b, c


def _left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    b, c = _so3_left_jacobian_terms(phi)
    W = skew(phi)
    WW = W @ W
    return _eye(3, phi, W.shape[:-2]) + b[..., None, None] * W + c[..., None, None] * WW


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """[..., 6] twist [rho, phi] -> [..., 4, 4] transform."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    t = (_left_jacobian(phi) @ rho[..., None])[..., 0]
    return rt_to_T(so3_exp(phi), t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] -> [..., 6] twist. Inverse of se3_exp."""
    phi = so3_log(T[..., :3, :3])
    rho = torch.linalg.solve_ex(_left_jacobian(phi), T[..., :3, 3:4])[0][..., 0]
    return torch.cat([rho, phi], dim=-1)


def rt_to_T(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """([..., 3, 3], [..., 3]) -> [..., 4, 4] homogeneous transform."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(*batch, 3, 3)
    t = t.expand(*batch, 3)
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = _eye(4, R)[3:].expand(*batch, 1, 4)  # a fill on R's device, no host copy
    return torch.cat([top, bottom], dim=-2)


def T_inv(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid transform."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return rt_to_T(Rt, -(Rt @ t[..., None])[..., 0])


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply [..., 4, 4] to [..., N, 3] (or a single [3]) points."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    if pts.ndim >= 2:
        return pts @ R.transpose(-1, -2) + t[..., None, :]
    return (R @ pts[..., None])[..., 0] + t


def project(K: torch.Tensor, pts_cam: torch.Tensor) -> torch.Tensor:
    """Pinhole projection. K [..., 3, 3]; pts_cam [..., 3] -> [..., 2]."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    z = pts_cam[..., 2]
    inv_z = 1.0 / torch.where(z.abs() < _EPS, torch.full_like(z, _EPS), z)
    u = fx * pts_cam[..., 0] * inv_z + cx
    v = fy * pts_cam[..., 1] * inv_z + cy
    return torch.stack([u, v], dim=-1)


def backproject(K: torch.Tensor, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Pixel + depth -> camera-frame 3D point."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    x = (uv[..., 0] - cx) / fx * depth
    y = (uv[..., 1] - cy) / fy * depth
    return torch.stack([x, y, depth], dim=-1)


# ---------------------------------------------------------------------------
# Sim3 — stored as [..., 8]: (quat xyzw, t xyz, log_s)
# ---------------------------------------------------------------------------

def sim3_make(s: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(scale [...], rot [..., 3, 3], trans [..., 3]) -> packed [..., 8]."""
    return torch.cat([rot_to_quat(R), t, torch.log(s)[..., None]], dim=-1)


def sim3_identity(batch: tuple = (), *, device, dtype=torch.float32) -> torch.Tensor:
    q = torch.tensor([0, 0, 0, 1, 0, 0, 0, 0], dtype=dtype, device=device)
    return q.expand(*batch, 8)


def sim3_parts(S: torch.Tensor):
    """[..., 8] -> (s [...], R [..., 3, 3], t [..., 3])."""
    return torch.exp(S[..., 7]), quat_to_rot(S[..., :4]), S[..., 4:7]


def sim3_apply(S: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """x' = s R x + t; pts [..., N, 3] or [..., 3]."""
    s, R, t = sim3_parts(S)
    if pts.ndim >= 2 and pts.shape[-1] == 3 and pts.ndim > S.ndim:
        return s[..., None, None] * (pts @ R.transpose(-1, -2)) + t[..., None, :]
    return s[..., None] * (R @ pts[..., None])[..., 0] + t


def sim3_compose(Sa: torch.Tensor, Sb: torch.Tensor) -> torch.Tensor:
    """S = Sa o Sb (apply Sb first)."""
    sa, Ra, ta = sim3_parts(Sa)
    sb, Rb, tb = sim3_parts(Sb)
    t = sa[..., None] * (Ra @ tb[..., None])[..., 0] + ta
    return sim3_make(sa * sb, Ra @ Rb, t)


def sim3_inv(S: torch.Tensor) -> torch.Tensor:
    s, R, t = sim3_parts(S)
    Rt = R.transpose(-1, -2)
    sinv = 1.0 / s
    return sim3_make(sinv, Rt, -sinv[..., None] * (Rt @ t[..., None])[..., 0])


def sim3_from_se3(T: torch.Tensor) -> torch.Tensor:
    ones = torch.ones(T.shape[:-2], dtype=T.dtype, device=T.device)
    return sim3_make(ones, T[..., :3, :3], T[..., :3, 3])


def sim3_to_se3(S: torch.Tensor) -> torch.Tensor:
    """Scale folded into translation as ``t / s`` (the reference's mapping of
    a corrected Sim3 back onto an SE3 keyframe pose, MultiMapper.cc:552-556)."""
    s, R, t = sim3_parts(S)
    return rt_to_T(R, t / s[..., None])


def _sim3_V(sigma, s, phi):
    """The Sim3 V matrix (Strasdat) with the JAX package's series branches;
    shared by sim3_exp and sim3_log."""
    theta2 = (phi * phi).sum(-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    W = skew(phi)
    WW = W @ W
    sig2 = sigma * sigma
    small_sig = sigma.abs() < 1e-5
    small_th = theta2 < 1e-8
    A = torch.where(small_sig, 1.0 + sigma / 2.0 + sig2 / 6.0, (s - 1.0) / (sigma + _EPS))
    denom = sig2 + theta2 + _EPS
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    B_gen = (s * sin_t * sigma + (1.0 - s * cos_t) * theta) / (theta * denom)
    B_theta0 = torch.where(small_sig, 0.5 + sigma / 3.0,
                           (s * (sigma - 1.0) + 1.0) / (sig2 + _EPS))
    B = torch.where(small_th, B_theta0, B_gen)
    C_gen = (A - ((s * cos_t - 1.0) * sigma + s * sin_t * theta) / denom) / (theta2 + _EPS)
    C_theta0 = torch.where(small_sig, 1.0 / 6.0 + sigma / 8.0,
                           A - (s * (1 + sigma) - 1 - sigma * s) / (sig2 + _EPS))
    C = torch.where(small_th, torch.clamp_min(C_theta0, 1.0 / 6.0), C_gen)
    eye = _eye(3, phi, W.shape[:-2])
    return A[..., None, None] * eye + B[..., None, None] * W + C[..., None, None] * WW


def sim3_exp(xi: torch.Tensor) -> torch.Tensor:
    """[..., 7] tangent [rho, phi, sigma] -> packed Sim3 [..., 8]."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = torch.exp(sigma)
    t = (_sim3_V(sigma, s, phi) @ rho[..., None])[..., 0]
    return sim3_make(s, so3_exp(phi), t)


def _solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 solve by the adjugate (no pivoting, no error check, so no
    host sync; also differentiable under ``torch.func``)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c10 + a02 * c20
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([c00 * b0 + c01 * b1 + c02 * b2,
                        c10 * b0 + c11 * b1 + c12 * b2,
                        c20 * b0 + c21 * b1 + c22 * b2], -1) / det[..., None]


def sim3_log(S: torch.Tensor) -> torch.Tensor:
    """Packed Sim3 [..., 8] -> [..., 7] tangent (inverse of sim3_exp's V)."""
    s, R, t = sim3_parts(S)
    sigma = torch.log(s)
    phi = so3_log(R)
    rho = _solve3(_sim3_V(sigma, s, phi), t)
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def umeyama_alignment(src: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor | None = None,
                      with_scale: bool = True):
    """Closed-form Sim3/SE3 alignment dst ~ s R src + t (Umeyama / Horn).

    src, dst [N, 3]; mask [N] bool. Returns (s, R [3,3], t [3]). A reflection
    is fixed through det(U) det(Vt), as the JAX package does; the SVD's free
    signs of singular-vector pairs cancel in U S Vt."""
    if mask is None:
        mask = torch.ones(src.shape[:-1], dtype=torch.bool, device=src.device)
    w = mask.to(src.dtype)
    n = w.sum() + _EPS
    mu_s = (src * w[..., None]).sum(0) / n
    mu_d = (dst * w[..., None]).sum(0) / n
    sc = (src - mu_s) * w[..., None]
    dc = (dst - mu_d) * w[..., None]
    cov = dc.T @ (src - mu_s) / n
    U, D, Vt = torch.linalg.svd(cov)
    det = torch.linalg.det(U) * torch.linalg.det(Vt)
    diag = torch.stack([torch.ones_like(det), torch.ones_like(det),
                        torch.where(det < 0, -1.0, 1.0)])
    R = U @ (diag[:, None] * Vt)
    var_s = (sc * (src - mu_s)).sum() / n
    if with_scale:
        s = (D * diag).sum() / (var_s + _EPS)
    else:
        s = torch.ones((), dtype=src.dtype, device=src.device)
    t = mu_d - s * R @ mu_s
    return s, R, t


def triangulate_dlt(P1, P2, uv1, uv2) -> torch.Tensor:
    """Two-view linear (DLT) triangulation, batched over points.

    P1, P2: [..., 3, 4] projection matrices; uv: [..., 2] pixels. The null
    vector is the eigenvector of the smallest eigenvalue of A^T A; its sign
    is free and cancels on dehomogenising."""
    def rows(P, uv):
        r0 = uv[..., 0, None] * P[..., 2, :] - P[..., 0, :]
        r1 = uv[..., 1, None] * P[..., 2, :] - P[..., 1, :]
        return r0, r1

    a0, a1 = rows(P1, uv1)
    a2, a3 = rows(P2, uv2)
    A = torch.stack([a0, a1, a2, a3], dim=-2)
    AtA = A.transpose(-1, -2) @ A
    _, vecs = torch.linalg.eigh(AtA)
    X = vecs[..., :, 0]
    w = X[..., 3]
    w = torch.where(w.abs() < _EPS, torch.full_like(w, _EPS), w)
    return X[..., :3] / w[..., None]
