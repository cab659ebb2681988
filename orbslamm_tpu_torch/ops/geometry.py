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
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    bottom = bottom.expand(*batch, 1, 4)
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
