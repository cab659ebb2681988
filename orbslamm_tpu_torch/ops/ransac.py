"""Batched hypothesize-and-verify solvers (port of orbslamm_tpu/ops/ransac.py):
two-view initialization (8-point F), PnP (6-point DLT) for relocalization,
and Sim3 (3-point Horn) for loop closing.

Every hypothesis is solved and scored in parallel; argmax picks the winner.
Hypotheses are drawn with ``torch.multinomial`` on a caller-owned
``torch.Generator``, which cannot reproduce ``jax.random``'s stream: tests
inject the JAX draw through ``idx``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orbslamm_tpu_torch.ops import geometry as geo


def _sample_indices(generator: torch.Generator, valid, n_hyp: int, k: int):
    """[H, k] indices drawn from valid entries (with replacement)."""
    p = valid.to(torch.float32)
    # an all-invalid set would be an invalid distribution; draw uniformly
    p = torch.where(p.sum() > 0, p, torch.ones_like(p))
    idx = torch.multinomial(p, n_hyp * k, replacement=True, generator=generator)
    return idx.reshape(n_hyp, k)


class InitResult(NamedTuple):
    success: torch.Tensor  # bool
    T21: torch.Tensor  # [4,4] camera2-from-camera1 (unit-ish translation)
    points1: torch.Tensor  # [N,3] triangulated points in camera-1 frame
    inliers: torch.Tensor  # [N] bool (triangulated good points)
    n_inliers: torch.Tensor


def _normalize_2d(xy, valid):
    w = valid.to(torch.float32)[:, None]
    n = torch.clamp_min(w.sum(), 1.0)
    mean = (xy * w).sum(0) / n
    d = (xy - mean).abs() * w
    md = torch.clamp_min(d.sum(0) / n, 1e-6)
    sx, sy = 1.0 / md[0], 1.0 / md[1]
    zero = torch.zeros_like(sx)
    one = torch.ones_like(sx)
    T = torch.stack([
        torch.stack([sx, zero, -mean[0] * sx]),
        torch.stack([zero, sy, -mean[1] * sy]),
        torch.stack([zero, zero, one]),
    ])
    xyn = (xy - mean) * torch.stack([sx, sy])
    return xyn, T


def _eight_point(xy1n, xy2n, idx):
    """Batched 8-point: idx [H,8] -> F [H,3,3] (normalized coords).

    Both SVDs run in float64 and F comes back in float32: on the card the
    batched float32 SVD of the [8, 9] systems of a low-parallax pair loses
    digits of the null vector (F off by up to 1.5 % and hypothesis scores
    by hundreds against the JAX package on the same inputs, NVIDIA H100);
    in float64 the null vector is exact to float32 on either device."""
    p1 = xy1n[idx].double()
    p2 = xy2n[idx].double()
    u1, v1 = p1[..., 0], p1[..., 1]
    u2, v2 = p2[..., 0], p2[..., 1]
    ones = torch.ones_like(u1)
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, ones], dim=-1)
    _, _, Vt = torch.linalg.svd(A, full_matrices=True)
    F = Vt[..., 8, :].reshape(-1, 3, 3)
    U, S, Vt2 = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    return (U @ (S[..., None] * Vt2)).to(xy1n.dtype)


def _epipolar_score(F, xy1, xy2, valid, sigma: float):
    """Symmetric transfer error with chi2 gates; score sums (thScore - chi2)
    (reference CheckFundamental). F [H,3,3]."""
    ones = torch.ones_like(xy1[..., :1])
    p1 = torch.cat([xy1, ones], -1)
    p2 = torch.cat([xy2, ones], -1)
    l2 = torch.einsum("hij,nj->hni", F, p1)
    l1 = torch.einsum("hji,nj->hni", F, p2)
    d2 = torch.einsum("ni,hni->hn", p2, l2) ** 2 / torch.clamp_min(
        l2[..., 0] ** 2 + l2[..., 1] ** 2, 1e-12)
    d1 = torch.einsum("ni,hni->hn", p1, l1) ** 2 / torch.clamp_min(
        l1[..., 0] ** 2 + l1[..., 1] ** 2, 1e-12)
    inv_s2 = 1.0 / (sigma * sigma)
    chi1 = d1 * inv_s2
    chi2 = d2 * inv_s2
    th, th_score = 3.841, 5.991
    in1 = chi1 < th
    in2 = chi2 < th
    inlier = in1 & in2 & valid[None, :]
    zero = torch.zeros_like(chi1)
    score = torch.where(valid[None, :] & in1, th_score - chi1, zero) + torch.where(
        valid[None, :] & in2, th_score - chi2, zero)
    return score.sum(-1), inlier


def _decompose_E(E):
    """E -> 4 candidate (R, t)."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    return (R1, t), (R1, -t), (R2, t), (R2, -t)


def two_view_init(xy1, xy2, valid, K, generator: torch.Generator | None = None,
                  n_hyp: int = 256, sigma: float = 1.0,
                  min_parallax_cos: float = 0.99995,
                  median_parallax_cos: float = 0.99985,
                  min_inliers: int = 50, min_ratio: float = 0.5,
                  idx: torch.Tensor | None = None) -> InitResult:
    """Monocular two-view bootstrap: batched 8-point F RANSAC + E
    decomposition + cheirality/parallax triangulation checks.

    xy1/xy2 [N,2] are matched undistorted pixels (same index = match).
    ``idx`` [n_hyp, 8] overrides the hypothesis draw (tests inject the
    JAX package's draw); otherwise ``generator`` draws it.
    """
    N = xy1.shape[0]
    dev = xy1.device
    xy1n, T1 = _normalize_2d(xy1, valid)
    xy2n, T2 = _normalize_2d(xy2, valid)
    if idx is None:
        idx = _sample_indices(generator, valid, n_hyp, 8)
    Fn = _eight_point(xy1n, xy2n, idx.long())
    F = torch.einsum("ji,hjk,kl->hil", T2, Fn, T1)
    score, inliers_h = _epipolar_score(F, xy1, xy2, valid, sigma)
    best = torch.argmax(score)
    Fb = F[best]
    inl_F = inliers_h[best]

    E = K.T @ Fb @ K
    cands = _decompose_E(E)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    P1 = K @ torch.cat([eye3, torch.zeros((3, 1), device=dev)], 1)
    th2 = 4.0 * sigma * sigma

    def eval_cand(R, t):
        P2 = K @ torch.cat([R, t[:, None]], 1)
        X = geo.triangulate_dlt(P1, P2, xy1, xy2)  # camera-1 frame
        Xc2 = X @ R.T + t
        C2 = -R.T @ t
        r2 = X - C2
        cosp = (X * r2).sum(-1) / torch.clamp_min(
            torch.linalg.norm(X, dim=-1) * torch.linalg.norm(r2, dim=-1), 1e-9)
        e1 = ((geo.project(K, X) - xy1) ** 2).sum(-1)
        e2 = ((geo.project(K, Xc2) - xy2) ** 2).sum(-1)
        good = (inl_F & (X[:, 2] > 0) & (Xc2[:, 2] > 0) & (cosp < min_parallax_cos)
                & (e1 < th2) & (e2 < th2))
        return good.sum(), X, good

    outs = [eval_cand(R, t) for R, t in cands]
    counts = torch.stack([o[0] for o in outs])
    bestc = torch.argmax(counts)
    n_best = counts[bestc]
    R = torch.stack([c[0] for c in cands])[bestc]
    t = torch.stack([c[1] for c in cands])[bestc]
    X = torch.stack([o[1] for o in outs])[bestc]
    good = torch.stack([o[2] for o in outs])[bestc]

    n_F = inl_F.sum()
    # ambiguity check: the winner must dominate
    second = torch.sort(counts).values[-2]
    # parallax quality gate: the ~50th-best parallax must exceed the bar
    C2b = -R.T @ t
    cosp_all = (X * (X - C2b)).sum(-1) / torch.clamp_min(
        torch.linalg.norm(X, dim=-1) * torch.linalg.norm(X - C2b, dim=-1), 1e-9)
    cos_sorted = torch.sort(torch.where(good, cosp_all, torch.ones_like(cosp_all))).values
    kth = torch.clamp(n_best // 2, 0, 50)
    parallax_ok = cos_sorted[kth] < median_parallax_cos
    nb = n_best.to(torch.float32)
    success = ((n_best >= min_inliers) & (nb >= min_ratio * n_F.to(torch.float32))
               & (second.to(torch.float32) < 0.75 * nb) & parallax_ok)
    return InitResult(success=success, T21=geo.rt_to_T(R, t), points1=X,
                      inliers=good, n_inliers=n_best.to(torch.int32))


# ---------------------------------------------------------------------------
# Absolute pose (PnP) RANSAC — relocalization
# ---------------------------------------------------------------------------

class PnPResult(NamedTuple):
    success: torch.Tensor
    T_cw: torch.Tensor  # [4,4]
    inliers: torch.Tensor  # [N]
    n_inliers: torch.Tensor


def _orthogonalize(M):
    """M = s R with R in SO(3): (R, mean singular value with the reflection
    folded in)."""
    U, S, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    return U @ (D[..., None] * Vt), (S * D).sum(-1) / 3.0


def _dlt_pose(pts_w, uv_n, idx):
    """Batched 6-point DLT camera pose from K-normalized image coords.

    pts_w [N,3], uv_n [N,2], idx [H,6] -> R [H,3,3], t [H,3]. The null
    vector's sign is free: as in the JAX package, the pose is taken from it
    as it comes, and redone from its negation where more than 3 of the 6
    points would lie behind the camera, so either sign gives one pose."""
    P = pts_w[idx]  # [H,6,3]
    u = uv_n[idx][..., 0]
    v = uv_n[idx][..., 1]
    Ph = torch.cat([P, torch.ones(P.shape[:-1] + (1,), dtype=P.dtype, device=P.device)], -1)
    zeros = torch.zeros_like(Ph)
    r1 = torch.cat([Ph, zeros, -u[..., None] * Ph], -1)
    r2 = torch.cat([zeros, Ph, -v[..., None] * Ph], -1)
    A = torch.cat([r1, r2], dim=-2)  # [H,12,12]
    # the null vector in float64, as in _eight_point
    _, _, Vt = torch.linalg.svd(A.double())
    p = Vt[..., 11, :].reshape(-1, 3, 4).to(P.dtype)
    M = p[..., :3]
    R, scale = _orthogonalize(M)
    t = p[..., 3] / scale[..., None]
    pc = torch.einsum("hij,hkj->hki", R, P) + t[:, None, :]
    flip = (pc[..., 2] < 0).sum(-1) > 3
    sgn = torch.where(flip, -1.0, 1.0)[..., None]
    R, scale2 = _orthogonalize(M * sgn[..., None])
    t = (p[..., 3] * sgn) / scale2[..., None]
    return R, t


def pnp_ransac(pts_w, uv, valid, K, generator: torch.Generator | None = None,
               n_hyp: int = 128, sigma: float = 1.0, chi2_th: float = 5.991,
               min_inliers: int = 10, idx: torch.Tensor | None = None) -> PnPResult:
    """Robust absolute pose from 2D-3D matches (reference PnPsolver usage in
    Tracking::Relocalization). ``idx`` [n_hyp, 6] overrides the draw."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    uv_n = torch.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], -1)
    if idx is None:
        idx = _sample_indices(generator, valid, n_hyp, 6)
    R, t = _dlt_pose(pts_w, uv_n, idx.long())
    pc = torch.einsum("hij,nj->hni", R, pts_w) + t[:, None, :]
    chi2 = ((geo.project(K, pc) - uv[None]) ** 2).sum(-1) / (sigma * sigma)
    inl = (chi2 < chi2_th) & (pc[..., 2] > 0) & valid[None, :]
    counts = inl.sum(-1)
    best = torch.argmax(counts)
    n = counts[best]
    return PnPResult(success=n >= min_inliers, T_cw=geo.rt_to_T(R[best], t[best]),
                     inliers=inl[best], n_inliers=n.to(torch.int32))


# ---------------------------------------------------------------------------
# Sim3 RANSAC — loop closing
# ---------------------------------------------------------------------------

class Sim3Result(NamedTuple):
    success: torch.Tensor
    S21: torch.Tensor  # packed sim3 [8]: maps frame-1 3D points to frame-2
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def _horn_3pt(src, dst):
    """Batched minimal Horn: src, dst [H,3,3] -> (s [H], R [H,3,3], t [H,3]).
    The reflection is fixed through det(U Vt), as in the JAX package."""
    mu_s = src.mean(-2, keepdim=True)
    mu_d = dst.mean(-2, keepdim=True)
    sc = src - mu_s
    dc = dst - mu_d
    cov = torch.einsum("hni,hnj->hij", dc, sc) / 3.0
    U, D, Vt = torch.linalg.svd(cov)
    det = torch.linalg.det(U @ Vt)
    S = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    R = U @ (S[..., None] * Vt)
    var = torch.einsum("hni,hni->h", sc, sc) / 3.0
    s = (D * S).sum(-1) / torch.clamp_min(var, 1e-9)
    t = mu_d[:, 0, :] - s[:, None] * torch.einsum("hij,hj->hi", R, mu_s[:, 0, :])
    return s, R, t


def sim3_ransac(pts1, pts2, valid, K1, K2, generator: torch.Generator | None = None,
                n_hyp: int = 128, th2_px: float = 9.86, fix_scale: bool = False,
                min_inliers: int = 20, idx: torch.Tensor | None = None) -> Sim3Result:
    """Relative Sim3 from matched 3D points in two camera frames (reference
    Sim3Solver), inliers checked by reprojection in BOTH images. ``idx``
    [n_hyp, 3] overrides the draw."""
    if idx is None:
        idx = _sample_indices(generator, valid, n_hyp, 3)
    idx = idx.long()
    s, R, t = _horn_3pt(pts1[idx], pts2[idx])
    if fix_scale:
        s = torch.ones_like(s)
    p12 = s[:, None, None] * torch.einsum("hij,nj->hni", R, pts1) + t[:, None, :]
    e2 = ((geo.project(K2, p12) - geo.project(K2, pts2)[None]) ** 2).sum(-1)
    sinv = 1.0 / torch.clamp_min(s, 1e-9)
    p21 = sinv[:, None, None] * torch.einsum("hij,hnj->hni", R.transpose(-1, -2),
                                             pts2[None] - t[:, None, :])
    e1 = ((geo.project(K1, p21) - geo.project(K1, pts1)[None]) ** 2).sum(-1)
    inl = (e1 < th2_px) & (e2 < th2_px) & valid[None, :]
    counts = inl.sum(-1)
    best = torch.argmax(counts)
    n = counts[best]
    return Sim3Result(success=n >= min_inliers, S21=geo.sim3_make(s[best], R[best], t[best]),
                      inliers=inl[best], n_inliers=n.to(torch.int32))
