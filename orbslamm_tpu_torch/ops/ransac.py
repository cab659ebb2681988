"""Batched hypothesize-and-verify two-view initialization (port of
``two_view_init`` and its helpers from orbslamm_tpu/ops/ransac.py).

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
    """Batched 8-point: idx [H,8] -> F [H,3,3] (normalized coords)."""
    p1 = xy1n[idx]
    p2 = xy2n[idx]
    u1, v1 = p1[..., 0], p1[..., 1]
    u2, v2 = p2[..., 0], p2[..., 1]
    ones = torch.ones_like(u1)
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, ones], dim=-1)
    _, _, Vt = torch.linalg.svd(A, full_matrices=True)
    F = Vt[..., 8, :].reshape(-1, 3, 3)
    U, S, Vt2 = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    return U @ (S[..., None] * Vt2)


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
