"""Absolute trajectory error (ATE) evaluation (the port's copy of
``orbslamm_tpu/eval/ate.py``).

Implements the standard TUM-benchmark ATE RMSE: associate estimated and
ground-truth poses by timestamp, align with a closed-form SE3 (or Sim3, for
monocular scale ambiguity) fit, report translational RMSE. This is the metric
the reference is evaluated with externally (SURVEY.md §4.2 — the reference
dumps trajectories and relies on the TUM tooling offline).
"""

from __future__ import annotations

import numpy as np


def associate(
    t_est: np.ndarray, t_gt: np.ndarray, max_dt: float = 0.02
) -> tuple[np.ndarray, np.ndarray]:
    """Greedy nearest-timestamp association. Returns index arrays (est, gt)."""
    i = j = 0
    out_e, out_g = [], []
    while i < len(t_est) and j < len(t_gt):
        dt = t_est[i] - t_gt[j]
        if abs(dt) <= max_dt:
            out_e.append(i)
            out_g.append(j)
            i += 1
            j += 1
        elif dt > 0:
            j += 1
        else:
            i += 1
    return np.asarray(out_e, np.int64), np.asarray(out_g, np.int64)


def align_trajectory(
    est_xyz: np.ndarray,
    gt_xyz: np.ndarray,
    align: str = "sim3",
) -> np.ndarray:
    """``est_xyz`` [N, 3] moved onto ``gt_xyz`` [N, 3] by the closed-form
    fit: "sim3" (monocular — scale solved), "se3", or "none"."""
    est = np.asarray(est_xyz, np.float64)
    gt = np.asarray(gt_xyz, np.float64)
    if align == "none":
        return est
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    ec = est - mu_e
    gc = gt - mu_g
    cov = gc.T @ ec / len(est)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if align == "sim3":
        var = (ec * ec).sum() / len(est)
        s = float((D * np.diag(S)).sum() / max(var, 1e-12))
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return s * est @ R.T + t


def ate_rmse(
    est_xyz: np.ndarray,
    gt_xyz: np.ndarray,
    align: str = "sim3",
) -> float:
    """RMSE of translational error after closed-form alignment.

    est_xyz, gt_xyz: [N, 3] associated positions.
    align: "sim3" (monocular — scale solved), "se3", or "none".
    """
    if len(est_xyz) < 3:
        return float("inf")
    err = align_trajectory(est_xyz, gt_xyz, align) - np.asarray(gt_xyz, np.float64)
    return float(np.sqrt((err * err).sum(axis=1).mean()))


def ate_from_poses(
    est_poses_cw: np.ndarray, gt_poses_cw: np.ndarray, align: str = "sim3"
) -> float:
    """ATE RMSE from camera-from-world pose arrays [N, 4, 4] (already associated)."""

    def centers(poses):
        R = poses[:, :3, :3]
        t = poses[:, :3, 3]
        return -np.einsum("nij,nj->ni", np.transpose(R, (0, 2, 1)), t)

    return ate_rmse(centers(np.asarray(est_poses_cw)), centers(np.asarray(gt_poses_cw)), align)
