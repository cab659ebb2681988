"""Absolute trajectory error against the rendered ground truth.

The TUM benchmark's measure: camera centres of the estimate moved onto the
ground truth's by the closed-form fit (Umeyama: rotation and translation,
and for a similarity also scale), then the RMS of the distances. A camera
that never leaves one pose scores the RMS spread of the ground-truth
centres about their mean: ``frozen_spread``.
"""

from __future__ import annotations

import numpy as np


def centres(poses_cw: np.ndarray) -> np.ndarray:
    P = np.asarray(poses_cw, np.float64)
    return -np.einsum("nji,nj->ni", P[:, :3, :3], P[:, :3, 3])


def _fit(est, gt, with_scale: bool):
    """(s, R, t) moving ``est`` [N, 3] onto ``gt`` [N, 3]."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    ec, gc = est - mu_e, gt - mu_g
    U, D, Vt = np.linalg.svd(gc.T @ ec / len(est))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var = (ec * ec).sum() / len(est)
    s = float((D * np.diag(S)).sum() / var) if with_scale and var > 0 else 1.0
    return s, R, mu_g - s * R @ mu_e


def _rms(est, gt, with_scale):
    est, gt = np.asarray(est, np.float64), np.asarray(gt, np.float64)
    if with_scale and ((est - est.mean(0)) ** 2).sum() <= 0.0:
        return frozen_spread(gt)
    s, R, t = _fit(est, gt, with_scale)
    err = s * est @ R.T + t - gt
    return float(np.sqrt((err * err).sum(1).mean()))


def ate_sim3(est: np.ndarray, gt: np.ndarray) -> float:
    """RMS error of ``est`` [N, 3] centres after the similarity fit."""
    return _rms(est, gt, True)


def ate_se3(est: np.ndarray, gt: np.ndarray) -> float:
    """RMS error after a rigid fit (no scale: a metric sensor's measure)."""
    return _rms(est, gt, False)


def sim3_scale(est: np.ndarray, gt: np.ndarray) -> float:
    """The similarity fit's scale: ground-truth metres per estimated metre."""
    return _fit(np.asarray(est, np.float64), np.asarray(gt, np.float64), True)[0]


def frozen_spread(gt: np.ndarray) -> float:
    gc = np.asarray(gt, np.float64) - np.asarray(gt, np.float64).mean(0)
    return float(np.sqrt((gc * gc).sum(1).mean()))
