"""Trajectory files, TUM and KITTI (port of orbslamm_tpu/io/trajectory.py).

Write formats match the reference exactly so evaluation tools read either
package's files (System.cc:449-589 SaveTrajectoryTUM/KITTI,
MultiMapper.cc:847-923 SaveTrajectory); each writer writes the same bytes
as the JAX package's:
  * TUM:   ``timestamp tx ty tz qx qy qz qw`` per line (world-from-camera)
  * KITTI: 3x4 row-major world-from-camera matrix per line
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _pose_wc(T_cw: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    R = T_cw[:3, :3]
    t = T_cw[:3, 3]
    Rwc = R.T
    twc = -Rwc @ t
    return Rwc, twc


def _rot_to_quat_np(R: np.ndarray) -> np.ndarray:
    """(x, y, z, w), w >= 0."""
    w2 = max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])
    x2 = max(0.0, 1.0 + R[0, 0] - R[1, 1] - R[2, 2])
    y2 = max(0.0, 1.0 - R[0, 0] + R[1, 1] - R[2, 2])
    z2 = max(0.0, 1.0 - R[0, 0] - R[1, 1] + R[2, 2])
    idx = int(np.argmax([w2, x2, y2, z2]))
    if idx == 0:
        w = 0.5 * np.sqrt(w2)
        x = (R[2, 1] - R[1, 2]) / (4 * w)
        y = (R[0, 2] - R[2, 0]) / (4 * w)
        z = (R[1, 0] - R[0, 1]) / (4 * w)
    elif idx == 1:
        x = 0.5 * np.sqrt(x2)
        w = (R[2, 1] - R[1, 2]) / (4 * x)
        y = (R[0, 1] + R[1, 0]) / (4 * x)
        z = (R[0, 2] + R[2, 0]) / (4 * x)
    elif idx == 2:
        y = 0.5 * np.sqrt(y2)
        w = (R[0, 2] - R[2, 0]) / (4 * y)
        x = (R[0, 1] + R[1, 0]) / (4 * y)
        z = (R[1, 2] + R[2, 1]) / (4 * y)
    else:
        z = 0.5 * np.sqrt(z2)
        w = (R[1, 0] - R[0, 1]) / (4 * z)
        x = (R[0, 2] + R[2, 0]) / (4 * z)
        y = (R[1, 2] + R[2, 1]) / (4 * z)
    q = np.array([x, y, z, w], np.float64)
    q /= np.linalg.norm(q)
    return q if q[3] >= 0 else -q


def save_tum(path: str | Path, timestamps: np.ndarray, poses_cw: np.ndarray) -> None:
    lines = []
    for ts, T in zip(timestamps, poses_cw):
        Rwc, twc = _pose_wc(np.asarray(T, np.float64))
        q = _rot_to_quat_np(Rwc)
        lines.append(
            f"{ts:.6f} {twc[0]:.7f} {twc[1]:.7f} {twc[2]:.7f} "
            f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}"
        )
    Path(path).write_text("\n".join(lines) + "\n")


def load_tum(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """Returns (timestamps [T], positions+quat [T, 7]) — (tx ty tz qx qy qz qw)."""
    rows = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        rows.append([float(v) for v in line.split()])
    if not rows:
        return np.zeros(0), np.zeros((0, 7))
    arr = np.asarray(rows, np.float64)
    return arr[:, 0], arr[:, 1:8]


def save_kitti(path: str | Path, poses_cw: np.ndarray) -> None:
    lines = []
    for T in poses_cw:
        Rwc, twc = _pose_wc(np.asarray(T, np.float64))
        M = np.concatenate([Rwc, twc[:, None]], axis=1)
        lines.append(" ".join(f"{v:.9e}" for v in M.reshape(-1)))
    Path(path).write_text("\n".join(lines) + "\n")


def load_kitti(path: str | Path) -> np.ndarray:
    """Returns world-from-camera poses [T, 4, 4]."""
    rows = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        T = np.eye(4)
        T[:3, :] = np.asarray([float(v) for v in line.split()], np.float64).reshape(3, 4)
        rows.append(T)
    return np.asarray(rows)
