"""TUM trajectory files (the part of ``orbslamm_tpu/io/trajectory.py`` that
the port's synthetic-sequence export needs; the rest of that module is
ROADMAP queue 1 step 15).

Write format matches the reference exactly (System.cc:449-589
SaveTrajectoryTUM): ``timestamp tx ty tz qx qy qz qw`` per line,
world-from-camera.
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
