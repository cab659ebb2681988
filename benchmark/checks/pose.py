"""The pose solve: a sample of the window's motion-only BA calls
(``capture.py``, drawn from the seed), their arguments, poses and inlier
classes, against the reference's solve from the same start and
observations. Numbers: ``pose_gap_px``, the widest gap in pixels between a
point's projection under the two poses (the basin the caller keeps: the
most inliers, the first on a tie); ``inlier_flip``, the share of
observations whose inlier class differs. The control: the TF32
reference's solve."""

import torch

from benchmark.reference import pose as ref_pose
from benchmark.reference.precision import EXACT, TF32


def gather(run, rng):
    return run.capture.poses


def numbers(ev, cfg, device, control):
    if not ev:
        return {"pose_gap_px": None, "inlier_flip": None}
    gap = 0.0
    flips = total = 0
    for args, out in ev:
        a = {k: (v.to(device) if torch.is_tensor(v) else v) for k, v in args.items()}
        T_ref, m_ref = ref_pose.pose_optimize(**a, prec=EXACT)
        if control:
            T_got, m_got = ref_pose.pose_optimize(**a, prec=TF32)
            n_got = m_got.sum(-1)
        else:
            T_got = out.T_cw.to(device).reshape(-1, 4, 4)
            m_got = out.inliers.to(device).reshape(T_got.shape[0], -1)
            n_got = out.n_inliers.to(device).reshape(-1)
        b = 0 if len(n_got) == 1 or int(n_got[0]) >= int(n_got[1]) else 1
        valid = a["valid"].bool()
        uv_got, front_got = ref_pose.project(T_got[b:b + 1], a["K"], a["pts_w"])
        uv_ref, front_ref = ref_pose.project(T_ref[b:b + 1], a["K"], a["pts_w"])
        sel = valid & front_got[0] & front_ref[0]
        if sel.any():
            gap = max(gap, float(torch.linalg.norm(uv_got[0] - uv_ref[0], dim=-1)[sel].max()))
        flips += int(((m_got[b] != m_ref[b]) & valid).sum())
        total += int(valid.sum())
    return {"pose_gap_px": gap, "inlier_flip": flips / max(total, 1)}


def notes(ev):
    return {"pose_calls_checked": len(ev)}
