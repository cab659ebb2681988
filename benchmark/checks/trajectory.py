"""The trajectory: every window frame the port tracked, its pose as the port
exports it (through its reference keyframe), and the rendered ground
truth. Number: ``ate_share``, the window's metric trajectory error (a rigid
fit, no scale: a depth sensor's map has the scale of the world) as a share
of the error of a camera that never moved (which reads 1.0); the worst
robot's. No control: the ground truth is exact. Beside it, not compared:
the error after a fitted scale (Sim3) and that scale."""

import numpy as np

from benchmark.reference import ate as ref_ate


def gather(run, rng):
    from orbslamm_tpu_torch.models.system import resolve_frame_poses

    out = []
    for r in run.robots:
        recs = [f for f in r.tracker.frames if r.first <= f.frame_id < r.end and f.state == "OK"]
        est = np.stack(resolve_frame_poses(recs)) if recs else np.zeros((0, 4, 4))
        out.append((est, r.stream.poses_cw[[f.frame_id for f in recs]]))
    return out


def numbers(ev, cfg, device, control):
    if control:
        return {}
    worst = None
    for est, gt in ev:
        if len(est) < 3:
            return {"ate_share": None}
        g = ref_ate.centres(gt)
        share = ref_ate.ate_se3(ref_ate.centres(est), g) / max(ref_ate.frozen_spread(g), 1e-12)
        worst = share if worst is None else max(worst, share)
    return {"ate_share": worst}


def notes(ev):
    out = {}
    for k, (est, gt) in enumerate(ev):
        if len(est) >= 3:
            e, g = ref_ate.centres(est), ref_ate.centres(gt)
            out[f"ate_m_{k}"] = ref_ate.ate_se3(e, g)
            out[f"ate_sim3_share_{k}"] = ref_ate.ate_sim3(e, g) / max(ref_ate.frozen_spread(g),
                                                                      1e-12)
            out[f"sim3_scale_{k}"] = ref_ate.sim3_scale(e, g)
    return out
