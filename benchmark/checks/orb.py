"""ORB extraction: keypoints, angles and descriptors of up to ``KEYFRAMES``
keyframes inserted in the window (drawn from the seed; the newest keyframe
where the window inserted none), beside the benchmark's own image of each.

Numbers: ``orb_kp_diff``, the keypoints that the port's selection and the
reference's differ by (FAST score, 3x3 suppression, threshold, border,
block ranking and each level's budget; level 0 exact, a resized level's
near-ties left out, ``reference.orb.keypoint_diff``); ``orb_angle_gap``,
the widest angle gap (rad), which swings with the keypoint whose intensity
centroid is nearly at its centre; ``orb_angle_drift``, the widest sideways
move of the centroid that the angle gap means (``|sin gap|`` times the
centroid's length over the disc's moment scale, ``OrbCheck.centroid``),
which does not; ``orb_bits_share`` and ``orb_bits_max``, descriptor bits
that differ, as a share of all and at the worst keypoint (descriptors
sampled at the port's angle, so that the angle is judged once). The
control: the TF32 reference's keypoints, angles and descriptors.
"""

import torch

from benchmark.reference import orb as ref_orb
from benchmark.reference.precision import EXACT, TF32

KEYFRAMES = 6


def _keyframes(run, rng):
    """Keyframes of every map the run made (a robot that lost tracking
    under a MultiMapper goes on in a new map), each tied to its robot by its
    frame and timestamp."""
    from orbslamm_tpu_torch.models.system import MapContext

    picks, newest = [], None
    for _, mc in sorted(MapContext.registry().items()):
        m = mc.map
        n = int(m.n_kf)
        fid = m.kf_frame_id[:n].cpu().numpy()
        ts = m.kf_timestamp[:n].cpu().numpy()
        valid = m.kf_valid[:n].cpu().numpy()
        for slot in range(n):
            f = int(fid[slot])
            r = next((r for r in run.robots if valid[slot] and 0 <= f < len(r.stream.timestamps)
                      and abs(float(ts[slot]) - float(r.stream.timestamps[f])) <= 1e-3), None)
            if r is None:
                continue
            item = (r, m, slot, f)
            if r.first <= f < r.end:
                picks.append(item)
            elif newest is None or f > newest[3]:
                newest = item
    if picks:
        rng.shuffle(picks)
        return picks[:KEYFRAMES], True
    return ([newest] if newest is not None else []), False


def gather(run, rng):
    kfs, in_window = _keyframes(run, rng)
    out = []
    for r, m, slot, f in kfs:
        ok = m.kf_feat_valid[slot]
        out.append((r.stream.images[f], m.kf_xy[slot][ok].cpu().numpy(),
                    m.kf_level[slot][ok].cpu().numpy(), m.kf_angle[slot][ok].cpu(),
                    m.kf_desc[slot][ok].cpu()))
    return {"keyframes": out, "in_window": in_window}


def numbers(ev, cfg, device, control):
    kw = dict(n_levels=cfg.orb.n_levels, scale=cfg.orb.scale_factor, device=device)
    sel = dict(n_features=cfg.orb.n_features, min_th=float(cfg.orb.min_th_fast),
               cell=cfg.orb.cell_size, **kw)
    n_kp = bits = bits_max = kp_diff = 0
    gap = drift = 0.0
    for img, xy, level, angle, desc in ev["keyframes"]:
        if control:  # the TF32 reference's selection and its readings of it
            xy, level = ref_orb.keypoints(img, prec=TF32, **sel)
            ctl = ref_orb.describe(img, xy, level, None, prec=TF32, **kw)
            angle, desc = ctl.angle.cpu(), ctl.desc.cpu()
        kp_diff += ref_orb.keypoint_diff(img, xy, level, prec=EXACT, **sel)[0]
        ref = ref_orb.describe(img, xy, level, angle.numpy(), prec=EXACT, **kw)
        e = ref_orb.bit_errors(desc.to(ref.desc.device), ref.desc)
        if len(e):
            n_kp += len(e)
            bits += int(e.sum())
            bits_max = max(bits_max, int(e.max()))
            g = ref_orb.angle_gap(angle.to(ref.angle.device), ref.angle)
            gap = max(gap, float(g.abs().max()))
            drift = max(drift, float((torch.sin(g).abs() * ref.centroid).max()))
    if n_kp == 0:
        return {"orb_kp_diff": None, "orb_angle_gap": None, "orb_angle_drift": None,
                "orb_bits_share": None, "orb_bits_max": None}
    return {"orb_kp_diff": float(kp_diff), "orb_angle_gap": gap, "orb_angle_drift": drift,
            "orb_bits_share": bits / (256.0 * n_kp), "orb_bits_max": float(bits_max)}


def notes(ev):
    return {"orb_keyframes": len(ev["keyframes"]), "orb_keyframes_in_window": ev["in_window"]}
