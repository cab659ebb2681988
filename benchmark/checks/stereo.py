"""The stereo association: up to six keyframes inserted in the
window (drawn as ``checks/orb.py`` draws them), each keyframe's own left
features and the right coordinates the port wrote for them (``kf_ur``),
beside the stream's left and right images of its frame and the right
image's features as the port's extractor gives them (the association's
other argument, extracted again after the window: the keyframe keeps only
its left features).

The reference (``reference/stereo.py``) runs ORB-SLAM2's association on
those arguments. Numbers: ``stereo_row_diff``, the rows whose kept or
rejected state differs from the reference's, as a share of the keyframes'
valid rows; ``stereo_gap_px``, the widest |u_right| gap on rows that both
keep. A row whose answer turns on a pair at the row band's limit, where
float32 coordinates decide by their rounding (``reference.stereo
.determinate``), is not judged; ``stereo_undetermined``, their share, is
shown. The extractor itself is judged on the same
frames' left images by ``checks/orb.py``.

No control reading: the association is integer arithmetic (Hamming
distances, sums of absolute differences of pixels) and comparisons of the
given coordinates, which the TF32 reference computes to the same answer, so
the control could not fail here. Notes: the process Tracer's six ``stereo.*`` counters at the check, set-up and window
together (the harness keeps no reading of them at the window's start).
"""

import numpy as np

from benchmark.checks.orb import _keyframes
from benchmark.reference import stereo as ref_stereo

COUNTERS = ("stereo.rows_matched", "stereo.rows_kept", "stereo.rejected_edge",
            "stereo.rejected_vertex", "stereo.rejected_border", "stereo.rejected_median")


def gather(run, rng):
    import torch

    from orbslamm_tpu_torch.utils.trace import get_tracer

    def rows(xy, level, desc, valid):
        ok = valid.bool()
        return {"xy": xy[ok].cpu().numpy(), "level": level[ok].cpu().numpy(),
                "desc": desc[ok].cpu().numpy(), "valid": np.ones(int(ok.sum()), bool)}

    kfs, in_window = _keyframes(run, rng)
    out = []
    for r, m, slot, f in kfs:
        if r.stream.images_right is None:
            continue
        fr = r.tracker.extract(torch.as_tensor(r.stream.images_right[f], device=run.device))
        out.append((r.stream.images[f], r.stream.images_right[f],
                    rows(m.kf_xy[slot], m.kf_level[slot], m.kf_desc[slot],
                         m.kf_feat_valid[slot]),
                    rows(fr.xy, fr.level, fr.desc, fr.valid),
                    m.kf_ur[slot][m.kf_feat_valid[slot]].cpu().numpy()))
    counters = get_tracer().metrics()["counters"]
    return {"keyframes": out, "in_window": in_window,
            "counters": {k: counters[k] for k in COUNTERS if k in counters}}


def numbers(ev, cfg, device, control):
    if control:
        return {}
    kw = dict(bf=cfg.camera.bf, min_z=cfg.camera.baseline, scale=cfg.orb.scale_factor)
    differ = rows = undetermined = 0
    gap = 0.0
    for imgL, imgR, left, right, ur in ev["keyframes"]:
        want = ref_stereo.associate(imgL, imgR, left, right, **kw)
        judged = ref_stereo.determinate(imgL, imgR, left, right, **kw)
        kept_got, kept_want = ur >= 0, want.u_right >= 0
        differ += int(((kept_got != kept_want) & judged).sum())
        rows += len(ur)
        undetermined += int((~judged).sum())
        both = kept_got & kept_want & judged
        if both.any():
            gap = max(gap, float(np.abs(ur[both] - want.u_right[both]).max()))
    if rows == 0:
        return {"stereo_row_diff": None, "stereo_gap_px": None, "stereo_undetermined": None}
    return {"stereo_row_diff": differ / rows, "stereo_gap_px": gap,
            "stereo_undetermined": undetermined / rows}


def notes(ev):
    return {"stereo_keyframes": len(ev["keyframes"]), **ev["counters"]}
