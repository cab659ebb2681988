"""The stereo cell at a test size on the CPU: a sound run is correct, and the
stereo check reads planted faults of the association above their limits.

    python -m pytest -q benchmark/tests/test_bench_stereo.py

The faults are planted in the check's evidence of one rendered pair (the
port's features and association at test size): one kept row's ``u_right``
moved by 3 px, and one row that the association rejected revived at its
coarse match.
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_bench_faults import tiny_cell  # noqa: E402

from benchmark import harness, scene  # noqa: E402
from benchmark.checks import stereo as check  # noqa: E402
from benchmark.reference import stereo as ref  # noqa: E402

CELL = "kitti_stereo.stream"


def test_a_sound_stereo_run_is_correct():
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    res = harness.execute(tiny_cell(CELL), 2 ** 31 + 11, 8, False, "cpu")
    assert res["attempted"] > 0 and res["failed"] == 0
    # as the RGB-D cell's sound run: at this size the trajectory is held
    # only to beating a camera that never moved (1.0)
    over = {k: c for k, c in res["check"].items()
            if c["value"] is None or c["value"] > (1.0 if k == "ate_share" else c["limit"])}
    assert not over, res["check"]
    assert res["setup"]["stereo.rows_kept"] > 0


@pytest.fixture(scope="module")
def evidence():
    """The check's evidence and the reference's answer for one pair."""
    from orbslamm_tpu_torch.ops import orb, stereo

    cell = tiny_cell(CELL)
    cfg = harness.slam_config(cell.conf)
    st = scene.streams(cell.mix, harness.scene_camera(cell.conf), 5, 3, frames=1)[0]
    imgL, imgR = st.images[0], st.images_right[0]
    extract = orb.make_extractor(cfg.orb, cfg.camera, device="cpu")
    fL, fR = extract(torch.as_tensor(imgL)), extract(torch.as_tensor(imgR))
    ur = stereo.with_stereo(fL, fR, cfg.camera, cfg.orb.scale_factor,
                            img_left=torch.as_tensor(imgL),
                            img_right=torch.as_tensor(imgR)).u_right

    def rows(f):
        ok = f.valid
        return {"xy": f.xy[ok].numpy(), "level": f.level[ok].numpy(), "desc": f.desc[ok].numpy(),
                "valid": np.ones(int(ok.sum()), bool)}

    left, right = rows(fL), rows(fR)
    kw = dict(bf=cfg.camera.bf, min_z=cfg.camera.baseline, scale=cfg.orb.scale_factor)
    want = ref.associate(imgL, imgR, left, right, **kw)
    judged = ref.determinate(imgL, imgR, left, right, **kw)
    ev = {"keyframes": [(imgL, imgR, left, right, ur[fL.valid].numpy())], "counters": {}}
    return ev, want, judged, cfg, cell.mix["limits"]


def _numbers(ev, cfg, ur):
    (imgL, imgR, left, right, _), = ev["keyframes"]
    return check.numbers({**ev, "keyframes": [(imgL, imgR, left, right, ur)]}, cfg, "cpu",
                         False)


def test_the_sound_evidence_reads_no_fault(evidence):
    ev, _, _, cfg, limits = evidence
    got = _numbers(ev, cfg, ev["keyframes"][0][4])
    assert got["stereo_row_diff"] == 0.0 and got["stereo_gap_px"] <= limits["stereo_gap_px"]
    assert check.numbers(ev, cfg, "cpu", True) == {}  # no control reading


@pytest.mark.parametrize("fault", ["moved_3px", "revived"])
def test_a_planted_fault_is_read_above_its_limit(evidence, fault):
    ev, want, judged, cfg, limits = evidence
    ur = ev["keyframes"][0][4].copy()
    if fault == "moved_3px":
        i = int(np.nonzero((ur >= 0) & judged)[0][0])
        ur[i] += 3.0
    else:  # a row rejected by the correlation or the filter, at its coarse match
        reasons = np.array(want.reason, object)
        i = int(np.nonzero(judged & (reasons != None) & (reasons != "kept"))[0][0])  # noqa: E711
        ur[i] = ev["keyframes"][0][3]["xy"][want.coarse[i], 0]
    got = _numbers(ev, cfg, ur)
    assert (got["stereo_row_diff"] > limits["stereo_row_diff"]
            or got["stereo_gap_px"] > limits["stereo_gap_px"]), got
