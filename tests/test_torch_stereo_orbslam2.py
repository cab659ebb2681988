"""The port's stereo association against the plain reference of ORB-SLAM2's
``Frame::ComputeStereoMatches`` (``benchmark/reference/stereo.py``).

  * on a rendered 320x240 pair (the port's own extractor on both images,
    400 features, 4 levels, bf 130): kept and rejected rows exactly the
    reference's, ``u_right`` within 1e-4 px (float32 against float64 at
    coordinates below 320), ``depth`` within 1e-5 relative, and the six
    ``stereo.*`` counters the process Tracer reads equal to the
    reference's counts;
  * one case per rule on planted rows (a textured image and its copy
    shifted by a known disparity, the coarse match placed so that the SAD's
    minimum, a patch's border or a row's SAD is known): the minimum at
    either end of the search, the parabola's vertex at its bound, a search
    window off the image on either side and a patch off its rows, and the
    median filter with an odd and an even count of kept rows; each row's
    outcome and the counts equal the reference's;
  * the Tracer's device counts: summed on their device, read once with the
    counters.

A vertex outside [-1, 1] cannot be planted: with the first least SAD inside
the search, ``s0 > s1 <= s2`` and ``|deltaR| <= 1/2``. The vertex case
plants the widest vertex there is, +1/2, and holds it kept.
"""

import numpy as np
import pytest
import torch

from benchmark.reference import stereo as ref
from orbslamm_tpu_torch.io.synthetic import make_sequence
from orbslamm_tpu_torch.ops import orb as to
from orbslamm_tpu_torch.ops import stereo as tst
from orbslamm_tpu_torch.utils.config import CameraConfig, OrbConfig
from orbslamm_tpu_torch.utils.trace import Tracer, get_tracer

torch.set_num_threads(2)

CAM = CameraConfig(width=320, height=240, fx=260, fy=260, cx=160, cy=120, fps=30,
                   bf=130.0, th_depth=60.0, depth_map_factor=1.0)
ORB = OrbConfig(n_features=400, max_keypoints=1024, n_levels=4)
MAX_DISP = CAM.bf / CAM.baseline


def _feature_dict(f):
    return {"xy": f.xy.numpy(), "level": f.level.numpy(), "desc": f.desc.numpy(),
            "valid": f.valid.numpy()}


def _counters():
    c = get_tracer().metrics()["counters"]
    return {k: c.get(k, 0.0) for k in tst.STEREO_COUNTERS}


@pytest.mark.parametrize("seed", [3, 11])
def test_with_stereo_matches_the_reference(seed):
    seq = make_sequence(n_frames=1, n_points=900, cam=CAM, seed=seed, motion="forward",
                        stereo=True)
    imgL, imgR = seq.images[0], seq.images_right[0]
    extract = to.make_extractor(ORB, CAM, device="cpu")
    fL, fR = extract(torch.as_tensor(imgL)), extract(torch.as_tensor(imgR))
    before = _counters()
    got = tst.with_stereo(fL, fR, CAM, ORB.scale_factor, img_left=torch.as_tensor(imgL),
                          img_right=torch.as_tensor(imgR))
    after = _counters()
    want = ref.associate(imgL, imgR, _feature_dict(fL), _feature_dict(fR), bf=CAM.bf,
                         min_z=CAM.baseline, scale=ORB.scale_factor)
    u, d = got.u_right.numpy(), got.depth.numpy()
    kept = want.u_right >= 0
    assert np.array_equal(u >= 0, kept) and np.array_equal(d > 0, kept)
    assert kept.sum() >= 50
    np.testing.assert_allclose(u[kept], want.u_right[kept], rtol=0, atol=1e-4)
    np.testing.assert_allclose(d[kept], want.depth[kept], rtol=1e-5, atol=0)
    counts = want.counts()
    assert {k: after[k] - before[k] for k in tst.STEREO_COUNTERS} == counts
    # the filter has work on a rendered pair: coarse matches are rejected
    assert counts["stereo.rows_matched"] > counts["stereo.rows_kept"]


# -- planted rows -------------------------------------------------------------

H, W, DISP = 96, 160, 12  # the right image is the left one moved DISP px left
NORMAL = [(40 + 14 * k, 14 + 12 * (k % 5)) for k in range(6)]  # (uL, v) rows kept


def _images(bumps=()):
    """A textured left image and its copy moved DISP px to the left; each
    bump (u, v, a) adds ``a`` to one right-image pixel, which raises that
    row's least SAD by exactly ``a``."""
    rng = np.random.default_rng(7)
    left = rng.integers(0, 200, (H, W)).astype(np.int64)
    right = np.zeros_like(left)
    right[:, :W - DISP] = left[:, DISP:]
    right[:, W - DISP:] = rng.integers(0, 200, (H, DISP))
    for u, v, a in bumps:
        right[v, u] += a
    return left.astype(np.uint8), right.astype(np.uint8)


def _run(left, right, rows):
    """The port's refinement and the reference's on rows (uL, v, uR0)."""
    xy = np.array([[u, v] for u, v, _ in rows], np.float32)
    ur = np.array([r for _, _, r in rows], np.float32)
    u, d, counts = tst.refine_disparity(torch.as_tensor(left), torch.as_tensor(right),
                                        torch.as_tensor(xy), torch.as_tensor(ur), CAM.bf,
                                        MAX_DISP)
    want = ref.correlate(left, right, xy.astype(np.float64), ur, bf=CAM.bf, max_disp=MAX_DISP)
    kept = want.u_right >= 0
    assert np.array_equal(u.numpy() >= 0, kept)
    np.testing.assert_allclose(u.numpy()[kept], want.u_right[kept], rtol=0, atol=1e-4)
    np.testing.assert_allclose(d.numpy()[kept], want.depth[kept], rtol=1e-5, atol=0)
    assert dict(zip(tst.STEREO_COUNTERS, counts.tolist())) == want.counts()
    return u.numpy(), want.reason


def _normal():
    return [(u, v, u - DISP) for u, v in NORMAL]


def _bumps(rows, sads):
    """One bump off each row's patch centre, at its true match in the right
    image: the row's least SAD is then ``a``."""
    return [(u - DISP + 2, v + 1, a) for (u, v, _), a in zip(rows, sads)]


# the kept rows' SADs beside a planted row: none at 2.1 x their median
NORMAL_SADS = [20, 25, 30, 35, 40, 45]


@pytest.mark.parametrize("rule", ["edge_low", "edge_high", "vertex_bound", "border_left",
                                  "border_right", "border_rows"])
def test_each_rejection_on_a_planted_row(rule):
    if rule == "edge_low":  # the true match 5 columns left of the coarse one
        row, expect = (60, 50, 60 - DISP + 5), "edge"
    elif rule == "edge_high":
        row, expect = (60, 50, 60 - DISP - 5), "edge"
    elif rule == "vertex_bound":
        # a ramp along the row in both images, over the left patch and over
        # the right columns of shifts 0 and +1 alone: less their centre
        # pixels both match the left patch (SAD 0), shift -1 does not, so
        # s1 = s2 = 0 < s0 and deltaR = +1/2
        row, expect = (60, 50, 60 - DISP), "kept"
    elif rule == "border_left":  # the search's left end at column -1
        row, expect = (26, 50, 9), "border"
    elif rule == "border_right":  # its right end at column W
        row, expect = (W - 6, 50, W - 10), "border"
    else:  # the patch's top row at -1
        row, expect = (60, 4, 60 - DISP), "border"
    left, right = _images(_bumps(_normal(), NORMAL_SADS))
    if rule == "vertex_bound":
        uL, v, u0 = row
        base = np.random.default_rng(9).integers(0, 150, (11, 1))
        left[v - 5:v + 6, uL - 5:uL + 6] = base + np.arange(11)
        right[v - 5:v + 6, u0 - 5:u0 + 7] = base + np.arange(12)
    u, reason = _run(left, right, _normal() + [row])
    assert reason[-1] == expect
    assert all(r == "kept" for r in reason[:-1])
    if rule == "vertex_bound":
        assert u[-1] == pytest.approx(row[2] + 0.5, abs=1e-4)


@pytest.mark.parametrize("n_kept", [5, 6])
def test_the_median_filter(n_kept):
    """Rows whose least SAD is raised by a bump: the median is the SAD at
    index n // 2 of the kept rows, and a row at or above 2.1 times it goes."""
    sads = [0, 10, 20, 30, 40, 90] if n_kept == 6 else [0, 10, 20, 30, 50]
    rows = [(u, v, u - DISP) for (u, v) in NORMAL[:n_kept]]
    left, right = _images(_bumps(rows, sads))
    median = sorted(sads)[n_kept // 2]  # 20 of 5 rows, 30 of 6
    u, reason = _run(left, right, rows)
    assert [r == "median" for r in reason] == [a >= 2.1 * median for a in sads]
    assert reason[-1] == "median" and reason.count("median") == 1


def test_device_counts_are_read_with_the_counters():
    tr = Tracer()
    names = ("a", "b")
    tr.add_device_counts(names, torch.tensor([1, 2]))
    tr.add_device_counts(names, torch.tensor([3, 4]))
    tr.incr("a", 1.0)
    assert tr.metrics()["counters"] == {"a": 5.0, "b": 6.0}
    assert tr.report()["counters"] == {"a": 5.0, "b": 6.0}  # read once, not twice
    tr.enabled = False
    tr.add_device_counts(names, torch.tensor([1, 1]))
    assert tr.metrics()["counters"]["a"] == 5.0
