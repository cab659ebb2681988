"""Stereo and RGB-D depth association.

* ``match_stereo`` — rectified left/right descriptor matching (the JAX
  package's rule, ``orbslamm_tpu/ops/stereo.py``): the full [M, M] Hamming
  matrix with the row band, octave band, disparity range and validity as
  masks, then the acceptance distance, the 0.85 ratio test against the
  runner-up and the mutual-best check.
* ``refine_disparity`` — ORB-SLAM2's correlation step and final filter
  (``Frame::ComputeStereoMatches``, ``src/Frame.cc``): an 11x11 patch with
  its centre pixel subtracted (``IL - IL(w,w)``, likewise each right
  patch), its SAD at +-5 right-image columns around the coarse match, and a
  parabola through the minimum. A row is rejected where the minimum lies
  at either end of the search (``bestincR == +-L``), where the vertex
  ``deltaR = (s0 - s2) / (2 (s0 + s2 - 2 s1))`` leaves [-1, 1], where a
  patch of the search leaves the image, and where the refined disparity
  leaves (0.25, bf / baseline); of the rows left, those whose SAD is at
  least ``1.5f * 1.4f`` times the median (index n // 2 of the ascending
  sort) go too. No row falls back to the coarse match. The SAD sums at
  most 121 integers, so the argmin, the vertex and the filter are exact.
  One batched gather of every left patch and every right strip; the
  median is taken on the device with no host read.
* ``depth_from_depthmap`` — RGB-D association (Frame::ComputeStereoFromRGBD):
  the registered depth image sampled at each raw keypoint, and the virtual
  right coordinate ``u - bf/d``.

Departures from ORB-SLAM2's stereo association, shared with
``benchmark/reference/stereo.py``: the correlation runs on the level-0
images at the keypoint's level-0 position, not on the keypoint's octave;
the descriptor stage keeps the JAX package's rule (a band of 2 x scale^octave
rows around the left keypoint, the acceptance at ``<=`` 75, the ratio test
and the mutual-best check, none of which ORB-SLAM2 has); the disparity floor
is 0.25 px, not 0 with a clamp to 0.01; the border test takes the whole
search window and the left patch (ORB-SLAM2 tests ``uR0 + L - w``).
Coordinates are rounded half away from zero, as C's ``round``.

All return ``(u_right [M], depth [M])`` with -1 where there is none, the
``Features.u_right``/``depth`` fields. Plain torch on the device of the
inputs: the port launches no hand kernel here.
"""

from __future__ import annotations

import numpy as np
import torch

from orbslamm_tpu_torch.ops import matching as mt
from orbslamm_tpu_torch.ops.orb import Features
from orbslamm_tpu_torch.utils.trace import get_tracer, stage

# the refinement's row counts, accumulated on the device (``refine_disparity``)
STEREO_COUNTERS = ("stereo.rows_matched", "stereo.rows_kept", "stereo.rejected_edge",
                   "stereo.rejected_vertex", "stereo.rejected_border",
                   "stereo.rejected_median")
# ORB-SLAM2's ``1.5f*1.4f``, a float32 constant
SAD_MEDIAN_FACTOR = float(np.float32(1.5) * np.float32(1.4))


def match_stereo(featsL: Features, featsR: Features, bf: float, scale_factor: float = 1.2,
                 th_dist: float = 75.0, min_z: float | None = None,
                 max_row_band: float = 2.0):
    """Rectified stereo association. Returns (u_right [M], depth [M]).

    th_dist: acceptance Hamming distance, the reference's (TH_HIGH+TH_LOW)/2
    = 75. min_z: the least depth (the baseline, reference minZ = mb); it
    sets the largest disparity bf/min_z."""
    D = mt.hamming_matrix(featsL.desc, featsR.desc)  # [M, M]
    inf = torch.full_like(D, float("inf"))
    # row band |vL - vR| <= max_row_band * scale of the left octave
    band = max_row_band * scale_factor ** featsL.level.to(torch.float32)
    row_ok = (featsL.xy[:, None, 1] - featsR.xy[None, :, 1]).abs() <= band[:, None]
    lvl_ok = mt.level_mask(featsL.level, featsR.level)  # right octave in [octL-1, octL+1]
    disp = featsL.xy[:, None, 0] - featsR.xy[None, :, 0]
    max_disp = bf / max(min_z, 1e-6) if min_z else 1e9
    disp_ok = (disp > 0.25) & (disp <= max_disp)
    valid = featsL.valid[:, None] & featsR.valid[None, :]
    Dm = torch.where(row_ok & lvl_ok & disp_ok & valid, D, inf)
    # argmin takes the first minimum; a row (column) with no candidate
    # gives 0, as jnp.argmin does
    j = torch.argmin(Dm, dim=1)
    rows = torch.arange(Dm.shape[0], device=Dm.device)
    best = Dm[rows, j]
    ok = torch.isfinite(best) & (best <= th_dist)
    # the runner-up masks only the winner's column: an equal distance in
    # another column is the runner-up and fails the ratio test
    winner = torch.zeros_like(Dm, dtype=torch.bool)
    winner[rows, j] = True
    second = torch.where(winner, inf, Dm).amin(dim=1)
    ok = ok & (best <= 0.85 * torch.where(torch.isfinite(second), second,
                                          torch.full_like(second, 1e9)))
    rev = torch.argmin(Dm, dim=0)
    ok = ok & (rev[j] == rows)

    uR = featsR.xy[j, 0]
    depth = bf / torch.clamp_min(featsL.xy[:, 0] - uR, 1e-6)
    minus1 = torch.full_like(uR, -1.0)
    return torch.where(ok, uR, minus1), torch.where(ok, depth, minus1)


def _round(x: torch.Tensor) -> torch.Tensor:
    """C's ``round`` for the non-negative pixel coordinates it is given
    (half away from zero), as integers."""
    return torch.floor(x + 0.5).long()


def refine_disparity(img_left, img_right, xy_left, u_right, bf: float, max_disp: float,
                     w: int = 5, r: int = 5):
    """ORB-SLAM2's correlation step and final filter (module docstring):
    the (2w+1)^2 level-0 patch at each left keypoint, its centre pixel
    subtracted, slid over +-r right-image columns around the coarse match
    ``u_right`` [M] (-1 where none); rows at the window's edge, with the
    parabola's vertex outside [-1, 1] or with a window off the image
    rejected, then those whose SAD is at least 1.5 x 1.4 x the median of
    the kept rows. Returns (u_right [M], depth [M], -1 where rejected or
    unmatched; counts [6] int64 on the device, ``STEREO_COUNTERS``' order)."""
    H, W = img_left.shape
    M = xy_left.shape[0]
    dev = xy_left.device
    matched = u_right >= 0
    uL, v, uR0 = _round(xy_left[:, 0]), _round(xy_left[:, 1]), _round(u_right)
    border = matched & ((v < w) | (v > H - 1 - w) | (uL < w) | (uL > W - 1 - w)
                        | (uR0 < w + r) | (uR0 > W - 1 - w - r))
    # gather at clamped positions; a row whose window leaves the image is
    # rejected (``border``), never moved inward
    v = v.clamp(w, H - 1 - w)
    uLc = uL.clamp(w, W - 1 - w)
    uRc = uR0.clamp(w + r, W - 1 - w - r)
    off = torch.arange(-w, w + 1, device=dev)
    rows = (v[:, None] + off)[:, :, None]  # [M, 2w+1, 1]
    L = img_left.to(torch.int32)
    R = img_right.to(torch.int32)
    patchL = L[rows, (uLc[:, None] + off)[:, None, :]]  # [M, 2w+1, 2w+1]
    patchL = patchL - patchL[:, w:w + 1, w:w + 1]
    span = torch.arange(-(w + r), w + r + 1, device=dev)
    strip = R[rows, (uRc[:, None] + span)[:, None, :]]  # [M, 2w+1, 2(w+r)+1]
    patchR = strip.unfold(2, 2 * w + 1, 1)  # [M, row, shift, col]
    patchR = patchR - patchR[:, w:w + 1, :, w:w + 1]
    # integers: exact in any order of summation
    sad = (patchR - patchL[:, :, None, :]).abs().sum(dim=(1, 3))  # [M, 2r+1]

    best = torch.argmin(sad, dim=1)  # the first minimum (ORB-SLAM2's strict <)
    s1 = sad.gather(1, best[:, None])[:, 0]
    edge = matched & ~border & ((best == 0) | (best == 2 * r))
    bi = best.clamp(1, 2 * r - 1)
    s0 = sad.gather(1, (bi - 1)[:, None])[:, 0]
    s2 = sad.gather(1, (bi + 1)[:, None])[:, 0]
    delta = (s0 - s2).to(torch.float32) / (2 * (s0 + s2 - 2 * s1)).to(torch.float32)
    live = matched & ~border & ~edge
    vertex = live & ((delta < -1.0) | (delta > 1.0))
    live = live & ~vertex
    u0 = (uR0 + best - r).to(torch.float32)
    disp = (xy_left[:, 0] - u0) - delta
    live = live & (disp > 0.25) & (disp < max_disp)
    # the median of the kept rows' SADs, index n // 2 of the ascending sort,
    # gathered with n on the device
    big = torch.iinfo(sad.dtype).max
    ranked = torch.sort(torch.where(live, s1, torch.full_like(s1, big))).values
    n = live.sum()
    median = ranked.gather(0, torch.clamp_max(n // 2, M - 1).reshape(1))
    median_out = live & (s1.to(torch.float32) >= median.to(torch.float32) * SAD_MEDIAN_FACTOR)
    keep = live & ~median_out
    counts = torch.stack([matched, keep, edge, vertex, border, median_out]).sum(dim=1)
    minus1 = torch.full_like(disp, -1.0)
    return (torch.where(keep, u0 + delta, minus1),
            torch.where(keep, bf / torch.clamp_min(disp, 1e-6), minus1), counts)


def depth_from_depthmap(feats: Features, depth_img, depth_map_factor: float, bf: float):
    """RGB-D association: nearest-pixel depth at each raw keypoint (the
    depth image is registered to the raw image), d > 0 and finite kept."""
    H, W = depth_img.shape
    dm = depth_img.to(torch.float32)
    if depth_map_factor not in (0.0, 1.0):
        dm = dm / depth_map_factor
    u = torch.clamp(torch.round(feats.xy_raw[:, 0]).long(), 0, W - 1)
    v = torch.clamp(torch.round(feats.xy_raw[:, 1]).long(), 0, H - 1)
    d = dm[v, u]
    ok = feats.valid & (d > 0.0) & torch.isfinite(d)
    minus1 = torch.full_like(d, -1.0)
    u_right = feats.xy[:, 0] - bf / torch.clamp_min(d, 1e-6)
    return torch.where(ok, u_right, minus1), torch.where(ok, d, minus1)


def with_stereo(featsL: Features, featsR: Features, cam, scale_factor=1.2,
                img_left=None, img_right=None) -> Features:
    """Attach stereo depth to a left Features set: the descriptor match and,
    with both images, ORB-SLAM2's correlation and filter, whose six row
    counts go to the process Tracer's ``STEREO_COUNTERS`` without a host
    read."""
    H, W = (cam.height, cam.width) if img_left is None else img_left.shape
    shape = dict(M=featsL.desc.shape[0], H=int(H), W=int(W))
    with stage("stereo.match", **shape):
        u_right, depth = match_stereo(featsL, featsR, bf=cam.bf, scale_factor=scale_factor,
                                      min_z=cam.baseline)
    if img_left is not None and img_right is not None:
        with stage("stereo.refine", **shape):
            u_right, depth, counts = refine_disparity(
                img_left, img_right, featsL.xy_raw, u_right, cam.bf,
                cam.bf / max(cam.baseline, 1e-6))
            get_tracer().add_device_counts(STEREO_COUNTERS, counts)
    return featsL._replace(u_right=u_right, depth=depth)


def with_depthmap(feats: Features, depth_img, cam) -> Features:
    """Attach RGB-D depth to a Features set."""
    with stage("rgbd.associate"):
        u_right, depth = depth_from_depthmap(feats, depth_img, cam.depth_map_factor, cam.bf)
    return feats._replace(u_right=u_right, depth=depth)
