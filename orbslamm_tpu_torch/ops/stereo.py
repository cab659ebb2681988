"""Stereo and RGB-D depth association (port of orbslamm_tpu/ops/stereo.py).

* ``match_stereo`` — rectified left/right descriptor matching (reference
  Frame::ComputeStereoMatches): the full [M, M] Hamming matrix with the row
  band, octave band, disparity range and validity as masks, then the
  acceptance distance, the 0.85 ratio test against the runner-up and the
  mutual-best check.
* ``refine_disparity`` — the reference's 11x11 SAD correlation over +-5
  right-image columns with a parabola through the minimum, batched as one
  gather of every left patch and every right window.
* ``depth_from_depthmap`` — RGB-D association (Frame::ComputeStereoFromRGBD):
  the registered depth image sampled at each raw keypoint, and the virtual
  right coordinate ``u - bf/d``.

All return ``(u_right [M], depth [M])`` with -1 where there is none, the
``Features.u_right``/``depth`` fields. Plain torch on the device of the
inputs: the JAX package computes these with XLA, not with its Pallas
kernel, and the port launches no hand kernel here either.
"""

from __future__ import annotations

import torch

from orbslamm_tpu_torch.ops import matching as mt
from orbslamm_tpu_torch.ops.orb import Features
from orbslamm_tpu_torch.utils.trace import stage


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


def refine_disparity(img_left, img_right, xy_left, u_right, w: int = 5, r: int = 5):
    """Subpixel disparity by SAD correlation and a parabola fit: an
    (2w+1)^2 patch slid over +-r right-image columns around the coarse
    match. xy_left [M, 2] raw left keypoints, u_right [M] (-1 invalid).
    Returns the refined u_right; rows without a match pass through."""
    H, W = img_left.shape
    dev = xy_left.device
    L = img_left.to(torch.float32)
    Rimg = img_right.to(torch.float32)
    # round half to even first, then to integers (as jnp.round + astype)
    uL = torch.clamp(torch.round(xy_left[:, 0]).long(), w, W - w - 1)
    v = torch.clamp(torch.round(xy_left[:, 1]).long(), w, H - w - 1)
    uR0 = torch.clamp(torch.round(u_right).long(), w + r, W - w - r - 1)

    off = torch.arange(-w, w + 1, device=dev)
    dy = off[:, None].expand(2 * w + 1, 2 * w + 1).reshape(-1)
    dx = off[None, :].expand(2 * w + 1, 2 * w + 1).reshape(-1)  # [P]
    patch_rows = v[:, None] + dy[None, :]  # [M, P]
    patchL = L[patch_rows, uL[:, None] + dx[None, :]]
    patchL = patchL - patchL.mean(dim=-1, keepdim=True)
    dr = torch.arange(-r, r + 1, device=dev)  # [D]
    cols = uR0[:, None, None] + dr[None, :, None] + dx[None, None, :]  # [M, D, P]
    patchR = Rimg[patch_rows[:, None, :].expand_as(cols), cols]
    patchR = patchR - patchR.mean(dim=-1, keepdim=True)
    sad = (patchR - patchL[:, None, :]).abs().sum(dim=-1)  # [M, D]

    bi = torch.clamp(torch.argmin(sad, dim=-1), 1, 2 * r - 1)
    s0 = sad.gather(1, (bi - 1)[:, None])[:, 0]
    s1 = sad.gather(1, bi[:, None])[:, 0]
    s2 = sad.gather(1, (bi + 1)[:, None])[:, 0]
    denom = torch.clamp_min(s0 + s2 - 2.0 * s1, 1e-6)
    delta = torch.clamp(0.5 * (s0 - s2) / denom, -1.0, 1.0)
    u_ref = uR0.to(torch.float32) + (bi - r).to(torch.float32) + delta
    # keep the refinement only where the vertex stays near the coarse match
    ok = (u_right >= 0) & ((u_ref - u_right).abs() <= r + 1.0)
    return torch.where(ok, u_ref, u_right)


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
    """Attach stereo depth to a left Features set; with both images the
    disparity is SAD-refined to subpixel (reference parity)."""
    with stage("stereo.match"):
        u_right, depth = match_stereo(featsL, featsR, bf=cam.bf, scale_factor=scale_factor,
                                      min_z=cam.baseline)
    if img_left is not None and img_right is not None:
        with stage("stereo.refine"):
            u_right = torch.where(
                u_right >= 0, refine_disparity(img_left, img_right, featsL.xy_raw, u_right),
                u_right)
            disp = featsL.xy[:, 0] - u_right
            depth = torch.where((u_right >= 0) & (disp > 0.25),
                                cam.bf / torch.clamp_min(disp, 1e-6), torch.full_like(disp, -1.0))
    return featsL._replace(u_right=u_right, depth=depth)


def with_depthmap(feats: Features, depth_img, cam) -> Features:
    """Attach RGB-D depth to a Features set."""
    with stage("rgbd.associate"):
        u_right, depth = depth_from_depthmap(feats, depth_img, cam.depth_map_factor, cam.bf)
    return feats._replace(u_right=u_right, depth=depth)
