"""Plain ORB check: the keypoints that one image's extraction selects, and
at given keypoints their intensity-centroid angle and 256-bit rotated
binary descriptor.

It follows the extractor's stated semantics, written out directly rather
than as the program computes them: pyramid levels resized with the
antialiasing triangle kernel of ``jax.image.resize(..., "linear")``
(two weight matrices a level), the FAST-16/9 max-threshold score, a 3x3
non-maximum suppression (ties kept) above ``minThFAST`` and at least
``EDGE`` pixels inside the level, the centroid over a radius-15 disc of
the unblurred level, and a 7x7 Gaussian (sigma 2, edges replicated) under
a pattern of 256 tests between 256 points, rotated by the angle and rounded
to whole pixels. The pattern is data of the extractor's definition: the
generators below draw it with the same seeds. The selection: ORB-SLAM2's
geometric budget per level, the corners of each ``cell`` x ``cell`` block
ranked by response, then the level's budget taken by rank first and
response second (the lower index first among equals).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from benchmark.reference.precision import Precision

EDGE = 20
IC_R = 15
N_POINTS = 256
CIRCLE = [(0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
          (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3)]


def pattern_points() -> np.ndarray:
    rng = np.random.default_rng(20240817)
    pts = rng.normal(0.0, 6.2, size=(N_POINTS, 2))
    return np.clip(np.round(pts), -13, 13).astype(np.int64)


def pattern_tests() -> np.ndarray:
    rng = np.random.default_rng(20240818)
    a = rng.integers(0, N_POINTS, size=256)
    b = rng.integers(0, N_POINTS, size=256)
    pts = pattern_points()
    for _ in range(N_POINTS):
        clash = (a == b) | np.all(pts[a] == pts[b], axis=-1)
        if not clash.any():
            break
        b = np.where(clash, (b + 17) % N_POINTS, b)
    return np.stack([a, b], axis=-1).astype(np.int64)


def level_budgets(n_features: int, n_levels: int, scale: float) -> list[int]:
    """ORB-SLAM2's per-level feature budget (ORBextractor.cc)."""
    f = 1.0 / scale
    total = n_features * (1 - f) / (1 - f ** n_levels)
    counts = [int(round(total * f ** lv)) for lv in range(n_levels - 1)]
    counts.append(max(n_features - sum(counts), 1))
    return counts


def level_shape(h: int, w: int, scale: float, level: int) -> tuple[int, int]:
    s = scale ** level
    return max(int(round(h / s)), 2 * EDGE + 2), max(int(round(w / s)), 2 * EDGE + 2)


def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] float64: the triangle kernel widened by the downscale
    factor, normalised per output sample, zero for samples outside."""
    inv = n_in / n_out
    ks = max(inv, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / ks
    w = np.maximum(0.0, 1.0 - x)
    tot = w.sum(axis=0, keepdims=True)
    w = np.where(tot > 0, w / np.where(tot > 0, tot, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).T


def level_image(img: torch.Tensor, scale: float, level: int, prec: Precision) -> torch.Tensor:
    h, w = img.shape
    if level == 0:
        return img.to(prec.dtype)
    hl, wl = level_shape(h, w, scale, level)
    ry = prec.t(resize_matrix(h, hl), img.device)
    rx = prec.t(resize_matrix(w, wl), img.device)
    return prec.mm(prec.mm(ry, img), rx.T).to(prec.dtype)


def _at(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """img[y, x] with edges replicated."""
    h, w = img.shape
    return img[y.clamp(0, h - 1), x.clamp(0, w - 1)]


def fast_score(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """FAST-16/9 max-threshold score at integer positions: the largest,
    over both polarities and the 16 arcs of 9 contiguous circle pixels, of
    the arc's smallest signed difference to the centre; at least 0."""
    c = _at(img, y, x)
    d = torch.stack([_at(img, y + dy, x + dx) - c for dx, dy in CIRCLE], dim=-1)
    best = torch.zeros_like(c)
    for start in range(16):
        arc = d[..., [(start + k) % 16 for k in range(9)]]
        best = torch.maximum(best, torch.maximum(arc.min(-1).values, (-arc).min(-1).values))
    return best


def score_map(img: torch.Tensor) -> torch.Tensor:
    """FAST score of every pixel of a level, edges replicated."""
    h, w = img.shape
    y = torch.arange(h, device=img.device)[:, None].expand(h, w)
    x = torch.arange(w, device=img.device)[None, :].expand(h, w)
    return fast_score(img, y, x)


def pick_level(score: torch.Tensor, n_slots: int, min_th: float, cell: int) -> torch.Tensor:
    """[H, W] bool: the level's keypoints: corners kept by a 3x3 suppression
    (ties kept) above ``min_th`` and ``EDGE`` inside, each ``cell`` block's
    first ``kc`` by response, then ``n_slots`` of them by rank in their block
    first and response second, the lower index first among equals."""
    h, w = score.shape
    dev = score.device
    pad = torch.full((h + 2, w + 2), -math.inf, dtype=score.dtype, device=dev)
    pad[1:-1, 1:-1] = score
    nb = torch.stack([pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                      for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dy or dx]).amax(0)
    inside = torch.zeros_like(score, dtype=torch.bool)
    inside[EDGE:h - EDGE, EDGE:w - EDGE] = True
    keep = inside & (score >= nb) & (score > min_th)
    hp, wp = -(-h // cell) * cell, -(-w // cell) * cell
    nch, ncw = hp // cell, wp // cell
    val = torch.full((hp, wp), -1.0, dtype=score.dtype, device=dev)
    val[:h, :w] = torch.where(keep, score, torch.full_like(score, -1.0))
    val = val.reshape(nch, cell, ncw, cell).permute(0, 2, 1, 3).reshape(nch * ncw, -1)
    kc = min(cell * cell, max(8, -(-4 * n_slots // (nch * ncw))))
    order = torch.sort(val, dim=-1, descending=True, stable=True)
    vals, pos = order.values[:, :kc], order.indices[:, :kc]
    rank = torch.arange(kc, device=dev, dtype=score.dtype)[None, :].expand_as(vals)
    key = torch.where(vals > 0, rank * 512.0 + (256.0 - vals.clamp_max(255.0)),
                      torch.full_like(vals, 1e9)).reshape(-1)
    sel = torch.sort(key, stable=True).indices[:n_slots]
    sel = sel[key[sel] < 1e9]
    picked = torch.zeros((nch * ncw, cell * cell), dtype=torch.bool, device=dev)
    picked[sel // kc, pos.reshape(-1)[sel]] = True
    return picked.reshape(nch, ncw, cell, cell).permute(0, 2, 1, 3).reshape(hp, wp)[:h, :w]


def pick_sure(score: torch.Tensor, n_slots: int, min_th: float, cell: int, eps: float,
              trials: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """(picked, sure) [H, W]: the level's keypoints, and the pixels whose
    decision stands when every score moves by up to ``eps`` (``trials``
    draws, fixed): near-ties at the threshold, in the suppression, in a
    block's ranking and at the budget's cut are not sure."""
    picked = pick_level(score, n_slots, min_th, cell)
    sure = torch.ones_like(picked)
    if eps > 0:
        gen = torch.Generator(device=score.device).manual_seed(0)
        for _ in range(trials):
            jitter = (torch.rand(score.shape, generator=gen, device=score.device,
                                 dtype=score.dtype) * 2 - 1) * eps
            sure &= pick_level(score + jitter, n_slots, min_th, cell) == picked
    return picked, sure


def keypoints(image_u8, *, n_features: int, n_levels: int, scale: float, min_th: float,
              cell: int, prec: Precision, device) -> tuple[np.ndarray, np.ndarray]:
    """The extraction's keypoints: (xy [N, 2] level-0 pixels, level [N])."""
    img0 = torch.as_tensor(np.asarray(image_u8), device=device).to(prec.dtype)
    xys, levels = [], []
    for lv, n_slots in enumerate(level_budgets(n_features, n_levels, scale)):
        picked = pick_level(score_map(level_image(img0, scale, lv, prec)), n_slots, min_th, cell)
        yx = torch.nonzero(picked).cpu().numpy()
        xys.append(yx[:, ::-1] * scale ** lv)
        levels.append(np.full(len(yx), lv))
    return np.concatenate(xys), np.concatenate(levels)


def keypoint_diff(image_u8, xy, level, *, n_features: int, n_levels: int, scale: float,
                  min_th: float, cell: int, prec: Precision, device, eps: float = 1e-2):
    """(differing, sure, picked): keypoints of the extraction's selection
    that the given set ``xy`` [N, 2] (level-0 pixels) at ``level`` [N]
    lacks or has beyond it, where the decision is sure; the pixels judged
    sure; the reference's keypoints. Level 0 is exact (integer scores:
    nothing is unsure there); a resized level leaves ``eps`` for the
    rounding of its image."""
    img0 = torch.as_tensor(np.asarray(image_u8), device=device).to(prec.dtype)
    xy = torch.as_tensor(np.asarray(xy, np.float64), device=device)
    level = torch.as_tensor(np.asarray(level), device=device).long()
    diff = sure = picked = 0
    for lv, n_slots in enumerate(level_budgets(n_features, n_levels, scale)):
        img = level_image(img0, scale, lv, prec)
        sel, ok = pick_sure(score_map(img), n_slots, min_th, cell, eps if lv else 0.0)
        h, w = img.shape
        p = torch.round(xy[level == lv] / scale ** lv).long()
        mine = torch.zeros((h, w), dtype=torch.bool, device=device)
        mine[p[:, 1].clamp(0, h - 1), p[:, 0].clamp(0, w - 1)] = True
        diff += int(((mine ^ sel) & ok).sum())
        sure += int(((mine | sel) & ok).sum())
        picked += int(sel.sum())
    return diff, sure, picked


@dataclass
class OrbCheck:
    angle: torch.Tensor  # [N] the reference's own angle
    desc: torch.Tensor  # [N, 32] uint8, sampled at the angle it was given
    # [N] |(m10, m01)| over the disc's moment scale sum((|dx| + |dy|) I): how
    # well the angle is determined (a small centroid's angle is not)
    centroid: torch.Tensor


def describe(image_u8, xy, level, angle, *, n_levels: int, scale: float,
             prec: Precision, device) -> OrbCheck:
    """The reference's reading of keypoints ``xy`` [N, 2] (level-0 pixels),
    ``level`` [N]; descriptors are sampled at ``angle`` [N] or, where it is
    None, at the reference's own angle."""
    img0 = torch.as_tensor(np.asarray(image_u8), device=device).to(prec.dtype)
    h0, w0 = img0.shape
    xy = torch.as_tensor(np.asarray(xy, np.float64), device=device)
    level = torch.as_tensor(np.asarray(level), device=device).long()
    n = xy.shape[0]
    ang = torch.zeros(n, dtype=torch.float64, device=device)
    cen = torch.zeros(n, dtype=torch.float64, device=device)
    desc = torch.zeros((n, 32), dtype=torch.uint8, device=device)
    pts = torch.as_tensor(pattern_points(), device=device)
    tests = torch.as_tensor(pattern_tests(), device=device)
    g = np.exp(-np.arange(-3, 4) ** 2 / 8.0)
    g = prec.t(np.outer(g, g) / g.sum() ** 2, device)  # [7, 7]
    taps = torch.arange(-3, 4, device=device)
    dys = torch.arange(-IC_R, IC_R + 1, device=device)
    hw = torch.floor(torch.sqrt((IC_R * IC_R - dys * dys).double().clamp_min(0) + 1e-9)).long()
    disc = (torch.arange(-IC_R, IC_R + 1, device=device)[None, :].abs() <= hw[:, None])
    wx = prec.t(disc * torch.arange(-IC_R, IC_R + 1, device=device)[None, :], device)
    wy = prec.t(disc * dys[:, None], device)
    dxs = torch.arange(-IC_R, IC_R + 1, device=device)
    wabs = prec.t(disc * (dys[:, None].abs() + dxs[None, :].abs()), device)
    shifts = torch.arange(8, device=device)
    for lv in torch.unique(level).tolist():
        sel = torch.nonzero(level == lv)[:, 0]
        img = level_image(img0, scale, lv, prec)
        p = torch.round(xy[sel] / scale ** lv).long()
        x, y = p[:, 0], p[:, 1]
        yy = y[:, None, None] + dys[None, :, None]
        xx = x[:, None, None] + torch.arange(-IC_R, IC_R + 1, device=device)[None, None, :]
        patch = _at(img, yy, xx)  # [n, 31, 31]
        m10 = prec.einsum("nij,ij->n", patch, wx)
        m01 = prec.einsum("nij,ij->n", patch, wy)
        own = torch.atan2(m01.double(), m10.double())
        ang[sel] = own
        cen[sel] = torch.hypot(m10.double(), m01.double()) / prec.einsum(
            "nij,ij->n", patch, wabs).double().clamp_min(1e-12)
        a = own if angle is None else torch.as_tensor(
            np.asarray(angle), device=device).double()[sel]
        c, si = torch.cos(a)[:, None], torch.sin(a)[:, None]
        px, py = pts[:, 0].double()[None], pts[:, 1].double()[None]
        rx = torch.round(c * px - si * py).long()
        ry = torch.round(si * px + c * py).long()
        sy = (y[:, None] + ry)[:, :, None, None] + taps[None, None, :, None]
        sx = (x[:, None] + rx)[:, :, None, None] + taps[None, None, None, :]
        v = prec.einsum("npij,ij->np", _at(img, sy, sx), g)  # [n, 256]
        bits = (v[:, tests[:, 0]] < v[:, tests[:, 1]]).to(torch.uint8).reshape(-1, 32, 8)
        desc[sel] = (bits << shifts).sum(-1).to(torch.uint8)
    return OrbCheck(angle=ang, desc=desc, centroid=cen)


_POP = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int64)


def bit_errors(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N] differing bits between two [N, 32] uint8 descriptor sets."""
    x = torch.bitwise_xor(a.to(torch.uint8), b.to(torch.uint8)).long()
    return _POP.to(x.device)[x].sum(-1)


def angle_gap(a, b) -> torch.Tensor:
    d = torch.as_tensor(a).double() - torch.as_tensor(b).double().to(
        torch.as_tensor(a).device)
    return torch.remainder(d + math.pi, 2 * math.pi) - math.pi
