"""ORB feature extraction on tensors (port of orbslamm_tpu/ops/orb.py).

Same design as the JAX package: an exact FAST-16/9 max-threshold score for
every pixel, NMS, a cell-rank spread selection of keypoints per pyramid
level, intensity-centroid orientation from full-image moment maps, and a
256-bit rotated binary descriptor sampled from a shared pool of 256 points
of the blurred level image. All shapes are fixed per (OrbConfig, image
size); invalid slots are masked.

The numpy generators of the descriptor pattern, the intensity-centroid mask
and the per-level budgets are copied from the JAX package (it imports jax,
so this package cannot import it); a test checks that the copies equal the
originals.

Pyramid levels are resized with two dense weight matrices per level,
``img_l = Ry @ img0 @ Rx.T``, computed in numpy with the scale-and-translate
triangle kernel of ``jax.image.resize(..., "linear")`` — which antialiases
when it downscales, unlike ``F.interpolate``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from orbslamm_tpu_torch.utils.config import CameraConfig, OrbConfig

PATCH_R = 20  # covers the rotated pattern (|p|<=13 -> 19) plus rounding
IC_R = 15  # intensity-centroid circular mask radius (reference PATCH_SIZE 31)
EDGE = PATCH_R  # keypoints must be >= EDGE px from the level border

# 16-point Bresenham circle, radius 3, in circular order (dx, dy)
_CIRCLE = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    np.int32,
)

N_SAMPLE_POINTS = 256


class Features(NamedTuple):
    """Fixed-capacity per-frame feature set (the Frame data of the reference)."""

    xy: torch.Tensor  # [M, 2] float32 — undistorted pixel coords at level 0
    xy_raw: torch.Tensor  # [M, 2] float32 — raw (distorted) pixel coords
    angle: torch.Tensor  # [M] float32 radians
    response: torch.Tensor  # [M] float32
    level: torch.Tensor  # [M] int32 pyramid octave
    desc: torch.Tensor  # [M, 32] uint8 — 256-bit descriptor
    valid: torch.Tensor  # [M] bool
    # stereo / RGB-D fields of the JAX Features; always None in this port
    # until stereo/RGB-D is ported
    u_right: torch.Tensor | None = None
    depth: torch.Tensor | None = None

    @property
    def capacity(self) -> int:
        return self.xy.shape[-2]


# ---------------------------------------------------------------------------
# Descriptor test pattern (copied numpy generators; fixed seeds)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def pattern_points() -> np.ndarray:
    """[N_SAMPLE_POINTS, 2] int32 sample offsets in [-13, 13]."""
    rng = np.random.default_rng(20240817)
    pts = rng.normal(0.0, 6.2, size=(N_SAMPLE_POINTS, 2))
    return np.clip(np.round(pts), -13, 13).astype(np.int32)


@functools.lru_cache(maxsize=1)
def pattern_tests() -> np.ndarray:
    """[256, 2] int32 — (i, j) indices into pattern_points per bit."""
    rng = np.random.default_rng(20240818)
    a = rng.integers(0, N_SAMPLE_POINTS, size=256)
    b = rng.integers(0, N_SAMPLE_POINTS, size=256)
    pts = pattern_points()
    # walk b until no test compares a point against identical coordinates
    for _ in range(N_SAMPLE_POINTS):
        clash = (a == b) | np.all(pts[a] == pts[b], axis=-1)
        if not clash.any():
            break
        b = np.where(clash, (b + 17) % N_SAMPLE_POINTS, b)
    assert not ((a == b) | np.all(pts[a] == pts[b], axis=-1)).any()
    return np.stack([a, b], axis=-1).astype(np.int32)


@functools.lru_cache(maxsize=1)
def ic_row_halfwidths() -> np.ndarray:
    """[2*IC_R+1] int32 — half-width of the circular intensity-centroid mask
    at each dy row (|dx| <= floor(sqrt(IC_R^2 - dy^2)))."""
    r = np.arange(-IC_R, IC_R + 1)
    return np.floor(np.sqrt(np.maximum(IC_R * IC_R - r * r, 0) + 1e-9)).astype(
        np.int32
    )


def level_feature_counts(n_features: int, n_levels: int, scale: float) -> list[int]:
    """Reference geometric per-level budget (ORBextractor.cc ctor)."""
    f = 1.0 / scale
    total = n_features * (1 - f) / (1 - f**n_levels)
    counts = [int(round(total * f**l)) for l in range(n_levels - 1)]
    counts.append(max(n_features - sum(counts), 1))
    return counts


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] float32 weights of ``jax.image.resize(...,
    "linear")`` along one axis: the triangle kernel widened by the
    downscale factor (antialiasing), normalised per output sample, zero
    where the sample lies outside the input — the formula of JAX's
    scale-and-translate, evaluated in float32 like JAX does."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32).T.copy()


# ---------------------------------------------------------------------------
# Per-level pieces
# ---------------------------------------------------------------------------

def gaussian_blur7(img: torch.Tensor) -> torch.Tensor:
    """Separable 7x7 Gaussian, sigma=2 (reference GaussianBlur before
    descriptors, ORBextractor.cc:1105). Taps are summed in the JAX order."""
    x = np.arange(-3, 4, dtype=np.float32)
    k = np.exp(-(x**2) / (2 * 2.0**2))
    k /= k.sum()
    H, W = img.shape
    pad = F.pad(img[None, None], (0, 0, 3, 3), mode="replicate")[0, 0]
    out = pad[0:H, :] * float(k[0])
    for i in range(1, 7):
        out = out + pad[i:i + H, :] * float(k[i])
    pad = F.pad(out[None, None], (3, 3, 0, 0), mode="replicate")[0, 0]
    res = pad[:, 0:W] * float(k[0])
    for i in range(1, 7):
        res = res + pad[:, i:i + W] * float(k[i])
    return res


def fast_score(img: torch.Tensor) -> torch.Tensor:
    """Exact FAST-16/9 max-threshold score per pixel: max over polarity and
    over the 16 arcs of 9 consecutive circle pixels of the arc's minimum of
    polarity * (circle_px - center). Min and max are exact, so the sliding
    minimum may be taken in any order."""
    H, W = img.shape
    pad = F.pad(img[None, None].float(), (3, 3, 3, 3), mode="replicate")[0, 0]
    center = img.float()
    diffs = torch.stack(
        [pad[3 + dy:3 + dy + H, 3 + dx:3 + dx + W] - center for dx, dy in _CIRCLE],
        dim=0,
    )  # [16, H, W]
    ext = torch.cat([diffs, diffs[:8]], dim=0)  # [24, H, W]
    bright = ext.unfold(0, 9, 1).amin(-1).amax(0)
    dark = (-ext).unfold(0, 9, 1).amin(-1).amax(0)
    return torch.clamp_min(torch.maximum(bright, dark), 0.0)


def _nms3(score: torch.Tensor) -> torch.Tensor:
    m = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return score >= m


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` with its tie rule (lowest index first among equal
    values): a stable descending sort, sliced."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_level_keypoints(score: torch.Tensor, n_slots: int, min_th: float,
                           cell: int):
    """Spread-aware top-k corner selection on one pyramid level.

    Returns (xy [n_slots, 2] int32 level coords, response [n_slots], valid).
    """
    H, W = score.shape
    dev = score.device
    keep = _nms3(score) & (score > min_th)
    border = torch.zeros_like(keep)
    border[EDGE:H - EDGE, EDGE:W - EDGE] = True
    keep &= border
    eff = torch.where(keep, score, torch.full_like(score, -1.0))

    Hp = -(-H // cell) * cell
    Wp = -(-W // cell) * cell
    nch, ncw = Hp // cell, Wp // cell
    n_cells = nch * ncw
    effp = torch.full((Hp, Wp), -1.0, dtype=torch.float32, device=dev)
    effp[:H, :W] = eff
    cells = effp.reshape(nch, cell, ncw, cell).permute(0, 2, 1, 3).reshape(
        n_cells, cell * cell)
    kc = min(cell * cell, max(8, -(-4 * n_slots // n_cells)))
    vals, pos = _top_k(cells, kc)  # [n_cells, kc], response-sorted

    # selection key: spread first (cell rank), then strength
    rank = torch.arange(kc, dtype=torch.float32, device=dev)[None, :].expand_as(vals)
    key = torch.where(vals > 0, rank * 512.0 + (256.0 - torch.clamp_max(vals, 255.0)),
                      torch.full_like(vals, 1e9))
    neg_key, sel = _top_k(-key.reshape(-1), n_slots)
    valid = neg_key > -1e9
    cell_id = sel // kc
    within = pos.reshape(-1)[sel]
    x = (cell_id % ncw) * cell + within % cell
    y = (cell_id // ncw) * cell + within // cell
    xy = torch.stack([x, y], dim=-1).to(torch.int32)
    xy = torch.minimum(xy, torch.tensor([W - 1, H - 1], dtype=torch.int32, device=dev))
    resp = vals.reshape(-1)[sel]
    return xy, torch.where(valid, resp, torch.zeros_like(resp)), valid


def orientation_maps(img: torch.Tensor):
    """Full-image intensity-centroid moment maps (m10, m01), each [H, W].

    The circular mask decomposes into per-row segments, so both moments are
    sums of x-prefix-sum differences. The x-weighted prefix is taken per
    column tile of 256 with a locally centred x coordinate, which bounds its
    magnitude (see the JAX package). All 31 mask rows of a tile are
    gathered at once; on an integer image every term is an exact integer in
    float32, so the order of the sum does not change the result.
    """
    H, W = img.shape
    dev = img.device
    pad = IC_R + 1
    TB = 256
    ip = F.pad(img[None, None], (pad, pad, pad, pad))[0, 0]
    halfw = torch.as_tensor(ic_row_halfwidths(), dtype=torch.int64, device=dev)
    dys = torch.arange(-IC_R, IC_R + 1, device=dev)
    rows = (pad + dys)[:, None] + torch.arange(H, device=dev)[None, :]  # [31, H]
    m10_tiles, m01_tiles = [], []
    for t0 in range(0, W, TB):
        tw = min(TB, W - t0)
        tile = ip[:, t0:t0 + tw + 2 * pad]
        S = torch.cumsum(tile, dim=1)
        c = pad + tw // 2
        xloc = (torch.arange(tile.shape[1], dtype=img.dtype, device=dev) - c)[None, :]
        T = torch.cumsum(tile * xloc, dim=1)
        x0 = torch.arange(tw, dtype=img.dtype, device=dev)[None, :] + pad - c
        cols = torch.arange(tw, device=dev)[None, :]
        hi = (pad + halfw[:, None] + cols)[:, None, :].expand(-1, H, -1)
        lo = (pad - halfw[:, None] - 1 + cols)[:, None, :].expand(-1, H, -1)
        S_r, T_r = S[rows], T[rows]  # [31, H, tw + 2 pad]
        rowsum = S_r.gather(2, hi) - S_r.gather(2, lo)
        tsum = T_r.gather(2, hi) - T_r.gather(2, lo)
        m10_tiles.append((tsum - x0 * rowsum).sum(0))
        m01_tiles.append((dys.to(img.dtype)[:, None, None] * rowsum).sum(0))
    return torch.cat(m10_tiles, dim=1), torch.cat(m01_tiles, dim=1)


# ---------------------------------------------------------------------------
# Undistortion (Frame.cc UndistortKeyPoints equivalent)
# ---------------------------------------------------------------------------

def undistort_points(xy: torch.Tensor, cam: CameraConfig) -> torch.Tensor:
    """Iterative inverse of the radtan distortion model; [..., 2] pixels."""
    if cam.k1 == 0 and cam.k2 == 0 and cam.p1 == 0 and cam.p2 == 0 and cam.k3 == 0:
        return xy
    fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
    xd = (xy[..., 0] - cx) / fx
    yd = (xy[..., 1] - cy) / fy
    x, y = xd, yd
    for _ in range(8):
        r2 = x * x + y * y
        radial = 1.0 + cam.k1 * r2 + cam.k2 * r2 * r2 + cam.k3 * r2 * r2 * r2
        dx = 2 * cam.p1 * x * y + cam.p2 * (r2 + 2 * x * x)
        dy = cam.p1 * (r2 + 2 * y * y) + 2 * cam.p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return torch.stack([x * fx + cx, y * fy + cy], dim=-1)


# ---------------------------------------------------------------------------
# Full extractor
# ---------------------------------------------------------------------------

def make_extractor(orb: OrbConfig, cam: CameraConfig, n_features: int | None = None,
                   max_keypoints: int | None = None, *, device):
    """Build an ``image_u8 [H, W] -> Features`` extractor on ``device``.

    ``n_features`` overrides orb.n_features (the init extractor uses a larger
    budget); ``max_keypoints`` overrides the padded output capacity.
    """
    device = torch.device(device)
    H, W = cam.height, cam.width
    n_feat = n_features or orb.n_features
    counts = level_feature_counts(n_feat, orb.n_levels, orb.scale_factor)
    level_shapes = []
    for l in range(orb.n_levels):
        s = orb.scale_factor**l
        level_shapes.append((max(int(round(H / s)), 2 * EDGE + 2),
                             max(int(round(W / s)), 2 * EDGE + 2)))
    M = max_keypoints or orb.max_keypoints
    total = sum(counts)
    if total > M:
        raise ValueError(f"max_keypoints {M} < total level budget {total}")

    resize = [
        None if l == 0 else (
            torch.as_tensor(resize_weights(H, Hl), device=device),
            torch.as_tensor(resize_weights(W, Wl), device=device),
        )
        for l, (Hl, Wl) in enumerate(level_shapes)
    ]
    level_off = np.cumsum([0] + [Hl * Wl for Hl, Wl in level_shapes])[:-1]
    i32 = torch.int32
    base = torch.cat([torch.full((n_l,), int(level_off[l]), dtype=i32)
                      for l, n_l in enumerate(counts)]).to(device)
    Wk = torch.cat([torch.full((n_l,), Wl, dtype=i32)
                    for (_, Wl), n_l in zip(level_shapes, counts)]).to(device)
    levels = torch.cat([torch.full((n_l,), l, dtype=i32)
                        for l, n_l in enumerate(counts)]).to(device)
    scales = torch.cat([torch.full((n_l,), orb.scale_factor**l, dtype=torch.float32)
                        for l, n_l in enumerate(counts)]).to(device)
    pts = torch.as_tensor(pattern_points(), device=device)
    px = pts[:, 0][None].to(torch.float32)
    py = pts[:, 1][None].to(torch.float32)
    tests = torch.as_tensor(pattern_tests(), dtype=torch.int64, device=device)
    bit_shift = torch.arange(8, dtype=torch.uint8, device=device)
    pad = M - total

    def cat(x):
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        return x

    def extract(image_u8) -> Features:
        img0 = torch.as_tensor(image_u8, device=device).to(torch.float32)
        xs_lvl, resps, valids = [], [], []
        blur_parts, m10_parts, m01_parts = [], [], []
        for l, n_l in enumerate(counts):
            img = img0 if l == 0 else resize[l][0] @ img0 @ resize[l][1].T
            xy, resp, valid = select_level_keypoints(
                fast_score(img), n_l, float(orb.min_th_fast), orb.cell_size)
            blur_parts.append(gaussian_blur7(img).reshape(-1))
            m10, m01 = orientation_maps(img)
            m10_parts.append(m10.reshape(-1))
            m01_parts.append(m01.reshape(-1))
            xs_lvl.append(xy)
            resps.append(resp)
            valids.append(valid)

        # one orientation gather and one descriptor gather across all levels
        blur_flat = torch.cat(blur_parts)
        xy_lvl = torch.cat(xs_lvl)  # [total, 2] int32 level coords
        anchor = (base + xy_lvl[:, 1] * Wk + xy_lvl[:, 0]).long()
        ang_all = torch.atan2(torch.cat(m01_parts)[anchor], torch.cat(m10_parts)[anchor])
        c = torch.cos(ang_all)[:, None]
        s = torch.sin(ang_all)[:, None]
        rx = torch.round(c * px - s * py).to(i32)
        ry = torch.round(s * px + c * py).to(i32)
        # keypoints are >= EDGE from every level border and the rotated
        # pattern stays within 19 px, so no clipping is needed
        idx = anchor[:, None] + (ry * Wk[:, None] + rx).long()
        v = blur_flat[idx]  # [N, P]
        bits = (v[:, tests[:, 0]] < v[:, tests[:, 1]]).to(torch.uint8)
        desc_all = (bits.reshape(-1, 32, 8) << bit_shift).sum(-1).to(torch.uint8)

        xy_raw = cat(xy_lvl.to(torch.float32) * scales[:, None])
        valid = cat(torch.cat(valids))
        xy_und = undistort_points(xy_raw, cam)
        return Features(
            xy=torch.where(valid[:, None], xy_und, torch.zeros_like(xy_und)),
            xy_raw=xy_raw,
            angle=cat(ang_all),
            response=cat(torch.cat(resps)),
            level=cat(levels),
            desc=cat(desc_all),
            valid=valid,
        )

    return extract
