"""Headless map and frame renderings (port of orbslamm_tpu/io/viz.py; the
reference's Viewer/MapDrawer/FrameDrawer, SURVEY.md §2.1), written as PNG
files instead of drawn in a GL window.

What is drawn is kept apart from how: ``map_arrays`` returns the arrays a
map rendering shows (landmarks and camera centres in the top-down x-z
plane, covisibility edges), and ``draw_map`` / ``draw_frame`` paint them
with PIL's ``ImageDraw``. PIL, not matplotlib, because the GPU machine has
PIL and no matplotlib; a missing PIL raises, it never skips a picture.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np

from orbslamm_tpu_torch.models import map_state as ms

# covisibility edges drawn between keyframes sharing at least this many
# landmarks (the JAX package's threshold)
COVIS_MIN = 30
MAP_SIZE = (880, 880)  # the JAX package's 8 x 8 in figure at 110 dpi
_MARGIN = 48
_GREY, _EDGE, _KF, _TRAJ = (119, 119, 119), (136, 187, 136), (0, 0, 255), (255, 0, 0)
_TRACKED, _FREE = (51, 221, 51), (68, 136, 255)


class MapArrays(NamedTuple):
    landmarks_xz: np.ndarray  # [N, 2] x and z of every valid landmark
    centers: np.ndarray  # [K', 3] valid keyframes' camera centres, slot order
    edges: np.ndarray  # [E, 2] int: index pairs into ``centers``, a < b
    trajectory: np.ndarray  # [T, 3] camera centres of the frame trajectory
    n_kf: int
    n_lm: int


def _centers(poses: np.ndarray) -> np.ndarray:
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    return -np.einsum("nji,nj->ni", R, t)


def map_arrays(m: ms.MapState, trajectory: np.ndarray | None = None,
               show_covisibility: bool = True) -> MapArrays:
    """The arrays ``draw_map`` draws; each map field is read once."""
    kv = m.kf_valid.cpu().numpy()
    lv = m.lm_valid.cpu().numpy()
    pts = m.lm_pos.cpu().numpy()[lv]
    poses = m.kf_pose.cpu().numpy()[kv]
    C = _centers(poses) if len(poses) else np.zeros((0, 3), np.float32)
    edges = np.zeros((0, 2), np.int64)
    if show_covisibility and kv.sum() > 1:
        idx = np.nonzero(kv)[0]
        W = ms.covisibility(m).cpu().numpy()[np.ix_(idx, idx)]
        a, b = np.nonzero(np.triu(W >= COVIS_MIN, k=1))
        edges = np.stack([a, b], axis=1)
    traj = (np.zeros((0, 3), np.float32) if trajectory is None or not len(trajectory)
            else _centers(np.asarray(trajectory)))
    return MapArrays(landmarks_xz=pts[:, [0, 2]], centers=C, edges=edges, trajectory=traj,
                     n_kf=int(kv.sum()), n_lm=int(lv.sum()))


def _pil():
    from PIL import Image, ImageDraw  # raises where PIL is missing

    return Image, ImageDraw


def _plot_transform(xz: np.ndarray, size):
    """Equal-aspect map from the points' x-z box onto the canvas (z up)."""
    w, h = size
    if len(xz):
        lo, hi = xz.min(0), xz.max(0)
    else:
        lo, hi = np.array([-1.0, -1.0]), np.array([1.0, 1.0])
    mid, span = (lo + hi) / 2, np.maximum(hi - lo, 1e-6) * 1.05
    scale = min((w - 2 * _MARGIN) / span[0], (h - 2 * _MARGIN) / span[1])

    def to_px(p: np.ndarray) -> np.ndarray:
        p = np.asarray(p, np.float64).reshape(-1, 2)
        return np.stack([w / 2 + (p[:, 0] - mid[0]) * scale,
                         h / 2 - (p[:, 1] - mid[1]) * scale], axis=1)

    return to_px


def draw_map(m: ms.MapState, path: str | Path, trajectory: np.ndarray | None = None,
             title: str = "orbslamm_tpu map", show_covisibility: bool = True) -> None:
    """Top-down (x-z) map rendering: landmarks in grey, covisibility edges
    in green, keyframe centres joined in slot order in blue, the frame
    trajectory in red, and a title with the keyframe and landmark counts."""
    Image, ImageDraw = _pil()
    a = map_arrays(m, trajectory, show_covisibility)
    kf_xz, tr_xz = a.centers[:, [0, 2]], a.trajectory[:, [0, 2]]
    to_px = _plot_transform(np.concatenate([a.landmarks_xz, kf_xz, tr_xz]), MAP_SIZE)
    img = Image.new("RGB", MAP_SIZE, "white")
    d = ImageDraw.Draw(img)
    w, h = MAP_SIZE
    d.rectangle([_MARGIN // 2, _MARGIN // 2, w - _MARGIN // 2, h - _MARGIN // 2],
                outline=(0, 0, 0))
    d.point([tuple(p) for p in to_px(a.landmarks_xz)], fill=_GREY)
    kf_px = to_px(kf_xz)
    for i, j in a.edges:
        d.line([tuple(kf_px[i]), tuple(kf_px[j])], fill=_EDGE, width=1)
    if len(kf_px) > 1:
        d.line([tuple(p) for p in kf_px], fill=_KF, width=1)
    for x, y in kf_px:
        d.ellipse([x - 2, y - 2, x + 2, y + 2], fill=_KF)
    if len(tr_xz) > 1:
        d.line([tuple(p) for p in to_px(tr_xz)], fill=_TRAJ, width=1)
    d.text((_MARGIN // 2, 6), f"{title} - {a.n_kf} KFs, {a.n_lm} landmarks", fill=(0, 0, 0))
    d.text((w // 2, h - _MARGIN // 2 + 6), "x", fill=(0, 0, 0))
    d.text((6, h // 2), "z", fill=(0, 0, 0))
    for k, (name, color) in enumerate((("landmarks", _GREY), ("keyframes", _KF),
                                       ("frames", _TRAJ))):
        y = _MARGIN // 2 + 8 + 14 * k
        d.line([(w - 150, y + 5), (w - 130, y + 5)], fill=color, width=2)
        d.text((w - 124, y), name, fill=(0, 0, 0))
    img.save(path, format="PNG")


def draw_frame(image: np.ndarray, feats, feat_lm, path: str | Path, status: str = "") -> None:
    """The frame with its keypoints (green: tracked to a landmark, blue:
    free) under a status bar, the FrameDrawer::DrawFrame analog.
    ``feats`` is a ``Features`` (tensors or arrays), ``feat_lm`` the
    per-keypoint landmark ids or None."""
    Image, ImageDraw = _pil()

    def host(x):
        return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)

    valid = host(feats.valid)
    xy = host(feats.xy_raw)[valid]
    tracked = (host(feat_lm)[valid] >= 0) if feat_lm is not None else np.zeros(len(xy), bool)
    gray = np.clip(host(image).astype(np.float64), 0, 255).astype(np.uint8)
    h, w = gray.shape[:2]
    bar = 20
    img = Image.new("RGB", (w, h + bar), "black")
    img.paste(Image.fromarray(gray).convert("RGB"), (0, bar))
    d = ImageDraw.Draw(img)
    for (x, y), t in zip(xy, tracked):
        d.ellipse([x - 3, y + bar - 3, x + 3, y + bar + 3],
                  outline=_TRACKED if t else _FREE)
    d.text((4, 4), status or f"{int(valid.sum())} keypoints, {int(tracked.sum())} tracked",
           fill=(255, 255, 255))
    img.save(path, format="PNG")
