"""Synthetic scenes and sequences for tests and benchmarks (the port's copy
of ``orbslamm_tpu/io/synthetic.py``; ``fabricate_map`` builds the port's
tensor ``MapState``).

The reference verifies itself by running dataset sequences end-to-end
(SURVEY.md §4); the datasets are not shipped with this build environment, so
the test pyramid is grounded on synthetic sequences with exact ground truth:
a random 3D landmark field rendered as intensity blobs ("point-sprite"
rendering), full 6-DoF trajectories, and a kidnap generator that teleports
the camera to exercise the multi-map path (the fr2_360_kidnap analog).

Host-side numpy; this feeds images into the pipeline the same way a
dataset loader would. The sequences are array for array those of the JAX
package for the same arguments (``tests/test_torch_package.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from orbslamm_tpu_torch.utils.config import CameraConfig


@dataclasses.dataclass
class SyntheticSequence:
    images: np.ndarray  # [T, H, W] uint8
    poses_cw: np.ndarray  # [T, 4, 4] float32 camera-from-world (ground truth)
    timestamps: np.ndarray  # [T] float64
    points_w: np.ndarray  # [P, 3] landmark field
    K: np.ndarray  # [3, 3]
    images_right: np.ndarray | None = None  # [T, H, W] uint8 (stereo)
    depths: np.ndarray | None = None  # [T, H, W] float32 meters, 0=invalid


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)


def make_landmark_field(
    n_points: int = 4000,
    extent: float = 12.0,
    depth_range: tuple[float, float] = (4.0, 14.0),
    seed: int = 0,
) -> np.ndarray:
    """Random 3D landmark cloud in front of the origin, non-planar."""
    rng = np.random.default_rng(seed)
    pts = np.empty((n_points, 3), np.float32)
    pts[:, 0] = rng.uniform(-extent, extent, n_points)
    pts[:, 1] = rng.uniform(-extent * 0.5, extent * 0.5, n_points)
    pts[:, 2] = rng.uniform(depth_range[0], depth_range[1], n_points)
    return pts


def make_stamps(
    n_points: int, blob: int = 5, seed: int = 77, pool: int | None = None
) -> np.ndarray:
    """Per-landmark distinctive texture stamps [P, 2b+1, 2b+1] in [0, 1].

    Each landmark gets its own asymmetric random pattern so that (a) its ORB
    descriptor is distinctive (the ratio test works like on real imagery) and
    (b) the intensity-centroid orientation is stable across views — a plain
    radially-symmetric blob has neither property.

    ``pool``: draw every landmark's stamp from only ``pool`` unique textures
    — PERCEPTUAL ALIASING (repeated similar structures, the KITTI-00 facade
    problem) for loop-closure precision tests.
    """
    rng = np.random.default_rng(seed)
    size = 2 * blob + 1
    n_unique = n_points if pool is None else min(pool, n_points)
    stamps = rng.uniform(0.25, 1.0, (n_unique, size, size)).astype(np.float32)
    stamps[:, blob, blob] = 1.0  # bright center → reliable FAST response
    if pool is not None:
        stamps = stamps[rng.integers(0, n_unique, n_points)]
    return stamps


def render_view(
    points_w: np.ndarray,
    T_cw: np.ndarray,
    cam: CameraConfig,
    point_brightness: np.ndarray,
    stamps: np.ndarray | None = None,
    blob: int = 5,
    background: float = 32.0,
    noise: float = 0.5,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Point-sprite render: project landmarks, stamp per-landmark textures.

    Stamps are billboard sprites pinned to integer pixels, so a landmark's
    local appearance (and therefore its ORB descriptor) is consistent across
    views — which is what makes synthetic tracking meaningful.
    """
    H, W = cam.height, cam.width
    if stamps is None:
        stamps = make_stamps(len(points_w), blob)
    img = np.full((H, W), background, np.float32)
    R, t = T_cw[:3, :3], T_cw[:3, 3]
    pc = points_w @ R.T + t
    z = pc[:, 2]
    vis = z > 0.3
    u = cam.fx * pc[:, 0] / np.maximum(z, 1e-6) + cam.cx
    v = cam.fy * pc[:, 1] / np.maximum(z, 1e-6) + cam.cy
    vis &= (u >= blob + 2) & (u < W - blob - 2) & (v >= blob + 2) & (v < H - blob - 2)
    ui = np.floor(u[vis]).astype(np.int32)
    vi = np.floor(v[vis]).astype(np.int32)
    fu = (u[vis] - ui).astype(np.float32)[:, None, None]
    fv = (v[vis] - vi).astype(np.float32)[:, None, None]
    bright = point_brightness[vis]
    stv = stamps[vis]
    # far points slightly dimmer for scale realism
    atten = np.clip(6.0 / np.maximum(z[vis], 1.0), 0.4, 1.0)
    order = np.argsort(z[vis])[::-1]  # paint near points last
    ui, vi, bright, atten = ui[order], vi[order], bright[order], atten[order]
    stv, fu, fv = stv[order], fu[order], fv[order]
    # subpixel splat: bilinear shift of the stamp into a (2b+2)^2 footprint.
    # Integer pinning would add ±0.5px per-frame jitter to every feature —
    # twice the localization noise real imagery has.
    size = 2 * blob + 1
    pad = np.zeros((len(stv), size + 1, size + 1), np.float32)
    pad[:, :size, :size] = stv
    sh_x = (1 - fu) * pad + fu * np.roll(pad, 1, axis=2)
    sub = (1 - fv) * sh_x + fv * np.roll(sh_x, 1, axis=1)
    amp = bright * atten
    for dv in range(size + 1):
        for du in range(size + 1):
            val = background + (amp * sub[:, dv, du] - background)
            img[vi + dv - blob, ui + du - blob] = np.maximum(val, background)
    if noise > 0:
        rng = rng or np.random.default_rng(0)
        img = img + rng.normal(0.0, noise, img.shape).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def render_depth(
    points_w: np.ndarray,
    T_cw: np.ndarray,
    cam: CameraConfig,
    blob: int = 5,
) -> np.ndarray:
    """Ground-truth depth map [H, W] float32 (meters; 0 = no return).

    Z-buffer splat over each landmark's sprite footprint — the depth image a
    registered RGB-D sensor would produce for the point-sprite scene.
    """
    H, W = cam.height, cam.width
    depth = np.zeros((H, W), np.float32)
    R, t = T_cw[:3, :3], T_cw[:3, 3]
    pc = points_w @ R.T + t
    z = pc[:, 2]
    vis = z > 0.3
    u = cam.fx * pc[:, 0] / np.maximum(z, 1e-6) + cam.cx
    v = cam.fy * pc[:, 1] / np.maximum(z, 1e-6) + cam.cy
    vis &= (u >= blob + 2) & (u < W - blob - 2) & (v >= blob + 2) & (v < H - blob - 2)
    ui = np.floor(u[vis]).astype(np.int32)
    vi = np.floor(v[vis]).astype(np.int32)
    zv = z[vis]
    order = np.argsort(zv)[::-1]  # far first, near overwrites
    ui, vi, zv = ui[order], vi[order], zv[order]
    for dv in range(-blob, blob + 2):
        for du in range(-blob, blob + 2):
            depth[vi + dv, ui + du] = zv
    return depth


def make_sequence(
    n_frames: int = 30,
    cam: CameraConfig | None = None,
    n_points: int = 4000,
    motion: str = "strafe",
    kidnap_at: int | None = None,
    return_at: int | None = None,
    seed: int = 0,
    stereo: bool = False,
    with_depth: bool = False,
    stamp_pool: int | None = None,
    path_scale: float = 1.0,
) -> SyntheticSequence:
    """Generate a rendered sequence with ground-truth poses.

    motion:
      * "strafe"  — sideways translation with small rotation (good parallax,
                    the TUM fr1_xyz analog)
      * "forward" — dominant forward motion (KITTI analog)
      * "orbit"   — yaw around the field
    kidnap_at — teleport the camera far away at this frame (tracking loss →
                new-map path).
    return_at — teleport BACK and re-traverse the original path from its
                start (the fr2_360_kidnap scenario: the second map's
                keyframes revisit the first map's region → cross-map merge).
    path_scale — stretch the trajectory (and the landmark field with it):
                the default paths are a few meters, so LONG sequences
                (KITTI-00-class frame counts) would otherwise squeeze
                per-frame motion toward zero; scaling keeps real motion per
                frame while the trajectory grows.
    """
    cam = cam or CameraConfig()
    rng = np.random.default_rng(seed)
    extent = 12.0 * max(1.0, 0.35 * path_scale)
    pts = make_landmark_field(n_points, extent=extent,
                              depth_range=(4.0, 14.0), seed=seed)
    if kidnap_at is not None:
        # second landmark field at the teleport destination so the camera
        # still sees structure there (a brand-new map gets built on it)
        pts_b = make_landmark_field(n_points, seed=seed + 1)
        pts_b[:, 0] += 40.0
        pts_b[:, 2] += 2.0
        pts = np.concatenate([pts, pts_b], axis=0)
    brightness = rng.uniform(120, 255, len(pts)).astype(np.float32)
    stamps = make_stamps(len(pts), seed=seed + 100, pool=stamp_pool)

    poses = np.zeros((n_frames, 4, 4), np.float32)
    images = np.zeros((n_frames, cam.height, cam.width), np.uint8)
    timestamps = np.arange(n_frames, dtype=np.float64) / max(cam.fps, 1.0)
    images_right = (
        np.zeros((n_frames, cam.height, cam.width), np.uint8) if stereo else None
    )
    depths = (
        np.zeros((n_frames, cam.height, cam.width), np.float32)
        if with_depth
        else None
    )
    baseline = cam.baseline if stereo else 0.0
    if stereo and baseline <= 0:
        raise ValueError("stereo sequence needs cam.bf > 0")

    for i in range(n_frames):
        if return_at is not None and i >= return_at:
            s = (i - return_at) / max(n_frames - 1, 1)
        else:
            s = i / max(n_frames - 1, 1)
        if motion == "strafe":
            C = path_scale * np.array(
                [2.5 * s, 0.4 * np.sin(4 * s), 0.5 * s], np.float32
            )
            Rwc = _rot_y(0.15 * s) @ _rot_x(0.05 * np.sin(3 * s))
        elif motion == "forward":
            C = path_scale * np.array(
                [0.3 * np.sin(2 * s), 0.0, 3.5 * s], np.float32
            )
            Rwc = _rot_y(0.25 * np.sin(2 * s))
        elif motion == "orbit":
            ang = 0.8 * s
            C = np.array([9.0 * np.sin(ang), 0.0, 9.0 - 9.0 * np.cos(ang)], np.float32)
            Rwc = _rot_y(ang)
        elif motion == "outback":
            # out along the strafe path and back to the start — a loop-
            # closure trajectory: the return leg revisits earlier viewpoints
            sb = 1.0 - abs(2.0 * s - 1.0)
            C = path_scale * np.array(
                [2.5 * sb, 0.4 * np.sin(4 * sb), 0.5 * sb], np.float32
            )
            Rwc = _rot_y(0.15 * sb) @ _rot_x(0.05 * np.sin(3 * sb))
        else:
            raise ValueError(motion)
        if kidnap_at is not None and i >= kidnap_at and (
            return_at is None or i < return_at
        ):
            C = C + np.array([40.0, 0.0, 2.0], np.float32)
        # camera-from-world: R = Rwc^T, t = -R C
        R = Rwc.T
        t = -R @ C
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = t
        poses[i] = T
        images[i] = render_view(pts, T, cam, brightness, stamps=stamps, rng=rng)
        if stereo:
            # right camera: same orientation, center shifted by +baseline
            # along camera x → t_r = t - R·(Rwc·[b,0,0]) = t + [-b, 0, 0]
            Tr = T.copy()
            Tr[0, 3] -= baseline
            images_right[i] = render_view(
                pts, Tr, cam, brightness, stamps=stamps, rng=rng
            )
        if with_depth:
            depths[i] = render_depth(pts, T, cam)

    return SyntheticSequence(
        images, poses, timestamps, pts, cam.K(),
        images_right=images_right, depths=depths,
    )


def fabricate_map(
    cfg,
    poses_cw: np.ndarray,  # [K,4,4]
    points_w: np.ndarray,  # [P,3]
    point_desc: np.ndarray,  # [P,32] uint8 per-landmark descriptors
    frame_ids: np.ndarray | None = None,
    desc_flip_bits: int = 4,
    pixel_noise: float = 0.5,
    seed: int = 0,
    share_landmarks: np.ndarray | None = None,  # [P] bool: only these get pool slots
    kf_point_mask: np.ndarray | None = None,  # [K,P] bool: per-KF observability
    point_ref_kf: np.ndarray | None = None,  # [P] int32 reference keyframe ids
    *,
    device,
):
    """Build a consistent MapState directly from ground truth — keyframes at
    the given poses observing the landmark field through ideal projection
    (plus noise), with per-landmark descriptors re-observed with a few random
    bit flips. Used to unit-test loop closing / merging machinery without
    running a full tracking session. The random draws are those of the JAX
    package's ``fabricate_map``; the map's tensors live on ``device``.
    Returns (MapState, lm_slot_of_point [P] int64 — -1 where unused).
    """
    import torch

    from orbslamm_tpu_torch.models import map_state as ms
    from orbslamm_tpu_torch.ops.orb import Features

    def t(x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    rng = np.random.default_rng(seed)
    m = ms.empty_map(cfg, device=device)
    Kmat = cfg.camera.K()
    H, W = cfg.camera.height, cfg.camera.width
    Mfeat = cfg.orb.max_keypoints
    P = len(points_w)
    use_pts = np.ones(P, bool) if share_landmarks is None else share_landmarks
    lm_slot = np.full(P, -1, np.int64)
    lm_slot[use_pts] = np.arange(use_pts.sum())

    # landmark pool
    centers = np.stack([-T[:3, :3].T @ T[:3, 3] for T in poses_cw])
    dirs = points_w[None, :, :] - centers[:, None, :]
    mean_dir = dirs.mean(0)
    mean_dir /= np.maximum(np.linalg.norm(mean_dir, axis=-1, keepdims=True), 1e-9)
    dists = np.linalg.norm(dirs, axis=-1).mean(0)
    sel = np.nonzero(use_pts)[0]
    refs = (
        np.zeros(len(sel), np.int32)
        if point_ref_kf is None
        else point_ref_kf[sel].astype(np.int32)
    )
    f32 = torch.float32
    m = ms.add_landmarks(
        m,
        t(lm_slot[sel], torch.int32),
        t(np.ones(len(sel), bool)),
        t(points_w[sel], f32),
        t(point_desc[sel]),
        t(mean_dir[sel], f32),
        t(dists[sel] * 0.2, f32),
        t(dists[sel] * 5.0, f32),
        t(refs),
    )

    for k, T in enumerate(poses_cw):
        pc = points_w @ T[:3, :3].T + T[:3, 3]
        uv = (pc[:, :2] / np.maximum(pc[:, 2:3], 1e-6)) * [Kmat[0, 0], Kmat[1, 1]] + [
            Kmat[0, 2], Kmat[1, 2]]
        vis = (pc[:, 2] > 0.3) & (uv[:, 0] > 25) & (uv[:, 0] < W - 25) & \
              (uv[:, 1] > 25) & (uv[:, 1] < H - 25) & use_pts
        if kf_point_mask is not None:
            vis &= kf_point_mask[k]
        cand = np.nonzero(vis)[0]
        rng.shuffle(cand)
        cand = cand[:Mfeat]
        n = len(cand)
        xy = np.zeros((Mfeat, 2), np.float32)
        desc = np.zeros((Mfeat, 32), np.uint8)
        valid = np.zeros(Mfeat, bool)
        obs = np.full(Mfeat, -1, np.int64)
        xy[:n] = uv[cand] + rng.normal(0, pixel_noise, (n, 2))
        bits = np.unpackbits(point_desc[cand], axis=1, bitorder="little")
        for i in range(n):
            fl = rng.choice(256, desc_flip_bits, replace=False)
            bits[i, fl] ^= 1
        desc[:n] = np.packbits(bits, axis=1, bitorder="little")
        valid[:n] = True
        obs[:n] = lm_slot[cand]
        feats = Features(
            xy=t(xy),
            xy_raw=t(xy),
            angle=torch.zeros(Mfeat, dtype=f32, device=device),
            response=t(np.where(valid, 50.0, 0.0), f32),
            level=torch.zeros(Mfeat, dtype=torch.int32, device=device),
            desc=t(desc),
            valid=t(valid),
        )
        fid = k if frame_ids is None else int(frame_ids[k])
        m = ms.insert_keyframe(
            m, k, t(T, f32), t(Kmat), feats, t(obs, torch.int32), fid, float(fid),
            fixed=(k == 0),
        )
    return m, lm_slot


def export_tum_sequence(seq: SyntheticSequence, out_dir, cam=None) -> "Path":
    """Write a SyntheticSequence to disk in the TUM RGB-D dataset layout
    (rgb/<stamp>.png + rgb.txt + groundtruth.txt + a reference-schema
    settings YAML) — exercises the REAL dataset path end to end:
    the JAX package's io/datasets.load_tum_sequence and examples/mono_tum.py
    read it (mono_tum.cc LoadImages).
    """
    from pathlib import Path

    from PIL import Image

    from orbslamm_tpu_torch.io.trajectory import save_tum

    out = Path(out_dir)
    (out / "rgb").mkdir(parents=True, exist_ok=True)
    lines = ["# color images", "# file: synthetic", "# timestamp filename"]
    for i, (ts, img) in enumerate(zip(seq.timestamps, seq.images)):
        name = f"rgb/{ts:.6f}.png"
        Image.fromarray(img).save(out / name)
        lines.append(f"{ts:.6f} {name}")
    (out / "rgb.txt").write_text("\n".join(lines) + "\n")
    save_tum(out / "groundtruth.txt", seq.timestamps, seq.poses_cw)
    K = seq.K
    settings = [
        "%YAML:1.0",
        f"Camera.fx: {K[0, 0]}",
        f"Camera.fy: {K[1, 1]}",
        f"Camera.cx: {K[0, 2]}",
        f"Camera.cy: {K[1, 2]}",
        "Camera.k1: 0.0", "Camera.k2: 0.0", "Camera.p1: 0.0",
        "Camera.p2: 0.0", "Camera.k3: 0.0",
        "Camera.fps: 30.0", "Camera.RGB: 1",
        "ORBextractor.nFeatures: 400",
        "ORBextractor.scaleFactor: 1.2",
        "ORBextractor.nLevels: 4",
        "ORBextractor.iniThFAST: 20",
        "ORBextractor.minThFAST: 7",
        # framework-extension keys: synthetic sprites pin to integer pixels
        "Tracking.pixelNoise: 1.2",
        "Tracking.initMinParallaxDeg: 0.4",
    ]
    (out / "settings.yaml").write_text("\n".join(settings) + "\n")
    return out
