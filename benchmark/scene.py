"""The benchmark's traffic generator: rendered camera streams from a seed.

A frozen copy of the port's synthetic renderer (``io/synthetic.py``:
``make_landmark_field``, ``make_stamps``, ``render_view``, ``render_depth``
and the "strafe" and "forward" paths of ``make_sequence``), kept here so
that a change to the program cannot change the benchmark's input, and
written in torch so that set-up renders on the card. Its departures: the
seed draws the whole scene from one generator; each frame's pixel noise
comes from its own generator seeded with (seed, path frame, camera), so
frames render alike in any order; depth is stored as uint16 in ``depth_map_factor`` units, as TUM stores it,
a return past 65535 units reading 0 (no return), as a sensor out of range
does; a stereo rig's right camera sits ``baseline`` metres along the left
camera's x axis.

A traffic mix (``benchmark/workloads/<cell>.json``) gives the path
(``motion``), its sampling and the scene's size in metres
(``metres_per_unit``: the images do not depend on it; the depths, the
stereo baseline in scene units and the ground truth do);
``streams(mix, cam, seed, seconds)`` renders it. The stream holds
``init_frames + fps * seconds`` frames, the set-up's initialization
segment plus the most the camera can deliver in the window,
all rendered in set-up, so that the window renders nothing whatever the
port's speed. The path's per-frame motion is that of a
``path_frames``-frame path whatever the stream's length, so the keyframe
rate does not depend on it. The seed chooses the landmarks' looks and the
noise; the robot's name is fixed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BLOB = 5
BACKGROUND = 32.0
NOISE = 0.5
ROBOT = "robot0"  # a name seeds the tracker's generator: fixed


@dataclass(frozen=True)
class Camera:
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    fps: float
    depth_map_factor: float = 0.0  # 0: no depth stream
    baseline: float = 0.0  # metres; 0: no right camera


@dataclass
class Stream:
    """One robot's frames: images [F, H, W] uint8, right images or depths
    [F, H, W] (uint8, uint16) or None, timestamps [F] (path frame / fps),
    poses_cw [F, 4, 4] ground truth."""

    name: str
    images: np.ndarray
    images_right: np.ndarray | None
    depths: np.ndarray | None
    timestamps: np.ndarray
    poses_cw: np.ndarray


def _seed_words(seed: int) -> list[int]:
    s = int(seed) % (1 << 64)
    return [s & 0xFFFFFFFF, s >> 32]


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)


def scene(layout: int, seed: int, n_points: int, path_scale: float):
    """(points [P, 3] of the layout; brightness [P], stamps [P, 11, 11] of
    the seed)."""
    geo = np.random.default_rng([layout, 0])
    extent = 12.0 * max(1.0, 0.35 * path_scale)
    pts = np.empty((n_points, 3), np.float32)
    pts[:, 0] = geo.uniform(-extent, extent, n_points)
    pts[:, 1] = geo.uniform(-extent * 0.5, extent * 0.5, n_points)
    pts[:, 2] = geo.uniform(4.0, 14.0, n_points)
    levels = np.linspace(120, 255, n_points, dtype=np.float32)
    rng = np.random.default_rng(_seed_words(seed) + [0])
    brightness = levels[rng.permutation(n_points)]
    size = 2 * BLOB + 1
    stamps = rng.uniform(0.25, 1.0, (n_points, size, size)).astype(np.float32)
    stamps[:, BLOB, BLOB] = 1.0  # a bright centre: a reliable FAST response
    return pts, brightness, stamps


def path_pose(motion: str, p: int, n_path: int, path_scale: float) -> np.ndarray:
    """Camera-from-world pose of path frame ``p`` of an ``n_path``-frame
    path: "strafe" (sideways, a small rotation) or "forward" (along the
    optical axis, a slow weave)."""
    s = p / max(n_path - 1, 1)
    if motion == "strafe":
        C = path_scale * np.array([2.5 * s, 0.4 * np.sin(4 * s), 0.5 * s], np.float32)
        Rwc = _rot_y(0.15 * s) @ _rot_x(0.05 * np.sin(3 * s))
    elif motion == "forward":
        C = path_scale * np.array([0.3 * np.sin(2 * s), 0.0, 3.5 * s], np.float32)
        Rwc = _rot_y(0.25 * np.sin(2 * s))
    else:
        raise ValueError(f"unknown motion {motion!r}")
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = Rwc.T
    T[:3, 3] = -Rwc.T @ C
    return T


class _Painter:
    """Renders frames of one scene on ``device`` with torch: each sprite's
    footprint written in the order of the port's renderer (offset by
    offset, far sprites before near ones within each), the last write
    winning. The winner of a pixel is the largest write index that reaches
    it, so the result does not depend on the order the device runs in."""

    def __init__(self, pts, brightness, stamps, cam: Camera, device):
        import torch

        self.t, self.cam, self.dev = torch, cam, torch.device(device)
        self.pts = torch.as_tensor(pts, device=self.dev)
        self.bright = torch.as_tensor(brightness, device=self.dev)
        size = 2 * BLOB + 1
        pad = torch.zeros((len(pts), size + 1, size + 1), device=self.dev)
        pad[:, :size, :size] = torch.as_tensor(stamps, device=self.dev)
        self.pad = pad
        off = torch.arange(-BLOB, BLOB + 2, device=self.dev)
        self.drow, self.dcol = off[:, None, None], off[None, :, None]

    def _project(self, T):
        t = self.t
        T = t.as_tensor(T, device=self.dev)
        pc = (self.pts[:, None, :] * T[None, :3, :3]).sum(-1) + T[:3, 3]
        z = pc[:, 2]
        c = self.cam
        u = c.fx * pc[:, 0] / t.clamp_min(z, 1e-6) + c.cx
        v = c.fy * pc[:, 1] / t.clamp_min(z, 1e-6) + c.cy
        vis = (z > 0.3) & (u >= BLOB + 2) & (u < c.width - BLOB - 2) \
            & (v >= BLOB + 2) & (v < c.height - BLOB - 2)
        idx = t.nonzero(vis)[:, 0]
        idx = idx[t.sort(z[idx], descending=True, stable=True).indices]  # far to near
        return u[idx], v[idx], z[idx], idx

    def _paint(self, ui, vi, values, fill):
        """[H, W]: ``values`` [(2 BLOB + 2)^2, N] written offset-major."""
        t, c = self.t, self.cam
        pix = ((vi[None, None, :] + self.drow) * c.width + ui[None, None, :] + self.dcol).reshape(-1)
        order = t.arange(pix.numel(), device=self.dev)
        win = t.full((c.height * c.width,), -1, dtype=order.dtype, device=self.dev)
        win.scatter_reduce_(0, pix, order, reduce="amax")
        flat = values.reshape(-1)
        img = t.where(win >= 0, flat[win.clamp_min(0)], t.full_like(win, 0, dtype=flat.dtype)
                      + fill)
        return img.reshape(c.height, c.width)

    def image(self, T, gen):
        t = self.t
        u, v, z, idx = self._project(T)
        ui, vi = t.floor(u).long(), t.floor(v).long()
        fu = (u - ui).float()[:, None, None]
        fv = (v - vi).float()[:, None, None]
        pad = self.pad[idx]
        sh_x = (1 - fu) * pad + fu * t.roll(pad, 1, dims=2)
        sub = (1 - fv) * sh_x + fv * t.roll(sh_x, 1, dims=1)
        amp = self.bright[idx] * t.clamp(6.0 / t.clamp_min(z, 1.0), 0.4, 1.0)
        val = BACKGROUND + (amp * sub.permute(1, 2, 0) - BACKGROUND)
        img = self._paint(ui, vi, t.clamp_min(val, BACKGROUND), BACKGROUND)
        img = img + NOISE * t.randn(img.shape, generator=gen, device=self.dev)
        return t.clamp(img, 0, 255).to(t.uint8)

    def depth(self, T, factor: float):
        """Z-buffered depth over each sprite's footprint in raw units
        (``factor`` per scene unit; 0 = no return past 65535)."""
        t = self.t
        u, v, z, _ = self._project(T)
        n = (2 * BLOB + 2) ** 2
        d = self._paint(t.floor(u).long(), t.floor(v).long(), z[None, :].expand(n, -1), 0.0)
        raw = t.round(d.double() * factor)
        return t.where(raw > 65535, t.zeros_like(raw), raw).to(t.int32)


@dataclass(frozen=True)
class Plan:
    """Where the robot's frames lie on the path."""

    motion: str
    n_frames: int
    path_scale: float
    metres: float  # metres per scene unit


def plan(mix: dict, fps: float, seconds: int) -> Plan:
    n = int(mix["init_frames"]) + int(round(fps * int(seconds)))
    return Plan(motion=mix["motion"], n_frames=n, path_scale=n / float(mix["path_frames"]),
                metres=float(mix["metres_per_unit"]))


def _noise_seed(seed: int, p: int, camera: int) -> int:
    """A generator seed of (seed, path frame, camera): each frame's noise is
    its own, whatever order frames render in."""
    s0, s1 = _seed_words(seed)
    return int(np.random.SeedSequence([s0, s1, 1, p, camera]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def streams(mix: dict, cam: Camera, seed: int, seconds: int, device="cpu",
            frames: int | None = None) -> list[Stream]:
    """The robot's stream of ``mix`` for a window of ``seconds``: all of
    its frames (the first ``frames``, where given), rendered on ``device``
    and held on the host."""
    import torch

    pl = plan(mix, cam.fps, seconds)
    n = pl.n_frames if frames is None else min(frames, pl.n_frames)
    pts, bright, stamps = scene(int(mix["layout"]), seed, int(mix["n_points"]), pl.path_scale)
    painter = _Painter(pts, bright, stamps, cam, device)
    poses = [path_pose(pl.motion, p, pl.n_frames, pl.path_scale) for p in range(n)]
    images = np.empty((n, cam.height, cam.width), np.uint8)
    right = images.copy() if cam.baseline else None
    depths = np.empty((n, cam.height, cam.width), np.uint16) if cam.depth_map_factor \
        and not cam.baseline else None
    gen = torch.Generator(device=painter.dev)
    for p, T in enumerate(poses):
        images[p] = painter.image(T, gen.manual_seed(_noise_seed(seed, p, 0))).cpu().numpy()
        if right is not None:
            Tr = T.copy()
            Tr[0, 3] -= cam.baseline / pl.metres
            right[p] = painter.image(Tr, gen.manual_seed(_noise_seed(seed, p, 1))).cpu().numpy()
        if depths is not None:
            depths[p] = painter.depth(T, cam.depth_map_factor * pl.metres).cpu().numpy()
    poses_m = np.stack(poses)
    poses_m[:, :3, 3] *= pl.metres
    return [Stream(name=ROBOT, images=images, images_right=right, depths=depths,
                   timestamps=np.arange(n, dtype=np.float64) / cam.fps, poses_cw=poses_m)]
