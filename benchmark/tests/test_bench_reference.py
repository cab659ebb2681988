"""The benchmark's plain reference against the port, at small sizes on the
CPU, and its control and arithmetic on cases with known answers.

    python -m pytest -q benchmark/tests
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark import peaks, scene  # noqa: E402
from benchmark.reference import ate as ref_ate  # noqa: E402
from benchmark.reference import hamming as ref_ham  # noqa: E402
from benchmark.reference import orb as ref_orb  # noqa: E402
from benchmark.reference import pose as ref_pose  # noqa: E402
from benchmark.reference.precision import EXACT, TF32, round_tf32  # noqa: E402

CAM = scene.Camera(width=320, height=240, fx=260.45, fy=260.5, cx=162.57, cy=124.85, fps=30.0)
MIX = {"motion": "strafe", "n_points": 1400, "layout": 1,
       "metres_per_unit": 1.0, "path_frames": 440, "init_frames": 8}


def _frames(seed=3, frames=4):
    return scene.streams(MIX, CAM, seed, 0, frames=frames)[0]


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 255.3, -7.77e-3])
    r = round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2 ** -10
    assert r[2] == 1.0  # a tie goes to the even mantissa
    assert r[3] == 1.0 + 2 ** -9
    m, _ = np.frexp(r.numpy().astype(np.float64))
    assert np.all(np.abs(m * 2 ** 11 - np.round(m * 2 ** 11)) == 0)
    assert torch.all((r - x).abs() <= x.abs() * 2 ** -11)


def test_streams_repeat_and_render_in_any_order():
    a = scene.streams(MIX, CAM, 2 ** 31 + 5, 0, frames=3)[0]
    b = scene.streams(MIX, CAM, 2 ** 31 + 5, 0, frames=3)[0]
    c = scene.streams(MIX, CAM, 6, 0, frames=3)[0]
    assert np.array_equal(a.images, b.images) and np.array_equal(a.poses_cw, b.poses_cw)
    assert not np.array_equal(a.images, c.images)
    assert np.array_equal(a.poses_cw, c.poses_cw)  # the seed moves the scene, not the path


def test_set_up_renders_every_frame_the_window_can_take():
    a = scene.streams(MIX, CAM, 9, 2)[0]
    assert len(a.images) == 8 + 2 * 30 == len(a.timestamps) == len(a.poses_cw)
    head = scene.streams(MIX, CAM, 9, 2, frames=5)[0]
    for f in ("images", "timestamps", "poses_cw"):
        assert np.array_equal(getattr(a, f)[:5], getattr(head, f)), f


def test_the_painter_keeps_the_last_write_of_the_port_s_renderer():
    """Noise aside, the torch painter writes what ``io/synthetic.py``'s
    loops write: each offset over all sprites, far to near, the last write
    winning; depth likewise."""
    cam = scene.Camera(**{**CAM.__dict__, "depth_map_factor": 5208.0})
    pl = scene.plan(MIX, cam.fps, 2)
    pts, bright, stamps = scene.scene(1, 3, 1400, pl.path_scale)
    T = scene.path_pose("strafe", 20, pl.n_frames, pl.path_scale)
    painter = scene._Painter(pts, bright, stamps, cam, "cpu")
    gen = torch.Generator()
    img = painter.image(T, gen.manual_seed(0)).numpy().astype(np.int32)
    noise = torch.randn((cam.height, cam.width), generator=gen.manual_seed(0)).numpy()
    ref = np.full((cam.height, cam.width), scene.BACKGROUND, np.float32)
    dep = np.zeros((cam.height, cam.width), np.float64)
    pc = pts @ T[:3, :3].T + T[:3, 3]
    z = pc[:, 2]
    u = cam.fx * pc[:, 0] / z + cam.cx
    v = cam.fy * pc[:, 1] / z + cam.cy
    b = scene.BLOB
    vis = (z > 0.3) & (u >= b + 2) & (u < cam.width - b - 2) & (v >= b + 2) & (v < cam.height - b - 2)
    order = np.nonzero(vis)[0][np.argsort(-z[vis], kind="stable")]
    for dv in range(2 * b + 2):
        for du in range(2 * b + 2):
            for k in order:
                ui, vi = int(np.floor(u[k])), int(np.floor(v[k]))
                fu, fv = u[k] - ui, v[k] - vi
                pad = np.zeros((2 * b + 2, 2 * b + 2))
                pad[:2 * b + 1, :2 * b + 1] = stamps[k]
                sx = (1 - fu) * pad + fu * np.roll(pad, 1, axis=1)
                sub = (1 - fv) * sx + fv * np.roll(sx, 1, axis=0)
                amp = bright[k] * np.clip(6.0 / max(z[k], 1.0), 0.4, 1.0)
                ref[vi + dv - b, ui + du - b] = max(amp * sub[dv, du], scene.BACKGROUND)
                dep[vi + dv - b, ui + du - b] = z[k]
    ref = np.clip(ref + scene.NOISE * noise, 0, 255).astype(np.int32)
    assert np.abs(img - ref).max() <= 1 and (img != ref).mean() < 1e-3
    raw = painter.depth(T, 5208.0).numpy()
    want = np.round(dep * 5208.0)
    assert np.array_equal(raw, np.where(want > 65535, 0, want))


def test_depth_is_uint16_with_no_return_past_range():
    cam = scene.Camera(**{**CAM.__dict__, "depth_map_factor": 5208.0})
    s = scene.streams(MIX, cam, 4, 0, frames=1)[0]
    d = s.depths[0]
    assert d.dtype == np.uint16 and d.max() <= 65535 and (d == 0).any()
    z = d[d > 0] / 5208.0
    assert z.min() > 3.0 and z.max() <= 65535 / 5208.0


def _port_features(img, n_features=400, levels=4):
    from orbslamm_tpu_torch.ops import orb
    from orbslamm_tpu_torch.utils.config import CameraConfig, OrbConfig

    cam = CameraConfig(width=CAM.width, height=CAM.height, fx=CAM.fx, fy=CAM.fy, cx=CAM.cx,
                       cy=CAM.cy)
    f = orb.make_extractor(OrbConfig(n_features=n_features, n_levels=levels,
                                     max_keypoints=1024), cam, device="cpu")(img)
    v = f.valid
    return f.xy[v], f.level[v], f.angle[v], f.desc[v]


def test_orb_reference_agrees_with_the_port():
    s = _frames()
    img = s.images[1]
    xy, level, angle, desc = _port_features(img)
    kw = dict(n_levels=4, scale=1.2, device="cpu")
    diff, sure, picked = ref_orb.keypoint_diff(img, xy.numpy(), level.numpy(), n_features=400,
                                               min_th=7.0, cell=16, prec=EXACT, **kw)
    assert diff == 0 and picked == len(xy) and sure >= 0.95 * len(xy)
    ref = ref_orb.describe(img, xy.numpy(), level.numpy(), angle.numpy(), prec=EXACT, **kw)
    assert float(ref_orb.angle_gap(angle, ref.angle).abs().max()) < 1e-3
    e = ref_orb.bit_errors(desc, ref.desc)
    assert int(e.sum()) <= 2  # near-equal pairs may fall either way
    # the control reads higher on the angle than the port does
    ctl = ref_orb.describe(img, xy.numpy(), level.numpy(), None, prec=TF32, **kw)
    assert float(ref_orb.angle_gap(ctl.angle, ref.angle).abs().max()) > \
        float(ref_orb.angle_gap(angle, ref.angle).abs().max())


def test_orb_reference_sees_a_moved_keypoint_and_a_changed_descriptor(monkeypatch):
    from orbslamm_tpu_torch.ops import orb

    s = _frames()
    img = s.images[2]
    xy, level, angle, desc = _port_features(img)
    kw = dict(n_levels=4, scale=1.2, device="cpu")
    sel = dict(n_features=400, min_th=7.0, cell=16, prec=EXACT, **kw)
    moved = xy.clone()
    moved[:5, 0] += 3.0 * 1.2 ** level[:5].double().float()
    assert ref_orb.keypoint_diff(img, moved.numpy(), level.numpy(), **sel)[0] >= 5
    lost = (level != 2).numpy()  # a pyramid level lost
    assert ref_orb.keypoint_diff(img, xy.numpy()[lost], level.numpy()[lost], **sel)[0] \
        >= 0.9 * int((level == 2).sum())  # near-ties of a resized level are left out
    with monkeypatch.context() as m:  # no suppression of a corner's neighbours
        m.setattr(orb, "_nms3", lambda score: torch.ones_like(score, dtype=torch.bool))
        xy2, level2, _, _ = _port_features(img)
    assert ref_orb.keypoint_diff(img, xy2.numpy(), level2.numpy(), **sel)[0] > 0.1 * len(xy)
    ref = ref_orb.describe(img, xy.numpy(), level.numpy(), angle.numpy(), prec=EXACT, **kw)
    bad = desc.clone()
    bad[0] = ~bad[0]
    assert int(ref_orb.bit_errors(bad, ref.desc).max()) >= 250


@pytest.mark.parametrize("mode", ["none", "window", "epipolar"])
def test_match_tables_reference_agrees_with_the_port(mode):
    from orbslamm_tpu_torch.ops.cuda import hamming

    g = torch.Generator().manual_seed(11)
    N, M = 300, 517
    base = torch.randint(0, 256, (40, 32), dtype=torch.uint8, generator=g)
    a = dict(desc_a=base[torch.randint(0, 40, (N,), generator=g)].clone(),
             desc_b=torch.randint(0, 256, (M, 32), dtype=torch.uint8, generator=g),
             valid_a=torch.rand(N, generator=g) > 0.1, valid_b=torch.rand(M, generator=g) > 0.1,
             xy_a=None, xy_b=None, radius_b=None, lines_a=None, epi_thr_b=None,
             level_a=torch.randint(0, 4, (N,), dtype=torch.int32, generator=g),
             level_b=torch.randint(0, 4, (M,), dtype=torch.int32, generator=g),
             lvl_lo=-1.0, lvl_hi=1.0, use_window=mode == "window", use_epipolar=mode == "epipolar")
    a["desc_b"][:40] = base  # exact duplicates: ties
    if mode != "none":
        a["xy_b"] = torch.rand(M, 2, generator=g) * 300
    if mode == "window":
        a["xy_a"] = torch.rand(N, 2, generator=g) * 300
        a["radius_b"] = torch.full((M,), 60.0)
    if mode == "epipolar":
        ln = torch.randn(N, 3, generator=g)
        ln[:, 2] = -(ln[:, 0] * 150 + ln[:, 1] * 150)
        a["lines_a"] = ln
        a["epi_thr_b"] = torch.full((M,), 3.84 * 400.0)
    out = hamming.match_tables(**a)
    strict, loose = ref_ham.tables(a, block=128)
    diff, judged, _ = ref_ham.compare(ref_ham.Tables(*out), strict, loose)
    assert judged > N and diff == 0
    # one altered answer is seen
    bad = ref_ham.Tables(*out)
    k = int(torch.nonzero(bad.row_best < 256)[0])
    bad.row_best[k] += 1
    assert ref_ham.compare(bad, strict, loose)[0] >= 1


def _pose_problem(seed=0, n=300):
    g = np.random.default_rng(seed)
    X = np.c_[g.uniform(-4, 4, n), g.uniform(-3, 3, n), g.uniform(4, 14, n)].astype(np.float32)
    ang = 0.05
    R = np.array([[math.cos(ang), 0, math.sin(ang)], [0, 1, 0], [-math.sin(ang), 0, math.cos(ang)]])
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = [0.2, -0.1, 0.3]
    K = np.array([[520.9, 0, 325.1], [0, 521.0, 249.7], [0, 0, 1]], np.float32)
    pc = X @ T[:3, :3].T + T[:3, 3]
    uv = (pc[:, :2] / pc[:, 2:]) * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
    uv = uv + g.normal(0, 1.0, uv.shape)
    uv[:20] += 40.0  # outliers
    level = g.integers(0, 4, n)
    T0 = T.copy()
    T0[:3, 3] += [0.05, 0.02, -0.04]
    return dict(T_init=torch.tensor(T0), K=torch.tensor(K), pts_w=torch.tensor(X),
                uv_obs=torch.tensor(uv, dtype=torch.float32),
                valid=torch.tensor(g.random(n) > 0.05),
                sigma2=torch.tensor((1.2 * 1.2 ** level) ** 2, dtype=torch.float32))


def test_pose_reference_agrees_with_the_port():
    from orbslamm_tpu_torch.ops import ba

    a = _pose_problem()
    out = ba.pose_optimize(**a)
    T, m = ref_pose.pose_optimize(**a, prec=EXACT)
    uv_p, _ = ref_pose.project(out.T_cw[None], a["K"], a["pts_w"])
    uv_r, _ = ref_pose.project(T, a["K"], a["pts_w"])
    assert float((uv_p - uv_r).norm(dim=-1).max()) < 0.01
    assert int((out.inliers != m[0]).sum()) == 0
    # batched starts, as the motion model calls it
    a2 = dict(a, T_init=torch.stack([a["T_init"], a["T_init"]]))
    T2, _ = ref_pose.pose_optimize(**a2, prec=EXACT)
    assert torch.allclose(T2[0], T2[1]) and torch.allclose(T2[0], T[0])
    # the control reads wider than the port
    Tc, _ = ref_pose.pose_optimize(**a, prec=TF32)
    uv_c, _ = ref_pose.project(Tc, a["K"], a["pts_w"])
    assert float((uv_c - uv_r).norm(dim=-1).max()) > float((uv_p - uv_r).norm(dim=-1).max())


def test_pose_reference_stereo_rows_agree_with_the_port():
    from orbslamm_tpu_torch.ops import ba

    a = _pose_problem(seed=1)
    z = (a["pts_w"] @ a["T_init"][:3, :3].T + a["T_init"][:3, 3])[:, 2]
    ur = a["uv_obs"][:, 0] - 40.0 / z
    ur[::3] = -1.0
    a.update(ur_obs=ur, bf=40.0)
    out = ba.pose_optimize(**a)
    T, m = ref_pose.pose_optimize(**a, prec=EXACT)
    uv_p, _ = ref_pose.project(out.T_cw[None], a["K"], a["pts_w"])
    uv_r, _ = ref_pose.project(T, a["K"], a["pts_w"])
    assert float((uv_p - uv_r).norm(dim=-1).max()) < 0.01


def test_ate_of_a_similar_copy_is_zero_and_of_a_frozen_camera_is_the_spread():
    g = np.random.default_rng(0)
    gt = g.normal(size=(50, 3))
    R = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]])
    est = 0.3 * gt @ R.T + [1, 2, 3]
    assert ref_ate.ate_sim3(est, gt) < 1e-9
    assert ref_ate.ate_sim3(np.zeros_like(gt), gt) == pytest.approx(ref_ate.frozen_spread(gt))


def test_matcher_least_time_is_operations_bound_at_the_main_shapes():
    t = peaks.matcher_least_s("window", 2048, 4096)
    assert t == pytest.approx(2 * 2048 * 4096 * 256 / 1.979e15)
    assert peaks.matcher_bytes("window", 2048, 4096) / peaks.HBM_BYTES_PER_S < t
