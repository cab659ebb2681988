"""Stereo and RGB-D op parity: orbslamm_tpu_torch against the JAX package at
the JAX stereo test's size (320x240, 400 features, 4 levels, bf 130,
th_depth 60), on features the JAX extractor takes from a rendered frame.

Tolerances:
  * match_stereo: the ``u_right >= 0`` masks equal; u_right and depth within
    1e-5 relative;
  * the refinement and filter after match_stereo follow ORB-SLAM2, not the
    JAX package: tests/test_torch_stereo_orbslam2.py holds them to
    benchmark/reference/stereo.py;
  * depth_from_depthmap / with_depthmap: masks exact, values within 1e-5
    relative, with depth map factors 1 and 5208;
  * pose_optimize with mixed monocular and stereo rows: inlier masks equal,
    poses within 1e-4;
  * bundle_adjust_window and bundle_adjust_cg with stereo rows: inlier
    classification equal, cost within 1e-4 relative, poses within 1e-3;
  * create_depth_landmarks: slots, validity and observations exact, landmark
    positions within 1e-5, with close_only on and off;
  * global_bundle_adjust with bf > 0: cost within 1e-4 relative;
  * the extractor at a KITTI aspect (413x125, not a multiple of 32):
    keypoints exact on every level, responses and descriptors exact on
    level 0, descriptors on >= 98 % of the slots of each level above (a level image comes from a
    float resize whose last-ulp rounding differs between XLA and PyTorch,
    as tests/test_torch_orb.py states).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslamm_tpu.io.synthetic import fabricate_map, make_sequence
from orbslamm_tpu.models import local_mapping as jlm
from orbslamm_tpu.models import loop_closing as jlc
from orbslamm_tpu.models import map_state as jms
from orbslamm_tpu.ops import ba as jba
from orbslamm_tpu.ops import geometry as jg
from orbslamm_tpu.ops import orb as jo
from orbslamm_tpu.ops import stereo as jst
from orbslamm_tpu.utils.config import CameraConfig, CapacityConfig, OrbConfig, SlamConfig
from orbslamm_tpu_torch import convert
from orbslamm_tpu_torch.models import local_mapping as tlm
from orbslamm_tpu_torch.models import loop_closing as tlc
from orbslamm_tpu_torch.ops import ba as tba
from orbslamm_tpu_torch.ops import orb as to
from orbslamm_tpu_torch.ops import stereo as tst

torch.set_num_threads(2)

CAM = CameraConfig(width=320, height=240, fx=260, fy=260, cx=160, cy=120, fps=30,
                   bf=130.0, th_depth=60.0, depth_map_factor=1.0)
ORB = OrbConfig(n_features=400, max_keypoints=1024, n_levels=4)
CFG = SlamConfig(camera=CAM, orb=ORB,
                 capacity=CapacityConfig(max_keyframes=16, max_landmarks=2048))
K = CAM.K()


def _np(tree):
    return jax.tree.map(np.array, tree)


def _feats_t(f):
    return convert.features_from_numpy(_np(f)._asdict(), device="cpu")


@pytest.fixture(scope="module")
def frame():
    """One rendered stereo frame with its depth map, and the JAX
    extractor's left and right features."""
    seq = make_sequence(n_frames=1, n_points=900, cam=CAM, seed=3, motion="forward",
                        stereo=True, with_depth=True)
    extract = jo.make_extractor(ORB, CAM)
    imgL, imgR = seq.images[0], seq.images_right[0]
    return dict(imgL=imgL, imgR=imgR, depth=seq.depths[0], fL=extract(jnp.asarray(imgL)),
                fR=extract(jnp.asarray(imgR)))


def _close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


def test_match_stereo(frame):
    uj, dj = (np.asarray(a) for a in jst.match_stereo(
        frame["fL"], frame["fR"], bf=CAM.bf, scale_factor=ORB.scale_factor, min_z=CAM.baseline))
    ut, dt = (a.numpy() for a in tst.match_stereo(
        _feats_t(frame["fL"]), _feats_t(frame["fR"]), bf=CAM.bf,
        scale_factor=ORB.scale_factor, min_z=CAM.baseline))
    assert np.array_equal(ut >= 0, uj >= 0) and (uj >= 0).sum() >= 100
    _close(ut, uj, 1e-5)
    _close(dt, dj, 1e-5)


def test_match_stereo_runner_up_and_empty_rows():
    """An equal distance in another column is the runner-up (the ratio test
    rejects the row), and rows and columns without any candidate keep
    argmin 0, in both packages."""
    rng = np.random.default_rng(5)
    M = 48
    desc = rng.integers(0, 256, (M, 32), dtype=np.uint8)
    xy = np.stack([rng.uniform(60, 300, M), rng.uniform(10, 230, M)], -1).astype(np.float32)
    right = desc.copy()
    xy_r = xy - [12.0, 0.0]
    right[6] = desc[6] ^ np.array([255] + [0] * 31, np.uint8)  # distance 8
    right[7] = right[6]  # row 6 ties between columns 6 and 7
    xy_r[7] = xy_r[6] - [3.0, 0.0]
    valid = np.ones(M, bool)
    valid[40:] = False  # rows 40.. and columns 40.. have no candidate
    f = dict(xy=xy, xy_raw=xy, angle=np.zeros(M, np.float32), response=np.ones(M, np.float32),
             level=np.zeros(M, np.int32), desc=desc, valid=valid)
    fr = dict(f, xy=xy_r.astype(np.float32), xy_raw=xy_r.astype(np.float32), desc=right)
    jf = {k: jnp.asarray(v) for k, v in f.items()}
    jfr = {k: jnp.asarray(v) for k, v in fr.items()}
    uj, dj = (np.asarray(a) for a in jst.match_stereo(
        jo.Features(**jf), jo.Features(**jfr), bf=CAM.bf))
    ut, dt = (a.numpy() for a in tst.match_stereo(
        convert.features_from_numpy(f, device="cpu"),
        convert.features_from_numpy(fr, device="cpu"), bf=CAM.bf))
    assert np.array_equal(ut, uj)
    _close(dt, dj, 1e-5)
    assert uj[6] == -1 and (uj[:40] >= 0).sum() >= 35 and (uj[40:] == -1).all()


@pytest.mark.parametrize("factor", [1.0, 5208.0])
def test_depth_from_depthmap_and_with_depthmap(frame, factor):
    cam = dataclasses.replace(CAM, depth_map_factor=factor)
    raw = (frame["depth"] * factor).astype(np.float32)
    raw[5:9, :] = np.nan  # a band of invalid readings
    uj, dj = (np.asarray(a) for a in jst.depth_from_depthmap(frame["fL"], jnp.asarray(raw),
                                                             factor, cam.bf))
    ft = _feats_t(frame["fL"])
    ut, dt = (a.numpy() for a in tst.depth_from_depthmap(ft, torch.as_tensor(raw), factor,
                                                         cam.bf))
    assert np.array_equal(ut >= 0, uj >= 0) and np.array_equal(dt > 0, dj > 0)
    assert (dj > 0).sum() >= 150
    _close(ut, uj, 1e-5)
    _close(dt, dj, 1e-5)
    fj = jst.with_depthmap(frame["fL"], jnp.asarray(raw), cam)
    ft = tst.with_depthmap(ft, torch.as_tensor(raw), cam)
    _close(ft.u_right.numpy(), np.asarray(fj.u_right), 1e-5)
    _close(ft.depth.numpy(), np.asarray(fj.depth), 1e-5)


def _pose(xi):
    return np.array(jg.se3_exp(jnp.asarray(xi, jnp.float32)))


def _project(T, X):
    pc = X @ T[:3, :3].T + T[:3, 3]
    return (pc[:, :2] / pc[:, 2:3]) * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]], pc[:, 2]


def test_pose_optimize_stereo_rows():
    """Half the rows stereo, a few outliers in u, v and u_r; one start pose
    in the JAX package, and the port's single and batched starts."""
    rng = np.random.default_rng(0)
    n = 300
    X = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    X[:, 2] += 8.0
    T_true = _pose([0.1, -0.05, 0.2, 0.02, -0.01, 0.03])
    uv, z = _project(T_true, X)
    uv = (uv + rng.normal(0, 0.7, (n, 2))).astype(np.float32)
    ur = (uv[:, 0] - CAM.bf / z + rng.normal(0, 0.5, n)).astype(np.float32)
    ur[rng.random(n) > 0.5] = -1.0
    uv[:20] += rng.uniform(-40, 40, (20, 2)).astype(np.float32)
    ur[20:30] = np.where(ur[20:30] >= 0, ur[20:30] + 15.0, ur[20:30])  # right-x outliers
    valid = rng.random(n) > 0.05
    sigma2 = ((1.2 ** rng.integers(0, 4, n)) ** 2).astype(np.float32)
    T0 = np.stack([_pose([0.12, -0.02, 0.15, 0.03, 0.0, 0.02]), np.eye(4, dtype=np.float32)])
    for b in range(2):
        j = jba.pose_optimize(jnp.asarray(T0[b]), jnp.asarray(K), jnp.asarray(X),
                              jnp.asarray(uv), jnp.asarray(valid), sigma2=jnp.asarray(sigma2),
                              ur_obs=jnp.asarray(ur), bf=CAM.bf)
        t = tba.pose_optimize(torch.as_tensor(T0[b]), torch.as_tensor(K), torch.as_tensor(X),
                              torch.as_tensor(uv), torch.as_tensor(valid),
                              sigma2=torch.as_tensor(sigma2), ur_obs=torch.as_tensor(ur),
                              bf=CAM.bf)
        assert np.array_equal(t.inliers.numpy(), np.asarray(j.inliers))
        np.testing.assert_allclose(t.T_cw.numpy(), np.asarray(j.T_cw), rtol=0, atol=1e-4)
        both = tba.pose_optimize(torch.as_tensor(T0), torch.as_tensor(K), torch.as_tensor(X),
                                 torch.as_tensor(uv), torch.as_tensor(valid),
                                 sigma2=torch.as_tensor(sigma2), ur_obs=torch.as_tensor(ur),
                                 bf=CAM.bf)
        assert np.array_equal(both.inliers[b].numpy(), np.asarray(j.inliers))
        np.testing.assert_allclose(both.T_cw[b].numpy(), np.asarray(j.T_cw), rtol=0, atol=1e-4)
    # the right-x outliers are rejected, the stereo inliers kept
    inl = np.asarray(j.inliers)
    assert not inl[20:30][ur[20:30] >= 0].any() and inl[30:][ur[30:] >= 0].mean() > 0.9


def _stereo_window_problem(seed):
    """A 5-camera window (one fixed, one invalid), 40 % monocular edges."""
    rng = np.random.default_rng(seed)
    W, M, P = 5, 120, 160
    X = rng.uniform(-3, 3, (P, 3)).astype(np.float32)
    X[:, 2] += 9.0
    T_true = np.stack([_pose([0.3 * w, 0.02 * w, 0.1 * w, 0.0, 0.02 * w, 0.0])
                       for w in range(W)])
    obs_point = np.zeros((W, M), np.int32)
    obs_uv = np.zeros((W, M, 2), np.float32)
    obs_ur = np.full((W, M), -1.0, np.float32)
    obs_valid = rng.random((W, M)) > 0.1
    for w in range(W):
        pts = rng.permutation(P)[:M]
        obs_point[w] = pts
        uv, z = _project(T_true[w], X[pts])
        obs_uv[w] = uv + rng.normal(0, 0.6, (M, 2))
        obs_ur[w] = np.where(rng.random(M) > 0.4, obs_uv[w, :, 0] - CAM.bf / z
                             + rng.normal(0, 0.5, M), -1.0)
    obs_uv[1, :6] += 35.0  # a few outliers
    T_init = T_true.copy()
    for w in range(1, W):
        T_init[w] = _pose(rng.normal(0, 0.01, 6)) @ T_true[w]
    level = rng.integers(0, 3, (W, M))
    return dict(
        T_cw=T_init, K=np.broadcast_to(K, (W, 3, 3)).copy(),
        cam_valid=np.array([True, True, True, True, False]),
        cam_fixed=np.array([True, False, False, False, False]),
        points=X + rng.normal(0, 0.05, X.shape).astype(np.float32),
        point_valid=rng.random(P) > 0.05, obs_point=obs_point, obs_uv=obs_uv,
        obs_sigma2=((1.2 ** level) ** 2).astype(np.float32), obs_valid=obs_valid,
        obs_ur=obs_ur, bf=np.full(W, CAM.bf, np.float32))


@pytest.mark.parametrize("seed", [1, 2])
def test_bundle_adjust_window_stereo_rows(seed):
    p = _stereo_window_problem(seed)
    j = jba.bundle_adjust_window(**{k: jnp.asarray(v) for k, v in p.items()}, iters=8)
    t = tba.bundle_adjust_window(**{k: torch.as_tensor(v) for k, v in p.items()}, iters=8)
    assert np.array_equal(t.obs_inlier.numpy(), np.asarray(j.obs_inlier))
    assert float(t.cost) == pytest.approx(float(j.cost), rel=1e-4)
    np.testing.assert_allclose(t.T_cw.numpy(), np.asarray(j.T_cw), rtol=0, atol=1e-3)
    assert np.array_equal(t.T_cw[0].numpy(), p["T_cw"][0])  # the fixed camera stays


@pytest.mark.parametrize("seed", [1, 2])
def test_bundle_adjust_cg_stereo_rows(seed):
    """The same window as an edge list through the matrix-free solver."""
    p = _stereo_window_problem(seed)
    W, M = p["obs_point"].shape
    d = dict(T_cw=p["T_cw"], K=p["K"], cam_valid=p["cam_valid"], cam_fixed=p["cam_fixed"],
             points=p["points"], point_valid=p["point_valid"],
             obs_cam=np.repeat(np.arange(W, dtype=np.int32), M),
             obs_point=p["obs_point"].reshape(-1), obs_uv=p["obs_uv"].reshape(-1, 2),
             obs_sigma2=p["obs_sigma2"].reshape(-1), obs_valid=p["obs_valid"].reshape(-1),
             obs_ur=p["obs_ur"].reshape(-1), bf=p["bf"])
    j = jba.bundle_adjust_cg(jba.BAProblem(**{k: jnp.asarray(v) for k, v in d.items()}),
                             iters=6, cg_iters=30)
    t = tba.bundle_adjust_cg(convert.ba_problem_from_numpy(d, device="cpu"), iters=6,
                             cg_iters=30)
    assert np.array_equal(t.obs_inlier.numpy(), np.asarray(j.obs_inlier))
    assert float(t.cost) == pytest.approx(float(j.cost), rel=1e-4)
    np.testing.assert_allclose(t.T_cw.numpy(), np.asarray(j.T_cw), rtol=0, atol=1e-3)


@pytest.fixture(scope="module")
def depth_kf(frame):
    """Both packages' maps holding one keyframe with the RGB-D features of
    the frame at a moved pose, and 40 landmarks already in the pool (a
    freed slot among them); some features already observe them, and a run
    of features shares one depth (ties)."""
    f = jst.with_depthmap(frame["fL"], jnp.asarray(frame["depth"]), CAM)
    depth = np.array(f.depth)
    has = np.nonzero(depth > 0)[0]
    depth[has[10:16]] = depth[has[10]]  # equal depths
    f = f._replace(depth=jnp.asarray(depth))
    m = jms.empty_map(CFG)
    rng = np.random.default_rng(9)
    m = jms.add_landmarks(m, jnp.arange(40, dtype=jnp.int32), jnp.ones(40, bool),
                          jnp.asarray(rng.normal(0, 1, (40, 3)).astype(np.float32)),
                          jnp.zeros((40, 32), jnp.uint8), jnp.zeros((40, 3)), jnp.ones(40),
                          jnp.ones(40), 0)
    m = m._replace(lm_valid=m.lm_valid.at[17].set(False))
    obs = np.full(ORB.max_keypoints, -1, np.int32)
    obs[has[:30:3]] = np.arange(10)
    T = _pose([0.05, -0.02, 0.3, 0.01, 0.02, -0.01])
    m = jms.insert_keyframe(m, jnp.int32(2), jnp.asarray(T), jnp.asarray(K), f,
                            jnp.asarray(obs), 5, 0.5)
    return dict(m_j=m, m_t=convert.map_state_from_numpy(_np(m)._asdict(), device="cpu"),
                depth=depth)


@pytest.mark.parametrize("close_only,th_depth", [(True, 60.0), (True, 12.0), (False, 60.0)])
def test_create_depth_landmarks(depth_kf, close_only, th_depth):
    """th_depth 12 puts the close depth at 6 m inside the 4-14 m field, so
    the 100-closest rule decides part of the selection."""
    cfg = dataclasses.replace(CFG, camera=dataclasses.replace(CAM, th_depth=th_depth))
    max_new = 256 if close_only else ORB.max_keypoints
    j = _np(jlm.create_depth_landmarks(cfg, depth_kf["m_j"], jnp.int32(2),
                                       jnp.asarray(depth_kf["depth"]), max_new=max_new,
                                       close_only=close_only))
    t = tlm.create_depth_landmarks(cfg, depth_kf["m_t"], 2, torch.as_tensor(depth_kf["depth"]),
                                   max_new=max_new, close_only=close_only)
    assert np.array_equal(t.kf_obs_lm.numpy(), j.kf_obs_lm)
    assert np.array_equal(t.lm_valid.numpy(), j.lm_valid)
    assert np.array_equal(t.lm_ref_kf.numpy(), j.lm_ref_kf)
    new = j.lm_valid & ~np.asarray(depth_kf["m_j"].lm_valid)
    assert new.sum() >= 100 and new[17]  # the freed slot is reused
    np.testing.assert_allclose(t.lm_pos.numpy()[new], j.lm_pos[new], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t.lm_normal.numpy()[new], j.lm_normal[new], rtol=0, atol=1e-5)
    np.testing.assert_allclose(t.lm_dist_max.numpy()[new], j.lm_dist_max[new], rtol=1e-5)


def test_global_bundle_adjust_stereo_rows():
    """A fabricated 6-keyframe map with right-x measurements on most
    observations and two moved keyframes: one GBA slice of each package."""
    cfg = CFG  # 1024 feature slots: the solve takes each keyframe's first 512
    rng = np.random.default_rng(4)
    n_kf, n_pts = 6, 500
    pts = np.stack([rng.uniform(-4, 4, n_pts), rng.uniform(-2, 2, n_pts),
                    rng.uniform(5, 12, n_pts)], -1).astype(np.float32)
    poses = np.stack([_pose([0.2 * i, 0.0, 0.05 * i, 0.0, 0.01 * i, 0.0])
                      for i in range(n_kf)])
    m, _ = fabricate_map(cfg, poses, pts, rng.integers(0, 256, (n_pts, 32), dtype=np.uint8),
                         seed=4)
    m = _np(m)
    ur = np.full(m.kf_ur.shape, -1.0, np.float32)
    for k in range(n_kf):
        obs = m.kf_obs_lm[k]
        ok = (obs >= 0) & m.kf_feat_valid[k] & (rng.random(obs.shape) > 0.3)
        pc = m.lm_pos[np.maximum(obs, 0)] @ poses[k][:3, :3].T + poses[k][:3, 3]
        ur[k] = np.where(ok, m.kf_xy[k, :, 0] - CAM.bf / pc[:, 2] + rng.normal(0, 0.4, obs.shape),
                         -1.0)
    kf_pose = m.kf_pose.copy()
    kf_pose[3, :3, 3] += [0.05, -0.03, 0.04]
    kf_pose[5] = _pose([0.0, 0.02, 0.0, 0.01, 0.0, 0.0]) @ kf_pose[5]
    m = m._replace(kf_ur=ur, kf_pose=kf_pose)
    m_j = jax.tree.map(jnp.asarray, m)
    g_j, cost_j = jlc.global_bundle_adjust(cfg, m_j, iters=2, cg_iters=16)
    g_t, cost_t = tlc.global_bundle_adjust(
        cfg, convert.map_state_from_numpy(m._asdict(), device="cpu"), iters=2, cg_iters=16)
    assert float(cost_t) == pytest.approx(float(cost_j), rel=1e-4)
    np.testing.assert_allclose(g_t.kf_pose.numpy(), np.asarray(g_j.kf_pose), atol=1e-3)
    mono = dataclasses.replace(cfg, camera=dataclasses.replace(CAM, bf=0.0))
    _, cost_mono = tlc.global_bundle_adjust(
        mono, convert.map_state_from_numpy(m._asdict(), device="cpu"), iters=2, cg_iters=16)
    assert float(cost_t) != float(cost_mono)  # the stereo rows took part


def test_extractor_at_a_kitti_aspect():
    cam = CameraConfig(width=413, height=125, fx=239.3, fy=239.3, cx=206.5, cy=62.5, fps=10)
    seq = make_sequence(n_frames=2, n_points=900, cam=cam, seed=7, motion="forward")
    img = seq.images[1]
    fj = _np(jo.make_extractor(ORB, cam)(jnp.asarray(img)))
    ft = to.make_extractor(ORB, cam, device="cpu")(img)
    assert np.array_equal(ft.valid.numpy(), fj.valid) and fj.valid.sum() >= 300
    assert np.array_equal(ft.level.numpy(), fj.level)
    assert np.array_equal(ft.xy_raw.numpy(), fj.xy_raw)
    assert np.array_equal(ft.xy.numpy(), fj.xy)
    l0 = fj.level == 0
    assert np.array_equal(ft.response.numpy()[l0], fj.response[l0])
    for level in range(ORB.n_levels):
        sel = (fj.level == level) & fj.valid
        same = (ft.desc.numpy()[sel] == fj.desc[sel]).all(-1)
        assert same.all() if level == 0 else same.mean() >= 0.98, (level, same.mean())
