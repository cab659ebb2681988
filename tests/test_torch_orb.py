"""ORB extraction parity: orbslamm_tpu_torch.ops.orb against the JAX package.

Tolerances:
  * copied generators, FAST score, NMS, keypoint selection and the level-0
    orientation moments are exact (integer-valued float32 arithmetic or
    min/max only);
  * the 7x7 blur sums its taps in the JAX order: <= 1e-5;
  * resize weights: <= 1e-6 against JAX's own weight matrix (the column
    normalisation may sum in another order), and the resized image
    <= 1e-3 absolute on 0..255 pixels (another order of the two products);
  * the extractor on a rendered frame: level 0 keypoints and descriptors
    bit-exact. On levels >= 1 the level image comes from a float resize
    whose last-ulp rounding differs between XLA and PyTorch, which can flip
    FAST threshold/NMS ties, so >= 98% of keypoint slots must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslamm_tpu.io.synthetic import make_sequence
from orbslamm_tpu.ops import orb as jo
from orbslamm_tpu.utils.config import CameraConfig, OrbConfig
from orbslamm_tpu_torch.ops import orb as to

torch.set_num_threads(2)

CAM = CameraConfig(width=320, height=240, fx=260, fy=260, cx=160, cy=120, fps=30)
ORB = OrbConfig(n_features=400, max_keypoints=1024, n_levels=4)


@pytest.fixture(scope="module")
def frame():
    seq = make_sequence(n_frames=2, n_points=900, cam=CAM, seed=7, motion="strafe")
    return seq.images[1]


def test_undistort_points():
    cam = CameraConfig(width=320, height=240, fx=260, fy=260, cx=160, cy=120,
                       k1=0.12, k2=-0.05, p1=0.001, p2=-0.002, k3=0.01)
    xy = np.random.default_rng(5).uniform(0, [320, 240], (200, 2)).astype(np.float32)
    np.testing.assert_allclose(to.undistort_points(torch.as_tensor(xy), cam).numpy(),
                               np.asarray(jo.undistort_points(jnp.asarray(xy), cam)),
                               rtol=0, atol=1e-3)
    assert to.undistort_points(torch.as_tensor(xy), CAM) is not None


def test_fast_nms_blur_orientation(frame):
    img = frame.astype(np.float32)
    sj = np.asarray(jo.fast_score(jnp.asarray(img)))
    st = to.fast_score(torch.as_tensor(img)).numpy()
    assert np.array_equal(st, sj)
    assert np.array_equal(to._nms3(torch.as_tensor(st)).numpy(), np.asarray(jo._nms3(jnp.asarray(sj))))
    np.testing.assert_allclose(to.gaussian_blur7(torch.as_tensor(img)).numpy(),
                               np.asarray(jo.gaussian_blur7(jnp.asarray(img))), rtol=0, atol=1e-5)
    m10t, m01t = to.orientation_maps(torch.as_tensor(img))
    m10j, m01j = jo.orientation_maps(jnp.asarray(img))
    assert np.array_equal(m10t.numpy(), np.asarray(m10j))
    assert np.array_equal(m01t.numpy(), np.asarray(m01j))


@pytest.mark.parametrize("n_slots,cell", [(160, 16), (37, 16), (200, 8)])
def test_select_level_keypoints(frame, n_slots, cell):
    score = np.array(jo.fast_score(jnp.asarray(frame.astype(np.float32))))
    xy_j, r_j, v_j = jo.select_level_keypoints(jnp.asarray(score), n_slots, 7.0, cell)
    xy_t, r_t, v_t = to.select_level_keypoints(torch.as_tensor(score), n_slots, 7.0, cell)
    assert np.array_equal(xy_t.numpy(), np.asarray(xy_j))
    assert np.array_equal(r_t.numpy(), np.asarray(r_j))
    assert np.array_equal(v_t.numpy(), np.asarray(v_j))


def test_resize_weights_match_jax(frame):
    from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

    for n_in, n_out in [(240, 200), (320, 267), (240, 139), (480, 231), (240, 240)]:
        w_j = np.asarray(compute_weight_mat(n_in, n_out, n_out / n_in, 0.0,
                                            _fill_triangle_kernel, True))
        np.testing.assert_allclose(to.resize_weights(n_in, n_out), w_j.T, rtol=0, atol=1e-6)
    img = frame.astype(np.float32)
    out_j = np.asarray(jax.image.resize(jnp.asarray(img), (167, 222), method="linear"))
    Ry = torch.as_tensor(to.resize_weights(240, 167))
    Rx = torch.as_tensor(to.resize_weights(320, 222))
    out_t = (Ry @ torch.as_tensor(img) @ Rx.T).numpy()
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=1e-3)


def test_extractor_matches_jax(frame):
    fj = jax.tree.map(np.asarray, jo.make_extractor(ORB, CAM)(jnp.asarray(frame)))
    ft = to.make_extractor(ORB, CAM, device="cpu")(frame)
    lvl = fj.level
    assert np.array_equal(ft.level.numpy(), lvl)
    assert np.array_equal(ft.valid.numpy(), fj.valid)
    l0 = (lvl == 0) & fj.valid
    assert np.array_equal(ft.xy_raw.numpy()[l0], fj.xy_raw[l0])
    assert np.array_equal(ft.xy.numpy()[l0], fj.xy[l0])
    assert np.array_equal(ft.desc.numpy()[l0], fj.desc[l0])
    assert np.array_equal(ft.response.numpy()[l0], fj.response[l0])
    np.testing.assert_allclose(ft.angle.numpy()[l0], fj.angle[l0], rtol=0, atol=1e-5)
    for level in range(1, ORB.n_levels):
        sel = lvl == level
        same = (ft.xy_raw.numpy()[sel] == fj.xy_raw[sel]).all(-1)
        assert same.mean() >= 0.98, (level, same.mean())
