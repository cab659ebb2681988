"""Solver parity: pose_optimize, bundle_adjust_window and two_view_init of
orbslamm_tpu_torch against the JAX package on synthetic problems.

Tolerances (float32 solves whose reductions sum in another order):
  * inlier masks and init success: exact;
  * poses <= 1e-4, BA points <= 1e-3, init T21 <= 1e-4.
The init test injects the hypotheses JAX drew (``idx``): torch cannot
reproduce jax.random's stream.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from orbslamm_tpu.ops import ba as jba
from orbslamm_tpu.ops import geometry as jg
from orbslamm_tpu.ops import ransac as jr
from orbslamm_tpu_torch.ops import ba as tba
from orbslamm_tpu_torch.ops import ransac as tr

torch.set_num_threads(2)

K = np.array([[520.9, 0, 325.1], [0, 521.0, 249.7], [0, 0, 1]], np.float32)


def _pose(xi):
    return np.array(jg.se3_exp(jnp.asarray(xi, jnp.float32)))


def _project(T, X):
    pc = X @ T[:3, :3].T + T[:3, 3]
    return (pc[:, :2] / pc[:, 2:3]) * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]


def test_pose_optimize_batched_and_single():
    rng = np.random.default_rng(0)
    n = 300
    X = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    X[:, 2] += 8.0
    T_true = _pose([0.1, -0.05, 0.2, 0.02, -0.01, 0.03])
    uv = _project(T_true, X).astype(np.float32) + rng.normal(0, 0.7, (n, 2)).astype(np.float32)
    uv[:30] += rng.uniform(-40, 40, (30, 2)).astype(np.float32)  # outliers
    valid = rng.random(n) > 0.05
    level = rng.integers(0, 4, n)
    sigma2 = (1.2 ** level).astype(np.float32) ** 2
    T0 = np.stack([_pose([0.12, -0.02, 0.15, 0.03, 0.0, 0.02]), np.eye(4, dtype=np.float32)])
    j = jax.vmap(lambda T: jba.pose_optimize(T, jnp.asarray(K), jnp.asarray(X), jnp.asarray(uv),
                                             jnp.asarray(valid), sigma2=jnp.asarray(sigma2)))(
        jnp.asarray(T0))
    t = tba.pose_optimize(torch.as_tensor(T0), torch.as_tensor(K), torch.as_tensor(X),
                          torch.as_tensor(uv), torch.as_tensor(valid),
                          sigma2=torch.as_tensor(sigma2))
    assert np.array_equal(t.inliers.numpy(), np.asarray(j.inliers))
    assert np.array_equal(t.n_inliers.numpy(), np.asarray(j.n_inliers))
    np.testing.assert_allclose(t.T_cw.numpy(), np.asarray(j.T_cw), rtol=0, atol=1e-4)
    single = tba.pose_optimize(torch.as_tensor(T0[0]), torch.as_tensor(K), torch.as_tensor(X),
                               torch.as_tensor(uv), torch.as_tensor(valid),
                               sigma2=torch.as_tensor(sigma2))
    np.testing.assert_allclose(single.T_cw.numpy(), t.T_cw[0].numpy(), rtol=0, atol=1e-6)
    assert int(single.n_inliers) == int(t.n_inliers[0]) > 200


def _window_problem(seed):
    rng = np.random.default_rng(seed)
    W, M, P = 5, 120, 160
    X = rng.uniform(-3, 3, (P, 3)).astype(np.float32)
    X[:, 2] += 9.0
    T_true = np.stack([_pose([0.3 * w, 0.02 * w, 0.1 * w, 0.0, 0.02 * w, 0.0]) for w in range(W)])
    obs_point = np.zeros((W, M), np.int32)
    obs_uv = np.zeros((W, M, 2), np.float32)
    obs_valid = np.zeros((W, M), bool)
    for w in range(W):
        pts = rng.permutation(P)[:M]
        obs_point[w] = pts
        obs_uv[w] = _project(T_true[w], X[pts]) + rng.normal(0, 0.6, (M, 2))
        obs_valid[w] = rng.random(M) > 0.1
    obs_uv[1, :6] += 35.0  # a few outliers
    T_init = T_true.copy()
    for w in range(1, W):
        T_init[w] = _pose(rng.normal(0, 0.01, 6)) @ T_true[w]
    pts_init = X + rng.normal(0, 0.05, X.shape).astype(np.float32)
    level = rng.integers(0, 3, (W, M))
    return dict(
        T_cw=T_init, K=np.broadcast_to(K, (W, 3, 3)).copy(),
        cam_valid=np.array([True, True, True, True, False]),
        cam_fixed=np.array([True, False, False, False, False]),
        points=pts_init, point_valid=rng.random(P) > 0.05,
        obs_point=obs_point, obs_uv=obs_uv,
        obs_sigma2=((1.2 ** level) ** 2).astype(np.float32), obs_valid=obs_valid,
    )


def test_bundle_adjust_window():
    p = _window_problem(1)
    j = jba.bundle_adjust_window(**{k: jnp.asarray(v) for k, v in p.items()}, iters=8)
    t = tba.bundle_adjust_window(**{k: torch.as_tensor(v) for k, v in p.items()}, iters=8)
    assert np.array_equal(t.obs_inlier.numpy(), np.asarray(j.obs_inlier))
    np.testing.assert_allclose(t.T_cw.numpy(), np.asarray(j.T_cw), rtol=0, atol=1e-4)
    np.testing.assert_allclose(t.points.numpy(), np.asarray(j.points), rtol=0, atol=1e-3)
    np.testing.assert_allclose(float(t.cost), float(j.cost), rtol=1e-3)
    # fixed and invalid cameras never move
    assert np.array_equal(t.T_cw[0].numpy(), p["T_cw"][0])
    assert np.array_equal(t.T_cw[4].numpy(), p["T_cw"][4])


def test_window_incidence_and_inv3x3():
    rng = np.random.default_rng(2)
    obs = rng.integers(0, 50, (4, 30)).astype(np.int32)
    valid = rng.random((4, 30)) > 0.2
    ij, hj = jba._window_incidence(jnp.asarray(obs), jnp.asarray(valid), 50)
    it, ht = tba._window_incidence(torch.as_tensor(obs), torch.as_tensor(valid), 50)
    assert np.array_equal(it.numpy(), np.asarray(ij))
    assert np.array_equal(ht.numpy(), np.asarray(hj))
    A = rng.normal(0, 1, (20, 3, 3)).astype(np.float32) + 3 * np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(tba._inv3x3(torch.as_tensor(A)).numpy(),
                               np.asarray(jba._inv3x3(jnp.asarray(A))), rtol=1e-5, atol=1e-6)


def test_two_view_init_with_injected_hypotheses():
    rng = np.random.default_rng(3)
    n = 400
    X = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    X[:, 2] += 8.0
    T21 = _pose([0.5, 0.0, 0.1, 0.0, 0.04, 0.0])
    xy1 = (_project(np.eye(4, dtype=np.float32), X) + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    xy2 = (_project(T21, X) + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    xy2[:40] += rng.uniform(-60, 60, (40, 2)).astype(np.float32)  # wrong matches
    valid = rng.random(n) > 0.1
    key = jax.random.key(5)
    kw = dict(n_hyp=512, sigma=1.5, min_inliers=50, median_parallax_cos=np.cos(np.radians(1.0)))
    j = jr.two_view_init(jnp.asarray(xy1), jnp.asarray(xy2), jnp.asarray(valid),
                         jnp.asarray(K), key, **kw)
    idx = np.asarray(jr._sample_indices(key, jnp.asarray(valid), 512, 8))
    t = tr.two_view_init(torch.as_tensor(xy1), torch.as_tensor(xy2), torch.as_tensor(valid),
                         torch.as_tensor(K), idx=torch.as_tensor(idx), **kw)
    assert bool(j.success) and bool(t.success)
    assert np.array_equal(t.inliers.numpy(), np.asarray(j.inliers))
    assert int(t.n_inliers) == int(j.n_inliers)
    np.testing.assert_allclose(t.T21.numpy(), np.asarray(j.T21), rtol=0, atol=1e-4)
    good = np.asarray(j.inliers)
    np.testing.assert_allclose(t.points1.numpy()[good], np.asarray(j.points1)[good],
                               rtol=1e-3, atol=1e-3)
    # the generator path draws its own hypotheses and still succeeds
    g = torch.Generator().manual_seed(0)
    t2 = tr.two_view_init(torch.as_tensor(xy1), torch.as_tensor(xy2), torch.as_tensor(valid),
                          torch.as_tensor(K), g, **kw)
    assert bool(t2.success)
