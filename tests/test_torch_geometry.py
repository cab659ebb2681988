"""Geometry parity: orbslamm_tpu_torch.ops.geometry against the JAX package.

Tolerance: 1e-5 relative (plus 1e-6 absolute for entries near zero) —
float32 transcendentals and 3x3 products differ between XLA and PyTorch by a
few ulp. Near-zero rotations exercise the series branches.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslamm_tpu.ops import geometry as jg
from orbslamm_tpu_torch.ops import geometry as tg

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


def _twists(seed, n=64, scale=1.0):
    rng = np.random.default_rng(seed)
    xi = rng.normal(0, 1, (n, 6)).astype(np.float32)
    xi[:, 3:] *= scale
    return xi


# At |phi| ~ 1e-3 the general (non-series) branch evaluates (1 - cos t)/t^2
# in float32, where 1 - cos t ~ 5e-7 keeps only one or two significant
# digits in EITHER implementation: the left-Jacobian coefficient differs by
# up to ~10% between XLA's and PyTorch's cos, i.e. up to ~1e-4 absolute in
# the translation of se3 exp/log for a unit rho. That case gets that bound;
# every other case holds 1e-5 relative.
SE3_CASES = [(1.0, ATOL), (1e-3, 5e-4), (1e-6, ATOL), (0.0, ATOL)]


@pytest.mark.parametrize("scale,se3_atol", SE3_CASES)
def test_so3_and_se3_exp(scale, se3_atol):
    xi = _twists(0, scale=scale)
    _close(tg.skew(torch.as_tensor(xi[:, 3:])), jg.skew(jnp.asarray(xi[:, 3:])))
    _close(tg.so3_exp(torch.as_tensor(xi[:, 3:])), jg.so3_exp(jnp.asarray(xi[:, 3:])))
    _close(tg.se3_exp(torch.as_tensor(xi)), jg.se3_exp(jnp.asarray(xi)), atol=se3_atol)


@pytest.mark.parametrize("scale,se3_atol", SE3_CASES[:3])
def test_so3_and_se3_log(scale, se3_atol):
    xi = _twists(1, scale=scale)
    T = np.array(jg.se3_exp(jnp.asarray(xi)))
    _close(tg.rot_to_quat(torch.as_tensor(T[:, :3, :3])), jg.rot_to_quat(jnp.asarray(T[:, :3, :3])))
    _close(tg.so3_log(torch.as_tensor(T[:, :3, :3])), jg.so3_log(jnp.asarray(T[:, :3, :3])),
           rtol=1e-5, atol=1e-6)
    # se3_log solves a 3x3 system: allow the solve's conditioning on top
    _close(tg.se3_log(torch.as_tensor(T)), jg.se3_log(jnp.asarray(T)), rtol=1e-4,
           atol=max(se3_atol, 1e-5))


def test_rt_inverse_transform_project():
    xi = _twists(2)
    T = np.array(jg.se3_exp(jnp.asarray(xi)))
    rng = np.random.default_rng(3)
    pts = rng.normal(0, 2, (64, 50, 3)).astype(np.float32)
    pts[..., 2] += 6.0
    K = np.array([[520.9, 0, 325.1], [0, 521.0, 249.7], [0, 0, 1]], np.float32)
    _close(tg.T_inv(torch.as_tensor(T)), jg.T_inv(jnp.asarray(T)))
    _close(tg.rt_to_T(torch.as_tensor(T[:, :3, :3]), torch.as_tensor(T[:, :3, 3])),
           jg.rt_to_T(jnp.asarray(T[:, :3, :3]), jnp.asarray(T[:, :3, 3])))
    pc_t = tg.transform_points(torch.as_tensor(T), torch.as_tensor(pts))
    pc_j = jg.transform_points(jnp.asarray(T), jnp.asarray(pts))
    _close(pc_t, pc_j)
    _close(tg.transform_points(torch.as_tensor(T[0]), torch.as_tensor(pts[0, 0])),
           jg.transform_points(jnp.asarray(T[0]), jnp.asarray(pts[0, 0])))
    _close(tg.project(torch.as_tensor(K), torch.as_tensor(pts)),
           jg.project(jnp.asarray(K), jnp.asarray(pts)))


def test_triangulate_dlt():
    rng = np.random.default_rng(4)
    K = np.array([[520.9, 0, 325.1], [0, 521.0, 249.7], [0, 0, 1]], np.float32)
    X = rng.uniform(-2, 2, (200, 3)).astype(np.float32)
    X[:, 2] += 7.0
    T2 = np.asarray(jg.se3_exp(jnp.asarray([0.4, 0.05, 0.1, 0.01, -0.03, 0.02], jnp.float32)))
    P1 = K @ np.eye(4, dtype=np.float32)[:3]
    P2 = K @ T2[:3]
    uv1 = np.asarray(jg.project(jnp.asarray(K), jnp.asarray(X)))
    uv2 = np.asarray(jg.project(jnp.asarray(K), jg.transform_points(jnp.asarray(T2), jnp.asarray(X))))
    uv1 = uv1 + rng.normal(0, 0.5, uv1.shape).astype(np.float32)
    Xt = tg.triangulate_dlt(*(torch.as_tensor(a) for a in (P1, P2, uv1, uv2)))
    Xj = jg.triangulate_dlt(*(jnp.asarray(a) for a in (P1, P2, uv1, uv2)))
    # a 4x4 eigenproblem of a badly scaled A^T A: both sides lose digits to
    # conditioning; the eigenvector sign is free and cancels on dividing by w
    _close(Xt, Xj, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(Xj), X, atol=0.5)
