"""The port's segment plan and the plain versions of its sorted segment sum
(``orbslamm_tpu_torch/ops/cuda/segsum.py``) on the CPU, against numpy and the
JAX package's ``_make_sorted_segsum`` and ``.at[].add``, and
``bundle_adjust_cg(segsum=...)`` against the JAX package's. The kernel itself
runs only on the card: tests/test_torch_segsum_cuda.py.

Tolerances, each with its reason:

* float32 sums of the same L values in two orders differ by at most
  2 (L - 1) 2^-24 sum |v| (each of the L - 1 additions rounds by at most
  2^-24 of a partial sum, which is at most sum |v|, in each order);
* the JAX package runs its sorted form with float64 off in these tests, so
  its running sum is float32 over all E edges: each boundary value is off by
  at most E 2^-24 sum_all |v|, a segment (a difference of two) by twice that;
* the port's sorted form is float64 to the end and rounds once to float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslamm_tpu.ops import ba as jba
from orbslamm_tpu_torch import convert
from orbslamm_tpu_torch.ops import ba as tba
from orbslamm_tpu_torch.ops.cuda import segsum as ss

torch.set_num_threads(2)

EPS = 2.0 ** -24


def _ids(case, rng):
    """(ids [E] int32, n): seeded edge lists with the shapes the solves give."""
    if case == "random":
        return rng.integers(0, 40, 3000).astype(np.int32), 40
    if case == "empty_segments":  # every odd segment empty, the last ones too
        return (2 * rng.integers(0, 20, 2000)).astype(np.int32), 50
    if case == "one_segment":  # every edge in one segment of many
        return np.full(1500, 7, np.int32), 16
    if case == "no_edges":
        return np.zeros(0, np.int32), 12
    if case == "pairs":  # the dense BA's (camera, point) pairs: almost all empty
        oc, op = rng.integers(0, 6, 500), rng.integers(0, 300, 500)
        return (oc * 300 + op).astype(np.int32), 6 * 300
    raise ValueError(case)


CASES = ["random", "empty_segments", "one_segment", "no_edges", "pairs"]


@pytest.mark.parametrize("case", CASES)
def test_plan_matches_numpy(case):
    """The permutation is numpy's stable argsort; each segment's start and
    end are numpy's left and right searchsorted; the kernel's chunk tables
    cut each segment's sorted run, in order, into chunks of at most
    CHUNK_ROWS edges, within the static bound n + ceil(E / CHUNK_ROWS)."""
    ids, n = _ids(case, np.random.default_rng(1))
    plan = ss.segment_plan(torch.as_tensor(ids), n)
    order = np.argsort(ids, kind="stable")
    s = ids[order]
    assert plan.n == n and plan.tables is None  # a CPU plan carries no kernel tables
    assert np.array_equal(plan.perm.numpy(), order)
    assert np.array_equal(plan.start.numpy(), np.searchsorted(s, np.arange(n), side="left"))
    assert np.array_equal(plan.end.numpy(), np.searchsorted(s, np.arange(n), side="right"))
    t = ss.kernel_tables(plan.perm, plan.start, plan.end)
    lo, hi, cs = t.chunk_lo.numpy(), t.chunk_hi.numpy(), t.chunk_start.numpy()
    assert t.perm.dtype == torch.int32 and np.array_equal(t.perm.numpy(), order)
    assert len(lo) == n + -(-len(ids) // ss.CHUNK_ROWS) and len(cs) == n + 1
    for seg in range(n):
        runs = [(lo[c], hi[c]) for c in range(cs[seg], cs[seg + 1])]
        a, b = plan.start[seg].item(), plan.end[seg].item()
        want = [(k, min(k + ss.CHUNK_ROWS, b)) for k in range(a, b, ss.CHUNK_ROWS)]
        assert runs == want, seg
    assert (lo[cs[-1]:] == 0).all() and (hi[cs[-1]:] == 0).all()  # empty past the last


@pytest.mark.parametrize("case", CASES)
def test_scatter_form_is_index_add(case):
    """``segment_sum_ref``, ``segment_sum`` and ``ops/ba._seg_add`` on a CPU
    tensor are ``index_add_`` in edge order, bit for bit (the CPU numbers
    of every solve stay as they were), and launch no kernel."""
    rng = np.random.default_rng(2)
    ids, n = _ids(case, rng)
    vals = torch.as_tensor(rng.normal(size=(len(ids), 3, 3)).astype(np.float32))
    want = torch.zeros((n, 3, 3)).index_add_(0, torch.as_tensor(ids).long(), vals)
    plan = ss.segment_plan(torch.as_tensor(ids), n)
    before = ss.launches
    for got in (ss.segment_sum_ref(plan, vals), ss.segment_sum(plan, vals),
                ss.segment_sum(plan, vals, "scatter"), tba._seg_add(plan, vals)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert ss.launches == before


@pytest.mark.parametrize("width", [1, 3, 6, 7, 9, 36, 49])
@pytest.mark.parametrize("case", ["random", "empty_segments", "one_segment", "pairs"])
def test_sorted_form_matches_jax(case, width):
    """The port's sorted form against the JAX package's
    ``_make_sorted_segsum`` and its ``.at[].add`` scatter on the same
    seeded edges, at the row widths the solves sum (1, 3, 6, 9 and 36 in
    the BAs, 7 and 49 in the Sim3 pose graph): within the bounds in the
    module docstring; against the float64 sum, within one float32 rounding
    plus the float64 running sum's own error."""
    rng = np.random.default_rng(width)
    ids, n = _ids(case, rng)
    shape = (len(ids),) + ((width,) if width in (1, 3, 6, 7, 9) else (int(width ** 0.5),) * 2)
    v = rng.normal(size=shape).astype(np.float32)
    v2 = v.reshape(len(ids), -1)
    plan = ss.segment_plan(torch.as_tensor(ids), n)
    got = ss.segment_sum(plan, torch.as_tensor(v), "sorted")
    assert got.shape == (n,) + shape[1:] and got.dtype == torch.float32
    assert torch.equal(got, ss.segment_sum_sorted_ref(plan, torch.as_tensor(v)))
    got = got.numpy().reshape(n, -1).astype(np.float64)

    exact = np.zeros((n, v2.shape[1]))
    np.add.at(exact, ids, v2.astype(np.float64))
    abs_seg = np.zeros_like(exact)
    np.add.at(abs_seg, ids, np.abs(v2.astype(np.float64)))
    L = np.bincount(ids, minlength=n)[:, None]
    assert (np.abs(got - exact) <= EPS * np.abs(exact) + 4 * len(ids) * 2.0 ** -53
            * np.abs(v2).sum(0)[None]).all()

    j_sorted = np.asarray(jba._make_sorted_segsum(jnp.asarray(ids), n)(jnp.asarray(v)))
    j_scatter = np.asarray(jnp.zeros((n,) + shape[1:], jnp.float32).at[jnp.asarray(ids)]
                           .add(jnp.asarray(v)))
    j_sorted = j_sorted.reshape(n, -1).astype(np.float64)
    j_scatter = j_scatter.reshape(n, -1).astype(np.float64)
    cumsum_tol = 2 * len(ids) * EPS * np.abs(v2).sum(0)[None] + EPS * np.abs(exact)
    assert (np.abs(got - j_sorted) <= cumsum_tol).all()
    order_tol = 2 * np.maximum(L - 1, 0) * EPS * abs_seg + EPS * np.abs(exact)
    assert (np.abs(got - j_scatter) <= order_tol).all()


def _small_ba(seed):
    """A seeded monocular BA problem: 5 cameras along x looking down +z at 80
    points, every point seen by every camera it projects into, camera 0
    fixed, 1 px observation noise, the free cameras moved by 2 cm and the
    points by 5 cm; 2 of the 400 edge slots invalid."""
    rng = np.random.default_rng(seed)
    C, P = 5, 80
    K = np.array([[260.0, 0, 160], [0, 260.0, 120], [0, 0, 1]], np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    T[:, 0, 3] = -0.3 * np.arange(C)
    pts = np.stack([rng.uniform(-1.5, 2.7, P), rng.uniform(-1, 1, P), rng.uniform(3, 6, P)],
                   -1).astype(np.float32)
    oc = np.repeat(np.arange(C), P).astype(np.int32)
    op = np.tile(np.arange(P), C).astype(np.int32)
    pc = pts[op] + T[oc, :3, 3]
    uv = (pc[:, :2] / pc[:, 2:]) * 260.0 + np.array([160.0, 120.0])
    uv = (uv + rng.normal(scale=1.0, size=uv.shape)).astype(np.float32)
    ok = (uv[:, 0] >= 0) & (uv[:, 0] < 320) & (uv[:, 1] >= 0) & (uv[:, 1] < 240)
    ok[[3, 77]] = False
    T0 = T.copy()
    T0[1:, :3, 3] += rng.normal(scale=0.02, size=(C - 1, 3)).astype(np.float32)
    fixed = np.zeros(C, bool)
    fixed[0] = True
    return dict(T_cw=T0, K=np.tile(K, (C, 1, 1)), cam_valid=np.ones(C, bool), cam_fixed=fixed,
                points=(pts + rng.normal(scale=0.05, size=pts.shape)).astype(np.float32),
                point_valid=np.ones(P, bool), obs_cam=oc, obs_point=op, obs_uv=uv,
                obs_sigma2=np.ones(C * P, np.float32), obs_valid=ok)


@pytest.mark.parametrize("seed", [0, 1])
def test_bundle_adjust_cg_sorted_matches_jax(seed):
    """``bundle_adjust_cg(segsum="sorted")`` of both packages on one seeded
    problem (4 LM iterations of 20 CG steps): cost within 1e-3 relative,
    poses within 1e-3 and points within 1e-2 (the bounds of the scatter
    route's parity test, tests/test_torch_loop_closing.py), inlier masks
    equal; the port's two routes agree as closely."""
    d = _small_ba(seed)
    p_j = jba.BAProblem(**{k: jnp.asarray(v) for k, v in d.items()})
    p_t = convert.ba_problem_from_numpy(d, device="cpu")
    r_j = jba.bundle_adjust_cg(p_j, iters=4, cg_iters=20, segsum="sorted")
    r_t = tba.bundle_adjust_cg(p_t, iters=4, cg_iters=20, segsum="sorted")
    r_s = tba.bundle_adjust_cg(p_t, iters=4, cg_iters=20)
    cost0 = float(tba._ba_cost(p_t.T_cw, p_t.K, p_t.points, p_t, p_t.obs_valid, tba.CHI2_MONO))
    assert float(r_t.cost) < 0.5 * cost0  # the solve does work
    for other in (r_j, r_s):
        assert float(r_t.cost) == pytest.approx(float(other.cost), rel=1e-3)
        np.testing.assert_allclose(r_t.T_cw.numpy(), np.asarray(other.T_cw), rtol=0, atol=1e-3)
        np.testing.assert_allclose(r_t.points.numpy(), np.asarray(other.points), rtol=0,
                                   atol=1e-2)
        assert np.array_equal(r_t.obs_inlier.numpy(), np.asarray(other.obs_inlier))


def test_unknown_segsum_raises():
    """``segsum`` takes "scatter" or "sorted"; any other value raises, in
    ``bundle_adjust_cg``, its sharded form and ``segment_sum``."""
    p = convert.ba_problem_from_numpy(_small_ba(0), device="cpu")
    with pytest.raises(ValueError, match="segsum"):
        tba.bundle_adjust_cg(p, iters=1, cg_iters=2, segsum="atomic")
    with pytest.raises(ValueError, match="segsum"):
        tba.bundle_adjust_cg_shards(p, [p], iters=1, cg_iters=2, segsum="Sorted")
    plan = ss.segment_plan(p.obs_cam, 5)
    with pytest.raises(ValueError, match="form"):
        ss.segment_sum(plan, p.obs_uv, "cumsum")
