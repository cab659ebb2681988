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
from orbslamm_tpu_torch.ops import geometry as tgeo
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
    end are numpy's left and right searchsorted; the kernel's int32 tables
    hold the permutation, the sorted ids and the bounds (one segment past
    the last, empty here); ``tile_pieces`` cuts the sorted rows where the
    segment or the tile changes, as a numpy cut does, at two tile sizes."""
    ids, n = _ids(case, np.random.default_rng(1))
    plan = ss.segment_plan(torch.as_tensor(ids), n)
    order = np.argsort(ids, kind="stable")
    s = ids[order]
    t = plan.tables
    assert plan.n == n and plan.split is None
    assert t.counters is None and t.launch is None  # a CPU plan binds no kernel
    assert np.array_equal(plan.perm.numpy(), order)
    assert np.array_equal(plan.start.numpy(), np.searchsorted(s, np.arange(n), side="left"))
    assert np.array_equal(plan.end.numpy(), np.searchsorted(s, np.arange(n), side="right"))
    assert t.perm.dtype == t.sorted_ids.dtype == t.bounds.dtype == torch.int32
    assert np.array_equal(t.perm.numpy(), order) and np.array_equal(t.sorted_ids.numpy(), s)
    assert np.array_equal(t.bounds.numpy(), np.searchsorted(s, np.arange(n + 2), side="left"))
    for tile in (32, 100):
        k = np.arange(len(s))
        cut = np.flatnonzero(np.r_[True, (s[1:] != s[:-1]) | (k[1:] // tile != k[:-1] // tile)]
                             ) if len(s) else np.zeros(0, int)
        seg, tl, lo, hi = (x.numpy() for x in ss.tile_pieces(plan, tile))
        assert np.array_equal(lo, cut) and np.array_equal(hi, np.r_[cut[1:], len(s)][:len(cut)])
        assert np.array_equal(seg, s[cut]) and np.array_equal(tl, cut // tile)
        assert ((hi - 1) // tile == tl).all() and (hi > lo).all()


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


def _loop_tiled(ids, n, v, tile):
    """The kernel's order written as loops over float32 rows: each segment's
    pieces, one a tile; within a piece its tile-aligned groups of
    GROUP_ROWS rows, each added left to right, then the groups' sums in the
    pairwise tree; then the pieces' sums in the same tree."""

    def tree(xs):
        xs, d = list(xs), 1
        while d < len(xs):
            for q in range(0, len(xs) - d, 2 * d):
                xs[q] = xs[q] + xs[q + d]
            d *= 2
        return xs[0]

    G = ss.GROUP_ROWS
    order = np.argsort(ids, kind="stable")
    s, sv = ids[order], v[order]
    out = np.zeros((n, v.shape[1]), np.float32)
    for seg in range(n):
        lo, hi = np.searchsorted(s, seg), np.searchsorted(s, seg, side="right")
        pieces = []
        for t in range(lo // tile, (hi - 1) // tile + 1) if hi > lo else ():
            a, b = max(lo, t * tile), min(hi, (t + 1) * tile)
            groups = []
            for g0 in range(a - (a - t * tile) % G, b, G):
                acc = sv[max(a, g0)].copy()
                for r in range(max(a, g0) + 1, min(b, g0 + G)):
                    acc = acc + sv[r]
                groups.append(acc)
            pieces.append(tree(groups))
        if pieces:
            out[seg] = tree(pieces)
    return out


@pytest.mark.parametrize("tile", [32, 45, 256])
@pytest.mark.parametrize("width", [1, 6, 7])
@pytest.mark.parametrize("case", CASES)
def test_tiled_ref_is_the_kernel_order(case, width, tile):
    """``segment_sum_tiled_ref`` (tensor ops) bitwise equal to the kernel's
    order written as loops, with segments across several tiles."""
    rng = np.random.default_rng(3)
    ids, n = _ids(case, rng)
    v = rng.normal(size=(len(ids), width)).astype(np.float32)
    got = ss.segment_sum_tiled_ref(ss.segment_plan(torch.as_tensor(ids), n),
                                   torch.as_tensor(v), tile)
    assert got.dtype == torch.float32 and got.shape == (n, width)
    assert np.array_equal(got.numpy().view(np.int32), _loop_tiled(ids, n, v, tile).view(np.int32))


def _reorder_bound(ids, n, v):
    """2 (L - 1) 2^-24 sum |v| per segment of L edges, [n, width]."""
    v2 = v.reshape(len(ids), -1).astype(np.float64)
    abs_seg = np.zeros((n, v2.shape[1]))
    np.add.at(abs_seg, ids, np.abs(v2))
    L = np.bincount(ids, minlength=n)[:, None]
    return 2 * np.maximum(L - 1, 0) * EPS * abs_seg


@pytest.mark.parametrize("width", [1, 3, 6, 7, 9, 18, 36, 49])
@pytest.mark.parametrize("case", ["random", "empty_segments", "one_segment", "pairs"])
def test_tiled_ref_within_bound(case, width):
    """The kernel's order against ``index_add_`` in edge order, at every row
    width the solves sum, with tiles of 32 rows so that segments span
    several tiles: within the reordering bound; empty segments exactly 0."""
    rng = np.random.default_rng(width + 7)
    ids, n = _ids(case, rng)
    shape = {36: (6, 6), 49: (7, 7), 9: (3, 3), 18: (6, 3), 1: ()}.get(width, (width,))
    v = rng.normal(size=(len(ids),) + shape).astype(np.float32)
    plan = ss.segment_plan(torch.as_tensor(ids), n)
    got = ss.segment_sum_tiled_ref(plan, torch.as_tensor(v), 32)
    want = ss.segment_sum_ref(plan, torch.as_tensor(v))
    assert got.shape == want.shape and got.dtype == want.dtype
    d = np.abs(got.numpy().astype(np.float64) - want.numpy()).reshape(n, -1)
    assert (d <= _reorder_bound(ids, n, v)).all(), d.max()
    empty = np.bincount(ids, minlength=n) == 0
    assert (got.numpy().reshape(n, -1)[empty] == 0).all()


@pytest.mark.parametrize("width", [7, 49])
def test_pair_is_two_index_adds(width):
    """``segment_sum_pair`` on the CPU: bitwise ``index_add_`` of each list
    in edge order plus one add (the pose graph's CPU numbers stay as they
    were), no kernel launch; its tiled order within the reordering bound;
    a pair plan and a single plan refuse each other's sum."""
    rng = np.random.default_rng(width)
    ei, ej = rng.integers(0, 60, 400), rng.integers(0, 60, 400)
    shape = (width,) if width == 7 else (7, 7)
    a = torch.as_tensor(rng.normal(size=(400,) + shape).astype(np.float32))
    b = torch.as_tensor(rng.normal(size=(400,) + shape).astype(np.float32))
    plan = ss.segment_plan_pair(torch.as_tensor(ei), torch.as_tensor(ej), 60)
    before = ss.launches
    got = ss.segment_sum_pair(plan, a, b)
    want = (torch.zeros((60,) + shape).index_add_(0, torch.as_tensor(ei), a)
            + torch.zeros((60,) + shape).index_add_(0, torch.as_tensor(ej), b))
    assert ss.launches == before and torch.equal(got, want)
    assert torch.equal(tba._seg_add_pair(plan, a, b), want)
    tiled = ss.segment_sum_pair_tiled_ref(plan, a, b, 32)
    ids = np.concatenate([ei, ej])
    v = torch.cat([a, b]).numpy()
    d = np.abs(tiled.numpy().astype(np.float64) - want.numpy()).reshape(60, -1)
    # the pair's own reference adds the two lists' sums once more: one rounding
    bound = _reorder_bound(ids, 60, v) + EPS * np.abs(want.numpy()).reshape(60, -1)
    assert (d <= bound).all()
    with pytest.raises(ValueError, match="segment_sum_pair"):
        ss.segment_sum(plan, torch.cat([a, b]))
    with pytest.raises(ValueError, match="segment_plan_pair"):
        ss.segment_sum_pair(ss.segment_plan(torch.as_tensor(ei), 60), a, b)
    with pytest.raises(ValueError, match="rows"):
        ss.segment_sum_pair(plan, a[1:], b)


def test_pose_graph_pair_matches_two_plans(monkeypatch):
    """``pose_graph_optimize`` on the CPU with the pair plan bitwise equal to
    the form it replaces (two plans, two sums and an add per product), on a
    seeded ring with chords."""
    rng = np.random.default_rng(5)
    C = 20
    S = torch.zeros(C, 8)
    S[:, 3] = S[:, 7] = 1.0
    S[:, 4:7] = torch.as_tensor(rng.normal(size=(C, 3)).astype(np.float32))
    ei = torch.as_tensor(np.r_[np.arange(C), rng.integers(0, C, 12)].astype(np.int32))
    ej = torch.as_tensor(np.r_[(np.arange(C) + 1) % C, rng.integers(0, C, 12)].astype(np.int32))
    M = tgeo.sim3_compose(S[ei.long()], tgeo.sim3_inv(S[ej.long()]))
    S0 = S.clone()
    S0[:, 4:7] += torch.as_tensor(rng.normal(scale=0.05, size=(C, 3)).astype(np.float32))
    fixed = torch.zeros(C, dtype=torch.bool)
    fixed[0] = True
    E = ei.shape[0]
    prob = tba.PoseGraphProblem(
        S_iw=S0, node_valid=torch.ones(C, dtype=torch.bool), node_fixed=fixed, edge_i=ei,
        edge_j=ej, edge_Sij=M, edge_valid=torch.ones(E, dtype=torch.bool),
        edge_weight=torch.as_tensor(rng.uniform(0.5, 2.0, E).astype(np.float32)))
    got = tba.pose_graph_optimize(prob, iters=4, cg_iters=10)

    def two_plans(plan, a, b):
        i = ss.segment_plan(plan.idx[:plan.split], plan.n)
        j = ss.segment_plan(plan.idx[plan.split:], plan.n)
        return tba._seg_add(i, a) + tba._seg_add(j, b)

    monkeypatch.setattr(tba, "_seg_add_pair", two_plans)
    want = tba.pose_graph_optimize(prob, iters=4, cg_iters=10)
    assert not torch.equal(got, S0) and torch.equal(got, want)


def test_copy_width_from_alignment():
    """The wrapper's copy size: 16 bytes where the width and every base
    pointer allow, else 8, else 4; a pointer off 4-byte alignment raises."""
    assert ss._copy_floats(36, 256, 1024) == 4
    assert ss._copy_floats(36, 256, 1032) == 2
    assert ss._copy_floats(18, 256, 512) == 2
    assert ss._copy_floats(7, 256, 512) == 1
    assert ss._copy_floats(36, 260, 512) == 1
    with pytest.raises(ValueError, match="aligned"):
        ss._copy_floats(36, 258, 512)


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
