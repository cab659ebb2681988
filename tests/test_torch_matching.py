"""Matcher parity: orbslamm_tpu_torch.ops.matching and the plain match tables
against the JAX package (the Pallas kernel in interpret mode, as
tests/test_pallas_hamming.py runs it).

Tolerances: every output here is discrete (distances are integers 0..256,
indices, masks), so the comparisons are exact. Masked table entries only
have to stay above 256 on both sides — the two formulations accumulate
different penalties by design.
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslamm_tpu.ops import matching as jm
from orbslamm_tpu.ops.pallas import hamming as jph
from orbslamm_tpu_torch.ops import matching as tm
from orbslamm_tpu_torch.ops.cuda import hamming as tph

torch.set_num_threads(2)


def _case(seed, n, m):
    """The random case of test_pallas_hamming.py, as numpy arrays."""
    rng = np.random.default_rng(seed)
    desc_a = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    desc_b = rng.integers(0, 256, (m, 32), dtype=np.uint8)
    desc_b[1] = desc_a[0]  # duplicated descriptors exercise tie-breaking
    desc_b[m - 1] = desc_a[0]
    return dict(
        desc_a=desc_a, desc_b=desc_b,
        valid_a=rng.random(n) > 0.1, valid_b=rng.random(m) > 0.1,
        xy_a=rng.uniform(0, 640, (n, 2)).astype(np.float32),
        xy_b=rng.uniform(0, 640, (m, 2)).astype(np.float32),
        radius_b=rng.uniform(50, 400, (m,)).astype(np.float32),
        level_a=rng.integers(0, 8, (n,)).astype(np.int32),
        level_b=rng.integers(0, 8, (m,)).astype(np.int32),
        lines_a=np.concatenate([rng.normal(size=(n, 2)),
                                rng.uniform(-400, 0, (n, 1))], 1).astype(np.float32),
        epi_thr_b=(3.84 * 1.44 ** rng.integers(0, 8, (m,))).astype(np.float32) * 40,
    )


def _j(d, keys):
    return {k: jnp.asarray(d[k]) for k in keys}


def _t(d, keys):
    return {k: torch.as_tensor(d[k]) for k in keys}


def _assert_tables_equal(t, j):
    """Equal on live entries; masked entries > 256 on both sides."""
    jb = np.asarray(j.row_best)
    live_r = jb <= 256.0
    assert np.array_equal(t.row_best.numpy()[live_r], jb[live_r])
    assert np.array_equal(t.row_arg.numpy()[live_r], np.asarray(j.row_arg)[live_r])
    assert np.all(t.row_best.numpy()[~live_r] > 256.0)
    js = np.asarray(j.row_second)
    live_s = live_r & (js <= 256.0)
    assert np.array_equal(t.row_second.numpy()[live_s], js[live_s])
    assert np.all(t.row_second.numpy()[live_r & ~live_s] > 256.0)
    jc = np.asarray(j.col_best)
    live_c = jc <= 256.0
    assert np.array_equal(t.col_best.numpy()[live_c], jc[live_c])
    assert np.array_equal(t.col_arg.numpy()[live_c], np.asarray(j.col_arg)[live_c])
    assert np.all(t.col_best.numpy()[~live_c] > 256.0)
    assert np.all((t.row_arg.numpy() >= 0) & (t.row_arg.numpy() < len(jc)))
    return int(live_r.sum())


BASE = ("desc_a", "desc_b", "valid_a", "valid_b")
WINDOW = BASE + ("xy_a", "xy_b", "radius_b", "level_a", "level_b")
EPI = BASE + ("xy_b", "lines_a", "epi_thr_b", "level_a", "level_b")


@pytest.mark.parametrize("mode,n,m,seed", [
    ("window", 256, 128, 0),
    ("window", 512, 384, 0),
    ("none", 256, 256, 1),
    ("epipolar", 256, 128, 4),
    ("epipolar", 512, 384, 5),
])
def test_match_tables_ref_equals_pallas(mode, n, m, seed):
    d = _case(seed, n, m)
    keys = {"window": WINDOW, "none": BASE, "epipolar": EPI}[mode]
    kw = dict(lvl_lo=-1.0, lvl_hi=2.0, use_window=mode == "window",
              use_epipolar=mode == "epipolar")
    if mode == "none":
        kw = {}
    j = jph.match_tables(**_j(d, keys), interpret=True, **kw)
    t = tph.match_tables_ref(**_t(d, keys), **kw)
    n_live = _assert_tables_equal(t, j)
    assert n_live > 0  # the case exercises live entries


def test_match_tables_all_invalid_columns():
    d = _case(2, 256, 128)
    d["valid_b"][:] = False
    t = tph.match_tables(**_t(d, BASE))
    assert torch.all(t.row_best > 256.0) and torch.all(t.col_best > 256.0)
    assert torch.all((t.row_arg >= 0) & (t.row_arg < 128))
    assert torch.all(t.col_arg == 0)


def test_match_tables_duplicate_gives_second_equal_best():
    d = _case(3, 64, 40)
    d["valid_a"][0] = d["valid_b"][1] = d["valid_b"][39] = True
    t = tph.match_tables(**_t(d, BASE))
    assert t.row_best[0] == 0 and t.row_second[0] == 0 and t.row_arg[0] == 1


def test_match_tables_ragged_any_shape():
    """No alignment rule: any N, M >= 1 (the TPU kernel needs N % 256 and
    M % 128); the plain twin on the CPU must equal the dense reduction."""
    d = _case(6, 37, 11)
    t = tph.match_tables(**_t(d, WINDOW), lvl_lo=-1.0, lvl_hi=1.0, use_window=True)
    assert t.row_best.shape == (37,) and t.col_arg.shape == (11,)
    D = tm.hamming_matrix(torch.as_tensor(d["desc_a"]), torch.as_tensor(d["desc_b"]))
    allowed = (tm.window_mask_b(torch.as_tensor(d["xy_a"]), torch.as_tensor(d["xy_b"]),
                                torch.as_tensor(d["radius_b"]))
               & tm.level_mask(torch.as_tensor(d["level_a"]), torch.as_tensor(d["level_b"]))
               & torch.as_tensor(d["valid_a"])[:, None] & torch.as_tensor(d["valid_b"])[None])
    live = allowed.any(1)
    Dm = torch.where(allowed, D, torch.full_like(D, 1e9))
    assert torch.equal(t.row_best[live], Dm.min(1).values[live])
    assert torch.equal(t.row_arg[live].long(), Dm.argmin(1)[live])


def test_matchers_on_cpu_never_launch_the_kernel():
    before = tph.launches
    d = _case(0, 256, 128)
    tm.match_windowed(**_t(d, WINDOW), lvl_lo=-1.0, lvl_hi=1.0, max_dist=60.0)
    tm.match_epipolar(**_t(d, ("desc_a", "desc_b", "valid_a", "valid_b", "xy_a", "xy_b",
                               "level_a", "level_b")),
                      F12=torch.eye(3), scale=1.2)
    assert tph.launches == before


def test_unpack_bits_and_hamming_matrix():
    d = _case(7, 64, 48)
    bits_j = np.asarray(jm.unpack_bits(jnp.asarray(d["desc_a"])))
    bits_t = tm.unpack_bits(torch.as_tensor(d["desc_a"])).numpy()
    assert np.array_equal(bits_j, bits_t)
    Dj = np.asarray(jm.hamming_matrix(jnp.asarray(d["desc_a"]), jnp.asarray(d["desc_b"])))
    Dt = tm.hamming_matrix(torch.as_tensor(d["desc_a"]), torch.as_tensor(d["desc_b"])).numpy()
    assert np.array_equal(Dj, Dt)


def test_candidate_masks():
    """The dense candidate masks: exact (one compare per entry on the same
    float32 values, except the epipolar band, whose products are rounded
    the same way in both — checked exact on this case)."""
    d = _case(14, 96, 80)
    rng = np.random.default_rng(14)
    ja = {k: jnp.asarray(d[k]) for k in ("xy_a", "xy_b", "level_a", "level_b")}
    ta = {k: torch.as_tensor(d[k]) for k in ja}
    r_row = rng.uniform(20, 300, 96).astype(np.float32)
    for r_j, r_t in ((150.0, 150.0), (jnp.asarray(r_row), torch.as_tensor(r_row))):
        assert np.array_equal(tm.window_mask(ta["xy_a"], ta["xy_b"], r_t).numpy(),
                              np.asarray(jm.window_mask(ja["xy_a"], ja["xy_b"], r_j)))
    assert np.array_equal(
        tm.window_mask_b(ta["xy_a"], ta["xy_b"], torch.as_tensor(d["radius_b"])).numpy(),
        np.asarray(jm.window_mask_b(ja["xy_a"], ja["xy_b"], jnp.asarray(d["radius_b"]))))
    assert np.array_equal(tm.level_mask(ta["level_a"], ta["level_b"], -2, 1).numpy(),
                          np.asarray(jm.level_mask(ja["level_a"], ja["level_b"], -2, 1)))
    F12 = np.array([[0, -0.001, 0.2], [0.001, 0, -1.5], [-0.3, 1.4, 2.0]], np.float32)
    mj = np.asarray(jm.epipolar_mask(jnp.asarray(F12), ja["xy_a"], ja["xy_b"],
                                     ja["level_b"], 1.2))
    mt = tm.epipolar_mask(torch.as_tensor(F12), ta["xy_a"], ta["xy_b"], ta["level_b"], 1.2)
    assert mj.any() and not mj.all()
    assert np.array_equal(mt.numpy(), mj)


def _assert_matches_equal(t, j):
    ok = np.asarray(j.ok)
    assert np.array_equal(t.ok.numpy(), ok)
    assert np.array_equal(t.idx.numpy()[ok], np.asarray(j.idx)[ok])
    assert np.array_equal(t.dist.numpy()[ok], np.asarray(j.dist)[ok])
    return int(ok.sum())


@pytest.mark.parametrize("mutual,ratio", [(False, 1.0), (True, 0.9)])
def test_match_dense_with_angles(mutual, ratio):
    d = _case(8, 256, 200)
    rng = np.random.default_rng(9)
    ang_a = rng.uniform(-np.pi, np.pi, 256).astype(np.float32)
    ang_b = rng.uniform(-np.pi, np.pi, 200).astype(np.float32)
    allowed = rng.random((256, 200)) > 0.3
    kw = dict(max_dist=110.0, ratio=ratio, mutual=mutual)
    j = jm.match(**_j(d, BASE), allowed=jnp.asarray(allowed),
                 angles_a=jnp.asarray(ang_a), angles_b=jnp.asarray(ang_b), **kw)
    t = tm.match(**_t(d, BASE), allowed=torch.as_tensor(allowed),
                 angles_a=torch.as_tensor(ang_a), angles_b=torch.as_tensor(ang_b), **kw)
    assert _assert_matches_equal(t, j) > 0


@pytest.mark.parametrize("seed", [10, 11])
def test_match_windowed(seed):
    d = _case(seed, 256, 128)
    rng = np.random.default_rng(seed)
    # B holds noisy copies of a subset of A near the same positions, so the
    # threshold, ratio and rotation gates all see real matches
    perm = rng.permutation(256)[:128]
    d["desc_b"] = d["desc_a"][perm] ^ (rng.random((128, 32)) < 0.03).astype(np.uint8)
    d["xy_b"] = d["xy_a"][perm] + rng.normal(0, 20, (128, 2)).astype(np.float32)
    d["level_b"] = d["level_a"][perm]
    ang_a = rng.uniform(-np.pi, np.pi, 256).astype(np.float32)
    ang_b = rng.uniform(-np.pi, np.pi, 128).astype(np.float32)
    kw = dict(lvl_lo=-1.0, lvl_hi=1.0, max_dist=100.0, ratio=0.9)
    j = jm.match_windowed(**_j(d, WINDOW), angles_a=jnp.asarray(ang_a),
                          angles_b=jnp.asarray(ang_b), **kw)
    t = tm.match_windowed(**_t(d, WINDOW), angles_a=torch.as_tensor(ang_a),
                          angles_b=torch.as_tensor(ang_b), **kw)
    assert _assert_matches_equal(t, j) > 0


def test_match_epipolar():
    rng = np.random.default_rng(12)
    d = _case(12, 256, 256)
    # a real epipolar geometry: b is a as seen after a sideways camera move
    d["xy_b"] = (d["xy_a"] + np.array([25.0, 0.0], np.float32)
                 + rng.normal(0, 0.5, (256, 2)).astype(np.float32))
    d["desc_b"] = d["desc_a"].copy()
    flip = rng.random((256, 32)) < 0.05
    d["desc_b"][flip] ^= np.uint8(1)
    F12 = np.array([[0, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)  # pure x translation
    keys = ("desc_a", "desc_b", "valid_a", "valid_b", "xy_a", "xy_b", "level_a", "level_b")
    j = jm.match_epipolar(**_j(d, keys), F12=jnp.asarray(F12), scale=1.2, max_dist=100.0)
    t = tm.match_epipolar(**_t(d, keys), F12=torch.as_tensor(F12), scale=1.2, max_dist=100.0)
    assert _assert_matches_equal(t, j) > 50


def test_resolve_duplicates_and_rotation_consistency():
    rng = np.random.default_rng(13)
    n, n_b = 300, 40
    idx = rng.integers(0, n_b, n).astype(np.int32)
    dist = rng.integers(0, 30, n).astype(np.float32)  # many equal distances
    ok = rng.random(n) > 0.3
    mj = jm.Matches(idx=jnp.asarray(idx), dist=jnp.asarray(np.where(ok, dist, 1e9)),
                    ok=jnp.asarray(ok))
    mt = tm.Matches(idx=torch.as_tensor(idx), dist=torch.as_tensor(np.where(ok, dist, 1e9)),
                    ok=torch.as_tensor(ok))
    rj = jm.resolve_duplicates(mj, n_b)
    rt = tm.resolve_duplicates(mt, n_b)
    assert np.array_equal(rt.ok.numpy(), np.asarray(rj.ok))
    ang_a = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    ang_b = rng.uniform(-np.pi, np.pi, n_b).astype(np.float32)
    ang_b[:20] = 0.3  # a dominant rotation bin
    cj = jm._rotation_consistent(jnp.asarray(ok), jnp.asarray(ang_a), jnp.asarray(ang_b),
                                 jnp.asarray(idx), 30)
    ct = tm._rotation_consistent(torch.as_tensor(ok), torch.as_tensor(ang_a),
                                 torch.as_tensor(ang_b), torch.as_tensor(idx), 30)
    assert np.array_equal(ct.numpy(), np.asarray(cj))


def _tie_case(seed, n, m, row_edges, col_edges):
    """A case full of ties: descriptors from a 4-letter byte alphabet (so
    distances repeat), and at every given row edge r two equal rows r-1, r
    that copy one column (the first columns outside the column pairs, in
    order), at every column edge c two equal columns c-1, c that copy one
    row; each pair sits on both sides of its edge, live in every mode."""
    d = _case(seed, n, m)
    rng = np.random.default_rng(seed + 100)
    d["desc_a"] = rng.choice(np.array([0, 1, 3, 255], np.uint8), (n, 32))
    d["desc_b"] = rng.choice(np.array([0, 1, 3, 255], np.uint8), (m, 32))
    d["level_a"][:] = d["level_b"][:] = 0
    pair_rows = {i for r in row_edges for i in (r - 1, r)}
    pair_cols = {j for c in col_edges for j in (c - 1, c)}
    free_cols = iter(j for j in range(m) if j not in pair_cols)
    free_rows = iter(i for i in range(n) if i not in pair_rows)
    for r, c in zip(row_edges, free_cols):
        d["desc_a"][r - 1] = d["desc_a"][r] = d["desc_b"][c]
        d["xy_a"][r - 1] = d["xy_a"][r] = d["xy_b"][c]
        d["valid_a"][r - 1] = d["valid_a"][r] = d["valid_b"][c] = True
    for c, r in zip(col_edges, free_rows):
        d["desc_b"][c - 1] = d["desc_b"][c] = d["desc_a"][r]
        d["xy_b"][c - 1] = d["xy_b"][c] = d["xy_a"][r]
        d["valid_b"][c - 1] = d["valid_b"][c] = d["valid_a"][r] = True
    # epipolar lines through each row's own position: the pairs stay live
    d["lines_a"] = np.stack([np.ones(n), np.zeros(n), -d["xy_a"][:, 0]], 1).astype(np.float32)
    return d


def _first(d, n, m):
    """The first n rows and m columns of a case."""
    a_side = ("desc_a", "valid_a", "xy_a", "level_a", "lines_a")
    return {k: v[:n] if k in a_side else v[:m] for k, v in d.items()}


_NONE, _SHIFT = 0xFFFFFFFF, 23


def _keys(best, arg, offset):
    """Tables of a block -> the kernel's u32 keys (d << 23) | index."""
    b = best.numpy()
    live = b <= 256
    k = (np.where(live, b, 0).astype(np.uint64) << _SHIFT) | (arg.numpy() + offset).astype(np.uint64)
    return np.where(live, k, _NONE).astype(np.uint64)


def _merge_row(k1, s1, k2, s2):
    """csrc/hamming.cu merge_row: (best key, second) over disjoint columns."""
    hi = np.maximum(k1, k2)
    return np.minimum(k1, k2), np.minimum(np.minimum(s1, s2), hi >> _SHIFT)


def _decode(key):
    live = key != _NONE
    return (np.where(live, key >> _SHIFT, 0).astype(np.float32),
            np.where(live, key & ((1 << _SHIFT) - 1), 0).astype(np.int32), live)


@pytest.mark.parametrize("mode", ["window", "none", "epipolar"])
@pytest.mark.parametrize("rows,cols", [(8, 7), (5, 11)])
def test_block_merge_rule_equals_whole_tables(mode, rows, cols):
    """The kernel's merge rule, on the CPU: match_tables_ref over row and
    column blocks that do not divide N and M, merged as csrc/hamming.cu
    merges its partials (row pairs across column blocks, column keys across
    row blocks, any order), equals match_tables_ref over the whole matrix
    exactly, masked entries and their zero argmins included. Equal
    distances and duplicate descriptors straddle the block edges."""
    n, m = 37, 29
    d = _tie_case(3, n, m, row_edges=range(rows, n, rows), col_edges=range(cols, m, cols))
    keys = {"window": WINDOW, "none": BASE, "epipolar": EPI}[mode]
    kw = dict(lvl_lo=-1.0, lvl_hi=1.0, use_window=mode == "window",
              use_epipolar=mode == "epipolar")
    t = _t(d, keys)
    whole = tph.match_tables_ref(**t, **kw)
    row_key = np.full(n, _NONE, np.uint64)
    row_sec = np.full(n, _NONE >> _SHIFT, np.uint64)
    col_key = np.full(m, _NONE, np.uint64)
    col_blocks = list(range(0, m, cols))[::-1]  # merge order does not matter
    for r0 in range(0, n, rows):
        for c0 in col_blocks:
            rs, cs = slice(r0, r0 + rows), slice(c0, c0 + cols)
            part = {k: (v[rs] if k in ("desc_a", "valid_a", "xy_a", "level_a", "lines_a")
                        else v[cs]) for k, v in t.items()}
            p = tph.match_tables_ref(**part, **kw)
            sec = p.row_second.numpy()
            sec = np.where(sec <= 256, sec, _NONE >> _SHIFT).astype(np.uint64)
            row_key[rs], row_sec[rs] = _merge_row(row_key[rs], row_sec[rs],
                                                  _keys(p.row_best, p.row_arg, c0), sec)
            col_key[cs] = np.minimum(col_key[cs], _keys(p.col_best, p.col_arg, r0))
    best, arg, live = _decode(row_key)
    second = np.where(row_sec == _NONE >> _SHIFT, BIG32, row_sec).astype(np.float32)
    assert np.array_equal(np.where(live, best, BIG32), whole.row_best.numpy())
    assert np.array_equal(arg, whole.row_arg.numpy())
    assert np.array_equal(second, whole.row_second.numpy())
    cbest, carg, clive = _decode(col_key)
    assert np.array_equal(np.where(clive, cbest, BIG32), whole.col_best.numpy())
    assert np.array_equal(carg, whole.col_arg.numpy())
    # the ties are real: duplicates give second == best, and columns whose
    # best is held by two rows on both sides of a row-block edge go to the
    # earlier row
    assert live.sum() > n // 2 and (second[live] == best[live]).any()
    held = [j for j in range(m) if j not in {i for c in range(cols, m, cols) for i in (c - 1, c)}]
    held = held[:len(range(rows, n, rows))]
    assert (whole.col_best.numpy()[held] == 0).all()
    assert np.array_equal(whole.col_arg.numpy()[held], np.arange(rows, n, rows) - 1)


BIG32 = np.float32(tph.BIG)


def _float_levels(d, level_a=False, b_shift=0.0):
    """The case with level_b as float32, as the local-map and fuse
    searches pass a predicted level (level_a too if ``level_a``); ``b_shift``
    moves B's levels off the integers."""
    d = dict(d)
    d["level_b"] = d["level_b"].astype(np.float32) + np.float32(b_shift)
    if level_a:
        d["level_a"] = d["level_a"].astype(np.float32)
    return d


@pytest.mark.cuda
def test_cuda_kernel_equals_plain_version():
    """The hand-written kernel against match_tables_ref on the card, at the
    main path's shapes and modes, at tile edges (2047 x 4097, 17 x 9,
    1 x 1) and with duplicates and equal distances straddling the 32-row
    and 128-column tile edges, with levels as int32 and as float32 (the
    local-map and fuse dtypes). Equal everywhere, masked entries included;
    ``launches_by_shape`` counts each call by (mode, N, M)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU/interpret mode)")
    before, by_shape = tph.launches, tph.launches_by_shape.copy()
    cases = [("window", 2048, 4096, _case(0, 2048, 4096)),
             ("window", 2048, 2048, _case(3, 2048, 2048)),
             ("window", 2048, 8192, _case(4, 2048, 8192)),
             ("epipolar", 2048, 2048, _case(1, 2048, 2048)),
             ("none", 1000, 777, _case(2, 1000, 777)),
             ("window", 2047, 4097, _case(5, 2047, 4097)),
             ("window", 17, 9, _case(6, 17, 9)),
             ("none", 1, 1, _first(_case(7, 2, 2), 1, 1)),
             ("none", 300, 700, _tie_case(8, 300, 700, (32, 64, 288), (128, 256, 640))),
             ("window", 300, 700, _tie_case(9, 300, 700, (32, 96), (128, 384))),
             ("epipolar", 300, 700, _tie_case(10, 300, 700, (64, 160), (256, 512))),
             ("window", 2048, 4096, _float_levels(_case(11, 2048, 4096))),
             ("window", 2048, 8192, _float_levels(_case(12, 2048, 8192))),
             ("window", 17, 9, _float_levels(_case(13, 17, 9), level_a=True, b_shift=0.5)),
             ("epipolar", 300, 700, _float_levels(_case(14, 300, 700), level_a=True))]
    for mode, n, m, d in cases:
        keys = {"window": WINDOW, "none": BASE, "epipolar": EPI}[mode]
        args = {k: torch.as_tensor(v).cuda() for k, v in d.items() if k in keys}
        kw = dict(lvl_lo=-2.0, lvl_hi=1.0, use_window=mode == "window",
                  use_epipolar=mode == "epipolar")
        got = tph.match_tables(**args, **kw)
        want = tph.match_tables_ref(**args, **kw)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), (mode, n, m)
    assert tph.launches == before + len(cases)
    added = tph.launches_by_shape - by_shape
    assert added == Counter((mode, n, m) for mode, n, m, _ in cases)
