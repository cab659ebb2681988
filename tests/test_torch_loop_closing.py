"""Parity of the port's place recognition, loop closing and relocalization
with the JAX package, module by module, on the same numpy inputs.

Inputs: the drifted ring of tests/test_loop_closing.py (re-created here:
segment A at ground truth, segment B under an accumulated Sim3 drift and
observing its own drifted copies of the points, the last B keyframe
revisiting the first A viewpoint), the repository's vocabulary file
(orbslamm_tpu/data/vocab_10x4.npz) and a small tree trained by the JAX
package. Random draws of the JAX package are injected into the port
(``idx=`` / ``draw=``). Each tolerance and its reason sits with its test.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslamm_tpu.io.synthetic import fabricate_map
from orbslamm_tpu.models import loop_closing as jlc
from orbslamm_tpu.models import map_state as jms
from orbslamm_tpu.ops import ba as jba
from orbslamm_tpu.ops import bow as jbow
from orbslamm_tpu.ops import geometry as jgeo
from orbslamm_tpu.ops import ransac as jransac
from orbslamm_tpu.ops.orb import Features as JFeatures
from orbslamm_tpu.utils.config import (
    CameraConfig, CapacityConfig, OrbConfig, SlamConfig, TrackingConfig,
)
from orbslamm_tpu_torch import convert
from orbslamm_tpu_torch.io import synthetic as tsynthetic
from orbslamm_tpu_torch.models import loop_closing as tlc
from orbslamm_tpu_torch.ops import ba as tba
from orbslamm_tpu_torch.ops import bow as tbow
from orbslamm_tpu_torch.ops import geometry as tgeo
from orbslamm_tpu_torch.ops import ransac as transac

torch.set_num_threads(2)

VOCAB = Path(__file__).resolve().parents[1] / "orbslamm_tpu" / "data" / "vocab_10x4.npz"
CFG = SlamConfig(
    camera=CameraConfig(width=320, height=240, fx=260, fy=260, cx=160, cy=120),
    orb=OrbConfig(n_features=300, max_keypoints=512, n_levels=4),
    capacity=CapacityConfig(max_keyframes=32, max_landmarks=4096),
    tracking=TrackingConfig(pixel_noise=1.0),
)


def _np(tree):
    return jax.tree.map(np.array, tree)


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _jmap(d):
    return jms.MapState(**{k: jnp.asarray(v) for k, v in d.items()})


def build_drifted_ring(n_kf=16, n_split=11, drift_scale=1.12, seed=0, per_turn=None,
                       device="cpu"):
    """(JAX MapState, the port's MapState on ``device``, T_gt [K,4,4]); as
    tests/test_loop_closing.py. Each package's ``fabricate_map`` builds its
    own map from the same arrays (the two are equal field for field,
    tests/test_torch_package.py). With
    ``per_turn`` < ``n_kf`` keyframes the ring goes round more than once and
    segment B's last ``n_kf - per_turn`` keyframes revisit segment A's first
    viewpoints."""
    rng = np.random.default_rng(seed)
    T_gt = np.zeros((n_kf, 4, 4), np.float32)
    for i in range(n_kf):
        ang = 2 * np.pi * i / (per_turn or n_kf)
        R = np.asarray(jgeo.so3_exp(jnp.asarray([0.0, ang, 0.0], jnp.float32))).T
        C = np.array([3.0 * np.sin(ang), 0.0, -3.0 * np.cos(ang)], np.float32)
        T_gt[i, :3, :3] = R
        T_gt[i, :3, 3] = -R @ C
        T_gt[i, 3, 3] = 1
    n_pts = 1200
    ang_p = rng.uniform(0, 2 * np.pi, n_pts)
    pts = np.stack([10.0 * np.sin(ang_p), rng.uniform(-3, 3, n_pts),
                    -10.0 * np.cos(ang_p)], -1).astype(np.float32)
    desc = rng.integers(0, 256, (n_pts, 32), dtype=np.uint8)
    D = jgeo.sim3_make(jnp.float32(drift_scale),
                       jgeo.so3_exp(jnp.asarray([0.01, 0.05, -0.02], jnp.float32)),
                       jnp.asarray([0.4, 0.1, -0.3], jnp.float32))
    pts_b = np.asarray(jgeo.sim3_apply(D, jnp.asarray(pts)))
    S_inv = jgeo.sim3_inv(D)
    poses = T_gt.copy()
    for i in range(n_split, n_kf):
        S_Tw = jgeo.sim3_compose(jgeo.sim3_from_se3(jnp.asarray(T_gt[i])), S_inv)
        poses[i] = np.asarray(jgeo.sim3_to_se3(S_Tw))
    mask = np.zeros((n_kf, 2 * n_pts), bool)
    mask[:n_split, :n_pts] = True
    mask[n_split:, n_pts:] = True
    refs = np.concatenate([np.zeros(n_pts, np.int32), np.full(n_pts, n_split, np.int32)])
    args = (CFG, poses, np.concatenate([pts, pts_b.astype(np.float32)]),
            np.concatenate([desc, desc]))
    kw = dict(kf_point_mask=mask, seed=seed, point_ref_kf=refs)
    m_j, _ = fabricate_map(*args, **kw)
    m_t, _ = tsynthetic.fabricate_map(*args, **kw, device=device)
    return m_j, m_t, T_gt


@pytest.fixture(scope="module")
def ring():
    m_j, m_t, T_gt = build_drifted_ring()
    return dict(m_j=m_j, m_np=_np(m_j), m_t=m_t, T_gt=T_gt)


@pytest.fixture(scope="module")
def small_voc(ring):
    """A 512-word tree the JAX package trains from the ring's descriptors,
    and both packages' BoW databases of the ring's keyframes."""
    m = ring["m_j"]
    kv = np.asarray(m.kf_valid)
    descs = np.concatenate([np.asarray(m.kf_desc[s])[np.asarray(m.kf_feat_valid[s])]
                            for s in np.nonzero(kv)[0]])
    voc_j = jbow.build_vocabulary(descs, branching=8, depth=3, iters=5)
    voc_t = convert.vocabulary_from_numpy(_np(voc_j), device="cpu")
    slots = np.nonzero(kv)[0].astype(np.int32)
    bow_j = jbow.update_bow_rows(voc_j, m.kf_desc, m.kf_feat_valid,
                                 jnp.zeros((kv.shape[0], voc_j.n_words)), jnp.asarray(slots))
    bow_t = tbow.update_bow_rows(voc_t, ring["m_t"].kf_desc, ring["m_t"].kf_feat_valid,
                                 torch.zeros((kv.shape[0], voc_t.n_words)), slots.tolist())
    return voc_j, voc_t, bow_j, bow_t


def _jax_draw(key):
    """The JAX package's hypothesis draw for a given mask, as the port's
    ``draw`` callable (same key, same mask -> the draw the JAX code makes)."""
    def draw(valid, n_hyp, k):
        return _t(jransac._sample_indices(key, jnp.asarray(valid.numpy()), n_hyp, k))
    return draw


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def test_sim3_geometry():
    """Sim3 family, quat_to_rot, backproject, umeyama (incl. a reflection):
    float32 closed forms, 2e-6 absolute on O(1) values (a few ulps of the
    series/closed-form branches; the tiny-angle and tiny-scale rows hit the
    series branches on both sides)."""
    rng = np.random.default_rng(0)
    xi = (rng.normal(size=(40, 7)) * 0.5).astype(np.float32)
    xi[:5, 3:6] *= 1e-5
    xi[5:10, 6] *= 1e-6
    S_j = jgeo.sim3_exp(jnp.asarray(xi))
    S_t = tgeo.sim3_exp(_t(xi))
    np.testing.assert_allclose(S_t.numpy(), np.asarray(S_j), atol=2e-6)
    a = np.asarray(S_j)
    b = np.roll(a, 3, 0)
    pairs = [
        (jgeo.sim3_log(jnp.asarray(a)), tgeo.sim3_log(_t(a))),
        (jgeo.sim3_compose(jnp.asarray(a), jnp.asarray(b)), tgeo.sim3_compose(_t(a), _t(b))),
        (jgeo.sim3_inv(jnp.asarray(a)), tgeo.sim3_inv(_t(a))),
        (jgeo.sim3_to_se3(jnp.asarray(a)), tgeo.sim3_to_se3(_t(a))),
        (jgeo.quat_to_rot(jnp.asarray(a[:, :4])), tgeo.quat_to_rot(_t(a[:, :4]))),
    ]
    T = np.asarray(jgeo.sim3_to_se3(jnp.asarray(a)))
    pairs.append((jgeo.sim3_from_se3(jnp.asarray(T)), tgeo.sim3_from_se3(_t(T))))
    pts = rng.normal(size=(40, 3)).astype(np.float32)
    pairs.append((jax.vmap(jgeo.sim3_apply)(jnp.asarray(a), jnp.asarray(pts)),
                  tgeo.sim3_apply(_t(a), _t(pts))))
    pairs.append((jgeo.sim3_apply(jnp.asarray(a[0]), jnp.asarray(pts)),
                  tgeo.sim3_apply(_t(a[0]), _t(pts))))
    s, R, t = jgeo.sim3_parts(jnp.asarray(a))
    pairs.append((jgeo.sim3_make(s, R, t), tgeo.sim3_make(*(_t(x) for x in (s, R, t)))))
    Kmat = CFG.camera.K()
    uv = rng.uniform(0, 300, (40, 2)).astype(np.float32)
    dep = rng.uniform(1, 9, 40).astype(np.float32)
    pairs.append((jgeo.backproject(jnp.asarray(Kmat), jnp.asarray(uv), jnp.asarray(dep)),
                  tgeo.backproject(_t(Kmat), _t(uv), _t(dep))))
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-6)
    np.testing.assert_array_equal(tgeo.sim3_identity((2,), device="cpu").numpy(),
                                  np.asarray(jgeo.sim3_identity((2,))))
    # umeyama: a proper rotation, and a mirrored target that forces the
    # determinant fix (both packages return the nearest proper rotation)
    src = rng.normal(size=(60, 3)).astype(np.float32)
    Rg = np.asarray(jgeo.so3_exp(jnp.asarray([0.1, -0.4, 0.3])))
    mask = rng.random(60) > 0.2
    for dst in (1.3 * src @ Rg.T + 0.5, src * np.array([1, 1, -1], np.float32)):
        dst = dst.astype(np.float32)
        for ws in (True, False):
            want = jgeo.umeyama_alignment(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask),
                                          with_scale=ws)
            got = tgeo.umeyama_alignment(_t(src), _t(dst), _t(mask), with_scale=ws)
            for w_, g_ in zip(want, got):
                np.testing.assert_allclose(g_.numpy(), np.asarray(w_), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("n", [37, 38, 1])
def test_nanmedian_matches_jax(n):
    """``jnp.nanmedian`` averages the two middle values of an even count
    (``torch.nanmedian`` takes the lower); exact up to one rounding."""
    rng = np.random.default_rng(n)
    x = rng.random(n).astype(np.float32)
    ok = rng.random(n) > 0.4
    ok[0] = True
    want = float(jnp.nanmedian(jnp.where(jnp.asarray(ok), jnp.asarray(x), jnp.nan)))
    assert float(tlc._nanmedian(_t(x), _t(ok))) == pytest.approx(want, rel=1e-7)
    assert torch.isnan(tlc._nanmedian(_t(x), torch.zeros(n, dtype=torch.bool)))


# ---------------------------------------------------------------------------
# BoW
# ---------------------------------------------------------------------------

def test_vocabulary_file_words_exact(ring, tmp_path):
    """The repository's 10^4-word file: loaded by both packages, word ids
    of every ring keyframe exact (integer Hamming sums, first-minimum
    argmin); tf-idf rows within 1e-6 (float32 sums in another order);
    save/load round trip exact."""
    voc_j = jbow.load_vocabulary_npz(VOCAB)
    voc_t = tbow.load_vocabulary_npz(VOCAB, device="cpu")
    assert (voc_t.branching, voc_t.depth, voc_t.n_words) == (10, 4, 10 ** 4)
    m_j, m_t = ring["m_j"], ring["m_t"]
    words_t = tbow.assign_words(voc_t, m_t.kf_desc[:16], m_t.kf_feat_valid[:16])
    words_j = jax.vmap(lambda d, v: jbow.assign_words(voc_j, d, v))(
        m_j.kf_desc[:16], m_j.kf_feat_valid[:16])
    assert np.array_equal(words_t.numpy(), np.asarray(words_j))
    assert (words_t.numpy() >= 0).sum() > 1000
    rows_t = tbow.bow_vector(voc_t, words_t)
    rows_j = jax.vmap(lambda w: jbow.bow_vector(voc_j, w))(words_j)
    np.testing.assert_allclose(rows_t.numpy(), np.asarray(rows_j), atol=1e-6)
    tbow.save_vocabulary_npz(voc_t, tmp_path / "v.npz")
    back = jbow.load_vocabulary_npz(tmp_path / "v.npz")
    assert np.array_equal(np.asarray(back.nodes), np.asarray(voc_j.nodes))
    assert np.array_equal(np.asarray(back.idf), np.asarray(voc_j.idf))
    assert back.node_valid is None and voc_t.node_valid is None


def test_small_tree_words_and_scores(ring, small_voc):
    """A JAX-trained 8^3 tree: word ids exact, database rows within 1e-6,
    bow_score within 1e-5 (L1 sums over the vocabulary in another order)."""
    voc_j, voc_t, bow_j, bow_t = small_voc
    m_j, m_t = ring["m_j"], ring["m_t"]
    for s in (0, 7, 15):
        w_j = jbow.assign_words(voc_j, m_j.kf_desc[s], m_j.kf_feat_valid[s])
        w_t = tbow.assign_words(voc_t, m_t.kf_desc[s], m_t.kf_feat_valid[s])
        assert np.array_equal(w_t.numpy(), np.asarray(w_j))
    np.testing.assert_allclose(bow_t.numpy(), np.asarray(bow_j), atol=1e-6)
    sc_j = jbow.bow_score(bow_j[15], bow_j)
    sc_t = tbow.bow_score(bow_t[15], bow_t)
    np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), atol=1e-5)
    assert float(tbow.bow_score(bow_t[3], bow_t[4])) == pytest.approx(
        float(jbow.bow_score(bow_j[3], bow_j[4])), abs=1e-5)


def test_dbow2_text_vocabulary(tmp_path):
    """DBoW2 text format with an incomplete tree: nodes, validity and idf
    exact (the same numpy walk), word ids exact."""
    rng = np.random.default_rng(2)
    lines, frontier, n = ["5 4 0 0"], [0], 0
    for level in range(4):  # random fan-out, early leaves above the bottom
        nxt = []
        for node in frontier:
            for _ in range(5 if level == 0 else int(rng.integers(1, 6))):
                n += 1
                leaf = level == 3 or rng.random() < 0.25
                d = " ".join(str(int(x)) for x in rng.integers(0, 256, 32))
                lines.append(f"{node} {int(leaf)} {d} {rng.uniform(0.1, 3.0) if leaf else 0.0:.6f}")
                if not leaf:
                    nxt.append(n)
        frontier = nxt
    p = tmp_path / "voc.txt"
    p.write_text("\n".join(lines) + "\n")
    voc_j = jbow.load_orb_vocabulary_text(p, max_depth=3)
    voc_t = tbow.load_orb_vocabulary_text(p, max_depth=3, device="cpu")
    assert np.array_equal(voc_t.nodes.numpy(), np.asarray(voc_j.nodes))
    assert np.array_equal(voc_t.node_valid.numpy(), np.asarray(voc_j.node_valid))
    assert np.array_equal(voc_t.idf.numpy(), np.asarray(voc_j.idf))
    rng = np.random.default_rng(3)
    desc = rng.integers(0, 256, (200, 32), dtype=np.uint8)
    valid = rng.random(200) > 0.1
    assert np.array_equal(
        tbow.assign_words(voc_t, _t(desc), _t(valid)).numpy(),
        np.asarray(jbow.assign_words(voc_j, jnp.asarray(desc), jnp.asarray(valid))))
    # a tree trained from the same descriptors is complete (no node
    # validity) and assigns every valid descriptor a word
    trained = tbow.build_vocabulary(desc, branching=5, depth=3, iters=3, device="cpu")
    assert trained.node_valid is None and trained.nodes.shape == (5 + 25 + 125, 32)
    words = tbow.assign_words(trained, _t(desc), _t(valid)).numpy()
    assert ((words >= 0) == valid).all() and words.max() < 125


# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("min_gap", [3, 10])
def test_loop_candidates_and_groups(ring, small_voc, min_gap):
    """Admissibility masks exact; scores and minScore within 1e-5; group
    accumulation within 1e-5 and group membership exact; the surviving
    (>= 0.75 x best) groups exact where no candidate sits within 1e-4 of
    the boundary."""
    _, _, bow_j, bow_t = small_voc
    m_j, m_t = ring["m_j"], ring["m_t"]
    slots = [12, 15]
    sc_j, al_j, mn_j = jlc.batched_loop_candidates(CFG, m_j, bow_j, jnp.asarray(slots, jnp.int32),
                                                   min_gap=min_gap)
    sc_t, al_t, mn_t = tlc.batched_loop_candidates(CFG, m_t, bow_t, slots, min_gap=min_gap)
    assert np.array_equal(al_t.numpy(), np.asarray(al_j))
    np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), atol=1e-5)
    np.testing.assert_allclose(mn_t.numpy(), np.asarray(mn_j), atol=1e-5)
    s1, a1, m1 = tlc.loop_candidates(CFG, m_t, bow_t, 15, min_gap=min_gap)
    assert torch.equal(a1, al_t[1]) and float(m1) == float(mn_t[1])
    for i in range(len(slots)):
        masked = np.asarray(jnp.where(al_j[i], sc_j[i], -1.0))
        acc_j, nb_j = jlc.candidate_groups(CFG, m_j, jnp.asarray(masked))
        acc_t, nb_t = tlc.candidate_groups(CFG, m_t, torch.where(al_t[i], sc_t[i], -1.0))
        assert np.array_equal(nb_t.numpy(), np.asarray(nb_j))
        np.testing.assert_allclose(acc_t.numpy(), np.asarray(acc_j), atol=1e-5)
        acc = np.asarray(acc_j)
        if acc.max() > 0:
            far = np.abs(acc - 0.75 * acc.max()) > 1e-4
            assert np.array_equal((acc_t.numpy() > 0)[far], (acc > 0)[far])


# ---------------------------------------------------------------------------
# RANSAC, refinement, verification
# ---------------------------------------------------------------------------

def _sim3_problem(seed=1, n=120, outliers=30):
    rng = np.random.default_rng(seed)
    p1 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(3, 8, n)], -1).astype(np.float32)
    S = np.asarray(jgeo.sim3_make(jnp.float32(0.9), jgeo.so3_exp(jnp.asarray([0.02, 0.1, -0.03])),
                                  jnp.asarray([0.2, -0.1, 0.3])))
    p2 = np.asarray(jgeo.sim3_apply(jnp.asarray(S), jnp.asarray(p1)))
    p2 = p2 + rng.normal(scale=0.003, size=p2.shape).astype(np.float32)
    p2[:outliers] += rng.normal(scale=0.8, size=(outliers, 3)).astype(np.float32)
    valid = rng.random(n) > 0.1
    return p1, p2.astype(np.float32), valid, S


@pytest.mark.parametrize("fix_scale", [False, True])
def test_sim3_ransac_and_refine(fix_scale):
    """JAX's hypotheses injected: success and inlier masks exact, S within
    1e-4 (SVD of 3x3 covariances in float32); sim3_refine from the winner:
    inliers exact, S within 1e-4 (7x7 LM solves)."""
    p1, p2, valid, _ = _sim3_problem()
    K = CFG.camera.K()
    key = jax.random.key(4)
    want = jransac.sim3_ransac(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid),
                               jnp.asarray(K), jnp.asarray(K), key, n_hyp=128,
                               fix_scale=fix_scale)
    idx = _t(jransac._sample_indices(key, jnp.asarray(valid), 128, 3))
    got = transac.sim3_ransac(_t(p1), _t(p2), _t(valid), _t(K), _t(K), n_hyp=128,
                              fix_scale=fix_scale, idx=idx)
    assert bool(got.success) == bool(want.success)
    assert np.array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    np.testing.assert_allclose(got.S21.numpy(), np.asarray(want.S21), atol=1e-4)
    S0 = np.asarray(want.S21) + np.array([0, 0, 0, 0, 0.01, -0.01, 0.02, 0.01], np.float32)
    r_j = jba.sim3_refine(jnp.asarray(S0), jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid),
                          jnp.asarray(K), jnp.asarray(K), fix_scale=fix_scale)
    r_t = tba.sim3_refine(_t(S0), _t(p1), _t(p2), _t(valid), _t(K), _t(K), fix_scale=fix_scale)
    assert np.array_equal(r_t.inliers.numpy(), np.asarray(r_j.inliers))
    np.testing.assert_allclose(r_t.S.numpy(), np.asarray(r_j.S), atol=1e-4)


def test_pnp_ransac():
    """JAX's hypotheses injected: success and inliers exact, T within 1e-4
    (12x12 SVD null vectors, sign normalized through the cheirality flip)."""
    rng = np.random.default_rng(5)
    n = 150
    pw = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 10, n)],
                  -1).astype(np.float32)
    T = np.asarray(jgeo.se3_exp(jnp.asarray([0.1, -0.05, 0.2, 0.03, -0.06, 0.02])))
    K = CFG.camera.K()
    pc = pw @ T[:3, :3].T + T[:3, 3]
    uv = (pc[:, :2] / pc[:, 2:]) * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
    uv = (uv + rng.normal(scale=0.3, size=uv.shape)).astype(np.float32)
    uv[:20] += rng.uniform(-40, 40, (20, 2)).astype(np.float32)
    valid = rng.random(n) > 0.1
    key = jax.random.key(9)
    want = jransac.pnp_ransac(jnp.asarray(pw), jnp.asarray(uv), jnp.asarray(valid),
                              jnp.asarray(K), key)
    idx = _t(jransac._sample_indices(key, jnp.asarray(valid), 128, 6))
    got = transac.pnp_ransac(_t(pw), _t(uv), _t(valid), _t(K), idx=idx)
    assert bool(got.success) == bool(want.success) is True
    assert np.array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    np.testing.assert_allclose(got.T_cw.numpy(), np.asarray(want.T_cw), atol=1e-4)


def test_compute_loop_sim3(ring):
    """Keyframe 15 against 0 (the revisit), JAX's draw injected: success
    and inlier count equal, S within 1e-4."""
    key = jax.random.key(0)
    want = jlc.compute_loop_sim3(CFG, ring["m_j"], jnp.int32(15), jnp.int32(0), key)
    got = tlc.compute_loop_sim3(CFG, ring["m_t"], 15, 0, draw=_jax_draw(key))
    assert bool(want.success) and bool(got.success)
    assert int(got.n_inliers) == int(want.n_inliers)
    np.testing.assert_allclose(got.S_ba.numpy(), np.asarray(want.S_ba), atol=1e-4)
    # the drift scale is recovered (KF15 camera -> KF0 camera, 1 / 1.12)
    assert float(torch.exp(got.S_ba[7])) == pytest.approx(1 / 1.12, abs=0.02)


# ---------------------------------------------------------------------------
# correction
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def loop_sim3(ring):
    return np.array(jlc.compute_loop_sim3(CFG, ring["m_j"], jnp.int32(15), jnp.int32(0),
                                          jax.random.key(0)).S_ba)


def test_essential_graph_edges_exact(ring, loop_sim3):
    """The pose graph's edges against the JAX package's primitives
    (spanning_parent, covisibility, ``lax.top_k`` over the upper triangle
    with its lower-index-first ties): edge endpoints, validity and weights
    exact; measurements within 1e-5."""
    m_j = ring["m_j"]
    K = m_j.kf_pose.shape[0]
    prob, le = tlc.essential_graph(CFG, ring["m_t"], 15, 0, _t(loop_sim3))
    parent = np.asarray(jms.spanning_parent(m_j))
    W = jms.covisibility(m_j)
    flat = (jnp.triu(W, k=1) * m_j.kf_valid[:, None] * m_j.kf_valid[None, :]).reshape(-1)
    _, top = jax.lax.top_k(flat, 256)
    top = np.asarray(top)
    E = m_j.loop_edges.shape[0]
    # the new edge is recorded in the table's first free row, which the
    # graph then lists (as invalid) among the past loop edges
    past_i, past_j = np.zeros(E, int), np.zeros(E, int)
    past_i[0] = 15
    ei = np.concatenate([np.arange(K), top // K, past_i, [15]])
    ej = np.concatenate([np.maximum(parent, 0), top % K, past_j, [0]])
    ok = np.concatenate([(parent >= 0) & np.asarray(m_j.kf_valid),
                         np.asarray(flat)[top] >= CFG.loop.essential_graph_min_weight,
                         np.zeros(E, bool), [True]])
    assert np.array_equal(prob.edge_i.numpy(), ei)
    assert np.array_equal(prob.edge_j.numpy(), ej)
    assert np.array_equal(prob.edge_valid.numpy(), ok)
    assert ok[K:K + 256].sum() > 5  # strong covisibility edges exist
    w = np.ones(len(ei), np.float32)
    w[-1] = 5.0
    assert np.array_equal(prob.edge_weight.numpy(), w)
    assert le[0].tolist() == [15, 0] and (le[1:, 0] == -1).all()
    S_old = jax.vmap(jgeo.sim3_from_se3)(m_j.kf_pose)
    M = jax.vmap(lambda i, j: jgeo.sim3_compose(S_old[i], jgeo.sim3_inv(S_old[j])))(
        jnp.asarray(ei[:-1]), jnp.asarray(ej[:-1]))
    np.testing.assert_allclose(prob.edge_Sij[:-1].numpy(), np.asarray(M), atol=1e-5)


def test_pose_graph_optimize(ring, loop_sim3):
    """One pose graph through both optimizers (the port's problem, carried
    to JAX by the converters): keyframe positions within 1e-3 (20 LM x 50
    CG float32 iterations; the CG's dot products sum in another order)."""
    prob_t, _ = tlc.essential_graph(CFG, ring["m_t"], 15, 0, _t(loop_sim3))
    d = convert.pose_graph_to_numpy(prob_t)
    S_j = jba.pose_graph_optimize(jba.PoseGraphProblem(**{k: jnp.asarray(v) for k, v in d.items()}),
                                  iters=20, cg_iters=50)
    S_t = tba.pose_graph_optimize(convert.pose_graph_from_numpy(d, device="cpu"),
                                  iters=20, cg_iters=50)
    T_j = np.asarray(jax.vmap(jgeo.sim3_to_se3)(S_j))
    T_t = tgeo.sim3_to_se3(S_t).numpy()
    C_j = -np.einsum("kji,kj->ki", T_j[:, :3, :3], T_j[:, :3, 3])
    C_t = -np.einsum("kji,kj->ki", T_t[:, :3, :3], T_t[:, :3, 3])
    np.testing.assert_allclose(C_t[:16], C_j[:16], atol=1e-3)
    T0 = tgeo.sim3_to_se3(prob_t.S_iw).numpy()
    C0 = -np.einsum("kji,kj->ki", T0[:, :3, :3], T0[:, :3, 3])
    assert np.abs(C_t[11:16] - C0[11:16]).max() > 0.05  # the graph did move segment B


def _kf_pose_err(kf_pose, T_gt):
    C = -np.einsum("kji,kj->ki", kf_pose[:16, :3, :3], kf_pose[:16, :3, 3])
    Cg = -np.einsum("kji,kj->ki", T_gt[:, :3, :3], T_gt[:, :3, 3])
    return np.linalg.norm(C - Cg, axis=1)


def test_correct_loop(ring, loop_sim3):
    """correct_loop with JAX's loop Sim3: keyframe positions within 1e-3,
    landmark positions within 1e-3 relative to their 10 m scale (both ride
    the pose graph's float32 solve), loop-edge table exact, and the drift
    pulled back on both sides."""
    m_j = jlc.correct_loop(CFG, ring["m_j"], jnp.int32(15), jnp.int32(0), jnp.asarray(loop_sim3))
    m_t = tlc.correct_loop(CFG, ring["m_t"], 15, 0, _t(loop_sim3))
    np.testing.assert_allclose(m_t.kf_pose.numpy(), np.asarray(m_j.kf_pose), atol=1e-3)
    lv = np.asarray(m_j.lm_valid)
    np.testing.assert_allclose(m_t.lm_pos.numpy()[lv], np.asarray(m_j.lm_pos)[lv], atol=1e-2,
                               rtol=1e-3)
    np.testing.assert_allclose(m_t.lm_normal.numpy()[lv], np.asarray(m_j.lm_normal)[lv],
                               atol=1e-3)
    np.testing.assert_allclose(m_t.lm_dist_max.numpy()[lv], np.asarray(m_j.lm_dist_max)[lv],
                               rtol=1e-3)
    assert np.array_equal(m_t.loop_edges.numpy(), np.asarray(m_j.loop_edges))
    before = _kf_pose_err(ring["m_np"].kf_pose, ring["T_gt"])
    after = _kf_pose_err(m_t.kf_pose.numpy(), ring["T_gt"])
    assert after[11:].max() < 0.5 * before[11:].max()


def test_global_bundle_adjust(ring, loop_sim3):
    """Two GBA slices (2 LM x 16 CG, as the session schedules them) on the
    corrected map: cost within 1e-3 relative, keyframe poses within 1e-3
    (float32 segment sums in another order). The BA problem converts both
    ways."""
    m_j = jlc.correct_loop(CFG, ring["m_j"], jnp.int32(15), jnp.int32(0), jnp.asarray(loop_sim3))
    m_t = convert.map_state_from_numpy(_np(m_j)._asdict(), device="cpu")
    g_j, cost_j = jlc.global_bundle_adjust(CFG, m_j, iters=2, cg_iters=16)
    g_t, cost_t = tlc.global_bundle_adjust(CFG, m_t, iters=2, cg_iters=16)
    assert float(cost_t) == pytest.approx(float(cost_j), rel=1e-3)
    np.testing.assert_allclose(g_t.kf_pose.numpy(), np.asarray(g_j.kf_pose), atol=1e-3)
    lv = np.asarray(g_j.lm_valid)
    np.testing.assert_allclose(g_t.lm_pos.numpy()[lv], np.asarray(g_j.lm_pos)[lv], atol=1e-2)


def test_bundle_adjust_cg_and_converters(ring):
    """bundle_adjust_cg directly on a converted BAProblem (a perturbed ring
    camera, every observation): cost within 1e-3 relative, poses within
    1e-3, final inlier classification >= 99.9 % equal (chi2 gates on
    float32 residuals)."""
    m = ring["m_np"]
    K, M = m.kf_obs_lm.shape
    ok = m.kf_feat_valid & (m.kf_obs_lm >= 0) & m.kf_valid[:, None]
    T = m.kf_pose.copy()
    T[5, :3, 3] += np.array([0.05, -0.03, 0.02], np.float32)
    d = dict(T_cw=T, K=m.kf_K, cam_valid=m.kf_valid, cam_fixed=m.kf_fixed,
             points=m.lm_pos, point_valid=m.lm_valid,
             obs_cam=np.repeat(np.arange(K, dtype=np.int32), M),
             obs_point=np.maximum(m.kf_obs_lm, 0).reshape(-1),
             obs_uv=m.kf_xy.reshape(-1, 2),
             obs_sigma2=np.full(K * M, 1.0, np.float32), obs_valid=ok.reshape(-1))
    p_t = convert.ba_problem_from_numpy(d, device="cpu")
    assert p_t.obs_ur is None and p_t.bf is None
    back = convert.ba_problem_to_numpy(p_t)
    p_j = jba.BAProblem(**{k: (None if v is None else jnp.asarray(v)) for k, v in back.items()})
    r_j = jba.bundle_adjust_cg(p_j, iters=4, cg_iters=20)
    r_t = tba.bundle_adjust_cg(p_t, iters=4, cg_iters=20)
    assert float(r_t.cost) == pytest.approx(float(r_j.cost), rel=1e-3)
    np.testing.assert_allclose(r_t.T_cw.numpy(), np.asarray(r_j.T_cw), atol=1e-3)
    assert (r_t.obs_inlier.numpy() == np.asarray(r_j.obs_inlier)).mean() >= 0.999


# ---------------------------------------------------------------------------
# relocalization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slot, succeeds", [(13, True), (3, False)])
def test_relocalize_against_kf(ring, small_voc, slot, succeeds):
    """A frame made from keyframe ``slot``'s features (positions moved by
    0.3 px) relocalized against it, JAX's draw injected: success, inlier
    count and landmark associations exact, pose within 1e-4 when it
    succeeds (on keyframe 3 the PnP draw fails in both packages alike);
    the database scores of its BoW vector within 1e-5."""
    m_np = ring["m_np"]
    rng = np.random.default_rng(slot)
    xy = (m_np.kf_xy[slot] + rng.normal(scale=0.3, size=m_np.kf_xy[slot].shape)).astype(np.float32)
    f = dict(xy=xy, xy_raw=xy, angle=m_np.kf_angle[slot], response=np.ones_like(xy[:, 0]),
             level=m_np.kf_level[slot], desc=m_np.kf_desc[slot], valid=m_np.kf_feat_valid[slot])
    feats_j = JFeatures(**{k: jnp.asarray(v) for k, v in f.items()})
    feats_t = convert.features_from_numpy(f, device="cpu")
    K = CFG.camera.K()
    key = jax.random.key(slot)
    ok_j, T_j, fl_j, n_j = jlc.relocalize_against_kf(CFG, ring["m_j"], feats_j, jnp.asarray(K),
                                                     jnp.int32(slot), key)
    ok_t, T_t, fl_t, n_t = tlc.relocalize_against_kf(CFG, ring["m_t"], feats_t, _t(K), slot,
                                                     draw=_jax_draw(key))
    assert bool(ok_t) == bool(ok_j) == succeeds
    assert int(n_t) == int(n_j)
    assert np.array_equal(fl_t.numpy(), np.asarray(fl_j))
    if succeeds:
        np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-4)
    voc_j, voc_t, bow_j, bow_t = small_voc
    v_j = jbow.bow_vector(voc_j, jbow.assign_words(voc_j, feats_j.desc, feats_j.valid))
    v_t = tbow.bow_vector(voc_t, tbow.assign_words(voc_t, feats_t.desc, feats_t.valid))
    np.testing.assert_allclose(
        tlc.relocalization_candidates(CFG, ring["m_t"], bow_t, v_t).numpy(),
        np.asarray(jlc.relocalization_candidates(CFG, ring["m_j"], bow_j, v_j)), atol=1e-5)


# ---------------------------------------------------------------------------
# the session's detection entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_try_close_loop_matches_jax(monkeypatch, device):
    """``MapContext.try_close_loop`` of both packages on a ring that goes
    round 1.3 times (segment B's keyframes 15-19 revisit segment A's first
    viewpoints under the drift, sharing no landmark with them), with the
    repository's vocabulary file and the default loop gap: keyframes 12-19
    in turn, each fed the JAX package's ``loop_scan`` scores, JAX's Sim3
    draw injected. The chains grow over keyframes 13-16 and keyframe 16's
    candidate verifies. (15.5 keyframes per turn put each revisit between
    two outbound viewpoints: at a zero baseline the Sim3 scale leaves the
    projections unchanged, so sim3_refine's scale step is float32 noise in
    either package.)
    Exact: the return of every call, the consistency chains after it (group
    members and counts), the candidates handed to Sim3 verification in
    order, and the closed loop (slot, candidate, inliers). The port's own
    ``loop_scan`` within 1e-5 (L1 sums in another order). Keyframe poses
    after the correction and its GBA slice within 1e-3, as correct_loop.
    Both packages' Tracers record the same ``loop_detect`` and
    ``loop_correct`` span counts, ``loops_closed`` counter and
    ``loop_closed`` events (the host clock's ``t`` aside).
    The ``cuda`` case runs the port on the card (float scatter sums in
    any order there)."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from orbslamm_tpu.models import system as jsys
    from orbslamm_tpu.utils.trace import get_tracer as jax_tracer
    from orbslamm_tpu_torch.models import system as tsys
    from orbslamm_tpu_torch.utils.trace import get_tracer as port_tracer

    m_j, m_t, _ = build_drifted_ring(n_kf=20, per_turn=15.5, device=device)
    n_kf = int(np.asarray(m_j.kf_valid).sum())
    mj = jsys.MapContext(CFG, jbow.load_vocabulary_npz(str(VOCAB)))
    mt = tsys.MapContext(CFG, tbow.load_vocabulary_npz(str(VOCAB), device=device), device=device)
    mj.map, mj.n_kf = m_j, n_kf
    mt.map, mt.n_kf = m_t, n_kf
    mj.update_bow_rows(list(range(n_kf)))
    mt.update_bow_rows(list(range(n_kf)))

    key = jax.random.key(3)
    verified_j, verified_t = [], []
    j_sim3, t_sim3 = jlc.compute_loop_sim3, tlc.compute_loop_sim3

    def j_verify(cfg_, m, a, b, _key):
        verified_j.append((int(a), int(b)))
        return j_sim3(cfg_, m, a, b, key)

    def t_verify(cfg_, m, a, b, _generator):
        verified_t.append((int(a), int(b)))
        return t_sim3(cfg_, m, a, b, draw=lambda valid, n_hyp, k: _jax_draw(key)(
            valid.cpu(), n_hyp, k).to(valid.device))

    monkeypatch.setattr(jlc, "compute_loop_sim3", j_verify)
    monkeypatch.setattr(tlc, "compute_loop_sim3", t_verify)

    jax_tracer().reset()
    port_tracer().reset()
    slots = list(range(12, n_kf))
    pre = mj.loop_scan(slots)
    pre_t = mt.loop_scan(slots)
    for s in slots:
        np.testing.assert_allclose(pre_t[s][0], pre[s][0], atol=1e-5)
        assert pre_t[s][1] == pytest.approx(pre[s][1], abs=1e-5)
    chains, closed = [], []
    for s in slots:
        r_j = mj.try_close_loop(s, key, precomputed=pre[s])
        r_t = mt.try_close_loop(s, torch.Generator(device=device).manual_seed(0),
                                precomputed=pre[s])
        assert r_t == r_j
        c_j = [(sorted(g), n) for g, n in mj._consist]
        assert [(sorted(g), n) for g, n in mt._consist] == c_j
        chains.append(c_j)
        closed.append(r_j)
    # a chain reached the consistency count and its candidate verified
    assert any(closed), (chains, verified_j)
    assert verified_j and verified_t == verified_j
    assert len(mj.loops_closed) == 1 and mt.loops_closed == mj.loops_closed
    assert mt.gba_slices_run == 1 and mt.gba_remaining == mj.gba_remaining
    np.testing.assert_allclose(mt.map.kf_pose.cpu().numpy(), np.asarray(mj.map.kf_pose),
                               atol=1e-3)
    rep_j, rep_t = jax_tracer().report(), port_tracer().report()
    counts = {k: v["count"] for k, v in rep_j["stages"].items()}
    assert {k: v["count"] for k, v in rep_t["stages"].items()} == counts
    assert counts["loop_correct"] == 1 and counts["loop_detect"] >= 1
    assert rep_t["counters"] == rep_j["counters"] == {"loops_closed": 1.0}

    def no_clock(events):
        return [{k: v for k, v in e.items() if k != "t"} for e in events]

    assert no_clock(port_tracer().events()) == no_clock(jax_tracer().events())
    assert [e["kind"] for e in port_tracer().events()] == ["loop_closed"]


@pytest.mark.cuda
def test_cuda_null_vectors_hold_float32():
    """On the card, the 8-point and DLT null vectors of low-parallax
    systems stay within 1e-5 (relative, sign-free) of a float64 solve of the
    same float32 inputs: the port solves them in float64. In float32 the
    card's batched SVD gave an F up to 1.5 % away from the JAX package's on
    the same inputs (NVIDIA H100)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(11)
    n = 200
    x1 = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    x2 = (x1 + rng.normal(scale=2e-3, size=x1.shape)).astype(np.float32)  # tiny parallax
    idx = torch.as_tensor(rng.integers(0, n, (512, 8)))
    got = transac._eight_point(_t(x1).cuda(), _t(x2).cuda(), idx.cuda()).cpu().numpy()
    want = transac._eight_point(_t(x1).double(), _t(x2).double(), idx).numpy()
    g = got / np.linalg.norm(got, axis=(1, 2), keepdims=True)
    w = want / np.linalg.norm(want, axis=(1, 2), keepdims=True)
    err = np.minimum(np.abs(g - w).max(axis=(1, 2)), np.abs(g + w).max(axis=(1, 2)))
    assert np.median(err) < 1e-5, np.median(err)
