"""Parity of the port's multi-map path with the JAX package, on the same
numpy inputs: vocabulary training, value-aware landmark slots, the seam
fuse, the cross-map scan and Sim3, ``merge_maps``, ``MultiMapper._do_merge``
and the MultiMapper's host logic.

Inputs: tests/test_multimap.py's two overlapping maps (map A on a ring
sector at ground truth, map B on the next sector in its own Sim3-warped
world, two views shared), each package building its own map with its own
``fabricate_map`` from the same arrays. Random draws of the JAX package are
injected into the port (``draws=`` / ``draw=``). Each tolerance and its
reason sits with its test.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslamm_tpu.io.synthetic import fabricate_map
from orbslamm_tpu.models import local_mapping as jlm
from orbslamm_tpu.models import loop_closing as jlc
from orbslamm_tpu.models import map_state as jms
from orbslamm_tpu.models import multimap as jmm
from orbslamm_tpu.models import system as jsys
from orbslamm_tpu.ops import bow as jbow
from orbslamm_tpu.ops import geometry as jgeo
from orbslamm_tpu.ops import ransac as jransac
from orbslamm_tpu.utils.config import (
    CameraConfig, CapacityConfig, OrbConfig, SlamConfig, TrackingConfig,
)
from orbslamm_tpu_torch import convert
from orbslamm_tpu_torch.io import synthetic as tsynthetic
from orbslamm_tpu_torch.models import local_mapping as tlm
from orbslamm_tpu_torch.models import loop_closing as tlc
from orbslamm_tpu_torch.models import map_state as tms
from orbslamm_tpu_torch.models import multimap as tmm
from orbslamm_tpu_torch.models import system as tsys
from orbslamm_tpu_torch.ops import bow as tbow

torch.set_num_threads(2)

CFG = SlamConfig(
    camera=CameraConfig(width=320, height=240, fx=260, fy=260, cx=160, cy=120),
    orb=OrbConfig(n_features=300, max_keypoints=512, n_levels=4),
    capacity=CapacityConfig(max_keyframes=32, max_landmarks=4096),
    tracking=TrackingConfig(pixel_noise=1.0),
)
N_A = N_B = 8


def _np(tree):
    return jax.tree.map(np.array, tree)


def _t(a, dtype=None, device="cpu"):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def _jmap(d):
    return jms.MapState(**{k: jnp.asarray(v) for k, v in d.items()})


def _tmap(d, device="cpu"):
    return convert.map_state_from_numpy(d, device=device)


def _jax_draw(key):
    """The JAX package's hypothesis draw for a mask, as the port's ``draw``."""
    def draw(valid, n_hyp, k):
        idx = jransac._sample_indices(key, jnp.asarray(valid.cpu().numpy()), n_hyp, k)
        return _t(idx, device=valid.device)
    return draw


def jax_training_draws(seed, depth, n):
    """The uniform keys JAX's ``_build_voc_device`` draws per level."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(depth):
        key, k1 = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(k1, (n,))))
    return np.stack(out)


def _padded_size(n, branching, max_train=32768):
    if n > max_train:
        n = len(range(0, n, int(np.ceil(n / max_train)))[:max_train])
    return max(1 << int(np.ceil(np.log2(max(n, branching)))), branching)


def build_two_overlapping_maps(n_a=N_A, n_b=N_B, seed=0, device="cpu"):
    """tests/test_multimap.py's maps, built by both packages. Returns
    (mA_j, mB_j, mA_t, mB_t, T_gt)."""
    rng = np.random.default_rng(seed)
    n_total = n_a + n_b
    T_gt = np.zeros((n_total, 4, 4), np.float32)
    for i in range(n_total):
        ang = 2 * np.pi * i / 20
        Rwc = np.asarray(jgeo.so3_exp(jnp.asarray([0.0, ang, 0.0], jnp.float32)))
        C = np.array([3.0 * np.sin(ang), 0.0, -3.0 * np.cos(ang)], np.float32)
        T_gt[i, :3, :3] = Rwc.T
        T_gt[i, :3, 3] = -Rwc.T @ C
        T_gt[i, 3, 3] = 1
    n_pts = 1500
    ang_p = rng.uniform(-0.5, 2 * np.pi * n_total / 20 + 0.5, n_pts)
    pts = np.stack([10 * np.sin(ang_p), rng.uniform(-3, 3, n_pts), -10 * np.cos(ang_p)],
                   -1).astype(np.float32)
    desc = rng.integers(0, 256, (n_pts, 32), dtype=np.uint8)
    D = jgeo.sim3_make(jnp.float32(0.55), jgeo.so3_exp(jnp.asarray([0.05, -0.3, 0.1], jnp.float32)),
                       jnp.asarray([1.0, -0.5, 2.0], jnp.float32))
    pts_b = np.asarray(jgeo.sim3_apply(D, jnp.asarray(pts))).astype(np.float32)
    S_inv = jgeo.sim3_inv(D)
    poses_b = np.stack([
        np.asarray(jgeo.sim3_to_se3(jgeo.sim3_compose(jgeo.sim3_from_se3(jnp.asarray(T)), S_inv)))
        for T in T_gt[n_a - 2:n_a - 2 + n_b]])
    mA_j, _ = fabricate_map(CFG, T_gt[:n_a], pts, desc, seed=seed)
    mB_j, _ = fabricate_map(CFG, poses_b, pts_b, desc, seed=seed + 1)
    mA_t, _ = tsynthetic.fabricate_map(CFG, T_gt[:n_a], pts, desc, seed=seed, device=device)
    mB_t, _ = tsynthetic.fabricate_map(CFG, poses_b, pts_b, desc, seed=seed + 1, device=device)
    return mA_j, mB_j, mA_t, mB_t, T_gt


@pytest.fixture(scope="module")
def maps():
    mA_j, mB_j, mA_t, mB_t, T_gt = build_two_overlapping_maps()
    return dict(mA_j=mA_j, mB_j=mB_j, mA_t=mA_t, mB_t=mB_t, T_gt=T_gt)


def _map_descriptors(m_np):
    kv = m_np.kf_valid
    return np.concatenate([m_np.kf_desc[s][m_np.kf_feat_valid[s]] for s in np.nonzero(kv)[0]])


@pytest.fixture(scope="module")
def databases(maps):
    """A 512-word tree the JAX package trains from both maps' descriptors,
    and each package's BoW database of each map."""
    descs = np.concatenate([_map_descriptors(_np(maps["mA_j"])),
                            _map_descriptors(_np(maps["mB_j"]))])
    voc_j = jbow.build_vocabulary(descs, branching=8, depth=3, iters=5)
    voc_t = convert.vocabulary_from_numpy(_np(voc_j), device="cpu")
    out = dict(voc_j=voc_j, voc_t=voc_t)
    for side, n in (("A", N_A), ("B", N_B)):
        m_j, m_t = maps[f"m{side}_j"], maps[f"m{side}_t"]
        K = m_j.kf_pose.shape[0]
        out[f"bow{side}_j"] = jbow.update_bow_rows(voc_j, m_j.kf_desc, m_j.kf_feat_valid,
                                                   jnp.zeros((K, voc_j.n_words)),
                                                   jnp.arange(n, dtype=jnp.int32))
        out[f"bow{side}_t"] = tbow.update_bow_rows(voc_t, m_t.kf_desc, m_t.kf_feat_valid,
                                                   torch.zeros((K, voc_t.n_words)), list(range(n)))
    return out


# ---------------------------------------------------------------------------
# vocabulary training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_desc, max_train, branching, depth, iters", [
    (3000, 32768, 8, 3, 5),  # padded to 4096
    (5000, 1024, 4, 3, 4),  # strided down to max_train
    (40, 32768, 4, 3, 3),  # level 2: groups with fewer members than k (ties at -1)
])
def test_build_vocabulary_matches_jax(maps, n_desc, max_train, branching, depth, iters):
    """JAX's per-level keys injected: nodes exact (0/1 products, segment
    sums of 0/1 and majority votes are exact in float32; group top-k and
    argmin take ties in lax's order), idf within 1e-6 relative (one float32
    log of the same quotient)."""
    descs = np.concatenate([_map_descriptors(_np(maps["mA_j"])),
                            _map_descriptors(_np(maps["mB_j"]))])[:n_desc]
    voc_j = jbow.build_vocabulary(descs, branching=branching, depth=depth, iters=iters,
                                  seed=3, max_train=max_train)
    draws = jax_training_draws(3, depth, _padded_size(len(descs), branching, max_train))
    voc_t = tbow.build_vocabulary(descs, branching=branching, depth=depth, iters=iters, seed=3,
                                  max_train=max_train, device="cpu", draws=draws)
    assert voc_t.nodes.dtype == torch.uint8 and voc_t.n_words == voc_j.n_words
    assert np.array_equal(voc_t.nodes.numpy(), np.asarray(voc_j.nodes))
    np.testing.assert_allclose(voc_t.idf.numpy(), np.asarray(voc_j.idf), rtol=1e-6, atol=1e-6)
    # the port's own keys: a deterministic tree with every node set
    own = tbow.build_vocabulary(descs, branching=branching, depth=depth, iters=iters, seed=3,
                                max_train=max_train, device="cpu")
    again = tbow.build_vocabulary(descs, branching=branching, depth=depth, iters=iters, seed=3,
                                  max_train=max_train, device="cpu")
    assert torch.equal(own.nodes, again.nodes) and torch.equal(own.idf, again.idf)
    assert own.nodes.shape == voc_t.nodes.shape and torch.isfinite(own.idf).all()


def test_ensure_vocabulary_trains_from_the_map(maps, monkeypatch):
    """``MapContext.ensure_vocabulary`` with no vocabulary file trains a
    tree from the map's keyframe descriptors (JAX's keys injected): the
    trained nodes exact, the database rows of every keyframe within 1e-6
    and the keyframes' words exact."""
    m_j, m_t = maps["mA_j"], maps["mA_t"]
    mc_j = jsys.MapContext(CFG)
    mc_t = tsys.MapContext(CFG, device="cpu")
    mc_j.map, mc_j.n_kf = m_j, N_A
    mc_t.map, mc_t.n_kf = m_t, N_A
    n = len(_map_descriptors(_np(m_j)))
    lc = CFG.loop
    draws = jax_training_draws(0, lc.vocab_depth, _padded_size(n, lc.vocab_branching))
    monkeypatch.setattr(tbow, "build_vocabulary",
                        functools.partial(tbow.build_vocabulary, draws=draws))
    assert mc_j.ensure_vocabulary() and mc_t.ensure_vocabulary()
    assert np.array_equal(mc_t.voc.nodes.numpy(), np.asarray(mc_j.voc.nodes))
    np.testing.assert_allclose(mc_t.kf_bow.numpy(), np.asarray(mc_j.kf_bow), atol=1e-6)
    for s in range(N_A):
        w_j = jbow.assign_words(mc_j.voc, m_j.kf_desc[s], m_j.kf_feat_valid[s])
        w_t = tbow.assign_words(mc_t.voc, m_t.kf_desc[s], m_t.kf_feat_valid[s])
        assert np.array_equal(w_t.numpy(), np.asarray(w_j))
    young = tsys.MapContext(CFG, device="cpu")
    young.n_kf = 3
    assert not young.ensure_vocabulary() and young.voc is None  # waits for 4 keyframes


# ---------------------------------------------------------------------------
# map-state and mapping pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("by_value", [True, False])
@pytest.mark.parametrize("n_free", [0, 100])
def test_free_lm_slots_matches_jax(maps, by_value, n_free):
    """A pool with n_free free slots and tied found ratios among the
    occupied ones (ratios from a handful of visible/found pairs): the slot
    order exact (same float32 key, ties lowest index first)."""
    d = _np(maps["mA_j"])._asdict()
    L = d["lm_valid"].shape[0]
    rng = np.random.default_rng(n_free)
    valid = np.ones(L, bool)
    valid[rng.choice(L, n_free, replace=False)] = False
    pairs = np.array([(10, 1), (10, 9), (4, 2), (2, 1), (0, 0), (7, 3)], np.int32)
    pick = pairs[rng.integers(0, len(pairs), L)]
    d.update(lm_valid=valid, lm_visible=pick[:, 0], lm_found=pick[:, 1])
    n = 700
    want = np.asarray(jms.free_lm_slots(_jmap(d), n, by_value=by_value))
    got = tms.free_lm_slots(_tmap(d), n, by_value=by_value)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("slot", [3, 7])
def test_fuse_neighbors_matches_jax(maps, slot):
    """The seam fuse on map A with a third of keyframe ``slot``'s and its
    neighbours' observations cleared, so there are features to claim, and
    the distance bands narrowed to put the predicted octave within the
    search band of the level-0 features: ``kf_obs_lm`` and ``lm_valid``
    exact, and the fuse re-associated some."""
    d = _np(maps["mA_j"])._asdict()
    d["lm_dist_max"] = d["lm_dist_max"] / 4.0
    rng = np.random.default_rng(slot)
    obs = d["kf_obs_lm"].copy()
    for s in (slot - 1, slot, min(slot + 1, N_A - 1)):
        drop = (obs[s] >= 0) & (rng.random(obs.shape[1]) < 0.33)
        obs[s][drop] = -1
    d["kf_obs_lm"] = obs
    want = jlm.fuse_neighbors(CFG, _jmap(d), jnp.int32(slot))
    got = tlm.fuse_neighbors(CFG, _tmap(d), slot)
    assert np.array_equal(got.kf_obs_lm.numpy(), np.asarray(want.kf_obs_lm))
    assert np.array_equal(got.lm_valid.numpy(), np.asarray(want.lm_valid))
    assert (got.kf_obs_lm.numpy() >= 0).sum() > (obs >= 0).sum()


# ---------------------------------------------------------------------------
# cross-map scan and Sim3
# ---------------------------------------------------------------------------

def test_merge_scan_scores_match_jax(maps, databases):
    """Map B's keyframes 0-3 against map A's database: scores, minScore
    and group accumulation within 1e-5 (L1 sums and group sums in another
    order), group membership exact; the single-query form equals the
    batched row."""
    db = databases
    slots = [0, 1, 2, 3]
    want = jlc.batched_merge_scan_scores(CFG, maps["mB_j"], db["bowB_j"],
                                         jnp.asarray(slots, jnp.int32), maps["mA_j"],
                                         db["bowA_j"])
    got = tlc.batched_merge_scan_scores(CFG, maps["mB_t"], db["bowB_t"], slots, maps["mA_t"],
                                        db["bowA_t"])
    for name, g, w in zip(("scores", "min_score", "acc"), got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, err_msg=name)
    assert np.array_equal(got[3].numpy(), np.asarray(want[3]))
    assert float(got[0].max()) > 0.015  # the shared views score
    one = tlc.merge_scan_scores(CFG, maps["mB_t"], db["bowB_t"], 2, maps["mA_t"], db["bowA_t"])
    one_j = jlc.merge_scan_scores(CFG, maps["mB_j"], db["bowB_j"], jnp.int32(2), maps["mA_j"],
                                  db["bowA_j"])
    for g, w, b in zip(one, one_j, got):
        assert torch.equal(g, b[2])
        np.testing.assert_allclose(g.numpy().astype(np.float32), np.asarray(w, np.float32),
                                   atol=1e-5)


@pytest.mark.parametrize("slot_b, slot_a", [(0, N_A - 1), (1, N_A - 2)])
def test_compute_loop_sim3_cross_matches_jax(maps, slot_b, slot_a):
    """Neighbouring views across the maps (B keyframe 0 is the place of A's
    keyframe 6, B's 1 of A's 7), JAX's draw injected: success and inlier
    count exact, S_ba within 1e-4 (3x3 SVDs and the 7x7 refinement in
    float32); the scale is B's world warp (1 / 0.55). The shared views
    themselves (B 0 against A 6) are not compared: from one camera centre
    the Sim3 scale leaves every projection unchanged, so the refinement's
    scale is float32 noise in either package (1.8 % apart here)."""
    key = jax.random.key(slot_b)
    want = jlc.compute_loop_sim3_cross(CFG, maps["mB_j"], maps["mA_j"], jnp.int32(slot_b),
                                       jnp.int32(slot_a), key)
    got = tlc.compute_loop_sim3_cross(CFG, maps["mB_t"], maps["mA_t"], slot_b, slot_a,
                                      draw=_jax_draw(key))
    assert bool(want.success) and bool(got.success)
    assert int(got.n_inliers) == int(want.n_inliers)
    np.testing.assert_allclose(got.S_ba.numpy(), np.asarray(want.S_ba), atol=1e-4)
    assert float(torch.exp(got.S_ba[7])) == pytest.approx(1 / 0.55, abs=0.05)


@pytest.fixture(scope="module")
def merge_sim3(maps):
    """JAX's cross-map Sim3 of the shared view (B 0 -> A 6)."""
    return np.array(jlc.compute_loop_sim3_cross(CFG, maps["mB_j"], maps["mA_j"], jnp.int32(0),
                                                jnp.int32(N_A - 2), jax.random.key(0)).S_ba)


def _tight_pool(d_np):
    """tests/test_multimap.py's tight pool: A's free slots filled but 64
    with poorly found fillers (ratio 0.1), its own landmarks well found."""
    d = dict(d_np)
    valid = d["lm_valid"].copy()
    free = np.nonzero(~valid)[0]
    fill = free[:len(free) - 64]
    vis, fnd = d["lm_visible"].copy(), d["lm_found"].copy()
    orig = np.nonzero(valid)[0]
    valid[fill] = True
    vis[fill], fnd[fill] = 10, 1
    vis[orig], fnd[orig] = 10, 9
    d.update(lm_valid=valid, lm_visible=vis, lm_found=fnd)
    return d


def assert_merge_results_equal(got, want):
    """Integer and bool fields, ``lm_remap`` and ``n_evicted`` exact; poses,
    positions, normals, distance bands and S_AB within 1e-5 relative to
    their size (Sim3 compositions in float32, einsum against matmul)."""
    m_t, m_j = convert.map_state_to_numpy(got.map), _np(want.map)._asdict()
    for k, w in m_j.items():
        g = m_t[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if w.dtype.kind in "biu":
            assert np.array_equal(g, w), k
        else:
            scale = max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(g, w, atol=1e-5 * scale, err_msg=k)
    assert np.array_equal(got.lm_remap.numpy(), np.asarray(want.lm_remap))
    assert int(got.n_evicted) == int(want.n_evicted)
    np.testing.assert_allclose(got.S_AB.numpy(), np.asarray(want.S_AB), atol=1e-5)


@pytest.mark.parametrize("pool", ["roomy", "tight"])
def test_merge_maps_matches_jax(maps, merge_sim3, pool):
    """``merge_maps`` with JAX's S_cam, into map A's pool as built
    (roomy) and into tests/test_multimap.py's tight pool, where A's
    worst landmarks are evicted. The merged map must also hold up against
    ground truth and keep every absorbed landmark."""
    dA = _np(maps["mA_j"])._asdict()
    if pool == "tight":
        dA = _tight_pool(dA)
    args = (jnp.asarray(merge_sim3), jnp.int32(0), jnp.int32(N_A - 2), jnp.int32(N_A))
    want = jmm.merge_maps(CFG, _jmap(dA), maps["mB_j"], *args)
    got = tmm.merge_maps(CFG, _tmap(dA), maps["mB_t"], _t(merge_sim3), 0, N_A - 2, N_A)
    assert_merge_results_equal(got, want)
    remap = got.lm_remap.numpy()
    assert (remap[maps["mB_t"].lm_valid.numpy()] >= 0).all()
    assert (int(got.n_evicted) > 0) == (pool == "tight")
    T_gt = maps["T_gt"]
    kp = got.map.kf_pose.numpy()
    for i in range(N_A + N_B):
        g = i if i < N_A else (i - N_A) + (N_A - 2)
        C = -kp[i, :3, :3].T @ kp[i, :3, 3]
        Cg = -T_gt[g, :3, :3].T @ T_gt[g, :3, 3]
        assert np.linalg.norm(C - Cg) < 0.15


def test_merge_maps_masks_writes_past_the_pools(maps, merge_sim3):
    """B's keyframes land past A's keyframe pool when n_kf_A is near its
    end, and B's loop edges overflow A's edge table: those writes go
    nowhere in both packages (a torch scatter would fault on them)."""
    dA = _np(maps["mA_j"])._asdict()
    dB = _np(maps["mB_j"])._asdict()
    E = dA["loop_edges"].shape[0]
    # A: all rows but five used (the five scattered); B: 11 rows used, of
    # which only 5 fit after A's
    le_a = np.stack([np.arange(E) % N_A + 1, np.zeros(E)], -1).astype(np.int32)
    le_a[[0, 7, 8, 20, 31]] = -1
    le_b = np.full((E, 2), -1, np.int32)
    le_b[1::3] = [3, 1]
    dA["loop_edges"], dB["loop_edges"] = le_a, le_b
    K = dA["kf_pose"].shape[0]
    n_kf_A = K - 3
    want = jmm.merge_maps(CFG, _jmap(dA), _jmap(dB), jnp.asarray(merge_sim3), jnp.int32(0),
                          jnp.int32(N_A - 2), jnp.int32(n_kf_A))
    got = tmm.merge_maps(CFG, _tmap(dA), _tmap(dB), _t(merge_sim3), 0, N_A - 2, n_kf_A)
    assert_merge_results_equal(got, want)
    assert got.map.kf_valid[-3:].all() and (got.map.loop_edges[:, 0] >= 0).all()


# ---------------------------------------------------------------------------
# MultiMapper._do_merge on converted state
# ---------------------------------------------------------------------------

def _setup_mapper(pkg, maps, databases, device="cpu"):
    """A MultiMapper of ``pkg`` ("j" or "t") with two robots, robot a on map
    A and robot b on map B, each tracking its map's newest keyframe (moved
    a little) with three frame records resolved through keyframes."""
    voc = databases[f"voc_{pkg}"]
    if pkg == "j":
        mm = jmm.MultiMapper(CFG)
    else:
        mm = tmm.MultiMapper(CFG, device=device)
    mm.voc = voc if pkg == "j" else voc.to(device)
    robots = [mm.add_robot("a"), mm.add_robot("b")]
    for r, side, n in zip(robots, "AB", (N_A, N_B)):
        mc = r.mapctx
        m = maps[f"m{side}_{pkg}"]
        mc.map, mc.n_kf = (m if pkg == "j" else m._replace(**{
            k: v.to(device) for k, v in m._asdict().items()})), n
        kf_bow = databases[f"bow{side}_{pkg}"]
        mc.kf_bow = kf_bow if pkg == "j" else kf_bow.to(device)
        poses = np.asarray(m.kf_pose if pkg == "j" else m.kf_pose.numpy())
        last = poses[n - 1].copy()
        last[:3, 3] += np.array([0.02, -0.01, 0.03], np.float32)
        obs = np.asarray(m.kf_obs_lm[n - 1] if pkg == "j" else m.kf_obs_lm[n - 1].numpy())
        Rec = jsys.FrameRecord if pkg == "j" else tsys.FrameRecord
        for k, ref in enumerate((n - 3, n - 2, n - 1)):
            T = poses[ref].copy()
            T[:3, 3] += 0.01 * k
            T_rel = (T.astype(np.float64) @ np.linalg.inv(poses[ref])).astype(np.float32)
            r.frames.append(Rec(frame_id=k, timestamp=float(k), T_cw=T, state="OK",
                                n_inliers=50, map_id=mc.map_id, ref_slot=ref, T_rel=T_rel))
        r.state = jsys.TrackingState.OK if pkg == "j" else tsys.TrackingState.OK
        if pkg == "j":
            r.T_cw, r.last_lm = jnp.asarray(last), jnp.asarray(obs)
        else:
            r.T_cw, r.last_lm = _t(last, device=device), _t(obs, device=device)
        r.last_T = r.T_cw
    return mm, robots


def _numpy(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_do_merge_matches_jax(maps, databases, merge_sim3, device):
    """``MultiMapper._do_merge`` of both packages from the same state,
    JAX's S_cam given: the merged map within PR 2's correct_loop and GBA
    tolerances (keyframe poses 1e-3, landmarks 1e-2 + 1e-3 relative: the
    essential graph's float32 CG and one GBA slice); observations >= 99 %
    equal (the seam fuse follows the corrected poses, a borderline
    projection may flip); the database, the loop-edge table and the merge
    record exact; robot a's pose within 1e-4; robot b's pose relative to
    its anchor (the transplanted newest keyframe of B, whose correction it
    rides) within 1e-4, and its absolute pose within the keyframe poses'
    1e-3 (it is a product with that anchor's pose-graph output: 1.4e-4
    apart on the CPU where the keyframe poses are 1.7e-4 apart); the
    retro-transformed frame records (T_cw, ref_slot, T_rel) within 1e-5.
    The ``cuda`` case runs the port on the card."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    mm_j, (a_j, b_j) = _setup_mapper("j", maps, databases)
    mm_t, (a_t, b_t) = _setup_mapper("t", maps, databases, device)
    mcA_j, mcB_j, mcA_t, mcB_t = a_j.mapctx, b_j.mapctx, a_t.mapctx, b_t.mapctx
    mm_j._do_merge(mcA_j, mcB_j, jnp.asarray(merge_sim3), 0, N_A - 2)
    mm_t._do_merge(mcA_t, mcB_t, _t(merge_sim3, device=device), 0, N_A - 2)
    assert mm_j.merges == [(mcB_j.map_id, mcA_j.map_id, 0, N_A - 2)]
    assert mm_t.merges == [(mcB_t.map_id, mcA_t.map_id, 0, N_A - 2)]
    assert mm_t.merge_evictions == [0]
    assert mcB_t.merged_into is mcA_t and mm_t.live_maps() == [mcA_t]
    assert b_t.mapctx is mcA_t and mcA_t.n_kf == mcA_j.n_kf == N_A + N_B
    assert mcA_t.gba_remaining == mcA_j.gba_remaining and mcA_t.gba_slices_run == 1
    m_t, m_j = convert.map_state_to_numpy(mcA_t.map), _np(mcA_j.map)._asdict()
    np.testing.assert_allclose(m_t["kf_pose"], m_j["kf_pose"], atol=1e-3)
    lv = m_j["lm_valid"]
    assert np.array_equal(m_t["lm_valid"], lv)
    np.testing.assert_allclose(m_t["lm_pos"][lv], m_j["lm_pos"][lv], atol=1e-2, rtol=1e-3)
    assert (m_t["kf_obs_lm"] == m_j["kf_obs_lm"]).mean() >= 0.99
    assert np.array_equal(m_t["loop_edges"], m_j["loop_edges"])
    assert np.array_equal(m_t["kf_valid"], m_j["kf_valid"])
    np.testing.assert_allclose(_numpy(mcA_t.kf_bow), np.asarray(mcA_j.kf_bow), atol=1e-6)
    for T_b, T_a in zip(mcA_t.last_merge_rebase, mcA_j.last_merge_rebase):
        np.testing.assert_allclose(T_b, T_a, atol=1e-3)
    np.testing.assert_allclose(_numpy(a_t.T_cw), np.asarray(a_j.T_cw), atol=1e-4)
    anchor_b = N_A + N_B - 1
    rel_t = _numpy(b_t.T_cw).astype(np.float64) @ np.linalg.inv(m_t["kf_pose"][anchor_b])
    rel_j = np.asarray(b_j.T_cw, np.float64) @ np.linalg.inv(m_j["kf_pose"][anchor_b])
    np.testing.assert_allclose(rel_t, rel_j, atol=1e-4)
    np.testing.assert_allclose(_numpy(b_t.T_cw), np.asarray(b_j.T_cw), atol=1e-3)
    assert np.array_equal(_numpy(b_t.last_lm), np.asarray(b_j.last_lm))
    assert a_t.prev_inliers == a_j.prev_inliers == 0
    for f_t, f_j in zip(a_t.frames + b_t.frames, a_j.frames + b_j.frames):
        np.testing.assert_allclose(f_t.T_cw, f_j.T_cw, atol=1e-5)
        assert f_t.ref_slot == f_j.ref_slot
        np.testing.assert_allclose(f_t.T_rel, f_j.T_rel, atol=1e-5)
    assert [f.map_id for f in b_t.frames] == [mcA_t.map_id] * 3
    assert [f.ref_slot for f in b_t.frames] == [N_A + N_B - 3, N_A + N_B - 2, N_A + N_B - 1]


# ---------------------------------------------------------------------------
# MultiMapper host logic
# ---------------------------------------------------------------------------

SMALL = SlamConfig(camera=CameraConfig(width=160, height=120, fx=130, fy=130, cx=80, cy=60),
                   orb=OrbConfig(n_features=120, max_keypoints=256, n_levels=2),
                   capacity=CapacityConfig(max_keyframes=16, max_landmarks=512))


def _mappers():
    return jmm.MultiMapper(SMALL), tmm.MultiMapper(SMALL, device="cpu")


def test_enqueue_scan_matches_jax():
    """The rescan cursor and the capped queue over a run of keyframe
    events on a map that grows (and one too young to scan): equal after
    every event."""
    mm_j, mm_t = _mappers()
    mcs = []
    for mm, pkg in ((mm_j, jsys), (mm_t, tsys)):
        mc = pkg.MapContext(SMALL) if pkg is jsys else pkg.MapContext(SMALL, device="cpu")
        mc.kf_bow = np.zeros(1)
        young = pkg.MapContext(SMALL) if pkg is jsys else pkg.MapContext(SMALL, device="cpu")
        young.kf_bow, young.n_kf = np.zeros(1), 5
        mcs.append((mm, mc, young))
    for n_kf in range(10, 16):
        for slot in (n_kf - 1, n_kf - 3):
            for mm, mc, young in mcs:
                mc.n_kf = n_kf
                mm.enqueue_scan(mc, slot)
                mm.enqueue_scan(young, 4)
            (mm_j, mc_j, y_j), (mm_t, mc_t, y_t) = mcs
            assert mm_t._scan_queue[mc_t.map_id] == mm_j._scan_queue[mc_j.map_id]
            assert mm_t._rescan_cursor[mc_t.map_id] == mm_j._rescan_cursor[mc_j.map_id]
            assert len(mm_t._scan_queue[mc_t.map_id]) <= 2 * mm_t.scan_batch
            assert y_t.map_id not in mm_t._scan_queue and y_j.map_id not in mm_j._scan_queue


def test_dispatch_verifies_matches_jax(monkeypatch):
    """Injected scores for four query slots (one under its floor): the
    candidates handed to the cross-map Sim3, in order, and the cooldown
    that skips a candidate verified and failed one round before, equal."""
    rng = np.random.default_rng(5)
    Q, K = 4, SMALL.capacity.max_keyframes
    scores = rng.uniform(0.0, 0.2, (Q, K)).astype(np.float32)
    scores[2] = 0.01  # below the 0.015 floor
    min_score = np.array([0.05, 0.02, 0.5, 0.0], np.float32)
    nb = rng.random((Q, K, K)) < 0.2
    nb |= np.eye(K, dtype=bool)[None]
    acc = np.where(rng.random((Q, K)) < 0.6, rng.uniform(0.1, 1.0, (Q, K)), -1.0).astype(np.float32)
    calls = {"j": [], "t": []}

    def fake(pkg, success):
        def verify(cfg, m_b, m_a, slot_b, slot_a, *rest):
            calls[pkg].append((int(slot_b), int(slot_a)))
            return jlc.LoopSim3(success=success, S_ba=None, n_inliers=0) if pkg == "j" else \
                tlc.LoopSim3(success=success, S_ba=None, n_inliers=0)
        return verify

    monkeypatch.setattr(jlc, "compute_loop_sim3_cross", fake("j", jnp.asarray(False)))
    monkeypatch.setattr(tlc, "compute_loop_sim3_cross", fake("t", torch.tensor(False)))
    mm_j, mm_t = _mappers()
    for mm, pkg in ((mm_j, "j"), (mm_t, "t")):
        mcB, mcA = mm.new_map(), mm.new_map()
        conv = (lambda a: jnp.asarray(a)) if pkg == "j" else (lambda a: torch.as_tensor(a))
        tok = {"mcB": mcB, "mcA": mcA, "slots": [11, 9, 7, 5],
               "out": tuple(conv(a) for a in (scores, min_score, acc, nb))}
        mm._pump_round = 7
        # candidate 3 failed one round ago: skipped; 4 failed long ago: tried
        mm._verify_cooldown[(mcB.map_id, mcA.map_id, 3)] = 6
        mm._verify_cooldown[(mcB.map_id, mcA.map_id, 4)] = 2
        mm._dispatch_verifies(tok)
        # the failed verdicts are read at the next round and cool down
        mm._pump_round += 1
        assert mm._fetch_and_verify_scans() is False
        cool = {k[2]: v for k, v in mm._verify_cooldown.items()}
        calls[pkg + "_cool"] = cool
    assert calls["j"] and calls["t"] == calls["j"]
    assert calls["t_cool"] == calls["j_cool"]
    assert all(cand != 3 for _, cand in calls["t"])


@pytest.mark.parametrize("n_kf", [12, 3])
def test_handle_loss_matches_jax(n_kf):
    """A lost robot on an established map (12 keyframes) gets a brand-new
    map and the old one stays live; on a young map (3) the map is reset in
    place under a renewed id. Both packages alike."""
    outcomes = []
    for mm in _mappers():
        r = mm.add_robot("r")
        mc = r.mapctx
        mc.n_kf, old_id = n_kf, mc.map_id
        r.state = type(r.state).LOST
        mm._handle_loss(r, 0.0)
        outcomes.append((len(mm.maps), len(mm.live_maps()), r.mapctx is mc, mc.n_kf,
                         r.mapctx.map_id > old_id, r.state.name,
                         int(np.asarray(_numpy(r.mapctx.map.kf_valid)).sum())))
    assert outcomes[0] == outcomes[1]
    assert outcomes[1][:3] == ((2, 2, False) if n_kf >= 10 else (1, 1, True))


@pytest.mark.parametrize("on", [True, False])
def test_set_multi_mapping_matches_jax(monkeypatch, on):
    """With multi-mapping off a lost robot owned by a MultiMapper
    relocalizes; with it on it does not (the MultiMapper starts a new map
    instead). Both packages alike."""
    seen = []
    for mm in _mappers():
        r = mm.add_robot("r")
        mm.set_multi_mapping(on)
        assert r.reloc_on_loss == (not on) and mm.multi_mapping_enabled == on
        r.state = type(r.state).LOST
        tried = []
        r.extract = lambda img: None
        r._try_relocalize = lambda feats, tried=tried: tried.append(1) or 0
        mm.process_frame(0, np.zeros((SMALL.camera.height, SMALL.camera.width), np.uint8), 0.0)
        seen.append((bool(tried), r.state.name, len(mm.maps)))
    assert seen[0] == seen[1] and seen[1][0] == (not on)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_build_vocabulary_on_the_card_equals_the_cpu(maps):
    """The port's own draws (a CPU generator, moved to the card): nodes
    exact, idf within 1e-6 relative (the card's logf)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    descs = np.concatenate([_map_descriptors(_np(maps["mA_j"])),
                            _map_descriptors(_np(maps["mB_j"]))])
    cpu = tbow.build_vocabulary(descs, iters=6, device="cpu")
    card = tbow.build_vocabulary(descs, iters=6, device="cuda")
    assert card.nodes.is_cuda and torch.equal(card.nodes.cpu(), cpu.nodes)
    np.testing.assert_allclose(card.idf.cpu().numpy(), cpu.idf.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["roomy", "tight"])
def test_merge_maps_on_the_card_equals_the_cpu(maps, merge_sim3, pool):
    """``merge_maps`` on the card against the CPU, both pools: integer and
    bool fields exact, floats within 1e-5 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dA = _np(maps["mA_j"])._asdict()
    if pool == "tight":
        dA = _tight_pool(dA)
    dB = _np(maps["mB_j"])._asdict()
    cpu = tmm.merge_maps(CFG, _tmap(dA), _tmap(dB), _t(merge_sim3), 0, N_A - 2, N_A)
    card = tmm.merge_maps(CFG, _tmap(dA, "cuda"), _tmap(dB, "cuda"),
                          _t(merge_sim3, device="cuda"), 0, N_A - 2, N_A)
    assert card.map.kf_pose.is_cuda
    m_c, m_g = convert.map_state_to_numpy(cpu.map), convert.map_state_to_numpy(card.map)
    for k, w in m_c.items():
        if w.dtype.kind in "biu":
            assert np.array_equal(m_g[k], w), k
        else:
            np.testing.assert_allclose(m_g[k], w, atol=1e-5 * max(1.0, float(np.abs(w).max())),
                                       err_msg=k)
    assert torch.equal(card.lm_remap.cpu(), cpu.lm_remap)
    assert int(card.n_evicted) == int(cpu.n_evicted)
