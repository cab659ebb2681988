"""Package-level checks of orbslamm_tpu_torch: it never imports jax, its copies
of the JAX package's numpy generators are exact, its converters carry a map
across both ways, the CPU matcher never launches the CUDA kernel, and paths
the port does not have yet are refused rather than skipped."""

import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslamm_tpu.models import fused as jfused
from orbslamm_tpu.models import map_state as jms
from orbslamm_tpu.ops import orb as jo
from orbslamm_tpu.utils.config import CameraConfig, CapacityConfig, OrbConfig, SlamConfig
from orbslamm_tpu_torch import convert
from orbslamm_tpu_torch.models import map_state as tms
from orbslamm_tpu_torch.models.system import MonocularSession, TrackingState
from orbslamm_tpu_torch.ops import orb as to
from orbslamm_tpu_torch.ops.cuda import hamming as tph

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CAM = CameraConfig(width=160, height=120, fx=130, fy=130, cx=80, cy=60, fps=30)
CFG = SlamConfig(camera=CAM, orb=OrbConfig(n_features=120, max_keypoints=256, n_levels=2),
                 capacity=CapacityConfig(max_keyframes=8, max_landmarks=512))


def test_port_never_imports_jax():
    """A fresh interpreter imports the whole port, runs a few frames of the
    session on the CPU, and has not loaded jax."""
    script = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        torch.set_num_threads(2)
        import orbslamm_tpu_torch
        from orbslamm_tpu_torch import convert
        from orbslamm_tpu_torch.models import (fused, local_mapping, loop_closing, map_state,
                                               system, tracking)
        from orbslamm_tpu_torch.ops import ba, bow, geometry, matching, orb, ransac
        from orbslamm_tpu_torch.ops.cuda import hamming
        from orbslamm_tpu_torch.utils import trace
        from orbslamm_tpu.io.synthetic import make_sequence
        from orbslamm_tpu.eval import ate
        from orbslamm_tpu.utils.config import (CameraConfig, CapacityConfig,
                                               OrbConfig, SlamConfig)
        cam = CameraConfig(width=160, height=120, fx=130, fy=130, cx=80, cy=60)
        cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=120, max_keypoints=256,
                                                   n_levels=2),
                         capacity=CapacityConfig(max_keyframes=8, max_landmarks=512))
        seq = make_sequence(n_frames=4, n_points=300, cam=cam, seed=3)
        sess = system.MonocularSession(cfg, device="cpu")
        sess.enable_loop_closing = False
        recs = [sess.process_frame(seq.images[i], float(seq.timestamps[i])) for i in range(4)]
        assert len(recs) == 4 and hamming.launches == 0
        assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
        print("NOJAX_OK")
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "NOJAX_OK" in out.stdout


def test_copied_pattern_tables_equal_the_originals():
    assert np.array_equal(to._CIRCLE, jo._CIRCLE)
    assert np.array_equal(to.pattern_points(), jo.pattern_points())
    assert np.array_equal(to.pattern_tests(), jo.pattern_tests())
    assert np.array_equal(to.ic_row_halfwidths(), jo.ic_row_halfwidths())
    for n, lv, s in [(400, 4, 1.2), (1000, 8, 1.2), (4000, 8, 1.2), (77, 3, 1.5)]:
        assert to.level_feature_counts(n, lv, s) == jo.level_feature_counts(n, lv, s)


def test_precision_is_pinned():
    assert torch.get_default_dtype() == torch.float32
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_cpu_matcher_path_leaves_launches_at_zero():
    rng = np.random.default_rng(0)
    before = tph.launches
    desc = torch.as_tensor(rng.integers(0, 256, (64, 32), dtype=np.uint8))
    valid = torch.ones(64, dtype=torch.bool)
    t = tph.match_tables(desc, desc, valid, valid)
    assert torch.equal(t.row_arg, torch.arange(64, dtype=torch.int32))
    assert tph.launches == before


def test_wrapper_refuses_other_devices_and_bad_inputs():
    desc = torch.zeros((8, 32), dtype=torch.uint8, device="meta")
    valid = torch.zeros(8, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        tph.match_tables(desc, desc, valid, valid)
    with pytest.raises(ValueError):  # wrong descriptor width
        tph.match_tables(torch.zeros((8, 16), dtype=torch.uint8),
                         torch.zeros((8, 32), dtype=torch.uint8),
                         torch.ones(8, dtype=torch.bool), torch.ones(8, dtype=torch.bool))
    with pytest.raises(ValueError):  # window mode without positions
        tph.match_tables(torch.zeros((8, 32), dtype=torch.uint8),
                         torch.zeros((8, 32), dtype=torch.uint8),
                         torch.ones(8, dtype=torch.bool), torch.ones(8, dtype=torch.bool),
                         use_window=True)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_map_and_features_convert_both_ways():
    m_j = jms.empty_map(CFG)
    rng = np.random.default_rng(1)
    m_j = m_j._replace(lm_pos=jnp.asarray(rng.normal(size=(512, 3)).astype(np.float32)),
                       kf_obs_lm=m_j.kf_obs_lm.at[1, :5].set(jnp.arange(5, dtype=jnp.int32)),
                       n_kf=jnp.int32(2))
    m_t = convert.map_state_from_numpy(_np(m_j), device="cpu")
    m_e = tms.empty_map(CFG, device="cpu")
    for k in jms.MapState._fields:
        a, b = getattr(m_t, k), getattr(m_e, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
    back = convert.map_state_to_numpy(m_t)
    m_j2 = jms.MapState(**{k: jnp.asarray(v) for k, v in back.items()})
    for k in jms.MapState._fields:
        assert np.array_equal(np.asarray(getattr(m_j2, k)), np.asarray(getattr(m_j, k))), k
        assert np.asarray(getattr(m_j2, k)).dtype == np.asarray(getattr(m_j, k)).dtype, k
    img = (rng.random((CAM.height, CAM.width)) * 255).astype(np.uint8)
    f_j = jo.make_extractor(CFG.orb, CAM)(jnp.asarray(img))
    f_t = convert.features_from_numpy({k: np.asarray(v) for k, v in f_j._asdict().items()},
                                      device="cpu")
    assert f_t.u_right is None and f_t.desc.dtype == torch.uint8
    for k, v in convert.features_to_numpy(f_t).items():
        if v is not None:
            assert np.array_equal(v, np.asarray(getattr(f_j, k))), k


def test_track_state_converts_both_ways():
    M = CFG.orb.max_keypoints
    feats = jo.Features(
        xy=jnp.zeros((M, 2)), xy_raw=jnp.zeros((M, 2)), angle=jnp.zeros(M),
        response=jnp.zeros(M), level=jnp.zeros(M, jnp.int32),
        desc=jnp.zeros((M, 32), jnp.uint8), valid=jnp.zeros(M, bool))
    ts_j = jfused.TrackState(
        T_cw=jnp.eye(4), velocity=jnp.eye(4), last_T=jnp.eye(4), last_feats=feats,
        last_lm=jnp.full((M,), -1, jnp.int32), frames_since_kf=jnp.int32(3),
        peak_inliers=jnp.int32(40), prev_inliers=jnp.int32(35), n_kf=jnp.int32(2),
        lost=jnp.asarray(False), obs_ind=jnp.zeros((8, 512)), last_kf_T=jnp.eye(4))
    ts_t = convert.track_state_from_numpy(_np(ts_j), device="cpu")
    assert ts_t.n_kf.dtype == torch.int32 and int(ts_t.peak_inliers) == 40
    d = convert.track_state_to_numpy(ts_t)
    ts_back = jfused.TrackState(**{**{k: jnp.asarray(v) for k, v in d.items()
                                      if k != "last_feats"},
                                   "last_feats": jo.Features(**{
                                       k: (None if v is None else jnp.asarray(v))
                                       for k, v in d["last_feats"].items()})})
    for a, b in zip(jax.tree.leaves(ts_back), jax.tree.leaves(ts_j)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_vocabulary_and_frame_summary_convert_both_ways():
    """The vocabulary file as the JAX package loads it, and a chunk summary
    with its loop-scan fields, carried to the port and back, bit-equal."""
    from orbslamm_tpu.ops import bow as jbow

    voc_j = jbow.load_vocabulary_npz(REPO / "orbslamm_tpu" / "data" / "vocab_10x4.npz")
    voc_t = convert.vocabulary_from_numpy(voc_j, device="cpu")
    assert (voc_t.branching, voc_t.depth, voc_t.n_words) == (10, 4, 10 ** 4)
    d = convert.vocabulary_to_numpy(voc_t)
    back = jbow.Vocabulary(**{k: (v if k in ("branching", "depth") or v is None
                                  else jnp.asarray(v)) for k, v in d.items()})
    for a, b in ((back.nodes, voc_j.nodes), (back.idf, voc_j.idf),
                 (back.node_valid, voc_j.node_valid)):
        assert (a is None and b is None) or np.array_equal(np.asarray(a), np.asarray(b))
    K = CFG.capacity.max_keyframes
    s_j = jfused.FrameSummary(
        T_cw=jnp.eye(4)[None].repeat(8, 0), n_inliers=jnp.arange(8, dtype=jnp.int32),
        tracking_ok=jnp.ones(8, bool), new_kf=jnp.arange(8) % 3 == 0,
        kf_slot=jnp.arange(8, dtype=jnp.int32), ref_slot=jnp.zeros(8, jnp.int32),
        T_rel=jnp.eye(4)[None].repeat(8, 0),
        loop_scores=jnp.linspace(-1.0, 1.0, 8 * K).reshape(8, K),
        loop_min_score=jnp.full(8, 0.05))
    s_t = convert.frame_summary_from_numpy(_np(s_j), device="cpu")
    assert s_t.loop_scores.shape == (8, K) and s_t.new_kf.dtype == torch.bool
    s_back = jfused.FrameSummary(**{k: jnp.asarray(v)
                                    for k, v in convert.frame_summary_to_numpy(s_t).items()})
    for a, b in zip(s_back, s_j):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_paths_the_slice_lacks_are_refused():
    # a file vocabulary loads, and localization mode works on top of it
    vocab = REPO / "orbslamm_tpu" / "data" / "vocab_10x4.npz"
    sess = MonocularSession(dataclasses.replace(CFG, vocabulary_path=str(vocab)), device="cpu")
    mc = sess.tracker.mapctx
    assert mc.voc.n_words == 10 ** 4 and tuple(mc.kf_bow.shape) == (8, 10 ** 4)
    sess.activate_localization_mode()
    assert sess.tracker.localization_only
    sess.deactivate_localization_mode()
    assert not sess.tracker.localization_only
    # on-device vocabulary training: loop closing on, no vocabulary file,
    # once the map holds 4 keyframes
    sess = MonocularSession(CFG, device="cpu")
    sess.tracker.mapctx.n_kf = 4
    img = np.zeros((CAM.height, CAM.width), np.uint8)
    with pytest.raises(NotImplementedError, match="step 9b"):
        sess.process_frame(img, 0.0)
    with pytest.raises(NotImplementedError, match="step 9b"):
        sess.activate_localization_mode()
    sess.enable_loop_closing = False
    sess.tracker.mapctx.n_kf = 0
    assert sess.process_frame(img, 0.0).state == "NOT_INITIALIZED"
    # stereo and RGB-D
    with pytest.raises(NotImplementedError, match="step 13"):
        MonocularSession(dataclasses.replace(CFG, sensor="stereo"), device="cpu")
    # the multi-map entry points
    from orbslamm_tpu_torch.models import loop_closing
    with pytest.raises(NotImplementedError, match="step 12"):
        sess.tracker.adopt_merged_map(None, None, None)
    for fn in (loop_closing.merge_scan_scores, loop_closing.batched_merge_scan_scores,
               loop_closing.compute_loop_sim3_cross):
        with pytest.raises(NotImplementedError, match="step 12"):
            fn()
