"""Package-level checks of orbslamm_tpu_torch: it imports neither jax nor the
JAX package, its copies of the JAX package's numpy-only modules (config,
synthetic sequences, ATE) and generators are exact, its converters carry a
map across both ways, the CPU matcher never launches the CUDA kernel, the
paths of earlier steps that once were refused now run (the bank's device
mesh among them)."""

import ast
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


def _foreign(name: str | None) -> bool:
    return name is not None and any(name == p or name.startswith(p + ".")
                                    for p in ("jax", "orbslamm_tpu"))


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in [*(REPO / "orbslamm_tpu_torch").rglob("*.py"),
                                       REPO / "chip_smoke.py", REPO / "bench_torch.py",
                                       REPO / "tools" / "make_vocab_torch.py"]))
def test_port_sources_import_nothing_of_jax_or_the_jax_package(path):
    """No ``import jax``, ``from jax``, ``import orbslamm_tpu`` or
    ``from orbslamm_tpu.`` anywhere in the port's sources, chip_smoke.py,
    bench_torch.py or tools/make_vocab_torch.py, at top level or inside a
    function."""
    tree = ast.parse((REPO / path).read_text(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _foreign(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and _foreign(node.module):
            bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_port_never_imports_jax():
    """A fresh interpreter imports the whole port (the I/O modules, the
    renderings, the viewer, the driver, every command line, the entry
    points, bench_torch.py and tools/make_vocab_torch.py included),
    runs a few frames of the
    session on the CPU on a sequence from the port's own synthetic module,
    and has loaded neither jax nor any module of the JAX package."""
    script = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        torch.set_num_threads(2)
        import orbslamm_tpu_torch
        from orbslamm_tpu_torch import convert
        from orbslamm_tpu_torch.models import (fused, local_mapping, loop_closing, map_state,
                                               multimap, system, tracking)
        from orbslamm_tpu_torch.ops import ba, bow, geometry, matching, orb, ransac
        from orbslamm_tpu_torch.ops.cuda import hamming, nvcc, segsum
        from orbslamm_tpu_torch.parallel import (dist_ba, multihost, multihost_demo,
                                                 multihost_mapper, streams)
        from orbslamm_tpu_torch.utils import trace
        from orbslamm_tpu_torch import driver, entry
        import importlib.util
        for name, path in (("bench_torch", "bench_torch.py"),
                           ("make_vocab_torch", "tools/make_vocab_torch.py")):
            spec = importlib.util.spec_from_file_location(name, path)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        from orbslamm_tpu_torch.examples import (
            convert_gt_to_quaternion, mono_agz, mono_eth, mono_kitti, mono_kitti_dif_seq,
            mono_live, mono_newcollege, mono_synthetic, mono_tum)
        from orbslamm_tpu_torch.io import datasets, native, serialize, trajectory, viewer, viz
        from orbslamm_tpu_torch.io.synthetic import make_sequence
        from orbslamm_tpu_torch.eval import ate
        from orbslamm_tpu_torch.utils.config import (CameraConfig, CapacityConfig,
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
        assert segsum.launches == 0
        assert ate.ate_from_poses(seq.poses_cw, seq.poses_cw) < 1e-6
        foreign = sorted(m for m in sys.modules
                         if m == "jax" or m.startswith("jax.")
                         or m == "orbslamm_tpu" or m.startswith("orbslamm_tpu."))
        assert not foreign, foreign
        print("NOJAX_OK")
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "NOJAX_OK" in out.stdout


YAML = """%YAML:1.0
Camera.fx: 300.5
Camera.fy: 301.0
Camera.cx: 159.5
Camera.cy: 119.5
Camera.k1: 0.01
Camera.fps: 20.0
Camera.RGB: 0
Camera.width: 320
Camera.height: 240
Camera.bf: 40.0
ThDepth: 35.0
ORBextractor.nFeatures: 600  # comment
ORBextractor.scaleFactor: 1.25
ORBextractor.nLevels: 6
ORBextractor.iniThFAST: 18
ORBextractor.minThFAST: 6
Tracking.pixelNoise: 1.2
"""


def test_config_copy_equals_the_original(tmp_path):
    """The port's config module: the default SlamConfig, the OpenCV-YAML
    parser and load_settings (on a default base and on a changed one) give
    the same fields as the JAX package's, and the copy holds every name."""
    from orbslamm_tpu.utils import config as jc
    from orbslamm_tpu_torch.utils import config as tc

    names = ("CameraConfig", "OrbConfig", "MatcherConfig", "TrackingConfig",
             "MappingConfig", "LoopConfig", "CapacityConfig", "SlamConfig",
             "load_settings", "_parse_opencv_yaml", "_next_pow2")
    assert all(hasattr(tc, n) for n in names)
    assert dataclasses.asdict(tc.SlamConfig()) == dataclasses.asdict(jc.SlamConfig())
    assert tc._parse_opencv_yaml(YAML) == jc._parse_opencv_yaml(YAML)
    path = tmp_path / "settings.yaml"
    path.write_text(YAML)
    assert dataclasses.asdict(tc.load_settings(path)) == dataclasses.asdict(jc.load_settings(path))
    base_t = tc.SlamConfig(orb=tc.OrbConfig(max_keypoints=512), sensor="stereo")
    base_j = jc.SlamConfig(orb=jc.OrbConfig(max_keypoints=512), sensor="stereo")
    got = tc.load_settings(path, base=base_t)
    assert dataclasses.asdict(got) == dataclasses.asdict(jc.load_settings(path, base=base_j))
    assert got.orb.max_keypoints == 1024 and got.camera.K().dtype == np.float32
    assert [tc._next_pow2(n) for n in (1, 5, 64, 1000)] == [1, 8, 64, 1024]


@pytest.mark.parametrize("motion,seed", [("forward", 7), ("forward", 12),
                                         ("outback", 13), ("outback", 14)])
def test_synthetic_sequence_copy_equals_the_original(motion, seed):
    """make_sequence of both packages, array for array, at test size."""
    from orbslamm_tpu.io import synthetic as js
    from orbslamm_tpu_torch.io import synthetic as ts
    from orbslamm_tpu_torch.utils.config import CameraConfig as TCam

    cam_t = TCam(width=160, height=120, fx=130, fy=130, cx=80, cy=60, fps=30)
    a = ts.make_sequence(n_frames=5, n_points=400, cam=cam_t, seed=seed, motion=motion)
    b = js.make_sequence(n_frames=5, n_points=400, cam=CAM, seed=seed, motion=motion)
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert (x is None and y is None) or (x.dtype == y.dtype and np.array_equal(x, y)), f.name
    assert a.images.any()


def test_synthetic_helpers_copy_equal_the_originals(tmp_path):
    """The scene helpers and the TUM export (files byte for byte)."""
    from orbslamm_tpu.io import synthetic as js
    from orbslamm_tpu_torch.io import synthetic as ts

    assert np.array_equal(ts.make_landmark_field(300, seed=4), js.make_landmark_field(300, seed=4))
    assert np.array_equal(ts.make_stamps(50, pool=7, seed=5), js.make_stamps(50, pool=7, seed=5))
    seq = js.make_sequence(n_frames=3, n_points=300, cam=CAM, seed=2, with_depth=True)
    pts, T = seq.points_w, seq.poses_cw[1]
    bright = np.full(len(pts), 200.0, np.float32)
    assert np.array_equal(ts.render_view(pts, T, CAM, bright), js.render_view(pts, T, CAM, bright))
    assert np.array_equal(ts.render_depth(pts, T, CAM), js.render_depth(pts, T, CAM))
    pytest.importorskip("PIL")
    out_t = ts.export_tum_sequence(seq, tmp_path / "t")
    out_j = js.export_tum_sequence(seq, tmp_path / "j")
    names = sorted(p.relative_to(out_j) for p in out_j.rglob("*") if p.is_file())
    assert names == sorted(p.relative_to(out_t) for p in out_t.rglob("*") if p.is_file())
    for name in names:
        assert (out_t / name).read_bytes() == (out_j / name).read_bytes(), name


def test_fabricate_map_copy_equals_the_original():
    """The port's fabricate_map builds, field for field, the map the JAX
    package's builds from the same arguments (same numpy draws)."""
    from orbslamm_tpu.io import synthetic as js
    from orbslamm_tpu_torch.io import synthetic as ts

    rng = np.random.default_rng(21)
    pts = js.make_landmark_field(200, extent=4.0, seed=21)
    desc = rng.integers(0, 256, (200, 32), dtype=np.uint8)
    poses = np.stack([np.eye(4, dtype=np.float32)] * 3)
    poses[:, 0, 3] = [0.0, -0.3, -0.6]
    share = rng.random(200) > 0.2
    kw = dict(frame_ids=np.array([0, 4, 9]), seed=3, share_landmarks=share,
              point_ref_kf=rng.integers(0, 3, 200).astype(np.int32))
    m_j, slot_j = js.fabricate_map(CFG, poses, pts, desc, **kw)
    m_t, slot_t = ts.fabricate_map(CFG, poses, pts, desc, **kw, device="cpu")
    assert np.array_equal(slot_t, slot_j)
    got = convert.map_state_to_numpy(m_t)
    for k in jms.MapState._fields:
        want = np.asarray(getattr(m_j, k))
        assert got[k].dtype == want.dtype and np.array_equal(got[k], want), k
    assert int(m_t.n_kf) == 3 and int(m_t.lm_valid.sum()) == int(share.sum())


def test_ate_copy_equals_the_original():
    """ate_from_poses, ate_rmse (every alignment) and associate of both
    packages on the same trajectories: equal to the last bit."""
    from orbslamm_tpu.eval import ate as ja
    from orbslamm_tpu.io import synthetic as js
    from orbslamm_tpu_torch.eval import ate as ta

    gt = js.make_sequence(n_frames=12, n_points=300, cam=CAM, seed=5, motion="outback").poses_cw
    rng = np.random.default_rng(5)
    est = gt.copy()
    est[:, :3, 3] = 0.7 * est[:, :3, 3] + rng.normal(0, 0.01, (12, 3))
    for align in ("sim3", "se3", "none"):
        assert ta.ate_from_poses(est, gt, align) == ja.ate_from_poses(est, gt, align)
        assert ta.ate_rmse(est[:, :3, 3], gt[:, :3, 3], align) == \
            ja.ate_rmse(est[:, :3, 3], gt[:, :3, 3], align)
    assert ta.ate_from_poses(est[:2], gt[:2]) == float("inf")
    t_est = np.arange(10) / 30.0 + 0.004
    t_gt = np.arange(0, 12) / 30.0
    for a, b in zip(ta.associate(t_est, t_gt), ja.associate(t_est, t_gt)):
        assert np.array_equal(a, b)


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
    # once the map holds 4 keyframes (here 4 keyframes of random features)
    from orbslamm_tpu_torch.io.synthetic import fabricate_map, make_landmark_field
    rng = np.random.default_rng(4)
    pts = make_landmark_field(300, extent=4.0, seed=4)
    poses = np.stack([np.eye(4, dtype=np.float32)] * 4)
    poses[:, 0, 3] = [0.0, -0.2, -0.4, -0.6]
    m, _ = fabricate_map(CFG, poses, pts, rng.integers(0, 256, (300, 32), dtype=np.uint8),
                         device="cpu")
    sess = MonocularSession(CFG, device="cpu")
    mc = sess.tracker.mapctx
    mc.map = m
    img = np.zeros((CAM.height, CAM.width), np.uint8)
    assert sess.process_frame(img, 0.0).state == "NOT_INITIALIZED" and mc.voc is None
    mc.n_kf = 4
    sess.process_frame(img, 0.0)
    assert mc.voc is not None and mc.voc.n_words == 8 ** 3
    assert torch.allclose(mc.kf_bow[:4].sum(-1), torch.ones(4))  # every keyframe's row
    sess.activate_localization_mode()
    assert sess.tracker.localization_only
    # stereo and RGB-D (step 13) are ported: their sessions refuse a
    # camera without a baseline and take one with a rig
    from orbslamm_tpu_torch.models.system import RGBDSession, StereoSession
    for kind, sensor in ((StereoSession, "stereo"), (RGBDSession, "rgbd")):
        with pytest.raises(ValueError, match="bf > 0"):
            kind(CFG, device="cpu")
        rig = dataclasses.replace(CFG, camera=dataclasses.replace(CAM, bf=40.0))
        assert kind(rig, device="cpu").tracker.cfg.sensor == sensor
    # the robot-parallel bank, on one device or with its robot axis over a
    # device mesh (step 14b)
    from orbslamm_tpu_torch.parallel.multihost import stream_mesh
    from orbslamm_tpu_torch.parallel.streams import StreamBank
    assert StreamBank(CFG, [sess.tracker], device="cpu",
                      mesh=stream_mesh(["cpu"])).n_streams == 1
    assert StreamBank(CFG, [sess.tracker], device="cpu").n_streams == 1
    # the multi-map entry points: a MultiMapper, the cross-map scan and
    # Sim3 between the session's map and itself, and the adoption of a
    # merged map with the identity Sim3
    from orbslamm_tpu_torch.models import loop_closing
    from orbslamm_tpu_torch.models.multimap import MultiMapper
    from orbslamm_tpu_torch.ops import geometry
    mm = MultiMapper(CFG, device="cpu")
    assert mm.add_robot().name == "robot0" and mm.summary()["n_maps"] == 1
    scores, min_score, acc, nb = loop_closing.merge_scan_scores(CFG, m, mc.kf_bow, 3, m,
                                                                mc.kf_bow)
    assert float(scores[3]) == pytest.approx(1.0) and tuple(nb.shape) == (8, 8)
    batched = loop_closing.batched_merge_scan_scores(CFG, m, mc.kf_bow, [3, 2], m, mc.kf_bow)
    assert torch.equal(batched[0][0], scores) and tuple(batched[3].shape) == (2, 8, 8)
    ls = loop_closing.compute_loop_sim3_cross(CFG, m, m, 1, 2, torch.Generator().manual_seed(0))
    assert ls.S_ba.shape == (8,) and int(ls.n_inliers) >= 0
    tr = mm.robots[0]
    tr.T_cw = torch.as_tensor(poses[1])
    tr.last_lm = torch.tensor([-1, 0, 5], dtype=torch.int32)
    remap = torch.arange(512, dtype=torch.int32) + 7
    tr.adopt_merged_map(mc, geometry.sim3_identity(device="cpu"), remap)
    assert tr.mapctx is mc and torch.allclose(tr.T_cw, torch.as_tensor(poses[1]), atol=1e-6)
    assert tr.last_lm.tolist() == [-1, 7, 12]
    # the driver (step 15a) runs, and with viewer_port (step 15b) it starts
    # the live viewer for the run and stops it at the end: the feed, pulled
    # while the run goes on, reads /state from it
    import json
    import socket
    import urllib.error
    import urllib.request

    from orbslamm_tpu_torch.driver import RobotFeed, run_robots
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    url = f"http://127.0.0.1:{port}/state"
    seen = []

    def feed():
        seen.append(json.loads(urllib.request.urlopen(url, timeout=60).read()))
        yield from ()

    mm, report = run_robots(CFG, [RobotFeed(feed(), "r0")], viewer_port=port, verbose=False,
                            device="cpu")
    assert [r["name"] for r in seen[0]["robots"]] == ["r0"] and seen[0]["merges"] == []
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(url, timeout=60)
    mm, report = run_robots(CFG, [RobotFeed([], "r0")], verbose=False, device="cpu")
    assert mm.robots[0].name == "r0" and report.timing_summary() == {}
