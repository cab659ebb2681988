"""The port's MultiMapper alone on the CPU, on tests/test_multimap.py's
session scenarios (320x240, 600 features), with no vocabulary file so that
the vocabulary is trained from the first map on the way:

  * a kidnap at frame 30 loses tracking and a second map grows;
  * a kidnap at frame 40 and a return at frame 70: the maps that recognise
    each other merge, and the base map's keyframes stay near ground truth.

The JAX package runs the same scenarios in tests/test_multimap.py; the
pieces are held against it in tests/test_torch_multimap.py.
"""

import numpy as np
import pytest
import torch

from orbslamm_tpu_torch.eval.ate import ate_from_poses
from orbslamm_tpu_torch.io.synthetic import make_sequence
from orbslamm_tpu_torch.models.multimap import MultiMapper
from orbslamm_tpu_torch.models.system import resolve_frame_poses
from orbslamm_tpu_torch.utils.config import (
    CameraConfig, CapacityConfig, OrbConfig, SlamConfig, TrackingConfig,
)

torch.set_num_threads(2)

CAM = CameraConfig(width=320, height=240, fx=260, fy=260, cx=160, cy=120, fps=30)
TRACKING = TrackingConfig(pixel_noise=1.2, min_matches_init=55, init_min_triangulated=30,
                          init_min_parallax_deg=0.4)


def _run(cfg, seq):
    mm = MultiMapper(cfg, device="cpu")
    mm.add_robot("r0")
    states = [mm.process_frame(0, seq.images[i], float(seq.timestamps[i])).state
              for i in range(len(seq.images))]
    return mm, states


@pytest.fixture(scope="module")
def kidnap():
    cfg = SlamConfig(camera=CAM, orb=OrbConfig(n_features=600, max_keypoints=1024, n_levels=4),
                     capacity=CapacityConfig(max_keyframes=64, max_landmarks=4096),
                     tracking=TRACKING)
    seq = make_sequence(n_frames=60, n_points=1400, cam=CAM, seed=7, kidnap_at=30)
    return _run(cfg, seq)


@pytest.fixture(scope="module")
def kidnap_return():
    cfg = SlamConfig(camera=CAM, orb=OrbConfig(n_features=600, max_keypoints=1024, n_levels=4),
                     capacity=CapacityConfig(max_keyframes=96, max_landmarks=8192),
                     tracking=TRACKING)
    seq = make_sequence(n_frames=100, n_points=1400, cam=CAM, seed=7, kidnap_at=40,
                        return_at=70)
    mm, states = _run(cfg, seq)
    mm.flush_merge_scans()  # drain the deferred scan pipeline
    return mm, states, seq


def test_kidnap_creates_new_map(kidnap):
    """The kidnap loses tracking and the robot continues in a new map; both
    maps stay live with keyframes, and tracking recovered."""
    mm, states = kidnap
    assert "LOST" in states
    live = mm.live_maps()
    assert len(live) >= 2, mm.summary()
    assert len([m for m in live if m.n_kf >= 2]) >= 2, [m.n_kf for m in live]
    assert states[-1] == "OK" or states[-2] == "OK"


def test_kidnap_trains_one_vocabulary_for_every_map(kidnap):
    """No vocabulary file: the first map trains one once it holds 4
    keyframes, and every map shares it with a database row per keyframe."""
    mm, _ = kidnap
    assert mm.voc is not None and mm.voc.n_words == 8 ** 3
    for mc in mm.maps:
        assert mc.voc is mm.voc and mc.kf_bow.shape == (64, 8 ** 3)
        rows = mc.kf_bow[: mc.n_kf].sum(-1)
        assert torch.allclose(rows[mc.map.kf_valid[: mc.n_kf]], torch.ones(1), atol=1e-5)


def test_kidnap_and_return_merges_maps(kidnap_return):
    """The fr2_360_kidnap scenario: kidnap, new map, return to the start;
    the MultiMapper's own scan finds the overlap and merges; the base map
    spans both regions and its keyframes stay within 0.6 m ATE."""
    mm, _, seq = kidnap_return
    assert len(mm.merges) >= 1, mm.summary()
    base = next(m for m in mm.maps if m.map_id == mm.merges[0][1])
    assert base.merged_into is None and base.n_kf >= 18, base.summary()
    kv = base.map.kf_valid.numpy()
    fids = base.map.kf_frame_id.numpy()[kv]
    ate = ate_from_poses(base.map.kf_pose.numpy()[kv], seq.poses_cw[fids])
    assert ate < 0.6, f"merged-map ATE {ate}"


def test_merged_frames_resolve_on_the_base_map(kidnap_return):
    """After the merge the robot tracks the base map, the absorbed map's
    frames were re-pointed at the base map's transplanted keyframes, and
    every OK frame on the base map resolves to a finite pose."""
    mm, states, _ = kidnap_return
    absorbed, base_id = mm.merges[0][:2]
    r = mm.robots[0]
    assert r.mapctx.map_id == base_id and states[-1] == "OK"
    assert not [f for f in r.frames if f.map_id == absorbed and f.state == "OK"]
    ok = [f for f in r.frames if f.state == "OK" and f.map_id == base_id]
    assert len(ok) >= 40
    poses = np.stack(resolve_frame_poses(ok))
    assert np.isfinite(poses).all()
