"""The port's robot-parallel StreamBank alone on the CPU (320x240), on
tests/test_streams.py::test_bank_cross_robot_merge_owner_follower's
scenario: two robots on overlapping halves of one strafe sequence, one
MultiMapper, the file vocabulary and the test's lenient merge gates. The
halves are cut from 152 to 88 frames (robot 1 from frame 30 instead of 48)
to fit the CPU: the port tracks about one frame a second per robot here.

  * the two maps merge inside the bank, the absorbed robot becomes a
    follower, and its keyframes are replayed into the shared map at sync
    points; the merged map's trajectories stay within 0.6 m ATE;
  * robot 0 alone in a 1-robot bank tracks its first two chunks exactly as
    in the 2-robot bank: the bank runs its robots one after another, with
    no operation across robots (the JAX package vmaps one program over the
    robot axis, which may reorder float reductions; nothing here does), so
    robot 0 sees the same operations on the same inputs, and the tolerance
    is zero;
  * a loss inside that 1-robot bank: blank frames lose tracking, the
    MultiMapper's hook gives the robot a new map, the per-frame path
    initializes it, and ``reset_stream`` re-adopts the robot into the bank.

The pieces are held against the JAX package in tests/test_torch_streams.py.
"""

import copy
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from orbslamm_tpu_torch.eval.ate import ate_from_poses
from orbslamm_tpu_torch.io.synthetic import make_sequence
from orbslamm_tpu_torch.models.multimap import MultiMapper
from orbslamm_tpu_torch.models.system import TrackingState, resolve_frame_poses
from orbslamm_tpu_torch.parallel.streams import StreamBank
from orbslamm_tpu_torch.utils.config import (
    CameraConfig, CapacityConfig, LoopConfig, OrbConfig, SlamConfig, TrackingConfig,
)

torch.set_num_threads(2)

CAM = CameraConfig(width=320, height=240, fx=260, fy=260, cx=160, cy=120, fps=30)
VOCAB = Path(__file__).resolve().parents[1] / "orbslamm_tpu" / "data" / "vocab_10x4.npz"
# tests/test_streams.py's configuration, vocabulary and merge gates
CFG = SlamConfig(
    camera=CAM,
    orb=OrbConfig(n_features=600, max_keypoints=1024, n_levels=4),
    capacity=CapacityConfig(max_keyframes=64, max_landmarks=4096),
    tracking=TrackingConfig(pixel_noise=1.2, min_matches_init=60, init_min_triangulated=45,
                            init_min_parallax_deg=0.7),
    vocabulary_path=str(VOCAB),
    loop=dataclasses.replace(LoopConfig(), min_sim3_inliers=10, min_bow_matches=10,
                             min_kfs_for_merge=6),
)
N_TOTAL, HALF, STARTS = 200, 88, (0, 30)
CHUNK = 8


def _robots(mm, seq, names):
    """Each robot initialized frame by frame on its half, then all caught
    up to a common start (tests/test_streams.py's bootstrap). Returns the
    start."""
    offs = []
    for k, name in enumerate(names):
        t = mm.add_robot(name)
        i = 0
        while t.state != TrackingState.OK and i < HALF:
            mm.process_frame(k, seq.images[STARTS[k] + i], float(seq.timestamps[STARTS[k] + i]))
            i += 1
        assert t.state == TrackingState.OK, f"{name} failed to initialize"
        offs.append(i)
    start = max(offs)
    for k in range(len(names)):
        for j in range(offs[k], start):
            mm.process_frame(k, seq.images[STARTS[k] + j], float(seq.timestamps[STARTS[k] + j]))
    return start


def _bank(mm):
    bank = StreamBank(CFG, mm.robots, device="cpu", chunk_size=CHUNK)
    bank.on_lost = lambda t: mm._handle_loss(t, 0.0)
    bank.on_chunk_end = mm.pump_merge_scans
    return bank


def _chunk(seq, n_robots, i):
    imgs = np.stack([np.stack(seq.images[STARTS[k] + i:STARTS[k] + i + CHUNK])
                     for k in range(n_robots)])
    stamps = np.stack([seq.timestamps[STARTS[k] + i:STARTS[k] + i + CHUNK]
                       for k in range(n_robots)])
    return imgs, stamps


def _copy_map(m):
    return type(m)(*(x.clone() for x in m))


@pytest.fixture(scope="module")
def merge_run():
    """Both robots through one bank to the end of the halves; robot 0's
    records and slice after its first two chunks are kept."""
    seq = make_sequence(n_frames=N_TOTAL, n_points=2500, cam=CAM, seed=21, motion="strafe")
    mm = MultiMapper(CFG, device="cpu")
    start = _robots(mm, seq, ("r0", "r1"))
    bank = _bank(mm)
    i, c, early = start, 0, None
    while i + CHUNK <= HALF:
        bank.process_chunk(*_chunk(seq, 2, i))
        i, c = i + CHUNK, c + 1
        if c == 2:
            early = (_copy_map(bank.m_all[0]), bank.flush()[0],
                     copy.deepcopy(mm.robots[0].frames))
    bank.sync_to_trackers()
    mm.flush_merge_scans()  # drain the deferred scan pipeline
    return dict(seq=seq, mm=mm, bank=bank, start=start, early=early)


def test_bank_merges_robots_into_owner_and_follower(merge_run):
    """tests/test_streams.py's assertions: a merge, an owner/follower pair,
    follower keyframes replayed into the shared map, both robots OK for the
    bulk of the run, and each robot's frames on the merged map within 0.6 m
    ATE."""
    mm, bank, seq = merge_run["mm"], merge_run["bank"], merge_run["seq"]
    assert mm.merges, "no cross-map merge happened in the bank"
    assert bank.count("bank_follower") >= 1, bank.events
    assert bank.count("bank_replay_kf") >= 1 and bank.sync_points >= 1, bank.events
    for t in mm.robots:
        ok = [f for f in t.frames if f.state == "OK"]
        assert len(ok) > 0.6 * HALF, f"{t.name}: only {len(ok)} OK frames"
    base_id = mm.merges[0][1]
    for t in mm.robots:
        ok = [f for f in t.frames if f.state == "OK" and f.map_id == base_id]
        assert len(ok) > 20, f"{t.name}: only {len(ok)} merged-map frames"
        est = np.stack(resolve_frame_poses(ok))
        idx = [int(round(f.timestamp * CAM.fps)) for f in ok]
        ate = ate_from_poses(est, seq.poses_cw[idx])
        assert ate < 0.6, f"{t.name} merged-map ATE {ate:.3f}"
    # every replayed keyframe landed in a fresh slot of the shared map
    dst = [f["dst_slot"] for n, f in bank.events if n == "bank_replay_kf"]
    assert len(set(dst)) == len(dst)


@pytest.fixture(scope="module")
def solo(merge_run):
    """Robot 0 alone, on its own MultiMapper, in a 1-robot bank over the same
    first two chunks."""
    seq = merge_run["seq"]
    mm = MultiMapper(CFG, device="cpu")
    start = _robots(mm, seq, ("r0",))
    for j in range(start, merge_run["start"]):
        mm.process_frame(0, seq.images[j], float(seq.timestamps[j]))
    bank = _bank(mm)
    i = merge_run["start"]
    for _ in range(2):
        bank.process_chunk(*_chunk(seq, 1, i))
        i += CHUNK
    early = (_copy_map(bank.m_all[0]), bank.flush()[0], copy.deepcopy(mm.robots[0].frames))
    return dict(seq=seq, mm=mm, bank=bank, i=i, early=early)


def test_two_robot_bank_tracks_robot0_as_a_one_robot_bank(merge_run, solo):
    (m_a, last_a, frames_a), (m_b, last_b, frames_b) = merge_run["early"], solo["early"]
    assert len(last_a) == len(last_b) == CHUNK
    assert len(frames_a) == len(frames_b)
    for fa, fb in zip(frames_a, frames_b):
        assert (fa.frame_id, fa.state, fa.n_inliers, fa.ref_slot) == \
            (fb.frame_id, fb.state, fb.n_inliers, fb.ref_slot)
        assert np.array_equal(fa.T_cw, fb.T_cw)
        assert (fa.T_rel is None) == (fb.T_rel is None)
        assert fa.T_rel is None or np.array_equal(fa.T_rel, fb.T_rel)
    assert all(f.state == "OK" for f in frames_a[-2 * CHUNK:])
    for name, x, y in zip(m_a._fields, m_a, m_b):
        assert torch.equal(x, y), name


def test_loss_in_the_bank_gives_a_new_map_and_readopts(solo):
    """Robot 0's 1-robot bank goes on: blank frames lose tracking, the
    MultiMapper gives it a new map (its first map has enough keyframes to
    keep), the per-frame path initializes it, and the bank re-adopts it: its
    last chunk runs in the bank, on the new map."""
    mm, bank, seq, i = solo["mm"], solo["bank"], solo["seq"], solo["i"]
    t = mm.robots[0]
    first = t.mapctx
    while first.n_kf < CFG.tracking.min_kfs_for_new_map:
        bank.process_chunk(*_chunk(seq, 1, i))
        i += CHUNK
    imgs, stamps = _chunk(seq, 1, i)
    bank.process_chunk(np.zeros_like(imgs), stamps)  # blank frames
    i += CHUNK
    # the loss is seen one chunk late; the per-frame path then initializes
    # a new map, and the bank re-adopts the robot once it is OK
    for _ in range(8):
        gen = bank._gens[0]
        bank.process_chunk(*_chunk(seq, 1, i))
        i += CHUNK
        if t.state == TrackingState.OK and bank._gens[0] != gen:
            break
    bank.process_chunk(*_chunk(seq, 1, i))
    last = bank.flush()[0]  # the last chunk's records, if it ran in the bank
    bank.sync_to_trackers()
    assert any(f.state == "LOST" for f in t.frames)
    assert t.mapctx is not first and len(mm.live_maps()) == 2
    assert first.n_kf >= CFG.tracking.min_kfs_for_new_map  # the first map was kept
    assert t.state == TrackingState.OK and t.mapctx.n_kf >= 2
    # re-adopted: the last chunk ran in the bank, on the new map
    assert len(last) == CHUNK and last == t.frames[-CHUNK:]
    assert all(f.state == "OK" and f.map_id == t.mapctx.map_id for f in last)
    assert int(bank.m_all[0].n_kf) == t.mapctx.n_kf
