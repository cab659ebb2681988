"""Benchmark of the PyTorch/CUDA port (orbslamm_tpu_torch): bench.py's
metrics on one JSON line, on an NVIDIA GPU.

    python3 bench_torch.py [--device cuda|cpu]

The port of bench.py: the same configuration, sequences, seeds, chunking,
warm-ups and output keys, run by the port's sessions, MultiMapper and
StreamBank. Prints ONE JSON line (twice: once the moment phase 1
completes, so a timeout in phase 2 still leaves the number in the output
tail, and once complete):
  {"metric": "tracking_fps", "value": <single-stream fps>, "unit": "frames/s",
   "vs_baseline": <fps/30>, "single_ate_rmse_m": ..., "device": <card>,
   "multi": {"fps_per_stream": ..., "n_streams": 2, "merged": bool,
             "merged_ate_rmse_m": ...}}
``device`` is ``nvidia-smi``'s name and power limit of the card (``cpu``
when run on the CPU); every other key is bench.py's.

Phase 1, single stream: 640x480, 1000 ORB features, 8 levels, 4000 init
features, on a rendered forward-motion sequence of 248 frames through the
pipelined chunk path (chunk k+1 dispatched before chunk k's summaries are
read). Initialization and two warm-up chunks are excluded; the steady fps
and the Sim3-aligned ATE of the tracked frames are reported. Seed 7, then
12 if 7 gives no result.

Phase 2, two-robot merge: two robots on overlapping halves (280 of 440
frames, 120 shared) of one strafe sequence through the robot-parallel
StreamBank, sharing a MultiMapper; per-stream fps at the median, mean and
p90 chunk, whether the maps merged, and the ATE of both robots' frames on
the base map under one Sim3. Seed 21, then 5 if 21 does not merge.

The vocabulary file orbslamm_tpu/data/vocab_10x4.npz is read as data.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

_REPO = Path(__file__).resolve().parent

CHUNK = 8
SINGLE_FRAMES = 248  # phase 1's sequence
VOCAB = _REPO / "orbslamm_tpu" / "data" / "vocab_10x4.npz"
# main()'s seeds, in its order: a borderline two-view init is RNG-sensitive
SINGLE_SEEDS = (7, 12)
MULTI_SEEDS = (21, 5)
# phase 2's sequence, each robot's half of it (120 frames shared) and the
# robots' names (a name seeds its tracker's generator)
MULTI_FRAMES, MULTI_HALF = 440, 280
MULTI_NAMES = ("r0", "r1")


def _cfg():
    from orbslamm_tpu_torch.utils.config import (
        CameraConfig, CapacityConfig, LoopConfig, OrbConfig, SlamConfig, TrackingConfig,
    )

    cam = CameraConfig(width=640, height=480, fx=520.9, fy=521.0, cx=325.1,
                       cy=249.7, fps=30)
    return SlamConfig(
        camera=cam,
        # init_features 4000: the sprite renderer's wide-baseline feature
        # selection churn (not matching) caps init matches; a 4000-feature
        # init budget re-selects enough common structure to clear the
        # reference's 100-match bar at >= 1 deg parallax
        orb=OrbConfig(n_features=1000, max_keypoints=2048, init_features=4000),
        capacity=CapacityConfig(max_keyframes=128, max_landmarks=8192),
        tracking=TrackingConfig(pixel_noise=1.2),
        # production-scale vocabulary (10^4 words, the truncated-ORBvoc
        # size), loaded from the pretrained data file (System.cc:167-168)
        loop=LoopConfig(vocab_branching=10, vocab_depth=4),
        vocabulary_path=str(VOCAB) if VOCAB.exists() else None,
    )


def _synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def device_name(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    ``cpu``."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def bench_single(cfg, seed=7, device="cuda", *, details=False):
    """Phase 1 on ``seed``. Returns (result, error), one of them None;
    with ``details`` also a dict of the run (``sess``, ``seq``,
    ``init_frames``, ``n_meas``, ``n_ok``, ``chunk_times``)."""
    from orbslamm_tpu_torch.eval.ate import ate_from_poses
    from orbslamm_tpu_torch.io.synthetic import make_sequence
    from orbslamm_tpu_torch.models.system import MonocularSession, TrackingState

    n_frames = SINGLE_FRAMES
    seq = make_sequence(n_frames=n_frames, n_points=2500, cam=cfg.camera,
                        seed=seed, motion="forward")
    sess = MonocularSession(cfg, device=device)
    sess.tracker.chunk_size = CHUNK
    run = {"sess": sess, "seq": seq}

    def done(result, err):
        return (result, err, run) if details else (result, err)

    # warm-up: initialize (per-frame path; the matcher kernel is built at
    # its first use there) and run two chunks so every steady-state path
    # has run once before the clock starts
    i, streak = 0, 0
    while streak < 3 and i < n_frames // 2:
        r = sess.process_frame(seq.images[i], float(seq.timestamps[i]))
        streak = streak + 1 if r.state == "OK" else 0
        i += 1
    run["init_frames"] = i
    if sess.state != TrackingState.OK:
        return done(None, "initialization failed")
    for _ in range(2):
        sess.process_frames(seq.images[i:i + CHUNK], seq.timestamps[i:i + CHUNK])
        i += CHUNK
    _synchronize(device)

    # steady state: stream the remaining frames through the pipelined path,
    # timing each chunk so rare events (loop closure and its GBA slices)
    # show up as the median/mean split (mono_kitti_dif-Seq.cc:213-221)
    n0 = i
    t = sess.tracker
    recs = []
    chunk_times = []
    pending = None
    t0 = time.perf_counter()
    while i + CHUNK <= n_frames and sess.state == TrackingState.OK:
        c0 = time.perf_counter()
        tok = t._dispatch_chunk(seq.images[i:i + CHUNK], seq.timestamps[i:i + CHUNK])
        if pending is not None:
            recs.extend(t._finish_chunk(pending))
        pending = tok
        chunk_times.append(time.perf_counter() - c0)
        i += CHUNK
    if pending is not None:
        recs.extend(t._finish_chunk(pending))
    wall = time.perf_counter() - t0
    n_meas = i - n0
    n_ok = sum(1 for r in recs if r.state == "OK")
    run.update(n_meas=n_meas, n_ok=n_ok, chunk_times=chunk_times)
    if n_ok < n_meas - 3 * CHUNK:
        return done(None, f"tracking unstable ({n_ok}/{n_meas} OK)")
    fps = n_meas / wall
    fps_median = CHUNK / float(np.median(chunk_times))

    from orbslamm_tpu_torch.models.system import resolve_frame_poses

    ok = [f for f in sess.tracker.frames if f.state == "OK"]
    est = np.stack(resolve_frame_poses(ok))
    idx = [int(round(f.timestamp * cfg.camera.fps)) for f in ok]
    ate = ate_from_poses(est, seq.poses_cw[idx])
    return done({"fps": round(fps, 2), "fps_median": round(fps_median, 2),
                 "ate_rmse_m": round(float(ate), 4)}, None)


def _warm_rare_events(cfg, robots, device) -> None:
    """Run every rare-event function of the two-robot phase once on
    throwaway inputs, outside the timed window, so that first-call costs
    (the CUDA libraries' and the matcher's kernel loads) do not register as
    stall chunks: the global-BA slice, the essential graph, the cross-map
    Sim3 verification, the merge transplant, the follower replay, the
    tracking-state rebase and the seam fuse. The port's functions build new
    tensors and leave their inputs as they are. bench.py also compiles
    ``lm_indicator`` here: the port has no size-switched indicator programs
    (ROADMAP, "Not ported, by design"), and the bank builds its robots'
    indicators when it starts."""
    from orbslamm_tpu_torch.models import fused as fused_mod
    from orbslamm_tpu_torch.models import local_mapping as lm_mod
    from orbslamm_tpu_torch.models import loop_closing as lc_stage
    from orbslamm_tpu_torch.models.multimap import merge_maps
    from orbslamm_tpu_torch.ops import geometry as geo
    from orbslamm_tpu_torch.parallel.streams import _replay_kfs_device

    mc0, mc1 = robots[0].mapctx, robots[1].mapctx
    eye = torch.eye(4, dtype=torch.float32, device=device)
    lc_stage.global_bundle_adjust(cfg, mc0.map, iters=mc0.gba_slice_iters,
                                  cg_iters=mc0.gba_cg_iters)
    lc_stage.correct_loop(cfg, mc0.map, 1, 0, geo.sim3_from_se3(eye))
    ls_w = lc_stage.compute_loop_sim3_cross(cfg, mc1.map, mc0.map, 1, 1,
                                            torch.Generator(device=device).manual_seed(0))
    merge_maps(cfg, mc0.map, mc1.map, ls_w.S_ba, 0, 0, mc0.n_kf)
    if mc0.kf_bow is not None and mc0.voc is not None:
        _replay_kfs_device(cfg, mc0.map, mc0.kf_bow, mc0.voc, mc1.map, [-1] * 16,
                           mc0.map.lm_valid, mc0.n_kf, 0, True)
    fused_mod.rebase_track_state(robots[0]._make_ts(), eye, eye)
    lm_mod.fuse_neighbors(cfg, mc0.map, 1)
    _synchronize(device)


def bench_multi(cfg, n_points=2500, seed=21, device="cuda", *, mesh=None, details=False):
    """Two-robot overlapping-halves merge run through the StreamBank
    (robots over ``mesh``'s slots when one is given). Returns (result,
    error), one of them None; with ``details`` also a dict of the run
    (``seq``, ``starts``, ``mm``, ``robots``, ``offs``, ``frames0``,
    ``bank``, ``chunk_times``, ``merged_at``: the first timed chunk after
    which the MultiMapper had merged)."""
    from orbslamm_tpu_torch.eval.ate import ate_rmse
    from orbslamm_tpu_torch.io.synthetic import make_sequence
    from orbslamm_tpu_torch.models.multimap import MultiMapper
    from orbslamm_tpu_torch.models.system import TrackingState
    from orbslamm_tpu_torch.parallel.streams import StreamBank

    # reference-strength constants throughout: the 100-match init bar
    # (Tracking.cc:640) and the 15/20/40 merge gates (LoopConfig defaults)
    n_total = MULTI_FRAMES
    half = MULTI_HALF
    starts = [0, n_total - half]  # 120-frame overlap
    seq = make_sequence(n_frames=n_total, n_points=n_points, cam=cfg.camera,
                        seed=seed, motion="strafe")
    mm = MultiMapper(cfg, device=device)
    robots = [mm.add_robot(name) for name in MULTI_NAMES]
    run = {"seq": seq, "starts": starts, "mm": mm, "robots": robots, "merged_at": None}

    def done(result, err):
        return (result, err, run) if details else (result, err)

    offs = run["offs"] = []
    for k, t in enumerate(robots):
        i, streak = 0, 0
        while streak < 3 and i < half // 2:
            r = mm.process_frame(k, seq.images[starts[k] + i],
                                 float(seq.timestamps[starts[k] + i]))
            streak = streak + 1 if r.state == "OK" else 0
            i += 1
        if t.state != TrackingState.OK:
            return done(None, f"robot {k} failed to initialize")
        offs.append(i)
    start = max(offs)
    for k, t in enumerate(robots):
        for j in range(offs[k], start):
            mm.process_frame(k, seq.images[starts[k] + j],
                             float(seq.timestamps[starts[k] + j]))
    run["frames0"] = [len(t.frames) for t in robots]

    _warm_rare_events(cfg, robots, device)

    bank = run["bank"] = StreamBank(cfg, robots, device=device, mesh=mesh, chunk_size=CHUNK)
    # loss recovery inside the bank: new-map-on-loss (Tracking.cc:330-366)
    bank.on_lost = lambda t: mm._handle_loss(t, 0.0)
    bank.on_chunk_end = mm.pump_merge_scans

    def chunk_at(i):
        imgs = np.stack([
            np.stack(seq.images[starts[k] + i:starts[k] + i + CHUNK])
            for k in range(2)
        ])
        stamps = np.stack([
            seq.timestamps[starts[k] + i:starts[k] + i + CHUNK]
            for k in range(2)
        ])
        return imgs, stamps

    # warm-up chunks (the chunk step's first run, and the pipeline filled)
    i = start
    for _ in range(2):
        if i + CHUNK <= half:
            imgs, stamps = chunk_at(i)
            bank.process_chunk(imgs, stamps)
            i += CHUNK

    chunk_times = run["chunk_times"] = []
    n_meas = 0
    while i + CHUNK <= half:
        imgs, stamps = chunk_at(i)
        t0 = time.perf_counter()
        bank.process_chunk(imgs, stamps)
        chunk_times.append(time.perf_counter() - t0)
        if run["merged_at"] is None and mm.merges:
            run["merged_at"] = {"chunk": len(chunk_times) + 1, "stream_frame": i + CHUNK - 1,
                                "follower_pairs": dict(bank.followers)}
        n_meas += CHUNK
        i += CHUNK
    t0 = time.perf_counter()
    bank.flush()
    chunk_times[-1] += time.perf_counter() - t0
    bank.sync_to_trackers()
    mm.flush_merge_scans()  # drain the deferred scan pipeline
    # per-stream fps from the median chunk time (the reference reports the
    # median per-frame tracking time, mono_kitti_dif-Seq.cc:213-221); the
    # p90/max split shows the stall distribution (merge chunks)
    ct = np.asarray(chunk_times)
    fps_stream = CHUNK / float(np.median(ct))
    fps_p90 = CHUNK / float(np.percentile(ct, 90))
    fps_stream_mean = n_meas / float(np.sum(ct))
    merged = bool(mm.merges)
    ate = None
    if merged:
        # union ATE under ONE Sim3 alignment: certifies a consistent merged
        # map across both robots' trajectories. Poses are resolved through
        # reference keyframes so pre-merge frames ride all corrections
        # (System.cc:470-499)
        from orbslamm_tpu_torch.models.system import resolve_frame_poses

        mid = robots[0].mapctx.map_id
        est_c, gt_c = [], []
        for k, t in enumerate(robots):
            ok = [f for f in t.frames
                  if f.state == "OK" and f.map_id == mid]
            for f, T in zip(ok, resolve_frame_poses(ok)):
                R = T[:3, :3]
                tv = T[:3, 3]
                est_c.append(-R.T @ tv)
                g = seq.poses_cw[int(round(f.timestamp * cfg.camera.fps))]
                gt_c.append(-g[:3, :3].T @ g[:3, 3])
        if len(est_c) >= 10:
            ate = round(float(ate_rmse(np.stack(est_c), np.stack(gt_c))), 4)
    return done({
        "fps_per_stream": round(fps_stream, 2),
        "fps_per_stream_mean": round(fps_stream_mean, 2),
        "fps_per_stream_p90": round(fps_p90, 2),
        "max_chunk_s": round(float(np.max(ct)), 2),
        "n_chunks_measured": len(chunk_times),
        "n_streams": 2,
        "merged": merged,
        "merged_ate_rmse_m": ate,
        "states": [t.state.name for t in robots],
    }, None)


def single_line(out: dict, single, err) -> dict:
    """main()'s line after phase 1: the fps, its ratio to the 30 fps
    baseline and the ATE, or the error."""
    if single is None:
        out["error"] = err
        return out
    out["value"] = single["fps"]
    out["vs_baseline"] = round(single["fps"] / 30.0, 3)
    out["single_ate_rmse_m"] = single["ate_rmse_m"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    device = ap.parse_args(argv).device
    if device == "cuda" and not torch.cuda.is_available():
        print("bench_torch: no CUDA device (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return 2
    cfg = _cfg()
    out = {"metric": "tracking_fps", "value": 0.0, "unit": "frames/s",
           "vs_baseline": 0.0, "device": device_name(device)}
    single = err = None
    for seed in SINGLE_SEEDS:
        single, err = bench_single(cfg, seed=seed, device=device)
        if single is not None:
            break
    single_line(out, single, err)
    print(json.dumps(out), flush=True)
    if single is None:
        return 1
    try:
        multi = merr = None
        for seed in MULTI_SEEDS:
            multi, merr = bench_multi(cfg, seed=seed, device=device)
            if multi is not None and multi.get("merged"):
                break
        if multi is None:
            out["multi"] = {"error": merr}
        else:
            out["multi"] = multi
    except Exception as e:  # never lose the single-stream number
        out["multi"] = {"error": f"{type(e).__name__}: {e}"}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
