"""Two-process cross-host merge demonstration (SURVEY §5.8), the port's
counterpart of tools/multihost_demo.py.

Each process runs one robot over its part of a shared synthetic strafe
scene (the mono_kitti_dif-Seq split-sequence pattern across processes
instead of threads), with its own MultiMapper. A HostMapperBridge exchanges
map signatures over the gloo process group; the process whose database
recognizes the other's map pulls its payload and merges it through the
Sim3-verified pipeline. Same scenario, configuration and result keys as the
JAX tool.

Run (two shells; ``--device`` has no default):

  python -m orbslamm_tpu_torch.parallel.multihost_demo --process-id 0 \\
      --num-processes 2 --coordinator localhost:19876 --device cpu --out mh0.json
  python -m orbslamm_tpu_torch.parallel.multihost_demo --process-id 1 \\
      --num-processes 2 --coordinator localhost:19876 --device cpu --out mh1.json

With ``--device cuda`` both processes may share one card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np

from orbslamm_tpu_torch.parallel import multihost as mh

VOCAB = Path(__file__).resolve().parents[2] / "orbslamm_tpu" / "data" / "vocab_10x4.npz"


def demo_cfg():
    """The JAX tool's configuration: 320x240, 600 features, 4 levels, 64
    keyframes, 4096 landmarks, merges from 6 keyframes on, the repository's
    10^4-word vocabulary."""
    from orbslamm_tpu_torch.utils.config import (
        CameraConfig, CapacityConfig, LoopConfig, OrbConfig, SlamConfig, TrackingConfig,
    )

    cam = CameraConfig(width=320, height=240, fx=260, fy=260, cx=160, cy=120, fps=30)
    return SlamConfig(
        camera=cam,
        orb=OrbConfig(n_features=600, max_keypoints=1024, n_levels=4),
        capacity=CapacityConfig(max_keyframes=64, max_landmarks=4096),
        tracking=TrackingConfig(pixel_noise=1.2, min_matches_init=60, init_min_triangulated=45,
                                init_min_parallax_deg=0.4),
        loop=dataclasses.replace(LoopConfig(), min_sim3_inliers=10, min_bow_matches=10,
                                 min_kfs_for_merge=6),
        vocabulary_path=str(VOCAB) if VOCAB.exists() else None,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--coordinator", default="localhost:19876")
    ap.add_argument("--device", required=True, help="cuda, cuda:N or cpu")
    ap.add_argument("--out", default="")
    ap.add_argument("--frames", type=int, default=168)
    args = ap.parse_args(argv)

    import torch

    mh.initialize(coordinator_address=args.coordinator, num_processes=args.num_processes,
                  process_id=args.process_id)
    pid = mh.process_index()
    if args.device == "cpu":
        torch.set_num_threads(2)

    from orbslamm_tpu_torch.eval.ate import ate_from_poses
    from orbslamm_tpu_torch.io.synthetic import make_sequence
    from orbslamm_tpu_torch.models.multimap import MultiMapper
    from orbslamm_tpu_torch.models.system import resolve_frame_poses
    from orbslamm_tpu_torch.parallel.multihost_mapper import HostMapperBridge

    cfg = demo_cfg()
    cam = cfg.camera
    # vocabulary consistency across hosts: the same file on every host here
    # (broadcast_pytree would ship it if only host 0 had the file)
    n_total = args.frames
    half = int(n_total * 0.64)
    starts = [0, n_total - half]
    seq = make_sequence(n_frames=n_total, n_points=1800, cam=cam, seed=21, motion="strafe")
    mm = MultiMapper(cfg, device=args.device)
    robot = mm.add_robot(f"host{pid}")
    bridge = HostMapperBridge(mm)

    s0 = starts[pid]
    for i in range(half):
        mm.process_frame(0, seq.images[s0 + i], float(seq.timestamps[s0 + i]))
    mm.flush_merge_scans()
    ok = [f for f in robot.frames if f.state == "OK"]
    print(f"[host{pid}] tracked {len(ok)}/{half} frames, maps={len(mm.live_maps())}",
          flush=True)

    # lockstep exchange rounds: signatures, payload migration, then the
    # local Sim3-verified merge of the imported map
    for _ in range(6):
        bridge.exchange()
        for _ in range(4):
            mm.pump_merge_scans()
        mm.flush_merge_scans()
    mh.barrier()

    result = {
        "process": pid,
        "tracked": len(ok),
        "merges": mm.merges,
        "imported": len(bridge._imported),
        "transfers": bridge.transfers,
        "state": robot.state.name,
    }
    if mm.merges:
        base = next(m for m in mm.maps if m.map_id == mm.merges[0][1])
        result["merged_n_kf"] = int(base.map.kf_valid.sum())
        # this host's frames resolved against the merged map (timestamps
        # are global scene time, so the ground truth indexes directly)
        ok2 = [f for f in robot.frames if f.state == "OK" and f.map_id == base.map_id]
        if len(ok2) >= 10:
            est = np.stack(resolve_frame_poses(ok2))
            idx = [min(int(round(f.timestamp * cam.fps)), n_total - 1) for f in ok2]
            result["merged_frames_ate"] = round(float(ate_from_poses(est, seq.poses_cw[idx])), 4)
    print(f"[host{pid}] result: {json.dumps(result)}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    # the gloo group's threads are stopped before the interpreter exits
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
