"""Entry points: the single-device per-frame step and the mesh dry run
(the port of the repository's ``__graft_entry__.py``).

``entry(device)`` returns ``(fn, example_args)``: ``fn(image_u8, T_pred)
-> (T_cw, n_inliers)`` runs ORB extraction, motion-model tracking and
local-map tracking with the final pose optimization against a map
bootstrapped on a synthetic sequence, the per-frame core of the main path.
``dryrun_multichip(n_devices, devices)`` runs the sharded paths over an
``n_devices``-slot mesh (``parallel/multihost.stream_mesh``): stream
extraction, the edge-sharded dense BA, the robot-parallel bank's chunk,
the keyframe-block-sharded global BA with its 1-slot against n-slot timing,
and the cross-process map bridge at one process.

Everything runs on the card unless the caller names the CPU
(``device="cpu"``, ``devices=["cpu"] * n``); there is no fallback.

    python -m orbslamm_tpu_torch.entry [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import copy
import sys
import time

import numpy as np
import torch

from orbslamm_tpu_torch.io.synthetic import make_sequence
from orbslamm_tpu_torch.models import tracking as trk
from orbslamm_tpu_torch.models.system import MonocularSession, TrackingState
from orbslamm_tpu_torch.utils.config import (
    CameraConfig, CapacityConfig, OrbConfig, SlamConfig, TrackingConfig,
)


def _small_cfg() -> SlamConfig:
    cam = CameraConfig(width=320, height=240, fx=260, fy=260, cx=160, cy=120)
    return SlamConfig(
        camera=cam,
        orb=OrbConfig(n_features=400, max_keypoints=1024, n_levels=4),
        capacity=CapacityConfig(max_keyframes=64, max_landmarks=4096),
        tracking=TrackingConfig(pixel_noise=1.2, min_matches_init=55, init_min_triangulated=30,
                                init_min_parallax_deg=0.4),
    )


def _require(devices) -> None:
    """A CUDA device named where the process has none raises: nothing runs
    on the CPU unless the caller asks for it."""
    if any(torch.device(d).type == "cuda" for d in devices) and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' (devices=['cpu', ...]) to run "
                           "on the CPU")


def _synchronize(devices) -> None:
    if any(torch.device(d).type == "cuda" for d in devices):
        torch.cuda.synchronize()


def make_frame_fn(cfg: SlamConfig, m, K, last_feats, last_lm, extract):
    """``fn(image_u8, T_pred) -> (T_cw, n_inliers)`` against map ``m`` with
    the last tracked frame's features and landmark associations; the map's
    updated visibility counters are dropped, so every call sees ``m``."""

    def fn(image_u8, T_pred):
        feats = extract(image_u8)
        r1 = trk.track_motion_model(cfg, m, feats, T_pred, K, last_feats, last_lm,
                                    T_last=T_pred)
        r2, _ = trk.track_local_map(cfg, m, feats, r1.T_cw, K, r1.feat_lm)
        return r2.T_cw, r2.n_inliers

    return fn


def entry(device="cuda"):
    """(fn, example_args): the per-frame tracking step (``make_frame_fn``)
    against a map bootstrapped on ``make_sequence(60, 900 points, seed 7,
    "forward")`` frames 0-19; ``example_args`` is frame 21 and the
    tracker's pose, on ``device``. Raises if the bootstrap does not
    initialize."""
    _require([device])
    cfg = _small_cfg()
    seq = make_sequence(n_frames=60, n_points=900, cam=cfg.camera, seed=7, motion="forward")
    sess = MonocularSession(cfg, device=device)
    for i in range(20):  # enough frames at gentle motion to initialize and map
        sess.process_frame(seq.images[i], float(seq.timestamps[i]))
    tracker = sess.tracker
    tracker._sync_from_ts()
    if tracker.last_feats is None:
        raise RuntimeError("bootstrap session failed to initialize")
    fn = make_frame_fn(cfg, sess.map, tracker.K, tracker.last_feats, tracker.last_lm,
                       tracker.extract)
    example_args = (torch.as_tensor(seq.images[21], device=device),
                    tracker.T_cw.to(device=device, dtype=torch.float32))
    return fn, example_args


def dryrun_inputs(n_devices: int):
    """Part 1's random frames and part 2's BA problem as numpy, drawn from
    one ``default_rng(0)`` in that order: [n_devices, 72, 96] uint8 and a
    dict of ``BAProblem`` fields (4 cameras, 64 points, max(32 n, 128)
    edges, camera 0 fixed, points moved by 2 cm)."""
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 255, (n_devices, 72, 96), np.uint8)
    C, Pn = 4, 64
    E = max(n_devices * 32, 128)
    pts = rng.uniform(-2, 2, (Pn, 3)).astype(np.float32)
    pts[:, 2] += 6.0
    K = np.array([[80.0, 0, 48], [0, 80, 36], [0, 0, 1]], np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    for c in range(C):
        T[c, 0, 3] = 0.3 * c
    oc = rng.integers(0, C, E).astype(np.int32)
    op = rng.integers(0, Pn, E).astype(np.int32)
    pc = np.einsum("eij,ej->ei", T[oc][:, :3, :3], pts[op]) + T[oc][:, :3, 3]
    uv = (pc[:, :2] / pc[:, 2:3]) * [80, 80] + [48, 36]
    cam_fixed = np.zeros(C, bool)
    cam_fixed[0] = True
    prob = dict(
        T_cw=T, K=np.broadcast_to(K, (C, 3, 3)).copy(), cam_valid=np.ones(C, bool),
        cam_fixed=cam_fixed,
        points=pts + rng.normal(0, 0.02, pts.shape).astype(np.float32),
        point_valid=np.ones(Pn, bool), obs_cam=oc, obs_point=op,
        obs_uv=uv.astype(np.float32), obs_sigma2=np.ones(E, np.float32),
        obs_valid=np.ones(E, bool))
    return imgs, prob


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run the sharded paths on a mesh of ``n_devices`` slots over
    ``devices`` (default: every local card; entries may repeat):

    1. robot-parallel feature extraction (one image per slot);
    2. the edge-sharded dense BA (partial sums on the first slot);
    3. the bank's chunk with the robot axis over the mesh: one bootstrapped
       robot replicated ``n_devices`` ways, ``process_chunk`` + ``flush``;
    4. the keyframe-block-sharded global BA on the bootstrapped map, and
       its time on one slot against ``n_devices`` slots (on repeated slots
       of one device, the cost of the partitioning, not scaling);
    5. the cross-process map bridge at one process (a no-op).

    Returns each part's result: ``features``, ``ba`` (BAResult),
    ``records`` (per robot), ``gba`` (t_1_ms, t_n_ms,
    overhead_efficiency) and ``imported`` (the bridge's count)."""
    from orbslamm_tpu_torch.models.multimap import MultiMapper
    from orbslamm_tpu_torch.ops import ba
    from orbslamm_tpu_torch.ops import orb as orb_ops
    from orbslamm_tpu_torch.parallel import dist_ba
    from orbslamm_tpu_torch.parallel.multihost import stream_mesh
    from orbslamm_tpu_torch.parallel.multihost_mapper import HostMapperBridge
    from orbslamm_tpu_torch.parallel.streams import StreamBank

    slots = stream_mesh(None if devices is None else list(devices)).flat[:n_devices]
    if len(slots) < n_devices:
        raise ValueError(f"a mesh of {n_devices} slots over {len(slots)} devices")
    _require(slots)
    mesh = stream_mesh(slots)
    dev0 = slots[0]
    out = {}
    imgs, prob_np = dryrun_inputs(n_devices)

    # --- 1. robot-parallel extraction on tiny frames -----------------------
    cam = CameraConfig(width=96, height=72, fx=80, fy=80, cx=48, cy=36)
    orb_cfg = OrbConfig(n_features=64, max_keypoints=128, n_levels=2)
    streams = dist_ba.make_stream_extractor(
        mesh, lambda d: orb_ops.make_extractor(orb_cfg, cam, device=d))
    out["features"] = streams(torch.as_tensor(imgs))
    _synchronize(slots)

    # --- 2. distributed BA with sharded edges ------------------------------
    prob = ba.BAProblem(**{k: torch.as_tensor(v, device=dev0) for k, v in prob_np.items()})
    step = dist_ba.make_distributed_ba(mesh, iters=3)
    res = step(dist_ba.shard_ba_problem(prob, mesh))
    if not bool(torch.isfinite(res.cost)):
        raise AssertionError("distributed BA produced non-finite cost")
    out["ba"] = res

    # --- 3. the bank's chunk, robot axis over the mesh ---------------------
    cfg = _small_cfg()
    # strafe: sideways motion with strong parallax; the dry run checks the
    # sharded chunk step, not a marginal forward-motion initialization
    seq = make_sequence(n_frames=32, n_points=900, cam=cfg.camera, seed=7, motion="strafe")
    sess = MonocularSession(cfg, device=dev0)
    sess.enable_loop_closing = False
    # bootstrap until tracking is stably OK: a marginal first init is
    # discarded by the early-loss reset and tried again
    i, streak = 0, 0
    while streak < 3 and i < 28:
        r = sess.process_frame(seq.images[i], float(seq.timestamps[i]))
        streak = streak + 1 if r.state == "OK" else 0
        i += 1
    if sess.state != TrackingState.OK:
        raise AssertionError("dryrun bootstrap failed")
    # the robot replicated along the mesh: each copy has its own map
    # context, records and generator (a shallow copy would share the
    # generator, and the copies' draws would interleave); the tracking
    # state and the map are immutable tuples that the bank copies per slot
    trackers = [sess.tracker]
    for _ in range(n_devices - 1):
        t = copy.copy(sess.tracker)
        t.mapctx = copy.copy(sess.tracker.mapctx)
        t.frames = list(sess.tracker.frames)
        t.generator = torch.Generator(device=t.device)
        t.generator.set_state(sess.tracker.generator.get_state())
        trackers.append(t)
    bank = StreamBank(cfg, trackers, device=dev0, mesh=mesh, chunk_size=4)
    chunk = np.ascontiguousarray(np.broadcast_to(np.stack(seq.images[i:i + 4]),
                                                 (n_devices, 4, *seq.images[0].shape)))
    stamps = np.broadcast_to(seq.timestamps[i:i + 4], (n_devices, 4))
    # process_chunk is pipelined (the previous chunk's records, [] on the
    # first call): flush the chunk in flight before counting
    recs = bank.process_chunk(chunk, stamps)
    recs += bank.flush()
    if len(recs) != n_devices or len(recs[0]) != 4:
        raise AssertionError(f"bank records: {[len(r) for r in recs]}")
    n_ok = sum(1 for rr in recs for r in rr if r.state == "OK")
    if n_ok < 2 * n_devices:
        raise AssertionError(f"sharded chunk step tracked too little ({n_ok})")
    out["records"] = recs

    # --- 4. keyframe-block-sharded global BA + the 1-slot timing -----------
    bank.sync_to_trackers()
    m_full = sess.tracker.mapctx.map
    gba_n = dist_ba.make_kf_sharded_gba(mesh, cfg, iters=3)
    m_sharded = dist_ba.shard_map_kf_blocks(m_full, mesh)
    res_n = gba_n(m_sharded)
    if not bool(torch.isfinite(torch.cat([p.to(dev0) for p in res_n.kf_pose])).all()):
        raise AssertionError("kf-sharded GBA non-finite")
    mesh1 = stream_mesh(slots[:1])
    gba_1 = dist_ba.make_kf_sharded_gba(mesh1, cfg, iters=3)
    m_1 = dist_ba.shard_map_kf_blocks(m_full, mesh1)
    gba_1(m_1)  # the first call's costs stay outside the timing
    _synchronize(slots)

    def per_call(fn, m):
        t0 = time.perf_counter()
        for _ in range(3):
            fn(m)
        _synchronize(slots)
        return (time.perf_counter() - t0) / 3

    t_1, t_n = per_call(gba_1, m_1), per_call(gba_n, m_sharded)
    # repeated slots of one device measure the partitioning's overhead, not
    # scaling: efficiency t_1 / t_n on the same problem (>= ~0.8 means
    # sharding costs < 25 %)
    eff = t_1 / max(t_n, 1e-9)
    print(f"kf_sharded_gba: t_1dev={t_1 * 1e3:.1f}ms t_{n_devices}dev={t_n * 1e3:.1f}ms "
          f"overhead_efficiency={eff:.2f}", flush=True)
    out["gba"] = {"t_1_ms": t_1 * 1e3, "t_n_ms": t_n * 1e3, "overhead_efficiency": eff}

    # --- 5. the cross-process map bridge (a no-op at one process; the
    # two-process path: parallel/multihost_demo.py) ------------------------
    mm = MultiMapper(cfg, device=dev0)
    mm.robots.append(sess.tracker)
    mm.maps.append(sess.tracker.mapctx)
    out["imported"] = HostMapperBridge(mm).exchange()
    print("multihost bridge ok (1-process no-op)", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    fn, example = entry(args.device)
    res = fn(*example)
    print("entry ok:", [tuple(torch.as_tensor(o).shape) for o in res], flush=True)
    if args.device == "cuda":
        n = torch.cuda.device_count()
        dryrun_multichip(n)
    else:
        n = 1
        dryrun_multichip(n, devices=["cpu"])
    print("dryrun ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
