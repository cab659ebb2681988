"""Smoke run of the PyTorch/CUDA port (orbslamm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each ending in ``torch.cuda.synchronize()``; any failure exits
non-zero and no phase failure is caught:

1. the card (``nvidia-smi`` name and power limit) and the software versions;
2. building the hand-written matcher kernel (csrc/hamming.cu) with nvcc;
3. the kernel against its plain torch version on the card: window mode at
   the main path's shapes 2048x2048 (motion model), 2048x4096 (local map)
   and 2048x8192 (fuse), epipolar mode at 2048x2048 (triangulation), and a
   ragged 1000x777, an all-invalid-columns and a duplicate-descriptor case.
   Tolerance: the tables must be equal (exact) on live entries, and masked
   entries must stay above 256 in both. Median times from CUDA events;
4. the main path: ``MonocularSession(cfg, device="cuda")`` at bench.py's
   single-stream size (640x480, 1000 features, 8 levels, 2048 keypoints,
   2000 init features, 128 keyframes, 8192 landmarks) on bench.py's rendered
   synthetic forward-motion sequence (248 frames), initialized frame by
   frame within the first half, then up to 120 frames streamed in chunks of
   8; asserts initialization, >= 90% tracked frames,
   >= 3 keyframes, >= 2 kernel launches per tracked frame and a finite ATE
   below 0.5 m (a catastrophe guard);
5. two more chunks: one with a synchronized wall clock per stage (the
   split of a chunk's time), one under ``torch.profiler`` for the device's
   busy time.

The last line is the JSON contract line; the line before it holds the
kernels' record. Needs the rest of the repository beside it: the port
package and the numpy-only config, synthetic-sequence and ATE modules of
the reference package (``orbslamm_tpu.utils.config``,
``orbslamm_tpu.io.synthetic``, ``orbslamm_tpu.eval.ate``; none imports jax).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
CHUNK = 8
# bench.py's 248-frame sequence; make_sequence spreads a fixed path over
# n_frames, so a shorter sequence would move twice as far per frame and
# starve the two-view init of matches. As in bench.py the init may take up
# to half the sequence; then N_STREAM frames are streamed.
SEQ_FRAMES = 248
N_STREAM = 120
KERNEL_SHAPES = [  # (name, N, M, mode, radius scale)
    ("motion_model", 2048, 2048, "window", 15.0),
    ("local_map", 2048, 4096, "window", 4.0),
    ("fuse", 2048, 8192, "window", 3.0),
    ("triangulate", 2048, 2048, "epipolar", 0.0),
]
# the port's stage names (orbslamm_tpu_torch.utils.trace.stage) start so
STAGE_PREFIXES = ("orb", "track", "ba", "matching", "mapping")


def bench_cfg():
    """bench.py's single-stream configuration, without a vocabulary and with
    the reference's init budget (2 x n_features, Tracking.cc:122) instead of
    bench.py's 4000 init features. With 4000, on this sequence and with no
    vocabulary, the two-view init succeeds early with 60-80 landmarks and
    loses tracking on the next frame, every time, in the JAX package (run
    through JAX's CUDA backend on an H100) as in the port; see PERF.md."""
    from orbslamm_tpu.utils.config import (
        CameraConfig, CapacityConfig, LoopConfig, OrbConfig, SlamConfig,
        TrackingConfig,
    )

    cam = CameraConfig(width=640, height=480, fx=520.9, fy=521.0, cx=325.1,
                       cy=249.7, fps=30)
    return SlamConfig(
        camera=cam,
        orb=OrbConfig(n_features=1000, max_keypoints=2048, init_features=0),
        capacity=CapacityConfig(max_keyframes=128, max_landmarks=8192),
        tracking=TrackingConfig(pixel_noise=1.2),
        loop=LoopConfig(vocab_branching=10, vocab_depth=4),
        vocabulary_path=None,
    )


def _case(torch, n, m, seed, device, mode="window", radius=15.0, dup=False,
          all_invalid=False):
    """Random matcher inputs: descriptors, validity, 640x480 positions,
    8 octaves, per-column windows radius * 1.2^level or epipolar lines."""
    g = np.random.default_rng(seed)
    t = lambda a, **kw: torch.as_tensor(a, device=device, **kw)  # noqa: E731
    da = t(g.integers(0, 256, (n, 32), dtype=np.uint8))
    db = t(g.integers(0, 256, (m, 32), dtype=np.uint8))
    if dup:
        db[1] = da[0]
        db[m - 1] = da[0]
    va = g.random(n) > 0.1
    vb = g.random(m) > 0.1
    if dup:
        va[0] = vb[1] = vb[m - 1] = True
    if all_invalid:
        vb[:] = False
    lb = g.integers(0, 8, m)
    kw = dict(
        xy_b=t(g.uniform(0, [640, 480], (m, 2)).astype(np.float32)),
        level_a=t(g.integers(0, 8, n), dtype=torch.int32),
        level_b=t(lb, dtype=torch.int32), lvl_lo=-2.0, lvl_hi=1.0,
    )
    if mode == "window":
        kw.update(xy_a=t(g.uniform(0, [640, 480], (n, 2)).astype(np.float32)),
                  radius_b=t((radius * 1.2 ** lb).astype(np.float32)),
                  use_window=True)
    elif mode == "epipolar":
        lines = g.normal(size=(n, 3)).astype(np.float32)
        lines[:, 2] = -(lines[:, 0] * g.uniform(0, 640, n) + lines[:, 1] * g.uniform(0, 480, n))
        kw.update(lines_a=t(lines), epi_thr_b=t((3.84 * 1.44 ** lb).astype(np.float32)),
                  use_epipolar=True)
    return (da, db, t(va), t(vb)), kw


def _compare(torch, got, want) -> float:
    """Max |difference| over the tables; raises unless the tables agree
    exactly on live entries and masked entries stay above 256 in both."""
    live_r = want.row_best <= 256
    live_s = live_r & (want.row_second <= 256)
    live_c = want.col_best <= 256
    checks = [
        (got.row_best, want.row_best, live_r), (got.row_arg, want.row_arg, live_r),
        (got.row_second, want.row_second, live_s),
        (got.col_best, want.col_best, live_c), (got.col_arg, want.col_arg, live_c),
    ]
    err = 0.0
    for g_, w_, live in checks:
        d = (g_.double() - w_.double()).abs()
        if bool((d[live] != 0).any()):
            raise AssertionError("kernel disagrees with the plain version on live entries")
        err = max(err, float(d[live].max()) if bool(live.any()) else 0.0)
    for g_, w_, live in ((got.row_best, want.row_best, live_r),
                         (got.col_best, want.col_best, live_c)):
        if bool((g_[~live] <= 256).any()) or bool((w_[~live] <= 256).any()):
            raise AssertionError("a masked entry fell to 256 or below")
    if not bool((got.row_arg >= 0).all()) or not bool((got.row_arg < want.col_best.numel()).all()):
        raise AssertionError("row_arg out of range")
    return err


def _median_ms(torch, fn, reps=20):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def kernel_phase(torch, ph, device):
    """Kernel vs plain version at every shape; returns (max_abs_err,
    per-shape timings)."""
    cases = [(name, _case(torch, n, m, i, device, mode, r), (n, m, mode))
             for i, (name, n, m, mode, r) in enumerate(KERNEL_SHAPES)]
    cases += [
        ("ragged", _case(torch, 1000, 777, 10, device, dup=True), (1000, 777, "window")),
        ("all_invalid_columns", _case(torch, 300, 129, 11, device, all_invalid=True),
         (300, 129, "window")),
        ("duplicate_descriptor", _case(torch, 1000, 777, 12, device, mode="none", dup=True),
         (1000, 777, "none")),
    ]
    err, timings = 0.0, []
    for name, (args, kw), (n, m, mode) in cases:
        got = ph.match_tables(*args, **kw)
        torch.cuda.synchronize()
        want = ph.match_tables_ref(*args, **kw)
        torch.cuda.synchronize()
        e = _compare(torch, got, want)
        if name == "all_invalid_columns" and bool((got.row_best <= 256).any()):
            raise AssertionError("all-invalid columns produced a live row")
        if name == "duplicate_descriptor" and bool(got.row_second[0] != got.row_best[0]):
            raise AssertionError("a duplicate descriptor must give second == best")
        err = max(err, e)
        row = {"case": name, "N": n, "M": m, "mode": mode, "max_abs_err": e,
               "live_rows": int((want.row_best <= 256).sum())}
        if name in dict((s[0], 0) for s in KERNEL_SHAPES):
            row["ms"] = _median_ms(torch, lambda: ph.match_tables(*args, **kw))
            row["plain_ms"] = _median_ms(torch, lambda: ph.match_tables_ref(*args, **kw))
        timings.append(row)
        print("kernel_vs_plain " + json.dumps(row), flush=True)
    torch.cuda.synchronize()
    return err, timings


def main_path_phase(torch, ph, device):
    """Initialize, then stream the sequence in chunks of CHUNK."""
    from orbslamm_tpu.eval.ate import ate_from_poses
    from orbslamm_tpu.io.synthetic import make_sequence
    from orbslamm_tpu_torch.models.system import (
        MonocularSession, TrackingState, resolve_frame_poses,
    )

    cfg = bench_cfg()
    ph.launches = 0  # counts from here on are the main path's
    sess = seq = None
    for seed in (7, 12):  # as bench.py: retry once if the two-view init fails
        seq = make_sequence(n_frames=SEQ_FRAMES, n_points=2500, cam=cfg.camera,
                            seed=seed, motion="forward")
        sess = MonocularSession(cfg, device=device)
        sess.enable_loop_closing = False
        sess.tracker.chunk_size = CHUNK
        i, streak = 0, 0
        t0 = time.perf_counter()
        while streak < 3 and i < SEQ_FRAMES // 2:
            r = sess.process_frame(seq.images[i], float(seq.timestamps[i]))
            streak = streak + 1 if r.state == "OK" else 0
            i += 1
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        print(f"init frames (seed {seed}): " + " ".join(
            f"{f.state[0]}{f.n_inliers}" for f in sess.frames), flush=True)
        if sess.state == TrackingState.OK:
            break
    if sess.state != TrackingState.OK:
        raise AssertionError("two-view initialization failed on both seeds")
    print(f"init: seed {seed}, OK after frame {i - 1}, {init_s:.3f} s, "
          f"keyframes {sess.n_kf}", flush=True)

    launches0, frames0 = ph.launches, i
    end = min(i + N_STREAM, SEQ_FRAMES - 2 * CHUNK)  # two chunks stay for the split
    chunk_s = []
    while i + CHUNK <= end and sess.state == TrackingState.OK:
        t0 = time.perf_counter()
        sess.process_frames(seq.images[i:i + CHUNK], seq.timestamps[i:i + CHUNK])
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
        i += CHUNK
    n_stream = i - frames0
    post = [f for f in sess.frames if f.frame_id >= frames0]
    n_ok = sum(f.state == "OK" for f in post)
    stream_launches = ph.launches - launches0
    ok_frames = [f for f in sess.frames if f.state == "OK"]
    est = np.stack(resolve_frame_poses(ok_frames))
    gt = seq.poses_cw[[int(round(f.timestamp * cfg.camera.fps)) for f in ok_frames]]
    ate = float(ate_from_poses(est, gt))
    steady = chunk_s[1:] if len(chunk_s) > 1 else chunk_s  # first chunk warms up
    result = {
        "frames_streamed": n_stream, "frames_ok": n_ok, "keyframes": sess.n_kf,
        "chunk_s_median": float(np.median(steady)),
        "fps_steady": float(CHUNK * len(steady) / np.sum(steady)),
        "ate_m": ate, "stream_launches": stream_launches,
        "landmarks": int(sess.map.lm_valid.sum()),
    }
    print("main_path " + json.dumps(result), flush=True)
    print("streamed frames: " + " ".join(f"{f.state[0]}{f.n_inliers}" for f in post),
          flush=True)
    if n_stream < 4 * CHUNK or n_ok < 0.9 * n_stream:
        raise AssertionError(f"tracked {n_ok} of {n_stream} streamed frames")
    if sess.n_kf < 3:
        raise AssertionError(f"only {sess.n_kf} keyframes")
    if stream_launches < 2 * n_ok:
        raise AssertionError(f"{stream_launches} kernel launches for {n_ok} tracked frames")
    if not np.isfinite(ate) or ate >= 0.5:
        raise AssertionError(f"ATE {ate} m")
    return sess, seq, i, result


def _union_ms(spans) -> float:
    """Total length of the union of (start_us, end_us) intervals, in ms."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def split_phase(torch, sess, seq, i, chunk_s_median):
    """Two more chunks. The first runs under a StageTimer: a synchronized
    wall clock per stage, the split of a chunk's time (stages nest:
    track.* hold their matcher and pose-optimization calls). The second runs
    under torch.profiler for the device's busy time: the union of the
    intervals of its kernels, copies and fills, profiler ranges left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from orbslamm_tpu_torch.models.system import TrackingState
    from orbslamm_tpu_torch.utils.trace import StageTimer

    if i + 2 * CHUNK > SEQ_FRAMES or sess.state != TrackingState.OK:
        raise AssertionError("no tracked frames left for the split phase")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with StageTimer("cuda") as timer:
        sess.process_frames(seq.images[i:i + CHUNK], seq.timestamps[i:i + CHUNK])
        torch.cuda.synchronize()
    timed_ms = (time.perf_counter() - t0) * 1e3
    i += CHUNK
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        sess.process_frames(seq.images[i:i + CHUNK], seq.timestamps[i:i + CHUNK])
        torch.cuda.synchronize()
    device_ops = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and e.name.split(".")[0] not in STAGE_PREFIXES
                  and not getattr(e, "is_user_annotation", False)]
    busy_ms = _union_ms((e.time_range.start, e.time_range.end) for e in device_ops)
    if not device_ops:
        raise AssertionError("the profiled chunk recorded no device work")
    out = {
        "timed_chunk_ms": timed_ms,
        "stages": {k: {"calls": timer.calls[k], "ms": v * 1e3}
                   for k, v in timer.seconds.items()},
        "profiled_chunk_device_ops": len(device_ops),
        "profiled_chunk_device_busy_ms": busy_ms,
        # against an unprofiled chunk: the profiler slows the host, not the kernels
        "device_idle_share": max(0.0, 1.0 - busy_ms / (chunk_s_median * 1e3)),
    }
    print("stage_split " + json.dumps(out), flush=True)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "orbslamm_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    device = "cuda"

    import orbslamm_tpu_torch  # noqa: F401  (pins float32 / TF32 off)
    from orbslamm_tpu_torch.ops.cuda import hamming as ph

    t0 = time.perf_counter()
    ph.build()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {ph.build_seconds})", flush=True)

    err, timings = kernel_phase(torch, ph, device)
    sess, seq, i, result = main_path_phase(torch, ph, device)
    torch.cuda.synchronize()
    main_launches = ph.launches
    split_phase(torch, sess, seq, i, result["chunk_s_median"])
    torch.cuda.synchronize()
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    local = next(t for t in timings if t["case"] == "local_map")
    kernels = {"kernels": [{
        "name": "hamming_match_tables",
        "route": "cuda",
        "source": "orbslamm_tpu_torch/csrc/hamming.cu",
        "replaces": "orbslamm_tpu/ops/pallas/hamming.py:208",
        "launches": main_launches,
        "max_abs_err": err,
        "ms": local["ms"],
        "plain_ms": local["plain_ms"],
    }]}
    print(f"main path: {result['fps_steady']:.2f} fps steady, chunk median "
          f"{result['chunk_s_median']:.4f} s, ATE {result['ate_m']:.4f} m on {smi}",
          flush=True)
    print(smi, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
