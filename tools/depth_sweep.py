"""The stereo and RGB-D sessions of both packages over several sequence
seeds, with no asserts: one ``depth_run`` JSON line per run, its outcome
from ``chip_smoke.depth_metrics`` (initialization, frames tracked, SE3 and
Sim3 ATE, the Sim3 scale, the travelled distance and the frozen-camera
ATE).

    python3 tools/depth_sweep.py port 1 2 3
    XLA_PYTHON_CLIENT_PREALLOCATE=false python3 tools/depth_sweep.py jax 1 2 3
    python3 tools/depth_sweep.py cpu 1 2 3
    python3 tools/depth_sweep.py nudge 1e-4

``port`` (a CUDA device and nvcc) and ``jax`` (JAX's default backend) run
chip_smoke.py's stereo (KITTI) and RGB-D (TUM2) phases on each seed; ``port``
adds ``stereo_rendered_depth``: the KITTI rig and frames with the rendered
depth map in place of the stereo association (an RGBDSession). ``cpu``
runs tests/test_stereo_rgbd.py's sequences and configuration in both
packages on the CPU; ``nudge`` runs the JAX package's stereo session of
that file (seed 11) six times, its pose moved by +-EPS metres along each
axis at frame 4.
"""
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import chip_smoke as cs  # noqa: E402


def emit(pkg, sensor, seed, sess, seq, fps, wall, extra=None):
    ts, est = sess.frame_trajectory()
    out = {"pkg": pkg, "sensor": sensor, "seed": seed,
           **cs.depth_metrics(sess.frames, ts, est, seq, fps), "keyframes": sess.n_kf,
           "wall_s": wall, "states": " ".join(f"{r.state[0]}{r.n_inliers}" for r in sess.frames)}
    out.update(extra or {})
    print("depth_run " + json.dumps(out), flush=True)


def stream(sess, seq, sensor, n, factor=1.0):
    second = seq.images_right if sensor == "stereo" else seq.depths[:n] * np.float32(factor)
    t0 = time.perf_counter()
    for i in range(n):
        sess.process_frame(seq.images[i], second[i], float(seq.timestamps[i]))
    return time.perf_counter() - t0


def card_sequence(make_sequence, sensor, cfg, seed, with_depth=False):
    return make_sequence(n_frames=cs.SEQ_FRAMES, n_points=2500, cam=cfg.camera, seed=seed,
                         motion="forward" if sensor == "stereo" else "strafe",
                         stereo=sensor == "stereo", with_depth=with_depth or sensor == "rgbd")


def port(seeds):
    import torch

    from orbslamm_tpu_torch.io.synthetic import make_sequence
    from orbslamm_tpu_torch.ops.cuda import hamming as ph
    ph.build()
    for sensor in ("stereo", "rgbd"):
        cfg = cs.kitti_stereo_cfg() if sensor == "stereo" else cs.tum2_rgbd_cfg()
        for seed in seeds:
            seq = card_sequence(make_sequence, sensor, cfg, seed)
            r, split, _ = cs._depth_run(torch, ph, "cuda", sensor, cfg, seq, cs.DEPTH_FRAMES)
            print("depth_run " + json.dumps({"pkg": "port", "seed": seed, **r, "split": split}),
                  flush=True)
    cfg = cs.kitti_stereo_cfg()
    for seed in seeds:
        seq = card_sequence(make_sequence, "stereo", cfg, seed, with_depth=True)
        r, _, _ = cs._depth_run(torch, ph, "cuda", "rgbd", cfg, seq, cs.DEPTH_FRAMES)
        print("depth_run " + json.dumps({"pkg": "port", "seed": seed, **r,
                                         "sensor": "stereo_rendered_depth"}), flush=True)


def jax_run(seeds):
    import jax

    from orbslamm_tpu.io.synthetic import make_sequence
    from orbslamm_tpu.models.system import RGBDSession, StereoSession
    print("jax", jax.__version__, jax.devices(), flush=True)
    for sensor in ("stereo", "rgbd"):
        cfg = cs.kitti_stereo_cfg() if sensor == "stereo" else cs.tum2_rgbd_cfg()
        for seed in seeds:
            seq = card_sequence(make_sequence, sensor, cfg, seed)
            sess = (StereoSession if sensor == "stereo" else RGBDSession)(cfg)
            wall = stream(sess, seq, sensor, cs.DEPTH_FRAMES, cfg.camera.depth_map_factor)
            emit("jax", sensor, seed, sess, seq, cfg.camera.fps, wall)


def _cpu_setup():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import test_torch_stereo_session as t
    return t


def cpu(seeds):
    from orbslamm_tpu.models import system as jsys

    t = _cpu_setup()
    from orbslamm_tpu_torch.models import system as tsys
    for sensor in ("stereo", "rgbd"):
        for seed in seeds:
            seq = t._sequence(sensor, seed)
            for pkg in ("jax", "port"):
                mod = jsys if pkg == "jax" else tsys
                kind = mod.StereoSession if sensor == "stereo" else mod.RGBDSession
                sess = kind(t.CFG) if pkg == "jax" else kind(t.CFG, device="cpu")
                wall = stream(sess, seq, sensor, len(seq.images))
                emit(pkg, sensor, seed, sess, seq, t.CAM.fps, wall)


def nudge(eps):
    from orbslamm_tpu.models.system import StereoSession

    t = _cpu_setup()
    seq = t._sequence("stereo")
    for axis in range(3):
        for sign in (1, -1):
            sess = StereoSession(t.CFG)
            t0 = time.perf_counter()
            for i in range(len(seq.images)):
                if i == 4:
                    tr = sess.tracker
                    tr.T_cw = tr.T_cw.at[axis, 3].add(sign * eps)
                    tr.last_T = tr.T_cw
                sess.process_frame(seq.images[i], seq.images_right[i], float(seq.timestamps[i]))
            emit("jax", "stereo", 11, sess, seq, t.CAM.fps, time.perf_counter() - t0,
                 {"nudge_m": sign * eps, "axis": axis})


if __name__ == "__main__":
    mode, args = sys.argv[1], sys.argv[2:]
    if mode == "nudge":
        nudge(float(args[0]))
    else:
        {"port": port, "jax": jax_run, "cpu": cpu}[mode]([int(s) for s in args])
