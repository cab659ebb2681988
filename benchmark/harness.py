"""One run of one cell of the port's benchmark (``benchmark/run.py``).

Everything that belongs to a cell is data, found by name from the cell's
entry in ``BENCHMARK.json``: its configuration (``configs/<config>.json``),
its traffic mix (``workloads/<cell>.json``: the path, its sampling and the
limits of the check) and its metrics (``metrics/<metric>.py``, each a
``read(run)`` that returns a number, or None where it finds nothing to
read). The session is chosen by the configuration's sensor: one robot's
``RGBDSession``, ``StereoSession`` or ``MonocularSession``, fed frame by
frame.

A run: set-up (render the stream from the seed, build the session, feed
frames one by one until ``init_streak`` frames in a row track, then
``warmup_frames`` frames of the window's own work, so that every kernel the
window runs is built and every path has run once), the window (frames fed
as fast as the port takes them, never ahead of the camera's rate, until
``seconds`` have passed; the work in flight is finished and its time
counted), then the check against the plain reference (``check.py``) and the
result line. With ``--trace 1`` the window runs under ``torch.profiler``
and the per-layer metrics are read from its events.
"""

from __future__ import annotations

import importlib.util
import json
import random
import sys
import time
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "orbslamm_tpu")


class RunFailed(Exception):
    """The run could not measure (no initialization within the segment)."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    entry: dict  # the cell's entry in BENCHMARK.json
    mix: dict  # workloads/<cell>.json
    conf: dict  # configs/<config>.json
    end_to_end: list
    per_layer: list


def load_cell(name: str) -> Cell:
    spec = load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
    mix = load_json(BENCH / "workloads" / f"{name}.json")
    conf_entry = next(c for c in spec["configs"] if c["name"] == entry["config"])
    conf = load_json(ROOT / conf_entry["file"])

    def mine(m):
        return name in m.get("workloads", [name])
    return Cell(name, entry, mix, conf, [m for m in spec["end_to_end"] if mine(m)],
                [m for m in spec["per_layer"] if mine(m)])


def slam_config(conf: dict):
    from orbslamm_tpu_torch.utils.config import (
        CameraConfig, CapacityConfig, LoopConfig, OrbConfig, SlamConfig, TrackingConfig,
    )

    cam = CameraConfig(
        width=int(conf["Camera.width"]), height=int(conf["Camera.height"]),
        fx=conf["Camera.fx"], fy=conf["Camera.fy"], cx=conf["Camera.cx"], cy=conf["Camera.cy"],
        k1=conf["Camera.k1"], k2=conf["Camera.k2"], p1=conf["Camera.p1"],
        p2=conf["Camera.p2"], k3=conf["Camera.k3"], fps=conf["Camera.fps"],
        rgb=int(conf["Camera.RGB"]), bf=conf.get("Camera.bf", 0.0),
        th_depth=conf.get("ThDepth", 40.0), depth_map_factor=conf.get("DepthMapFactor", 5000.0))
    orb = OrbConfig(
        n_features=conf["ORBextractor.nFeatures"], scale_factor=conf["ORBextractor.scaleFactor"],
        n_levels=conf["ORBextractor.nLevels"], ini_th_fast=conf["ORBextractor.iniThFAST"],
        min_th_fast=conf["ORBextractor.minThFAST"], max_keypoints=conf["max_keypoints"],
        init_features=conf["init_features"])
    voc = ROOT / conf["vocabulary"] if conf.get("vocabulary") else None
    if voc is not None and not voc.exists():
        raise FileNotFoundError(f"vocabulary file {voc} is missing")
    return SlamConfig(
        camera=cam, orb=orb,
        capacity=CapacityConfig(max_keyframes=conf["max_keyframes"],
                                max_landmarks=conf["max_landmarks"]),
        # "tracking": TrackingConfig fields a test-size configuration relaxes
        tracking=TrackingConfig(pixel_noise=conf["pixel_noise"], **conf.get("tracking", {})),
        loop=LoopConfig(vocab_branching=10, vocab_depth=4),
        sensor=conf["sensor"], vocabulary_path=None if voc is None else str(voc))


def scene_camera(conf: dict):
    from benchmark.scene import Camera

    sensor = conf["sensor"]
    return Camera(width=int(conf["Camera.width"]), height=int(conf["Camera.height"]),
                  fx=conf["Camera.fx"], fy=conf["Camera.fy"], cx=conf["Camera.cx"],
                  cy=conf["Camera.cy"], fps=float(conf["Camera.fps"]),
                  depth_map_factor=conf["DepthMapFactor"] if sensor == "rgbd" else 0.0,
                  baseline=conf["Camera.bf"] / conf["Camera.fx"] if sensor == "stereo" else 0.0)


@dataclass
class Robot:
    tracker: object
    stream: object  # benchmark.scene.Stream
    first: int = 0  # stream index of the window's first frame
    end: int = 0  # one past its last


@dataclass
class Run:
    """What a run measured: read by the metric readers and the check."""

    cell: Cell
    seed: int
    device: str
    camera_fps: float = 30.0
    setup_s: float = 0.0
    init_frames: list = field(default_factory=list)  # per robot: frames to initialize
    window_s: float = 0.0  # host clock, first work handed to the last answer back
    frames: int = 0  # frames handed to the port in the window, all streams
    failed: int = 0  # of those, frames whose state is not OK
    streams: int = 1
    keyframes: float = 0.0  # the Tracer's keyframes_inserted over the window
    matcher_calls: Counter = field(default_factory=Counter)  # (mode, N, M) -> calls
    trace: object = None  # benchmark.trace.TraceWindow, with --trace 1
    memory_peak_bytes: int = 0
    robots: list = field(default_factory=list)
    capture: object = None
    trace_s: dict = field(default_factory=dict)  # seconds the profiler's stop and the reduction took
    setup_split: dict = field(default_factory=dict)  # seconds from the start to each set-up step's end


class SessionDriver:
    """One robot, frame by frame: ``RGBDSession``, ``StereoSession`` or
    ``MonocularSession``."""

    def __init__(self, run: Run, cfg, streams):
        from orbslamm_tpu_torch.models.system import (
            MonocularSession, RGBDSession, StereoSession,
        )

        s = streams[0]
        cls = {"rgbd": RGBDSession, "stereo": StereoSession}.get(cfg.sensor, MonocularSession)
        self.sess = cls(cfg, name=s.name, device=run.device)
        self.robot = Robot(self.sess.tracker, s)
        self.i = 0

    def _frame(self, j):
        s = self.robot.stream
        if s.depths is not None:  # raw units to float32, as ORB-SLAM2's reader converts
            return self.sess.process_frame(s.images[j], s.depths[j].astype(np.float32),
                                           float(s.timestamps[j]))
        if s.images_right is not None:
            return self.sess.process_frame(s.images[j], s.images_right[j],
                                           float(s.timestamps[j]))
        return self.sess.process_frame(s.images[j], float(s.timestamps[j]))

    def initialize(self, streak_needed: int, limit: int) -> list[int]:
        """Frames one by one until ``streak_needed`` in a row track; returns
        the frames it took."""
        streak = 0
        while streak < streak_needed:
            if self.i >= limit:
                raise RunFailed(f"{self.robot.stream.name}: no initialization in {limit} frames")
            r = self._frame(self.i)
            streak = streak + 1 if r.state == "OK" else 0
            self.i += 1
        return [self.i]

    def robots(self):
        return [self.robot]

    def feed(self, wait) -> int | None:
        """Hand the next frame once it is due; returns 1, or None when the
        stream is spent."""
        if self.i >= len(self.robot.stream.images):
            return None
        wait(1)
        self._frame(self.i)
        self.i += 1
        return 1

    def position(self) -> list[int]:
        return [self.i]

    def release(self):
        self.sess = None


def _sync(device: str):
    import torch

    if device.startswith("cuda"):
        torch.cuda.synchronize()


def window(run: Run, driver, seconds: float) -> None:
    """The measured window: work handed until ``seconds`` have passed, then
    what is in flight finished."""
    fed = 0
    t0 = 0.0

    def wait(n):  # frame fed + n - 1 of the window is due from the camera
        due = t0 + (fed + n - 1) / run.camera_fps
        while (now := time.perf_counter()) < due:
            time.sleep(due - now)

    starts = driver.position()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        got = driver.feed(wait)
        if got is None:
            raise RunFailed("the streams ended inside the window")
        fed += got
    _sync(run.device)
    run.window_s = time.perf_counter() - t0
    run.frames = fed
    for r, a, b in zip(run.robots, starts, driver.position()):
        r.first, r.end = a, b


def count_failed(run: Run) -> int:
    """Window frames whose record is not OK, or that have no record."""
    bad = 0
    for r in run.robots:
        state = {f.frame_id: f.state for f in r.tracker.frames}
        bad += sum(state.get(j) != "OK" for j in range(r.first, r.end))
    return bad


def load_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_block(run: Run) -> dict:
    import torch

    out = {"platform": "gpu" if run.device.startswith("cuda") else "cpu",
           "kind": torch.cuda.get_device_name(0) if run.device.startswith("cuda") else "cpu",
           "count": int(run.cell.entry.get("chips", 1)),
           "memory_peak_bytes": int(run.memory_peak_bytes)}
    if run.trace is not None:
        out["busy_s"] = run.trace.busy_s
        out["window_s"] = run.trace.window_s
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, the compared numbers beside their limits). A number is
    compared where the cell's mix gives it a limit; the others are shown.
    A compared number that is missing fails."""
    checks = {k: {"value": numbers.get(k), "limit": lim} for k, lim in limits.items()}
    return bool(checks) and all(c["value"] is not None and c["value"] <= c["limit"]
                                for c in checks.values()), checks


def execute(cell: Cell, seed: int, seconds: int, trace: bool, device: str,
            control: bool = False, t_start: float | None = None) -> dict:
    """Run the cell once; returns the result dict (``check`` last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    from benchmark import capture as cap_mod
    from benchmark import check as check_mod
    from benchmark import scene
    from orbslamm_tpu_torch.ops import ba
    from orbslamm_tpu_torch.ops.cuda import hamming
    from orbslamm_tpu_torch.utils.trace import get_tracer

    run = Run(cell=cell, seed=seed, device=device)
    split = run.setup_split
    split["imports"] = time.perf_counter() - t_start
    cfg = slam_config(cell.conf)
    cam = scene_camera(cell.conf)
    run.camera_fps = cam.fps
    streams = scene.streams(cell.mix, cam, seed, seconds, device=device)
    if device.startswith("cuda"):  # the peak is the port's, not the renderer's
        torch.cuda.reset_peak_memory_stats()
    split["render"] = time.perf_counter() - t_start
    run.streams = len(streams)
    driver = SessionDriver(run, cfg, streams)
    run.robots = driver.robots()
    split["session"] = time.perf_counter() - t_start
    run.init_frames = driver.initialize(int(cell.mix["init_streak"]), int(cell.mix["init_frames"]))
    _sync(device)
    split["init"] = time.perf_counter() - t_start
    mix = cell.mix
    # warm-up frames of the window's own work, counted in set-up
    for _ in range(int(mix["warmup_frames"])):
        if driver.feed(lambda n: None) is None:
            raise RunFailed("the streams ended during the warm-up")
    _sync(device)
    run.setup_s = split["warm_up"] = time.perf_counter() - t_start
    capture = run.capture = cap_mod.Capture(hamming, ba, int(mix["pose_samples"]),
                                            random.Random(seed))
    profiler = None
    if trace:
        from benchmark.trace import profile

        profiler = profile(device)
    tracer = get_tracer()
    kf0 = tracer.metrics()["counters"].get("keyframes_inserted", 0.0)
    shapes0 = Counter(hamming.launches_by_shape)
    with capture:
        if profiler is not None:
            with profiler as prof:
                from torch.profiler import record_function

                with record_function("bench.window"):
                    window(run, driver, seconds)
                t_stop = time.perf_counter()
            run.trace_s["stop"] = time.perf_counter() - t_stop
        else:
            window(run, driver, seconds)
    run.keyframes = tracer.metrics()["counters"].get("keyframes_inserted", 0.0) - kf0
    run.matcher_calls = Counter(hamming.launches_by_shape) - shapes0
    if device.startswith("cuda"):
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    run.failed = count_failed(run)
    if profiler is not None:
        from benchmark.trace import reduce

        t_reduce = time.perf_counter()
        run.trace = reduce(prof)
        run.trace_s["reduce"] = time.perf_counter() - t_reduce
    metrics_spec = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in metrics_spec:
        v = load_reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    evidence = check_mod.gather(run)
    run.robots = run.capture = None
    driver.release()
    del driver
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    numbers = check_mod.numbers(evidence, cfg, device)
    limits = mix["limits"]
    correct, checks = judge(numbers, limits)
    result = {"correct": correct, "attempted": run.frames, "failed": run.failed,
              "metrics": metrics, "device": device_block(run)}
    if run.trace is not None:
        result["breakdown"] = run.trace.breakdown
    result["setup"] = {"init_frames": run.init_frames, "window_frames": run.frames,
                       "window_s": run.window_s, "keyframes": run.keyframes,
                       "setup_split": run.setup_split, "trace_s": run.trace_s,
                       **check_mod.notes(evidence),
                       "not_compared": {k: v for k, v in numbers.items() if k not in limits}}
    if control:  # the TF32 reference in the port's place, judged alike on what it reads
        ctl = check_mod.numbers(evidence, cfg, device, control=True)
        ctl_correct, ctl_checks = judge(ctl, {k: v for k, v in limits.items() if k in ctl})
        result["control"] = {"correct": ctl_correct, "check": ctl_checks}
    result["check"] = checks
    return result


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="one run of one cell of the port's benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    cell = load_cell(a.workload)
    import torch

    chips = int(cell.entry.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        result = execute(cell, a.seed, a.seconds, bool(a.trace), "cuda", t_start=t_start)
    except RunFailed as e:
        print(f"benchmark: {e}", file=sys.stderr)
        result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {},
                  "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                             "count": chips,
                             "memory_peak_bytes": int(torch.cuda.max_memory_allocated())},
                  "check": {"initialized": {"value": 0, "limit": 1}}}
        print(json.dumps(result), flush=True)
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules loaded that the port must not load: {bad}", file=sys.stderr)
        return 3
    for k, c in result["check"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
