"""The example drivers' shared machinery (port of orbslamm_tpu/driver.py; the
reference's Examples/Monocular drivers).

As mono_tum.cc / mono_kitti.cc / mono_kitti_dif-Seq.cc do: pump one or more
image streams through robots that share one MultiMapper, report the
per-frame tracking time (median and mean, mono_kitti_dif-Seq.cc:213-221),
and save TUM and KITTI trajectories, the map set, a rendering of each map
and the Tracer's report; optionally serve the live viewer while it runs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from orbslamm_tpu_torch.io import serialize, viz
from orbslamm_tpu_torch.io import trajectory as tio
from orbslamm_tpu_torch.models.multimap import MultiMapper
from orbslamm_tpu_torch.models.system import resolve_frame_poses
from orbslamm_tpu_torch.utils.config import SlamConfig
from orbslamm_tpu_torch.utils.trace import get_tracer


def autodetect_image_size(cfg: SlamConfig, sample_image) -> SlamConfig:
    """The reference's settings files carry no image size (cv::Mat knows its
    own); the extractor's shapes need it, so take it from the first frame."""
    h, w = sample_image.shape[:2]
    if (cfg.camera.height, cfg.camera.width) != (h, w):
        cam = dataclasses.replace(cfg.camera, height=h, width=w)
        cfg = dataclasses.replace(cfg, camera=cam)
    return cfg


@dataclass
class RobotFeed:
    """One robot's image stream: any iterable of (timestamp, image)."""

    frames: object  # iterable of (float, np.ndarray), or an ImageSequence
    name: str = ""


@dataclass
class RunReport:
    track_times: dict = field(default_factory=dict)  # name -> [s] per frame
    states: dict = field(default_factory=dict)  # name -> [state name] per frame

    def timing_summary(self) -> dict:
        out = {}
        for name, ts in self.track_times.items():
            if ts:
                arr = np.asarray(ts[3:] or ts)  # the first frames carry the warm-up
                out[name] = {
                    "median_s": float(np.median(arr)),
                    "mean_s": float(np.mean(arr)),
                    "fps": float(1.0 / max(np.median(arr), 1e-9)),
                }
        return out


def run_robots(
    cfg: SlamConfig,
    feeds: list[RobotFeed],
    out_dir: str | Path | None = None,
    pace_real_time: bool = False,
    verbose: bool = True,
    span_chunks: int = 4,
    viewer_port: int | None = None,
    *,
    device,
) -> tuple[MultiMapper, RunReport]:
    """Run every feed round-robin through one ``MultiMapper(cfg,
    device=device)`` (the reference runs one thread per robot; taking turns
    reproduces the concurrency).

    Each round pulls a span of ``span_chunks * chunk_size`` frames per robot
    and runs it through the pipelined chunk path
    (``MultiMapper.process_frames``: while tracking is OK, chunk k+1 is
    dispatched before chunk k's summaries are read). A frame's time is its
    span's time over the span's frames, so the reference's per-frame
    statistics stay comparable (mono_kitti_dif-Seq.cc:213-221).
    ``pace_real_time`` sleeps the rest of each span's real-time budget
    (mono_tum.cc:211-219). The merge-scan pipeline is drained at the end;
    with ``out_dir`` the outputs are saved there (``save_outputs``). The
    process Tracer is reset first, so its report is this run's.

    A truthy ``viewer_port`` serves the live viewer (``io/viewer.py``) on
    that port while the feeds run (0 or None: no viewer); each robot's span
    holds the viewer's lock (``LiveViewer.span``), so its renders and
    toggles land between spans.
    """
    get_tracer().reset()
    mm = MultiMapper(cfg, device=device)
    iters = []
    for i, feed in enumerate(feeds):
        name = feed.name or f"robot{i}"
        mm.add_robot(name)
        iters.append((name, iter(feed.frames)))

    viewer = None
    if viewer_port:
        from orbslamm_tpu_torch.io.viewer import LiveViewer

        viewer = LiveViewer(mm, port=viewer_port).start()
        if verbose:
            print(f"[driver] live viewer at http://{viewer.host}:{viewer.port}/")
    span_lock = viewer.span if viewer is not None else contextlib.nullcontext
    report = RunReport()
    for name, _ in iters:
        report.track_times[name] = []
        report.states[name] = []

    try:
        live = list(range(len(iters)))
        n_rounds = 0
        while live:
            for idx in list(live):
                name, it = iters[idx]
                span = max(1, span_chunks * mm.robots[idx].chunk_size)
                stamps, imgs = [], []
                for _ in range(span):
                    try:
                        ts, img = next(it)
                    except StopIteration:
                        live.remove(idx)
                        break
                    stamps.append(float(ts))
                    imgs.append(img)
                if not imgs:
                    continue
                t0 = time.perf_counter()
                with span_lock():
                    recs = mm.process_frames(idx, imgs, stamps)
                dt = time.perf_counter() - t0
                report.track_times[name].extend([dt / len(imgs)] * len(imgs))
                report.states[name].extend(r.state for r in recs)
                if pace_real_time and cfg.camera.fps > 0:
                    sleep = len(imgs) / cfg.camera.fps - dt
                    if sleep > 0:
                        time.sleep(sleep)
            n_rounds += 1
            if verbose and n_rounds % 4 == 0:
                print(f"[driver] span {n_rounds}: {mm.summary()}")

        # drain the deferred merge-scan pipeline (the reference's shutdown
        # barrier lets the MultiMapper finish its scan in flight, MultiMapper.cc:954)
        with span_lock():
            mm.flush_merge_scans()
    finally:
        if viewer is not None:
            viewer.stop()
    if out_dir is not None:
        save_outputs(mm, out_dir)
    if verbose:
        for name, s in report.timing_summary().items():
            print(f"[driver] {name}: median track {s['median_s'] * 1e3:.1f} ms, "
                  f"mean {s['mean_s'] * 1e3:.1f} ms ({s['fps']:.1f} fps)")
        print(f"[driver] final: {mm.summary()}")
        stages = get_tracer().stage_summary()
        for name in ("track", "local_mapping", "loop_detect", "loop_correct", "merge_scan",
                     "merge"):
            if name in stages:
                s = stages[name]
                print(f"[trace] {name}: n={s['count']} median={s['median_ms']}ms "
                      f"p90={s['p90_ms']}ms total={s['total_s']}s")
    return mm, report


def save_outputs(mm: MultiMapper, out_dir: str | Path) -> None:
    """Per robot, its tracked frames as TUM and KITTI trajectories; per live
    map, its keyframes as a TUM trajectory; the maps (``maps/``, through
    ``serialize.save_session``); per live map with keyframes, its
    rendering ``map<id>.png`` (``viz.draw_map``); the Tracer's
    ``trace_report.json`` and ``events.jsonl``. The reference's
    SaveTrajectory* and SaveMultipleMapsTrajectories."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for r in mm.robots:
        ok = [f for f in r.frames if f.state == "OK"]
        if ok:
            stamps = np.asarray([f.timestamp for f in ok])
            # poses through their reference keyframes at save time
            # (System.cc:470-499): frames ride every correction
            poses = np.stack(resolve_frame_poses(ok))
            tio.save_tum(out / f"{r.name}_frames_tum.txt", stamps, poses)
            tio.save_kitti(out / f"{r.name}_frames_kitti.txt", poses)
    for mc in mm.live_maps():
        kv = mc.map.kf_valid.cpu().numpy()
        if kv.sum():
            poses = mc.map.kf_pose.cpu().numpy()[kv]
            stamps = mc.map.kf_timestamp.cpu().numpy()[kv]
            order = np.argsort(stamps)
            tio.save_tum(out / f"map{mc.map_id}_keyframes_tum.txt", stamps[order],
                         poses[order])
            viz.draw_map(mc.map, out / f"map{mc.map_id}.png", title=f"map {mc.map_id}")
    serialize.save_session(out / "maps", mm)
    tr = get_tracer()
    tr.save_report(out / "trace_report.json")
    tr.save_events(out / "events.jsonl")
