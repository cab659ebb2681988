"""The port's driver (orbslamm_tpu_torch/driver.py) and its TUM command line
(orbslamm_tpu_torch/examples/mono_tum.py) against the JAX package's, on the
CPU at test size.

  * ``run_robots`` of both packages on tests/test_trace.py's configuration
    (24 frames): the same output files, the maps' renderings
    ``map<id>.png`` included, the same stage, counter and event
    names in the Tracer's report, and the port's output directory read by
    the JAX package (``load_tum``, ``load_kitti``, ``load_session``);
  * the command line, run on a synthetic sequence exported in the TUM
    layout, as tests/test_e2e_tum.py runs the JAX package's, at a test-size
    base configuration: Sim3 ATE below 0.5 m;
  * chip_smoke.py's driver phase on the CPU, its gates included.
"""

import functools
import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from orbslamm_tpu.io import serialize as jser
from orbslamm_tpu.io import trajectory as jtio
from orbslamm_tpu.models.multimap import MultiMapper as JMultiMapper
from orbslamm_tpu_torch.io import trajectory as ttio
from orbslamm_tpu_torch.utils import config as tc

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
N_FRAMES = 24


def _cfg(pkg):
    """tests/test_trace.py's configuration, from either package's config."""
    if pkg == "jax":
        from orbslamm_tpu.utils import config as c
    else:
        c = tc
    return c.SlamConfig(
        camera=c.CameraConfig(width=320, height=240, fx=260, fy=260, cx=160, cy=120),
        orb=c.OrbConfig(n_features=600, max_keypoints=1024, n_levels=4),
        capacity=c.CapacityConfig(max_keyframes=64, max_landmarks=4096),
        tracking=c.TrackingConfig(pixel_noise=1.2, min_matches_init=55,
                                  init_min_triangulated=30, init_min_parallax_deg=0.4,
                                  new_kf_max_frames=4),
    )


def _sequence(n=N_FRAMES):
    from orbslamm_tpu_torch.io.synthetic import make_sequence

    return make_sequence(n_frames=n, n_points=1400, cam=_cfg("port").camera, seed=7)


def _frames(seq):
    for i in range(len(seq.timestamps)):
        yield seq.timestamps[i], np.asarray(seq.images[i])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' run_robots on one sequence; each package's output
    directory, Tracer report, events and MultiMapper."""
    from orbslamm_tpu import driver as jdriver
    from orbslamm_tpu.utils.trace import get_tracer as jax_tracer
    from orbslamm_tpu_torch import driver as tdriver
    from orbslamm_tpu_torch.utils.trace import get_tracer as port_tracer

    seq = _sequence()
    root = tmp_path_factory.mktemp("driver")
    out = {}
    for pkg, drv, tracer, kw in (("jax", jdriver, jax_tracer, {}),
                                 ("port", tdriver, port_tracer, {"device": "cpu"})):
        mm, report = drv.run_robots(_cfg(pkg), [drv.RobotFeed(_frames(seq), "r0")],
                                    out_dir=root / pkg, verbose=False, **kw)
        out[pkg] = SimpleNamespace(dir=root / pkg, mm=mm, report=report,
                                   trace=tracer().report(), events=tracer().events())
    return out


def _files(run) -> list[str]:
    """The run's output files, each map's id (a process-wide counter in
    either package) replaced by its place among the run's live maps."""
    place = {mc.map_id: i for i, mc in enumerate(run.mm.live_maps())}
    out = []
    for f in (str(p.relative_to(run.dir)) for p in run.dir.rglob("*") if p.is_file()):
        m = re.fullmatch(r"(maps/map_|map)(\d+)(.*)", f)
        out.append(f"{m[1]}<{place[int(m[2])]}>{m[3]}" if m else f)
    return sorted(out)


def test_run_robots_writes_the_jax_files(runs):
    """The same file names as the JAX package's run, each map's rendering
    ``map<id>.png`` included (a PNG that PIL decodes), the same frame states
    and timing-summary keys."""
    from PIL import Image

    from orbslamm_tpu_torch.io import viz

    j, t = runs["jax"], runs["port"]
    want = _files(j)
    assert _files(t) == want
    assert {"r0_frames_tum.txt", "maps/manifest.json", "map<0>_keyframes_tum.txt",
            "maps/map_<0>.npz", "map<0>.png"} <= set(want)
    for mc in t.mm.live_maps():
        with Image.open(t.dir / f"map{mc.map_id}.png") as img:
            assert img.format == "PNG" and img.size == viz.MAP_SIZE
    assert t.report.states == j.report.states
    assert t.report.states["r0"].count("OK") >= N_FRAMES - 4
    s = t.report.timing_summary()["r0"]
    assert sorted(s) == sorted(j.report.timing_summary()["r0"]) and s["fps"] > 0


def test_trace_report_has_the_jax_names(runs):
    """``trace_report.json`` of both runs: the same keys, stage (span) names
    and counter names, and the same event kinds in ``events.jsonl``."""
    reps = {k: json.loads((r.dir / "trace_report.json").read_text()) for k, r in runs.items()}
    assert sorted(reps["port"]) == sorted(reps["jax"]) == ["counters", "gauges", "stages"]
    assert sorted(reps["port"]["stages"]) == sorted(reps["jax"]["stages"])
    assert {"track", "loop_detect"} <= set(reps["port"]["stages"])
    assert sorted(reps["port"]["counters"]) == sorted(reps["jax"]["counters"])
    for k in ("track", "loop_detect"):
        assert sorted(reps["port"]["stages"][k]) == sorted(reps["jax"]["stages"][k])
    kinds = {k: Counter(json.loads(x)["kind"] for x in (r.dir / "events.jsonl").read_text()
                        .splitlines()) for k, r in runs.items()}
    assert set(kinds["port"]) == set(kinds["jax"]) == {"keyframe"}
    assert reps["port"]["counters"]["keyframes_inserted"] == kinds["port"]["keyframe"]


def test_jax_package_reads_the_port_outputs(runs):
    """The JAX package's loaders on the port's output directory: its TUM and
    KITTI trajectories give the port's own loaders' arrays and the frames
    the port resolved, and its session loads into a JAX MultiMapper."""
    from orbslamm_tpu_torch.models.system import resolve_frame_poses

    t = runs["port"]
    d = t.dir
    ts_j, rows_j = jtio.load_tum(d / "r0_frames_tum.txt")
    ts_t, rows_t = ttio.load_tum(d / "r0_frames_tum.txt")
    assert np.array_equal(ts_j, ts_t) and np.array_equal(rows_j, rows_t)
    k_j = jtio.load_kitti(d / "r0_frames_kitti.txt")
    k_t = ttio.load_kitti(d / "r0_frames_kitti.txt")
    assert np.array_equal(k_j, k_t)
    ok = [f for f in t.mm.robots[0].frames if f.state == "OK"]
    poses = np.stack(resolve_frame_poses(ok))
    assert len(ts_j) == len(ok)
    np.testing.assert_allclose(ts_j, [f.timestamp for f in ok], atol=1e-6)
    np.testing.assert_allclose(k_j[:, :3, :3], np.transpose(poses[:, :3, :3], (0, 2, 1)),
                               atol=1e-6)
    np.testing.assert_allclose(rows_j[:, :3], k_j[:, :3, 3], atol=1e-6)
    live = t.mm.live_maps()
    kf_ts, _ = jtio.load_tum(d / f"map{live[0].map_id}_keyframes_tum.txt")
    assert len(kf_ts) == int(live[0].map.kf_valid.sum())
    mm_j = JMultiMapper(_cfg("jax"))
    jser.load_session(d / "maps", mm_j)
    assert [mc.n_kf for mc in mm_j.maps] == [mc.n_kf for mc in live]
    for mc_j, mc_t in zip(mm_j.maps, live):
        for k, v in mc_t.map._asdict().items():
            assert np.array_equal(np.asarray(getattr(mc_j.map, k)), v.numpy()), k
    assert mm_j.maps[0].voc is not None


def test_mono_tum_cli_end_to_end(tmp_path, monkeypatch):
    """The port's mono_tum main on a synthetic forward sequence exported in
    the TUM layout (tests/test_e2e_tum.py's sequence, its first 30 frames),
    on the CPU, with the settings file read over a test-size base
    configuration (512 keypoint slots, 64 keyframes, 4096 landmarks: the
    defaults' 16384-landmark fuse takes minutes on the CPU): the loader
    round trip, then trajectories, maps and the trace written, and a Sim3
    ATE below 0.5 m over at least 20 frames."""
    from orbslamm_tpu_torch.eval.ate import ate_rmse
    from orbslamm_tpu_torch.examples import mono_tum
    from orbslamm_tpu_torch.io.datasets import load_tum_sequence
    from orbslamm_tpu_torch.io.synthetic import export_tum_sequence, make_sequence

    pytest.importorskip("PIL")
    cam = tc.CameraConfig(width=320, height=240, fx=260, fy=260, cx=160, cy=120, fps=30)
    seq = make_sequence(n_frames=60, n_points=900, cam=cam, seed=7, motion="forward")
    root = export_tum_sequence(seq, tmp_path / "seq")
    loaded = load_tum_sequence(root)
    assert len(loaded) == 60 and loaded.frame(0).shape == (240, 320)
    assert np.allclose(loaded.timestamps, seq.timestamps, atol=1e-5)
    base = tc.SlamConfig(orb=tc.OrbConfig(max_keypoints=512),
                         capacity=tc.CapacityConfig(max_keyframes=64, max_landmarks=4096))
    monkeypatch.setattr(mono_tum, "load_settings",
                        functools.partial(tc.load_settings, base=base))
    out = tmp_path / "out"
    mono_tum.main([str(root / "settings.yaml"), str(root), "1", "--out", str(out),
                   "--max-frames", "30", "--device", "cpu"])
    for f in ("robot0_frames_kitti.txt", "maps/manifest.json", "trace_report.json",
              "events.jsonl"):
        assert (out / f).exists(), f
    stamps, rows = ttio.load_tum(out / "robot0_frames_tum.txt")
    assert len(stamps) >= 20, f"only {len(stamps)} poses"
    gt = seq.poses_cw[[int(round(t * cam.fps)) for t in stamps]]
    gt_c = -np.einsum("nji,nj->ni", gt[:, :3, :3], gt[:, :3, 3])
    ate = ate_rmse(rows[:, :3], gt_c)
    assert ate < 0.5, f"end-to-end ATE {ate:.3f}"


def test_mono_tum_module_runs_and_refuses_the_viewer(tmp_path):
    """``python -m orbslamm_tpu_torch.examples.mono_tum``: its usage, and a
    run with ``--viewer PORT`` (the live viewer of step 15b, which the
    command line once refused) on the first 4 frames of a synthetic TUM
    export: the viewer answers ``/state`` while the run goes on, and the
    run ends with its outputs written."""
    import socket
    import time
    import urllib.request

    from orbslamm_tpu_torch.io.synthetic import export_tum_sequence, make_sequence

    cmd = [sys.executable, "-m", "orbslamm_tpu_torch.examples.mono_tum"]
    out = subprocess.run(cmd + ["--help"], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and "--device" in out.stdout and "--two-robots" in out.stdout
    assert "--viewer" in out.stdout
    cam = tc.CameraConfig(width=320, height=240, fx=260, fy=260, cx=160, cy=120, fps=30)
    root = export_tum_sequence(make_sequence(n_frames=4, n_points=900, cam=cam, seed=7,
                                             motion="forward"), tmp_path / "seq")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(cmd + [str(root / "settings.yaml"), str(root), "1", "--viewer",
                                   str(port), "--device", "cpu", "--out", str(tmp_path / "out")],
                            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    state = None
    try:
        deadline = time.monotonic() + 240
        while state is None and proc.poll() is None and time.monotonic() < deadline:
            try:
                state = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/state",
                                                          timeout=240).read())
            except OSError:
                time.sleep(0.01)
        log = proc.communicate(timeout=240)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, log
    assert state is not None, log
    assert [r["name"] for r in state["robots"]] == ["robot0"]
    assert f"live viewer at http://127.0.0.1:{port}/" in log
    assert (tmp_path / "out" / "maps" / "manifest.json").is_file()


def test_chip_smoke_driver_phase_on_the_cpu(monkeypatch):
    """chip_smoke.driver_path_phase, gates included, on the CPU at test
    size: 16 frames written to disk by the smoke's PNG writer, decoded by
    the native loader, run through run_robots with its live viewer polled,
    the files and the session read back."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from orbslamm_tpu_torch.ops.cuda import hamming as tph

    monkeypatch.setattr(chip_smoke, "bench_cfg", lambda: _cfg("port"))
    seq = _sequence(16)
    ph = SimpleNamespace(launches=0, launches_by_shape=Counter())
    # spans of one chunk: the viewer's pollers get two span boundaries
    res = chip_smoke.driver_path_phase(torch, ph, "cpu", seq, 2, "cpu", span_chunks=1)
    assert res["viewer"]["state_answers"] >= 2 and res["viewer"]["map_png_answers"] >= 2
    assert any(f.startswith("map") and f.endswith(".png") for f in res["files"])
    assert res["frames"] == 16 and res["tracked_share"] >= 0.9 and res["ate_m"] < 0.5
    assert max(res["trajectory_file_err"].values()) <= 1e-6
    assert res["launches"] == 0 and tph.launches == 0  # the CPU runs the plain matcher
    assert "robot0_frames_tum.txt" in res["files"] and res["bytes_written"] > 0
