"""The port's example command lines (orbslamm_tpu_torch/examples/) against the
JAX package's scripts (examples/*.py), on the CPU.

  * each command line and the JAX script run on the same files in
    ``tmp_path``, in each reader's layout as tests/test_datasets.py writes
    them, with ``run_robots`` replaced in both by a recorder: the feeds are
    equal (robot names, timestamps, frame bytes), and so are the config,
    ``out_dir`` and ``viewer_port``, but where the JAX script drops
    ``--viewer`` (mono_agz, mono_live: the port passes it on); mono_live
    reads an ``img_%03d.png`` pattern through ``cv2.VideoCapture`` and
    stamps frames with the monotonic clock, so only its frames are compared;
  * the JAX mono_synthetic stops on ``args.viewer`` before its run; the
    port's feeds are held against the scenarios its code defines;
  * convert_gt_to_quaternion: byte-equal output files;
  * two full runs: mono_kitti on 16 frames of a synthetic sequence in the
    KITTI layout (a test-size base configuration, as the mono_tum test),
    and mono_synthetic's kidnap scenario through chip_smoke.py's cli_path
    phase (gates included, 40 frames).
"""

import dataclasses
import functools
import importlib.util
import sys
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from orbslamm_tpu_torch.utils import config as tc

torch.set_num_threads(2)
cv2 = pytest.importorskip("cv2")

REPO = Path(__file__).resolve().parents[1]
SETTINGS = REPO / "examples" / "settings"
N = 6  # frames written per sequence
VIEWER = 8123


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_cli(name):
    return importlib.import_module(f"orbslamm_tpu_torch.examples.{name}")


class Recorder:
    """Stands in for ``run_robots``: keeps the config, the feeds (consumed)
    and the keyword arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, cfg, feeds, **kw):
        frames = [(f.name, [(float(ts), np.asarray(img)) for ts, img in f.frames])
                  for f in feeds]
        self.calls.append(SimpleNamespace(cfg=cfg, feeds=frames, kw=kw))


def _run_both(monkeypatch, name, argv, port_extra=("--device", "cpu")):
    """The JAX script's main and the port's on the same arguments; their
    recorded run_robots calls."""
    jmod, tmod = _jax_script(name), _port_cli(name)
    rec_j, rec_t = Recorder(), Recorder()
    monkeypatch.setattr(jmod, "run_robots", rec_j)
    monkeypatch.setattr(tmod, "run_robots", rec_t)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    jmod.main()
    tmod.main([*argv, *port_extra])
    assert len(rec_j.calls) == len(rec_t.calls) == 1
    return rec_j.calls[0], rec_t.calls[0]


def _assert_same_feeds(j, t, stamps=True):
    assert [n for n, _ in t.feeds] == [n for n, _ in j.feeds]
    for (_, fj), (_, ft) in zip(j.feeds, t.feeds):
        assert len(ft) == len(fj) > 0
        for (ts_j, im_j), (ts_t, im_t) in zip(fj, ft):
            assert im_t.dtype == np.uint8 and np.array_equal(im_t, im_j)
            if stamps:
                assert ts_t == ts_j


def _assert_same_cfg(j, t):
    assert dataclasses.asdict(t.cfg) == dataclasses.asdict(j.cfg)


def _images(n=N, h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w), dtype=np.uint8) for _ in range(n)]


def _write(path, img):
    path.parent.mkdir(parents=True, exist_ok=True)
    assert cv2.imwrite(str(path), img)


def _kitti_dir(root, images, t0=0.0):
    (root / "image_0").mkdir(parents=True, exist_ok=True)
    (root / "times.txt").write_text("".join(f"{t0 + 0.1 * i:.6e}\n" for i in range(len(images))))
    for i, img in enumerate(images):
        _write(root / "image_0" / f"{i:06d}.png", img)
    return root


LAYOUTS = {}


def layout(name):
    def register(fn):
        LAYOUTS[name] = fn
        return fn
    return register


@layout("mono_tum")
def _tum(root):
    lines = ["# color images"]
    for i, img in enumerate(_images(seed=1)):
        _write(root / "rgb" / f"{1.5 + i / 30:.6f}.png", img)
        lines.append(f"{1.5 + i / 30:.6f} rgb/{1.5 + i / 30:.6f}.png")
    (root / "rgb.txt").write_text("\n".join(lines) + "\n")
    return SETTINGS / "TUM1.yaml", [str(root)]


@layout("mono_kitti")
def _kitti(root):
    return SETTINGS / "KITTI00-02.yaml", [str(_kitti_dir(root, _images(seed=2)))]


@layout("mono_eth")
def _eth(root):
    stamps = [1403715273262142976 + 50_000_000 * i for i in range(N)]
    (root / "data.csv").write_text("#timestamp [ns],filename\n"
                                   + "".join(f"{s},{s}.png\n" for s in stamps))
    for s, img in zip(stamps, _images(seed=3)):
        _write(root / "data" / f"{s}.png", img)
    return SETTINGS / "ETH_V1_3_Difficult.yaml", [str(root)]


@layout("mono_newcollege")
def _newcollege(root):
    names = [f"f{i}.png" for i in range(N)]
    (root / "times.txt").write_text("".join(f"{10 + 0.1 * i}\n" for i in range(N)))
    (root / "right").mkdir(parents=True)
    (root / "right" / "filenames.txt").write_text("\n".join(names) + "\n")
    for n, img in zip(names, _images(seed=4)):
        _write(root / "right" / n, img)
    return SETTINGS / "NewCollege.yaml", [str(root)]


@layout("mono_agz")
def _agz(root):
    names = [f"img{i}.png" for i in range(12)]
    (root / "filenames.txt").write_text("\n".join(names) + "\n")
    for n, img in zip(names, _images(12, seed=5)):
        _write(root / "MAVImages" / n, img)
    return SETTINGS / "AGZ.yaml", [str(root)]


@pytest.mark.parametrize("name,two_robots", [
    ("mono_tum", False), ("mono_tum", True), ("mono_kitti", False), ("mono_kitti", True),
    ("mono_eth", False), ("mono_eth", True), ("mono_newcollege", False),
    ("mono_newcollege", True), ("mono_agz", False)])
def test_cli_feeds_match_the_jax_script(tmp_path, monkeypatch, name, two_robots):
    (tmp_path / "seq").mkdir()
    settings, seq_args = LAYOUTS[name](tmp_path / "seq")
    argv = [str(settings), *seq_args, "0", "--out", str(tmp_path / "out"), "--max-frames", "5",
            "--viewer", str(VIEWER)]
    if two_robots:
        argv.append("--two-robots")
    j, t = _run_both(monkeypatch, name, argv)
    _assert_same_feeds(j, t)
    _assert_same_cfg(j, t)
    assert not t.cfg.multi_mapping  # the "0" argument
    assert t.kw["out_dir"] == j.kw["out_dir"] == str(tmp_path / "out")
    assert t.kw["viewer_port"] == VIEWER and t.kw["device"] == "cpu"
    # the JAX mono_agz drops --viewer; the others pass it on
    assert j.kw.get("viewer_port") == (None if name == "mono_agz" else VIEWER)
    assert len(t.feeds) == (2 if two_robots else 1)
    assert sum(len(f) for _, f in t.feeds) == (3 if name == "mono_agz" else 5)


def test_kitti_two_sequences_match_the_jax_script(tmp_path, monkeypatch):
    """mono_kitti_dif_seq: settings1 drives both robots, settings2 is parsed
    and not read, in both packages."""
    s1 = _kitti_dir(tmp_path / "s1", _images(seed=6))
    s2 = _kitti_dir(tmp_path / "s2", _images(4, seed=7), t0=100.0)
    argv = [str(SETTINGS / "KITTI00-02.yaml"), str(s1), "1", str(s2),
            str(tmp_path / "missing.yaml"), "--out", str(tmp_path / "out"), "--viewer",
            str(VIEWER), "--max-frames", "5"]
    j, t = _run_both(monkeypatch, "mono_kitti_dif_seq", argv)
    _assert_same_feeds(j, t)
    _assert_same_cfg(j, t)
    assert [len(f) for _, f in t.feeds] == [5, 4]
    assert t.kw["viewer_port"] == j.kw["viewer_port"] == VIEWER
    assert t.cfg.multi_mapping and t.cfg.vocabulary_path is None


def test_live_capture_matches_the_jax_script(tmp_path, monkeypatch):
    """mono_live on an image pattern read by cv2.VideoCapture: the same
    frames (stamped by the monotonic clock in both, so not compared); the
    JAX script drops --viewer, the port passes it on."""
    for i, img in enumerate(_images(seed=8)):
        _write(tmp_path / "cam" / f"img_{i:03d}.png", img)
    argv = [str(SETTINGS / "BebopConf.yaml"), str(tmp_path / "cam" / "img_%03d.png"),
            "--out", str(tmp_path / "out"), "--max-frames", "4", "--viewer", str(VIEWER)]
    j, t = _run_both(monkeypatch, "mono_live", argv)
    _assert_same_feeds(j, t, stamps=False)
    _assert_same_cfg(j, t)
    stamps = [ts for ts, _ in t.feeds[0][1]]
    assert len(stamps) == 4 and stamps == sorted(stamps)
    assert t.kw["viewer_port"] == VIEWER and j.kw.get("viewer_port") is None


@pytest.mark.parametrize("scenario", ["kidnap", "two-robot", "vo"])
def test_synthetic_feeds_follow_the_jax_scenarios(tmp_path, monkeypatch, scenario):
    """The JAX mono_synthetic stops on ``args.viewer`` (its parser defines
    no --viewer) before its run; the port's feeds are those of the
    scenarios its code defines, on the JAX package's sequences and config."""
    from orbslamm_tpu.io.synthetic import make_sequence
    from orbslamm_tpu.utils import config as jc

    frames = 20
    jmod, tmod = _jax_script("mono_synthetic"), _port_cli("mono_synthetic")
    rec_j, rec_t = Recorder(), Recorder()
    monkeypatch.setattr(jmod, "run_robots", rec_j)
    monkeypatch.setattr(tmod, "run_robots", rec_t)
    monkeypatch.setattr(sys, "argv", ["mono_synthetic.py", "--scenario", scenario,
                                      "--frames", str(frames)])
    with pytest.raises(AttributeError, match="viewer"):
        jmod.main()
    assert rec_j.calls == []
    tmod.main(["--scenario", scenario, "--frames", str(frames), "--device", "cpu",
               "--viewer", str(VIEWER), "--out", str(tmp_path)])
    (t,) = rec_t.calls
    cam = jc.CameraConfig(width=320, height=240, fx=260, fy=260, cx=160, cy=120, fps=30)
    want_cfg = jc.SlamConfig(
        camera=cam, orb=jc.OrbConfig(n_features=600, max_keypoints=1024, n_levels=4),
        capacity=jc.CapacityConfig(max_keyframes=64, max_landmarks=4096),
        tracking=jc.TrackingConfig(pixel_noise=1.2, min_matches_init=55,
                                   init_min_triangulated=30, init_min_parallax_deg=0.4))
    assert dataclasses.asdict(t.cfg) == dataclasses.asdict(want_cfg)
    kw = dict(n_frames=frames, n_points=1400, cam=cam, seed=7)
    if scenario == "kidnap":
        seq, spans = make_sequence(**kw, kidnap_at=frames // 2), [("robot0", 0, frames)]
    elif scenario == "two-robot":
        seq = make_sequence(**kw)
        spans = [("robot0", 0, frames // 2 + 8), ("robot1", frames // 2, frames)]
    else:
        seq, spans = make_sequence(**kw), [("robot0", 0, frames)]
    want = SimpleNamespace(feeds=[(n, [(float(seq.timestamps[i]), np.asarray(seq.images[i]))
                                       for i in range(lo, hi)]) for n, lo, hi in spans])
    _assert_same_feeds(want, t)
    assert t.kw == {"out_dir": str(tmp_path), "viewer_port": VIEWER, "device": "cpu"}


def test_convert_gt_to_quaternion_matches_the_jax_script(tmp_path, monkeypatch):
    rng = np.random.default_rng(9)
    rows = []
    for _ in range(20):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                      [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                      [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])
        rows.append(" ".join(f"{v:.9e}" for v in
                             np.concatenate([R, rng.normal(size=(3, 1)) * 5], 1).ravel()))
    poses = tmp_path / "poses.txt"
    poses.write_text("\n".join(rows) + "\n")
    monkeypatch.setattr(sys, "argv", ["convert_gt_to_quaternion.py", str(poses), "-o",
                                      str(tmp_path / "jax.txt")])
    _jax_script("convert_gt_to_quaternion").main()
    _port_cli("convert_gt_to_quaternion").main([str(poses), "-o", str(tmp_path / "port.txt")])
    got = (tmp_path / "port.txt").read_bytes()
    assert got == (tmp_path / "jax.txt").read_bytes() and got.count(b"\n") == 20


def test_mono_kitti_end_to_end(tmp_path, monkeypatch):
    """mono_kitti's full run on the CPU: 16 frames of a synthetic forward
    sequence written in the KITTI layout with the synthetic camera's
    settings file, over a test-size base configuration (512 keypoint
    slots, 64 keyframes, 4096 landmarks): trajectories, maps, renderings
    and the trace written, Sim3 ATE below 0.5 m."""
    from orbslamm_tpu_torch.eval.ate import ate_rmse
    from orbslamm_tpu_torch.examples import mono_kitti
    from orbslamm_tpu_torch.io import trajectory as ttio
    from orbslamm_tpu_torch.io.synthetic import export_tum_sequence, make_sequence

    cam = tc.CameraConfig(width=320, height=240, fx=260, fy=260, cx=160, cy=120, fps=30)
    seq = make_sequence(n_frames=16, n_points=900, cam=cam, seed=7, motion="forward")
    settings = export_tum_sequence(seq, tmp_path / "tum") / "settings.yaml"
    root = _kitti_dir(tmp_path / "kitti", list(seq.images))
    (root / "times.txt").write_text("".join(f"{t:.6e}\n" for t in seq.timestamps))
    base = tc.SlamConfig(orb=tc.OrbConfig(max_keypoints=512),
                         capacity=tc.CapacityConfig(max_keyframes=64, max_landmarks=4096))
    monkeypatch.setattr(mono_kitti, "load_settings",
                        functools.partial(tc.load_settings, base=base))
    out = tmp_path / "out"
    mono_kitti.main([str(settings), str(root), "1", "--out", str(out), "--device", "cpu"])
    for f in ("robot0_frames_kitti.txt", "maps/manifest.json", "trace_report.json",
              "events.jsonl"):
        assert (out / f).exists(), f
    assert list(out.glob("map*.png"))
    stamps, rows = ttio.load_tum(out / "robot0_frames_tum.txt")
    assert len(stamps) >= 10, f"only {len(stamps)} poses"
    gt = seq.poses_cw[[int(round(t * cam.fps)) for t in stamps]]
    gt_c = -np.einsum("nji,nj->ni", gt[:, :3, :3], gt[:, :3, 3])
    ate = ate_rmse(rows[:, :3], gt_c)
    assert ate < 0.5, f"end-to-end ATE {ate:.3f}"


def test_chip_smoke_cli_phase_on_the_cpu():
    """chip_smoke.cli_path_phase, gates included, on the CPU: mono_synthetic's
    kidnap scenario on 40 frames, a new map after the kidnap."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    ph = SimpleNamespace(launches=0, launches_by_shape=Counter())
    res = chip_smoke.cli_path_phase(torch, ph, "cpu", "cpu", frames=40)
    assert len(res["maps"]) >= 2 and res["launches"] == 0
    assert {"robot0_frames_tum.txt", "robot0_frames_kitti.txt", "maps/manifest.json"} \
        <= set(res["files"])
    assert sum(f.endswith(".png") for f in res["files"]) == sum(
        m["n_kf"] > 0 for m in res["maps"])
