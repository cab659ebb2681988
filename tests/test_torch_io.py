"""The port's file I/O against the JAX package's: trajectory files
(``io/trajectory.py``), maps and sessions (``io/serialize.py``), the
dataset readers (``io/datasets.py``), the native frame loader
(``io/native.py``) and chip_smoke.py's PNG writer.

Tolerances: trajectory files byte for byte, and each package's loader equal
to the other's on either file; map fields bitwise (values and dtypes);
reader paths and timestamps exact; pixels exact, but RGB PNGs, where the
native decoder's integer BT.601 weights and PIL's rounding may differ by 1.
"""

import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from orbslamm_tpu.io import datasets as jds
from orbslamm_tpu.io import serialize as jser
from orbslamm_tpu.io import synthetic as jsyn
from orbslamm_tpu.io import trajectory as jtio
from orbslamm_tpu.models import map_state as jms
from orbslamm_tpu.models.multimap import MultiMapper as JMultiMapper
from orbslamm_tpu.utils.config import CameraConfig, CapacityConfig, OrbConfig, SlamConfig
from orbslamm_tpu_torch import convert
from orbslamm_tpu_torch.io import datasets as tds
from orbslamm_tpu_torch.io import native
from orbslamm_tpu_torch.io import serialize as tser
from orbslamm_tpu_torch.io import synthetic as tsyn
from orbslamm_tpu_torch.io import trajectory as ttio
from orbslamm_tpu_torch.models.multimap import MultiMapper as TMultiMapper
from orbslamm_tpu_torch.utils.config import CameraConfig as TCameraConfig

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
# tests/test_io_session.py's configuration
CFG = SlamConfig(
    camera=CameraConfig(width=320, height=240, fx=260, fy=260, cx=160, cy=120),
    orb=OrbConfig(n_features=300, max_keypoints=512, n_levels=4),
    capacity=CapacityConfig(max_keyframes=32, max_landmarks=4096),
)


def _poses(n=9, seed=3):
    cam = CameraConfig(width=64, height=48)
    seq = jsyn.make_sequence(n_frames=n, n_points=50, cam=cam, seed=seed, motion="outback")
    return seq.timestamps, seq.poses_cw


# ---------------------------------------------------------------------------
# trajectory files
# ---------------------------------------------------------------------------

def test_trajectory_writers_write_the_same_bytes(tmp_path):
    """TUM and KITTI files of both packages, byte for byte, on a rendered
    trajectory and on random rotations (every branch of the quaternion)."""
    stamps, poses = _poses()
    rng = np.random.default_rng(0)
    rand = np.tile(np.eye(4), (40, 1, 1))
    for i in range(40):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        rand[i, :3, :3] = q * np.sign(np.linalg.det(q))
        rand[i, :3, 3] = rng.normal(size=3) * 5
    for name, ts, T in (("seq", stamps, poses), ("rand", np.arange(40) * 0.05, rand)):
        jtio.save_tum(tmp_path / f"{name}_j.txt", ts, T)
        ttio.save_tum(tmp_path / f"{name}_t.txt", ts, T)
        jtio.save_kitti(tmp_path / f"{name}_kj.txt", T)
        ttio.save_kitti(tmp_path / f"{name}_kt.txt", T)
        assert (tmp_path / f"{name}_t.txt").read_bytes() == \
            (tmp_path / f"{name}_j.txt").read_bytes()
        assert (tmp_path / f"{name}_kt.txt").read_bytes() == \
            (tmp_path / f"{name}_kj.txt").read_bytes()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_trajectory_loaders_read_the_other_packages_files(tmp_path, writer):
    """load_tum and load_kitti of both packages on one package's files:
    equal arrays, and the TUM positions and KITTI rotations are the poses'
    (as tests/test_io_eval.py holds the JAX round trip)."""
    stamps, poses = _poses()
    mod = jtio if writer == "jax" else ttio
    mod.save_tum(tmp_path / "t.txt", stamps, poses)
    mod.save_kitti(tmp_path / "k.txt", poses)
    (tmp_path / "c.txt").write_text("# a comment\n\n" + (tmp_path / "t.txt").read_text())
    for f in ("t.txt", "c.txt"):
        ts_t, rows_t = ttio.load_tum(tmp_path / f)
        ts_j, rows_j = jtio.load_tum(tmp_path / f)
        assert np.array_equal(ts_t, ts_j) and np.array_equal(rows_t, rows_j)
    np.testing.assert_allclose(ts_t, stamps, atol=1e-5)
    centers = -np.einsum("nji,nj->ni", poses[:, :3, :3], poses[:, :3, 3])
    np.testing.assert_allclose(rows_t[:, :3], centers, atol=1e-5)
    k_t, k_j = ttio.load_kitti(tmp_path / "k.txt"), jtio.load_kitti(tmp_path / "k.txt")
    assert np.array_equal(k_t, k_j) and k_t.shape == (len(poses), 4, 4)
    np.testing.assert_allclose(k_t[:, :3, :3], np.transpose(poses[:, :3, :3], (0, 2, 1)),
                               atol=1e-6)
    (tmp_path / "e.txt").write_text("# nothing\n")
    for mod in (ttio, jtio):
        ts_e, rows_e = mod.load_tum(tmp_path / "e.txt")
        assert ts_e.shape == (0,) and rows_e.shape == (0, 7)


# ---------------------------------------------------------------------------
# maps and sessions
# ---------------------------------------------------------------------------

def _small_map(pkg, seed=0, n_kf=4):
    """tests/test_io_session.py's small_map, from either package's
    fabricate_map (the same draws, tests/test_torch_package.py)."""
    rng = np.random.default_rng(seed)
    T = np.tile(np.eye(4, dtype=np.float32), (n_kf, 1, 1))
    for i in range(n_kf):
        T[i, 0, 3] = 0.3 * i
    pts = rng.uniform(-3, 3, (400, 3)).astype(np.float32)
    pts[:, 2] += 8
    desc = rng.integers(0, 256, (400, 32), dtype=np.uint8)
    if pkg == "jax":
        return jsyn.fabricate_map(CFG, T, pts, desc, seed=seed)[0]
    return tsyn.fabricate_map(CFG, T, pts, desc, seed=seed, device="cpu")[0]


def _assert_same_map(m_t, m_j):
    got = convert.map_state_to_numpy(m_t)
    assert sorted(got) == sorted(jms.MapState._fields)
    for k in jms.MapState._fields:
        want = np.asarray(getattr(m_j, k))
        assert got[k].dtype == want.dtype and got[k].shape == want.shape, k
        assert np.array_equal(got[k], want), k


def test_map_files_cross_load_bitwise(tmp_path):
    """A JAX save_map file loads into the port bitwise, and a port file into
    the JAX package; the port's own round trip too, on the named device."""
    m_j = _small_map("jax")
    m_t = _small_map("port")
    _assert_same_map(m_t, m_j)
    jser.save_map(tmp_path / "j.npz", m_j)
    tser.save_map(tmp_path / "t.npz", m_t)
    got = tser.load_map(tmp_path / "j.npz", device="cpu")
    assert all(v.device.type == "cpu" for v in got)
    _assert_same_map(got, m_j)
    _assert_same_map(m_t, jser.load_map(tmp_path / "t.npz"))
    _assert_same_map(tser.load_map(tmp_path / "t.npz", device="cpu"), m_j)
    with np.load(tmp_path / "t.npz") as a, np.load(tmp_path / "j.npz") as b:
        assert sorted(a.files) == sorted(b.files)


def _session(pkg):
    """A MultiMapper with two maps (4 and 2 keyframes) and a recorded merge."""
    mm = JMultiMapper(CFG) if pkg == "jax" else TMultiMapper(CFG, device="cpu")
    for seed, n_kf in ((0, 4), (1, 2)):
        mc = mm.new_map()
        mc.map = _small_map(pkg, seed=seed, n_kf=n_kf)
        mc.n_kf = n_kf
    mm.merges.append((7, 3, 1, 2))
    return mm


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sessions_cross_load(tmp_path, writer):
    """A session directory of one package loads into the other's
    MultiMapper (and into its own): the same maps, keyframe counts, merges
    and ``kf_valid``, every map field bitwise, the vocabulary trained from
    the first map's descriptors. The port computes every loaded keyframe's
    BoW row, in each map."""
    src = _session(writer)
    (jser if writer == "jax" else tser).save_session(tmp_path / "s", src)
    manifest = (tmp_path / "s" / "manifest.json").read_text()
    assert '"merges"' in manifest and len(list((tmp_path / "s").glob("map_*.npz"))) == 2
    mm_t = TMultiMapper(CFG, device="cpu")
    tser.load_session(tmp_path / "s", mm_t)
    mm_j = JMultiMapper(CFG)
    jser.load_session(tmp_path / "s", mm_j)
    assert [mc.n_kf for mc in mm_t.maps] == [mc.n_kf for mc in mm_j.maps] == [4, 2]
    assert mm_t.merges == mm_j.merges == [(7, 3, 1, 2)]
    for mc_t, mc_j in zip(mm_t.maps, mm_j.maps):
        assert np.array_equal(mc_t.map.kf_valid.numpy(), np.asarray(mc_j.map.kf_valid))
        _assert_same_map(mc_t.map, mc_j.map)
        assert mc_t.device == mm_t.device
        assert mc_t.voc is not None and mc_t.voc is mm_t.voc
        rows = mc_t.kf_bow[:mc_t.n_kf].sum(-1)
        assert torch.allclose(rows, torch.ones(mc_t.n_kf)), rows
    assert mm_j.maps[0].voc is not None


# ---------------------------------------------------------------------------
# dataset readers
# ---------------------------------------------------------------------------

def _layouts(root: Path) -> dict:
    """tests/test_datasets.py's layouts, one directory each."""
    d = {k: root / k for k in ("tum", "kitti", "euroc", "newcollege", "agz")}
    (d["tum"] / "rgb").mkdir(parents=True)
    (d["tum"] / "rgb.txt").write_text("# comment\n1.5 rgb/a.png\n2.5 rgb/b.png\n")
    d["kitti"].mkdir()
    (d["kitti"] / "times.txt").write_text("0.0\n0.1\n0.2\n")
    (d["euroc"] / "data").mkdir(parents=True)
    (d["euroc"] / "data.csv").write_text(
        "#timestamp [ns],filename\n"
        "1403715273262142976,1403715273262142976.png\n"
        "1403715273312143104,1403715273312143104.png\n")
    (d["newcollege"] / "right").mkdir(parents=True)
    (d["newcollege"] / "times.txt").write_text("10.0\n\n10.2\n10.3\n")
    (d["newcollege"] / "right" / "filenames.txt").write_text("a.png\nb.png\nc.png\nd.png\n")
    (d["agz"] / "MAVImages").mkdir(parents=True)
    (d["agz"] / "filenames.txt").write_text("\n".join(f"img{i}.png" for i in range(12)) + "\n")
    return d


READERS = ["load_tum_sequence", "load_kitti_sequence", "load_euroc_sequence",
           "load_newcollege_sequence", "load_agz_sequence"]


@pytest.mark.parametrize("reader", READERS)
def test_readers_match_the_jax_readers(tmp_path, reader):
    """Each reader on tests/test_datasets.py's layout: the JAX reader's
    paths, timestamps (values and dtype) and name."""
    d = _layouts(tmp_path)[reader.split("_")[1]]
    got, want = getattr(tds, reader)(d), getattr(jds, reader)(d)
    assert len(got) == len(want) > 0
    assert got.paths == want.paths and got.name == want.name
    assert got.timestamps.dtype == want.timestamps.dtype
    assert np.array_equal(got.timestamps, want.timestamps)


def _images(d: Path):
    """A gray PNG, an RGB PNG, a palette PNG (outside the native subset)
    and a binary PGM, written with PIL and by hand; their pixels as
    imread_gray decodes them."""
    Image = pytest.importorskip("PIL.Image")

    rng = np.random.default_rng(0)
    d.mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(4):
        Image.fromarray(rng.integers(0, 255, (48, 64), np.uint8)).save(d / f"{i:06d}.png")
        paths.append(d / f"{i:06d}.png")
    Image.fromarray(rng.integers(0, 255, (48, 64, 3), np.uint8)).save(d / "rgb.png")
    Image.fromarray(rng.integers(0, 255, (48, 64), np.uint8)).convert("P").save(d / "pal.png")
    (d / "gray.pgm").write_bytes(b"P5\n64 48\n255\n"
                                 + rng.integers(0, 255, (48, 64), np.uint8).tobytes())
    paths += [d / "rgb.png", d / "pal.png", d / "gray.pgm"]
    return paths


def test_imread_gray_matches_the_jax_package(tmp_path):
    """The same pixels as the JAX package's imread_gray (here through PIL),
    and an ImportError naming both decoders when neither imports."""
    for p in _images(tmp_path):
        got, want = tds.imread_gray(p), jds.imread_gray(p)
        assert got.dtype == want.dtype == np.uint8 and np.array_equal(got, want), p.name
    saved = {k: sys.modules.get(k) for k in ("cv2", "PIL")}
    try:
        sys.modules["cv2"] = None
        sys.modules["PIL"] = None
        with pytest.raises(ImportError, match="cv2.*PIL"):
            tds.imread_gray(tmp_path / "000000.png")
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def _stub_cv2(frames, opened=True):
    """A stand-in cv2 module: a VideoCapture over ``frames`` (BGR or gray)
    and the BGR-to-gray conversion."""
    cv2 = types.ModuleType("cv2")
    cv2.COLOR_BGR2GRAY = 6
    cv2.released = 0

    class VideoCapture:
        def __init__(self, source):
            self.it = iter(list(frames))

        def isOpened(self):
            return opened

        def read(self):
            f = next(self.it, None)
            return (f is not None), f

        def release(self):
            cv2.released += 1

    def cvtColor(img, code):
        assert code == cv2.COLOR_BGR2GRAY
        w = np.array([0.114, 0.587, 0.299])
        return np.round(img.astype(np.float64) @ w).astype(np.uint8)

    cv2.VideoCapture, cv2.cvtColor = VideoCapture, cvtColor
    return cv2


@pytest.mark.parametrize("max_frames", [0, 2])
def test_video_capture_frames_match_the_jax_package(monkeypatch, max_frames):
    """Both packages' live-camera generators over a stub cv2: the same
    frames (gray from BGR, gray passed through), ``max_frames`` honoured,
    the capture released; an unopened source raises RuntimeError."""
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 255, (6, 8, 3), np.uint8), rng.integers(0, 255, (6, 8), np.uint8),
              rng.integers(0, 255, (6, 8, 3), np.uint8)]
    stub = _stub_cv2(frames)
    monkeypatch.setitem(sys.modules, "cv2", stub)
    got = list(tds.video_capture_frames(0, max_frames=max_frames))
    want = list(jds.video_capture_frames(0, max_frames=max_frames))
    assert len(got) == len(want) == (max_frames or 3)
    for (ts_g, a), (ts_w, b) in zip(got, want):
        assert isinstance(ts_g, float) and np.array_equal(a, b) and a.ndim == 2
    assert stub.released == 2
    monkeypatch.setitem(sys.modules, "cv2", _stub_cv2(frames, opened=False))
    with pytest.raises(RuntimeError, match="could not open"):
        next(tds.video_capture_frames("cam.mp4"))


# ---------------------------------------------------------------------------
# the native frame loader
# ---------------------------------------------------------------------------

def test_native_library_builds_under_build_and_leaves_native_alone(tmp_path, monkeypatch):
    """The build compiles native/frame_loader.cc into the library path it is
    given (build/native/libframe_loader.so by default) and writes nothing
    under native/."""
    before = sorted((p.name, p.stat().st_mtime_ns) for p in (REPO / "native").iterdir())
    assert native._LIBRARY == REPO / "build" / "native" / "libframe_loader.so"
    lib_path = tmp_path / "lib" / "libframe_loader.so"
    monkeypatch.setattr(native, "_LIBRARY", lib_path)
    monkeypatch.setattr(native, "_lib", None)
    lib = native.build()
    assert lib_path.exists() and lib.fl_next.restype is not None
    assert native.build() is lib  # loaded once
    assert not list(lib_path.parent.glob("*.tmp.so"))
    after = sorted((p.name, p.stat().st_mtime_ns) for p in (REPO / "native").iterdir())
    assert after == before
    # the default library, as the rest of the port builds and loads it
    monkeypatch.setattr(native, "_LIBRARY", REPO / "build" / "native" / "libframe_loader.so")
    monkeypatch.setattr(native, "_lib", None)
    assert native.native_available() and native._LIBRARY.exists()


def test_native_loader_decodes_to_imread_gray_pixels(tmp_path):
    """Gray PNGs and a PGM decode exactly to imread_gray's pixels, an RGB PNG
    within 1 (integer BT.601 weights against PIL's rounding), a palette PNG
    through the imread_gray fallback, all in order, with 1 and 4 threads
    and a short lookahead."""
    paths = _images(tmp_path)
    truth = [tds.imread_gray(p) for p in paths]
    for lookahead, threads in ((8, 2), (2, 4)):
        dec0, fb0 = native.decoded, native.fallbacks
        frames = list(native.NativeFrameLoader(paths, 48, 64, lookahead=lookahead,
                                               n_threads=threads))
        assert native.decoded - dec0 == 6 and native.fallbacks - fb0 == 1
        assert len(frames) == len(paths)
        for p, f, t in zip(paths, frames, truth):
            assert f.dtype == np.uint8 and f.shape == (48, 64), p.name
            if p.name == "rgb.png":
                assert np.abs(f.astype(int) - t.astype(int)).max() <= 1
            else:
                assert np.array_equal(f, t), p.name


def test_prefetched_uses_the_native_loader_and_raises_its_errors(tmp_path, monkeypatch):
    """``ImageSequence.prefetched`` yields the timestamps and imread_gray's
    pixels through the native loader; with no native library it decodes
    with imread_gray; an error inside the native loader propagates."""
    paths = _images(tmp_path)[:4]
    seq = tds.ImageSequence(paths, np.arange(4) * 0.5, name="x")
    dec0 = native.decoded
    got = list(seq.prefetched(48, 64))
    assert native.decoded - dec0 == 4
    want = list(iter(seq))
    assert [t for t, _ in got] == [t for t, _ in want] == [0.0, 0.5, 1.0, 1.5]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(got, want))
    assert np.array_equal(seq.frame(2), want[2][1]) and len(seq) == 4
    monkeypatch.setattr(native, "native_available", lambda: False)
    dec0 = native.decoded
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(seq.prefetched(48, 64), want))
    assert native.decoded == dec0
    monkeypatch.setattr(native, "native_available", lambda: True)

    def broken(*args, **kw):
        raise RuntimeError("loader failed")

    monkeypatch.setattr(native, "NativeFrameLoader", broken)
    with pytest.raises(RuntimeError, match="loader failed"):
        list(seq.prefetched(48, 64))


# ---------------------------------------------------------------------------
# chip_smoke.py's PNG writer
# ---------------------------------------------------------------------------

def test_smoke_png_writer_matches_the_tum_export(tmp_path):
    """chip_smoke.write_tum_dir (stdlib PNGs) against the port's
    export_tum_sequence (PIL PNGs) on one sequence: the same file names,
    rgb.txt and groundtruth.txt byte for byte, and every image decodes to
    the same pixels through imread_gray and through the native loader."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    cam = TCameraConfig(width=96, height=72, fx=80, fy=80, cx=48, cy=36)
    seq = tsyn.make_sequence(n_frames=5, n_points=300, cam=cam, seed=2)
    a = chip_smoke.write_tum_dir(tmp_path / "smoke", seq.timestamps, seq.images, seq.poses_cw)
    b = tsyn.export_tum_sequence(seq, tmp_path / "export")
    names = sorted(str(p.relative_to(a)) for p in a.rglob("*") if p.is_file())
    assert names == sorted(str(p.relative_to(b)) for p in b.rglob("*")
                           if p.is_file() and p.name != "settings.yaml")
    for f in ("rgb.txt", "groundtruth.txt"):
        assert (a / f).read_bytes() == (b / f).read_bytes()
    seq_a, seq_b = tds.load_tum_sequence(a), tds.load_tum_sequence(b)
    native_a = [img for _, img in seq_a.prefetched(72, 96)]
    for i, img in enumerate(seq.images):
        assert np.array_equal(seq_a.frame(i), img) and np.array_equal(seq_b.frame(i), img)
        assert np.array_equal(native_a[i], img)
