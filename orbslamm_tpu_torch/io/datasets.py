"""Dataset readers (port of orbslamm_tpu/io/datasets.py): TUM RGB-D (the
monocular stream), KITTI odometry, EuRoC/ETH, New College, AGZ, and a live
camera.

Formats match the reference's example drivers:
  * TUM:   ``<seq>/rgb.txt`` lines ``timestamp filename`` (mono_tum.cc LoadImages)
  * KITTI: ``<seq>/times.txt`` + ``<seq>/image_<camera>/%06d.png`` (mono_kitti.cc)
  * EuRoC: ``<seq>/data.csv`` + ``<seq>/data/`` (mono_eth.cc)
  * New College: ``<seq>/times.txt`` + ``<seq>/right/filenames.txt``
  * AGZ:   ``<seq>/filenames.txt`` + ``<seq>/MAVImages/``, every 5th frame

Images are decoded on the host to grayscale uint8 numpy arrays, the
pipeline's input: by the native prefetching loader (``io/native.py``) where
it builds, else by OpenCV, else by PIL. Each reader returns the paths,
timestamps and pixels the JAX package's returns.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

import numpy as np


def imread_gray(path: str | Path) -> np.ndarray:
    """Decode an image file to grayscale uint8 with OpenCV, else PIL."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise FileNotFoundError(path)
        return img
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("imread_gray needs OpenCV (cv2) or Pillow (PIL); "
                          "neither is installed") from e
    return np.asarray(Image.open(path).convert("L"))


@dataclass
class ImageSequence:
    paths: list[Path]
    timestamps: np.ndarray  # [T] float64
    name: str = ""

    def __len__(self) -> int:
        return len(self.paths)

    def __iter__(self) -> Iterator[tuple[float, np.ndarray]]:
        for ts, p in zip(self.timestamps, self.paths):
            yield float(ts), imread_gray(p)

    def frame(self, i: int) -> np.ndarray:
        return imread_gray(self.paths[i])

    def prefetched(self, height: int, width: int, lookahead: int = 8):
        """Iterate (timestamp, gray) through the native prefetching decoder
        (native/frame_loader.cc) where it builds, else through
        ``imread_gray``. An error inside the native loader propagates."""
        from orbslamm_tpu_torch.io.native import NativeFrameLoader, native_available

        if not native_available():
            yield from iter(self)
            return
        loader = NativeFrameLoader(self.paths, height, width, lookahead)
        for ts, img in zip(self.timestamps, loader):
            yield float(ts), img


def load_tum_sequence(seq_dir: str | Path) -> ImageSequence:
    seq_dir = Path(seq_dir)
    paths: list[Path] = []
    stamps: list[float] = []
    for line in (seq_dir / "rgb.txt").read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        ts, rel = line.split()[:2]
        stamps.append(float(ts))
        paths.append(seq_dir / rel)
    return ImageSequence(paths, np.asarray(stamps), name=seq_dir.name)


def load_kitti_sequence(seq_dir: str | Path, camera: int = 0) -> ImageSequence:
    seq_dir = Path(seq_dir)
    stamps = np.asarray([float(x) for x in (seq_dir / "times.txt").read_text().split()],
                        np.float64)
    img_dir = seq_dir / f"image_{camera}"
    paths = [img_dir / f"{i:06d}.png" for i in range(len(stamps))]
    return ImageSequence(paths, stamps, name=seq_dir.name)


def load_euroc_sequence(seq_dir: str | Path) -> ImageSequence:
    """EuRoC/ETH camera folder: ``<seq>/data.csv`` lines ``t_ns,filename``
    with images under ``<seq>/data/`` (mono_eth.cc LoadImages + :70).
    Nanosecond timestamps are converted to seconds, the unit decided once
    from the first row so a file is never mixed-unit (the reference keeps
    the raw values)."""
    seq_dir = Path(seq_dir)
    paths: list[Path] = []
    stamps: list[float] = []
    ns_scale: float | None = None
    for line in (seq_dir / "data.csv").read_text().splitlines()[1:]:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        t_str, name = [x.strip() for x in line.split(",")[:2]]
        t = float(t_str)
        if ns_scale is None:
            ns_scale = 1e-9 if t > 1e14 else 1.0
        stamps.append(t * ns_scale)
        paths.append(seq_dir / "data" / name)
    return ImageSequence(paths, np.asarray(stamps), name=seq_dir.name)


def load_newcollege_sequence(seq_dir: str | Path) -> ImageSequence:
    """New College: ``<seq>/times.txt`` + ``<seq>/right/filenames.txt``
    (mono_NewCollege.cc:127-157), paired line by line as the reference's
    getline loop pairs them: a blank line in one file skips that pair only."""
    seq_dir = Path(seq_dir)
    stamps: list[float] = []
    paths: list[Path] = []
    t_lines = (seq_dir / "times.txt").read_text().splitlines()
    f_lines = (seq_dir / "right" / "filenames.txt").read_text().splitlines()
    for t_line, f_line in zip(t_lines, f_lines):
        if not t_line.strip() or not f_line.strip():
            continue
        stamps.append(float(t_line.split()[0]))
        paths.append(seq_dir / "right" / f_line.split()[0])
    return ImageSequence(paths, np.asarray(stamps), name=seq_dir.name)


def load_agz_sequence(seq_dir: str | Path, stride: int = 5) -> ImageSequence:
    """AGZ (Zurich urban MAV): ``<seq>/filenames.txt`` naming images in
    ``<seq>/MAVImages/``; 10 Hz timestamps made up, every ``stride``-th
    frame processed (mono_AGZ.cc LoadImages + main loop ``ni+=5``)."""
    seq_dir = Path(seq_dir)
    names = [s.split()[0] for s in (seq_dir / "filenames.txt").read_text().splitlines()
             if s.strip()]
    paths = [seq_dir / "MAVImages" / n for n in names]
    stamps = np.arange(len(paths), dtype=np.float64) * 0.1
    return ImageSequence(paths[::stride], stamps[::stride], name=seq_dir.name)


def video_capture_frames(source: int | str, max_frames: int = 0):
    """Live camera: yields (timestamp, gray) from an OpenCV ``VideoCapture``
    (a device index or a file/URL), the mono_Bebop.cc:56 path (the Bebop
    H.264 -> FIFO -> v4l2loopback plumbing ends in whatever V4L2 device
    OpenCV sees). Needs OpenCV."""
    import cv2

    cap = cv2.VideoCapture(source)
    if not cap.isOpened():
        raise RuntimeError(f"could not open video source {source!r}")
    n = 0
    try:
        while not max_frames or n < max_frames:
            ok, frame = cap.read()
            if not ok:
                break
            if frame.ndim == 3:
                frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
            yield time.monotonic(), frame
            n += 1
    finally:
        cap.release()
