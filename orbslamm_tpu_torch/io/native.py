"""ctypes binding of the native frame loader (port of orbslamm_tpu/io/native.py).

``NativeFrameLoader`` wraps ``native/frame_loader.cc``: a C++ worker pool
that decodes dataset frames (8-bit non-interlaced PNG, gray or RGB, and
binary PGM, to grayscale) ahead of the consumer into a bounded ring, the
ingestion part of the reference's runtime (cv::imread on the tracking
thread) moved off the Python hot path. A frame outside that subset is
decoded by ``datasets.imread_gray``.

The library is built at first use from the source, which is only read:
``g++ -O3 -fPIC -std=c++17 -shared ... -lz -lpthread`` (the flags of
``native/Makefile``) into ``build/native/libframe_loader.so``, rebuilt when
it is older than the source, written under a temporary name and moved into
place, so processes that build at once never load a half-written file.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
_SOURCE = _REPO / "native" / "frame_loader.cc"
_LIBRARY = _REPO / "build" / "native" / "libframe_loader.so"
_lib = None
decoded = 0  # frames the native decoder decoded in this process
fallbacks = 0  # frames it could not decode, which imread_gray decoded instead


def build() -> ctypes.CDLL:
    """Compile ``native/frame_loader.cc`` (if the library is missing or older
    than the source) and load it."""
    global _lib
    if _lib is not None:
        return _lib
    if not _LIBRARY.exists() or _LIBRARY.stat().st_mtime < _SOURCE.stat().st_mtime:
        cxx = shutil.which("g++")
        if cxx is None:
            raise FileNotFoundError("no C++ compiler (g++) to build the native frame loader")
        _LIBRARY.parent.mkdir(parents=True, exist_ok=True)
        tmp = _LIBRARY.with_suffix(f".{os.getpid()}.tmp.so")
        subprocess.run([cxx, "-O3", "-fPIC", "-std=c++17", "-Wall", "-shared", "-o", str(tmp),
                        str(_SOURCE), "-lz", "-lpthread"], check=True, capture_output=True)
        os.replace(tmp, _LIBRARY)
    lib = ctypes.CDLL(str(_LIBRARY))
    lib.fl_open.restype = ctypes.c_void_p
    lib.fl_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_long,
                            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.fl_next.restype = ctypes.c_long
    lib.fl_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
    lib.fl_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    """Whether the library builds and loads here (a compiler, zlib's header
    and library). Any other error propagates."""
    try:
        build()
    except (OSError, subprocess.CalledProcessError):
        return False
    return True


class NativeFrameLoader:
    """Prefetching grayscale frame iterator over a list of image paths."""

    def __init__(self, paths, height: int, width: int, lookahead: int = 8,
                 n_threads: int = 2):
        self._lib = build()
        self._paths = [str(p) for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*[p.encode() for p in self._paths])
        self._h, self._w = height, width
        self._handle = self._lib.fl_open(arr, len(self._paths), height, width, lookahead,
                                         n_threads)
        self._closed = False

    def __iter__(self):
        global decoded, fallbacks
        from orbslamm_tpu_torch.io.datasets import imread_gray

        buf = np.empty((self._h, self._w), np.uint8)
        ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        emitted = 0
        try:
            while True:
                idx = self._lib.fl_next(self._handle, ptr)
                if idx == -1:
                    break
                if idx == -2:
                    # a format outside the native subset
                    fallbacks += 1
                    yield imread_gray(self._paths[emitted])
                else:
                    decoded += 1
                    yield buf.copy()
                emitted += 1
        finally:
            self.close()

    def close(self):
        if not self._closed:
            self._lib.fl_close(self._handle)
            self._closed = True

    def __del__(self):
        if not getattr(self, "_closed", True):
            self.close()
