"""Build of the port's hand-written CUDA kernels: one ``csrc/*.cu`` file with a
plain C interface into one shared library under ``build/kernels/``, compiled
by nvcc for sm_90a at first use and loaded with ctypes by its wrapper."""

from __future__ import annotations

import os
import shutil
import subprocess
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[3]
SOURCES = REPO / "orbslamm_tpu_torch" / "csrc"
LIBRARIES = REPO / "build" / "kernels"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(cuda_home) / "bin" / "nvcc")


def compile_library(source: Path, library: Path) -> float | None:
    """Compile ``source`` into ``library`` if the library is missing or older
    than the source. Returns the build's wall seconds, or None if the
    library was current. Processes that build at once each write their own
    temporary file and rename it into place."""
    if library.exists() and library.stat().st_mtime >= source.stat().st_mtime:
        return None
    library.parent.mkdir(parents=True, exist_ok=True)
    tmp = library.with_suffix(f".{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    subprocess.run(
        # the shared CUDA runtime is the one PyTorch loaded, so the
        # profiler links these launches to the ranges they run in
        [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-cudart", "shared", "-o", str(tmp), str(source)],
        check=True,
    )
    os.replace(tmp, library)
    return time.perf_counter() - t0
