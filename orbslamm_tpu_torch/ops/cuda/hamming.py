"""Fused masked Hamming matcher: the CUDA kernel's wrapper and its plain twin.

``match_tables`` has the contract of the Pallas TPU kernel
``orbslamm_tpu/ops/pallas/hamming.py::match_tables``: per-row best,
second-best and argmin and per-column best and argmin of the masked
256-bit Hamming distance, without materialising [N, M] on the card.

The device of the inputs decides the path, never their shape: a CUDA tensor
launches the hand-written kernel (``csrc/hamming.cu``, built for sm_90a with
nvcc at first use into ``build/kernels/libhamming.so`` and bound with
ctypes) or raises; a CPU tensor goes to ``match_tables_ref``, the plain torch
version of the same contract, which is also the kernel's test oracle.
``launches`` counts kernel launches and nothing else.

Tie rules (both paths): the row argmin is the lowest column, the column
argmin the earliest row, and second-best is the minimum over the columns
other than the argmin (a duplicate descriptor gives second == best). A
masked entry never competes: a row or column without a live entry reports
best = second = BIG (> 256) and argmin 0.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

BIG = 1e9
launches = 0  # kernel launches made by match_tables (not by the plain twin)

_REPO = Path(__file__).resolve().parents[3]
_SOURCE = _REPO / "orbslamm_tpu_torch" / "csrc" / "hamming.cu"
_LIBRARY = _REPO / "build" / "kernels" / "libhamming.so"
_lib = None
build_seconds = None  # wall time of this process's nvcc build, if it built


class MatchTables(NamedTuple):
    row_best: torch.Tensor  # [N] f32 — best masked distance per A row
    row_second: torch.Tensor  # [N] f32 — second-best (different column)
    row_arg: torch.Tensor  # [N] i32 — argmin column per A row
    col_best: torch.Tensor  # [M] f32 — best masked distance per B column
    col_arg: torch.Tensor  # [M] i32 — argmin row per B column


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(cuda_home) / "bin" / "nvcc")


def build() -> ctypes.CDLL:
    """Compile ``csrc/hamming.cu`` (if the library is missing or older than
    the source) and load it. Called at the first launch."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    if (not _LIBRARY.exists()
            or _LIBRARY.stat().st_mtime < _SOURCE.stat().st_mtime):
        _LIBRARY.parent.mkdir(parents=True, exist_ok=True)
        tmp = _LIBRARY.with_suffix(f".{os.getpid()}.tmp.so")
        t0 = time.perf_counter()
        subprocess.run(
            [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
             "-o", str(tmp), str(_SOURCE)],
            check=True,
        )
        os.replace(tmp, _LIBRARY)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(_LIBRARY))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hamming_match_tables.argtypes = [
        vp, vp, ci, vp, vp, ci, cf, cf, ci, ci, ci,
        vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
    ]
    lib.hamming_match_tables.restype = ci
    lib.hamming_rows_per_block.argtypes = []
    lib.hamming_rows_per_block.restype = ci
    lib.hamming_tile_cols.argtypes = []
    lib.hamming_tile_cols.restype = ci
    _lib = lib
    return lib


def _column(x, n, device, col=None):
    """Per-row/column scalar as f32 [n] (zeros where absent)."""
    if x is None:
        return torch.zeros(n, dtype=torch.float32, device=device)
    x = x if col is None else x[:, col]
    return x.to(torch.float32)


def _check(name, t, shape, dtype, device):
    if t is None:
        return
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")


def _validate(desc_a, desc_b, valid_a, valid_b, xy_a, xy_b, radius_b,
              level_a, level_b, lines_a, epi_thr_b, use_window, use_epipolar):
    dev = desc_a.device
    N, M = desc_a.shape[0], desc_b.shape[0]
    if N < 1 or M < 1:
        raise ValueError(f"empty match problem ({N} x {M})")
    _check("desc_a", desc_a, (N, 32), torch.uint8, dev)
    _check("desc_b", desc_b, (M, 32), torch.uint8, dev)
    _check("valid_a", valid_a, (N,), torch.bool, dev)
    _check("valid_b", valid_b, (M,), torch.bool, dev)
    _check("xy_a", xy_a, (N, 2), None, dev)
    _check("xy_b", xy_b, (M, 2), None, dev)
    _check("radius_b", radius_b, (M,), None, dev)
    _check("level_a", level_a, (N,), None, dev)
    _check("level_b", level_b, (M,), None, dev)
    _check("lines_a", lines_a, (N, 3), None, dev)
    _check("epi_thr_b", epi_thr_b, (M,), None, dev)
    if use_window and (xy_a is None or xy_b is None or radius_b is None):
        raise ValueError("use_window needs xy_a, xy_b and radius_b")
    if use_epipolar and (lines_a is None or xy_b is None or epi_thr_b is None):
        raise ValueError("use_epipolar needs lines_a, xy_b and epi_thr_b")
    return N, M


def match_tables(
    desc_a: torch.Tensor,  # [N, 32] uint8
    desc_b: torch.Tensor,  # [M, 32] uint8
    valid_a: torch.Tensor,  # [N] bool
    valid_b: torch.Tensor,  # [M] bool
    xy_a: torch.Tensor | None = None,  # [N, 2] f32
    xy_b: torch.Tensor | None = None,  # [M, 2] f32
    radius_b: torch.Tensor | None = None,  # [M] per-candidate radius
    level_a: torch.Tensor | None = None,  # [N] int/float
    level_b: torch.Tensor | None = None,  # [M]
    lines_a: torch.Tensor | None = None,  # [N, 3] epipolar lines in B's image
    epi_thr_b: torch.Tensor | None = None,  # [M] threshold per column
    lvl_lo: float = -1e9,
    lvl_hi: float = 1e9,
    use_window: bool = False,
    use_epipolar: bool = False,
) -> MatchTables:
    """Fused masked match tables. CUDA tensors launch the kernel, CPU
    tensors take ``match_tables_ref``; any other device raises."""
    global launches
    args = (desc_a, desc_b, valid_a, valid_b, xy_a, xy_b, radius_b, level_a,
            level_b, lines_a, epi_thr_b)
    N, M = _validate(*args, use_window, use_epipolar)
    dev = desc_a.device
    if dev.type == "cpu":
        return match_tables_ref(*args, lvl_lo=lvl_lo, lvl_hi=lvl_hi,
                                use_window=use_window,
                                use_epipolar=use_epipolar)
    if dev.type != "cuda":
        raise ValueError(f"match_tables runs on cpu or cuda, not {dev}")
    lib = build()
    desc_a = desc_a.contiguous()
    desc_b = desc_b.contiguous()
    for name, t in (("desc_a", desc_a), ("desc_b", desc_b)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    f32 = torch.float32
    rows = torch.stack([
        _column(xy_a, N, dev, 0), _column(xy_a, N, dev, 1),
        _column(level_a, N, dev),
        _column(lines_a, N, dev, 0), _column(lines_a, N, dev, 1),
        _column(lines_a, N, dev, 2),
        valid_a.to(f32), torch.zeros(N, dtype=f32, device=dev),
    ], dim=1).contiguous()
    cols = torch.stack([
        _column(xy_b, M, dev, 0), _column(xy_b, M, dev, 1),
        _column(level_b, M, dev), _column(radius_b, M, dev),
        _column(epi_thr_b, M, dev), valid_b.to(f32),
        torch.zeros(M, dtype=f32, device=dev),
        torch.zeros(M, dtype=f32, device=dev),
    ], dim=1).contiguous()
    # split the columns across blocks so that even a few row blocks fill
    # every SM twice over
    row_blocks = -(-N // lib.hamming_rows_per_block())
    col_tiles = -(-M // lib.hamming_tile_cols())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split = max(1, min(col_tiles, -(-2 * sms // row_blocks)))
    part_best = torch.empty((n_split, N), dtype=f32, device=dev)
    part_second = torch.empty((n_split, N), dtype=f32, device=dev)
    part_arg = torch.empty((n_split, N), dtype=torch.int32, device=dev)
    col_key = torch.empty((M,), dtype=torch.int64, device=dev)
    out = MatchTables(
        row_best=torch.empty((N,), dtype=f32, device=dev),
        row_second=torch.empty((N,), dtype=f32, device=dev),
        row_arg=torch.empty((N,), dtype=torch.int32, device=dev),
        col_best=torch.empty((M,), dtype=f32, device=dev),
        col_arg=torch.empty((M,), dtype=torch.int32, device=dev),
    )
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.hamming_match_tables(
        desc_a.data_ptr(), rows.data_ptr(), N, desc_b.data_ptr(),
        cols.data_ptr(), M, float(lvl_lo), float(lvl_hi), int(use_window),
        int(use_epipolar), n_split, part_best.data_ptr(),
        part_second.data_ptr(), part_arg.data_ptr(), col_key.data_ptr(),
        out.row_best.data_ptr(), out.row_second.data_ptr(),
        out.row_arg.data_ptr(), out.col_best.data_ptr(),
        out.col_arg.data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(f"hamming_match_tables launch failed: cudaError {rc}")
    launches += 1
    return out


def match_tables_ref(
    desc_a, desc_b, valid_a, valid_b, xy_a=None, xy_b=None, radius_b=None,
    level_a=None, level_b=None, lines_a=None, epi_thr_b=None,
    lvl_lo: float = -1e9, lvl_hi: float = 1e9, use_window: bool = False,
    use_epipolar: bool = False,
) -> MatchTables:
    """Plain torch version of ``match_tables``: builds the dense masked
    [N, M] distance matrix and reduces it with the same tie rules."""
    from orbslamm_tpu_torch.ops.matching import hamming_matrix

    N, M = desc_a.shape[0], desc_b.shape[0]
    dev = desc_a.device
    D = hamming_matrix(desc_a, desc_b)
    live = valid_a[:, None] & valid_b[None, :]
    if use_window:
        dx = (xy_a[:, 0:1].float() - xy_b[None, :, 0].float()).abs()
        dy = (xy_a[:, 1:2].float() - xy_b[None, :, 1].float()).abs()
        live &= torch.maximum(dx, dy) <= radius_b.float()[None, :]
    if use_epipolar:
        lx, ly, lz = (lines_a[:, i:i + 1].float() for i in range(3))
        num = lx * xy_b[None, :, 0].float() + ly * xy_b[None, :, 1].float() + lz
        den = torch.clamp_min(lx * lx + ly * ly, 1e-12)
        live &= num * num <= epi_thr_b.float()[None, :] * den
    la = _column(level_a, N, dev)
    lb = _column(level_b, M, dev)
    dl = lb[None, :] - la[:, None]
    live &= (dl >= lvl_lo) & (dl <= lvl_hi)
    D = torch.where(live, D, torch.full_like(D, BIG))
    row_arg = torch.argmin(D, dim=1)
    row_best = D.gather(1, row_arg[:, None])[:, 0]
    D2 = D.scatter(1, row_arg[:, None], BIG)
    row_second = D2.min(dim=1).values
    col_arg = torch.argmin(D, dim=0)
    col_best = D.gather(0, col_arg[None, :])[0]
    return MatchTables(
        row_best=row_best,
        row_second=row_second,
        row_arg=row_arg.to(torch.int32),
        col_best=col_best,
        col_arg=col_arg.to(torch.int32),
    )
