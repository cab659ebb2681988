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

On the card the wrapper launches nothing but the matcher: it hands the
caller's tensors to the C entry as they are (a null pointer for an absent
input), makes one ``torch.empty`` for the outputs and the scratch and slices
it into views. ``launches`` counts calls that launched the kernel and
nothing else; ``launches_by_shape`` counts them by ``(mode, N, M)``.

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
from collections import Counter
from pathlib import Path
from typing import NamedTuple

import torch

BIG = 1e9
launches = 0  # kernel launches made by match_tables (not by the plain twin)
launches_by_shape: Counter = Counter()  # (mode, N, M) -> launches

_REPO = Path(__file__).resolve().parents[3]
_SOURCE = _REPO / "orbslamm_tpu_torch" / "csrc" / "hamming.cu"
_LIBRARY = _REPO / "build" / "kernels" / "libhamming.so"
_lib = None
_tile = None  # (rows per block, columns per tile) of the built kernel
_slots: dict[int, int] = {}  # tile-kernel blocks resident at once, per device index
build_seconds = None  # wall time of this process's nvcc build, if it built
_MAX_INDEX = 1 << 23  # N and M stay below it (the index field of a key)


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
    global _lib, _tile, build_seconds
    if _lib is not None:
        return _lib
    if (not _LIBRARY.exists()
            or _LIBRARY.stat().st_mtime < _SOURCE.stat().st_mtime):
        _LIBRARY.parent.mkdir(parents=True, exist_ok=True)
        tmp = _LIBRARY.with_suffix(f".{os.getpid()}.tmp.so")
        t0 = time.perf_counter()
        subprocess.run(
            # the shared CUDA runtime is the one PyTorch loaded, so the
            # profiler links these launches to the ranges they run in
            [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
             "-cudart", "shared", "-o", str(tmp), str(_SOURCE)],
            check=True,
        )
        os.replace(tmp, _LIBRARY)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(_LIBRARY))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hamming_match_tables.argtypes = (
        [vp, vp, ci, ci] + [vp] * 9 + [cf, cf, ci, ci, ci] + [vp] * 9)
    lib.hamming_match_tables.restype = ci
    for fn in (lib.hamming_rows_per_block, lib.hamming_tile_cols, lib.hamming_blocks_per_sm):
        fn.argtypes = []
        fn.restype = ci
    _tile = (lib.hamming_rows_per_block(), lib.hamming_tile_cols())
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
    if dtype is not None and t.dtype not in dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of {dtype}")


def _validate(desc_a, desc_b, valid_a, valid_b, xy_a, xy_b, radius_b,
              level_a, level_b, lines_a, epi_thr_b, use_window, use_epipolar):
    """Shapes and devices always; on a CUDA tensor also the types the
    kernel reads (float32 scalars, int32 or float32 levels)."""
    dev = desc_a.device
    N, M = desc_a.shape[0], desc_b.shape[0]
    if N < 1 or M < 1:
        raise ValueError(f"empty match problem ({N} x {M})")
    cuda = dev.type == "cuda"
    f32 = (torch.float32,) if cuda else None
    lvl = (torch.int32, torch.float32) if cuda else None
    _check("desc_a", desc_a, (N, 32), (torch.uint8,), dev)
    _check("desc_b", desc_b, (M, 32), (torch.uint8,), dev)
    _check("valid_a", valid_a, (N,), (torch.bool,), dev)
    _check("valid_b", valid_b, (M,), (torch.bool,), dev)
    _check("xy_a", xy_a, (N, 2), f32, dev)
    _check("xy_b", xy_b, (M, 2), f32, dev)
    _check("radius_b", radius_b, (M,), f32, dev)
    _check("level_a", level_a, (N,), lvl, dev)
    _check("level_b", level_b, (M,), lvl, dev)
    _check("lines_a", lines_a, (N, 3), f32, dev)
    _check("epi_thr_b", epi_thr_b, (M,), f32, dev)
    if use_window and (xy_a is None or xy_b is None or radius_b is None):
        raise ValueError("use_window needs xy_a, xy_b and radius_b")
    if use_epipolar and (lines_a is None or xy_b is None or epi_thr_b is None):
        raise ValueError("use_epipolar needs lines_a, xy_b and epi_thr_b")
    return N, M


def _mode(use_window: bool, use_epipolar: bool) -> str:
    if use_window and use_epipolar:
        return "window+epipolar"
    return "window" if use_window else "epipolar" if use_epipolar else "none"


def split_plan(N: int, M: int, slots: int, rows: int, cols: int):
    """(row_tiles, col_tiles, n_split, tiles_per_split): the column tiles
    are split so that the blocks about fill the ``slots`` the card holds at
    once (a few row tiles still fill it), and every split holds at least
    one tile."""
    row_tiles, col_tiles = -(-N // rows), -(-M // cols)
    n_split = max(1, min(col_tiles, -(-slots // row_tiles)))
    per_split = -(-col_tiles // n_split)
    return row_tiles, col_tiles, -(-col_tiles // per_split), per_split


def match_tables(
    desc_a: torch.Tensor,  # [N, 32] uint8
    desc_b: torch.Tensor,  # [M, 32] uint8
    valid_a: torch.Tensor,  # [N] bool
    valid_b: torch.Tensor,  # [M] bool
    xy_a: torch.Tensor | None = None,  # [N, 2] f32
    xy_b: torch.Tensor | None = None,  # [M, 2] f32
    radius_b: torch.Tensor | None = None,  # [M] per-candidate radius
    level_a: torch.Tensor | None = None,  # [N] int32/float32
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
    if N >= _MAX_INDEX or M >= _MAX_INDEX:
        raise ValueError(f"match_tables takes N, M < {_MAX_INDEX}, got {N} x {M}")
    lib = build()
    # views of contiguous tensors as they are (no kernel); a strided input
    # is copied here, and kept alive until the launch is queued
    keep = [None if t is None else t.contiguous() for t in args]
    for name, t in (("desc_a", keep[0]), ("desc_b", keep[1])):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    ptrs = [None if t is None else t.data_ptr() for t in keep]
    slots = _slots.get(dev.index)
    if slots is None:
        with torch.cuda.device(dev):
            slots = max(1, lib.hamming_blocks_per_sm()) * torch.cuda.get_device_properties(
                dev).multi_processor_count
        _slots[dev.index] = slots
    rows, cols = _tile
    row_tiles, col_tiles, n_split, per_split = split_plan(N, M, slots, rows, cols)
    n_pad, m_pad = row_tiles * rows, col_tiles * cols
    # one allocation: column keys, row keys, row seconds (scratch), then
    # the five outputs; every part starts at an even 4-byte offset
    sizes = [row_tiles * m_pad, n_split * n_pad, n_split * n_pad, N, N, N, M, M]
    buf = torch.empty(sum(sizes), dtype=torch.int32, device=dev)
    part_col, part_key, part_sec, rb, rs, ra, cb, ca = torch.split(buf, sizes)
    out = MatchTables(row_best=rb.view(torch.float32), row_second=rs.view(torch.float32),
                      row_arg=ra, col_best=cb.view(torch.float32), col_arg=ca)
    flags = (int(use_window) | int(use_epipolar) << 1
             | int(level_a is not None and level_a.dtype == torch.int32) << 2
             | int(level_b is not None and level_b.dtype == torch.int32) << 3)
    stream = torch.cuda.current_stream(dev).cuda_stream
    call = (ptrs[0], ptrs[1], N, M, ptrs[2], ptrs[3], ptrs[4], ptrs[5], ptrs[6],
            ptrs[7], ptrs[8], ptrs[9], ptrs[10], float(lvl_lo), float(lvl_hi), flags,
            n_split, per_split, part_col.data_ptr(), part_key.data_ptr(),
            part_sec.data_ptr(), rb.data_ptr(), rs.data_ptr(), ra.data_ptr(),
            cb.data_ptr(), ca.data_ptr(), stream)
    if dev.index == torch.cuda.current_device():
        rc = lib.hamming_match_tables(*call)
    else:
        with torch.cuda.device(dev):
            rc = lib.hamming_match_tables(*call)
    if rc != 0:
        raise RuntimeError(f"hamming_match_tables launch failed: cudaError {rc}")
    launches += 1
    launches_by_shape[(_mode(use_window, use_epipolar), N, M)] += 1
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
