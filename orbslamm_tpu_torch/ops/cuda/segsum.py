"""Sorted segment sum: the CUDA kernel's wrapper and its two plain versions.

``segment_sum(plan, vals)`` returns ``out[s] = sum of vals[e] over the edges e
with ids[e] == s``: the edge-to-node sums of the BA, pose-graph and global-BA
solves (``ops/ba.py``). It is the port of the JAX package's scatter-free
``orbslamm_tpu/ops/ba.py::_make_sorted_segsum``: a solve plans its static
edge list once (``segment_plan``: a stable permutation of the edges by
segment and each segment's start and end, on the ids' device, with no read
back to the host) and every sum of the solve reuses the plan.

The device of the values decides the path, never their shape:

* a CUDA tensor launches the hand-written kernel (``csrc/segsum.cu``, built
  for sm_90a with nvcc at first use into ``build/kernels/libsegsum.so`` and
  bound with ctypes), which adds each segment's rows in one order fixed by
  the plan, with no atomics: two calls on the same inputs give the same
  bits. A failed build or launch raises; nothing falls back to
  ``index_add_``;
* a CPU tensor takes a plain version: ``segment_sum_ref``, ``index_add_`` in
  edge order (the scatter form, and the kernel's test oracle), or with
  ``form="sorted"`` ``segment_sum_sorted_ref``, the JAX package's sorted
  form (gather in plan order, a float64 running sum, boundary differences).

The kernel's order differs from both, so the kernel and a plain version
agree to the float32 rounding of a sum taken in another order:
``|a - b| <= 2 (L - 1) 2^-24 sum |v|`` over a segment of L edges.
Ids must lie in [0, n): the kernel skips an edge outside, ``index_add_``
raises on it.

``launches`` counts calls that launched the kernel and nothing else;
``launches_by_width`` counts them by row width (the floats summed per edge).
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter
from typing import NamedTuple

import torch

from orbslamm_tpu_torch.ops.cuda.nvcc import LIBRARIES, SOURCES, compile_library

FORMS = ("scatter", "sorted")
CHUNK_ROWS = 32  # edges per chunk of the kernel's first pass (csrc/segsum.cu)
launches = 0  # kernel launches made by segment_sum (not by the plain versions)
launches_by_width: Counter = Counter()  # floats per edge row -> launches

_SOURCE = SOURCES / "segsum.cu"
_LIBRARY = LIBRARIES / "libsegsum.so"
_lib = None
build_seconds = None  # wall time of this process's nvcc build, if it built


class KernelTables(NamedTuple):
    """The kernel's view of a plan, int32: segment s's run of ``perm`` cut
    into chunks of at most CHUNK_ROWS edges."""

    perm: torch.Tensor  # [E] the edges stably sorted by segment
    chunk_lo: torch.Tensor  # [n + ceil(E / CHUNK_ROWS)] chunk c owns
    chunk_hi: torch.Tensor  # perm[chunk_lo[c]:chunk_hi[c]]; empty past the last
    chunk_start: torch.Tensor  # [n + 1] segment s owns chunks chunk_start[s]:[s + 1]


class SegmentPlan(NamedTuple):
    idx: torch.Tensor  # [E] int64, the segment of each edge (the scatter form's index)
    n: int  # number of segments
    perm: torch.Tensor  # [E] int64, the edges stably sorted by segment
    start: torch.Tensor  # [n] int64, segment s owns perm[start[s]:end[s]]
    end: torch.Tensor  # [n] int64
    tables: KernelTables | None  # the kernel's tables, on a CUDA plan only


def build() -> ctypes.CDLL:
    """Compile ``csrc/segsum.cu`` (if the library is missing or older than
    the source) and load it. Called at the first launch."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    seconds = compile_library(_SOURCE, _LIBRARY)
    if seconds is not None:
        build_seconds = seconds
    lib = ctypes.CDLL(str(_LIBRARY))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.segsum_launch.argtypes = [vp] * 5 + [ci, ci, ci, vp, vp, vp]
    lib.segsum_launch.restype = ci
    lib.segsum_chunk_rows.argtypes = []
    lib.segsum_chunk_rows.restype = ci
    if lib.segsum_chunk_rows() != CHUNK_ROWS:
        raise RuntimeError(f"{_LIBRARY} cuts chunks of {lib.segsum_chunk_rows()} rows, "
                           f"the plan {CHUNK_ROWS}")
    _lib = lib
    return lib


def segment_plan(ids: torch.Tensor, n_seg: int) -> SegmentPlan:
    """The plan of the edge list ``ids`` [E] over ``n_seg`` segments, on
    ``ids``' device: a stable sort and two searches (and the kernel's chunk
    tables on a CUDA device), with no read back to the host."""
    idx = ids.long()
    n = int(n_seg)
    dev = idx.device
    sorted_ids, perm = torch.sort(idx, stable=True)
    bounds = torch.searchsorted(sorted_ids, torch.arange(n + 1, dtype=torch.int64, device=dev))
    start, end = bounds[:-1], bounds[1:]
    tables = kernel_tables(perm, start, end) if dev.type == "cuda" else None
    return SegmentPlan(idx=idx, n=n, perm=perm, start=start, end=end, tables=tables)


def kernel_tables(perm: torch.Tensor, start: torch.Tensor, end: torch.Tensor) -> KernelTables:
    """Each segment's run [start, end) of ``perm`` in chunks of CHUNK_ROWS
    edges, on the plan's device. There are at most n + ceil(E / CHUNK_ROWS)
    chunks, a count known from the shapes alone; the tables hold that many
    and the ones past the last are empty."""
    dev = perm.device
    n, E = start.shape[0], perm.shape[0]
    per_seg = (end - start + CHUNK_ROWS - 1) // CHUNK_ROWS
    chunk_start = torch.cat([per_seg.new_zeros(1), torch.cumsum(per_seg, 0)])
    c = torch.arange(n + -(-E // CHUNK_ROWS), dtype=torch.int64, device=dev)
    if n:
        # the segment owning chunk c: the first s with chunk_start[s + 1] > c
        seg = torch.clamp_max(torch.searchsorted(chunk_start[1:], c, right=True), n - 1)
        lo = start[seg] + (c - chunk_start[seg]) * CHUNK_ROWS
        hi = torch.minimum(lo + CHUNK_ROWS, end[seg])
        live = c < chunk_start[-1]
        lo, hi = torch.where(live, lo, 0), torch.where(live, hi, 0)
    else:
        lo = hi = torch.zeros_like(c)
    i32 = torch.int32
    return KernelTables(perm=perm.to(i32), chunk_lo=lo.to(i32), chunk_hi=hi.to(i32),
                        chunk_start=chunk_start.to(i32))


def segment_sum(plan: SegmentPlan, vals: torch.Tensor, form: str = "scatter") -> torch.Tensor:
    """Segment sum of ``vals`` [E, ...] into [n, ...]. A CUDA tensor launches
    the kernel whatever ``form``; a CPU tensor takes ``segment_sum_ref``
    (``form="scatter"``) or ``segment_sum_sorted_ref`` (``"sorted"``); any
    other device or form raises."""
    global launches
    if form not in FORMS:
        raise ValueError(f"segment sum form {form!r}, expected one of {FORMS}")
    E = plan.idx.shape[0]
    if vals.shape[0] != E:
        raise ValueError(f"vals has {vals.shape[0]} rows for a plan of {E} edges")
    dev = vals.device
    if plan.idx.device != dev:
        raise ValueError(f"the plan is on {plan.idx.device}, vals on {dev}")
    if dev.type == "cpu":
        return segment_sum_ref(plan, vals) if form == "scatter" \
            else segment_sum_sorted_ref(plan, vals)
    if dev.type != "cuda":
        raise ValueError(f"segment_sum runs on cpu or cuda, not {dev}")
    if vals.dtype != torch.float32:
        raise ValueError(f"segment_sum sums float32 on the card, not {vals.dtype}")
    width = math.prod(vals.shape[1:])
    out = torch.empty((plan.n,) + tuple(vals.shape[1:]), dtype=torch.float32, device=dev)
    if plan.n == 0 or width == 0:
        return out
    if E >= 2 ** 31 or plan.n >= 2 ** 31:
        raise ValueError("segment_sum takes fewer than 2^31 edges and segments")
    lib = build()
    t = plan.tables
    v = vals.contiguous()  # kept alive until the launch is queued
    n_chunks = t.chunk_lo.shape[0]
    part = torch.empty((n_chunks, width), dtype=torch.float32, device=dev)
    call = (v.data_ptr(), t.perm.data_ptr(), t.chunk_lo.data_ptr(), t.chunk_hi.data_ptr(),
            t.chunk_start.data_ptr(), n_chunks, plan.n, width, part.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if dev.index is None or dev.index == torch.cuda.current_device():
        rc = lib.segsum_launch(*call)
    else:
        with torch.cuda.device(dev):
            rc = lib.segsum_launch(*call)
    if rc != 0:
        raise RuntimeError(f"segsum_launch failed: cudaError {rc}")
    launches += 1
    launches_by_width[width] += 1
    return out


def segment_sum_ref(plan: SegmentPlan, vals: torch.Tensor) -> torch.Tensor:
    """Plain version, the scatter form: ``index_add_`` in edge order."""
    out = torch.zeros((plan.n,) + tuple(vals.shape[1:]), dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, plan.idx, vals)


def segment_sum_sorted_ref(plan: SegmentPlan, vals: torch.Tensor) -> torch.Tensor:
    """Plain version, the JAX package's sorted form: the values gathered in
    plan order, a float64 running sum from zero, and each segment's sum as
    the difference of the running sum at its end and at its start."""
    v = vals[plan.perm].to(torch.float64)
    cz = torch.cat([torch.zeros((1,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device),
                    torch.cumsum(v, 0)])
    return (cz[plan.end] - cz[plan.start]).to(vals.dtype)
