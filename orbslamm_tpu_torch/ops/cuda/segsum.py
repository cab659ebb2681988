"""Sorted segment sum: the CUDA kernel's wrapper and its plain versions.

``segment_sum(plan, vals)`` returns ``out[s] = sum of vals[e] over the edges e
with ids[e] == s``: the edge-to-node sums of the BA, pose-graph and global-BA
solves (``ops/ba.py``). It is the port of the JAX package's scatter-free
``orbslamm_tpu/ops/ba.py::_make_sorted_segsum``: a solve plans its static
edge list once (``segment_plan``: a stable permutation of the edges by
segment, each segment's start and end, and the kernel's int32 tables, on the
ids' device with no read back to the host) and every sum of the solve reuses
the plan. ``segment_plan_pair(ei, ej, n)`` plans two edge lists as one, and
``segment_sum_pair(plan, a, b)`` sums ``a`` over ``ei`` plus ``b`` over ``ej``
in one call: the pose graph's products.

The device of the values decides the path, never their shape:

* a CUDA tensor launches the hand-written kernel (``csrc/segsum.cu``, built
  for sm_90a with nvcc at first use into ``build/kernels/libsegsum.so`` and
  bound with ctypes): one launch a call, over tiles of ``tile_rows``
  sorted rows, which adds each segment's rows in one order fixed by the plan
  and the width, with no atomics on values: two calls on the same inputs
  give the same bits. A failed build or launch raises; nothing falls back
  to ``index_add_``;
* a CPU tensor takes a plain version: ``segment_sum_ref``, ``index_add_`` in
  edge order (the scatter form, the CPU's numbers since before the kernel),
  or with ``form="sorted"`` ``segment_sum_sorted_ref``, the JAX package's
  sorted form (gather in plan order, a float64 running sum, boundary
  differences); ``segment_sum_pair_ref`` for a pair.

``segment_sum_tiled_ref(plan, vals, tile)`` is the plain version in the
kernel's own order, written with elementwise adds alone: the kernel equals
it bit for bit. Nothing on the solves' path calls it; the tests and
chip_smoke.py do. The kernel's order differs from ``index_add_``'s, so the
two agree to the float32 rounding of a sum taken in another order:
``|a - b| <= 2 (L - 1) 2^-24 sum |v|`` over a segment of L edges.
Ids must lie in [0, n): the plan sends an id outside to a segment of its
own past the last, which no caller sees; ``index_add_`` raises on it.

``launches`` counts calls that launched the kernel, ``kernel_launches`` the
kernel launches they made (one a call), and ``launches_by_width`` the calls
by row width (the floats summed per edge).
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter
from typing import NamedTuple

import torch

from orbslamm_tpu_torch.ops.cuda.nvcc import LIBRARIES, SOURCES, compile_library

FORMS = ("scatter", "sorted")
GROUP_ROWS = 8  # rows a kernel thread adds in order (csrc/segsum.cu kGroup)
CHUNK = 32  # pieces per counted chunk of the kernel's cross-tile tree (kChunk)
MAX_TILE = 256  # rows of a tile at most: 32 groups, one warp's lanes (kMaxTile)
TILE_FLOATS = 8192  # values per tile at most (32 KB)
MAX_WIDTH = 256  # floats per edge the kernel takes (32 rows of a tile in 32 KB)
launches = 0  # segment_sum / segment_sum_pair calls that launched the kernel
kernel_launches = 0  # kernel launches those calls made
launches_by_width: Counter = Counter()  # floats per edge row -> calls

_SOURCE = SOURCES / "segsum.cu"
_LIBRARY = LIBRARIES / "libsegsum.so"
_lib = None
build_seconds = None  # wall time of this process's nvcc build, if it built


class KernelTables(NamedTuple):
    """The kernel's view of a plan, int32, on the plan's device."""

    perm: torch.Tensor  # [E] the rows stably sorted by segment
    sorted_ids: torch.Tensor  # [E] the segment of each sorted row (n for an id outside [0, n))
    bounds: torch.Tensor  # [n + 2] segment s owns sorted rows bounds[s]:bounds[s + 1]
    counters: torch.Tensor | None  # [levels, 2 ceil(E / CHUNK)] zero; on a CUDA plan only
    launch: object  # the bound ctypes function, on a CUDA plan only
    sms: int | None  # the card's count of SMs, on a CUDA plan only


class SegmentPlan(NamedTuple):
    idx: torch.Tensor  # [E] int64, the segment of each edge (the scatter form's index)
    n: int  # number of segments
    perm: torch.Tensor  # [E] int64, the edges stably sorted by segment
    start: torch.Tensor  # [n] int64, segment s owns perm[start[s]:end[s]]
    end: torch.Tensor  # [n] int64
    split: int | None  # a pair plan: edges [0, split) are the first list's
    tables: KernelTables


def build() -> ctypes.CDLL:
    """Compile ``csrc/segsum.cu`` (if the library is missing or older than
    the source) and load it. Called when the first CUDA plan is made."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    seconds = compile_library(_SOURCE, _LIBRARY)
    if seconds is not None:
        build_seconds = seconds
    lib = ctypes.CDLL(str(_LIBRARY))
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.segsum_launch.argtypes = [vp, vp, cl, vp, vp, vp, vp] + [ci] * 6 + [vp, vp, vp]
    lib.segsum_launch.restype = ci
    for name, want in (("segsum_group_rows", GROUP_ROWS), ("segsum_chunk", CHUNK),
                       ("segsum_max_tile", MAX_TILE)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [], ci
        if fn() != want:
            raise RuntimeError(f"{_LIBRARY}: {name}() is {fn()}, the wrapper's {want}")
    _lib = lib
    return lib


def tile_rows(width: int, rows: int = 0, sms: int | None = None) -> int:
    """Sorted rows per kernel tile at ``width`` floats an edge: about
    TILE_FLOATS values, at least CHUNK and at most MAX_TILE; with the card's
    count of SMs, ``rows`` edges are spread over the SMs in tiles of a
    multiple of 32 rows (a small call, such as the pose graph's, runs on many
    SMs at once instead of one)."""
    tile = min(MAX_TILE, max(CHUNK, TILE_FLOATS // max(int(width), 1)))
    if sms:
        per_sm = -(-int(rows) // sms)
        tile = min(tile, max(CHUNK, -(-per_sm // 32) * 32))
    return tile


def _count_levels(rows: int) -> int:
    """Levels of the kernel's chunk tree over at most ceil(rows / CHUNK) pieces."""
    pieces, levels = -(-rows // CHUNK), 1
    while CHUNK ** levels < pieces:
        levels += 1
    return levels


def segment_plan(ids: torch.Tensor, n_seg: int, split: int | None = None) -> SegmentPlan:
    """The plan of the edge list ``ids`` [E] over ``n_seg`` segments, on
    ``ids``' device: a stable sort and a search, with no read back to the
    host. A CUDA plan builds the kernel, binds it and zeroes its counters."""
    idx = ids.long()
    n = int(n_seg)
    dev = idx.device
    key = torch.where((idx >= 0) & (idx < n), idx, n)
    sorted_ids, perm = torch.sort(key, stable=True)
    bounds = torch.searchsorted(sorted_ids, torch.arange(n + 2, dtype=torch.int64, device=dev))
    counters = launch = sms = None
    if dev.type == "cuda":
        launch = build().segsum_launch
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        rows = idx.shape[0]
        counters = torch.zeros((_count_levels(rows), 2 * -(-rows // CHUNK)), dtype=torch.int32,
                               device=dev)
    i32 = torch.int32
    tables = KernelTables(perm=perm.to(i32), sorted_ids=sorted_ids.to(i32),
                          bounds=bounds.to(i32), counters=counters, launch=launch, sms=sms)
    return SegmentPlan(idx=idx, n=n, perm=perm, start=bounds[:n], end=bounds[1:n + 1],
                       split=split, tables=tables)


def segment_plan_pair(ids_a: torch.Tensor, ids_b: torch.Tensor, n_seg: int) -> SegmentPlan:
    """One plan over the rows ``[edges of ids_a; edges of ids_b]``, for
    ``segment_sum_pair``."""
    return segment_plan(torch.cat([ids_a.long(), ids_b.long()]), n_seg,
                        split=int(ids_a.shape[0]))


def _check(plan: SegmentPlan, vals: torch.Tensor, rows: int, what: str) -> None:
    if vals.shape[0] != rows:
        raise ValueError(f"{what} has {vals.shape[0]} rows for a plan of {rows} edges")
    if plan.idx.device != vals.device:
        raise ValueError(f"the plan is on {plan.idx.device}, {what} on {vals.device}")
    if vals.device.type not in ("cpu", "cuda"):
        raise ValueError(f"segment_sum runs on cpu or cuda, not {vals.device}")


def segment_sum(plan: SegmentPlan, vals: torch.Tensor, form: str = "scatter") -> torch.Tensor:
    """Segment sum of ``vals`` [E, ...] into [n, ...]. A CUDA tensor launches
    the kernel whatever ``form``; a CPU tensor takes ``segment_sum_ref``
    (``form="scatter"``) or ``segment_sum_sorted_ref`` (``"sorted"``); any
    other device or form raises."""
    if form not in FORMS:
        raise ValueError(f"segment sum form {form!r}, expected one of {FORMS}")
    if plan.split is not None:
        raise ValueError("a pair plan is summed by segment_sum_pair")
    _check(plan, vals, plan.idx.shape[0], "vals")
    if vals.device.type == "cpu":
        return segment_sum_ref(plan, vals) if form == "scatter" \
            else segment_sum_sorted_ref(plan, vals)
    return _launch(plan, vals, vals)


def segment_sum_pair(plan: SegmentPlan, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` [E_a, ...] summed over the pair plan's first edge list plus ``b``
    [E_b, ...] over its second, into [n, ...]: one launch on the card
    (sorted row k reads ``a[k]`` for k < E_a, else ``b[k - E_a]``), on the
    CPU ``segment_sum_pair_ref``."""
    if plan.split is None:
        raise ValueError("segment_sum_pair takes a plan of segment_plan_pair")
    _check(plan, a, plan.split, "a")
    _check(plan, b, plan.idx.shape[0] - plan.split, "b")
    if a.shape[1:] != b.shape[1:] or a.dtype != b.dtype:
        raise ValueError(f"a {a.dtype} {tuple(a.shape)} and b {b.dtype} {tuple(b.shape)} "
                         "differ past the edge axis")
    if a.device.type == "cpu":
        return segment_sum_pair_ref(plan, a, b)
    return _launch(plan, a, b)


def _copy_floats(width: int, *ptrs: int) -> int:
    """Floats per asynchronous copy: 4 (16 bytes) or 2 where the width and
    every base pointer allow, else 1. Raises on a pointer that is not
    4-byte aligned."""
    if any(p % 4 for p in ptrs):
        raise ValueError("segment_sum takes 4-byte aligned float32 values")
    for v in (4, 2):
        if width % v == 0 and all(p % (4 * v) == 0 for p in ptrs):
            return v
    return 1


def _launch(plan: SegmentPlan, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    global launches, kernel_launches
    dev = a.device
    for x in (a, b):
        if x.dtype != torch.float32:
            raise ValueError(f"segment_sum sums float32 on the card, not {x.dtype}")
        if not x.is_contiguous():
            raise ValueError("segment_sum takes contiguous values on the card")
    rows = plan.idx.shape[0]
    if rows >= 2 ** 31 or plan.n >= 2 ** 31 - 1:
        raise ValueError("segment_sum takes fewer than 2^31 edges and segments")
    width = math.prod(a.shape[1:])
    out = torch.empty((plan.n + 1,) + tuple(a.shape[1:]), dtype=torch.float32, device=dev)
    if plan.n == 0 or width == 0:
        return out[:plan.n]
    if width > MAX_WIDTH:
        raise ValueError(f"segment_sum takes at most {MAX_WIDTH} floats an edge on the card")
    t = plan.tables
    tile = tile_rows(width, rows, t.sms)
    part = torch.empty((2 * -(-rows // tile), width), dtype=torch.float32, device=dev)
    split = rows if plan.split is None else plan.split
    call = (a.data_ptr(), b.data_ptr(), split, t.perm.data_ptr(), t.sorted_ids.data_ptr(),
            t.bounds.data_ptr(), t.counters.data_ptr(), t.counters.shape[1], rows, plan.n + 1,
            width, tile, _copy_floats(width, a.data_ptr(), b.data_ptr()), part.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if dev.index is None or dev.index == torch.cuda.current_device():
        rc = t.launch(*call)
    else:
        with torch.cuda.device(dev):
            rc = t.launch(*call)
    if rc != 0:
        raise RuntimeError(f"segsum_launch failed: cudaError {rc}")
    launches += 1
    kernel_launches += 1
    launches_by_width[width] += 1
    return out[:plan.n]


def segment_sum_ref(plan: SegmentPlan, vals: torch.Tensor) -> torch.Tensor:
    """Plain version, the scatter form: ``index_add_`` in edge order."""
    out = torch.zeros((plan.n,) + tuple(vals.shape[1:]), dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, plan.idx, vals)


def segment_sum_pair_ref(plan: SegmentPlan, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of a pair: ``index_add_`` of each list in edge order,
    then one add."""
    shape = (plan.n,) + tuple(a.shape[1:])
    ia, ib = plan.idx[:plan.split], plan.idx[plan.split:]
    return (torch.zeros(shape, dtype=a.dtype, device=a.device).index_add_(0, ia, a)
            + torch.zeros(shape, dtype=b.dtype, device=b.device).index_add_(0, ib, b))


def segment_sum_sorted_ref(plan: SegmentPlan, vals: torch.Tensor) -> torch.Tensor:
    """Plain version, the JAX package's sorted form: the values gathered in
    plan order, a float64 running sum from zero, and each segment's sum as
    the difference of the running sum at its end and at its start."""
    v = vals[plan.perm].to(torch.float64)
    cz = torch.cat([torch.zeros((1,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device),
                    torch.cumsum(v, 0)])
    return (cz[plan.end] - cz[plan.start]).to(vals.dtype)


def tile_pieces(plan: SegmentPlan, tile: int):
    """The kernel's cut of the sorted rows: the runs of one segment within
    one tile of ``tile`` rows. Returns (segment, tile, first row, end row),
    int64 [pieces] each, in sorted order."""
    key = plan.tables.sorted_ids.long()
    k = torch.arange(key.shape[0], device=key.device)
    lo = _run_starts(key, k // tile)
    hi = torch.cat([lo[1:], lo.new_tensor([key.shape[0]])])[:lo.shape[0]]
    return key[lo], lo // tile, lo, hi


def _run_starts(*keys: torch.Tensor) -> torch.Tensor:
    """Positions where any of the equal-length ``keys`` changes (0 first)."""
    change = torch.zeros(keys[0].shape[0], dtype=torch.bool, device=keys[0].device)
    change[:1] = True
    for key in keys:
        change[1:] |= key[1:] != key[:-1]
    return torch.nonzero(change).flatten()


def _tree(x: torch.Tensor, run_start: torch.Tensor) -> torch.Tensor:
    """The kernel's pairwise tree within each run of consecutive rows of
    ``x`` [U, W] (runs begin at ``run_start``): item q of a run takes item
    q + d where q % 2d == 0, for d = 1, 2, 4, ...; returns each run's sum."""
    U = x.shape[0]
    ends = torch.cat([run_start[1:], run_start.new_tensor([U])])
    length = ends - run_start
    run = torch.repeat_interleave(torch.arange(run_start.shape[0], device=x.device), length)
    q = torch.arange(U, device=x.device) - run_start[run]
    nq = length[run]
    x = x.clone()
    d = 1
    while U and d < int(length.max()):
        take = torch.nonzero((q % (2 * d) == 0) & (q + d < nq)).flatten()
        x[take] = x[take] + x[take + d]
        d *= 2
    return x[run_start]


def segment_sum_tiled_ref(plan: SegmentPlan, vals: torch.Tensor,
                          tile: int | None = None) -> torch.Tensor:
    """Plain version in the kernel's order, with ``tile`` sorted rows a tile
    (by default the kernel's, ``tile_rows(width, E, plan.tables.sms)``),
    elementwise adds alone: within a tile, each tile-aligned group of
    GROUP_ROWS rows adds its rows of one segment left to right; a segment's groups in the tile add in the
    pairwise tree; its tiles' sums add in the same tree; an empty segment
    is zero."""
    return _tiled(plan, _rows(vals), tile).reshape((plan.n,) + tuple(vals.shape[1:]))


def segment_sum_pair_tiled_ref(plan: SegmentPlan, a: torch.Tensor, b: torch.Tensor,
                               tile: int | None = None) -> torch.Tensor:
    """``segment_sum_tiled_ref`` of a pair plan: the kernel's order over the
    rows ``[a; b]``."""
    return _tiled(plan, torch.cat([_rows(a), _rows(b)]), tile).reshape((plan.n,) + tuple(a.shape[1:]))


def _rows(vals: torch.Tensor) -> torch.Tensor:
    return vals.reshape(vals.shape[0], math.prod(vals.shape[1:]))


def _tiled(plan: SegmentPlan, vals: torch.Tensor, tile: int | None) -> torch.Tensor:
    rows, width = vals.shape
    if tile is None:
        tile = tile_rows(width, rows, plan.tables.sms)
    out = torch.zeros((plan.n + 1, width), dtype=vals.dtype, device=vals.device)
    if rows == 0:
        return out[:plan.n]
    v = vals[plan.perm]
    key = plan.tables.sorted_ids.long()
    k = torch.arange(rows, device=v.device)
    t = k // tile
    # one group's rows of one segment, added left to right
    sub = _run_starts(key, t, (k % tile) // GROUP_ROWS)
    length = torch.cat([sub[1:], sub.new_tensor([rows])]) - sub
    acc = v[sub]
    for j in range(1, GROUP_ROWS):
        live = torch.nonzero(length > j).flatten()
        acc[live] = acc[live] + v[sub[live] + j]
    # a segment's groups within a tile, then its tiles
    pieces = _run_starts(key[sub], t[sub])
    acc = _tree(acc, pieces)
    segs = _run_starts(key[sub][pieces])
    acc = _tree(acc, segs)
    out[key[sub][pieces][segs]] = acc
    return out[:plan.n]
