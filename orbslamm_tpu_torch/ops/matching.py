"""Hamming descriptor matching (port of orbslamm_tpu/ops/matching.py).

The dense primitive is the same: 256-bit Hamming distance as
    d(a, b) = pop(a) + pop(b) - 2 * <bits(a), bits(b)>
one [N, 256] x [256, M] float32 product, exact because every partial sum is
a small integer. ``match`` (the init matcher) stays on that dense product.

``match_windowed`` and ``match_epipolar`` — the tracking, fuse and
triangulation matchers — always go through ``ops/cuda/hamming.match_tables``:
on a CUDA tensor that is the hand-written kernel, on a CPU tensor its plain
twin. The JAX package's gate on N % 256 / M % 128 and the TPU backend is a
TPU tiling condition; the CUDA kernel masks its own ragged edge, so the
device alone decides the path here.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from orbslamm_tpu_torch.ops.cuda import hamming as ph
from orbslamm_tpu_torch.utils.trace import stage

BIG = 1e9


class Matches(NamedTuple):
    idx: torch.Tensor  # [N] int32 — index into B for each A feature (undefined where ~ok)
    dist: torch.Tensor  # [N] float32 — best Hamming distance
    ok: torch.Tensor  # [N] bool


def unpack_bits(desc_u8: torch.Tensor) -> torch.Tensor:
    """[..., 32] uint8 -> [..., 256] float32 in {0, 1}, little-endian bit
    order within each byte (numpy's ``unpackbits(bitorder="little")``)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=desc_u8.device)
    bits = (desc_u8[..., None] >> shifts) & 1
    return bits.reshape(*desc_u8.shape[:-1], desc_u8.shape[-1] * 8).to(torch.float32)


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """[N, 32] x [M, 32] uint8 -> [N, M] float32 Hamming distances (0..256)."""
    A = unpack_bits(desc_a)
    B = unpack_bits(desc_b)
    inner = A @ B.T
    pa = A.sum(-1, keepdim=True)
    pb = B.sum(-1, keepdim=True)
    return pa + pb.T - 2.0 * inner


def window_mask(xy_a, xy_b, radius) -> torch.Tensor:
    """[N,2] x [M,2] -> [N,M] bool — Chebyshev window; radius scalar or per
    A row [N]."""
    d = (xy_a[:, None, :] - xy_b[None, :, :]).abs()
    r = torch.as_tensor(radius, dtype=torch.float32, device=xy_a.device)
    if r.ndim == 1:
        r = r[:, None]
    return d.amax(-1) <= r


def window_mask_b(xy_a, xy_b, radius_b) -> torch.Tensor:
    """[N,2] x [M,2] -> [N,M] bool — Chebyshev window with PER-COLUMN radii."""
    d = (xy_a[:, None, :] - xy_b[None, :, :]).abs()
    r = torch.as_tensor(radius_b, dtype=torch.float32, device=xy_a.device)
    return d.amax(-1) <= r[None, :]


def level_mask(lvl_a, lvl_b, lo=-1, hi=1) -> torch.Tensor:
    """Octave band check (reference: kp.octave in [pred-1, pred+1])."""
    d = lvl_b[None, :] - lvl_a[:, None]
    return (d >= lo) & (d <= hi)


def epipolar_mask(F12, xy1, xy2, level2, scale: float) -> torch.Tensor:
    """Point-to-epipolar-line band (dsqr < 3.84 * sigma2(octave))."""
    ones = torch.ones((xy1.shape[0], 1), dtype=xy1.dtype, device=xy1.device)
    l = torch.cat([xy1, ones], dim=1) @ F12.T
    num = l[:, None, 0] * xy2[None, :, 0] + l[:, None, 1] * xy2[None, :, 1] + l[:, None, 2]
    den = l[:, 0:1] ** 2 + l[:, 1:2] ** 2
    dsqr = num * num / torch.clamp_min(den, 1e-12)
    sigma2 = (scale ** level2.to(torch.float32)) ** 2
    return dsqr < 3.84 * sigma2[None, :]


def _finish(valid_a, idx, best, second, max_dist, ratio, mutual, col_arg,
            angles_a, angles_b, histo_bins) -> Matches:
    """Threshold, ratio, mutual and rotation checks on the match tables."""
    ok = valid_a & (best <= max_dist)
    if ratio < 1.0:
        ok &= best < ratio * second
    if mutual:
        arange = torch.arange(idx.shape[0], dtype=torch.int32, device=idx.device)
        ok &= col_arg[idx.long()] == arange
    if angles_a is not None and angles_b is not None:
        # reference ComputeThreeMaxima: drop 2nd/3rd bins below 0.1x the max
        ok &= _rotation_consistent(ok, angles_a, angles_b, idx, histo_bins)
    return Matches(idx=idx, dist=torch.where(ok, best, torch.full_like(best, BIG)), ok=ok)


def match(desc_a, desc_b, valid_a, valid_b, allowed=None, max_dist: float = 50.0,
          ratio: float = 1.0, mutual: bool = False, angles_a=None, angles_b=None,
          histo_bins: int = 30) -> Matches:
    """Dense matcher: masked best/second-best with ratio, threshold,
    optional mutual-best and rotation-consistency checks. ``allowed`` is the
    composed candidate mask [N, M]."""
    D = hamming_matrix(desc_a, desc_b)
    pen = torch.where(valid_b[None, :], 0.0, BIG)
    if allowed is not None:
        pen = pen + torch.where(allowed, 0.0, BIG)
    D = D + pen
    idx = torch.argmin(D, dim=1)
    best = D.gather(1, idx[:, None])[:, 0]
    second = D.scatter(1, idx[:, None], (best + BIG)[:, None]).amin(dim=1)
    col_arg = torch.argmin(D, dim=0).to(torch.int32) if mutual else None
    return _finish(valid_a, idx.to(torch.int32), best, second, max_dist, ratio,
                   mutual, col_arg, angles_a, angles_b, histo_bins)


def match_windowed(desc_a, desc_b, valid_a, valid_b, xy_a=None, xy_b=None,
                   radius_b=None, level_a=None, level_b=None,
                   lvl_lo: float = -1e9, lvl_hi: float = 1e9,
                   max_dist: float = 50.0, ratio: float = 1.0,
                   mutual: bool = False, angles_a=None, angles_b=None,
                   histo_bins: int = 30) -> Matches:
    """The hot-path matcher: window + octave-band candidate restriction
    through the fused match tables (same contract as ``match`` with
    ``allowed = window(xy, radius_b) & (lvl_b - lvl_a in [lvl_lo, lvl_hi])``)."""
    with stage("matching.match_tables"):
        t = ph.match_tables(
            desc_a, desc_b, valid_a, valid_b, xy_a=xy_a, xy_b=xy_b,
            radius_b=radius_b, level_a=level_a, level_b=level_b,
            lvl_lo=lvl_lo, lvl_hi=lvl_hi, use_window=xy_a is not None,
        )
    return _finish(valid_a, t.row_arg, t.row_best, t.row_second, max_dist,
                   ratio, mutual, t.col_arg, angles_a, angles_b, histo_bins)


def match_epipolar(desc_a, desc_b, valid_a, valid_b, F12, xy_a, xy_b, level_a,
                   level_b, scale: float, lvl_lo: float = -2.0,
                   lvl_hi: float = 2.0, max_dist: float = 100.0,
                   ratio: float = 1.0) -> Matches:
    """Epipolar-band matching for triangulation (SearchForTriangulation,
    ORBmatcher.cc:659) through the fused match tables."""
    ones = torch.ones((xy_a.shape[0], 1), dtype=xy_a.dtype, device=xy_a.device)
    lines = torch.cat([xy_a, ones], dim=1) @ F12.T  # [N, 3]
    epi_thr = 3.84 * (scale ** level_b.to(torch.float32)) ** 2
    with stage("matching.match_tables"):  # the matcher's launches alone
        t = ph.match_tables(
            desc_a, desc_b, valid_a, valid_b, xy_b=xy_b, level_a=level_a,
            level_b=level_b, lines_a=lines, epi_thr_b=epi_thr,
            lvl_lo=lvl_lo, lvl_hi=lvl_hi, use_epipolar=True,
        )
    return _finish(valid_a, t.row_arg, t.row_best, t.row_second, max_dist,
                   ratio, False, None, None, None, 30)


def _floor_mod(x, y: float):
    """``x % y`` with floor semantics, as jnp.remainder computes it: an exact
    fmod, then one correction by y where the sign differs."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` with its tie rule (lowest index first among equal
    values): a stable descending sort, sliced. Returns (values, indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _rotation_consistent(ok, angles_a, angles_b, idx, histo_bins: int):
    """Three-maxima rotation-consistency filter (shared by match paths)."""
    two_pi = 2.0 * math.pi
    delta = _floor_mod(angles_a - angles_b[idx.long()], two_pi)
    bins = torch.clamp((delta / two_pi * histo_bins).to(torch.int32), 0, histo_bins - 1)
    hist = torch.zeros(histo_bins, dtype=torch.int32, device=ok.device)
    hist = hist.index_add(0, bins.long(), ok.to(torch.int32))
    counts, top3 = _top_k(hist, 3)
    floor = torch.clamp_min((0.1 * counts[0].to(torch.float32)).to(torch.int32), 1)
    keep_bin = counts >= floor
    return ((bins[:, None] == top3[None, :]) & keep_bin[None, :]).any(dim=1)


def resolve_duplicates(matches: Matches, n_b: int) -> Matches:
    """Keep only the lowest-distance A per matched B (lowest A index among
    equal distances)."""
    n_a = matches.idx.shape[0]
    dev = matches.idx.device
    idx = matches.idx.long()
    d = torch.where(matches.ok, matches.dist, torch.full_like(matches.dist, BIG))
    per_b = torch.full((n_b,), BIG, dtype=d.dtype, device=dev).scatter_reduce(
        0, idx, d, "amin")
    is_winner = matches.ok & (d <= per_b[idx])
    arange = torch.arange(n_a, dtype=torch.int32, device=dev)
    cand = torch.where(is_winner, arange, torch.full_like(arange, n_a))
    first_a = torch.full((n_b,), n_a, dtype=torch.int32, device=dev).scatter_reduce(
        0, idx, cand, "amin")
    ok = is_winner & (first_a[idx] == arange)
    return Matches(idx=matches.idx, dist=matches.dist, ok=ok)
