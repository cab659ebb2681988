"""Plain masked Hamming match tables, and their comparison with a matcher's.

The contract: for descriptor rows A [N, 32] and columns B [M, 32] (uint8,
256 bits), the distance is the popcount of A xor B; an entry is live where
both sides are valid, ``|xa - xb|`` and ``|ya - yb|`` are at most the
column's radius (window mode), the point lies within the column's band of
the row's epipolar line (``num^2 <= thr * (lx^2 + ly^2)``, epipolar mode)
and ``level_b - level_a`` lies in ``[lvl_lo, lvl_hi]``. Per row: the best
distance, its column (the lowest among ties) and the second best over the
other columns; per column: the best distance and its row (the earliest).
A row or column with no live entry reports a best above 256.

The window and band tests compare float32 inputs: where a pair lies within
a relative 1e-5 of its limit, float32 and float64 may decide it apart. The
tables are therefore built twice, with such borderline pairs dropped and
kept; a row or column is judged only where both agree (``determinate``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

BIG = 1e9
BORDER = 1e-5


class Tables(NamedTuple):
    row_best: torch.Tensor
    row_second: torch.Tensor
    row_arg: torch.Tensor
    col_best: torch.Tensor
    col_arg: torch.Tensor


def _bits(d: torch.Tensor) -> torch.Tensor:
    shifts = torch.arange(8, device=d.device, dtype=torch.uint8)
    return ((d[..., None] >> shifts) & 1).reshape(d.shape[0], 256).double()


def _masks(a: dict, rows: slice):
    """(live, borderline) [n, M] for rows ``rows``."""
    va, vb = a["valid_a"][rows], a["valid_b"]
    live = va[:, None] & vb[None, :]
    border = torch.zeros_like(live)
    if a["use_window"]:
        xa, xb, r = a["xy_a"][rows].double(), a["xy_b"].double(), a["radius_b"].double()
        d = torch.maximum((xa[:, None, 0] - xb[None, :, 0]).abs(),
                          (xa[:, None, 1] - xb[None, :, 1]).abs())
        live &= d <= r[None, :]
        border |= (d - r[None, :]).abs() <= BORDER * torch.clamp_min(r[None, :], 1.0)
    if a["use_epipolar"]:
        ln, xb, thr = a["lines_a"][rows].double(), a["xy_b"].double(), a["epi_thr_b"].double()
        num = ln[:, None, 0] * xb[None, :, 0] + ln[:, None, 1] * xb[None, :, 1] + ln[:, None, 2]
        den = torch.clamp_min(ln[:, 0:1] ** 2 + ln[:, 1:2] ** 2, 1e-12)
        lhs, rhs = num * num, thr[None, :] * den
        live &= lhs <= rhs
        border |= (lhs - rhs).abs() <= BORDER * torch.clamp_min(rhs, 1e-6)
    n, m = live.shape
    la = a["level_a"][rows].double() if a["level_a"] is not None else torch.zeros(
        n, dtype=torch.float64, device=live.device)
    lb = a["level_b"].double() if a["level_b"] is not None else torch.zeros(
        m, dtype=torch.float64, device=live.device)
    dl = lb[None, :] - la[:, None]
    live &= (dl >= a["lvl_lo"]) & (dl <= a["lvl_hi"])
    return live, border & (a["valid_a"][rows][:, None] & vb[None, :])


def tables(a: dict, block: int = 512) -> tuple[Tables, Tables]:
    """The reference tables of one call's arguments ``a`` (the matcher's
    keyword names), with borderline pairs dropped and with them kept."""
    db = _bits(a["desc_b"])
    pb = db.sum(-1)
    n = a["desc_a"].shape[0]
    out = {k: [] for k in ("strict", "loose")}
    col = {k: None for k in out}
    for r0 in range(0, n, block):
        rows = slice(r0, min(n, r0 + block))
        da = _bits(a["desc_a"][rows])
        D = da.sum(-1)[:, None] + pb[None, :] - 2.0 * (da @ db.T)
        live, border = _masks(a, rows)
        for kind, lv in (("strict", live & ~border), ("loose", live | border)):
            Dm = torch.where(lv, D, torch.full_like(D, BIG))
            arg = torch.argmin(Dm, dim=1)
            best = Dm.gather(1, arg[:, None])[:, 0]
            second = Dm.scatter(1, arg[:, None], BIG).min(dim=1).values
            out[kind].append((best, second, arg))
            cb = Dm.min(dim=0).values
            ca = torch.argmin(Dm, dim=0) + r0
            if col[kind] is None:
                col[kind] = (cb, ca)
            else:
                pb_, pa_ = col[kind]
                take = cb < pb_  # an earlier block wins ties
                col[kind] = (torch.where(take, cb, pb_), torch.where(take, ca, pa_))
    res = []
    for kind in ("strict", "loose"):
        best, second, arg = (torch.cat(x) for x in zip(*out[kind]))
        res.append(Tables(best, second, arg, col[kind][0], col[kind][1]))
    return res[0], res[1]


def _entry_diff(pb, ps, pa, rb, rs, ra):
    """[n] True where a program's (best, second, arg) differ from the
    reference's: best and second equal where live (both above 256 where
    not), the argument equal where the best is live."""
    big_p, big_r = pb > 256, rb > 256
    diff = (big_p != big_r) | (~big_r & (pb != rb))
    diff |= (~big_r & (pa.long() != ra.long()))
    if ps is not None:
        sp, sr = ps > 256, rs > 256
        diff |= (sp != sr) | (~sr & (ps != rs))
    return diff


def compare(prog: Tables, strict: Tables, loose: Tables) -> tuple[int, int, int]:
    """(entries that differ, entries judged, entries left undetermined) over
    the rows and the columns of one call."""
    prog = Tables(*(t.to(strict.row_best.device) for t in prog))
    pr = [prog.row_best.double(), prog.row_second.double(), prog.row_arg]
    pc = [prog.col_best.double(), None, prog.col_arg]
    det_r = ~_entry_diff(strict.row_best, strict.row_second, strict.row_arg,
                         loose.row_best, loose.row_second, loose.row_arg)
    det_c = ~_entry_diff(strict.col_best, None, strict.col_arg,
                         loose.col_best, None, loose.col_arg)
    dr = _entry_diff(*pr, strict.row_best, strict.row_second, strict.row_arg) & det_r
    dc = _entry_diff(*pc, strict.col_best, None, strict.col_arg) & det_c
    judged = int(det_r.sum()) + int(det_c.sum())
    undetermined = int((~det_r).sum()) + int((~det_c).sum())
    return int(dr.sum()) + int(dc.sum()), judged, undetermined
