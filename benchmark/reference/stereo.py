"""Plain stereo association: ORB-SLAM2's ``Frame::ComputeStereoMatches``
(``src/Frame.cc``) as the port states it, written out row by row.

For each valid left keypoint (level-0 ``xy``, ``level``, 256-bit ``desc``):

1. The descriptor stage, the port's rule as it stands: candidates are the
   valid right keypoints within ``2 * scale^level`` rows of it, of an
   octave within one of its own, at a disparity in ``(0.25, bf / min_z]``;
   the best (the first of equal distances) is taken where it is at most 75,
   at most 0.85 times the runner-up (the best of the other candidates) and
   the left keypoint is in turn the best (the first) for that right
   keypoint among the left keypoints it is a candidate of.
2. The correlation: the 11x11 patch of the left image at the rounded
   position, less its centre pixel, against the right image's patches
   around the rounded coarse match ``uR0``, each less its own centre pixel,
   at the shifts -5..5: the sum of absolute differences of integers. The
   row is rejected where a patch of the search would leave the image, where
   the least SAD (the first of equals) lies at a shift of -5 or 5, and where
   the parabola's vertex ``deltaR = (s0 - s2) / (2 (s0 + s2 - 2 s1))`` lies
   outside [-1, 1] (with the least SAD inside the search the vertex lies
   within +-1/2, so this rule does not fire). The refined
   ``u_right = uR0 + shift + deltaR``; a row whose disparity
   ``u_left - u_right`` is not in ``(0.25, bf / min_z)`` is dropped.
3. The final filter: the SADs of the rows left, sorted; ``median`` is the
   one at index n // 2; every row whose SAD is at least
   ``1.5f * 1.4f * median`` (float32, as ORB-SLAM2 computes it) is rejected.

Departures from ORB-SLAM2, each the port's: the correlation runs on the
level-0 images at the level-0 positions, not on the keypoint's octave; the
descriptor stage's row band is set by the left keypoint's octave and
compares coordinates (ORB-SLAM2: the right keypoint's, over whole rows), it
accepts at ``<=`` 75 (ORB-SLAM2: ``< 75``) and adds the ratio test and the
mutual-best check, which ORB-SLAM2 has not; the disparity floor is 0.25 px
(ORB-SLAM2: 0, a disparity of exactly 0 moved to 0.01); the border test
takes the left patch and the whole search window (ORB-SLAM2 tests
``uR0 + L - w`` and the window's right end). Coordinates are rounded half
away from zero, as C's ``round``. Arithmetic is float64 and integers,
except the median's threshold.

``determinate`` marks the rows whose answer the rule fixes: the port's
float32 coordinates decide pairs that lie exactly at the row band's limit
by their rounding, and such a pair can move a row's match and, through the
median, other rows' filter.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

W_PATCH = 5  # half the patch: 11x11
L_SEARCH = 5  # shifts -5..5
TH_DIST = 75
RATIO = 0.85
ROW_BAND = 2.0
MIN_DISP = 0.25
SAD_FACTOR = np.float32(1.5) * np.float32(1.4)
BORDER_SHARE = 1e-5  # of the row band: what float32 rounding can move its limit by
# the reasons a matched row is not kept, in the order they are tested
BORDER, EDGE, VERTEX, RANGE, MEDIAN = "border", "edge", "vertex", "range", "median"


@dataclass
class Association:
    u_right: np.ndarray  # [M] float64, -1 where not kept
    depth: np.ndarray  # [M] float64, -1 where not kept
    coarse: np.ndarray  # [M] int64: the matched right keypoint, -1 where none
    reason: list  # [M] "kept", one of the rejections, or None where unmatched
    sad: np.ndarray  # [M] int64: the least SAD of a row that reached the filter, else -1

    def counts(self) -> dict:
        """The port's six counters (``ops/stereo.STEREO_COUNTERS``)."""
        r = self.reason
        return {"stereo.rows_matched": sum(x is not None for x in r),
                "stereo.rows_kept": r.count("kept"),
                "stereo.rejected_edge": r.count(EDGE),
                "stereo.rejected_vertex": r.count(VERTEX),
                "stereo.rejected_border": r.count(BORDER),
                "stereo.rejected_median": r.count(MEDIAN)}


def _round(x: float) -> int:
    return int(np.floor(float(x) + 0.5))


def hamming(desc_a: np.ndarray, desc_b: np.ndarray) -> np.ndarray:
    """[N, M] int64 Hamming distances of uint8 descriptor rows [N, 32], [M, 32]."""
    a = np.unpackbits(np.asarray(desc_a, np.uint8), axis=1).astype(np.float64)
    b = np.unpackbits(np.asarray(desc_b, np.uint8), axis=1).astype(np.float64)
    return np.rint(a @ (1.0 - b).T + (1.0 - a) @ b.T).astype(np.int64)


def match_rows(xyL, levelL, descL, validL, xyR, levelR, descR, validR, *, bf: float,
               min_z: float, scale: float, slack: float = 0.0) -> np.ndarray:
    """Step 1: [M] the right keypoint matched to each left keypoint, -1
    where none; ``slack`` widens (or, negative, narrows) the row band by
    that share of itself."""
    xyL, xyR = np.asarray(xyL, np.float64), np.asarray(xyR, np.float64)
    levelL, levelR = np.asarray(levelL, np.int64), np.asarray(levelR, np.int64)
    validL, validR = np.asarray(validL, bool), np.asarray(validR, bool)
    D = hamming(descL, descR)
    band = ROW_BAND * scale ** levelL.astype(np.float64)
    disp = xyL[:, None, 0] - xyR[None, :, 0]
    cand = (validL[:, None] & validR[None, :]
            & (np.abs(xyL[:, None, 1] - xyR[None, :, 1]) <= band[:, None] * (1.0 + slack))
            & (np.abs(levelR[None, :] - levelL[:, None]) <= 1)
            & (disp > MIN_DISP) & (disp <= bf / min_z))
    big = np.iinfo(np.int64).max
    Dm = np.where(cand, D, big)
    col_best = Dm.argmin(axis=0)  # per right keypoint: its first best left keypoint
    out = np.full(len(xyL), -1, np.int64)
    for i in np.nonzero(cand.any(axis=1))[0]:
        row = Dm[i]
        j = int(row.argmin())
        others = np.delete(row, j)
        second = others.min() if len(others) and others.min() < big else None
        if row[j] > TH_DIST:
            continue
        if second is not None and not row[j] <= RATIO * second:
            continue
        if col_best[j] != i:
            continue
        out[i] = j
    return out


def median_threshold(sads) -> np.float32:
    """Step 3's threshold over the SADs of the rows that reached it:
    ``1.5f * 1.4f`` times the one at index n // 2 of their ascending sort."""
    return np.float32(SAD_FACTOR * np.float32(sorted(sads)[len(sads) // 2]))


def correlate(img_left, img_right, xy_left, u_coarse, *, bf: float, max_disp: float,
              coarse=None, with_filter: bool = True) -> Association:
    """Steps 2 and 3 (with ``with_filter``) for rows with a coarse right
    coordinate ``u_coarse`` [M] (-1 where none), on uint8 images [H, W]."""
    IL = np.asarray(img_left).astype(np.int64)
    IR = np.asarray(img_right).astype(np.int64)
    H, W = IL.shape
    w, L = W_PATCH, L_SEARCH
    M = len(u_coarse)
    u_out = np.full(M, -1.0)
    depth = np.full(M, -1.0)
    reason: list = [None] * M
    sad = np.full(M, -1, np.int64)
    for i in range(M):
        if u_coarse[i] < 0:
            continue
        uL, vL = _round(xy_left[i][0]), _round(xy_left[i][1])
        uR0 = _round(u_coarse[i])
        if (vL - w < 0 or vL + w > H - 1 or uL - w < 0 or uL + w > W - 1
                or uR0 - L - w < 0 or uR0 + L + w > W - 1):
            reason[i] = BORDER
            continue
        patch = IL[vL - w:vL + w + 1, uL - w:uL + w + 1]
        patch = patch - patch[w, w]
        dists = []
        for inc in range(-L, L + 1):
            pr = IR[vL - w:vL + w + 1, uR0 + inc - w:uR0 + inc + w + 1]
            dists.append(int(np.abs(patch - (pr - pr[w, w])).sum()))
        best = min(range(2 * L + 1), key=lambda k: (dists[k], k))
        if best in (0, 2 * L):
            reason[i] = EDGE
            continue
        s0, s1, s2 = dists[best - 1], dists[best], dists[best + 1]
        delta = (s0 - s2) / (2.0 * (s0 + s2 - 2.0 * s1))
        if delta < -1 or delta > 1:
            reason[i] = VERTEX
            continue
        u_r = uR0 + (best - L) + delta
        disp = float(xy_left[i][0]) - u_r
        if not (MIN_DISP < disp < max_disp):
            reason[i] = RANGE
            continue
        u_out[i], depth[i], reason[i], sad[i] = u_r, bf / disp, "kept", s1
    # ORB-SLAM2: sort (SAD, row) pairs, the median at index n // 2, and drop
    # from the largest down while the SAD is not below 1.5f * 1.4f * median
    ranked = sorted((int(sad[i]), i) for i in range(M) if reason[i] == "kept")
    if with_filter and ranked:
        th = median_threshold([s for s, _ in ranked])
        for s, i in reversed(ranked):
            if np.float32(s) < th:
                break
            u_out[i], depth[i], reason[i] = -1.0, -1.0, MEDIAN
    return Association(u_out, depth, np.full(M, -1, np.int64) if coarse is None
                       else np.asarray(coarse, np.int64), reason, sad)


def associate(img_left, img_right, left: dict, right: dict, *, bf: float, min_z: float,
              scale: float, slack: float = 0.0, with_filter: bool = True) -> Association:
    """The whole association: ``left`` and ``right`` hold ``xy`` [N, 2]
    (level-0 pixels), ``level`` [N], ``desc`` [N, 32] uint8 and ``valid``
    [N]; the answer is per left row."""
    j = match_rows(left["xy"], left["level"], left["desc"], left["valid"], right["xy"],
                   right["level"], right["desc"], right["valid"], bf=bf, min_z=min_z,
                   scale=scale, slack=slack)
    xyR = np.asarray(right["xy"], np.float64)
    u_coarse = np.where(j >= 0, xyR[np.maximum(j, 0), 0], -1.0)
    return correlate(img_left, img_right, np.asarray(left["xy"], np.float64), u_coarse,
                     bf=bf, max_disp=bf / min_z, coarse=j, with_filter=with_filter)


def determinate(img_left, img_right, left: dict, right: dict, **kw) -> np.ndarray:
    """[M] bool: the rows whose answer the rule determines. Keypoints lie on
    each level's pixel grid, so many pairs lie exactly two level rows
    apart, at the row band's limit, where float32 coordinates decide by
    their rounding, pair by pair. Steps 1 and 2 are run with the band moved
    by ``BORDER_SHARE`` of itself either way: a row whose answer differs
    between the two turns on such a pair. The rows that reach step 3 in one
    reading and not in the other (or with another SAD) move the median: a
    row that reaches it in both is determined where its SAD lies below the
    threshold of the least median any choice of those rows gives, or at or
    above that of the greatest."""
    lo = associate(img_left, img_right, left, right, slack=-BORDER_SHARE, with_filter=False,
                   **kw)
    hi = associate(img_left, img_right, left, right, slack=BORDER_SHARE, with_filter=False,
                   **kw)
    r_lo, r_hi = np.array(lo.reason, object), np.array(hi.reason, object)
    same = (r_lo == r_hi) & (np.abs(lo.u_right - hi.u_right) <= 1e-9)
    sure = same & (r_lo == "kept")
    if not sure.any():
        return same
    open_ = ~sure & ((r_lo == "kept") | (r_hi == "kept"))
    # an open row's SADs in the readings where it reaches step 3
    low = np.where(r_lo == "kept", lo.sad, np.where(r_hi == "kept", hi.sad, 0))
    high = np.maximum(np.where(r_lo == "kept", lo.sad, 0), np.where(r_hi == "kept", hi.sad, 0))
    low = np.minimum(low, np.where(r_hi == "kept", hi.sad, low))[open_].tolist()
    high = high[open_].tolist()
    sads = lo.sad[sure].tolist()

    def median(values):
        return sorted(values)[len(values) // 2]

    # at each count, the open rows' least (greatest) SADs give the least
    # (greatest) median of that count
    least = min(median(sads + sorted(low)[:k]) for k in range(len(low) + 1))
    most = max(median(sads + sorted(high)[len(high) - k:]) for k in range(len(high) + 1))
    th_lo = np.float32(SAD_FACTOR * np.float32(least))
    th_hi = np.float32(SAD_FACTOR * np.float32(most))
    s = lo.sad.astype(np.float32)
    return same & (~sure | (s < th_lo) | (s >= th_hi))
