"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit) and the least-time arithmetic of the
kernels the benchmark reads.

The matcher (``match_tables``): for N descriptor rows against M columns of
256 bits, one multiply-add per bit and pair (``2 N M 256`` operations) at
the int8 rate, or every input read once and every table written once at
the memory rate, whichever is longer. The count is that of the contract,
not of an implementation.
"""

from __future__ import annotations

INT8_OPS_PER_S = 1.979e15
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12
FP32_FLOPS_PER_S = 67e12


def matcher_ops(n: int, m: int) -> float:
    return 2.0 * n * m * 256


def matcher_bytes(mode: str, n: int, m: int) -> float:
    """Inputs read once, tables written once: descriptors (32 B a row or
    column), validity (1 B), levels (4 B), and in window mode both sides'
    points (8 B) and the columns' radii (4 B), in epipolar mode the rows'
    lines (12 B), the columns' points (8 B) and thresholds (4 B); the row
    tables (best, second, argmin: 12 B) and column tables (best, argmin:
    8 B)."""
    row, col = 32 + 1 + 4 + 12, 32 + 1 + 4 + 8
    if "window" in mode:
        row += 8
        col += 8 + 4
    if "epipolar" in mode:
        row += 12
        col += 8 + 4
    return float(n * row + m * col)


def matcher_least_s(mode: str, n: int, m: int) -> float:
    return max(matcher_ops(n, m) / INT8_OPS_PER_S, matcher_bytes(mode, n, m) / HBM_BYTES_PER_S)
