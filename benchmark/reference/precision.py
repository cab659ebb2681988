"""The reference's arithmetic, in one of two precisions.

``EXACT`` computes in float64: the reference proper. ``TF32`` is the
control, the nearest precision below the configurations' float32 with TF32
off: every product-sum (matrix product, einsum, convolution) takes operands
rounded to TF32's 10-bit mantissa, as the tensor cores would, and
everything is float32. The rounding is done explicitly so that the control
reads the same on the CPU and on the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to nearest (ties to even) at 10 mantissa bits."""
    b = x.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    r = ((b + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


@dataclass(frozen=True)
class Precision:
    name: str
    dtype: torch.dtype
    tf32: bool

    def t(self, x, device=None) -> torch.Tensor:
        return torch.as_tensor(x, device=device).to(self.dtype)

    def _op(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        return round_tf32(x) if self.tf32 else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self._op(a) @ self._op(b)

    def einsum(self, eq: str, *ops: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, *(self._op(o) for o in ops))


EXACT = Precision("float64", torch.float64, False)
TF32 = Precision("tf32", torch.float32, True)
