"""The 3xTF32 product of K3's float32 mode and K9, emulated in plain
PyTorch. Only tests use it: it shows on the CPU that the split holds the
float32 paths' tolerances before the kernels run on the card.

Each f32 operand x is split into tf32 hi = rna(x) (round to nearest, ties
away from zero, at the 10th mantissa bit: `cvt.rna.tf32.f32`) and lo =
rna(x - hi). The kernels accumulate hi.hi + hi.lo + lo.hi in f32 on the
tensor cores; every such product of two tf32 values is exact in f32, so
three f32 matrix products here form the same terms.
"""

from __future__ import annotations

from typing import Tuple

import torch

_ROUND = 0x1000           # half of the 13 dropped mantissa bits
_KEEP = -0x2000           # 0xFFFFE000: sign, exponent, 10 mantissa bits


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 to the nearest tf32, ties away from zero (as f32); NaN and
    infinities pass through."""
    x = x.to(torch.float32).contiguous()
    bits = (x.view(torch.int32) + _ROUND) & _KEEP
    return torch.where(torch.isfinite(x), bits.view(torch.float32), x)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with hi = rna(x), lo = rna(x - hi)."""
    hi = round_tf32(x)
    return hi, round_tf32(x.to(torch.float32) - hi)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (N, K).T as the kernels form it: (M, N) f32."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return a_hi @ b_lo.T + a_lo @ b_hi.T + a_hi @ b_hi.T
