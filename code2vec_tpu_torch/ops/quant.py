"""Per-row quantization of the embedding tables: int8, fp8 (e4m3/e5m2)
and packed int4 (two weights per byte).

The host side is numpy (torch only for the fp8 casts) and produces
byte-identical output to the reference quantizers
(code2vec_tpu/ops/quant.py:57-145). Every scheme is per-row symmetric,
with all-zero rows at scale 0:

- int8: s_r = max|w_r| / 127, q = round(w / s_r) in [-127, 127];
- fp8: s_r = max|w_r| / FP8_MAX[fmt], payload = (w / s_r) cast to the
  format, stored as its uint8 bit patterns (numpy has no fp8 type; torch
  encodes exactly as ml_dtypes does);
- int4: s_r = max|w_r| / 7, q = round(w / s_r) in [-7, 7], stored
  offset-binary (q + 8), the even column in the low nibble of each byte,
  an odd trailing column padded with 8 (the encoding of 0).

The device side is the plain PyTorch gather with fused dequant
(code2vec_tpu/ops/quant.py:151-194). A table's dtype names its format:
f32 (scales None), int8, torch.float8_e4m3fn or torch.float8_e5m2 (an
fp8 payload viewed from its bytes), or uint8 holding packed int4. An int4
table's width in values is that of the operand it meets (the code vector,
a query), or `int4_dim` where nothing else tells it (the gathers, whose
odd widths leave the last byte half padding). On the serving path the gathers run
inside kernels K1, K4 and K11 and the table read inside K3; these are
their plain versions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

QMAX = 127
INT4_QMAX = 7
FP8_DTYPES = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}
FP8_MAX = {"e4m3": 448.0, "e5m2": 57344.0}


def _check_2d(table: np.ndarray) -> np.ndarray:
    table = np.asarray(table, np.float32)
    if table.ndim != 2:
        raise ValueError(f"row quantizers expect a 2-D table, "
                         f"got shape {table.shape}")
    return table


def _row_scales(table: np.ndarray, qmax: float) -> np.ndarray:
    return (np.abs(table).max(axis=1, keepdims=True) / qmax
            ).astype(np.float32)


def quantize_rows(table: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """f32 (V, D) -> (int8 (V, D), f32 scales (V, 1))."""
    table = _check_2d(table)
    scales = _row_scales(table, QMAX)
    safe = np.where(scales > 0, scales, 1.0)
    q = np.clip(np.rint(table / safe), -QMAX, QMAX).astype(np.int8)
    return q, scales


def quantize_rows_fp8(table: np.ndarray, fmt: str = "e4m3"
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """f32 (V, D) -> (uint8 fp8 bit patterns (V, D), f32 scales (V, 1))."""
    if fmt not in FP8_DTYPES:
        raise ValueError(f"fp8 format must be one of {sorted(FP8_DTYPES)}, "
                         f"got {fmt!r}")
    table = _check_2d(table)
    scales = _row_scales(table, FP8_MAX[fmt])
    safe = np.where(scales > 0, scales, 1.0)
    x = np.ascontiguousarray(table / safe, dtype=np.float32)
    q = torch.from_numpy(x).to(FP8_DTYPES[fmt]).view(torch.uint8)
    return q.numpy(), scales


def quantize_rows_int4(table: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """f32 (V, D) -> (uint8 (V, ceil(D/2)), f32 scales (V, 1))."""
    table = _check_2d(table)
    scales = _row_scales(table, INT4_QMAX)
    safe = np.where(scales > 0, scales, 1.0)
    q = np.clip(np.rint(table / safe), -INT4_QMAX, INT4_QMAX)
    u = (q + 8).astype(np.uint8)
    if u.shape[1] % 2:
        u = np.concatenate(
            [u, np.full((u.shape[0], 1), 8, np.uint8)], axis=1)
    return (u[:, 0::2] | (u[:, 1::2] << 4)), scales


def dequantize_rows(q: np.ndarray, scales: np.ndarray) -> np.ndarray:
    return q.astype(np.float32) * np.asarray(scales, np.float32)


def dequantize_rows_fp8(q: np.ndarray, scales: np.ndarray,
                        fmt: str = "e4m3") -> np.ndarray:
    """Inverse of quantize_rows_fp8 (uint8 bit patterns in)."""
    f = torch.from_numpy(np.ascontiguousarray(q, np.uint8)).view(
        FP8_DTYPES[fmt]).float().numpy()
    return f * np.asarray(scales, np.float32)


def unpack_int4_host(packed: np.ndarray, dim: int) -> np.ndarray:
    """uint8 (V, ceil(dim/2)) -> int8 (V, dim) in [-7, 7]."""
    packed = np.asarray(packed, np.uint8)
    out = np.empty((packed.shape[0], packed.shape[1] * 2), np.int8)
    out[:, 0::2] = (packed & 0xF).astype(np.int8) - 8
    out[:, 1::2] = (packed >> 4).astype(np.int8) - 8
    return out[:, :dim]


def dequantize_rows_int4(packed: np.ndarray, scales: np.ndarray,
                         dim: int) -> np.ndarray:
    return (unpack_int4_host(packed, dim).astype(np.float32)
            * np.asarray(scales, np.float32))


# ----------------------------------------------------------- device side


def unpack_int4(packed: torch.Tensor, dim: int) -> torch.Tensor:
    """uint8 (..., ceil(dim/2)) -> f32 (..., dim): the nibbles of gathered
    or sliced rows, never of the whole table."""
    lo = (packed & 0xF).to(torch.int32) - 8
    hi = (packed >> 4).to(torch.int32) - 8
    out = torch.stack([lo, hi], dim=-1).reshape(
        packed.shape[:-1] + (packed.shape[-1] * 2,))
    return out[..., :dim].float()


def decode_rows(rows: torch.Tensor,
                dim: Optional[int] = None) -> torch.Tensor:
    """Gathered or sliced rows of any table format -> their f32 values
    before the scale (exact for every format). Packed int4 rows (uint8)
    hold `dim` values, by default two a byte."""
    if rows.dtype == torch.uint8:
        return unpack_int4(rows, 2 * rows.shape[-1] if dim is None else dim)
    return rows.float()


def dequant_gather(q_table: torch.Tensor, scales: torch.Tensor,
                   ids: torch.Tensor,
                   int4_dim: Optional[int] = None) -> torch.Tensor:
    """Rows of an int8, fp8 or packed-int4 table by id, times their
    scales: (..., D) f32."""
    ids = ids.long()
    return (decode_rows(q_table[ids], int4_dim)
            * scales[:, 0][ids][..., None])


def table_gather(table: torch.Tensor, scales: Optional[torch.Tensor],
                 ids: torch.Tensor, *,
                 int4_dim: Optional[int] = None) -> torch.Tensor:
    """f32 tables pass scales=None (plain gather); int8, fp8 and packed
    int4 tables carry their scales, int4 ones of odd width also their
    unpacked width."""
    if scales is None:
        return table[ids.long()]
    return dequant_gather(table, scales, ids, int4_dim)
