"""Per-row int8 quantization of the embedding tables.

The host side is numpy and produces byte-identical output to the
reference quantizer (code2vec_tpu/ops/quant.py:57-120): s_r = max|w_r| /
127, q = round(w / s_r) in [-127, 127], all-zero rows get scale 0. The
device side is the plain PyTorch gather with fused dequant
(code2vec_tpu/ops/quant.py:163-194); on the serving path the gather runs
inside kernel K1 (kernels/encoder.py), and these are its plain version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

QMAX = 127


def quantize_rows(table: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """f32 (V, D) -> (int8 (V, D), f32 scales (V, 1))."""
    table = np.asarray(table, np.float32)
    if table.ndim != 2:
        raise ValueError(f"row quantizers expect a 2-D table, "
                         f"got shape {table.shape}")
    scales = (np.abs(table).max(axis=1, keepdims=True) / QMAX
              ).astype(np.float32)
    safe = np.where(scales > 0, scales, 1.0)
    q = np.clip(np.rint(table / safe), -QMAX, QMAX).astype(np.int8)
    return q, scales


def dequantize_rows(q: np.ndarray, scales: np.ndarray) -> np.ndarray:
    return q.astype(np.float32) * np.asarray(scales, np.float32)


def dequant_gather(q_table: torch.Tensor, scales: torch.Tensor,
                   ids: torch.Tensor) -> torch.Tensor:
    """Rows of an int8 table by id, times their scales: (..., D) f32."""
    ids = ids.long()
    return q_table[ids].float() * scales[:, 0][ids][..., None]


def table_gather(table: torch.Tensor, scales: Optional[torch.Tensor],
                 ids: torch.Tensor) -> torch.Tensor:
    """f32 tables pass scales=None (plain gather); int8 tables carry
    their scales."""
    if scales is None:
        return table[ids.long()]
    return dequant_gather(table, scales, ids)
