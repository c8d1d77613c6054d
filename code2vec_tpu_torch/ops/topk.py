"""Blockwise top-k over the target-name classifier, in plain PyTorch: the
counterpart of code2vec_tpu/ops/topk.py, and the plain version of
kernels K3 (kernels/topk.py) and K4 (kernels/label_logits.py).

The table is streamed in row blocks: each block's (B, block) logits are
computed in f32 from operands rounded to the compute dtype, scaled by the
per-row dequant scale, masked at `valid_rows`, and merged into a running
top-k and a running logsumexp, so the (B, V) logits never exist.

Ties: `lax.top_k` ranks NaN first and breaks equal values toward the
lower index. A stable descending sort over [running, block] reproduces
that (running entries hold lower indices), where `torch.topk` would not.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from code2vec_tpu_torch.ops.quant import decode_rows

NEG_INF = float("-inf")


class BlockTopKOutputs(NamedTuple):
    values: torch.Tensor   # (B, k) f32, sorted descending
    indices: torch.Tensor  # (B, k) int32 global target-vocab ids
    lse: torch.Tensor      # (B,) f32 logsumexp over all live logits


def _merge_top_k(vals: torch.Tensor, idx: torch.Tensor,
                 block_vals: torch.Tensor, block_idx: torch.Tensor,
                 k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold one block's logits into the running (B, k) top-k."""
    cat_v = torch.cat([vals, block_vals], dim=1)
    cat_i = torch.cat([idx, block_idx], dim=1)
    top_v, pos = torch.sort(cat_v, dim=1, descending=True, stable=True)
    return top_v[:, :k], torch.gather(cat_i, 1, pos[:, :k])


def _fold_lse(run_max: torch.Tensor, run_sum: torch.Tensor,
              block_logits: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One streaming-logsumexp step; -inf entries contribute 0."""
    block_max = block_logits.amax(dim=-1)
    new_max = torch.maximum(run_max, block_max)
    safe_new = torch.where(torch.isfinite(new_max), new_max,
                           torch.zeros_like(new_max))
    rescale = torch.where(torch.isfinite(run_max),
                          torch.exp(run_max - safe_new),
                          torch.zeros_like(run_max))
    run_sum = (run_sum * rescale
               + torch.exp(block_logits - safe_new[:, None]).sum(dim=-1))
    return new_max, run_sum


def blockwise_top_k_from_logits(logits: torch.Tensor, k: int,
                                block_cols: int
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of precomputed (B, V) logits streamed in column blocks."""
    b, v = logits.shape
    k = min(k, v)
    block_cols = max(1, min(int(block_cols), v))
    vals = torch.full((b, k), NEG_INF, dtype=logits.dtype,
                      device=logits.device)
    idx = torch.zeros((b, k), dtype=torch.int32, device=logits.device)
    for start in range(0, v, block_cols):
        stop = min(start + block_cols, v)
        ids = torch.arange(start, stop, dtype=torch.int32,
                           device=logits.device)
        vals, idx = _merge_top_k(vals, idx, logits[:, start:stop],
                                 ids[None, :].expand(b, stop - start), k)
    return vals, idx


def _as_compute(x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """Round to the compute dtype, then widen to f32 for an f32-accumulated
    product (exact products for bf16 operands)."""
    return x.to(compute_dtype).float()


def _table_as_compute(rows: torch.Tensor, compute_dtype: torch.dtype,
                      dim: int) -> torch.Tensor:
    """`dim`-value table rows of any format decoded to f32, then cast to
    the compute dtype, as the reference does; both steps are exact for
    int8, fp8 and int4 values."""
    return _as_compute(decode_rows(rows, dim), compute_dtype)


def blockwise_matmul_top_k(
    code_vectors: torch.Tensor,        # (B, D) f32
    target_table: torch.Tensor,        # (V, D) f32, or quantized + `scales`
                                       # (packed int4: (V, ceil(D/2)) uint8)
    k: int,
    block_rows: int,
    *,
    scales: Optional[torch.Tensor] = None,  # (V, 1) f32
    valid_rows: Optional[int] = None,       # ids >= this are padding
    compute_dtype: torch.dtype = torch.float32,
) -> BlockTopKOutputs:
    """Streaming `top_k(code_vectors @ target_table.T, k)` + logsumexp.

    The last window is clamped to the table end and its already-visited
    prefix masked to -inf, so no row is counted twice."""
    b, d = code_vectors.shape
    v = target_table.shape[0]
    k = min(k, v if valid_rows is None else valid_rows)
    block = max(1, min(int(block_rows), v))
    n_blocks = -(-v // block)
    dev = code_vectors.device
    cv = _as_compute(code_vectors, compute_dtype)
    vals = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    idx = torch.zeros((b, k), dtype=torch.int32, device=dev)
    run_max = torch.full((b,), NEG_INF, dtype=torch.float32, device=dev)
    run_sum = torch.zeros((b,), dtype=torch.float32, device=dev)
    for i in range(n_blocks):
        start = min(i * block, v - block)
        tbl = target_table[start:start + block]
        ids = torch.arange(start, start + block, dtype=torch.int32,
                           device=dev)
        logits = cv @ _table_as_compute(tbl, compute_dtype, d).T
        if scales is not None:
            logits = logits * scales[start:start + block, 0][None, :]
        live = ids >= i * block
        if valid_rows is not None:
            live &= ids < valid_rows
        logits = torch.where(live[None, :], logits,
                             torch.full_like(logits, NEG_INF))
        vals, idx = _merge_top_k(vals, idx, logits,
                                 ids[None, :].expand_as(logits), k)
        # the CE denominator gets the eval path's nonfinite guard; the
        # top-k above merged the raw logits
        lse_in = torch.where(live[None, :] & ~torch.isfinite(logits),
                             torch.full_like(logits, -1e30), logits)
        run_max, run_sum = _fold_lse(run_max, run_sum, lse_in)
    lse = torch.where(torch.isfinite(run_max),
                      torch.log(torch.clamp(run_sum, min=1e-30)) + run_max,
                      run_max)
    return BlockTopKOutputs(vals, idx, lse)


def gathered_label_logits(code_vectors: torch.Tensor,
                          target_table: torch.Tensor,
                          labels: torch.Tensor, *,
                          scales: Optional[torch.Tensor] = None,
                          compute_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """(B,) logit of each row's own label; a NaN/Inf logit, or a label
    outside the table (jnp.take fills NaN there), becomes -1e30."""
    v = target_table.shape[0]
    lab = labels.long()
    oob = (lab < 0) | (lab >= v)
    safe = torch.where(oob, torch.zeros_like(lab), lab)
    rows = target_table[safe]
    logits = (_as_compute(code_vectors, compute_dtype)
              * _table_as_compute(rows, compute_dtype,
                                  code_vectors.shape[-1])
              ).sum(dim=-1)
    if scales is not None:
        logits = logits * scales[safe, 0]
    logits = torch.where(oob, torch.full_like(logits, float("nan")), logits)
    return torch.where(torch.isfinite(logits), logits,
                       torch.full_like(logits, -1e30))
