"""The tensor-parallel device functions, over a communicator of the
mesh's `model` axis.

The counterpart of code2vec_tpu/ops/sharded.py, with the communicator
(parallel/comm.py) where the reference takes `axis_name`; the rank's
shard number is the communicator's `index`. The three tables are
row-split over `model`, so a rank holds rows [index * rows_local, ...)
of a table and columns [index * n_cols, ...) of the logits:

- `tp_embedding_lookup`: K14's masked local gather, then a SUM over the
  group;
- `tp_logits`: the local (B, V/tp) logits, a plain product left to the
  library as the single-device step leaves its classifier;
- `tp_softmax_ce` / `tp_softmax_stats`: K15's stats pass, one
  all-gather of its (3, b) triples, merged in rank order: the global
  (max, sum of exp, label logit) of each row without the full logits on
  one rank, the same bits on every rank;
- `tp_log_softmax_at_topk`: the global (max, logsumexp) from the same
  pass and gather;
- `tp_top_k`: K13 over the local logits, the shard's offset, an
  all-gather, K13's merge of the tp * k candidates as gathered.

The logits may carry columns past `n_cols` (a row stride padded for K13)
and padded target columns past `n_valid` (-inf to the passes, or -1e30
with `floor`, as the reference's eval step substitutes).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from code2vec_tpu_torch.kernels.select import (
    merge_topk, padded_width, select_topk,
)
from code2vec_tpu_torch.kernels.sharded import (
    merge_xent_stats, shard_gather, tp_xent_stats,
)
from code2vec_tpu_torch.models.code2vec import matmul_f32


def tp_embedding_lookup(table_shard: torch.Tensor, ids: torch.Tensor,
                        comm) -> torch.Tensor:
    """Rows of a row-sharded table by global ids: (*ids.shape, d) f32."""
    rows = shard_gather(table_shard, ids,
                        comm.index * table_shard.shape[0])
    comm.all_reduce(rows)
    return rows.view(*ids.shape, table_shard.shape[1])


def tp_logits(code_vectors: torch.Tensor, target_table_shard: torch.Tensor,
              compute_dtype: torch.dtype = torch.bfloat16,
              ld: Optional[int] = None) -> torch.Tensor:
    """The local logits (B, V/tp) f32 from compute-dtype operands; with
    `ld`, (B, ld), the columns past V/tp 0 (a padded row stride)."""
    cd = compute_dtype
    tgt = target_table_shard.to(cd)
    v = tgt.shape[0]
    if ld is not None and ld > v:
        padded = torch.zeros((ld, tgt.shape[1]), dtype=cd,
                             device=tgt.device)
        padded[:v] = tgt
        tgt = padded
    return matmul_f32(code_vectors.to(cd), tgt.T)


def _cols(local_logits, n_cols, n_valid):
    n_cols = local_logits.shape[1] if n_cols is None else int(n_cols)
    return n_cols, n_cols if n_valid is None else int(n_valid)


def tp_softmax_stats(local_logits: torch.Tensor, labels: torch.Tensor,
                     comm, n_cols: Optional[int] = None,
                     n_valid: Optional[int] = None, floor: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each row's global (max, sum of exp(x - max), label logit), (B,) f32
    each, the same bits on every rank of the group."""
    n_cols, n_valid = _cols(local_logits, n_cols, n_valid)
    stats = tp_xent_stats(local_logits, n_cols, n_valid, labels,
                          comm.index * n_cols, floor)
    parts = comm.all_gather(stats).view(comm.size, 3, -1)
    return merge_xent_stats(parts)


def tp_softmax_ce(local_logits: torch.Tensor, labels: torch.Tensor, comm,
                  n_cols: Optional[int] = None,
                  n_valid: Optional[int] = None,
                  floor: bool = False) -> torch.Tensor:
    """Sparse softmax cross-entropy over row-sharded logits: (B,) f32,
    log(sum exp) + max - the label's logit, as the reference."""
    gmax, gsum, label_logit = tp_softmax_stats(local_logits, labels, comm,
                                               n_cols, n_valid, floor)
    return torch.log(gsum) + gmax - label_logit


def tp_log_softmax_at_topk(local_logits: torch.Tensor, comm,
                           n_cols: Optional[int] = None,
                           n_valid: Optional[int] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's global (max, logsumexp), for normalising scores of
    sharded logits (the labels play no part)."""
    labels = torch.zeros(local_logits.shape[0], dtype=torch.int32,
                         device=local_logits.device)
    gmax, gsum, _ = tp_softmax_stats(local_logits, labels, comm, n_cols,
                                     n_valid)
    return gmax, torch.log(gsum) + gmax


def _stride4(x: torch.Tensor, n: int, fill: float) -> torch.Tensor:
    """x's first n columns in rows of a stride K13 reads (a multiple of
    4), copied only where x's own stride is not one."""
    if x.shape[1] % 4 == 0 and x.is_contiguous():
        return x
    out = torch.full((x.shape[0], padded_width(n)), fill, dtype=x.dtype,
                     device=x.device)
    out[:, :n] = x[:, :n]
    return out


def tp_top_k(local_logits: torch.Tensor, k: int, comm,
             n_cols: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over row-sharded logits -> (values (B, k) f32, global ids
    (B, k) int32), in lax.top_k's order (equal values by ascending id,
    which the merge's rank-major order keeps). Padded target columns
    must already hold -inf, as the reference's caller masks them."""
    n_cols, _ = _cols(local_logits, n_cols, None)
    b = local_logits.shape[0]
    k_local = min(int(k), n_cols)
    values, pos = select_topk(_stride4(local_logits, n_cols,
                                       float("-inf")), k_local, n_cols)
    ids = pos + comm.index * n_cols
    if comm.size == 1:
        return values, ids
    all_values = comm.all_gather(values).view(comm.size, b, k_local)
    all_ids = comm.all_gather(ids).view(comm.size, b, k_local)
    return merge_topk(all_values, all_ids, int(k))
