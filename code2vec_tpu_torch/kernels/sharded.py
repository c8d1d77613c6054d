"""K14 shard_gather / shard_scatter_add / shard_local_ids and K15
tp_softmax_xent: the tensor-parallel device functions of the parallel
steps, each a phase between two collectives.

K14 replaces code2vec_tpu/ops/sharded.py tp_embedding_lookup (:32-47)
before its psum, its transpose in the dense step, and the sparse step's
`to_local` (code2vec_tpu/training/step.py:453-459); K15 replaces
tp_softmax_ce (:59-84) and tp_log_softmax_at_topk (:87-94) and the
gradient of tp_softmax_ce, as two passes around one collective over
`model`: the stats pass (each row's max, sum of exp and label logit
over this rank's columns), an all-gather of those (3, b) triples merged
in rank order (`merge_xent_stats`), and the gradient pass. The CUDA
source is csrc/sharded.cu; its header gives the arithmetic, what bounds
each on an H100 and the design. The `*_plain` functions below are the
same in plain PyTorch: CPU tensors take them, CUDA tensors launch the
kernels. A rank holds rows [offset, offset + rows_local) of a table, and
columns [offset, offset + n_cols) of the logits, of which the first
n_valid are real target rows (`valid_columns`).

`merge_softmax_stats` is the rank-order merge of (max, sum of exp) pairs
that K15 and K16 (kernels/cp_attention.py) share: plain PyTorch on the
gathered (ranks, b) pairs, one function on either device, so every rank
of a group gets the same bits.

Each wrapper adds one to its counter where it launches: `launches`
(K14's gather), `scatter_launches`, `local_ids_launches`, and
`xent_launches` for each of K15's two passes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from code2vec_tpu_torch.kernels import launch

launches = 0            # K14 shard_gather
scatter_launches = 0    # K14 shard_scatter_add
local_ids_launches = 0  # K14 shard_local_ids
xent_launches = 0       # K15, each pass (stats, gradient)
_fns = {}
FLOOR = -1e30  # the eval step's stand-in for a non-finite logit


def valid_columns(n_cols: int, offset: int, n_real: int) -> int:
    """How many of a rank's n_cols logit columns, starting at global
    column `offset`, are real target rows (below n_real)."""
    return int(min(max(n_real - offset, 0), n_cols))


def _local(ids: torch.Tensor, offset: int, rows_local: int):
    local = ids.reshape(-1).long() - int(offset)
    return local, (local >= 0) & (local < rows_local)


# ------------------------------------------------------- plain versions


def shard_gather_plain(table: torch.Tensor, ids: torch.Tensor, offset: int,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    rows_local = table.shape[0]
    local, ok = _local(ids, offset, rows_local)
    rows = table[local.clamp(0, rows_local - 1)].float()
    rows = torch.where(ok[:, None], rows, torch.zeros_like(rows))
    if out is None:
        return rows
    return out.copy_(rows)


def shard_scatter_add_plain(grad: torch.Tensor, ids: torch.Tensor,
                            rows: torch.Tensor, offset: int) -> None:
    local, ok = _local(ids, offset, grad.shape[0])
    grad.index_add_(0, local[ok],
                    rows.reshape(-1, grad.shape[1])[ok].float())


def shard_local_ids_plain(ids: torch.Tensor, offset: int,
                          rows_local: int) -> torch.Tensor:
    local, ok = _local(ids, offset, rows_local)
    return torch.where(ok, local, torch.full_like(local, rows_local)).to(
        torch.int32)


def xent_values(logits: torch.Tensor, n_cols: int, n_valid: int,
                floor: bool) -> torch.Tensor:
    """The (b, n_cols) f32 values K15's stats pass reads (csrc/sharded.cu
    `read_value`): padded columns -inf, or in floor mode -1e30 like every
    non-finite logit."""
    x = logits[:, :n_cols].float()
    if floor:
        x = torch.where(torch.isfinite(x), x, torch.full_like(x, FLOOR))
    pad = torch.arange(n_cols, device=x.device) >= n_valid
    return torch.where(pad[None, :], torch.full_like(
        x, FLOOR if floor else float("-inf")), x)


def _safe(m: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def tp_xent_stats_plain(logits, n_cols, n_valid, labels, offset,
                        floor=False):
    x = xent_values(logits, n_cols, n_valid, floor)
    lm = x.amax(dim=1)
    ls = torch.exp(x - _safe(lm)[:, None]).sum(dim=1)
    lab = labels.long() - int(offset)
    ok = (lab >= 0) & (lab < n_cols)
    ll = x.gather(1, lab.clamp(0, n_cols - 1)[:, None])[:, 0]
    return torch.stack([lm, ls, torch.where(ok, ll, torch.zeros_like(ll))])


def merge_softmax_stats(lm: torch.Tensor, ls: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global (max M, sum S of exp(x - M)) of each column of
    (ranks, b) per-rank pairs (ls_r the sum of exp(x - lm_r) over rank
    r's part), added in rank order 0..ranks-1: S = sum_r ls_r exp(lm_r -
    M). A non-finite max is taken as 0 inside exp, as the kernels do, and
    a rank with a sum of 0 (nothing but -inf) adds 0. One rank gives its
    own pair back, bit for bit."""
    gmax = lm.amax(dim=0)
    terms = ls * torch.exp(_safe(lm) - _safe(gmax)[None, :])
    terms = torch.where(ls == 0, torch.zeros_like(terms), terms)
    gsum = terms[0]
    for r in range(1, terms.shape[0]):
        gsum = gsum + terms[r]
    return gmax, gsum


def merge_xent_stats(parts: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K15's stats of every model rank, (ranks, 3, b) in rank order (the
    all-gather's), merged: each row's global (max, sum of exp(x - max),
    label logit), (b,) f32 each. The label lies in one rank's columns;
    the others give 0, added in rank order."""
    gmax, gsum = merge_softmax_stats(parts[:, 0], parts[:, 1])
    label = parts[0, 2]
    for r in range(1, parts.shape[0]):
        label = label + parts[r, 2]
    return gmax, gsum, label


def inv_count(count: int) -> float:
    """1 / count as f32, as K7 scales its gradient."""
    return float(np.float32(1.0) / np.float32(count))


def tp_xent_grad_plain(logits, n_valid, gmax, gsum, labels, valid, offset,
                       count, grad_dtype=torch.bfloat16):
    b, ld = logits.shape
    x = logits[:, :n_valid].float()
    e = torch.exp(x - _safe(gmax)[:, None])
    scale = valid.float() * inv_count(count)
    g = (e / gsum[:, None]) * scale[:, None]
    lab = labels.long() - int(offset)
    rows = torch.nonzero((lab >= 0) & (lab < n_valid))[:, 0]
    g[rows, lab[rows]] = g[rows, lab[rows]] - scale[rows]
    if grad_dtype == torch.float32:
        grad = torch.zeros((b, ld), dtype=torch.float32, device=x.device)
        grad[:, :n_valid] = g
        return grad
    grad = torch.zeros((2, b, ld), dtype=grad_dtype, device=x.device)
    hi = g.to(grad_dtype)
    grad[0, :, :n_valid] = hi
    grad[1, :, :n_valid] = (g - hi.float()).to(grad_dtype)
    return grad


# ------------------------------------------------------------- wrappers


def _fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        P, I32, I64, F32 = launch.P, launch.I32, launch.I64, launch.F32
        args = {
            "c2v_shard_gather": [P, I64, I32, P, I64, I64, P, P],
            "c2v_shard_scatter_add": [P, I64, I32, P, I64, I64, P, I32, P],
            "c2v_shard_local_ids": [P, I64, I64, I64, P, P],
            "c2v_tp_xent_stats": [P, I32, I64, I64, I64, I32, P, I64, P,
                                  P],
            "c2v_tp_xent_grad": [P, I32, I64, I64, P, P, P, P, I64, F32, P,
                                 P],
        }[name]
        fn = _fns[name] = launch.bind("sharded", name, args)
    return fn


def _ids(ids: torch.Tensor) -> torch.Tensor:
    launch.check_tensor(ids, "ids", [torch.int32], ids.dim())
    return ids.reshape(-1)


def shard_gather(table: torch.Tensor, ids: torch.Tensor, offset: int,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The rows of global `ids` (any shape, int32) of a table whose rows
    [offset, offset + rows_local) this rank holds: (n, d) f32, zeros for
    the ids outside them; written into `out` where given."""
    if launch.runs_plain(table, ids, out):
        return shard_gather_plain(table, ids, offset, out)
    fn = _fn("c2v_shard_gather")
    launch.check_tensor(table, "table", [torch.float32], 2, align=16)
    flat = _ids(ids)
    n, d = flat.shape[0], table.shape[1]
    if out is None:
        out = torch.empty((n, d), dtype=torch.float32, device=table.device)
    launch.check_tensor(out, "out", [torch.float32], 2, align=16)
    launch.require(tuple(out.shape) == (n, d), f"out: expected ({n}, {d})")
    err = fn(table.data_ptr(), table.shape[0], d, flat.data_ptr(), n,
             int(offset), out.data_ptr(), launch.stream(table.device))
    launch.check_launch(err, "shard_gather")
    launch.count(__name__)
    return out


def shard_scatter_add(grad: torch.Tensor, ids: torch.Tensor,
                      rows: torch.Tensor, offset: int) -> None:
    """grad[id - offset] += rows, in place, for the ids in this rank's
    rows; `rows` (n, d) f32 or bf16 in the order of ids' elements."""
    if launch.runs_plain(grad, ids, rows):
        return shard_scatter_add_plain(grad, ids, rows, offset)
    fn = _fn("c2v_shard_scatter_add")
    launch.check_tensor(grad, "grad", [torch.float32], 2)
    flat = _ids(ids)
    n, d = flat.shape[0], grad.shape[1]
    launch.require(rows.is_contiguous() and rows.numel() == n * d
                   and rows.dtype in (torch.float32, torch.bfloat16),
                   f"rows: expected {n} x {d} contiguous f32 or bf16")
    err = fn(grad.data_ptr(), grad.shape[0], d, flat.data_ptr(), n,
             int(offset), rows.data_ptr(), int(rows.dtype == torch.bfloat16),
             launch.stream(grad.device))
    launch.check_launch(err, "shard_scatter_add")
    launch.count(__name__, "scatter_launches")


def shard_local_ids(ids: torch.Tensor, offset: int,
                    rows_local: int) -> torch.Tensor:
    """ids - offset where in [0, rows_local), else rows_local (the id the
    sparse update drops), int32 (n,)."""
    if launch.runs_plain(ids):
        return shard_local_ids_plain(ids, offset, rows_local)
    fn = _fn("c2v_shard_local_ids")
    flat = _ids(ids)
    out = torch.empty_like(flat)
    err = fn(flat.data_ptr(), flat.shape[0], int(offset), int(rows_local),
             out.data_ptr(), launch.stream(ids.device))
    launch.check_launch(err, "shard_local_ids")
    launch.count(__name__, "local_ids_launches")
    return out


def _check_logits(logits, n_cols, n_valid):
    launch.check_tensor(logits, "logits", [torch.float32], 2)
    launch.require(0 < n_cols <= logits.shape[1] and 0 <= n_valid <= n_cols,
                   f"n_cols {n_cols}, n_valid {n_valid} outside the "
                   f"{logits.shape[1]} columns")


def tp_xent_stats(logits: torch.Tensor, n_cols: int, n_valid: int,
                  labels: torch.Tensor, offset: int,
                  floor: bool = False) -> torch.Tensor:
    """K15's stats pass: (3, b) f32, each row's max over this rank's
    columns, its sum of exp(x - that max), and its label's logit where
    the label is one of them (0 elsewhere): one buffer for one
    all-gather."""
    if launch.runs_plain(logits, labels):
        return tp_xent_stats_plain(logits, n_cols, n_valid, labels, offset,
                                   floor)
    fn = _fn("c2v_tp_xent_stats")
    _check_logits(logits, n_cols, n_valid)
    b, ld = logits.shape
    launch.check_tensor(labels, "labels", [torch.int32], 1)
    launch.require(labels.shape[0] == b, f"labels: expected ({b},)")
    out = torch.empty((3, b), dtype=torch.float32, device=logits.device)
    err = fn(logits.data_ptr(), b, ld, n_cols, n_valid, int(floor),
             labels.data_ptr(), int(offset), out.data_ptr(),
             launch.stream(logits.device))
    launch.check_launch(err, "tp_xent_stats")
    launch.count(__name__, "xent_launches")
    return out


def tp_xent_grad(logits: torch.Tensor, n_valid: int, gmax: torch.Tensor,
                 gsum: torch.Tensor, labels: torch.Tensor,
                 valid: torch.Tensor, offset: int, count: int,
                 grad_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """K15's gradient pass: d loss / d logits of this rank's (b, ld)
    logits (16-byte aligned on the card), (exp(x - gmax) / gsum - onehot)
    * valid / count from the merged stats, as K7 writes it: two bf16
    planes (2, b, ld) (f32 (b, ld) for grad_dtype float32, the plain
    version's), zero past n_valid."""
    if launch.runs_plain(logits, gmax, gsum, labels, valid):
        return tp_xent_grad_plain(logits, n_valid, gmax, gsum, labels,
                                  valid, offset, count, grad_dtype)
    fn = _fn("c2v_tp_xent_grad")
    launch.check_tensor(logits, "logits", [torch.float32], 2, align=16)
    b, ld = logits.shape
    launch.require(0 <= n_valid <= ld, f"n_valid {n_valid} outside {ld}")
    launch.require(grad_dtype == torch.bfloat16,
                   f"tp_xent_grad writes bfloat16 hi/lo planes, not "
                   f"{grad_dtype}")
    for name, t in (("gmax", gmax), ("gsum", gsum), ("valid", valid)):
        launch.check_tensor(t, name, [torch.float32], 1)
        launch.require(t.shape[0] == b, f"{name}: expected ({b},)")
    launch.check_tensor(labels, "labels", [torch.int32], 1)
    planes = torch.empty((2, b, ld), dtype=torch.bfloat16,
                         device=logits.device)
    err = fn(logits.data_ptr(), b, ld, n_valid, gmax.data_ptr(),
             gsum.data_ptr(), labels.data_ptr(), valid.data_ptr(),
             int(offset), inv_count(count), planes.data_ptr(),
             launch.stream(logits.device))
    launch.check_launch(err, "tp_xent_grad")
    launch.count(__name__, "xent_launches")
    return planes
