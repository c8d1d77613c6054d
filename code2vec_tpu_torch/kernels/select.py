"""K13 select_topk: the top k of each row of an f32 score matrix, for any
k up to the row's length.

The large-k mode of K3 (kernels/topk.py) and K11 (kernels/ivf.py): past
the 64 entries their shared-memory lists hold, they write every
candidate's score and this kernel selects the top k (radix select,
compaction in position order, a bitonic sort of the winners). The order
is `lax.top_k`'s: NaN first, then values descending, equal values by
ascending position. The CUDA source is csrc/select.cu, which says what
bounds it on an H100 and how its design answers that.
`select_topk_plain` below is the same function in plain PyTorch (a
stable descending sort): CPU tensors take it, CUDA tensors launch the
kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from code2vec_tpu_torch.kernels import launch

launches = 0
_fns = {}


def top_positions(scores: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`lax.top_k` of each row: values descending, NaN first, equal
    values by ascending position (a stable descending sort)."""
    vals, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], pos[:, :k]


def select_topk_plain(scores: torch.Tensor, k: int,
                      n: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    n = scores.shape[1] if n is None else int(n)
    vals, pos = top_positions(scores[:, :n], k)
    return vals, pos.to(torch.int32)


def _fn():
    fn = _fns.get("select")
    if fn is None:
        P, I32, I64 = launch.P, launch.I32, launch.I64
        fn = _fns["select"] = launch.bind(
            "select", "c2v_select_topk",
            [P, I32, I64, I32, I32, I32, P, P, P, P])
        _fns["smem_entries"] = launch.bind(
            "select", "c2v_select_smem_entries", [])
    return fn


def padded_width(n: int) -> int:
    """The row stride the kernel reads: `n` rounded up to 4 floats, so
    every row starts 16-byte aligned."""
    return -(-int(n) // 4) * 4


def select_topk(scores: torch.Tensor, k: int, n: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k (values (B, k) f32, positions (B, k) int32) of the first `n`
    columns (all by default) of each row of `scores` (B, ld) f32, 1 <= k
    <= n. The kernel takes a row stride ld that is a multiple of 4
    (`padded_width`)."""
    if launch.runs_plain(scores):
        return select_topk_plain(scores, k, n)
    fn = _fn()  # builds the library first: raises where nvcc is missing
    launch.check_tensor(scores, "scores", [torch.float32], 2, align=16)
    rows, ld = scores.shape
    n = ld if n is None else int(n)
    k = int(k)
    launch.require(ld % 4 == 0, f"scores: row stride {ld} is not a "
                                f"multiple of 4 (padded_width)")
    launch.require(0 < n <= ld and n < 2 ** 31 - 1,
                   f"n={n} outside 1..{ld}")
    launch.require(1 <= k <= n, f"k={k} outside 1..{n}")
    launch.require(rows < 2 ** 31, "more than 2^31 rows")
    sort_len = max(2, 1 << (k - 1).bit_length())
    device = scores.device
    scratch = None
    if sort_len > _fns["smem_entries"]():
        scratch = torch.empty((rows, sort_len), dtype=torch.int64,
                              device=device)
    values = torch.empty((rows, k), dtype=torch.float32, device=device)
    positions = torch.empty((rows, k), dtype=torch.int32, device=device)
    err = fn(scores.data_ptr(), rows, ld, n, k, sort_len,
             launch.ptr(scratch), values.data_ptr(), positions.data_ptr(),
             launch.stream(device))
    launch.check_launch(err, "select_topk")
    launch.count(__name__)
    return values, positions
