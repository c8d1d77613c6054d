"""K11 ivf_search: the probe and candidate scan of an IVF index.

One kernel, two instantiations: f32 rows (replaces code2vec_tpu/
retrieval/index.py `NeighborIndex._search_ivf` :319-349) and int8 rows
with per-row f32 scales (replaces code2vec_tpu/retrieval/mips.py
`MipsHead.topk_fn` :139-188, whose score is (cv . float(row)) * scale).
Per query: the inner product with every centroid, the top `nprobe` lists
(ties to the lowest centroid index), every row of those lists scored in
f32, and the top k with ties broken by candidate position (probe rank,
then offset in the list), as `lax.top_k` orders the reference's padded
candidate array. Dead slots: position -1 (index) or global id 0 (MIPS,
`global_ids` given), value -inf. The CUDA source is csrc/ivf_search.cu,
which says what bounds it on an H100 and how its design answers that.

The lists are contiguous rows [list_offsets[c], list_offsets[c + 1]) of
`rows`; the kernel walks them through the offsets, while the plain
version below gathers from a padded (nlist, max_len) list matrix as the
reference does (take + einsum + a stable top-k). CPU tensors take the
plain version, CUDA tensors launch the kernel. Each instantiation keeps
its own count: `launches` (f32 rows) and `int8_launches`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from code2vec_tpu_torch.kernels import launch

launches = 0       # f32 rows
int8_launches = 0  # int8 rows with scales
_fns = {}
MAX_K = 64    # the kernel's compiled maximum (csrc/ivf_search.cu kMaxK)
MAX_D = 512   # the widest row a lane's registers hold (4 x 128)


def padded_lists(list_offsets: torch.Tensor, max_len: int) -> torch.Tensor:
    """(nlist, max_len) int64 matrix of member positions, -1 padded (the
    reference's `_padded_lists`)."""
    lo = list_offsets[:-1]
    lens = list_offsets[1:] - lo
    j = torch.arange(max(int(max_len), 1), device=list_offsets.device)
    return torch.where(j[None, :] < lens[:, None], lo[:, None] + j[None, :],
                       torch.full_like(j[None, :], -1))


def top_positions(scores: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`lax.top_k` of each row: values descending, NaN first, equal
    values by ascending position (a stable descending sort)."""
    vals, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], pos[:, :k]


def ivf_search_plain(queries: torch.Tensor, centroids: torch.Tensor,
                     rows: torch.Tensor, list_offsets: torch.Tensor,
                     nprobe: int, k: int, *,
                     scales: Optional[torch.Tensor] = None,
                     global_ids: Optional[torch.Tensor] = None,
                     max_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    b = queries.shape[0]
    offsets = list_offsets.long()
    _, probe = top_positions(queries @ centroids.T, nprobe)
    cand = padded_lists(offsets, max_len)[probe].reshape(b, -1)
    live = cand >= 0
    safe = torch.clamp(cand, min=0)
    scores = torch.einsum("bd,bpd->bp", queries, rows[safe].float())
    if scales is not None:
        scores = scores * scales.reshape(-1)[safe]
    scores = torch.where(live, scores, torch.full_like(scores, -torch.inf))
    kk = min(k, scores.shape[1])
    vals, pos = top_positions(scores, kk)
    idx = torch.gather(cand, 1, pos)
    if global_ids is not None:
        idx = torch.where(idx >= 0, global_ids.long()[torch.clamp(idx, min=0)],
                          torch.zeros_like(idx))
    if kk < k:
        vals = torch.nn.functional.pad(vals, (0, k - kk), value=-torch.inf)
        idx = torch.nn.functional.pad(
            idx, (0, k - kk), value=0 if global_ids is not None else -1)
    return vals, idx.to(torch.int32)


def _fn():
    fn = _fns.get("ivf")
    if fn is None:
        P, I32 = launch.P, launch.I32
        fn = _fns["ivf"] = launch.bind(
            "ivf_search", "c2v_ivf_search",
            [P, I32, I32, P, I32, P, P, I32, P, I32, P, I32, I32, P, P, P, P,
             P, P])
    return fn


def ivf_search(queries: torch.Tensor, centroids: torch.Tensor,
               rows: torch.Tensor, list_offsets: torch.Tensor, nprobe: int,
               k: int, *, scales: Optional[torch.Tensor] = None,
               global_ids: Optional[torch.Tensor] = None,
               max_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k (values (B, k) f32, indices (B, k) int32) over the rows of
    the `nprobe` lists nearest each query. Indices are positions into
    `rows`, or `global_ids` of them when given. `max_len` is the longest
    list."""
    if launch.runs_plain(queries, centroids, rows, list_offsets, scales,
                         global_ids):
        return ivf_search_plain(queries, centroids, rows, list_offsets,
                                nprobe, k, scales=scales,
                                global_ids=global_ids, max_len=max_len)
    fn = _fn()  # builds the library first: raises where nvcc is missing
    launch.check_tensor(queries, "queries", [torch.float32], 2, align=16)
    launch.check_tensor(centroids, "centroids", [torch.float32], 2, align=16)
    int8 = rows.dtype == torch.int8
    launch.check_tensor(rows, "rows", [torch.int8] if int8 else
                        [torch.float32], 2, align=16)
    launch.check_tensor(list_offsets, "list_offsets", [torch.int64], 1)
    b, d = queries.shape
    n_cent = centroids.shape[0]
    launch.require(d % 4 == 0 and d <= MAX_D,
                   f"width {d} is not a multiple of 4 up to {MAX_D}")
    launch.require(centroids.shape[1] == d and rows.shape[1] == d,
                   f"centroids and rows must be {d} wide")
    launch.require(list_offsets.shape[0] == n_cent + 1,
                   f"list_offsets: expected ({n_cent + 1},)")
    launch.require(rows.shape[0] < 2 ** 31, "more than 2^31 rows")
    if int8:
        launch.require(scales is not None, "int8 rows need scales")
        launch.check_tensor(scales, "scales", [torch.float32], scales.dim())
        launch.require(scales.numel() == rows.shape[0],
                       f"scales: expected {rows.shape[0]} values")
    else:
        launch.require(scales is None, "f32 rows take no scales")
    if global_ids is not None:
        launch.check_tensor(global_ids, "global_ids", [torch.int32], 1)
        launch.require(global_ids.shape[0] == rows.shape[0],
                       f"global_ids: expected ({rows.shape[0]},)")
    launch.require(1 <= nprobe <= n_cent,
                   f"nprobe={nprobe} outside 1..{n_cent}")
    launch.require(1 <= k <= MAX_K,
                   f"k={k} outside the kernel's range 1..{MAX_K}")
    max_len = max(int(max_len), 1)
    launch.require(nprobe * max_len < 2 ** 31 - 1,
                   "nprobe x longest list must stay below 2^31")
    device = queries.device
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    probe = torch.empty((b, nprobe), **i32)
    part_vals = torch.empty((b, nprobe, k), **f32)
    part_keys = torch.empty((b, nprobe, k), **i32)
    values = torch.empty((b, k), **f32)
    indices = torch.empty((b, k), **i32)
    err = fn(queries.data_ptr(), b, d, centroids.data_ptr(), n_cent,
             rows.data_ptr(), launch.ptr(scales), int(int8),
             list_offsets.data_ptr(), max_len, launch.ptr(global_ids),
             nprobe, k, probe.data_ptr(), part_vals.data_ptr(),
             part_keys.data_ptr(), values.data_ptr(), indices.data_ptr(),
             launch.stream(device))
    launch.check_launch(err, "ivf_search")
    launch.count(__name__, "int8_launches" if int8 else "launches")
    return values, indices
