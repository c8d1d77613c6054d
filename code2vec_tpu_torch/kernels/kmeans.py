"""K9 kmeans_assign and K10 kmeans_update: one Lloyd step of k-means.

K9 replaces code2vec_tpu/retrieval/index.py `_assign_jax` (:117-122),
the nearest centroid of every row by argmin(|c|^2 - 2 x.c) with ties to
the lowest index; K10 the update of `train_kmeans.lloyd` (:96-111), the
mean of each cluster's rows, the old centroid where a cluster is empty,
and the spherical renormalisation. Both carry float32's precision (a
flipped assignment moves a row to another list): K9 by 3xTF32 on the
tensor cores (each operand split into tf32 hi and lo parts;
`kmeans_assign_3xtf32` is that arithmetic in plain PyTorch, for tests),
K10 in f32. The CUDA source is csrc/kmeans.cu, which says what bounds
each kernel on an H100 and how its design answers that; K10 is
deterministic (a stable counting sort, then fixed-order sums), so two
runs give the same bits. K9 takes widths in multiples of 4 (its tensor
copies of x move whole 16-byte units).

CPU tensors take the plain versions below (matmul + argmin; index_add_
+ where), CUDA tensors launch the kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from code2vec_tpu_torch.kernels import launch, tf32

launches = 0         # K9
update_launches = 0  # K10
_fns = {}
TILE_ROWS = 1024     # rows per counting-sort tile (csrc/kmeans.cu)
MAX_UPDATE_D = 1024  # widest row K10 takes (4 groups of d / 4 threads)
PLAIN_CHUNK_ROWS = 65536  # rows per (rows, C) distance block of the plain K9
ASSIGN_ROWS = 128    # rows of x a K9 CTA holds (csrc/kmeans.cu kAssignRows)
CENTROID_TILE = 128  # centroids per K9 tile, wgmma's N (kCentTile)
K_BLOCK = 32         # K9's depth per ring stage (a tf32 block)


class AssignPlan(NamedTuple):
    centroid_tiles: int  # tiles of CENTROID_TILE centroids
    dead_columns: int    # padded centroid columns of the last tile
    k_blocks: int        # 32-wide K blocks of a row
    row_tiles: int       # tiles of ASSIGN_ROWS rows
    grid: int            # persistent CTAs


def assign_plan(n: int, d: int, n_cent: int, sms: int) -> AssignPlan:
    """How K9 covers n rows and n_cent centroids of width d on `sms` SMs."""
    tiles = -(-n_cent // CENTROID_TILE)
    k_blocks = -(-d // K_BLOCK)
    row_tiles = -(-n // ASSIGN_ROWS)
    return AssignPlan(tiles, tiles * CENTROID_TILE - n_cent, k_blocks,
                      row_tiles, min(row_tiles, sms))


def kmeans_assign_3xtf32(x: torch.Tensor, centroids: torch.Tensor,
                         sms: int = 132) -> torch.Tensor:
    """K9's arithmetic in plain PyTorch (tests only): the centroids padded
    with zero rows to whole tiles, x.c by 3xTF32 (kernels/tf32.py),
    |c|^2 - 2 x.c with the padded columns dead, the first minimum."""
    n, d = x.shape
    c = centroids.shape[0]
    p = assign_plan(n, d, c, sms)
    padded = torch.zeros((c + p.dead_columns, d), dtype=torch.float32,
                         device=x.device)
    padded[:c] = centroids
    cn = (centroids * centroids).sum(dim=1)
    dist = torch.full((n, c + p.dead_columns), float("inf"),
                      device=x.device)
    dist[:, :c] = cn[None, :] - 2.0 * tf32.matmul_3xtf32(x, padded)[:, :c]
    return torch.argmin(dist, dim=1).to(torch.int32)


def kmeans_assign_plain(x: torch.Tensor, centroids: torch.Tensor
                        ) -> torch.Tensor:
    """(N,) int32 nearest centroid by |c|^2 - 2 x.c; torch.argmin gives
    the first of equal minima, as jnp.argmin does. Rows go in chunks so
    the (rows, C) distances stay small."""
    cn = (centroids * centroids).sum(dim=1)
    out = torch.empty((x.shape[0],), dtype=torch.int32, device=x.device)
    for lo in range(0, x.shape[0], PLAIN_CHUNK_ROWS):
        hi = lo + PLAIN_CHUNK_ROWS
        d = cn[None, :] - 2.0 * (x[lo:hi] @ centroids.T)
        out[lo:hi] = torch.argmin(d, dim=1).to(torch.int32)
    return out


def kmeans_update_plain(x: torch.Tensor, assign: torch.Tensor,
                        centroids: torch.Tensor,
                        spherical: bool = False) -> torch.Tensor:
    """The mean of each cluster's rows; empty clusters keep their old
    centroid; `spherical` renormalises the means (1e-12 guard)."""
    c = centroids.shape[0]
    idx = assign.long()
    sums = torch.zeros_like(centroids).index_add_(0, idx, x)
    counts = torch.zeros((c,), dtype=x.dtype, device=x.device).index_add_(
        0, idx, torch.ones_like(idx, dtype=x.dtype))
    fresh = sums / torch.clamp(counts, min=1.0)[:, None]
    if spherical:
        fresh = fresh / torch.clamp(
            torch.linalg.vector_norm(fresh, dim=1, keepdim=True), min=1e-12)
    return torch.where((counts > 0)[:, None], fresh, centroids)


def _assign_fn():
    fn = _fns.get("assign")
    if fn is None:
        P, I32, I64 = launch.P, launch.I32, launch.I64
        fn = _fns["assign"] = launch.bind(
            "kmeans", "c2v_kmeans_assign",
            [P, I64, I32, P, I32, P, P, I32, P, P])
    return fn


def _tile_bytes_fn():
    fn = _fns.get("tile_bytes")
    if fn is None:
        I32 = launch.I32
        fn = _fns["tile_bytes"] = launch.bind(
            "kmeans", "c2v_kmeans_tile_bytes", [I32, I32],
            restype=launch.I64)
    return fn


def _update_fn():
    fn = _fns.get("update")
    if fn is None:
        P, I32, I64 = launch.P, launch.I32, launch.I64
        fn = _fns["update"] = launch.bind(
            "kmeans", "c2v_kmeans_update",
            [P, I64, I32, P, P, I32, I32, P, P, P, P, P, P])
    return fn


def _check_rows(x: torch.Tensor, centroids: torch.Tensor) -> None:
    launch.check_tensor(x, "x", [torch.float32], 2, align=16)
    launch.check_tensor(centroids, "centroids", [torch.float32], 2, align=16)
    launch.require(x.shape[0] > 0 and centroids.shape[0] > 0,
                   "kmeans: empty rows or centroids")
    launch.require(centroids.shape[1] == x.shape[1],
                   f"centroids: expected {x.shape[1]} columns")
    launch.require(x.shape[0] < 2 ** 31 and centroids.shape[0] < 2 ** 31,
                   "kmeans: more than 2^31 rows")


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """(N,) int32 index of each row's nearest centroid, ties to the lowest
    index."""
    if launch.runs_plain(x, centroids):
        return kmeans_assign_plain(x, centroids)
    fn = _assign_fn()  # builds the library first: raises where nvcc is missing
    _check_rows(x, centroids)
    n, d = x.shape
    launch.require(d % 4 == 0,
                   f"kmeans_assign takes widths in multiples of 4, not {d}")
    device = x.device
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    norms = torch.empty((centroids.shape[0],), dtype=torch.float32,
                        device=device)
    tiles = torch.empty((_tile_bytes_fn()(centroids.shape[0], d),),
                        dtype=torch.uint8, device=device)
    assign = torch.empty((n,), dtype=torch.int32, device=device)
    err = fn(x.data_ptr(), n, d, centroids.data_ptr(), centroids.shape[0],
             norms.data_ptr(), tiles.data_ptr(), sms, assign.data_ptr(),
             launch.stream(device))
    launch.check_launch(err, "kmeans_assign")
    launch.count(__name__)
    return assign


def kmeans_update(x: torch.Tensor, assign: torch.Tensor,
                  centroids: torch.Tensor,
                  spherical: bool = False) -> torch.Tensor:
    """New (C, D) centroids from the rows' assignments (each in [0, C))."""
    if launch.runs_plain(x, assign, centroids):
        return kmeans_update_plain(x, assign, centroids, spherical)
    fn = _update_fn()
    _check_rows(x, centroids)
    launch.check_tensor(assign, "assign", [torch.int32], 1)
    n, d = x.shape
    c = centroids.shape[0]
    launch.require(assign.shape[0] == n, f"assign: expected ({n},)")
    launch.require(d % 4 == 0 and d <= MAX_UPDATE_D,
                   f"kmeans_update takes widths that are multiples of 4 up "
                   f"to {MAX_UPDATE_D}, not {d}")
    device = x.device
    n_tiles = -(-n // TILE_ROWS)
    i32 = dict(dtype=torch.int32, device=device)
    tile_pos = torch.zeros((n_tiles, c), **i32)
    counts = torch.empty((c,), **i32)
    offsets = torch.empty((c + 1,), **i32)
    order = torch.empty((n,), **i32)
    out = torch.empty_like(centroids)
    err = fn(x.data_ptr(), n, d, assign.data_ptr(), centroids.data_ptr(), c,
             int(bool(spherical)), tile_pos.data_ptr(), counts.data_ptr(),
             offsets.data_ptr(), order.data_ptr(), out.data_ptr(),
             launch.stream(device))
    launch.check_launch(err, "kmeans_update")
    launch.count(__name__, "update_launches")
    return out
