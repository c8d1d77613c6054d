"""K9 kmeans_assign and K10 kmeans_update: one Lloyd step of k-means.

K9 replaces code2vec_tpu/retrieval/index.py `_assign_jax` (:117-122),
the nearest centroid of every row by argmin(|c|^2 - 2 x.c) with ties to
the lowest index; K10 the update of `train_kmeans.lloyd` (:96-111), the
mean of each cluster's rows, the old centroid where a cluster is empty,
and the spherical renormalisation. Both compute in float32 (no TF32: a
flipped assignment moves a row to another list). The CUDA source is
csrc/kmeans.cu, which says what bounds each kernel on an H100 and how its
design answers that; K10 is deterministic (a stable counting sort, then
fixed-order sums), so two runs give the same bits.

CPU tensors take the plain versions below (matmul + argmin; index_add_
+ where), CUDA tensors launch the kernels.
"""

from __future__ import annotations

import torch

from code2vec_tpu_torch.kernels import launch

launches = 0         # K9
update_launches = 0  # K10
_fns = {}
TILE_ROWS = 1024     # rows per counting-sort tile (csrc/kmeans.cu)
MAX_UPDATE_D = 1024  # widest row K10 takes (4 groups of d / 4 threads)
PLAIN_CHUNK_ROWS = 65536  # rows per (rows, C) distance block of the plain K9


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
            "kmeans", "c2v_kmeans_assign", [P, I64, I32, P, I32, P, P, P])
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
    device = x.device
    norms = torch.empty((centroids.shape[0],), dtype=torch.float32,
                        device=device)
    assign = torch.empty((x.shape[0],), dtype=torch.int32, device=device)
    err = fn(x.data_ptr(), x.shape[0], x.shape[1], centroids.data_ptr(),
             centroids.shape[0], norms.data_ptr(), assign.data_ptr(),
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
