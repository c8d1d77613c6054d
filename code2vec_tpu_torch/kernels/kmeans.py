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
deterministic (a stable sort of the row ids by cluster, one 11-bit digit
pass for up to 2,048 clusters, then each CTA of the sum launch sums its
own equal range of the sorted rows, cluster by cluster, and a cluster
that crosses ranges adds its segments in range order), so two runs give
the same bits. `update_plan` gives its combine runs and scratch,
`sort_order` and `ranged_update` its arithmetic in plain PyTorch (tests
only). K9 takes widths in multiples of 4 (its tensor copies of x move
whole 16-byte units), K10 those up to MAX_UPDATE_D.

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
MAX_UPDATE_D = 1024  # widest row K10 takes (8 consumer warps of float4s)
SORT_TILE = 2048     # rows a K10 sort CTA ranks (csrc/kmeans.cu kSortTile)
SORT_WARPS = 8       # its warps, 256 rows each in row order
MAX_SORT_CLUSTERS = 2048  # clusters of the one-pass sort (kMaxBins)
TILE_ROWS = 1024     # rows a counting-sort tile takes above that
COMBINE_GROUPS = 4   # runs of segment sums a combine CTA adds in parallel
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


class UpdatePlan(NamedTuple):
    combine_groups: int  # runs of segment sums a combine CTA adds
    scratch_bytes: int   # c2v_kmeans_update_scratch_bytes


def _align16(b: int) -> int:
    return -(-b // 16) * 16


def update_plan(n: int, d: int, n_cent: int, grid: int) -> UpdatePlan:
    """K10's combine runs and scratch for n rows of width d, n_cent
    clusters and `grid` sum CTAs (c2v_kmeans_update_grid; csrc/kmeans.cu
    update_layout and c2v_kmeans_update): the one-pass sort's tiles of
    SORT_TILE rows and counts padded to 8 up to MAX_SORT_CLUSTERS
    clusters, else TILE_ROWS-row tiles; a combine CTA holds
    COMBINE_GROUPS runs of a row's float4 columns (in whole warps) within
    1,024 threads."""
    one_pass = n_cent <= MAX_SORT_CLUSTERS
    tiles = -(-n // (SORT_TILE if one_pass else TILE_ROWS))
    cs = -(-n_cent // 8) * 8 if one_pass else n_cent
    scratch = sum(_align16(b) for b in (
        4 * n_cent, 4 * tiles * cs, 4 * (n_cent + 1), 4 * n,
        4 * grid * d, 4 * grid * d, 4 * grid))
    d4p = -(-(d // 4) // 32) * 32
    groups = COMBINE_GROUPS if COMBINE_GROUPS * d4p <= 1024 else 1024 // d4p
    return UpdatePlan(groups, scratch)


def sort_order(assign: torch.Tensor, n_cent: int) -> torch.Tensor:
    """The one-pass sort's placement in plain PyTorch (tests only): each
    (tile, cluster)'s first slot from the scan (cluster-major over the
    tiles' counts), each warp's offset within its tile's run, each row's
    rank among its warp's earlier rows of the cluster; returns the row
    ids in sorted order. Rows outside [0, n_cent) are dropped."""
    n = assign.shape[0]
    a = assign.long()
    ok = (a >= 0) & (a < n_cent)
    rows = torch.arange(n)
    tile = rows // SORT_TILE
    warp = rows % SORT_TILE // (SORT_TILE // SORT_WARPS)
    unit = tile * SORT_WARPS + warp           # (tile, warp) in row order
    counts = torch.zeros((-(-n // SORT_TILE) * SORT_WARPS, n_cent),
                         dtype=torch.long)
    counts.index_put_((unit[ok], a[ok]), torch.ones_like(a[ok]),
                      accumulate=True)
    # the scan's slots over (cluster, tile, warp) in that order, a
    # cluster's rows then in row order
    flat = counts.T.reshape(-1)
    first = (torch.cumsum(flat, 0) - flat).reshape(n_cent, -1).T
    out = torch.full((int(ok.sum()),), -1, dtype=torch.long)
    seen = torch.zeros_like(counts)
    for r in rows[ok].tolist():
        u, c = int(unit[r]), int(a[r])
        out[first[u, c] + seen[u, c]] = r
        seen[u, c] += 1
    return out


def segments(offsets: torch.Tensor, grid: int) -> list:
    """Each cluster's segments over `grid` equal ranges of the sorted rows
    (ceil(rows / grid) a range): [(range, first row, end row)] in range
    order, [] for an empty cluster."""
    nv = int(offsets[-1])
    per = max(1, -(-nv // grid))
    out = []
    for c in range(offsets.numel() - 1):
        lo, hi = int(offsets[c]), int(offsets[c + 1])
        out.append([(i, max(lo, i * per), min(hi, (i + 1) * per))
                    for i in range(lo // per, (hi - 1) // per + 1)]
                   if hi > lo else [])
    return out


def ranged_update(x: torch.Tensor, assign: torch.Tensor,
                  centroids: torch.Tensor, spherical: bool = False,
                  grid: int = 528) -> torch.Tensor:
    """K10's arithmetic in plain PyTorch (tests only): the rows in stable
    cluster order, cut into `grid` equal ranges; each cluster's rows in a
    range summed in row order; a cluster within one range takes its mean
    from that sum, one that crosses ranges adds its segments' sums in the
    combine's contiguous runs (`update_plan`'s groups for this width) and
    the runs in order; empty clusters keep their centroid; the spherical
    renormalisation (1e-12 guard). Each f32 add is one rounding, as the
    kernel's are."""
    c = centroids.shape[0]
    groups = update_plan(1, x.shape[1], c, grid).combine_groups
    a = assign.long()
    keep = (a >= 0) & (a < c)
    rows = torch.nonzero(keep).flatten()[
        torch.argsort(a[keep], stable=True)]
    counts = torch.bincount(a[keep], minlength=c)
    offsets = torch.zeros(c + 1, dtype=torch.long)
    offsets[1:] = torch.cumsum(counts, 0)
    segs = segments(offsets, grid)
    spans = torch.tensor([(lo, hi) for cs in segs for _, lo, hi in cs],
                         dtype=torch.long).reshape(-1, 2)
    sums = torch.zeros((spans.shape[0], x.shape[1]), dtype=x.dtype)
    size = spans[:, 1] - spans[:, 0]
    for j in range(int(size.max()) if spans.numel() else 0):
        live = size > j     # every segment's j-th row, in row order
        sums[live] = sums[live] + x[rows[spans[live, 0] + j]]
    out = centroids.clone()
    at = 0
    for k, cs in enumerate(segs):
        m = len(cs)
        if m == 0:
            continue
        part = sums[at:at + m]
        at += m
        if m == 1:
            s = part[0]
        else:
            runs = []
            for g in range(groups):
                acc = torch.zeros_like(x[0])
                for j in range(m * g // groups, m * (g + 1) // groups):
                    acc = acc + part[j]
                runs.append(acc)
            s = runs[0]
            for r in runs[1:]:
                s = s + r
        mean = s / torch.tensor(float(max(int(counts[k]), 1)),
                                dtype=x.dtype)
        if spherical:
            mean = mean / torch.clamp(torch.linalg.vector_norm(mean),
                                      min=1e-12)
        out[k] = mean
    return out


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
            [P, I64, I32, P, P, I32, I32, I32, P, P, P])
        _fns["update_scratch"] = launch.bind(
            "kmeans", "c2v_kmeans_update_scratch_bytes",
            [I64, I32, I32, I32], restype=I64)
        _fns["update_grid"] = launch.bind(
            "kmeans", "c2v_kmeans_update_grid", [I32, I32])
    return fn


def update_grid(device: torch.device, d: int) -> int:
    """K10's sum CTAs for width d on `device` (c2v_kmeans_update_grid: the
    SMs times the sum kernel's occupancy), asked once a card and width."""
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    key = ("update_grid", index, int(d))
    grid = _fns.get(key)
    if grid is None:
        _update_fn()
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        grid = _fns["update_grid"](int(d), sms)
        launch.require(grid > 0, "kmeans_update: no occupancy for its sums")
        _fns[key] = grid
    return grid


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
    grid = update_grid(device, d)
    scratch = torch.empty((_fns["update_scratch"](n, d, c, grid),),
                          dtype=torch.uint8, device=device)
    out = torch.empty_like(centroids)
    err = fn(x.data_ptr(), n, d, assign.data_ptr(), centroids.data_ptr(), c,
             int(bool(spherical)), grid, scratch.data_ptr(), out.data_ptr(),
             launch.stream(device))
    launch.check_launch(err, "kmeans_update")
    launch.count(__name__, "update_launches")
    return out
