"""K12 sparse_adam: duplicate combining and touched-rows (lazy) Adam for
the embedding tables, in place, both tables of one width in one launch
sequence.

Replaces code2vec_tpu/training/sparse_adam.py `combine_duplicate_rows`
(:64-83) and `sparse_adam_rows` (:86-130). The CUDA source is
csrc/sparse_adam.cu; its header gives the update's rounding points, what
bounds it on an H100 and how its design answers that: a stable radix
sort of every table's ids as one key space (a histogram launch, then a
scan and a scatter launch a digit pass), a warp per 32 sorted
positions summing rows in position order and updating, and a CTA per id
whose rows span three or more chunks adding their partial sums in a fixed
order. The plain version is training/sparse_adam.py `sparse_adam_rows`,
the reference's chain on tensors (a stable argsort, a segment sum, the
update of the representatives): CPU tensors take it, CUDA tensors launch
the kernel. Both update the tables and their slots in place.

`plan` is the kernel's sort and scratch shape on the host, and
`radix_destinations` and `segment_sums` are its sort and its sums in
plain PyTorch, term by term (held on the CPU by
tests/test_torch_sparse_adam_attention_plans.py).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from code2vec_tpu_torch.kernels import launch
from code2vec_tpu_torch.kernels.adam import AdamHyper
from code2vec_tpu_torch.training.sparse_adam import (
    RowAdamSlots, sparse_adam_rows,
)

launches = 0
_fns = {}
MAX_D = 512
MAX_TABLES = 2          # tables a launch sequence takes (kMaxTables)
TILE = 2048             # pairs a sort CTA ranks (kTile)
WARP_PAIRS = 256        # pairs a sort warp ranks, in position order
MIN_DIGIT_BITS, MAX_DIGIT_BITS = 8, 11
CHUNK = 32              # sorted pairs a warp owns in the segment pass
COMBINE_WARPS = 16      # warps summing a long segment's partials
COUNTERS = 4            # the long list's length, padded to 16 bytes
MAX_PAIRS = 2 ** 30 - 1

sparse_adam_plain = sparse_adam_rows

Update = Tuple[torch.Tensor, RowAdamSlots, torch.Tensor, torch.Tensor]


class SortPlan(NamedTuple):
    passes: int         # digit passes
    digit_bits: int     # bits a digit
    bins: int           # 2 ** digit_bits
    tiles: int          # sort CTAs a pass
    chunks: int         # segment-pass warps
    scratch_bytes: int


def _align256(x: int) -> int:
    return (x + 255) // 256 * 256


def plan(n: int, keys: int, d: int) -> SortPlan:
    """The kernel's shape for n pairs of keys in [0, keys] (the last is a
    dropped id's) at width d (csrc/sparse_adam.cu `Plan`, `Scratch`):
    the fewest digit passes of at most 11 bits, as even as they can be and
    at least 8; the scratch: keys and positions twice, every pass's tile
    counts, the digit counts and counters, a pass's slots, the list of
    long segments and two partial rows a chunk."""
    bits = max(1, keys.bit_length())
    passes = -(-bits // MAX_DIGIT_BITS)
    digit_bits = max(MIN_DIGIT_BITS, -(-bits // passes))
    bins = 1 << digit_bits
    tiles = -(-n // TILE)
    chunks = -(-n // CHUNK)
    table = 4 * tiles * bins  # one pass's tile counts
    o = 0
    for _ in range(4):  # keys and positions, twice
        o = _align256(o + 4 * n)
    o = _align256(o + table)
    o = _align256(o + 4 * passes * bins + 4 * COUNTERS
                  + table * (passes - 1))
    o = _align256(o + table)  # each pass's slots
    o = _align256(o + 4 * chunks)
    o = _align256(o + 4 * chunks * d)
    o = _align256(o + 4 * chunks * d)
    return SortPlan(passes, digit_bits, bins, tiles, chunks, o)


def radix_destinations(keys: torch.Tensor, shift: int, bins: int
                       ) -> torch.Tensor:
    """Where one digit pass puts each pair, in the kernel's terms: the
    count of the digits below its digit over all keys, plus its digit's
    count in the earlier tiles (the scan launch's slot), in the tile's
    earlier warps and in its warp's earlier pairs (tests only)."""
    n = keys.shape[0]
    digit = ((keys >> shift) & (bins - 1)).long()
    i = torch.arange(n)
    tile, warp = i // TILE, i // WARP_PAIRS  # warp: over all tiles

    def exclusive(group: torch.Tensor) -> torch.Tensor:
        """(groups, bins): each digit's count in the earlier groups."""
        g = int(group.max()) + 1
        per = torch.bincount(group * bins + digit,
                             minlength=g * bins).view(g, bins)
        return torch.cumsum(per, 0) - per

    totals = torch.bincount(digit, minlength=bins)
    below = torch.cumsum(totals, 0) - totals
    in_tiles = exclusive(tile)[tile, digit]
    in_warps = exclusive(warp)[warp, digit] - in_tiles
    # the rank among the warp's pairs of the same digit, in position order
    group = warp * bins + digit
    order = torch.argsort(group, stable=True)
    sizes = torch.bincount(group, minlength=int(group.max()) + 1)
    first = torch.cumsum(sizes, 0) - sizes
    rank = torch.empty_like(i)
    rank[order] = torch.arange(n) - first[group[order]]
    return below[digit] + in_tiles + in_warps + rank


def segment_sums(keys: torch.Tensor, rows: torch.Tensor, dead: int
                 ) -> Dict[int, torch.Tensor]:
    """The f32 gradient sum of every live key of the sorted `keys` (rows
    in the same order), added as the segment and combine passes add them
    (tests only): an id whose pairs end in its first chunk or the next is
    summed in position order; one that runs into a third chunk is summed
    a chunk at a time in position order, then those partials in
    COMBINE_WARPS contiguous runs in order, then the runs in order."""
    n = keys.shape[0]
    rows = rows.float()
    out = {}
    start = 0
    while start < n:
        key = int(keys[start])
        end = start
        while end < n and int(keys[end]) == key:
            end += 1
        if key != dead:
            first, last = start // CHUNK, (end - 1) // CHUNK
            if last <= first + 1:
                acc = torch.zeros_like(rows[0])
                for j in range(start, end):
                    acc = acc + rows[j]
            else:
                parts = []
                for c in range(first, last + 1):
                    acc = torch.zeros_like(rows[0])
                    for j in range(max(start, c * CHUNK),
                                   min(end, (c + 1) * CHUNK)):
                        acc = acc + rows[j]
                    parts.append(acc)
                per = -(-len(parts) // COMBINE_WARPS)
                acc = torch.zeros_like(rows[0])
                for w in range(0, len(parts), per):
                    run = torch.zeros_like(rows[0])
                    for x in parts[w:w + per]:
                        run = run + x
                    acc = acc + run
            out[key] = acc
        start = end
    return out


def _fn():
    fn = _fns.get("sparse_adam")
    if fn is None:
        P, I32, I64, F32 = launch.P, launch.I32, launch.I64, launch.F32
        fn = _fns["sparse_adam"] = launch.bind(
            "sparse_adam", "c2v_sparse_adam",
            [I32, P, P, P, P, P, P, P, I32, I32] + [F32] * 8 + [P, P])
        _fns["scratch"] = launch.bind(
            "sparse_adam", "c2v_sparse_adam_scratch_bytes", [I64, I64, I32],
            restype=I64)
        _fns["passes"] = launch.bind(
            "sparse_adam", "c2v_sparse_adam_passes", [I64])
    return fn


def kernel_plan(n: int, keys: int, d: int) -> Tuple[int, int, int]:
    """The kernel's own (passes, digit bits, scratch bytes) (tests hold
    `plan` to them)."""
    _fn()
    pd = int(_fns["passes"](keys))
    return pd // 100, pd % 100, int(_fns["scratch"](n, keys, d))


def _check(table, slots, ids, grads) -> None:
    launch.check_tensor(table, "table", [torch.float32], 2, align=16)
    v, d = table.shape
    launch.require(d % 128 == 0 and d <= MAX_D,
                   f"width {d}: the kernel takes multiples of 128 up to "
                   f"{MAX_D}")
    launch.check_tensor(slots.mu, "mu", [torch.bfloat16, torch.float32], 2,
                        align=16)
    launch.check_tensor(slots.nu, "nu", [torch.float32], 2, align=16)
    launch.require(slots.mu.shape == table.shape == slots.nu.shape,
                   "table, mu and nu differ in shape")
    launch.check_tensor(ids, "ids", [torch.int32], 1)
    n = ids.shape[0]
    launch.check_tensor(grads, "grads", [torch.bfloat16], 2, align=16)
    launch.require(tuple(grads.shape) == (n, d), f"grads: expected ({n}, "
                                                 f"{d})")


def launch_tables(group: Sequence[Update], c: Dict[str, float]) -> None:
    """One launch sequence over up to MAX_TABLES checked tables of one
    width and mu dtype on one device, with K8's f32 constants `c`
    (AdamHyper.scalars)."""
    fn = _fn()
    count = len(group)
    launch.require(1 <= count <= MAX_TABLES,
                   f"{count} tables: a launch takes 1 to {MAX_TABLES}")
    d = group[0][0].shape[1]
    device = group[0][0].device
    n = sum(ids.shape[0] for _, _, ids, _ in group)
    keys = sum(table.shape[0] for table, _, _, _ in group)
    launch.require(n <= MAX_PAIRS and keys < 2 ** 31 - 1,
                   f"{n} ids over {keys} rows: the kernel takes fewer than "
                   f"2^30 ids and 2^31 - 1 rows a launch")

    def ptrs(xs):
        return (ctypes.c_void_p * count)(*xs)

    tables = ptrs([u[0].data_ptr() for u in group])
    mus = ptrs([u[1].mu.data_ptr() for u in group])
    nus = ptrs([u[1].nu.data_ptr() for u in group])
    ids = ptrs([u[2].data_ptr() for u in group])
    rows = ptrs([u[3].data_ptr() for u in group])
    vs = (ctypes.c_int * count)(*[u[0].shape[0] for u in group])
    ns = (ctypes.c_int64 * count)(*[u[2].shape[0] for u in group])
    scratch = torch.empty(max(int(_fns["scratch"](n, keys, d)), 1),
                          dtype=torch.uint8, device=device)
    err = fn(count, ctypes.addressof(tables), ctypes.addressof(mus),
             ctypes.addressof(nus), ctypes.addressof(vs),
             ctypes.addressof(ids), ctypes.addressof(rows),
             ctypes.addressof(ns), d,
             int(group[0][1].mu.dtype == torch.bfloat16), c["b1"], c["b2"],
             c["one_minus_b1"], c["one_minus_b2"], c["b1c"], c["b2c"],
             c["eps"], c["neg_lr"], scratch.data_ptr(),
             launch.stream(device))
    launch.check_launch(err, "sparse_adam")
    launch.count(__name__)


def sparse_adam_tables(updates: Sequence[Update], *, t: int, lr: float,
                       b1: float, b2: float, eps: float) -> None:
    """Lazy Adam, in place, for each (table (V, d) f32, its slots, ids
    (n,) int32, gradient rows (n, d); bf16 for the kernel) of `updates`;
    `t` is the 1-based global step. The kernel takes the tables of one
    width and mu dtype in one launch sequence (MAX_TABLES at most), in
    the order given."""
    tensors = [x for table, slots, ids, grads in updates
               for x in (table, slots.mu, slots.nu, ids, grads)]
    if launch.runs_plain(*tensors):
        for table, slots, ids, grads in updates:
            sparse_adam_plain(table, slots, ids, grads, t=t, lr=lr, b1=b1,
                              b2=b2, eps=eps)
        return
    _fn()  # builds the library first: raises where nvcc is missing
    groups: Dict[Tuple[int, torch.dtype], List[Update]] = {}
    for u in updates:
        _check(*u)
        launch.require(u[0].device == updates[0][0].device,
                       "tables on more than one device")
        groups.setdefault((u[0].shape[1], u[1].mu.dtype), []).append(u)
    c = AdamHyper(learning_rate=lr, b1=b1, b2=b2, eps=eps).scalars(t)
    for group in groups.values():
        for i in range(0, len(group), MAX_TABLES):
            launch_tables(group[i:i + MAX_TABLES], c)


def sparse_adam(table: torch.Tensor, slots: RowAdamSlots, ids: torch.Tensor,
                grads: torch.Tensor, *, t: int, lr: float, b1: float,
                b2: float, eps: float) -> None:
    """Lazy Adam, in place, over the rows of `table` (V, d) f32 and its
    slots named by `ids` (n,) int32, with gradient rows `grads` (n, d)
    (bf16 for the kernel); `t` is the 1-based global step."""
    sparse_adam_tables([(table, slots, ids, grads)], t=t, lr=lr, b1=b1,
                       b2=b2, eps=eps)
