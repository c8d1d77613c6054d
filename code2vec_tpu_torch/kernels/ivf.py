"""K11 ivf_search: the probe and candidate scan of an IVF index.

One kernel, an instantiation per row format: f32 rows (replaces
code2vec_tpu/retrieval/index.py `NeighborIndex._search_ivf` :319-349) and
int8, fp8 (e4m3, e5m2) or packed int4 rows with per-row f32 scales
(replaces code2vec_tpu/retrieval/mips.py `MipsHead.topk_fn` :139-188,
whose score is (cv . float(row)) * scale in f32). The rows' dtype names
their format; packed int4 rows are uint8, two values a byte.
Per query: the inner product with every centroid, the top `nprobe` lists
(ties to the lowest centroid index), every row of those lists scored in
f32, and the top k with ties broken by candidate position (probe rank,
then offset in the list), as `lax.top_k` orders the reference's padded
candidate array. Dead slots: position -1 (index) or global id 0 (MIPS,
`global_ids` given), value -inf. The CUDA source is csrc/ivf_search.cu,
which says what bounds it on an H100 and how its design answers that:
three launches (probe, selection and grouping, a scan that also
merges) that spread one query's probed lists over the card in chunks of
R rows and read each probed list once per group of 64 queries. `plan`
sizes them on the host (plain Python, held on the CPU by
tests/test_torch_attention_ivf_plans.py), and `ivf_search_chunked` is
the kernel's work, chunk by chunk, in plain PyTorch.

The lists are contiguous rows [list_offsets[c], list_offsets[c + 1]) of
`rows`; the kernel walks them through the offsets, while the plain
version below gathers from a padded (nlist, max_len) list matrix as the
reference does (take + einsum + a stable top-k). CPU tensors take the
plain version, CUDA tensors launch the kernel. Each instantiation keeps
its own count: `launches` (f32 rows), `int8_launches`, `fp8_launches`
(e4m3 and e5m2) and `int4_launches`. Widths it takes: multiples of 4 up
to 512 (a lane holds 4 x 4 values of a row; an int4 row is d / 2 bytes).

For k above the 64 entries a list holds (MAX_K), K11 runs its large-k
mode: every probed row's score goes to a (B, nprobe * max_len) f32
matrix at its padded candidate position, K13 (kernels/select.py) selects
the top k positions, and a last launch maps them to positions or ids.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from code2vec_tpu_torch.kernels import launch, select
from code2vec_tpu_torch.kernels.select import top_positions
from code2vec_tpu_torch.ops.quant import decode_rows

launches = 0       # f32 rows
int8_launches = 0  # int8 rows with scales
fp8_launches = 0   # fp8 rows with scales
int4_launches = 0  # packed int4 rows with scales
_fns = {}
# each row format's counter
COUNTERS = {launch.FMT_F32: "launches", launch.FMT_INT8: "int8_launches",
            launch.FMT_E4M3: "fp8_launches", launch.FMT_E5M2: "fp8_launches",
            launch.FMT_INT4: "int4_launches"}
MAX_K = 64    # a list's length (csrc/ivf_search.cu kMaxK); above: K13
MAX_D = 512   # the widest row a lane's registers hold (4 x 128)
GROUP = 64    # queries grouped by probed list (csrc kGroup: one mask word)
MEMBER_TILE = 16       # queries a scan pass scores at once (kMemberTile)
CHUNK_ROWS = (128, 64, 32, 16)  # rows a scan CTA may own, largest first
CHUNK_BYTES = 65536    # a chunk's staged bytes at most
SCAN_HEAD = 3072       # a scan CTA's shared memory before the scores
SELECT_SMEM = 98304    # the grouping's shared memory at most
SMS = 132              # an H100 SXM's SMs
# a zeroed int32 buffer of tickets per (device, stream): the kernels leave
# it zero, and launches on one stream run in order
_counters: Dict[Tuple[int, int], torch.Tensor] = {}


class IvfPlan(NamedTuple):
    rows_per_chunk: int   # R: rows a scan CTA owns
    chunks_per_list: int  # cpl = max(1, ceil(max_len / R))
    grouped: bool         # probes grouped by list (each read once a group)
    probe_grid: Tuple[int, int]  # (centroid slices of 8, query groups)
    select_grid: int      # one CTA per query
    scan_grid: int        # b * nprobe * cpl
    max_parts: int        # partial lists a query may have: nprobe * cpl
    select_smem: int      # the selection CTA's shared memory
    scan_smem: int        # a scan CTA's shared memory
    scratch_bytes: int    # scores, probe, starts, slots, members, partials
    counters: int         # int32 tickets: a group's, then a query's


def _align(x: int, a: int) -> int:
    return (x + a - 1) // a * a


def row_bytes(fmt: int, d: int) -> int:
    return 4 * d if fmt == launch.FMT_F32 else (
        d // 2 if fmt == launch.FMT_INT4 else d)


def select_smem(b: int, nlist: int, nprobe: int, grouped: bool) -> int:
    """csrc/ivf_search.cu `select_smem`."""
    work = 4 * 64 * 8
    if nprobe > MAX_K:
        work = max(work, nlist * 4)
    if grouped:
        work = max(work, _align(nlist * 4, 16) + min(b, GROUP) * nprobe * 8)
    return 4 * (2 * _align(nprobe, 4) + 4) + work


def scan_smem(fmt: int, d: int, rows_per_chunk: int, tile_cap: int) -> int:
    """csrc/ivf_search.cu `scan_smem`: the header, a tile's scores
    (tile_cap = min(b, 16) queries) and, below 16, its queries, the
    chunk's span."""
    staged = d if tile_cap < MEMBER_TILE else 0
    return (_align(SCAN_HEAD + tile_cap * (rows_per_chunk + staged) * 4, 128)
            + _align(rows_per_chunk * row_bytes(fmt, d), 16) + 16)


def plan(b: int, nprobe: int, max_len: int, fmt: int, d: int, *,
         k: int = MAX_K, nlist: Optional[int] = None,
         n_rows: Optional[int] = None, sms: int = SMS) -> IvfPlan:
    """How K11 covers b queries: R, the rows a scan CTA owns, is the
    largest of 128, 64, 32, 16 whose chunk stays within 64 KB and still
    gives one scan CTA an SM, counting min(nlist, b x nprobe) probed lists
    of the average length (n_rows / nlist; max_len where not given);
    probes are grouped by list where b > 1 and the grouping's shared
    memory fits, and a list's queries are scored 16 to a CTA."""
    nlist = nprobe if nlist is None else int(nlist)
    max_len = max(int(max_len), 1)
    avg = max_len if n_rows is None else max(1, -(-int(n_rows) // nlist))
    lists = min(nlist, b * nprobe)
    rb = row_bytes(fmt, d)
    fits = [r for r in CHUNK_ROWS if r * rb <= CHUNK_BYTES] or [16]
    rpc = next((r for r in fits if lists * -(-avg // r) >= sms), fits[-1])
    cpl = -(-max_len // rpc)
    q = min(b, GROUP)
    groups = -(-b // GROUP)
    grouped = b > 1 and select_smem(b, nlist, nprobe, True) <= SELECT_SMEM
    max_parts = nprobe * cpl
    slots = b * nprobe
    scratch = (b * nlist * 4 + slots * 4 + b * (nprobe + 1) * 4
               + slots * 32 + slots * q * 16 + b * max_parts * k * 8)
    return IvfPlan(rpc, cpl, grouped, (-(-nlist // 8), groups), b,
                   slots * cpl, max_parts,
                   select_smem(b, nlist, nprobe, grouped),
                   scan_smem(fmt, d, rpc, min(b, MEMBER_TILE)), scratch,
                   groups + b)


def padded_lists(list_offsets: torch.Tensor, max_len: int) -> torch.Tensor:
    """(nlist, max_len) int64 matrix of member positions, -1 padded (the
    reference's `_padded_lists`)."""
    lo = list_offsets[:-1]
    lens = list_offsets[1:] - lo
    j = torch.arange(max(int(max_len), 1), device=list_offsets.device)
    return torch.where(j[None, :] < lens[:, None], lo[:, None] + j[None, :],
                       torch.full_like(j[None, :], -1))


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
    scores = torch.einsum("bd,bpd->bp", queries,
                          decode_rows(rows[safe], queries.shape[1]))
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


def _keys(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """The kernel's 64-bit candidate keys (csrc/ivf_search.cu `make_key`)
    as int64 with the top bit flipped, so that signed order is the
    kernel's unsigned order: descending keys are lax.top_k's order (NaN
    first, larger values first, ties to the lower index)."""
    v = torch.where(values == 0, torch.zeros_like(values), values)
    u = v.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    ordv = torch.where(u >= 0x80000000, (~u) & 0xFFFFFFFF, u | 0x80000000)
    ordv = torch.where(torch.isnan(values), torch.full_like(u, 0xFFFFFFFF),
                       ordv)
    key = (ordv << 32) | (0xFFFFFFFF - index.long())
    return key ^ (-(2 ** 63))


def ivf_search_chunked(queries: torch.Tensor, centroids: torch.Tensor,
                       rows: torch.Tensor, list_offsets: torch.Tensor,
                       nprobe: int, k: int, *, rows_per_chunk: int,
                       scales: Optional[torch.Tensor] = None,
                       global_ids: Optional[torch.Tensor] = None,
                       max_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K11's work in plain PyTorch, chunk by chunk (tests only): each
    probed list's rows in chunks of `rows_per_chunk`, each chunk's top k
    by the kernel's keys (value, then rank * max_len + offset), and the
    chunks' lists merged by the same keys; empty slots -inf with position
    -1 or global id 0."""
    b, d = queries.shape
    offsets = list_offsets.long()
    max_len = max(int(max_len), 1)
    _, probe = top_positions(queries @ centroids.T, nprobe)
    out_v = torch.full((b, k), -torch.inf)
    out_i = torch.full((b, k), 0 if global_ids is not None else -1,
                       dtype=torch.long)
    for q in range(b):
        keys, vals, poss = [], [], []
        for p in range(nprobe):
            lo, hi = int(offsets[probe[q, p]]), int(offsets[probe[q, p] + 1])
            for r0 in range(0, hi - lo, rows_per_chunk):
                pos = torch.arange(lo + r0, min(hi, lo + r0 + rows_per_chunk))
                sc = decode_rows(rows[pos], d) @ queries[q]
                if scales is not None:
                    sc = sc * scales.reshape(-1)[pos]
                key = _keys(sc, p * max_len + pos - lo)
                top = torch.argsort(key, descending=True)[:k]
                keys.append(key[top])
                vals.append(sc[top])
                poss.append(pos[top])
        if not keys:
            continue
        key, val, pos = torch.cat(keys), torch.cat(vals), torch.cat(poss)
        top = torch.argsort(key, descending=True)[:k]
        n = top.numel()
        out_v[q, :n] = val[top]
        out_i[q, :n] = (global_ids.long()[pos[top]] if global_ids is not None
                        else pos[top])
    return out_v, out_i.to(torch.int32)


def _fn():
    fn = _fns.get("ivf")
    if fn is None:
        P, I32 = launch.P, launch.I32
        fn = _fns["ivf"] = launch.bind(
            "ivf_search", "c2v_ivf_search",
            [P, I32, I32, P, I32, P, P, I32, P, I32, P, I32, I32, I32, I32,
             P, P, P, P, P, P, P, P, P, P])
        _fns["scores"] = launch.bind(
            "ivf_search", "c2v_ivf_scores",
            [P, I32, I32, P, I32, P, P, I32, P, I32, I32, P, P, P,
             launch.I64, P])
        _fns["select_smem"] = launch.bind(
            "ivf_search", "c2v_ivf_select_smem", [I32, I32, I32, I32],
            restype=launch.I64)
        _fns["scan_smem"] = launch.bind(
            "ivf_search", "c2v_ivf_scan_smem", [I32, I32, I32, I32],
            restype=launch.I64)
        _fns["map"] = launch.bind(
            "ivf_search", "c2v_ivf_map",
            [P, P, I32, I32, P, P, I32, I32, I32, P, P, P, P])
    return fn


def kernel_smem(b: int, nlist: int, nprobe: int, grouped: bool, fmt: int,
                d: int, rows_per_chunk: int) -> Tuple[int, int]:
    """The kernel's own (selection, scan) shared memory (tests hold
    `select_smem` and `scan_smem` to it)."""
    _fn()
    return (int(_fns["select_smem"](b, nlist, nprobe, int(grouped))),
            int(_fns["scan_smem"](fmt, d, rows_per_chunk,
                                  min(b, MEMBER_TILE))))


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    key = (device.index, launch.stream(device))
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = _counters[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                           device=device)
    return buf


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
    fmt = launch.table_format(rows, "rows")
    launch.check_tensor(rows, "rows", [rows.dtype], 2, align=16)
    launch.check_tensor(list_offsets, "list_offsets", [torch.int64], 1)
    b, d = queries.shape
    n_cent = centroids.shape[0]
    launch.require(d % 4 == 0 and d <= MAX_D,
                   f"width {d} is not a multiple of 4 up to {MAX_D}")
    launch.require(centroids.shape[1] == d
                   and rows.shape[1] == launch.stored_width(fmt, d),
                   f"centroids and rows must be {d} values wide")
    launch.require(list_offsets.shape[0] == n_cent + 1,
                   f"list_offsets: expected ({n_cent + 1},)")
    launch.require(rows.shape[0] < 2 ** 31, "more than 2^31 rows")
    if fmt == launch.FMT_F32:
        launch.require(scales is None, "f32 rows take no scales")
    else:
        launch.require(scales is not None, "quantized rows need scales")
        launch.check_tensor(scales, "scales", [torch.float32], scales.dim())
        launch.require(scales.numel() == rows.shape[0],
                       f"scales: expected {rows.shape[0]} values")
    if global_ids is not None:
        launch.check_tensor(global_ids, "global_ids", [torch.int32], 1)
        launch.require(global_ids.shape[0] == rows.shape[0],
                       f"global_ids: expected ({rows.shape[0]},)")
    launch.require(1 <= nprobe <= n_cent,
                   f"nprobe={nprobe} outside 1..{n_cent}")
    launch.require(k >= 1, f"k={k} < 1")
    max_len = max(int(max_len), 1)
    launch.require(nprobe * max_len < 2 ** 31 - 1,
                   "nprobe x longest list must stay below 2^31")
    device = queries.device
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    probe = torch.empty((b, nprobe), **i32)
    cscores = torch.empty((b, n_cent), **f32)
    if k > MAX_K:
        return _large_k(queries, centroids, rows, list_offsets, nprobe, k,
                        scales, global_ids, max_len, cscores, probe, fmt)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    p = plan(b, nprobe, max_len, fmt, d, k=k, nlist=n_cent,
             n_rows=rows.shape[0], sms=sms)
    launch.require(p.scan_grid < 2 ** 31,
                   "queries x nprobe x chunks a list must stay below 2^31")
    pstart = torch.empty((b, nprobe + 1), **i32)
    slots = torch.empty((b * nprobe, 4), dtype=torch.int64, device=device)
    members = torch.empty((b * nprobe, min(b, GROUP), 4), **i32)
    part = torch.empty((b, p.max_parts, k), dtype=torch.int64, device=device)
    tickets = _tickets(device, p.counters)
    values = torch.empty((b, k), **f32)
    indices = torch.empty((b, k), **i32)
    err = fn(queries.data_ptr(), b, d, centroids.data_ptr(), n_cent,
             rows.data_ptr(), launch.ptr(scales), fmt,
             list_offsets.data_ptr(), max_len, launch.ptr(global_ids),
             nprobe, k, p.rows_per_chunk, int(p.grouped),
             cscores.data_ptr(), probe.data_ptr(), pstart.data_ptr(),
             slots.data_ptr(), members.data_ptr(), part.data_ptr(),
             tickets.data_ptr(),
             values.data_ptr(), indices.data_ptr(), launch.stream(device))
    launch.check_launch(err, "ivf_search")
    launch.count(__name__, COUNTERS[fmt])
    return values, indices


def _large_k(queries, centroids, rows, list_offsets, nprobe, k, scales,
             global_ids, max_len, cscores, probe, fmt):
    """K11's large-k mode: the probed rows' scores, K13, the id map."""
    b, d = queries.shape
    device = queries.device
    n = nprobe * max_len
    scores = torch.empty((b, select.padded_width(n)), dtype=torch.float32,
                         device=device)
    err = _fns["scores"](queries.data_ptr(), b, d, centroids.data_ptr(),
                         centroids.shape[0], rows.data_ptr(),
                         launch.ptr(scales), fmt,
                         list_offsets.data_ptr(), max_len, nprobe,
                         cscores.data_ptr(), probe.data_ptr(),
                         scores.data_ptr(),
                         scores.shape[1], launch.stream(device))
    launch.check_launch(err, "ivf_search scores")
    launch.count(__name__, COUNTERS[fmt])
    k_sel = min(k, n)
    sel_vals, sel_pos = select.select_topk(scores, k_sel, n=n)
    values = torch.empty((b, k), dtype=torch.float32, device=device)
    indices = torch.empty((b, k), dtype=torch.int32, device=device)
    err = _fns["map"](sel_vals.data_ptr(), sel_pos.data_ptr(), b, k_sel,
                      list_offsets.data_ptr(), probe.data_ptr(), nprobe,
                      max_len, k, launch.ptr(global_ids), values.data_ptr(),
                      indices.data_ptr(), launch.stream(device))
    launch.check_launch(err, "ivf_search map")
    return values, indices
