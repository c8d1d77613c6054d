"""K13 select_topk: the top k of each row of an f32 score matrix, for any
k up to the row's length.

The large-k mode of K3 (kernels/topk.py) and K11 (kernels/ivf.py): past
the 64 entries their shared-memory lists hold, they write every
candidate's score and this kernel selects the top k. The order is
`lax.top_k`'s: NaN first, then values descending, equal values by
ascending position. The CUDA source is csrc/select.cu, which says what
bounds it on an H100 and how its design answers that: an 11-bit radix
select over each element's unique (score key, inverted position) key, a
row cut into slices across many CTAs (`plan`), two reads of the scores
(a histogram, then a filter into each slice's winners and candidates),
the rest picked from the candidates by a CTA a row, which also sorts the
k winners; a row whose candidates overflow a slice's buffer is refined
by all its CTAs, reading the row again. `sliced_select` is that
arithmetic in plain PyTorch and `slice_candidates` the filter's counts
(tests only). Rows of at most SMALL_MAX columns take the small-width
mode instead: one launch, a warp a row, each candidate ranked by the
count of the row's keys above its own. `merge_topk` is that mode over
the tp x k candidates of a tensor-parallel top-k as the all-gather
stacks them (ops/sharded.py tp_top_k), writing their ids. The `*_plain`
functions are the same in plain PyTorch (a stable descending sort): CPU
tensors take them, CUDA tensors launch the kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from code2vec_tpu_torch.kernels import launch

launches = 0
_fns = {}
DIGIT_BITS = 11      # radix digit (csrc/select.cu)
BINS = 1 << DIGIT_BITS
TOP_SHIFT = 32 - DIGIT_BITS   # the first digit: the score key's top bits
STATE_WORDS = 4      # a row's state words after its BINS counts
REFINE_WORDS = 8     # a row's refine words after its BINS counts
MIN_SLICE = 4096     # fewest columns a CTA takes
CTAS_PER_SM = 3      # hist / filter CTAs resident on an SM (kCtasPerSm)
MAX_CAP = 8192       # candidates a slice's buffer holds at most
MAX_SLICES = 1024    # slices a row (csrc/select.cu kMaxSlices)
SMALL_MAX = 128      # columns of the small-width mode (kSmallMax)


class SelectPlan(NamedTuple):
    slices: int         # CTAs a row in the hist and filter launches
    slice: int          # columns a CTA reads (a multiple of 4)
    cap: int            # candidates a slice's buffer holds
    pos_bits: int       # bits of a position (of n - 1, at least 1)
    sort_len: int       # the power of two >= k (>= 32) the winners sort in
    scratch_bytes: int  # c2v_select_scratch_bytes


def _align16(b: int) -> int:
    return -(-b // 16) * 16


def plan(rows: int, n: int, k: int, sms: int = 132,
         min_slice: int = MIN_SLICE, max_cap: int = MAX_CAP) -> SelectPlan:
    """How K13 cuts `rows` rows of n columns for top k on `sms` SMs: as
    many slices a row as fit one wave of CTAS_PER_SM CTAs on every SM (a
    partial second wave would idle SMs; a row's CTAs refining it wait on
    each other, so all must be resident), none under `min_slice` columns
    (rounded up to whole 16-byte groups)."""
    want = max(1, min(MAX_SLICES, CTAS_PER_SM * sms // rows))
    slices = max(1, min(want, -(-n // min_slice)))
    width = -(-(-(-n // slices)) // 4) * 4
    slices = -(-n // width)
    cap = min(width, max_cap)
    sort_len = max(32, 1 << (k - 1).bit_length())
    cells = rows * slices
    refine = 4 * rows * (BINS + REFINE_WORDS) if cap < width else 0
    scratch = (_align16(4 * rows * (BINS + STATE_WORDS)) + _align16(refine)
               + _align16(8 * cells)
               + _align16(8 * cells * min(k, width))
               + _align16(8 * cells * cap) + 8 * rows * sort_len)
    return SelectPlan(slices, width, cap, max(1, (n - 1).bit_length()),
                      sort_len, scratch)


def score_keys(x: torch.Tensor) -> torch.Tensor:
    """The kernel's order-preserving uint32 key of each f32 score (int64):
    a larger float has a larger key, every NaN the largest, -0 that of
    +0."""
    x = torch.where(x == 0, torch.zeros_like(x), x).contiguous()
    u = x.view(torch.int32).to(torch.int64) & 0xffffffff
    key = torch.where(u >= 2 ** 31, ~u & 0xffffffff, u | 2 ** 31)
    return torch.where(torch.isnan(x), torch.full_like(u, 0xffffffff), key)


def choose_digit(hist: torch.Tensor, want: int) -> Tuple[int, int, int]:
    """(digit d, the count of larger digits, hist[d]) where the count from
    the top digit down reaches `want`."""
    rev = hist.flip(0)
    run = torch.cumsum(rev, 0)
    j = int(torch.nonzero(run >= want)[0])
    return hist.numel() - 1 - j, int(run[j] - rev[j]), int(rev[j])


def slice_candidates(scores: torch.Tensor, k: int, p: SelectPlan,
                     n: Optional[int] = None) -> torch.Tensor:
    """The candidates the filter finds in each (row, slice) of the first
    `n` columns (tests only): the keys of the first digit d0, none where
    d0's whole bin is wanted. (rows, slices) int64, on the scores' device;
    a row with a slice above `p.cap` overflows, and all its CTAs refine
    it."""
    n = scores.shape[1] if n is None else int(n)
    digit = score_keys(scores[:, :n]) >> TOP_SHIFT
    rows = digit.shape[0]
    hist = torch.zeros((rows, BINS), dtype=torch.int64,
                       device=digit.device).scatter_add_(
        1, digit, torch.ones_like(digit))
    from_top = torch.cumsum(hist.flip(1), 1)   # keys of digit >= d, d falling
    j = torch.argmax((from_top >= k).to(torch.int8), 1)
    d0 = BINS - 1 - j
    take_all = from_top.gather(1, j[:, None])[:, 0] == k
    is_cand = (digit == d0[:, None]) & ~take_all[:, None]
    is_cand = torch.nn.functional.pad(is_cand, (0, p.slices * p.slice - n))
    return is_cand.view(rows, p.slices, p.slice).sum(2)


def sliced_select(scores: torch.Tensor, k: int, n: Optional[int] = None,
                  p: Optional[SelectPlan] = None, sms: int = 132):
    """K13's arithmetic in plain PyTorch (tests only), row by row: the
    first digits counted slice by slice and added, d0 picked; the filter
    slice by slice (winners above d0, candidates at d0, buffered where
    every slice's fit `p.cap`, else read from the row again); the radix
    passes over the candidates' (low key bits, inverted position bits);
    the winners sorted by (key, -position). Returns (values, positions int32,
    one dict a row: d0, bin0, buffered, take_all, passes)."""
    rows = scores.shape[0]
    n = scores.shape[1] if n is None else int(n)
    p = plan(rows, n, k, sms) if p is None else p
    vals = torch.empty((rows, k), dtype=scores.dtype)
    out = torch.empty((rows, k), dtype=torch.int32)
    info = []
    pos_mask = (1 << p.pos_bits) - 1
    for r in range(rows):
        x = scores[r, :n]
        key = score_keys(x)
        digit = key >> TOP_SHIFT
        hist = torch.zeros(BINS, dtype=torch.int64)
        cuts = [(lo, min(lo + p.slice, n)) for lo in range(0, n, p.slice)]
        assert len(cuts) == p.slices
        for lo, hi in cuts:
            hist += torch.bincount(digit[lo:hi], minlength=BINS)
        d0, above0, bin0 = choose_digit(hist, k)
        want = k - above0
        take_all = bin0 == want
        wins, cands = [], []
        for lo, hi in cuts:
            idx = torch.arange(lo, hi)
            dg = digit[lo:hi]
            wins.append(idx[(dg > d0) | ((dg == d0) & take_all)])
            cands.append(idx[dg == d0])
        # every slice's candidates fit its buffer, or the row's CTAs
        # refine it, reading the row again
        buffered = not take_all and max(c.numel() for c in cands) <= p.cap
        passes = 0
        if not take_all:
            src = (torch.cat(cands) if buffered
                   else torch.nonzero(digit == d0).flatten())
            rr = (((key[src] & ((1 << TOP_SHIFT) - 1)) << p.pos_bits)
                  | (~src & pos_mask))
            top, prefix = TOP_SHIFT + p.pos_bits, 0
            while True:
                width = min(DIGIT_BITS, top)
                shift = top - width
                live = (rr >> top) == prefix
                d, above, c = choose_digit(torch.bincount(
                    (rr[live] >> shift) & ((1 << width) - 1),
                    minlength=BINS), want)
                prefix = (prefix << width) | d
                want -= above
                top = shift
                passes += 1
                if c == want or top == 0:
                    break
            wins.append(src[(rr >> top) >= prefix])
        w = torch.sort(torch.cat(wins)).values
        assert w.numel() == k
        w = w[torch.sort(key[w], descending=True, stable=True).indices]
        out[r] = w.to(torch.int32)
        vals[r] = x[w]
        info.append(dict(d0=d0, bin0=bin0, buffered=buffered,
                         take_all=take_all, passes=passes))
    return vals, out, info


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


def merge_topk_plain(values: torch.Tensor, ids: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    parts, rows, k_local = values.shape
    flat_values = values.permute(1, 0, 2).reshape(rows, parts * k_local)
    flat_ids = ids.permute(1, 0, 2).reshape(rows, parts * k_local)
    vals, pos = top_positions(flat_values, k)
    return vals, flat_ids.gather(1, pos)


def _fn(name: str = "c2v_select_topk"):
    fn = _fns.get(name)
    if fn is None:
        P, I32, I64 = launch.P, launch.I32, launch.I64
        fn = _fns[name] = launch.bind("select", name, {
            "c2v_select_topk": [P, I32, I64, I32, I32, I32, I32, I32, I32,
                                I32, P, P, P, P],
            "c2v_select_small": [P, I32, I64, I32, I32, P, P, P],
            "c2v_select_merge": [P, P, I32, I32, I32, I32, P, P, P],
        }[name])
        if name == "c2v_select_topk":
            _fns["scratch_bytes"] = launch.bind(
                "select", "c2v_select_scratch_bytes",
                [I32, I32, I32, I32, I32, I32], restype=I64)
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
    rows, ld = scores.shape
    n = ld if n is None else int(n)
    # builds the library first: raises where nvcc is missing
    fn = _fn("c2v_select_small" if n <= SMALL_MAX else "c2v_select_topk")
    launch.check_tensor(scores, "scores", [torch.float32], 2, align=16)
    k = int(k)
    launch.require(ld % 4 == 0, f"scores: row stride {ld} is not a "
                                f"multiple of 4 (padded_width)")
    launch.require(0 < n <= ld and n < 2 ** 31 - 4,
                   f"n={n} outside 1..{ld}")
    launch.require(1 <= k <= n, f"k={k} outside 1..{n}")
    launch.require(rows < 2 ** 31, "more than 2^31 rows")
    device = scores.device
    values = torch.empty((rows, k), dtype=torch.float32, device=device)
    positions = torch.empty((rows, k), dtype=torch.int32, device=device)
    if n <= SMALL_MAX:
        err = fn(scores.data_ptr(), rows, ld, n, k, values.data_ptr(),
                 positions.data_ptr(), launch.stream(device))
        launch.check_launch(err, "select_topk")
        launch.count(__name__)
        return values, positions
    p = plan(rows, n, k,
             torch.cuda.get_device_properties(device).multi_processor_count)
    scratch = torch.empty(
        (_fns["scratch_bytes"](rows, p.slices, p.slice, k, p.cap,
                               p.sort_len),),
        dtype=torch.uint8, device=device)
    err = fn(scores.data_ptr(), rows, ld, n, k, p.slices, p.slice, p.cap,
             p.pos_bits, p.sort_len, scratch.data_ptr(), values.data_ptr(),
             positions.data_ptr(), launch.stream(device))
    launch.check_launch(err, "select_topk")
    launch.count(__name__)
    return values, positions


def merge_topk(values: torch.Tensor, ids: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top k (values (B, k) f32, ids (B, k) int32) of each row's
    candidates, given as values f32 and ids int32 (parts, B, k_local),
    the all-gather of each rank's top k_local: `lax.top_k` over the
    rank-major (B, parts x k_local) candidates and their ids taken at the
    positions it picks. Up to SMALL_MAX candidates a row one launch of
    the small-width mode reads them in place; more are copied rank-major
    and take the large mode and a gather."""
    if launch.runs_plain(values, ids):
        return merge_topk_plain(values, ids, k)
    fn = _fn("c2v_select_merge")  # raises where nvcc is missing
    launch.check_tensor(values, "values", [torch.float32], 3)
    launch.check_tensor(ids, "ids", [torch.int32], 3)
    launch.require(ids.shape == values.shape,
                   f"ids {tuple(ids.shape)} and values "
                   f"{tuple(values.shape)} differ")
    parts, rows, k_local = values.shape
    n, k = parts * k_local, int(k)
    launch.require(1 <= k <= n, f"k={k} outside 1..{n}")
    if n > SMALL_MAX:
        flat = torch.full((rows, padded_width(n)), float("-inf"),
                          device=values.device)
        flat[:, :n] = values.permute(1, 0, 2).reshape(rows, n)
        top_values, top_pos = select_topk(flat, k, n)
        return top_values, ids.permute(1, 0, 2).reshape(rows, n).gather(
            1, top_pos.long())
    out_values = torch.empty((rows, k), dtype=torch.float32,
                             device=values.device)
    out_ids = torch.empty((rows, k), dtype=torch.int32,
                          device=values.device)
    err = fn(values.data_ptr(), ids.data_ptr(), parts, rows, k_local, k,
             out_values.data_ptr(), out_ids.data_ptr(),
             launch.stream(values.device))
    launch.check_launch(err, "merge_topk")
    launch.count(__name__)
    return out_values, out_ids
