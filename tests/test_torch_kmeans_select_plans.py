"""K10's and K13's host-side plans and split arithmetic, on the CPU.

K13 (kernels/select.py, csrc/select.cu) ranks every score by a unique
key (its order-preserving uint32 key above its inverted position), cuts
each row into slices across many CTAs, counts the first 11-bit digits
slice by slice, filters the winners above the chosen digit and the
candidates at it (into a buffer where they fit, else all the row's CTAs
refine it, reading the row again), and picks the rest from the candidates by digit passes over the
remaining key and position bits. K10 (kernels/kmeans.py, csrc/kmeans.cu)
sorts the row ids by cluster in one 11-bit digit pass (a tile's counts,
a scan of (cluster, tile) slots, a stable rank in each warp), gives each
CTA of its sum launch an equal range of the sorted rows to sum cluster by
cluster in row order, and adds the segments of a cluster that crosses
ranges in fixed runs. The CUDA kernels run only on the card; here their
plans (`select.plan`, `kmeans.update_plan`) are checked over the shapes
the wrappers take, and their arithmetic, emulated in plain PyTorch
(`select.sliced_select`, `kmeans.sort_order`, `kmeans.ranged_update`),
is held against the plain versions and the JAX package on the same
seeded numpy inputs: `jax.lax.top_k` exactly (positions and value bits),
the Lloyd step of `code2vec_tpu/retrieval/index.py` `train_kmeans` at
ROADMAP's f32 parity bar (rtol 1e-5, atol 1e-6: the sums are taken in
another order).

XLA's CPU top_k orders -0 below +0, where the port (and its plain
version, a stable sort) takes the two as equal and orders them by
position: against JAX, runs of equal values (+-0 together) are compared
in position order, on inputs whose k-th value is no zero, so that both
select the same set.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from code2vec_tpu.retrieval import index as jindex
from code2vec_tpu_torch.kernels import kmeans, select

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-6)
SMS = 132    # an H100's SMs


# ------------------------------------------------------------ K13's plan

N_SWEEP = sorted(set([1, 2, 3, 4, 5, 7, 8, 9, 100, 1001, 4095, 4096, 4097,
                      8191, 8192, 8193, 10432, 16385, 32767, 32768, 32769,
                      100003, 261245, 1000000, 2 ** 24 + 3]))


@pytest.mark.parametrize("rows", [1, 2, 8, 64, 1024])
def test_select_plan_every_shape(rows):
    """Every width from 1 to 16M columns: the slices cover each row in
    whole 16-byte groups with less than one slice of padding, the rows'
    slices fit one wave of CTAS_PER_SM CTAs on every SM (or a row takes
    one), none much under MIN_SLICE columns, a slice's candidate buffer
    holds at most its width or MAX_CAP, the position bits cover n - 1,
    the sort length is the power of two at or above k (32 at least:
    whole warps sort), and the scratch holds the counts (the refine's
    too where a slice is wider than its buffer), candidates and
    winners."""
    slots = select.CTAS_PER_SM * SMS
    for n in N_SWEEP:
        for k in sorted({1, min(n, 100), min(n, 1000), n}):
            p = select.plan(rows, n, k, SMS)
            assert p.slice % 4 == 0
            assert (p.slices - 1) * p.slice < n <= p.slices * p.slice
            assert p.slices == 1 or rows * p.slices <= slots
            assert p.slices == 1 or 2 * p.slice > select.MIN_SLICE
            assert p.cap == min(p.slice, select.MAX_CAP)
            assert p.slices <= select.MAX_SLICES
            assert (n - 1) >> p.pos_bits == 0 and p.pos_bits >= 1
            assert p.sort_len >= max(k, 32)
            assert p.sort_len & (p.sort_len - 1) == 0
            assert p.sort_len < 2 * max(k, 32)
            cells = rows * p.slices
            parts = (4 * rows * (select.BINS + select.STATE_WORDS)
                     + (4 * rows * (select.BINS + select.REFINE_WORDS)
                        if p.cap < p.slice else 0)
                     + 8 * cells * (1 + min(k, p.slice) + p.cap)
                     + 8 * rows * p.sort_len)
            assert parts <= p.scratch_bytes < parts + 80
    # B 1 and B 64 over 1M columns fill the card
    for rows in (1, 64):
        p = select.plan(rows, 1000000, 1000, SMS)
        assert rows * p.slices >= SMS


def _keys_plain(x):
    """The kernel's key order by numpy: NaN above all, -0 as +0."""
    return select.score_keys(torch.from_numpy(x)).numpy()


def test_score_keys_order():
    """The uint32 keys order floats as their values do, NaN above +inf,
    -0 equal to +0, distinct values distinct."""
    x = np.array([-np.inf, -3.5, -1e-38, -0.0, 0.0, 1e-45, 2.0, np.inf,
                  np.nan], np.float32)
    k = _keys_plain(x)
    assert (np.diff(k[[0, 1, 2, 3, 5, 6, 7, 8]]) > 0).all()
    assert k[3] == k[4] and k[8] == 0xffffffff
    rng = np.random.default_rng(3)
    y = rng.standard_normal(10000).astype(np.float32) * 1e3
    ky = _keys_plain(y)
    assert (np.argsort(ky, kind="stable") == np.argsort(y, kind="stable")
            ).all()


def _case(rng, name):
    """(scores (B, n) f32, k, plan overrides) of one emulated case: small
    slices and buffers, so that rows span many slices and candidates
    both fit and overflow."""
    if name == "k1":
        return rng.standard_normal((3, 1001)).astype(np.float32), 1, {}
    if name == "k_is_n":
        return rng.standard_normal((2, 77)).astype(np.float32), 77, {}
    if name == "odd_n":
        return (rng.standard_normal((2, 4099)).astype(np.float32), 300,
                dict(min_slice=64))
    if name == "all_equal":
        return np.full((2, 5000), 0.25, np.float32), 1000, dict(
            min_slice=256, max_cap=100)
    if name == "one_bin":     # distinct values in one 11-bit bin
        return ((1.0 + 0.24 * rng.random((2, 6000))).astype(np.float32),
                999, dict(min_slice=128, max_cap=50))
    if name == "one_bin_buffered":
        return ((1.0 + 0.24 * rng.random((2, 6000))).astype(np.float32),
                999, dict(min_slice=128))
    if name == "nan_inf_zero":
        x = rng.standard_normal((3, 3001)).astype(np.float32)
        x[:, ::9] = np.nan
        x[:, 1::97] = np.inf
        x[:, 2::89] = -np.inf
        x[:, 3::7] = 0.0
        x[:, 4::11] = -0.0
        return x, 700, dict(min_slice=64, max_cap=100)
    if name == "ties_across_slices":
        x = rng.standard_normal((2, 2000)).astype(np.float32)
        cut = select.plan(2, 2000, 5, SMS, min_slice=64).slice
        x[:, cut - 3:cut + 4] = 9.0   # seven equal tops across a boundary
        x[:, 2 * cut - 1:2 * cut + 1] = 9.0
        return x, 5, dict(min_slice=64)
    if name == "ties_overflow":
        x = (np.round(rng.standard_normal((2, 3000)), 1) + 0.05
             ).astype(np.float32)   # few distinct values, no zero
        return x, 1500, dict(min_slice=64, max_cap=1)
    if name == "wide_buffered":
        return (rng.standard_normal((4, 20003)).astype(np.float32), 100,
                dict(min_slice=512))
    raise ValueError(name)


SELECT_CASES = ["k1", "k_is_n", "odd_n", "all_equal", "one_bin",
                "one_bin_buffered", "nan_inf_zero", "ties_across_slices",
                "ties_overflow", "wide_buffered"]


def _as_lax_order(vals, pos):
    """JAX's rows with runs of equal values (+-0 together) in position
    order: lax.top_k's order where -0 == +0."""
    vals, pos = vals.copy(), pos.copy()
    for r in range(vals.shape[0]):
        key = np.where(vals[r] == 0, np.float32(0), vals[r])
        nan = np.isnan(key)
        order = np.lexsort((pos[r], -np.where(nan, np.inf, key), ~nan))
        vals[r], pos[r] = vals[r][order], pos[r][order]
    return vals, pos


@pytest.mark.parametrize("name", SELECT_CASES)
def test_sliced_select_matches_lax_top_k(name):
    """K13's sliced passes (per-slice first-digit counts, the filter into
    winners and candidates, the candidates' digit passes over the key and
    position bits, buffered or, where a slice overflowed, read from the
    row again) against the plain
    version and jax.lax.top_k: positions and value bits equal, for k 1
    and k = n, widths that are no multiple of 4, a row of one value and
    one packed into one 11-bit bin, NaN, +-inf and +-0, and equal values
    across slice boundaries."""
    rng = np.random.default_rng(len(name))
    x, k, over = _case(rng, name)
    b, n = x.shape
    p = select.plan(b, n, k, SMS, **over)
    vals, pos, info = select.sliced_select(torch.from_numpy(x), k, p=p)
    want_v, want_p = select.select_topk_plain(torch.from_numpy(x), k)
    assert torch.equal(pos, want_p)
    assert np.array_equal(vals.numpy().view(np.int32),
                          want_v.numpy().view(np.int32))
    jv, jp = jax.lax.top_k(jnp.asarray(x), k)
    jv, jp = _as_lax_order(np.asarray(jv), np.asarray(jp))
    assert np.array_equal(pos.numpy(), jp)
    assert np.array_equal(np.where(vals.numpy() == 0, 0, vals.numpy())
                          .view(np.int32),
                          np.where(jv == 0, 0, jv).view(np.int32))
    assert np.array_equal(vals.numpy().view(np.int32),
                          x[np.arange(b)[:, None], pos.numpy()]
                          .view(np.int32))
    # the path each case is meant to take
    paths = {"k_is_n": "take_all", "all_equal": "overflow",
             "one_bin": "overflow", "one_bin_buffered": "buffered",
             "ties_overflow": "overflow", "wide_buffered": "buffered"}
    for row in info:
        path = ("take_all" if row["take_all"] else
                "buffered" if row["buffered"] else "overflow")
        assert paths.get(name, path) == path
    if name in ("all_equal", "ties_across_slices"):
        assert p.slices > 1
        # the equal values' lowest positions win, whichever slice holds them
        assert (np.diff(pos.numpy(), axis=1) > 0).all()


@pytest.mark.parametrize("name", SELECT_CASES)
def test_slice_candidates_match_the_emulation(name):
    """The filter's per-slice candidate counts (`slice_candidates`, what the
    card tests use to show a case overflows) agree with the emulation: a
    row is buffered exactly where no slice holds more than the plan's
    cap, and its candidates are d0's whole bin."""
    rng = np.random.default_rng(len(name))
    x, k, over = _case(rng, name)
    b, n = x.shape
    p = select.plan(b, n, k, SMS, **over)
    counts = select.slice_candidates(torch.from_numpy(x), k, p)
    assert counts.shape == (b, p.slices)
    _, _, info = select.sliced_select(torch.from_numpy(x), k, p=p)
    for row, c in zip(info, counts):
        if row["take_all"]:
            assert int(c.sum()) == 0
            continue
        assert int(c.sum()) == row["bin0"]
        assert row["buffered"] == (int(c.max()) <= p.cap)


@pytest.mark.parametrize("seed", range(6))
def test_sliced_select_random_rows(seed):
    """Random rows of few distinct values (ties everywhere), random k,
    slice widths and per-slice buffer sizes: the emulation equals the
    plain version."""
    rng = np.random.default_rng(100 + seed)
    b, n = int(rng.integers(1, 5)), int(rng.integers(1, 5000))
    x = rng.integers(-20, 20, (b, n)).astype(np.float32) / 4
    k = int(rng.integers(1, n + 1))
    p = select.plan(b, n, k, SMS, min_slice=int(rng.integers(4, 600)),
                    max_cap=int(rng.integers(1, 200)))
    vals, pos, _ = select.sliced_select(torch.from_numpy(x), k, p=p)
    want_v, want_p = select.select_topk_plain(torch.from_numpy(x), k)
    assert torch.equal(pos, want_p) and torch.equal(vals, want_v)


# ------------------------------------------------------------ K10's plan

@pytest.mark.parametrize("d", [4, 8, 12, 100, 128, 384, 512, 1000, 1024])
def test_update_plan_every_width(d):
    """Every width K10 takes: the combine's runs of a row's float4 columns
    (padded to whole warps) fit one CTA of 1,024 threads, four runs where
    they fit; the scratch holds the cluster totals, the sort's tile counts
    (2,048-row tiles, counts padded to 8, up to 2,048 clusters; 1,024-row
    tiles above), the offsets, the sorted row ids and each sum CTA's head
    and tail sums, and grows with n."""
    grid = 4 * SMS
    d4p = -(-(d // 4) // 32) * 32
    for c in (1, 2, 511, 1000, 2048, 2049, 5000):
        prev = 0
        for n in (1, 63, 64, 65, 2047, 2048, 2049, 261245, 1000000):
            p = kmeans.update_plan(n, d, c, grid)
            assert p.combine_groups * d4p <= 1024
            assert p.combine_groups == min(4, 1024 // d4p) >= 1
            one_pass = c <= 2048
            tiles = -(-n // (2048 if one_pass else 1024))
            stride = -(-c // 8) * 8 if one_pass else c
            parts = 4 * (c + tiles * stride + c + 1 + n + 2 * grid * d
                         + grid)
            assert parts <= p.scratch_bytes < parts + 7 * 16
            assert p.scratch_bytes >= prev
            prev = p.scratch_bytes


def _assignments(rng, how, n, c):
    if how == "uniform":
        return rng.integers(0, c, n)
    if how == "skewed":     # half in one list, every eighth list empty
        live = np.array([j for j in range(1, c) if j % 8 != 0])
        a = live[rng.integers(0, len(live), n)]
        a[rng.permutation(n)[:n // 2]] = 0
        return a
    if how == "one":
        return np.zeros(n, np.int64)
    if how == "identity":
        return rng.permutation(n)
    if how == "dropped":    # ids past the clusters are left out
        a = rng.integers(0, c + 3, n)
        a[::17] = -1
        return a
    raise ValueError(how)


@pytest.mark.parametrize("n", [1, 255, 256, 257, 2048, 2049, 7000])
@pytest.mark.parametrize("how", ["uniform", "skewed", "one", "identity",
                                 "dropped"])
def test_sort_order_is_a_stable_sort(n, how):
    """The one-pass sort's slots (cluster-major scan of the tiles'
    counts, each warp's offset, each row's rank among its warp's earlier
    rows of its cluster) place every kept row once, in stable cluster
    order, across warp and tile boundaries."""
    rng = np.random.default_rng(n)
    c = n if how == "identity" else min(300, max(9, n))
    a = torch.from_numpy(_assignments(rng, how, n, c).astype(np.int32))
    got = kmeans.sort_order(a, c)
    keep = (a >= 0) & (a < c)
    want = torch.nonzero(keep).flatten()[
        torch.argsort(a[keep].long(), stable=True)]
    assert torch.equal(got, want)


@pytest.mark.parametrize("grid", [1, 7, 528])
@pytest.mark.parametrize("how", ["uniform", "skewed", "one", "identity"])
def test_segments_cover_every_row(how, grid):
    """The sum launch's ranges cut every cluster's sorted rows into
    segments, one a range it meets, in range order, that tile its rows
    exactly; a range holds at most one segment of a cluster that starts
    before it (its head) and one of a cluster that runs past it (its
    tail); empty clusters have none."""
    rng = np.random.default_rng(grid)
    n, c = 30000, 300
    counts = torch.bincount(torch.from_numpy(
        _assignments(rng, how, n, c if how != "identity" else n)),
        minlength=c if how != "identity" else n)
    offsets = torch.zeros(counts.numel() + 1, dtype=torch.long)
    offsets[1:] = torch.cumsum(counts, 0)
    per = -(-n // grid)
    heads, tails = set(), set()
    for k, segs in enumerate(kmeans.segments(offsets, grid)):
        lo, hi = int(offsets[k]), int(offsets[k + 1])
        assert (segs == []) == (lo == hi)
        if not segs:
            continue
        assert segs[0][1] == lo and segs[-1][2] == hi
        for (i, a, b), (j, a2, _) in zip(segs, segs[1:]):
            assert j == i + 1 and b == a2 == j * per
        for i, a, b in segs:
            assert i * per <= a < b <= (i + 1) * per
        if len(segs) > 1:
            assert segs[0][0] not in tails
            tails.add(segs[0][0])
            for i, _, _ in segs[1:]:
                assert i not in heads
                heads.add(i)


def _lloyd_case(rng, name):
    """(x (n, d) f32, nlist, seed) of one Lloyd-step case; the first
    nlist rows of default_rng(seed).permutation(n) are the reference's
    initial centroids, which the data is built around."""
    seed = 7
    if name == "one_cluster":
        n, d, c = 3001, 16, 1
    elif name == "c_equals_n":
        n, d, c = 200, 8, 200
    elif name == "all_but_one":
        n, d, c = 4000, 12, 2
    elif name == "empty_clusters":
        n, d, c = 5000, 24, 40
    elif name == "skewed":
        n, d, c = 20000, 32, 64
    elif name.startswith("width_"):
        n, d, c = 3000, int(name[6:]), 37
    else:
        raise ValueError(name)
    perm = np.random.default_rng(seed).permutation(n)
    x = rng.standard_normal((n, d)).astype(np.float32)
    if name == "all_but_one":   # one far row, the first initial centroid
        x = (0.1 * x).astype(np.float32)
        x[perm[0]] = 50.0
    elif name == "empty_clusters":  # duplicate initial centroids get none
        for j in range(1, c, 5):
            x[perm[j]] = x[perm[j - 1]]
    elif name == "skewed":      # half the rows about one initial centroid
        half = perm[c:][: n // 2]
        x[half] = x[perm[0]] + 0.01 * x[half]
    return x, c, seed


LLOYD_CASES = ["one_cluster", "c_equals_n", "all_but_one", "empty_clusters",
               "skewed", "width_4", "width_100", "width_384", "width_1024"]


@pytest.mark.parametrize("spherical", [False, True])
@pytest.mark.parametrize("name", LLOYD_CASES)
def test_ranged_update_matches_jax_lloyd_step(name, spherical):
    """K10's range sums and fixed-order combine (over 528 ranges, as on
    an H100, and over 5), one Lloyd step from the reference's initial
    centroids on the reference's assignment, against
    `train_kmeans(iters=1)` and against the plain version: one cluster,
    one list a row, one list holding all rows but one, empty lists (their
    centroids kept), half the rows in one list, widths 4 to 1024."""
    rng = np.random.default_rng(len(name))
    x, c, seed = _lloyd_case(rng, name)
    n = x.shape[0]
    init = x[np.random.default_rng(seed).permutation(n)[:c]]
    want = jindex.train_kmeans(x, c, iters=1, seed=seed,
                               spherical=spherical)
    assign = np.asarray(jindex.assign_lists(x, init))
    xt, at, it = (torch.from_numpy(v) for v in (x, assign, init))
    got = kmeans.ranged_update(xt, at, it, spherical, grid=4 * SMS)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    np.testing.assert_allclose(
        kmeans.ranged_update(xt, at, it, spherical, grid=5).numpy(), want,
        **F32)
    np.testing.assert_allclose(
        got.numpy(), kmeans.kmeans_update_plain(xt, at, it, spherical),
        **F32)
    counts = np.bincount(assign, minlength=c)
    assert np.array_equal(got.numpy()[counts == 0], init[counts == 0])
    if name == "all_but_one":
        assert sorted(counts.tolist()) == [1, n - 1]
    if name == "empty_clusters":
        assert (counts == 0).sum() >= 7
    if name == "skewed":
        assert counts.max() >= n // 2
