"""K2's and K11's host-side plans and chunked arithmetic, on the CPU.

K2 (kernels/attention.py) runs a thread-block cluster of C CTAs per batch
row, each owning a chunk of the row's contexts; K11 (kernels/ivf.py)
scans each probed list in chunks of R rows and merges the chunks' top-k
lists by a 64-bit key order. The CUDA kernels run only on the card; here
their plans (`attention.plan`, `ivf.plan`) are checked for every batch
and context count the wrappers may see, and their arithmetic, emulated
chunk by chunk in plain PyTorch (`attention.split_softmax`,
`ivf.ivf_search_chunked`), is held against the JAX package on the same
seeded numpy inputs:
`code2vec_tpu/ops/attention.py` `masked_single_query_attention`,
`code2vec_tpu/retrieval/mips.py` `MipsHead.topk_fn` and
`code2vec_tpu/retrieval/index.py` `NeighborIndex._search_ivf`.

Tolerances, ROADMAP's parity bar: f32 results rtol 1e-5, atol 1e-6
(attention weights, scores); code vectors summed from bf16-rounded
weights and contexts atol 2e-2, rtol 1e-2 (one bf16 weight may round the
other way where f32 sums are taken in another order); top-k indices equal
except where the reference's neighbouring values lie within the f32
tolerance of each other.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from code2vec_tpu.ops.attention import masked_single_query_attention
from code2vec_tpu.retrieval import mips as jmips
from code2vec_tpu_torch.kernels import attention, ivf, launch
from code2vec_tpu_torch.ops.quant import FP8_DTYPES
from code2vec_tpu_torch.retrieval import mips as tmips

from test_torch_retrieval import _build, _clustered, _load, _write_store

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=1e-2, atol=2e-2)
SMS = 132  # an H100's SMs
FORMATS = {"f32": launch.FMT_F32, "int8": launch.FMT_INT8,
           "e4m3": launch.FMT_E4M3, "e5m2": launch.FMT_E5M2,
           "int4": launch.FMT_INT4}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------ K2's plan


@pytest.mark.parametrize("d", [8, 128, 384, 512])
def test_attention_plan_every_batch_and_context_count(d):
    """B 1-1024 x M 1-201: C a power of two up to 8, the grid b x C (a
    multiple of C), the chunks cover the row, the contexts are staged and
    the CTA's shared memory fits; C stops doubling once b x C covers the
    SMs (or C reaches M or 8) and a chunk takes at most a quarter of what
    a block may use."""
    limit = attention.SMEM_LIMIT
    for b in range(1, 1025):
        for m in range(1, 202):
            p = attention.plan(b, m, d, limit, SMS)
            assert p.cluster in (1, 2, 4, 8)
            assert p.grid == b * p.cluster and p.grid % p.cluster == 0
            assert p.chunk == -(-m // p.cluster)
            assert p.staged and p.smem <= limit
            assert p.smem == attention.smem_bytes(p.chunk, d, True)
            quarter = p.smem <= limit // 4
            assert p.cluster == 8 or p.cluster >= m or (
                b * p.cluster >= SMS and quarter)
            if p.cluster > 1:  # the cluster half as large would not do
                c = p.cluster // 2
                assert b * c < SMS or attention.smem_bytes(
                    -(-m // c), d, True) > limit // 4


def test_attention_plan_at_the_measured_shapes():
    """C 8 at the MIPS batch (B 8) and at B 1, 4 at serving (B 64) and at
    train (B 1024: C 2 would stage 77 KB a CTA, over a quarter of 227 KB);
    a row too long to stage reads device memory."""
    assert attention.plan(8, 200, 384)[::4] == (8, 64)
    assert attention.plan(1, 200, 384)[::4] == (8, 8)
    assert attention.plan(64, 200, 384)[:3] == (4, 50, True)
    assert attention.plan(64, 32, 384)[:3] == (4, 8, True)
    assert attention.plan(1024, 200, 384)[:3] == (4, 50, True)
    assert attention.plan(1024, 200, 384).grid == 4096
    big = attention.plan(2, 60000, 384)
    assert (big.cluster, big.staged) == (8, False)
    assert big.smem <= attention.SMEM_LIMIT
    # every row length the kernel before clusters took still plans
    assert attention.plan(1, 57000, 384).smem <= attention.SMEM_LIMIT


# ------------------------------------------------- K2's split softmax


def _attention_inputs(seed, b, m, d, dtype):
    rng = np.random.default_rng(seed)
    t = np.tanh(rng.standard_normal((b, m, d))).astype(np.float32)
    a = rng.standard_normal(d).astype(np.float32)
    mask = (rng.random((b, m)) > 0.4).astype(np.float32)
    mask[0] = 0.0                 # an all-invalid (padded) row
    if b > 1:
        mask[1] = 0.0             # one valid context
        mask[1, m // 2] = 1.0
    if b > 2:
        t[2, 0, 3] = np.nan       # a NaN context: the row goes NaN
        mask[2, 0] = 1.0
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return (jnp.asarray(t).astype(jdt), jnp.asarray(a), jnp.asarray(mask),
            torch.from_numpy(t).to(tdt), torch.from_numpy(a),
            torch.from_numpy(mask))


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("b,m", [(5, 1), (6, 25), (4, 32), (3, 201)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_softmax_matches_jax(cluster, b, m, dtype):
    """K2's arithmetic by chunks (empty ones where m < C or m is no
    multiple of C) against the reference: the weights at the f32 bar, the
    code vector at the f32 bar (f32 contexts) or the bf16 bar; zeros for
    the all-masked row, weight 1 on a single valid context, NaN where a
    context is NaN."""
    jt, ja, jmask, t, a, mask = _attention_inputs(cluster * 10 + m, b, m,
                                                  24, dtype)
    jcv, jattn = masked_single_query_attention(jt, ja, jmask)
    cv, attn = attention.split_softmax(t, a, mask, cluster)
    np.testing.assert_allclose(_np(attn), _np(jattn), **F32)
    np.testing.assert_allclose(_np(cv), _np(jcv),
                               **(F32 if dtype == "float32" else BF16))
    assert not _np(attn)[0].any() and not _np(cv)[0].any()
    if b > 1:
        assert _np(attn)[1, m // 2] == 1.0
    if b > 2:
        assert np.isnan(_np(attn)[2]).all() and np.isnan(_np(cv)[2]).all()


# ----------------------------------------------------------- K11's plan


def _chunks(length, r):
    """The row ranges the scan kernel gives a list of `length` rows
    (csrc/ivf_search.cu `chunks_of_len`, scan_kernel's r0 and n)."""
    nch = max(1, -(-length // r))
    return [(c * r, max(0, min(length, c * r + r))) for c in range(nch)]


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("d", [12, 100, 384, 512])
@pytest.mark.parametrize("b", [1, 2, 8, 64, 65, 1024])
def test_ivf_plan_chunks_cover_every_row(fmt, d, b):
    """For lists of 0, 1, 513 and ragged lengths: R is one of 128, 64,
    32, 16 and its chunk stays within 64 KB; the chunks of every list
    cover each row once (an empty list still gets one empty chunk, which
    reports to its queries); no list needs more chunks than the grid
    gives it (cpl), and no query more partial lists than it holds."""
    lens = [0, 1, 513, 17, 128, 129, 300, 64]
    nprobe = 4 if b > 64 else len(lens)
    p = ivf.plan(b, nprobe, max(lens), FORMATS[fmt], d, k=10,
                 nlist=len(lens), n_rows=sum(lens))
    r = p.rows_per_chunk
    assert r in ivf.CHUNK_ROWS
    assert r * ivf.row_bytes(FORMATS[fmt], d) <= ivf.CHUNK_BYTES
    assert p.chunks_per_list == -(-max(lens) // r)
    for length in lens:
        spans = _chunks(length, r)
        covered = [i for lo, hi in spans for i in range(lo, hi)]
        assert covered == list(range(length))
        assert len(spans) <= p.chunks_per_list
    assert p.max_parts == nprobe * p.chunks_per_list
    assert p.max_parts >= sum(sorted(len(_chunks(x, r)) for x in lens)
                              [-nprobe:])
    assert p.scan_grid == b * nprobe * p.chunks_per_list
    assert p.select_grid == b and p.counters == -(-b // 64) + b
    assert p.probe_grid == (1, -(-b // 64))
    assert p.grouped == (b > 1)
    assert p.scan_smem == ivf.scan_smem(FORMATS[fmt], d, r,
                                        min(b, 16)) <= 232448
    assert p.select_smem == ivf.select_smem(b, len(lens), nprobe, p.grouped)


def test_ivf_plan_at_the_measured_shapes():
    """The MIPS head (261,245 int8 rows, nlist 511, nprobe 16): chunks of
    32 at B 1 (16 lists x 16 chunks cover the SMs), 128 at B 8 and 64,
    grouped above B 1; the 1M f32 index (nlist 1000): 32 (a 64-row chunk
    of 1,536-byte rows would pass 64 KB); nprobe = nlist at B 64 is too
    many slots to group in shared memory."""
    mips = dict(k=10, nlist=511, n_rows=261245)
    i8 = launch.FMT_INT8
    assert ivf.plan(1, 16, 1200, i8, 384, **mips)[:3] == (32, 38, False)
    assert ivf.plan(8, 16, 1200, i8, 384, **mips)[:3] == (128, 10, True)
    assert ivf.plan(64, 16, 1200, i8, 384, **mips)[:3] == (128, 10, True)
    assert not ivf.plan(64, 511, 1200, i8, 384, **mips).grouped
    idx = dict(k=16, nlist=1000, n_rows=1_000_000)
    for b in (1, 64):
        assert ivf.plan(b, 16, 2500, launch.FMT_F32, 384,
                        **idx).rows_per_chunk == 32


# --------------------------------------------- K11's chunked emulation


def _close_topk(got_i, got_v, want_i, want_v):
    """Values at the f32 bar; indices equal except at near-ties of the
    reference's values."""
    got_i, want_i = np.asarray(got_i), np.asarray(want_i)
    got_v, want_v = np.asarray(got_v, np.float64), np.asarray(want_v,
                                                              np.float64)
    np.testing.assert_allclose(got_v, want_v, **F32)
    for r, c in zip(*np.nonzero((got_i != want_i) & np.isfinite(want_v))):
        near = [abs(want_v[r, c] - want_v[r, j]) <= 1e-6 + 1e-5 * abs(
            want_v[r, c]) for j in (c - 1, c + 1) if 0 <= j < want_v.shape[1]]
        assert any(near), (r, c, got_i[r], want_i[r])


def _mips_tables(scheme, table):
    """(JAX table, port table, (V, 1) scales, int4 width)."""
    import ml_dtypes
    from code2vec_tpu.ops import quant as jquant
    if scheme == "int8":
        q, s = jquant.quantize_rows(table)
        return q, torch.from_numpy(q), s, None
    if scheme == "int4":
        q, s = jquant.quantize_rows_int4(table)
        return q, torch.from_numpy(q), s, table.shape[1]
    q, s = jquant.quantize_rows_fp8(table, scheme)
    ml = {"e4m3": ml_dtypes.float8_e4m3fn, "e5m2": ml_dtypes.float8_e5m2}
    return (q.view(ml[scheme]), torch.from_numpy(q).view(FP8_DTYPES[scheme]),
            s, None)


@pytest.mark.parametrize("scheme", ["int8", "e4m3", "e5m2", "int4"])
@pytest.mark.parametrize("rows_per_chunk", [16, 32, 128])
def test_chunked_mips_matches_jax(scheme, rows_per_chunk):
    """The MIPS head's lists scanned chunk by chunk and merged by key,
    against MipsHead.topk_fn of the JAX package: 40 copies of one row
    (one list, across chunk boundaries), a zero query (every score 0:
    candidate order), a NaN query (NaN first) and the head over every
    list; k above the candidates gives -inf with id 0."""
    rng = np.random.default_rng(len(scheme) + rows_per_chunk)
    v, d, real = 700, 16, 690
    table = rng.normal(size=(v, d)).astype(np.float32)
    table[100:140] = table[99]
    jt, tt, s, int4_dim = _mips_tables(scheme, table)
    kw = dict(real_vocab=real, nlist=12, nprobe=3, kmeans_iters=6, seed=2)
    jh = jmips.MipsHead.build(jt, s, int4_dim=int4_dim, **kw)
    th = tmips.MipsHead.build(tt, s, device="cpu", **kw)
    cv = rng.normal(size=(6, d)).astype(np.float32)
    cv[0] = 2.0 * table[99]
    cv[1] = 0.0
    cv[2, 5] = np.nan
    for nprobe, k in ((3, 10), (12, 10), (3, 64), (1, 64)):
        want_v, want_i = jh.topk_fn(k, nprobe)(jnp.asarray(cv))
        got_v, got_i = ivf.ivf_search_chunked(
            torch.from_numpy(cv), th._centroids, th._rows, th._offsets,
            nprobe, k, rows_per_chunk=rows_per_chunk, scales=th._scales,
            global_ids=th._global_ids, max_len=th.max_len)
        _close_topk(got_i.numpy(), got_v.numpy(), np.asarray(want_i),
                    np.asarray(want_v))
        dead = np.isneginf(got_v.numpy())
        assert (got_i.numpy()[dead] == 0).all()
        # the copies of row 99 come back in candidate order
        dups = [i for i in got_i.numpy()[0].tolist() if 99 <= i < 140]
        assert dups and dups == sorted(dups)
        assert np.isnan(got_v.numpy()[2][~dead[2]]).all()


@pytest.mark.parametrize("rows_per_chunk", [16, 32, 64])
def test_chunked_index_matches_jax(tmp_path, rows_per_chunk):
    """An f32 index (12 lists of ~40 rows, duplicate rows) searched chunk
    by chunk, against NeighborIndex._search_ivf of the JAX package on the
    same index: store positions, -1 past the candidates; zero queries."""
    pts = _clustered(n_clusters=12, per=40, seed=4)
    pts[100:140] = pts[99]
    _write_store("torch", tmp_path / "store", pts)
    _build("torch", tmp_path / "store", tmp_path / "idx", nlist=12,
           nprobe=3, kmeans_iters=6)
    ji, ti = _load("jax", tmp_path / "idx"), _load("torch", tmp_path / "idx")
    q = np.concatenate([pts[::37], pts[99:100], np.zeros((1, pts.shape[1]),
                                                         np.float32)])
    for nprobe, k in ((3, 10), (12, 16), (1, 64)):
        want_v, want_i = ji._search_ivf(jnp.asarray(q), k, nprobe)
        # past the candidates the reference's top-k gives its sentinel
        # position, which NeighborIndex.search maps to -1, as K11 does
        want_v = np.asarray(want_v)
        want_i = np.where(np.isfinite(want_v), np.asarray(want_i), -1)
        got_v, got_i = ivf.ivf_search_chunked(
            torch.from_numpy(q), ti._centroids, ti._vectors, ti._offsets,
            nprobe, k, rows_per_chunk=rows_per_chunk, max_len=ti._max_len)
        _close_topk(got_i.numpy(), got_v.numpy(), want_i, want_v)
        dead = np.isneginf(got_v.numpy())
        assert (got_i.numpy()[dead] == -1).all()


def test_keys_order_as_lax_top_k():
    """The kernel's 64-bit keys sort as lax.top_k orders: NaN first (by
    index), then larger values, ties to the lower index, -inf last among
    real candidates; above the empty key. -0 ties +0, as in the plain
    version's stable sort (kernels/select.py `top_positions`), which the
    kernel is held to on the card."""
    import jax
    vals = np.array([0.5, np.nan, -2.0, 0.0, -np.inf, 0.5, np.nan, 3.0,
                     -1.0, np.inf, -np.inf, 1e-30, -1e-30], np.float32)
    idx = torch.arange(len(vals))
    keys = ivf._keys(torch.from_numpy(vals), idx)
    got = torch.argsort(keys, descending=True, stable=True).tolist()
    _, want = jax.lax.top_k(jnp.asarray(vals), len(vals))
    assert got == np.asarray(want).tolist()
    assert bool((keys > (0 ^ (-(2 ** 63)))).all())  # above the empty key
    zeros = torch.tensor([-0.0, 0.0, -0.0])
    _, plain = ivf.top_positions(zeros[None, :], 3)
    assert torch.argsort(ivf._keys(zeros, torch.arange(3)), descending=True,
                         stable=True).tolist() == plain[0].tolist()
