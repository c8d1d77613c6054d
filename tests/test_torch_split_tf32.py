"""The 3xTF32 arithmetic of K3's float32 mode and K9, on the CPU.

The kernels split each f32 operand into tf32 hi = rna(x) and lo = rna(x -
hi) and accumulate hi.hi + hi.lo + lo.hi in f32 on the tensor cores.
kernels/tf32.py emulates that product in plain PyTorch; here it goes
through K9's tiling (kmeans.kmeans_assign_3xtf32: zero-padded centroid
tiles, dead padded columns) and K3's float32 mode
(topk.blockwise_topk_3xtf32) and is held against the JAX package's f32
functions on seeded numpy inputs:
`code2vec_tpu/retrieval/index.py` `_assign_jax` and
`code2vec_tpu/ops/topk.py` `blockwise_matmul_top_k(compute_dtype=float32)`.

Tolerances, chip_smoke.py's, unchanged:
- TOL_ASSIGN (1e-5, relative, the distance scale clamped at 1): an
  assignment may differ from the reference's only where the two
  centroids' distances lie within it of each other.
- TOL_F32SUM (atol 1e-5, rtol 1e-4): top-k values and the logsumexp;
  indices equal except where the reference's neighbouring values lie
  within it of each other.

The wrappers' host-side planning is checked here too: K3's N tile for
every batch of 1 to 1024, its runs over a ragged number of table rows,
and K9's dead padded centroid columns.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from code2vec_tpu.ops import topk as jtopk
from code2vec_tpu.retrieval import index as jindex
from code2vec_tpu_torch.kernels import kmeans, tf32, topk

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

TOL_ASSIGN = 1e-5
TOL_F32SUM = (1e-5, 1e-4)
SMS = 132  # an H100's SMs


def _np_rna(x):
    """Round-to-nearest-away at tf32 by integer arithmetic on the bits."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    r = ((u + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF
    return r.astype(np.uint32).view(np.float32)


def test_round_tf32_is_rna_at_the_tenth_mantissa_bit():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4096) * 10.0 ** rng.uniform(-30, 30, 4096)
         ).astype(np.float32)
    got = tf32.round_tf32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), _np_rna(x).view(
        np.uint32))
    assert not (got.view(np.uint32) & 0x1FFF).any()
    assert (np.abs(got - x) <= 2.0 ** -11 * np.abs(x)).all()
    # halfway cases go away from zero; NaN and infinities pass through
    half = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -11],
                    dtype=np.float32)
    np.testing.assert_array_equal(
        tf32.round_tf32(torch.from_numpy(half)).numpy(),
        np.array([1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1 + 2 * 2.0 ** -10],
                 dtype=np.float32))
    special = torch.tensor([float("nan"), float("inf"), float("-inf")])
    out = tf32.round_tf32(special)
    assert torch.isnan(out[0]) and out[1] == math.inf and out[2] == -math.inf


@pytest.mark.parametrize("d", [8, 128, 384])
def test_split_product_carries_f32_precision(d):
    """hi + lo carries ~22 mantissa bits, so the three products miss the
    exact dot by ~2^-21 of sum |x y|: f32's rounding, where one tf32
    product (2^-11) would not do."""
    rng = np.random.default_rng(d)
    a = rng.standard_normal((64, d)).astype(np.float32)
    b = rng.standard_normal((48, d)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64).T
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64).T
    got = tf32.matmul_3xtf32(torch.from_numpy(a), torch.from_numpy(b))
    err = np.abs(got.numpy() - exact) / scale
    assert err.max() < 2.0 ** -19
    one = tf32.round_tf32(torch.from_numpy(a)) @ tf32.round_tf32(
        torch.from_numpy(b)).T
    assert (np.abs(one.numpy() - exact) / scale).max() > 2.0 ** -15
    hi, lo = tf32.split_tf32(torch.from_numpy(a))
    assert (np.abs((hi + lo).numpy() - a) <= 2.0 ** -21 * np.abs(a)).all()


def _assign_gaps(x, c, got, want):
    """(rows that differ away from a near-tie, the largest gap), the
    distances in float64 as chip_smoke.py's assign_agreement takes them."""
    rows = np.nonzero(got != want)[0]
    if rows.size == 0:
        return 0, 0.0
    xd, cd = x[rows].astype(np.float64), c.astype(np.float64)

    def dist(idx):
        cc = cd[idx]
        return (cc * cc).sum(1) - 2 * (xd * cc).sum(1)

    dg, dw = dist(got[rows]), dist(want[rows])
    gap = np.abs(dg - dw)
    scale = np.maximum(np.maximum(np.abs(dg), np.abs(dw)), 1.0)
    return int((gap > TOL_ASSIGN * scale).sum()), float(gap.max())


@pytest.mark.parametrize("n,d,c,normalise", [
    (3000, 384, 37, True),    # the index's spherical rows
    (2500, 384, 129, True),   # one live column in the last centroid tile
    (4000, 64, 511, False),   # the MIPS head's nlist: one dead column
    (1003, 16, 1, False),     # one centroid: 127 dead columns
    (700, 8, 300, False),
])
def test_kmeans_assign_3xtf32_against_jax(n, d, c, normalise):
    rng = np.random.default_rng(n + c)
    x = rng.standard_normal((n, d)).astype(np.float32)
    if normalise:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    cent = x[rng.permutation(n)[:c]].copy()
    cent += 0.01 * rng.standard_normal(cent.shape).astype(np.float32)
    if c > 2:
        cent[1] = cent[0]   # duplicated: ties go to the lower index
    got = kmeans.kmeans_assign_3xtf32(torch.from_numpy(x),
                                      torch.from_numpy(cent)).numpy()
    want = np.asarray(jindex._assign_jax(jnp.asarray(x), jnp.asarray(cent)))
    bad, gap = _assign_gaps(x, cent, got, want)
    assert bad == 0, f"{bad} assignments differ away from near-ties ({gap})"
    assert got.max() < c
    if c > 2:
        assert not (got == 1).any()


def test_kmeans_assign_3xtf32_never_picks_a_dead_column():
    """Rows whose real distances are all positive: a zero centroid in the
    padding would be nearest (distance 0) if its column were live."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((500, 32)).astype(np.float32)
    cent = -5.0 * np.abs(rng.standard_normal((3, 32))).astype(np.float32)
    cent[:, ::2] *= -1.0
    xt, ct = torch.from_numpy(x), torch.from_numpy(cent)
    dots = tf32.matmul_3xtf32(xt, ct)
    assert ((ct * ct).sum(1)[None, :] - 2 * dots > 0).all()
    p = kmeans.assign_plan(500, 32, 3, SMS)
    assert p.dead_columns == kmeans.CENTROID_TILE - 3
    got = kmeans.kmeans_assign_3xtf32(xt, ct)
    assert int(got.max()) < 3
    assert torch.equal(got, kmeans.kmeans_assign_plain(xt, ct))


@pytest.mark.parametrize("n_cent,tiles,dead", [
    (1, 1, 127), (128, 1, 0), (129, 2, 127), (511, 4, 1), (1000, 8, 24)])
def test_assign_plan_dead_columns(n_cent, tiles, dead):
    p = kmeans.assign_plan(1_000_000, 384, n_cent, SMS)
    assert (p.centroid_tiles, p.dead_columns) == (tiles, dead)
    assert p.k_blocks == 12 and p.row_tiles == 7813 and p.grid == SMS


def _topk_check(got, want, k):
    nxt = want.values[:, k]
    w_v, w_i = want.values[:, :k], want.indices[:, :k]
    np.testing.assert_allclose(got.values.numpy(), w_v, atol=TOL_F32SUM[0],
                               rtol=TOL_F32SUM[1])
    np.testing.assert_allclose(got.lse.numpy(), want.lse,
                               atol=TOL_F32SUM[0], rtol=TOL_F32SUM[1])
    v = w_v.astype(np.float64)
    gap_prev = np.full_like(v, np.inf)
    gap_next = np.full_like(v, np.inf)
    gap_prev[:, 1:] = np.abs(v[:, 1:] - v[:, :-1])
    gap_next[:, :-1] = np.abs(v[:, 1:] - v[:, :-1])
    gap_next[:, -1] = np.abs(nxt - v[:, -1])
    near = np.minimum(gap_prev, gap_next) <= TOL_F32SUM[0] + TOL_F32SUM[1] \
        * np.abs(v)
    diff = got.indices.numpy() != w_i
    assert not (diff & ~near).any()


@pytest.mark.parametrize("b,v,valid,k", [
    (1, 1000, 1000, 10), (12, 3001, 2990, 16), (64, 5000, 4999, 64),
    (65, 777, 777, 1)])
def test_blockwise_topk_3xtf32_against_jax(b, v, valid, k):
    rng = np.random.default_rng(b * v)
    rows = rng.standard_normal((v, 384)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    rows[[5, 17]] = rows[3]                  # identical rows
    q = rows[rng.choice(valid, b)] + 0.05 * rng.standard_normal(
        (b, 384)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    want = jtopk.blockwise_matmul_top_k(
        jnp.asarray(q), jnp.asarray(rows), k + 1, 256, valid_rows=valid,
        compute_dtype=jnp.float32)
    want = type(want)(*(np.asarray(x) for x in want))
    got = topk.blockwise_topk_3xtf32(torch.from_numpy(q),
                                     torch.from_numpy(rows), k,
                                     valid_rows=valid)
    assert (got.indices.numpy() < valid).all()
    _topk_check(got, want, k)


def _smem(per_tile: int, per_stage: int):
    """A stand-in for the kernel's layout (c2v_topk_smem, which needs the
    built library): bytes per code vector of the N tile and per ring
    stage."""
    return lambda n, stages: n * per_tile + stages * per_stage


def test_topk_plan_n_tile_for_every_batch():
    """The smallest N tile of 8, 16, 32 that holds the batch; larger
    batches in chunks of 32, or of 64 above the serving batch of 64 in the
    bf16 mode; the runs leave one CTA per SM."""
    fits = _smem(1000, 10000)
    for f32 in (False, True):
        for b in range(1, 1025):
            top = 64 if b > 64 and not f32 else 32
            p = topk.plan(b, f32, 261_246, SMS, fits)
            assert p.n_tile in topk.N_TILES and p.n_tile <= top
            assert p.n_tile >= min(b, top)
            assert p.n_tile == 8 or p.n_tile // 2 < min(b, top)
            assert p.b_chunks == -(-b // p.n_tile)
            assert p.grid == p.runs * p.b_chunks <= SMS
            assert p.partials == 2 * p.runs
            assert p.smem <= topk.SMEM_LIMIT and p.stages == 4
            assert p.smem == fits(p.n_tile, 4)
    assert topk.plan(12, False, 261_246, SMS, fits).n_tile == 16
    p = topk.plan(64, False, 261_246, SMS, fits)
    assert (p.n_tile, p.b_chunks, p.runs) == (32, 2, 66)
    p = topk.plan(1024, False, 261_246, SMS, fits)
    assert (p.n_tile, p.b_chunks, p.runs) == (64, 16, 8)


@pytest.mark.parametrize("f32,limit,n_tile,stages", [
    (False, 200_000, 64, 4), (False, 90_000, 64, 2), (False, 75_000, 32, 4),
    (True, 75_000, 32, 4), (True, 60_000, 32, 2), (True, 40_000, 16, 2),
])
def test_topk_plan_shrinks_to_fit_shared_memory(f32, limit, n_tile, stages):
    """Four ring stages before two, then the N tile halved, until a CTA's
    shared memory fits (the bytes per tile and per stage stand in for the
    kernel's layout, which tests/test_torch_kernels_cuda.py reads)."""
    smem = _smem(1000, 10000)
    p = topk.plan(128, f32, 261_246, SMS, smem, limit)
    assert (p.n_tile, p.stages) == (n_tile, stages)
    assert p.smem == smem(n_tile, stages) <= limit


def test_topk_plan_refuses_when_no_tile_fits():
    with pytest.raises(ValueError, match="no tile fits"):
        topk.plan(128, False, 261_246, SMS, _smem(1000, 10000), 20_000)


@pytest.mark.parametrize("v", [1, 63, 64, 65, 4097, 261_246, 1_000_000])
def test_topk_runs_cover_ragged_tables_once(v):
    """Run r owns tiles [T r / R, T (r + 1) / R) (csrc/topk.cu): every
    64-row tile once, the last one ragged, empty runs only where there
    are fewer tiles than runs (never, as planned)."""
    p = topk.plan(64, False, v, SMS, _smem(1000, 10000))
    tiles = -(-v // topk.TILE_ROWS)
    bounds = [tiles * r // p.runs for r in range(p.runs + 1)]
    assert bounds[0] == 0 and bounds[-1] == tiles
    assert all(hi > lo for lo, hi in zip(bounds, bounds[1:]))
    rows = sum(min(v, hi * 64) - lo * 64 for lo, hi in zip(bounds,
                                                            bounds[1:]))
    assert rows == v
