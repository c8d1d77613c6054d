"""K1's and K7's host-side plans and split arithmetic, on the CPU.

K1 (kernels/encoder.py, csrc/encoder.cu) walks 64-context tiles with a
persistent CTA per SM, builds each tile's context 64 columns (a K-chunk)
at a time and multiplies it by W rounded to bf16 and laid out as chunks
padded to 64 rows and to column groups of 384; K7 (kernels/softmax_xent.py,
csrc/softmax_xent.cu) runs a thread-block cluster of C CTAs per row, each
holding a slice of the row's 16-byte-aligned interior, and folds the
slices' (max, sum of exp) in rank order. The CUDA kernels run only on
the card; here their plans (`encoder.plan`, `softmax_xent.plan`,
`softmax_xent.row_slices`) are checked over every width and batch the
wrappers may see, and their arithmetic, emulated in plain PyTorch
(`encoder.chunked_product`, `softmax_xent.split_softmax_xent`), is held
against the JAX package on the same seeded numpy inputs:
`code2vec_tpu/models/code2vec.py` `transform_gathered` and
`code2vec_tpu/training/step.py` `_loss_from_logits` under `jax.grad`.

Tolerances, ROADMAP's parity bar: the loss and gradient rtol 1e-5, atol
1e-7 (f32, sums taken in another order); K1's bf16 outputs atol 2e-2,
rtol 1e-2 (one bf16 step where the f32 sums' order flips a rounding).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from code2vec_tpu.config import Config as JaxConfig
from code2vec_tpu.models.code2vec import Code2VecModule as FlaxModule
from code2vec_tpu.models.code2vec import ModelDims as JaxDims
from code2vec_tpu.training.step import TrainStepBuilder as JaxBuilder
from code2vec_tpu_torch.kernels import encoder, softmax_xent

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

XENT = dict(rtol=1e-5, atol=1e-7)
BF16 = dict(rtol=1e-2, atol=2e-2)
SMS = 132  # an H100's SMs


# ------------------------------------------------------------ K1's plan


@pytest.mark.parametrize("d_out", [16, 48, 128, 192, 368, 384, 400, 768,
                                   2048])
def test_encoder_plan_every_width(d_out):
    """Every width the wrapper takes (token and path rows multiples of 4,
    context and code widths multiples of 16), up to a 1,536-wide context
    (the old kernel's shared-memory limit) and 2,048-wide codes: the
    chunks and column groups cover the widths with less than one chunk or
    group of padding. (The shared memory and the W tiles' bytes are the
    kernel's own, c2v_context_encoder_smem and _scratch, which a CUDA
    test holds against `w_tiles_plain`.)"""
    for td in range(4, 772, 4):
        for pd in range(4, 1540 - 2 * td, 4):
            k_dim = 2 * td + pd
            if k_dim % 16:
                continue
            p = encoder.plan(k_dim, d_out)
            assert 0 <= p.chunks * 64 - k_dim < 64
            assert 0 <= p.groups * 384 - d_out < 384


def _jax_transform(rows, transform, dtype):
    """The reference's transform_gathered (no dropout) on pre-gathered
    rows, through the Flax module's own method."""
    src, pth, tgt = rows
    td, pd = src.shape[-1], pth.shape[-1]
    dims = JaxDims(token_vocab_size=8, path_vocab_size=8,
                   target_vocab_size=8, token_dim=td, path_dim=pd)
    dims_code = transform.shape[1]
    assert dims_code == dims.code_dim
    fmod = FlaxModule(dims, compute_dtype=dtype)
    params = fmod.init(jax.random.PRNGKey(0), np.zeros((1, 1), np.int32),
                       np.zeros((1, 1), np.int32), np.zeros((1, 1), np.int32),
                       np.ones((1, 1), np.float32))["params"]
    params = {**params, "transform": jnp.asarray(transform)}
    return fmod.apply({"params": params}, src, pth, tgt,
                      method=FlaxModule.transform_gathered)


@pytest.mark.parametrize("td,pd", [(4, 8), (12, 8), (20, 24), (128, 128),
                                   (36, 56)])
def test_encoder_chunked_product_matches_transform_gathered(td, pd):
    """K1's product, chunk by chunk over W's padded bf16 tiles (the
    context's columns zero past k_dim, W's rows past k_dim and columns
    past d_out zero), against the reference at context widths that are no
    multiple of 64 and code widths that are no multiple of 384."""
    rng = np.random.default_rng(td * 100 + pd)
    b, m = 3, 29
    k_dim = 2 * td + pd
    d_out = k_dim  # the model's code width
    rows = [(0.5 * rng.standard_normal((b, m, w))).astype(np.float32)
            for w in (td, pd, td)]
    transform = (rng.standard_normal((k_dim, d_out)) / np.sqrt(k_dim)
                 ).astype(np.float32)
    want = _jax_transform(rows, transform, jnp.bfloat16)
    ctx = torch.cat([torch.from_numpy(r) for r in rows],
                    dim=-1).to(torch.bfloat16).view(b * m, k_dim)
    acc = encoder.chunked_product(ctx, torch.from_numpy(transform))
    assert acc.shape == (b * m, d_out) and acc.dtype == torch.float32
    got = torch.tanh(acc).to(torch.bfloat16).view(b, m, d_out)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **BF16)


def test_encoder_w_tiles_layout():
    """W's bf16 tiles: chunk kc, row n holds W[64 kc + i, n] for i < 64
    (the K-major B operand of the product), zero past the widths."""
    rng = np.random.default_rng(3)
    k_dim, d_out = 80, 400
    w = torch.from_numpy(rng.standard_normal((k_dim, d_out)
                                             ).astype(np.float32))
    tiles = encoder.w_tiles_plain(w)
    p = encoder.plan(k_dim, d_out)
    assert tiles.shape == (p.chunks, p.groups * 384, 64)
    wb = w.to(torch.bfloat16)
    for kc in range(p.chunks):
        hi = min(k_dim, 64 * kc + 64)
        assert torch.equal(tiles[kc, :d_out, :hi - 64 * kc],
                           wb[64 * kc:hi].T)
        assert not tiles[kc, d_out:].any()
        assert not tiles[kc, :, hi - 64 * kc:].any()


# ------------------------------------------------------------ K7's plan


def _xent_smem(units):
    """A stand-in for the kernel's layout (c2v_softmax_xent_smem, which
    needs the built library; tests/test_torch_kernels_cuda.py plans on
    the real one): a 256-byte header and the slice, at most 8 bulk copies
    of 2,048 16-byte units."""
    return 256 + 16 * units if -(-units // 2048) <= 8 else -1


@pytest.mark.parametrize("v", [1, 2, 3, 4, 5, 7, 17, 1000, 30011, 30012,
                               261245, 261246, 929999, 1_000_000])
def test_xent_plan_every_batch(v):
    """B 1-1024: C a power of two up to 16 (the grid b x C, a multiple of
    C), the ranks' slices cover the row's 16-byte units, a CTA's shared
    memory fits a block; C stops doubling once the slice fits and b x C
    covers the SMs; a row 16 CTAs cannot hold takes the two-read kernel
    (cluster 0)."""
    limit = softmax_xent.SMEM_LIMIT

    def need(c):
        n = _xent_smem(-(-(v // 4) // c))
        return n if n >= 0 else limit + 1

    for b in list(range(1, 140)) + [255, 256, 1023, 1024]:
        p = softmax_xent.plan(b, v, SMS, _xent_smem, limit)
        if p.cluster == 0:
            assert need(16) > limit
            assert p.grid == b
            continue
        assert p.cluster in (1, 2, 4, 8, 16)
        assert p.grid == b * p.cluster and p.grid % p.cluster == 0
        assert p.cluster * p.units >= v // 4
        assert p.smem == _xent_smem(p.units) <= limit
        if p.cluster > 1:
            c = p.cluster // 2
            assert b * c < SMS or need(c) > limit // softmax_xent.SLICE_SHARE


@pytest.mark.parametrize("limit,cluster", [
    (232448, 16), (140000, 16), (60000, 0), (270000, 8)])
def test_xent_plan_follows_the_layout(limit, cluster):
    """At the flagship width (1024 x 261,246) the plan takes the smallest
    C whose slice fits the layout, and the two-read kernel where 16 CTAs'
    slices do not fit; a layout that refuses a slice's piece count (-1)
    counts as not fitting, whatever the limit."""
    v = 261_246
    p = softmax_xent.plan(1024, v, SMS, _xent_smem, limit)
    assert p.cluster == cluster
    if cluster:
        assert p.smem == _xent_smem(p.units) <= limit
    pieces = softmax_xent.plan(1, 1_000_000, SMS, _xent_smem, 10 ** 9)
    assert pieces.cluster == 16  # 15,625 units: 8 pieces of 2,048
    assert softmax_xent.plan(1, 1_100_000, SMS, _xent_smem,
                             10 ** 9).cluster == 0  # 17,188 units: 9


@pytest.mark.parametrize("v", [1, 2, 3, 5, 6, 17, 30011, 30012, 261245,
                               261246])
@pytest.mark.parametrize("cluster", [1, 2, 8, 16])
def test_xent_row_slices_cover_each_row_once(v, cluster):
    """Rows starting 0, 4, 8 or 12 bytes off a 16-byte boundary (row b
    starts at element b v): the ranks' slices are contiguous, in rank
    order, cover [0, v) once; every rank's interior part starts on a
    16-byte boundary and is whole 16-byte units; the head before it
    (rank 0) and the tail after it (rank C - 1) are under 4 elements."""
    units = -(-(v // 4) // cluster)
    for row in range(9):
        s = softmax_xent.row_slices(row, v, cluster, units)
        assert len(s) == cluster
        assert s[0][0] == 0 and s[-1][1] == v
        for (lo, hi), (lo2, _) in zip(s, s[1:]):
            assert lo <= hi == lo2
        h = min(v, (4 - (row * v) % 4) % 4)
        n = (v - h) // 4
        assert (row * v + h) % 4 == 0 or h == v
        for r, (lo, hi) in enumerate(s):
            ilo = h + 4 * min(n, r * units)
            ihi = h + 4 * min(n, (r + 1) * units)
            assert ihi == ilo or (row * v + ilo) % 4 == 0
            assert (ihi - ilo) % 4 == 0
            assert lo == (0 if r == 0 else ilo)
            assert hi == (v if r == cluster - 1 else ihi)
        assert h < 4 and v - (h + 4 * n) < 4


def _jax_xent(logits, labels, valid, n_real):
    x = np.array(logits, copy=True)
    x[:, n_real:] = -np.inf  # the padded target rows' logits
    steps = JaxBuilder(None, None, JaxConfig())
    loss, grad = jax.value_and_grad(
        lambda y: steps._loss_from_logits(y, labels, valid))(x)
    return float(loss), np.asarray(grad)


CASES = [  # b, v, n_real, cluster
    (1, 17, 17, 1), (3, 17, 15, 16), (4, 1001, 1001, 2), (5, 1002, 700, 4),
    (2, 30011, 30011, 8), (6, 4099, 4099, 16), (3, 4099, 100, 16),
    (7, 64, 64, 16)]


@pytest.mark.parametrize("b,v,n_real,cluster", CASES)
def test_split_softmax_xent_matches_reference(b, v, n_real, cluster):
    """The split merge (slices wholly past n_real included: C 16 at
    n_real 100 of 4,099 columns) against `softmax_xent_plain` and the
    reference's loss and gradient under jax.grad; a valid = 0 row gets
    no gradient."""
    rng = np.random.default_rng(b * 7919 + v + cluster)
    logits = (4 * rng.standard_normal((b, v))).astype(np.float32)
    labels = rng.integers(0, n_real, b).astype(np.int32)
    valid = np.ones(b, np.float32)
    if b > 1:
        valid[1] = 0.0
    units = -(-(v // 4) // cluster)
    loss, grad = softmax_xent.split_softmax_xent(
        torch.from_numpy(logits), torch.from_numpy(labels),
        torch.from_numpy(valid), n_real, cluster, units)
    want_loss, want_grad = softmax_xent.softmax_xent_plain(
        torch.from_numpy(logits), torch.from_numpy(labels),
        torch.from_numpy(valid), n_real=n_real, grad_dtype=torch.float32)
    np.testing.assert_allclose(float(loss), float(want_loss), **XENT)
    np.testing.assert_allclose(grad.numpy(), want_grad.numpy(), **XENT)
    jloss, jgrad = _jax_xent(logits, labels, valid > 0, n_real)
    np.testing.assert_allclose(float(loss), jloss, **XENT)
    np.testing.assert_allclose(grad.numpy()[:, :n_real],
                               jgrad[:, :n_real], **XENT)
    assert not grad.numpy()[:, n_real:].any()
    if b > 1:
        assert not grad.numpy()[1].any()


@pytest.mark.parametrize("cluster", [1, 4, 16])
def test_split_softmax_xent_edges(cluster):
    """A label outside [0, n_real) (NaN loss term, no one-hot term), an
    all-masked row (every real logit -inf: NaN, as the reference), a NaN
    logit (the row's gradient NaN), against the plain version."""
    rng = np.random.default_rng(cluster)
    b, v, n_real = 4, 203, 190
    logits = (2 * rng.standard_normal((b, v))).astype(np.float32)
    logits[1, :n_real] = -np.inf
    logits[2, 77] = np.nan
    labels = np.array([n_real + 3, 5, 6, 7], np.int32)
    valid = np.ones(b, np.float32)
    args = (torch.from_numpy(logits), torch.from_numpy(labels),
            torch.from_numpy(valid))
    loss, grad = softmax_xent.split_softmax_xent(
        *args, n_real, cluster, -(-(v // 4) // cluster))
    want_loss, want_grad = softmax_xent.softmax_xent_plain(
        *args, n_real=n_real, grad_dtype=torch.float32)
    assert np.isnan(float(loss)) and np.isnan(float(want_loss))
    np.testing.assert_allclose(grad.numpy(), want_grad.numpy(),
                               equal_nan=True, **XENT)
    assert np.isnan(grad.numpy()[1, :n_real]).all()
    assert np.isnan(grad.numpy()[2, :n_real]).all()
    row0 = grad.numpy()[0, :n_real]
    assert np.isfinite(row0).all() and row0.min() >= 0.0  # no one-hot term
