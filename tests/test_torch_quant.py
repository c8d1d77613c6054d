"""The port's fp8 and int4 table formats against the JAX package, on the
CPU: the host quantizers, the plain gathers and decodes, the plain top-k
and label-logit heads over each format, and the MIPS head over fp8 and
int4 tables.

Inputs are made with numpy from a seed and fed to both packages. fp8
tables reach JAX as ml_dtypes views of their bytes (as the JAX runtime
views them at load) and the port as torch.float8_e4m3fn / float8_e5m2
views; packed int4 tables as uint8 (JAX with its unpacked width, the
port working the width out from the other operand).

Tolerances, and why (as in tests/test_torch_ops.py):
- exact: the quantizers (byte for byte), the decodes and the f32
  gathers (every int8, fp8 and int4 value and its product with an f32
  scale is exact in f32 on both sides).
- F32 (rtol 1e-5, atol 1e-6): f32 products summed in another order.
- BF16 (atol 2e-2, rtol 1e-2): a code vector rounded to bf16 whose f32
  value differs in its last bits may land one bf16 step apart.
- Top-k indices: exact; the inputs' top k + 1 logits are well separated.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from code2vec_tpu.ops import quant as jquant
from code2vec_tpu.ops import topk as jtopk
from code2vec_tpu.retrieval import mips as jmips
from code2vec_tpu_torch import kernels
from code2vec_tpu_torch.kernels.encoder import context_encoder
from code2vec_tpu_torch.kernels.label_logits import label_logits
from code2vec_tpu_torch.kernels.topk import blockwise_topk
from code2vec_tpu_torch.ops import quant as tquant
from code2vec_tpu_torch.retrieval.mips import MipsHead

pytestmark = pytest.mark.torch_port
# the shapes are tiny; one intra-op thread leaves the CPU cores to the
# other pytest workers
torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=1e-2, atol=2e-2)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SCHEMES = ("int8", "e4m3", "e5m2", "int4")
ML_FP8 = {"e4m3": ml_dtypes.float8_e4m3fn, "e5m2": ml_dtypes.float8_e5m2}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _table(seed, shape, scale=0.3):
    """A table with a heavy tail, an all-zero row and a one-value row."""
    rng = np.random.default_rng(seed)
    t = (rng.standard_normal(shape) * scale).astype(np.float32)
    t *= np.exp(rng.standard_normal(shape)).astype(np.float32)
    t[1] = 0.0
    t[2] = 0.0
    t[2, -1] = -0.7
    return t


def _quantized(scheme, table):
    """(JAX table, port table, scales, int4_dim) of one f32 table."""
    if scheme == "int8":
        q, s = jquant.quantize_rows(table)
        return jnp.asarray(q), torch.from_numpy(q), s, None
    if scheme == "int4":
        q, s = jquant.quantize_rows_int4(table)
        return jnp.asarray(q), torch.from_numpy(q), s, table.shape[1]
    q, s = jquant.quantize_rows_fp8(table, scheme)
    return (jnp.asarray(q.view(ML_FP8[scheme])),
            torch.from_numpy(q).view(tquant.FP8_DTYPES[scheme]), s, None)


# ------------------------------------------------------------ quantizers


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("shape", [(40, 16), (7, 385)])
def test_quantize_rows_fp8_byte_identical(fmt, shape):
    table = _table(shape[0], shape)
    jq, js = jquant.quantize_rows_fp8(table, fmt)
    tq, ts = tquant.quantize_rows_fp8(table, fmt)
    assert tq.dtype == jq.dtype == np.uint8 and ts.dtype == js.dtype
    assert tq.tobytes() == jq.tobytes() and ts.tobytes() == js.tobytes()
    assert ts[1, 0] == 0.0 and not tq[1].any()     # all-zero row
    assert tquant.dequantize_rows_fp8(tq, ts, fmt).tobytes() == \
        jquant.dequantize_rows_fp8(jq, js, fmt).tobytes()
    assert tquant.FP8_MAX[fmt] == jquant.FP8_MAX[fmt]


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_quantize_rows_fp8_every_halfway_point(fmt):
    """Rows whose largest value is the format's max have scale 1, so the
    quantizer encodes the other values as they are: every halfway point
    between two neighbouring codes (ties to even), and the f32 values
    just below and above it, of both signs."""
    codes = np.arange(256, dtype=np.uint8).view(ML_FP8[fmt])
    vals = np.unique(codes.astype(np.float64))
    vals = vals[np.isfinite(vals) & (vals >= 0)]
    mid = ((vals[:-1] + vals[1:]) / 2).astype(np.float32)
    probes = np.concatenate([mid, np.nextafter(mid, np.float32(0)),
                             np.nextafter(mid, np.float32(np.inf)),
                             vals.astype(np.float32)])
    probes = np.concatenate([probes, -probes])
    width = 64
    n_rows = -(-probes.size // (width - 1))
    table = np.zeros((n_rows, width), np.float32)
    table[:, 0] = jquant.FP8_MAX[fmt]
    table[:, 1:].flat[:probes.size] = probes
    jq, js = jquant.quantize_rows_fp8(table, fmt)
    tq, ts = tquant.quantize_rows_fp8(table, fmt)
    assert (js == 1.0).all()
    assert tq.tobytes() == jq.tobytes() and ts.tobytes() == js.tobytes()


@pytest.mark.parametrize("shape", [(40, 16), (7, 385)])
def test_quantize_rows_int4_byte_identical(shape):
    table = _table(shape[0] + 1, shape)
    jq, js = jquant.quantize_rows_int4(table)
    tq, ts = tquant.quantize_rows_int4(table)
    assert tq.shape == (shape[0], (shape[1] + 1) // 2)
    assert tq.tobytes() == jq.tobytes() and ts.tobytes() == js.tobytes()
    if shape[1] % 2:   # an odd trailing column is padded with 8
        assert ((tq[:, -1] >> 4) == 8).all()
    assert (tq[1] == 0x88).all() and ts[1, 0] == 0.0
    np.testing.assert_array_equal(tquant.unpack_int4_host(tq, shape[1]),
                                  jquant.unpack_int4_host(jq, shape[1]))
    assert tquant.dequantize_rows_int4(tq, ts, shape[1]).tobytes() == \
        jquant.dequantize_rows_int4(jq, js, shape[1]).tobytes()


def test_unpack_int4_device_matches_jax():
    rng = np.random.default_rng(3)
    packed = rng.integers(0, 256, (5, 3, 9)).astype(np.uint8)
    for dim in (17, 18):
        want = np.asarray(jquant.unpack_int4(jnp.asarray(packed), dim))
        got = tquant.unpack_int4(torch.from_numpy(packed), dim).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_table_gather_matches_jax(scheme):
    rng = np.random.default_rng(7)
    table = _table(4, (50, 20))
    jt, tt, s, int4_dim = _quantized(scheme, table)
    ids = rng.integers(0, 50, (3, 6)).astype(np.int32)
    want = np.asarray(jquant.table_gather(jt, jnp.asarray(s),
                                          jnp.asarray(ids),
                                          int4_dim=int4_dim))
    got = tquant.table_gather(tt, torch.from_numpy(s), torch.from_numpy(ids),
                              int4_dim=int4_dim).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tok_d,path_d", [(8, 6), (7, 6), (8, 5), (7, 5)])
def test_context_encoder_int4_widths_match_jax(tok_d, path_d):
    """K1's plain version over packed int4 tables works out each table's
    width, odd ones too, from the transform's 2 token + path rows: the
    context equals the JAX gathers at their given widths."""
    rng = np.random.default_rng(tok_d * 10 + path_d)
    jtok, ttok, stok, _ = _quantized("int4", _table(5, (30, tok_d)))
    jpath, tpath, spath, _ = _quantized("int4", _table(6, (20, path_d)))
    k_dim = 2 * tok_d + path_d
    w = rng.standard_normal((k_dim, 16)).astype(np.float32)
    ids = [rng.integers(0, n, (3, 4)).astype(np.int32) for n in (30, 20, 30)]
    ctx = np.concatenate([np.asarray(jquant.table_gather(
        jt, jnp.asarray(s), jnp.asarray(i), int4_dim=dim))
        for jt, s, i, dim in ((jtok, stok, ids[0], tok_d),
                              (jpath, spath, ids[1], path_d),
                              (jtok, stok, ids[2], tok_d))], axis=-1)
    got = context_encoder(ttok, torch.from_numpy(stok), tpath,
                          torch.from_numpy(spath), torch.from_numpy(w),
                          *(torch.from_numpy(i) for i in ids),
                          compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.tanh(ctx @ w), **F32)


# --------------------------------------------------------------- heads


def _separated(seed, v, d, b, k, valid_rows):
    """k + 1 well-separated best rows (scaled copies of one direction, so
    every format keeps them apart through its per-row scale)."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(d).astype(np.float32)
    u /= np.linalg.norm(u)
    cv = (u[None, :] * 2.0
          + 0.01 * rng.standard_normal((b, d))).astype(np.float32)
    table = (0.05 * rng.standard_normal((v, d))).astype(np.float32)
    hot = np.linspace(1, valid_rows - 1, k + 1).astype(int)
    rng.shuffle(hot)
    for j, row in enumerate(hot):
        table[row] = u * (1.0 + 0.125 * j)
    if valid_rows < v:
        table[valid_rows] = u * 10.0
    return cv, table


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_blockwise_topk_matches_jax(scheme, k, dtype):
    jdt, tdt = DTYPES[dtype]
    v, d, b, block, valid = 400, 32, 5, 96, 397
    cv, table = _separated(k, v, d, b, k, valid)
    jt, tt, s, int4_dim = _quantized(scheme, table)
    want = jtopk.blockwise_matmul_top_k(
        jnp.asarray(cv), jt, k, block, scales=jnp.asarray(s),
        valid_rows=valid, compute_dtype=jdt, int4_dim=int4_dim)
    before = kernels.launch_counts()
    got = blockwise_topk(torch.from_numpy(cv), tt, k, block,
                         scales=torch.from_numpy(s), valid_rows=valid,
                         compute_dtype=tdt)
    assert kernels.launch_counts() == before   # CPU: the plain version
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(got.values.numpy(), _np(want.values), **tol)
    np.testing.assert_allclose(got.lse.numpy(), _np(want.lse), **tol)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_label_logits_match_jax(scheme, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(11)
    v, d, b = 60, 22, 7
    cv = rng.standard_normal((b, d)).astype(np.float32)
    jt, tt, s, int4_dim = _quantized(scheme, _table(12, (v, d)))
    labels = np.array([0, 4, 59, 1, 4, 33, 60], np.int32)  # 60: outside
    want = _np(jtopk.gathered_label_logits(
        jnp.asarray(cv), jt, jnp.asarray(labels), scales=jnp.asarray(s),
        compute_dtype=jdt, int4_dim=int4_dim))
    got = label_logits(torch.from_numpy(cv), tt, torch.from_numpy(labels),
                       scales=torch.from_numpy(s),
                       compute_dtype=tdt).numpy()
    np.testing.assert_allclose(got, want, **F32)
    assert got[6] == -1e30 and got[3] == 0.0   # outside; all-zero row


@pytest.mark.parametrize("scheme", ["e4m3", "e5m2", "int4"])
def test_mips_head_every_list_is_the_exact_head(scheme):
    """At nprobe = nlist the MIPS head scores every real row, in f32 as
    the exact head's float32 mode does: the same indices and values; and
    the same as the JAX MIPS head over the same table."""
    v, d, b, k, real = 600, 32, 6, 10, 590
    cv, table = _separated(21, v, d, b, k, real)
    jt, tt, s, int4_dim = _quantized(scheme, table)
    head = MipsHead.build(tt, s, real_vocab=real, nlist=12, nprobe=3,
                          seed=0, device="cpu")
    vals, ids = head.topk_fn(k, head.nlist)(torch.from_numpy(cv))
    exact = blockwise_topk(torch.from_numpy(cv), tt, k, 128,
                           scales=torch.from_numpy(s), valid_rows=real,
                           compute_dtype=torch.float32)
    np.testing.assert_array_equal(ids.numpy(), exact.indices.numpy())
    np.testing.assert_allclose(vals.numpy(), exact.values.numpy(), **F32)
    jhead = jmips.MipsHead.build(np.asarray(jt), s, real_vocab=real,
                                 nlist=12, nprobe=3, int4_dim=int4_dim,
                                 seed=0)
    jvals, jids = jhead.search(cv, k, nprobe=jhead.nlist)
    np.testing.assert_array_equal(ids.numpy(), jids)
    np.testing.assert_allclose(vals.numpy(), jvals, **F32)
    # the rows stay in their stored format, reordered list by list
    assert head._rows.dtype == tt.dtype
    assert head._rows.shape == (real, tt.shape[1])
