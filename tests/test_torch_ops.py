"""The port's device functions against the JAX package, on the CPU.

Each test makes its inputs with numpy from a seed, feeds the same arrays
to the JAX function and to its counterpart in code2vec_tpu_torch, and
compares. On CPU tensors the port's kernel wrappers run their plain
PyTorch versions (the CUDA kernels themselves are held against those
plain versions on the card by chip_smoke.py).

Tolerances, and why:
- F32: rtol 1e-5, atol 1e-6. Same f32 arithmetic; only the summation
  order of the contractions differs between XLA and PyTorch.
- BF16: atol 2e-2, rtol 1e-2. An intermediate rounded to bf16 (the
  transformed contexts, the attention weights before the weighted sum)
  can land one bf16 step (2^-8 relative) apart when the f32 value it is
  rounded from differs in its last bits.
- Top-k indices: exact. Inputs are built so that no two of the top k+1
  logits lie within tolerance of each other (or tie exactly, where the
  lowest index must win).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from code2vec_tpu.models.code2vec import Code2VecModule as FlaxModule
from code2vec_tpu.models.code2vec import ModelDims as JaxDims
from code2vec_tpu.ops import topk as jtopk
from code2vec_tpu.ops.attention import masked_single_query_attention
from code2vec_tpu.ops.quant import dequant_gather as jax_dequant_gather
from code2vec_tpu.ops.quant import dequantize_rows as jax_dequantize_rows
from code2vec_tpu.ops.quant import quantize_rows as jax_quantize_rows
from code2vec_tpu.ops.quant import table_gather as jax_table_gather
from code2vec_tpu_torch import kernels
from code2vec_tpu_torch.kernels.attention import masked_attention
from code2vec_tpu_torch.kernels.encoder import context_encoder
from code2vec_tpu_torch.kernels.label_logits import label_logits
from code2vec_tpu_torch.kernels.topk import blockwise_topk
from code2vec_tpu_torch.models.code2vec import Code2VecModule, ModelDims
from code2vec_tpu_torch.ops import quant as tquant
from code2vec_tpu_torch.ops import topk as ttopk
from code2vec_tpu_torch.weights import params_from_jax

pytestmark = pytest.mark.torch_port
# the shapes are tiny; one intra-op thread leaves the CPU cores to the
# other pytest workers
torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=1e-2, atol=2e-2)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------ attention


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_attention_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    b, m, d = 6, 9, 16
    t = np.tanh(rng.standard_normal((b, m, d))).astype(np.float32)
    a = rng.standard_normal(d).astype(np.float32)
    mask = (rng.random((b, m)) > 0.4).astype(np.float32)
    mask[0] = 0.0          # an all-invalid (padded) row
    mask[1] = 1.0
    jcv, jattn = masked_single_query_attention(
        jnp.asarray(t).astype(jdt), jnp.asarray(a), jnp.asarray(mask))
    before = kernels.launch_counts()
    cv, attn = masked_attention(torch.from_numpy(t).to(tdt),
                                torch.from_numpy(a), torch.from_numpy(mask))
    assert kernels.launch_counts() == before, "CPU calls launch nothing"
    assert cv.dtype == attn.dtype == torch.float32
    np.testing.assert_allclose(_np(attn), _np(jattn), **F32)
    np.testing.assert_allclose(_np(cv), _np(jcv),
                               **(F32 if dtype == "float32" else BF16))
    assert not _np(attn)[0].any() and not _np(cv)[0].any()
    np.testing.assert_allclose(_np(attn)[1:].sum(axis=1), 1.0, rtol=1e-5)


# ---------------------------------------------------------------- top-k


def _separated_problem(seed, v, d, b, k, valid_rows):
    """cv rows share a direction u; k+1 'hot' table rows lie along u at
    logits ~2 + 0.25 j apart, spread over the table (last block
    included); every other row is small noise. One row past valid_rows
    would win if it were not masked."""
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


def _jax_topk(cv, table, k, block, scales, valid_rows, jdt):
    out = jtopk.blockwise_matmul_top_k(
        jnp.asarray(cv), jnp.asarray(table), k, block,
        scales=None if scales is None else jnp.asarray(scales),
        valid_rows=valid_rows, compute_dtype=jdt)
    return _np(out.values), np.asarray(out.indices), _np(out.lse)


def _port_topk(cv, table, k, block, scales, valid_rows, tdt):
    out = blockwise_topk(
        torch.from_numpy(cv), torch.from_numpy(table), k, block,
        scales=None if scales is None else torch.from_numpy(scales),
        valid_rows=valid_rows, compute_dtype=tdt)
    assert out.indices.dtype == torch.int32
    return out.values.numpy(), out.indices.numpy(), out.lse.numpy()


@pytest.mark.parametrize("scheme,dtype,v,block,valid_rows", [
    ("f32", "float32", 1000, 96, 1000),
    ("f32", "bfloat16", 1000, 96, 990),
    ("int8", "bfloat16", 1000, 96, 997),
    ("int8", "bfloat16", 50, 8, 47),
    ("int8", "float32", 300, 4096, 300),
])
def test_blockwise_topk_matches_jax(scheme, dtype, v, block, valid_rows):
    jdt, tdt = DTYPES[dtype]
    k, d, b = 10, 16, 5
    cv, table = _separated_problem(3, v, d, b, k, valid_rows)
    scales = None
    if scheme == "int8":
        table, scales = jax_quantize_rows(table)
    jv, ji, jl = _jax_topk(cv, table, k, block, scales, valid_rows, jdt)
    tv, ti, tl = _port_topk(cv, table, k, block, scales, valid_rows, tdt)
    np.testing.assert_array_equal(ti, ji)
    assert (ti < valid_rows).all()
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(tv, jv, **tol)
    np.testing.assert_allclose(tl, jl, **tol)


def test_blockwise_topk_exact_ties_pick_lowest_index():
    rng = np.random.default_rng(5)
    v, d, b, k = 200, 16, 3, 4
    cv = rng.standard_normal((b, d)).astype(np.float32)
    table = (0.01 * rng.standard_normal((v, d))).astype(np.float32)
    top = cv.mean(axis=0) * 3.0
    for row in (150, 7, 63, 199, 31):   # five identical best rows
        table[row] = top
    q, s = jax_quantize_rows(table)
    for tbl, scl in ((table, None), (q, s)):
        jv, ji, jl = _jax_topk(cv, tbl, k, 32, scl, v, jnp.bfloat16)
        tv, ti, tl = _port_topk(cv, tbl, k, 32, scl, v, torch.bfloat16)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(ti, np.tile([7, 31, 63, 150], (b, 1)))
        np.testing.assert_array_equal(tv, jv)


def test_blockwise_topk_nonfinite_row_keeps_lse_finite():
    v, d, b, k = 120, 16, 4, 5
    cv, table = _separated_problem(7, v, d, b, k, v)
    table[33, 2] = np.nan    # NaN logits rank first, as lax.top_k has it
    table[90, 0] = np.inf
    jv, ji, jl = _jax_topk(cv, table, k, 16, None, v, jnp.float32)
    tv, ti, tl = _port_topk(cv, table, k, 16, None, v, torch.float32)
    np.testing.assert_array_equal(ti, ji)
    assert (ti[:, 0] == 33).all()
    np.testing.assert_allclose(tv, jv, **F32)   # NaN == NaN here
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, **F32)


@pytest.mark.parametrize("v,block", [(37, 8), (64, 64), (100, 7)])
def test_blockwise_top_k_from_logits_matches_jax(v, block):
    rng = np.random.default_rng(v)
    logits = rng.integers(-5, 5, (4, v)).astype(np.float32)  # many ties
    jv, ji = jtopk.blockwise_top_k_from_logits(jnp.asarray(logits), 6, block)
    tv, ti = ttopk.blockwise_top_k_from_logits(torch.from_numpy(logits), 6,
                                               block)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("scheme,dtype", [("f32", "float32"),
                                          ("f32", "bfloat16"),
                                          ("int8", "bfloat16")])
def test_label_logits_match_jax(scheme, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(11)
    v, d, b = 60, 16, 7
    cv = rng.standard_normal((b, d)).astype(np.float32)
    table = rng.standard_normal((v, d)).astype(np.float32)
    table[4, 3] = np.inf     # a nonfinite logit becomes -1e30
    labels = np.array([0, 4, 59, 12, 4, 33, 60], np.int32)  # 60: outside
    scales = None
    if scheme == "int8":
        table, scales = jax_quantize_rows(np.where(np.isfinite(table),
                                                   table, 0.0))
        table[4] = 0
        scales[4] = np.inf
    want = _np(jtopk.gathered_label_logits(
        jnp.asarray(cv), jnp.asarray(table), jnp.asarray(labels),
        scales=None if scales is None else jnp.asarray(scales),
        compute_dtype=jdt))
    got = label_logits(
        torch.from_numpy(cv), torch.from_numpy(table),
        torch.from_numpy(labels),
        scales=None if scales is None else torch.from_numpy(scales),
        compute_dtype=tdt).numpy()
    np.testing.assert_allclose(got, want, **F32)
    assert got[1] == got[4] == got[6] == -1e30


# ---------------------------------------------------------------- quant


@pytest.mark.parametrize("shape", [(40, 16), (7, 384)])
def test_quantize_rows_byte_identical(shape):
    rng = np.random.default_rng(shape[0])
    table = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    table[3] = 0.0           # all-zero row: scale 0, exact zeros
    jq, js = jax_quantize_rows(table)
    tq, ts = tquant.quantize_rows(table)
    assert tq.dtype == jq.dtype and ts.dtype == js.dtype
    assert tq.tobytes() == jq.tobytes() and ts.tobytes() == js.tobytes()
    assert tquant.dequantize_rows(tq, ts).tobytes() == \
        jax_dequantize_rows(jq, js).tobytes()
    ids = rng.integers(0, shape[0], (3, 5)).astype(np.int32)
    want = np.asarray(jax_dequant_gather(jnp.asarray(jq), jnp.asarray(js),
                                         jnp.asarray(ids)))
    got = tquant.table_gather(torch.from_numpy(tq), torch.from_numpy(ts),
                              torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)


# -------------------------------------------------------------- encoder


def _flax_and_port(dtype, seed=0):
    jdt, tdt = DTYPES[dtype]
    jdims = JaxDims(token_vocab_size=30, path_vocab_size=20,
                    target_vocab_size=40, token_dim=8, path_dim=16,
                    real_target_vocab_size=37)
    fmod = FlaxModule(jdims, compute_dtype=jdt)
    rng = np.random.default_rng(seed)
    b, m = 4, 6
    src = rng.integers(0, 30, (b, m)).astype(np.int32)
    pth = rng.integers(0, 20, (b, m)).astype(np.int32)
    tgt = rng.integers(0, 30, (b, m)).astype(np.int32)
    mask = (rng.random((b, m)) > 0.3).astype(np.float32)
    mask[2] = 0.0
    params = fmod.init(jax.random.PRNGKey(seed), src, pth, tgt,
                       mask)["params"]
    dims = ModelDims(token_vocab_size=30, path_vocab_size=20,
                     target_vocab_size=40, token_dim=8, path_dim=16,
                     real_target_vocab_size=37)
    tmod = Code2VecModule(dims, compute_dtype=tdt, device="cpu")
    tmod.load_state_dict(params_from_jax(jax.device_get(params)))
    inputs = (src, pth, tgt, mask)
    return fmod, params, tmod, inputs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_flax_module(dtype):
    fmod, params, tmod, (src, pth, tgt, mask) = _flax_and_port(dtype)
    want = fmod.apply({"params": params}, src, pth, tgt,
                      method=FlaxModule.transform_contexts)
    got = tmod.transform_contexts(*(torch.from_numpy(x)
                                    for x in (src, pth, tgt)))
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(_np(got), _np(want),
                               **(F32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_flax_module(dtype):
    fmod, params, tmod, inputs = _flax_and_port(dtype, seed=4)
    jlogits, jcv, jattn = fmod.apply({"params": params}, *inputs)
    logits, cv, attn = tmod(*(torch.from_numpy(x) for x in inputs))
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(_np(attn), _np(jattn), **tol)
    np.testing.assert_allclose(_np(cv), _np(jcv), **tol)
    np.testing.assert_allclose(_np(logits), _np(jlogits), **tol)
    assert np.isneginf(_np(logits)[:, 37:]).all()   # padded targets


def test_module_init_shapes_and_ranges():
    dims = ModelDims(token_vocab_size=50, path_vocab_size=20,
                     target_vocab_size=10)
    g = torch.Generator().manual_seed(0)
    mod = Code2VecModule(dims, device="cpu", generator=g)
    assert mod.transform.shape == (384, 384)
    assert mod.attention.shape == (384, 1)
    assert mod.target_embedding.shape == (10, 384)
    assert mod.token_embedding.abs().max() <= (3.0 / 128) ** 0.5
    assert mod.transform.abs().max() <= (6.0 / 768) ** 0.5


@pytest.mark.parametrize("scheme", ["int8", "f32"])
def test_context_encoder_matches_release_step_math(scheme):
    """K1's plain version on artifact tables against the JAX release
    step's encoder (code2vec_tpu/release/runtime.py:113-122): gather with
    fused dequant, concat, bf16 cast, tanh(ctx @ bf16(W)), bf16 out."""
    rng = np.random.default_rng(9)
    tok = (0.2 * rng.standard_normal((50, 8))).astype(np.float32)
    path = (0.2 * rng.standard_normal((30, 16))).astype(np.float32)
    w = (0.3 * rng.standard_normal((32, 32))).astype(np.float32)
    ids = [rng.integers(0, n, (3, 7)).astype(np.int32) for n in (50, 30, 50)]
    tok_s = path_s = None
    if scheme == "int8":
        tok, tok_s = jax_quantize_rows(tok)
        path, path_s = jax_quantize_rows(path)

    def jnp_or_none(x):
        return None if x is None else jnp.asarray(x)

    ctx = jnp.concatenate([
        jax_table_gather(jnp.asarray(tok), jnp_or_none(tok_s), ids[0]),
        jax_table_gather(jnp.asarray(path), jnp_or_none(path_s), ids[1]),
        jax_table_gather(jnp.asarray(tok), jnp_or_none(tok_s), ids[2]),
    ], axis=-1).astype(jnp.bfloat16)
    want = jnp.tanh(jnp.einsum(
        "bmc,cd->bmd", ctx, jnp.asarray(w).astype(jnp.bfloat16),
        preferred_element_type=jnp.float32)).astype(jnp.bfloat16)

    def t_or_none(x):
        return None if x is None else torch.from_numpy(x)

    got = context_encoder(
        torch.from_numpy(tok), t_or_none(tok_s), torch.from_numpy(path),
        t_or_none(path_s), torch.from_numpy(w),
        *(torch.from_numpy(i) for i in ids))
    assert got.dtype == torch.bfloat16 and got.shape == (3, 7, 32)
    np.testing.assert_allclose(_np(got), _np(want), **BF16)
