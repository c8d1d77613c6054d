"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

These tests need a CUDA GPU and nvcc, and skip elsewhere. They import no
JAX, so they run on a machine without it; from the repo root:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances, and why:
- BF16 (atol 2e-2, rtol 1e-2): the kernels' bf16 outputs and the code
  vectors built from bf16-rounded attention weights may land one bf16
  step from the plain version's.
- F32SUM (atol 1e-4, rtol 1e-4): logits, logsumexp and label logits are
  f32 sums of exact bf16 products, taken in another order.
- Top-k indices: exact; inputs are built with well-separated top logits,
  or with exact ties that the lowest index must win.
- STEP (one bf16 step at the compared tensor's largest value, 2^-8 to
  2^-7 of it): the train kernels' results that the reference rounds to
  bf16 (K1's output, K5's table and W gradients, K6's dT and da) may
  land one bf16 step from the plain version's, the largest value's
  included, where f32 sums taken in another order (or K5's hi/lo split
  of the f32 tanh gradient) move the value rounded; K5's table gradients
  are f32 sums of such terms, added by atomics in any order.
- K7 (rtol 1e-5, atol 1e-7) and K8 (rtol 1e-6, atol 1e-9): elementwise
  f32 with the plain version's operation order; K7 sums a row in another
  order, and the card's division by a scalar may differ in the last bit,
  which moves a parameter by a few f32 ulps of the update (~lr = 1e-3)
  where the update cancels it.
- F32DOT (rtol 1e-5, atol 1e-5): K3's float32 mode and K11 score with
  f32 products summed in another order than the plain versions' matmul
  and einsum (about 1e-7 relative of values of order 1-10); K11's test
  data reach scores of ~4e3, so its atol is 1e-6 of the largest score.
- K10 (rtol 1e-4, atol 1e-5): a centroid is the mean of up to a few
  thousand f32 rows, summed in another order (about 1e-6 relative).
- K9: an assignment may differ only where the two nearest centroids'
  distances lie within 1e-4 (relative) of each other.
- K13: exact (the same positions, values read back from the scores).
- K12: K8's (rtol 1e-6, atol 1e-9; a bf16 mu equal or one bf16 step
  apart), on gradient rows whose duplicate sums are exact in f32 in any
  order; untouched rows and reruns bit-equal.
- K14: the gather and the local ids exact; the scatter-add's f32
  atomics at rtol 1e-5 (a row's terms in any order). K15: the max exact,
  the sums and the gradient's hi + lo f32 (rtol 1e-5). K16/K17: the
  weights and exp at rtol 1e-6, sums at F32SUM, fs, dT and da within one
  bf16 step (an f32 sum in another order moves a bf16 rounding).
- The fp8 and int4 modes of K1, K3, K4 and K11: the int8 mode's
  tolerances (every fp8 and int4 value decodes exactly, to f32 and to
  bf16); all 256 fp8 codes of each format exactly.
"""

import math

import numpy as np
import pytest
import torch

from code2vec_tpu_torch import kernels
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.kernels.adam import AdamHyper, adam, adam_plain
from code2vec_tpu_torch.kernels import attention as kattention
from code2vec_tpu_torch.kernels import ivf as kivf
from code2vec_tpu_torch.kernels.attention import (
    masked_attention, masked_attention_backward,
    masked_attention_backward_plain, masked_attention_plain,
)
from code2vec_tpu_torch.kernels.encoder import (
    Dropout, context_encoder, context_encoder_plain,
)
from code2vec_tpu_torch.kernels.encoder_backward import (
    encoder_backward, encoder_backward_plain,
)
from code2vec_tpu_torch.kernels.ivf import (
    ivf_search, ivf_search_plain, top_positions,
)
from code2vec_tpu_torch.kernels.kmeans import (
    kmeans_assign, kmeans_assign_plain, kmeans_update, kmeans_update_plain,
)
from code2vec_tpu_torch.kernels.softmax_xent import (
    softmax_xent, softmax_xent_plain,
)
from code2vec_tpu_torch.kernels.label_logits import (
    label_logits, label_logits_plain,
)
from code2vec_tpu_torch.kernels import launch, topk
from code2vec_tpu_torch.kernels.topk import (
    blockwise_topk, blockwise_topk_plain,
)
from code2vec_tpu_torch.ops import quant
from code2vec_tpu_torch.ops.quant import quantize_rows
from code2vec_tpu_torch.release.artifact import write_artifact
from code2vec_tpu_torch.release.runtime import ReleaseModel
from code2vec_tpu_torch.vocab import Code2VecVocabs

pytestmark = [pytest.mark.torch_port, pytest.mark.cuda]

BF16 = dict(rtol=1e-2, atol=2e-2)
F32SUM = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: run on the card with "
                    "python -m pytest --noconftest -m cuda "
                    "tests/test_torch_kernels_cuda.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)


def _tables(rng, dev, scheme, rows, dim):
    t = (0.2 * rng.standard_normal((rows, dim))).astype(np.float32)
    if scheme == "f32":
        return torch.from_numpy(t).to(dev), None
    q, s = quantize_rows(t)
    return torch.from_numpy(q).to(dev), torch.from_numpy(s).to(dev)


@pytest.mark.parametrize("scheme", ["int8", "f32"])
@pytest.mark.parametrize("b,m", [(3, 5), (64, 200), (64, 32)])
def test_context_encoder_kernel(dev, scheme, b, m):
    rng = np.random.default_rng(b * m)
    tok, tok_s = _tables(rng, dev, scheme, 5000, 128)
    pth, pth_s = _tables(rng, dev, scheme, 3000, 128)
    w = torch.from_numpy((0.05 * rng.standard_normal((384, 384))
                          ).astype(np.float32)).to(dev)
    ids = [torch.from_numpy(rng.integers(0, n, (b, m)).astype(np.int32)
                            ).to(dev) for n in (5000, 3000, 5000)]
    before = kernels.launch_counts()["context_encoder"]
    got = context_encoder(tok, tok_s, pth, pth_s, w, *ids)
    assert kernels.launch_counts()["context_encoder"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (b, m, 384)
    _close(got, context_encoder_plain(tok, tok_s, pth, pth_s, w, *ids), BF16)


@pytest.mark.parametrize("m", [5, 200])
def test_masked_attention_kernel(dev, m):
    rng = np.random.default_rng(m)
    b = 7
    t = torch.from_numpy(np.tanh(rng.standard_normal((b, m, 384))).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    a = torch.from_numpy(rng.standard_normal(384).astype(np.float32)).to(dev)
    mask = torch.from_numpy((rng.random((b, m)) > 0.3).astype(np.float32)
                            ).to(dev)
    mask[0] = 0.0
    cv, attn = masked_attention(t, a, mask)
    want_cv, want_attn = masked_attention_plain(t, a, mask)
    _close(attn, want_attn, dict(rtol=1e-4, atol=1e-5))
    _close(cv, want_cv, BF16)
    assert not cv[0].any() and not attn[0].any()


def _separated(rng, v, b, valid):
    """k+1 <= 65 well-separated best rows, spread over the table."""
    u = rng.standard_normal(384).astype(np.float32)
    u /= np.linalg.norm(u)
    cv = (u[None, :] * 2.0 + 0.01 * rng.standard_normal((b, 384))
          ).astype(np.float32)
    table = (0.05 * rng.standard_normal((v, 384))).astype(np.float32)
    hot = np.linspace(1, valid - 1, 65).astype(int)
    rng.shuffle(hot)
    for j, row in enumerate(hot):
        table[row] = u * (1.0 + 0.05 * j)
    if valid < v:
        table[valid] = u * 10.0   # masked: must never win
    return cv, table


@pytest.mark.parametrize("scheme", ["int8", "f32"])
@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("b", [5, 64])
def test_blockwise_topk_kernel(dev, scheme, k, b):
    rng = np.random.default_rng(k + b)
    v, valid = 20011, 20003
    cv, table = _separated(rng, v, b, valid)
    scales = None
    if scheme == "int8":
        table, scales = quantize_rows(table)
        scales = torch.from_numpy(scales).to(dev)
    cv, table = torch.from_numpy(cv).to(dev), torch.from_numpy(table).to(dev)
    before = kernels.launch_counts()["blockwise_topk"]
    got = blockwise_topk(cv, table, k, 4096, scales=scales, valid_rows=valid)
    assert kernels.launch_counts()["blockwise_topk"] == before + 1
    want = blockwise_topk_plain(cv, table, k, 4096, scales=scales,
                                valid_rows=valid,
                                compute_dtype=torch.bfloat16)
    assert torch.equal(got.indices, want.indices)
    assert (got.indices < valid).all()
    _close(got.values, want.values, F32SUM)
    _close(got.lse, want.lse, F32SUM)


def test_blockwise_topk_kernel_ties_and_nan(dev):
    rng = np.random.default_rng(3)
    v = 9000
    table = (0.1 * rng.standard_normal((v, 384))).astype(np.float32)
    table[[8999, 17, 4500, 5]] = table[3]      # five identical rows
    table[777, 9] = np.nan                     # NaN logits rank first
    cv = rng.standard_normal((4, 384)).astype(np.float32)
    cv[:] = table[3] * 5
    q, s = quantize_rows(np.nan_to_num(table))
    q[777, 9] = 0
    s_t = torch.from_numpy(s).to(dev)
    for tbl, scl, first in (
            (torch.from_numpy(table).to(dev), None,
             [777, 3, 5, 17, 4500, 8999]),
            (torch.from_numpy(q).to(dev), s_t, [3, 5, 17, 4500, 8999])):
        got = blockwise_topk(torch.from_numpy(cv).to(dev), tbl, 6, 4096,
                             scales=scl)
        want = blockwise_topk_plain(torch.from_numpy(cv).to(dev), tbl, 6,
                                    4096, scales=scl,
                                    compute_dtype=torch.bfloat16)
        assert torch.equal(got.indices, want.indices)
        assert got.indices[0, :len(first)].tolist() == first
        assert torch.isfinite(got.lse).all()
        _close(got.lse, want.lse, F32SUM)


@pytest.mark.parametrize("scheme", ["int8", "f32"])
def test_label_logits_kernel(dev, scheme):
    rng = np.random.default_rng(4)
    tbl, scl = _tables(rng, dev, scheme, 700, 384)
    cv = torch.from_numpy(rng.standard_normal((9, 384)).astype(np.float32)
                          ).to(dev)
    labels = torch.tensor([0, 5, 699, 700, -1, 3, 3, 100, 42],
                          dtype=torch.int32, device=dev)
    got = label_logits(cv, tbl, labels, scales=scl)
    _close(got, label_logits_plain(cv, tbl, labels, scales=scl,
                                   compute_dtype=torch.bfloat16), F32SUM)
    assert got[3] == got[4] == -1e30   # labels outside the table


def test_wrappers_refuse_what_kernels_do_not_take(dev):
    t = torch.zeros((2, 3, 384), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        masked_attention(t, torch.zeros(384, device=dev),
                         torch.ones((2, 3), device=dev))
    cv = torch.zeros((2, 384), device=dev)
    tbl = torch.zeros((100, 384), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="scales"):
        blockwise_topk(cv, tbl, 10, 4096)
    # a k above the 64-entry lists is no refusal: K13 answers it
    out = blockwise_topk(cv, tbl, 65, 4096,
                         scales=torch.ones((100, 1), device=dev))
    assert out.indices.shape == (2, 65)


def test_release_model_cuda_matches_cpu(dev, tmp_path):
    """A small artifact (full widths, small vocabularies) served on the
    GPU and on the CPU gives the same top-k words."""
    rng = np.random.default_rng(6)
    tokens = [f"t{i}" for i in range(300)]
    paths = [f"p{i}" for i in range(200)]
    names = [f"name|w{i}" for i in range(5000)]
    vocabs = Code2VecVocabs.from_words(tokens, paths, names)

    def u(shape, lim):
        return (rng.random(shape, dtype=np.float32) * 2 - 1) * lim

    params = {"token_embedding": u((301, 128), 0.15),
              "path_embedding": u((201, 128), 0.15),
              "target_embedding": u((5001, 384), 0.09),
              "transform": u((384, 384), 0.09),
              "attention": u((384, 1), 0.09)}
    art = str(tmp_path / "art")
    write_artifact(params, vocabs, art, "int8")
    lines = [f"name|w{i} " + " ".join(
        f"t{rng.integers(300)},p{rng.integers(200)},t{rng.integers(300)}"
        for _ in range(rng.integers(1, 150))) for i in range(70)]
    gpu = ReleaseModel(Config(serve_artifact=art, verbose_mode=0))
    cpu = ReleaseModel(Config(serve_artifact=art, device="cpu",
                              verbose_mode=0))
    got = gpu.predict(lines, with_code_vectors=True)
    want = cpu.predict(lines, with_code_vectors=True)
    agree = 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.topk_predicted_words_scores,
                                   w.topk_predicted_words_scores, **BF16)
        np.testing.assert_allclose(g.code_vector, w.code_vector, **BF16)
        agree += g.topk_predicted_words == w.topk_predicted_words
    assert agree >= len(lines) - 2   # random weights: near-ties may swap


# ------------------------------------------------------------- train path


def _step_close(got, want, what):
    g, w = got.float().cpu(), want.float().cpu()
    largest = float(w.abs().max())
    tol = math.ldexp(1.0, math.frexp(largest)[1] - 8) if largest else 0.0
    err = float((g - w).abs().max())
    assert err <= tol, f"{what}: max error {err} > {tol}"


def _train_inputs(dev, b, m, v_tok=5000, v_path=3000, repeat=False):
    rng = np.random.default_rng(b * 1000 + m)
    tok = torch.from_numpy((0.3 * rng.standard_normal((v_tok, 128))
                            ).astype(np.float32)).to(dev)
    pth = torch.from_numpy((0.3 * rng.standard_normal((v_path, 128))
                            ).astype(np.float32)).to(dev)
    w = torch.from_numpy((0.1 * rng.standard_normal((384, 384))
                          ).astype(np.float32)).to(dev)
    hi = (7, 5, 7) if repeat else (v_tok, v_path, v_tok)  # collisions
    ids = [torch.from_numpy(rng.integers(0, n, (b, m)).astype(np.int32)
                            ).to(dev) for n in hi]
    return rng, tok, pth, w, ids


@pytest.mark.parametrize("keep", [1.0, 0.75, 0.5])
def test_context_encoder_train_mode_kernel(dev, keep):
    rng, tok, pth, w, ids = _train_inputs(dev, 9, 37)
    drawn = torch.empty((9, 37, 384), dtype=torch.bool, device=dev)
    got, lo = context_encoder(tok, None, pth, None, w, *ids,
                              dropout=Dropout(keep, seed=5, step=3,
                                              out_mask=drawn),
                              residual=True)
    want, want_lo = context_encoder_plain(
        tok, None, pth, None, w, *ids, dropout=Dropout(keep, mask=drawn),
        residual=True)
    _step_close(got, want, "K1 train")
    _step_close(got.float() + lo.float(), want.float() + want_lo.float(),
                "K1 train + residual")
    share = float(drawn.float().mean())
    assert abs(share - keep) <= 5 * (keep * (1 - keep) / drawn.numel()
                                     ) ** 0.5 + 1e-9
    again = torch.empty_like(drawn)
    context_encoder(tok, None, pth, None, w, *ids,
                    dropout=Dropout(keep, seed=5, step=3, out_mask=again))
    assert torch.equal(drawn, again)
    if keep < 1.0:
        other = torch.empty_like(drawn)
        context_encoder(tok, None, pth, None, w, *ids,
                        dropout=Dropout(keep, seed=5, step=4,
                                        out_mask=other))
        assert not torch.equal(drawn, other)
    injected = context_encoder(tok, None, pth, None, w, *ids,
                               dropout=Dropout(keep, mask=drawn))
    assert torch.equal(injected, got)


@pytest.mark.parametrize("keep", [1.0, 0.5])
@pytest.mark.parametrize("b,m,repeat", [(3, 5, False), (64, 200, False),
                                        (16, 33, True)])
def test_encoder_backward_kernel(dev, keep, b, m, repeat):
    rng, tok, pth, w, ids = _train_inputs(dev, b, m, repeat=repeat)
    drawn = torch.empty((b, m, 384), dtype=torch.bool, device=dev)
    t, lo = context_encoder(tok, None, pth, None, w, *ids,
                            dropout=Dropout(keep, seed=1, step=2,
                                            out_mask=drawn), residual=True)
    dt = torch.from_numpy((0.1 * rng.standard_normal((b, m, 384))
                           ).astype(np.float32)).to(dev).to(torch.bfloat16)
    before = kernels.launch_counts()["encoder_backward"]
    got = encoder_backward(dt, t, lo, tok, pth, w, *ids,
                           dropout=Dropout(keep, seed=1, step=2))
    assert kernels.launch_counts()["encoder_backward"] == before + 1
    want = encoder_backward_plain(dt, t, lo, tok, pth, w, *ids,
                                  dropout=Dropout(keep, mask=drawn))
    for name, g, x in zip(("d_token", "d_path", "d_transform"), got, want):
        _step_close(g, x, name)
    # rows no id touches stay exactly 0
    used = torch.zeros(tok.shape[0], dtype=torch.bool, device=dev)
    used[ids[0].long().flatten()] = True
    used[ids[2].long().flatten()] = True
    assert not got[0][~used].any()


def test_encoder_backward_dropped_elements_get_nothing(dev):
    """Each context row its own table row: a dropped element's gradient
    must be exactly 0."""
    b, m = 4, 25
    rng, tok, pth, w, _ = _train_inputs(dev, b, m)
    n = b * m
    ids = [torch.arange(n, dtype=torch.int32, device=dev).view(b, m),
           torch.arange(n, dtype=torch.int32, device=dev).view(b, m),
           torch.arange(n, 2 * n, dtype=torch.int32, device=dev).view(b, m)]
    drawn = torch.empty((b, m, 384), dtype=torch.bool, device=dev)
    t, lo = context_encoder(tok, None, pth, None, w, *ids,
                            dropout=Dropout(0.5, seed=3, step=0,
                                            out_mask=drawn), residual=True)
    dt = torch.ones_like(t)
    d_tok, d_path, _ = encoder_backward(dt, t, lo, tok, pth, w, *ids,
                                        dropout=Dropout(0.5, seed=3, step=0))
    src_rows = d_tok[:n].view(b, m, 128)
    assert not src_rows[~drawn[..., :128]].any()
    assert not d_path[:n].view(b, m, 128)[~drawn[..., 128:256]].any()
    assert src_rows[drawn[..., :128]].ne(0).float().mean() > 0.99


@pytest.mark.parametrize("m", [5, 200])
def test_masked_attention_backward_kernel(dev, m):
    rng = np.random.default_rng(m + 1)
    b = 9
    t = torch.from_numpy(np.tanh(rng.standard_normal((b, m, 384))).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    a = torch.from_numpy(rng.standard_normal(384).astype(np.float32)).to(dev)
    mask = torch.from_numpy((rng.random((b, m)) > 0.3).astype(np.float32)
                            ).to(dev)
    mask[0] = 0.0   # all masked
    mask[1] = 1.0
    _, attn = masked_attention(t, a, mask)
    dcv = torch.from_numpy(rng.standard_normal((b, 384)).astype(np.float32)
                           ).to(dev)
    before = kernels.launch_counts()["masked_attention_backward"]
    dt, da = masked_attention_backward(t, a, mask, attn, dcv)
    assert kernels.launch_counts()["masked_attention_backward"] == before + 1
    want_dt, want_da = masked_attention_backward_plain(t, a, mask, attn, dcv)
    _step_close(dt, want_dt, "dT")
    _step_close(da, want_da, "da")
    assert not dt[0].any()


@pytest.mark.parametrize("b,v", [(3, 17), (64, 30011), (64, 30012)])
def test_softmax_xent_kernel(dev, b, v):
    rng = np.random.default_rng(b + v)
    logits = torch.from_numpy((4 * rng.standard_normal((b, v))
                               ).astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, v - 2, b).astype(np.int32)
                              ).to(dev)
    valid = torch.ones(b, device=dev)
    valid[1] = 0.0
    before = kernels.launch_counts()["softmax_xent"]
    loss, grad = softmax_xent(logits, labels, valid, n_real=v - 2)
    assert kernels.launch_counts()["softmax_xent"] == before + 1
    want_loss, want_grad = softmax_xent_plain(logits, labels, valid,
                                              n_real=v - 2)
    _close(loss, want_loss, dict(rtol=1e-5, atol=1e-7))
    # hi + lo per element: each side's planes carry its f32 g to 2^-16
    # relative; where the two sides' g (~1e-6 apart: expf, the row sum's
    # order) round lo or hi the other way, the sums differ by up to 2^-15
    # of g (3.05e-5); atol far under the typical |g| of a valid row
    got_g, want_g = grad[0].float() + grad[1].float(), (
        want_grad[0].float() + want_grad[1].float())
    _close(got_g, want_g, dict(rtol=4e-5, atol=1e-3 * float(
        want_g[want_g != 0].abs().median())))
    assert not grad[:, 1].any() and not grad[:, :, v - 2:].any()
    with pytest.raises(ValueError, match="bfloat16"):
        softmax_xent(logits, labels, valid, grad_dtype=torch.float32)


@pytest.mark.parametrize("shapes", [
    [(1301, 128), (3,), (2049, 7), (384, 384), (384, 1)],   # scalar path
    [(1301, 128), (911, 128), (261, 384), (384, 384), (384, 1)],  # 4-wide
], ids=["odd", "vec4"])
@pytest.mark.parametrize("mu,nu", [("bfloat16", "bfloat16"),
                                   ("bfloat16", "float32"),
                                   ("float32", "float32")])
def test_adam_kernel(dev, mu, nu, shapes):
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    hyper = AdamHyper(mu_dtype=dt[mu], nu_dtype=dt[nu])
    g = torch.Generator(device=dev).manual_seed(0)
    params = [torch.randn(s, device=dev, generator=g) for s in shapes]
    grads = [torch.randn(s, device=dev, generator=g) * 1e-3 for s in shapes]
    mus = [(torch.randn(s, device=dev, generator=g) * 1e-3).to(dt[mu])
           for s in shapes]
    nus = [(torch.rand(s, device=dev, generator=g) * 1e-6).to(dt[nu])
           for s in shapes]
    ref = [[x.clone() for x in xs] for xs in (params, mus, nus)]
    before = kernels.launch_counts()["adam"]
    adam(params, grads, mus, nus, 7, hyper)
    assert kernels.launch_counts()["adam"] == before + 1
    adam_plain(ref[0], grads, ref[1], ref[2], 7, hyper)
    for got, want in zip(params + mus + nus, ref[0] + ref[1] + ref[2]):
        _close(got, want, dict(rtol=1e-6, atol=1e-9))


# ----------------------------------------- retrieval: K3 f32 mode, K9-K11

F32DOT = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [1, 16, 64])
@pytest.mark.parametrize("b", [1, 64])
def test_blockwise_topk_f32_kernel(dev, k, b):
    rng = np.random.default_rng(100 + k + b)
    v, valid = 20011, 20003
    cv, table = _separated(rng, v, b, valid)
    cv, table = torch.from_numpy(cv).to(dev), torch.from_numpy(table).to(dev)
    before = kernels.launch_counts()
    got = blockwise_topk(cv, table, k, 4096, valid_rows=valid,
                         compute_dtype=torch.float32)
    after = kernels.launch_counts()
    assert after["blockwise_topk_f32"] == before["blockwise_topk_f32"] + 1
    assert after["blockwise_topk"] == before["blockwise_topk"]
    want = blockwise_topk_plain(cv, table, k, 4096, valid_rows=valid,
                                compute_dtype=torch.float32)
    assert torch.equal(got.indices, want.indices)
    _close(got.values, want.values, F32DOT)
    _close(got.lse, want.lse, F32DOT)


def test_blockwise_topk_f32_ties_and_refusals(dev):
    rng = np.random.default_rng(5)
    table = rng.standard_normal((9000, 384)).astype(np.float32)
    table[[8999, 17, 4500, 5]] = table[3]      # five identical rows
    cv = torch.from_numpy(np.repeat(table[3:4] * 2, 3, axis=0)).to(dev)
    tbl = torch.from_numpy(table).to(dev)
    got = blockwise_topk(cv, tbl, 6, 4096, compute_dtype=torch.float32)
    assert got.indices[:, :5].tolist() == [[3, 5, 17, 4500, 8999]] * 3
    want = blockwise_topk_plain(cv, tbl, 6, 4096, compute_dtype=torch.float32)
    assert torch.equal(got.indices, want.indices)
    q = torch.zeros((9000, 384), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="f32 tables"):
        blockwise_topk(cv, q, 6, 4096, scales=torch.ones((9000, 1),
                                                         device=dev),
                       compute_dtype=torch.float32)


def _blobs(rng, n, d, c):
    centers = 4.0 * rng.standard_normal((max(c, 1), d))
    x = centers[rng.integers(0, max(c, 1), n)] + rng.standard_normal((n, d))
    return x.astype(np.float32)


def _distances(x, c):
    return (c * c).sum(1)[None, :] - 2.0 * (x @ c.T)


@pytest.mark.parametrize("n,d,c", [(1000, 384, 37), (5003, 16, 1),
                                   (300, 8, 300), (70001, 384, 200)])
def test_kmeans_assign_kernel(dev, n, d, c):
    """Random blobs, a duplicated centroid (ties go to the lower index),
    a single centroid, and nlist = N (every row its own centroid)."""
    rng = np.random.default_rng(n + c)
    x = _blobs(rng, n, d, c)
    cent = x.copy() if c == n else x[rng.permutation(n)[:c]].copy()
    if 2 < c < n:
        cent[1] = cent[0]
    xt, ct = torch.from_numpy(x).to(dev), torch.from_numpy(cent).to(dev)
    before = kernels.launch_counts()["kmeans_assign"]
    got = kmeans_assign(xt, ct)
    assert kernels.launch_counts()["kmeans_assign"] == before + 1
    want = kmeans_assign_plain(xt, ct)
    assert got.dtype == torch.int32 and got.shape == (n,)
    dist = _distances(x.astype(np.float64), cent.astype(np.float64))
    g, w = got.cpu().numpy(), want.cpu().numpy()
    rows = np.nonzero(g != w)[0]
    gap = np.abs(dist[rows, g[rows]] - dist[rows, w[rows]])
    assert (gap <= 1e-4 * np.abs(dist[rows]).max(axis=1)).all()
    assert len(rows) <= max(1, n // 1000)
    if 2 < c < n:
        assert not (g == 1).any()   # the duplicate of centroid 0
    if c == n:
        assert (g == np.arange(n)).all()
    if c == 1:
        assert not g.any()


@pytest.mark.parametrize("spherical", [False, True])
@pytest.mark.parametrize("n,d,c", [(1000, 384, 37), (3001, 16, 1),
                                   (300, 8, 300), (100003, 384, 500)])
def test_kmeans_update_kernel(dev, n, d, c, spherical):
    """Means (and renormalised means) equal to the plain version's, an
    empty cluster keeps its centroid, and two runs give the same bits."""
    rng = np.random.default_rng(n + c + spherical)
    x = torch.from_numpy(_blobs(rng, n, d, c)).to(dev)
    assign = rng.integers(0, c, n).astype(np.int32)
    if c > 2:
        assign[assign == 2] = 0   # cluster 2 is empty
    assign = torch.from_numpy(assign).to(dev)
    old = torch.from_numpy(rng.standard_normal((c, d)).astype(np.float32)
                           ).to(dev)
    before = kernels.launch_counts()["kmeans_update"]
    got = kmeans_update(x, assign, old, spherical)
    again = kmeans_update(x, assign, old, spherical)
    assert kernels.launch_counts()["kmeans_update"] == before + 2
    assert torch.equal(got, again)
    _close(got, kmeans_update_plain(x, assign, old, spherical),
           dict(rtol=1e-4, atol=1e-5))
    if c > 2:
        assert torch.equal(got[2], old[2])
    if spherical:
        norms = torch.linalg.vector_norm(got, dim=1)
        live = torch.bincount(assign.long(), minlength=c) > 0
        _close(norms[live], torch.ones_like(norms[live]),
               dict(rtol=1e-5, atol=1e-6))



K10_EDGES = {
    # name: (n, d, c, how the rows are assigned)
    "one_cluster": (3001, 16, 1, "uniform"),
    "c_equals_n": (300, 8, 300, "identity"),
    "all_but_one": (5000, 12, 7, "all_but_one"),
    "empty_and_skewed": (100003, 384, 511, "skewed"),
    "width_4": (4099, 4, 9, "uniform"),
    "width_1024": (3000, 1024, 40, "uniform"),
    "short_lists": (2000, 384, 100, "uniform"),
    "above_2048_clusters": (20000, 32, 3000, "uniform"),
    "one_pass_edge": (12289, 64, 2048, "uniform"),
}


def _k10_assign(rng, n, c, how):
    if how == "identity":
        a = np.arange(n)
    elif how == "all_but_one":
        a = np.full(n, 3)
        a[n // 2] = 5
    elif how == "skewed":   # half in one list, every eighth list empty
        live = np.array([j for j in range(1, c) if j % 8 != 0])
        a = live[rng.integers(0, len(live), n)]
        a[rng.permutation(n)[:n // 2]] = 0
    else:
        a = rng.integers(0, c, n)
        if c > 2:
            a[a == 2] = 0
    return a.astype(np.int32)


@pytest.mark.parametrize("spherical", [False, True])
@pytest.mark.parametrize("case", sorted(K10_EDGES))
def test_kmeans_update_range_edges(dev, case, spherical):
    """The range sums at their edges: one cluster (across every range), as
    many clusters as rows, one list holding all rows but one, half the
    rows in one list with empty lists beside it, widths 4 and 1024, lists
    shorter than a range, more than 2,048 clusters (the counting sort of
    1,024-row tiles) and exactly 2,048: within the
    plain version's tolerance, empty lists kept, two runs bit-equal, and
    without the renormalisation bit-equal to the emulation's fixed-order
    sums (kmeans.ranged_update over the launch's grid)."""
    from code2vec_tpu_torch.kernels import kmeans as kk
    n, d, c, how = K10_EDGES[case]
    rng = np.random.default_rng(n + d + c)
    x = _blobs(rng, n, d, c)
    a = _k10_assign(rng, n, c, how)
    old = rng.standard_normal((c, d)).astype(np.float32)
    xt, at, ot = (torch.from_numpy(v).to(dev) for v in (x, a, old))
    got = kmeans_update(xt, at, ot, spherical)
    assert torch.equal(got, kmeans_update(xt, at, ot, spherical))
    _close(got, kmeans_update_plain(xt, at, ot, spherical),
           dict(rtol=1e-4, atol=1e-5))
    empty = np.bincount(a, minlength=c) == 0
    assert torch.equal(got[torch.from_numpy(empty).to(dev)],
                       ot[torch.from_numpy(empty).to(dev)])
    if not spherical:
        want = kk.ranged_update(torch.from_numpy(x), torch.from_numpy(a),
                                torch.from_numpy(old),
                                grid=kk.update_grid(dev, d))
        assert torch.equal(got.cpu(), want)


def test_kmeans_update_plan_fits_the_kernels_layout(dev):
    """update_plan's scratch is the kernel's own (its layout export), and
    the sum launch fills every SM."""
    from code2vec_tpu_torch.kernels import kmeans as kk
    kk._update_fn()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n, d, c in ((1, 4, 1), (261245, 384, 511), (1000000, 384, 1000),
                    (20000, 32, 3000), (4099, 1024, 2048)):
        grid = kk.update_grid(dev, d)
        assert grid >= sms and grid % sms == 0
        assert kk.update_plan(n, d, c, grid).scratch_bytes == \
            kk._fns["update_scratch"](n, d, c, grid)


def _ivf_index(rng, dev, scheme, sizes, d=384, dup=True):
    """An IVF layout with the given list sizes (0 and 1 included), rows
    near their list's centroid, exact duplicates (inside one list and
    across two lists) and, for int8, an all-zero row (scale 0)."""
    nlist = len(sizes)
    cent = (3.0 * rng.standard_normal((nlist, d))).astype(np.float32)
    owner = np.repeat(np.arange(nlist), sizes)
    rows = (cent[owner] + rng.standard_normal((len(owner), d))
            ).astype(np.float32)
    offsets = np.zeros(nlist + 1, np.int64)
    np.cumsum(sizes, out=offsets[1:])
    big = int(np.argmax(sizes))
    lo = int(offsets[big])
    if dup:
        rows[lo + 3:lo + 6] = rows[lo + 2]          # ties inside one list
        other = int(np.argsort(sizes)[-2])
        rows[int(offsets[other])] = rows[lo + 2]    # and across lists
        rows[lo + 7] = 0.0
    scales = None
    if scheme == "int8":
        q, s = quantize_rows(rows)
        rows, scales = q, torch.from_numpy(s[:, 0].copy()).to(dev)
    t = {"cent": torch.from_numpy(cent).to(dev),
         "rows": torch.from_numpy(rows).to(dev),
         "offsets": torch.from_numpy(offsets).to(dev), "scales": scales,
         "max_len": max(sizes)}
    return t, lo


@pytest.mark.parametrize("scheme", ["f32", "int8"])
@pytest.mark.parametrize("b,k,nprobe,ids", [
    (1, 1, 3, False), (64, 64, 3, False), (7, 10, 9, False),
    (64, 16, 2, True), (5, 64, 9, True)])
def test_ivf_search_kernel(dev, scheme, b, k, nprobe, ids):
    """Lists of 0 and 1 rows, nprobe = nlist (9), k = 1 and 64, k above
    the candidates (dead slots -1 or id 0, value -inf), one query,
    duplicate rows and, for int8, a row whose scale is 0."""
    rng = np.random.default_rng(b + k + nprobe)
    sizes = [0, 1, 40, 0, 25, 3, 1, 30, 17]
    if nprobe == 3:  # small lists first: some queries get fewer than k
        sizes = [3, 1, 40, 0, 5, 3, 1, 9, 17]
    t, lo = _ivf_index(rng, dev, scheme, sizes)
    n = int(sum(sizes))
    q = torch.from_numpy(rng.standard_normal((b, 384)).astype(np.float32)
                         ).to(dev)
    q[0] = t["rows"][lo + 2].float() * (1.0 if t["scales"] is None
                                        else t["scales"][lo + 2])
    gids = (torch.from_numpy(rng.permutation(10 * n)[:n].astype(np.int32)
                             ).to(dev) if ids else None)
    args = (q, t["cent"], t["rows"], t["offsets"], nprobe, k)
    kw = dict(scales=t["scales"], global_ids=gids, max_len=t["max_len"])
    name = "ivf_search_int8" if scheme == "int8" else "ivf_search"
    before = kernels.launch_counts()
    got_v, got_i = ivf_search(*args, **kw)
    # one launch, counted by its instantiation alone
    assert kernels.launch_counts() == {**before, name: before[name] + 1}
    want_v, want_i = ivf_search_plain(*args, **kw)
    assert torch.equal(got_i, want_i)
    # scores here run to ~4e3 (a row with itself) while others cancel to
    # ~0.1: the error of an f32 sum of 384 products scales with the
    # products, so atol is 1e-6 of the largest score
    live = torch.isfinite(want_v)
    _close(got_v, want_v, dict(rtol=1e-5, atol=1e-6 * float(
        want_v[live].abs().max())))
    dead = torch.isneginf(got_v)
    assert (got_i[dead] == (0 if ids else -1)).all()
    # each query's dead slots: k minus the rows of its probed lists
    _, probe = top_positions(q @ t["cent"].T, nprobe)
    cands = (t["offsets"][1:] - t["offsets"][:-1])[probe].sum(dim=1)
    assert torch.equal(dead.sum(dim=1), (k - cands).clamp(min=0))


def test_ivf_search_duplicate_order(dev):
    """Identical rows come back in candidate order: probe rank, then the
    offset in the list."""
    rng = np.random.default_rng(9)
    t, lo = _ivf_index(rng, dev, "f32", [20, 30, 10])
    q = (t["rows"][lo + 2] * 3).reshape(1, -1).contiguous()
    _, got = ivf_search(q, t["cent"], t["rows"], t["offsets"], 3, 5,
                        max_len=t["max_len"])
    other = int(t["offsets"][0])   # the copy in the second-largest list
    rank = torch.argsort(-(t["cent"] @ q[0]), stable=True).tolist()
    big, second = 1, 0
    first_list = [lo + 2, lo + 3, lo + 4, lo + 5]
    order = (first_list + [other] if rank.index(big) < rank.index(second)
             else [other] + first_list)
    assert got[0].tolist() == order


def test_ivf_search_refuses_large_k(dev):
    """No k is refused any more: k 65 over 20 candidates answers as the
    plain version does (20 rows, then dead slots)."""
    rng = np.random.default_rng(1)
    t, _ = _ivf_index(rng, dev, "f32", [10, 10], dup=False)
    q = torch.from_numpy(rng.standard_normal((2, 384)).astype(np.float32)
                         ).to(dev)
    args = (q, t["cent"], t["rows"], t["offsets"], 2, 65)
    got_v, got_i = ivf_search(*args, max_len=t["max_len"])
    want_v, want_i = ivf_search_plain(*args, max_len=t["max_len"])
    assert torch.equal(got_i, want_i)
    assert torch.isneginf(got_v[:, 20:]).all()


# ------------------------------------------------- large k (K13), K12


def _select_close(got, want):
    """K13 against the plain stable sort: positions equal, values equal
    bit for bit (they are read back from the scores), NaN on NaN."""
    assert torch.equal(got[1], want[1])
    g, w = got[0].cpu(), want[0].cpu()
    assert torch.equal(torch.isnan(g), torch.isnan(w))
    assert torch.equal(g.nan_to_num(), w.nan_to_num())


@pytest.mark.parametrize("b,n,k", [(3, 1001, 1), (64, 30011, 100),
                                   (5, 200003, 1000), (2, 40000, 20000),
                                   (4, 77, 77)])
def test_select_topk_kernel(dev, b, n, k):
    """Ties (a value repeated across the row), NaN and -inf entries, +0
    and -0, k up to the whole row and past the shared-memory sort."""
    from code2vec_tpu_torch.kernels.select import (
        padded_width, select_topk, select_topk_plain,
    )
    rng = np.random.default_rng(n + k)
    x = rng.standard_normal((b, n)).astype(np.float32)
    x[:, ::7] = 0.5                  # ties spread over the row
    x[0, 3] = np.nan
    x[0, 10] = -np.inf
    x[-1, 5], x[-1, 6] = 0.0, -0.0
    scores = torch.full((b, padded_width(n)), 7.0, device=dev)
    scores[:, :n] = torch.from_numpy(x).to(dev)  # padding never selected
    before = kernels.launch_counts()["select_topk"]
    got = select_topk(scores, k, n=n)
    assert kernels.launch_counts()["select_topk"] == before + 1
    _select_close(got, select_topk_plain(scores, k, n=n))
    again = select_topk(scores, k, n=n)
    assert torch.equal(got[1], again[1])



def _k13_scores(rng, case):
    """(scores (B, n) f32 numpy, k) of one K13 edge case."""
    from code2vec_tpu_torch.kernels import select as ks
    if case == "k1_odd_n":
        return rng.standard_normal((3, 4097)).astype(np.float32), 1
    if case == "k_is_n":
        return rng.standard_normal((2, 1001)).astype(np.float32), 1001
    if case == "all_equal":
        return np.full((3, 200003), 0.25, np.float32), 1000
    if case == "one_bin":   # distinct values in [1, 1.25): one 11-bit bin
        return (1.0 + 0.24 * rng.random((2, 200003))).astype(np.float32), 999
    # B 64 x 1M, the main path's batch: slices of 174,764 columns, wider
    # than a slice's candidate buffer, so these rows overflow it
    wide = (64, 1000000)
    if case in ("all_equal_wide_k5", "all_equal_wide_k1000"):
        return np.full(wide, 0.25, np.float32), int(case.rsplit("k", 1)[1])
    if case in ("one_bin_wide_k5", "one_bin_wide_k1000"):
        return ((1.0 + 0.24 * rng.random(wide)).astype(np.float32),
                int(case.rsplit("k", 1)[1]))
    if case == "mixed_wide":   # overflowing rows beside buffered ones
        x = rng.standard_normal(wide).astype(np.float32)
        x[::2] = 0.25
        return x, 1000
    if case == "all_equal_b1024":   # one slice a row, wider than its buffer
        return np.full((1024, 20000), -3.0, np.float32), 100
    if case == "nan_inf_zero":
        x = rng.standard_normal((4, 50001)).astype(np.float32)
        x[:, ::5] = np.nan
        x[:, 1::97] = np.inf
        x[:, 2::89] = -np.inf
        x[:, 3::7] = 0.0
        x[:, 4::11] = -0.0
        return x, 20000
    if case == "ties_across_slices":
        b, n = 2, 300000
        x = rng.standard_normal((b, n)).astype(np.float32)
        cut = ks.plan(b, n, 4, 132).slice
        x[:, cut - 3:cut + 4] = 9.0   # seven ties across a slice boundary
        x[:, 2 * cut - 1:2 * cut + 1] = 9.0
        return x, 5
    if case == "b1_1m":
        return rng.standard_normal((1, 1000000)).astype(np.float32), 1000
    if case == "b64_wide":
        return rng.standard_normal((64, 10432)).astype(np.float32), 100
    raise ValueError(case)


# the cases whose candidates overflow a slice's buffer, by how many rows
K13_OVERFLOW = {"all_equal_wide_k5": 64, "all_equal_wide_k1000": 64,
                "one_bin_wide_k5": 64, "one_bin_wide_k1000": 64,
                "mixed_wide": 32, "all_equal_b1024": 1024}


@pytest.mark.parametrize("case", [
    "k1_odd_n", "k_is_n", "all_equal", "one_bin", "nan_inf_zero",
    "ties_across_slices", "b1_1m", "b64_wide", *K13_OVERFLOW])
def test_select_topk_slice_edges(dev, case):
    """The sliced radix select at its edges: k 1 on a width that is no
    multiple of 4, k = n, a row of one repeated value and one packed into
    one 11-bit bin (at B 2-3 x 200,003 their slices are no wider than the
    candidate buffer, so the candidates stay buffered; at B 64 x 1M,
    k 5 and 1000, they overflow it and all the row's CTAs refine the row,
    as they do beside buffered rows in one call, and at B 1024 a row's one
    CTA does), NaN, +-inf and +-0 spread over the row, equal values
    across slice boundaries that the k-th falls in, B 1 x 1M and K11's
    candidate width: positions and value bits equal to the plain
    version's, on every run; the overflowing cases are shown to overflow
    by the filter's candidate counts against the plan's cap."""
    from code2vec_tpu_torch.kernels.select import (
        padded_width, plan, select_topk, select_topk_plain, slice_candidates,
    )
    rng = np.random.default_rng(len(case))
    x, k = _k13_scores(rng, case)
    b, n = x.shape
    scores = torch.full((b, padded_width(n)), np.inf, device=dev)
    scores[:, :n] = torch.from_numpy(x).to(dev)  # padding never selected
    del x
    p = plan(b, n, k,
             torch.cuda.get_device_properties(dev).multi_processor_count)
    over = int((slice_candidates(scores, k, p, n).max(1).values > p.cap)
               .sum())
    assert over == K13_OVERFLOW.get(case, 0)
    before = kernels.launch_counts()["select_topk"]
    got = select_topk(scores, k, n=n)
    assert kernels.launch_counts()["select_topk"] == before + 1
    _select_close(got, select_topk_plain(scores, k, n=n))
    again = select_topk(scores, k, n=n)
    assert torch.equal(got[1], again[1])


def test_select_plan_fits_the_kernels_layout(dev):
    """select.plan's scratch is the kernel's own (its layout export)."""
    from code2vec_tpu_torch.kernels import select as ks
    ks._fn()
    for b, n, k in ((1, 1, 1), (64, 1000000, 1000), (1, 1000000, 1000),
                    (64, 261245, 100), (2, 40000, 20000)):
        p = ks.plan(b, n, k, 132)
        assert p.scratch_bytes == ks._fns["scratch_bytes"](
            b, p.slices, p.slice, k, p.cap, p.sort_len)


@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("k", [65, 1000])
def test_blockwise_topk_large_k_kernel(dev, f32, k):
    """K3's large-k mode: the scores, then K13; ties among identical
    rows go to the lower row, the logsumexp is the lists' one."""
    rng = np.random.default_rng(k)
    v, valid = 20011, 20003
    cv, table = _separated(rng, v, 9, valid)
    table[[11, 700, 9000]] = table[5]               # identical rows
    cv_t = torch.from_numpy(cv).to(dev)
    tbl = torch.from_numpy(table).to(dev)
    cd = torch.float32 if f32 else torch.bfloat16
    name = "blockwise_topk_f32" if f32 else "blockwise_topk"
    before = kernels.launch_counts()
    got = blockwise_topk(cv_t, tbl, k, 4096, valid_rows=valid,
                         compute_dtype=cd)
    after = kernels.launch_counts()
    assert after[name] == before[name] + 1
    assert after["select_topk"] == before["select_topk"] + 1
    want = blockwise_topk_plain(cv_t, tbl, k, 4096, valid_rows=valid,
                                compute_dtype=cd)
    tol = F32DOT if f32 else F32SUM
    _close(got.values, want.values, tol)
    _close(got.lse, want.lse, tol)
    small = blockwise_topk(cv_t, tbl, 64, 4096, valid_rows=valid,
                           compute_dtype=cd)
    _close(got.lse, small.lse, dict(rtol=1e-6, atol=1e-6))
    # the well-separated head and the identical rows' order are exact
    assert torch.equal(got.indices[:, :64], small.indices)
    assert (got.indices < valid).all()
    vals, idx = got.values.cpu(), got.indices.cpu()
    for r in range(idx.shape[0]):
        same = [int(i) for i, x in zip(idx[r], vals[r])
                if int(i) in (5, 11, 700, 9000)]
        assert same == sorted(same)


@pytest.mark.parametrize("scheme", ["f32", "int8"])
@pytest.mark.parametrize("k,nprobe", [(65, 3), (100, 9), (200, 9)])
def test_ivf_search_large_k_kernel(dev, scheme, k, nprobe):
    """K11's large-k mode against the plain version: candidate order
    among duplicates, dead slots past the candidates."""
    rng = np.random.default_rng(k + nprobe)
    sizes = [0, 1, 40, 0, 25, 3, 1, 30, 17]
    t, lo = _ivf_index(rng, dev, scheme, sizes)
    n = int(sum(sizes))
    q = torch.from_numpy(rng.standard_normal((6, 384)).astype(np.float32)
                         ).to(dev)
    q[0] = t["rows"][lo + 2].float() * (1.0 if t["scales"] is None
                                        else t["scales"][lo + 2])
    gids = torch.from_numpy(rng.permutation(10 * n)[:n].astype(np.int32)
                            ).to(dev) if scheme == "int8" else None
    args = (q, t["cent"], t["rows"], t["offsets"], nprobe, k)
    kw = dict(scales=t["scales"], global_ids=gids, max_len=t["max_len"])
    name = "ivf_search_int8" if scheme == "int8" else "ivf_search"
    before = kernels.launch_counts()
    got_v, got_i = ivf_search(*args, **kw)
    after = kernels.launch_counts()
    assert after[name] == before[name] + 1
    assert after["select_topk"] == before["select_topk"] + 1
    want_v, want_i = ivf_search_plain(*args, **kw)
    assert torch.equal(got_i, want_i)
    live = torch.isfinite(want_v)
    _close(got_v, want_v, dict(rtol=1e-5, atol=1e-6 * float(
        want_v[live].abs().max())))


@pytest.mark.parametrize("keep", [1.0, 0.5])
@pytest.mark.parametrize("b,m,repeat", [(3, 5, False), (64, 200, False),
                                        (16, 33, True)])
def test_encoder_backward_rows_kernel(dev, keep, b, m, repeat):
    """K5's row mode against its plain version; its rows summed by id
    against the dense mode's table gradients."""
    from code2vec_tpu_torch.kernels.encoder_backward import (
        encoder_backward_rows, encoder_backward_rows_plain,
    )
    rng, tok, pth, w, ids = _train_inputs(dev, b, m, repeat=repeat)
    drawn = torch.empty((b, m, 384), dtype=torch.bool, device=dev)
    t, lo = context_encoder(tok, None, pth, None, w, *ids,
                            dropout=Dropout(keep, seed=1, step=2,
                                            out_mask=drawn), residual=True)
    dt = torch.from_numpy((0.1 * rng.standard_normal((b, m, 384))
                           ).astype(np.float32)).to(dev).to(torch.bfloat16)
    drop = Dropout(keep, seed=1, step=2)
    before = kernels.launch_counts()
    got = encoder_backward_rows(dt, t, lo, tok, pth, w, *ids, dropout=drop)
    after = kernels.launch_counts()
    assert after["encoder_backward_rows"] == \
        before["encoder_backward_rows"] + 1
    assert after["encoder_backward"] == before["encoder_backward"]
    assert got[0].shape == (2, b, m, 128) and got[1].shape == (b, m, 128)
    assert got[0].dtype == got[1].dtype == torch.bfloat16
    want = encoder_backward_rows_plain(dt, t, lo, tok, pth, w, *ids,
                                       dropout=Dropout(keep, mask=drawn))
    for name, g, x in zip(("token rows", "path rows", "d_transform"), got,
                          want):
        _step_close(g, x, name)
    dense = encoder_backward(dt, t, lo, tok, pth, w, *ids, dropout=drop)
    assert torch.equal(got[2], dense[2])
    tok_ids = torch.cat([ids[0].flatten(), ids[2].flatten()]).long()
    summed = torch.zeros_like(tok).index_add_(
        0, tok_ids, got[0].reshape(-1, 128).float())
    _close(summed, dense[0], dict(rtol=1e-5, atol=1e-6))



def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("widths", [(32, 64, 128), (64, 128, 256),
                                    (128, 128, 384)])
@pytest.mark.parametrize("b,m", [(3, 37), (7, 200)])
@pytest.mark.parametrize("drop_mode", ["draw", "mask"])
def test_encoder_backward_ragged_rows_widths_and_bad_ids(dev, widths, b, m,
                                                         drop_mode):
    """Both K5 modes at row counts that are no multiple of any tile,
    context widths 128, 256 and 384, dropout redrawn (Philox) or
    injected, and ids of -1 and past the table, which gather a NaN row
    (jnp.take's fill) and whose table gradient rows are dropped. The
    plain reference takes tables with a NaN row appended for the bad ids;
    its rows, scattered by the ids that are in range, give the dense
    mode's table gradients. dW the same bits on a rerun and in both
    modes."""
    from code2vec_tpu_torch.kernels.encoder_backward import (
        encoder_backward_rows, encoder_backward_rows_plain,
    )
    td, pd, d = widths
    k_dim = 2 * td + pd
    rng = np.random.default_rng(b * m + k_dim)
    v_tok, v_path = 600, 400
    tok = torch.from_numpy((0.3 * rng.standard_normal((v_tok, td))
                            ).astype(np.float32)).to(dev)
    pth = torch.from_numpy((0.3 * rng.standard_normal((v_path, pd))
                            ).astype(np.float32)).to(dev)
    w = torch.from_numpy((0.1 * rng.standard_normal((k_dim, d))
                          ).astype(np.float32)).to(dev)
    ids = [torch.from_numpy(rng.integers(0, n, (b, m)).astype(np.int32)
                            ).to(dev) for n in (v_tok, v_path, v_tok)]
    drawn = torch.empty((b, m, k_dim), dtype=torch.bool, device=dev)
    context_encoder(tok, None, pth, None, w, *ids,
                    dropout=Dropout(0.5, seed=7, step=1, out_mask=drawn))
    bad = [x.clone() for x in ids]
    bad[0][0, 0] = -1
    bad[1][1, 2] = v_path
    bad[2][2, 5] = v_tok + 3
    th = torch.tanh(torch.from_numpy(rng.standard_normal((b, m, d)).astype(
        np.float32)).to(dev))
    t = th.to(torch.bfloat16)
    lo = (th - t.float()).to(torch.bfloat16)
    dt = torch.from_numpy((0.1 * rng.standard_normal((b, m, d))
                           ).astype(np.float32)).to(dev).to(torch.bfloat16)
    drop = (Dropout(0.5, seed=7, step=1) if drop_mode == "draw"
            else Dropout(0.5, mask=drawn))
    args = (dt, t, lo, tok, pth, w, *bad)
    got = encoder_backward(*args, dropout=drop)
    again = encoder_backward(*args, dropout=drop)
    rows = encoder_backward_rows(*args, dropout=drop)
    rows_again = encoder_backward_rows(*args, dropout=drop)

    def nan_row(table):
        return torch.cat([table, torch.full_like(table[:1], math.nan)])

    def to_nan_row(x, v):
        return torch.where((x >= 0) & (x < v), x, v)

    want = encoder_backward_rows_plain(
        dt, t, lo, nan_row(tok), nan_row(pth), w, to_nan_row(bad[0], v_tok),
        to_nan_row(bad[1], v_path), to_nan_row(bad[2], v_tok),
        dropout=Dropout(0.5, mask=drawn))
    _step_close(rows[0], want[0], "token rows")
    _step_close(rows[1], want[1], "path rows")
    nan = torch.isnan(want[2])
    assert nan.any()  # the bad ids reached dW
    assert torch.equal(torch.isnan(got[2]), nan)
    _step_close(torch.where(nan, 0, got[2]), torch.where(nan, 0, want[2]),
                "d_transform")

    def scattered(v, parts):
        out = torch.zeros((v, parts[0][1].shape[-1]), device=dev)
        for x, r in parts:
            x = x.flatten().long()
            ok = (x >= 0) & (x < v)
            out.index_add_(0, x[ok], r.reshape(-1, r.shape[-1]).float()[ok])
        return out

    _step_close(got[0], scattered(v_tok, [(bad[0], want[0][0]),
                                          (bad[2], want[0][1])]), "d_token")
    _step_close(got[1], scattered(v_path, [(bad[1], want[1])]), "d_path")
    for x in (again[2], rows[2], rows_again[2]):
        assert torch.equal(_bits(x), _bits(got[2]))


def _zipf_ids(rng, n, v, s=1.07):
    ranks = np.arange(1, v + 1, dtype=np.float64)
    p = ranks ** -s
    return rng.choice(v, size=n, p=p / p.sum()).astype(np.int32)


@pytest.mark.parametrize("mu", ["bfloat16", "float32"])
@pytest.mark.parametrize("v,n,dist", [(1000, 5000, "uniform"),
                                      (50000, 40000, "zipf"),
                                      (300, 70000, "zipf"),
                                      (5000, 1, "uniform")])
def test_sparse_adam_kernel(dev, mu, v, n, dist):
    """K12 against its plain version: touched rows within Adam's
    tolerance, untouched rows bit-equal, ids past the table dropped, two
    runs bit-equal. The gradient rows are bf16 integers times 2^-12, so
    every partial sum of a duplicated id is exact in f32 and the kernel's
    order of the sums (32-pair chunks, a long id's partials in 16 runs)
    gives the plain version's g."""
    from code2vec_tpu_torch.kernels.sparse_adam import (
        sparse_adam, sparse_adam_plain,
    )
    from code2vec_tpu_torch.training.sparse_adam import RowAdamSlots
    rng = np.random.default_rng(v + n)
    ids = (_zipf_ids(rng, n, v) if dist == "zipf"
           else rng.integers(0, v, n).astype(np.int32))
    if n > 3:
        ids[:3] = [v, v + 9, -1]
    grads = (rng.integers(-127, 128, (n, 128)) * 2.0 ** -12).astype(
        np.float32)
    mdt = torch.bfloat16 if mu == "bfloat16" else torch.float32
    table = torch.from_numpy(rng.standard_normal((v, 128)).astype(
        np.float32)).to(dev)
    m0 = torch.from_numpy((rng.standard_normal((v, 128)) * 1e-3).astype(
        np.float32)).to(dev).to(mdt)
    n0 = torch.from_numpy((rng.random((v, 128)) * 1e-6).astype(
        np.float32)).to(dev)
    ids_t = torch.from_numpy(ids).to(dev)
    g_t = torch.from_numpy(grads).to(dev).to(torch.bfloat16)
    outs = []
    for _ in range(2):
        tb, slots = table.clone(), RowAdamSlots(mu=m0.clone(),
                                                nu=n0.clone())
        before = kernels.launch_counts()["sparse_adam"]
        sparse_adam(tb, slots, ids_t, g_t, t=5, lr=1e-3, b1=0.9,
                    b2=0.999, eps=1e-8)
        assert kernels.launch_counts()["sparse_adam"] == before + 1
        outs.append((tb, slots.mu, slots.nu))
    for a, b in zip(*outs):
        assert torch.equal(a, b)                # two runs, the same bits
    tb, slots = table.clone(), RowAdamSlots(mu=m0.clone(), nu=n0.clone())
    sparse_adam_plain(tb, slots, ids_t, g_t, t=5, lr=1e-3, b1=0.9,
                      b2=0.999, eps=1e-8)
    got_p, got_m, got_n = outs[0]
    _close(got_p, tb, dict(rtol=1e-6, atol=1e-9))
    _close(got_n, slots.nu, dict(rtol=1e-6, atol=1e-12))
    step = 2.0 ** -7 if mdt == torch.bfloat16 else 1e-6
    assert ((got_m.float() - slots.mu.float()).abs()
            <= step * slots.mu.float().abs() + 1e-12).all()
    touched = torch.zeros(v, dtype=torch.bool, device=dev)
    ok = (ids_t >= 0) & (ids_t < v)
    touched[ids_t[ok].long()] = True
    assert torch.equal(got_p[~touched], table[~touched])
    assert torch.equal(got_m[~touched], m0[~touched])
    assert torch.equal(got_n[~touched], n0[~touched])


# ------------------------------------------- fp8 and int4 table formats

FORMATS = ("e4m3", "e5m2", "int4")


def _formatted(table, dev, fmt):
    """(table tensor in the dtype that names its format, (V, 1) scales)
    of an f32 numpy table; fp8 as a view of its bytes, int4 packed."""
    if fmt == "int4":
        q, s = quant.quantize_rows_int4(table)
        return torch.from_numpy(q).to(dev), torch.from_numpy(s).to(dev)
    q, s = quant.quantize_rows_fp8(table, fmt)
    return (torch.from_numpy(q).to(dev).view(quant.FP8_DTYPES[fmt]),
            torch.from_numpy(s).to(dev))


def _mode(name, fmt):
    return f"{name}_{'int4' if fmt == 'int4' else 'fp8'}"


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("b,m", [(3, 5), (64, 200)])
def test_context_encoder_quant_formats(dev, fmt, b, m):
    """K1 reading fp8 and int4 tables against its plain version, to the
    int8 mode's tolerance (every value decodes exactly); an id outside
    the table gives NaN rows, as the reference's gather does."""
    rng = np.random.default_rng(b * m + len(fmt))
    tok, tok_s = _formatted(
        (0.2 * rng.standard_normal((5000, 128))).astype(np.float32), dev, fmt)
    pth, pth_s = _formatted(
        (0.2 * rng.standard_normal((3000, 128))).astype(np.float32), dev, fmt)
    w = torch.from_numpy((0.05 * rng.standard_normal((384, 384))
                          ).astype(np.float32)).to(dev)
    ids = [torch.from_numpy(rng.integers(0, n, (b, m)).astype(np.int32)
                            ).to(dev) for n in (5000, 3000, 5000)]
    name = _mode("context_encoder", fmt)
    before = kernels.launch_counts()
    got = context_encoder(tok, tok_s, pth, pth_s, w, *ids)
    assert kernels.launch_counts() == {**before, name: before[name] + 1}
    want = context_encoder_plain(tok, tok_s, pth, pth_s, w, *ids)
    _close(got, want, BF16)
    with pytest.raises(ValueError, match="train mode"):
        context_encoder(tok, tok_s, pth, pth_s, w, *ids,
                        dropout=Dropout(keep=0.5))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("k", [1, 10, 64, 100])
def test_blockwise_topk_quant_formats(dev, fmt, k):
    """K3 over fp8 and int4 tables (k 100: the large-k mode through K13)
    against its plain version: the same indices, values and logsumexp
    within the int8 mode's F32SUM."""
    rng = np.random.default_rng(k + len(fmt))
    v, valid, b = 20011, 20003, 64
    cv, table = _separated(rng, v, b, valid)
    if k > 64:   # 101 separated rows: widen the head
        u = cv.mean(axis=0) / np.linalg.norm(cv.mean(axis=0))
        hot = np.linspace(2, valid - 2, k + 1).astype(int)
        for j, row in enumerate(hot):
            table[row] = u * (1.0 + 0.05 * j)
    tbl, scl = _formatted(table, dev, fmt)
    cv = torch.from_numpy(cv).to(dev)
    name = _mode("blockwise_topk", fmt)
    before = kernels.launch_counts()[name]
    got = blockwise_topk(cv, tbl, k, 4096, scales=scl, valid_rows=valid)
    assert kernels.launch_counts()[name] == before + 1
    want = blockwise_topk_plain(cv, tbl, k, 4096, scales=scl,
                                valid_rows=valid,
                                compute_dtype=torch.bfloat16)
    assert torch.equal(got.indices, want.indices)
    _close(got.values, want.values, F32SUM)
    _close(got.lse, want.lse, F32SUM)


@pytest.mark.parametrize("fmt", FORMATS)
def test_label_logits_quant_formats(dev, fmt):
    rng = np.random.default_rng(40 + len(fmt))
    table = (0.2 * rng.standard_normal((700, 384))).astype(np.float32)
    table[3] = 0.0                                # scale 0
    tbl, scl = _formatted(table, dev, fmt)
    cv = torch.from_numpy(rng.standard_normal((9, 384)).astype(np.float32)
                          ).to(dev)
    labels = torch.tensor([0, 5, 699, 700, -1, 3, 3, 100, 42],
                          dtype=torch.int32, device=dev)
    name = _mode("label_logits", fmt)
    before = kernels.launch_counts()[name]
    got = label_logits(cv, tbl, labels, scales=scl)
    assert kernels.launch_counts()[name] == before + 1
    _close(got, label_logits_plain(cv, tbl, labels, scales=scl,
                                   compute_dtype=torch.bfloat16), F32SUM)
    assert got[3] == got[4] == -1e30 and got[5] == 0.0


@pytest.mark.parametrize("fmt", ("f32", "int8") + FORMATS)
def test_eval_batch_every_format(dev, fmt):
    """K1 (m 200), K3 (k 10) and K4 at the evaluation's batch of 1024 rows
    (K3's rows span 16 row tiles) in every table format, against their
    plain versions."""
    rng = np.random.default_rng(1024 + len(fmt))
    b, v, valid = 1024, 20011, 20003

    def as_format(t):
        if fmt in FORMATS:
            return _formatted(t, dev, fmt)
        if fmt == "f32":
            return torch.from_numpy(t).to(dev), None
        return tuple(torch.from_numpy(x).to(dev) for x in quantize_rows(t))

    tok, tok_s = as_format(
        (0.2 * rng.standard_normal((5000, 128))).astype(np.float32))
    pth, pth_s = as_format(
        (0.2 * rng.standard_normal((3000, 128))).astype(np.float32))
    w = torch.from_numpy((0.05 * rng.standard_normal((384, 384))
                          ).astype(np.float32)).to(dev)
    ids = [torch.from_numpy(rng.integers(0, n, (b, 200)).astype(np.int32)
                            ).to(dev) for n in (5000, 3000, 5000)]
    _close(context_encoder(tok, tok_s, pth, pth_s, w, *ids),
           context_encoder_plain(tok, tok_s, pth, pth_s, w, *ids), BF16)
    cv, tgt = _separated(rng, v, b, valid)
    tbl, scl = as_format(tgt)
    cv = torch.from_numpy(cv).to(dev)
    got = blockwise_topk(cv, tbl, 10, 4096, scales=scl, valid_rows=valid)
    want = blockwise_topk_plain(cv, tbl, 10, 4096, scales=scl,
                                valid_rows=valid,
                                compute_dtype=torch.bfloat16)
    assert torch.equal(got.indices, want.indices)
    _close(got.values, want.values, F32SUM)
    _close(got.lse, want.lse, F32SUM)
    labels = torch.from_numpy(rng.integers(0, v, b).astype(np.int32)).to(dev)
    _close(label_logits(cv, tbl, labels, scales=scl),
           label_logits_plain(cv, tbl, labels, scales=scl,
                              compute_dtype=torch.bfloat16), F32SUM)


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_fp8_codes_decode_exactly(dev, fmt):
    """All 256 codes through K3's large-k mode (row j holds code j in its
    first column, the code vector picks that column): each logit is the
    code's value exactly, NaN and infinities included; and the finite
    ones through K4."""
    codes = torch.arange(256, dtype=torch.uint8)
    want = codes.view(quant.FP8_DTYPES[fmt]).float()
    rows = torch.zeros((256, 16), dtype=torch.uint8)
    rows[:, 0] = codes
    tbl = rows.to(dev).view(quant.FP8_DTYPES[fmt])
    ones = torch.ones((256, 1), device=dev)
    cv = torch.zeros((1, 16), device=dev)
    cv[0, 0] = 1.0
    got = blockwise_topk(cv, tbl, 256, 4096, scales=ones)
    logit = torch.empty(256)
    logit[got.indices[0].cpu().long()] = got.values[0].cpu()
    assert torch.equal(torch.isnan(logit), torch.isnan(want))
    fin = ~torch.isnan(want)
    assert torch.equal(logit[fin], want[fin])
    eye = torch.zeros((256, 16), device=dev)
    eye[:, 0] = 1.0
    k4 = label_logits(eye, tbl, torch.arange(256, dtype=torch.int32,
                                             device=dev), scales=ones).cpu()
    finite = torch.isfinite(want)
    assert torch.equal(k4[finite], want[finite])
    assert (k4[~finite] == -1e30).all()


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("k,nprobe", [(10, 3), (64, 9), (100, 9)])
def test_ivf_search_quant_formats(dev, fmt, k, nprobe):
    """K11's fp8 and int4 instantiations (k 100: its large-k mode)
    against the plain version, each counted by its own counter."""
    rng = np.random.default_rng(k + nprobe + len(fmt))
    sizes = [0, 1, 40, 0, 25, 3, 1, 30, 17]
    t, lo = _ivf_index(rng, dev, "f32", sizes)
    rows, scl = _formatted(t["rows"].cpu().numpy(), dev, fmt)
    n = int(sum(sizes))
    q = torch.from_numpy(rng.standard_normal((6, 384)).astype(np.float32)
                         ).to(dev)
    gids = torch.from_numpy(rng.permutation(10 * n)[:n].astype(np.int32)
                            ).to(dev)
    args = (q, t["cent"], rows, t["offsets"], nprobe, k)
    kw = dict(scales=scl[:, 0].contiguous(), global_ids=gids,
              max_len=t["max_len"])
    name = _mode("ivf_search", fmt)
    before = kernels.launch_counts()[name]
    got_v, got_i = ivf_search(*args, **kw)
    assert kernels.launch_counts()[name] == before + 1
    want_v, want_i = ivf_search_plain(*args, **kw)
    assert torch.equal(got_i, want_i)
    live = torch.isfinite(want_v)
    _close(got_v, want_v, dict(rtol=1e-5, atol=1e-6 * float(
        want_v[live].abs().max())))


@pytest.mark.parametrize("scheme", ["fp8_e4m3", "fp8_e5m2", "int4"])
def test_release_model_quant_cuda_matches_cpu(dev, tmp_path, scheme):
    """Artifacts of the new schemes served and evaluated on the GPU and
    on the CPU: the same top-k words (near-ties aside) and metrics."""
    rng = np.random.default_rng(8)
    tokens = [f"t{i}" for i in range(300)]
    paths = [f"p{i}" for i in range(200)]
    names = [f"name|w{i}" for i in range(5000)]
    vocabs = Code2VecVocabs.from_words(tokens, paths, names)

    def u(shape, lim):
        return (rng.random(shape, dtype=np.float32) * 2 - 1) * lim

    params = {"token_embedding": u((301, 128), 0.15),
              "path_embedding": u((201, 128), 0.15),
              "target_embedding": u((5001, 384), 0.09),
              "transform": u((384, 384), 0.09),
              "attention": u((384, 1), 0.09)}
    art = str(tmp_path / "art")
    write_artifact(params, vocabs, art, scheme)
    lines = [f"name|w{i} " + " ".join(
        f"t{rng.integers(300)},p{rng.integers(200)},t{rng.integers(300)}"
        for _ in range(rng.integers(1, 150))) for i in range(70)]
    gpu = ReleaseModel(Config(serve_artifact=art, verbose_mode=0))
    cpu = ReleaseModel(Config(serve_artifact=art, device="cpu",
                              verbose_mode=0))
    counts = kernels.launch_counts()
    got = gpu.predict(lines, with_code_vectors=True)
    want = cpu.predict(lines, with_code_vectors=True)
    mode = "int4" if scheme == "int4" else "fp8"
    after = kernels.launch_counts()
    for k in ("context_encoder", "blockwise_topk", "label_logits"):
        assert after[f"{k}_{mode}"] > counts[f"{k}_{mode}"]
    agree = 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.code_vector, w.code_vector, **BF16)
        agree += g.topk_predicted_words == w.topk_predicted_words
    assert agree >= len(lines) - 2
    corpus = str(tmp_path / "test.c2v")
    with open(corpus, "w") as f:
        f.write("\n".join(lines) + "\n")
    for model in (gpu, cpu):
        model.config.test_data_path = corpus
        model.config.test_batch_size = 32
    g = gpu.evaluate(log_path=None)
    c = cpu.evaluate(log_path=None)
    np.testing.assert_allclose(g.topk_acc, c.topk_acc, atol=2 / len(lines))
    np.testing.assert_allclose(g.loss, c.loss, rtol=1e-3)


# ------------------- K3 and K9 on wgmma: the edges the tiling creates
#
# K3 covers a batch in N tiles of 8-64 code vectors (32 in the float32
# mode) and the table in runs of 64-row tiles, 64-wide K blocks (32 in
# the float32 mode); K9 covers rows in tiles of 128 and centroids in
# tiles of 128 with dead padded columns. The cases below cross each
# boundary: batches of 1 to 1024, a table of 3001 rows (not a whole
# tile) with valid_rows below it, widths 128 to 512, k 1 to 65 (65: the
# large-k mode), every table format, identical rows (ties go to the
# lowest index) and a NaN row (ranks first; f32 tables).

EDGE_FORMATS = ("f32", "int8", "e4m3", "e5m2", "int4", "f32_mode")
EDGE_BATCHES = (1, 8, 12, 63, 65, 256, 1024)


def _edge_table(rng, v, b, valid, d, k):
    """k + 1 well-separated best rows, three rows identical to the best
    one, a masked row above valid_rows that would win."""
    u = rng.standard_normal(d).astype(np.float32)
    u /= np.linalg.norm(u)
    cv = (2.0 * u[None, :] + 0.01 * rng.standard_normal((b, d))
          ).astype(np.float32)
    table = (0.05 * rng.standard_normal((v, d))).astype(np.float32)
    hot = np.linspace(1, valid - 1, k + 1).astype(int)
    rng.shuffle(hot)
    for j, row in enumerate(hot):
        table[row] = u * (1.0 + 0.05 * (k - j))
    best = hot[0]
    dups = [r for r in (0, valid // 2 + 3, valid - 7) if r not in hot]
    table[dups] = table[best]
    table[valid] = u * 10.0
    return cv, table, sorted([best] + dups)


@pytest.mark.parametrize("fmt", EDGE_FORMATS)
@pytest.mark.parametrize("b", EDGE_BATCHES)
def test_blockwise_topk_tiling_edges(dev, fmt, b):
    i = EDGE_BATCHES.index(b) + EDGE_FORMATS.index(fmt)
    d = (128, 256, 384, 512)[i % 4]
    k = (1, 10, 64, 65)[(i // 4 + i) % 4]
    rng = np.random.default_rng(1000 * b + i)
    v, valid = 3001, 2990
    cv, table, ties = _edge_table(rng, v, b, valid, d, k)
    nan_row = None
    if fmt in ("f32", "f32_mode"):
        nan_row = 1500 if 1500 not in ties else 1501
        table[nan_row, 3] = np.nan
    tbl, scl = _edge_operands(table, dev, fmt)
    cd = torch.float32 if fmt == "f32_mode" else torch.bfloat16
    cv_t = torch.from_numpy(cv).to(dev)
    got = blockwise_topk(cv_t, tbl, k, 4096, scales=scl, valid_rows=valid,
                         compute_dtype=cd)
    want = blockwise_topk_plain(cv_t, tbl, k, 4096, scales=scl,
                                valid_rows=valid, compute_dtype=cd)
    tol = F32DOT if fmt == "f32_mode" else F32SUM
    assert torch.equal(got.indices, want.indices)
    _close(got.values, want.values, tol)
    _close(got.lse, want.lse, tol)
    assert torch.isfinite(got.lse).all()
    assert (got.indices < valid).all()
    head = got.indices[:, :len(ties) + (nan_row is not None)].cpu()
    first = ([nan_row] if nan_row is not None else []) + ties
    assert head.tolist() == [first[:k]] * b


def _edge_operands(table, dev, fmt):
    if fmt in FORMATS:
        return _formatted(table, dev, fmt)
    if fmt == "int8":
        return tuple(torch.from_numpy(x).to(dev) for x in quantize_rows(table))
    return torch.from_numpy(table).to(dev), None


@pytest.mark.parametrize("fmt", EDGE_FORMATS)
@pytest.mark.parametrize("b,live", [(64, 63), (64, 12), (1024, 37)])
def test_blockwise_topk_padded_batches(dev, fmt, b, live):
    """The serving path pads a batch with rows whose code vector is zero
    (a zero mask; K2 gives such a row 0): every table row then has the
    same logit, so the top k are rows 0 to k - 1 and the logsumexp that of
    equal logits. One NaN code vector (every logit NaN) beside them. The
    kernel must agree with the plain version on live and padded rows."""
    rng = np.random.default_rng(b + live + EDGE_FORMATS.index(fmt))
    v, valid, k = 3001, 2990, 10
    cv, table, _ = _edge_table(rng, v, b, valid, 384, k)
    cv[live:] = 0.0
    if live + 1 < b:
        cv[live] = np.nan
    tbl, scl = _edge_operands(table, dev, fmt)
    cd = torch.float32 if fmt == "f32_mode" else torch.bfloat16
    cv_t = torch.from_numpy(cv).to(dev)
    got = blockwise_topk(cv_t, tbl, k, 4096, scales=scl, valid_rows=valid,
                         compute_dtype=cd)
    want = blockwise_topk_plain(cv_t, tbl, k, 4096, scales=scl,
                                valid_rows=valid, compute_dtype=cd)
    tol = F32DOT if fmt == "f32_mode" else F32SUM
    assert torch.equal(got.indices, want.indices)
    _close(got.values, want.values, tol)
    _close(got.lse, want.lse, tol)
    zero = slice(live + 1, b)
    assert (got.indices[zero].cpu() == torch.arange(k)).all()
    assert (got.values[zero] == 0).all()


@pytest.mark.parametrize("fmt,f32,d,k,n_tile,stages", [
    ("int8", False, 512, 64, 32, 4), ("int4", False, 1024, 64, 32, 2),
    ("f32_mode", True, 512, 64, 32, 2), ("f32", False, 384, 64, 64, 4),
])
def test_topk_plan_fits_the_kernels_layout(dev, fmt, f32, d, k, n_tile,
                                           stages):
    """`plan` on the kernel's own shared-memory layout (c2v_topk_smem)
    shrinks the ring, then the N tile, where a batch of 128 at the widest
    rows and k 64 does not fit; the kernel launches at that plan."""
    code = {"int8": launch.FMT_INT8, "int4": launch.FMT_INT4}.get(
        fmt, launch.FMT_F32)
    smem = topk._smem_fn()
    p = topk.plan(128, f32, 3001, 132,
                  lambda n, s: smem(code, int(f32), d, k, n, s),
                  launch.shared_memory_limit(dev))
    assert (p.n_tile, p.stages) == (n_tile, stages)
    rng = np.random.default_rng(d + k)
    cv, table, _ = _edge_table(rng, 3001, 128, 2990, d, k)
    tbl, scl = _edge_operands(table, dev, fmt)
    cd = torch.float32 if f32 else torch.bfloat16
    cv_t = torch.from_numpy(cv).to(dev)
    got = blockwise_topk(cv_t, tbl, k, 4096, scales=scl, valid_rows=2990,
                         compute_dtype=cd)
    want = blockwise_topk_plain(cv_t, tbl, k, 4096, scales=scl,
                                valid_rows=2990, compute_dtype=cd)
    assert torch.equal(got.indices, want.indices)
    _close(got.values, want.values, F32DOT if f32 else F32SUM)


@pytest.mark.parametrize("n,d,c", [(3001, 384, 511), (130, 128, 129),
                                   (20001, 256, 1000), (64, 8, 3),
                                   (257, 12, 5), (1000, 100, 37)])
def test_kmeans_assign_tiling_edges(dev, n, d, c):
    """nlist 511 and 1000 (dead padded centroid columns), rows not a whole
    128-row tile, widths that end inside a 32-wide K block (12, 100),
    duplicated centroids: ties go to the lower index, and no row lands on
    a padded column."""
    rng = np.random.default_rng(n + c)
    x = _blobs(rng, n, d, c)
    cent = x[rng.permutation(n)[:c]].copy() if c <= n else _blobs(rng, c, d,
                                                                  c)
    cent[2] = cent[1]
    xt, ct = torch.from_numpy(x).to(dev), torch.from_numpy(cent).to(dev)
    got = kmeans_assign(xt, ct).cpu().numpy()
    want = kmeans_assign_plain(xt, ct).cpu().numpy()
    dist = _distances(x.astype(np.float64), cent.astype(np.float64))
    rows = np.nonzero(got != want)[0]
    gap = np.abs(dist[rows, got[rows]] - dist[rows, want[rows]])
    assert (gap <= 1e-4 * np.abs(dist[rows]).max(axis=1)).all()
    assert len(rows) <= max(1, n // 1000)
    assert got.max() < c and not (got == 2).any()
    with pytest.raises(ValueError, match="multiples of 4"):
        kmeans_assign(torch.zeros((10, 10), device=dev),
                      torch.zeros((3, 10), device=dev))


# ------------------------------ K2 on clusters, K11 at small batches


@pytest.mark.parametrize("b", [1, 8, 64, 1024])
@pytest.mark.parametrize("m", [1, 25, 32, 200, 201])
def test_masked_attention_cluster_edges(dev, b, m):
    """K2's cluster of C CTAs a row (C from `plan`: 8 at B 1 and 8, 4 at
    B 64, 2 at B 1024; empty chunks where m < C or m is no multiple of
    C): an all-masked row gives zero weights and a zero code vector, a
    row with one valid context gives it weight 1, the weights match the
    plain version's and the chunked emulation's, the code vector is the
    weighted sum of the kernel's own bf16 weights, and reruns are
    bit-equal."""
    rng = np.random.default_rng(b * 1000 + m)
    t = torch.from_numpy(np.tanh(rng.standard_normal((b, m, 384))).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    a = torch.from_numpy((0.3 * rng.standard_normal(384)).astype(
        np.float32)).to(dev)
    mask = torch.from_numpy((rng.random((b, m)) > 0.3).astype(np.float32)
                            ).to(dev)
    mask[0] = 0.0
    if b > 1:
        mask[1] = 0.0
        mask[1, m // 2] = 1.0
    before = kernels.launch_counts()["masked_attention"]
    cv, attn = masked_attention(t, a, mask)
    assert kernels.launch_counts()["masked_attention"] == before + 1
    cv2, attn2 = masked_attention(t, a, mask)
    assert torch.equal(cv, cv2) and torch.equal(attn, attn2)
    want_cv, want_attn = masked_attention_plain(t, a, mask)
    _close(attn, want_attn, dict(rtol=1e-4, atol=1e-5))
    p = kattention.plan(b, m, 384, launch.shared_memory_limit(dev),
                        torch.cuda.get_device_properties(dev)
                        .multi_processor_count)
    emu_cv, emu_attn = kattention.split_softmax(t, a, mask, p.cluster)
    _close(attn, emu_attn, dict(rtol=1e-5, atol=1e-6))
    own = (attn.to(torch.bfloat16).float()[:, :, None] * t.float()).sum(1)
    _close(cv, own, F32SUM)
    _close(cv, want_cv, BF16)
    assert not cv[0].any() and not attn[0].any()
    if b > 1:
        assert float(attn[1, m // 2]) == 1.0 and float(attn[1].sum()) == 1.0
        assert torch.equal(cv[1], t[1, m // 2].float())


def test_attention_plan_fits_the_kernels_layout(dev):
    """`plan`'s shared memory is the kernel's own (c2v_attention_smem),
    and a row too long to stage (60,000 contexts) runs from device
    memory, against the plain version."""
    for chunk, d, staged in ((25, 384, True), (100, 384, True),
                             (7500, 384, False), (1, 8, True)):
        assert kattention.smem_bytes(chunk, d, staged) == \
            kattention.kernel_smem_bytes(chunk, d, staged)
    rng = np.random.default_rng(3)
    b, m = 2, 60000
    p = kattention.plan(b, m, 384, launch.shared_memory_limit(dev))
    assert not p.staged and p.cluster == 8
    t = torch.from_numpy(np.tanh(rng.standard_normal((b, m, 384))).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    a = torch.from_numpy((0.3 * rng.standard_normal(384)).astype(
        np.float32)).to(dev)
    mask = torch.from_numpy((rng.random((b, m)) > 0.3).astype(np.float32)
                            ).to(dev)
    cv, attn = masked_attention(t, a, mask)
    want_cv, want_attn = masked_attention_plain(t, a, mask)
    _close(attn, want_attn, dict(rtol=1e-4, atol=1e-7))
    _close(cv, want_cv, BF16)


def _ivf_edge_index(rng, d, r):
    """Nine lists of 0, 1 and up to 300 rows (longer than any chunk; the
    first three hold 4 rows, what a zero query probes at nprobe 3), rows
    near their list's centroid; in the 300-row list the rows at offsets
    r - 2 .. r + 1 (across the boundary of the first chunk of r rows) are
    one row, and a row of the 140-row list is its copy too."""
    sizes = [0, 1, 3, 300, 25, 0, 1, 140, 17]
    nlist = len(sizes)
    cent = (3.0 * rng.standard_normal((nlist, d))).astype(np.float32)
    owner = np.repeat(np.arange(nlist), sizes)
    rows = (cent[owner] + rng.standard_normal((len(owner), d))
            ).astype(np.float32)
    offsets = np.zeros(nlist + 1, np.int64)
    np.cumsum(sizes, out=offsets[1:])
    lo = int(offsets[3])
    rows[lo + r - 2:lo + r + 2] = rows[lo + r - 2]
    rows[int(offsets[7]) + 5] = rows[lo + r - 2]
    return cent, rows, offsets, lo + r - 2, max(sizes)


@pytest.mark.parametrize("fmt", ["f32", "int8", "e4m3", "e5m2", "int4"])
@pytest.mark.parametrize("b", [1, 2, 8, 64])
@pytest.mark.parametrize("d", [12, 100, 384])
@pytest.mark.parametrize("r", [16, 128])
def test_ivf_search_small_batch_edges(dev, monkeypatch, fmt, b, d, r):
    """K11 at B 1, 2, 8 and 64 in every format, at widths whose rows are
    not whole 16-byte units (int8 12 and 100, int4 12 and 100: the span's
    head and tail bytes by plain loads), in chunks of r rows (`plan`
    held to r): empty lists, lists of one row and lists longer than a
    chunk; nprobe = nlist at B 2 and 64; duplicate rows across the first
    chunk boundary and in another list come back in candidate order;
    zero queries (B 8: one live query and seven zero ones, as the MIPS
    dispatch pads a batch), k above the candidates at B 8."""
    monkeypatch.setattr(kivf, "CHUNK_ROWS", (r,))
    rng = np.random.default_rng(b * 100 + d + r + len(fmt))
    cent, rows, offsets, dup, max_len = _ivf_edge_index(rng, d, r)
    nlist, n = len(cent), len(rows)
    nprobe = nlist if b in (2, 64) else 3
    k = 64 if b == 8 else 10
    if fmt == "f32":
        tbl, scl, gids = torch.from_numpy(rows).to(dev), None, None
        q_dup = rows[dup]
    else:
        if fmt == "int8":
            qr, s8 = quantize_rows(rows)
            tbl, scl = torch.from_numpy(qr).to(dev), torch.from_numpy(s8)
            scl = scl.to(dev)
        else:
            tbl, scl = _formatted(rows, dev, fmt)
        scl = scl[:, 0].contiguous()
        gids = torch.from_numpy(rng.permutation(10 * n)[:n].astype(np.int32)
                                ).to(dev)
        q_dup = rows[dup]
    q = rng.standard_normal((b, d)).astype(np.float32)
    q[0] = 3.0 * q_dup
    if b == 8:
        q[1:] = 0.0
    elif b > 1:
        q[-1] = 0.0
    qt = torch.from_numpy(q).to(dev)
    args = (qt, torch.from_numpy(cent).to(dev), tbl,
            torch.from_numpy(offsets).to(dev), nprobe, k)
    kw = dict(scales=scl, global_ids=gids, max_len=max_len)
    name = {"f32": "ivf_search", "int8": "ivf_search_int8"}.get(
        fmt, _mode("ivf_search", fmt))
    before = kernels.launch_counts()[name]
    got_v, got_i = ivf_search(*args, **kw)
    assert kernels.launch_counts()[name] == before + 1
    again_v, again_i = ivf_search(*args, **kw)
    assert torch.equal(got_i, again_i) and torch.equal(got_v, again_v)
    want_v, want_i = ivf_search_plain(*args, **kw)
    assert torch.equal(got_i, want_i)
    live = torch.isfinite(want_v)
    _close(got_v, want_v, dict(rtol=1e-5, atol=1e-6 * float(
        want_v[live].abs().max())))
    if b == 8:  # the zero queries: the 4 rows of lists 0-2, all 0
        assert (got_v[1:, :4] == 0).all()
        assert torch.isneginf(got_v[1:, 4:]).all()
        assert (got_i[1:, 4:] == (-1 if gids is None else 0)).all()


def test_ivf_plan_fits_the_kernels_layout(dev):
    """`plan`'s shared memory is the kernel's own (c2v_ivf_select_smem,
    c2v_ivf_scan_smem) for every format, width and chunk."""
    for fmt in (launch.FMT_F32, launch.FMT_INT8, launch.FMT_E4M3,
                launch.FMT_INT4):
        for d in (12, 100, 384, 512):
            for r in kivf.CHUNK_ROWS:
                for b, nlist, nprobe in ((1, 511, 16), (64, 1000, 16),
                                         (64, 511, 511), (3, 9, 9)):
                    for grouped in (False, True):
                        assert (kivf.select_smem(b, nlist, nprobe, grouped),
                                kivf.scan_smem(fmt, d, r, min(b, 16))) == \
                            kivf.kernel_smem(b, nlist, nprobe, grouped, fmt,
                                             d, r)


# ------------------------------------- K1 and K7 redesigned (tiles, clusters)

K1_EDGE_FORMATS = ("f32", "int8") + FORMATS


def _k1_tables(rng, dev, fmt, rows, dim):
    t = (0.2 * rng.standard_normal((rows, dim))).astype(np.float32)
    if fmt == "f32":
        return torch.from_numpy(t).to(dev), None
    if fmt == "int8":
        q, s = quantize_rows(t)
        return torch.from_numpy(q).to(dev), torch.from_numpy(s).to(dev)
    return _formatted(t, dev, fmt)


@pytest.mark.parametrize("fmt", K1_EDGE_FORMATS)
@pytest.mark.parametrize("td,pd,d_out", [(4, 8, 16), (12, 8, 32),
                                         (20, 24, 400), (128, 128, 384),
                                         (256, 1024, 48)])
@pytest.mark.parametrize("b,m", [(1, 1), (3, 37), (5, 200)])
def test_context_encoder_tile_edges(dev, fmt, td, pd, d_out, b, m):
    """K1 in serve mode against its plain version: context counts that
    are no multiple of the 64-context tile, row widths that are no whole
    16-byte unit (token rows of 4 or 12 values, int4 rows of 20: 10
    bytes), context widths that are no multiple of the 64-column chunk,
    code widths below and above one 384-column group, and ids of -1 and
    past each table (NaN rows, as the reference's gather); reruns are
    bit-equal. A 1,536-wide context (24 chunks) was the widest the kernel
    before tiles took."""
    k_dim = 2 * td + pd
    rng = np.random.default_rng(b * m + 7 * k_dim + len(fmt))
    v_tok, v_path = 700, 300
    tok, tok_s = _k1_tables(rng, dev, fmt, v_tok, td)
    pth, pth_s = _k1_tables(rng, dev, fmt, v_path, pd)
    w = torch.from_numpy((rng.standard_normal((k_dim, d_out)) / np.sqrt(
        k_dim)).astype(np.float32)).to(dev)
    ids = [torch.from_numpy(rng.integers(0, n, (b, m)).astype(np.int32)
                            ).to(dev) for n in (v_tok, v_path, v_tok)]
    ids[0][0, 0] = -1
    ids[1][-1, -1] = v_path
    if b * m > 2:
        ids[2][b // 2, m // 2] = v_tok + 5
    args = (tok, tok_s, pth, pth_s, w, *ids)
    got = context_encoder(*args)
    assert got.shape == (b, m, d_out)
    assert torch.equal(got.view(torch.int16),
                       context_encoder(*args).view(torch.int16))

    # the plain version on tables with a NaN row appended (a zero row
    # with a NaN scale where quantized), the bad ids pointed at it
    def nan_row(table, scales):
        if scales is None:
            return (torch.cat([table, torch.full_like(table[:1], math.nan)]),
                    None)
        return (torch.cat([table, torch.zeros_like(table[:1])]),
                torch.cat([scales, torch.full_like(scales[:1], math.nan)]))

    def to_nan_row(x, v):
        return torch.where((x >= 0) & (x < v), x, v)

    want = context_encoder_plain(
        *nan_row(tok, tok_s), *nan_row(pth, pth_s), w,
        to_nan_row(ids[0], v_tok), to_nan_row(ids[1], v_path),
        to_nan_row(ids[2], v_tok))
    assert torch.isnan(want[0, 0]).all() and torch.isnan(want[-1, -1]).all()
    _close(got, want, BF16)


@pytest.mark.parametrize("widths", [(32, 64, 128), (128, 128, 384),
                                    (12, 8, 400)])
@pytest.mark.parametrize("b,m", [(3, 37), (7, 200)])
def test_context_encoder_dropout_bits_match_k5(dev, widths, b, m):
    """K1's train mode draws the mask K5 redraws: the mask K1 writes out
    (mode 1) gives the plain version K1's output when it is injected, K1
    given that mask (mode 2) gives the same bits, and K5 on K1's output
    with the bits redrawn from (seed, step) gives the plain backward's
    gradients on that mask; reruns are bit-equal."""
    td, pd, d = widths
    k_dim = 2 * td + pd
    rng = np.random.default_rng(b * m + k_dim)
    v_tok, v_path = 900, 500
    tok = torch.from_numpy((0.3 * rng.standard_normal((v_tok, td))
                            ).astype(np.float32)).to(dev)
    pth = torch.from_numpy((0.3 * rng.standard_normal((v_path, pd))
                            ).astype(np.float32)).to(dev)
    w = torch.from_numpy((0.1 * rng.standard_normal((k_dim, d))
                          ).astype(np.float32)).to(dev)
    ids = [torch.from_numpy(rng.integers(0, n, (b, m)).astype(np.int32)
                            ).to(dev) for n in (v_tok, v_path, v_tok)]
    drawn = torch.empty((b, m, k_dim), dtype=torch.bool, device=dev)
    t, lo = context_encoder(tok, None, pth, None, w, *ids, residual=True,
                            dropout=Dropout(0.75, seed=11, step=4,
                                            out_mask=drawn))
    t2, lo2 = context_encoder(tok, None, pth, None, w, *ids, residual=True,
                              dropout=Dropout(0.75, seed=11, step=4))
    injected, lo3 = context_encoder(tok, None, pth, None, w, *ids,
                                    residual=True,
                                    dropout=Dropout(0.75, mask=drawn))
    for x, y in ((t2, t), (lo2, lo), (injected, t), (lo3, lo)):
        assert torch.equal(x.view(torch.int16), y.view(torch.int16))
    want, want_lo = context_encoder_plain(
        tok, None, pth, None, w, *ids, residual=True,
        dropout=Dropout(0.75, mask=drawn))
    _step_close(t, want, "K1 train")
    _step_close(t.float() + lo.float(), want.float() + want_lo.float(),
                "K1 train + residual")
    share = float(drawn.float().mean())
    assert abs(share - 0.75) <= 5 * (0.75 * 0.25 / drawn.numel()) ** 0.5
    if k_dim % 128 or d % 128:
        return  # K5 takes context and code widths in multiples of 128
    dt = torch.from_numpy((0.1 * rng.standard_normal((b, m, d))
                           ).astype(np.float32)).to(dev).to(torch.bfloat16)
    got = encoder_backward(dt, t, lo, tok, pth, w, *ids,
                           dropout=Dropout(0.75, seed=11, step=4))
    ref = encoder_backward_plain(dt, t, lo, tok, pth, w, *ids,
                                 dropout=Dropout(0.75, mask=drawn))
    for name, g, x in zip(("d_token", "d_path", "d_transform"), got, ref):
        _step_close(g, x, name)


# (b, v, n_real, the cluster size `plan` takes for them on an H100: 132
# SMs, 232,448 bytes of shared memory a block)
XENT_EDGES = [
    (1, 261246, 261246, 16), (3, 261245, 261245, 16), (5, 30011, 29000, 16),
    (2, 5, 5, 16), (4, 4099, 100, 16), (9, 1001, 1001, 16),
    (17, 100003, 100003, 8), (24, 100000, 90000, 8),
    (33, 100002, 100002, 4), (132, 30011, 30011, 2), (132, 28001, 27000, 1),
    (1, 1_000_000, 1_000_000, 0), (3, 1_000_001, 999_000, 0)]


@pytest.mark.parametrize("b,v,n_real,cluster", XENT_EDGES)
def test_softmax_xent_cluster_edges(dev, b, v, n_real, cluster):
    """K7 against its plain version at every cluster size, each reached
    through shapes for which `plan` takes it (C 16 at the flagship width,
    8 and 4 at ~100K columns and B 17-33, 2 and 1 at B 132 and ~30K, the
    two-read kernel at a million columns, even and odd): odd widths (rows
    starting 4, 8 or 12 bytes off a 16-byte boundary, 8 of them at row 1
    of 261,245), n_real < V with slices wholly past it, a label out of
    range (NaN loss term, no one-hot term), an all-masked row, valid = 0,
    B 1; reruns bit-equal."""
    from code2vec_tpu_torch.kernels import softmax_xent as kxent
    assert kxent.device_plan(b, v, dev).cluster == cluster
    rng = np.random.default_rng(b * 31 + v % 97 + cluster)
    logits = (3 * rng.standard_normal((b, v))).astype(np.float32)
    labels = rng.integers(0, n_real, b).astype(np.int32)
    valid = np.ones(b, np.float32)
    if b > 2:
        valid[1] = 0.0
        labels[2] = n_real + 1   # out of range
    if b > 3:
        logits[3, :n_real] = -np.inf   # all masked
    x = torch.from_numpy(logits).to(dev)
    lab = torch.from_numpy(labels).to(dev)
    val = torch.from_numpy(valid).to(dev)
    loss, grad = softmax_xent(x, lab, val, n_real=n_real)
    loss2, grad2 = softmax_xent(x, lab, val, n_real=n_real)
    assert torch.equal(_bits(loss.view(1)), _bits(loss2.view(1)))
    assert torch.equal(grad.view(torch.int16), grad2.view(torch.int16))
    want_loss, want_grad = softmax_xent_plain(x, lab, val, n_real=n_real)
    if b > 2:
        assert torch.isnan(loss) and torch.isnan(want_loss)
    else:
        _close(loss, want_loss, dict(rtol=1e-5, atol=1e-7))
    got_g = grad[0].float() + grad[1].float()
    want_g = want_grad[0].float() + want_grad[1].float()
    fin = torch.isfinite(want_g)
    assert torch.equal(torch.isfinite(got_g), fin)
    _close(got_g[fin], want_g[fin], dict(rtol=4e-5, atol=1e-3 * float(
        want_g[fin & (want_g != 0)].abs().median())))
    assert not grad[:, :, n_real:].any()
    if b > 2:
        assert not grad[:, 1].any()
        assert (got_g[2, :n_real] >= 0).all()   # no one-hot term


def test_softmax_xent_plan_fits_the_kernels_layout(dev):
    """`plan` on the kernel's own layout (c2v_softmax_xent_smem) and this
    card: the slices cover each row, a CTA's shared memory fits a block,
    a slice of more bulk copies than the kernel makes is refused (-1),
    and the edge shapes above reach every cluster size."""
    from code2vec_tpu_torch.kernels import softmax_xent as kxent
    limit = launch.shared_memory_limit(dev)
    kxent._fn()
    assert kxent._fns["smem"](-1) == -1
    assert kxent._fns["smem"](8 * 2048) > 0 > kxent._fns["smem"](8 * 2048 + 1)
    for b in (1, 64, 1024):
        for v in (17, 30011, 261245, 261246):
            p = kxent.device_plan(b, v, dev)
            assert p.cluster > 0 and p.cluster * p.units >= v // 4
            assert kxent._fns["smem"](p.units) == p.smem <= limit
    assert {kxent.device_plan(b, v, dev).cluster
            for b, v, _, _ in XENT_EDGES} == {0, 1, 2, 4, 8, 16}


def test_context_encoder_plan_fits_the_kernels_layout(dev):
    """K1's shared memory (c2v_context_encoder_smem, one size for every
    width) fits what the card lets a block use, and its W-tile bytes
    (c2v_context_encoder_scratch, what the wrapper allocates) are those
    of `w_tiles_plain`, the layout the tests' product emulation uses, for
    every kind of width."""
    from code2vec_tpu_torch.kernels import encoder as kenc
    kenc._fn()
    assert 0 < kenc._fns["smem"]() <= launch.shared_memory_limit(dev)
    for k_dim, d_out in ((16, 16), (32, 32), (64, 400), (384, 384),
                         (1536, 2048)):
        w = torch.zeros((k_dim, d_out))
        assert kenc.w_tiles_plain(w).numel() * 2 == \
            kenc._fns["scratch"](k_dim, d_out)


# ------------------------------------ K12 and K6 redesigned: edge cases

def _row_adam_case(rng, dev, v, n, dist, d, mdt):
    """A table, its slots, ids (`dist`: uniform, zipf, same, or
    out_of_range: a quarter outside [0, v)) and gradient rows that are
    bf16 integers times 2^-12 (every partial sum exact in f32)."""
    if dist == "zipf":
        ids = _zipf_ids(rng, n, v)
    elif dist == "same":
        ids = np.full(n, rng.integers(0, v), np.int32)
    else:
        ids = rng.integers(0, v, n).astype(np.int32)
    if dist == "out_of_range":
        bad = np.array([-1, v, v + 7, 2 ** 31 - 1], np.int32)
        out = rng.random(n) < 0.25
        ids[out] = bad[rng.integers(0, 4, int(out.sum()))]
    grads = (rng.integers(-127, 128, (n, d)) * 2.0 ** -12).astype(np.float32)
    table = torch.from_numpy(rng.standard_normal((v, d)).astype(
        np.float32)).to(dev)
    m0 = torch.from_numpy((rng.standard_normal((v, d)) * 1e-3).astype(
        np.float32)).to(dev).to(mdt)
    n0 = torch.from_numpy((rng.random((v, d)) * 1e-6).astype(
        np.float32)).to(dev)
    return (table, m0, n0, torch.from_numpy(ids).to(dev),
            torch.from_numpy(grads).to(dev).to(torch.bfloat16))


def _check_row_adam(got, want, table, m0, n0, ids, v, mdt):
    got_p, got_m, got_n = got
    want_p, want_m, want_n = want
    _close(got_p, want_p, dict(rtol=1e-6, atol=1e-9))
    _close(got_n, want_n, dict(rtol=1e-6, atol=1e-12))
    step = 2.0 ** -7 if mdt == torch.bfloat16 else 1e-6
    assert ((got_m.float() - want_m.float()).abs()
            <= step * want_m.float().abs() + 1e-12).all()
    touched = torch.zeros(v, dtype=torch.bool, device=table.device)
    ok = (ids >= 0) & (ids < v)
    touched[ids[ok].long()] = True
    assert torch.equal(got_p[~touched], table[~touched])
    assert torch.equal(got_m[~touched], m0[~touched])
    assert torch.equal(got_n[~touched], n0[~touched])


@pytest.mark.parametrize("mu", ["bfloat16", "float32"])
@pytest.mark.parametrize("d", [128, 256, 384, 512])
@pytest.mark.parametrize("dist", ["uniform", "zipf", "same",
                                  "out_of_range"])
def test_sparse_adam_tables_kernel(dev, mu, d, dist):
    """K12 over two tables in one launch sequence (the sparse step's
    call), at every width it takes and both mu dtypes, with uniform,
    Zipf, all-equal and out-of-range ids: each table within Adam's
    tolerance of the plain version, untouched rows bit-equal, reruns
    bit-equal, one launch counted."""
    from code2vec_tpu_torch.kernels.sparse_adam import (
        sparse_adam_plain, sparse_adam_tables,
    )
    from code2vec_tpu_torch.training.sparse_adam import RowAdamSlots
    rng = np.random.default_rng(d + len(dist))
    mdt = torch.bfloat16 if mu == "bfloat16" else torch.float32
    cases = [_row_adam_case(rng, dev, v, n, dist, d, mdt)
             for v, n in ((20011, 9000), (7001, 4500))]
    runs = []
    for _ in range(2):
        work = [(c[0].clone(), RowAdamSlots(mu=c[1].clone(),
                                            nu=c[2].clone()), c[3], c[4])
                for c in cases]
        before = kernels.launch_counts()["sparse_adam"]
        sparse_adam_tables(work, t=5, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)
        assert kernels.launch_counts()["sparse_adam"] == before + 1
        runs.append(work)
    for (p1, s1, _, _), (p2, s2, _, _) in zip(*runs):
        assert torch.equal(p1, p2) and torch.equal(s1.mu, s2.mu)
        assert torch.equal(s1.nu, s2.nu)
    for (table, m0, n0, ids, grads), (p, s, _, _) in zip(cases, runs[0]):
        want = RowAdamSlots(mu=m0.clone(), nu=n0.clone())
        want_p = table.clone()
        sparse_adam_plain(want_p, want, ids, grads, t=5, lr=1e-3, b1=0.9,
                          b2=0.999, eps=1e-8)
        _check_row_adam((p, s.mu, s.nu), (want_p, want.mu, want.nu), table,
                        m0, n0, ids, table.shape[0], mdt)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 64, 65, 4095, 4096, 4097,
                               614400])
def test_sparse_adam_sums_follow_the_emulation(dev, n):
    """K12's duplicate sums are `segment_sums`' to the bit (rows of random
    bf16 values, so the order of the additions shows): ids Zipf over
    3,000 rows (one id where n <= 64), so that ids span one, two and many
    32-pair chunks. The sums are read back as mu' with b1 = 0: an f32 mu
    then stores g exactly."""
    from code2vec_tpu_torch.kernels import sparse_adam as ksa
    from code2vec_tpu_torch.training.sparse_adam import RowAdamSlots
    rng = np.random.default_rng(n)
    v = 3000
    ids = _zipf_ids(rng, n, v) if n > 64 else np.zeros(n, np.int32)
    grads = torch.from_numpy(rng.standard_normal((n, 128)).astype(
        np.float32)).to(torch.bfloat16)
    table = torch.zeros((v, 128), device=dev)
    slots = RowAdamSlots(mu=torch.zeros((v, 128), device=dev),
                         nu=torch.zeros((v, 128), device=dev))
    ksa.sparse_adam(table, slots, torch.from_numpy(ids).to(dev),
                    grads.to(dev), t=1, lr=0.0, b1=0.0, b2=0.0, eps=1e-8)
    order = torch.from_numpy(np.argsort(ids, kind="stable"))
    want = ksa.segment_sums(torch.from_numpy(ids)[order].long(),
                            grads[order], dead=v)
    got = slots.mu.cpu()
    for key, row in want.items():
        assert torch.equal(got[key], row), key


def test_sparse_adam_plan_fits_the_kernels_layout(dev):
    """`plan`'s digit passes and scratch bytes are the kernel's own
    (c2v_sparse_adam_passes, c2v_sparse_adam_scratch_bytes) for every
    width, for n from 1 to the two tables' 614,400 ids and for key spaces
    of one to 22 bits."""
    from code2vec_tpu_torch.kernels import sparse_adam as ksa
    for n in (1, 32, 2048, 2049, 409600, 614400):
        for keys in (1, 300, 70000, 1301137, 2212555):
            for d in (128, 256, 384, 512):
                p = ksa.plan(n, keys, d)
                assert ksa.kernel_plan(n, keys, d) == \
                    (p.passes, p.digit_bits, p.scratch_bytes)


@pytest.mark.parametrize("b,m", [(1024, 200), (64, 200), (1024, 1),
                                 (1024, 32), (64, 1), (64, 32), (3, 5)])
def test_masked_attention_backward_cluster_edges(dev, b, m):
    """K6's cluster of C CTAs a row (C from `backward_plan`: 4 at B 64
    and 1024 x 200, 1 at 1 and 32 contexts of B 1024): dT and da within
    one bf16 step of the plain version, within f32 rounding of the
    chunked emulation, all-masked rows zero, reruns bit-equal."""
    rng = np.random.default_rng(b + m)
    t = torch.from_numpy(np.tanh(rng.standard_normal((b, m, 384))).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    a = torch.from_numpy((0.3 * rng.standard_normal(384)).astype(
        np.float32)).to(dev)
    mask = torch.from_numpy((rng.random((b, m)) > 0.3).astype(np.float32)
                            ).to(dev)
    mask[0] = 0.0
    _, attn = masked_attention(t, a, mask)
    dcv = torch.from_numpy((0.05 * rng.standard_normal((b, 384))).astype(
        np.float32)).to(dev)
    before = kernels.launch_counts()["masked_attention_backward"]
    dt, da = masked_attention_backward(t, a, mask, attn, dcv)
    assert kernels.launch_counts()["masked_attention_backward"] == before + 1
    dt2, da2 = masked_attention_backward(t, a, mask, attn, dcv)
    assert torch.equal(dt, dt2) and torch.equal(da, da2)
    want_dt, want_da = masked_attention_backward_plain(t, a, mask, attn, dcv)
    _step_close(dt, want_dt, "dT")
    _step_close(da, want_da, "da")
    dead = (mask > 0).sum(dim=1) == 0
    assert not dt[dead].any()
    p = kattention.backward_plan(b, m, 384, launch.shared_memory_limit(dev),
                                 torch.cuda.get_device_properties(dev)
                                 .multi_processor_count)
    emu_dt, emu_da = kattention.split_backward(
        t.cpu(), a.cpu(), mask.cpu(), attn.cpu(), dcv.cpu(), p.cluster)
    _step_close(dt, emu_dt, "dT against the emulation")
    _step_close(da, emu_da, "da against the emulation")


def test_attention_backward_plan_fits_the_kernels_layout(dev):
    """`backward_smem_bytes` is K6's own count (c2v_attention_backward_smem)
    at every width kind, and a row too long to stage (60,000 contexts)
    runs from device memory, against the plain version."""
    for chunk, d, staged in ((50, 384, True), (1, 384, True),
                             (7500, 384, False), (1, 8, True),
                             (3, 4096, True)):
        assert kattention.backward_smem_bytes(chunk, d, staged) == \
            kattention.kernel_backward_smem_bytes(chunk, d, staged)
    rng = np.random.default_rng(4)
    b, m = 2, 60000
    p = kattention.backward_plan(b, m, 384, launch.shared_memory_limit(dev))
    assert not p.staged and p.cluster == 8
    t = torch.from_numpy(np.tanh(rng.standard_normal((b, m, 384))).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    a = torch.from_numpy((0.3 * rng.standard_normal(384)).astype(
        np.float32)).to(dev)
    mask = torch.from_numpy((rng.random((b, m)) > 0.3).astype(np.float32)
                            ).to(dev)
    _, attn = masked_attention(t, a, mask)
    dcv = torch.from_numpy((0.05 * rng.standard_normal((b, 384))).astype(
        np.float32)).to(dev)
    dt, da = masked_attention_backward(t, a, mask, attn, dcv)
    want_dt, want_da = masked_attention_backward_plain(t, a, mask, attn, dcv)
    _step_close(dt, want_dt, "dT")
    _step_close(da, want_da, "da")


# ----------------------------------------------------------- K14 - K17

def _within_step(got, want):
    """Within one bf16 step at the compared tensor's largest value."""
    tol = 2.0 ** -8 * float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("rows,d,n", [(50, 128, 7), (650569, 128, 409600),
                                      (33, 12, 100), (1, 8, 1)])
def test_shard_gather_scatter_local_ids_kernels(dev, rows, d, n):
    """K14 against its plain versions: ids below, inside and past this
    rank's rows (two shards of `rows`), duplicates in the scatter-add;
    odd widths take the scalar path."""
    from code2vec_tpu_torch.kernels import sharded as k15
    rng = np.random.default_rng(rows + n)
    table = torch.from_numpy(rng.standard_normal((rows, d)).astype(
        np.float32)).to(dev)
    ids = torch.from_numpy(rng.integers(-3, 2 * rows + 3, n).astype(
        np.int32)).to(dev)
    for offset in (0, rows):
        before = kernels.launch_counts()
        got = k15.shard_gather(table, ids, offset)
        assert kernels.launch_counts()["shard_gather"] == \
            before["shard_gather"] + 1
        assert torch.equal(got, k15.shard_gather_plain(table, ids, offset))
        for dtype in (torch.float32, torch.bfloat16):
            rows_g = torch.from_numpy(rng.standard_normal((n, d)).astype(
                np.float32)).to(dev).to(dtype)
            acc = torch.zeros_like(table)
            k15.shard_scatter_add(acc, ids, rows_g, offset)
            want = torch.zeros_like(table)
            k15.shard_scatter_add_plain(want, ids, rows_g, offset)
            # atomics add a row's terms in any order
            _close(acc, want, dict(rtol=1e-5, atol=1e-5))
        assert torch.equal(k15.shard_local_ids(ids, offset, rows),
                           k15.shard_local_ids_plain(ids, offset, rows))


@pytest.mark.parametrize("b,v,n_valid", [(1024, 130623, 130623),
                                         (1024, 130623, 130620),
                                         (3, 7, 0), (5, 70, 65)])
@pytest.mark.parametrize("floor", [False, True])
def test_tp_xent_passes_kernel(dev, b, v, n_valid, floor):
    """K15's three passes against their plain versions: padded columns
    (none, some, all of this rank's), labels in and outside the slice,
    an invalid row, non-finite logits in floor mode."""
    from code2vec_tpu_torch.kernels import sharded as k15
    rng = np.random.default_rng(b * v + n_valid)
    x = (3 * rng.standard_normal((b, v))).astype(np.float32)
    if floor:
        x[0, :2] = [np.inf, np.nan]
    logits = torch.from_numpy(x).to(dev)
    labels = torch.from_numpy(rng.integers(0, 2 * v, b).astype(np.int32)
                              ).to(dev)
    valid = torch.ones(b, device=dev)
    valid[b // 2] = 0
    offset = v
    mx = k15.tp_xent_max(logits, v, n_valid, floor)
    _close(mx, k15.tp_xent_max_plain(logits, v, n_valid, floor),
           dict(rtol=0, atol=0))
    st = k15.tp_xent_sum(logits, v, n_valid, mx, labels, offset, floor)
    _close(st, k15.tp_xent_sum_plain(logits, v, n_valid, mx, labels,
                                     offset, floor),
           dict(rtol=1e-5, atol=1e-6))
    if floor or n_valid == 0:
        return
    got = k15.tp_xent_grad(logits, n_valid, mx, st[0], labels, valid,
                           offset, 2 * b)
    want = k15.tp_xent_grad_plain(logits, n_valid, mx, st[0], labels, valid,
                                  offset, 2 * b)
    # the hi + lo value of each element: f32 exp and division
    _close(got[0].float() + got[1].float(), want[0].float()
           + want[1].float(), dict(rtol=1e-5, atol=1e-9))
    assert (got[:, :, n_valid:] == 0).all()


@pytest.mark.parametrize("b,m,d", [(1024, 100, 384), (64, 50, 384),
                                   (3, 1, 384), (5, 7, 128)])
def test_cp_attention_phases_kernel(dev, b, m, d):
    """K16's and K17's phases against their plain versions: an
    all-invalid row, one context a row; every sum in a fixed order, so
    two runs are bit-equal."""
    from code2vec_tpu_torch.kernels import cp_attention as k16
    g = torch.Generator(device=dev).manual_seed(b * m + d)
    t = torch.tanh(torch.randn((b, m, d), generator=g, device=dev)).to(
        torch.bfloat16)
    a = torch.randn((d,), generator=g, device=dev) * 0.25
    mask = (torch.rand((b, m), generator=g, device=dev) > 0.2).float()
    mask[0] = 0.0
    dcv = torch.randn((b, d), generator=g, device=dev)
    s, mx = k16.cp_attention_scores(t, a, mask)
    s2, mx2 = k16.scores_plain(t, a, mask)
    assert torch.equal(torch.isinf(s), torch.isinf(s2))
    _close(torch.where(torch.isinf(s2), 0, s), torch.where(
        torch.isinf(s2), 0, s2), F32SUM)
    u, den = k16.cp_attention_exp(s, mx)
    u2, den2 = k16.exp_plain(s, mx)
    _close(u, u2, dict(rtol=1e-6, atol=0))
    _close(den, den2, dict(rtol=1e-5, atol=0))
    cv, attn = k16.cp_attention_combine(t, u, den)
    cv2, attn2 = k16.combine_plain(t, u, den)
    _close(cv, cv2, F32SUM)
    _close(attn, attn2, dict(rtol=1e-6, atol=0))
    assert cv[0].abs().max() == 0 and attn[0].abs().max() == 0
    fs, wfs = k16.cp_attention_backward_fs(t, attn, dcv)
    fs2, wfs2 = k16.backward_fs_plain(t, attn, dcv)
    _within_step(fs, fs2)
    _close(wfs, wfs2, F32SUM)
    dt, da = k16.cp_attention_backward_dt(t, a, mask, attn, fs, wfs, dcv)
    dt2, da2 = k16.backward_dt_plain(t, a, mask, attn, fs, wfs, dcv)
    _within_step(dt, dt2)
    _within_step(da, da2)
    again = k16.cp_attention_backward_dt(t, a, mask, attn, fs, wfs, dcv)
    assert torch.equal(dt, again[0]) and torch.equal(da, again[1])
    assert dt[0].abs().max() == 0


def test_parallel_step_of_one_rank_matches_single_device(dev):
    """The parallel dense and sparse steps on a mesh of one rank (every
    collective a no-op) launch K14, K15 and K1-K8/K12 and give the
    single-device step's loss and parameters (the same kernels on the
    same values, but for K14's gather before K1 and K15 for K7)."""
    from code2vec_tpu_torch.models.code2vec import Code2VecModule, ModelDims
    from code2vec_tpu_torch.parallel.mesh import local_mesh
    from code2vec_tpu_torch.training.state import (
        create_train_state, make_optimizer, sharded_train_state,
    )
    from code2vec_tpu_torch.training.step import (
        ParallelStepBuilder, TrainStepBuilder,
    )
    dims = ModelDims(5000, 3000, 2000, target_oov_floor=1)
    rng = np.random.default_rng(3)
    b, m = 64, 50
    batch = [torch.from_numpy(x).to(dev) for x in (
        rng.integers(0, 5000, (b, m)).astype(np.int32),
        rng.integers(0, 3000, (b, m)).astype(np.int32),
        rng.integers(0, 5000, (b, m)).astype(np.int32),
        (rng.random((b, m)) > 0.2).astype(np.float32),
        rng.integers(2, 2000, b).astype(np.int32), np.ones(b, bool))]
    drop = torch.from_numpy(rng.random((b, m, 384)) < 0.75).to(dev)
    for sparse in (False, True):
        config = Config(use_sparse_embedding_update=sparse)
        hyper = make_optimizer(config)
        g = torch.Generator(device=dev).manual_seed(5)
        module = Code2VecModule(dims, device=dev, generator=g)
        full = {k: p.detach().clone() for k, p in module.named_parameters()}
        state = create_train_state(module, hyper, config)
        step = TrainStepBuilder(module, hyper, config).make_train_step(state)
        mesh_state = sharded_train_state(full, hyper, config,
                                         local_mesh(dev))
        mesh_step = ParallelStepBuilder(
            dims, hyper, config, local_mesh(dev)).make_train_step(mesh_state)
        before = kernels.launch_counts()
        for _ in range(2):
            state, loss = step(state, *batch, 0, dropout_mask=drop)
            mesh_state, mesh_loss = mesh_step(mesh_state, *batch, 0,
                                              dropout_mask=drop)
            _close(mesh_loss, loss, dict(rtol=1e-5, atol=0))
        counts = kernels.launch_counts()
        for name in ("shard_gather", "tp_softmax_xent",
                     "encoder_backward_rows",
                     "shard_local_ids" if sparse else "shard_scatter_add"):
            assert counts[name] > before[name], name
        for n, p in state.params.items():
            diff = (mesh_state.params[n] - p.detach()).abs()
            assert float(diff.max()) <= 2 * 2 * config.learning_rate, n
            assert int((diff > 1e-5 + 1e-5 * p.detach().abs()).sum()) <= \
                0.02 * p.numel(), n
