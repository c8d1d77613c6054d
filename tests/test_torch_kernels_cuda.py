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
"""

import math

import numpy as np
import pytest
import torch

from code2vec_tpu_torch import kernels
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.kernels.adam import AdamHyper, adam, adam_plain
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
from code2vec_tpu_torch.kernels.topk import (
    blockwise_topk, blockwise_topk_plain,
)
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
    with pytest.raises(ValueError, match="range"):
        blockwise_topk(cv, tbl, 65, 4096,
                       scales=torch.ones((100, 1), device=dev))


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
    rng = np.random.default_rng(1)
    t, _ = _ivf_index(rng, dev, "f32", [10, 10], dup=False)
    q = torch.zeros((2, 384), device=dev)
    with pytest.raises(ValueError, match="range"):
        ivf_search(q, t["cent"], t["rows"], t["offsets"], 2, 65,
                   max_len=t["max_len"])
