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
"""

import numpy as np
import pytest
import torch

from code2vec_tpu_torch import kernels
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.kernels.attention import (
    masked_attention, masked_attention_plain,
)
from code2vec_tpu_torch.kernels.encoder import (
    context_encoder, context_encoder_plain,
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
