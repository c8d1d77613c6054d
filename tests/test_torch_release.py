"""The port's release runtime against the JAX package's, on the CPU.

A tiny JAX model (as tests/test_quant.py builds it, bf16 compute) is
exported with the JAX `export_artifact` in each scheme (int8, fp8 e4m3
and e5m2, packed int4, float32); both packages' ReleaseModels then serve
that one artifact. The port also writes artifacts itself
(`write_artifact`), which must be byte-identical to the JAX export for
the same params, and reads the JAX `dictionaries.bin` bit for bit.

Tolerances, and why (as in tests/test_torch_ops.py):
- F32 (rtol 1e-5, atol 1e-6): f32 math, summation order differs.
- BF16 (atol 2e-2, rtol 1e-2): the transformed contexts and attention
  weights are rounded to bf16, where a last-bit difference in f32 can
  move a value one bf16 step.
- Top-k words: exact.
"""

import dataclasses
import filecmp
import json
import os
import pickle
import random

import numpy as np
import pytest
import torch

import jax

from code2vec_tpu.config import Config as JaxConfig
from code2vec_tpu.data import reader as jreader
from code2vec_tpu.release import artifact as jart
from code2vec_tpu.release.runtime import ReleaseModel as JaxReleaseModel
from code2vec_tpu.vocab import Code2VecVocabs as JaxVocabs
from code2vec_tpu_torch import kernels
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.data import reader as treader
from code2vec_tpu_torch.release import artifact as tart
from code2vec_tpu_torch.release.runtime import ReleaseModel
from code2vec_tpu_torch.vocab import Code2VecVocabs

pytestmark = pytest.mark.torch_port
# the shapes are tiny; one intra-op thread leaves the CPU cores to the
# other pytest workers
torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=1e-2, atol=2e-2)

LINES = [
    "alpha tok0,p0,tok0 tok0,p1,tok0",
    "beta tok1,p2,tok1",
    "name|x3 tok3,p3,tok3 tok2,p0,tok5 tok4,p1,tok4 " + " ".join(
        f"tok{i % 6},p{i % 4},tok{(i + 1) % 6}" for i in range(9)),
    "unknown nosuch,p9,tok2 ,, tok1,,",
    "name|x7 " + " ".join(f"tok{i % 6},p{i % 4},tok{i % 5}"
                          for i in range(16)),
]


def _tiny_jax_model(tmp_path, **overrides):
    from code2vec_tpu.model_facade import Code2VecModel
    rng = random.Random(0)
    tokens = [f"tok{i}" for i in range(6)]
    paths = [f"p{i}" for i in range(4)]
    targets = [f"name|x{i}" for i in range(40)]
    rows = []
    for _ in range(48):
        t = rng.randrange(len(targets))
        ctxs = [f"{tokens[t % 6]},{rng.choice(paths)},{tokens[t % 6]}"
                for _ in range(rng.randint(2, 6))]
        rows.append(f"{targets[t]} " + " ".join(ctxs)
                    + " " * (16 - len(ctxs)))
    prefix = str(tmp_path / "synthetic")
    with open(prefix + ".train.c2v", "w") as f:
        f.write("\n".join(rows) + "\n")
    with open(prefix + ".dict.c2v", "wb") as f:
        pickle.dump({w: 10 for w in tokens}, f)
        pickle.dump({p: 10 for p in paths}, f)
        pickle.dump({t: 10 for t in targets}, f)
        pickle.dump(len(rows), f)
    kwargs = dict(train_data_path_prefix=prefix, max_contexts=16,
                  train_batch_size=8, test_batch_size=8,
                  compute_dtype="bfloat16", verbose_mode=0,
                  serve_batch_size=4, serve_buckets="4,8",
                  num_train_epochs=1, save_every_epochs=1000)
    kwargs.update(overrides)
    return Code2VecModel(JaxConfig(**kwargs))


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    return _tiny_jax_model(tmp_path_factory.mktemp("torch-release"))


def _export(model, tmp_path, scheme):
    art_dir = str(tmp_path / f"artifact-{scheme}")
    jart.export_artifact(model, art_dir, scheme=scheme, aot=False,
                         log=lambda m: None)
    return art_dir


def _both_models(jax_model, art_dir):
    jcfg = dataclasses.replace(jax_model.config,
                               train_data_path_prefix=None,
                               serve_artifact=art_dir)
    jrm = JaxReleaseModel(jcfg, log=lambda m: None)
    trm = ReleaseModel(Config(serve_artifact=art_dir, serve_batch_size=4,
                              device="cpu", verbose_mode=0))
    return jrm, trm


@pytest.mark.parametrize("scheme", jart.ALL_SCHEMES)
def test_release_predict_matches_jax(jax_model, tmp_path, scheme):
    jrm, trm = _both_models(jax_model, _export(jax_model, tmp_path, scheme))
    assert trm.model_fingerprint() == jrm.model_fingerprint()
    assert trm.context_buckets == tuple(jrm.context_buckets)
    before = kernels.launch_counts()
    # all lines in chunks of 4 rows, then each line alone (other buckets)
    want = jrm.predict(LINES, batch_size=4, with_code_vectors=True)
    got = trm.predict(LINES, batch_size=4, with_code_vectors=True)
    for line in LINES:
        want += jrm.predict([line], batch_size=4, with_code_vectors=True)
        got += trm.predict([line], batch_size=4, with_code_vectors=True)
    assert kernels.launch_counts() == before
    assert len(got) == len(want) == 2 * len(LINES)
    for g, w in zip(got, want):
        assert g.original_name == w.original_name
        assert g.topk_predicted_words == w.topk_predicted_words
        np.testing.assert_allclose(g.topk_predicted_words_scores,
                                   w.topk_predicted_words_scores, **BF16)
        assert list(g.attention_per_context) == list(w.attention_per_context)
        np.testing.assert_allclose(
            list(g.attention_per_context.values()),
            list(w.attention_per_context.values()), **BF16)
        np.testing.assert_allclose(g.code_vector, w.code_vector, **BF16)
    # buckets 4 and 16 were reached: one step per (rows, bucket)
    assert trm.predict_compile_count() == jrm.predict_compile_count() == 2


def test_release_eval_step_matches_jax(jax_model, tmp_path):
    """The whole step, loss_sum (K4's label logits) included, on a random
    batch whose labels include PAD/OOV rows and invalid rows."""
    _eval_step_case(jax_model, tmp_path, jart.SCHEME_INT8)


@pytest.mark.parametrize("scheme", [jart.SCHEME_FP8_E4M3,
                                    jart.SCHEME_FP8_E5M2, jart.SCHEME_INT4,
                                    jart.SCHEME_FP32])
def test_release_eval_step_matches_jax_per_scheme(jax_model, tmp_path,
                                                  scheme):
    _eval_step_case(jax_model, tmp_path, scheme)


def _eval_step_case(jax_model, tmp_path, scheme):
    jrm, trm = _both_models(jax_model, _export(jax_model, tmp_path, scheme))
    rng = np.random.default_rng(2)
    b, m = 4, 8
    arrays = (rng.integers(0, 7, (b, m)).astype(np.int32),
              rng.integers(0, 5, (b, m)).astype(np.int32),
              rng.integers(0, 7, (b, m)).astype(np.int32),
              (rng.random((b, m)) > 0.3).astype(np.float32),
              np.array([5, 0, 17, 30], np.int32),
              np.array([True, True, True, False]))
    jo = jrm.eval_step(None, *arrays)
    to = trm.eval_step(*(torch.from_numpy(a) for a in arrays))
    np.testing.assert_array_equal(to.topk_indices.numpy(),
                                  np.asarray(jo.topk_indices))
    for name in ("topk_values", "code_vectors", "attention", "loss_sum"):
        np.testing.assert_allclose(getattr(to, name).numpy(),
                                   np.asarray(getattr(jo, name)), **BF16)


@pytest.mark.parametrize("scheme", ["int8", "float32", "fp8_e4m3",
                                    "fp8_e5m2", "int4"])
def test_write_artifact_byte_identical_to_export(jax_model, tmp_path,
                                                 scheme):
    jdir = _export(jax_model, tmp_path, jart.SCHEME_BY_KNOB[scheme])
    params = {k: np.asarray(jax.device_get(v))
              for k, v in jax_model.state.params.items()}
    cfg = jax_model.config
    tdir = str(tmp_path / f"port-{scheme}")
    meta = tart.write_artifact(
        params, Code2VecVocabs.load(os.path.join(jdir, tart.DICT_NAME)),
        tdir, scheme, max_contexts=cfg.max_contexts,
        compute_dtype=cfg.compute_dtype,
        topk=cfg.top_k_words_considered_during_prediction,
        topk_block_size=cfg.topk_block_size,
        serve_batch_size=cfg.serve_batch_size,
        buckets=jax_model.context_buckets)
    names = sorted(n for n in os.listdir(jdir) if n.endswith(".npy"))
    assert names == sorted(n for n in os.listdir(tdir) if n.endswith(".npy"))
    assert ("target_embedding.scale.npy" in names) == (scheme != "float32")
    for name in names + [tart.DICT_NAME]:
        assert filecmp.cmp(os.path.join(jdir, name),
                           os.path.join(tdir, name), shallow=False), name
    with open(os.path.join(jdir, tart.META_NAME)) as f:
        jmeta = json.load(f)
    assert meta["fingerprint"] == jmeta["fingerprint"]
    for key in ("dims", "quantization", "buckets", "topk", "max_contexts"):
        assert meta[key] == jmeta[key]
    # and the JAX loader accepts what the port wrote
    assert jart.load_artifact(tdir).fingerprint == meta["fingerprint"]


def _jax_vocabs(jax_model, separate):
    """The tiny model's vocabularies in either special-word scheme."""
    from code2vec_tpu.vocab import load_word_freq_dicts
    return JaxVocabs.create_from_freq_dicts(
        load_word_freq_dicts(jax_model.config.word_freq_dict_path),
        max_token_vocab_size=100, max_path_vocab_size=100,
        max_target_vocab_size=100, separate_oov_and_pad=separate)


@pytest.mark.parametrize("separate", [False, True])
def test_dictionaries_round_trip(jax_model, tmp_path, separate):
    jv = _jax_vocabs(jax_model, separate)
    jpath, tpath = str(tmp_path / "jax.bin"), str(tmp_path / "port.bin")
    jv.save(jpath)
    tv = Code2VecVocabs.load(jpath, separate_oov_and_pad=separate)
    tv.save(tpath)
    assert filecmp.cmp(jpath, tpath, shallow=False)
    for name in ("token_vocab", "path_vocab", "target_vocab"):
        a, b = getattr(jv, name), getattr(tv, name)
        assert a.word_to_index == b.word_to_index
        assert (a.pad_index, a.oov_index, a.size) == \
            (b.pad_index, b.oov_index, b.size)


@pytest.mark.parametrize("separate", [False, True])
def test_reader_matches_jax(jax_model, tmp_path, separate):
    path = str(tmp_path / "dict.bin")
    _jax_vocabs(jax_model, separate).save(path)
    jv = JaxVocabs.load(path, separate_oov_and_pad=separate)
    tv = Code2VecVocabs.load(path, separate_oov_and_pad=separate)
    want = jreader.parse_context_lines(LINES, jv, 16,
                                       jreader.EstimatorAction.Predict,
                                       keep_strings=True)
    got = treader.parse_context_lines(LINES, tv, 16)
    for f in ("source_token_indices", "path_indices", "target_token_indices",
              "context_valid_mask", "target_index", "example_valid",
              "source_strings", "path_strings", "target_token_strings"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    assert got.target_strings == want.target_strings
    # parse into a slot buffer, then bucket and pad as the predict path does
    buf = treader.empty_predict_batch(8, 16, tv)
    jbuf = jreader.empty_predict_batch(8, 16, jv)
    treader.parse_context_lines(LINES[:2], tv, 16, out=buf, row_offset=3)
    jreader.parse_context_lines(LINES[:2], jv, 16,
                                jreader.EstimatorAction.Predict,
                                keep_strings=True, out=jbuf, row_offset=3)
    tcut = treader._pad_rows(treader.slice_contexts(
        treader.truncate_rows(buf, 6), 4), 10)
    jcut = jreader._pad_rows(jreader.slice_contexts(
        jreader.truncate_rows(jbuf, 6), 4), 10)
    for f in dataclasses.fields(jreader.RowBatch):
        np.testing.assert_array_equal(np.asarray(getattr(tcut, f.name)),
                                      np.asarray(getattr(jcut, f.name)),
                                      f.name)


@pytest.mark.parametrize("edit,field", [
    (lambda d, meta: meta.pop("topk"), "topk"),
    (lambda d, meta: meta["dims"].pop("path_dim"), "dims"),
    (lambda d, meta: meta.update(kind="checkpoint"), "kind"),
    (lambda d, meta: os.remove(os.path.join(d, "transform.npy")),
     "transform"),
    (lambda d, meta: np.save(os.path.join(d, "path_embedding.npy"),
                             np.zeros((3, 128), np.int8)),
     "path_embedding.shape"),
    (lambda d, meta: np.save(os.path.join(d, "target_embedding.scale.npy"),
                             np.zeros((3, 1), np.float32)),
     "target_embedding.scale"),
])
def test_load_artifact_names_the_bad_field(jax_model, tmp_path, edit, field):
    art_dir = _export(jax_model, tmp_path, jart.SCHEME_INT8)
    meta_path = os.path.join(art_dir, tart.META_NAME)
    with open(meta_path) as f:
        meta = json.load(f)
    edit(art_dir, meta)
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(tart.ArtifactError) as e:
        tart.load_artifact(art_dir)
    assert e.value.field == field
    with pytest.raises(jart.ArtifactError) as je:
        jart.load_artifact(art_dir)
    assert je.value.field == field


def test_cuda_device_refused_without_cuda(jax_model, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal is for hosts without")
    art_dir = _export(jax_model, tmp_path, jart.SCHEME_INT8)
    with pytest.raises(RuntimeError, match="is_available"):
        ReleaseModel(Config(serve_artifact=art_dir, verbose_mode=0))
