"""Training, evaluation and the command line at the default config, which
reads the packed `.c2vb`, against the JAX package on the CPU.

Both facades run with `use_packed_data` on (the default), float32
compute and moments and dropout off, from the same initial parameters:
the same batches in the same order (each epoch a permutation keyed by
the seed and the absolute epoch), per-step losses at the f32 bar, and
each parameter's change over one epoch at that bar too, by
test_torch_lifecycle.py's `_assert_trained_leaf` rule (up to the stray
elements of near-zero gradients that STRAY_SHARE below bounds). The same holds
for a `--train_corpus_manifest` of two shards. Evaluation from the
`.c2vb` (and from a fused-compiled test set with no text) gives the JAX
facade's metrics and log.txt. The `train` command packs once and then
reads the `.c2vb`; `--no_packed_data` reads the text.
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

from code2vec_tpu.config import Config as JaxConfig
from code2vec_tpu.data import packed as jpacked
from code2vec_tpu.model_facade import Code2VecModel as JaxModel
from code2vec_tpu_torch import cli
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.data import packed
from code2vec_tpu_torch.model_facade import Code2VecModel
from code2vec_tpu_torch.weights import params_from_jax

from test_torch_lifecycle import (
    F32, _assert_trained_leaf, _jax_with_params, _port_params, _recording,
)
from test_torch_train import _jax_initial_params, _make_synthetic_dataset

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

COMMON = dict(max_contexts=8, train_batch_size=16, test_batch_size=16,
              dropout_keep_rate=1.0, verbose_mode=0,
              compute_dtype="float32", adam_mu_dtype="float32",
              adam_nu_dtype="float32")


def _configs(prefix, **kw):
    """(JAX config, port config) at the default data path."""
    common = dict(train_data_path_prefix=prefix, **COMMON, **kw)
    return (JaxConfig(save_every_epochs=1000,
                      num_batches_to_log_progress=1000, **common),
            Config(device="cpu", eval_log_path=None, **common))


def _train_both(jcfg, tcfg):
    """Both facades trained from the JAX initial params, recording each
    step's ids and loss: (jmodel, port model, init, jax record, port
    record)."""
    init = params_from_jax(jax.device_get(_jax_initial_params(jcfg)))
    jmodel = JaxModel(jcfg)
    jrec = ([], [])
    _recording(jmodel.builder, *jrec)
    jmodel.train()
    model = Code2VecModel(tcfg)
    model.module.load_state_dict(init)
    rec = ([], [])
    _recording(model.builder, *rec)
    model.train()
    return jmodel, model, init, jrec, rec


# Adam divides the first moment by the root of the second: where a
# gradient is a near-total cancellation (a sum of terms far larger than
# itself), the two packages' f32 summation orders give it relative errors
# far above f32's, and its step follows. Over a few steps that moved at
# most 5 of the 147,456 `transform` elements past the f32 bar, by under
# 6e-6 (0.6% of one step of lr 1e-3), on the text reader as on the packed
# one. Such elements may miss the bar: at most one in 10,000 of a tensor
# (and at least one), each within 1e-5.
STRAY_SHARE, STRAY_ATOL = 1e-4, 1e-5


def _assert_trained_change(key, got, want):
    """`_assert_trained_leaf` on a parameter's change over training, up
    to the stray elements above."""
    zero = np.zeros_like(want)
    tol = dict(rtol=F32["rtol"], atol=F32["atol"])
    assert not np.allclose(zero, want, **tol), key
    stray = ~np.isclose(got, want, **tol)
    assert stray.sum() <= max(1, STRAY_SHARE * want.size), (key, stray.sum())
    np.testing.assert_allclose(got[stray], want[stray], rtol=0,
                               atol=STRAY_ATOL, err_msg=key)
    _assert_trained_leaf(key, np.where(stray, want, got), want, zero)


def _assert_same_training(jmodel, model, init, jrec, rec, params=True):
    """The same batches and losses; with `params` (one epoch: the f32
    bar holds a parameter's change over a few steps, not over many), the
    same change of every parameter."""
    (jbatches, jlosses), (batches, losses) = jrec, rec
    assert len(batches) == len(jbatches) > 6
    for a, b in zip(jbatches, batches):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_allclose(losses, jlosses, **F32)
    if not params:
        return
    for k, p in jax.device_get(jmodel.state.params).items():
        before = init[k].numpy()
        got = model.state.params[k].detach().numpy()
        _assert_trained_change(k, got - before, np.asarray(p) - before)


@pytest.mark.parametrize("epochs", [1, 3])
@pytest.mark.parametrize("sparse", [False, True])
def test_default_config_training_matches_jax(tmp_path, sparse, epochs):
    prefix = _make_synthetic_dataset(tmp_path, n_rows=160)
    jcfg, tcfg = _configs(prefix, num_train_epochs=epochs,
                          use_sparse_embedding_update=sparse)
    assert jcfg.use_packed_data and tcfg.use_packed_data
    _assert_same_training(*_train_both(jcfg, tcfg), params=epochs == 1)
    assert os.path.isfile(prefix + ".train.c2vb")


def test_manifest_training_matches_jax(tmp_path):
    """--train_corpus_manifest over two shards: one row space, the same
    epoch-keyed permutation in both packages."""
    prefix = _make_synthetic_dataset(tmp_path, n_rows=160)
    with open(prefix + ".train.c2v") as f:
        lines = f.readlines()
    jcfg, tcfg = _configs(prefix)
    model = Code2VecModel(tcfg)
    shards = []
    for i, part in enumerate((lines[:90], lines[90:])):
        text = str(tmp_path / f"part{i}.c2v")
        with open(text, "w") as f:
            f.writelines(part)
        shards.append(packed.pack_c2v(text, model.vocabs, 8))
    manifest = str(tmp_path / "corpus.manifest.json")
    packed.create_manifest(manifest, shards)
    jcfg, tcfg = _configs(prefix, num_train_epochs=1,
                          train_corpus_manifest=manifest)
    jmodel, model, init, jrec, rec = _train_both(jcfg, tcfg)
    _assert_same_training(jmodel, model, init, jrec, rec)
    assert model._train_corpus().num_shard_files == 2
    with pytest.raises(ValueError, match="requires packed data"):
        Config(train_data_path_prefix=prefix, device="cpu",
               train_corpus_manifest=manifest,
               use_packed_data=False).verify()


def _read_lines(path):
    with open(path) as f:
        return f.read().splitlines()


@pytest.mark.parametrize("source", ["packed", "compiled"])
def test_packed_evaluate_matches_jax(tmp_path, monkeypatch, source):
    """The port's evaluation of a `.c2vb` (packed beside its text on
    first use, or fused-compiled with no text at all) against the JAX
    facade's on the same params: metrics and log.txt lines equal."""
    prefix = _make_synthetic_dataset(tmp_path, n_rows=120)
    jcfg, tcfg = _configs(prefix, num_train_epochs=1)
    model = Code2VecModel(tcfg)
    model.train()
    test = str(tmp_path / "test.c2v")
    with open(prefix + ".train.c2v") as f:
        lines = f.readlines()
    with open(test, "w") as f:
        f.writelines(lines[:41])
    if source == "compiled":
        packed.pack_c2v(test, model.vocabs, 8)
        os.unlink(test)
    for side in ("port", "jax"):
        os.makedirs(tmp_path / side)
        for suffix in ("", "b", "b.targets", "b.meta.json"):
            if os.path.exists(test + suffix):
                shutil.copy(test + suffix, tmp_path / side /
                            f"test.c2v{suffix}")
    monkeypatch.chdir(tmp_path / "port")
    model.config.test_data_path = str(tmp_path / "port" / "test.c2v")
    model.config.eval_log_path = "log.txt"
    got = model.evaluate()
    assert model.config.num_test_examples == 41
    assert os.path.isfile(model.config.test_data_path + "b")
    jcfg.test_data_path = str(tmp_path / "jax" / "test.c2v")
    jmodel = _jax_with_params(JaxModel(jcfg), _port_params(model))
    monkeypatch.chdir(tmp_path / "jax")
    want = jmodel.evaluate()
    np.testing.assert_array_equal(got.topk_acc, want.topk_acc)
    assert (got.subtoken_precision, got.subtoken_recall, got.subtoken_f1) \
        == (want.subtoken_precision, want.subtoken_recall, want.subtoken_f1)
    np.testing.assert_allclose(got.loss, want.loss, **F32)
    assert _read_lines(str(tmp_path / "port" / "log.txt")) == \
        _read_lines(str(tmp_path / "jax" / "log.txt"))
    assert want.topk_acc[-1] > 0


def test_train_command_packs_once(tmp_path, caplog):
    """`train --data PREFIX` packs `PREFIX.train.c2v` once and then reads
    the `.c2vb` (a second run finds it and writes nothing); the JAX
    package opens the port's pack; `--no_packed_data` reads the text and
    writes no pack."""
    prefix = _make_synthetic_dataset(tmp_path)
    argv = ["train", "--data", prefix, "--epochs", "1", "--batch_size",
            "16", "--max_contexts", "8", "--device", "cpu"]
    text_prefix = str(tmp_path / "text")
    for suffix in (".train.c2v", ".dict.c2v"):
        shutil.copy(prefix + suffix, text_prefix + suffix)
    model = cli.main(argv + ["--no_packed_data"])
    assert not model.config.use_packed_data
    model = cli.main(["train", "--data", text_prefix] + argv[3:]
                     + ["--no_packed_data"])
    assert not os.path.exists(text_prefix + ".train.c2vb")
    with caplog.at_level("INFO", logger="code2vec_tpu_torch"):
        model = cli.main(argv + ["--preprocess_workers", "2"])
    assert model.config.use_packed_data
    assert model.config.preprocess_workers == 2
    assert any("(one-time)" in r.message for r in caplog.records)
    packed_path = prefix + ".train.c2vb"
    stamp = os.stat(packed_path).st_mtime_ns
    caplog.clear()
    with caplog.at_level("INFO", logger="code2vec_tpu_torch"):
        model = cli.main(argv + ["--prefetch_double_buffer"])
    assert model.config.prefetch_double_buffer
    assert not any("(one-time)" in r.message for r in caplog.records)
    assert os.stat(packed_path).st_mtime_ns == stamp
    assert sum(len(e) for e in model.trainer.epoch_losses) == \
        model.state.step > 0
    jds = jpacked.PackedDataset(packed_path, JaxModel(JaxConfig(
        train_data_path_prefix=prefix, max_contexts=8,
        verbose_mode=0)).vocabs)
    assert jds.num_rows_total == packed.PackedDataset.read_header(
        packed_path)[0] == 98
