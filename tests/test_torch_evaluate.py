"""The port's artifact evaluation against the JAX package's, on the CPU.

The tiny JAX model of tests/test_torch_release.py is exported in every
scheme; both packages' `ReleaseModel.evaluate` (and their command lines,
`code2vec_tpu --artifact DIR --test FILE` and `python -m
code2vec_tpu_torch evaluate --artifact DIR --test FILE --device cpu`)
score one labelled corpus with it. The port's metrics module, a copy of
the JAX one, is held against it on random names.

Tolerances, and why:
- top-k accuracy, subtoken precision, recall and F1, and the per-example
  log: exact (the top-k indices are equal; the metrics count them).
- the loss: BF16 (atol 2e-2, rtol 1e-2), as the release step's outputs in
  tests/test_torch_release.py: a code vector rounded to bf16 may land one
  bf16 step apart.
- the port's serial and pipelined loops: identical (the same step on the
  same batches).
"""

import dataclasses
import logging
import os
import random

import numpy as np
import pytest
import torch

from code2vec_tpu import cli as jcli
from code2vec_tpu.evaluation import metrics as jmetrics
from code2vec_tpu.release import artifact as jart
from code2vec_tpu.release.runtime import ReleaseModel as JaxReleaseModel
from code2vec_tpu.vocab import Code2VecVocabs as JaxVocabs
from code2vec_tpu_torch import cli, kernels
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.evaluation import metrics as tmetrics
from code2vec_tpu_torch.release.runtime import ReleaseModel
from code2vec_tpu_torch.vocab import Code2VecVocabs

from test_torch_release import _export, _tiny_jax_model

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

BF16 = dict(rtol=1e-2, atol=2e-2)


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    return _tiny_jax_model(tmp_path_factory.mktemp("torch-evaluate"))


@pytest.fixture(scope="module")
def corpus(jax_model, tmp_path_factory):
    """The model's training rows, then rows with unknown names, unknown
    words, no valid context (dropped by the reader) and a name the model
    knows under other contexts: 57 rows, of which 56 are scored."""
    with open(jax_model.config.train_data_path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    lines += ["unknown|name tok0,p0,tok0 tok1,p2,tok1",
              "name|x3 nosuch,p9,tok2 tok3,p3,tok3",
              "name|x7 , ,",
              "get|x1 tok4,p1,tok4",
              "name|x12 tok2,p0,tok5 tok0,p3,tok1 tok5,p2,tok5",
              "x|y|z tok1,p1,tok1",
              "name|x0 tok0,p0,tok0",
              "NAME|X5 tok5,p1,tok5",
              "name|x39 tok3,p2,tok3 tok4,p2,tok4"]
    path = str(tmp_path_factory.mktemp("corpus") / "test.c2v")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def _jax_evaluate(jax_model, art_dir, test_path, log_dir, monkeypatch):
    jcfg = dataclasses.replace(jax_model.config,
                               train_data_path_prefix=None,
                               serve_artifact=art_dir,
                               test_data_path=test_path)
    monkeypatch.chdir(log_dir)   # the JAX evaluator writes ./log.txt
    results = JaxReleaseModel(jcfg, log=lambda m: None).evaluate()
    with open(os.path.join(log_dir, "log.txt")) as f:
        return results, f.read().splitlines()


def _port_model(art_dir, test_path):
    return ReleaseModel(Config(serve_artifact=art_dir, device="cpu",
                               test_data_path=test_path, test_batch_size=8,
                               verbose_mode=0))


def _same_results(got, want):
    np.testing.assert_array_equal(got.topk_acc, want.topk_acc)
    assert (got.subtoken_precision, got.subtoken_recall,
            got.subtoken_f1) == (want.subtoken_precision,
                                 want.subtoken_recall, want.subtoken_f1)
    np.testing.assert_allclose(got.loss, want.loss, **BF16)


@pytest.mark.parametrize("scheme", jart.ALL_SCHEMES)
def test_evaluate_matches_jax(jax_model, corpus, tmp_path, monkeypatch,
                              scheme):
    art_dir = _export(jax_model, tmp_path, scheme)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    want, want_log = _jax_evaluate(jax_model, art_dir, corpus, str(jdir),
                                   monkeypatch)
    model = _port_model(art_dir, corpus)
    before = kernels.launch_counts()
    runs = {}
    for prefetch in (True, False):
        log_path = str(tdir / f"log-{prefetch}.txt")
        runs[prefetch] = (model.evaluate(log_path=log_path,
                                         prefetch=prefetch), log_path)
    assert kernels.launch_counts() == before   # CPU: the plain versions
    assert model.config.num_test_examples == 57
    got, log_path = runs[True]
    _same_results(got, want)
    assert got.topk_acc.shape == (10,) and np.isfinite(got.loss)
    with open(log_path) as f:
        got_log = f.read().splitlines()
    assert got_log == want_log
    assert len(got_log) >= 56 + 1
    # the serial loop gives what the pipelined one gives
    serial, serial_log = runs[False]
    np.testing.assert_array_equal(serial.topk_acc, got.topk_acc)
    assert (serial.subtoken_f1, serial.loss) == (got.subtoken_f1, got.loss)
    with open(serial_log) as f:
        assert f.read().splitlines() == got_log


def _logged_results(logger_name, run):
    """The result line a command logs (`loss: ..., top10_acc: ...`)."""
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = logging.getLogger(logger_name)
    handler = Keep()
    logger.addHandler(handler)
    level = logger.level
    logger.setLevel(logging.INFO)
    try:
        out = run()
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    lines = [r for r in records if r.startswith("loss: ")]
    assert len(lines) == 1, records
    return out, lines[0]


def test_evaluate_command_matches_jax_command(jax_model, corpus, tmp_path,
                                              monkeypatch):
    """The two command lines print the same accuracy, precision, recall
    and F1 (the loss within one bf16 step)."""
    art_dir = _export(jax_model, tmp_path, jart.SCHEME_INT4)
    monkeypatch.chdir(tmp_path)
    _, want = _logged_results("code2vec_tpu", lambda: jcli.main(
        ["--artifact", art_dir, "--test", corpus]))
    log_path = str(tmp_path / "port-log.txt")
    got_results, got = _logged_results(
        "code2vec_tpu_torch", lambda: cli.main(
            ["evaluate", "--artifact", art_dir, "--test", corpus,
             "--test_batch_size", "8", "--eval_log", log_path,
             "--device", "cpu"]))
    assert os.path.isfile(log_path)
    loss_w, rest_w = want.split(", ", 1)
    loss_g, rest_g = got.split(", ", 1)
    assert rest_g == rest_w and rest_g.startswith("top10_acc: [")
    np.testing.assert_allclose(float(loss_g.split()[1]),
                               float(loss_w.split()[1]), **BF16)
    assert str(got_results).replace("topk", "top10") == got


def test_evaluate_command_refuses_mips_and_a_missing_corpus(jax_model,
                                                            tmp_path):
    art_dir = _export(jax_model, tmp_path, jart.SCHEME_INT8)
    with pytest.raises(SystemExit):
        cli.main(["evaluate", "--artifact", art_dir, "--test", "x.c2v",
                  "--serve_mips_nprobe", "4", "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli.main(["evaluate", "--artifact", art_dir, "--device", "cpu"])
    with pytest.raises(SystemExit):   # --test belongs to evaluate/embed
        cli.main(["serve", "--artifact", art_dir, "--test", "x.c2v",
                  "--device", "cpu"])


def _random_vocab_and_names(seed, separate):
    """A target vocabulary of random subtoken names (some illegal) and
    method names, some in it, some not."""
    rng = random.Random(seed)
    parts = ["get", "set", "x", "Name", "to", "string", "a1", "is"]
    words = sorted({"|".join(rng.choice(parts)
                             for _ in range(rng.randint(1, 3)))
                    for _ in range(60)})
    tv = Code2VecVocabs.from_words(["t"], ["p"], words,
                                   separate_oov_and_pad=separate)
    names = ["|".join(rng.choice(parts) for _ in range(rng.randint(1, 3)))
             for _ in range(40)] + ["", "a-b", "GET|X"]
    return tv, names


@pytest.mark.parametrize("separate", [False, True])
def test_metrics_match_jax(separate, tmp_path):
    tv, names = _random_vocab_and_names(5, separate)
    path = str(tmp_path / "dict.bin")
    tv.save(path)
    jv = JaxVocabs.load(path, separate_oov_and_pad=separate)
    rng = np.random.default_rng(5)
    v = tv.target_vocab.size
    topk = rng.integers(0, v + 3, (len(names), 10))   # some past the vocab
    jt = jmetrics.TargetWordTables(jv.target_vocab)
    tt = tmetrics.TargetWordTables(tv.target_vocab)
    jinfo = jmetrics.batch_prediction_info(jt, names, topk)
    tinfo = tmetrics.batch_prediction_info(tt, names, topk)
    for a, b in zip(tinfo, jinfo):
        np.testing.assert_array_equal(a, b)
    for k in (1, 5, 10):
        jm = jmetrics.TopKAccuracyEvaluationMetric(k, jt)
        tm = tmetrics.TopKAccuracyEvaluationMetric(k, tt)
        jm.update_batch_from_indices(names, topk)
        tm.update_batch_from_indices(names, topk)
        np.testing.assert_array_equal(tm.topk_correct_predictions,
                                      jm.topk_correct_predictions)
    js = jmetrics.SubtokensEvaluationMetric(jt)
    ts = tmetrics.SubtokensEvaluationMetric(tt)
    js.update_batch_from_indices(names, topk)
    ts.update_batch_from_indices(names, topk)
    assert (ts.precision, ts.recall, ts.f1) == (js.precision, js.recall,
                                                 js.f1)
    for name, row in zip(names, topk):
        assert tmetrics.first_match_rank(tt, name, row) == \
            jmetrics.first_match_rank(jt, name, row)
    res = dict(topk_acc=np.array([0.25, 0.5]), subtoken_precision=0.5,
               subtoken_recall=0.25, subtoken_f1=1 / 3, loss=1.5)
    assert str(tmetrics.ModelEvaluationResults(**res)) == \
        str(jmetrics.ModelEvaluationResults(**res))
