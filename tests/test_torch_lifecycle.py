"""The port's training lifecycle against the JAX package, on the CPU:
resume, evaluation during training, the code-vector outputs, `export`,
the word2vec dumps, serving from `--load`, the command line, and one end
to end run on tests/goldens.

Both packages get the same numpy inputs: the same synthetic dataset
(tests/test_torch_train.py), the same initial parameters (the JAX
facade's, from its seed, carried by `params_from_jax`), or the port's
trained parameters given to a JAX facade. Dropout is off (keep 1.0)
wherever both train: threefry and Philox masks cannot match.

Tolerances are ROADMAP's parity bar: f32 rtol 1e-5 / atol 1e-6; bf16
atol 2e-2 / rtol 1e-2 (one bf16 step: a last-bit f32 difference can move
a value rounded to bf16 by a step, and training compounds such steps).
Metrics computed from the same top-k indices are equal; files written
from the same parameters (word2vec text, artifact tables) are equal
byte for byte.
"""

import builtins
import dataclasses
import json
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from code2vec_tpu import cli as jcli
from code2vec_tpu.config import Config as JaxConfig
from code2vec_tpu.model_facade import Code2VecModel as JaxModel
from code2vec_tpu.release import artifact as jart
from code2vec_tpu.release.runtime import ReleaseModel as JaxReleaseModel
from code2vec_tpu.retrieval.store import VectorStore as JaxVectorStore
from code2vec_tpu.serving.server import PredictionServer as JaxServer
from code2vec_tpu.training import checkpoint as jckpt
from code2vec_tpu.vocab import VocabType as JaxVocabType
from code2vec_tpu_torch import cli
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.model_facade import Code2VecModel
from code2vec_tpu_torch.release.runtime import ReleaseModel
from code2vec_tpu_torch.serving.server import PredictionServer
from code2vec_tpu_torch.training import checkpoint as ckpt
from code2vec_tpu_torch.weights import opt_state_from_jax, params_from_jax

from test_torch_server import FAKE_EXTRACTOR, SOURCE, _close, _post
from test_torch_train import _jax_initial_params, _make_synthetic_dataset

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=1e-2, atol=2e-2)
GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "goldens")
COMMON = dict(max_contexts=8, train_batch_size=16, test_batch_size=16,
              shuffle_buffer_size=32, dropout_keep_rate=1.0, verbose_mode=0)


def _port_config(prefix, **kw):
    return Config(**{"train_data_path_prefix": prefix, "device": "cpu",
                     "eval_log_path": None, "use_packed_data": False,
                     **COMMON, **kw})


def _jax_config(prefix, **kw):
    base = dict(train_data_path_prefix=prefix, use_packed_data=False,
                num_batches_to_log_progress=1000, **COMMON)
    base.update(kw)
    return JaxConfig(**base)


def _jax_with_params(jmodel, params):
    """The JAX facade holding `params` (name -> numpy f32)."""
    jmodel.state = jmodel.state.replace(
        params={k: jnp.asarray(np.asarray(v, np.float32))
                for k, v in params.items()})
    return jmodel


def _port_params(model):
    return {k: v.detach().numpy().copy() for k, v in model.state.params.items()}


def _recording(builder, batches, losses):
    """Wrap builder.make_train_step to record each step's ids and loss."""
    make = builder.make_train_step

    def make_recording(state):
        step = make(state)

        def run(state, *arrays):
            batches.append([np.asarray(a) for a in arrays[:5]])
            state, loss = step(state, *arrays)
            losses.append(float(loss))
            return state, loss
        return run

    builder.make_train_step = make_recording


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The synthetic dataset, and a labelled test file of its lines."""
    tmp = tmp_path_factory.mktemp("lifecycle")
    prefix = _make_synthetic_dataset(tmp, n_rows=160)
    test = str(tmp / "test.c2v")
    with open(prefix + ".train.c2v") as f:
        lines = f.readlines()
    with open(test, "w") as f:
        f.writelines(lines[:37] + lines[-2:])
    return tmp, prefix, test


@pytest.fixture(scope="module")
def trained(data):
    """The port trained two epochs with --save and --test (f32 compute):
    (model, the final checkpoint's path)."""
    tmp, prefix, test = data
    base = str(tmp / "port" / "model")
    os.makedirs(os.path.dirname(base))
    model = Code2VecModel(_port_config(
        prefix, num_train_epochs=2, model_save_path=base,
        test_data_path=test, compute_dtype="float32",
        eval_log_path=str(tmp / "port" / "log.txt")))
    model.train()
    return model, base


# ------------------------------------------------------------ the JAX state

def _assert_trained_leaf(key, got, want, before, atol=F32["atol"]):
    """`got` against `want` at the f32 bar, after checking that the bar
    tells the trained leaf from its value `before` the epoch: a
    checkpoint of the untrained state fails."""
    tol = dict(rtol=F32["rtol"], atol=atol)
    assert not np.allclose(before, want, **tol), key
    np.testing.assert_allclose(got, want, err_msg=key, **tol)


@pytest.mark.parametrize("sparse", [False, True])
def test_checkpoint_matches_jax_state(tmp_path, sparse):
    """The same initial params and batches through both packages' train
    step for one epoch, in float32 with float32 moments: the port's
    checkpoint, read with numpy alone, against the JAX state leaf by
    leaf. Params are held as their change over the epoch (six Adam steps
    move a param by ~6e-3), the moments against zero, where they start."""
    prefix = _make_synthetic_dataset(tmp_path)
    f32 = dict(num_train_epochs=1, use_sparse_embedding_update=sparse,
               compute_dtype="float32", adam_mu_dtype="float32",
               adam_nu_dtype="float32")
    jcfg = _jax_config(prefix, **f32)
    init = params_from_jax(jax.device_get(_jax_initial_params(jcfg)))
    jmodel = JaxModel(jcfg)
    jmodel.train()
    model = Code2VecModel(_port_config(
        prefix, model_save_path=str(tmp_path / "model"), **f32))
    model.module.load_state_dict(init)
    model.train()
    got = ckpt.load_state_arrays(str(tmp_path / "model"))
    jstate = jax.device_get(jmodel.state)
    assert int(got["step"]) == int(jstate.step) > 0
    for k, p in jstate.params.items():
        before = init[k].numpy()
        zero = np.zeros_like(before)
        _assert_trained_leaf(k, got[f"params/{k}"] - before,
                             np.asarray(p) - before, zero)
    opt = opt_state_from_jax(jstate.opt_state)
    if sparse:
        assert int(got["opt_state/dense/count"]) == opt.dense.count
        pairs = [(f"opt_state/dense/{m}/{k}", getattr(opt.dense, m)[k])
                 for m in ("mu", "nu") for k in getattr(opt.dense, m)]
        pairs += [(f"opt_state/slots/{t}/{m}", getattr(s, m))
                  for t, s in opt.slots.items() for m in ("mu", "nu")]
    else:
        assert int(got["opt_state/count"]) == opt.count == int(jstate.step)
        pairs = [(f"opt_state/{m}/{k}", getattr(opt, m)[k])
                 for m in ("mu", "nu") for k in getattr(opt, m)]
    assert len(pairs) >= 6
    for key, want in pairs:
        assert got[key].dtype == np.float32, key
        want = want.float().numpy()
        # the bar's atol scaled to the moment (Adam's nu is ~1e-6)
        atol = F32["atol"] * min(1.0, float(np.abs(want).max()))
        _assert_trained_leaf(key, got[key], want, np.zeros_like(want),
                             atol)


@pytest.mark.parametrize("kw", [
    {}, {"use_sparse_embedding_update": True},
    {"adam_mu_dtype": "float32", "adam_nu_dtype": "float32",
     "separate_oov_and_pad": True}])
def test_meta_matches_jax(tmp_path, kw):
    prefix = _make_synthetic_dataset(tmp_path)
    jmodel = JaxModel(_jax_config(prefix, **kw))
    jpath = str(tmp_path / "jax")
    jckpt.save_model(jpath, jmodel.state, jmodel.vocabs, jmodel.config,
                     epoch=3)
    model = Code2VecModel(_port_config(prefix, **kw))
    path = ckpt.save_model(str(tmp_path / "port"), model.state, model.vocabs,
                           model.config, epoch=3)
    assert ckpt.load_model_meta(path) == jckpt.load_model_meta(jpath)
    with open(os.path.join(jpath, "dictionaries.bin"), "rb") as a, \
            open(os.path.join(path, "dictionaries.bin"), "rb") as b:
        assert a.read() == b.read()


def test_resume_matches_jax(tmp_path):
    """The JAX facade saves after epoch 1 and resumes with --load; the
    port resumes from the same state, carried into a port checkpoint:
    epoch 2's batches (its shuffle), losses and numbering agree."""
    prefix = _make_synthetic_dataset(tmp_path, n_rows=160)
    jbase = str(tmp_path / "jax" / "model")
    jmodel = JaxModel(_jax_config(prefix, num_train_epochs=1,
                                  model_save_path=jbase))
    jmodel.train()
    resumed = JaxModel(_jax_config(prefix, num_train_epochs=2,
                                   model_load_path=jbase + "_iter1"))
    assert resumed.initial_epoch == 1
    jbatches, jlosses = [], []
    _recording(resumed.builder, jbatches, jlosses)
    resumed.train()

    jstate = jax.device_get(jmodel.state)
    model = Code2VecModel(_port_config(prefix))
    model.module.load_state_dict(params_from_jax(jstate.params))
    model.state.opt_state = opt_state_from_jax(jstate.opt_state)
    model.state.step = int(jstate.step)
    pbase = str(tmp_path / "port" / "model")
    os.makedirs(os.path.dirname(pbase))
    ckpt.save_model(pbase + "_iter1", model.state, model.vocabs,
                    model.config, epoch=1)
    port = Code2VecModel(_port_config(prefix, num_train_epochs=2,
                                      model_load_path=pbase))
    assert port.initial_epoch == 1
    batches, losses = [], []
    _recording(port.builder, batches, losses)
    port.train()
    assert port.trainer.final_epoch == resumed.initial_epoch == 2
    assert len(port.trainer.epoch_losses) == 1
    assert len(batches) == len(jbatches) > 3
    for a, b in zip(jbatches, batches):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-2)


# ----------------------------------------------- evaluation during training

def _read(path):
    with open(path) as f:
        return f.read().splitlines()


def test_eval_during_training_matches_jax(data, trained, tmp_path,
                                          monkeypatch):
    """`train --test`'s epoch-end results and log.txt against the JAX
    facade's `_evaluate_with_params` on the same params."""
    tmp, prefix, test = data
    model, _ = trained
    assert [e for e, _ in model.trainer.eval_results] == [1, 2]
    got = model.trainer.eval_results[-1][1]
    jmodel = _jax_with_params(JaxModel(_jax_config(
        prefix, test_data_path=test, compute_dtype="float32")),
        _port_params(model))
    monkeypatch.chdir(tmp_path)
    want = jmodel._evaluate_with_params(jmodel.state.params)
    np.testing.assert_array_equal(got.topk_acc, want.topk_acc)
    assert (got.subtoken_precision, got.subtoken_recall, got.subtoken_f1) \
        == (want.subtoken_precision, want.subtoken_recall, want.subtoken_f1)
    np.testing.assert_allclose(got.loss, want.loss, **F32)
    assert _read(str(tmp / "port" / "log.txt")) == _read("log.txt")
    assert 0 < want.topk_acc[-1]


@pytest.mark.parametrize("text", [False, True])
def test_code_vectors_match_jax(data, trained, tmp_path, text):
    """--export_code_vectors: the port's `.vectors` store opens in the
    JAX reader with the JAX export's rows and ids; --vectors_text lines
    hold the JAX export's vectors."""
    _, prefix, test = data
    model, base = trained
    for side in ("port", "jax"):
        os.makedirs(tmp_path / side)
        shutil.copy(test, tmp_path / side / "test.c2v")
    port = Code2VecModel(_port_config(
        prefix, compute_dtype="float32", model_load_path=base,
        test_data_path=str(tmp_path / "port" / "test.c2v"),
        export_code_vectors=True, vectors_text=text))
    port.evaluate()
    jmodel = _jax_with_params(JaxModel(_jax_config(
        prefix, compute_dtype="float32",
        test_data_path=str(tmp_path / "jax" / "test.c2v"),
        export_code_vectors=True, vectors_text=text)), _port_params(model))
    jmodel._evaluate_with_params(jmodel.state.params)
    got, want = (str(tmp_path / side / "test.c2v.vectors")
                 for side in ("port", "jax"))
    if text:
        g = np.array([[float(x) for x in ln.split()] for ln in _read(got)])
        w = np.array([[float(x) for x in ln.split()] for ln in _read(want)])
        assert g.shape == w.shape and g.shape[1] == 384
        np.testing.assert_allclose(g, w, **F32)
        return
    gs, ws = JaxVectorStore.open(got), JaxVectorStore.open(want)
    assert gs.ids == ws.ids and gs.rows == ws.rows > 0
    np.testing.assert_allclose(gs.load(), ws.load(), **F32)
    assert gs.fingerprint == port.model_fingerprint()
    assert port.model_fingerprint().startswith(f"ckpt:{base}@step")


# ------------------------------------------------------------------ export

@pytest.mark.parametrize("scheme", ["int8", "float32", "fp8_e4m3", "int4"])
def test_export_matches_jax(data, trained, tmp_path, monkeypatch, scheme):
    """`export --load` of a port checkpoint: tables byte-identical to the
    JAX export of the same params, and the same evaluation (metrics and
    log.txt) in the JAX ReleaseModel as in the port's."""
    _, prefix, test = data
    model, base = trained
    out = str(tmp_path / "port-art")
    meta = cli.main(["export", "--load", base, "--artifact_out", out,
                     "--release_scheme", scheme, "--max_contexts", "8",
                     "--device", "cpu"])
    jmodel = _jax_with_params(JaxModel(_jax_config(prefix)),
                              _port_params(model))
    jout = str(tmp_path / "jax-art")
    jmeta = jart.export_artifact(jmodel, jout,
                                 scheme=jart.SCHEME_BY_KNOB[scheme],
                                 aot=False, log=lambda m: None)
    assert meta["fingerprint"] == jmeta["fingerprint"]
    for key in ("dims", "buckets", "topk", "max_contexts", "compute_dtype",
                "quantization", "table_bytes"):
        assert meta[key] == jmeta[key], key
    assert meta["source"] == {"checkpoint": base,
                              "step": int(model.state.step), "epoch": 2}
    names = sorted(f for f in os.listdir(jout) if f.endswith(".npy"))
    assert names == sorted(f for f in os.listdir(out) if f.endswith(".npy"))
    for name in names:
        with open(os.path.join(out, name), "rb") as a, \
                open(os.path.join(jout, name), "rb") as b:
            assert a.read() == b.read(), name
    results = {}
    for side, make in (
            ("jax", lambda: JaxReleaseModel(dataclasses.replace(
                jmodel.config, train_data_path_prefix=None,
                serve_artifact=out, test_data_path=test),
                log=lambda m: None).evaluate()),
            ("port", lambda: ReleaseModel(Config(
                serve_artifact=out, test_data_path=test, device="cpu",
                test_batch_size=16, verbose_mode=0)).evaluate())):
        os.makedirs(tmp_path / side)
        monkeypatch.chdir(tmp_path / side)
        results[side] = make()
    got, want = results["port"], results["jax"]
    np.testing.assert_array_equal(got.topk_acc, want.topk_acc)
    assert got.subtoken_f1 == want.subtoken_f1
    # the artifact's compute dtype is bf16
    np.testing.assert_allclose(got.loss, want.loss, **BF16)
    assert _read(str(tmp_path / "port" / "log.txt")) == \
        _read(str(tmp_path / "jax" / "log.txt"))


# ---------------------------------------------------------------- word2vec

@pytest.mark.parametrize("what", ["save_w2v", "save_t2v", "embeddings"])
def test_word2vec_matches_jax(data, trained, tmp_path, what):
    _, prefix, _ = data
    model, base = trained
    jmodel = _jax_with_params(JaxModel(_jax_config(prefix)),
                              _port_params(model))
    if what == "embeddings":
        cli.main(["export-embeddings", "--load", base, "--embeddings_out",
                  str(tmp_path / "port"), "--device", "cpu"])
        jmodel.export_embeddings(str(tmp_path / "jax"))
        pairs = [(tmp_path / "port" / n, tmp_path / "jax" / n)
                 for n in ("tokens.w2v", "targets.w2v")]
    else:
        got = str(tmp_path / "port.txt")
        cli.main(["evaluate", "--load", base, f"--{what}", got,
                  "--device", "cpu"])
        want = str(tmp_path / "jax.txt")
        jmodel.save_word2vec_format(
            want, JaxVocabType.Token if what == "save_w2v"
            else JaxVocabType.Target)
        pairs = [(got, want)]
    for got, want in pairs:
        text = open(want).read()
        assert open(got).read() == text
        assert len(text.splitlines()) > 5


# ------------------------------------------------------- serving from --load

@pytest.fixture(scope="module")
def load_servers(data, trained, tmp_path_factory):
    """The port's server on `--load` of its checkpoint and the JAX
    server on `--load` of a JAX checkpoint of the same params, the fake
    extractor installed."""
    _, prefix, _ = data
    model, base = trained
    tmp = tmp_path_factory.mktemp("load-servers")
    fake = tmp / "fake-c2v-extract"
    fake.write_text(FAKE_EXTRACTOR)
    fake.chmod(0o755)
    mp = pytest.MonkeyPatch()
    mp.setenv("C2V_NATIVE_EXTRACTOR", str(fake))
    jsaved = _jax_with_params(JaxModel(_jax_config(
        prefix, compute_dtype="float32")), _port_params(model))
    jpath = str(tmp / "jax-ckpt")
    jckpt.save_model(jpath, jsaved.state, jsaved.vocabs, jsaved.config,
                     epoch=2)
    serve = dict(serve=True, serve_batch_size=4, serve_buckets="4,8",
                 compute_dtype="float32")
    jcfg = _jax_config(None, model_load_path=jpath, extractor_pool_size=1,
                       **serve)
    jserver = JaxServer(JaxModel(jcfg), jcfg)
    cfg = Config(model_load_path=base, device="cpu",
                 serve_max_delay_ms=2.0, **{**COMMON, **serve})
    tserver = PredictionServer(Code2VecModel(cfg))
    port = tserver.start(port=0)
    yield jserver, tserver, f"http://127.0.0.1:{port}", tmp
    tserver.shutdown()
    jserver.drain(timeout=5)
    mp.undo()


@pytest.mark.parametrize("endpoint", ["predict", "embed"])
def test_serve_load_matches_jax(load_servers, endpoint):
    jserver, tserver, url, _ = load_servers
    want = json.loads(jserver.handle(endpoint, SOURCE))
    status, body = _post(f"{url}/{endpoint}", SOURCE)
    assert status == 200, body
    got = json.loads(body)
    assert got.pop("model_fingerprint").startswith("ckpt:")
    want.pop("model_fingerprint")
    got.pop("embedding_fingerprint", None)
    want.pop("embedding_fingerprint", None)
    _close(got, want)
    if endpoint == "predict":
        assert [m["original_name"] for m in got["methods"]] == \
            ["alpha", "beta"]


def test_predict_load_command(load_servers, trained, monkeypatch, capsys):
    """`predict --load`: the interactive loop prints the server's names."""
    _, _, url, tmp = load_servers
    _, base = trained
    src = tmp / "Input.java"
    src.write_text(SOURCE)
    answers = iter(["", "q"])
    monkeypatch.setattr(builtins, "input", lambda *a: next(answers))
    cli.main(["predict", "--load", base, "--predict_file", str(src),
              "--device", "cpu", "--max_contexts", "8"])
    out = capsys.readouterr().out
    body = json.loads(_post(f"{url}/predict", SOURCE)[1])
    assert "Original name:\talpha" in out
    top = body["methods"][0]["predictions"][0]["name"]
    assert f"predicted: {top}" in out


# ------------------------------------------------------------ command line

@pytest.fixture
def paths(tmp_path):
    os.makedirs(tmp_path / "m")
    return {"L": str(tmp_path / "m" / "model"), "P": str(tmp_path / "d"),
            "T": str(tmp_path / "t.c2v"), "S": str(tmp_path / "m" / "s"),
            "A": str(tmp_path / "art"), "E": str(tmp_path / "emb"),
            "W": str(tmp_path / "w.txt"), "O": str(tmp_path / "store")}


def _argv(args, paths):
    return [paths.get(a, a) for a in args]


@pytest.mark.parametrize("port_argv,ref_argv,fields", [
    (["train", "--data", "P", "--save", "S"], ["--data", "P", "--save", "S"],
     ["model_save_path", "train_data_path_prefix"]),
    (["train", "-d", "P", "-s", "S", "-te", "T"],
     ["-d", "P", "-s", "S", "-te", "T"],
     ["model_save_path", "test_data_path"]),
    (["train", "--data", "P", "--load", "L"], ["--data", "P", "--load", "L"],
     ["model_load_path"]),
    (["train", "--data", "P", "-l", "L", "--save_w2v", "W", "--save_t2v",
      "T"], ["--data", "P", "-l", "L", "--save_w2v", "W", "--save_t2v", "T"],
     ["save_w2v", "save_t2v"]),
    (["evaluate", "--load", "L", "--release"], ["--load", "L", "--release"],
     ["release", "model_load_path"]),
    (["evaluate", "--load", "L", "--test", "T", "--export_code_vectors",
      "--vectors_text"], ["--load", "L", "--test", "T",
                          "--export_code_vectors", "--vectors_text"],
     ["export_code_vectors", "vectors_text", "test_data_path"]),
    (["export", "--load", "L", "--artifact_out", "A"],
     ["export", "--load", "L", "--artifact_out", "A"],
     ["export_artifact_path", "release_quantize", "release_scheme"]),
    (["export", "--load", "L", "--artifact_out", "A", "--no_quantize"],
     ["export", "--load", "L", "--artifact_out", "A", "--no_quantize"],
     ["release_quantize"]),
    (["export", "--load", "L", "--artifact_out", "A", "--release_scheme",
      "int4"], ["export", "--load", "L", "--artifact_out", "A",
                "--release_scheme", "int4"], ["release_scheme"]),
    (["export-embeddings", "--load", "L", "--embeddings_out", "E"],
     ["export-embeddings", "--load", "L", "--embeddings_out", "E"],
     ["embeddings_out", "model_load_path"]),
    (["serve", "--load", "L"], ["serve", "--load", "L"],
     ["serve", "model_load_path"]),
    (["embed", "--load", "L", "--test", "T", "--embed_out", "O"],
     ["embed", "--load", "L", "--test", "T", "--embed_out", "O"],
     ["embed_out", "model_load_path", "test_data_path"]),
    (["train", "--data", "P", "--adam_mu_dtype", "float32",
      "--adam_nu_dtype", "float32"],
     ["--data", "P", "--adam_mu_dtype", "float32", "--adam_nu_dtype",
      "float32"], ["adam_mu_dtype", "adam_nu_dtype"]),
    # the training loop's operations
    (["train", "--data", "P", "--tensorboard", "--rss_limit_gb", "2.5",
      "--on_nonfinite_loss", "warn"],
     ["--data", "P", "--tensorboard", "--rss_limit_gb", "2.5",
      "--on_nonfinite_loss", "warn"],
     ["use_tensorboard", "rss_limit_gb", "on_nonfinite_loss"]),
    (["train", "--data", "P", "--async_checkpointing", "--no_cursor_resume",
      "--checkpoint_hash_content"],
     ["--data", "P", "--async_checkpointing", "--no_cursor_resume",
      "--checkpoint_hash_content"],
     ["async_checkpointing", "cursor_resume", "checkpoint_hash_content"]),
    (["train", "--data", "P", "--profile_dir", "D", "--heartbeat_file", "W",
      "--metrics_file", "E", "--metrics_port", "9", "--trace_export", "O"],
     ["--data", "P", "--profile_dir", "D", "--heartbeat_file", "W",
      "--metrics_file", "E", "--metrics_port", "9", "--trace_export", "O"],
     ["profile_dir", "heartbeat_file", "metrics_file", "metrics_port",
      "trace_export"]),
    (["train", "--data", "P"], ["--data", "P"],
     ["use_tensorboard", "rss_limit_gb", "on_nonfinite_loss",
      "async_checkpointing", "cursor_resume", "checkpoint_hash_content",
      "profile_dir", "heartbeat_file", "save_on_preemption",
      "num_train_batches_to_evaluate"]),
])
def test_flags_parse_as_reference(paths, port_argv, ref_argv, fields):
    _, config = cli.config_from_args(_argv(port_argv, paths))
    ref = jcli.config_from_args(_argv(ref_argv, paths))
    ref.verify()
    for field in fields:
        assert getattr(config, field) == getattr(ref, field), field


def test_new_fields_default_as_reference():
    port, ref = Config(), JaxConfig()
    for field in ("save_every_epochs", "max_to_keep", "model_save_path",
                  "model_load_path", "release", "save_w2v", "save_t2v",
                  "export_artifact_path", "release_quantize",
                  "vectors_text", "embeddings_out", "release_scheme"):
        assert getattr(port, field) == getattr(ref, field), field


def _reference_error(argv):
    try:
        config = jcli.config_from_args(argv)
    except SystemExit as e:
        return str(e)
    with pytest.raises(ValueError) as e:
        config.verify()
    return str(e.value)


@pytest.mark.parametrize("port_argv,ref_argv", [
    (["export", "--load", "L"], ["export", "--load", "L"]),
    (["export", "--data", "P", "--artifact_out", "A"],
     ["export", "--data", "P", "--artifact_out", "A"]),
    (["export-embeddings", "--load", "L"],
     ["export-embeddings", "--load", "L"]),
    (["export", "--load", "L", "--artifact_out", "A", "--test", "T"],
     ["export", "--load", "L", "--artifact_out", "A", "--test", "T"]),
    (["serve", "--artifact", "A", "--load", "L"],
     ["serve", "--artifact", "A", "--load", "L"]),
    (["evaluate", "--artifact", "A", "--save_w2v", "W"],
     ["--artifact", "A", "--save_w2v", "W"]),
    (["train", "--data", "P", "--artifact", "A"],
     ["--data", "P", "--artifact", "A"]),
    (["export-embeddings", "--load", "L", "--embeddings_out", "E",
      "--test", "T"],
     ["export-embeddings", "--load", "L", "--embeddings_out", "E",
      "--test", "T"]),
])
def test_argument_errors_as_reference(paths, port_argv, ref_argv, capsys):
    want = _reference_error(_argv(ref_argv, paths))
    with pytest.raises(SystemExit):
        cli.config_from_args(_argv(port_argv, paths))
    err = " ".join(capsys.readouterr().err.split())
    assert " ".join(want.split()) in err


@pytest.mark.parametrize("argv", [
    ["train", "--data", "P"],
    ["train", "--data", "P", "--save", "S", "--test", "T"],
    ["evaluate", "--load", "L", "--test", "T"],
    ["evaluate", "--load", "L", "--release"],
    ["export", "--load", "L", "--artifact_out", "A"],
    ["export-embeddings", "--load", "L", "--embeddings_out", "E"],
    ["serve", "--load", "L"],
    ["predict", "--load", "L"],
    ["embed", "--load", "L", "--test", "T", "--embed_out", "O"],
])
def test_entry_points_refuse_cuda_without_cuda(data, trained, argv):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the refusal is for hosts without")
    _, prefix, test = data
    _, base = trained
    paths = {"P": prefix, "L": base, "T": test, "S": base + "-other",
             "A": base + "-art", "E": base + "-emb", "O": base + "-store"}
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(_argv(argv, paths))
    assert not os.path.exists(base + "-art")


# ------------------------------------------------------------ end to end

def test_end_to_end_on_goldens(tmp_path, monkeypatch):
    """The extractor's golden outputs as a corpus: train with --save and
    --test, then `evaluate --load`, `export` and predict from the
    checkpoint and from the artifact."""
    lines = []
    for name in ("Input.java.c2v", "PriceService.java.c2v",
                 "UserStore.java.c2v", "Golden.cs.c2v"):
        with open(os.path.join(GOLDENS, name)) as f:
            lines += [ln.rstrip("\n") for ln in f if ln.strip()]
    counts = [{}, {}, {}]
    for ln in lines:
        name, *ctxs = ln.split()
        counts[2][name] = counts[2].get(name, 0) + 1
        for c in ctxs:
            s, p, t = c.split(",")
            for i, w in ((0, s), (1, p), (0, t)):
                counts[i][w] = counts[i].get(w, 0) + 1
    prefix = str(tmp_path / "goldens")
    with open(prefix + ".train.c2v", "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(prefix + ".dict.c2v", "wb") as f:
        for c in counts:
            pickle.dump(c, f)
        pickle.dump(len(lines), f)
    monkeypatch.chdir(tmp_path)
    save = str(tmp_path / "m" / "model")
    model = cli.main(["train", "--data", prefix, "--save", save, "--test",
                      prefix + ".train.c2v", "--epochs", "3",
                      "--batch_size", "8", "--device", "cpu"])
    assert [e for e, _ in model.trainer.eval_results] == [1, 2, 3]
    final = model.trainer.eval_results[-1][1]
    assert sorted(os.listdir(tmp_path / "m")) == \
        ["model", "model_iter1", "model_iter2", "model_iter3"]
    again = cli.main(["evaluate", "--load", save, "--test",
                      prefix + ".train.c2v", "--device", "cpu",
                      "--batch_size", "8"])
    np.testing.assert_array_equal(again.topk_acc, final.topk_acc)
    np.testing.assert_allclose(again.loss, final.loss, **F32)
    art = str(tmp_path / "art")
    cli.main(["export", "--load", save, "--artifact_out", art,
              "--no_quantize", "--device", "cpu"])
    loaded = Code2VecModel(Config(model_load_path=save, device="cpu",
                                  verbose_mode=0))
    released = ReleaseModel(Config(serve_artifact=art, device="cpu",
                                   verbose_mode=0))
    got = loaded.predict(lines[:5])
    want = released.predict(lines[:5])
    assert [r.topk_predicted_words for r in got] == \
        [r.topk_predicted_words for r in want]
    assert [r.original_name for r in got] == [ln.split()[0]
                                              for ln in lines[:5]]
