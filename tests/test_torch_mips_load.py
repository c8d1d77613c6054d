"""The MIPS head from `--load` and the export-time crossover calibration,
on the CPU against the JAX package.

The port's `--load` facade with `serve_mips_nprobe` builds its head over
the live target table (K9, K10 on the card; their plain versions here)
and must give the JAX facade's `_get_mips_topk` answers for the same
weights and seed, at tests/test_torch_retrieval.py's MIPS tolerance.
`export --serve_mips_nprobe` records `mips_crossover` and
`mips_calibration` without moving the fingerprint, and a ReleaseModel
with `--serve_mips_crossover -1` adopts what was recorded, as the JAX
runtime does for the same artifact.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from code2vec_tpu import cli as jcli
from code2vec_tpu.release.runtime import ReleaseModel as JaxReleaseModel
from code2vec_tpu_torch import cli, obs
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.model_facade import Code2VecModel
from code2vec_tpu_torch.release.artifact import META_NAME, load_artifact
from code2vec_tpu_torch.release.runtime import ReleaseModel

from test_torch_release import _tiny_jax_model
from test_torch_retrieval import _assert_topk_close

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

NPROBE, NLIST = 3, 6
SERVE = dict(serve_batch_size=4, serve_buckets="4,8", max_contexts=16,
             compute_dtype="float32")


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A JAX facade with the MIPS head on, and the port's checkpoint of
    the same (seeded) params: (jax model, checkpoint base, lines)."""
    tmp = tmp_path_factory.mktemp("mips-load")
    jmodel = _tiny_jax_model(tmp, compute_dtype="float32", serve=True,
                             serve_mips_nprobe=NPROBE,
                             serve_mips_nlist=NLIST)
    params = {k: np.asarray(v, np.float32) for k, v in
              jax.device_get(jmodel.state.params).items()}
    prefix = jmodel.config.train_data_path_prefix
    port = Code2VecModel(Config(train_data_path_prefix=prefix, device="cpu",
                                verbose_mode=0, use_packed_data=False,
                                num_train_epochs=1, **SERVE))
    port.load_params(params)
    base = str(tmp / "port" / "model")
    port.save(base)
    with open(jmodel.config.train_data_path) as f:
        lines = f.read().splitlines()[:12]
    return jmodel, base, lines


def _load(base, **kw):
    return Code2VecModel(Config(model_load_path=base, device="cpu",
                                verbose_mode=0, serve=True, **{**SERVE,
                                                               **kw}))


def test_load_facade_mips_head_matches_jax(saved):
    jmodel, base, lines = saved
    model = _load(base, serve_mips_nprobe=NPROBE, serve_mips_nlist=NLIST)
    exact = _load(base)
    got = model.predict(lines, batch_size=4, with_code_vectors=True)
    assert model.mips_head is not None
    assert (model.mips_head.nlist, model.mips_head.nprobe) == (NLIST, NPROBE)
    assert model.mips_head.real_vocab == jmodel.dims.real_target_vocab_size
    cv = np.stack([r.code_vector for r in got]).astype(np.float32)
    np.testing.assert_allclose(
        cv, np.stack([r.code_vector for r in exact.predict(
            lines, batch_size=4, with_code_vectors=True)]),
        rtol=1e-5, atol=1e-6)
    # the head closures on the same code vectors, at the served nprobe
    vals, ids = model._get_mips_topk()(torch.from_numpy(cv))
    jvals, jids = jmodel._get_mips_topk()(jnp.asarray(cv))
    _assert_topk_close(ids.numpy(), vals.numpy(), np.asarray(jids),
                       np.asarray(jvals))
    # predict answers with those ids, in the facade's word order
    words = [[model.vocabs.target_vocab.lookup_word(int(j)) for j in row]
             for row in ids.numpy()]
    assert [r.topk_predicted_words for r in got] == words
    # over every list the head is the exact head's top-k
    all_vals, all_ids = model.mips_head.topk_fn(10, NLIST)(
        torch.from_numpy(cv))
    want = exact.predict(lines, batch_size=4)
    want_ids = [[exact.vocabs.target_vocab.lookup_index(w)
                 for w in r.topk_predicted_words] for r in want]
    jall_vals, jall_ids = jmodel.mips_head.search(cv, 10, nprobe=NLIST)
    _assert_topk_close(all_ids.numpy(), all_vals.numpy(), jall_ids,
                       jall_vals)
    assert (all_ids.numpy()[:, 0] == np.asarray(want_ids)[:, 0]).all()


def test_load_facade_mips_counts_its_head(saved):
    _, base, lines = saved
    model = _load(base, serve_mips_nprobe=NPROBE, serve_mips_nlist=NLIST)
    counter = obs.default_registry().counter(
        "serving_head_dispatch_total", head="mips")
    before = counter.value
    model.warmup()   # builds the head; warm-up batches are not counted
    assert model.mips_head is not None and counter.value == before
    model.predict(lines[:5], batch_size=4)   # two device batches
    assert counter.value == before + 2
    # evaluation keeps the exact head
    assert model._get_eval_step() is not model._get_bucketed_predict_step(
        4, 4)


def _export(base, out, *flags):
    return cli.main(["export", "--load", base, "--artifact_out", out,
                     "--max_contexts", "16", "--compute_dtype", "float32",
                     "--device", "cpu", "-v", "0"] + list(flags))


def test_export_calibrates_without_moving_the_fingerprint(saved, tmp_path):
    _, base, lines = saved
    plain = _export(base, str(tmp_path / "plain"))
    meta = _export(base, str(tmp_path / "calibrated"), "--serve_mips_nprobe",
                   str(NPROBE), "--serve_mips_nlist", str(NLIST))
    assert "mips_crossover" not in plain
    assert meta["fingerprint"] == plain["fingerprint"]
    assert {k: v for k, v in meta.items()
            if not k.startswith("mips_")} == plain
    with open(tmp_path / "calibrated" / META_NAME) as f:
        on_disk = json.load(f)
    assert on_disk == meta
    assert load_artifact(str(tmp_path / "calibrated")).fingerprint == \
        plain["fingerprint"]
    crossover, table = meta["mips_crossover"], meta["mips_calibration"]
    assert isinstance(crossover, int)
    grid = [1, 2, 4, 8, 16, int(meta["serve_batch_size"])]
    keys = [int(k) for k in table]
    # the scan runs the grid in order and stops at the first exact win
    assert keys == sorted(set(grid))[:len(keys)]
    for rows in keys:
        t = table[str(rows)]
        assert sorted(t) == ["exact", "exact_range", "mips", "mips_range"]
        for head in ("exact", "mips"):
            lo, hi = t[f"{head}_range"]
            assert 0 < lo <= t[head] <= hi
    wins = [r for r in keys if table[str(r)]["mips"] < table[str(r)]["exact"]]
    assert wins == keys[:len(wins)]
    assert crossover == (wins[-1] if wins else 0)
    if len(keys) < len(set(grid)):
        assert keys[-1] not in wins

    # --serve_mips_crossover -1 adopts the recorded crossover, as the JAX
    # runtime does for the same artifact, except a recorded 0: exact-only
    # here, all-MIPS there (ROADMAP Queue 3)
    art = str(tmp_path / "calibrated")
    cfg = Config(serve_artifact=art, device="cpu", verbose_mode=0,
                 serve=True, serve_mips_nprobe=NPROBE,
                 serve_mips_nlist=NLIST, serve_mips_crossover=-1)
    tm = ReleaseModel(cfg)
    jcfg = jcli.config_from_args(
        ["--artifact", art, "--predict", "--serve_mips_nprobe",
         str(NPROBE), "--serve_mips_nlist", str(NLIST),
         "--serve_mips_crossover", "-1"])
    jm = JaxReleaseModel(jcfg, log=lambda m: None)
    bs = int(meta["serve_batch_size"])
    if crossover == 0:
        assert jm._mips_all
        assert tm.mips_head is None and tm.mips_nprobe == 0
        tm.predict((lines * -(-bs // len(lines)))[:bs], batch_size=bs)
        assert tm.head_dispatches == {"exact": 1, "mips": 0}
        return
    assert (tm.mips_rows, tm._mips_all) == (jm.mips_rows, jm._mips_all)
    if crossover < bs:
        assert tm.mips_rows == crossover and not tm._mips_all
        rows = lines * -(-bs // len(lines))
        tm.predict(rows[:crossover], batch_size=bs)
        tm.predict(rows[:crossover + 1], batch_size=bs)
        assert tm.head_dispatches == {"exact": 1, "mips": 1}
    else:   # MIPS wins every row count: all-MIPS
        assert tm._mips_all and tm.mips_rows == 0
        tm.predict((lines * -(-bs // len(lines)))[:bs], batch_size=bs)
        assert tm.head_dispatches == {"exact": 0, "mips": 1}


def test_export_with_crossover_zero_does_not_calibrate(saved, tmp_path):
    _, base, _ = saved
    meta = _export(base, str(tmp_path / "a"), "--serve_mips_nprobe", "2",
                   "--serve_mips_crossover", "0")
    assert "mips_crossover" not in meta


FLAGS = ["--serve_continuous", "--serve_inflight_steps", "3",
         "--serve_cache_entries", "0", "--extractor_pool_size", "4",
         "--extractor_retries", "1", "--serve_deadline_ms", "500",
         "--serve_deadline_max_ms", "9000", "--serve_queue_depth", "7",
         "--serve_debug_trace", "--metrics_file", "m.prom",
         "--metrics_port", "9123", "--compute_dtype", "float32",
         "--serve_buckets", "8,16", "--topk_block", "128", "-v", "0",
         "--serve_batch_size", "16", "--serve_max_delay_ms", "2.5",
         "--extractor_timeout", "30", "--serve_mips_nprobe", "3",
         "--serve_mips_nlist", "9", "--serve_mips_crossover", "4"]
FIELDS = ("serve", "serve_continuous", "serve_inflight_steps",
          "serve_cache_entries", "extractor_pool_size", "extractor_retries",
          "serve_deadline_ms", "serve_deadline_max_ms", "serve_queue_depth",
          "serve_debug_trace", "metrics_file", "metrics_port",
          "compute_dtype", "serve_buckets", "topk_block_size",
          "verbose_mode", "serve_batch_size", "serve_max_delay_ms",
          "extractor_timeout_s", "serve_mips_nprobe", "serve_mips_nlist",
          "serve_mips_crossover", "model_load_path")


@pytest.mark.parametrize("flags", [[], FLAGS], ids=["defaults", "set"])
def test_serve_flags_parse_to_the_reference_values(saved, flags):
    _, base, _ = saved
    argv = ["serve", "--load", base] + flags
    _, got = cli.config_from_args(argv)
    want = jcli.config_from_args(argv)
    for field in FIELDS:
        assert getattr(got, field) == getattr(want, field), field


def test_bad_serving_values_are_refused(saved, capsys):
    _, base, _ = saved
    for flags, message in ((["--extractor_pool_size", "0"],
                            "extractor_pool_size"),
                           (["--serve_queue_depth", "0"],
                            "serve_queue_depth"),
                           (["--serve_deadline_ms", "50000"],
                            "serve_deadline_ms must not exceed"),
                           (["--serve_inflight_steps", "0"],
                            "serve_inflight_steps"),
                           (["--serve_cache_entries", "-1"],
                            "serve_cache_entries"),
                           (["--extractor_retries", "-1"],
                            "extractor_retries")):
        with pytest.raises(SystemExit):
            cli.config_from_args(["serve", "--load", base] + flags)
        assert message in capsys.readouterr().err
    # --test with the MIPS head stays refused, as in the reference
    with pytest.raises(SystemExit):
        cli.config_from_args(["evaluate", "--load", base, "--test",
                              os.devnull, "--serve_mips_nprobe", "2"])
    assert "--test" in capsys.readouterr().err
