"""The port's ReleaseModel takes the artifact's serve_batch_size as the
JAX ReleaseModel does (code2vec_tpu/release/runtime.py:275-300).

A tiny JAX model serves with 4 rows, so its int8 artifact records
serve_batch_size 4. Served with the DEFAULT config of each package (64,
no --serve_batch_size given) and a MIPS crossover of 8, both adopt 4:
every batch is at or under the crossover, so the MIPS head takes all of
them, and a 12-method predict gives the same top-k words in both. An
explicit size, even the default 64, is kept by both, and the CLI marks
the flag explicit only when it was given.

Tolerances: the words exactly; scores as tests/test_torch_release.py's
BF16 (atol 2e-2, rtol 1e-2: bf16 contexts and attention).
"""

import numpy as np
import pytest
import torch

from code2vec_tpu.config import Config as JaxConfig
from code2vec_tpu.release import artifact as jart
from code2vec_tpu.release.runtime import ReleaseModel as JaxReleaseModel
from code2vec_tpu_torch import cli
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.release.runtime import ReleaseModel

from test_torch_release import BF16, _tiny_jax_model

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

MIPS = dict(serve=True, serve_mips_nprobe=1, serve_mips_nlist=8,
            serve_mips_crossover=8)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch-serve-batch")
    model = _tiny_jax_model(tmp)
    art = str(tmp / "artifact")
    jart.export_artifact(model, art, aot=False, log=lambda m: None)
    with open(model.config.train_data_path) as f:
        lines = f.read().splitlines()[:12]
    return art, lines


def _jax_model(art, **kw):
    return JaxReleaseModel(JaxConfig(serve_artifact=art, verbose_mode=0,
                                     **MIPS, **kw), log=lambda m: None)


def _torch_model(art, **kw):
    return ReleaseModel(Config(serve_artifact=art, device="cpu",
                               verbose_mode=0, **MIPS, **kw))


def test_default_config_adopts_the_artifacts_size(artifact):
    art, lines = artifact
    jm, tm = _jax_model(art), _torch_model(art)
    assert jm.meta["serve_batch_size"] == 4
    assert tm.config.serve_batch_size == jm.config.serve_batch_size == 4
    # crossover 8 at or above 4 rows: all-MIPS in both
    assert tm._mips_all and jm._mips_all
    assert "target_embedding" not in tm.params
    want = jm.predict(lines)
    got = tm.predict(lines)
    assert tm.head_dispatches == {"exact": 0, "mips": 3}
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert g.topk_predicted_words == w.topk_predicted_words
        np.testing.assert_allclose(g.topk_predicted_words_scores,
                                   w.topk_predicted_words_scores, **BF16)


def test_explicit_size_wins_even_at_the_default(artifact):
    art, lines = artifact
    knobs = ("serve_batch_size",)
    jm = _jax_model(art, serve_batch_size=64, explicit_knobs=knobs)
    tm = _torch_model(art, serve_batch_size=64, explicit_knobs=knobs)
    assert tm.config.serve_batch_size == jm.config.serve_batch_size == 64
    # 12 rows above the crossover of 8: the exact head, in one batch
    assert not tm._mips_all and tm.mips_rows == 8
    assert not jm._mips_all and jm.mips_rows == 8
    tm.predict(lines)
    assert tm.head_dispatches == {"exact": 1, "mips": 0}


def test_cli_marks_the_flag_explicit_only_when_given(artifact):
    art, _ = artifact
    _, config = cli.config_from_args(["serve", "--artifact", art,
                                      "--device", "cpu"])
    assert "serve_batch_size" not in config.explicit_knobs
    assert ReleaseModel(config).config.serve_batch_size == 4
    _, config = cli.config_from_args(["serve", "--artifact", art,
                                      "--device", "cpu",
                                      "--serve_batch_size", "64",
                                      "--epochs", "2"])
    assert config.explicit_knobs == ("num_train_epochs", "serve_batch_size")
    assert ReleaseModel(config).config.serve_batch_size == 64
