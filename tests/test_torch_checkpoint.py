"""The port's checkpoints on the CPU: the commit, the restore, the crash
safety, rotation and the mismatch refusals (training/checkpoint.py,
model_facade.py).

Models are tiny (tests/test_torch_train.py's synthetic dataset: 13
tokens, 7 paths, 5 targets, dims 128/128/384, M 8, B 16). Save -> load is
held bit for bit: the payload is the tensors' own bits (bf16 moments as
uint16). The crash cases are the single-process subset of
tests/test_chaos.py:89-386: a `raise` armed at each fault point of the
commit (utils/faults.py), and one hard kill (`exit`) of a subprocess.
The refusals are compared with the JAX package's own messages.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from code2vec_tpu.config import Config as JaxConfig
from code2vec_tpu.model_facade import Code2VecModel as JaxModel
from code2vec_tpu.training import checkpoint as jckpt
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.model_facade import Code2VecModel
from code2vec_tpu_torch.training import checkpoint as ckpt
from code2vec_tpu_torch.utils import faults

from test_torch_train import _make_synthetic_dataset

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(prefix, **kw):
    base = dict(train_data_path_prefix=prefix, max_contexts=8,
                train_batch_size=16, num_train_epochs=1,
                shuffle_buffer_size=32, dropout_keep_rate=1.0,
                device="cpu", verbose_mode=0, eval_log_path=None)
    base.update(kw)
    return Config(**base)


def _trained(tmp_path, **kw):
    """A port model trained one epoch (dropout off)."""
    prefix = _make_synthetic_dataset(tmp_path)
    model = Code2VecModel(_config(prefix, **kw))
    model.train()
    return model, prefix


def _leaves(state, with_opt=True):
    """{leaf: a host copy} of a TrainState (ints as they are)."""
    return {k: (v.detach().clone() if isinstance(v, torch.Tensor) else v)
            for k, v in ckpt.state_leaves(state, with_opt).items()}


def _assert_bit_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], torch.Tensor):
            assert got[k].dtype == want[k].dtype, k
            assert torch.equal(got[k].view(torch.int16) if got[k].dtype ==
                               torch.bfloat16 else got[k],
                               want[k].view(torch.int16) if want[k].dtype ==
                               torch.bfloat16 else want[k]), k
        else:
            assert got[k] == want[k], k


@pytest.fixture(autouse=True)
def _disarm():
    faults.reset(None)
    yield
    faults.reset(None)


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    """A trained dense model and one saved epoch checkpoint of it."""
    tmp = tmp_path_factory.mktemp("ckpt-dense")
    model, prefix = _trained(tmp)
    base = str(tmp / "m" / "model")
    os.makedirs(os.path.dirname(base))
    path = ckpt.save_model(base + "_iter1", model.state, model.vocabs,
                           model.config, epoch=1)
    return model, prefix, base, path


# ---------------------------------------------------------------- round trip

@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("moments", ["bfloat16", "float32"])
def test_save_load_bit_equal(tmp_path, sparse, moments):
    model, prefix = _trained(tmp_path, use_sparse_embedding_update=sparse,
                             adam_mu_dtype=moments, adam_nu_dtype=moments)
    path = ckpt.save_model(str(tmp_path / "ck"), model.state, model.vocabs,
                           model.config, epoch=1)
    meta = ckpt.verify_checkpoint(path)
    assert meta["use_sparse_embedding_update"] is sparse
    assert meta["adam_mu_dtype"] == moments and meta["step"] > 0
    fresh = Code2VecModel(_config(prefix, use_sparse_embedding_update=sparse,
                                  adam_mu_dtype=moments,
                                  adam_nu_dtype=moments, model_load_path=path))
    _assert_bit_equal(_leaves(fresh.state), _leaves(model.state))
    assert fresh.initial_epoch == 1
    # numpy alone reads it: bf16 leaves are their uint16 bits
    arrays = ckpt.load_state_arrays(path)
    tree = json.load(open(os.path.join(path, ckpt.MANIFEST_NAME)))[
        "param_tree"]
    for key, x in ckpt.state_leaves(model.state).items():
        if isinstance(x, torch.Tensor):
            np.testing.assert_array_equal(arrays[key], x.detach().float().numpy())
            assert tree[key]["dtype"] == str(x.dtype).split(".")[-1]
        else:
            assert int(arrays[key]) == x
    if sparse:
        assert "opt_state/slots/token_embedding/mu" in tree
        assert "opt_state/dense/mu/transform" in tree


@pytest.mark.parametrize("sparse", [False, True])
def test_resume_from_disk_equals_resume_from_memory(tmp_path, sparse):
    """Epoch 2 from a checkpoint of epoch 1 and from the same state held
    in memory: the same bits."""
    prefix = _make_synthetic_dataset(tmp_path, n_rows=160)
    snap = {}
    cfg = _config(prefix, num_train_epochs=1,
                  use_sparse_embedding_update=sparse,
                  model_save_path=str(tmp_path / "m" / "model"))
    first = Code2VecModel(cfg)
    first.train()
    snap = _leaves(first.state)
    from_disk = Code2VecModel(_config(
        prefix, num_train_epochs=2, use_sparse_embedding_update=sparse,
        model_load_path=str(tmp_path / "m" / "model_iter1")))
    assert from_disk.initial_epoch == 1
    from_disk.train()
    in_memory = Code2VecModel(_config(prefix, num_train_epochs=2,
                                      use_sparse_embedding_update=sparse))
    with torch.no_grad():
        for key, x in ckpt.state_leaves(in_memory.state).items():
            if isinstance(x, torch.Tensor):
                x.copy_(snap[key])
    in_memory.state.step = snap["step"]
    counter = ("opt_state/dense/count" if sparse else "opt_state/count")
    ckpt._set_counter(in_memory.state, counter, snap[counter])
    in_memory.initial_epoch = 1
    in_memory.train()
    assert from_disk.trainer.final_epoch == in_memory.trainer.final_epoch == 2
    assert len(from_disk.trainer.epoch_losses[0]) > 0
    assert from_disk.trainer.epoch_losses == in_memory.trainer.epoch_losses
    _assert_bit_equal(_leaves(from_disk.state), _leaves(in_memory.state))


def test_train_saves_epochs_and_final(tmp_path):
    prefix = _make_synthetic_dataset(tmp_path, n_rows=160)
    base = str(tmp_path / "m" / "model")
    model = Code2VecModel(_config(prefix, num_train_epochs=3,
                                  model_save_path=base, save_every_epochs=2))
    model.train()
    # epoch 2 by the cadence, 3 as the final epoch, and the final save
    assert sorted(os.listdir(tmp_path / "m")) == \
        ["model", "model_iter2", "model_iter3"]
    for name in ("model", "model_iter2", "model_iter3"):
        ckpt.verify_checkpoint(str(tmp_path / "m" / name))
    manifest = ckpt.load_manifest(base + "_iter2")
    assert manifest["data_cursor"] == {"epoch": 2, "global_row_ordinal": 0,
                                       "global_batch_size": 16}
    assert manifest["process_count"] == 1
    assert ckpt.load_model_meta(base)["epoch"] == 3


# -------------------------------------------------------------- crash safety

@pytest.mark.parametrize("hit", [1, 2, 3, 4, 5])
def test_kill_at_each_save_point_keeps_previous(dense, tmp_path, hit):
    model, _, _, _ = dense
    base = str(tmp_path / "model")
    first = ckpt.save_model(base + "_iter1", model.state, model.vocabs,
                            model.config, epoch=1)
    faults.reset(f"save@{hit}=raise")
    with pytest.raises(faults.FaultInjected):
        ckpt.save_model(base + "_iter2", model.state, model.vocabs,
                        model.config, epoch=2)
    assert not os.path.exists(base + "_iter2")
    assert ckpt.latest_valid_checkpoint(base) == first
    assert ckpt.resolve_load_path(base) == first
    faults.reset(None)  # a retry in the same process commits
    second = ckpt.save_model(base + "_iter2", model.state, model.vocabs,
                             model.config, epoch=2)
    assert ckpt.latest_valid_checkpoint(base) == second
    assert not [p for p in os.listdir(tmp_path) if ckpt.is_staging_path(p)]


@pytest.mark.parametrize("point", ["checkpoint_commit", "checkpoint_swap"])
def test_overwrite_swap(dense, tmp_path, point):
    """Overwriting an artifact swaps through `.old-<pid>`; a kill before
    the swap keeps the old one, a kill inside it leaves two intact copies,
    and reclaim promotes the newer into the empty slot."""
    model, prefix, _, _ = dense
    path = str(tmp_path / "model")
    ckpt.save_model(path, model.state, model.vocabs, model.config, epoch=1)
    before = ckpt.load_model_meta(path)["epoch"]
    faults.reset(f"{point}=raise")
    with pytest.raises(faults.FaultInjected):
        ckpt.save_model(path, model.state, model.vocabs, model.config,
                        epoch=7)
    faults.reset(None)
    left = sorted(os.listdir(tmp_path))
    staging = f"model{ckpt.STAGING_INFIX}{os.getpid()}"
    if point == "checkpoint_commit":
        assert left == ["model", staging]
        assert ckpt.load_model_meta(path)["epoch"] == before
    else:
        assert left == [f"model{ckpt.BACKUP_INFIX}{os.getpid()}", staging]
        assert ckpt.reclaim_orphan(str(tmp_path / staging)) == "promoted"
        assert ckpt.load_model_meta(path)["epoch"] == 7
        assert ckpt.reclaim_orphan(str(tmp_path / left[0])) == "removed"
    ckpt.verify_checkpoint(path)
    # a clean overwrite leaves the new artifact alone
    ckpt.save_model(path, model.state, model.vocabs, model.config, epoch=9)
    assert sorted(os.listdir(tmp_path)) == ["model"]
    assert ckpt.load_model_meta(path)["epoch"] == 9


@pytest.mark.parametrize("damage", ["truncate", "delete"])
def test_damaged_state_file_is_named(dense, tmp_path, damage):
    model, prefix, _, path = dense
    copy = str(tmp_path / "model_iter1")
    shutil.copytree(path, copy)
    victim = os.path.join(copy, "state", "params", "transform.npy")
    if damage == "truncate":
        with open(victim, "r+b") as f:
            f.truncate(os.path.getsize(victim) // 2)
    else:
        os.remove(victim)
    with pytest.raises(ckpt.CheckpointIntegrityError, match=victim):
        ckpt.verify_checkpoint(copy)
    fresh = Code2VecModel(_config(prefix))
    with pytest.raises(ckpt.CheckpointIntegrityError, match=victim):
        ckpt.load_model(copy, fresh.state)


def test_staged_files_reach_the_disk_before_the_manifest(dense, tmp_path,
                                                         monkeypatch):
    """A power loss must not leave a manifest that certifies leaves still
    in the page cache: every staged file and directory is fsynced before
    the manifest is written."""
    model, _, _, _ = dense
    synced, seen = set(), []
    fsync = os.fsync

    def recording(fd):
        synced.add(os.path.realpath(f"/proc/self/fd/{fd}"))
        return fsync(fd)

    write_manifest = ckpt._write_manifest

    def checking(base, *args):
        staged = {os.path.realpath(r) for r, _, _ in os.walk(base)}
        staged |= {os.path.realpath(os.path.join(r, n))
                   for r, _, names in os.walk(base) for n in names}
        seen.append(len(staged))
        assert staged <= synced, sorted(staged - synced)
        return write_manifest(base, *args)

    monkeypatch.setattr(os, "fsync", recording)
    monkeypatch.setattr(ckpt, "_write_manifest", checking)
    path = ckpt.save_model(str(tmp_path / "model"), model.state,
                           model.vocabs, model.config, epoch=1)
    assert seen and seen[0] > 10
    ckpt.verify_checkpoint(path)


def test_corrupt_manifest_is_skipped(dense, tmp_path):
    model, _, _, path = dense
    base = str(tmp_path / "model")
    shutil.copytree(path, base + "_iter1")
    ckpt.save_model(base + "_iter2", model.state, model.vocabs, model.config,
                    epoch=2)
    with open(os.path.join(base + "_iter2", ckpt.MANIFEST_NAME), "w") as f:
        f.write("{not json")
    trail = []
    assert ckpt.latest_valid_checkpoint(base, trail=trail) == base + "_iter1"
    assert [t["outcome"] for t in trail] == ["rejected", "selected"]
    assert "corrupt manifest" in trail[0]["reason"]


def test_flipped_bit_in_dictionaries_is_caught(dense, tmp_path):
    _, _, _, path = dense
    copy = str(tmp_path / "model_iter1")
    shutil.copytree(path, copy)
    victim = os.path.join(copy, "dictionaries.bin")
    with open(victim, "r+b") as f:
        f.seek(20)
        byte = f.read(1)
        f.seek(20)
        f.write(bytes([byte[0] ^ 1]))
    with pytest.raises(ckpt.CheckpointIntegrityError, match="sha256"):
        ckpt.verify_checkpoint(copy)


def test_resolve_load_path_base_and_directory(dense, tmp_path):
    model, prefix, _, path = dense
    base = str(tmp_path / "run" / "model")
    os.makedirs(os.path.dirname(base))
    for epoch in (1, 2, 10):
        ckpt.save_model(f"{base}_iter{epoch}", model.state, model.vocabs,
                        model.config, epoch=epoch)
    # the newest by epoch number, not by name
    assert ckpt.resolve_load_path(base) == base + "_iter10"
    assert ckpt.resolve_load_path(base + "_iter2") == base + "_iter2"
    assert ckpt.resolve_load_path(str(tmp_path / "none")) == \
        str(tmp_path / "none")
    loaded = Code2VecModel(_config(prefix, model_load_path=base))
    assert loaded.config.model_load_path == base + "_iter10"
    assert loaded.initial_epoch == 10


def test_rotation_and_orphan_sweep(dense, tmp_path):
    """max_to_keep keeps the newest epochs; the sweep removes a dead
    process's staging directory and never deletes the only artifact that
    verifies."""
    model, prefix, _, _ = dense
    base = str(tmp_path / "model")
    model.config.model_save_path, model.config.max_to_keep = base, 2
    try:
        for epoch in (1, 2, 3):
            ckpt.save_model(f"{base}_iter{epoch}", model.state, model.vocabs,
                            model.config, epoch=epoch)
        dead = f"{base}_iter4{ckpt.STAGING_INFIX}999999999"
        os.makedirs(dead)
        model._rotate_epoch_checkpoints()
        assert sorted(os.listdir(tmp_path)) == ["model_iter2", "model_iter3"]
        # the retained ones corrupt: the newest over-quota one that
        # verifies stays
        for epoch in (2, 3):
            os.remove(os.path.join(f"{base}_iter{epoch}",
                                   ckpt.MANIFEST_NAME))
        ckpt.save_model(f"{base}_iter1", model.state, model.vocabs,
                        model.config, epoch=1)
        model.config.max_to_keep = 1
        model._rotate_epoch_checkpoints()
        assert "model_iter1" in os.listdir(tmp_path)
        assert ckpt.latest_valid_checkpoint(base) == base + "_iter1"
    finally:
        model.config.model_save_path, model.config.max_to_keep = None, 10


def test_hard_kill_of_a_saving_subprocess(dense, tmp_path):
    """C2V_FAULTS=save@3=exit kills a subprocess between the meta and the
    state: the previous artifact stays the latest valid one, and the
    sweep removes the dead process's staging directory."""
    model, prefix, _, path = dense
    base = str(tmp_path / "model")
    shutil.copytree(path, base + "_iter1")
    script = (
        "import sys\n"
        "from code2vec_tpu_torch.config import Config\n"
        "from code2vec_tpu_torch.model_facade import Code2VecModel\n"
        f"m = Code2VecModel(Config(model_load_path={base + '_iter1'!r}, "
        f"device='cpu', verbose_mode=0))\n"
        f"m.save({base + '_iter2'!r})\n")
    env = dict(os.environ, C2V_FAULTS="save@3=exit",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == faults.FAULT_EXIT_CODE, proc.stderr[-2000:]
    staged = [p for p in os.listdir(tmp_path) if ckpt.is_staging_path(p)]
    assert len(staged) == 1 and staged[0].startswith("model_iter2")
    assert ckpt.latest_valid_checkpoint(base) == base + "_iter1"
    model.config.model_save_path = base
    try:
        model._rotate_epoch_checkpoints()
    finally:
        model.config.model_save_path = None
    assert sorted(os.listdir(tmp_path)) == ["model_iter1"]


def test_fault_spec_errors():
    with pytest.raises(faults.FaultSpecError):
        faults.reset("save@x=raise")
    with pytest.raises(faults.FaultSpecError):
        faults.reset("save=explode")
    faults.reset("save@2")
    faults.fault_point("save")
    with pytest.raises(faults.FaultInjected):
        faults.fault_point("save")


# ----------------------------------------------------------------- refusals

def _jax_message(tmp_path, prefix, saved_kw, run_kw):
    """The JAX package's ValueError for loading its own checkpoint saved
    under `saved_kw` into a run with `run_kw`, with its path as {path}."""
    common = dict(train_data_path_prefix=prefix, max_contexts=8,
                  train_batch_size=16, verbose_mode=0, use_packed_data=False)
    jm = JaxModel(JaxConfig(**common, **saved_kw))
    path = str(tmp_path / "jax-ckpt")
    jckpt.save_model(path, jm.state, jm.vocabs, jm.config, epoch=1)
    target = JaxModel(JaxConfig(**common, **run_kw))
    with pytest.raises(ValueError) as e:
        jckpt.load_model(path, target.state, config=target.config)
    return str(e.value).replace(os.path.abspath(path), "{path}")


@pytest.mark.parametrize("saved_kw,run_kw", [
    ({}, {"use_sparse_embedding_update": True}),
    ({"use_sparse_embedding_update": True}, {}),
    ({}, {"adam_mu_dtype": "float32"}),
    ({"adam_nu_dtype": "float32"}, {}),
])
def test_mismatch_refusals_match_reference(tmp_path, saved_kw, run_kw):
    prefix = _make_synthetic_dataset(tmp_path)
    want = _jax_message(tmp_path, prefix, saved_kw, run_kw)
    saved = Code2VecModel(_config(prefix, **saved_kw))
    path = ckpt.save_model(str(tmp_path / "port-ckpt"), saved.state,
                           saved.vocabs, saved.config, epoch=1)
    with pytest.raises(ValueError) as e:
        Code2VecModel(_config(prefix, model_load_path=path, **run_kw))
    assert str(e.value).replace(path, "{path}") == want


@pytest.mark.parametrize("sparse", [False, True])
def test_release_loads_under_either_mode(tmp_path, sparse):
    model, prefix = _trained(tmp_path, use_sparse_embedding_update=sparse)
    path = ckpt.save_model(str(tmp_path / "model"), model.state,
                           model.vocabs, model.config, epoch=1)
    released = Code2VecModel(_config(
        prefix, model_load_path=path, release=True,
        use_sparse_embedding_update=sparse))
    assert released.evaluate() is None
    rel = path + ckpt.RELEASED_SUFFIX
    meta = ckpt.verify_checkpoint(rel)
    assert meta["released"] is True
    assert not any(k.startswith("opt_state") for k in
                   json.load(open(os.path.join(rel, ckpt.MANIFEST_NAME)))[
                       "param_tree"])
    for run_sparse in (False, True):
        other = Code2VecModel(_config(
            prefix, model_load_path=rel,
            use_sparse_embedding_update=run_sparse))
        for k, p in model.state.params.items():
            assert torch.equal(other.state.params[k], p), k
        assert other.state.step == model.state.step
    fresh = Code2VecModel(_config(prefix))
    ckpt.load_model(rel, fresh.state, params_only=True)
    assert torch.equal(fresh.state.params["transform"],
                       model.state.params["transform"])
    # release_model: load params-only and re-save weights-only
    again = ckpt.release_model(path, str(tmp_path / "again"), fresh.state,
                               model.vocabs, model.config)
    assert again == str(tmp_path / "again") + ckpt.RELEASED_SUFFIX
    assert ckpt.load_model_meta(again)["released"] is True
    assert sorted(ckpt.load_manifest(again)["param_tree"]) == \
        sorted(ckpt.load_manifest(rel)["param_tree"])
