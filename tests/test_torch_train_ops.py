"""The training loop's operations against the JAX package, on the CPU.

Preemption (SIGTERM, and the RSS watchdog) and the data cursor's resume
on both readers, a second preemption inside the resumed epoch, the
`_nanhalt` save, the mid-epoch evaluation, the heartbeat, the progress
line, the registry's training metrics, the TensorBoard event writer, the
async commit and the fault points around it, the content hash, the new
fields and the profiler hook; and one real SIGTERM to a `python -m
code2vec_tpu_torch train` process, which then resumes.

Both packages get the same numpy inputs: the synthetic dataset of
tests/test_torch_train.py and the JAX facade's initial parameters
(`params_from_jax`). Where both train, dropout is off and both compute in
float32, so the resumed losses hold to rtol 1e-2 (ROADMAP's bf16 bar;
f32 holds far tighter) and their evaluations give equal log lines. The
loop's own tests drive each package's Trainer with a fake step that
returns chosen losses, so they compare the loop alone.

Every test runs under a time limit of its own (`_limit`: SIGALRM, the
tests run on the main thread), and so do the module fixtures.
"""

import contextlib
import functools
import glob
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax

from code2vec_tpu import obs as jobs
from code2vec_tpu.config import Config as JaxConfig
from code2vec_tpu.data import preprocess as jpp
from code2vec_tpu.data.reader import EpochEnd as JaxEpochEnd
from code2vec_tpu.data.reader import RowBatch as JaxRowBatch
from code2vec_tpu.model_facade import Code2VecModel as JaxModel
from code2vec_tpu.obs import exporters as jexporters
from code2vec_tpu.training import checkpoint as jckpt
from code2vec_tpu.training import loop as jloop
from code2vec_tpu.utils import faults as jfaults
from code2vec_tpu.utils import tb as jtb
from code2vec_tpu_torch import obs
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.data import preprocess as pp
from code2vec_tpu_torch.data.reader import EpochEnd, RowBatch
from code2vec_tpu_torch.model_facade import Code2VecModel
from code2vec_tpu_torch.obs import exporters
from code2vec_tpu_torch.training import checkpoint as ckpt
from code2vec_tpu_torch.training import loop
from code2vec_tpu_torch.utils import faults
from code2vec_tpu_torch.utils import tb
from code2vec_tpu_torch.weights import params_from_jax

import chaos_child
from test_torch_train import _make_synthetic_dataset

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 16               # the train batch
STEPS = 10           # batches an epoch: 160 rows of the synthetic dataset
PREEMPT_AT = 13      # SIGTERM after the third batch of epoch 2
SECOND_AT = 2        # and again after the resumed run's second batch
LOSS_RTOL = 1e-2
COMMON = dict(max_contexts=8, train_batch_size=B, test_batch_size=B,
              shuffle_buffer_size=32, dropout_keep_rate=1.0, verbose_mode=0,
              compute_dtype="float32", num_batches_to_log_progress=1000)
# the checkpoint family the port names for what it does: the reference's
# time of Orbax's flush is the port's write and flush of the state files
RENAMED = {"checkpoint_orbax_flush_seconds": "checkpoint_state_write_seconds"}
PREFIXES = ("train_", "checkpoint_", "eval_", "prefetch_", "data_",
            "preprocess_")


# ------------------------------------------------------------ time limits

@contextlib.contextmanager
def _deadline(seconds: float, what: str):
    def expired(signum, frame):
        raise TimeoutError(f"{what} exceeded its limit of {seconds} s")
    prev = signal.signal(signal.SIGALRM, expired)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, prev)


def _limit(seconds: float):
    """Fail the test when it runs longer than `seconds`."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            with _deadline(seconds, fn.__name__):
                return fn(*args, **kw)
        return run
    return wrap


@pytest.fixture(autouse=True)
def _disarm_faults():
    yield
    faults.reset(None)
    jfaults.reset(None)


# ---------------------------------------------------------------- facades

def _port_config(prefix, **kw):
    return Config(**{"train_data_path_prefix": prefix, "device": "cpu",
                     "eval_log_path": None, **COMMON, **kw})


def _jax_config(prefix, **kw):
    return JaxConfig(**{"train_data_path_prefix": prefix, **COMMON, **kw})


def _facade(pkg, prefix, init=None, **kw):
    """The `pkg` facade; a fresh port model starts from `init` (the JAX
    facade's initial parameters)."""
    if pkg == "jax":
        return JaxModel(_jax_config(prefix, **kw))
    model = Code2VecModel(_port_config(prefix, **kw))
    if init is not None and "model_load_path" not in kw:
        model.module.load_state_dict(params_from_jax(init))
    return model


def _recording(builder, batches, losses, sigterm_at=None):
    """Wrap builder.make_train_step: record each step's ids and loss, and
    send SIGTERM from the step (the consumer side, at a fixed consumed
    step) after step `sigterm_at`."""
    make = builder.make_train_step

    def make_recording(state):
        step = make(state)

        def run(state, *arrays):
            batches.append([np.asarray(a) for a in arrays[:5]])
            state, loss = step(state, *arrays)
            losses.append(float(loss))
            if len(losses) == sigterm_at:
                os.kill(os.getpid(), signal.SIGTERM)
            return state, loss
        return run

    builder.make_train_step = make_recording


def _train(model, sigterm_at=None):
    """(batches, losses, the epoch the model had trained before)."""
    batches, losses = [], []
    _recording(model.builder, batches, losses, sigterm_at)
    loaded = model.initial_epoch
    model.train()
    return batches, losses, loaded


def _ckpt(pkg):
    return jckpt if pkg == "jax" else ckpt


def _cursor(pkg, path):
    return _ckpt(pkg).load_manifest(path)["data_cursor"]


def _copy_dataset(prefix, dst):
    """The dataset under `dst` (each package packs its own `.c2vb`)."""
    os.makedirs(dst, exist_ok=True)
    out = os.path.join(dst, os.path.basename(prefix))
    for suffix in (".train.c2v", ".dict.c2v"):
        shutil.copy(prefix + suffix, out + suffix)
    return out


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The synthetic dataset (160 trainable rows), a labelled test file
    of its lines, and the JAX facade's initial parameters."""
    tmp = tmp_path_factory.mktemp("train_ops")
    prefix = _make_synthetic_dataset(tmp, n_rows=160)
    test = str(tmp / "test.c2v")
    with open(prefix + ".train.c2v") as f:
        lines = f.readlines()
    with open(test, "w") as f:
        f.writelines(lines[:37] + lines[-2:])
    init = jax.device_get(JaxModel(_jax_config(prefix)).state.params)
    return tmp, prefix, test, init


# ------------------------------------------- preemption and cursor resume

@pytest.fixture(scope="module", params=[True, False], ids=["packed", "text"])
def preempted(request, data):
    """Each package, from the same parameters: `train --save B` of 2
    epochs preempted by SIGTERM after step PREEMPT_AT; `train --load B`
    preempted again after its step SECOND_AT; `train --load B` to the
    end. The port also trains 2 epochs unbroken, and resumes once with
    the `cursor_remap` fault armed. Per package: {run: (batches, losses,
    model)} and what the artifacts held in between."""
    tmp, prefix, _, init = data
    packed = request.param
    out = {"packed": packed}
    with _deadline(150, "the preemption runs"):
        for pkg in ("jax", "port"):
            pfx = _copy_dataset(prefix, str(tmp / f"{request.param_index}"
                                            f"-{pkg}"))
            base = pfx + "-model"
            kw = dict(num_train_epochs=2, model_save_path=base,
                      use_packed_data=packed)
            rec = out[pkg] = {"base": base}
            first = _facade(pkg, pfx, init, **kw)
            rec["first"] = _train(first, PREEMPT_AT) + (first,)
            # a preempted run skips its final save
            rec["final_save"] = os.path.exists(base)
            rec["cursor1"] = _cursor(pkg, base + "_iter1_preempt")
            rec["resolved"] = _ckpt(pkg).resolve_load_path(base)
            if pkg == "port":
                manifest = base + "_iter1_preempt/" + ckpt.MANIFEST_NAME
                with open(manifest, "rb") as f:
                    before = f.read()
                faults.reset("cursor_remap=raise")
                try:
                    with pytest.raises(faults.FaultInjected):
                        _facade(pkg, pfx, model_load_path=base, **kw).train()
                finally:
                    faults.reset(None)
                with open(manifest, "rb") as f:
                    rec["remap_kept"] = f.read() == before
                ckpt.verify_checkpoint(base + "_iter1_preempt",
                                       check_content=True)
            second = _facade(pkg, pfx, model_load_path=base, **kw)
            rec["second"] = _train(second, SECOND_AT) + (second,)
            rec["cursor2"] = _cursor(pkg, base + "_iter1_preempt")
            third = _facade(pkg, pfx, model_load_path=base, **kw)
            rec["third"] = _train(third) + (third,)
            rec["left"] = sorted(os.path.basename(p)
                                 for p in glob.glob(base + "*"))
            if pkg == "port":
                unbroken = _facade(pkg, pfx, init, num_train_epochs=2,
                                   use_packed_data=packed)
                rec["unbroken"] = _train(unbroken)
    return out


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@_limit(180)
def test_preempt_cursor_and_load_path_match_jax(preempted):
    """SIGTERM after step 13 (epoch 2, batch 3): both packages leave the
    run with `_iter1_preempt` holding the same cursor, after the same
    batches, and `--load <base>` resolves to it. From the packed reader
    the cursor is the 48 rows of epoch 2; the text reader's shuffle
    buffer moves the epoch's end past the pass (see
    test_resume_continues_the_unbroken_epoch)."""
    assert preempted["port"]["cursor1"] == preempted["jax"]["cursor1"]
    if preempted["packed"]:
        assert preempted["port"]["cursor1"] == {
            "epoch": 1, "global_row_ordinal": (PREEMPT_AT - STEPS) * B,
            "global_batch_size": B}
    for pkg in ("jax", "port"):
        rec = preempted[pkg]
        assert not rec["final_save"]
        assert rec["cursor1"]["global_row_ordinal"] % B == 0
        assert rec["resolved"] == os.path.abspath(rec["base"]
                                                  + "_iter1_preempt")
        assert not os.path.exists(rec["base"] + "_iter1_nanhalt")
    jb, jl = preempted["jax"]["first"][:2]
    pb, pl = preempted["port"]["first"][:2]
    assert len(pb) == PREEMPT_AT
    assert preempted["port"]["first"][3].trainer.preempted
    _assert_batches_equal(pb, jb)
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)


@_limit(180)
def test_resumed_batches_and_losses_match_jax(preempted):
    """The two resumed runs of each package (cut again after 2 batches,
    then to the end) take the rest of epoch 2: the same batches array for
    array, the same losses, the same epoch numbering, and the same
    artifacts left (the clean `_iter2` supersedes `_iter1_preempt`)."""
    got, want = preempted["port"], preempted["jax"]
    for run in ("second", "third"):
        assert got[run][2] == want[run][2] == 1
        assert got[run][3].config.model_load_path.endswith("_preempt")
        assert want[run][3].config.model_load_path.endswith("_preempt")
    pb = got["second"][0] + got["third"][0]
    jb = want["second"][0] + want["third"][0]
    if preempted["packed"]:
        assert len(pb) == 2 * STEPS - PREEMPT_AT
    _assert_batches_equal(pb, jb)
    np.testing.assert_allclose(got["second"][1] + got["third"][1],
                               want["second"][1] + want["third"][1],
                               rtol=LOSS_RTOL)
    assert got["third"][3].trainer.final_epoch == 2
    assert got["left"] == want["left"]
    assert not any(p.endswith("_preempt") for p in got["left"])


@_limit(180)
def test_second_preemption_records_summed_cursor(preempted):
    """A preemption inside the resumed epoch records the rows skipped at
    resume plus the rows it trained (the trainer counts from 0)."""
    assert preempted["port"]["cursor2"] == preempted["jax"]["cursor2"]
    first = preempted["port"]["cursor1"]
    assert preempted["port"]["cursor2"] == dict(
        first, global_row_ordinal=first["global_row_ordinal"]
        + SECOND_AT * B)


@_limit(180)
def test_resume_continues_the_unbroken_epoch(preempted):
    """From the packed reader the port's three cut runs train exactly the
    batches of one unbroken run, in its order: nothing skipped, nothing
    read twice. The text reader (--no_packed_data) resumes as the
    reference's does: its cursor counts the rows since the EpochEnd
    marker, which the shuffle buffer (32 lines here) moves past the end
    of the pass, while the resumed stream starts from the epoch's own
    pass; so the cut runs miss the buffer's rows (ROADMAP Queue 3)."""
    rec = preempted["port"]
    cut = rec["first"][0] + rec["second"][0] + rec["third"][0]
    unbroken = rec["unbroken"][0]
    if preempted["packed"]:
        _assert_batches_equal(cut, unbroken)
    else:
        assert len(cut) == len(unbroken) - 32 // B
        _assert_batches_equal(cut[:PREEMPT_AT], unbroken[:PREEMPT_AT])


@_limit(180)
def test_cursor_remap_kill_leaves_artifact_restorable(preempted):
    """A kill where the resume applies the saved cursor leaves the
    artifact untouched: it verifies and the next resume takes it."""
    rec = preempted["port"]
    assert rec["remap_kept"]
    assert rec["second"][3].resume_report["restored_step"] == PREEMPT_AT


@_limit(90)
def test_no_cursor_resume_reruns_the_epoch_as_jax(data, tmp_path):
    """With cursor_resume off, `--load <base>` still takes
    `_iter1_preempt` but trains its epoch from the start: the whole epoch
    2 of the permutation, its first batches those the preempted run had
    trained, the same batches and log line as the reference's."""
    _, prefix, _, init = data
    out = {}
    with _deadline(80, "the cursor_resume=False runs"):
        for pkg in ("jax", "port"):
            pfx = _copy_dataset(prefix, str(tmp_path / pkg))
            kw = dict(num_train_epochs=2, model_save_path=pfx + "-model")
            cut = _train(_facade(pkg, pfx, init, **kw), PREEMPT_AT)[0]
            model = _facade(pkg, pfx, model_load_path=pfx + "-model",
                            cursor_resume=False, **kw)
            logs = []
            model.log = model.config.log = logs.append
            again = _train(model)[0]
            assert model.config.model_load_path.endswith("_iter1_preempt")
            out[pkg] = (cut, again, [m for m in logs
                                     if m.startswith("cursor_resume")])
    _assert_batches_equal(out["port"][1], out["jax"][1])
    cut, again, said = out["port"]
    assert len(again) == STEPS
    _assert_batches_equal(again[:PREEMPT_AT - STEPS], cut[STEPS:])
    assert said == out["jax"][2] and len(said) == 1


# ------------------------------------------------ the loop, fake steps

class _State:
    step = 0


def _fake_batches(pkg, epochs, per_epoch, n=2, m=4):
    row_batch, epoch_end = ((JaxRowBatch, JaxEpochEnd) if pkg == "jax"
                            else (RowBatch, EpochEnd))
    for e in range(epochs):
        for _ in range(per_epoch):
            yield row_batch(
                source_token_indices=np.ones((n, m), np.int32),
                path_indices=np.ones((n, m), np.int32),
                target_token_indices=np.ones((n, m), np.int32),
                context_valid_mask=np.ones((n, m), np.float32),
                target_index=np.ones((n,), np.int32),
                example_valid=np.ones((n,), bool))
        yield epoch_end(e + 1)


def _loop_config(pkg, **kw):
    fields = {**dict(train_data_path_prefix="x", max_contexts=4,
                     train_batch_size=2, num_train_epochs=2,
                     verbose_mode=0), **kw}
    return JaxConfig(**fields) if pkg == "jax" else Config(**fields)


def _run_loop(pkg, losses, epochs=2, per_epoch=4, raise_at=None,
              sigterm_at=None, step_hook=None, config_kw=None,
              **trainer_kw):
    """Each package's Trainer over fake batches: step k returns
    losses[k - 1]. Returns (trainer, saves, logs, raised)."""
    config = _loop_config(pkg, **(config_kw or {}))
    logs, saves, count = [], [], [0]
    config.log = logs.append

    def step(state, *args):
        count[0] += 1
        if step_hook is not None:
            step_hook(count[0])
        if count[0] == raise_at:
            raise KeyError("poisoned batch layout")
        if count[0] == sigterm_at:
            os.kill(os.getpid(), signal.SIGTERM)
        x = losses[count[0] - 1]
        return state, (np.float32(x) if pkg == "jax"
                       else torch.tensor(x, dtype=torch.float32))

    def save_fn(state, epoch, suffix="", cursor_rows=0):
        saves.append((epoch, suffix, cursor_rows))

    batches = _fake_batches(pkg, epochs, per_epoch)
    if pkg == "jax":
        trainer = jloop.Trainer(config, step, save_fn=save_fn, **trainer_kw)
        seed = np.zeros((2,), np.uint32)
    else:
        trainer = loop.Trainer(config, step, "cpu", save_fn=save_fn,
                               **trainer_kw)
        seed = 0
    raised = None
    try:
        trainer.train(_State(), batches, seed)
    except Exception as e:  # noqa: BLE001 - compared across packages
        raised = e
    return trainer, saves, logs, raised


def _both(**kw):
    return {pkg: _run_loop(pkg, **kw) for pkg in ("jax", "port")}


def _numbers_out(line: str) -> str:
    return re.sub(r"\d+(\.\d+)?", "#", line)


@_limit(30)
@pytest.mark.parametrize("policy", ["halt", "warn"])
def test_nonfinite_loss_policies_match_jax(policy):
    """A NaN from step 3, seen at the log boundary of step 4: `halt` saves
    the state under `_nanhalt` through the preemption path (cursor 4
    batches) and raises; `warn` logs and trains on. The same saves and
    the same log line in both packages."""
    losses = [1.0, 1.0] + [float("nan")] * 6
    runs = _both(losses=losses, config_kw=dict(
        num_batches_to_log_progress=2, on_nonfinite_loss=policy))
    (jt, jsaves, jlogs, jerr), (pt, psaves, plogs, perr) = \
        runs["jax"], runs["port"]
    assert psaves == jsaves
    nonfinite = [[m for m in logs if m.startswith("Non-finite")]
                 for logs in (jlogs, plogs)]
    assert nonfinite[0] == nonfinite[1] and nonfinite[1]
    if policy == "halt":
        assert psaves == [(0, "_nanhalt", 4 * 2)]
        assert type(jerr).__name__ == type(perr).__name__ == \
            "NonFiniteLossError"
        assert str(perr) == str(jerr)
        assert pt.preempted and jt.preempted
        for mod in (jckpt, ckpt):
            assert mod.parse_iter_name("m_iter0_nanhalt") is None
    else:
        assert jerr is None and perr is None
        assert psaves == [(1, "", 0), (2, "", 0)]
        assert not pt.preempted


@_limit(60)
def test_nanhalt_artifact_is_invisible_to_resume(data, tmp_path):
    """The port facade's `_nanhalt` save: a halted run leaves
    `<save>_iter1_nanhalt`, which verifies for post-mortem, while `--load
    <save>` resumes the last clean artifact."""
    _, prefix, _, init = data
    base = str(tmp_path / "model")
    model = _facade("port", _copy_dataset(prefix, str(tmp_path / "d")),
                    init, num_train_epochs=2, model_save_path=base,
                    num_batches_to_log_progress=2)
    make = model.builder.make_train_step

    def poisoned(state):
        step = make(state)
        count = [0]

        def run(state, *arrays):
            count[0] += 1
            state, loss = step(state, *arrays)
            return state, loss * float("nan") if count[0] > 12 else loss
        return run

    model.builder.make_train_step = poisoned
    with pytest.raises(loop.NonFiniteLossError):
        model.train()
    assert ckpt.verify_checkpoint(base + "_iter1_nanhalt")["epoch"] == 1
    assert _cursor("port", base + "_iter1_nanhalt")["global_row_ordinal"] \
        == 4 * B
    assert ckpt.resolve_load_path(base) == os.path.abspath(base + "_iter1")
    assert not os.path.exists(base)


@_limit(30)
@pytest.mark.parametrize("limit_gb", [1e-6, 0.0])
def test_rss_limit_matches_jax(limit_gb):
    """An RSS limit below the process's resident memory stops the run at
    its first step through the preemption save; the default (0) never
    does."""
    runs = _both(losses=[1.0] * 8, config_kw=dict(rss_limit_gb=limit_gb))
    (jt, jsaves, jlogs, _), (pt, psaves, plogs, _) = runs["jax"], \
        runs["port"]
    assert psaves == jsaves
    assert pt.preempted == jt.preempted == (limit_gb > 0)
    tripped = [[_numbers_out(m) for m in logs if m.startswith("Host RSS")]
               for logs in (jlogs, plogs)]
    assert tripped[0] == tripped[1]
    if limit_gb:
        assert psaves == [(0, "_preempt", 2)] and tripped[1]
    else:
        assert psaves == [(1, "", 0), (2, "", 0)] and not tripped[1]


@_limit(30)
@pytest.mark.parametrize("stop_at", [1, None])
def test_stop_fn_stops_after_an_epoch_as_jax(stop_at):
    """`stop_fn`, asked after each epoch-end save and evaluation, ends the
    run when it first says True (after epoch 1), and otherwise never: the
    same saves, epochs and log lines in both packages."""
    runs = {}
    for pkg in ("jax", "port"):
        asked = []

        def stop_fn(asked=asked):
            asked.append(True)
            return len(asked) == stop_at
        runs[pkg] = _run_loop(pkg, losses=[1.0] * 12, epochs=3,
                              config_kw=dict(num_train_epochs=3),
                              stop_fn=stop_fn) + (len(asked),)
    (jt, jsaves, jlogs, jerr, jasked), (pt, psaves, plogs, perr, pasked) = \
        runs["jax"], runs["port"]
    assert jerr is None and perr is None
    assert psaves == jsaves and pasked == jasked
    assert pt.final_epoch == jt.final_epoch
    early = [[m for m in logs if m.startswith("Early stopping")]
             for logs in (jlogs, plogs)]
    assert early[0] == early[1]
    if stop_at:
        assert psaves == [(1, "", 0)] and early[1] == [
            "Early stopping after epoch 1"]
    else:
        assert psaves == [(1, "", 0), (2, "", 0), (3, "", 0)]
        assert pasked == 3 and not early[1]
    assert not pt.preempted


@_limit(30)
@pytest.mark.parametrize("enabled", [True, False])
def test_save_on_preemption_installs_handler_or_none(enabled):
    """`save_on_preemption` installs the SIGTERM watcher for the loop and
    restores the previous handler after it; off, the handler is never
    touched."""
    seen = {}
    for pkg in ("jax", "port"):
        prev = signal.getsignal(signal.SIGTERM)
        during = []
        _run_loop(pkg, losses=[1.0] * 8,
                  step_hook=lambda k: during.append(
                      signal.getsignal(signal.SIGTERM)),
                  config_kw=dict(save_on_preemption=enabled))
        assert signal.getsignal(signal.SIGTERM) == prev
        seen[pkg] = {getattr(h, "__name__", h) for h in during}
        assert (prev not in during) == enabled
    assert seen["jax"] == seen["port"]


@_limit(30)
@pytest.mark.parametrize("case", ["done", "preempted", "error"])
def test_heartbeats_match_jax(case, tmp_path, monkeypatch):
    """The heartbeats of a clean run, a SIGTERM and a crash: the same
    sequence of statuses, steps, epochs and losses, and files with the
    same keys (the times, the pid and the RSS aside); a crash also names
    its exception's class and message."""
    beats = {}
    for pkg, mod in (("jax", jexporters), ("port", exporters)):
        seen = beats[pkg] = []
        write = mod.write_heartbeat

        def recording(path, write=write, seen=seen, **fields):
            seen.append(fields)
            return write(path, **fields)

        monkeypatch.setattr(mod, "write_heartbeat", recording)
        hb = str(tmp_path / f"{pkg}.json")
        _, _, _, raised = _run_loop(
            pkg, losses=[2.0, 1.0, 0.5, 0.25] * 2,
            raise_at=3 if case == "error" else None,
            sigterm_at=6 if case == "preempted" else None,
            config_kw=dict(heartbeat_file=hb, num_batches_to_log_progress=2),
            heartbeat_extra={"resume_mode": "fresh", "restored_step": None})
        assert (raised is not None) == (case == "error")
        with open(hb) as f:
            seen.append(("file", sorted(json.load(f))))
    timing = ("wall_time", "pid", "rss_bytes", "examples_per_sec")

    def stable(beat):
        if isinstance(beat, tuple):
            return beat
        return {k: v for k, v in beat.items() if k not in timing}

    assert [stable(b) for b in beats["port"]] == \
        [stable(b) for b in beats["jax"]]
    last = beats["port"][-2]
    assert last["status"] == case
    if case == "error":
        assert last["error_type"] == "KeyError"
        assert "poisoned batch layout" in last["error_message"]


@_limit(30)
def test_progress_line_matches_jax():
    """The reference's progress line word for word: the loss, the batch,
    the epoch's ETA and the host breakdown (the measured seconds and
    rates aside)."""
    runs = _both(losses=[2.0, 1.0, 0.5, 0.25] * 2, steps_per_epoch_hint=4,
                 config_kw=dict(num_batches_to_log_progress=2))
    lines = {pkg: [m for m in r[2] if m.startswith("Average loss")]
             for pkg, r in runs.items()}
    assert len(lines["port"]) == 4
    assert [_numbers_out(m) for m in lines["port"]] == \
        [_numbers_out(m) for m in lines["jax"]]
    assert [m.split("\t")[0] for m in lines["port"]] == \
        [m.split("\t")[0] for m in lines["jax"]]


@_limit(60)
def test_profiler_trace_covers_batches_10_to_20(tmp_path):
    """`profile_dir`: a torch.profiler Chrome trace of batches 10-20; a
    raise inside that window still closes the profiler."""
    def marked(k):
        with torch.profiler.record_function("fake_step"):
            pass

    trainer, _, logs, _ = _run_loop(
        "port", losses=[1.0] * 25, epochs=1, per_epoch=25, step_hook=marked,
        profile_dir=str(tmp_path / "trace"))
    traces = glob.glob(str(tmp_path / "trace" / "*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert names.count("fake_step") == 11
    assert any(m.startswith("Wrote profiler trace to") for m in logs)
    _, _, _, raised = _run_loop(
        "port", losses=[1.0] * 25, epochs=1, per_epoch=25, raise_at=14,
        profile_dir=str(tmp_path / "crash"))
    assert isinstance(raised, KeyError)
    assert glob.glob(str(tmp_path / "crash" / "*.json"))
    with torch.profiler.profile() as prof:   # nothing was left open
        torch.ones(2).sum()
    assert prof.key_averages()


# ------------------------------------------ evaluation cadence and metrics

def _gauges(registry):
    return [(name, key, child)
            for name, children in registry.collect().items()
            for key, child in children.items()
            if type(child).__name__ == "Gauge"]


def _touched(registry, run):
    """Run `run()`; the names of `registry`'s metrics it fetched, changed
    or set (gauges are marked NaN first and restored where untouched),
    and the deltas of its counters' values and histograms' counts,
    {(name, labels): delta}."""
    fetched = set()
    get = registry._get

    def recording_get(kind, name, *args, **kw):
        fetched.add(name)
        return get(kind, name, *args, **kw)

    def values():
        return {(name, key): (child.count if hasattr(child, "count")
                              else child.value)
                for name, children in registry.collect().items()
                for key, child in children.items()}

    marked = [(g, g.value) for _, _, g in _gauges(registry)]
    for g, _ in marked:
        g.set(float("nan"))
    before = values()
    registry._get = recording_get
    try:
        run()
    finally:
        del registry._get
    after = values()
    for g, old in marked:
        if math.isnan(g.value):
            g.set(old)
    changed = {name for (name, key), v in after.items()
               if (name, key) not in before or not (
                   v == before[(name, key)] or (
                       isinstance(v, float) and math.isnan(v)
                       and math.isnan(before[(name, key)])))}
    deltas = {(name, key): v - before.get((name, key), 0)
              for (name, key), v in after.items()
              if name.endswith("_total") or isinstance(v, int)}
    return fetched | changed, deltas


@pytest.fixture(scope="module")
def cadence(data):
    """Each package's facade, from the same parameters: `train --save
    --test --tensorboard` of 2 epochs with an evaluation every 4 batches;
    the labels its evaluations logged, the final eval log, the decoded
    train/ and eval/ scalars, and the registry names and deltas it
    added."""
    tmp, prefix, test, init = data
    out = {}
    with _deadline(120, "the cadence runs"):
        for pkg, registry in (("jax", jobs.default_registry()),
                              ("port", obs.default_registry())):
            pfx = _copy_dataset(prefix, str(tmp / f"cadence-{pkg}"))
            kw = dict(num_train_epochs=2, model_save_path=pfx + "-model",
                      test_data_path=test, num_train_batches_to_evaluate=4,
                      num_batches_to_log_progress=5, use_tensorboard=True)
            if pkg == "port":   # the JAX facade's is log.txt in the cwd
                kw["eval_log_path"] = "log.txt"
            model = _facade(pkg, pfx, init, **kw)
            logs = []
            model.config.log = logs.append
            cwd = os.getcwd()
            os.chdir(os.path.dirname(pfx))
            try:
                names, deltas = _touched(registry, model.train)
            finally:
                os.chdir(cwd)
            with open(os.path.join(os.path.dirname(pfx), "log.txt")) as f:
                eval_log = f.read().splitlines()
            events = glob.glob(pfx + "-model_tb/events.out.tfevents.*")
            assert len(events) == 1
            scalars = [s for s in tb.read_scalars(events[0])
                       if s[0].startswith(("train/", "eval/"))]
            out[pkg] = dict(
                labels=[m.split(" -- ")[0] for m in logs if " -- " in m],
                eval_log=eval_log, scalars=scalars, deltas=deltas,
                names={RENAMED.get(n, n) for n in names
                       if n.startswith(PREFIXES)},
                mid=([b for b, _ in model.trainer.mid_epoch_results]
                     if pkg == "port" else None))
    return out


@_limit(150)
def test_mid_epoch_evaluation_matches_jax(cadence):
    """An evaluation every 4 batches, the count restarting at each epoch,
    beside the epoch-end ones: the same labels in the same order, and the
    last evaluation's log lines equal."""
    want = ["Mid-epoch (batch 4) evaluation", "Mid-epoch (batch 8) "
            "evaluation", "After 1 epochs", "Mid-epoch (batch 14) "
            "evaluation", "Mid-epoch (batch 18) evaluation",
            "After 2 epochs"]
    assert cadence["port"]["labels"] == cadence["jax"]["labels"] == want
    assert cadence["port"]["mid"] == [4, 8, 14, 18]
    assert cadence["port"]["eval_log"] == cadence["jax"]["eval_log"]
    assert cadence["port"]["eval_log"]


@_limit(150)
def test_tensorboard_scalars_match_jax(cadence):
    """`--tensorboard`: the trainer's train/ and eval/ scalars, the same
    tags at the same steps in both packages' event files, values within
    the f32 training's spread."""
    got, want = cadence["port"]["scalars"], cadence["jax"]["scalars"]
    assert [(t, s) for t, s, _ in got] == [(t, s) for t, s, _ in want]
    assert {t for t, _, _ in got} >= {"train/loss", "eval/subtoken_f1"}
    def values(scalars):   # the throughput is the host's, not compared
        return [v for t, _, v in scalars if t != "train/examples_per_sec"]

    np.testing.assert_allclose(values(got), values(want), rtol=LOSS_RTOL,
                               atol=1e-6)


@_limit(150)
def test_registry_metrics_match_jax(cadence):
    """The train_*, checkpoint_*, eval_*, prefetch_*, data_* names one run
    adds to the registry are the reference's (the Orbax flush renamed),
    and the run's batches, epochs, evaluations and saves count alike."""
    got, want = cadence["port"], cadence["jax"]
    assert got["names"] == want["names"]
    for name in ("train_batches_total", "train_epochs_total",
                 "eval_runs_total", "checkpoint_saves_total"):
        assert got["deltas"][name, ()] == want["deltas"][name, ()], name
    assert got["deltas"]["train_batches_total", ()] == 2 * STEPS
    assert got["deltas"]["train_epochs_total", ()] == 2


@_limit(120)
def test_preprocess_metrics_match_jax(data, tmp_path, monkeypatch):
    """The fused compile's phase metrics (`preprocess_*`, the rows of
    each phase) and the `C2V_METRICS_FILE` export of the command."""
    _, prefix, _, _ = data
    raw = prefix + ".train.c2v"
    got = {}
    for pkg, mod, registry in (("jax", jpp, jobs.default_registry()),
                               ("port", pp, obs.default_registry())):
        metrics_file = str(tmp_path / f"{pkg}.prom")
        monkeypatch.setenv("C2V_METRICS_FILE", metrics_file)
        argv = ["--train_raw", raw, "--val_raw", raw, "--test_raw", raw,
                "--output_name", str(tmp_path / pkg / "mini"),
                "--max_contexts", "8", "--preprocess_workers", "1"]
        os.makedirs(tmp_path / pkg)
        names, deltas = _touched(registry, lambda: mod.main(argv))
        with open(metrics_file) as f:
            text = f.read()
        got[pkg] = ({n for n in names if n.startswith("preprocess_")},
                    {k: d for k, d in deltas.items()
                     if k[0].startswith("preprocess_")},
                    "preprocess_phase_seconds_count" in text)
    assert got["port"] == got["jax"]
    assert got["port"][0] and got["port"][2]


# ------------------------------------------------------------ TensorBoard

@_limit(30)
def test_scalar_writer_matches_jax(tmp_path, monkeypatch):
    """`ScalarWriter` writes the reference's bytes under a fixed clock, and
    both files decode to the same (tag, step, value) stream."""
    monkeypatch.setattr(time, "time", lambda: 1234567890.25)
    stream = [("train/loss", 2.5, 10), ("eval/subtoken_f1", 0.125, 10),
              ("obs/x.k.v/mean", -3.0, 2 ** 40)]
    paths = {}
    for pkg, mod in (("jax", jtb), ("port", tb)):
        w = mod.ScalarWriter(str(tmp_path / pkg))
        for tag, value, step in stream:
            w.scalar(tag, value, step)
        w.close()
        w.close()   # idempotent
        paths[pkg] = w.path
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    assert tb.read_scalars(paths["port"]) == tb.read_scalars(paths["jax"]) \
        == [(t, s, v) for t, v, s in stream]
    with open(paths["port"], "r+b") as f:
        f.seek(-6, os.SEEK_END)
        f.write(b"\xff")
    with pytest.raises(ValueError, match="CRC"):
        tb.read_scalars(paths["port"])


@_limit(30)
def test_tb_export_matches_jax(tmp_path):
    """`tb_export` writes a registry's metrics under obs/ as the
    reference does, histograms as count, sum and mean."""
    class Recorder:
        def __init__(self):
            self.seen = []

        def scalar(self, tag, value, step):
            self.seen.append((tag, value, step))

    got = {}
    for pkg, mod in (("jax", jobs), ("port", obs)):
        reg = mod.MetricsRegistry()
        reg.counter("c_total", "h", k="v").inc(3)
        reg.gauge("g", "h").set(-1.5)
        reg.histogram("h_seconds", "h").observe(0.25)
        rec = Recorder()
        (jexporters if pkg == "jax" else exporters).tb_export(rec, 7,
                                                              registry=reg)
        got[pkg] = rec.seen
    assert got["port"] == got["jax"]
    assert ("obs/h_seconds/mean", 0.25, 7) in got["port"]


# ------------------------------------------------------------ async commit

@pytest.fixture(scope="module")
def small(data):
    """A port model of the synthetic dataset: its state, vocabularies and
    config for the checkpoint tests."""
    _, prefix, _, init = data
    return _facade("port", prefix, init)


def _leaves(state):
    return {k: (v.detach().clone() if isinstance(v, torch.Tensor) else v)
            for k, v in ckpt.state_leaves(state).items()}


def _assert_restores(path, small, want):
    fresh = _facade("port", small.config.train_data_path_prefix)
    ckpt.load_model(path, fresh.state, config=fresh.config)
    got = ckpt.state_leaves(fresh.state)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(got[k], v), k
        else:
            assert got[k] == v, k


@_limit(60)
def test_async_save_holds_the_state_at_return(small, tmp_path):
    """`save_model(committer=)` returns before the commit, and what
    commits is the state as it was when it returned, though the state is
    changed in place right after (as K8 and K12 update it); it restores
    bit-equal, as a synchronous save does."""
    gate, started = threading.Event(), threading.Event()
    committer = ckpt.AsyncCommitter(max_in_flight=2)
    want = _leaves(small.state)
    committer.submit(lambda: (started.set(), gate.wait(30)), "gate")
    assert started.wait(10)
    base = str(tmp_path / "m_iter1")
    path = ckpt.save_model(base, small.state, small.vocabs, small.config,
                           epoch=1, committer=committer)
    assert committer.in_flight == 2 and not os.path.exists(path)
    with torch.no_grad():
        for p in small.state.params.values():
            p.add_(1.0)
    try:
        gate.set()
        committer.close()
        _assert_restores(path, small, want)
        sync = ckpt.save_model(str(tmp_path / "sync"), small.state,
                               small.vocabs, small.config, epoch=1)
        assert ckpt.load_state_arrays(sync)["params/transform"].tolist() != \
            ckpt.load_state_arrays(path)["params/transform"].tolist()
    finally:
        with torch.no_grad():
            for p in small.state.params.values():
                p.sub_(1.0)


def _script_committer(mod, tmp_path):
    """The same jobs through a package's AsyncCommitter: a failing commit
    re-raises on the next submit (once) and the pipeline goes on; two
    blocked commits hold back a third submit. Returns what was seen."""
    seen = []
    c = mod.AsyncCommitter(max_in_flight=2)

    def boom():
        raise OSError("disk gone")

    c.submit(boom, "first")
    deadline = time.time() + 10
    while c.in_flight and time.time() < deadline:
        time.sleep(0.01)
    try:
        c.submit(lambda: None, "second")
    except OSError as e:
        seen.append(("submit raised", str(e)))
    c.submit(lambda: seen.append("third ran"), "third")
    c.drain()
    gate = threading.Event()
    c.submit(lambda: gate.wait(30), "a")
    c.submit(lambda: gate.wait(30), "b")
    done = threading.Event()
    t = threading.Thread(target=lambda: (c.submit(lambda: None, "c"),
                                         done.set()), daemon=True)
    t.start()
    seen.append(("third submit waited", not done.wait(0.3),
                 c.in_flight))
    gate.set()
    seen.append(("then went in", done.wait(10)))
    c.close()
    seen.append(("closed", c.in_flight))
    return seen


@_limit(60)
def test_async_committer_matches_jax(tmp_path):
    """Back-pressure at max_in_flight=2 and the first failure re-raised on
    the next submit, as the reference's committer does."""
    got = _script_committer(ckpt, tmp_path)
    assert got == _script_committer(jckpt, tmp_path)
    assert got == [("submit raised", "disk gone"), "third ran",
                   ("third submit waited", True, 2), ("then went in", True),
                   ("closed", 0)]


@_limit(60)
def test_async_committer_bounds_inflight_under_contention():
    """Eight threads submit 80 commits with a 1 us switch interval: the
    in-flight count never passes 2, every commit runs once, and the count
    and its gauge return to 0 (a lost update would leave them off)."""
    committer = ckpt.AsyncCommitter(max_in_flight=2)
    ran, over = [], []

    def job(i):
        if committer.in_flight > 2:
            over.append(i)
        ran.append(i)

    def submitter(k):
        for i in range(10):
            committer.submit(functools.partial(job, 10 * k + i), str(i))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=submitter, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        committer.close()
    finally:
        sys.setswitchinterval(interval)
    assert sorted(ran) == list(range(80)) and not over
    assert committer.in_flight == 0
    assert obs.gauge("checkpoint_async_inflight").value == 0


@_limit(60)
@pytest.mark.parametrize("point,lands_on", [("async_commit", 1),
                                            ("callback_crash", 2)])
def test_async_fault_leaves_a_valid_artifact_as_jax(small, tmp_path, point,
                                                    lands_on):
    """A fault on the commit thread before the rename (`async_commit`)
    leaves `_iter2` uncommitted and resume on `_iter1`; after it
    (`callback_crash`) `_iter2` is committed and `_iter1` still verifies.
    The reference's matrix lands on the same artifact; the restore is
    bit-equal."""
    jvocabs, jconfig = chaos_child.build_vocabs(), chaos_child.build_config()
    found = {}
    for pkg in ("jax", "port"):
        mod, fmod = (jckpt, jfaults) if pkg == "jax" else (ckpt, faults)
        base = str(tmp_path / pkg / "m")
        os.makedirs(os.path.dirname(base))
        committer = mod.AsyncCommitter(max_in_flight=2)

        def save(epoch):
            if pkg == "jax":
                return jckpt.save_model(f"{base}_iter{epoch}",
                                        chaos_child.build_state(epoch),
                                        jvocabs, jconfig, epoch=epoch,
                                        committer=committer)
            return ckpt.save_model(f"{base}_iter{epoch}", small.state,
                                   small.vocabs, small.config, epoch=epoch,
                                   committer=committer)

        save(1)
        committer.drain()
        fmod.reset(f"{point}=raise")
        save(2)
        with pytest.raises(fmod.FaultInjected):
            committer.drain()
        fmod.reset(None)
        committer.close()
        mod.verify_checkpoint(f"{base}_iter1")
        found[pkg] = os.path.basename(mod.latest_valid_checkpoint(base))
    assert found["port"] == found["jax"] == f"m_iter{lands_on}"
    _assert_restores(str(tmp_path / "port" / found["port"]), small,
                     _leaves(small.state))


@_limit(60)
@pytest.mark.parametrize("hashed", [True, False])
def test_content_hash_matches_jax(small, tmp_path, hashed):
    """`checkpoint_hash_content` records every file's sha256 after the
    commit, and the deep probe (resume's) catches a size-preserving flip
    in a state file that the cheap probe cannot see; off (the default),
    no content hash is recorded. As in the reference."""
    import dataclasses
    jcfg = dataclasses.replace(chaos_child.build_config(),
                               checkpoint_hash_content=hashed)
    pcfg = dataclasses.replace(small.config, checkpoint_hash_content=hashed)
    assert not Config().checkpoint_hash_content
    seen = {}
    for pkg in ("jax", "port"):
        mod = _ckpt(pkg)
        base = str(tmp_path / pkg / "m_iter1")
        if pkg == "jax":
            out = jckpt.save_model(base, chaos_child.build_state(1),
                                   chaos_child.build_vocabs(), jcfg, epoch=1)
        else:
            out = ckpt.save_model(base, small.state, small.vocabs, pcfg,
                                  epoch=1)
        with open(os.path.join(out, mod.MANIFEST_NAME)) as f:
            manifest = json.load(f)
        files = manifest["files"]
        hashes = [("content_sha256" in e) for e in files.values()]
        big = max((r for r in files if r.startswith("state")),
                  key=lambda r: files[r]["size"])
        with open(os.path.join(out, big), "r+b") as f:
            f.seek(files[big]["size"] // 2)
            byte = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([byte[0] ^ 0xFF]))
        mod.verify_checkpoint(out)
        try:
            mod.verify_checkpoint(out, check_content=True)
            caught = None
        except mod.CheckpointIntegrityError as e:
            caught = "content sha256" in str(e)
        seen[pkg] = (manifest.get("content_hashed"), set(hashes), caught)
    assert seen["port"] == seen["jax"]
    assert seen["port"] == ((True, {True}, True) if hashed
                            else (None, {False}, None))
    if hashed:
        fresh = _facade("port", small.config.train_data_path_prefix)
        with pytest.raises(ckpt.CheckpointIntegrityError,
                           match="content sha256"):
            ckpt.load_model(str(tmp_path / "port" / "m_iter1"), fresh.state)


# ------------------------------------------------------------ config

@_limit(30)
def test_operations_fields_default_as_reference(tmp_path):
    """The operations' fields keep the reference's defaults, validation
    and TensorBoard directory."""
    port, ref = Config(), JaxConfig()
    for field in ("save_on_preemption", "rss_limit_gb", "async_checkpointing",
                  "cursor_resume", "checkpoint_hash_content",
                  "num_train_batches_to_evaluate", "use_tensorboard",
                  "profile_dir", "heartbeat_file", "on_nonfinite_loss",
                  "metrics_file", "metrics_port", "trace_export"):
        assert getattr(port, field) == getattr(ref, field), field
    for save, load in (("S", None), (None, "L"), (None, None)):
        assert Config(model_save_path=save, model_load_path=load
                      ).tensorboard_dir == JaxConfig(
            model_save_path=save, model_load_path=load).tensorboard_dir
    for cls in (Config, JaxConfig):
        with pytest.raises(ValueError, match="rss_limit_gb"):
            cls(train_data_path_prefix="x", rss_limit_gb=-1.0).verify()


# ------------------------------------------------ a real SIGTERM, resumed

@_limit(150)
def test_sigterm_to_train_process_saves_and_resumes(data, tmp_path):
    """`python -m code2vec_tpu_torch train` gets a real SIGTERM once its
    first epoch is saved: it writes `_iter<N>_preempt` with its cursor,
    its heartbeat says preempted, it exits 0; `--load <base>` then
    resolves to that artifact and resumes its epoch past the cursor."""
    _, prefix, _, _ = data
    pfx = _copy_dataset(prefix, str(tmp_path / "d"))
    base = str(tmp_path / "run" / "model")
    hb = str(tmp_path / "hb.json")
    os.makedirs(os.path.dirname(base))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "code2vec_tpu_torch", "train", "--data", pfx,
         "--save", base, "--epochs", "100000", "--batch_size", str(B),
         "--max_contexts", "8", "--device", "cpu", "--heartbeat_file", hb],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 100
        while time.time() < deadline:
            if proc.poll() is not None:
                pytest.fail(f"train died early:\n{proc.stdout.read()}")
            if ckpt.latest_valid_checkpoint(base):
                break
            time.sleep(0.1)
        else:
            pytest.fail("no checkpoint within the deadline")
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=100)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "Preempted: skipping final save" in out
    preempts = glob.glob(base + "_iter*_preempt")
    assert len(preempts) == 1, out
    meta = ckpt.verify_checkpoint(preempts[0])
    cursor = _cursor("port", preempts[0])
    assert cursor["epoch"] == meta["epoch"] >= 1
    assert cursor["global_row_ordinal"] % B == 0
    with open(hb) as f:
        assert json.load(f)["status"] == "preempted"
    assert not os.path.exists(base)
    model = _facade("port", pfx, model_load_path=base,
                    num_train_epochs=meta["epoch"] + 1, model_save_path=base)
    assert model.config.model_load_path == preempts[0]
    assert model.initial_epoch == meta["epoch"]
    batches = _train(model)[0]
    skipped = cursor["global_row_ordinal"] // B
    assert len(batches) == STEPS - skipped
    assert model.trainer.final_epoch == meta["epoch"] + 1
    assert not glob.glob(base + "_iter*_preempt")
