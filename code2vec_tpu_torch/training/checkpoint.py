"""Checkpoints: trainable and released artifacts with a crash-atomic commit.

The counterpart of code2vec_tpu/training/checkpoint.py for one process on
one device: the commit (`_save_model_inner` :916), the async committer
(`AsyncCommitter` :770-872, `save_model(committer=, on_committed=)`
:875-1082), the opt-in content hash (`hash_artifact_content` :229-262,
`verify_checkpoint(check_content=)` :496), the integrity check
(`verify_checkpoint`, `latest_valid_checkpoint` :678 with the preference
of a `_preempt` artifact over the clean one of its epoch, `_candidate_key`
:631, `resolve_load_path`, `reclaim_orphan`), the data cursor the
manifest records, the restore (`load_model` :1106, with `params_only`,
`report` and the reference's mismatch messages :1166-1197) and
`release_model` (:1213), with the reference's spans and metrics
(`checkpoint_save_seconds`, `checkpoint_async_*`,
`checkpoint_saves_total`, `checkpoint_last_save_*`, `checkpoint_verify_*`,
`checkpoint_content_hash_seconds`). The multi-host barriers and the
resharded restore are not ported (a mesh run refuses --save and --load).

An artifact is a directory:

    dictionaries.bin         the vocabularies (vocab.py)
    code2vec_meta.json       the reference's meta keys (:955-979)
    state/<leaf>.npy         one array per state leaf, named by its Flax
                             path: params/<name>, step, and for a
                             trainable save opt_state/count,
                             opt_state/mu/<name>, opt_state/nu/<name>
                             (the sparse step's HybridOptState:
                             opt_state/dense/{count,mu/<name>,nu/<name>}
                             and opt_state/slots/<table>/{mu,nu})
    code2vec_manifest.json   every file with its size, the sha256 of the
                             two small files, `param_tree` (each leaf's
                             shape and dtype) and the data cursor

The payload is torch-native, never Orbax: f32 leaves are f32 `.npy`,
bf16 leaves their uint16 bits (`param_tree` names the dtype), counters
int32 scalars, so numpy alone reads a checkpoint (`load_state_arrays`).

The commit: every file goes into a `<base>.tmp-<pid>` staging directory,
the manifest last, then the directory is renamed into place (an existing
artifact is first moved to `<base>.old-<pid>`, so a crash leaves the old
artifact or the new one, never a blend). Every staged file and directory
is flushed to the disk before the manifest is written, then the manifest
and the renames, so this holds across a power loss too, not only a
killed process. `fault_point("save")` sits at the five places the
reference marks, `async_commit` where the deferred work begins and
`callback_crash` after the rename, for the crash tests.

Async commits (`config.async_checkpointing`): `save_model(committer=)`
writes the two small files and copies every state leaf to host memory
before it returns (the port's K8 and K12 update the parameters and
moments in place, so the next step would change what a later copy
reads; the copy waits for the device's work queued before it), then
hands the state files, their flush, the manifest, the rename, the
content hash and `on_committed` (rotation) to the committer's one
thread. At most `max_in_flight` commits are pending: each holds its host
copy of the state (3.145 GB at the flagship width) until it commits.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import shutil
import threading
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from code2vec_tpu_torch import obs
from code2vec_tpu_torch.training.sparse_adam import HybridOptState
from code2vec_tpu_torch.training.state import TrainState
from code2vec_tpu_torch.utils.faults import fault_point

STATE_DIR = "state"
META_NAME = "code2vec_meta.json"
MANIFEST_NAME = "code2vec_manifest.json"
MANIFEST_FORMAT = 3
DICT_NAME = "dictionaries.bin"
RELEASED_SUFFIX = ".release"
# commit working directories: `.tmp-<pid>` stages a save, `.old-<pid>`
# holds the previous artifact while an overwrite swaps the new one in
STAGING_INFIX = ".tmp-"
BACKUP_INFIX = ".old-"
# the small files whose content the manifest hashes; the state files are
# checked by size, and by content only after `hash_artifact_content`
_HASHED_FILES = (DICT_NAME, META_NAME)
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


class CheckpointIntegrityError(RuntimeError):
    """An artifact failed its manifest check; the message names the
    offending file."""


def _abs(path: str) -> str:
    return os.path.abspath(path)


def is_staging_path(path: str) -> bool:
    """True for commit working directories (`.tmp-<pid>`, `.old-<pid>`),
    which are never artifacts."""
    name = os.path.basename(path.rstrip(os.sep))
    return STAGING_INFIX in name or BACKUP_INFIX in name


def staging_owner_alive(path: str) -> bool:
    """Does the process that made this staging or backup directory still
    run? Unparseable names count as orphaned."""
    name = os.path.basename(path.rstrip(os.sep))
    for infix in (STAGING_INFIX, BACKUP_INFIX):
        if infix in name:
            tail = name.rsplit(infix, 1)[1]
            break
    else:
        return False
    try:
        pid = int(tail)
    except ValueError:
        return False
    if pid == os.getpid():
        return True
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by another user


def parse_iter_name(path: str):
    """(epoch, is_preempt) of a `<base>_iter<N>[_preempt]` path, or None
    (reference :202-218). Staging directories and the post-mortem
    `_iter<N>_nanhalt` artifacts parse as None, so resume and rotation
    never see them."""
    if "_iter" not in path:
        return None
    tail = path.rsplit("_iter", 1)[1]
    preempt = tail.endswith("_preempt")
    if preempt:
        tail = tail[: -len("_preempt")]
    try:
        return int(tail), preempt
    except ValueError:
        return None


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def hash_artifact_content(base: str, max_threads: int = 4) -> dict:
    """Record a full-content sha256 of every manifest-listed file (the
    state files included, which the manifest otherwise only size-checks)
    and rewrite the manifest atomically (reference :229-262). Runs after
    the commit (`config.checkpoint_hash_content`), so a kill mid-hash
    leaves a valid artifact without content hashes. Returns the updated
    manifest."""
    from concurrent.futures import ThreadPoolExecutor

    with obs.span("checkpoint_content_hash",
                  hist=obs.histogram(
                      "checkpoint_content_hash_seconds",
                      "post-commit full-content sha256 of one artifact")):
        manifest_path = os.path.join(base, MANIFEST_NAME)
        with open(manifest_path) as f:
            manifest = json.load(f)
        rels = sorted(manifest["files"])
        with ThreadPoolExecutor(max_workers=max_threads) as pool:
            digests = pool.map(
                lambda rel: _sha256_file(os.path.join(base, rel)), rels)
        for rel, digest in zip(rels, digests):
            manifest["files"][rel]["content_sha256"] = digest
        manifest["content_hashed"] = True
        tmp = manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=2)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, manifest_path)
        return manifest


def _fsync_dir(path: str) -> None:
    """Record a directory entry (the rename) durably, where the
    filesystem allows it."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _fsync_tree(path: str) -> None:
    """Flush every file under `path`, then every directory, to the disk,
    so that a manifest written after this certifies data that survives
    a power loss, not only a killed process."""
    for root, dirs, names in os.walk(path, topdown=False):
        for name in names:
            fd = os.open(os.path.join(root, name), os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        _fsync_dir(root)


# ----------------------------------------------------------------- leaves

def _opt_leaves(prefix: str, opt_state) -> Dict[str, object]:
    if isinstance(opt_state, HybridOptState):
        out = _opt_leaves(f"{prefix}/dense", opt_state.dense)
        for name in sorted(opt_state.slots):
            slot = opt_state.slots[name]
            out[f"{prefix}/slots/{name}/mu"] = slot.mu
            out[f"{prefix}/slots/{name}/nu"] = slot.nu
        return out
    out = {f"{prefix}/count": int(opt_state.count)}
    for moment in ("mu", "nu"):
        tree = getattr(opt_state, moment)
        for name in sorted(tree):
            out[f"{prefix}/{moment}/{name}"] = tree[name]
    return out


def state_leaves(state: TrainState, with_opt_state: bool = True
                 ) -> Dict[str, object]:
    """{Flax path: tensor or int} of a TrainState's leaves."""
    out: Dict[str, object] = {f"params/{k}": state.params[k]
                              for k in sorted(state.params)}
    out["step"] = int(state.step)
    if with_opt_state:
        out.update(_opt_leaves("opt_state", state.opt_state))
    return out


def _leaf_summary(x) -> dict:
    if isinstance(x, torch.Tensor):
        return {"shape": [int(d) for d in x.shape],
                "dtype": _DTYPE_NAMES[x.dtype]}
    return {"shape": [], "dtype": "int32"}


def tree_summary(leaves: Dict[str, object]) -> dict:
    """{leaf: {shape, dtype}}: the manifest's `param_tree`."""
    return {k: _leaf_summary(x) for k, x in leaves.items()}


def _to_numpy(x) -> np.ndarray:
    """A leaf as the array its file holds: bf16 as uint16 bits."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x, dtype=np.int32)
    t = x.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def _snapshot(leaves: Dict[str, object]) -> Dict[str, np.ndarray]:
    """`_to_numpy` of every leaf into host memory of its own: what an
    async save writes after the device has moved on. A device tensor is
    copied into pinned memory (a DMA copy, several times the rate of a
    copy to pageable memory; PyTorch's caching host allocator keeps the
    freed buffers for the next save), the copies queued after the work
    already on the current stream, and the call returns once they are
    done."""
    out: Dict[str, np.ndarray] = {}
    devices = set()
    for key, x in leaves.items():
        if not isinstance(x, torch.Tensor):
            out[key] = np.asarray(x, dtype=np.int32)
            continue
        t = x.detach()
        bits = t.dtype == torch.bfloat16
        if bits:
            t = t.view(torch.int16)
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
        host.copy_(t, non_blocking=t.is_cuda)
        if t.is_cuda:
            devices.add(t.device)
        out[key] = host.numpy().view(np.uint16) if bits else host.numpy()
    for device in devices:
        torch.cuda.synchronize(device)
    return out


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def _leaf_path(base: str, key: str) -> str:
    return os.path.join(base, STATE_DIR, *key.split("/")) + ".npy"


def load_state_arrays(model_path: str) -> Dict[str, np.ndarray]:
    """Every state leaf of an artifact as a numpy array, bf16 leaves
    widened to f32 from their bits (numpy only)."""
    base = _abs(model_path)
    with open(os.path.join(base, MANIFEST_NAME)) as f:
        tree = json.load(f)["param_tree"]
    out = {}
    for key, entry in tree.items():
        arr = np.load(_leaf_path(base, key))
        if entry["dtype"] == "bfloat16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        out[key] = arr
    return out


# ----------------------------------------------------------------- commit

def _write_manifest(base: str, epoch: int, released: bool,
                    topology: dict) -> None:
    """Every file of the staged artifact with its size, and the sha256
    of the small ones. Written last: its presence certifies the rest."""
    files = {}
    for root, _dirs, names in os.walk(base):
        for name in names:
            p = os.path.join(root, name)
            rel = os.path.relpath(p, base)
            if rel == MANIFEST_NAME:
                continue
            entry = {"size": os.path.getsize(p)}
            if rel in _HASHED_FILES:
                entry["sha256"] = _sha256_file(p)
            files[rel] = entry
    manifest = {"format": MANIFEST_FORMAT, "epoch": epoch,
                "released": released, "state_complete": True,
                "payload": "npy", "process_count": 1, "commit_acks": [0],
                "files": files, **topology}
    with open(os.path.join(base, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=2)
        f.flush()
        os.fsync(f.fileno())


def _commit_staging(staging: str, base: str) -> None:
    """Rename a fully written staging directory into place. An overwrite
    swaps through `.old-<pid>`, so `base` is empty only between the two
    renames, and a kill there leaves two intact copies for
    `reclaim_orphan`."""
    fault_point("checkpoint_commit")
    if os.path.isdir(base):
        backup = f"{base}{BACKUP_INFIX}{os.getpid()}"
        if os.path.isdir(backup):
            shutil.rmtree(backup)
        os.rename(base, backup)
        fault_point("checkpoint_swap")
        os.rename(staging, base)
        shutil.rmtree(backup, ignore_errors=True)
    else:
        os.rename(staging, base)
    _fsync_dir(os.path.dirname(base) or ".")


class AsyncCommitter:
    """Bounded background pipeline for the deferred half of a save
    (reference :770-872): one commit thread; `submit` blocks once
    `max_in_flight` commits are pending (back-pressure: a slow disk never
    queues unbounded host copies of the state); the first failure
    re-raises on the next `submit` or `drain`; `drain` completes every
    pending commit (the trainer drains before a preemption save and in
    its `finally`); `close` drains and stops the thread."""

    def __init__(self, max_in_flight: int = 2,
                 log: Optional[Callable[[str], None]] = None):
        from concurrent.futures import ThreadPoolExecutor
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="c2v-ckpt-commit")
        self._slots = threading.Semaphore(max(1, int(max_in_flight)))
        self._lock = threading.Lock()
        self._futures = []
        self._errors = []
        self._depth = 0
        self._log = log
        self._g_depth = obs.gauge(
            "checkpoint_async_inflight",
            "async checkpoint commits currently pending")

    @property
    def in_flight(self) -> int:
        with self._lock:
            return self._depth

    def raise_pending(self) -> None:
        """Re-raise the first recorded commit failure (the original
        exception object) and forget it."""
        with self._lock:
            if not self._errors:
                return
            _label, err = self._errors.pop(0)
        raise err

    def submit(self, job: Callable[[], object], label: str) -> None:
        self.raise_pending()
        with obs.span("checkpoint_async_backpressure",
                      hist=obs.histogram(
                          "checkpoint_async_backpressure_seconds",
                          "save stalled waiting for an in-flight async "
                          "commit slot")):
            self._slots.acquire()  # back-pressure at max_in_flight

        def run():
            try:
                with obs.span("checkpoint_async_commit",
                              hist=obs.histogram(
                                  "checkpoint_async_commit_seconds",
                                  "deferred commit: state files + flush + "
                                  "manifest + rename")):
                    job()
            except BaseException as e:  # noqa: BLE001 (surfaced on drain)
                with self._lock:
                    self._errors.append((label, e))
                obs.counter("checkpoint_async_errors_total",
                            "async checkpoint commits that failed").inc()
                if self._log is not None:
                    self._log(f"Async checkpoint commit {label} FAILED: "
                              f"{type(e).__name__}: {e}")
            finally:
                with self._lock:
                    self._depth -= 1
                    self._g_depth.set(self._depth)
                self._slots.release()

        with self._lock:
            self._futures = [f for f in self._futures if not f.done()]
            self._futures.append(self._executor.submit(run))
            self._depth += 1
            self._g_depth.set(self._depth)

    def drain(self) -> None:
        """Block until every pending commit finished; re-raise the first
        failure. Idempotent."""
        from concurrent.futures import wait
        with self._lock:
            pending = list(self._futures)
        if pending:
            wait(pending)
        self.raise_pending()

    def close(self) -> None:
        """Drain (surfacing errors) and stop the commit thread."""
        try:
            self.drain()
        finally:
            self._executor.shutdown(wait=True)


def save_model(model_save_path: str, state: TrainState, vocabs, config,
               epoch: int = 0, released: bool = False,
               committer: Optional[AsyncCommitter] = None,
               on_committed: Optional[Callable[[], None]] = None,
               data_cursor: Optional[dict] = None) -> str:
    """Save a standalone artifact at `model_save_path` (plus `.release`
    when `released`, which leaves the optimizer state out); returns its
    path. Crash-atomic: staged, manifest last, renamed into place.

    With `committer` the call returns once the small files are staged
    and the state is copied to host memory; the state files, the
    manifest and the rename run on the commit thread, then
    `on_committed` (rotation). The returned path is where the artifact
    WILL commit: drain the committer before relying on it. `data_cursor`
    ({"epoch", "global_row_ordinal", "global_batch_size"}) goes into the
    manifest as it is."""
    with obs.span("checkpoint_save",
                  hist=obs.histogram(
                      "checkpoint_save_seconds",
                      "step-loop save stall: stage + write + commit (sync) "
                      "or stage + host snapshot (async)")):
        return _save_model_inner(model_save_path, state, vocabs, config,
                                 epoch, released, committer, on_committed,
                                 data_cursor)


def _save_model_inner(model_save_path: str, state: TrainState, vocabs,
                      config, epoch: int, released: bool,
                      committer: Optional[AsyncCommitter],
                      on_committed: Optional[Callable[[], None]],
                      data_cursor: Optional[dict]) -> str:
    base = _abs(model_save_path) + (RELEASED_SUFFIX if released else "")
    staging = f"{base}{STAGING_INFIX}{os.getpid()}"
    if os.path.isdir(staging):
        shutil.rmtree(staging)  # left by a failed save of this process
    os.makedirs(staging)
    fault_point("save")   # 1: staging created, nothing written
    vocabs.save(os.path.join(staging, DICT_NAME))
    fault_point("save")   # 2: vocabularies written, meta missing
    with open(os.path.join(staging, META_NAME), "w") as f:
        json.dump({
            "released": released,
            "epoch": epoch,
            "step": int(state.step),
            "token_vocab_size": vocabs.token_vocab.size,
            "path_vocab_size": vocabs.path_vocab.size,
            "target_vocab_size": vocabs.target_vocab.size,
            "token_embeddings_size": config.token_embeddings_size,
            "path_embeddings_size": config.path_embeddings_size,
            "separate_oov_and_pad": config.separate_oov_and_pad,
            # the optimizer state's layout and dtypes, checked at restore
            "use_sparse_embedding_update": bool(
                config.use_sparse_embedding_update),
            "adam_mu_dtype": str(config.adam_mu_dtype),
            "adam_nu_dtype": str(config.adam_nu_dtype),
        }, f, indent=2)
    fault_point("save")   # 3: meta written, state missing
    leaves = state_leaves(state, with_opt_state=not released)
    topology = {"param_tree": tree_summary(leaves)}
    if data_cursor is not None:
        topology["data_cursor"] = dict(data_cursor)
    if committer is not None:
        # the state as it is now: the steps after this return update it
        # in place
        with obs.span("checkpoint_snapshot",
                      hist=obs.histogram(
                          "checkpoint_snapshot_seconds",
                          "async save: the state's copy to host memory")):
            leaves = _snapshot(leaves)

    def commit_job():
        with obs.span("checkpoint_state_write",
                      hist=obs.histogram(
                          "checkpoint_state_write_seconds",
                          "the state files written and flushed to disk")):
            for key, x in leaves.items():
                path = _leaf_path(staging, key)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                np.save(path, x if isinstance(x, np.ndarray)
                        else _to_numpy(x))
            fault_point("save")   # 4: state written, manifest missing
            fault_point("async_commit")  # the deferred commit work begins
            _fsync_tree(staging)
        _write_manifest(staging, epoch, released, topology)
        fault_point("save")   # 5: fully staged, not yet committed
        _commit_staging(staging, base)
        fault_point("callback_crash")  # committed, completion pending
        if config.checkpoint_hash_content:
            # after the commit: the artifact is durable, a kill mid-hash
            # leaves it valid without content hashes
            hash_artifact_content(base)
        obs.counter("checkpoint_saves_total",
                    "committed checkpoint artifacts").inc()
        obs.gauge("checkpoint_last_save_unixtime",
                  "wall clock of the last committed save"
                  ).set_to_current_time()
        obs.gauge("checkpoint_last_save_epoch",
                  "epoch recorded in the last committed save").set(epoch)
        if on_committed is not None:
            on_committed()
        return base

    if committer is None:
        commit_job()
    else:
        try:
            committer.submit(commit_job, label=os.path.basename(base))
        except BaseException:
            # an earlier commit's failure surfaced before this job was
            # taken: nothing writes into this staging directory
            shutil.rmtree(staging, ignore_errors=True)
            raise
    return base


def reclaim_orphan(path: str,
                   log: Optional[Callable[[str], None]] = None) -> str:
    """Reclaim one orphaned commit directory: promote it to its final
    name where that is empty and it verifies (a kill between the swap's
    renames leaves exactly that), else remove it. Returns "promoted" or
    "removed"."""
    dirpart, name = os.path.split(os.path.abspath(path.rstrip(os.sep)))
    for infix in (STAGING_INFIX, BACKUP_INFIX):
        if infix in name:
            base = os.path.join(dirpart, name.rsplit(infix, 1)[0])
            break
    else:
        return "removed"
    if not os.path.exists(base):
        try:
            verify_checkpoint(path)
        except CheckpointIntegrityError:
            pass
        else:
            os.rename(path, base)
            _fsync_dir(dirpart)
            if log is not None:
                log(f"Promoted orphaned-but-complete checkpoint {path} "
                    f"back to {base} (save was killed mid-commit)")
            return "promoted"
    shutil.rmtree(path, ignore_errors=True)
    return "removed"


# ---------------------------------------------------------------- verify

def verify_checkpoint(model_path: str, check_content: bool = False) -> dict:
    """Check an artifact against its manifest (a stat per file, a hash of
    the two small ones); returns its meta, or raises
    CheckpointIntegrityError naming the first offending file.
    `check_content` also re-hashes every file that carries a post-commit
    `content_sha256` (saves made with `checkpoint_hash_content`): the
    resume path's deep probe; rotation and the fallback walk keep the
    cheap default."""
    with obs.span("checkpoint_verify",
                  hist=obs.histogram("checkpoint_verify_seconds",
                                     "manifest probe of one artifact")):
        try:
            return _verify_checkpoint_inner(model_path, check_content)
        except CheckpointIntegrityError:
            obs.counter("checkpoint_verify_failures_total",
                        "artifacts that failed their integrity check "
                        "(resume fallback walked past them)").inc()
            raise


def _verify_checkpoint_inner(model_path: str, check_content: bool) -> dict:
    base = _abs(model_path)
    if not os.path.isdir(base):
        raise CheckpointIntegrityError(f"{base}: not a directory")
    manifest_path = os.path.join(base, MANIFEST_NAME)
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except FileNotFoundError:
        raise CheckpointIntegrityError(
            f"{manifest_path}: manifest missing (the save did not commit)")
    except (OSError, ValueError) as e:
        raise CheckpointIntegrityError(
            f"{manifest_path}: unreadable or corrupt manifest ({e})")
    if not isinstance(manifest, dict) or not isinstance(
            manifest.get("files"), dict):
        raise CheckpointIntegrityError(
            f"{manifest_path}: malformed manifest (no file table)")
    if not manifest.get("state_complete") or not isinstance(
            manifest.get("param_tree"), dict):
        raise CheckpointIntegrityError(
            f"{manifest_path}: no completion marker or leaf table: not a "
            f"checkpoint of this package")
    for rel, entry in manifest["files"].items():
        p = os.path.join(base, rel)
        if not os.path.isfile(p):
            raise CheckpointIntegrityError(
                f"{p}: listed in manifest but missing")
        try:
            size = os.path.getsize(p)
            if size != entry.get("size"):
                raise CheckpointIntegrityError(
                    f"{p}: size {size} != manifest size {entry.get('size')} "
                    f"(truncated or partially written)")
            want_hash = entry.get("sha256")
            content_hash = (entry.get("content_sha256") if check_content
                            else None)
            if want_hash or content_hash:
                digest = _sha256_file(p)  # one pass serves both checks
                if want_hash and digest != want_hash:
                    raise CheckpointIntegrityError(
                        f"{p}: sha256 mismatch against manifest (corrupt)")
                if content_hash and digest != content_hash:
                    raise CheckpointIntegrityError(
                        f"{p}: content sha256 mismatch against manifest "
                        f"(bit-rot or size-preserving corruption)")
        except OSError as e:
            raise CheckpointIntegrityError(
                f"{p}: vanished or became unreadable mid-probe ({e})")
    meta_path = os.path.join(base, META_NAME)
    try:
        with open(meta_path) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointIntegrityError(
            f"{meta_path}: unreadable or corrupt meta ({e})")


def _candidate_key(parsed) -> int:
    """(epoch, is_preempt) as one integer in the resume preference order
    (reference :631-636): the newer epoch wins, and at equal epoch the
    preemption artifact (written mid-epoch N+1, so more trained than the
    clean end-of-epoch-N save)."""
    epoch, preempt = parsed
    return epoch * 2 + (1 if preempt else 0)


def latest_valid_checkpoint(save_base: str,
                            log: Optional[Callable[[str], None]] = None,
                            trail: Optional[List[dict]] = None
                            ) -> Optional[str]:
    """The newest `<save_base>_iter<N>[_preempt]` artifact that passes
    `verify_checkpoint` (None if none does), walking newest to oldest
    past corrupt or partial ones; at equal N the `_preempt` one first.
    `trail` collects one record per candidate considered."""
    candidates = []
    for p in glob.glob(save_base + "_iter*"):
        parsed = parse_iter_name(p)
        if parsed is not None:
            candidates.append((_candidate_key(parsed), p))
    for _key, path in sorted(candidates, reverse=True):
        try:
            verify_checkpoint(path)
        except CheckpointIntegrityError as e:
            obs.counter(
                "resume_artifacts_rejected_total",
                "resume candidates the fallback walk rejected").inc()
            if trail is not None:
                trail.append({"path": path, "outcome": "rejected",
                              "reason": str(e)})
            if log is not None:
                log(f"Skipping corrupt/partial checkpoint {path}: {e}")
            continue
        if trail is not None:
            trail.append({"path": path, "outcome": "selected",
                          "reason": "passes verification"})
        return path
    return None


def resolve_load_path(model_load_path: str,
                      log: Optional[Callable[[str], None]] = None,
                      trail: Optional[List[dict]] = None) -> str:
    """A `--load` argument: an artifact directory as it is, anything else
    as a save base resolved to its newest valid `_iter<N>` artifact."""
    base = _abs(model_load_path)
    if os.path.isdir(base) and (
            os.path.isfile(os.path.join(base, META_NAME))
            or os.path.isfile(os.path.join(base, MANIFEST_NAME))):
        return base
    found = latest_valid_checkpoint(base, log=log, trail=trail)
    return found if found is not None else base


def load_model_meta(model_load_path: str) -> dict:
    with open(os.path.join(_abs(model_load_path), META_NAME)) as f:
        return json.load(f)


def load_manifest(model_path: str) -> Optional[dict]:
    """The artifact's manifest, or None where it cannot be read."""
    try:
        with open(os.path.join(_abs(model_path), MANIFEST_NAME)) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None
    return manifest if isinstance(manifest, dict) else None


# ---------------------------------------------------------------- restore

def _check_param_tree(saved: dict, want: dict, base: str) -> None:
    """The reference's leaf checks (:339-370): every leaf the restore
    wants exists with its shape and dtype."""
    missing = sorted(set(want) - set(saved))
    if missing:
        raise ValueError(
            f"{base}: restore template expects leaf {missing[0]} but the "
            f"artifact's recorded parameter tree has no such leaf — the "
            f"saved model/optimizer structure differs from this run's "
            f"configuration ({len(missing)} leaves missing in total).")
    for key, entry in sorted(want.items()):
        rec = saved[key]
        if list(rec.get("shape", ())) != entry["shape"]:
            raise ValueError(
                f"{base}: leaf {key} was saved with global shape "
                f"{rec.get('shape')} but this run expects "
                f"{entry['shape']}; the model configuration (vocab or "
                f"embedding sizes) differs from the artifact's.")
        if rec.get("dtype") != entry["dtype"]:
            raise ValueError(
                f"{base}: leaf {key} was saved as {rec.get('dtype')} but "
                f"this run expects {entry['dtype']}; match the precision "
                f"flags the artifact was saved with.")


def _check_optimizer_layout(meta: dict, config, base: str) -> None:
    """The reference's refusals (:1166-1197) of a trainable artifact whose
    optimizer state does not fit this run."""
    saved_sparse = bool(meta.get("use_sparse_embedding_update", False))
    want_sparse = bool(config.use_sparse_embedding_update)
    if saved_sparse != want_sparse:
        raise ValueError(
            f"{base} was saved with use_sparse_embedding_update="
            f"{saved_sparse} but this run has "
            f"use_sparse_embedding_update={want_sparse}; the optimizer "
            f"state layouts are incompatible. Either set the flag to "
            f"match, or `--release` the artifact first (a released "
            f"model carries no optimizer state and loads under either "
            f"mode).")
    for knob in ("adam_mu_dtype", "adam_nu_dtype"):
        saved = meta.get(knob)
        want = str(getattr(config, knob))
        if saved is not None and saved != want:
            raise ValueError(
                f"{base} was saved with {knob}={saved} but this run "
                f"has {knob}={want}; the optimizer-moment dtypes "
                f"differ and a restore would corrupt or miscast the "
                f"moments. Pass --{knob} {saved} to resume this "
                f"artifact, or `--release` it first (released models "
                f"carry no optimizer state).")


def _set_counter(state: TrainState, key: str, value: int) -> None:
    opt = state.opt_state
    if key == "step":
        state.step = value
    elif key == "opt_state/count":
        opt.count = value
    elif key == "opt_state/dense/count":
        opt.dense.count = value
    else:
        raise KeyError(key)


def load_model(model_load_path: str, state_like: TrainState, config=None,
               params_only: bool = False,
               report: Optional[dict] = None) -> TrainState:
    """Restore an artifact of `save_model` into `state_like`, in place
    (its tensors keep their identity and device), and return it. A
    released artifact, or `params_only`, restores the params and the
    step and keeps `state_like`'s optimizer state; `params_only` skips
    the optimizer checks (the `--release` and export paths). The
    artifact is verified first, with its content hashes where the save
    recorded them, so a truncated or corrupt file fails with its name.
    `report` (an out-parameter) receives `resume_mode` ("exact": one
    device saved it and one restores it), the path, the data cursor and
    `restored_step` (reference :1130-1140, :1205)."""
    base = _abs(model_load_path)
    meta = verify_checkpoint(base, check_content=True)
    manifest = load_manifest(base)
    if report is not None:
        report.update(resume_mode="exact", path=base,
                      data_cursor=manifest.get("data_cursor"))
    released = bool(meta.get("released", False))
    if config is not None and not released and not params_only:
        _check_optimizer_layout(meta, config, base)
    leaves = state_leaves(state_like,
                          with_opt_state=not (released or params_only))
    saved = manifest["param_tree"]
    _check_param_tree(saved, tree_summary(leaves), base)
    with torch.no_grad():
        for key, target in leaves.items():
            arr = np.load(_leaf_path(base, key))
            if isinstance(target, torch.Tensor):
                src = _from_numpy(arr, saved[key]["dtype"])
                if tuple(src.shape) != tuple(target.shape):
                    raise CheckpointIntegrityError(
                        f"{_leaf_path(base, key)}: holds shape "
                        f"{tuple(src.shape)}, the manifest {saved[key]}")
                target.copy_(src)
            else:
                _set_counter(state_like, key, int(arr))
    if report is not None:
        report["restored_step"] = int(state_like.step)
    return state_like


def release_model(model_load_path: str, model_save_path: Optional[str],
                  state_like: TrainState, vocabs, config) -> str:
    """Load a trainable artifact params-only and save it weights-only as
    `<path>.release` (reference: tensorflow_model.py:131-135)."""
    state = load_model(model_load_path, state_like, params_only=True)
    out = model_save_path or model_load_path
    return save_model(out, state, vocabs, config, released=True)

