"""Checkpoints: trainable and released artifacts with a crash-atomic commit.

The counterpart of code2vec_tpu/training/checkpoint.py for one process on
one device: the commit (`_save_model_inner` :916), the integrity check
(`verify_checkpoint`, `latest_valid_checkpoint` :678, `resolve_load_path`,
`reclaim_orphan`), the restore (`load_model` :1106, with `params_only`
and the reference's mismatch messages :1166-1197) and `release_model`
(:1213). The multi-host barriers, the async committer, resharded
restores, the opt-in content hash and mid-epoch cursors are not ported.

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
reference marks, for the crash tests.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import shutil
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

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
# checked by size
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


def parse_iter_name(path: str) -> Optional[int]:
    """The epoch N of a `<base>_iter<N>` path, or None (staging
    directories parse as None)."""
    if "_iter" not in path:
        return None
    try:
        return int(path.rsplit("_iter", 1)[1])
    except ValueError:
        return None


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


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


def save_model(model_save_path: str, state: TrainState, vocabs, config,
               epoch: int = 0, released: bool = False,
               data_cursor: Optional[dict] = None) -> str:
    """Save a standalone artifact at `model_save_path` (plus `.release`
    when `released`, which leaves the optimizer state out); returns its
    path. Crash-atomic: staged, manifest last, renamed into place."""
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
    for key, x in leaves.items():
        path = _leaf_path(staging, key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path, _to_numpy(x))
    fault_point("save")   # 4: state written, manifest missing
    _fsync_tree(staging)
    topology = {"param_tree": tree_summary(leaves)}
    if data_cursor is not None:
        topology["data_cursor"] = dict(data_cursor)
    _write_manifest(staging, epoch, released, topology)
    fault_point("save")   # 5: fully staged, not yet committed
    _commit_staging(staging, base)
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

def verify_checkpoint(model_path: str) -> dict:
    """Check an artifact against its manifest (a stat per file, a hash of
    the two small ones); returns its meta, or raises
    CheckpointIntegrityError naming the first offending file."""
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
            if entry.get("sha256") and _sha256_file(p) != entry["sha256"]:
                raise CheckpointIntegrityError(
                    f"{p}: sha256 mismatch against manifest (corrupt)")
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


def latest_valid_checkpoint(save_base: str,
                            log: Optional[Callable[[str], None]] = None,
                            trail: Optional[List[dict]] = None
                            ) -> Optional[str]:
    """The newest `<save_base>_iter<N>` artifact that passes
    `verify_checkpoint` (None if none does), walking newest to oldest
    past corrupt or partial ones; `trail` collects one record per
    candidate considered."""
    candidates = []
    for p in glob.glob(save_base + "_iter*"):
        epoch = parse_iter_name(p)
        if epoch is not None:
            candidates.append((epoch, p))
    for _epoch, path in sorted(candidates, reverse=True):
        try:
            verify_checkpoint(path)
        except CheckpointIntegrityError as e:
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
               params_only: bool = False) -> TrainState:
    """Restore an artifact of `save_model` into `state_like`, in place
    (its tensors keep their identity and device), and return it. A
    released artifact, or `params_only`, restores the params and the
    step and keeps `state_like`'s optimizer state; `params_only` skips
    the optimizer checks (the `--release` and export paths). The
    artifact is verified first, so a truncated file fails with its name."""
    base = _abs(model_load_path)
    meta = verify_checkpoint(base)
    manifest = load_manifest(base)
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
    return state_like


def release_model(model_load_path: str, model_save_path: Optional[str],
                  state_like: TrainState, vocabs, config) -> str:
    """Load a trainable artifact params-only and save it weights-only as
    `<path>.release` (reference: tensorflow_model.py:131-135)."""
    state = load_model(model_load_path, state_like, params_only=True)
    out = model_save_path or model_load_path
    return save_model(out, state, vocabs, config, released=True)

