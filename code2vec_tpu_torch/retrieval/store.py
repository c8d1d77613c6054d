"""Sharded, memmappable code-vector store: the embed job's output format.

A copy of code2vec_tpu/retrieval/store.py (pure numpy), byte-compatible
both ways: a store written by either package opens in the other.

A vector store is a directory:

    vector_manifest.json    kind/format/dim/dtype/model_fingerprint/
                            shard records (see VectorStoreWriter)
    shard_00000.npy         (rows, dim) fp32 or fp16 vectors
    shard_00000.ids         one method-id string per row (utf-8 text)
    shard_00001.npy / .ids  ...

The manifest carries the embedding model's fingerprint (for a release
artifact `artifact:<content hash>`). The `index-build` job and the
serving mount propagate it, so the stack can prove end to end that a
query vector and the stored corpus came out of the same embedding space.

Shards commit atomically (tmp + rename, manifest rewritten after each
commit), so the batch embed job is resumable at shard granularity: a
killed job re-runs only the rows past the last committed shard. Loads
validate every manifest field the consumers touch and raise StoreError
naming the offending field.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

MANIFEST_NAME = "vector_manifest.json"
STORE_KIND = "code2vec_vector_store"
STORE_FORMAT = 1
STORE_DTYPES = ("float32", "float16")


class StoreError(ValueError):
    """Vector store rejected with the offending manifest/shard field
    named (as ArtifactError does for artifacts)."""

    def __init__(self, field: str, message: str):
        super().__init__(f"vector store field `{field}`: {message}")
        self.field = field


def _shard_base(index: int) -> str:
    return f"shard_{index:05d}"


def _atomic_write_json(path: str, payload: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


class VectorStoreWriter:
    """Shard-committing writer. `append(vectors, ids)` buffers rows and
    commits a shard every `shard_rows`; `finalize()` commits the ragged
    tail and marks the manifest complete.

    Resume: pointing a new writer at an existing (incomplete) store with
    the SAME fingerprint/dim/dtype keeps its committed shards —
    `rows_done` tells the embed job how many rows to skip. Any identity
    mismatch is a StoreError: resuming into a different embedding space
    would interleave incompatible vectors. `resume=False` rebuilds from
    scratch (the offline --export_code_vectors path: one eval, one
    store)."""

    def __init__(self, path: str, dim: int, dtype: str,
                 model_fingerprint: str, source: Optional[str] = None,
                 shard_rows: int = 65536, resume: bool = True, log=None):
        if dtype not in STORE_DTYPES:
            raise StoreError("dtype", f"must be one of {STORE_DTYPES}, "
                                      f"got {dtype!r}")
        if shard_rows < 1:
            raise StoreError("shard_rows", "must be >= 1")
        self.path = os.path.abspath(path)
        self.dim = int(dim)
        self.dtype = dtype
        self.fingerprint = model_fingerprint
        self.shard_rows = int(shard_rows)
        self.log = log or (lambda msg: None)
        os.makedirs(self.path, exist_ok=True)
        self._buf_vecs: List[np.ndarray] = []
        self._buf_ids: List[str] = []
        self._buffered = 0
        self._shards: List[dict] = []
        self._finalized = False
        manifest_path = os.path.join(self.path, MANIFEST_NAME)
        if os.path.isfile(manifest_path) and resume:
            self._resume_from(manifest_path)
        else:
            if os.path.isfile(manifest_path):
                self._wipe_existing()
            self._manifest = {
                "kind": STORE_KIND,
                "format": STORE_FORMAT,
                "dim": self.dim,
                "dtype": self.dtype,
                "model_fingerprint": model_fingerprint,
                "source": source,
                "shard_rows": self.shard_rows,
                "shards": [],
                "rows": 0,
                "complete": False,
            }
            self._write_manifest()

    # ----------------------------------------------------------- resume

    def _wipe_existing(self) -> None:
        for name in os.listdir(self.path):
            if name == MANIFEST_NAME or name.startswith("shard_"):
                os.unlink(os.path.join(self.path, name))

    def _resume_from(self, manifest_path: str) -> None:
        with open(manifest_path) as f:
            manifest = json.load(f)
        for field, want in (("kind", STORE_KIND), ("dim", self.dim),
                            ("dtype", self.dtype),
                            ("model_fingerprint", self.fingerprint)):
            if manifest.get(field) != want:
                raise StoreError(
                    field,
                    f"existing store at {self.path} holds "
                    f"{manifest.get(field)!r} but this job produces "
                    f"{want!r}; resuming would mix embedding spaces — "
                    f"delete the store or point --embed_out elsewhere")
        if manifest.get("complete"):
            raise StoreError(
                "complete",
                f"store at {self.path} is already complete "
                f"({manifest.get('rows')} rows); delete it to re-embed")
        # keep only shards whose files actually verify (a kill between
        # the shard rename and the manifest rewrite leaves an extra
        # file on disk; the manifest is authoritative)
        self._shards = list(manifest.get("shards") or [])
        for rec in self._shards:
            p = os.path.join(self.path, rec["file"])
            if not os.path.isfile(p):
                raise StoreError(
                    "shards", f"manifest lists {rec['file']} but the "
                              f"file is missing (torn store)")
        self._manifest = manifest
        self.log(f"Vector store resume: {self.rows_done} rows in "
                 f"{len(self._shards)} committed shard(s) at {self.path}")

    @property
    def rows_done(self) -> int:
        """Rows safely committed (resumable watermark); buffered rows of
        the open shard are not counted until their shard commits."""
        return int(sum(rec["rows"] for rec in self._shards))

    # ------------------------------------------------------------ write

    def append(self, vectors: np.ndarray, ids: Sequence[str]) -> None:
        if self._finalized:
            raise StoreError("complete", "writer already finalized")
        vectors = np.asarray(vectors)
        if vectors.ndim != 2 or vectors.shape[1] != self.dim:
            raise StoreError(
                "dim", f"append expects (rows, {self.dim}) vectors, got "
                       f"{vectors.shape}")
        if len(ids) != vectors.shape[0]:
            raise StoreError(
                "ids", f"{len(ids)} ids for {vectors.shape[0]} vectors")
        self._buf_vecs.append(vectors.astype(self.dtype))
        self._buf_ids.extend(str(i) for i in ids)
        self._buffered += vectors.shape[0]
        while self._buffered >= self.shard_rows:
            self._commit_shard(self.shard_rows)

    def _take_buffered(self, n: int) -> Tuple[np.ndarray, List[str]]:
        vecs = np.concatenate(self._buf_vecs, axis=0)
        take, rest = vecs[:n], vecs[n:]
        ids, self._buf_ids = self._buf_ids[:n], self._buf_ids[n:]
        self._buf_vecs = [rest] if len(rest) else []
        self._buffered -= n
        return take, ids

    def _commit_shard(self, n: int) -> None:
        vecs, ids = self._take_buffered(n)
        base = _shard_base(len(self._shards))
        vec_name, ids_name = base + ".npy", base + ".ids"
        vec_tmp = os.path.join(self.path, vec_name + ".tmp.npy")
        np.save(vec_tmp, vecs)
        os.replace(vec_tmp, os.path.join(self.path, vec_name))
        ids_tmp = os.path.join(self.path, ids_name + ".tmp")
        with open(ids_tmp, "w") as f:
            for method_id in ids:
                # ids are one-per-line; an embedded newline would shift
                # every later row's identity
                f.write(method_id.replace("\n", " ") + "\n")
        os.replace(ids_tmp, os.path.join(self.path, ids_name))
        self._shards.append({"file": vec_name, "ids_file": ids_name,
                             "rows": int(vecs.shape[0])})
        self._manifest["shards"] = self._shards
        self._manifest["rows"] = self.rows_done
        self._write_manifest()

    def finalize(self) -> dict:
        """Commit the ragged tail shard and mark the store complete;
        returns the final manifest."""
        if self._buffered:
            self._commit_shard(self._buffered)
        self._manifest["complete"] = True
        self._manifest["rows"] = self.rows_done
        self._write_manifest()
        self._finalized = True
        return dict(self._manifest)

    def _write_manifest(self) -> None:
        _atomic_write_json(os.path.join(self.path, MANIFEST_NAME),
                           self._manifest)


class VectorStore:
    """Validated read view: shards stay memory-mapped until a consumer
    asks for the concatenated matrix."""

    def __init__(self, path: str, manifest: dict,
                 shards: List[np.ndarray], ids: List[str]):
        self.path = path
        self.manifest = manifest
        self._shards = shards
        self._ids = ids

    @property
    def rows(self) -> int:
        return int(self.manifest["rows"])

    @property
    def dim(self) -> int:
        return int(self.manifest["dim"])

    @property
    def dtype(self) -> str:
        return str(self.manifest["dtype"])

    @property
    def fingerprint(self) -> str:
        return str(self.manifest["model_fingerprint"])

    @property
    def ids(self) -> List[str]:
        return self._ids

    def iter_shards(self) -> Iterable[np.ndarray]:
        return iter(self._shards)

    def load(self, dtype=np.float32) -> np.ndarray:
        """The full (rows, dim) matrix, materialized in `dtype`."""
        if not self._shards:
            return np.empty((0, self.dim), dtype=dtype)
        return np.concatenate(
            [np.asarray(s, dtype=dtype) for s in self._shards], axis=0)

    @classmethod
    def open(cls, path: str, expect_fingerprint: Optional[str] = None,
             allow_partial: bool = False) -> "VectorStore":
        base = os.path.abspath(path)
        manifest_path = os.path.join(base, MANIFEST_NAME)
        if not os.path.isfile(manifest_path):
            raise StoreError(
                "kind", f"{base} is not a vector store ({MANIFEST_NAME} "
                        f"missing); stores are written by the `embed` "
                        f"subcommand")
        with open(manifest_path) as f:
            try:
                manifest = json.load(f)
            except json.JSONDecodeError as e:
                raise StoreError("kind",
                                 f"unparseable {MANIFEST_NAME}: {e}")
        if manifest.get("kind") != STORE_KIND:
            raise StoreError("kind", f"expected {STORE_KIND!r}, got "
                                     f"{manifest.get('kind')!r}")
        if int(manifest.get("format", -1)) > STORE_FORMAT:
            raise StoreError(
                "format", f"store format {manifest.get('format')} is "
                          f"newer than this build understands "
                          f"(<= {STORE_FORMAT})")
        for field in ("dim", "dtype", "model_fingerprint", "rows",
                      "shards"):
            if field not in manifest:
                raise StoreError(field, f"missing from {MANIFEST_NAME} "
                                        f"(torn write?)")
        if manifest["dtype"] not in STORE_DTYPES:
            raise StoreError("dtype",
                             f"unknown dtype {manifest['dtype']!r}")
        if not manifest.get("complete") and not allow_partial:
            raise StoreError(
                "complete",
                f"store at {base} is incomplete (embed job still "
                f"running or killed mid-way; re-run `embed` to finish "
                f"it, or pass allow_partial to read the committed "
                f"prefix)")
        if expect_fingerprint is not None and \
                manifest["model_fingerprint"] != expect_fingerprint:
            raise StoreError(
                "model_fingerprint",
                f"store was embedded by {manifest['model_fingerprint']!r}"
                f" but the consumer expects {expect_fingerprint!r} — "
                f"mixing embedding spaces returns garbage neighbors")
        dim = int(manifest["dim"])
        want_dtype = np.dtype(manifest["dtype"])
        shards: List[np.ndarray] = []
        ids: List[str] = []
        total = 0
        for rec in manifest["shards"]:
            p = os.path.join(base, rec["file"])
            if not os.path.isfile(p):
                raise StoreError("shards",
                                 f"{rec['file']} missing on disk")
            arr = np.load(p, mmap_mode="r")
            if arr.dtype != want_dtype:
                raise StoreError(
                    f"{rec['file']}.dtype",
                    f"expected {want_dtype} per manifest, file holds "
                    f"{arr.dtype}")
            if arr.ndim != 2 or arr.shape[1] != dim or \
                    arr.shape[0] != int(rec["rows"]):
                raise StoreError(
                    f"{rec['file']}.shape",
                    f"expected ({rec['rows']}, {dim}), file holds "
                    f"{tuple(arr.shape)}")
            ids_path = os.path.join(base, rec["ids_file"])
            if not os.path.isfile(ids_path):
                raise StoreError("shards",
                                 f"{rec['ids_file']} missing on disk")
            with open(ids_path) as f:
                shard_ids = f.read().splitlines()
            if len(shard_ids) != int(rec["rows"]):
                raise StoreError(
                    f"{rec['ids_file']}.rows",
                    f"{len(shard_ids)} ids for {rec['rows']} vectors "
                    f"(torn sidecar)")
            shards.append(arr)
            ids.extend(shard_ids)
            total += arr.shape[0]
        if manifest.get("complete") and total != int(manifest["rows"]):
            raise StoreError(
                "rows", f"manifest says {manifest['rows']} rows but the "
                        f"shards hold {total}")
        return cls(base, manifest, shards, ids)
