"""IVF-flat approximate-nearest-neighbor index over a code-vector store.

The counterpart of code2vec_tpu/retrieval/index.py, with the same
artifact: `index_meta.json`, `centroids.npy`, `list_offsets.npy`,
`vectors.npy`, `ids.txt` and `store_rows.npy`, interchangeable both ways
(an index built by either package loads and searches in the other).

- Coarse quantizer and inverted lists (`ivf_lists`, also the MIPS
  head's): Lloyd k-means from the reference's numpy
  `default_rng(seed).permutation` init; each step is K9 kmeans_assign and
  K10 kmeans_update (kernels/kmeans.py) on the device. Empty clusters
  keep their previous centroid; cosine indexes run spherical k-means.
  Every vector then goes to its nearest centroid (K9) and the store is
  re-ordered list-contiguously by a stable sort, so probing a list reads
  a contiguous slice.
- Query: K11 ivf_search (kernels/ivf.py) picks the top-nprobe lists by
  centroid inner product and the top k of their rows.
- Brute force: K3's float32 mode (kernels/topk.py) over the whole store,
  the small-corpus backend and the exact ground truth `measure_recall`
  scores IVF against. With nprobe = nlist both return the same neighbors.

Similarity is cosine by default (vectors L2-normalised at build, queries
at search; distance = 1 - score) or raw dot (distance = -score). The
reference's metrics (:296, :451): `retrieval_searches_total{backend}`
and the loaded index's `retrieval_index_rows`.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from code2vec_tpu_torch import obs
from code2vec_tpu_torch.kernels.ivf import ivf_search
from code2vec_tpu_torch.kernels.kmeans import kmeans_assign, kmeans_update
from code2vec_tpu_torch.kernels.topk import blockwise_topk
from code2vec_tpu_torch.retrieval.store import VectorStore, _atomic_write_json

INDEX_META_NAME = "index_meta.json"
INDEX_KIND = "code2vec_ivf_index"
INDEX_FORMAT = 1
BACKEND_IVF = "ivf_flat"
BACKEND_BRUTE = "brute_force"
METRICS = ("cosine", "dot")
# Below this row count IVF cannot beat one small matmul: index-build
# falls back to the brute-force backend (still a valid index artifact).
MIN_IVF_ROWS = 256
_TOPK_BLOCK = 4096


class IndexArtifactError(ValueError):
    """Index artifact rejected with the offending field named."""

    def __init__(self, field: str, message: str):
        super().__init__(f"retrieval index field `{field}`: {message}")
        self.field = field


def _normalize(x: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(norms, 1e-12)


def _on(x, device) -> torch.Tensor:
    """An f32 contiguous tensor on `device` from a numpy array or tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).contiguous()
    a = np.ascontiguousarray(x, dtype=np.float32)
    if not a.flags.writeable:  # a memory-mapped artifact file
        a = a.copy()
    return torch.from_numpy(a).to(device)


# ------------------------------------------------------------------ k-means

def lloyd(x: torch.Tensor, centroids: torch.Tensor, iters: int,
          spherical: bool = False) -> torch.Tensor:
    """`iters` Lloyd steps on the device of `x`: K9 then K10 per step."""
    for _ in range(int(iters)):
        centroids = kmeans_update(x, kmeans_assign(x, centroids), centroids,
                                  spherical)
    return centroids


def ivf_lists(x, nlist: int, iters: int, seed: int = 0,
              spherical: bool = False, device="cuda"
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The coarse quantizer and inverted lists of (N, D) vectors (numpy
    or a tensor), on `device`: the reference's train_kmeans (init from
    numpy's default_rng(seed) permutation, `iters` Lloyd steps,
    `spherical` for cosine) and assign_lists (K9 once more), then the
    rows grouped by list.

    Returns (centroids (C, D) f32, order (N,) int64, offsets (C + 1,)
    int64) on `device`, C = min(nlist, N): list c holds the rows
    order[offsets[c]:offsets[c + 1]], in row order (a stable sort, so
    ties in a search resolve identically run to run)."""
    xd = _on(x, device)
    n = xd.shape[0]
    nlist = int(min(nlist, n))
    init = torch.from_numpy(np.random.default_rng(seed).permutation(n)
                            [:nlist]).to(xd.device)
    centroids = lloyd(xd, xd[init], iters, spherical)
    assign = kmeans_assign(xd, centroids).long()
    order = torch.sort(assign, stable=True).indices
    offsets = torch.zeros(nlist + 1, dtype=torch.int64, device=xd.device)
    offsets[1:] = torch.cumsum(torch.bincount(assign, minlength=nlist), 0)
    return centroids, order, offsets


# -------------------------------------------------------------------- build

def build_index(store_dir: str, out_dir: str, nlist: int = 0,
                nprobe: int = 8, kmeans_iters: int = 10, seed: int = 0,
                metric: str = "cosine", log=None, device="cuda") -> dict:
    """Build an index artifact at `out_dir` from the vector store at
    `store_dir`, k-means on `device`; returns the index meta dict."""
    log = log or print
    if metric not in METRICS:
        raise IndexArtifactError("metric",
                                 f"must be one of {METRICS}, got {metric!r}")
    store = VectorStore.open(store_dir)
    n = store.rows
    if n == 0:
        raise IndexArtifactError("rows", f"vector store {store_dir} is "
                                         f"empty; nothing to index")
    x = store.load(np.float32)
    if metric == "cosine":
        x = _normalize(x)
    if nlist <= 0:
        nlist = max(1, int(math.isqrt(n)))
    nlist = min(nlist, n)
    backend = BACKEND_IVF if (n >= MIN_IVF_ROWS and nlist > 1) \
        else BACKEND_BRUTE

    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    if backend == BACKEND_IVF:
        centroids, store_order, offsets = (
            t.cpu().numpy() for t in ivf_lists(
                x, nlist, kmeans_iters, seed, spherical=(metric == "cosine"),
                device=device))
        np.save(os.path.join(out_dir, "centroids.npy"), centroids)
        np.save(os.path.join(out_dir, "list_offsets.npy"), offsets)
    else:
        nlist = 1
        store_order = np.arange(n, dtype=np.int64)
    # vectors re-ordered list-contiguously, in the store's dtype (fp16
    # stays fp16 on disk; search computes in f32)
    ordered = x[store_order].astype(np.dtype(store.dtype))
    np.save(os.path.join(out_dir, "vectors.npy"), ordered)
    ids = store.ids
    with open(os.path.join(out_dir, "ids.txt.tmp"), "w") as f:
        for row in store_order:
            f.write(ids[int(row)] + "\n")
    os.replace(os.path.join(out_dir, "ids.txt.tmp"),
               os.path.join(out_dir, "ids.txt"))
    np.save(os.path.join(out_dir, "store_rows.npy"), store_order)

    nprobe = max(1, min(int(nprobe), nlist))
    meta = {
        "kind": INDEX_KIND,
        "format": INDEX_FORMAT,
        "backend": backend,
        "metric": metric,
        "dim": store.dim,
        "dtype": store.dtype,
        "rows": n,
        "nlist": int(nlist),
        "nprobe": nprobe,
        "kmeans_iters": int(kmeans_iters),
        "seed": int(seed),
        "model_fingerprint": store.fingerprint,
        "source_store": store.path,
        "build_seconds": round(time.perf_counter() - t0, 3),
    }
    # meta last: a kill mid-build leaves a directory load_index rejects
    # (missing meta) instead of a torn index that loads
    _atomic_write_json(os.path.join(out_dir, INDEX_META_NAME), meta)
    log(f"Built {backend} index at {out_dir}: {n} rows, dim {store.dim}, "
        f"nlist {nlist}, default nprobe {nprobe}, metric {metric}, "
        f"{meta['build_seconds']}s (fingerprint {store.fingerprint})")
    return meta


# --------------------------------------------------------------------- load

class NeighborIndex:
    """Loaded, validated index artifact with a `search` surface shared by
    both backends. Its arrays live on `device` and are read-only after
    load, so concurrent searches are safe."""

    def __init__(self, path: str, meta: dict, vectors: np.ndarray,
                 ids: List[str], store_rows: np.ndarray,
                 centroids: Optional[np.ndarray],
                 offsets: Optional[np.ndarray], device="cuda"):
        self.path = path
        self.meta = meta
        self.ids = ids
        self.store_rows = store_rows
        self.backend = meta["backend"]
        self.metric = meta["metric"]
        self.dim = int(meta["dim"])
        self.rows = int(meta["rows"])
        self.nlist = int(meta["nlist"])
        self.nprobe = int(meta["nprobe"])
        self.fingerprint = str(meta["model_fingerprint"])
        self.device = torch.device(device)
        self._vectors = _on(np.asarray(vectors, dtype=np.float32),
                            self.device)
        self._centroids = (None if centroids is None
                           else _on(centroids, self.device))
        self._offsets = self._max_len = None
        if offsets is not None:
            self._offsets = torch.from_numpy(
                np.asarray(offsets, dtype=np.int64)).to(self.device)
            self._max_len = max(int(np.diff(offsets).max()), 1)

    def search(self, queries: np.ndarray, k: int,
               nprobe: Optional[int] = None, exact: bool = False
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k neighbors of (B, dim) query vectors.

        Returns (positions, scores): positions (B, k) int32 into
        `self.ids`/`self.store_rows` (-1 where fewer than k candidates
        exist), scores (B, k) f32 descending (cosine or dot per the index
        metric). `exact=True` forces the brute-force path, the recall
        ground truth."""
        q = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        if q.shape[1] != self.dim:
            raise ValueError(f"query dim {q.shape[1]} != index dim "
                             f"{self.dim}")
        if self.metric == "cosine":
            q = _normalize(q)
        k = max(1, min(int(k), self.rows))
        qd = _on(q, self.device)
        if exact or self.backend == BACKEND_BRUTE:
            backend = "brute"
            out = blockwise_topk(qd, self._vectors, k,
                                 min(_TOPK_BLOCK, self.rows),
                                 compute_dtype=torch.float32)
            vals, pos = out.values, out.indices
        else:
            backend = "ivf"
            np_probe = self.nprobe if nprobe is None else \
                max(1, min(int(nprobe), self.nlist))
            vals, pos = ivf_search(qd, self._centroids, self._vectors,
                                   self._offsets, np_probe, k,
                                   max_len=self._max_len)
        obs.counter("retrieval_searches_total",
                    "ANN searches by backend", backend=backend).inc()
        vals = vals.cpu().numpy()
        pos = pos.cpu().numpy()
        # candidate shortfall surfaces as -inf scores; normalise to
        # position -1 so callers need no score sentinel
        pos = np.where(np.isfinite(vals), pos, -1).astype(np.int32)
        return pos, vals

    def distances(self, scores: np.ndarray) -> np.ndarray:
        """Metric-appropriate distance of a score array: 1 - cosine, or
        -dot. -inf scores (missing candidates) map to +inf distance."""
        with np.errstate(invalid="ignore"):
            d = (1.0 - scores) if self.metric == "cosine" else -scores
        return np.where(np.isfinite(scores), d, np.inf)


def load_index(path: str, expect_fingerprint: Optional[str] = None,
               device="cuda") -> NeighborIndex:
    base = os.path.abspath(path)
    meta_path = os.path.join(base, INDEX_META_NAME)
    if not os.path.isfile(meta_path):
        raise IndexArtifactError(
            "kind", f"{base} is not a retrieval index ({INDEX_META_NAME} "
                    f"missing); indexes are built by the `index-build` "
                    f"subcommand")
    with open(meta_path) as f:
        try:
            meta = json.load(f)
        except json.JSONDecodeError as e:
            raise IndexArtifactError("kind",
                                     f"unparseable {INDEX_META_NAME}: {e}")
    if meta.get("kind") != INDEX_KIND:
        raise IndexArtifactError("kind", f"expected {INDEX_KIND!r}, got "
                                         f"{meta.get('kind')!r}")
    if int(meta.get("format", -1)) > INDEX_FORMAT:
        raise IndexArtifactError(
            "format", f"index format {meta.get('format')} is newer than "
                      f"this build understands (<= {INDEX_FORMAT})")
    for field in ("backend", "metric", "dim", "dtype", "rows", "nlist",
                  "nprobe", "model_fingerprint"):
        if field not in meta:
            raise IndexArtifactError(
                field, f"missing from {INDEX_META_NAME} (torn build?)")
    if meta["backend"] not in (BACKEND_IVF, BACKEND_BRUTE):
        raise IndexArtifactError("backend",
                                 f"unknown backend {meta['backend']!r}")
    if meta["metric"] not in METRICS:
        raise IndexArtifactError("metric",
                                 f"unknown metric {meta['metric']!r}")
    if expect_fingerprint is not None and \
            meta["model_fingerprint"] != expect_fingerprint:
        raise IndexArtifactError(
            "model_fingerprint",
            f"index was built over vectors from "
            f"{meta['model_fingerprint']!r} but the serving model is "
            f"{expect_fingerprint!r} — refusing to answer /neighbors "
            f"across embedding spaces")
    rows, dim = int(meta["rows"]), int(meta["dim"])
    vec_path = os.path.join(base, "vectors.npy")
    if not os.path.isfile(vec_path):
        raise IndexArtifactError("vectors", "vectors.npy missing")
    vectors = np.load(vec_path, mmap_mode="r")
    if tuple(vectors.shape) != (rows, dim):
        raise IndexArtifactError(
            "vectors.shape", f"expected ({rows}, {dim}) per meta, file "
                             f"holds {tuple(vectors.shape)}")
    if vectors.dtype != np.dtype(meta["dtype"]):
        raise IndexArtifactError(
            "vectors.dtype", f"expected {meta['dtype']} per meta, file "
                             f"holds {vectors.dtype}")
    ids_path = os.path.join(base, "ids.txt")
    if not os.path.isfile(ids_path):
        raise IndexArtifactError("ids", "ids.txt missing")
    with open(ids_path) as f:
        ids = f.read().splitlines()
    if len(ids) != rows:
        raise IndexArtifactError(
            "ids", f"{len(ids)} ids for {rows} vectors (torn sidecar)")
    store_rows_path = os.path.join(base, "store_rows.npy")
    if not os.path.isfile(store_rows_path):
        raise IndexArtifactError("store_rows", "store_rows.npy missing")
    store_rows = np.load(store_rows_path)
    if store_rows.shape != (rows,):
        raise IndexArtifactError(
            "store_rows.shape", f"expected ({rows},), file holds "
                                f"{tuple(store_rows.shape)}")
    centroids = offsets = None
    if meta["backend"] == BACKEND_IVF:
        cpath = os.path.join(base, "centroids.npy")
        opath = os.path.join(base, "list_offsets.npy")
        if not os.path.isfile(cpath):
            raise IndexArtifactError("centroids", "centroids.npy missing")
        if not os.path.isfile(opath):
            raise IndexArtifactError("list_offsets",
                                     "list_offsets.npy missing")
        centroids = np.load(cpath)
        nlist = int(meta["nlist"])
        if tuple(centroids.shape) != (nlist, dim):
            raise IndexArtifactError(
                "centroids.shape", f"expected ({nlist}, {dim}), file "
                                   f"holds {tuple(centroids.shape)}")
        offsets = np.load(opath)
        if offsets.shape != (nlist + 1,) or int(offsets[-1]) != rows:
            raise IndexArtifactError(
                "list_offsets",
                f"expected ({nlist + 1},) ending at {rows}, file holds "
                f"{tuple(offsets.shape)} ending at "
                f"{int(offsets[-1]) if len(offsets) else 'nothing'}")
    obs.gauge("retrieval_index_rows",
              "rows in the mounted/loaded retrieval index").set(rows)
    return NeighborIndex(base, meta, np.asarray(vectors), ids, store_rows,
                         centroids, offsets, device=device)


def measure_recall(index: NeighborIndex, queries: np.ndarray, k: int,
                   nprobe: Optional[int] = None) -> float:
    """recall@k of the index's ANN path against its own brute-force
    exact ground truth: |ANN ∩ exact| / (|queries| * k), neighbor
    identity by position set."""
    approx_pos, _ = index.search(queries, k, nprobe=nprobe)
    exact_pos, _ = index.search(queries, k, exact=True)
    hits = 0
    total = 0
    for a, e in zip(approx_pos, exact_pos):
        truth = set(int(i) for i in e if i >= 0)
        if not truth:
            continue
        hits += len(truth & set(int(i) for i in a if i >= 0))
        total += len(truth)
    return hits / max(total, 1)
