"""Serving mount for the retrieval index: the /neighbors data plane.

The counterpart of code2vec_tpu/retrieval/api.py. `serve
--retrieval_index DIR` mounts a built index into the PredictionServer; a
/neighbors request runs the /predict pipeline (extractor, batcher, the
device step) and then searches the index with the batch's code vectors.

Embedding-space safety is the handle's job:

- MOUNT: the index's recorded `model_fingerprint` must equal the live
  model's; a mismatch refuses to mount.
- SERVE: every /neighbors answer re-checks that the fingerprint of the
  model that computed the batch equals the index's.
- DETACH: `detach(reason)` turns the handle off for good (/neighbors
  then answers 503); the reference calls it from a hot swap, which the
  port has not ported yet.

Search limits: k and nprobe are bucketed to powers of two, as the
reference does, and k is clamped to the index rows; the search kernels
(K3's float32 mode, K11) take any such k (above 64 through K13). The
reference's `obs` metrics (retrieval_search_seconds,
serving_retrieval_detached_total) and trace spans are not ported.
"""

from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np

from code2vec_tpu_torch.retrieval.index import NeighborIndex, load_index


def _pow2_ceil(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


class EmbeddingSpaceMismatch(RuntimeError):
    """A /neighbors answer would have crossed embedding spaces (model
    fingerprint != index fingerprint); maps to 503."""


class RetrievalHandle:
    """The server's handle on one mounted index. `detach()` is one-way
    and atomic with respect to `require_attached()` readers; a detached
    handle keeps its status (and the reason) for /healthz."""

    def __init__(self, index: NeighborIndex, default_topk: int = 10):
        self.index = index
        self.default_topk = int(default_topk)
        self._lock = threading.Lock()
        self._attached = True
        self._detach_reason: Optional[str] = None

    @classmethod
    def mount(cls, path: str, model_fingerprint: str,
              default_topk: int = 10, log=None,
              device="cuda") -> "RetrievalHandle":
        """Load + fingerprint-check an index for a live model. Raises
        IndexArtifactError (named field) on any validation failure,
        including an embedding-space mismatch."""
        index = load_index(path, expect_fingerprint=model_fingerprint,
                           device=device)
        handle = cls(index, default_topk=default_topk)
        if log is not None:
            log(f"Retrieval index mounted from {path}: "
                f"{index.rows} rows, backend {index.backend}, "
                f"nlist {index.nlist}, default nprobe {index.nprobe}, "
                f"metric {index.metric} (fingerprint "
                f"{index.fingerprint})")
        return handle

    @property
    def attached(self) -> bool:
        with self._lock:
            return self._attached

    @property
    def fingerprint(self) -> str:
        return self.index.fingerprint

    def detach(self, reason: str) -> None:
        with self._lock:
            if not self._attached:
                return
            self._attached = False
            self._detach_reason = reason

    def status(self) -> dict:
        with self._lock:
            attached, reason = self._attached, self._detach_reason
        return {
            "status": "attached" if attached else "detached",
            "detach_reason": reason,
            "fingerprint": self.index.fingerprint,
            "path": self.index.path,
            "backend": self.index.backend,
            "metric": self.index.metric,
            "rows": self.index.rows,
            "nlist": self.index.nlist,
            "nprobe": self.index.nprobe,
            "default_topk": self.default_topk,
        }

    def require_attached(self) -> None:
        with self._lock:
            if not self._attached:
                raise EmbeddingSpaceMismatch(
                    f"retrieval index detached: {self._detach_reason}")

    def search_k(self, k: Optional[int] = None) -> int:
        """The k the search runs at: the request's (or the default),
        clamped to the index rows and bucketed to a power of two."""
        k = self.default_topk if k is None else max(1, int(k))
        k = min(k, self.index.rows)
        return min(_pow2_ceil(k), self.index.rows)

    def neighbors(self, code_vectors: np.ndarray, result_fingerprint: str,
                  k: Optional[int] = None, nprobe: Optional[int] = None
                  ) -> List[List[dict]]:
        """Per-query neighbor lists for one batch of code vectors
        computed by the model identified by `result_fingerprint`. The
        fingerprint check is per response: the vectors only turn into
        neighbors if they came out of the index's own embedding space."""
        self.require_attached()
        if result_fingerprint != self.index.fingerprint:
            raise EmbeddingSpaceMismatch(
                f"batch was embedded by {result_fingerprint!r} but the "
                f"index holds vectors from {self.index.fingerprint!r}")
        # client knobs are bucketed to powers of two, so a client walking
        # k = 1, 2, 3, ... meets a bounded set of search shapes; results
        # are sliced back to the requested k
        k_eff = self.search_k(k)
        k = min(self.default_topk if k is None else max(1, int(k)),
                self.index.rows)
        nprobe_eff = None
        if nprobe is not None:
            nprobe_eff = min(_pow2_ceil(max(1, int(nprobe))),
                             self.index.nlist)
        pos, scores = self.index.search(
            np.asarray(code_vectors, dtype=np.float32), k_eff,
            nprobe=nprobe_eff)
        dists = self.index.distances(scores)
        out: List[List[dict]] = []
        for row_pos, row_scores, row_dists in zip(pos, scores, dists):
            row = []
            for p, s, d in zip(row_pos[:k], row_scores[:k],
                               row_dists[:k]):
                if p < 0:
                    continue  # fewer candidates than k in the probed lists
                row.append({"id": self.index.ids[int(p)],
                            "store_row": int(self.index.store_rows[int(p)]),
                            "score": float(s),
                            "distance": float(d)})
            out.append(row)
        return out
