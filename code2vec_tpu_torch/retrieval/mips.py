"""Approximate-MIPS prediction head: the retrieval stack's IVF coarse
quantizer pointed at the target-name classifier table.

The counterpart of code2vec_tpu/retrieval/mips.py over a target table
of any scheme: f32, int8, fp8 (e4m3, e5m2) or packed int4.

- Build (once, at model load): Lloyd k-means (K9, K10; plain L2, not
  spherical) over the dequantized real-vocab rows, then the rows
  reordered list-contiguously in their quantized form, with their scales
  and their global vocab ids beside them.
- Search (`topk_fn`): K11 ivf_search in the instantiation of the table's
  format (f32, int8, fp8 or int4): the top-`nprobe` lists by centroid
  inner product, the exact score (cv . float(row)) * scale of every row
  in them (f32, as code2vec_tpu/retrieval/mips.py:166-172), and the top k
  mapped to global vocab ids. Dead slots hold id 0 and value -inf, the
  blockwise head's sentinel.

Scores of returned candidates are exact; only the candidate set is
approximate. nprobe = nlist searches every row. A built head sets the
reference's `serving_mips_nlist` gauge.
"""

from __future__ import annotations

import math
import time
from typing import Optional, Tuple

import numpy as np
import torch

from code2vec_tpu_torch import obs
from code2vec_tpu_torch.kernels.ivf import ivf_search
from code2vec_tpu_torch.ops.quant import decode_rows
from code2vec_tpu_torch.retrieval.index import _on, ivf_lists


class MipsHead:
    """Coarse quantizer + list-contiguous quantized rows on one device.
    Read-only after build, so concurrent searches are safe."""

    def __init__(self, centroids: np.ndarray, rows: torch.Tensor,
                 scales: Optional[np.ndarray], offsets: np.ndarray,
                 global_ids: np.ndarray, *, real_vocab: int, nprobe: int,
                 build_seconds: float, device="cuda"):
        self.device = torch.device(device)
        self._centroids = _on(centroids, self.device)
        self._rows = rows.contiguous().to(self.device)
        self._scales = (None if scales is None else _on(
            np.asarray(scales, np.float32).reshape(-1), self.device))
        self._offsets = torch.from_numpy(
            np.asarray(offsets, dtype=np.int64)).to(self.device)
        self._global_ids = torch.from_numpy(
            np.asarray(global_ids, dtype=np.int32)).to(self.device)
        self.max_len = max(int(np.diff(offsets).max()), 1)
        self.real_vocab = int(real_vocab)
        self.nlist = int(centroids.shape[0])
        self.nprobe = max(1, min(int(nprobe), self.nlist))
        self.build_seconds = build_seconds
        obs.gauge("serving_mips_nlist",
                  "coarse-quantizer size of the approximate-MIPS "
                  "prediction head (0 = head not built)").set(self.nlist)

    @classmethod
    def build(cls, table, scales, *, real_vocab: int, nlist: int = 0,
              nprobe: int = 8, kmeans_iters: int = 6, seed: int = 0, log=None,
              device="cuda") -> "MipsHead":
        """Train the coarse quantizer over the real vocab rows of a target
        table and reorder the rows list-contiguously. `table` is f32
        (scales None), or int8, fp8 (a torch.float8_e4m3fn / float8_e5m2
        tensor) or packed int4 (uint8, two values a byte: an even width)
        with (V, 1) f32 scales. Padded classifier rows (>= real_vocab) are left out: they
        can never be predicted."""
        t0 = time.perf_counter()
        rows = (table if isinstance(table, torch.Tensor)
                else torch.from_numpy(np.asarray(table)))[:real_vocab].cpu()
        scales_np = None if scales is None else \
            np.asarray(scales, np.float32)[:real_vocab]
        if scales_np is None:
            if rows.dtype != torch.float32:
                raise ValueError(f"a {rows.dtype} target table needs its "
                                 f"scales")
            x = rows.numpy()
        else:
            x = decode_rows(rows).numpy() * scales_np
        n = x.shape[0]
        if nlist <= 0:
            nlist = max(1, int(math.isqrt(n)))
        centroids, order, offsets = (t.cpu().numpy() for t in ivf_lists(
            x, nlist, kmeans_iters, seed, device=device))
        nlist = centroids.shape[0]
        head = cls(centroids, rows[torch.from_numpy(order).long()],
                   None if scales_np is None else scales_np[order],
                   offsets, order.astype(np.int32), real_vocab=n,
                   nprobe=nprobe, device=device,
                   build_seconds=round(time.perf_counter() - t0, 3))
        if log:
            log(f"MIPS head built over {n} target rows: nlist {nlist}, "
                f"default nprobe {head.nprobe}, max list {head.max_len}, "
                f"{head.build_seconds}s")
        return head

    def topk_fn(self, k: int, nprobe: Optional[int] = None):
        """(code_vectors (B, D) f32 tensor on the head's device) ->
        (values (B, k) f32, indices (B, k) int32 global vocab ids)."""
        nprobe = self.nprobe if nprobe is None else \
            max(1, min(int(nprobe), self.nlist))
        k = max(1, min(int(k), self.real_vocab))

        def topk(code_vectors: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
            return ivf_search(code_vectors.float().contiguous(),
                              self._centroids, self._rows, self._offsets,
                              nprobe, k, scales=self._scales,
                              global_ids=self._global_ids,
                              max_len=self.max_len)

        return topk

    def search(self, code_vectors: np.ndarray, k: int,
               nprobe: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Host convenience wrapper: numpy in, numpy (values, ids) out."""
        vals, idx = self.topk_fn(k, nprobe)(_on(code_vectors, self.device))
        return vals.cpu().numpy(), idx.cpu().numpy()
