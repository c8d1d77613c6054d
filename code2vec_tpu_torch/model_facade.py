"""The bucketed predict path: line parsing, context bucketing, row
padding, the (rows, bucket) step cache and the host-side assembly of
results. The counterpart of the predict part of code2vec_tpu/
model_facade.py BucketedPredictMixin (:66-395).

Each device batch is padded to a fixed row count and its context axis cut
to the smallest bucket that holds its deepest valid context, so the
shapes the kernels see are bounded by len(buckets) per row count.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from code2vec_tpu_torch.data.reader import (
    RowBatch, _pad_rows, parse_context_lines, slice_contexts, truncate_rows,
)
from code2vec_tpu_torch.serving.batcher import bucket_for


class ModelPredictionResults(NamedTuple):
    original_name: str
    topk_predicted_words: List[str]
    topk_predicted_words_scores: np.ndarray
    attention_per_context: Dict[Tuple[str, str, str], float]
    code_vector: Optional[np.ndarray] = None


class BucketedPredictMixin:
    """Requires on the host class: config, log, vocabs, device,
    context_buckets, _predict_steps (dict), `_make_predict_step(rows, m)`
    and `_call_predict_step(step, arrays)`."""

    def _make_predict_step(self, batch_rows: int, m: int):
        raise NotImplementedError

    def _call_predict_step(self, step, arrays):
        raise NotImplementedError

    def model_fingerprint(self) -> str:
        raise NotImplementedError

    def _get_bucketed_predict_step(self, batch_rows: int, m: int):
        key = (batch_rows, m)
        step = self._predict_steps.get(key)
        if step is None:
            step = self._predict_steps[key] = \
                self._make_predict_step(batch_rows, m)
            self.log(f"Built predict step for shape (rows={batch_rows}, "
                     f"contexts={m}) [{len(self._predict_steps)} of <= "
                     f"{len(self.context_buckets)} buckets]")
        return step

    def predict_compile_count(self) -> int:
        """Distinct (rows, bucket) predict shapes seen so far."""
        return len(self._predict_steps)

    def _default_predict_batch_size(self) -> int:
        return int(self.config.serve_batch_size)

    def predict(self, predict_data_lines: Iterable[str],
                batch_size: Optional[int] = None,
                with_code_vectors: Optional[bool] = None
                ) -> List[ModelPredictionResults]:
        """Per-line top-k words with softmax-normalised scores, attention
        per context and (optionally) the code vector, in `batch_size`-row
        chunks."""
        results: List[ModelPredictionResults] = []
        bs = int(batch_size or self._default_predict_batch_size())
        if with_code_vectors is None:
            with_code_vectors = self.config.export_code_vectors
        it = iter(predict_data_lines)
        while True:
            lines = list(itertools.islice(it, bs))
            if not lines:
                return results
            results.extend(self._predict_chunk(lines, bs, with_code_vectors))

    def _predict_chunk(self, lines: List[str], bs: int,
                       with_code_vectors: bool
                       ) -> List[ModelPredictionResults]:
        chunk = parse_context_lines(lines, self.vocabs,
                                    self.config.max_contexts)
        return self._predict_parsed(chunk, len(lines), bs, with_code_vectors)

    def _to_device(self, batch: RowBatch):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                     for a in batch.model_arrays())

    def bucketed_batch(self, chunk: RowBatch, bs: int) -> RowBatch:
        """`chunk` as one device batch: its context axis cut to the
        smallest bucket that holds its deepest valid context, its rows
        cut or padded to `bs`."""
        any_valid_col = chunk.context_valid_mask.any(axis=0)
        deepest = (int(np.nonzero(any_valid_col)[0][-1]) + 1
                   if any_valid_col.any() else 1)
        chunk = slice_contexts(chunk, bucket_for(deepest,
                                                 self.context_buckets))
        if chunk.target_index.shape[0] > bs:
            chunk = truncate_rows(chunk, bs)
        return _pad_rows(chunk, bs)

    def _predict_parsed(self, chunk: RowBatch, n: int, bs: int,
                        with_code_vectors: bool
                        ) -> List[ModelPredictionResults]:
        chunk = self.bucketed_batch(chunk, bs)
        m = chunk.context_valid_mask.shape[1]
        step = self._get_bucketed_predict_step(bs, m)
        out = self._call_predict_step(step, self._to_device(chunk))
        topk_idx = out.topk_indices[:n].cpu().numpy()
        topk_val = out.topk_values[:n].cpu().numpy()
        code_vectors = out.code_vectors[:n].cpu().numpy()
        attention = out.attention[:n].cpu().numpy()
        # normalize_scores: softmax over the k values
        e = np.exp(topk_val - topk_val.max(axis=1, keepdims=True))
        scores = e / e.sum(axis=1, keepdims=True)
        results: List[ModelPredictionResults] = []
        for i in range(n):
            words = [self.vocabs.target_vocab.lookup_word(int(j))
                     for j in topk_idx[i]]
            attention_per_context: Dict[Tuple[str, str, str], float] = {}
            for j in range(m):
                s = chunk.source_strings[i, j]
                p = chunk.path_strings[i, j]
                t = chunk.target_token_strings[i, j]
                if s or p or t:
                    attention_per_context[(s, p, t)] = float(attention[i, j])
            results.append(ModelPredictionResults(
                original_name=(chunk.target_strings[i]
                               if chunk.target_strings else ""),
                topk_predicted_words=words,
                topk_predicted_words_scores=scores[i],
                attention_per_context=attention_per_context,
                code_vector=code_vectors[i] if with_code_vectors else None))
        return results
