"""Evaluation metrics: top-k accuracy and subtoken precision/recall/F1.

A copy of code2vec_tpu/evaluation/metrics.py (host-side numpy), importing
the port's own string helpers and vocabulary.

The reference has two implementations with subtly different edge cases
(Python host-side, tensorflow_model.py:449-512, vs in-graph Keras,
keras_words_subtoken_metrics.py). Per SURVEY.md §7 ("hard parts") the
Python/eval definition is canonical here:

- a prediction is the first *legal* word among the top-k (legal: not OOV
  and ^[a-zA-Z|]+$, common.py:122-129);
- subtoken tp/fp/fn count duplicate occurrences via Counter membership
  (tensorflow_model.py:457-468);
- top-k accuracy marks ranks >= the first normalized match's index within
  the FILTERED list (common.py:180-187, tensorflow_model.py:502-508).

One deliberate robustness fix: the reference crashes when no top-k word is
legal (`[0]` on an empty list, tensorflow_model.py:459); here that case
counts all original subtokens as false negatives instead (a strictly more
conservative score; with k=10 over a real model it virtually never fires).

Device->host flow: the model's eval step emits top-k *indices*; the
`TargetWordTables` cache maps indices to words/legality/normalized forms
once per vocab so the per-batch host work is dict lookups, not regex.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from code2vec_tpu_torch.common import (
    get_subtokens, is_legal_method_name, normalize_word,
)
from code2vec_tpu_torch.vocab import Vocab


class ModelEvaluationResults(NamedTuple):
    # reference: model_base.py:11-26
    topk_acc: np.ndarray
    subtoken_precision: float
    subtoken_recall: float
    subtoken_f1: float
    loss: Optional[float] = None

    def __str__(self):
        res = (f"topk_acc: {self.topk_acc}, precision: {self.subtoken_precision}, "
               f"recall: {self.subtoken_recall}, F1: {self.subtoken_f1}")
        if self.loss is not None:
            res = f"loss: {self.loss}, " + res
        return res

    def tb_scalars(self):
        """(tag, value) pairs for scalar logging (utils/tb.py)."""
        out = [("top1_acc", float(self.topk_acc[0])),
               ("topk_acc", float(self.topk_acc[-1])),
               ("subtoken_precision", float(self.subtoken_precision)),
               ("subtoken_recall", float(self.subtoken_recall)),
               ("subtoken_f1", float(self.subtoken_f1))]
        if self.loss is not None:
            out.append(("loss", float(self.loss)))
        return out


class TargetWordTables:
    """Per-target-vocab-index caches: word, legality, normalized form,
    subtoken Counter. Built lazily (predictions concentrate on a small set
    of frequent names)."""

    def __init__(self, target_vocab: Vocab):
        self.vocab = target_vocab
        self.oov_word = target_vocab.special_words.oov
        self._legal: Dict[int, bool] = {}
        self._normalized: Dict[int, str] = {}
        self._subtokens: Dict[int, Counter] = {}
        self._vec = None
        self._name_norm_cache: Dict[str, str] = {}
        self._subtokens_by_name: Dict[str, Counter] = {}

    def vec_arrays(self):
        """(legal bool (V,), norm_id int (V,), norm->id dict): whole-vocab
        legality/normalized-form tables for the vectorized batch pass.
        Built once (~1s for the 261K java14m target vocab), then every
        batch update is numpy indexing instead of per-row dict lookups —
        the difference between ~13K and >100K host-side examples/sec."""
        if self._vec is None:
            v = self.vocab.size
            legal = np.zeros(v, bool)
            norm_id = np.zeros(v, np.int64)
            norm_to_id: Dict[str, int] = {}
            for i in range(v):
                w = self.vocab.lookup_word(i)
                legal[i] = is_legal_method_name(w, self.oov_word)
                n = normalize_word(w)
                norm_id[i] = norm_to_id.setdefault(n, len(norm_to_id))
            self._vec = (legal, norm_id, norm_to_id)
        return self._vec

    def normalized_name(self, name: str) -> str:
        cached = self._name_norm_cache.get(name)
        if cached is None:
            cached = self._name_norm_cache[name] = normalize_word(name)
        return cached

    def subtokens_of_name(self, name: str) -> Counter:
        """Subtoken Counter for an arbitrary (possibly-OOV) original name;
        cached — frequent names dominate real corpora."""
        cached = self._subtokens_by_name.get(name)
        if cached is None:
            cached = self._subtokens_by_name[name] = Counter(
                get_subtokens(name))
        return cached

    def word(self, index: int) -> str:
        return self.vocab.lookup_word(index)

    def legal(self, index: int) -> bool:
        cached = self._legal.get(index)
        if cached is None:
            cached = is_legal_method_name(self.word(index), self.oov_word)
            self._legal[index] = cached
        return cached

    def normalized(self, index: int) -> str:
        cached = self._normalized.get(index)
        if cached is None:
            cached = normalize_word(self.word(index))
            self._normalized[index] = cached
        return cached

    def subtoken_counter(self, index: int) -> Counter:
        cached = self._subtokens.get(index)
        if cached is None:
            cached = Counter(get_subtokens(self.word(index)))
            self._subtokens[index] = cached
        return cached


class BatchPredictionInfo(NamedTuple):
    """One vectorized pass over a (B, k) top-k index batch, shared by both
    metrics and the per-example audit log so the work happens once.

    match_rank[i]: rank of the first normalized match within the row's
    LEGAL-filtered prediction list (-1: no match) — the reference's
    `filtered` rank semantics (tensorflow_model.py:502-508).
    match_idx[i]: that prediction's vocab index (-1: none).
    first_legal_idx[i]: the row's prediction for the subtoken metric —
    first legal word in the top-k (-1: none legal).
    """
    match_rank: np.ndarray       # (B,) int
    match_idx: np.ndarray        # (B,) int
    first_legal_idx: np.ndarray  # (B,) int


def batch_prediction_info(tables: TargetWordTables,
                          original_names: Sequence[str],
                          topk_indices: np.ndarray) -> BatchPredictionInfo:
    legal_arr, norm_id_arr, norm_to_id = tables.vec_arrays()
    topk = np.asarray(topk_indices)
    b = topk.shape[0]
    # indices past the real vocab (padded logit columns) are illegal
    in_vocab = topk < len(legal_arr)
    safe = np.minimum(topk, len(legal_arr) - 1)
    legal = legal_arr[safe] & in_vocab                      # (B, k)
    orig_ids = np.fromiter(
        (norm_to_id.get(tables.normalized_name(n), -1) for n in original_names),
        dtype=np.int64, count=b)
    match = legal & (norm_id_arr[safe] == orig_ids[:, None])
    rows = np.arange(b)
    any_match = match.any(axis=1)
    j = np.where(any_match, match.argmax(axis=1), 0)
    # rank within the legal-filtered list = # legal entries strictly
    # before the match = inclusive-cumsum at the match minus one
    legal_cum = np.cumsum(legal, axis=1)
    match_rank = np.where(any_match, legal_cum[rows, j] - 1, -1)
    match_idx = np.where(any_match, topk[rows, j], -1)
    any_legal = legal.any(axis=1)
    j0 = np.where(any_legal, legal.argmax(axis=1), 0)
    first_legal_idx = np.where(any_legal, topk[rows, j0], -1)
    return BatchPredictionInfo(match_rank, match_idx, first_legal_idx)


class TopKAccuracyEvaluationMetric:
    """reference: tensorflow_model.py:495-512."""

    def __init__(self, top_k: int, tables: TargetWordTables):
        self.top_k = top_k
        self.tables = tables
        self.nr_correct_predictions = np.zeros(top_k)
        self.nr_predictions = 0

    def update_batch_from_indices(self, original_names: Sequence[str],
                                  topk_indices: np.ndarray,
                                  info: Optional[BatchPredictionInfo] = None
                                  ) -> None:
        if info is None:
            info = batch_prediction_info(self.tables, original_names,
                                         topk_indices)
        self.nr_predictions += len(original_names)
        ranks = info.match_rank[(info.match_rank >= 0)
                                & (info.match_rank < self.top_k)]
        # each match at rank r increments nr_correct[r:]; summed over the
        # batch that is the cumulative histogram of ranks
        hist = np.bincount(ranks, minlength=self.top_k)[:self.top_k]
        self.nr_correct_predictions += np.cumsum(hist)

    @property
    def topk_correct_predictions(self) -> np.ndarray:
        return self.nr_correct_predictions / max(self.nr_predictions, 1)


class SubtokensEvaluationMetric:
    """reference: tensorflow_model.py:449-492 (see module docstring for the
    no-legal-prediction edge case)."""

    def __init__(self, tables: TargetWordTables):
        self.tables = tables
        self.nr_true_positives = 0
        self.nr_false_positives = 0
        self.nr_false_negatives = 0
        self.nr_predictions = 0

    _EMPTY = Counter()

    def update_batch_from_indices(self, original_names: Sequence[str],
                                  topk_indices: np.ndarray,
                                  info: Optional[BatchPredictionInfo] = None
                                  ) -> None:
        t = self.tables
        if info is None:
            info = batch_prediction_info(t, original_names, topk_indices)
        for name, pred_idx in zip(original_names, info.first_legal_idx):
            prediction_counter = (t.subtoken_counter(int(pred_idx))
                                  if pred_idx >= 0 else self._EMPTY)
            original = t.subtokens_of_name(name)
            self.nr_true_positives += sum(
                c for elem, c in prediction_counter.items() if elem in original)
            self.nr_false_positives += sum(
                c for elem, c in prediction_counter.items() if elem not in original)
            self.nr_false_negatives += sum(
                c for elem, c in original.items() if elem not in prediction_counter)
            self.nr_predictions += 1

    @property
    def precision(self) -> float:
        denom = self.nr_true_positives + self.nr_false_positives
        return self.nr_true_positives / denom if denom else 0.0

    @property
    def recall(self) -> float:
        denom = self.nr_true_positives + self.nr_false_negatives
        return self.nr_true_positives / denom if denom else 0.0

    @property
    def f1(self) -> float:
        p, r = self.precision, self.recall
        return 2 * p * r / (p + r) if (p + r) else 0.0


def first_match_rank(tables: TargetWordTables, original_name: str,
                     topk_indices: Iterable[int]) -> Optional[Tuple[int, str]]:
    """(rank within filtered list, predicted word) of the first normalized
    match, for the per-example eval log (tensorflow_model.py:410-421)."""
    normalized_original = normalize_word(original_name)
    filtered_rank = 0
    for idx in topk_indices:
        idx = int(idx)
        if not tables.legal(idx):
            continue
        if tables.normalized(idx) == normalized_original:
            return filtered_rank, tables.word(idx)
        filtered_rank += 1
    return None
