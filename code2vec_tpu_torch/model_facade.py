"""The model facade: training (`Code2VecModel`) and the bucketed predict
path (`BucketedPredictMixin`).

`Code2VecModel` is the counterpart of code2vec_tpu/model_facade.py
Code2VecModel for a training run from a `.c2v` text file (:440-470
construction, :557-640 `_train_batches` and :690-740 `train`, without
saving, evaluation, resume or the async committer): vocabularies from the
data's `.dict.c2v`, parameters from `config.seed`, the dense train step
and the Trainer.

The predict part is the counterpart of BucketedPredictMixin (:66-395):
line parsing, context bucketing, row padding, the (rows, bucket) step
cache and the host-side assembly of results. Each device batch is padded
to a fixed row count and its context axis cut to the smallest bucket that
holds its deepest valid context, so the shapes the kernels see are
bounded by len(buckets) per row count.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from code2vec_tpu_torch.data.reader import (
    EstimatorAction, PathContextReader, RowBatch, _pad_rows,
    parse_context_lines, slice_contexts, truncate_rows,
)
from code2vec_tpu_torch.models.code2vec import Code2VecModule, ModelDims
from code2vec_tpu_torch.serving.batcher import bucket_for
from code2vec_tpu_torch.training.loop import Trainer
from code2vec_tpu_torch.training.state import (
    DTYPES, create_train_state, make_optimizer, num_params,
)
from code2vec_tpu_torch.training.step import TrainStepBuilder, dropout_seed
from code2vec_tpu_torch.vocab import Code2VecVocabs


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

    def context_bucket(self, chunk: RowBatch) -> int:
        """The smallest bucket that holds the deepest valid context."""
        any_valid_col = chunk.context_valid_mask.any(axis=0)
        deepest = (int(np.nonzero(any_valid_col)[0][-1]) + 1
                   if any_valid_col.any() else 1)
        return bucket_for(deepest, self.context_buckets)

    def bucketed_batch(self, chunk: RowBatch, bs: int) -> RowBatch:
        """`chunk` as one device batch: its context axis cut to the
        smallest bucket that holds its deepest valid context, its rows
        cut or padded to `bs`."""
        chunk = slice_contexts(chunk, self.context_bucket(chunk))
        if chunk.target_index.shape[0] > bs:
            chunk = truncate_rows(chunk, bs)
        return _pad_rows(chunk, bs)

    def _dispatch_predict_step(self, n: int, bs: int, m: int):
        """(step, padded rows, head) for a batch with `n` live rows: one
        head for every shape here; ReleaseModel dispatches by shape."""
        return self._get_bucketed_predict_step(bs, m), bs, "exact"

    def _predict_parsed(self, chunk: RowBatch, n: int, bs: int,
                        with_code_vectors: bool
                        ) -> List[ModelPredictionResults]:
        m = self.context_bucket(chunk)
        step, rows, _ = self._dispatch_predict_step(n, bs, m)
        chunk = self.bucketed_batch(chunk, rows)
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


class Code2VecModel:
    """A training run on one device (config.device: cuda unless asked for
    cpu): `Code2VecModel(config).train()`."""

    def __init__(self, config):
        from code2vec_tpu_torch.release.runtime import resolve_device
        config.verify()
        self.config = config
        self.log = config.log
        self.device = resolve_device(config.device)
        self.vocabs = Code2VecVocabs.load_or_create(config)
        tv = self.vocabs.target_vocab
        self.dims = ModelDims(
            token_vocab_size=self.vocabs.token_vocab.size,
            path_vocab_size=self.vocabs.path_vocab.size,
            target_vocab_size=tv.size,
            token_dim=config.token_embeddings_size,
            path_dim=config.path_embeddings_size,
            target_oov_floor=max(tv.pad_index, tv.oov_index))
        generator = torch.Generator(device=self.device).manual_seed(
            config.seed)
        self.module = Code2VecModule(
            self.dims, compute_dtype=DTYPES[config.compute_dtype],
            device=self.device, generator=generator,
            dropout_keep_rate=config.dropout_keep_rate)
        self.optimizer = make_optimizer(config)
        self.state = create_train_state(self.module, self.optimizer)
        self.builder = TrainStepBuilder(self.module, self.optimizer, config)
        self.trainer = None
        self.log(f"Model on {self.device}: vocabularies {self.dims.token_vocab_size} "
                 f"tokens, {self.dims.path_vocab_size} paths, "
                 f"{self.dims.target_vocab_size} targets; "
                 f"{num_params(self.state)} parameters")

    def _train_batches(self) -> PathContextReader:
        """The text reader's train stream with EpochEnd markers."""
        config = self.config
        return PathContextReader(self.vocabs, config, EstimatorAction.Train,
                                 batch_size=config.train_batch_size,
                                 num_epochs=config.num_train_epochs,
                                 yield_epoch_markers=True)

    def train(self) -> None:
        config = self.config
        step = self.builder.make_train_step(self.state)
        self.trainer = Trainer(config, step, self.device)
        self.state = self.trainer.train(self.state, self._train_batches(),
                                        dropout_seed(config))
