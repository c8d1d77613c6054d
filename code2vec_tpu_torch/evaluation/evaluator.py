"""Evaluation loop: device top-k + host metrics + per-example audit log.

The counterpart of code2vec_tpu/evaluation/evaluator.py. The eval step
returns top-k indices (and the CE summed over rows with an in-vocabulary
label); strings exist only on the host, where the metrics of metrics.py
score the valid rows of each padded batch and each example's outcome is
appended to `log.txt`.

Two loops that give identical results: the serial one (parse, move, step,
score, one batch after another) and the pipelined one, where the
prefetcher's worker thread (utils/prefetch.py) reads batch N+1 into
pinned memory and its copy to the device is issued while the host scores
batch N. After each step the host copies of what scoring reads start at
once, behind the step on the stream, so that scoring batch N waits for
step N alone and not for step N+1, which is already queued.

The code vectors of the valid rows go, in eval order, to a text file
(`code_vectors_path`: one space-joined vector a line, the reference's
`.vectors` layout) or to a sink (`code_vectors_sink(vectors, names)`,
e.g. a retrieval/store.py VectorStoreWriter's `append`), as the
reference's do (:54-55, :124-132). Left out of the reference's: the `obs`
spans, counters and gauges.

On a mesh (`mesh`, parallel/mesh.py) every rank runs the eval step on
its part of each batch; the ranks of model and ctx coordinate 0 score
their data rank's rows, and the counters are summed over the mesh
(parallel/distributed.py allreduce_host_scalars) before any ratio is
taken, as the reference's evaluator sums them over hosts (:172-189). The
step's loss sum already covers the global batch. Rank 0 alone writes the
log (its data rank's rows, then the global top-k line).
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from code2vec_tpu_torch.evaluation.metrics import (
    ModelEvaluationResults, SubtokensEvaluationMetric, TargetWordTables,
    TopKAccuracyEvaluationMetric, batch_prediction_info,
)
from code2vec_tpu_torch.utils.prefetch import DevicePrefetcher

PREFETCH_DEPTH = 2  # batches the worker keeps ready ahead of the step


def batch_to_device(batch, device: torch.device):
    """The step's six inputs of a RowBatch as tensors on `device`."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in batch.model_arrays())


class _HostCopy:
    """Host copies of some of a step's outputs, started on the stream
    right after the step; `get()` waits for them alone."""

    def __init__(self, out, names):
        self.values = {n: getattr(out, n).to("cpu", non_blocking=True)
                       for n in names}
        self.event = None
        if out.topk_indices.is_cuda:
            self.event = torch.cuda.Event()
            self.event.record()

    def get(self):
        if self.event is not None:
            self.event.synchronize()
        return self.values


class Evaluator:
    """Scores an eval step (`eval_step(params, *arrays)` -> the release
    step's EvalOutputs) over a stream of RowBatches on `device`."""

    def __init__(self, config, vocabs, eval_step: Callable,
                 device: torch.device, log_path: Optional[str] = "log.txt",
                 mesh=None):
        self.config = config
        self.vocabs = vocabs
        self.eval_step = eval_step
        self.device = torch.device(device)
        self.mesh = mesh
        # the ranks that score rows: one per data rank
        self.scores_rows = mesh is None or (
            mesh.coords["model"] == 0 and mesh.coords["ctx"] == 0)
        self.log_path = log_path if mesh is None or mesh.index == 0 \
            else None
        self.tables = TargetWordTables(vocabs.target_vocab)

    def evaluate(self, params, batches: Iterable,
                 prefetch: bool = True,
                 code_vectors_path: Optional[str] = None,
                 code_vectors_sink: Optional[Callable] = None
                 ) -> ModelEvaluationResults:
        """Pipelined (`prefetch`) or serial evaluation; both give the same
        results."""
        config = self.config
        topk_metric = TopKAccuracyEvaluationMetric(
            config.top_k_words_considered_during_prediction, self.tables)
        subtoken_metric = SubtokensEvaluationMetric(self.tables)
        # the step sums CE over rows with an in-vocabulary label; the mean
        # divides by the same row count
        oov_floor = max(self.vocabs.target_vocab.pad_index,
                        self.vocabs.target_vocab.oov_index)
        with_vectors = bool(code_vectors_path or code_vectors_sink)
        names_read = ("topk_indices", "loss_sum") + (
            ("code_vectors",) if with_vectors else ())
        totals = dict(loss_sum=0.0, loss_rows=0, predictions=0, batches=0)
        start_time = time.time()
        log_file = open(self.log_path, "w") if self.log_path else None
        vectors_file = (open(code_vectors_path, "w") if code_vectors_path
                        else None)

        def consume(batch, host: _HostCopy) -> None:
            out = host.get()
            totals["batches"] += 1
            # the step's loss sum covers the global batch on every rank
            totals["loss_sum"] += float(out["loss_sum"])
            if not self.scores_rows:
                return
            valid = np.asarray(batch.example_valid)
            names = batch.target_strings
            if names is None:
                names = [self.vocabs.target_vocab.lookup_word(int(i))
                         for i in batch.target_index]
            names = [n for n, v in zip(names, valid) if v]
            rows = out["topk_indices"].numpy()[valid]
            info = batch_prediction_info(self.tables, names, rows)
            topk_metric.update_batch_from_indices(names, rows, info=info)
            subtoken_metric.update_batch_from_indices(names, rows, info=info)
            totals["loss_rows"] += int(np.sum(
                valid & (np.asarray(batch.target_index) > oov_floor)))
            totals["predictions"] += len(names)
            if log_file is not None:
                self._log_predictions(log_file, names, info)
            if with_vectors:
                vectors = out["code_vectors"].numpy()[valid]
                if vectors_file is not None:
                    for vec in vectors:
                        vectors_file.write(" ".join(map(str, vec)) + "\n")
                if code_vectors_sink is not None:
                    code_vectors_sink(vectors, names)
            if totals["batches"] % config.num_batches_to_log_progress == 0:
                elapsed = time.time() - start_time
                config.log(f"Evaluated {totals['predictions']} examples... "
                           f"({totals['predictions'] / max(elapsed, 1e-9):.0f}"
                           f" samples/sec)")

        def step(arrays) -> _HostCopy:
            with torch.no_grad():
                return _HostCopy(self.eval_step(params, *arrays), names_read)

        try:
            if prefetch:
                pending = None
                for arrays, batch in DevicePrefetcher(
                        batches, self.device, depth=PREFETCH_DEPTH,
                        keep_host_batch=True):
                    host = step(arrays)  # queued behind the previous step
                    if pending is not None:
                        consume(*pending)
                    pending = (batch, host)
                if pending is not None:
                    consume(*pending)
            else:
                for batch in batches:
                    consume(batch, step(batch_to_device(batch, self.device)))
            if self.mesh is not None:
                self._sum_over_mesh(totals, topk_metric, subtoken_metric)
            if log_file is not None:
                log_file.write(str(topk_metric.topk_correct_predictions)
                               + "\n")
        finally:
            if vectors_file is not None:
                vectors_file.close()
            if log_file is not None:
                log_file.close()
        return ModelEvaluationResults(
            topk_acc=topk_metric.topk_correct_predictions,
            subtoken_precision=subtoken_metric.precision,
            subtoken_recall=subtoken_metric.recall,
            subtoken_f1=subtoken_metric.f1,
            loss=totals["loss_sum"] / max(totals["loss_rows"], 1))

    def _sum_over_mesh(self, totals, topk, subtokens) -> None:
        """The counters of every scoring rank, summed (exact in f64)."""
        from code2vec_tpu_torch.parallel.distributed import (
            allreduce_host_scalars,
        )
        packed = allreduce_host_scalars(np.concatenate([
            [totals["loss_rows"], totals["predictions"],
             topk.nr_predictions, subtokens.nr_true_positives,
             subtokens.nr_false_positives, subtokens.nr_false_negatives,
             subtokens.nr_predictions],
            topk.nr_correct_predictions]), group=self.mesh.host_group)
        (totals["loss_rows"], totals["predictions"], topk.nr_predictions,
         subtokens.nr_true_positives, subtokens.nr_false_positives,
         subtokens.nr_false_negatives, subtokens.nr_predictions) = (
            int(x) for x in packed[:7])
        topk.nr_correct_predictions = packed[7:]

    def _log_predictions(self, log_file, names, info) -> None:
        # reference: tensorflow_model.py:410-421
        for name, rank, idx in zip(names, info.match_rank, info.match_idx):
            if rank >= 0:
                if rank == 0:
                    log_file.write(f"Original: {name}, predicted 1st: "
                                   f"{self.tables.word(int(idx))}\n")
                else:
                    log_file.write("\t\t predicted correctly at rank: "
                                   f"{rank + 1}\n")
            else:
                log_file.write(f"No results for predicting: {name}\n")
