"""Evaluation of a model on a labelled corpus: the counterpart of
code2vec_tpu/evaluation/.

- `metrics.py`   top-k accuracy and subtoken precision/recall/F1 (a copy
                 of the reference's host-side numpy).
- `evaluator.py` the loop: device batches through the model's eval step,
                 the metrics on the host, the per-example `log.txt`.
"""
