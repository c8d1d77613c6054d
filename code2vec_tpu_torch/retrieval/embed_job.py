"""Corpus-scale batch embedding job: a packed corpus -> a vector store.

The counterpart of code2vec_tpu/retrieval/embed_job.py, the body of the
`embed` command. It runs the corpus through the release model's eval step
(K1, K2 and the exact head on the card) in `test_batch_size` rows and
writes the code vectors into a sharded store (retrieval/store.py) whose
manifest records the model's fingerprint (`artifact:<hash16>`, or
`ckpt:<path>@step<N>#p<params>` for a --load'ed checkpoint).

It reads the corpus through `model._packed_dataset`, the `.c2vb` it
writes beside the `.c2v` on first use (:69), in the eval order (file
order, no shuffle, the eval row filter). Resumable at shard
granularity: a killed job restarted with the same output skips every
row already inside a committed shard, with no device work for them.
It records the reference's metrics (:41, :76-79):
`retrieval_embed_seconds{phase}` (device: the eval step and the copy of
its code vectors to the host; assemble: ids and the shard write),
`retrieval_embed_rows_total` and `retrieval_embed_rows_per_sec`; the
summary dict carries the rows and the rate too.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from code2vec_tpu_torch import obs
from code2vec_tpu_torch.data.reader import EstimatorAction
from code2vec_tpu_torch.retrieval.store import VectorStoreWriter


_H_PHASE_HELP = ("batch embedding job latency by phase: device (eval "
                 "step dispatch + wait), assemble (host fetch, id "
                 "resolution, shard write)")


def _phase_hist(phase: str):
    return obs.histogram("retrieval_embed_seconds", _H_PHASE_HELP,
                         phase=phase)


def run_embed_job(model, corpus_path: Optional[str] = None,
                  out_dir: Optional[str] = None, log=None) -> dict:
    """Embed `corpus_path` (default config.test_data_path) with `model` (a
    ReleaseModel, or a Code2VecModel from --load) into a vector store at `out_dir` (default
    config.embed_out). Returns {rows, resumed_rows, embedded_rows, shards,
    seconds, rows_per_sec, fingerprint, path}."""
    config = model.config
    log = log or config.log
    corpus = corpus_path or config.test_data_path
    out = out_dir or config.embed_out
    if not corpus:
        raise ValueError("embed needs a corpus: pass --test FILE")
    if not out:
        raise ValueError("embed needs --embed_out DIR")
    fingerprint = model.model_fingerprint()
    writer = VectorStoreWriter(
        out, dim=model.code_vector_size,
        dtype=config.embed_dtype, model_fingerprint=fingerprint,
        source=corpus, shard_rows=config.embed_shard_rows, log=log)
    resumed_rows = writer.rows_done
    if resumed_rows:
        log(f"Embed job resuming past {resumed_rows} committed row(s)")

    batches = model._packed_dataset(corpus).iter_batches(
        int(config.test_batch_size), EstimatorAction.Evaluate,
        with_target_strings=True)
    eval_step, params = model.eval_callable()
    h_device = _phase_hist("device")
    h_assemble = _phase_hist("assemble")
    rows_counter = obs.counter(
        "retrieval_embed_rows_total",
        "corpus rows embedded into a vector store")
    rate_gauge = obs.gauge(
        "retrieval_embed_rows_per_sec",
        "last embed job's end-to-end throughput")
    to_skip = resumed_rows
    written = 0
    t0 = time.perf_counter()
    for batch in batches:
        valid = np.asarray(batch.example_valid)
        n_valid = int(valid.sum())
        if to_skip >= n_valid:
            # already inside a committed shard: no device work on resume
            to_skip -= n_valid
            continue
        t_dev = time.perf_counter()
        arrays = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
            model.device) for a in batch.model_arrays())
        with torch.no_grad():
            code_vectors = eval_step(params, *arrays).code_vectors
        vectors = code_vectors.cpu().numpy()[valid]
        h_device.observe(time.perf_counter() - t_dev)
        t_asm = time.perf_counter()
        ids = [s for s, v in zip(batch.target_strings, valid) if v]
        if to_skip:
            vectors, ids = vectors[to_skip:], ids[to_skip:]
            to_skip = 0
        writer.append(vectors, ids)
        written += len(ids)
        rows_counter.inc(len(ids))
        h_assemble.observe(time.perf_counter() - t_asm)

    manifest = writer.finalize()
    seconds = time.perf_counter() - t0
    rows_per_sec = written / max(seconds, 1e-9)
    rate_gauge.set(rows_per_sec)
    log(f"Embed job done: {written} row(s) embedded "
        f"({resumed_rows} resumed) into {len(manifest['shards'])} "
        f"shard(s) at {out} in {seconds:.1f}s "
        f"({rows_per_sec:.0f} rows/s, dtype {config.embed_dtype}, "
        f"fingerprint {fingerprint})")
    return {"rows": int(manifest["rows"]), "resumed_rows": resumed_rows,
            "embedded_rows": written,
            "shards": len(manifest["shards"]), "seconds": seconds,
            "rows_per_sec": rows_per_sec, "fingerprint": fingerprint,
            "path": writer.path}
