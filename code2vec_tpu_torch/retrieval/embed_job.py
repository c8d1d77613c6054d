"""Corpus-scale batch embedding job: a `.c2v` corpus -> a vector store.

The counterpart of code2vec_tpu/retrieval/embed_job.py, the body of the
`embed` command. It runs the corpus through the release model's eval step
(K1, K2 and the exact head on the card) in `test_batch_size` rows and
writes the code vectors into a sharded store (retrieval/store.py) whose
manifest records the model's fingerprint (`artifact:<hash16>`).

The reference reads a packed `.c2vb` that it writes beside the corpus on
first use; the port reads the text file itself, in the same row order
(file order, no shuffle, the eval row filter) and writes nothing beside
it. Resumable at shard granularity: a killed job restarted with the same
output skips every row already inside a committed shard, with no device
work for them. The reference's `obs` metrics (retrieval_embed_rows_total,
retrieval_embed_seconds, retrieval_embed_rows_per_sec) are not ported;
the summary dict carries the rows and the rate.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from code2vec_tpu_torch.data.reader import EstimatorAction, PathContextReader
from code2vec_tpu_torch.retrieval.store import VectorStoreWriter


def run_embed_job(model, corpus_path: Optional[str] = None,
                  out_dir: Optional[str] = None, log=None) -> dict:
    """Embed `corpus_path` (default config.test_data_path) with `model` (a
    ReleaseModel) into a vector store at `out_dir` (default
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
    dims = model.meta["dims"]
    writer = VectorStoreWriter(
        out, dim=int(dims["path_dim"]) + 2 * int(dims["token_dim"]),
        dtype=config.embed_dtype, model_fingerprint=fingerprint,
        source=corpus, shard_rows=config.embed_shard_rows, log=log)
    resumed_rows = writer.rows_done
    if resumed_rows:
        log(f"Embed job resuming past {resumed_rows} committed row(s)")

    reader = PathContextReader(model.vocabs, config,
                               EstimatorAction.Evaluate, data_path=corpus,
                               batch_size=int(config.test_batch_size),
                               with_target_strings=True)
    eval_step, params = model.eval_callable()
    to_skip = resumed_rows
    written = 0
    t0 = time.perf_counter()
    for batch in reader:
        valid = np.asarray(batch.example_valid)
        n_valid = int(valid.sum())
        if to_skip >= n_valid:
            # already inside a committed shard: no device work on resume
            to_skip -= n_valid
            continue
        arrays = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
            model.device) for a in batch.model_arrays())
        with torch.no_grad():
            code_vectors = eval_step(params, *arrays).code_vectors
        vectors = code_vectors.cpu().numpy()[valid]
        ids = [s for s, v in zip(batch.target_strings, valid) if v]
        if to_skip:
            vectors, ids = vectors[to_skip:], ids[to_skip:]
            to_skip = 0
        writer.append(vectors, ids)
        written += len(ids)

    manifest = writer.finalize()
    seconds = time.perf_counter() - t0
    rows_per_sec = written / max(seconds, 1e-9)
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
