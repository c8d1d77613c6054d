"""The predict and serve knobs of the port, with the names and defaults of
code2vec_tpu/config.py.

A release artifact is authoritative for what shaped its export
(max_contexts, topk, buckets, vocab sizes, compute dtype): ReleaseModel
overwrites those fields from the artifact's meta, as the JAX runtime
does. `device` is new: entry points run on "cuda" unless asked for "cpu".
"""

from __future__ import annotations

import dataclasses
import logging
import sys
from typing import Optional


@dataclasses.dataclass
class Config:
    # model shape (code2vec_tpu/config.py:85-105)
    top_k_words_considered_during_prediction: int = 10
    max_contexts: int = 200
    max_token_vocab_size: int = 1301136
    max_target_vocab_size: int = 261245
    max_path_vocab_size: int = 911417
    token_embeddings_size: int = 128
    path_embeddings_size: int = 128
    separate_oov_and_pad: bool = False
    compute_dtype: str = "bfloat16"
    # release artifact (code2vec_tpu/config.py:477, :498)
    topk_block_size: int = 4096
    release_scheme: str = "int8"
    serve_artifact: Optional[str] = None
    # serving (code2vec_tpu/config.py:229-266)
    serve_port: int = 8800
    serve_host: str = "127.0.0.1"
    serve_batch_size: int = 64
    serve_max_delay_ms: float = 10.0
    serve_buckets: str = "32,64,128"
    extractor_timeout_s: float = 120.0
    export_code_vectors: bool = False
    # the port's own
    device: str = "cuda"
    verbose_mode: int = 1

    def log(self, msg: str) -> None:
        if self.verbose_mode > 0:
            logger = logging.getLogger("code2vec_tpu_torch")
            if not logger.handlers:
                handler = logging.StreamHandler(sys.stderr)
                handler.setFormatter(logging.Formatter(
                    "%(asctime)s %(levelname)s %(message)s"))
                logger.addHandler(handler)
                logger.setLevel(logging.INFO)
            logger.info(msg)
