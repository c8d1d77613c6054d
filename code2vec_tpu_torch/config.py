"""The train, predict and serve knobs of the port, with the names and
defaults of code2vec_tpu/config.py.

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
    # training schedule (code2vec_tpu/config.py:27, :43, :83, :86)
    num_train_epochs: int = 20
    on_nonfinite_loss: str = "halt"
    train_batch_size: int = 1024
    num_batches_to_log_progress: int = 100
    shuffle_buffer_size: int = 10000
    csv_buffer_size: int = 100 * 1024 * 1024
    train_data_path_prefix: Optional[str] = None
    dropout_keep_rate: float = 0.75
    # Adam (code2vec_tpu/config.py:136-139, :163, :172)
    learning_rate: float = 0.001
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    adam_mu_dtype: str = "bfloat16"
    adam_nu_dtype: str = "bfloat16"
    seed: int = 42
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

    @property
    def is_training(self) -> bool:
        return bool(self.train_data_path_prefix)

    @property
    def train_data_path(self) -> Optional[str]:
        # `<prefix>.train.c2v` (code2vec_tpu/config.py:753-758)
        if not self.is_training:
            return None
        return f"{self.train_data_path_prefix}.train.c2v"

    @property
    def word_freq_dict_path(self) -> Optional[str]:
        # `<prefix>.dict.c2v` (code2vec_tpu/config.py:760-764)
        if not self.is_training:
            return None
        return f"{self.train_data_path_prefix}.dict.c2v"

    def verify(self) -> None:
        """The dtype and policy checks of code2vec_tpu/config.py:822-840
        that the port's knobs share."""
        for name in ("compute_dtype", "adam_mu_dtype", "adam_nu_dtype"):
            if getattr(self, name) not in ("bfloat16", "float32"):
                raise ValueError(f"{name} must be bfloat16 or float32.")
        if self.on_nonfinite_loss not in ("halt", "warn"):
            raise ValueError("on_nonfinite_loss must be halt or warn.")
        if not 0.0 < self.dropout_keep_rate <= 1.0:
            raise ValueError("dropout_keep_rate must be in (0, 1].")

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
