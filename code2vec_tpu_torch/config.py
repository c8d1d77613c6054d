"""The train, predict, serve and retrieval knobs of the port, with the
names and defaults of code2vec_tpu/config.py.

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
    # `--test`: the labelled corpus `evaluate` scores, or the one the
    # embed job reads (code2vec_tpu/config.py:84, :697)
    test_data_path: Optional[str] = None
    test_batch_size: int = 1024
    num_test_examples: int = 0
    dropout_keep_rate: float = 0.75
    # Adam (code2vec_tpu/config.py:136-139, :163, :172)
    learning_rate: float = 0.001
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    adam_mu_dtype: str = "bfloat16"
    adam_nu_dtype: str = "bfloat16"
    # touched-rows (lazy) Adam for the token and path tables
    # (training/sparse_adam.py; code2vec_tpu/config.py:143-158): their
    # gradients stay rows, their moments are updated only where a batch
    # touches them (mu in adam_mu_dtype, nu in f32)
    use_sparse_embedding_update: bool = False
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
    # approximate-MIPS head (code2vec_tpu/config.py:499-522): 0 = exact
    # head; nlist 0 = sqrt(real vocab); crossover -1 = the artifact's
    # calibrated value (all-MIPS without one), 0 = exact only, N = batches
    # with <= N live rows take the MIPS head
    serve_mips_nprobe: int = 0
    serve_mips_nlist: int = 0
    serve_mips_crossover: int = -1
    # serving (code2vec_tpu/config.py:229-266)
    serve_port: int = 8800
    serve_host: str = "127.0.0.1"
    serve_batch_size: int = 64
    serve_max_delay_ms: float = 10.0
    serve_buckets: str = "32,64,128"
    extractor_timeout_s: float = 120.0
    export_code_vectors: bool = False
    # retrieval (code2vec_tpu/config.py:548-600)
    embed_out: Optional[str] = None
    embed_dtype: str = "float32"
    embed_shard_rows: int = 65536
    index_vectors: Optional[str] = None
    index_out: Optional[str] = None
    index_nlist: int = 0
    index_nprobe: int = 8
    index_kmeans_iters: int = 10
    index_metric: str = "cosine"
    retrieval_index: Optional[str] = None
    retrieval_topk: int = 10
    # the command that runs (set by the CLI): what the checks below read
    serve: bool = False
    predict: bool = False
    # the port's own
    device: str = "cuda"
    verbose_mode: int = 1

    @property
    def is_training(self) -> bool:
        return bool(self.train_data_path_prefix)

    @property
    def is_testing(self) -> bool:
        return bool(self.test_data_path)

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
        """The checks of code2vec_tpu/config.py:822-840 and :1114-1278
        that the port's knobs share."""
        for name in ("compute_dtype", "adam_mu_dtype", "adam_nu_dtype"):
            if getattr(self, name) not in ("bfloat16", "float32"):
                raise ValueError(f"{name} must be bfloat16 or float32.")
        if self.on_nonfinite_loss not in ("halt", "warn"):
            raise ValueError("on_nonfinite_loss must be halt or warn.")
        if not 0.0 < self.dropout_keep_rate <= 1.0:
            raise ValueError("dropout_keep_rate must be in (0, 1].")
        self._verify_mips()
        self._verify_retrieval()

    def _verify_mips(self) -> None:
        if self.serve_mips_nprobe < 0:
            raise ValueError(
                "serve_mips_nprobe must be >= 0 (0 = exact blockwise "
                "top-k, the default).")
        if self.serve_mips_nlist < 0:
            raise ValueError(
                "serve_mips_nlist must be >= 0 (0 = sqrt(vocab) auto).")
        if self.serve_mips_nprobe > 0:
            if not (self.serve or self.predict):
                raise ValueError(
                    "serve_mips_nprobe applies to serve/predict (the "
                    "prediction head); embed always uses the exact "
                    "blockwise path, so the knob would be a silent no-op "
                    "here.")
            if self.is_testing:
                raise ValueError(
                    "--serve_mips_nprobe cannot be combined with --test: "
                    "accuracy evaluation always scores the exact "
                    "blockwise head.")
        if self.serve_mips_crossover < -1:
            raise ValueError(
                "serve_mips_crossover must be >= -1 (-1 = adopt the "
                "artifact's calibrated crossover, 0 = exact-only, > 0 = "
                "explicit crossover row count).")
        if self.serve_mips_crossover > 0 and self.serve_mips_nprobe == 0:
            raise ValueError(
                "serve_mips_crossover > 0 requires serve_mips_nprobe > 0: "
                "there is no MIPS head to dispatch small batches to "
                "without an IVF probe budget.")

    def _verify_retrieval(self) -> None:
        if self.embed_dtype not in ("float32", "float16"):
            raise ValueError("embed_dtype must be float32 or float16.")
        if self.embed_shard_rows < 1:
            raise ValueError(
                "embed_shard_rows must be >= 1 (it is the embed job's "
                "resume granularity).")
        if self.embed_out and not self.is_testing:
            raise ValueError(
                "embed (--embed_out) needs a corpus: pass --test FILE.")
        if self.embed_out and not self.serve_artifact:
            raise ValueError(
                "embed (--embed_out) needs a model: --artifact DIR (an "
                "untrained model's vectors index noise).")
        if self.embed_out and self.is_training:
            raise ValueError(
                "embed (--embed_out) is a one-shot job and cannot be "
                "combined with training (--data); train first, then "
                "embed the corpus.")
        if self.embed_out and (self.serve or self.predict):
            raise ValueError(
                "embed (--embed_out) is a one-shot job and cannot be "
                "combined with serve/predict. Run them as separate "
                "invocations.")
        if self.index_out and (self.is_training or self.serve
                               or self.predict or self.is_testing
                               or self.embed_out):
            raise ValueError(
                "index-build (--index_out) is a standalone job and cannot "
                "be combined with training/serve/predict/--test/"
                "--embed_out. Run them as separate invocations.")
        if self.index_out and not self.index_vectors:
            raise ValueError(
                "index-build (--index_out) requires --vectors DIR (the "
                "store the `embed` subcommand wrote).")
        if self.index_vectors and not self.index_out:
            raise ValueError(
                "--vectors is only consumed by index-build; pass "
                "--index_out DIR for the artifact to write.")
        if self.index_nlist < 0:
            raise ValueError(
                "index_nlist must be >= 0 (0 = sqrt(rows) auto).")
        if self.index_nprobe < 1:
            raise ValueError("index_nprobe must be >= 1.")
        if self.index_kmeans_iters < 1:
            raise ValueError("index_kmeans_iters must be >= 1.")
        if self.index_metric not in ("cosine", "dot"):
            raise ValueError("index_metric must be cosine or dot.")
        if self.retrieval_index and not self.serve:
            raise ValueError(
                "--retrieval_index applies to the serve subcommand only "
                "(it mounts the /neighbors index).")
        if self.retrieval_topk < 1:
            raise ValueError("retrieval_topk must be >= 1.")

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
