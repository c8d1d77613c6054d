"""The train, checkpoint, predict, serve and retrieval knobs of the port,
with the names and defaults of code2vec_tpu/config.py.

A release artifact is authoritative for what shaped its export
(max_contexts, topk, buckets, vocab sizes, compute dtype): ReleaseModel
overwrites those fields from the artifact's meta, as the JAX runtime
does. `device` is new: entry points run on "cuda" unless asked for "cpu".
"""

from __future__ import annotations

import dataclasses
import logging
import os
import sys
from typing import Optional, Tuple


@dataclasses.dataclass
class Config:
    # training schedule (code2vec_tpu/config.py:27-28, :43, :83, :86,
    # :91)
    num_train_epochs: int = 20
    save_every_epochs: int = 1
    max_to_keep: int = 10
    on_nonfinite_loss: str = "halt"
    train_batch_size: int = 1024
    num_batches_to_log_progress: int = 100
    shuffle_buffer_size: int = 10000
    csv_buffer_size: int = 100 * 1024 * 1024
    train_data_path_prefix: Optional[str] = None
    # the data path (code2vec_tpu/config.py:179-202): train and evaluate
    # from the packed `.c2vb` beside each `.c2v` (packed once, on first
    # use, with `preprocess_workers` processes; 0 = in-process), or from
    # the text itself (--no_packed_data); `train_corpus_manifest` trains
    # from a manifest of `.c2vb` shards as one row space; the prefetcher
    # keeps `prefetch_batches` batches staged ahead of the step, and
    # `prefetch_double_buffer` one more held back
    use_packed_data: bool = True
    train_corpus_manifest: Optional[str] = None
    preprocess_workers: int = 0
    prefetch_batches: int = 4
    prefetch_double_buffer: bool = False
    # `--test`: the labelled corpus `evaluate` scores, or the one the
    # embed job reads (code2vec_tpu/config.py:84, :697)
    test_data_path: Optional[str] = None
    test_batch_size: int = 1024
    num_test_examples: int = 0
    # checkpoints and their exports (code2vec_tpu/config.py:112-119,
    # :485, :492, :566, :570): `--save`, `--load`, `--release` (re-save
    # the loaded model without its optimizer state), the word2vec text
    # dumps, `export --artifact_out` (release_quantize False = float32
    # tables), `--vectors_text` (the `.vectors` text layout of
    # --export_code_vectors) and `export-embeddings --embeddings_out`
    model_save_path: Optional[str] = None
    model_load_path: Optional[str] = None
    release: bool = False
    save_w2v: Optional[str] = None
    save_t2v: Optional[str] = None
    export_artifact_path: Optional[str] = None
    release_quantize: bool = True
    vectors_text: bool = False
    embeddings_out: Optional[str] = None
    # each evaluated example's outcome (the reference writes log.txt in
    # the working directory; None writes none)
    eval_log_path: Optional[str] = "log.txt"
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
    # serving (code2vec_tpu/config.py:57, :229-340): the batcher
    # (collect-then-dispatch, or continuous with --serve_continuous and
    # `serve_inflight_steps` device steps in flight), the prediction
    # cache (0 entries: off), the warm extractor pool and its crash
    # retries, the default and largest request deadline (0: none) and the
    # admission bound; `serve_debug_trace` honours ?debug=trace
    serve_port: int = 8800
    serve_host: str = "127.0.0.1"
    serve_batch_size: int = 64
    serve_max_delay_ms: float = 10.0
    serve_continuous: bool = False
    serve_inflight_steps: int = 2
    serve_buckets: str = "32,64,128"
    serve_cache_entries: int = 4096
    extractor_pool_size: int = 2
    extractor_timeout_s: float = 120.0
    extractor_retries: int = 2
    serve_deadline_ms: float = 2000.0
    serve_deadline_max_ms: float = 30000.0
    serve_queue_depth: int = 64
    serve_debug_trace: bool = False
    export_code_vectors: bool = False
    # observability (code2vec_tpu/config.py:210-222): a Prometheus text
    # snapshot rewritten atomically while serving and at its end, a
    # localhost /metrics port (0: off), and the serving span ring's
    # Chrome trace-event file
    metrics_file: Optional[str] = None
    metrics_port: int = 0
    trace_export: Optional[str] = None
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
    # the `corpus` command (code2vec_tpu/config.py:610-623): list the
    # manifest at train_corpus_manifest, create it over comma-separated
    # shards, append a shard, or re-check every shard
    corpus: bool = False
    corpus_create: Optional[str] = None
    corpus_add: Optional[str] = None
    corpus_validate: bool = False
    # the mesh of the parallel steps (code2vec_tpu/config.py:128-142):
    # data-, tensor- (the tables' rows) and context-parallel degrees, one
    # process a rank (the explicit-collective steps: torch has no GSPMD,
    # so the reference's use_manual_tp_kernels switch has no counterpart)
    dp: int = 1
    tp: int = 1
    cp: int = 1
    # the collectives' backend: "" follows the device (nccl for cuda,
    # gloo for cpu); gloo on cuda lets ranks share one card
    dist_backend: str = ""
    # the rendezvous (file://PATH or tcp://HOST:PORT); None reads
    # torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR/PORT)
    dist_init_method: Optional[str] = None
    # the port's own
    device: str = "cuda"
    verbose_mode: int = 1
    # the fields the command line set (filled by cli.config_from_args;
    # code2vec_tpu/config.py:681): ReleaseModel adopts an artifact's
    # serve_batch_size only where the flag was not given
    explicit_knobs: Tuple[str, ...] = ()

    @property
    def is_training(self) -> bool:
        return bool(self.train_data_path_prefix)

    @property
    def is_testing(self) -> bool:
        return bool(self.test_data_path)

    @property
    def is_loading(self) -> bool:
        return bool(self.model_load_path)

    @property
    def is_saving(self) -> bool:
        return bool(self.model_save_path)

    @property
    def model_load_dir(self) -> str:
        return os.path.dirname(self.model_load_path or "")

    @property
    def mesh_size(self) -> int:
        return self.dp * self.tp * self.cp

    @property
    def code_vector_size(self) -> int:
        return self.path_embeddings_size + 2 * self.token_embeddings_size

    @staticmethod
    def get_vocabularies_path_from_model_path(model_file_path: str) -> str:
        # a model directory carries its own dictionaries.bin; the
        # reference's layout keeps it beside the model file
        # (code2vec_tpu/config.py:773-782)
        inside = os.path.join(model_file_path, "dictionaries.bin")
        if os.path.isfile(inside):
            return inside
        return os.path.join(os.path.dirname(model_file_path),
                            "dictionaries.bin")

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
        """The checks of code2vec_tpu/config.py:800-840 and :1109-1289
        that the port's knobs share."""
        if not (self.is_training or self.is_loading or self.serve_artifact
                or self.index_out or self.corpus):
            raise ValueError(
                "Must train or load a model (or serve a release "
                "artifact via --artifact; `index-build` and `corpus` "
                "alone need no model).")
        if self.is_loading and not os.path.isdir(self.model_load_dir):
            raise ValueError(
                f"Model load dir `{self.model_load_dir}` does not exist.")
        for name in ("compute_dtype", "adam_mu_dtype", "adam_nu_dtype"):
            if getattr(self, name) not in ("bfloat16", "float32"):
                raise ValueError(f"{name} must be bfloat16 or float32.")
        if self.on_nonfinite_loss not in ("halt", "warn"):
            raise ValueError("on_nonfinite_loss must be halt or warn.")
        if not 0.0 < self.dropout_keep_rate <= 1.0:
            raise ValueError("dropout_keep_rate must be in (0, 1].")
        if self.save_every_epochs < 1:
            raise ValueError("save_every_epochs must be >= 1.")
        if self.max_to_keep < 0:
            raise ValueError("max_to_keep must be >= 0 (0 keeps every "
                             "epoch checkpoint).")
        if self.preprocess_workers < 0:
            raise ValueError(
                "preprocess_workers must be >= 0 (0 = in-process serial).")
        if self.train_corpus_manifest and not self.use_packed_data:
            raise ValueError(
                "--train_corpus_manifest requires packed data: the "
                "manifest lists .c2vb shards (drop --no_packed_data).")
        if self.release_scheme not in ("int8", "fp8_e4m3", "fp8_e5m2",
                                       "int4", "float32"):
            raise ValueError(
                "release_scheme must be one of int8, fp8_e4m3, "
                "fp8_e5m2, int4, float32.")
        self._verify_mesh()
        self._verify_serving()
        self._verify_mips()
        self._verify_exports()
        self._verify_retrieval()

    def _verify_mesh(self) -> None:
        # code2vec_tpu/config.py:796-821, and what the port does not run
        # on a mesh yet (ROADMAP Queue 1 item 6)
        if self.dp < 1 or self.tp < 1 or self.cp < 1:
            raise ValueError("Mesh axis sizes dp/tp/cp must be >= 1.")
        if self.max_contexts % self.cp != 0:
            raise ValueError(
                f"max_contexts ({self.max_contexts}) must be divisible by "
                f"the context-parallel degree cp ({self.cp}).")
        if self.dist_backend not in ("", "nccl", "gloo"):
            raise ValueError("dist_backend must be nccl or gloo.")
        if self.mesh_size == 1:
            return
        from code2vec_tpu_torch.parallel.distributed import local_batch_size
        for batch in (self.train_batch_size, self.test_batch_size):
            local_batch_size(batch, self.dp)
        if self.is_saving or self.is_loading:
            raise ValueError(
                "--save and --load on a mesh (dp x tp x cp > 1) are not "
                "ported yet: a checkpoint holds whole tables, and the "
                "mesh's ranks hold row shards. Train on a mesh without "
                "them, or on one device with them.")
        if (self.serve or self.predict or self.serve_artifact
                or self.embed_out or self.save_w2v or self.save_t2v
                or self.export_code_vectors or not self.is_training):
            raise ValueError(
                "a mesh (dp x tp x cp > 1) runs `train` (with --test) "
                "only: serving, predict, embed, evaluate and the exports "
                "run on one device.")

    def _verify_serving(self) -> None:
        # code2vec_tpu/config.py:836-892, :1147-1150
        if self.extractor_timeout_s < 0:
            raise ValueError(
                "extractor_timeout_s must be >= 0 (0 disables).")
        if self.extractor_retries < 0:
            raise ValueError(
                "extractor_retries must be >= 0 (0 disables retries).")
        if not (0 <= self.metrics_port <= 65535):
            raise ValueError(
                "metrics_port must be in [0, 65535] (0 disables).")
        if not (0 <= self.serve_port <= 65535):
            raise ValueError(
                "serve_port must be in [0, 65535] (0 picks a free port).")
        if self.serve_batch_size < 1:
            raise ValueError("serve_batch_size must be >= 1.")
        if self.serve_max_delay_ms < 0:
            raise ValueError(
                "serve_max_delay_ms must be >= 0 (0 = dispatch "
                "immediately, no coalescing).")
        if self.serve_cache_entries < 0:
            raise ValueError(
                "serve_cache_entries must be >= 0 (0 disables the "
                "prediction cache).")
        if self.extractor_pool_size < 1:
            raise ValueError("extractor_pool_size must be >= 1.")
        try:
            from code2vec_tpu_torch.serving.batcher import parse_buckets
            parse_buckets(self.serve_buckets, self.max_contexts, cp=self.cp)
        except ValueError:
            raise ValueError(
                f"serve_buckets must be a comma-separated list of ints "
                f"(got {self.serve_buckets!r}).")
        if self.serve_deadline_ms < 0:
            raise ValueError(
                "serve_deadline_ms must be >= 0 (0 = no default "
                "deadline).")
        if self.serve_deadline_max_ms < 0:
            raise ValueError(
                "serve_deadline_max_ms must be >= 0 (0 = no ceiling).")
        if (self.serve_deadline_ms > 0 and self.serve_deadline_max_ms > 0
                and self.serve_deadline_ms > self.serve_deadline_max_ms):
            raise ValueError(
                "serve_deadline_ms must not exceed serve_deadline_max_ms "
                "(the default deadline would be clamped below itself).")
        if self.serve_queue_depth < 1:
            raise ValueError(
                "serve_queue_depth must be >= 1 (the admission gate "
                "needs room for at least one request).")
        if self.serve_inflight_steps < 1:
            raise ValueError(
                "serve_inflight_steps must be >= 1 (device steps the "
                "continuous batcher may keep in flight).")

    def _verify_exports(self) -> None:
        if self.export_artifact_path and not self.is_loading:
            raise ValueError(
                "export (--artifact_out) requires --load: the artifact "
                "is built from a trained checkpoint.")
        if self.export_artifact_path and self.is_training:
            raise ValueError(
                "export (--artifact_out) cannot be combined with training "
                "(--data): main() exports the --load'ed checkpoint and "
                "exits, so the training run would be silently skipped. "
                "Train first, then `export --load CKPT --artifact_out "
                "DIR`.")
        if self.export_artifact_path and (self.serve or self.predict
                                          or self.is_testing):
            raise ValueError(
                "export (--artifact_out) is a one-shot job and cannot be "
                "combined with serve/--predict/--test in the same run; "
                "run those against the exported artifact (--artifact) or "
                "the checkpoint (--load) separately.")
        if self.serve_artifact and self.is_loading:
            raise ValueError(
                "--artifact and --load are mutually exclusive: a release "
                "artifact carries its own tables and vocabularies.")
        if self.serve_artifact and (self.save_w2v or self.save_t2v):
            raise ValueError(
                "--artifact cannot be combined with --save_w2v/--save_t2v: "
                "the vector writers read the fp32 checkpoint tables and "
                "the artifact branch in main() would silently skip them; "
                "run them against --load.")
        if self.serve_artifact and self.is_training:
            raise ValueError(
                "--artifact is inference-only (serve/--predict/--test) "
                "and cannot be combined with training (--data): a "
                "release artifact has no optimizer state to train.")
        if self.embeddings_out and (self.is_training or self.serve
                                    or self.predict or self.is_testing
                                    or self.embed_out):
            raise ValueError(
                "export-embeddings (--embeddings_out) is a one-shot "
                "job and cannot be combined with training/serve/"
                "--predict/--test/--embed_out: main() writes the "
                "tables and exits, silently skipping the rest. Run "
                "them as separate invocations.")
        if self.embeddings_out and not self.is_loading:
            raise ValueError(
                "export-embeddings (--embeddings_out) requires --load: "
                "the tables come from a trained checkpoint.")
        if self.embeddings_out and self.serve_artifact:
            raise ValueError(
                "export-embeddings (--embeddings_out) reads the fp32 "
                "checkpoint tables; a release artifact's are quantized "
                "— run it against --load.")

    def _verify_mips(self) -> None:
        if self.serve_mips_nprobe < 0:
            raise ValueError(
                "serve_mips_nprobe must be >= 0 (0 = exact blockwise "
                "top-k, the default).")
        if self.serve_mips_nlist < 0:
            raise ValueError(
                "serve_mips_nlist must be >= 0 (0 = sqrt(vocab) auto).")
        if self.serve_mips_nprobe > 0:
            if not (self.serve or self.predict
                    or self.export_artifact_path):
                raise ValueError(
                    "serve_mips_nprobe applies to serve/predict (the "
                    "prediction head) and export (which calibrates and "
                    "records the exact/MIPS crossover in the artifact "
                    "meta); eval/embed always use the exact blockwise "
                    "path, so the knob would be a silent no-op here.")
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
        if self.embed_out and not (self.is_loading or self.serve_artifact):
            raise ValueError(
                "embed (--embed_out) needs a model: --load CKPT or "
                "--artifact DIR (an untrained model's vectors index "
                "noise).")
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
                               or self.embed_out or self.embeddings_out):
            raise ValueError(
                "index-build (--index_out) is a standalone job and cannot "
                "be combined with training/serve/predict/--test/"
                "--embed_out/--embeddings_out. Run them as separate "
                "invocations.")
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
