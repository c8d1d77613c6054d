"""Command line of the port: `train` from a preprocessed dataset (saving
and evaluating as it goes, or resuming a checkpoint); `serve`,
`predict`, `evaluate` and `embed` against a release artifact of any
scheme or a checkpoint; `export` and `export-embeddings` of a
checkpoint; `index-build` over a vector store; `corpus` over a manifest
of packed shards. Flag names, destinations, defaults and checks are
those of code2vec_tpu/cli.py and config.py, plus a command word and
`--device` (default cuda). Datasets come from `python -m
code2vec_tpu_torch.data.preprocess` (data/preprocess.py).

    python -m code2vec_tpu_torch train --data PREFIX --epochs N
        [--save M] [--test T] [--load M_iter<N>] [--batch_size B]
        [--max_contexts M] [--seed S] [--device cpu]
        [--sparse_embedding_update] [--save_w2v F] [--save_t2v F]
        [--no_packed_data | --train_corpus_manifest MANIFEST]
        [--preprocess_workers N] [--prefetch_double_buffer]
        [--async_checkpointing] [--checkpoint_hash_content]
        [--no_cursor_resume] [--rss_limit_gb G]
        [--on_nonfinite_loss halt|warn] [--tensorboard]
        [--profile_dir DIR] [--heartbeat_file F] [--metrics_file F]
        [--metrics_port P] [--trace_export F]
        [--dp N --tp N --cp N [--dist_backend nccl|gloo]
         [--dist_init file://PATH]]
    python -m code2vec_tpu_torch export --load M --artifact_out DIR
        [--release_scheme int8|fp8_e4m3|fp8_e5m2|int4|float32]
        [--no_quantize] [--serve_mips_nprobe P (calibrates the head
         crossover into the meta)]
    python -m code2vec_tpu_torch export-embeddings --load M
        --embeddings_out DIR
    python -m code2vec_tpu_torch evaluate --load M --release
    python -m code2vec_tpu_torch serve (--artifact DIR | --load M)
        [--serve_port P] [--serve_continuous [--serve_inflight_steps N]]
        [--serve_cache_entries N] [--extractor_pool_size N]
        [--extractor_retries N] [--serve_deadline_ms MS]
        [--serve_deadline_max_ms MS] [--serve_queue_depth N]
        [--serve_debug_trace] [--metrics_file F] [--metrics_port P]
        [--trace_export F]
        [--retrieval_index IDX [--retrieval_topk K]]
        [--serve_mips_nprobe P [--serve_mips_nlist N]
         [--serve_mips_crossover R]]
    python -m code2vec_tpu_torch predict (--artifact DIR | --load M)
    python -m code2vec_tpu_torch evaluate (--artifact DIR | --load M)
        --test FILE [--test_batch_size N] [--eval_log FILE]
        [--export_code_vectors [--vectors_text]] [--device cpu]
    python -m code2vec_tpu_torch embed (--artifact DIR | --load M)
        --test CORPUS.c2v --embed_out STORE [--embed_dtype float16]
        [--embed_shard_rows N]
    python -m code2vec_tpu_torch index-build --vectors STORE
        --index_out IDX [--nlist N] [--nprobe P] [--kmeans_iters I]
        [--index_metric cosine|dot]
    python -m code2vec_tpu_torch corpus --train_corpus_manifest MANIFEST
        [--corpus_create SHARD[,SHARD...]] [--corpus_add SHARD]
        [--corpus_validate]

`train`, `evaluate` and `embed` read the packed `.c2vb` beside each
`.c2v` (written once, on first use, with --preprocess_workers
processes), and `--no_packed_data` the text itself.

`train` on a dp x tp x cp mesh runs one process a rank, launched with
`python -m torch.distributed.run --nproc-per-node N -m code2vec_tpu_torch
train --data P --tp 2 ...` (N = dp x tp x cp); each rank takes
`cuda:$LOCAL_RANK` unless --device pins one, and `--dist_backend gloo`
lets ranks share one card. `--gspmd` is accepted and runs the same
explicit-collective steps (torch has no GSPMD).

`serve` answers POST /predict, /embed (and /neighbors with an index)
through the prediction cache, the admission gate, the warm extractor
pool and the batcher, and GET /healthz and /metrics (serving/server.py).
Every command takes --compute_dtype, --serve_buckets, --topk_block and
-v/--verbose as the reference does.

`train --save M` saves `M_iter<N>` at the end of every
`save_every_epochs`-th epoch and of the last (keeping `max_to_keep`) and
`M` when it ends; with `--test T` it evaluates T after each of those
saves. `--load` takes an artifact directory or a save base (its newest
valid `_iter<N>`, or the `_iter<N>_preempt` a SIGTERM or the RSS limit
left mid-epoch N+1, which resumes after the rows it had consumed); a
resumed run numbers its epochs on from the loaded one. A NaN or Inf loss
halts with an `_iter<N>_nanhalt` artifact that resume never picks. `evaluate` prints the top-k accuracy, subtoken precision, recall
and F1 and the loss, and writes each example's outcome to `--eval_log`
(default log.txt). `evaluate --load M --release` writes `M.release`, the
model without its optimizer state (the reference's `--load M
--release`); `--save_w2v`/`--save_t2v` run after training, or on
`evaluate --load`.
"""

from __future__ import annotations

import argparse
import sys
import time

from code2vec_tpu_torch.config import Config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m code2vec_tpu_torch")
    p.add_argument("command", choices=COMMANDS)
    p.add_argument("--artifact", dest="serve_artifact", metavar="DIR",
                   help="`serve`, `predict`, `evaluate`, `embed`: release "
                        "artifact directory (or --load a checkpoint)")
    p.add_argument("-d", "--data", dest="data_path", metavar="PREFIX",
                   help="`train`: path prefix of the preprocessed dataset "
                        "(PREFIX.train.c2v, PREFIX.dict.c2v)")
    p.add_argument("--epochs", type=int, default=None,
                   help="`train`: epochs (default 20)")
    p.add_argument("--batch_size", type=int, default=None,
                   help="rows per train step and per evaluation batch "
                        "(default 1024)")
    p.add_argument("--max_contexts", type=int, default=None,
                   help="`train`: contexts per method (default 200)")
    p.add_argument("--seed", type=int, default=42,
                   help="`train`: seed of the parameters, dropout and "
                        "shuffle")
    p.add_argument("--sparse_embedding_update", action="store_true",
                   help="`train`: touched-rows (lazy) Adam for the "
                        "token/path tables (training/sparse_adam.py)")
    p.add_argument("--no_packed_data", action="store_true",
                   help="stream text .c2v instead of packed .c2vb")
    p.add_argument("--train_corpus_manifest", metavar="FILE", default=None,
                   help="`train`: train from a corpus manifest (a JSON "
                        "list of .c2vb shards) as one row space with a "
                        "single pack's epoch-keyed shuffle; `corpus`: the "
                        "manifest to list, create, grow or check")
    p.add_argument("--preprocess_workers", type=int, default=None,
                   metavar="N",
                   help="worker processes of the one-time .c2v -> .c2vb "
                        "pack (the output is the same at any count; "
                        "default 0 = in-process)")
    p.add_argument("--prefetch_double_buffer", action="store_true",
                   default=None,
                   help="`train`: hold one staged batch back, so batch "
                        "N+1's copy is issued before batch N's step")
    p.add_argument("--corpus_create", metavar="SHARD[,SHARD...]",
                   default=None,
                   help="`corpus`: build a new manifest over these .c2vb "
                        "shards, in order (shard order defines global row "
                        "ids); refuses mixed-vocabulary shard sets")
    p.add_argument("--corpus_add", metavar="SHARD", default=None,
                   help="`corpus`: append one .c2vb shard to the manifest "
                        "(existing row ids stay); refused on a vocabulary "
                        "fingerprint mismatch")
    p.add_argument("--corpus_validate", action="store_true", default=None,
                   help="`corpus`: re-read every listed shard's header and "
                        "meta and fail on drift")
    p.add_argument("-s", "--save", dest="save_path", metavar="FILE",
                   help="`train`: save the model here (M_iter<N> after "
                        "each scheduled epoch, M at the end)")
    p.add_argument("-l", "--load", dest="load_path", metavar="FILE",
                   help="the model to resume, evaluate, serve, export or "
                        "release: a checkpoint directory or a save base")
    p.add_argument("--release", action="store_true",
                   help="`evaluate --load M`: write M.release, the model "
                        "without its optimizer state")
    p.add_argument("--save_w2v", metavar="FILE",
                   help="save token embeddings in word2vec format")
    p.add_argument("--save_t2v", metavar="FILE",
                   help="save target embeddings in word2vec format")
    p.add_argument("--vectors_text", action="store_true",
                   help="--export_code_vectors compat: write the "
                        "reference's `.vectors` text layout instead of "
                        "the sharded store format")
    p.add_argument("--artifact_out", dest="export_artifact_path",
                   metavar="DIR",
                   help="`export`: write a release artifact of the "
                        "--load'ed model here")
    p.add_argument("--no_quantize", action="store_true",
                   help="`export`: float32 tables instead of the "
                        "scheme's")
    p.add_argument("--release_scheme",
                   choices=["int8", "fp8_e4m3", "fp8_e5m2", "int4",
                            "float32"], default=None,
                   help="`export`: quantization scheme of the tables "
                        "(default int8)")
    p.add_argument("--embeddings_out", metavar="DIR",
                   help="`export-embeddings`: write the token and target "
                        "tables in word2vec text format here")
    p.add_argument("--adam_mu_dtype", choices=["bfloat16", "float32"],
                   default=None,
                   help="`train`: storage dtype of Adam's first moment "
                        "(default bfloat16)")
    p.add_argument("--adam_nu_dtype", choices=["bfloat16", "float32"],
                   default=None,
                   help="`train`: storage dtype of Adam's second moment "
                        "(default bfloat16)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda, on a mesh "
                        "cuda:$LOCAL_RANK; cpu runs the plain PyTorch "
                        "versions of the kernels)")
    p.add_argument("--dp", type=int, default=None,
                   help="`train`: data-parallel mesh axis size (one "
                        "process a rank: launch dp x tp x cp processes "
                        "with python -m torch.distributed.run)")
    p.add_argument("--tp", type=int, default=None,
                   help="`train`: tensor-parallel axis size (the tables' "
                        "rows)")
    p.add_argument("--cp", type=int, default=None,
                   help="`train`: context-parallel axis size (shards "
                        "MAX_CONTEXTS)")
    p.add_argument("--gspmd", action="store_true",
                   help="the reference's GSPMD route; torch has none, so "
                        "the same explicit-collective steps run")
    p.add_argument("--dist_backend", choices=["nccl", "gloo"],
                   default=None,
                   help="collectives' backend (default: nccl on cuda, "
                        "gloo on cpu; gloo on cuda lets ranks share one "
                        "card)")
    p.add_argument("--dist_init", dest="dist_init_method", default=None,
                   metavar="URL",
                   help="rendezvous (file://PATH or tcp://HOST:PORT) with "
                        "RANK and WORLD_SIZE in the environment; default: "
                        "torchrun's environment")
    p.add_argument("--serve_port", type=int, default=None, metavar="PORT",
                   help="HTTP port (default 8800; 0 picks a free port)")
    p.add_argument("--serve_host", default=None, metavar="HOST",
                   help="bind address (default 127.0.0.1)")
    p.add_argument("--serve_batch_size", type=int, default=None,
                   metavar="ROWS", help="rows per device batch (default 64)")
    p.add_argument("--serve_max_delay_ms", type=float, default=None,
                   metavar="MS",
                   help="longest wait for batch-mates (default 10; 0 = no "
                        "coalescing)")
    p.add_argument("--serve_continuous", action="store_true", default=None,
                   help="continuous batching: arriving rows join the next "
                        "device step of an already-forming slot (parsed "
                        "straight into the slot's buffer); a row arriving "
                        "while a step is in flight rides the next step")
    p.add_argument("--serve_inflight_steps", type=int, default=None,
                   metavar="N",
                   help="device steps the continuous batcher keeps in "
                        "flight at once (default 2)")
    p.add_argument("--serve_buckets", default=None, metavar="LIST",
                   help="padded context-count buckets of the predict path "
                        "(default '32,64,128'; max_contexts is always "
                        "appended)")
    p.add_argument("--serve_cache_entries", type=int, default=None,
                   metavar="N",
                   help="LRU prediction-cache capacity keyed by the "
                        "normalized source (default 4096; 0 disables)")
    p.add_argument("--extractor_pool_size", type=int, default=None,
                   metavar="N",
                   help="warm extractor worker processes kept resident by "
                        "the serving pool (default 2)")
    p.add_argument("--serve_deadline_ms", type=float, default=None,
                   metavar="MS",
                   help="default end-to-end deadline of a request "
                        "(default 2000; the X-Deadline-Ms header "
                        "overrides it; 0 = none); expiry is a 504")
    p.add_argument("--serve_deadline_max_ms", type=float, default=None,
                   metavar="MS",
                   help="ceiling on any request's deadline, the header's "
                        "included (default 30000; 0 = none)")
    p.add_argument("--serve_queue_depth", type=int, default=None,
                   metavar="N",
                   help="admission bound: requests in the cache-miss "
                        "pipeline before more are shed with 503 + "
                        "Retry-After (default 64)")
    p.add_argument("--serve_debug_trace", action="store_true", default=None,
                   help="honour ?debug=trace: the response gains the "
                        "request's span tree")
    p.add_argument("--extractor_timeout", dest="extractor_timeout_s",
                   type=float, default=None, metavar="SECONDS",
                   help="kill a hung extractor after this (default 120; "
                        "0 disables)")
    p.add_argument("--extractor_retries", type=int, default=None,
                   metavar="N",
                   help="requeue a request whose extractor worker "
                        "crashed or failed to launch onto a fresh one, up "
                        "to N times (default 2; timeouts and ERR frames "
                        "are never retried)")
    p.add_argument("--metrics_file", metavar="FILE", default=None,
                   help="`serve`, `train`: write a Prometheus text "
                        "snapshot here, rewritten atomically while serving "
                        "(at every log boundary while training) and at "
                        "exit")
    p.add_argument("--metrics_port", type=int, default=0, metavar="PORT",
                   help="`serve`, `train`: also serve the snapshot at "
                        "http://127.0.0.1:PORT/metrics (0 disables)")
    p.add_argument("--trace_export", metavar="FILE", default=None,
                   help="`serve`: record every request's and batch's "
                        "host spans and write them here as Chrome "
                        "trace-event JSON (Perfetto-loadable), rewritten "
                        "while serving and at exit; `train`: the host "
                        "spans (data wait, dispatch, loss sync, saves, "
                        "evaluations), written when training ends")
    # the training loop's operations (code2vec_tpu/cli.py:596, :655-743)
    p.add_argument("--tensorboard", dest="use_tensorboard",
                   action="store_true",
                   help="`train`: write TensorBoard scalars (train loss/"
                        "throughput, eval metrics, every registry metric) "
                        "to <save>_tb")
    p.add_argument("--rss_limit_gb", type=float, default=0.0,
                   help="`train`: checkpoint-and-stop (like SIGTERM "
                        "preemption) when the process's resident memory "
                        "crosses this many GB; 0 disables")
    p.add_argument("--on_nonfinite_loss", choices=["halt", "warn"],
                   default=None,
                   help="`train`: on a NaN/Inf batch loss, halt (default; "
                        "save <save>_iter<N>_nanhalt and exit nonzero) or "
                        "warn (log and continue)")
    p.add_argument("--async_checkpointing", action="store_true",
                   help="`train`: the epoch saves copy the state to host "
                        "memory and commit it (state files, manifest, "
                        "rename) on a background thread, at most 2 in "
                        "flight; crash-atomicity is unchanged")
    p.add_argument("--no_cursor_resume", action="store_true",
                   help="`train --load`: ignore the checkpoint's data "
                        "cursor and re-run an interrupted epoch from its "
                        "start instead of skipping the rows it consumed")
    p.add_argument("--checkpoint_hash_content", action="store_true",
                   help="`train`: record the sha256 of every checkpoint "
                        "file into its manifest after the commit; resume "
                        "verifies them")
    p.add_argument("--profile_dir", metavar="DIR",
                   help="`train`: write a torch.profiler trace (CPU and "
                        "CUDA) of train batches 10-20 to DIR (Chrome trace "
                        "JSON, Perfetto-viewable)")
    p.add_argument("--heartbeat_file", metavar="FILE",
                   help="`train`: atomically rewrite a JSON heartbeat "
                        "{status, step, epoch, last_loss, wall_time, ...} "
                        "here each log window, so a watchdog can detect a "
                        "hang by staleness")
    p.add_argument("--compute_dtype", choices=["bfloat16", "float32"],
                   default="bfloat16",
                   help="dtype of the kernels' products (default "
                        "bfloat16; an artifact records its own)")
    p.add_argument("--topk_block", dest="topk_block_size", type=int,
                   default=None, metavar="ROWS",
                   help="target-table rows per block of the blockwise "
                        "top-k head (default 4096; 0 = one block)")
    p.add_argument("-v", "--verbose", dest="verbose_mode", type=int,
                   default=1, help="verbose mode in {0,1,2}")
    p.add_argument("--export_code_vectors", action="store_true",
                   help="include code vectors in /predict responses")
    p.add_argument("--predict_file", default="Input.java",
                   help="`predict`: the Java file to re-predict")
    p.add_argument("--serve_mips_nprobe", type=int, default=None,
                   metavar="N",
                   help="approximate-MIPS prediction head: search only the "
                        "N nearest coarse-quantizer lists of the target "
                        "table (default 0 = exact blockwise top-k)")
    p.add_argument("--serve_mips_nlist", type=int, default=None,
                   metavar="N",
                   help="coarse-quantizer size of the MIPS head (default "
                        "0 = sqrt(vocab))")
    p.add_argument("--serve_mips_crossover", type=int, default=None,
                   metavar="ROWS",
                   help="device batches with at most ROWS live rows take "
                        "the MIPS head, larger ones the exact head "
                        "(default -1 = the artifact's calibrated "
                        "crossover, or all-MIPS without one; 0 = exact "
                        "only)")
    # retrieval
    p.add_argument("-te", "--test", dest="test_data_path", metavar="FILE",
                   help="`train`, `evaluate`: the labelled .c2v corpus to "
                        "score; `embed`: the .c2v corpus to embed")
    p.add_argument("--test_batch_size", type=int, default=None,
                   metavar="ROWS", help="`evaluate`, `embed`: rows per "
                                        "device batch (default 1024)")
    p.add_argument("--eval_log", default="log.txt", metavar="FILE",
                   help="`evaluate`, `train --test`: each example's "
                        "outcome (default log.txt)")
    p.add_argument("--embed_out", metavar="DIR",
                   help="`embed`: write the corpus's code vectors into a "
                        "sharded vector store here (resumable per shard)")
    p.add_argument("--embed_dtype", choices=["float32", "float16"],
                   default=None,
                   help="vector-store payload dtype (default float32)")
    p.add_argument("--embed_shard_rows", type=int, default=None,
                   metavar="N", help="rows per committed store shard "
                                     "(default 65536)")
    p.add_argument("--vectors", dest="index_vectors", metavar="DIR",
                   help="`index-build` input: the vector store `embed` "
                        "wrote")
    p.add_argument("--index_out", metavar="DIR",
                   help="`index-build` output: the index artifact "
                        "directory (IVF-flat, or brute force on small "
                        "corpora)")
    p.add_argument("--nlist", dest="index_nlist", type=int, default=None,
                   metavar="N", help="IVF coarse-quantizer size (default 0 "
                                     "= sqrt(rows))")
    p.add_argument("--nprobe", dest="index_nprobe", type=int, default=None,
                   metavar="N", help="inverted lists probed per query, "
                                     "the index's default (default 8)")
    p.add_argument("--kmeans_iters", dest="index_kmeans_iters", type=int,
                   default=None, metavar="N",
                   help="Lloyd iterations of the coarse quantizer "
                        "(default 10)")
    p.add_argument("--index_metric", choices=["cosine", "dot"],
                   default=None,
                   help="similarity metric of the index (default cosine)")
    p.add_argument("--retrieval_index", metavar="DIR",
                   help="`serve`: mount this index so the server answers "
                        "POST /neighbors; its embedding fingerprint must "
                        "match the served model's")
    p.add_argument("--retrieval_topk", type=int, default=None, metavar="K",
                   help="default neighbors per method from /neighbors "
                        "(default 10; JSON body `k` overrides)")
    return p


COMMANDS = ("train", "serve", "predict", "evaluate", "embed",
            "index-build", "export", "export-embeddings", "corpus")
# the commands that run a model: a release artifact or a checkpoint
MODEL_COMMANDS = ("serve", "predict", "evaluate", "embed")


def config_from_args(argv):
    """(parsed args, Config), checked by Config.verify."""
    parser = build_parser()
    args = parser.parse_args(argv)
    cmd = args.command
    if cmd == "train" and not args.data_path:
        parser.error("train needs --data PREFIX")
    if cmd in MODEL_COMMANDS and not (args.serve_artifact or args.load_path):
        parser.error(f"{cmd} needs --artifact DIR or --load MODEL")
    if cmd == "export" and not args.export_artifact_path:
        parser.error("the `export` subcommand requires --artifact_out DIR")
    if cmd == "export-embeddings" and not args.embeddings_out:
        parser.error("the `export-embeddings` subcommand requires "
                     "--embeddings_out DIR (plus --load MODEL)")
    if args.export_artifact_path and cmd != "export":
        parser.error("--artifact_out is the `export` command's output")
    if args.embeddings_out and cmd != "export-embeddings":
        parser.error("--embeddings_out is the `export-embeddings` "
                     "command's output")
    if args.save_path and cmd != "train":
        parser.error("--save is the `train` command's output")
    if args.release and not (cmd == "evaluate" and args.load_path):
        parser.error("--release re-saves a checkpoint: `evaluate --load M "
                     "--release`")
    if (args.save_w2v or args.save_t2v) and cmd not in ("train",
                                                         "evaluate"):
        parser.error("--save_w2v/--save_t2v dump a checkpoint's tables: "
                     "after `train`, or on `evaluate --load M`")
    if args.test_data_path and cmd in ("serve", "predict"):
        parser.error("--test is the corpus of `train` and `evaluate` "
                     "(labelled) and of `embed`")
    if cmd == "evaluate" and not (args.test_data_path or args.release
                                  or args.save_w2v or args.save_t2v):
        parser.error("evaluate needs --test FILE (a labelled .c2v corpus)")
    if cmd == "embed" and not args.embed_out:
        parser.error("the `embed` subcommand requires --embed_out DIR "
                     "(plus --test CORPUS and --artifact DIR or --load "
                     "MODEL)")
    if cmd == "index-build" and not (args.index_vectors and args.index_out):
        parser.error("the `index-build` subcommand requires --vectors DIR "
                     "and --index_out DIR")
    if cmd == "corpus" and not args.train_corpus_manifest:
        parser.error(
            "the `corpus` subcommand requires --train_corpus_manifest "
            "FILE (plus --corpus_create/--corpus_add/--corpus_validate "
            "for the mutation/check actions; plain `corpus` lists the "
            "manifest)")
    config = Config(serve_artifact=args.serve_artifact,
                    device=args.device or "cuda",
                    export_code_vectors=args.export_code_vectors,
                    train_data_path_prefix=args.data_path, seed=args.seed,
                    use_sparse_embedding_update=args.sparse_embedding_update,
                    model_save_path=args.save_path,
                    model_load_path=args.load_path, release=args.release,
                    save_w2v=args.save_w2v, save_t2v=args.save_t2v,
                    vectors_text=args.vectors_text,
                    release_quantize=not args.no_quantize,
                    eval_log_path=args.eval_log,
                    use_packed_data=not args.no_packed_data,
                    corpus=cmd == "corpus",
                    corpus_create=args.corpus_create,
                    corpus_add=args.corpus_add,
                    corpus_validate=bool(args.corpus_validate),
                    serve=cmd == "serve", predict=cmd == "predict",
                    compute_dtype=args.compute_dtype,
                    verbose_mode=args.verbose_mode,
                    metrics_file=args.metrics_file,
                    metrics_port=args.metrics_port,
                    trace_export=args.trace_export,
                    use_tensorboard=args.use_tensorboard,
                    rss_limit_gb=args.rss_limit_gb,
                    async_checkpointing=args.async_checkpointing,
                    cursor_resume=not args.no_cursor_resume,
                    checkpoint_hash_content=args.checkpoint_hash_content,
                    profile_dir=args.profile_dir,
                    heartbeat_file=args.heartbeat_file)
    explicit = []
    # --batch_size sets the test batch too, unless --test_batch_size
    # does (code2vec_tpu/cli.py:1058-1062)
    for name, fields in (("epochs", ("num_train_epochs",)),
                         ("batch_size", ("train_batch_size",
                                         "test_batch_size")),
                         ("max_contexts", ("max_contexts",))):
        value = getattr(args, name)
        if value is not None:
            for field in fields:
                setattr(config, field, value)
                explicit.append(field)
    for name in ("serve_port", "serve_host", "serve_batch_size",
                 "serve_max_delay_ms", "serve_continuous",
                 "serve_inflight_steps", "serve_buckets",
                 "serve_cache_entries", "extractor_pool_size",
                 "serve_deadline_ms", "serve_deadline_max_ms",
                 "serve_queue_depth", "serve_debug_trace",
                 "extractor_timeout_s", "extractor_retries",
                 "topk_block_size",
                 "serve_mips_nprobe", "serve_mips_nlist",
                 "serve_mips_crossover", "test_data_path", "test_batch_size",
                 "embed_out", "embed_dtype", "embed_shard_rows",
                 "index_vectors", "index_out", "index_nlist", "index_nprobe",
                 "index_kmeans_iters", "index_metric", "retrieval_index",
                 "retrieval_topk", "export_artifact_path", "release_scheme",
                 "embeddings_out", "adam_mu_dtype", "adam_nu_dtype",
                 "train_corpus_manifest", "preprocess_workers",
                 "prefetch_double_buffer", "dp", "tp", "cp", "dist_backend",
                 "dist_init_method", "on_nonfinite_loss"):
        value = getattr(args, name)
        if value is not None:
            setattr(config, name, value)
            explicit.append(name)
    config.explicit_knobs = tuple(sorted(explicit))
    if args.device is None and config.mesh_size > 1:
        from code2vec_tpu_torch.parallel.distributed import local_rank
        config.device = f"cuda:{local_rank()}"
    try:
        config.verify()
    except ValueError as e:
        parser.error(str(e))
    return args, config


def corpus_main(config) -> int:
    """The `corpus` command (code2vec_tpu/cli.py:955-987): manifest
    tooling that builds no model; the fingerprints come from the shards'
    own meta sidecars."""
    from code2vec_tpu_torch.data import packed
    manifest_path = config.train_corpus_manifest
    try:
        if config.corpus_create:
            shards = [s for s in config.corpus_create.split(",") if s]
            packed.create_manifest(manifest_path, shards)
            config.log(f"created {manifest_path} "
                       f"({len(shards)} shard(s))")
        if config.corpus_add:
            packed.append_manifest_shard(manifest_path, config.corpus_add)
            config.log(f"appended {config.corpus_add} to {manifest_path}")
        manifest = packed.load_manifest(manifest_path)
        if config.corpus_validate:
            reports = packed.validate_manifest(manifest_path)
        else:
            reports = manifest["shards"]
    except (ValueError, OSError) as e:
        config.log(f"corpus: {e}")
        return 1
    total = sum(r["rows"] for r in reports)
    config.log(f"{manifest_path}: {len(reports)} shard(s), {total} rows, "
               f"max_contexts={manifest['max_contexts']}, vocab "
               f"fingerprint {manifest.get('vocab_fingerprint')}"
               + (" [validated]" if config.corpus_validate else ""))
    for r in reports:
        config.log(f"  {r['path']}: {r['rows']} rows, "
                   f"fingerprint={r.get('vocab_fingerprint')}")
    return 0


def main(argv=None):
    """Runs a command in the reference's order (code2vec_tpu/cli.py
    :1090-1143). `train` returns its Code2VecModel, `evaluate` its
    ModelEvaluationResults (None for --release), `embed` the embed job's
    summary, `index-build` the index meta, `export` the artifact's meta,
    `export-embeddings` the written paths."""
    args, config = config_from_args(sys.argv[1:] if argv is None else argv)
    if args.command == "corpus":
        sys.exit(corpus_main(config))
    if args.command == "index-build":
        from code2vec_tpu_torch.release.runtime import resolve_device
        from code2vec_tpu_torch.retrieval.index import build_index
        return build_index(config.index_vectors, config.index_out,
                           nlist=config.index_nlist,
                           nprobe=config.index_nprobe,
                           kmeans_iters=config.index_kmeans_iters,
                           seed=config.seed, metric=config.index_metric,
                           log=config.log,
                           device=resolve_device(config.device))
    t0 = time.perf_counter()
    if config.serve_artifact:
        from code2vec_tpu_torch.release.runtime import ReleaseModel
        model, what = ReleaseModel(config), "artifact"
    else:
        from code2vec_tpu_torch.model_facade import Code2VecModel
        model, what = Code2VecModel(config), "checkpoint"
    load_s = time.perf_counter() - t0
    if args.command == "export":
        from code2vec_tpu_torch.release.artifact import export_artifact
        t0 = time.perf_counter()
        meta = export_artifact(model, config.export_artifact_path)
        config.log(f"export timing: checkpoint load {load_s:.3f}s, "
                   f"artifact written in {time.perf_counter() - t0:.3f}s")
        return meta
    if args.command == "embed":
        from code2vec_tpu_torch.retrieval.embed_job import run_embed_job
        return run_embed_job(model)
    if args.command == "export-embeddings":
        return model.export_embeddings(config.embeddings_out)
    if args.command == "train":
        model.train()
    for path, vocab_type in ((config.save_w2v, "Token"),
                             (config.save_t2v, "Target")):
        if path:
            from code2vec_tpu_torch.vocab import VocabType
            model.save_word2vec_format(path, VocabType[vocab_type])
            config.log(f"{'Origin' if vocab_type == 'Token' else 'Target'} "
                       f"word vectors saved in word2vec text format in: "
                       f"{path}")
    if args.command == "train":
        return model
    if args.command == "evaluate":
        if config.release:
            return model.evaluate()
        if not config.is_testing:
            return None
        t0 = time.perf_counter()
        results = (model.evaluate(log_path=args.eval_log) if what ==
                   "artifact" else model.evaluate())
        eval_s = time.perf_counter() - t0
        config.log(str(results).replace(
            "topk", f"top{config.top_k_words_considered_during_prediction}"))
        n = config.num_test_examples
        config.log(f"evaluate timing: {what} load {load_s:.3f}s, "
                   f"{n} examples scored in {eval_s:.3f}s "
                   f"({n / max(eval_s, 1e-9):.1f} examples/s)")
        return results
    if args.command == "serve":
        from code2vec_tpu_torch.serving.server import serve_main
        model.warmup()
        sys.exit(serve_main(config, model))
    from code2vec_tpu_torch.serving.interactive import InteractivePredictor
    InteractivePredictor(config, model).predict(args.predict_file)
