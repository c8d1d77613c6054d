"""Command line of the port: `train` from a preprocessed dataset;
`serve`, `predict`, `evaluate` and `embed` against a release artifact of
any scheme; `index-build` over a vector store. Flag names, defaults and
checks are those of code2vec_tpu/cli.py and config.py, plus a command
word and `--device` (default cuda).

    python -m code2vec_tpu_torch train --data PREFIX --epochs N
        [--batch_size B] [--max_contexts M] [--seed S] [--device cpu]
        [--sparse_embedding_update]
    python -m code2vec_tpu_torch serve --artifact DIR [--serve_port P]
        [--retrieval_index IDX [--retrieval_topk K]]
        [--serve_mips_nprobe P [--serve_mips_nlist N]
         [--serve_mips_crossover R]]
    python -m code2vec_tpu_torch predict --artifact DIR [--device cpu]
    python -m code2vec_tpu_torch evaluate --artifact DIR --test FILE
        [--test_batch_size N] [--eval_log FILE] [--device cpu]
    python -m code2vec_tpu_torch embed --artifact DIR --test CORPUS.c2v
        --embed_out STORE [--embed_dtype float16] [--embed_shard_rows N]
    python -m code2vec_tpu_torch index-build --vectors STORE
        --index_out IDX [--nlist N] [--nprobe P] [--kmeans_iters I]
        [--index_metric cosine|dot]

`train` neither saves nor evaluates yet. `evaluate` is the reference's
`--artifact DIR --test FILE`: it prints the top-k accuracy, subtoken
precision, recall and F1 and the loss, and writes each example's outcome
to `--eval_log` (default log.txt).
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
                        "artifact directory")
    p.add_argument("-d", "--data", dest="data_path", metavar="PREFIX",
                   help="`train`: path prefix of the preprocessed dataset "
                        "(PREFIX.train.c2v, PREFIX.dict.c2v)")
    p.add_argument("--epochs", type=int, default=None,
                   help="`train`: epochs (default 20)")
    p.add_argument("--batch_size", type=int, default=None,
                   help="`train`: rows per step (default 1024)")
    p.add_argument("--max_contexts", type=int, default=None,
                   help="`train`: contexts per method (default 200)")
    p.add_argument("--seed", type=int, default=42,
                   help="`train`: seed of the parameters, dropout and "
                        "shuffle")
    p.add_argument("--sparse_embedding_update", action="store_true",
                   help="`train`: touched-rows (lazy) Adam for the "
                        "token/path tables (training/sparse_adam.py)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions of the kernels)")
    p.add_argument("--serve_port", type=int, default=None, metavar="PORT",
                   help="HTTP port (default 8800; 0 picks a free port)")
    p.add_argument("--serve_host", default=None, metavar="HOST",
                   help="bind address (default 127.0.0.1)")
    p.add_argument("--serve_batch_size", type=int, default=None,
                   metavar="ROWS", help="rows per device batch (default 64)")
    p.add_argument("--serve_max_delay_ms", type=float, default=None,
                   help="longest wait for batch-mates (default 10)")
    p.add_argument("--extractor_timeout", dest="extractor_timeout_s",
                   type=float, default=None, metavar="SECONDS",
                   help="kill a hung extractor after this (default 120)")
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
                   help="`evaluate`: the labelled .c2v corpus to score; "
                        "`embed`: the .c2v corpus to embed")
    p.add_argument("--test_batch_size", type=int, default=None,
                   metavar="ROWS", help="`evaluate`, `embed`: rows per "
                                        "device batch (default 1024)")
    p.add_argument("--eval_log", default="log.txt", metavar="FILE",
                   help="`evaluate`: each example's outcome (default "
                        "log.txt)")
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
            "index-build")


def config_from_args(argv):
    """(parsed args, Config), checked by Config.verify."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command == "train" and not args.data_path:
        parser.error("train needs --data PREFIX")
    if args.command in ("serve", "predict", "evaluate", "embed") and \
            not args.serve_artifact:
        parser.error(f"{args.command} needs --artifact DIR")
    if args.test_data_path and args.command not in ("evaluate", "embed"):
        parser.error("--test is the `embed` command's corpus and the "
                     "`evaluate` command's labelled one")
    if args.command == "evaluate" and not args.test_data_path:
        parser.error("evaluate needs --test FILE (a labelled .c2v corpus)")
    if args.command == "embed" and not args.embed_out:
        parser.error("the `embed` subcommand requires --embed_out DIR "
                     "(plus --test CORPUS and --artifact DIR)")
    if args.command == "index-build" and not (args.index_vectors
                                              and args.index_out):
        parser.error("the `index-build` subcommand requires --vectors DIR "
                     "and --index_out DIR")
    config = Config(serve_artifact=args.serve_artifact, device=args.device,
                    export_code_vectors=args.export_code_vectors,
                    train_data_path_prefix=args.data_path, seed=args.seed,
                    use_sparse_embedding_update=args.sparse_embedding_update,
                    serve=args.command == "serve",
                    predict=args.command == "predict")
    explicit = []
    for name, field in (("epochs", "num_train_epochs"),
                        ("batch_size", "train_batch_size"),
                        ("max_contexts", "max_contexts")):
        value = getattr(args, name)
        if value is not None:
            setattr(config, field, value)
            explicit.append(field)
    for name in ("serve_port", "serve_host", "serve_batch_size",
                 "serve_max_delay_ms", "extractor_timeout_s",
                 "serve_mips_nprobe", "serve_mips_nlist",
                 "serve_mips_crossover", "test_data_path", "test_batch_size",
                 "embed_out", "embed_dtype", "embed_shard_rows",
                 "index_vectors", "index_out", "index_nlist", "index_nprobe",
                 "index_kmeans_iters", "index_metric", "retrieval_index",
                 "retrieval_topk"):
        value = getattr(args, name)
        if value is not None:
            setattr(config, name, value)
            explicit.append(name)
    config.explicit_knobs = tuple(sorted(explicit))
    try:
        config.verify()
    except ValueError as e:
        parser.error(str(e))
    return args, config


def main(argv=None):
    """Runs a command; `train` returns its Code2VecModel, `evaluate` its
    ModelEvaluationResults, `embed` the embed job's summary and
    `index-build` the index meta."""
    args, config = config_from_args(sys.argv[1:] if argv is None else argv)
    if args.command == "train":
        from code2vec_tpu_torch.model_facade import Code2VecModel
        model = Code2VecModel(config)
        model.train()
        return model
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
    from code2vec_tpu_torch.release.runtime import ReleaseModel
    t0 = time.perf_counter()
    model = ReleaseModel(config)
    load_s = time.perf_counter() - t0
    if args.command == "embed":
        from code2vec_tpu_torch.retrieval.embed_job import run_embed_job
        return run_embed_job(model)
    if args.command == "evaluate":
        t0 = time.perf_counter()
        results = model.evaluate(log_path=args.eval_log)
        eval_s = time.perf_counter() - t0
        config.log(str(results).replace(
            "topk", f"top{config.top_k_words_considered_during_prediction}"))
        n = config.num_test_examples
        config.log(f"evaluate timing: artifact load {load_s:.3f}s, "
                   f"{n} examples scored in {eval_s:.3f}s "
                   f"({n / max(eval_s, 1e-9):.1f} examples/s)")
        return results
    if args.command == "serve":
        from code2vec_tpu_torch.serving.server import serve_main
        model.warmup()
        sys.exit(serve_main(config, model))
    from code2vec_tpu_torch.serving.extractor_bridge import PathExtractor
    from code2vec_tpu_torch.serving.interactive import interactive_predict
    interactive_predict(config, model, PathExtractor(config),
                        args.predict_file)
