"""Command line of the port: `train` from a preprocessed dataset, and
`serve` and `predict` against a release artifact, with the flag names of
code2vec_tpu/cli.py and a `--device` flag (default cuda).

    python -m code2vec_tpu_torch train --data PREFIX --epochs N
        [--batch_size B] [--max_contexts M] [--seed S] [--device cpu]
    python -m code2vec_tpu_torch serve --artifact DIR [--serve_port P]
    python -m code2vec_tpu_torch predict --artifact DIR [--device cpu]

`train` neither saves nor evaluates yet: `--save` and `--test` are
refused.
"""

from __future__ import annotations

import argparse
import sys

from code2vec_tpu_torch.config import Config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m code2vec_tpu_torch")
    p.add_argument("command", choices=("train", "serve", "predict"))
    p.add_argument("--artifact", dest="serve_artifact", metavar="DIR",
                   help="`serve`, `predict`: release artifact directory")
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
    return p


def config_from_args(argv):
    """(parsed args, Config)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command == "train" and not args.data_path:
        parser.error("train needs --data PREFIX")
    if args.command != "train" and not args.serve_artifact:
        parser.error(f"{args.command} needs --artifact DIR")
    config = Config(serve_artifact=args.serve_artifact, device=args.device,
                    export_code_vectors=args.export_code_vectors,
                    train_data_path_prefix=args.data_path, seed=args.seed)
    for name, field in (("epochs", "num_train_epochs"),
                        ("batch_size", "train_batch_size"),
                        ("max_contexts", "max_contexts")):
        value = getattr(args, name)
        if value is not None:
            setattr(config, field, value)
    for name in ("serve_port", "serve_host", "serve_batch_size",
                 "serve_max_delay_ms", "extractor_timeout_s"):
        value = getattr(args, name)
        if value is not None:
            setattr(config, name, value)
    return args, config


def main(argv=None):
    """Runs a command; `train` returns its Code2VecModel."""
    args, config = config_from_args(sys.argv[1:] if argv is None else argv)
    if args.command == "train":
        from code2vec_tpu_torch.model_facade import Code2VecModel
        model = Code2VecModel(config)
        model.train()
        return model
    from code2vec_tpu_torch.release.runtime import ReleaseModel
    model = ReleaseModel(config)
    if args.command == "serve":
        from code2vec_tpu_torch.serving.server import serve_main
        model.warmup()
        sys.exit(serve_main(config, model))
    from code2vec_tpu_torch.serving.extractor_bridge import PathExtractor
    from code2vec_tpu_torch.serving.interactive import interactive_predict
    interactive_predict(config, model, PathExtractor(config),
                        args.predict_file)
