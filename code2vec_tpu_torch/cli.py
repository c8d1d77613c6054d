"""Command line of the port: `serve` and `predict` against a release
artifact, with the flag names of code2vec_tpu/cli.py and a `--device`
flag (default cuda).

    python -m code2vec_tpu_torch serve --artifact DIR [--serve_port P]
    python -m code2vec_tpu_torch predict --artifact DIR [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

from code2vec_tpu_torch.config import Config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m code2vec_tpu_torch")
    p.add_argument("command", choices=("serve", "predict"))
    p.add_argument("--artifact", dest="serve_artifact", metavar="DIR",
                   required=True, help="release artifact directory")
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
    args = build_parser().parse_args(argv)
    config = Config(serve_artifact=args.serve_artifact, device=args.device,
                    export_code_vectors=args.export_code_vectors)
    for name in ("serve_port", "serve_host", "serve_batch_size",
                 "serve_max_delay_ms", "extractor_timeout_s"):
        value = getattr(args, name)
        if value is not None:
            setattr(config, name, value)
    return args, config


def main(argv=None) -> None:
    args, config = config_from_args(sys.argv[1:] if argv is None else argv)
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
