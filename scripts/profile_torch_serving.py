#!/usr/bin/env python3
"""Request latency of the port's HTTP server on one CUDA GPU.

    python3 scripts/profile_torch_serving.py [--seed N] [--repo DIR]
        [--artifact DIR] [--requests N]

Run from the repo root on a machine with a CUDA GPU, nvcc and the native
extractor built (`make -C cpp`). It serves chip_smoke.py's full-width
int8 artifact (seeded random weights over the java14m vocabulary sizes;
written to --artifact unless one is there) with the MIPS head beside the
exact one (`--serve_mips_nprobe 16 --serve_mips_crossover 8`, as
chip_smoke.py's quant path) and the prediction cache off where the
package has one, and times, one request at a time after 10 warm-up:
`--requests` POST /predict of a one-method source (the MIPS head) and a
third as many of a 12-method source (the exact head); then a burst of 96
one-method requests from 8 client threads, under the dynamic batcher
and, where the package has one, the continuous batcher. Each series
gives p50, p99 and max in ms. With --repo DIR it imports
`code2vec_tpu_torch` from DIR instead, so that two checkouts (say a
parent commit unpacked beside this one) are timed by the same code on
the same card in one call. Both use this tree's `cpp/build/c2v-extract`.
It prints one JSON line.

Exits non-zero where torch sees no CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--repo", default=HERE)
    p.add_argument("--artifact", default=os.path.join(HERE, "_scratch",
                                                      "serving-artifact"))
    p.add_argument("--requests", type=int, default=300)
    args = p.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_serving: needs a CUDA GPU")
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    sys.path.insert(1, HERE)
    os.environ["C2V_NATIVE_EXTRACTOR"] = os.path.join(
        HERE, "cpp", "build", "c2v-extract")
    # this tree's chip_smoke.py (a parent checkout's may lack the helpers)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    burst, latency_stats, post = (chip_smoke.burst, chip_smoke.latency_stats,
                                  chip_smoke.post)
    many_methods_source = chip_smoke.many_methods_source
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.kernels import build
    from code2vec_tpu_torch.release.artifact import write_artifact
    from code2vec_tpu_torch.release.runtime import ReleaseModel
    from code2vec_tpu_torch.serving.server import PredictionServer
    assert build.__file__.startswith(repo), build.__file__

    build.build_all(list(build.SOURCES))
    fs = chip_smoke.flagship()
    art = os.path.abspath(args.artifact)
    if not os.path.isdir(art):
        t0 = time.perf_counter()
        params, vocabs, _, _ = chip_smoke.serving_weights(args.seed, fs)
        write_artifact(params, vocabs, art, fs.scheme,
                       max_contexts=fs.contexts,
                       compute_dtype=fs.compute_dtype, topk=fs.topk,
                       topk_block_size=fs.block, serve_batch_size=fs.rows,
                       buckets=fs.buckets)
        del params, vocabs
        print(f"wrote {art} in {time.perf_counter() - t0:.1f}s",
              file=sys.stderr)
    fields = {f.name for f in dataclasses.fields(Config)}
    knobs = dict(serve_artifact=art, device="cuda", verbose_mode=0,
                 serve=True, serve_mips_nprobe=16, serve_mips_crossover=8)
    if "serve_cache_entries" in fields:
        knobs["serve_cache_entries"] = 0
    config = Config(**knobs)
    model = ReleaseModel(config)
    model.warmup()
    one = chip_smoke.SOURCES["Max.java"]
    many = many_methods_source(12)
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), "repo": repo, "torch": torch.__version__}
    batchers = ["dynamic"] + (["continuous"] if "serve_continuous" in fields
                              else [])
    for which in batchers:
        cfg = (dataclasses.replace(config, serve_continuous=True)
               if which == "continuous" else config)
        server = PredictionServer(model, cfg)
        url = f"http://127.0.0.1:{server.start(port=0)}/predict"
        pool = getattr(server, "pool", None)
        try:
            series = {}
            if which == "dynamic":
                for name, src, n in (("one_method", one, args.requests),
                                     ("twelve_methods", many,
                                      args.requests // 3)):
                    lat, _ = chip_smoke.timed_posts(url, src, n)
                    series[name] = latency_stats(lat)
            url_root = url.rsplit("/", 1)[0]
            for _ in range(10):
                post(url, one)
            lat, _ = burst(url_root, [one], 96)
            series["burst_96x8"] = latency_stats(lat)
            series["batches"] = server.batcher.batches_dispatched
        finally:
            server.shutdown()
        series["extractor"] = ("none" if pool is None
                               else "warm" if pool.warm else "cold")
        out[which] = series
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
