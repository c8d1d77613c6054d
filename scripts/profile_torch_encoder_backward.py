#!/usr/bin/env python3
"""K5 (encoder_backward) alone at the flagship train shape, on one CUDA GPU.

    python3 scripts/profile_torch_encoder_backward.py [--seed N]
        [--samples N] [--repo DIR] [--id_range N]

Run from the repo root on a machine with a CUDA GPU and nvcc. The inputs
are chip_smoke.py's for K5 (java14m vocabularies, dims 128/384, B 1024 x
M 200, dropout keep 0.75 redrawn by K1, f32 tables and W from --seed).
It prints one JSON line: the median device time over --samples runs
(CUDA events, the 50 MB L2 flushed before each) of the dense mode and
the row mode, and, where the package has `pass_times`, each pass's;
beside them the three row gathers alone in PyTorch (`index_select` from
the f32 tables, the bytes K5's passes gather). --id_range N draws every
id below N (a table slice that L2 and the TLBs hold) instead of over the
whole vocabularies. With --repo DIR it imports `code2vec_tpu_torch` from
DIR instead, so that two checkouts (say a parent commit unpacked beside
this one) are timed by the same code on the same card.

Exits non-zero where torch sees no CUDA device.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--samples", type=int, default=25)
    p.add_argument("--repo", default=HERE)
    p.add_argument("--id_range", type=int, default=0)
    args = p.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_encoder_backward: needs a CUDA GPU")
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    sys.path.insert(1, HERE)
    import chip_smoke
    from code2vec_tpu_torch.kernels import build, encoder
    from code2vec_tpu_torch.kernels import encoder_backward as kbwd
    assert kbwd.__file__.startswith(repo), kbwd.__file__

    build.build_all(["encoder", "encoder_backward"])
    fs, ft = chip_smoke.flagship(), chip_smoke.flagship_train()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed + 1)

    def uniform(shape, limit):
        return (torch.rand(shape, generator=g, device=dev) * 2 - 1) * limit

    td, pd, d = fs.token_dim, fs.path_dim, fs.code_dim
    b, m = ft.rows, ft.contexts
    tok = uniform((fs.vocab["token"] + 1, td), math.sqrt(3 / td))
    path = uniform((fs.vocab["path"] + 1, pd), math.sqrt(3 / pd))
    w = uniform((d, d), 1.0)
    ids = [torch.randint(0, min(hi, args.id_range or hi), (b, m),
                         generator=g, device=dev, dtype=torch.int32)
           for hi in (tok.shape[0], path.shape[0], tok.shape[0])]
    drop = encoder.Dropout(ft.keep, seed=args.seed, step=3)
    t, t_lo = encoder.context_encoder(tok, None, path, None, w, *ids,
                                      residual=True, dropout=drop)
    dt = uniform((b, m, d), 0.1).to(torch.bfloat16)
    args_k5 = (dt, t, t_lo, tok, path, w, *ids)
    timer = chip_smoke.Timer(torch, args.samples)
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), "repo": repo, "torch": torch.__version__,
        "id_range": args.id_range}
    flat = [i.reshape(-1).long() for i in ids]
    out["torch_gather_ms"] = timer(lambda: (
        tok.index_select(0, flat[0]), path.index_select(0, flat[1]),
        tok.index_select(0, flat[2])))
    for mode, fn in (("dense", kbwd.encoder_backward),
                     ("rows", kbwd.encoder_backward_rows)):
        out[f"{mode}_ms"] = timer(lambda: fn(*args_k5, dropout=drop))
        if hasattr(kbwd, "pass_times"):
            runs = []
            for _ in range(args.samples):
                timer.flush.zero_()
                runs.append(kbwd.pass_times(*args_k5, rows=mode == "rows",
                                            dropout=drop))
            out[f"{mode}_pass_ms"] = {
                k: statistics.median(r[k] for r in runs) for k in runs[0]}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
