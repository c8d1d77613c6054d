#!/usr/bin/env python3
"""Where the port's serving kernels spend their time, on one CUDA GPU.

    python3 scripts/profile_torch_kernels.py [--seed N] [--samples N]

Run from the repo root on a machine with a CUDA GPU and nvcc. At the
flagship serving shape (64 code vectors, 200 contexts, java14m
vocabularies, int8 tables) it prints:

- K3 (blockwise_topk) under variants that isolate its parts: k=1 and
  k=64 (the top-k insertion work), all but 64 table rows masked (no
  insertions at all), all-zero code vectors (every logit ties), an f32
  table (4x the bytes), and 8 code vectors;
- K1 (context_encoder) with random ids and with every id 0 (the gather
  served from one cached row);
- a torch.profiler table of device time per CUDA kernel over five calls
  of each kernel, which splits K3 into its partial and merge launches.

Times are medians of CUDA-event samples with the L2 cache flushed
(chip_smoke.Timer). Exits non-zero where torch sees no CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--samples", type=int, default=15)
    args = p.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_kernels: needs a CUDA GPU")
    sys.path.insert(0, REPO)
    import chip_smoke
    from code2vec_tpu_torch.kernels import (
        attention, build, encoder, label_logits, topk,
    )
    from torch.profiler import ProfilerActivity, profile

    build.build_all()
    fs = chip_smoke.flagship()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    timer = chip_smoke.Timer(torch, args.samples)
    print(f"card: {torch.cuda.get_device_name(0)}")

    def uniform(shape, limit):
        return (torch.rand(shape, generator=g, device=dev) * 2 - 1) * limit

    d = fs.code_dim
    v_tok, v_path, v_tgt = (fs.vocab[k] + 1 for k in ("token", "path",
                                                      "target"))
    tgt32 = uniform((v_tgt, d), (3 / d) ** 0.5)
    tgt, tgt_s = chip_smoke.quantize(torch, tgt32)
    cv = torch.randn((fs.rows, d), generator=g, device=dev) * 0.3

    def k3(code=cv, k=fs.topk, valid=v_tgt, table=tgt, scales=tgt_s):
        return topk.blockwise_topk(code, table, k, fs.block, scales=scales,
                                   valid_rows=valid)

    variants = {
        "K3 int8 (serving shape)": lambda: k3(),
        "K3 k=1": lambda: k3(k=1),
        "K3 k=64": lambda: k3(k=64),
        "K3 all but 64 rows masked": lambda: k3(valid=64),
        "K3 all-zero code vectors": lambda: k3(code=torch.zeros_like(cv)),
        "K3 f32 table": lambda: k3(table=tgt32, scales=None),
        "K3 8 code vectors": lambda: k3(code=cv[:8].contiguous()),
    }
    for name, fn in variants.items():
        print(f"{name}: {timer(fn):.4f} ms")

    tok, tok_s = chip_smoke.quantize(
        torch, uniform((v_tok, fs.token_dim), (3 / fs.token_dim) ** 0.5))
    pth, pth_s = chip_smoke.quantize(
        torch, uniform((v_path, fs.path_dim), (3 / fs.path_dim) ** 0.5))
    w = uniform((d, d), (6 / (2 * d)) ** 0.5)

    def ids(m):
        return [torch.randint(0, n, (fs.rows, m), generator=g, device=dev,
                              dtype=torch.int32)
                for n in (v_tok, v_path, v_tok)]

    for m in (fs.contexts, 32):
        rand_ids = ids(m)
        zero_ids = [torch.zeros_like(i) for i in rand_ids]
        for label, idx in (("random ids", rand_ids), ("every id 0", zero_ids)):
            ms = timer(lambda: encoder.context_encoder(tok, tok_s, pth, pth_s,
                                                       w, *idx))
            print(f"K1 m={m} {label}: {ms:.4f} ms")

    src = ids(fs.contexts)
    t = encoder.context_encoder(tok, tok_s, pth, pth_s, w, *src)
    mask = torch.ones((fs.rows, fs.contexts), device=dev)
    a = torch.randn(d, generator=g, device=dev) * 0.1
    labels = torch.randint(0, v_tgt, (fs.rows,), generator=g, device=dev,
                           dtype=torch.int32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            encoder.context_encoder(tok, tok_s, pth, pth_s, w, *src)
            attention.masked_attention(t, a, mask)
            k3()
            label_logits.label_logits(cv, tgt, labels, scales=tgt_s)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=8))


if __name__ == "__main__":
    main()
