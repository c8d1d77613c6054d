#!/usr/bin/env python3
"""K11 (ivf_search) and K2 (masked_attention) alone, on one CUDA GPU.

    python3 scripts/profile_torch_attention_ivf.py [--seed N] [--samples N]
        [--repo DIR] [--skip-index]

Run from the repo root on a machine with a CUDA GPU and nvcc. Shapes are
chip_smoke.py's. K11 on the MIPS head over the flagship classifier
(261,245 rows x 384, k-means lists, nlist 511, nprobe 16) in every row
format (int8, fp8 e4m3 and e5m2, packed int4; quantized on the device
from one seeded f32 table, the same lists for each) at B 1, B 8 with one
live query and seven zero ones (a one-method request as the MIPS
dispatch pads it: `b8`) and B 64, k 10, and at B 64, k 100 (the large-k
mode); K11 on a 1M x 384 f32 index (nlist 1000, 10 spherical Lloyd
steps, nprobe 16, k 16) at B 1 and 64. K2 at B 64 x 200 and 32 contexts
(serving), B 8 x 200 and 32 with one live row (the MIPS batch) and B 1024
x 200 (train). For each: the median device time over --samples runs
(CUDA events, the 50 MB L2 flushed before each), the least time the card
could take (chip_smoke.py `ivf_bound`, `bound`), and PyTorch's calls: for
K11 the chain from the candidates (gather, bmm, topk: `library_ms`) and
the whole function (matmul, topk(nprobe), gather, bmm, topk(k):
`library_full_ms`), for K2 scaled_dot_product_attention (`sdpa_ms`). It
prints one JSON line. With --repo DIR it imports `code2vec_tpu_torch`
from DIR instead, so that two checkouts (say a parent commit unpacked
beside this one) are timed by the same code on the same card in one run.

Exits non-zero where torch sees no CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--samples", type=int, default=25)
    p.add_argument("--repo", default=HERE)
    p.add_argument("--skip-index", action="store_true",
                   help="leave out the 1M-row f32 index")
    p.add_argument("--trace", action="store_true",
                   help="also each launch's device time by torch.profiler "
                        "(`trace_us`: mean microseconds per call by kernel)")
    args = p.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_attention_ivf: needs a CUDA GPU")
    repo = os.path.abspath(args.repo)
    # this checkout's chip_smoke.py (its helpers), the package from `repo`
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    bound = chip_smoke.bound
    sys.path.insert(0, repo)
    from code2vec_tpu_torch.kernels import attention, build, ivf
    from code2vec_tpu_torch.retrieval.index import ivf_lists
    assert ivf.__file__.startswith(repo), ivf.__file__

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all(["ivf_search", "attention", "select", "kmeans"])
    fs = chip_smoke.flagship()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed + 13)
    timer = chip_smoke.Timer(torch, args.samples)
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), "repo": repo, "torch": torch.__version__}
    d, nprobe = fs.code_dim, 16

    def trace(fn, calls=20):
        """Mean device microseconds per call of each kernel `fn` launches
        (torch.profiler over `calls` calls after a warm-up)."""
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return {e.key[:60]: e.device_time_total / calls
                for e in prof.key_averages() if e.device_time_total > 0}

    def timed(name, fn):
        ms = timer(fn)
        if args.trace:
            out.setdefault("trace_us", {})[name] = trace(fn)
        return ms

    def k11(name, q, cent, rows, offsets, k, scales=None, gids=None):
        max_len = int((offsets[1:] - offsets[:-1]).max())
        kw = dict(scales=scales, global_ids=gids, max_len=max_len)
        ms = timed(name, lambda: ivf.ivf_search(q, cent, rows, offsets,
                                                nprobe, k, **kw))
        bms, by, _, _ = chip_smoke.ivf_bound(torch, q, cent, rows, offsets,
                                             nprobe, k, scales, gids)
        lib, full = chip_smoke.ivf_chains(torch, timer, q, cent, rows,
                                          offsets, nprobe, k, scales)
        out[name] = dict(ms=ms, bound_ms=bms, bound_by=by, library_ms=lib,
                         library_full_ms=full)

    # -- the MIPS head: one set of lists, rows in every format
    v_real = fs.vocab["target"]
    f32 = (torch.rand((v_real, d), generator=g, device=dev) * 2 - 1
           ) * math.sqrt(3 / d)
    cent, order, offsets = ivf_lists(f32, max(1, math.isqrt(v_real)), 6,
                                     args.seed, device=dev)
    gids = order.to(torch.int32)
    q = (torch.rand((fs.rows, d), generator=g, device=dev) * 2 - 1)
    for fmt in ("int8", "e4m3", "e5m2", "int4"):
        tbl, scl = chip_smoke.quantize_format(torch, f32, fmt)
        rows = tbl[order].contiguous()
        rs = scl[order].reshape(-1).contiguous()
        del tbl, scl
        for b, x in chip_smoke.mips_batches(q, fs).items():
            tag = b if isinstance(b, str) else f"b{b}"
            k11(f"k11_{fmt}_{tag}", x, cent, rows, offsets, fs.topk, rs,
                gids)
        k11(f"k11_{fmt}_b{fs.rows}_k100", q, cent, rows, offsets, 100, rs,
            gids)
        del rows, rs
        torch.cuda.empty_cache()
    del f32, cent, order, offsets, gids

    # -- the 1M-row f32 index
    if not args.skip_index:
        x = torch.randn((1_000_000, d), generator=g, device=dev)
        x /= torch.linalg.vector_norm(x, dim=1, keepdim=True)
        cent, order, offsets = ivf_lists(x, 1000, 10, args.seed,
                                         spherical=True, device=dev)
        rows = x[order].contiguous()
        del x
        qi = rows[torch.randperm(rows.shape[0], generator=g,
                                 device=dev)[:fs.rows]]
        qi = qi + 0.05 * torch.randn(qi.shape, generator=g, device=dev)
        qi = (qi / torch.linalg.vector_norm(qi, dim=1, keepdim=True)
              ).contiguous()
        for b in (1, fs.rows):
            k11(f"k11_f32_index_b{b}", qi[:b].contiguous(), cent, rows,
                offsets, 16)
        del rows, cent, order, offsets, qi
        torch.cuda.empty_cache()

    # -- K2
    import torch.nn.functional as F
    a = (torch.rand((d,), generator=g, device=dev) * 2 - 1) * 0.25
    for b, m, live in ((fs.rows, fs.contexts, fs.rows), (fs.rows, 32, fs.rows),
                       (chip_smoke.MIPS_ROWS, fs.contexts, 1),
                       (chip_smoke.MIPS_ROWS, 32, 1),
                       (1024, fs.contexts, 1024)):
        t = (torch.rand((b, m, d), generator=g, device=dev) * 2 - 1
             ).to(torch.bfloat16)
        mask = (torch.rand((b, m), generator=g, device=dev) > 0.3).float()
        mask[live:] = 0.0
        ms = timed(f"k2_b{b}_m{m}",
                   lambda: attention.masked_attention(t, a, mask))
        qq = a.to(torch.bfloat16).view(1, 1, 1, d).expand(b, 1, 1, d
                                                           ).contiguous()
        kv = t.view(b, 1, m, d)
        keep = (mask > 0).view(b, 1, 1, m)
        sdpa = timer(lambda: F.scaled_dot_product_attention(
            qq, kv, kv, attn_mask=keep, scale=1.0))
        nbytes = t.numel() * 2 + mask.numel() * 4 * 2 + d * 4 + b * d * 4
        bms, by = bound(nbytes, 4.0 * t.numel())
        out[f"k2_b{b}_m{m}"] = dict(ms=ms, sdpa_ms=sdpa, bound_ms=bms,
                                    bound_by=by)
        del t, mask, kv, qq, keep
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
