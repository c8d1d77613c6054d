#!/usr/bin/env python3
"""K3 (blockwise_topk) and K9 (kmeans_assign) alone, on one CUDA GPU.

    python3 scripts/profile_torch_topk.py [--seed N] [--samples N]
        [--repo DIR]

Run from the repo root on a machine with a CUDA GPU and nvcc. Shapes are
chip_smoke.py's: K3 over the flagship target table (261,246 x 384, java14m)
in every table format (f32 and int8, fp8 e4m3 and e5m2, packed int4;
quantized on the device from one seeded f32 table) at the serving batch
(B 64) and the evaluate batch (B 1024), k 10, for two kinds of code
vectors: uniform in [-1, 1] (`k3_<format>_b<B>`) and the serving path's
(K1 and K2 over random contexts of the java14m-sized f32 tables, as
chip_smoke.py's kernel phase makes them: `k3_<format>_b<B>_path`; they
are much alike, so their lists take their insertions in the same
tiles), and those padded as the serving path pads a batch, with zero
code vectors (a zero mask; K2 gives such a row 0, so every logit of
the row is equal): B 64 with row 0 zero as chip_smoke.py's kernel
phase has it (`_pad1`), B 64 with 12 live rows (a request of 12
methods, `_pad52`) and B 1024 with 37 live rows (the evaluate tail of
chip_smoke.py's 4,133 methods, `_pad987`); K3's float32 mode over
1,000,000 normalised f32 rows at B 64, k 16; K9 at the index shape (1M x
384 rows, 1000 centroids) and the MIPS shape (261,245 int8-dequantised
rows, 511 centroids). For each: the median device time over --samples
runs (CUDA events, the 50 MB L2 flushed before each), the least time the
card could take (chip_smoke.py `bound`), and one PyTorch call computing
the same function (the cast or int4 unpack, a matmul and torch.topk; K9:
addmm and argmin). It prints one JSON line. With --repo DIR it imports
`code2vec_tpu_torch` from DIR instead, so that two checkouts (say a
parent commit unpacked beside this one) are timed by the same code on
the same card in one run.

Exits non-zero where torch sees no CUDA device.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 3xTF32: three tf32 products at the card's dense tf32 peak
TF32_FLOP_PER_S = 495e12


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--samples", type=int, default=25)
    p.add_argument("--repo", default=HERE)
    args = p.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_topk: needs a CUDA GPU")
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    sys.path.insert(1, HERE)
    import chip_smoke
    from chip_smoke import bound
    from code2vec_tpu_torch.kernels import (
        attention, build, encoder, kmeans, topk,
    )
    from code2vec_tpu_torch.ops.quant import unpack_int4
    assert topk.__file__.startswith(repo), topk.__file__

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all(["topk", "kmeans", "select", "encoder", "attention"])
    fs = chip_smoke.flagship()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed + 11)
    timer = chip_smoke.Timer(torch, args.samples)
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), "repo": repo, "torch": torch.__version__}

    d, k = fs.code_dim, fs.topk
    v_tgt = fs.vocab["target"] + 1
    f32 = (torch.rand((v_tgt, d), generator=g, device=dev) * 2 - 1
           ) * math.sqrt(3 / d)
    cvs = {f"b{b}": (torch.rand((b, d), generator=g, device=dev) * 2 - 1)
           for b in (64, 1024)}
    # the serving path's code vectors: K1 then K2 over random contexts
    td, pd = fs.token_dim, fs.path_dim
    v_tok, v_path = fs.vocab["token"] + 1, fs.vocab["path"] + 1
    tok = (torch.rand((v_tok, td), generator=g, device=dev) * 2 - 1
           ) * math.sqrt(3 / td)
    path = (torch.rand((v_path, pd), generator=g, device=dev) * 2 - 1
            ) * math.sqrt(3 / pd)
    w = (torch.rand((d, d), generator=g, device=dev) * 2 - 1)
    a = (torch.rand((d,), generator=g, device=dev) * 2 - 1) * 0.25
    for b in (64, 1024):
        ids = [torch.randint(0, n, (b, fs.contexts), generator=g, device=dev,
                             dtype=torch.int32)
               for n in (v_tok, v_path, v_tok)]
        mask = (torch.rand((b, fs.contexts), generator=g, device=dev)
                > 0.3).float()
        t = encoder.context_encoder(tok, None, path, None, w, *ids)
        cvs[f"b{b}_path"] = attention.masked_attention(t, a, mask)[0
                                                                ].contiguous()
    del tok, path, t
    torch.cuda.empty_cache()
    for b, live, name in ((64, None, "pad1"), (64, 12, "pad52"),
                          (1024, 37, "pad987")):
        cv = cvs[f"b{b}_path"].clone()
        if live is None:
            cv[0] = 0.0
        else:
            cv[live:] = 0.0
        cvs[f"b{b}_path_{name}"] = cv
    for fmt in ("float32", "int8", "e4m3", "e5m2", "int4"):
        tbl, scl = chip_smoke.quantize_format(torch, f32, fmt)
        tbl_bytes = tbl.numel() * tbl.element_size() + (
            0 if scl is None else v_tgt * 4)
        for name, cv in cvs.items():
            b = cv.shape[0]
            kw = dict(scales=scl, valid_rows=v_tgt)
            ms = timer(lambda: topk.blockwise_topk(cv, tbl, k, fs.block,
                                                   **kw))
            cv_bf16 = cv.to(torch.bfloat16)
            if fmt == "int4":
                lib = timer(lambda: torch.topk(torch.matmul(
                    cv_bf16, unpack_int4(tbl, d).to(torch.bfloat16).T), k),
                    spin_ms=20)
            else:
                lib = timer(lambda: torch.topk(torch.matmul(
                    cv_bf16, tbl.to(torch.bfloat16).T), k))
            bms, by = bound(tbl_bytes + cv.numel() * 4 + b * k * 8 + b * 4,
                            2.0 * b * v_tgt * d)
            out[f"k3_{fmt}_{name}"] = dict(ms=ms, library_ms=lib,
                                           bound_ms=bms, bound_by=by)
        del tbl, scl
        torch.cuda.empty_cache()

    # K3's float32 mode and K9 at the index shape
    x = torch.randn((1_000_000, d), generator=g, device=dev)
    x /= torch.linalg.vector_norm(x, dim=1, keepdim=True)
    q = x[:64] + 0.05 * torch.randn((64, d), generator=g, device=dev)
    q = (q / torch.linalg.vector_norm(q, dim=1, keepdim=True)).contiguous()
    kw = dict(compute_dtype=torch.float32)
    ms = timer(lambda: topk.blockwise_topk(q, x, 16, 4096, **kw))
    lib = timer(lambda: torch.topk(torch.matmul(q, x.T), 16))
    nbytes = x.numel() * 4 + q.numel() * 4 + 64 * 16 * 8 + 64 * 4
    flops = 2.0 * 64 * x.shape[0] * d
    bms, by = bound(nbytes, 3 * flops, TF32_FLOP_PER_S)
    f32_bms, f32_by = bound(nbytes, flops, chip_smoke.F32_FLOP_PER_S)
    out["k3_f32_mode_1m"] = dict(ms=ms, library_ms=lib, bound_ms=bms,
                                 bound_by=by, f32_fma_bound_ms=f32_bms)

    def k9(rows, nlist, name):
        c0 = rows[torch.randperm(rows.shape[0], generator=g,
                                 device=dev)[:nlist]].contiguous()
        cn = (c0 * c0).sum(1)
        t = timer(lambda: kmeans.kmeans_assign(rows, c0), spin_ms=10)
        lib = timer(lambda: torch.argmin(torch.addmm(
            cn[None, :], rows, c0.T, alpha=-2.0), dim=1), spin_ms=10)
        n = rows.shape[0]
        nbytes = (n * d + nlist * d) * 4 + n * 4
        flops = 2.0 * n * nlist * d
        bms, by = bound(nbytes, 3 * flops, TF32_FLOP_PER_S)
        f32_bms, _ = bound(nbytes, flops, chip_smoke.F32_FLOP_PER_S)
        out[name] = dict(ms=t, library_ms=lib, bound_ms=bms, bound_by=by,
                         f32_fma_bound_ms=f32_bms)

    k9(x, 1000, "k9_index")
    del x, q
    torch.cuda.empty_cache()
    q8, s8 = chip_smoke.quantize(torch, f32)
    rows = (q8[:v_tgt - 1].float() * s8[:v_tgt - 1]).contiguous()
    k9(rows, 511, "k9_mips")
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
