#!/usr/bin/env python3
"""K1 (context_encoder) and K7 (softmax_xent) alone, on one CUDA GPU.

    python3 scripts/profile_torch_encoder_xent.py [--seed N] [--samples N]
        [--repo DIR] [--trace] [--skip-probe] [--only k1|k7|probe]

Run from the repo root on a machine with a CUDA GPU and nvcc. Shapes are
chip_smoke.py's (java14m vocabularies, dims 128/128 -> 384, 200 contexts;
tables random from --seed, quantized on the device):

- K1 in train mode (B 1024, f32 tables, dropout keep 0.75, with the
  residual: `k1_train`), in serve mode at B 64 (`k1_serve_<fmt>`) and at
  the `evaluate` batch, B 1024 (`k1_eval_<fmt>`), in every table format
  (float32, int8, e4m3, e5m2, int4). Beside each: the least time the
  card could take (`bound_ms`, chip_smoke.py `bound`: the unique rows,
  ids, W and the bf16 outputs once, or the bf16 product), and the whole
  function in PyTorch calls (`library_ms`, chip_smoke.py `k1_library`:
  three index_select, the dequantization, cat, the bf16 cast, dropout on
  the same mask, torch.mm with f32 accumulation, tanh).
- K7 on f32 logits at B 1024 and 64 x 261,246 (`k7_b<B>`) and an odd
  width, 261,245 (`k7_b<B>_odd`), with the plan's cluster size, and
  with C 0 (the two-read kernel), 8 and 16 (`c0_ms`, `c8_ms`, `c16_ms`:
  the C entry point c2v_softmax_xent called with that C, which the
  wrapper never forces), beside F.cross_entropy forward and backward
  (`library_ms`), the bound (the logits read once, both bf16 planes
  written once) and a device copy of the logits (`copy_ms`: the same
  bytes read and written, no arithmetic).
- The gather probe (`probe`, csrc/gather_probe.cu, built here only): a
  kernel that only reads random 512-byte rows of the 1,301,137-row f32
  token table (614,400 rows, the train shape's three gathers), 8, 16, 32
  and 64 KB in flight per SM, over the whole table and with the ids
  confined to its first 32 MB (65,536 rows): GB/s per setting.

Device times are medians over --samples runs by CUDA events, the 50 MB
L2 flushed before each (chip_smoke.py `Timer`). --trace adds each
launch's device time by torch.profiler (`trace_us`). It prints one JSON
line. With --repo DIR it imports `code2vec_tpu_torch` from DIR instead,
so that two checkouts (say a parent commit unpacked beside this one) are
timed by the same code on the same card in one run; what DIR's package
lacks (the cluster kernel's entry point, the probe) is left out.

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
FORMATS = ("float32", "int8", "e4m3", "e5m2", "int4")
PROBE_ROWS_32MB = 32 * 2 ** 20 // 512


def forced_cluster_ms(timer, kxent, logits, labels, valid, cluster,
                      name):
    """K7's device time with `cluster` CTAs a row (0: the two-read
    kernel), by its C entry point, or None where a CTA's slice does not
    fit this card's shared memory."""
    import torch
    from code2vec_tpu_torch.kernels import launch
    fn = kxent._fn()
    b, v = logits.shape
    dev = logits.device
    units = -(-(v // 4) // cluster) if cluster else 0
    if cluster and not 0 <= kxent._fns["smem"](units) <= \
            launch.shared_memory_limit(dev):
        return None
    grad = torch.empty((2, b, v), dtype=torch.bfloat16, device=dev)
    ce = torch.empty((b,), device=dev)
    loss = torch.empty((), device=dev)

    def run():
        launch.check_launch(fn(
            logits.data_ptr(), b, v, v, labels.data_ptr(), valid.data_ptr(),
            grad.data_ptr(), ce.data_ptr(), loss.data_ptr(), cluster, units,
            launch.stream(dev)), name)

    return timer(run)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--samples", type=int, default=25)
    p.add_argument("--repo", default=HERE)
    p.add_argument("--trace", action="store_true")
    p.add_argument("--skip-probe", action="store_true")
    p.add_argument("--only", choices=("k1", "k7", "probe"))
    args = p.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_encoder_xent: needs a CUDA GPU")
    repo = os.path.abspath(args.repo)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    bound = chip_smoke.bound
    sys.path.insert(0, repo)
    from code2vec_tpu_torch.kernels import build, encoder, launch
    from code2vec_tpu_torch.kernels import softmax_xent as kxent
    assert encoder.__file__.startswith(repo), encoder.__file__
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all(["encoder", "softmax_xent"])
    fs, ft = chip_smoke.flagship(), chip_smoke.flagship_train()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed + 29)
    timer = chip_smoke.Timer(torch, args.samples)
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), "repo": repo, "torch": torch.__version__}

    def trace(fn, calls=10):
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return {e.key[:60]: e.device_time_total / calls
                for e in prof.key_averages() if e.device_time_total > 0}

    def timed(name, fn, spin_ms=2.0):
        ms = timer(fn, spin_ms=spin_ms)
        if args.trace:
            out.setdefault("trace_us", {})[name] = trace(fn)
        return ms

    def uniform(shape, limit):
        return (torch.rand(shape, generator=g, device=dev) * 2 - 1) * limit

    v_tok, v_path, v_tgt = (fs.vocab["token"] + 1, fs.vocab["path"] + 1,
                            fs.vocab["target"] + 1)
    td, pd, d = fs.token_dim, fs.path_dim, fs.code_dim
    k_dim = 2 * td + pd

    if args.only in (None, "k1"):
        f32 = {"tok": uniform((v_tok, td), math.sqrt(3 / td)),
               "path": uniform((v_path, pd), math.sqrt(3 / pd))}
        w = uniform((k_dim, d), 1.0)

        def ids(b):
            return [torch.randint(0, hi, (b, fs.contexts), generator=g,
                                  device=dev, dtype=torch.int32)
                    for hi in (v_tok, v_path, v_tok)]

        def k1_bytes(idx, fmt, outputs):
            esize = {"float32": 4, "int8": 1, "e4m3": 1, "e5m2": 1,
                     "int4": 0.5}[fmt]
            ssize = 0 if fmt == "float32" else 4
            tok_u = torch.unique(torch.cat([idx[0], idx[2]])).numel()
            path_u = torch.unique(idx[1]).numel()
            n = idx[0].numel()
            return (tok_u * (td * esize + ssize)
                    + path_u * (pd * esize + ssize) + 3 * n * 4
                    + w.numel() * 4 + outputs * n * d * 2), n

        # train mode
        b = ft.rows
        idx = ids(b)
        drawn = torch.empty((b, fs.contexts, k_dim), dtype=torch.bool,
                            device=dev)
        kw = dict(residual=True)
        encoder.context_encoder(
            f32["tok"], None, f32["path"], None, w, *idx, **kw,
            dropout=encoder.Dropout(ft.keep, seed=args.seed, step=3,
                                    out_mask=drawn))
        ms = timed("k1_train", lambda: encoder.context_encoder(
            f32["tok"], None, f32["path"], None, w, *idx, **kw,
            dropout=encoder.Dropout(ft.keep, seed=args.seed, step=3)))
        nbytes, n = k1_bytes(idx, "float32", 2)
        bms, by = bound(nbytes, 2.0 * n * k_dim * d)
        lib = timer(lambda: chip_smoke.k1_library(
            torch, f32["tok"], None, f32["path"], None, w, idx, drawn,
            ft.keep, True), spin_ms=20)
        out["k1_train"] = dict(ms=ms, bound_ms=bms, bound_by=by,
                               library_ms=lib)
        del drawn
        # serve and evaluate shapes, every format
        for fmt in FORMATS:
            tok, tok_s = chip_smoke.quantize_format(torch, f32["tok"], fmt)
            path, path_s = chip_smoke.quantize_format(torch, f32["path"],
                                                      fmt)
            for tag, b in (("serve", fs.rows), ("eval", 1024)):
                idx = ids(b)
                args_ = (tok, tok_s, path, path_s, w, *idx)
                name = f"k1_{tag}_{fmt}"
                ms = timed(name, lambda: encoder.context_encoder(*args_))
                nbytes, n = k1_bytes(idx, fmt, 1)
                bms, by = bound(nbytes, 2.0 * n * k_dim * d)
                lib = timer(lambda: chip_smoke.k1_library(
                    torch, tok, tok_s, path, path_s, w, idx), spin_ms=10)
                out[name] = dict(ms=ms, bound_ms=bms, bound_by=by,
                                 library_ms=lib)
            del tok, tok_s, path, path_s
            torch.cuda.empty_cache()
        del f32, w
        torch.cuda.empty_cache()

    if args.only in (None, "k7"):
        forced = hasattr(kxent, "device_plan")
        for b, v in ((ft.rows, v_tgt), (ft.rows, v_tgt - 1),
                     (64, v_tgt), (64, v_tgt - 1)):
            logits = torch.randn((b, v), generator=g, device=dev) * 3
            labels = torch.randint(0, v, (b,), generator=g, device=dev,
                                   dtype=torch.int32)
            valid = torch.ones(b, device=dev)
            tag = f"k7_b{b}" + ("_odd" if v % 2 else "")
            nbytes = logits.numel() * 4 + logits.numel() * 2 * 2 + b * 8 + 4
            bms, by = bound(nbytes, 5.0 * logits.numel())
            leaf = logits.clone().requires_grad_(True)
            lab64 = labels.long()

            def lib_fn():
                leaf.grad = None
                ((F.cross_entropy(leaf, lab64, reduction="none") * valid
                  ).sum() / b).backward()

            lib = timer(lib_fn, spin_ms=10)
            del leaf
            copy = torch.empty_like(logits)
            copy_ms = timer(lambda: copy.copy_(logits))
            del copy
            entry = dict(ms=timed(tag, lambda: kxent.softmax_xent(
                logits, labels, valid)), bound_ms=bms, bound_by=by,
                library_ms=lib, copy_ms=copy_ms)
            if forced:
                entry["cluster"] = kxent.device_plan(b, v, dev).cluster
                for c in (0, 8, 16):
                    entry[f"c{c}_ms"] = forced_cluster_ms(
                        timer, kxent, logits, labels, valid, c, f"{tag}_c{c}")
            out[tag] = entry
            del logits
            torch.cuda.empty_cache()

    if args.only in (None, "probe") and not args.skip_probe \
            and os.path.isfile(os.path.join(build.CSRC, "gather_probe.cu")):
        probe = launch.bind("gather_probe", "c2v_gather_probe",
                            [launch.P, launch.P, launch.I64, launch.I32,
                             launch.P, launch.P])
        table = torch.randn((v_tok, td), generator=g, device=dev)
        sink = torch.zeros(1, device=dev)
        n = ft.rows * fs.contexts * 3
        res = {}
        for where, hi in (("table", v_tok), ("first_32mb", PROBE_ROWS_32MB)):
            ids_ = torch.randint(0, hi, (n,), generator=g, device=dev,
                                 dtype=torch.int32)
            for u in (1, 2, 4, 8):
                def run():
                    launch.check_launch(probe(
                        table.data_ptr(), ids_.data_ptr(), n, u,
                        sink.data_ptr(), launch.stream(dev)), "gather_probe")
                ms = timer(run)
                res[f"{where}_{8 * u}kb"] = dict(
                    ms=ms, gb_per_s=n * 512 / ms / 1e6)
        out["probe"] = res
        del table
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
