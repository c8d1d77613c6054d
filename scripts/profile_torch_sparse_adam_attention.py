#!/usr/bin/env python3
"""K12 (sparse_adam) and K6 (masked_attention_backward) alone, on one
CUDA GPU.

    python3 scripts/profile_torch_sparse_adam_attention.py [--seed N]
        [--samples N] [--repo DIR] [--only k12|k6]

Run from the repo root on a machine with a CUDA GPU and nvcc. Shapes are
chip_smoke.py's:

- K12 over both tables of one sparse step (token 1,301,137 x 128 with
  409,600 ids, path 911,418 x 128 with 204,800 ids; f32 tables, bf16 mu,
  f32 nu, bf16 gradient rows), with ids uniform (`k12_uniform`) and
  Zipf(1.07) (`k12_zipf`), as the sparse step calls it (one call for
  both tables where the package has `sparse_adam_tables`, else one a
  table). Beside the whole time: the device time of each pass by
  torch.profiler (`pass_us`: the sort, the segment pass and the combine
  pass, mean microseconds a call, by kernel name) and of each kernel
  (`kernels_us`), the least time the card could take (`bound_ms`,
  chip_smoke.py `k12_bound`), torch.optim.SparseAdam on the same rows
  (`library_ms`, f32 moments), and K12's row bytes alone by the row
  read-modify-write probe (`rmw_probe`, csrc/gather_probe.cu, built here
  only: each touched row's table, mu and nu read and written back with
  one gradient row, `rmw_ms`, and read only, `read_ms`).
- K6 at B 1024 and 64 x 200 contexts x 384 (`k6_b<B>`; row 0 all
  masked, 30% of the other contexts masked), with each launch's device
  time (`pass_us`), the bound (T read once, dT written once) and the
  backward alone of scaled_dot_product_attention with T as key and
  value, one query a row and the mask (`library_ms`, chip_smoke.py
  `k6_library`), and with 1, 2, 4 and 8 CTAs a row by the C entry point
  (`c1_ms` .. `c8_ms`; the wrapper takes `backward_plan`'s, `cluster`).

Device times are medians over --samples runs by CUDA events, the 50 MB
L2 flushed before each (chip_smoke.py `Timer`). It prints one JSON line.
With --repo DIR it imports `code2vec_tpu_torch` from DIR instead, so
that two checkouts (say a parent commit unpacked beside this one) are
timed by the same code on the same card in one run.

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
# the parent's sort kernels, beside this tree's (chip_smoke.K12_PASSES)
PARENT_SORT = (("radix_", "sort"),)
K12_KERNELS = (("sort_zero", "zero"), ("sort_hist", "hist"),
               ("sort_scan", "scan"), ("sort_pass", "scatter"),
               ("segment_kernel", "segment"), ("combine_kernel", "combine"))


def forced_k6(timer, attention, t, a, mask, attn, dcv, cluster):
    """K6's device time with `cluster` CTAs a row, by its C entry point
    (the wrapper takes the plan's), or None where a chunk does not fit."""
    import torch
    from code2vec_tpu_torch.kernels import launch
    fn = attention._backward_fn()
    b, m, d = t.shape
    chunk = -(-m // cluster)
    if attention.backward_smem_bytes(chunk, d, True) > \
            launch.shared_memory_limit(t.device):
        return None
    dt = torch.empty_like(t)
    rows = torch.empty((b, d), dtype=torch.float32, device=t.device)
    da = torch.empty((d,), dtype=torch.float32, device=t.device)

    def run():
        launch.check_launch(fn(
            t.data_ptr(), a.data_ptr(), mask.data_ptr(), attn.data_ptr(),
            dcv.data_ptr(), b, m, d, cluster, chunk, 1, dt.data_ptr(),
            rows.data_ptr(), da.data_ptr(), launch.stream(t.device)),
            "masked_attention_backward")

    return timer(run)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--samples", type=int, default=25)
    p.add_argument("--repo", default=HERE)
    p.add_argument("--only", choices=("k12", "k6"))
    args = p.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_sparse_adam_attention: needs a CUDA GPU")
    repo = os.path.abspath(args.repo)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    sys.path.insert(0, repo)
    from code2vec_tpu_torch.kernels import attention, build, launch
    from code2vec_tpu_torch.kernels import sparse_adam as ksa
    from code2vec_tpu_torch.training.sparse_adam import RowAdamSlots
    assert ksa.__file__.startswith(repo), ksa.__file__

    build.build_all(["sparse_adam", "attention_backward", "attention"])
    fs, ft = chip_smoke.flagship(), chip_smoke.flagship_train()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed + 31)
    timer = chip_smoke.Timer(torch, args.samples)
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), "repo": repo, "torch": torch.__version__}

    def trace(fn, passes):
        return chip_smoke.device_passes(torch, fn, passes)

    def uniform(shape, limit):
        return (torch.rand(shape, generator=g, device=dev) * 2 - 1) * limit

    def rmw_probe(case, states):
        """K12's row bytes alone (csrc/gather_probe.cu c2v_row_rmw_probe)
        over both tables' sorted unique ids, each with its first
        gradient row: ms read and written back, and read only."""
        probe = launch.bind("gather_probe", "c2v_row_rmw_probe",
                            [launch.P] * 6 + [launch.I64, launch.I32,
                                              launch.P, launch.P])
        sink = torch.zeros(1, device=dev)
        jobs = []
        for name, (idx, rows) in case.items():
            uid, first = torch.unique(idx, return_inverse=True)
            pos = torch.full((uid.numel(),), idx.numel(), device=dev,
                             dtype=torch.int64).scatter_reduce_(
                0, first, torch.arange(idx.numel(), device=dev), "amin")
            t, m_, n_ = (x.clone() for x in states[name])
            jobs.append((t, m_, n_, rows, uid.int(), pos.int()))
        res = {}
        for write in (1, 0):
            def run():
                for t, m_, n_, rows, uid, pos in jobs:
                    launch.check_launch(probe(
                        t.data_ptr(), m_.data_ptr(), n_.data_ptr(),
                        rows.data_ptr(), uid.data_ptr(), pos.data_ptr(),
                        uid.numel(), write, sink.data_ptr(),
                        launch.stream(dev)), "row_rmw_probe")
            res["rmw_ms" if write else "read_ms"] = timer(run)
        return res

    if args.only in (None, "k12"):
        n = ft.rows * fs.contexts
        tables = {"token": (fs.vocab["token"] + 1, 2 * n),
                  "path": (fs.vocab["path"] + 1, n)}
        states = {name: (uniform((v, 128), math.sqrt(3 / 128)),
                         (torch.randn((v, 128), generator=g, device=dev)
                          * 1e-3).to(torch.bfloat16),
                         torch.rand((v, 128), generator=g, device=dev) * 1e-6)
                  for name, (v, _) in tables.items()}
        hyper = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)
        for dist in ("uniform", "zipf"):
            case = {}
            for name, (v, cnt) in tables.items():
                idx = (chip_smoke.zipf_ids(torch, g, cnt, v, dev)
                       if dist == "zipf" else
                       torch.randint(0, v, (cnt,), generator=g, device=dev,
                                     dtype=torch.int32))
                rows = (torch.randint(-127, 128, (cnt, 128), generator=g,
                                      device=dev).float() * 2.0 ** -12
                        ).to(torch.bfloat16)
                case[name] = (idx, rows)
            work = [(states[name][0].clone(),
                     RowAdamSlots(mu=states[name][1].clone(),
                                  nu=states[name][2].clone()), *case[name])
                    for name in tables]
            extra = {}
            if hasattr(ksa, "sparse_adam_tables"):
                def run():
                    ksa.sparse_adam_tables(work, t=7, **hyper)

                extra["kernels_us"] = trace(run, K12_KERNELS)
                extra["rmw_probe"] = rmw_probe(case, states)
            else:
                def run():
                    for p_, slots, idx, rows in work:
                        ksa.sparse_adam(p_, slots, idx, rows, t=7, **hyper)
            for _ in range(20):  # clocks up before the first timing
                run()
            ms = timer(run)
            passes = trace(run, PARENT_SORT + chip_smoke.K12_PASSES)
            per = trace(run, (("", "all"),))
            bms, by = chip_smoke.k12_bound(
                torch, [(case[name][0], v, 128)
                        for name, (v, _) in tables.items()], 2)
            lib = chip_smoke.k12_library(
                torch, timer, [(states[name][0], *case[name])
                               for name in tables], hyper)
            out[f"k12_{dist}"] = dict(ms=ms, pass_us=passes, device_us=per,
                                      bound_ms=bms, bound_by=by,
                                      library_ms=lib, **extra)
            del work
            torch.cuda.empty_cache()
        del states

    if args.only in (None, "k6"):
        b_full, m, d = ft.rows, fs.contexts, fs.code_dim
        for b in (b_full, 64):
            t = uniform((b, m, d), 1.0).to(torch.bfloat16)
            a = uniform((d,), 0.2)
            mask = (torch.rand((b, m), generator=g, device=dev) > 0.3).float()
            mask[0] = 0.0
            _, attn = attention.masked_attention(t, a, mask)
            dcv = uniform((b, d), 0.05).to(torch.bfloat16).float()

            def run():
                attention.masked_attention_backward(t, a, mask, attn, dcv)

            for _ in range(20):
                run()
            ms = timer(run)
            bms, by = chip_smoke.k6_bound(t)
            lib = chip_smoke.k6_library(torch, timer, t, a, mask, dcv)
            entry = dict(ms=ms, pass_us=trace(run, chip_smoke.K6_PASSES),
                         bound_ms=bms, bound_by=by, library_ms=lib)
            if hasattr(attention, "backward_plan"):
                entry["cluster"] = attention.backward_plan(
                    b, m, d, launch.shared_memory_limit(dev)).cluster
                for c in (1, 2, 4, 8):
                    entry[f"c{c}_ms"] = forced_k6(timer, attention, t, a, mask,
                                                  attn, dcv, c)
            out[f"k6_b{b}"] = entry
            del t
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
