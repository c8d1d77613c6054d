#!/usr/bin/env python3
"""K15 (tp_softmax_xent), K16 (cp_attention), K17
(cp_attention_backward) and K13's merge of the tp x k candidates alone,
on one CUDA GPU, beside the other device functions of the
tensor-parallel loss.

    python3 scripts/profile_torch_sharded.py [--seed N] [--samples N]
        [--repo DIR]

Run from the repo root on a machine with a CUDA GPU and nvcc. Shapes are
chip_smoke.py's parallel kernel phase: the java14m tables padded to tp 2
(the logits' 1024 x 130,623 slice of rank 1, its last column a padded
target row) and the cp-2 contexts (1024 x 100 x 384 bf16, a fifth of
them masked, one row with none valid).

- `k15_train`: the stats and gradient passes as a train step runs them
  on one rank (the merge of one rank's stats is its own, bit for bit, so
  the passes alone are timed); `library_ms` is F.cross_entropy's forward
  and backward over the slice.
- `k15_eval`: the stats pass alone as the eval step runs it (floor mode,
  the row stride padded for K13); `library_ms` is torch.logsumexp.
- `k16`: the scores and combine phases (one rank's stats passed straight
  on, as above); `library_ms` is SDPA over the same activations;
  `read_once_ms` / `read_twice_ms` one and two torch.amax reads of the
  activations under the same timer (a practical floor: the flush leaves
  the L2 dirty, and the first read pays the write-back).
- `tp_logits` (row 12b): ops/sharded.py tp_logits, the local product as
  the step calls it (the bf16 cast of the shard included);
  `matmul_ms` the bf16 product alone.
- `k13_local`, `k13_merge` (row 12e): K13 at k 10 over the eval step's
  padded slice beside torch.topk; and the merge of two ranks' gathered
  top 10 (2 x 1024 x 10 values and ids) as ops/sharded.py tp_top_k runs
  it, beside torch.topk + gather over the rank-major copy of the same
  candidates: in a checkout without `merge_topk` the rank-major copies,
  K13 and the gather of the ids. Its `launch_bound_ms` adds the device
  time of an empty launch (csrc/gather_probe.cu, `empty_ms`) to the
  bytes' bound, as PERF.md's row of K4 counts it.
- `k17`: the fs and dt phases of the backward over the same contexts
  and K16's weights (the sum of w fs of one rank passed straight on);
  `library_ms` is SDPA's backward by autograd (chip_smoke.py
  `k6_library`); `bound_ms` counts T read once and dT written once
  (chip_smoke.py `k6_bound`), `two_read_bound_ms` T read twice; its
  launches' device times by torch.profiler, back to back, no flush
  (`kernel_us`, microseconds a call by kernel name; the merge's too);
  `read_once_ms` a torch.amax of T and `write_once_ms` a zero_ of a
  tensor of dT's size under the same timer, the phases' practical
  floors. A checkout whose dt phase reads T (no P and Q
  from the fs phase) is timed through its own phases.

For each: the median device time over --samples runs (CUDA events, the
50 MB L2 flushed before each; chip_smoke.py `Timer`), each pass's time
(`pass_ms`), its launches a call (`launches`), the least time the card
could take (`bound_ms`; chip_smoke.py's byte counts), the library call
and the largest error against the plain version. A checkout from
before K17's and the merge's redesign (`new_k17`, `new_merge` false) is
timed through its own phases and calls, so that --repo DIR times a
parent commit unpacked beside this one with the same code on the same
card. It prints one JSON line.

Exits non-zero where torch sees no CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--samples", type=int, default=25)
    p.add_argument("--repo", default=HERE)
    args = p.parse_args()

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("profile_torch_sharded: needs a CUDA GPU")
    repo = os.path.abspath(args.repo)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    sys.path.insert(0, repo)
    from code2vec_tpu_torch import kernels
    from code2vec_tpu_torch.kernels import build
    from code2vec_tpu_torch.kernels import cp_attention as k16
    from code2vec_tpu_torch.kernels import sharded as k15
    from code2vec_tpu_torch.kernels.select import (
        padded_width, select_topk, select_topk_plain,
    )
    from code2vec_tpu_torch.kernels import launch as klaunch
    from code2vec_tpu_torch.kernels import select as k13
    from code2vec_tpu_torch.models.code2vec import matmul_f32
    from code2vec_tpu_torch.ops.sharded import _stride4, tp_logits
    assert k15.__file__.startswith(repo), k15.__file__

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all(["sharded", "cp_attention", "select", "gather_probe"])
    fs, ft = chip_smoke.flagship(), chip_smoke.flagship_train()
    dims = chip_smoke.parallel_dims(fs)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed + 13)
    timer = chip_smoke.Timer(torch, args.samples)
    bound, max_err = chip_smoke.bound, chip_smoke.max_err
    tol = chip_smoke.TOL_F32SUM
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), "repo": repo, "torch": torch.__version__}
    b, m, d = ft.rows, ft.contexts, fs.code_dim
    # this checkout's K17 and K13 merge, or its parent's (the dt phase
    # reading T again; the merge by copies, K13's large mode and a gather)
    new_k17 = "pq" in inspect.signature(
        k16.cp_attention_backward_dt).parameters
    new_merge = hasattr(k13, "merge_topk")
    out["new_k17"], out["new_merge"] = new_k17, new_merge

    def kernel_us(fn, calls=10):
        """Device microseconds a call of `fn` spends in each kernel (and
        memset, copy), by torch.profiler over `calls` calls after one."""
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = {}
        for e in prof.key_averages():
            if e.device_time_total > 0:
                name = re.sub(r"\(anonymous namespace\)::", "", e.key)
                name = name.split("(")[0].split("<")[0].strip() or e.key
                name = name.replace("void ", "")
                us[name] = us.get(name, 0.0) + e.device_time_total / calls
        return us or None

    def launches(fn, names):
        before = kernels.launch_counts()
        fn()
        after = kernels.launch_counts()
        return {n: after[n] - before[n] for n in names}

    def case(run, plain, check, library, nbytes, flops, passes,
             names, peak=chip_smoke.BF16_FLOP_PER_S):
        """`check(got, want)` -> largest error; `passes` name -> thunk."""
        err = check(run(), plain())
        for _ in range(5):
            run()
        ms = timer(run)
        lib = timer(library) if library is not None else None
        bms, by = bound(nbytes, flops, peak)
        return dict(ms=ms, pass_ms={k: timer(f) for k, f in passes.items()},
                    launches=launches(run, names), bound_ms=bms,
                    bound_by=by, library_ms=lib, max_abs_err=err)

    # K15 over rank 1's slice: its last column a padded target row
    v = dims.target_vocab_size // 2
    n_valid = k15.valid_columns(v, v, dims.real_target_vocab_size)
    logits = torch.randn((b, v), generator=g, device=dev) * 3
    labels = torch.randint(2, dims.real_target_vocab_size, (b,), generator=g,
                           device=dev, dtype=torch.int32)
    valid = torch.ones(b, device=dev)
    valid[1] = 0
    n = logits.numel()

    def train(stats=k15.tp_xent_stats, grad=k15.tp_xent_grad):
        st = stats(logits, v, n_valid, labels, v)
        return st, grad(logits, n_valid, st[0], st[1], labels, valid, v,
                        2 * b)

    st = k15.tp_xent_stats(logits, v, n_valid, labels, v)
    passes = {
        "stats": lambda: k15.tp_xent_stats(logits, v, n_valid, labels,
                                           v),
        "grad": lambda: k15.tp_xent_grad(logits, n_valid, st[0], st[1],
                                         labels, valid, v, 2 * b)}

    def check_train(got, want):
        hi_lo = [x[1][0].float() + x[1][1].float() for x in (got, want)]
        return max(max_err(got[0], want[0], tol)[0],
                   max_err(*hi_lo, tol)[0])

    lab = (labels.long() - v).clamp(0, v - 1)
    xg = logits.clone().requires_grad_()

    def xent_library():
        xg.grad = None
        F.cross_entropy(xg, lab).backward()

    out["k15_train"] = case(
        train, lambda: train(k15.tp_xent_stats_plain,
                             k15.tp_xent_grad_plain),
        check_train, xent_library, 2 * n * 4 + 2 * n * 2 + 4 * b * 4,
        6.0 * n, passes, ["tp_softmax_xent"], chip_smoke.F32_FLOP_PER_S)
    del xg, passes, st
    # the eval step's stats: floor mode, the row stride padded for K13
    ld = padded_width(v)
    wide = torch.full((b, ld), float("-inf"), device=dev)
    wide[:, :v] = logits
    del logits
    out["k15_eval"] = case(
        lambda: k15.tp_xent_stats(wide, v, n_valid, labels, v, True),
        lambda: k15.tp_xent_stats_plain(wide, v, n_valid, labels, v,
                                        True),
        lambda x, y: max_err(x, y, tol)[0],
        lambda: torch.logsumexp(wide[:, :v], dim=1),
        b * v * 4 + 3 * b * 4, 3.0 * b * v, {}, ["tp_softmax_xent"],
        chip_smoke.F32_FLOP_PER_S)

    # K13 over the eval step's slice, and its merge of two ranks'
    # gathered candidates (12e)
    k = 10

    def exact(x, y):
        return float(not (torch.equal(x[1], y[1]) and torch.equal(
            x[0].nan_to_num(), y[0].nan_to_num())))

    view = wide[:, :v]
    out["k13_local"] = case(
        lambda: select_topk(wide, k, v),
        lambda: select_topk_plain(wide, k, v), exact,
        lambda: torch.topk(view, k), b * v * 4 + b * k * 8,
        float(b * v), {}, ["select_topk"])
    parts = 2
    cand = parts * k
    all_values = torch.randn((parts, b, k), generator=g, device=dev)
    all_ids = (torch.arange(parts, device=dev)[:, None, None] * v
               + torch.randint(0, v, (parts, b, k), generator=g,
                               device=dev)).int()
    flat_values = all_values.permute(1, 0, 2).reshape(b, cand)
    flat_ids = all_ids.permute(1, 0, 2).reshape(b, cand)
    if new_merge:
        def merge():
            return k13.merge_topk(all_values, all_ids, k)
    else:
        def merge():  # tp_top_k's merge in the parent
            fv = all_values.permute(1, 0, 2).reshape(b, cand)
            fi = all_ids.permute(1, 0, 2).reshape(b, cand)
            top_v, top_p = select_topk(
                _stride4(fv, cand, float("-inf")), k, cand)
            return top_v, fi.gather(1, top_p.long())

    def merge_plain():
        top_v, top_p = select_topk_plain(flat_values, k)
        return top_v, flat_ids.gather(1, top_p.long())

    def merge_library():
        top_v, top_p = torch.topk(flat_values, k)
        return top_v, flat_ids.gather(1, top_p)

    empty = klaunch.bind("gather_probe", "c2v_empty_kernel",
                         [klaunch.I32, klaunch.I32, klaunch.P])
    stream = klaunch.stream(dev)
    out["empty_ms"] = timer(lambda: klaunch.check_launch(
        empty(1, 32, stream), "empty_kernel"))
    r = out["k13_merge"] = case(
        merge, merge_plain, exact, merge_library,
        b * cand * 8 + b * k * 8, float(b * cand), {}, ["select_topk"],
        chip_smoke.F32_FLOP_PER_S)
    r["plain_ms"] = timer(merge_plain, spin_ms=20)
    r["launch_bound_ms"] = r["bound_ms"] + out["empty_ms"]
    r["kernel_us"] = kernel_us(merge)
    del all_values, all_ids, flat_values, flat_ids
    del wide
    torch.cuda.empty_cache()

    # the local product (12b): (1024 x 384) x (384 x 130,623), f32 out
    cv = torch.randn((b, d), generator=g, device=dev)
    target = torch.randn((v, d), generator=g, device=dev) * 0.05

    def run():
        return tp_logits(cv, target)

    run()
    cv16, tgt16 = cv.to(torch.bfloat16), target.to(torch.bfloat16)
    bms, by = bound(b * v * 4, 2.0 * b * v * d)
    out["tp_logits"] = dict(
        ms=timer(run), bound_ms=bms, bound_by=by,
        matmul_ms=timer(lambda: matmul_f32(cv16, tgt16.T)))
    del cv, target, cv16, tgt16
    torch.cuda.empty_cache()

    # K16 and K17 over the cp-2 contexts
    mc = m // 2
    t = torch.tanh(torch.randn((b, mc, d), generator=g, device=dev)).to(
        torch.bfloat16)
    a = torch.randn((d,), generator=g, device=dev) * 0.25
    mask = (torch.rand((b, mc), generator=g, device=dev) > 0.2).float()
    mask[0] = 0.0

    def forward(sc=k16.cp_attention_scores, co=k16.cp_attention_combine):
        s, st = sc(t, a, mask)
        return co(t, s, st[0], st[1])

    s, st = k16.cp_attention_scores(t, a, mask)
    passes = {
        "scores": lambda: k16.cp_attention_scores(t, a, mask),
        "combine": lambda: k16.cp_attention_combine(t, s, st[0], st[1])}
    q = a.to(torch.bfloat16).view(1, 1, 1, d).expand(b, 1, 1, d
                                                     ).contiguous()
    kv = t.view(b, 1, mc, d)
    keep = (mask > 0).view(b, 1, 1, mc)
    out["k16"] = case(
        forward, lambda: forward(k16.scores_plain, k16.combine_plain),
        lambda x, y: max_err(x[1], y[1], tol)[0],
        lambda: F.scaled_dot_product_attention(q, kv, kv,
                                               attn_mask=keep,
                                               scale=1.0),
        2 * t.numel() * 2 + 3 * b * mc * 4 + b * d * 4,
        4.0 * t.numel(), passes, ["cp_attention"])
    # what two PyTorch reads of T take under the same timer (the L2
    # flush leaves the cache dirty, so the first read also pays its
    # write-back)
    out["k16"]["read_twice_ms"] = timer(lambda: (t.amax(), t.amax()))
    out["k16"]["read_once_ms"] = timer(lambda: t.amax())
    del s, st, passes, q, kv, keep

    _, attn = forward()
    dcv = torch.randn((b, d), generator=g, device=dev)
    if new_k17:
        def backward(fs_fn=k16.cp_attention_backward_fs,
                     dt_fn=k16.cp_attention_backward_dt):
            f, w, pq = fs_fn(t, attn, mask, dcv)
            return dt_fn(a, mask, attn, f, w, dcv, pq)
    else:
        def backward(fs_fn=k16.cp_attention_backward_fs,
                     dt_fn=k16.cp_attention_backward_dt):
            f, w = fs_fn(t, attn, dcv)
            return dt_fn(t, a, mask, attn, f, w, dcv)

    def check_k17(got, want):
        # dT against the plain version, d a against the direct sum of
        # ds t on the kernel's own fs (one bf16 step at the largest
        # passes)
        f = k16.cp_attention_backward_fs(t, attn, mask, dcv)[:2] \
            if new_k17 else k16.cp_attention_backward_fs(t, attn, dcv)
        ds = torch.where(mask > 0, attn * (f[0] - f[1][:, None]), 0.0)
        direct = torch.einsum("bm,bmd->d", ds, t.float())
        return max(float((got[0].float() - want[0].float()).abs()
                         .max()),
                   chip_smoke.step_err(got[1], direct)[0])

    r = out["k17"] = case(
        backward,
        lambda: backward(k16.backward_fs_plain, k16.backward_dt_plain),
        check_k17, None,
        2 * t.numel() * 2 + 2 * b * mc * 4 + b * d * 4 + 2 * d * 4,
        6.0 * t.numel(), {}, ["cp_attention_backward"])
    assert (r["bound_ms"], r["bound_by"]) == chip_smoke.k6_bound(t)
    r["library_ms"] = chip_smoke.k6_library(torch, timer, t, a, mask,
                                            dcv)
    r["two_read_bound_ms"] = bound(
        3 * t.numel() * 2 + 3 * b * mc * 4 + b * d * 4,
        6.0 * t.numel())[0]
    r["kernel_us"] = kernel_us(backward)
    # what one PyTorch read of T and one write of dT's bytes take under
    # the same timer: the practical floors of the fs and dt phases
    sink = torch.empty_like(t)
    r["read_once_ms"] = timer(lambda: t.amax())
    r["write_once_ms"] = timer(lambda: sink.zero_())
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
