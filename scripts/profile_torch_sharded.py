#!/usr/bin/env python3
"""K15 (tp_softmax_xent) and K16 (cp_attention) alone, on one CUDA GPU,
beside the other device functions of the tensor-parallel loss.

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
  padded slice, and over the tp x k candidates of two ranks, beside
  torch.topk.

For each: the median device time over --samples runs (CUDA events, the
50 MB L2 flushed before each; chip_smoke.py `Timer`), each pass's time
(`pass_ms`), its launches a call (`launches`), the least time the card
could take (`bound_ms`; chip_smoke.py's byte counts), the library call
and the largest error against the plain version. A checkout without the
stats pass (K15's max, sum and gradient passes; K16's scores, exp and
combine) is timed through its own phases, so that --repo DIR times a
parent commit unpacked beside this one with the same code on the same
card. It prints one JSON line.

Exits non-zero where torch sees no CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
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
    from code2vec_tpu_torch.models.code2vec import matmul_f32
    from code2vec_tpu_torch.ops.sharded import tp_logits
    assert k15.__file__.startswith(repo), k15.__file__

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all(["sharded", "cp_attention", "select"])
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
    new_api = hasattr(k15, "tp_xent_stats")

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
        lib = timer(library)
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
    if new_api:
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

        def plain():
            return train(k15.tp_xent_stats_plain, k15.tp_xent_grad_plain)
    else:
        def train(mx_fn=k15.tp_xent_max, sum_fn=k15.tp_xent_sum,
                  grad=k15.tp_xent_grad):
            mx = mx_fn(logits, v, n_valid)
            st = sum_fn(logits, v, n_valid, mx, labels, v)
            return (torch.stack([mx, st[0], st[1]]),
                    grad(logits, n_valid, mx, st[0], labels, valid, v,
                         2 * b))

        mx = k15.tp_xent_max(logits, v, n_valid)
        st = k15.tp_xent_sum(logits, v, n_valid, mx, labels, v)
        passes = {
            "max": lambda: k15.tp_xent_max(logits, v, n_valid),
            "sum": lambda: k15.tp_xent_sum(logits, v, n_valid, mx, labels,
                                           v),
            "grad": lambda: k15.tp_xent_grad(logits, n_valid, mx, st[0],
                                             labels, valid, v, 2 * b)}

        def plain():
            return train(k15.tp_xent_max_plain, k15.tp_xent_sum_plain,
                         k15.tp_xent_grad_plain)

    def check_train(got, want):
        hi_lo = [x[1][0].float() + x[1][1].float() for x in (got, want)]
        return max(max_err(got[0], want[0], tol)[0],
                   max_err(*hi_lo, tol)[0])

    lab = (labels.long() - v).clamp(0, v - 1)
    xg = logits.clone().requires_grad_()

    def xent_library():
        xg.grad = None
        F.cross_entropy(xg, lab).backward()

    n = logits.numel()
    out["k15_train"] = case(train, plain, check_train, xent_library,
                            2 * n * 4 + 2 * n * 2 + 4 * b * 4, 6.0 * n,
                            passes, ["tp_softmax_xent"],
                            chip_smoke.F32_FLOP_PER_S)
    del xg, passes, st
    # the eval step's stats: floor mode, the row stride padded for K13
    ld = padded_width(v)
    wide = torch.full((b, ld), float("-inf"), device=dev)
    wide[:, :v] = logits
    del logits
    if new_api:
        def stats():
            return k15.tp_xent_stats(wide, v, n_valid, labels, v, True)

        def stats_plain():
            return k15.tp_xent_stats_plain(wide, v, n_valid, labels, v,
                                           True)
    else:
        def stats():
            mx = k15.tp_xent_max(wide, v, n_valid, True)
            return torch.cat([mx[None], k15.tp_xent_sum(
                wide, v, n_valid, mx, labels, v, True)])

        def stats_plain():
            mx = k15.tp_xent_max_plain(wide, v, n_valid, True)
            return torch.cat([mx[None], k15.tp_xent_sum_plain(
                wide, v, n_valid, mx, labels, v, True)])

    out["k15_eval"] = case(
        stats, stats_plain, lambda x, y: max_err(x, y, tol)[0],
        lambda: torch.logsumexp(wide[:, :v], dim=1), b * v * 4 + 3 * b * 4,
        3.0 * b * v, {}, ["tp_softmax_xent"], chip_smoke.F32_FLOP_PER_S)

    # K13 over the eval step's slice and the two ranks' candidates (12e)
    k = 10

    def k13_case(scores, n_cols):
        view = scores[:, :n_cols]
        return case(lambda: select_topk(scores, k, n_cols),
                    lambda: select_topk_plain(scores, k, n_cols),
                    lambda x, y: float(not (torch.equal(x[1], y[1])
                                            and torch.equal(x[0], y[0]))),
                    lambda: torch.topk(view, k),
                    b * n_cols * 4 + b * k * 8, float(b * n_cols), {},
                    ["select_topk"])

    out["k13_local"] = k13_case(wide, v)
    cand = padded_width(2 * k)
    merged = torch.full((b, cand), float("-inf"), device=dev)
    merged[:, :2 * k] = torch.randn((b, 2 * k), generator=g, device=dev)
    out["k13_merge"] = k13_case(merged, 2 * k)
    del wide, merged
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

    # K16 over the cp-2 contexts
    mc = m // 2
    t = torch.tanh(torch.randn((b, mc, d), generator=g, device=dev)).to(
        torch.bfloat16)
    a = torch.randn((d,), generator=g, device=dev) * 0.25
    mask = (torch.rand((b, mc), generator=g, device=dev) > 0.2).float()
    mask[0] = 0.0
    if new_api:
        def forward(sc=k16.cp_attention_scores, co=k16.cp_attention_combine):
            s, st = sc(t, a, mask)
            return co(t, s, st[0], st[1])

        s, st = k16.cp_attention_scores(t, a, mask)
        passes = {
            "scores": lambda: k16.cp_attention_scores(t, a, mask),
            "combine": lambda: k16.cp_attention_combine(t, s, st[0], st[1])}

        def plain():
            return forward(k16.scores_plain, k16.combine_plain)
    else:
        def forward(sc=k16.cp_attention_scores, ex=k16.cp_attention_exp,
                    co=k16.cp_attention_combine):
            s, mx = sc(t, a, mask)
            u, den = ex(s, mx)
            return co(t, u, den)

        s, mx = k16.cp_attention_scores(t, a, mask)
        u, den = k16.cp_attention_exp(s, mx)
        passes = {
            "scores": lambda: k16.cp_attention_scores(t, a, mask),
            "exp": lambda: k16.cp_attention_exp(s, mx),
            "combine": lambda: k16.cp_attention_combine(t, u, den)}

        def plain():
            return forward(k16.scores_plain, k16.exp_plain,
                           k16.combine_plain)
    q = a.to(torch.bfloat16).view(1, 1, 1, d).expand(b, 1, 1, d).contiguous()
    kv = t.view(b, 1, mc, d)
    keep = (mask > 0).view(b, 1, 1, mc)
    out["k16"] = case(
        forward, plain, lambda x, y: max_err(x[1], y[1], tol)[0],
        lambda: F.scaled_dot_product_attention(q, kv, kv, attn_mask=keep,
                                               scale=1.0),
        2 * t.numel() * 2 + 3 * b * mc * 4 + b * d * 4, 4.0 * t.numel(),
        passes, ["cp_attention"])
    # what two PyTorch reads of T take under the same timer (the L2 flush
    # leaves the cache dirty, so the first read also pays its write-back)
    out["k16"]["read_twice_ms"] = timer(lambda: (t.amax(), t.amax()))
    out["k16"]["read_once_ms"] = timer(lambda: t.amax())
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
