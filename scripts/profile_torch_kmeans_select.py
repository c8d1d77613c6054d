#!/usr/bin/env python3
"""K10 (kmeans_update) and K13 (select_topk) alone, on one CUDA GPU.

    python3 scripts/profile_torch_kmeans_select.py [--seed N] [--samples N]
        [--repeats N] [--repo DIR] [--only k10|k13|e2e]

Run from the repo root on a machine with a CUDA GPU and nvcc. Shapes are
chip_smoke.py's:

- K10 at the MIPS shape (261,245 int8-dequantised rows x 384, 511
  centroids, `k10_mips`) and the index shape (1,000,000 L2-normalised
  rows x 384, 1000 centroids, spherical, `k10_index`), the rows assigned
  by K9 as a Lloyd step assigns them; and each shape with skewed lists
  (`_skew`): half the rows in cluster 0, the rest uniform over the other
  clusters but every eighth, which stays empty.
- K13 on the 1M index's scores (64 queries near stored rows, k 1000:
  `k13_b64_1m`, and its first row alone, `k13_b1_1m`), on K3's large-k
  scores at the serving shape (B 64 x 261,245 int8 logits, k 100:
  `k13_b64_261k`), on K11's candidate scores at the MIPS head's k 100
  (nprobe 16 x its longest list, B 64 and 1: `k13_mips_b64`,
  `k13_mips_b1`), recorded as K3 and K11 hand them to K13, and on B 64
  rows of 1M columns built to overflow a slice's candidate buffer: one
  repeated value (`k13_b64_1m_equal`) and distinct values in one 11-bit
  bin (`k13_b64_1m_one_bin`). `over_rows` counts the rows whose
  candidates overflow (select.slice_candidates against the plan's cap;
  null for a checkout without them).
- `e2e`: host seconds of 10 spherical Lloyd steps at the index shape
  (`lloyd_index_s`, the device part of `index-build` at 1M rows) and of
  `MipsHead.build` over the int8 classifier (`mips_build_s`), each
  --repeats times in one process (lists of seconds).

For each kernel case: the median device time over --samples runs (CUDA
events, the 50 MB L2 flushed before each; chip_smoke.py `Timer`), the
device time of each launch by torch.profiler (`launch_us`, microseconds
a call by kernel name, memsets included), the least time the card could
take (`bound_ms`, chip_smoke.py's byte counts), one PyTorch call
computing the same function (`library_ms`: index_add_ of the sums;
torch.topk), and the check against the plain version (K10: largest
error and two runs bit-equal; K13: positions and values equal). It
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
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
def launch_split(torch, fn, calls=10):
    """Mean device microseconds a call of `fn` spends in each kernel (and
    memset), by torch.profiler over `calls` calls after one more; None
    where the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = re.sub(r"\(anonymous namespace\)::", "", e.key)
            name = name.split("(")[0].split("<")[0].strip() or e.key
            out[name] = out.get(name, 0.0) + e.device_time_total / calls
    return out or None


def skewed(torch, rng, n, c, dev):
    """Half the rows (a random half) in cluster 0, the rest uniform over
    clusters 1..c-1 except every eighth, which stays empty."""
    import numpy as np
    live = np.array([j for j in range(1, c) if j % 8 != 0])
    a = live[rng.integers(0, len(live), n)]
    a[rng.permutation(n)[:n // 2]] = 0
    return torch.from_numpy(a.astype(np.int32)).to(dev)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--samples", type=int, default=25)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--repo", default=HERE)
    p.add_argument("--only", choices=("k10", "k13", "e2e"))
    args = p.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_kmeans_select: needs a CUDA GPU")
    repo = os.path.abspath(args.repo)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    sys.path.insert(0, repo)
    from code2vec_tpu_torch.kernels import build, ivf, kmeans, select, topk
    from code2vec_tpu_torch.retrieval.index import lloyd
    from code2vec_tpu_torch.retrieval.mips import MipsHead
    assert kmeans.__file__.startswith(repo), kmeans.__file__

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all(["kmeans", "select", "topk", "ivf_search"])
    fs = chip_smoke.flagship()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed + 41)
    rng = np.random.default_rng(args.seed)
    timer = chip_smoke.Timer(torch, args.samples)
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), "repo": repo, "torch": torch.__version__}
    d = fs.code_dim
    v_real = fs.vocab["target"]
    table = (torch.rand((v_real + 1, d), generator=g, device=dev) * 2 - 1
             ) * math.sqrt(3 / d)
    q8, s8 = chip_smoke.quantize(torch, table)
    del table

    def index_rows(n):
        x = torch.randn((n, d), generator=g, device=dev)
        return x / torch.linalg.vector_norm(x, dim=1, keepdim=True
                                            ).clamp(min=1e-12)

    def k10_case(x, c0, assign, spherical):
        def run():
            return kmeans.kmeans_update(x, assign, c0, spherical)

        got, again = run(), run()
        want = kmeans.kmeans_update_plain(x, assign, c0, spherical)
        err, ok = chip_smoke.max_err(got, want, chip_smoke.TOL_F32SUM)
        n, c = x.shape[0], c0.shape[0]
        bms, by = chip_smoke.bound(n * d * 4 + n * 4 + 2 * c * d * 4,
                                   float(n * d), chip_smoke.F32_FLOP_PER_S)
        for _ in range(10):
            run()
        ms = timer(run)
        idx = assign.long()
        sums = torch.zeros_like(c0)
        lib = timer(lambda: sums.index_add_(0, idx, x))
        counts = torch.bincount(idx, minlength=c)
        return dict(ms=ms, launch_us=launch_split(torch, run), bound_ms=bms,
                    bound_by=by, library_ms=lib, max_abs_err=err,
                    within_tol=ok, bit_equal=bool(torch.equal(got, again)),
                    largest_list=int(counts.max()),
                    empty_lists=int((counts == 0).sum()))

    def k13_case(scores, k, n=None):
        b = scores.shape[0]
        n = scores.shape[1] if n is None else n

        def run():
            return select.select_topk(scores, k, n=n)

        got_v, got_p = run()
        want_v, want_p = select.select_topk_plain(scores, k, n=n)
        exact = bool(torch.equal(got_p, want_p)) and bool(torch.equal(
            got_v.nan_to_num(), want_v.nan_to_num()))
        for _ in range(10):
            run()
        ms = timer(run)
        view = scores[:, :n]
        lib = timer(lambda: torch.topk(view, k), spin_ms=20)
        bms, by = chip_smoke.bound(b * n * 4 + b * k * 8, float(b * n))
        over = None   # where the checkout has no candidate buffers
        if hasattr(select, "slice_candidates"):
            p = select.plan(b, n, k, torch.cuda.get_device_properties(
                dev).multi_processor_count)
            over = int((select.slice_candidates(scores, k, p, n).max(1)
                        .values > p.cap).sum())
        return dict(ms=ms, launch_us=launch_split(torch, run), bound_ms=bms,
                    bound_by=by, library_ms=lib, exact=exact, b=b, n=n, k=k,
                    over_rows=over)

    def recorded(module, call):
        """The (scores, k, n) that `call` hands to K13 through `module`."""
        seen = []
        real = module.select.select_topk

        def record(scores, k, n=None):
            seen.append((scores.clone(), k, n))
            return real(scores, k, n)

        module.select.select_topk = record
        try:
            call()
        finally:
            module.select.select_topk = real
        return seen[-1]

    if args.only in (None, "k10"):
        x = q8[:v_real].float() * s8[:v_real]
        c0 = x[torch.from_numpy(rng.permutation(v_real)[:511]).to(dev)]
        a = kmeans.kmeans_assign(x, c0)
        out["k10_mips"] = k10_case(x, c0, a, False)
        out["k10_mips_skew"] = k10_case(x, c0, skewed(torch, rng, v_real,
                                                      511, dev), False)
        del x, c0, a
        x = index_rows(1_000_000)
        c0 = x[torch.from_numpy(rng.permutation(x.shape[0])[:1000]).to(dev)]
        a = kmeans.kmeans_assign(x, c0)
        out["k10_index"] = k10_case(x, c0, a, True)
        out["k10_index_skew"] = k10_case(x, c0, skewed(
            torch, rng, x.shape[0], 1000, dev), True)
        del x, c0, a
        torch.cuda.empty_cache()

    if args.only in (None, "k13"):
        rows = index_rows(1_000_000)
        qi = rows[torch.from_numpy(rng.choice(rows.shape[0], 64,
                                              replace=False)).to(dev)]
        qi = qi + 0.05 * torch.randn(qi.shape, generator=g, device=dev)
        qi = qi / torch.linalg.vector_norm(qi, dim=1, keepdim=True)
        scores = torch.matmul(qi, rows.T)
        del rows
        out["k13_b64_1m"] = k13_case(scores, 1000)
        out["k13_b1_1m"] = k13_case(scores[:1].contiguous(), 1000)
        out["k13_b64_1m_equal"] = k13_case(torch.full_like(scores, 0.25),
                                           1000)
        out["k13_b64_1m_one_bin"] = k13_case(
            1.0 + 0.24 * torch.rand(scores.shape, generator=g, device=dev),
            1000)
        del scores
        torch.cuda.empty_cache()
        cv = (torch.rand((fs.rows, d), generator=g, device=dev) * 2 - 1)
        s, k, n = recorded(topk, lambda: topk.blockwise_topk(
            cv, q8, 100, fs.block, scales=s8, valid_rows=v_real))
        out["k13_b64_261k"] = k13_case(s, k, n)
        del s
        head = MipsHead.build(q8.cpu().numpy(), s8.cpu().numpy(),
                              real_vocab=v_real, nprobe=16, kmeans_iters=6,
                              seed=args.seed, device=dev)
        for b in (fs.rows, 1):
            s, k, n = recorded(ivf, lambda: head.topk_fn(100)(
                cv[:b].contiguous()))
            out[f"k13_mips_b{b}"] = k13_case(s, k, n)
        del head, s
        torch.cuda.empty_cache()

    if args.only in (None, "e2e"):
        x = index_rows(1_000_000)
        c0 = x[torch.from_numpy(rng.permutation(x.shape[0])[:1000]).to(dev)]
        lloyd(x, c0, 1, True)
        torch.cuda.synchronize()
        out["lloyd_index_s"] = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            lloyd(x, c0, 10, True)
            torch.cuda.synchronize()
            out["lloyd_index_s"].append(time.perf_counter() - t0)
        del x, c0
        torch.cuda.empty_cache()
        table8, scales8 = q8.cpu().numpy(), s8.cpu().numpy()
        out["mips_build_s"] = [
            MipsHead.build(table8, scales8, real_vocab=v_real, nprobe=16,
                           kmeans_iters=6, seed=args.seed,
                           device=dev).build_seconds
            for _ in range(args.repeats)]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
