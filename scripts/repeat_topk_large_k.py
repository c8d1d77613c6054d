#!/usr/bin/env python3
"""K3's large-k mode called many times on the same inputs: are its
scores, values and indices the same bits on every call?

    python3 scripts/repeat_topk_large_k.py [--runs N] [--flagship-runs N]
        [--repo DIR]

Run from the repo root on a machine with a CUDA GPU and nvcc. Two cases:

- `test`: the data of tests/test_torch_kernels_cuda.py
  `test_blockwise_topk_large_k_kernel[1000-False]` (9 code vectors near
  one direction, a 20,011-row table of which 20,003 live, three rows
  equal to row 5; bf16 compute, k 1000), --runs calls;
- `flagship`: B 64 against the flagship target table (261,246 x 384
  f32, the last row dead; bf16 compute, k 1000), --flagship-runs calls.

Each call's scores (the (B, V) buffer K3 writes for K13, captured where
K3 hands it over), values, indices and logsumexp are compared bit for
bit with the first call's; each call's values are also held against the
plain version's within the test's tolerance (rtol 1e-4, atol 1e-4).
Then `test_k64`: the test's data at k 64, K3's list mode (no scores,
no K13), --runs calls. Prints one JSON line per case: the calls, how
many differed from the first in each output (and, for the scores, in how
many elements at most), and how many calls missed the plain version.
With --repo DIR it imports `code2vec_tpu_torch` from DIR (say a parent
commit unpacked beside this one), so two trees are checked by the same
code on the same card in one run. chip_smoke.py's K3 phase runs the
same check (`repeat`) with fewer calls.

Exits non-zero where torch sees no CUDA device, or where a call differed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_case_inputs(np, torch, dev):
    """tests/test_torch_kernels_cuda.py `_separated` at k 1000."""
    rng = np.random.default_rng(1000)
    v, valid, b = 20011, 20003, 9
    u = rng.standard_normal(384).astype(np.float32)
    u /= np.linalg.norm(u)
    cv = (u[None, :] * 2.0 + 0.01 * rng.standard_normal((b, 384))
          ).astype(np.float32)
    table = (0.05 * rng.standard_normal((v, 384))).astype(np.float32)
    hot = np.linspace(1, valid - 1, 65).astype(int)
    rng.shuffle(hot)
    for j, row in enumerate(hot):
        table[row] = u * (1.0 + 0.05 * j)
    table[valid] = u * 10.0
    table[[11, 700, 9000]] = table[5]
    return (torch.from_numpy(cv).to(dev), torch.from_numpy(table).to(dev),
            valid)


def repeat(torch, cv, table, valid: int, k: int, calls: int,
           want=None) -> dict:
    """`calls` calls of K3 (bf16 compute) on the same inputs, each
    output compared bit for bit with the first call's: the large-k
    mode's scores, captured where K3 hands them to K13, its values,
    indices and logsumexp. With `want`, the plain version's outputs,
    each call's values are also held against them (rtol 1e-4, atol
    1e-4)."""
    from code2vec_tpu_torch.kernels import select, topk

    captured = []
    select_topk = select.select_topk

    def recording(scores, kk, n=None):
        captured.append(scores[:, :n].clone())
        return select_topk(scores, kk, n=n)

    first, any_diff, most, misses, worst = None, 0, 0, 0, 0.0
    diff = {}
    select.select_topk = recording
    try:
        for _ in range(calls):
            captured.clear()
            out = topk.blockwise_topk(cv, table, k, 4096, valid_rows=valid,
                                      compute_dtype=torch.bfloat16)
            got = dict(values=out.values, indices=out.indices, lse=out.lse)
            if captured:
                got["scores"] = captured[0]
            got = {n: (x.view(torch.int32) if x.is_floating_point()
                       else x).clone() for n, x in got.items()}
            if first is None:
                first = got
                diff = dict.fromkeys(got, 0)
            differs = False
            for n, x in got.items():
                off = int((x != first[n]).sum())
                if off:
                    diff[n] += 1
                    differs = True
                    if n == "scores":
                        most = max(most, off)
            any_diff += differs
            if want is not None:
                err = (out.values - want.values).abs()
                worst = max(worst, float(err.max()))
                misses += not bool(
                    (err <= 1e-4 + 1e-4 * want.values.abs()).all())
        torch.cuda.synchronize()
    finally:
        select.select_topk = select_topk
    out = {"calls": calls, "batch": int(cv.shape[0]),
           "table_rows": int(table.shape[0]), "k": k,
           "calls_differing": any_diff,
           "calls_differing_from_the_first": diff}
    if "scores" in diff:
        out["most_score_elements_differing"] = most
    if want is not None:
        out["calls_missing_the_plain_version"] = misses
        out["largest_value_error_vs_plain"] = worst
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--runs", type=int, default=1000)
    p.add_argument("--flagship-runs", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--repo", default=HERE)
    args = p.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("repeat_topk_large_k: needs a CUDA GPU")
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)
    from code2vec_tpu_torch.kernels import build, topk
    assert topk.__file__.startswith(repo), topk.__file__

    build.build_all(["topk", "select"])
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    g = torch.Generator(device=dev).manual_seed(args.seed)
    v_real = 261245
    flagship_table = (torch.rand((v_real + 1, 384), generator=g, device=dev)
                      * 2 - 1) * math.sqrt(3 / 384)
    test = test_case_inputs(np, torch, dev)
    cases = {"test": (*test, 1000, args.runs),
             "flagship": (torch.randn((64, 384), generator=g, device=dev),
                          flagship_table, v_real, 1000, args.flagship_runs),
             "test_k64": (*test, 64, args.runs)}
    ok = True
    for name, (cv, table, valid, k, runs) in cases.items():
        want = None
        if k > 64:
            want = topk.blockwise_topk_plain(cv, table, k, 4096,
                                             valid_rows=valid,
                                             compute_dtype=torch.bfloat16)
        res = repeat(torch, cv, table, valid, k, runs, want)
        ok = ok and not res["calls_differing"]
        print(json.dumps({"case": name, "card": card, "repo": repo, **res}),
              flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
