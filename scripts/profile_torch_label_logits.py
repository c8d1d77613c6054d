#!/usr/bin/env python3
"""K4 (label_logits) at the serving and evaluate batches, beside the
device time of an empty kernel launch, on one CUDA GPU.

    python3 scripts/profile_torch_label_logits.py [--seed N] [--samples N]
        [--launches N]

Run from the repo root on a machine with a CUDA GPU and nvcc. K4 reads
the flagship target table (261,246 x 384, chip_smoke.py's shape) as
float32 and as int8 with per-row scales, at B 64 (serving) and B 1024
(the evaluate batch), labels drawn over the live rows. For each case:
the median device time over --samples runs (CUDA events, the 50 MB L2
flushed before each; chip_smoke.py `Timer`), the plain version's, one
PyTorch yardstick (chip_smoke.py `k4_library`: the label rows gathered
and decoded, a bf16 cast and a row-wise dot), the least time the card
could take for the bytes K4 must move (`bound_ms`), and the largest
error against the plain version.

The empty kernel (csrc/gather_probe.cu `c2v_empty_kernel`, one CTA of
32 threads that does nothing; built here only) is timed the same way
(`empty_ms`, one launch between two events) and back to back
(`empty_back_to_back_us`: --launches launches between two events,
divided by their number). `k4_minus_empty_ms` is K4's time less the
empty launch's at each shape: the part of K4 that a bound counting the
launch would leave to the kernel's own work.

Prints one JSON line. Exits non-zero where torch sees no CUDA device.
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
    p.add_argument("--launches", type=int, default=1000)
    args = p.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_label_logits: needs a CUDA GPU")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    sys.path.insert(0, HERE)
    from code2vec_tpu_torch.kernels import build, label_logits, launch

    build.build_all(["label_logits", "gather_probe"])
    fs = chip_smoke.flagship()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed + 4)
    timer = chip_smoke.Timer(torch, args.samples)
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), "torch": torch.__version__}

    empty = launch.bind("gather_probe", "c2v_empty_kernel",
                        [launch.I32, launch.I32, launch.P])
    stream = launch.stream(dev)

    def empty_launch():
        launch.check_launch(empty(1, 32, stream), "empty_kernel")

    out["empty_ms"] = timer(empty_launch)
    empty_launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.launches):
        empty_launch()
    end.record()
    end.synchronize()
    out["empty_back_to_back_us"] = (start.elapsed_time(end) * 1e3
                                    / args.launches)

    d, v_real = fs.code_dim, fs.vocab["target"]
    f32 = (torch.rand((v_real + 1, d), generator=g, device=dev) * 2 - 1
           ) * math.sqrt(3 / d)
    q8, s8 = chip_smoke.quantize(torch, f32)
    for rows in (fs.rows, 1024):
        cv = torch.randn((rows, d), generator=g, device=dev)
        labels = torch.randint(0, v_real, (rows,), generator=g, device=dev,
                               dtype=torch.int32)
        for fmt, table, scales in (("float32", f32, None),
                                   ("int8", q8, s8)):
            esize = 4 if fmt == "float32" else 1
            nbytes = rows * (d * 4 + 4 + d * esize + 4
                             + (0 if scales is None else 4))
            bms, by = chip_smoke.bound(nbytes, 2.0 * rows * d)
            got = label_logits.label_logits(cv, table, labels, scales=scales)
            want = label_logits.label_logits_plain(
                cv, table, labels, scales=scales,
                compute_dtype=torch.bfloat16)
            err, ok = chip_smoke.max_err(got, want, chip_smoke.TOL_F32SUM)
            if not ok:
                sys.exit(f"label_logits B {rows} {fmt}: max error {err}")
            ms = timer(lambda: label_logits.label_logits(
                cv, table, labels, scales=scales))
            out[f"k4_b{rows}_{fmt}"] = dict(
                ms=ms, bound_ms=bms, bound_by=by, max_abs_err=err,
                plain_ms=timer(lambda: label_logits.label_logits_plain(
                    cv, table, labels, scales=scales,
                    compute_dtype=torch.bfloat16)),
                library_ms=timer(lambda: chip_smoke.k4_library(
                    torch, cv, table, labels, scales)),
                k4_minus_empty_ms=ms - out["empty_ms"])
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
