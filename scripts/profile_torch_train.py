#!/usr/bin/env python3
"""Where the port's flagship train step spends its time, on one CUDA GPU.

    python3 scripts/profile_torch_train.py [--seed N] [--steps N]
        [--sparse_embedding_update]

Run from the repo root on a machine with a CUDA GPU and nvcc. It builds
the flagship model at full width (java14m vocabularies, dims 128/384,
bf16 compute, Adam with the config's moment dtypes) with random weights
from --seed, takes a random batch of 1024 methods x 200 contexts (80% of
contexts valid), and prints, for the dense step or (with
--sparse_embedding_update, as the `train` command takes it) the sparse
one:

- the step time: median over --steps steps of CUDA events around one
  step (the step's device work, no host read-back), examples/s, and the
  peak device memory over those steps (`max_memory_allocated`) beside
  what the state holds between steps;
- a torch.profiler table of device time per CUDA kernel over --steps
  steps, and the share of the profiled window the device was busy.

Exits non-zero where torch sees no CUDA device.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--sparse_embedding_update", action="store_true")
    args = p.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_train: needs a CUDA GPU")
    sys.path.insert(0, REPO)
    import chip_smoke
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.kernels import build
    from code2vec_tpu_torch.models.code2vec import Code2VecModule, ModelDims
    from code2vec_tpu_torch.training.state import (
        create_train_state, make_optimizer,
    )
    from code2vec_tpu_torch.training.step import TrainStepBuilder
    from torch.profiler import ProfilerActivity, profile

    build.build_all()
    fs, ft = chip_smoke.flagship(), chip_smoke.flagship_train()
    dev = torch.device("cuda")
    config = Config(use_sparse_embedding_update=args.sparse_embedding_update)
    dims = ModelDims(fs.vocab["token"] + 1, fs.vocab["path"] + 1,
                     fs.vocab["target"] + 1, token_dim=fs.token_dim,
                     path_dim=fs.path_dim)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    module = Code2VecModule(dims, device=dev, generator=g,
                            dropout_keep_rate=ft.keep)
    hyper = make_optimizer(config)
    state = create_train_state(module, hyper, config)
    step = TrainStepBuilder(module, hyper, config).make_train_step(state)
    b, m = ft.rows, ft.contexts
    batch = [torch.randint(0, hi, (b, m), generator=g, device=dev,
                           dtype=torch.int32)
             for hi in (dims.token_vocab_size, dims.path_vocab_size,
                        dims.token_vocab_size)]
    batch.append((torch.rand((b, m), generator=g, device=dev) < 0.8
                  ).float())
    batch.append(torch.randint(1, dims.target_vocab_size, (b,), generator=g,
                               device=dev, dtype=torch.int32))
    batch.append(torch.ones(b, dtype=torch.bool, device=dev))
    print(f"card: {torch.cuda.get_device_name(0)}; "
          f"{'sparse' if args.sparse_embedding_update else 'dense'} step")
    for _ in range(2):
        state, _ = step(state, *batch, args.seed)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(args.steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, _ = step(state, *batch, args.seed)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated()
    print(f"step: {ms:.3f} ms (CUDA events, median of {args.steps}), "
          f"{b / ms * 1e3:.0f} examples/s; peak device memory "
          f"{peak / 1e9:.3f} GB ({(peak - held) / 1e9:.3f} GB above the "
          f"{held / 1e9:.3f} GB held between steps)")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            state, _ = step(state, *batch, args.seed)
        torch.cuda.synchronize()
    events = prof.key_averages()
    print(events.table(sort_by="cuda_time_total", row_limit=40))
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if kernels:
        busy = sum(e.time_range.elapsed_us() for e in kernels)
        span = (max(e.time_range.end for e in kernels)
                - min(e.time_range.start for e in kernels))
        print(f"device busy {busy / 1e3:.3f} ms of a {span / 1e3:.3f} ms "
              f"window over {args.steps} steps ({busy / span:.3f}); "
              f"{busy / 1e3 / args.steps:.3f} ms of kernels per step")
    else:
        print("device busy: not measured (the profiler saw no CUDA "
              "kernels)")


if __name__ == "__main__":
    main()
