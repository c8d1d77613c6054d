#!/usr/bin/env python3
"""Drive the PyTorch port (code2vec_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--samples N]

Run from the root of a checkout, on a machine with one CUDA GPU, nvcc and
a C++ compiler. Phases, each fatal on failure:

1. The card: `nvidia-smi` name and power limit, torch's device name.
2. Build: every kernel under code2vec_tpu_torch/kernels/csrc with nvcc
   (one process per source, in parallel) and, where missing, the native
   path extractor and data core (`make -C cpp`); the data core must load,
   so every data phase below takes the native route.
3. Kernels: each kernel of the serving path against its plain PyTorch
   version on the same inputs at the serving shapes (64 rows, 32 and 200
   contexts, int8 and f32 tables at the java14m vocabulary sizes; K2 also
   at the MIPS head's batch, 8 rows of which 7 are padding, and two runs
   bit-equal):
   largest error against the stated tolerance, top-k index agreement,
   median device time over --samples runs with the L2 cache flushed,
   the plain version's and a library call's time, and the least time the
   card could take (bytes over 3.35 TB/s, or bf16 operations over 989
   TFLOP/s, whichever is larger). Then K3 again and again on the same
   inputs (k3_repeat_check): every call's large-k scores, values,
   indices and logsumexp must be the first call's bits.
4. Train kernels: K1 in train mode, K2 and K5-K8 against their plain
   versions at the flagship train shapes (1024 rows x 200 contexts x 384;
   1024 x 261,246 logits; Adam over all 383.7M parameters with bf16
   moments), timed the same way; K5's and K6's gradients also by the
   share of elements that moved (check_flips). The dropout mask is drawn
   by K1's write-out mode: its kept share must lie within 5 sigma of the
   keep rate, the same (seed, step) must draw the same mask and the next
   step another, and K5 must give exactly 0 to every dropped element.
5. Serving path: a full-width int8 release artifact written from random
   weights (seeded), served over HTTP by the port's server on the GPU
   through the serving host path (path_phase): the extractor pool must
   come up warm (`c2v-extract --server`); the dynamic batcher and then
   the continuous one over the same model, cache off, answer /predict
   and /embed of every request source through the real extractor (each
   body checked, each equal to the other batcher's) and an 8-thread
   burst of 96 requests (p50, p99, batches, mean rows a batch, rides),
   each serving kernel launched under each batcher; with the cache on, a
   repeated and a re-indented request byte-equal to the first (hits +2)
   and 100 timed hits; /metrics parsed and its request, pool, batcher
   and cache series held to the requests sent; and the step's outputs
   on one padded batch of the extracted methods against the same step
   on the CPU (plain versions).
6. Train path: a synthetic corpus at full width (a `.dict.c2v` with the
   java14m vocabulary sizes, 4 x 1024 methods whose name follows their
   tokens) trained for 2 epochs by the `train` command of the port's CLI
   on the GPU, with --save and --test (2,048 more methods of the same
   writer): every loss finite, the second epoch's mean loss below the
   first's, every train kernel launched once per step; then the
   lifecycle (lifecycle_phase): the three checkpoints verify, each
   epoch-end evaluation launched each of K1-K4 once per batch, the final
   checkpoint reloads bit for bit and answers /predict from `serve
   --load` through K1-K4; `serve --load --serve_mips_nprobe 16` builds
   the MIPS head over the live target table (K9, K10) and answers
   /predict through K11, equal to the exact head over every list and on
   top-1 where the exact top-1 row lies in a probed list; `--release`
   drops the optimizer state, `train --load` of epoch 1's checkpoint
   runs epoch 2, `export` as float32 and int8, whose `evaluate` gives
   the epoch-end evaluation exactly (float32) and agrees on top-1
   (int8), and int8 with --serve_mips_nprobe 16, which records the
   calibrated head crossover with an unchanged fingerprint and which a
   ReleaseModel with --serve_mips_crossover -1 adopts; save, load,
   export seconds and bytes; then the step time and examples/s of a
   steady step. Then the loop's operations (ops_phase) on the same
   corpus and test file: `train --save B2 --test --async_checkpointing
   --checkpoint_hash_content --heartbeat_file --metrics_file` with a
   mid-epoch evaluation every 3 batches, SIGTERM sent from the step at
   step 6 (epoch 2 cut after 2 of its 4 batches): B2_iter1 verifies with
   its content hashes, B2_iter1_preempt holds the cursor (epoch 1, row
   2048), the heartbeat reads preempted, the metrics file counts the
   steps; `train --load B2` resumes exactly and trains the epoch-2
   permutation's rows 2048-4095 (id checksums against the host's
   gather) to step 8, its losses within OPS_LOSS_RTOL and its state within
   OPS_STATE_RTOL of the lifecycle run's step 8, each async artifact bit
   for bit the state at its save call, heartbeat done; K1, K2 and K5-K8
   once a step; the
   epoch-1 save's stall, synchronous (the lifecycle run) against async,
   and the state's host copy by route.
7. One train step at 64 rows with full vocabulary widths and an injected
   dropout mask, on the GPU against the same step on the CPU (plain
   versions): the loss and the five gradients within one bf16 step of
   each tensor's largest value, the target rows that are no label within
   one bf16 step of their own largest value, and K8's update on
   identical inputs.
8. Retrieval kernels: K9 kmeans_assign, K10 kmeans_update (two runs
   bit-equal), K11 ivf_search and K3's float32 mode against their plain
   versions, timed the same way (bounds over the float32 peak of 67
   TFLOP/s where operations bound them; K9 and K3's float32 mode run
   3xTF32, three tf32 products per f32 one, so theirs are over the tf32
   peak of 495 TFLOP/s, the f32-FMA bound beside it as f32_fma_bound_ms),
   at two shapes: the MIPS head
   over the flagship int8 classifier (261,245 rows, nlist 511, 6 Lloyd
   steps, nprobe 16, B 64, B 8 with one live and seven zero queries as
   the MIPS dispatch pads a one-method request, and B 1, k 10; at nprobe
   = nlist it must return the exact head's indices away from near-ties)
   and an index of 1,000,000 normalised f32 vectors (nlist 1000, 10
   spherical Lloyd steps, nprobe 16, B 64 and 1, k 16; brute force at B
   64, k 16). K11 twice on each batch, bit-equal, and timed beside two
   PyTorch chains: from the candidates (gather, bmm, topk) and the whole
   function (matmul, topk(nprobe), gather, bmm, topk(k)). K10 also on
   skewed lists at the MIPS shape (half the rows in one list, every
   eighth list empty: two runs bit-equal, empty lists kept, timed). The
   large-k mode (K13 select_topk): K3's float32 mode over the 1M index
   at B 64, k 1000, and K11 int8 on the MIPS head at B 64, k 100,
   against their plain versions (indices exact away from near-ties);
   K13 alone, exact against its plain version (positions and value
   bits) and timed, on the 1M index's scores at B 64 and 1 (k 1000), on
   K3's own large-k scores at the serving shape (B 64 x 261,245, k 100)
   and on K11's candidates at MIPS k 100 (B 64 and 1); and exact on
   rows built against it at B 64 x 1M (one value; one 11-bit bin;
   NaN, +-inf, +-0; ties across its slices), k 5 and 1000, the first
   two shown to overflow a slice's candidate buffer (so all of a row's
   CTAs refine it) and timed at k 1000.
9. Retrieval path, through the port's CLI on the serving path's
   artifact: `embed` of a 20,000-method synthetic corpus (plus the
   request sources' methods, twice), `index-build`, then `serve
   --retrieval_index --serve_mips_nprobe 16 --serve_mips_crossover 8`
   over HTTP (warm pool, cache off): well-formed /neighbors bodies, each
   stored method its own
   top neighbor at cosine >= 1 - 1e-4, k 65 and k 1000 answered (each
   method still its own top neighbor), a one-method /predict on the
   MIPS head (K11) and a 12-method one on the exact head (K3), the
   recall@10 of IVF against brute force, the MIPS head at nprobe = nlist
   against the exact head, every retrieval kernel launched, and the
   embed job's vectors on the GPU against a CPU run of the same rows.
10. Sparse kernels (run after 4), at the flagship train shapes: K5's
   row mode against its plain version (one bf16 step; its rows summed
   by id against the dense mode's table gradients) and K12 sparse_adam
   against its plain version on both tables, ids drawn uniform and
   Zipf(1.07) over the real vocabulary sizes: updated rows within K8's
   tolerance, untouched rows bit-equal, two runs bit-equal, timed with
   its bound and the unique-row count; each backward's allocation.
11. Sparse train path (run after 6): the `train` command with
   --sparse_embedding_update on the train path's corpus, 2 epochs of 4
   steps: every loss finite, the second epoch's mean below the first's,
   K5's row mode, K12 (once, both tables) and K8 (over the dense
   subtree only) launched every step; the steady step's time,
   examples/s and peak device memory beside the dense step's.
12. One sparse step (run after 7) at 64 rows with full vocabulary
   widths, an injected dropout mask and mid-training row moments, GPU
   against CPU: the loss, the updated rows of both tables, mu and nu
   within one bf16 step of each tensor's largest value, untouched rows
   bit-equal.

13. fp8 and int4 kernels (run after 3): the e4m3, e5m2 and packed-int4
   modes of K1 (200 and 32 contexts), K3 (k 10, and k 100 through its
   large-k mode and K13), K4 and K11 (the MIPS head's lists over the
   classifier in that format; B 64, 8 (7 zero queries) and 1 at k 10, B
   64 at k 100) against
   their plain versions at the serving shapes, to the int8 mode's
   tolerances, timed with their bounds, plain versions and library
   calls (the cast or torch's int4 unpack, a bf16 matmul and
   torch.topk); all 256 codes of each fp8 format through K3 and K4.
   Then K3 over the flagship target table in every format at B 1, 12, 64
   and 1024 (its N tiles of 8, 16, 2 x 32 and 16 x 64) and k 10 and 100,
   against its plain version; at B 1024 each format is timed beside a
   bf16 matmul + torch.topk and its bound (b1024_* keys of the K3
   entries).
14. fp8 and int4 serving (run after 5; warm pool, cache off):
   full-width artifacts of all five schemes written from one set of
   seeded weights; the e4m3 artifact
   served over HTTP (exact head), the int4 one with the MIPS head
   (nprobe 16, crossover 8: one-method requests on K11's int4 mode, a
   12-method one on the exact head): bodies checked, the mode's kernels
   launched and the int8 ones not, the step on one padded batch GPU
   against CPU; the e5m2 artifact on that batch in process.
15. Evaluation: the `evaluate` command over each of the five artifacts
   and a synthetic corpus of 4 x 1024 + 37 methods labelled with the
   float32 artifact's top-1 names (so float32 must score top-1 1.0, and
   each scheme's top-1 is its agreement with float32): examples/s,
   table bytes, top-1/top-10, F1; then a 64-row subset GPU against CPU.
16. Data path (run after 9): a 65,536-method synthetic corpus with the
   java14m vocabularies (M 200) packed by pack_c2v natively and by its
   Python route on every host core, the two byte-identical; the pack,
   a PackedDataset gather of a batch and the text parse (native and
   Python) timed alone; `train` from the `.c2vb` for 2 epochs of 64
   steps (B 1024), dense and sparse: examples/s over the second epoch
   and the device's busy share (CUDA events around each step), beside
   8 steps read from text with --no_packed_data; every train kernel
   once a step; the prefetcher's check (each batch of the dense run's
   first epoch has, on the device, the host's id checksum). Where an
   earlier phase's text corpus now goes through the packed default, its
   one-time pack is timed on a line of its own.
17. Capstone: the in-repo generated Java corpus (experiments/javagen.py,
   seed 17, 2,400/260/260 files) through the port's extract_dir and
   preprocess (M 200), `train --test val --epochs 14 --batch_size 1024`
   dense and sparse, `evaluate --load` on the test split: the val F1 of
   each epoch, test F1 >= 0.62 and top-1 >= 0.42 (the reference: 0.660 /
   0.467 dense, 0.654 / 0.464 sparse), each stage's seconds, train
   examples/s; compile_corpus on 4 workers row for row against the pack
   of the serial preprocess's text. The dense run also takes
   --profile_dir, --tensorboard, --heartbeat_file, --metrics_file and
   --trace_export (capstone_exports): the profiler's trace names K1, K2
   and K5-K8 by their CUDA symbols, the event file decodes to train/loss
   and eval/* scalars, the heartbeat reads done.
18. Parallel kernels (run after 10): K14 (gather, scatter-add, local ids
   of the tp-2 token shard, 409,600 ids), K15 (its stats and gradient
   passes over the 1024 x 130,623 tp-2 slice of the logits, beside
   F.cross_entropy's forward and backward; the stats pass alone as the
   eval step runs it, beside torch.logsumexp) and K16/K17 (the cp-2
   contexts, 1024 x 100 x 384) against their plain versions, timed beside
   them and a PyTorch call of the same function; K15's, K16's and K17's
   edge cases (small odd widths, a wholly padded slice, floor mode, one
   context a row, a row whose fs equals its sum of w fs) and second
   calls bit-equal; K17's per-launch device times. K13's merge of the
   eval step's candidates (2 and 4 ranks' top 10, B 1024, k 10) and its
   small-width mode exact against their plain versions, timed beside
   torch.topk + gather, with a bound that counts one empty launch, which
   K14's local ids also get.
19. Parallel path (run after 11): the dense and sparse single-device steps
   on the card as the reference (2 steps at B 1024, M 200, keep 0.75 with
   injected masks, seeded full-width weights, the tables padded to tp 2),
   then 8 processes sharing cuda:0 over gloo run the plans tp2 dense, tp2
   sparse, cp2 dense, dp2 sparse and dp2 tp2 cp2 dense (the parallel
   steps, training/step.py ParallelStepBuilder; each plan's mesh is the
   first dp x tp x cp ranks): each plan's losses and parameters against
   the reference (PARALLEL_LOSS_RTOL, PARALLEL_FLIP_SHARE), each plan's
   gradients of the first batch leaf by leaf against the single-device
   step's (PARALLEL_GRAD_RESID), the dense plans' eval step (K13 around
   the all-gather, then its merge where tp > 1: the launches counted,
   K15) against the single-device eval step, every
   kernel of the path launched, ms a step; then NCCL at world size 1, and
   `train --tp 2 --test` through torchrun on two processes that share
   the card.

Prints one line per kernel, then a JSON line {"kernels": [...]}, the
card's name and power limit, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, printing no result, where torch sees no CUDA device or
the package is not beside this script.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import gc
import json
import logging
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import types
import urllib.error
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12        # dense bf16 tensor-core peak, same source
F32_FLOP_PER_S = 67e12          # float32 outside the tensor cores, same
# dense tf32 tensor-core peak, same source: the bound of K3's float32 mode
# and K9, which run three tf32 products (3xTF32) for each f32 one
TF32_FLOP_PER_S = 495e12
# (atol, rtol) per kernel output, with the reason. The kernel phase's
# inputs are scaled so the compared values are of order one.
# K1's bf16 outputs: both sides round the same f32 value, except where the
# f32 sums' order flips a rounding, which moves it one bf16 step (2^-8
# of its size, under 8e-3 relative; atol for values near 0).
TOL_K1 = (1e-3, 8e-3)
# f32 results from exact bf16 products (and f32 softmax weights): only
# the order of the f32 sums differs, ~1e-7 relative.
TOL_F32SUM = (1e-5, 1e-4)
# The path phase compares the whole step on the GPU with the same step on
# the CPU. An f32 order difference can flip a bf16 rounding of an
# intermediate (K1's output, K2's weights, K3's cast of the code vector),
# which moves one term by one bf16 step; a few such terms move an output
# by far less than one bf16 step (2^-8) of its tensor's largest value.
PATH_REL_TOL = 2.0 ** -8
# the MIPS head's batch: a request of one method padded to 8 rows
# (release/runtime.py, chip_smoke's --serve_mips_crossover 8)
MIPS_ROWS = 8
SERVE_KERNELS = ("context_encoder", "masked_attention", "blockwise_topk",
                 "label_logits")

SOURCES = {
    "Input.java": None,  # read from the repo
    "Counter.java": """class Counter {
    private int count;
    public void increment() { count = count + 1; }
    public int getCount() { return count; }
}""",
    "Strings.java": """class Strings {
    static boolean isEmpty(String s) { return s == null || s.length() == 0; }
}""",
    "Search.java": """class Search {
    int indexOf(int[] values, int target) {
        for (int i = 0; i < values.length; i++) {
            if (values[i] == target) { return i; }
        }
        return -1;
    }
}""",
    "Max.java": """class Max {
    int max(int a, int b) { if (a > b) { return a; } return b; }
}""",
    "Reverse.java": """class Reverse {
    String reverse(String s) {
        StringBuilder sb = new StringBuilder(s);
        return sb.reverse().toString();
    }
}""",
}


def flagship():
    """The flagship serving shape: the port's Config defaults (the
    java14m vocabulary sizes and serving knobs of code2vec_tpu/config.py)."""
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.serving.batcher import parse_buckets
    c = Config()
    return types.SimpleNamespace(
        vocab={"token": c.max_token_vocab_size,
               "path": c.max_path_vocab_size,
               "target": c.max_target_vocab_size},
        token_dim=c.token_embeddings_size, path_dim=c.path_embeddings_size,
        code_dim=2 * c.token_embeddings_size + c.path_embeddings_size,
        rows=c.serve_batch_size, contexts=c.max_contexts,
        buckets=parse_buckets(c.serve_buckets, c.max_contexts),
        topk=c.top_k_words_considered_during_prediction,
        block=c.topk_block_size, scheme=c.release_scheme,
        compute_dtype=c.compute_dtype)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ----------------------------------------------------------------- timing


class Timer:
    """Median device time of a callable, by CUDA events. Before each
    sample a 256 MB write evicts the 50 MB L2 cache and a spin kernel
    keeps the GPU busy while the host enqueues the call, so the events
    bracket device work only, not Python's enqueue time."""

    def __init__(self, torch, samples: int):
        self.torch = torch
        self.samples = samples
        self.flush = torch.empty(64 * 2 ** 20, dtype=torch.float32,
                                 device="cuda")
        self.sleep = getattr(torch.cuda, "_sleep", None)

    def __call__(self, fn, spin_ms: float = 2.0) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(self.samples):
            self.flush.zero_()
            if self.sleep is not None:
                self.sleep(int(spin_ms * 1.5e6))
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        return statistics.median(out)


def bound(nbytes: float, flops: float, peak: float = BF16_FLOP_PER_S):
    """The least time (ms) for moving `nbytes` and doing `flops` at the
    card's memory rate and peak rate `peak`, and which of the two."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want, tol):
    """(max |got - want|, ok under |got - want| <= atol + rtol |want|);
    NaN must meet NaN."""
    torch = sys.modules["torch"]
    g, w = got.float(), want.float()
    same_nan = torch.isnan(g) == torch.isnan(w)
    # NaN meets NaN; an infinity must meet the same one
    diff = torch.where(torch.isnan(w) | (g == w), torch.zeros_like(w),
                       (g - w).abs())
    ok = bool(same_nan.all()) and bool(
        (diff <= tol[0] + tol[1] * w.abs().nan_to_num()).all())
    return float(diff.max()), ok


def topk_agreement(idx, want_idx, want_vals, tol, next_vals=None):
    """(positions equal, positions differing without a near-tie): a
    position may differ only where the reference's neighbouring values
    lie within tolerance of each other; `next_vals`, the reference's
    (k+1)-th value per row, is the last position's lower neighbour."""
    torch = sys.modules["torch"]
    diff = idx != want_idx
    v = want_vals.float()
    gap_prev = torch.full_like(v, math.inf)
    gap_next = torch.full_like(v, math.inf)
    gap_prev[:, 1:] = (v[:, 1:] - v[:, :-1]).abs()
    gap_next[:, :-1] = (v[:, 1:] - v[:, :-1]).abs()
    if next_vals is not None:
        gap_next[:, -1] = (next_vals.float() - v[:, -1]).abs()
    near = torch.minimum(gap_prev, gap_next) <= tol[0] + tol[1] * v.abs()
    return int((~diff).sum()), int((diff & ~near).sum())


def topk_detail(idx, want_idx, want_vals, next_vals, limit=4):
    """The first differing positions as (row, rank, index, the
    reference's index, its value, the value below it), for a failure
    message."""
    torch = sys.modules["torch"]
    v = torch.cat([want_vals.float(), next_vals.float()[:, None]], dim=1)
    out = []
    for r, c in torch.nonzero(idx != want_idx)[:limit].tolist():
        out.append((r, c, int(idx[r, c]), int(want_idx[r, c]),
                    float(v[r, c]), float(v[r, c + 1])))
    return out


# ------------------------------------------------------------ kernel phase


def quantize(torch, table):
    """The int8 row quantizer of ops/quant.py, on the device."""
    scales = table.abs().amax(dim=1, keepdim=True) / 127.0
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    q = torch.clamp(torch.round(table / safe), -127, 127).to(torch.int8)
    return q, scales.float()


def decoded_rows(torch, table, scales, idx, dim):
    """Rows `idx` of a table in its stored format, in PyTorch calls: an
    index_select, the format's decode (packed int4 unpacked, low nibble
    first) and the rows' scales."""
    r = table.index_select(0, idx)
    if table.dtype == torch.uint8:
        r = torch.stack([(r & 15).to(torch.int8) - 8,
                         (r >> 4).to(torch.int8) - 8],
                        dim=-1).flatten(1)[:, :dim]
    r = r.float()
    return r if scales is None else r * scales.index_select(0, idx)


def k4_library(torch, cv, table, labels, scales):
    """K4's whole function in PyTorch calls, its `library_ms` yardstick
    (no single call computes it): the label rows decoded
    (`decoded_rows`), cast to bf16 with the code vectors, and the
    row-wise dot in f32."""
    r = decoded_rows(torch, table, scales, labels.long(), cv.shape[1])
    return (cv.to(torch.bfloat16).float()
            * r.to(torch.bfloat16).float()).sum(dim=1)


def k1_library(torch, tok, tok_s, path, path_s, w, ids, mask=None,
               keep=1.0, residual=False):
    """K1's whole function in PyTorch calls, its `library_ms` yardstick
    (no single call computes it): per gather an index_select and the
    format's decode times the rows' scales, cat, the bf16 cast, dropout on
    a given mask, torch.mm of the bf16 context and W with f32
    accumulation, tanh, the bf16 cast (and the residual)."""
    from code2vec_tpu_torch.kernels.encoder import table_widths
    td, pd = table_widths(tok, path, w)

    def rows(table, scales, idx, dim):
        return decoded_rows(torch, table, scales, idx, dim)

    flat = [i.flatten() for i in ids]
    ctx = torch.cat([rows(tok, tok_s, flat[0], td),
                     rows(path, path_s, flat[1], pd),
                     rows(tok, tok_s, flat[2], td)], dim=1).to(torch.bfloat16)
    if mask is not None:
        ctx = torch.where(mask.view(ctx.shape),
                          (ctx.float() / keep).to(torch.bfloat16),
                          torch.zeros((), dtype=torch.bfloat16,
                                      device=ctx.device))
    th = torch.tanh(torch.mm(ctx, w.to(torch.bfloat16),
                             out_dtype=torch.float32))
    hi = th.to(torch.bfloat16)
    return (hi, (th - hi.float()).to(torch.bfloat16)) if residual else hi


def attention_case(torch, timer, t, a, mask, dead_row=0):
    """K2 on K1's output `t` against its plain version: the weights at
    TOL_F32SUM, the code vectors exactly against the weighted sum of the
    kernel's own bf16 weights and against the plain version within two
    bf16 weight flips, zeros for the all-invalid row `dead_row`, two runs
    bit-equal; then timed beside the plain version and
    scaled_dot_product_attention. Returns (report entry, the kernel's
    code vectors, its weights)."""
    from code2vec_tpu_torch.kernels import attention
    import torch.nn.functional as F

    b, m, d = t.shape
    got_cv, got_attn = attention.masked_attention(t, a, mask)
    again_cv, again_attn = attention.masked_attention(t, a, mask)
    want_cv, want_attn = attention.masked_attention_plain(t, a, mask)
    torch.cuda.synchronize()
    if not (torch.equal(got_cv, again_cv) and torch.equal(got_attn,
                                                          again_attn)):
        fail(f"masked_attention B={b} m={m}: two runs gave different bits")
    del again_cv, again_attn
    err_at, ok_at = max_err(got_attn, want_attn, TOL_F32SUM)
    # the weighted sum, exact given the kernel's own weights
    sum_cv = (got_attn.to(torch.bfloat16).float()[:, :, None]
              * t.float()).sum(dim=1)
    err_sum, ok_sum = max_err(got_cv, sum_cv, TOL_F32SUM)
    del sum_cv
    # against the plain version: a weight whose f32 value lies at a bf16
    # rounding boundary may round the other way there, moving the sum by
    # one bf16 step of that weight's term; allow two
    flip = 2 * 2.0 ** -8 * float(want_attn.abs().max() * t.abs().max())
    tol_cv = (flip + TOL_F32SUM[0], TOL_F32SUM[1])
    err_cv, ok_cv = max_err(got_cv, want_cv, tol_cv)
    if not (ok_cv and ok_at and ok_sum):
        fail(f"masked_attention B={b} m={m}: max errors cv {err_cv} (tol "
             f"{tol_cv}) attn {err_at} weighted sum {err_sum}")
    if got_cv[dead_row].abs().max() != 0 or \
            got_attn[dead_row].abs().max() != 0:
        fail("masked_attention: an all-invalid row must give zeros")
    nbytes = t.numel() * 2 + mask.numel() * 4 * 2 + d * 4 + b * d * 4
    bms, by = bound(nbytes, 4.0 * t.numel())
    ms = timer(lambda: attention.masked_attention(t, a, mask))
    plain_ms = timer(lambda: attention.masked_attention_plain(t, a, mask),
                     spin_ms=20)
    q = a.to(torch.bfloat16).view(1, 1, 1, d).expand(b, 1, 1, d).contiguous()
    kv = t.view(b, 1, m, d)
    keep = (mask > 0).view(b, 1, 1, m)
    lib_ms = timer(lambda: F.scaled_dot_product_attention(
        q, kv, kv, attn_mask=keep, scale=1.0))
    log(f"K2 masked_attention B={b} m={m}: max_abs_err cv "
        f"{err_cv:.3g} (tol {tol_cv[0]:.3g}, {tol_cv[1]}) weighted sum "
        f"{err_sum:.3g} attn {err_at:.3g} (tol {TOL_F32SUM}) max|cv| "
        f"{float(want_cv.abs().max()):.3g}, two runs bit-equal; ms "
        f"{ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} (SDPA) "
        f"bound_ms {bms:.4f} ({by})")
    entry = dict(max_abs_err=max(err_cv, err_at), ms=ms, plain_ms=plain_ms,
                 bound_ms=bms, bound_by=by, library_ms=lib_ms)
    return entry, got_cv, got_attn


def kernel_phase(torch, seed: int, timer, fs, dev="cuda"):
    from code2vec_tpu_torch.kernels import encoder, label_logits, topk

    dev = torch.device(dev)
    g = torch.Generator(device=dev).manual_seed(seed)

    def uniform(shape, limit):
        return (torch.rand(shape, generator=g, device=dev) * 2 - 1) * limit

    v_tok, v_path, v_tgt = (fs.vocab["token"] + 1, fs.vocab["path"] + 1,
                            fs.vocab["target"] + 1)
    td, pd, d = fs.token_dim, fs.path_dim, fs.code_dim
    tables = {"f32": {"tok": uniform((v_tok, td), math.sqrt(3 / td)),
                      "path": uniform((v_path, pd), math.sqrt(3 / pd)),
                      "tgt": uniform((v_tgt, d), math.sqrt(3 / d))}}
    tables["int8"] = {}
    for name, t in tables["f32"].items():
        tables["int8"][name] = quantize(torch, t)
    tables["f32"] = {k: (t, None) for k, t in tables["f32"].items()}
    # order-one values: pre-activations of std ~1 (tanh far from linear),
    # attention scores of std ~2 (weights far from uniform)
    w = uniform((d, d), 1.0)
    a = uniform((d,), 0.25)
    report = {}

    def ids(m):
        return (torch.randint(0, v_tok, (fs.rows, m), generator=g, device=dev,
                              dtype=torch.int32),
                torch.randint(0, v_path, (fs.rows, m), generator=g, device=dev,
                              dtype=torch.int32),
                torch.randint(0, v_tok, (fs.rows, m), generator=g, device=dev,
                              dtype=torch.int32))

    transformed = {}
    for scheme in ("int8", "f32"):
        (tok, tok_s), (path, path_s) = (tables[scheme]["tok"],
                                        tables[scheme]["path"])
        for m in (fs.contexts, 32):
            src, pth, tgt = ids(m)
            args = (tok, tok_s, path, path_s, w, src, pth, tgt)
            got = encoder.context_encoder(*args)
            want = encoder.context_encoder_plain(*args)
            torch.cuda.synchronize()
            err, ok = max_err(got, want, TOL_K1)
            if not ok:
                fail(f"context_encoder {scheme} m={m}: max error {err}")
            transformed[(scheme, m)] = got
            esize, ssize = (1, 4) if scheme == "int8" else (4, 0)
            uniq_tok = torch.unique(torch.cat([src, tgt])).numel()
            uniq_path = torch.unique(pth).numel()
            nbytes = (uniq_tok * (td * esize + ssize)
                      + uniq_path * (pd * esize + ssize) + 3 * src.numel() * 4
                      + w.numel() * 4 + got.numel() * 2)
            bms, by = bound(nbytes, 2.0 * src.numel() * d * d)
            ms = timer(lambda: encoder.context_encoder(*args))
            plain_ms = timer(lambda: encoder.context_encoder_plain(*args),
                             spin_ms=20)
            lib_ms = timer(lambda: k1_library(
                torch, tok, tok_s, path, path_s, w, (src, pth, tgt)))
            log(f"K1 context_encoder {scheme} B={fs.rows} m={m}: "
                f"max_abs_err {err:.3g} (tol {TOL_K1}) ms "
                f"{ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} "
                f"(the whole function in PyTorch calls) bound_ms "
                f"{bms:.4f} ({by})")
            if (scheme, m) == ("int8", fs.contexts):
                report["context_encoder"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                    bound_by=by, library_ms=lib_ms)

    k2 = {}
    for m in (fs.contexts, 32):
        t = transformed[("int8", m)]
        mask = (torch.rand((fs.rows, m), generator=g, device=dev)
                > 0.3).float()
        mask[0] = 0.0  # an all-invalid row
        k2[m], got_cv, _ = attention_case(torch, timer, t, a, mask)
        if m == fs.contexts:
            cv = got_cv.contiguous()
        # the MIPS dispatch's batch: one live row, seven padded ones
        mask8 = mask[:MIPS_ROWS].clone()
        mask8[0] = (torch.rand((m,), generator=g, device=dev) > 0.3).float()
        mask8[1:] = 0.0
        k2[(MIPS_ROWS, m)], _, _ = attention_case(
            torch, timer, t[:MIPS_ROWS].contiguous(), a, mask8, dead_row=1)
    report["masked_attention"] = dict(k2[fs.contexts])
    for key, prefix in ((32, "m32"), ((MIPS_ROWS, fs.contexts), "b8"),
                        ((MIPS_ROWS, 32), "b8_m32")):
        report["masked_attention"].update(
            {f"{prefix}_{n}": x for n, x in k2[key].items()})

    valid = fs.vocab["target"] + 1
    for scheme in ("int8", "f32"):
        tbl, scl = tables[scheme]["tgt"]
        args = (cv, tbl, fs.topk, fs.block)
        kw = dict(scales=scl, valid_rows=valid)
        got = topk.blockwise_topk(*args, **kw)
        want = topk.blockwise_topk_plain(*args, compute_dtype=torch.bfloat16,
                                         **kw)
        torch.cuda.synchronize()
        err_v, ok_v = max_err(got.values, want.values, TOL_F32SUM)
        err_l, ok_l = max_err(got.lse, want.lse, TOL_F32SUM)
        same, bad = topk_agreement(got.indices, want.indices, want.values,
                                   TOL_F32SUM)
        if not (ok_v and ok_l) or bad:
            fail(f"blockwise_topk {scheme}: value error {err_v}, lse error "
                 f"{err_l}, {bad} index mismatches away from near-ties")
        esize = 1 if scheme == "int8" else 4
        nbytes = (tbl.numel() * esize + (tbl.shape[0] * 4 if scl is not None
                                          else 0)
                  + cv.numel() * 4 + fs.rows * fs.topk * 8 + fs.rows * 4)
        bms, by = bound(nbytes, 2.0 * fs.rows * tbl.shape[0] * d)
        ms = timer(lambda: topk.blockwise_topk(*args, **kw))
        plain_ms = timer(lambda: topk.blockwise_topk_plain(
            *args, compute_dtype=torch.bfloat16, **kw), spin_ms=100)
        tbl_bf16 = tbl.to(torch.bfloat16)
        cv_bf16 = cv.to(torch.bfloat16)
        lib_ms = timer(lambda: torch.topk(torch.matmul(cv_bf16, tbl_bf16.T),
                                          fs.topk))
        del tbl_bf16
        log(f"K3 blockwise_topk {scheme} B={fs.rows} "
            f"V={tbl.shape[0]} "
            f"k={fs.topk}: max_abs_err values {err_v:.3g} lse "
            f"{err_l:.3g} (tol {TOL_F32SUM}) indices equal "
            f"{same}/{got.indices.numel()} ms {ms:.4f} plain_ms "
            f"{plain_ms:.4f} library_ms {lib_ms:.4f} bound_ms "
            f"{bms:.4f} ({by})")
        if scheme == "int8":
            report["blockwise_topk"] = dict(
                max_abs_err=max(err_v, err_l), ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=lib_ms)

        labels = torch.randint(0, valid, (fs.rows,), generator=g, device=dev,
                               dtype=torch.int32)
        got = label_logits.label_logits(cv, tbl, labels, scales=scl)
        want = label_logits.label_logits_plain(
            cv, tbl, labels, scales=scl, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        err, ok = max_err(got, want, TOL_F32SUM)
        if not ok:
            fail(f"label_logits {scheme}: max error {err}")
        uniq = torch.unique(labels).numel()
        nbytes = (uniq * (d * esize + (4 if scl is not None else 0))
                  + cv.numel() * 4 + fs.rows * 8)
        bms, by = bound(nbytes, 2.0 * fs.rows * d)
        ms = timer(lambda: label_logits.label_logits(cv, tbl, labels,
                                                     scales=scl))
        plain_ms = timer(lambda: label_logits.label_logits_plain(
            cv, tbl, labels, scales=scl, compute_dtype=torch.bfloat16),
            spin_ms=20)
        lib_ms = timer(lambda: k4_library(torch, cv, tbl, labels, scl))
        log(f"K4 label_logits {scheme} B={fs.rows}: max_abs_err "
            f"{err:.3g} (tol {TOL_F32SUM}) ms {ms:.4f} plain_ms "
            f"{plain_ms:.4f} library_ms {lib_ms:.4f} (gather, decode, "
            f"row-wise dot in PyTorch calls) bound_ms {bms:.4f} ({by})")
        if scheme == "int8":
            report["label_logits"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)
    report["blockwise_topk"]["repeat_calls"] = k3_repeat_check(
        torch, cv, tables["f32"]["tgt"][0], valid)
    del tables, transformed
    torch.cuda.empty_cache()
    return report


def k3_repeat_check(torch, cv, table, valid: int,
                    calls: int = 500, flagship_calls: int = 100) -> int:
    """K3 called again and again on the same inputs must write the same
    bits: the large-k mode's scores (captured where K3 hands them to K13),
    values, indices and logsumexp, on the data of
    tests/test_torch_kernels_cuda.py test_blockwise_topk_large_k_kernel
    (B 9 x 20,011 rows, k 1000; `calls` calls) and on the serving batch
    against the flagship f32 target table (k 1000, and k 10 in the list
    mode; `flagship_calls` calls each), through
    scripts/repeat_topk_large_k.py `repeat`. Before K3 gave a ring stage
    back only once the loads that read it had returned, 999 of 1,000
    calls on the test's data wrote other scores than the first call (that
    script, on an H100). Returns the calls made."""
    import numpy as np

    from scripts.repeat_topk_large_k import repeat, test_case_inputs

    made = 0
    for what, c, t, v, k, n in (
            ("test data", *test_case_inputs(np, torch, cv.device), 1000,
             calls),
            ("serving batch", cv, table, valid, 1000, flagship_calls),
            ("serving batch list mode", cv, table, valid, 10,
             flagship_calls)):
        res = repeat(torch, c, t, v, k, n)
        made += n
        outputs = ", ".join(res["calls_differing_from_the_first"])
        log(f"K3 repeat ({what}, B={c.shape[0]} V={t.shape[0]} k={k}): "
            f"{res['calls_differing']} of {n} calls differ from the first "
            f"in a bit of their {outputs}")
        if res["calls_differing"]:
            fail(f"K3 repeat ({what}): {res['calls_differing']} of {n} calls "
                 f"differ from the first")
    return made


# -------------------------------------------------------------- path phase


def flagship_weights(seed: int, extracted, fs):
    """(f32 params, vocabularies) of a full-width artifact from seeded
    random weights. The vocabularies hold the tokens, hashed paths and
    method names the extractor gives for the request sources, padded
    with filler words to the java14m sizes, so requests gather real rows;
    the filler method names hold no digits, so that they can be legal
    predictions in an evaluation."""
    import numpy as np

    from code2vec_tpu_torch.vocab import Code2VecVocabs

    tokens, paths, names = {}, {}, {}
    for lines, _ in extracted:
        for line in lines:
            parts = line.split()
            names[parts[0]] = None
            for ctx in parts[1:]:
                w1, p, w2 = ctx.split(",")
                tokens[w1] = tokens[w2] = paths[p] = None

    def padded(seen, n, stem, suffix=str):
        words = list(seen)[:n]
        return words + [f"{stem}{suffix(i)}" for i in range(n - len(words))]

    vocabs = Code2VecVocabs.from_words(
        padded(tokens, fs.vocab["token"], "tok"),
        padded(paths, fs.vocab["path"], "path"),
        padded(names, fs.vocab["target"], "name|filler", letters))
    rng = np.random.default_rng(seed)
    td, pd, d = fs.token_dim, fs.path_dim, fs.code_dim

    def uniform(shape, limit):
        x = rng.random(shape, dtype=np.float32)
        x *= 2 * limit
        x -= limit
        return x

    params = {
        "token_embedding": uniform((vocabs.token_vocab.size, td),
                                   math.sqrt(3 / td)),
        "path_embedding": uniform((vocabs.path_vocab.size, pd),
                                  math.sqrt(3 / pd)),
        "target_embedding": uniform((vocabs.target_vocab.size, d),
                                    math.sqrt(3 / d)),
        "transform": uniform((d, d), math.sqrt(6 / (2 * d))),
        "attention": uniform((d, 1), math.sqrt(6 / (d + 1))),
    }
    return params, vocabs


def post(url: str, body: str):
    req = urllib.request.Request(url, data=body.encode(), method="POST",
                                 headers={"Content-Type": "text/plain"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        status, data = r.status, r.read()
    return status, json.loads(data), time.perf_counter() - t0


def check_predict_body(body, fingerprint):
    if sorted(body) != ["methods", "model", "model_fingerprint"]:
        fail(f"/predict keys {sorted(body)}")
    if body["model_fingerprint"] != fingerprint or not body["methods"]:
        fail(f"/predict body {str(body)[:300]}")
    for m in body["methods"]:
        if sorted(m) != ["attention_paths", "original_name", "predictions"]:
            fail(f"/predict method keys {sorted(m)}")
        probs = [p["probability"] for p in m["predictions"]]
        if not probs or not all(math.isfinite(p) and 0 <= p <= 1
                                for p in probs):
            fail(f"/predict probabilities {probs}")
        if not m["attention_paths"] or not all(
                math.isfinite(a["score"]) for a in m["attention_paths"]):
            fail(f"/predict attention paths of {m['original_name']}")


def metric_values(text: str):
    """{(name, sorted label pairs): value} of a Prometheus text page,
    failing on a line that does not parse."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        head, _, value = line.rpartition(" ")
        name, _, labels = head.partition("{")
        pairs = tuple(sorted(
            tuple(kv.split("=", 1)) for kv in
            labels.rstrip("}").replace('"', "").split(",") if kv))
        try:
            out[(name, pairs)] = float(value)
        except ValueError:
            fail(f"/metrics: unparsable line {line!r}")
    return out


def scrape(url: str):
    with urllib.request.urlopen(f"{url}/metrics", timeout=60) as r:
        if not r.headers["Content-Type"].startswith("text/plain"):
            fail(f"/metrics content type {r.headers['Content-Type']}")
        return metric_values(r.read().decode())


def metric_delta(before, after, name, **labels):
    key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
    return after.get(key, 0.0) - before.get(key, 0.0)


SERVING_PHASES = ("queue_wait", "extract", "batch_wait", "device")


def phase_means(before, after):
    """Mean ms a request of each serving phase (queue_wait for an
    extractor worker, extract, batch_wait, device: the whole model call
    it rode) and of the whole request (status 200), over the requests
    between two scrapes of /metrics."""
    out = {}
    for phase, labels in [(p, {"phase": p}) for p in SERVING_PHASES] + [
            ("total", {"phase": "total", "status": "200"})]:
        n = metric_delta(before, after, "serving_request_seconds_count",
                         **labels)
        t = metric_delta(before, after, "serving_request_seconds_sum",
                         **labels)
        out[phase] = round(t / n * 1e3, 3) if n else None
    return out


def burst(url: str, sources, n: int, threads: int = 8):
    """`n` /predict requests of `sources` (cycled) from `threads` client
    threads at once: (latencies, [(source, body)])."""
    todo = [sources[i % len(sources)] for i in range(n)]

    def one(src):
        status, body, dt = post(f"{url}/predict", src)
        if status != 200:
            fail(f"/predict burst: HTTP {status}")
        return src, body, dt

    with concurrent.futures.ThreadPoolExecutor(threads) as ex:
        done = list(ex.map(one, todo))
    return [dt for _, _, dt in done], [(s, b) for s, b, _ in done]


def path_phase(torch, seed: int, work_dir: str, fs, weights,
               dev: str = "cuda", n_burst: int = 96, n_hits: int = 100):
    """The int8 artifact of `weights` (serving_weights) served over HTTP
    through the serving host path: the warm extractor pool (required),
    the dynamic batcher and then the continuous one over the same loaded
    model, cache off, with every body checked and each serial body equal
    to the other batcher's for the same source; an 8-thread burst of
    `n_burst` requests under each (p50, p99, batches, mean rows a batch,
    rides); then a dynamic server with the cache on: a repeated and a
    re-indented request byte-equal to the first, `serving_cache_hits_total`
    up by 2, and `n_hits` timed hits; /metrics parsed, its request, pool,
    batcher and cache series against the requests sent. Returns (the
    launch counts of both batchers' runs summed, (the artifact's
    directory, its meta), stats)."""
    import dataclasses

    from code2vec_tpu_torch import kernels
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.release.artifact import write_artifact
    from code2vec_tpu_torch.release.runtime import ReleaseModel
    from code2vec_tpu_torch.serving.server import PredictionServer

    params, vocabs, extracted, sources = weights
    t0 = time.perf_counter()
    art_dir = os.path.join(work_dir, "artifact")
    meta = write_artifact(params, vocabs, art_dir, fs.scheme,
                          max_contexts=fs.contexts,
                          compute_dtype=fs.compute_dtype, topk=fs.topk,
                          topk_block_size=fs.block,
                          serve_batch_size=fs.rows, buckets=fs.buckets)
    log(f"path: wrote a full-width int8 artifact in "
        f"{time.perf_counter() - t0:.1f}s: dims {meta['dims']}, "
        f"{meta['table_bytes']['artifact'] / 1e6:.1f} MB of tables")
    config = Config(serve_artifact=art_dir, device=dev, verbose_mode=0)
    t0 = time.perf_counter()
    model = ReleaseModel(config)
    model.warmup()
    fp = model.model_fingerprint()
    log(f"path: loaded and warmed the model on {model.device} in "
        f"{time.perf_counter() - t0:.1f}s")
    t_phase = time.perf_counter()
    srcs = list(sources.values())
    serial, counts, stats = {}, {}, {}
    for which in ("dynamic", "continuous"):
        server = PredictionServer(model, dataclasses.replace(
            config, serve_cache_entries=0,
            serve_continuous=which == "continuous"))
        url = f"http://127.0.0.1:{server.start(port=0)}"
        try:
            if not server.pool.warm:
                fail(f"path: the {which} server's extractor pool came up "
                     f"cold: cpp/build/c2v-extract has no --server mode")
            kernels.reset_launch_counts()
            bodies = {}
            for name, src in sources.items():
                status, body, _ = post(f"{url}/predict", src)
                if status != 200:
                    fail(f"/predict {name} ({which}): HTTP {status}")
                check_predict_body(body, fp)
                bodies[name] = body
            status, body, _ = post(f"{url}/embed", sources["Input.java"])
            vecs = body.get("vectors") or []
            if status != 200 or not vecs or not all(
                    len(v) == fs.code_dim and all(math.isfinite(x) for x in v)
                    for v in vecs):
                fail(f"/embed ({which}): HTTP {status}, {len(vecs)} vectors")
            bodies["embed"] = body
            serial[which] = bodies
            b0 = server.batcher.batches_dispatched
            r0 = getattr(server.batcher, "rides", 0)
            m0 = scrape(url)
            lat, done = burst(url, srcs, n_burst)
            m1 = scrape(url)
            want_names = {src: [m["original_name"]
                                for m in bodies[name]["methods"]]
                          for name, src in sources.items()}
            for src, body in done:
                check_predict_body(body, fp)
                if [m["original_name"] for m in body["methods"]] != \
                        want_names[src]:
                    fail(f"/predict burst ({which}): methods "
                         f"{[m['original_name'] for m in body['methods']]}")
            batches = server.batcher.batches_dispatched - b0
            rows = metric_delta(m0, m1, "serving_batch_rows_total")
            st = dict(latency_stats(lat), batches=batches,
                      mean_rows=rows / max(batches, 1),
                      rides=getattr(server.batcher, "rides", 0) - r0,
                      phases_ms=phase_means(m0, m1))
            if metric_delta(m0, m1, "serving_batches_total") != batches or \
                    metric_delta(m0, m1, "serving_requests_total",
                                 endpoint="predict", status="200") \
                    != n_burst or metric_delta(
                        m0, m1, "extractor_pool_requests_total") != n_burst:
                fail(f"path ({which}): /metrics deltas of the burst "
                     f"disagree with {n_burst} requests in {batches} "
                     f"batches")
            counts[which] = kernels.launch_counts()
            with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
                health = json.loads(r.read())
        finally:
            server.shutdown()
        if health["kernel_launches"] != counts[which]:
            fail(f"/healthz launch counts {health['kernel_launches']} != "
                 f"{counts[which]}")
        if health["batcher"]["continuous"] != (which == "continuous") or \
                not health["extractor_pool"]["warm"]:
            fail(f"/healthz of the {which} server: {health['batcher']}, "
                 f"{health['extractor_pool']}")
        missing = [k for k in SERVE_KERNELS if counts[which][k] <= 0]
        if missing:
            fail(f"the {which} batcher launched no {missing}")
        stats[which] = st
        pool_size = health["extractor_pool"]["size"]
        log(f"path: {which} batcher, warm pool ({pool_size} workers), "
            f"cache off: {len(sources)} /predict and 1 "
            f"/embed serial; a burst of {n_burst} /predict from 8 threads: "
            f"p50 {st['p50_ms']:.2f} ms, p99 {st['p99_ms']:.2f} ms, max "
            f"{st['max_ms']:.2f} ms; {st['batches']} batches, "
            f"{st['mean_rows']:.2f} rows a batch, {st['rides']} rides; "
            f"mean ms a request by phase {st['phases_ms']}; kernel "
            f"launches {counts[which]}")
    for name, body in serial["dynamic"].items():
        if body != serial["continuous"][name]:
            fail(f"path: the continuous batcher's {name} body differs "
                 f"from the dynamic one's")
    log(f"path: the {len(serial['dynamic'])} serial bodies of the two "
        f"batchers are equal")

    # the prediction cache: hits byte-equal to their miss, then timed
    server = PredictionServer(model, config)
    url = f"http://127.0.0.1:{server.start(port=0)}"
    try:
        m0 = scrape(url)
        src = sources["Input.java"]
        raw = []
        for body in (src, src, "\n".join("    " + ln
                                          for ln in src.splitlines())):
            req = urllib.request.Request(f"{url}/predict",
                                         data=body.encode(), method="POST",
                                         headers={"Content-Type":
                                                  "text/plain"})
            with urllib.request.urlopen(req, timeout=300) as r:
                raw.append(r.read())
        m1 = scrape(url)
        if raw[1] != raw[0] or raw[2] != raw[0]:
            fail("path: a cache hit is not byte-equal to its miss")
        hits = metric_delta(m0, m1, "serving_cache_hits_total")
        misses = metric_delta(m0, m1, "serving_cache_misses_total")
        if (hits, misses) != (2, 1):
            fail(f"path: the cache counted {hits} hits and {misses} misses "
                 f"for one miss and two hits")
        hit_lat, body = timed_posts(f"{url}/predict", src, n_hits, warm=0)
        check_predict_body(body, fp)
        m2 = scrape(url)
        total = metric_delta(m0, m2, "serving_requests_total",
                             endpoint="predict", status="200")
        if metric_delta(m0, m2, "serving_cache_hits_total") != 2 + n_hits \
                or total != 3 + n_hits or metric_delta(
                    m0, m2, "serving_request_seconds_count", phase="total",
                    status="200") != total or metric_delta(
                    m0, m2, "extractor_pool_requests_total") != 1:
            fail(f"path: /metrics after {3 + n_hits} requests of which "
                 f"{2 + n_hits} hits disagrees")
        series = {name for name, _ in m2}
        for name in ("serving_requests_total", "serving_request_seconds_count",
                     "extractor_pool_requests_total",
                     "extractor_pool_extract_seconds_count",
                     "serving_batches_total", "serving_batch_rows_total",
                     "serving_device_seconds_count",
                     "serving_cache_hits_total", "serving_cache_entries",
                     "serving_admission_depth",
                     "serving_head_dispatch_total"):
            if name not in series:
                fail(f"path: /metrics has no {name}")
    finally:
        server.shutdown()
    stats["hit"] = latency_stats(hit_lat)
    stats["phase_s"] = time.perf_counter() - t_phase
    stats["launches"] = counts
    log(f"path: cache on: a repeated and a re-indented request byte-equal "
        f"to the first (hits +2); {n_hits} hits of Input.java: p50 "
        f"{stats['hit']['p50_ms']:.3f} ms, p99 {stats['hit']['p99_ms']:.3f} "
        f"ms; /metrics ({len(m2)} series) agrees with the requests sent; "
        f"the serving host path took {stats['phase_s']:.1f}s")
    step_gpu_vs_cpu(torch, model, art_dir, extracted, fs, "path", dev)
    summed = {k: counts["dynamic"][k] + counts["continuous"][k]
              for k in counts["dynamic"]}
    return summed, (art_dir, meta), stats


def step_gpu_vs_cpu(torch, model, art_dir: str, extracted, fs, what: str,
                    dev: str = "cuda"):
    """The serving step on the GPU against the same step on the CPU
    (plain versions) on the same padded batch of every extracted method:
    top-k values, code vectors and attention within PATH_REL_TOL of each
    tensor's largest value, loss_sum within TOL_F32SUM, and the top-k
    indices equal away from near-ties."""
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.data.reader import parse_context_lines
    from code2vec_tpu_torch.kernels import label_logits
    from code2vec_tpu_torch.release.runtime import ReleaseModel

    lines = [ln for ls, _ in extracted for ln in ls][:fs.rows]
    batch = model.bucketed_batch(
        parse_context_lines(lines, model.vocabs, model.config.max_contexts),
        fs.rows)
    arrays = [torch.from_numpy(a) for a in batch.model_arrays()]
    cpu = ReleaseModel(Config(serve_artifact=art_dir, device="cpu",
                              verbose_mode=0), artifact=model.artifact)
    got = model.eval_step(*(a.to(dev) for a in arrays))
    want = cpu.eval_step(*arrays)
    n = len(lines)
    errs = {}
    for name in ("topk_values", "code_vectors", "attention"):
        g, w = getattr(got, name)[:n].cpu(), getattr(want, name)[:n]
        tol = (PATH_REL_TOL * float(w.abs().max()), 0.0)
        errs[name], ok = max_err(g, w, tol)
        if not ok:
            fail(f"{what}: GPU vs CPU step: {name} max error "
                 f"{errs[name]} > {tol}")
    errs["loss_sum"], ok = max_err(got.loss_sum.cpu(), want.loss_sum,
                                   TOL_F32SUM)
    if not ok:
        fail(f"{what}: GPU vs CPU step: loss_sum {float(got.loss_sum)} vs "
             f"{float(want.loss_sum)}")
    # each index the GPU returned holds, on the CPU, the logit the GPU
    # gave it; then equal positional values make it a top-k of the CPU's
    # logits, and indices may differ only where the CPU's values tie
    # within that tolerance
    g_idx, w_idx = got.topk_indices[:n].cpu(), want.topk_indices[:n]
    w_val = want.topk_values[:n]
    tol = (PATH_REL_TOL * float(w_val.abs().max()), 0.0)
    table = cpu.params["target_embedding"]
    scales = cpu.params.get("target_embedding_scale")
    at_idx = torch.stack([label_logits.label_logits_plain(
        want.code_vectors[:n], table, g_idx[:, j].contiguous(),
        scales=scales, compute_dtype=torch.bfloat16)
        for j in range(g_idx.shape[1])], dim=1)
    errs["logit_at_index"], ok = max_err(got.topk_values[:n].cpu(), at_idx,
                                         tol)
    same, bad = topk_agreement(g_idx, w_idx, w_val, (2 * tol[0], 0.0))
    if not ok or bad:
        fail(f"{what}: GPU vs CPU step: top-k indices: logits at the "
             f"GPU's indices off by {errs['logit_at_index']}, {bad} "
             f"positions differ away from near-ties")
    log(f"{what}: GPU vs CPU step on {n} methods (bucket "
        f"{batch.context_valid_mask.shape[1]}): top-k indices equal "
        f"{same}/{g_idx.numel()}; max errors "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f" (tolerance {PATH_REL_TOL:.3g} x max|value|; loss_sum "
        f"{TOL_F32SUM})")


# ------------------------------------------------------- train kernel phase

# Tolerances of the train kernels against their plain versions, and why:
# - One bf16 step at the compared tensor's largest value (bf16_step: the
#   spacing of bf16 numbers there, between 2^-8 and 2^-7 of it): K1's
#   output, K5's table and W gradients and K6's dT and da are values the
#   reference rounds to bf16, computed from f32 sums taken in another
#   order (K5: its bf16 hi/lo split of the f32 tanh gradient, and
#   atomics in any order), so a rounding may land one bf16 step away,
#   the largest value's included; a table gradient adds such terms.
# - Beside it, a check that tells the precisions apart (check_flips):
#   where both sides round the same f32 value, an element moves only
#   where the f32 sums' order (or K5's hi/lo split of dpre, 2^-16
#   relative) carries it across a bf16 rounding boundary. On an H100 that
#   moved 0.22% of the elements of K5's table gradients, 0.74% of its
#   d_transform (sums over 204,800 rows) and 0.002% of K6's dT, while a
#   K5 built without dpre's lo plane (dpre in bf16 alone, 2^-8
#   relative) moved 41%. An element counts as moved past FLIP_REL
#   relative (a bf16 step is at least 2^-8); at most FLIP_SHARE of the
#   elements that are nonzero on either side may move (at least
#   FLIP_MIN, for tensors of a few hundred elements).
# - TOL_XENT (atol 1e-7, rtol 1e-5): K7's loss is an f32 sum per row and
#   one over the rows, taken in another order. K7's gradient is held as
#   hi + lo per element (both planes summed), at TOL_XENT_GRAD's rtol
#   4e-5: each side's two bf16 planes carry its f32 g to 2^-16 relative,
#   and where the two sides' g (~1e-6 relative apart: expf and the f32
#   row sum) round lo or hi the other way the sums differ by up to 2^-15
#   (3.05e-5) of g; atol 1e-3 x the median |g|, so that every element is
#   held, the smallest too.
# - TOL_ADAM (atol 1e-7, rtol 1e-6) on parameters: K8 repeats the plain
#   version's operations in order, but the card's division by a scalar
#   (plain version) may differ in the last bit, which moves a parameter
#   by a few f32 ulps of its update (lr x |m / sqrt(v)|, up to ~0.03
#   here), hence the absolute part where the update cancels the
#   parameter. TOL_MOMENT (rtol 2^-7) on the stored moments: equal, or
#   one bf16 step apart where such a bit flips a rounding.
TOL_XENT = (1e-7, 1e-5)
TOL_XENT_GRAD_RTOL = 4e-5
FLIP_REL = 2.0 ** -12
FLIP_SHARE = 0.03
FLIP_MIN = 8
TOL_ADAM = (1e-7, 1e-6)
TOL_MOMENT = (0.0, 2.0 ** -7)


def bf16_step(x: float) -> float:
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    if x == 0 or not math.isfinite(x):
        return 0.0
    return math.ldexp(1.0, math.frexp(abs(x))[1] - 8)


def step_err(got, want):
    """(max |got - want|, ok within one bf16 step at max |want|)."""
    tol = bf16_step(float(want.float().abs().max()))
    err = float((got.float() - want.float()).abs().max())
    return err, err <= tol


def check_flips(got, want, what):
    """The share of elements (nonzero on either side) whose |got - want|
    exceeds FLIP_REL |want|; fails past FLIP_SHARE (or FLIP_MIN
    elements)."""
    g, w = got.float(), want.float()
    live = (g != 0) | (w != 0)
    moved = int((((g - w).abs() > FLIP_REL * w.abs()) & live).sum())
    n = int(live.sum())
    if moved > max(FLIP_SHARE * n, FLIP_MIN):
        fail(f"{what}: {moved} of {n} elements off by more than "
             f"{FLIP_REL:.3g} relative (at most {FLIP_SHARE:.0%} may be)")
    return moved / max(n, 1)


def row_step_err(got, want):
    """(largest |got - want| over one bf16 step at its row's largest
    |want|, rows past that): each row held at its own scale."""
    torch = sys.modules["torch"]
    g, w = got.float(), want.float()
    top = w.abs().amax(dim=1)
    step = torch.ldexp(torch.ones_like(top), torch.frexp(top)[1] - 8)
    step = torch.where(top > 0, step, torch.zeros_like(step))
    err = (g - w).abs().amax(dim=1)
    ratio = err / step.clamp_min(torch.finfo(torch.float32).tiny)
    return float(ratio.max()), int((err > step).sum())


def adam_errors(params, mus, nus, ref_params, ref_mus, ref_nus, what):
    """(max parameter error, max moment error); fails past TOL_ADAM on a
    parameter or TOL_MOMENT on a moment, naming the tensor."""
    err_p = err_m = 0.0
    for i, (x, y) in enumerate(zip(params, ref_params)):
        e, ok = max_err(x, y, TOL_ADAM)
        err_p = max(err_p, e)
        if not ok:
            fail(f"{what}: parameter {i} max error {e} (tol {TOL_ADAM})")
    for name, xs, ys in (("mu", mus, ref_mus), ("nu", nus, ref_nus)):
        for i, (x, y) in enumerate(zip(xs, ys)):
            e, ok = max_err(x, y, TOL_MOMENT)
            err_m = max(err_m, e)
            if not ok:
                fail(f"{what}: {name} {i} max error {e} (tol {TOL_MOMENT})")
    return err_p, err_m


def flagship_train():
    """The flagship train shape: the port's Config defaults (batch 1024,
    200 contexts, dropout keep 0.75, Adam lr 1e-3 with bf16 moments)."""
    from code2vec_tpu_torch.config import Config
    c = Config()
    return types.SimpleNamespace(rows=c.train_batch_size,
                                 contexts=c.max_contexts,
                                 keep=c.dropout_keep_rate,
                                 mu=c.adam_mu_dtype, nu=c.adam_nu_dtype)


def k5_library_full(torch, dt, t, t_lo, tok, path, w, ids, mask, keep,
                    rows):
    """K5's whole function in PyTorch calls (a yardstick, never on the
    port's path): the three gathers from the f32 tables, the bf16 cast and
    dropout on the drawn mask, tanh's rule, the two products on cuBLAS
    (dpre in bf16), dctx rounded and dropped out; then the rows, or
    zeroed tables and three index_add_."""
    td, pd = tok.shape[1], path.shape[1]
    n, d = dt.numel() // dt.shape[-1], dt.shape[-1]
    flat = [i.reshape(-1).long() for i in ids]
    bf16 = torch.bfloat16
    mask = mask.reshape(n, -1)
    scale = torch.tensor(keep, dtype=bf16).float()
    ctx = torch.cat([tok[flat[0]], path[flat[1]], tok[flat[2]]], dim=1)
    ctx = torch.where(mask, (ctx.to(bf16).float() / scale).to(bf16),
                      torch.zeros((), dtype=bf16))
    tv = t.float().view(n, d) + t_lo.float().view(n, d)
    gp = dt.float().view(n, d) * (1 - tv)
    dpre = (gp + gp * tv).to(bf16)
    dctx = torch.mm(dpre, w.to(bf16).T, out_dtype=torch.float32).to(bf16)
    dctx = torch.where(mask, (dctx.float() / scale).to(bf16),
                       torch.zeros((), dtype=bf16))
    dw = torch.mm(ctx.T, dpre, out_dtype=torch.float32).to(bf16).float()
    if rows:
        return (torch.stack([dctx[:, :td], dctx[:, td + pd:]]),
                dctx[:, td:td + pd].contiguous(), dw)
    d_tok = torch.zeros_like(tok)
    d_path = torch.zeros_like(path)
    d_tok.index_add_(0, flat[0], dctx[:, :td].float())
    d_path.index_add_(0, flat[1], dctx[:, td:td + pd].float())
    d_tok.index_add_(0, flat[2], dctx[:, td + pd:].float())
    return d_tok, d_path, dw


def k5_pass_split(torch, timer, timed):
    """The median ms of each K5 pass (`timed` returns one run's, by CUDA
    events) over the timer's samples, the L2 flushed before each."""
    timed()
    runs = []
    for _ in range(timer.samples):
        timer.flush.zero_()
        runs.append(timed())
    return {k: statistics.median(r[k] for r in runs) for k in runs[0]}


def device_passes(torch, fn, passes, calls=10):
    """Mean device microseconds a call of `fn` spends in each pass, by
    torch.profiler over `calls` calls after one more: `passes` maps a
    substring of a kernel's name to the name of its pass. None where the
    profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for pat, name in passes:
            if e.device_time_total > 0 and pat in e.key:
                out[name] = out.get(name, 0.0) + e.device_time_total / calls
                break
    return out or None


K6_PASSES = (("attention_backward_kernel", "main"), ("rows_sum", "da_sum"),
             ("da_sum", "da_sum"))


def k6_bound(t):
    """K6's least time (ms, and what bounds it): T read once and dT
    written once in bf16, the weights and the mask read, dcv read, the
    query read and da written; ~6 flops an element of T."""
    b, m, d = t.shape
    nbytes = 2 * t.numel() * 2 + 2 * b * m * 4 + b * d * 4 + 2 * d * 4
    return bound(nbytes, 6.0 * t.numel())


def k6_library(torch, timer, t, a, mask, dcv):
    """K6's yardstick (ms): the backward alone, by autograd, of K2's
    yardstick, scaled_dot_product_attention with T as key and value, one
    bf16 query a row and the context mask; the forward is run once
    before and not timed."""
    import torch.nn.functional as F
    b, m, d = t.shape
    q = a.to(torch.bfloat16).view(1, 1, 1, d).expand(b, 1, 1, d
                                                     ).contiguous()
    q.requires_grad_(True)
    kv = t.detach().clone().view(b, 1, m, d).requires_grad_(True)
    keep = (mask > 0).view(b, 1, 1, m)
    out = F.scaled_dot_product_attention(q, kv, kv, attn_mask=keep,
                                         scale=1.0)
    dout = dcv.to(torch.bfloat16).view(b, 1, 1, d)
    ms = timer(lambda: torch.autograd.grad(out, (q, kv), dout,
                                           retain_graph=True), spin_ms=10)
    del out, q, kv
    return ms


def k6_case(torch, timer, t, a, mask, attn, dcv, timed=True):
    """K6 on `t` against its plain version: dT and da within one bf16 step
    at their largest and few elements moved past 2^-12 (`check_flips`),
    zeros in dT for every all-masked row, two runs bit-equal; with
    `timed`, timed beside the plain version and `k6_library`, with each
    launch's device time. Returns the report entry."""
    from code2vec_tpu_torch.kernels import attention

    b, m, d = t.shape
    what = f"masked_attention_backward B={b} m={m}"
    got = attention.masked_attention_backward(t, a, mask, attn, dcv)
    again = attention.masked_attention_backward(t, a, mask, attn, dcv)
    want = attention.masked_attention_backward_plain(t, a, mask, attn, dcv)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        fail(f"{what}: two runs gave different bits")
    del again
    dead = (mask > 0).sum(dim=1) == 0
    dead_max = float(got[0][dead].abs().max()) if bool(dead.any()) else 0.
    errs = [step_err(x, y) for x, y in zip(got, want)]
    if not all(ok for _, ok in errs) or dead_max != 0:
        fail(f"{what}: max errors {[e for e, _ in errs]} of largest values "
             f"{[float(y.abs().max()) for y in want]} (tol one bf16 step "
             f"there), all-masked rows' max {dead_max}")
    flips = [check_flips(x, y, f"{what} {name}")
             for x, y, name in zip(got, want, ("dT", "da"))]
    del got, want
    entry = dict(max_abs_err=max(e for e, _ in errs))
    msg = (f"K6 {what}: max_abs_err dT {errs[0][0]:.3g} da {errs[1][0]:.3g} "
           f"(tol one bf16 step at the largest), elements moved "
           f"{flips[0]:.2e} {flips[1]:.2e} (tol {FLIP_SHARE}), "
           f"{int(dead.sum())} all-masked rows zero, two runs bit-equal")
    if timed:
        def run():
            attention.masked_attention_backward(t, a, mask, attn, dcv)

        bms, by = k6_bound(t)
        ms = timer(run)
        plain_ms = timer(lambda: attention.masked_attention_backward_plain(
            t, a, mask, attn, dcv), spin_ms=20)
        lib_ms = k6_library(torch, timer, t, a, mask, dcv)
        split = device_passes(torch, run, K6_PASSES)
        msg += (f"; ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
                f"{lib_ms:.4f} (SDPA backward by autograd) bound_ms "
                f"{bms:.4f} ({by}); launches (us): "
                + (", ".join(f"{k} {v:.1f}" for k, v in split.items())
                   if split else "not measured"))
        entry.update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                     library_ms=lib_ms, pass_us=split)
    log(msg)
    return entry


def train_kernel_phase(torch, seed: int, timer, fs, ft, dev="cuda"):
    from code2vec_tpu_torch.kernels import adam as kadam
    from code2vec_tpu_torch.kernels import attention, encoder
    from code2vec_tpu_torch.kernels import encoder_backward as kbwd
    from code2vec_tpu_torch.kernels import softmax_xent as kxent
    from code2vec_tpu_torch.training.state import DTYPES
    import torch.nn.functional as F

    dev = torch.device(dev)
    g = torch.Generator(device=dev).manual_seed(seed + 1)

    def uniform(shape, limit):
        return (torch.rand(shape, generator=g, device=dev) * 2 - 1) * limit

    v_tok, v_path, v_tgt = (fs.vocab["token"] + 1, fs.vocab["path"] + 1,
                            fs.vocab["target"] + 1)
    td, pd, d = fs.token_dim, fs.path_dim, fs.code_dim
    b, m = ft.rows, ft.contexts
    n = b * m
    tok = uniform((v_tok, td), math.sqrt(3 / td))
    path = uniform((v_path, pd), math.sqrt(3 / pd))
    tgt_table = uniform((v_tgt, d), math.sqrt(3 / d))
    w = uniform((d, d), 1.0)          # pre-activations of std ~1
    a = uniform((d,), 0.25)
    attn_param = uniform((d, 1), 0.25)
    ids = [torch.randint(0, hi, (b, m), generator=g, device=dev,
                         dtype=torch.int32) for hi in (v_tok, v_path, v_tok)]
    report = {}

    def unique_rows_bytes(idx_list, width):
        return torch.unique(torch.cat([i.flatten() for i in idx_list])
                            ).numel() * width * 4

    # K1, train mode: draw through the write-out mode, hold against the
    # plain version on that mask
    k_dim = 2 * td + pd
    drawn = torch.empty((b, m, k_dim), dtype=torch.bool, device=dev)
    step = 3

    def k1(out_mask=None, step=step):
        return encoder.context_encoder(
            tok, None, path, None, w, *ids, residual=True,
            dropout=encoder.Dropout(ft.keep, seed=seed, step=step,
                                    out_mask=out_mask))

    t, t_lo = k1(drawn)
    want, want_lo = encoder.context_encoder_plain(
        tok, None, path, None, w, *ids, residual=True,
        dropout=encoder.Dropout(ft.keep, mask=drawn))
    torch.cuda.synchronize()
    err, ok = max_err(t, want, TOL_K1)
    err_lo, ok_lo = step_err(t.float() + t_lo.float(),
                             want.float() + want_lo.float())
    share = float(drawn.float().mean())
    sigma = math.sqrt(ft.keep * (1 - ft.keep) / drawn.numel())
    again, other = torch.empty_like(drawn), torch.empty_like(drawn)
    k1(again)
    k1(other, step=step + 1)
    torch.cuda.synchronize()
    same, differs = bool(torch.equal(drawn, again)), not torch.equal(
        drawn, other)
    if not (ok and ok_lo) or abs(share - ft.keep) > 5 * sigma \
            or not same or not differs:
        fail(f"context_encoder train: max error {err} (residual {err_lo}), "
             f"kept share {share} (keep {ft.keep}, sigma {sigma}), same "
             f"key same mask {same}, next step another mask {differs}")
    nbytes = (unique_rows_bytes(ids[0:3:2], td) + unique_rows_bytes(
        ids[1:2], pd) + 3 * n * 4 + w.numel() * 4 + 2 * t.numel() * 2)
    bms, by = bound(nbytes, 2.0 * n * k_dim * d)
    ms = timer(lambda: k1())
    plain_ms = timer(lambda: encoder.context_encoder_plain(
        tok, None, path, None, w, *ids, residual=True,
        dropout=encoder.Dropout(ft.keep, mask=drawn)), spin_ms=20)
    lib_ms = timer(lambda: k1_library(torch, tok, None, path, None, w, ids,
                                      drawn, ft.keep, residual=True),
                   spin_ms=5)
    log(f"K1 context_encoder train B={b} m={m} keep={ft.keep}: max_abs_err "
        f"{err:.3g} (tol {TOL_K1}) with residual {err_lo:.3g} (tol one "
        f"bf16 step at the largest value) kept {share:.5f} (5 sigma "
        f"{5 * sigma:.2g}) ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
        f"{lib_ms:.4f} (the whole function in PyTorch calls) bound_ms "
        f"{bms:.4f} ({by})")
    report["context_encoder_train"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        library_ms=lib_ms)

    # K5: against the plain version on the drawn mask; then exact zeros
    # for every dropped element, with every context row its own table row
    dt = (uniform((b, m, d), 0.1)).to(torch.bfloat16)
    drop = encoder.Dropout(ft.keep, seed=seed, step=step)
    got = kbwd.encoder_backward(dt, t, t_lo, tok, path, w, *ids,
                                dropout=drop)
    want = kbwd.encoder_backward_plain(dt, t, t_lo, tok, path, w, *ids,
                                       dropout=encoder.Dropout(ft.keep,
                                                               mask=drawn))
    torch.cuda.synchronize()
    errs5 = [step_err(x, y) for x, y in zip(got, want)]
    if not all(ok for _, ok in errs5):
        fail(f"encoder_backward: max errors {[e for e, _ in errs5]} of "
             f"largest values {[float(y.abs().max()) for y in want]} (tol "
             f"one bf16 step there)")
    flips5 = [check_flips(x, y, f"encoder_backward {name}") for x, y, name
              in zip(got, want, ("d_token", "d_path", "d_transform"))]
    del got, want
    ar = torch.arange(n, dtype=torch.int32, device=dev).view(b, m)
    own = [ar, ar, ar + n]
    t_own, lo_own = encoder.context_encoder(
        tok, None, path, None, w, *own, residual=True,
        dropout=encoder.Dropout(ft.keep, seed=seed, step=step))
    own_mask = torch.empty_like(drawn)
    encoder.context_encoder(tok, None, path, None, w, *own,
                            dropout=encoder.Dropout(ft.keep, seed=seed,
                                                    step=step,
                                                    out_mask=own_mask))
    d_tok, d_path, _ = kbwd.encoder_backward(
        dt, t_own, lo_own, tok, path, w, *own, dropout=drop)
    torch.cuda.synchronize()
    d_ctx = torch.cat([d_tok[:n], d_path[:n], d_tok[n:2 * n]],
                      dim=1).view(b, m, k_dim)
    dropped_nonzero = int(d_ctx[~own_mask].ne(0).sum())
    kept_nonzero = float(d_ctx[own_mask].ne(0).float().mean())
    if dropped_nonzero or kept_nonzero < 0.99:
        fail(f"encoder_backward: {dropped_nonzero} dropped elements got a "
             f"gradient; {kept_nonzero:.4f} of kept ones did")
    del d_tok, d_path, d_ctx, t_own, lo_own, own_mask
    nbytes = (3 * t.numel() * 2 + unique_rows_bytes(ids[0:3:2], td)
              + unique_rows_bytes(ids[1:2], pd) + 3 * n * 4 + w.numel() * 4
              + (tok.numel() + path.numel()) * 4 + w.numel() * 4)
    bms, by = bound(nbytes, 4.0 * n * k_dim * d)
    ms = timer(lambda: kbwd.encoder_backward(dt, t, t_lo, tok, path, w,
                                             *ids, dropout=drop))
    plain_ms = timer(lambda: kbwd.encoder_backward_plain(
        dt, t, t_lo, tok, path, w, *ids,
        dropout=encoder.Dropout(ft.keep, mask=drawn)), spin_ms=50)
    # yardstick: the two products on cuBLAS (bf16 in, f32 out) and three
    # index_add_ into zeroed dense tables
    dpre = (dt.float() * (1 - t.float() ** 2)).to(torch.bfloat16).view(n, d)
    ctx_b = torch.zeros((n, k_dim), dtype=torch.bfloat16, device=dev)
    wb = w.to(torch.bfloat16)
    flat = [i.flatten().long() for i in ids]

    def library():
        dctx = torch.mm(dpre, wb.T, out_dtype=torch.float32)
        torch.mm(ctx_b.T, dpre, out_dtype=torch.float32)
        gt = torch.zeros_like(tok)
        gp = torch.zeros_like(path)
        gt.index_add_(0, flat[0], dctx[:, :td])
        gp.index_add_(0, flat[1], dctx[:, td:td + pd])
        gt.index_add_(0, flat[2], dctx[:, td + pd:])

    lib_ms = timer(library, spin_ms=20)
    del dpre, ctx_b, flat
    full_ms = timer(lambda: k5_library_full(
        torch, dt, t, t_lo, tok, path, w, ids, drawn, ft.keep, rows=False),
        spin_ms=20)
    split = k5_pass_split(torch, timer, lambda: kbwd.pass_times(
        dt, t, t_lo, tok, path, w, *ids, dropout=drop))
    log(f"K5 encoder_backward B={b} m={m} keep={ft.keep}: max_abs_err "
        f"d_token {errs5[0][0]:.3g} d_path {errs5[1][0]:.3g} d_transform "
        f"{errs5[2][0]:.3g} (tol one bf16 step at the largest), elements "
        f"moved {', '.join(f'{x:.2e}' for x in flips5)} (tol "
        f"{FLIP_SHARE}); dropped "
        f"elements with a gradient {dropped_nonzero}, kept with one "
        f"{kept_nonzero:.4f}; ms {ms:.4f} plain_ms {plain_ms:.4f} "
        f"library_ms {lib_ms:.4f} (2 cuBLAS mm + 3 index_add_) "
        f"library_full_ms {full_ms:.4f} (the whole function in PyTorch "
        f"calls) bound_ms {bms:.4f} ({by}); passes "
        + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    report["encoder_backward"] = dict(
        max_abs_err=max(e for e, _ in errs5), ms=ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=lib_ms,
        library_full_ms=full_ms, pass_ms=split)

    # K6: the backward of K2 on K1's train output, then at B 64 and at 1
    # and 32 contexts (row 0 all masked in each)
    mask = (torch.rand((b, m), generator=g, device=dev) > 0.3).float()
    mask[0] = 0.0
    report["masked_attention_train"], _, attn = attention_case(
        torch, timer, t, a, mask)
    dcv = uniform((b, d), 0.05).to(torch.bfloat16).float()
    k6 = report["masked_attention_backward"] = k6_case(
        torch, timer, t, a, mask, attn, dcv)
    for rows, ctx in ((64, m), (b, 1), (b, 32), (64, 1), (64, 32)):
        t_s = t[:rows, :ctx].contiguous()
        mask_s = mask[:rows, :ctx].contiguous()
        _, attn_s = attention.masked_attention(t_s, a, mask_s)
        entry = k6_case(torch, timer, t_s, a, mask_s, attn_s,
                        dcv[:rows].contiguous(), timed=ctx == m)
        k6["max_abs_err"] = max(k6["max_abs_err"], entry.pop("max_abs_err"))
        k6.update({f"b{rows}_m{ctx}_{k}": v for k, v in entry.items()})
        del t_s, mask_s, attn_s
    del t, t_lo, dt, drawn, again, other, attn, mask, dcv

    # K7 at 1024 x 261,246 f32 logits
    logits = torch.randn((b, v_tgt), generator=g, device=dev) * 3
    labels = torch.randint(0, v_tgt, (b,), generator=g, device=dev,
                           dtype=torch.int32)
    valid = torch.ones(b, device=dev)
    valid[1] = 0.0
    loss, grad = kxent.softmax_xent(logits, labels, valid)
    want_loss, want_grad = kxent.softmax_xent_plain(logits, labels, valid)
    torch.cuda.synchronize()
    err_l, ok_l = max_err(loss, want_loss, TOL_XENT)
    zero_row = float(grad[:, 1].abs().max())
    grad = grad[0].float() + grad[1].float()
    want_grad = want_grad[0].float() + want_grad[1].float()
    g_median = float(want_grad.abs().median())
    tol_g = (1e-3 * g_median, TOL_XENT_GRAD_RTOL)
    err_g, ok_g = max_err(grad, want_grad, tol_g)
    if not (ok_l and ok_g) or zero_row != 0:
        fail(f"softmax_xent: loss error {err_l}, gradient error {err_g} "
             f"(tol {tol_g}), valid = 0 row max {zero_row}")
    del grad, want_grad
    nbytes = logits.numel() * 4 + logits.numel() * 2 * 2 + b * 8 + 4
    bms, by = bound(nbytes, 5.0 * logits.numel())
    ms = timer(lambda: kxent.softmax_xent(logits, labels, valid))
    plain_ms = timer(lambda: kxent.softmax_xent_plain(logits, labels, valid),
                     spin_ms=20)
    leaf = logits.clone().requires_grad_(True)
    lab64 = labels.long()

    def library():
        leaf.grad = None
        ((F.cross_entropy(leaf, lab64, reduction="none") * valid).sum()
         / b).backward()

    lib_ms = timer(library, spin_ms=20)
    log(f"K7 softmax_xent B={b} V={v_tgt}: max_abs_err loss {err_l:.3g} "
        f"(tol {TOL_XENT}) gradient hi + lo {err_g:.3g} (tol "
        f"({tol_g[0]:.3g}, {tol_g[1]}), median |g| {g_median:.3g}) ms "
        f"{ms:.4f} plain_ms "
        f"{plain_ms:.4f} library_ms {lib_ms:.4f} bound_ms {bms:.4f} ({by})")
    report["softmax_xent"] = dict(
        max_abs_err=max(err_l, err_g), ms=ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=lib_ms)
    del logits, leaf
    torch.cuda.empty_cache()

    # K8 over the full state: 383.7M f32 parameters, bf16 moments
    hyper = kadam.AdamHyper(mu_dtype=DTYPES[ft.mu], nu_dtype=DTYPES[ft.nu])
    params = [tok, path, tgt_table, w, attn_param]
    grads = [torch.randn(p.shape, generator=g, device=dev) * 1e-3
             for p in params]
    mus = [(torch.randn(p.shape, generator=g, device=dev) * 1e-3).to(
        hyper.mu_dtype) for p in params]
    nus = [(torch.rand(p.shape, generator=g, device=dev) * 1e-6).to(
        hyper.nu_dtype) for p in params]
    ref = [[x.clone() for x in xs] for xs in (params, mus, nus)]
    kadam.adam(params, grads, mus, nus, 7, hyper)
    kadam.adam_plain(ref[0], grads, ref[1], ref[2], 7, hyper)
    torch.cuda.synchronize()
    err8, err_m = adam_errors(params, mus, nus, *ref, "adam")
    del ref
    n_params = sum(p.numel() for p in params)
    msz, nsz = (2 if hyper.mu_dtype == torch.bfloat16 else 4,
                2 if hyper.nu_dtype == torch.bfloat16 else 4)
    nbytes = n_params * (8 + 4 + 2 * msz + 2 * nsz)
    bms, by = bound(nbytes, 15.0 * n_params)
    ms = timer(lambda: kadam.adam(params, grads, mus, nus, 8, hyper))
    plain_ms = timer(lambda: kadam.adam_plain(params, grads, mus, nus, 8,
                                              hyper), spin_ms=50)
    del mus, nus
    torch.cuda.empty_cache()
    lib_params = [p.clone().requires_grad_(True) for p in params]
    for p, gr in zip(lib_params, grads):
        p.grad = gr
    opt = torch.optim.Adam(lib_params, lr=hyper.learning_rate,
                           betas=(hyper.b1, hyper.b2), eps=hyper.eps,
                           fused=True)
    lib_ms = timer(opt.step, spin_ms=20)
    log(f"K8 adam {n_params} params mu {ft.mu} nu {ft.nu}: max_abs_err "
        f"parameters {err8:.3g} (tol {TOL_ADAM}) moments {err_m:.3g} (tol "
        f"{TOL_MOMENT}) ms {ms:.4f} plain_ms {plain_ms:.4f} "
        f"library_ms {lib_ms:.4f} (fused torch.optim.Adam, f32 moments) "
        f"bound_ms {bms:.4f} ({by})")
    report["adam"] = dict(max_abs_err=err8, ms=ms, plain_ms=plain_ms,
                          bound_ms=bms, bound_by=by, library_ms=lib_ms)
    del opt, lib_params, params, grads, tok, path, tgt_table
    torch.cuda.empty_cache()
    return report


# ------------------------------------------------------ sparse kernel phase

# K12's check feeds gradient rows that are bf16 integers times 2^-12
# (|x| <= 127): every partial sum of up to ~64K such rows is exact in f32,
# so the kernel's order of the duplicate sums (fixed 64-row slices) and
# the plain version's (position order) give the same g, and the update is
# then held at K8's tolerance (TOL_ADAM on tables and nu; a bf16 mu equal
# or one bf16 step apart, TOL_MOMENT). The timing uses the same inputs.
# Row sums of K5's row mode against the dense mode's table gradients:
# the same bf16-valued terms added in another order (the dense mode's
# f32 atomics), within 1e-5 of the largest gradient (TOL_ROWSUM).
TOL_ROWSUM_REL = 1e-5
ZIPF_S = 1.07


def zipf_ids(torch, g, n, v, dev):
    """n ids over [0, v) with P(rank r) ~ r^-1.07 (the skew of
    code2vec_tpu/config.py:150), rank r = id r."""
    p = torch.arange(1, v + 1, dtype=torch.float64, device=dev) ** -ZIPF_S
    return torch.multinomial(p / p.sum(), n, replacement=True,
                             generator=g).to(torch.int32)


K12_PASSES = (("sort_", "sort"), ("segment_kernel", "segment"),
              ("combine_kernel", "combine"))


def k12_bound(torch, tables, mu_size):
    """K12's least time (ms, and what bounds it) over `tables`, each (ids,
    rows of the table, width): every id and bf16 gradient row read once,
    and each named row's table, mu (`mu_size` bytes a value) and nu read
    and written once; ~20 flops a value of a named row."""
    nbytes, values = 0, 0
    for idx, v, width in tables:
        uniq = torch.unique(idx[(idx >= 0) & (idx < v)]).numel()
        nbytes += (idx.numel() * (width * 2 + 4)
                   + uniq * width * (2 * 4 + 2 * mu_size + 2 * 4))
        values += uniq * width
    return bound(nbytes, 20.0 * values)


def k12_library(torch, timer, tables, hyper):
    """K12's yardstick (ms): torch.optim.SparseAdam.step over `tables`,
    each (table, ids, bf16 gradient rows), with coalesced COO gradients of
    the same rows (f32 moments)."""
    params = [torch.nn.Parameter(table.clone()) for table, _, _ in tables]
    for p, (_, idx, rows) in zip(params, tables):
        p.grad = torch.sparse_coo_tensor(idx.long()[None, :], rows.float(),
                                         p.shape).coalesce()
    opt = torch.optim.SparseAdam(params, lr=hyper["lr"],
                                 betas=(hyper["b1"], hyper["b2"]),
                                 eps=hyper["eps"])
    ms = timer(opt.step, spin_ms=20)
    del opt, params
    torch.cuda.empty_cache()
    return ms


def sparse_kernel_phase(torch, seed: int, timer, fs, ft, dev="cuda"):
    """K5's row mode and K12 at the flagship train shapes. Returns the
    two kernels' entries and the allocation of each backward mode."""
    from code2vec_tpu_torch.kernels import encoder
    from code2vec_tpu_torch.kernels import encoder_backward as kbwd
    from code2vec_tpu_torch.kernels import sparse_adam as ksa
    from code2vec_tpu_torch.training.sparse_adam import RowAdamSlots
    from code2vec_tpu_torch.training.state import DTYPES

    dev = torch.device(dev)
    g = torch.Generator(device=dev).manual_seed(seed + 3)

    def uniform(shape, limit):
        return (torch.rand(shape, generator=g, device=dev) * 2 - 1) * limit

    v_tok, v_path = fs.vocab["token"] + 1, fs.vocab["path"] + 1
    td, pd, d = fs.token_dim, fs.path_dim, fs.code_dim
    b, m = ft.rows, ft.contexts
    n = b * m
    k_dim = 2 * td + pd
    tok = uniform((v_tok, td), math.sqrt(3 / td))
    path = uniform((v_path, pd), math.sqrt(3 / pd))
    w = uniform((d, d), 1.0)
    ids = [torch.randint(0, hi, (b, m), generator=g, device=dev,
                         dtype=torch.int32) for hi in (v_tok, v_path, v_tok)]
    report = {}

    # K5's row mode on K1's train output with a drawn mask
    drawn = torch.empty((b, m, k_dim), dtype=torch.bool, device=dev)
    drop = encoder.Dropout(ft.keep, seed=seed, step=5)
    t, t_lo = encoder.context_encoder(
        tok, None, path, None, w, *ids, residual=True,
        dropout=encoder.Dropout(ft.keep, seed=seed, step=5,
                                out_mask=drawn))
    dt = uniform((b, m, d), 0.1).to(torch.bfloat16)
    args = (dt, t, t_lo, tok, path, w, *ids)
    allocs = {}
    for mode, fn in (("dense", kbwd.encoder_backward),
                     ("rows", kbwd.encoder_backward_rows)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn(*args, dropout=drop)
        torch.cuda.synchronize()
        allocs[mode] = torch.cuda.max_memory_allocated() - base
        if mode == "dense":
            dense = out
        else:
            got = out
        del out
    want = kbwd.encoder_backward_rows_plain(
        *args, dropout=encoder.Dropout(ft.keep, mask=drawn))
    torch.cuda.synchronize()
    errs = [step_err(x, y) for x, y in zip(got, want)]
    if not all(ok for _, ok in errs):
        fail(f"encoder_backward_rows: max errors {[e for e, _ in errs]} of "
             f"largest values {[float(y.abs().max()) for y in want]} (tol "
             f"one bf16 step there)")
    flips = [check_flips(x, y, f"encoder_backward_rows {name}") for x, y,
             name in zip(got, want, ("token rows", "path rows", "d_transform"))]
    del want
    if not torch.equal(got[2], dense[2]):
        fail("encoder_backward_rows: d_transform differs from the dense "
             "mode's")
    sums = torch.zeros_like(tok).index_add_(
        0, torch.cat([ids[0].flatten(), ids[2].flatten()]).long(),
        got[0].reshape(-1, td).float())
    psums = torch.zeros_like(path).index_add_(
        0, ids[1].flatten().long(), got[1].reshape(-1, pd).float())
    err_sum = max(float((sums - dense[0]).abs().max()),
                  float((psums - dense[1]).abs().max()))
    tol_sum = TOL_ROWSUM_REL * max(float(dense[0].abs().max()),
                                   float(dense[1].abs().max()))
    del sums, psums, dense
    if err_sum > tol_sum:
        fail(f"encoder_backward_rows: rows summed by id off the dense "
             f"mode's table gradients by {err_sum} > {tol_sum}")
    table_bytes = (tok.numel() + path.numel()) * 4
    row_bytes = sum(x.numel() * x.element_size() for x in got[:2])
    saved = allocs["dense"] - allocs["rows"]
    if saved < table_bytes - row_bytes:
        fail(f"encoder_backward_rows allocates {allocs['rows']} bytes, the "
             f"dense mode {allocs['dense']}: {saved} fewer, expected at "
             f"least the table gradients less the rows "
             f"({table_bytes - row_bytes})")

    def unique_rows_bytes(idx_list, width):
        return torch.unique(torch.cat([i.flatten() for i in idx_list])
                            ).numel() * width * 4

    nbytes = (3 * t.numel() * 2 + unique_rows_bytes(ids[0:3:2], td)
              + unique_rows_bytes(ids[1:2], pd) + 3 * n * 4 + w.numel() * 4
              + row_bytes + w.numel() * 4)
    bms, by = bound(nbytes, 4.0 * n * k_dim * d)
    ms = timer(lambda: kbwd.encoder_backward_rows(*args, dropout=drop))
    plain_ms = timer(lambda: kbwd.encoder_backward_rows_plain(
        *args, dropout=encoder.Dropout(ft.keep, mask=drawn)), spin_ms=50)
    # yardstick: the two products on cuBLAS (bf16 in, f32 out)
    dpre = (dt.float() * (1 - t.float() ** 2)).to(torch.bfloat16).view(n, d)
    ctx_b = torch.zeros((n, k_dim), dtype=torch.bfloat16, device=dev)
    wb = w.to(torch.bfloat16)
    lib_ms = timer(lambda: (torch.mm(dpre, wb.T, out_dtype=torch.float32),
                            torch.mm(ctx_b.T, dpre,
                                     out_dtype=torch.float32)), spin_ms=20)
    del dpre, ctx_b
    full_ms = timer(lambda: k5_library_full(
        torch, dt, t, t_lo, tok, path, w, ids, drawn, ft.keep, rows=True),
        spin_ms=20)
    split = k5_pass_split(torch, timer, lambda: kbwd.pass_times(
        *args, rows=True, dropout=drop))
    del got, t, t_lo, dt, drawn
    log(f"K5 encoder_backward row mode B={b} m={m} keep={ft.keep}: "
        f"max_abs_err token rows {errs[0][0]:.3g} path rows "
        f"{errs[1][0]:.3g} d_transform {errs[2][0]:.3g} (tol one bf16 step "
        f"at the largest), elements moved "
        f"{', '.join(f'{x:.2e}' for x in flips)} (tol {FLIP_SHARE}); rows "
        f"summed by id vs the dense mode {err_sum:.3g} (tol {tol_sum:.3g}); "
        f"allocates {allocs['rows'] / 1e9:.3f} GB (dense mode "
        f"{allocs['dense'] / 1e9:.3f} GB); ms {ms:.4f} plain_ms "
        f"{plain_ms:.4f} library_ms {lib_ms:.4f} (2 cuBLAS mm) "
        f"library_full_ms {full_ms:.4f} (the whole function in PyTorch "
        f"calls) bound_ms {bms:.4f} ({by}); passes "
        + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    report["encoder_backward_rows"] = dict(
        max_abs_err=max(e for e, _ in errs), ms=ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=lib_ms,
        library_full_ms=full_ms, pass_ms=split,
        alloc_gb=allocs["rows"] / 1e9, dense_alloc_gb=allocs["dense"] / 1e9)
    torch.cuda.empty_cache()

    # K12 on both tables in one call, as the sparse step makes it: ids
    # uniform and Zipf(1.07) over the real sizes (timed), every id the
    # same, and a quarter of the ids out of range
    mu_dtype = DTYPES[ft.mu]
    hyper = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)
    tables = {"token": (v_tok, 2 * n), "path": (v_path, n)}
    states = {}
    for name, (v, _) in tables.items():
        p0 = uniform((v, 128), math.sqrt(3 / 128))
        m0 = (torch.randn((v, 128), generator=g, device=dev) * 1e-3
              ).to(mu_dtype)
        n0 = torch.rand((v, 128), generator=g, device=dev) * 1e-6
        states[name] = (p0, m0, n0)

    def case_ids(dist, v, cnt):
        if dist == "zipf":
            return zipf_ids(torch, g, cnt, v, dev)
        idx = torch.randint(0, v, (cnt,), generator=g, device=dev,
                            dtype=torch.int32)
        if dist == "same":
            return idx[:1].expand(cnt).contiguous()
        if dist == "out_of_range":
            bad = torch.tensor([-1, v, v + 7, 2 ** 31 - 1], device=dev,
                               dtype=torch.int32)
            pick = torch.randint(0, 4, (cnt,), generator=g, device=dev)
            out = torch.rand((cnt,), generator=g, device=dev) < 0.25
            idx = torch.where(out, bad[pick], idx)
        return idx

    def fresh(case):
        return [(states[name][0].clone(), RowAdamSlots(
            mu=states[name][1].clone(), nu=states[name][2].clone()),
            *case[name]) for name in tables]

    k12 = {}
    for dist in ("uniform", "zipf", "same", "out_of_range"):
        case = {}
        for name, (v, cnt) in tables.items():
            rows = (torch.randint(-127, 128, (cnt, 128), generator=g,
                                  device=dev).float() * 2.0 ** -12
                    ).to(torch.bfloat16)
            case[name] = (case_ids(dist, v, cnt), rows)
        runs = []
        for _ in range(2):
            work = fresh(case)
            ksa.sparse_adam_tables(work, t=7, **hyper)
            runs.append(work)
        errs_p, errs_m, uniq = [], [], {}
        for i, (name, (v, _)) in enumerate(tables.items()):
            (got_p, got_s, idx, rows), (p2, s2, _, _) = runs[0][i], runs[1][i]
            if not (torch.equal(got_p, p2) and torch.equal(got_s.mu, s2.mu)
                    and torch.equal(got_s.nu, s2.nu)):
                fail(f"sparse_adam {name} {dist}: two runs gave different "
                     f"bits")
            p0, m0, n0 = states[name]
            p, slots = p0.clone(), RowAdamSlots(mu=m0.clone(), nu=n0.clone())
            ksa.sparse_adam_plain(p, slots, idx, rows, t=7, **hyper)
            torch.cuda.synchronize()
            touched = torch.zeros(v, dtype=torch.bool, device=dev)
            touched[idx[(idx >= 0) & (idx < v)].long()] = True
            uniq[name] = int(touched.sum())
            for x, x0 in ((got_p, p0), (got_s.mu, m0), (got_s.nu, n0)):
                if not torch.equal(x[~touched], x0[~touched]):
                    fail(f"sparse_adam {name} {dist}: an untouched row "
                         f"changed")
            e, ok = max_err(got_p[touched], p[touched], TOL_ADAM)
            en, ok_n = max_err(got_s.nu[touched], slots.nu[touched],
                               TOL_ADAM)
            em, ok_m = max_err(got_s.mu[touched], slots.mu[touched],
                               TOL_MOMENT)
            if not (ok and ok_n and ok_m):
                fail(f"sparse_adam {name} {dist}: max errors table {e} nu "
                     f"{en} (tol {TOL_ADAM}) mu {em} (tol {TOL_MOMENT})")
            errs_p.append(max(e, en))
            errs_m.append(em)
            del p, slots, touched
        del runs
        msg = (f"K12 sparse_adam {dist} ids, both tables in one call: token "
               f"{tables['token'][1]} ids -> {uniq['token']} unique rows of "
               f"{tables['token'][0]}, path {tables['path'][1]} ids -> "
               f"{uniq['path']} unique rows of {tables['path'][0]}; mu "
               f"{ft.mu}: max_abs_err table/nu {max(errs_p):.3g} (tol "
               f"{TOL_ADAM}) mu {max(errs_m):.3g} (tol {TOL_MOMENT}); "
               f"untouched rows bit-equal, two runs bit-equal")
        entry = dict(max_abs_err=max(errs_p), unique_rows=sum(uniq.values()))
        if dist in ("uniform", "zipf"):
            work = fresh(case)
            bms, by = k12_bound(torch, [(idx, v, 128) for (idx, _), (v, _)
                                        in zip(case.values(),
                                               tables.values())],
                                2 if mu_dtype == torch.bfloat16 else 4)

            def run():
                ksa.sparse_adam_tables(work, t=7, **hyper)

            def run_plain():
                for p, slots, idx, rows in work:
                    ksa.sparse_adam_plain(p, slots, idx, rows, t=7, **hyper)

            ms = timer(run)
            plain_ms = timer(run_plain, spin_ms=20)
            lib_ms = k12_library(torch, timer, [
                (states[name][0], *case[name]) for name in tables], hyper)
            split = device_passes(torch, run, K12_PASSES)
            del work
            msg += (f"; ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
                    f"{lib_ms:.4f} (torch.optim.SparseAdam, f32 moments) "
                    f"bound_ms {bms:.4f} ({by}); passes (us): "
                    + (", ".join(f"{k} {v:.1f}" for k, v in split.items())
                       if split else "not measured"))
            entry.update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         library_ms=lib_ms, pass_us=split)
        log(msg)
        k12[dist] = entry
        torch.cuda.empty_cache()
    report["sparse_adam"] = dict(k12["uniform"])
    report["sparse_adam"].update({f"zipf_{k}": v
                                  for k, v in k12["zipf"].items()})
    report["sparse_adam"]["max_abs_err"] = max(
        e["max_abs_err"] for e in k12.values())
    del states, tok, path, w, ids
    torch.cuda.empty_cache()
    return report


# --------------------------------------------------------- train path phase


def write_train_corpus(work_dir: str, seed: int, fs, ft, n_rows: int,
                       n_names: int = 64, tokens_per_name: int = 64,
                       stems=("t", "p", "name|w"), with_dict: bool = True,
                       name: str = "corpus"):
    """PREFIX.dict.c2v with the java14m vocabulary sizes (unless
    `with_dict` is false) and PREFIX.train.c2v (PREFIX: `name` under
    `work_dir`) of `n_rows` methods whose
    name follows their tokens (the pattern of tests/test_end_to_end.py at
    full width): each of `n_names` names owns `tokens_per_name` tokens
    spread over the token vocabulary; paths are drawn from the whole path
    vocabulary. Words are `stems` + their vocabulary index."""
    import pickle

    import numpy as np

    rng = np.random.default_rng(seed)
    v_tok, v_path, v_tgt = (fs.vocab["token"], fs.vocab["path"],
                            fs.vocab["target"])
    st, sp, sn = stems
    prefix = os.path.join(work_dir, name)
    if with_dict:
        with open(prefix + ".dict.c2v", "wb") as f:
            # descending counts: the vocabulary order is the word order
            pickle.dump({f"{st}{i}": v_tok - i for i in range(v_tok)}, f)
            pickle.dump({f"{sp}{i}": v_path - i for i in range(v_path)}, f)
            pickle.dump({f"{sn}{i}": v_tgt - i for i in range(v_tgt)}, f)
            pickle.dump(n_rows, f)
    owned = rng.choice(v_tok, size=(n_names, tokens_per_name), replace=False)
    names = rng.integers(0, n_names, n_rows)
    m = ft.contexts
    # the words of the owned tokens and of every path, formatted once
    tok_words = {int(i): f"{st}{i}" for i in owned.ravel()}
    path_words = [f"{sp}{i}" for i in range(v_path)]
    with open(prefix + ".train.c2v", "w", buffering=16 * 2 ** 20) as f:
        for r in range(n_rows):
            toks = owned[names[r]][rng.integers(0, tokens_per_name, (2, m))]
            pths = rng.integers(0, v_path, m).tolist()
            ctx = " ".join([f"{tok_words[a]},{path_words[b]},{tok_words[c]}"
                            for a, b, c in zip(toks[0].tolist(), pths,
                                               toks[1].tolist())])
            f.write(f"{sn}{names[r] * 997 % v_tgt} {ctx}\n")
    return prefix


def train_path_phase(torch, seed: int, work_dir: str, fs, ft,
                     epochs: int = 2, steps_per_epoch: int = 4,
                     dev: str = "cuda", sparse: bool = False,
                     lifecycle: bool = False):
    """The `train` command (with --sparse_embedding_update when `sparse`)
    on the synthetic corpus under `work_dir` (written by the first call):
    the epochs' losses, one launch per step of each kernel of the step,
    then a steady step's time, examples/s and peak device memory. With
    `lifecycle`, the run also saves and evaluates (--save, --test), and
    lifecycle_phase checks what it left before the steady step; its
    stats then carry the first save's stall (save_stall) and the steps'
    losses, for ops_phase. Returns (the launch counts of the run, its
    stats)."""
    import numpy as np

    from code2vec_tpu_torch import cli, kernels
    from code2vec_tpu_torch.evaluation.evaluator import batch_to_device
    from code2vec_tpu_torch.model_facade import Code2VecModel
    from code2vec_tpu_torch.training import checkpoint as ckpt
    from code2vec_tpu_torch.training.state import SPARSE_PARAM_NAMES

    # The packed reader's epoch is a permutation of all rows: rows/16
    # methods beyond 4 x 1024 give each epoch 4 full batches, its ragged
    # tail dropped. (So does the text reader's shuffle buffer of rows/16
    # lines, where --no_packed_data asks for it.)
    buffer = max(ft.rows // 16, 1)
    n_rows = steps_per_epoch * ft.rows + buffer
    what = "sparse train" if sparse else "train"
    prefix = os.path.join(work_dir, "corpus")
    if not os.path.isfile(prefix + ".train.c2v"):
        t0 = time.perf_counter()
        prefix = write_train_corpus(work_dir, seed, fs, ft, n_rows)
        log(f"train: wrote a {n_rows}-method corpus with java14m "
            f"vocabularies in {time.perf_counter() - t0:.1f}s")
    argv = ["train", "--data", prefix, "--epochs", str(epochs), "--seed",
            str(seed), "--batch_size", str(ft.rows), "--max_contexts",
            str(ft.contexts), "--device", dev]
    if sparse:
        argv.append("--sparse_embedding_update")
    base = os.path.join(work_dir, "ckpt", "model")
    test = os.path.join(work_dir, "test.train.c2v")
    if lifecycle:
        t0 = time.perf_counter()
        # the same seed: the same names own the same tokens, the methods
        # past the names' draw are others
        write_train_corpus(work_dir, seed, fs, ft, LIFECYCLE_TEST_ROWS,
                           with_dict=False, name="test")
        log(f"lifecycle: wrote a {LIFECYCLE_TEST_ROWS}-method test corpus "
            f"in {time.perf_counter() - t0:.1f}s")
        argv += ["--save", base, "--test", test, "--eval_log",
                 os.path.join(work_dir, "train_eval.log")]
    _, config = cli.config_from_args(argv)
    config.shuffle_buffer_size = buffer
    config.verbose_mode = 0
    t0 = time.perf_counter()
    model = Code2VecModel(config)   # what `cli.main(argv)` runs
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.module.parameters())
    log(f"{what}: built vocabularies and a {n_params}-"
        f"parameter model on {model.device} in "
        f"{time.perf_counter() - t0:.1f}s")
    timed_pack(model, config.train_data_path, what)
    if lifecycle:
        timed_pack(model, test, what)
    # the saves' and the evaluations' host seconds, and each evaluation's
    # launches; each step's start (the save stall: save start to the next
    # step's start, less the evaluation between)
    saves, evals, step_starts, spans = [], [], [], []
    save_model, evaluate = ckpt.save_model, model._evaluate_with_params

    def timed_save(*args, **kw):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = save_model(*args, **kw)
        saves.append((out, time.perf_counter() - t1))
        spans.append(("save", t1, time.perf_counter()))
        return out

    def timed_eval(params):
        torch.cuda.synchronize()
        before = kernels.launch_counts()
        t1 = time.perf_counter()
        res = evaluate(params)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        evals.append((res, time.perf_counter() - t1,
                      {k: after[k] - before[k] for k in after}))
        spans.append(("eval", t1, time.perf_counter()))
        return res

    ckpt.save_model, model._evaluate_with_params = timed_save, timed_eval
    marked_steps(model, step_starts)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        model.train()
        torch.cuda.synchronize()
    finally:
        ckpt.save_model = save_model
        del model._evaluate_with_params   # the wrapper held the model
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    # the epoch-end evaluations' K1 and K2 launches are not the steps'
    eval_launches = {k: sum(e[2][k] for e in evals) for k in counts}
    losses = model.trainer.epoch_losses
    steps = model.state.step
    means = [statistics.mean(e) if e else float("nan") for e in losses]
    log(f"{what}: {epochs} epochs, {steps} steps in {wall:.1f}s; losses "
        f"{[round(x, 4) for e in losses for x in e]}; epoch means "
        f"{[round(x, 4) for x in means]}; kernel launches {counts}")
    if len(losses) != epochs or any(len(e) != steps_per_epoch
                                    for e in losses):
        fail(f"{what}: epochs of {[len(e) for e in losses]} steps, "
             f"expected {epochs} of {steps_per_epoch}")
    if not all(math.isfinite(x) for e in losses for x in e):
        fail(f"{what}: a loss is not finite")
    if not means[1] < means[0]:
        fail(f"{what}: the second epoch's mean loss {means[1]} is not below "
             f"the first's {means[0]}")
    names = (kernels.SPARSE_TRAIN_KERNELS if sparse
             else kernels.TRAIN_KERNELS)
    want = {k: steps for k in names}  # K12: both tables in one launch
    if sparse:  # no dense K5: no table-shaped gradient
        want["encoder_backward"] = 0
    train_counts = {k: counts[k] - eval_launches[k] for k in want}
    if train_counts != want:
        fail(f"{what}: launches {train_counts}, expected {want} (one per "
             f"step, K12 once per table)")
    if sparse:
        dense_names = sorted(model.state.opt_state.dense.mu)
        if dense_names != ["attention", "target_embedding", "transform"] or \
                any(model.state.params[k].grad is not None
                    for k in SPARSE_PARAM_NAMES):
            fail(f"{what}: K8 ran over {dense_names}, or a table got a "
                 f"gradient")

    stats = {}
    if lifecycle:
        # the first epoch-end save's stall and the steps' losses, for the
        # operations phase
        stall = save_stall(spans, step_starts)
        step_losses = [list(e) for e in losses]
        model, stats = lifecycle_phase(torch, seed, work_dir, fs, ft, model,
                                       config, base, test, saves, evals, dev)
        stats.update(stall_s=stall, losses=step_losses)
    # a steady step on one batch: host clock around synchronised steps
    arrays = batch_to_device(model._train_corpus().gather(
        np.arange(ft.rows)), model.device)
    step_fn = model.builder.make_train_step(model.state)
    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model.state, loss = step_fn(model.state, *arrays, seed)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    step_ms = statistics.median(times[1:]) * 1e3
    # peak device memory of one step: in all, and above the memory held
    # before it (parameters, optimizer state, the batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    model.state, loss = step_fn(model.state, *arrays, seed)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"{what}: steady step {step_ms:.2f} ms (median of 5, host clock "
        f"around synchronised steps), {ft.rows / step_ms * 1e3:.0f} "
        f"examples/s; peak device memory {peak / 1e9:.3f} GB, "
        f"{(peak - held) / 1e9:.3f} GB above the {held / 1e9:.3f} GB held "
        f"between steps")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return counts, dict(step_ms=step_ms, examples_per_s=ft.rows / step_ms
                        * 1e3, epoch_means=means, peak_gb=peak / 1e9,
                        step_gb=(peak - held) / 1e9, held_gb=held / 1e9,
                        **stats)


LIFECYCLE_TEST_ROWS = 2048   # two batches at test_batch_size 1024
# the int8 artifact's top-1 agreement with the float32 one it was
# exported beside: the evaluate phase's int8 artifact agreed with float32
# on 0.9819 of its rows (measured on one H100), on random weights as here
INT8_AGREEMENT_BAR = 0.95


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def lifecycle_phase(torch, seed: int, work_dir: str, fs, ft, model, config,
                    base: str, test: str, saves, evals, dev: str = "cuda"):
    """What the `train --save BASE --test TEST` run of train_path_phase
    left, at full width: BASE_iter1, BASE_iter2 and BASE verify, and the
    two epoch-end evaluations launched each of K1-K4 once per batch with
    finite metrics; BASE loaded as `serve --load BASE` builds it is bit
    for bit the live state, and answers one /predict through K1-K4;
    `evaluate --load BASE --release` writes BASE.release (no optimizer
    state); `train --load BASE_iter1` runs epoch 2 (one epoch of the same
    steps, finite losses), and BASE.release loaded params-only into it
    gives back BASE's params; `export --load BASE` as float32
    (--no_quantize) and int8: `evaluate --artifact` of the float32 one
    gives the epoch-2 evaluation's metrics and log lines exactly (the
    same kernels on the same tables), the int8 one's top-1 agrees with it
    on at least INT8_AGREEMENT_BAR of the rows. Save, load and export
    seconds (host clock, warm page cache), bytes and eval examples/s are
    printed. BASE (step 8) is left for ops_phase, as stats["step8"].
    Returns (model, stats)."""
    import numpy as np

    from code2vec_tpu_torch import cli, kernels
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.data.reader import (
        EstimatorAction, PathContextReader,
    )
    from code2vec_tpu_torch.model_facade import Code2VecModel
    from code2vec_tpu_torch.release.runtime import ReleaseModel
    from code2vec_tpu_torch.serving.server import PredictionServer
    from code2vec_tpu_torch.training import checkpoint as ckpt

    ctx = str(ft.contexts)
    paths = [base + "_iter1", base + "_iter2", base]
    if [p for p, _ in saves] != paths:
        fail(f"lifecycle: saves {[p for p, _ in saves]}, expected {paths}")
    for p in paths:
        ckpt.verify_checkpoint(p)
    ckpt_bytes = dir_bytes(base)
    batches = -(-LIFECYCLE_TEST_ROWS // config.test_batch_size)
    if [e for e, _ in model.trainer.eval_results] != [1, 2] or \
            len(evals) != 2:
        fail(f"lifecycle: evaluations after epochs "
             f"{[e for e, _ in model.trainer.eval_results]}, expected [1, 2]")
    for res, _, launched in evals:
        got = {k: launched[k] for k in SERVE_KERNELS}
        if got != dict.fromkeys(SERVE_KERNELS, batches):
            fail(f"lifecycle: an evaluation launched {got}, expected "
                 f"{batches} of each (one a batch)")
        if not (np.isfinite(res.loss) and np.isfinite(res.topk_acc).all()
                and np.isfinite(res.subtoken_f1)):
            fail(f"lifecycle: evaluation {res}")
    eval_eps = [LIFECYCLE_TEST_ROWS / secs for _, secs, _ in evals]
    log(f"lifecycle: saved {[os.path.basename(p) for p in paths]} in "
        f"{[round(t, 2) for _, t in saves]} s, {ckpt_bytes / 1e9:.3f} GB "
        f"each; epoch-end evaluations of {LIFECYCLE_TEST_ROWS} methods at "
        f"{[round(x) for x in eval_eps]} examples/s, K1-K4 {batches} each; "
        f"after epoch 2: {evals[-1][0]}")
    shutil.rmtree(base + "_iter2")

    # `serve --load BASE`: the state it restores, then one /predict
    _, scfg = cli.config_from_args(["serve", "--load", base,
                                    "--max_contexts", ctx, "--device", dev])
    scfg.verbose_mode = 0
    t0 = time.perf_counter()
    loaded = Code2VecModel(scfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt.load_model(base, loaded.state, config=scfg)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    live, got = (ckpt.state_leaves(m.state) for m in (model, loaded))
    bad = [k for k, x in live.items()
           if not (torch.equal(x, got[k]) if isinstance(x, torch.Tensor)
                   else x == got[k])]
    if bad or loaded.initial_epoch != 2:
        fail(f"lifecycle: the loaded state differs from the saved one in "
             f"{bad[:5]} (epoch {loaded.initial_epoch})")
    log(f"lifecycle: `serve --load` built its model in {build_s:.2f}s; "
        f"load_model alone {load_s:.2f}s ({ckpt_bytes / 1e9 / load_s:.2f} "
        f"GB/s); all {len(live)} leaves (params, mu, nu, step, count) "
        f"bit-equal to the live state")
    loaded.warmup()
    server = PredictionServer(loaded)
    url = f"http://127.0.0.1:{server.start(port=0)}"
    try:
        with open(os.path.join(REPO, "Input.java")) as f:
            source = f.read()
        kernels.reset_launch_counts()
        status, body, dt = post(f"{url}/predict", source)
        counts = kernels.launch_counts()
    finally:
        server.shutdown()
    if status != 200:
        fail(f"lifecycle: /predict from --load: HTTP {status}")
    check_predict_body(body, loaded.model_fingerprint())
    served = {k: counts[k] for k in SERVE_KERNELS}
    if not all(served.values()):
        fail(f"lifecycle: /predict from --load launched {served}")
    log(f"lifecycle: /predict of Input.java from --load in "
        f"{dt * 1e3:.1f} ms, launches {served}, fingerprint "
        f"{loaded.model_fingerprint()}")
    mips_s = mips_from_load(torch, base, ctx, source, body, test, dev)
    del loaded, server, live, got
    gc.collect()
    torch.cuda.empty_cache()

    # --release
    t0 = time.perf_counter()
    cli.main(["evaluate", "--load", base, "--release", "--max_contexts",
              ctx, "--device", dev])
    release_s = time.perf_counter() - t0
    rel = base + ckpt.RELEASED_SUFFIX
    meta = ckpt.verify_checkpoint(rel)
    tree = ckpt.load_manifest(rel)["param_tree"]
    if not meta["released"] or any(k.startswith("opt_state") for k in tree):
        fail(f"lifecycle: {rel} holds {sorted(tree)}")
    release_bytes = dir_bytes(rel)

    # `train --load BASE_iter1`: epoch 2 again
    argv = ["train", "--data", config.train_data_path_prefix, "--epochs",
            "2", "--seed", str(seed), "--batch_size", str(ft.rows),
            "--max_contexts", ctx, "--load", base + "_iter1", "--device", dev]
    _, rcfg = cli.config_from_args(argv)
    rcfg.shuffle_buffer_size, rcfg.verbose_mode = config.shuffle_buffer_size, 0
    resumed = Code2VecModel(rcfg)
    if resumed.initial_epoch != 1:
        fail(f"lifecycle: --load {base}_iter1 restored epoch "
             f"{resumed.initial_epoch}")
    resumed.train()
    losses = resumed.trainer.epoch_losses
    if resumed.trainer.final_epoch != 2 or len(losses) != 1 or \
            len(losses[0]) != len(model.trainer.epoch_losses[1]) or \
            not all(math.isfinite(x) for x in losses[0]):
        fail(f"lifecycle: the resumed run ended at epoch "
             f"{resumed.trainer.final_epoch} with losses {losses}")
    ckpt.load_model(rel, resumed.state, params_only=True)
    bad = [k for k, p in model.state.params.items()
           if not torch.equal(resumed.state.params[k], p)]
    if bad or resumed.state.step != model.state.step:
        fail(f"lifecycle: {rel} loaded params-only differs in {bad}")
    log(f"lifecycle: `evaluate --load --release` in {release_s:.2f}s, "
        f"{release_bytes / 1e9:.3f} GB without optimizer state; `train "
        f"--load {os.path.basename(base)}_iter1` ran epoch 2 "
        f"({len(losses[0])} steps, losses "
        f"{[round(x, 4) for x in losses[0]]}; the first run's "
        f"{[round(x, 4) for x in model.trainer.epoch_losses[1]]}); the "
        f"released params loaded params-only bit-equal to the saved ones")
    del resumed
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(base + "_iter1")
    shutil.rmtree(rel)

    # export, float32 and int8, and int8 with the head crossover
    # calibrated (--serve_mips_nprobe 16)
    arts, export_s, metas = {}, {}, {}
    for scheme, flags in (("float32", ["--no_quantize"]),
                          ("int8", ["--release_scheme", "int8"]),
                          ("int8-mips", ["--release_scheme", "int8",
                                         "--serve_mips_nprobe", "16"])):
        arts[scheme] = os.path.join(work_dir, f"export-{scheme}")
        t0 = time.perf_counter()
        meta = cli.main(["export", "--load", base, "--artifact_out",
                         arts[scheme], "--max_contexts", ctx, "--device",
                         dev] + flags)
        export_s[scheme] = time.perf_counter() - t0
        metas[scheme] = meta
        if meta["source"] != {"checkpoint": base,
                              "step": int(model.state.step), "epoch": 2}:
            fail(f"lifecycle: export {scheme} source {meta['source']}")
    crossover = adopt_crossover(torch, arts["int8-mips"], metas, test, dev)
    shutil.rmtree(arts.pop("int8-mips"))
    log32 = os.path.join(work_dir, "a32_eval.log")
    kernels.reset_launch_counts()
    res = cli.main(["evaluate", "--artifact", arts["float32"], "--test",
                    test, "--test_batch_size", str(config.test_batch_size),
                    "--eval_log", log32, "--device", dev])
    want = evals[-1][0]
    with open(log32) as f, \
            open(os.path.join(work_dir, "train_eval.log")) as g:
        same_log = f.read() == g.read()
    if not (np.array_equal(res.topk_acc, want.topk_acc)
            and (res.subtoken_precision, res.subtoken_recall,
                 res.subtoken_f1, res.loss)
            == (want.subtoken_precision, want.subtoken_recall,
                want.subtoken_f1, want.loss) and same_log):
        fail(f"lifecycle: evaluate --artifact (float32) {res} (log.txt "
             f"equal: {same_log}) against the epoch-end {want}")
    models = {k: ReleaseModel(Config(serve_artifact=a, device=dev,
                                     verbose_mode=0))
              for k, a in arts.items()}
    top1 = {k: [] for k in models}
    for batch in PathContextReader(models["int8"].vocabs,
                                   models["int8"].config,
                                   EstimatorAction.Evaluate, data_path=test,
                                   batch_size=1024):
        arrays = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                       for a in batch.model_arrays())
        for k, m in models.items():
            out = m.eval_step(*arrays)
            top1[k].append(out.topk_indices[:, 0].cpu().numpy()[
                batch.example_valid])
    agree = float(np.mean(np.concatenate(top1["int8"])
                          == np.concatenate(top1["float32"])))
    log(f"lifecycle: export --load in {export_s['float32']:.2f}s (float32, "
        f"{dir_bytes(arts['float32']) / 1e9:.3f} GB) and "
        f"{export_s['int8']:.2f}s (int8, {dir_bytes(arts['int8']) / 1e9:.3f}"
        f" GB); evaluate --artifact float32 equal to the epoch-end "
        f"evaluation ({res}), log lines equal; int8 top-1 agrees with "
        f"float32 on {agree:.4f} of {LIFECYCLE_TEST_ROWS} rows (bar "
        f"{INT8_AGREEMENT_BAR})")
    if agree < INT8_AGREEMENT_BAR:
        fail(f"lifecycle: int8 top-1 agreement {agree} < "
             f"{INT8_AGREEMENT_BAR}")
    del models
    for a in arts.values():
        shutil.rmtree(a)
    # BASE (step 8) stays for ops_phase's resumed state, which removes it
    gc.collect()
    torch.cuda.empty_cache()
    return model, dict(save_s=[t for _, t in saves], ckpt_gb=ckpt_bytes / 1e9,
                       load_s=load_s, build_s=build_s, export_s=export_s,
                       mips_s=mips_s, crossover=crossover,
                       calibration=metas["int8-mips"]["mips_calibration"],
                       release_s=release_s, release_gb=release_bytes / 1e9,
                       eval_eps=eval_eps, int8_agreement=agree,
                       step8=base)


def mips_from_load(torch, base: str, ctx: str, source: str, exact_body,
                   test: str, dev: str = "cuda", rows: int = 64) -> dict:
    """`serve --load BASE --serve_mips_nprobe 16`: the MIPS head built
    over the live 261,245 x 384 target table (K9, K10) answers /predict
    of Input.java through K11, checked as a /predict body beside the
    exact head's (`exact_body`). On the code vectors of the first `rows`
    methods of `test` (the model's own vocabulary: Input.java's words
    are not in it, so its code vector is 0), the head over every list is
    the exact head (mips_against_exact's precision check), and at nprobe
    16 each row's top-1 is the exact head's unless the exact top-1 row
    lies in no probed list or is a near-tie. Returns the head's build and
    warm-up seconds, the top-1 agreement and the launch counts."""
    import numpy as np

    from code2vec_tpu_torch import cli, kernels
    from code2vec_tpu_torch.model_facade import Code2VecModel
    from code2vec_tpu_torch.serving.server import PredictionServer

    _, cfg = cli.config_from_args(
        ["serve", "--load", base, "--max_contexts", ctx, "--device", dev,
         "--serve_mips_nprobe", "16", "--serve_cache_entries", "0"])
    cfg.verbose_mode = 0
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    model = Code2VecModel(cfg)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model.warmup()   # builds the head (K9, K10) and warms every bucket
    warm_s = time.perf_counter() - t0
    head = model.mips_head
    server = PredictionServer(model)
    url = f"http://127.0.0.1:{server.start(port=0)}"
    try:
        status, body, dt = post(f"{url}/predict", source)
    finally:
        server.shutdown()
    counts = kernels.launch_counts()
    if status != 200:
        fail(f"lifecycle: /predict from --load with the MIPS head: HTTP "
             f"{status}")
    check_predict_body(body, model.model_fingerprint())
    need = ("kmeans_assign", "kmeans_update", "ivf_search",
            "context_encoder", "masked_attention")
    if not all(counts[k] for k in need) or counts["blockwise_topk"] or \
            counts["label_logits"]:
        fail(f"lifecycle: the MIPS head from --load launched {counts}")
    with open(test) as f:
        corpus = [next(f) for _ in range(rows)]
    # the facade's MIPS predict step (make_eval_step(mips_topk=)) on the
    # test methods: its top-k is checked against the head below
    predicted = model.predict(corpus, with_code_vectors=True)
    cv = torch.from_numpy(np.stack([r.code_vector for r in predicted])
                          ).to(dev)
    if not bool((cv.abs().amax(1) > 0).all()):
        fail("lifecycle: a test method's code vector is 0")
    table = model.state.params["target_embedding"].detach()
    real = model.dims.real_target_vocab_size
    fs = flagship()
    same, bad, tol = mips_against_exact(torch, head, cv, table, None, real,
                                        fs)
    if bad:
        fail(f"lifecycle: the MIPS head from --load at nprobe = nlist: "
             f"{bad} indices differ from the exact head away from "
             f"near-ties")
    # nprobe 16: top-1 against the exact head's, unless that row was in
    # no probed list (the approximation, not an error)
    from code2vec_tpu_torch.kernels import topk
    from code2vec_tpu_torch.kernels.ivf import top_positions
    exact = topk.blockwise_topk(cv, table, 2, fs.block, valid_rows=real)
    vals, ids = head.topk_fn(fs.topk, 16)(cv)
    # the predict step's answers are the head's at nprobe 16 on the same
    # code vectors, word for word (the head at nprobe = nlist was held
    # to the exact head above)
    lookup = model.vocabs.target_vocab.lookup_word
    wired = [[lookup(int(j)) for j in row] for row in ids.cpu().tolist()]
    off = [i for i, r in enumerate(predicted)
           if list(r.topk_predicted_words) != wired[i]]
    if off:
        i = off[0]
        fail(f"lifecycle: model.predict with the MIPS head from --load "
             f"differs from head.topk_fn(k, 16) on {len(off)} of "
             f"{len(predicted)} methods; method {i}: "
             f"{predicted[i].topk_predicted_words[:4]} against "
             f"{wired[i][:4]}")
    _, probe = top_positions(cv @ head._centroids.T, 16)
    agree = missed = 0
    for i in range(cv.shape[0]):
        want = int(exact.indices[i, 0])
        if int(ids[i, 0]) == want:
            agree += 1
            continue
        lists = probe[i].tolist()
        members = torch.cat([head._global_ids[head._offsets[c]:
                                              head._offsets[c + 1]]
                             for c in lists])
        near = float(exact.values[i, 0] - exact.values[i, 1]) <= tol
        if bool((members == want).any()) and not near:
            fail(f"lifecycle: method {i}: the MIPS head's top-1 "
                 f"{int(ids[i, 0])} at nprobe 16 is not the exact head's "
                 f"{want}, which lies in a probed list")
        missed += 1
    names = [(m["predictions"] or [{}])[0].get("name") for m in
             body["methods"]]
    exact_names = [(m["predictions"] or [{}])[0].get("name") for m in
                   exact_body["methods"]]
    log(f"lifecycle: `serve --load --serve_mips_nprobe 16` built its model "
        f"in {load_s:.2f}s and the MIPS head (nlist {head.nlist}, K9/K10 "
        f"over {real} x {table.shape[1]}, {head.build_seconds}s) and warmed "
        f"in {warm_s:.2f}s; /predict of Input.java in {dt * 1e3:.1f} ms, "
        f"launches kmeans_assign {counts['kmeans_assign']}, kmeans_update "
        f"{counts['kmeans_update']}, ivf_search {counts['ivf_search']}; "
        f"its top-1 names equal to the exact /predict's on "
        f"{sum(a == b for a, b in zip(names, exact_names))}/{len(names)} "
        f"methods; model.predict's top-{fs.topk} words equal to "
        f"head.topk_fn(k, 16)'s on all {len(predicted)} test methods; "
        f"on {cv.shape[0]} test methods over every list equal "
        f"to the exact head on {same} of {cv.shape[0] * fs.topk} indices "
        f"(the rest near-ties within {tol:.3g}); at nprobe 16 top-1 equal "
        f"to the exact head's on {agree} ({missed} where the exact top-1 "
        f"lies in no probed list or is a near-tie)")
    del model
    return dict(load_s=load_s, build_s=head.build_seconds, warm_s=warm_s,
                top1_agree=agree, methods=int(cv.shape[0]), launches=counts)


def adopt_crossover(torch, art: str, metas, test: str,
                    dev: str = "cuda") -> int:
    """`export --serve_mips_nprobe 16` recorded `mips_crossover` and
    `mips_calibration` (medians and [min, max] over the rows grid, the
    crossover the last row count of the table's leading MIPS wins) and
    kept the uncalibrated export's fingerprint; a ReleaseModel with
    --serve_mips_crossover -1 adopts the crossover and sends batches of
    at most that many live rows to the MIPS head, none where it is 0
    (MIPS lost at one row)."""
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.release.runtime import (CALIBRATION_SAMPLES,
                                                    ReleaseModel)

    meta, plain = metas["int8-mips"], metas["int8"]
    crossover, table = meta.get("mips_crossover"), \
        meta.get("mips_calibration")
    if not isinstance(crossover, int) or not table:
        fail(f"lifecycle: export --serve_mips_nprobe 16 recorded crossover "
             f"{crossover!r}, calibration {table!r}")
    if meta["fingerprint"] != plain["fingerprint"]:
        fail("lifecycle: the calibrated export's fingerprint differs from "
             "the uncalibrated one's")
    keys = [int(r) for r in table]
    wins = [r for r in keys if table[str(r)]["mips"] < table[str(r)]["exact"]]
    if wins != keys[:len(wins)] or crossover != (wins[-1] if wins else 0) \
            or any(not (t[f"{h}_range"][0] <= t[h] <= t[f"{h}_range"][1])
                   for t in table.values() for h in ("exact", "mips")):
        fail(f"lifecycle: crossover {crossover} does not follow its "
             f"calibration table {table}")
    model = ReleaseModel(Config(serve_artifact=art, device=dev,
                                verbose_mode=0, serve=True,
                                serve_mips_nprobe=16,
                                serve_mips_crossover=-1))
    bs = int(model.config.serve_batch_size)
    with open(test) as f:
        lines = [next(f) for _ in range(bs)]
    if 0 < crossover < bs:
        if model.mips_rows != crossover or model._mips_all:
            fail(f"lifecycle: crossover {crossover} adopted as "
                 f"{model.mips_rows} rows")
        model.predict(lines[:crossover])
        model.predict(lines[:crossover + 1])
        want = {"exact": 1, "mips": 1}
    elif crossover == 0:
        if model.mips_head is not None or model.mips_nprobe:
            fail("lifecycle: crossover 0 not adopted as exact-only")
        model.predict(lines)
        want = {"exact": 1, "mips": 0}
    else:
        if not model._mips_all:
            fail(f"lifecycle: crossover {crossover} not adopted as "
                 f"all-MIPS")
        model.predict(lines)
        want = {"exact": 0, "mips": 1}
    if model.head_dispatches != want:
        fail(f"lifecycle: with crossover {crossover} the heads ran "
             f"{model.head_dispatches}, expected {want}")
    spread = "; ".join(
        f"{r}: exact {t['exact']} {t['exact_range']} mips {t['mips']} "
        f"{t['mips_range']}" for r, t in table.items())
    log(f"lifecycle: export --serve_mips_nprobe 16 calibrated crossover "
        f"{crossover} (rows: us median [min, max] of "
        f"{CALIBRATION_SAMPLES} samples: {spread}), fingerprint unchanged; "
        f"--serve_mips_crossover -1 adopted it: heads {model.head_dispatches}")
    del model
    torch.cuda.empty_cache()
    return crossover


# ------------------------------------------------ the training loop's operations

# The operations phase's preempted run: SIGTERM from the step at this
# consumed step, so epoch 2 (4 steps of 1024) is cut after 2 batches
OPS_PREEMPT_STEP = 6
# a mid-epoch evaluation every 3 batches (config.num_train_batches_to_evaluate)
OPS_EVAL_EVERY = 3
# The resumed steps 7-8 against the lifecycle run's (the same seed,
# corpus and step numbers, so the same dropout masks). The two runs' losses
# were bit-equal in every call of PR 18 (rel err 0); K5 adds table
# gradients with f32 atomics, whose order may move last bits, so the bar
# leaves ~100 f32 ulps of a ~12-nat loss. A resume that dropped or zeroed
# the Adam moments or restarted the bias correction moves them by far more.
OPS_LOSS_RTOL = 1e-5
# The resumed state at step 8 against the lifecycle run's step-8 artifact,
# leaf by leaf: |resumed - lifecycle| / |lifecycle - step 6| (L2 norms), so
# the error is held against what steps 7-8 changed. Zeroed moments, moments
# not restored or a wrong bias correction give ~0.1-1; last-bit atomics,
# which Adam can turn into a sign for an element whose gradient nearly
# cancels, a few such elements in millions.
OPS_STATE_RTOL = 1e-2
# the CUDA symbols of the dense train step's kernels, as torch.profiler's
# trace names them (kernels/csrc)
TRACE_SYMBOLS = {"context_encoder": "context_encoder_kernel",
                 "masked_attention": "masked_attention_kernel",
                 "encoder_backward": "dctx_pass",
                 "masked_attention_backward": "attention_backward_kernel",
                 "softmax_xent": "softmax_xent_",
                 "adam": "adam_kernel"}


def marked_steps(model, starts, after=None):
    """Wrap the model's train step: each step's start on the host clock
    goes to `starts`, and `after(arrays, loss)` runs after it."""
    make = model.builder.make_train_step

    def make_marked(state):
        step = make(state)

        def run(state, *arrays):
            starts.append(time.perf_counter())
            state, loss = step(state, *arrays)
            if after is not None:
                after(arrays, loss)
            return state, loss
        return run

    model.builder.make_train_step = make_marked


def save_stall(spans, step_starts) -> dict:
    """The first save's stall of the step loop: its own seconds (the
    save call, from a synchronised device), and from its start to the
    next step's start less the evaluation between (the epoch-end
    evaluation follows the save)."""
    saves = [(t0, t1) for what, t0, t1 in spans if what == "save"]
    if not saves:
        fail("save stall: no save was made")
    s0, s1 = saves[0]
    after = [t for t in step_starts if t > s1]
    if not after:
        fail("save stall: no step followed the first save")
    evals = sum(t1 - t0 for what, t0, t1 in spans
                if what == "eval" and s0 <= t0 < after[0])
    return dict(save_s=s1 - s0, to_next_step_s=after[0] - s0 - evals,
                eval_s=evals)


def snapshot_routes(torch, state) -> dict:
    """The host copy an async save makes of the state's tensors, by
    route, host clock around synchronised copies: into fresh pageable
    memory (`Tensor.to("cpu")`), and checkpoint._snapshot's copies into
    pinned memory, twice (the second reuses the buffers the first freed,
    from PyTorch's caching host allocator)."""
    from code2vec_tpu_torch.training import checkpoint as ckpt

    leaves = {k: v for k, v in ckpt.state_leaves(state).items()
              if isinstance(v, torch.Tensor)}
    nbytes = sum(v.numel() * v.element_size() for v in leaves.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    copies = {k: v.to("cpu", copy=True) for k, v in leaves.items()}
    pageable = time.perf_counter() - t0
    del copies
    pinned = []
    for _ in range(2):
        t0 = time.perf_counter()
        snap = ckpt._snapshot(leaves)
        pinned.append(time.perf_counter() - t0)
        del snap
    return dict(gb=nbytes / 1e9, pageable_s=pageable, pinned_s=pinned)


def read_heartbeat(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def held_state(torch, state) -> dict:
    """A device copy of every leaf of `state`, as it stands on the current
    stream: what an artifact saved now must hold."""
    from code2vec_tpu_torch.training import checkpoint as ckpt

    return {k: v.detach().clone() if isinstance(v, torch.Tensor) else int(v)
            for k, v in ckpt.state_leaves(state).items()}


def artifact_mismatch(torch, path: str, held: dict) -> list:
    """The leaves where the artifact at `path` differs, bit for bit (bf16
    leaves widened to f32 on both sides), from `held` (held_state)."""
    from code2vec_tpu_torch.training import checkpoint as ckpt

    arrays = ckpt.load_state_arrays(path)
    if set(arrays) != set(held):
        return sorted(set(arrays) ^ set(held))
    bad = []
    for k, want in held.items():
        if isinstance(want, int):
            same = int(arrays[k]) == want
        else:
            got = torch.from_numpy(arrays[k]).to(want.device)
            same = torch.equal(got, want.float())
        if not same:
            bad.append(k)
    return bad


def resumed_state_err(torch, state, ref_path: str, start: dict) -> dict:
    """{leaf: |state - ref| / |ref - start|} (L2 norms, on the card) of
    `state` against the artifact at `ref_path`, where `start` holds the
    leaves (load_state_arrays) of the state both runs went on from; an
    integer leaf (the step) must be equal (its entry 0 or inf)."""
    from code2vec_tpu_torch.training import checkpoint as ckpt

    ref = ckpt.load_state_arrays(ref_path)
    errs = {}
    for k, v in ckpt.state_leaves(state).items():
        if not isinstance(v, torch.Tensor):
            errs[k] = 0.0 if int(v) == int(ref[k]) else float("inf")
            continue
        a = v.detach().float()
        b = torch.from_numpy(ref[k]).to(a.device)
        s0 = torch.from_numpy(start[k]).to(a.device)
        num = float(torch.linalg.vector_norm(a - b))
        den = float(torch.linalg.vector_norm(b - s0))
        errs[k] = num / den if den else (0.0 if num == 0 else float("inf"))
        del a, b, s0
    return errs


def ops_phase(torch, seed: int, work_dir: str, fs, ft, lifecycle: dict,
              dev: str = "cuda") -> dict:
    """The training loop's operations at full width, on the lifecycle
    phase's corpus and test file: `train --save B2 --test T
    --async_checkpointing --checkpoint_hash_content` for 2 epochs with a
    mid-epoch evaluation every OPS_EVAL_EVERY batches, the heartbeat and
    the metrics file, SIGTERM sent from the step at step OPS_PREEMPT_STEP;
    then `train --load B2 --epochs 2`. Checks: the mid-epoch evaluation
    at batch 3 (K1-K4 once a test batch); B2_iter1 verifies with the
    content hashes of every file; B2_iter1_preempt holds the cursor
    (epoch 1, row 2048); the resume takes B2_iter1_preempt, skips 2048
    rows and trains exactly the epoch-2 permutation's rows 2048-4095
    (the batches' id checksums against the host's gather), to step 8,
    its losses within OPS_LOSS_RTOL of the lifecycle run's steps 7-8 and
    its state at step 8 (parameters, moments, step) within OPS_STATE_RTOL
    of the lifecycle run's step-8 artifact, relative to what steps 7-8
    changed from B2_iter1_preempt; each async artifact (B2_iter1, B2_iter2)
    holds, bit for bit, a device copy of the state taken as its save was
    called, though K8 went on updating the state in place; the
    heartbeat reads preempted, then done (with the resume report); the
    metrics file counts the steps; each run launched K1, K2 and K5-K8
    once a step beside its evaluations. The async save's stall against
    the lifecycle run's synchronous one, in one call. Returns stats."""
    import signal

    import numpy as np

    from code2vec_tpu_torch import cli, kernels, obs
    from code2vec_tpu_torch.data.packed import _epoch_rng
    from code2vec_tpu_torch.data.reader import EstimatorAction
    from code2vec_tpu_torch.model_facade import Code2VecModel
    from code2vec_tpu_torch.training import checkpoint as ckpt

    t_phase = time.perf_counter()
    root = os.path.join(work_dir, "ops")
    os.makedirs(root)
    base = os.path.join(root, "B2")
    hb = os.path.join(root, "heartbeat.json")
    metrics_file = os.path.join(root, "metrics.prom")
    prefix = os.path.join(work_dir, "corpus")
    test = os.path.join(work_dir, "test.train.c2v")
    argv = ["train", "--data", prefix, "--epochs", "2", "--seed", str(seed),
            "--batch_size", str(ft.rows), "--max_contexts", str(ft.contexts),
            "--device", dev, "--save", base, "--test", test,
            "--async_checkpointing", "--checkpoint_hash_content",
            "--heartbeat_file", hb, "--metrics_file", metrics_file]
    weights = (torch.arange(ft.rows * ft.contexts, dtype=torch.int64,
                            device=dev) % 65521 + 1)
    np_weights = np.arange(ft.rows * ft.contexts, dtype=np.int64) % 65521 + 1
    batches_total = ("train_batches_total", ())

    def metric(name):
        """The process registry's unlabelled `name` without registering
        it: a counter's value, a histogram's (count, sum)."""
        child = obs.default_registry().collect().get(name, {}).get(())
        if isinstance(child, obs.Histogram):
            return child.count, child.sum
        if child is None:
            return 0.0 if name.endswith("_total") else (0, 0.0)
        return child.value

    def run(argv, preempt_at=None):
        _, config = cli.config_from_args(argv)
        config.shuffle_buffer_size = max(ft.rows // 16, 1)
        config.verbose_mode = 0
        config.num_train_batches_to_evaluate = OPS_EVAL_EVERY
        logs = []
        config.log = logs.append
        t0 = time.perf_counter()
        model = Code2VecModel(config)
        build_s = time.perf_counter() - t0
        starts, spans, sums, losses, evals, saved = [], [], [], [], [], []
        held = []

        def after(arrays, loss):
            sums.append(id_checksum(arrays, weights))
            losses.append(loss)
            if len(losses) == preempt_at:
                # from the consumer side, as a scheduler's notice lands
                os.kill(os.getpid(), signal.SIGTERM)

        marked_steps(model, starts, after)
        save_model, evaluate = ckpt.save_model, model._evaluate_with_params

        def timed_save(*args, **kw):
            copy = None
            if kw.get("committer") is not None:
                # the state as this call finds it: the steps after it
                # update the same tensors in place (K8) while the commit
                # thread writes the artifact
                copy = held_state(torch, args[1])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = save_model(*args, **kw)
            spans.append(("save", t1, time.perf_counter()))
            saved.append((os.path.basename(out), spans[-1][2] - t1))
            if copy is not None:
                held.append((out, copy))
            return out

        def timed_eval(params):
            torch.cuda.synchronize()
            before = kernels.launch_counts()
            t1 = time.perf_counter()
            res = evaluate(params)
            torch.cuda.synchronize()
            after_ = kernels.launch_counts()
            spans.append(("eval", t1, time.perf_counter()))
            evals.append({k: after_[k] - before[k] for k in after_})
            return res

        ckpt.save_model, model._evaluate_with_params = timed_save, timed_eval
        hist0 = metric("checkpoint_save_seconds")
        snap0 = metric("checkpoint_snapshot_seconds")
        steps0 = metric("train_batches_total")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            model.train()
            torch.cuda.synchronize()
        finally:
            ckpt.save_model = save_model
            del model._evaluate_with_params
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        # train() drained and closed the committer: every async artifact
        # is on disk
        if not held:
            fail("operations: the run made no async save")
        for path, copy in held:
            bad = artifact_mismatch(torch, path, copy)
            if bad:
                fail(f"operations: the async artifact {path} differs from "
                     f"the state at its save call in {bad[:8]}")
        async_checked = [os.path.basename(p) for p, _ in held]
        held.clear()
        del copy
        eval_launches = {k: sum(e[k] for e in evals) for k in counts}
        n = len(losses)
        got = {k: counts[k] - eval_launches[k] for k in kernels.TRAIN_KERNELS}
        if got != dict.fromkeys(kernels.TRAIN_KERNELS, n):
            fail(f"operations: a run of {n} steps launched {got}")
        for e in evals:
            if {k: e[k] for k in SERVE_KERNELS} != dict.fromkeys(
                    SERVE_KERNELS, LIFECYCLE_TEST_ROWS // 1024):
                fail(f"operations: an evaluation launched {e}")
        with open(metrics_file) as f:
            exported = metric_values(f.read())
        if exported.get(batches_total) != steps0 + n:
            fail(f"operations: the metrics file counts "
                 f"{exported.get(batches_total)} train batches, expected "
                 f"{steps0} + {n}")
        hist1, snap1 = (metric("checkpoint_save_seconds"),
                        metric("checkpoint_snapshot_seconds"))
        return model, dict(
            async_checked=async_checked,
            logs=logs, spans=spans, starts=starts, build_s=build_s,
            wall_s=wall, sums=torch.stack(sums).cpu().tolist(),
            losses=torch.stack(losses).float().cpu().tolist(),
            counts=counts, evals=len(evals), saved=saved,
            # the registry's checkpoint_save_seconds and, of the async
            # saves, checkpoint_snapshot_seconds over the run
            save_hist=(hist1[0] - hist0[0], hist1[1] - hist0[1]),
            snap_hist=(snap1[0] - snap0[0], snap1[1] - snap0[1]))

    # 1. preempted at step 6
    model, first = run(argv, preempt_at=OPS_PREEMPT_STEP)
    trainer = model.trainer
    beat = read_heartbeat(hb)
    if not trainer.preempted or len(first["losses"]) != OPS_PREEMPT_STEP \
            or beat["status"] != "preempted" or beat["step"] != \
            OPS_PREEMPT_STEP or beat["resume_mode"] != "fresh":
        fail(f"operations: the SIGTERM at step {OPS_PREEMPT_STEP} gave "
             f"preempted={trainer.preempted} after {len(first['losses'])} "
             f"steps, heartbeat {beat}")
    if [b for b, _ in trainer.mid_epoch_results] != [OPS_EVAL_EVERY] or \
            not any(m.startswith(f"Mid-epoch (batch {OPS_EVAL_EVERY}) "
                                 f"evaluation -- ") for m in first["logs"]):
        fail(f"operations: mid-epoch evaluations after batches "
             f"{[b for b, _ in trainer.mid_epoch_results]}")
    if os.path.exists(base) or os.path.exists(base + "_iter2"):
        fail("operations: the preempted run made its final save")
    t0 = time.perf_counter()
    manifest = ckpt.load_manifest(base + "_iter1")
    ckpt.verify_checkpoint(base + "_iter1", check_content=True)
    verify_s = time.perf_counter() - t0
    files = manifest["files"]
    if not manifest.get("content_hashed") or not all(
            "content_sha256" in e for e in files.values()):
        fail(f"operations: {base}_iter1 lacks content hashes")
    cursor = ckpt.load_manifest(base + "_iter1_preempt")["data_cursor"]
    want_cursor = {"epoch": 1, "global_row_ordinal": 2 * ft.rows,
                   "global_batch_size": ft.rows}
    if cursor != want_cursor:
        fail(f"operations: the preemption cursor {cursor}, expected "
             f"{want_cursor}")
    stall_async = save_stall(first["spans"], first["starts"])
    ds = model._train_corpus()
    rows = ds._global_filtered_row_ids(EstimatorAction.Train)
    seq = _epoch_rng(seed, 1).permutation(rows)[:4 * ft.rows]
    want_sums = [host_checksum(np, ds.gather(seq[i:i + ft.rows]),
                               np_weights)
                 for i in range(0, 4 * ft.rows, ft.rows)]
    if first["sums"][4:] != want_sums[:2]:
        fail("operations: the preempted run's epoch-2 batches are not the "
             "permutation's rows 0-2047")
    # the state both runs go on from at step 6
    step6 = ckpt.load_state_arrays(base + "_iter1_preempt")
    del model, trainer
    gc.collect()
    torch.cuda.empty_cache()

    # 2. train --load B2 --epochs 2: the rest of epoch 2
    resumed, second = run(argv[:argv.index("--save")] + [
        "--load", base, "--save", base] + argv[argv.index("--save") + 2:])
    beat = read_heartbeat(hb)
    report = resumed.resume_report
    if resumed.config.model_load_path != base + "_iter1_preempt" or \
            report["resume_mode"] != "exact" or \
            report["restored_step"] != OPS_PREEMPT_STEP:
        fail(f"operations: --load {base} resolved to "
             f"{resumed.config.model_load_path}, report {report}")
    if int(resumed.state.step) != 8 or second["sums"] != want_sums[2:]:
        fail(f"operations: the resumed run reached step "
             f"{int(resumed.state.step)}; its batches equal the "
             f"permutation's rows {2 * ft.rows}-{4 * ft.rows - 1}: "
             f"{second['sums'] == want_sums[2:]}")
    if beat["status"] != "done" or beat["restored_step"] != OPS_PREEMPT_STEP:
        fail(f"operations: the resumed run's heartbeat {beat}")
    want = lifecycle["losses"][1][2:]
    err = max(abs(a - b) / abs(b) for a, b in zip(second["losses"], want))
    if len(second["losses"]) != 2 or err > OPS_LOSS_RTOL:
        fail(f"operations: the resumed losses {second['losses']} against "
             f"the lifecycle run's {want} (rel err {err:.3g} > "
             f"{OPS_LOSS_RTOL})")
    state_errs = resumed_state_err(torch, resumed.state, lifecycle["step8"],
                                   step6)
    del step6
    shutil.rmtree(lifecycle["step8"])
    worst = max(state_errs, key=state_errs.get)
    if state_errs[worst] > OPS_STATE_RTOL:
        fail(f"operations: the resumed state at step 8 against the "
             f"lifecycle run's: {worst} off by {state_errs[worst]:.3g} of "
             f"what steps 7-8 changed (bar {OPS_STATE_RTOL}); "
             + ", ".join(f"{k} {v:.2e}" for k, v in sorted(
                 state_errs.items(), key=lambda kv: -kv[1])[:6]))
    for p in (base + "_iter2", base):
        ckpt.verify_checkpoint(p, check_content=True)
    if os.path.exists(base + "_iter1_preempt"):
        fail("operations: the clean _iter2 did not supersede _iter1_preempt")
    routes = snapshot_routes(torch, resumed.state)
    # the steady state: one more async save of the resumed model, whose
    # vocabularies its saves pickled and whose pinned buffers they freed
    committer = ckpt.AsyncCommitter(max_in_flight=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steady = ckpt.save_model(os.path.join(root, "steady"), resumed.state,
                             resumed.vocabs, resumed.config, epoch=2,
                             committer=committer)
    steady_s = time.perf_counter() - t0
    committer.close()
    ckpt.verify_checkpoint(steady, check_content=True)
    stall_sync = lifecycle["stall_s"]
    names = kernels.TRAIN_KERNELS
    launches = [first["counts"], second["counts"]]
    log(f"operations: SIGTERM at step {OPS_PREEMPT_STEP} -> "
        f"{os.path.basename(base)}_iter1_preempt (cursor {cursor}), "
        f"heartbeat preempted; mid-epoch evaluation at batch "
        f"{OPS_EVAL_EVERY}; {os.path.basename(base)}_iter1 content hashes "
        f"verified in {verify_s:.2f}s; `train --load` resumed exactly "
        f"(step {OPS_PREEMPT_STEP}), trained the permutation's rows "
        f"{2 * ft.rows}-{4 * ft.rows - 1} to step 8, losses "
        f"{[round(x, 5) for x in second['losses']]} against the lifecycle "
        f"run's {[round(x, 5) for x in want]} (rel err {err:.2e}), the "
        f"step-8 state against the lifecycle run's: largest {worst} "
        f"{state_errs[worst]:.2e} of what steps 7-8 changed; the async "
        f"artifacts {first['async_checked'] + second['async_checked']} "
        f"hold the state at their save calls bit for bit; heartbeat done; "
        f"launches (steps and evaluations) "
        f"{[{k: c[k] for k in names} for c in launches]}")
    log(f"operations: the epoch-1 save's stall, synchronous "
        f"{stall_sync['save_s']:.3f}s (save start to the next step's start, "
        f"less the evaluation: {stall_sync['to_next_step_s']:.3f}s) against "
        f"--async_checkpointing {stall_async['save_s']:.3f}s "
        f"({stall_async['to_next_step_s']:.3f}s); the preempted run's "
        f"saves {[(p, round(t, 3)) for p, t in first['saved']]} s, "
        f"checkpoint_save_seconds count {first['save_hist'][0]} sum "
        f"{first['save_hist'][1]:.3f}s, of which the async save's host "
        f"snapshot (checkpoint_snapshot_seconds) {first['snap_hist'][1]:.3f}"
        f"s; the resumed run's "
        f"{[(p, round(t, 3)) for p, t in second['saved']]} s")
    log(f"operations: a later async save (the vocabularies' bytes and "
        f"the pinned buffers reused) {steady_s:.3f}s")
    log(f"operations: the state's host copy ({routes['gb']:.3f} GB): into "
        f"fresh pageable memory {routes['pageable_s']:.3f}s; the async "
        f"save's snapshot into pinned memory {routes['pinned_s'][0]:.3f}s,"
        f" again {routes['pinned_s'][1]:.3f}s")
    del resumed
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(root)
    phase_s = time.perf_counter() - t_phase
    return dict(stall_sync=stall_sync, stall_async=stall_async,
                saves=[first["saved"], second["saved"]],
                save_hist=first["save_hist"], snap_hist=first["snap_hist"],
                routes=routes, steady_s=steady_s, verify_s=verify_s,
                loss_err=err, state_err=state_errs[worst],
                launches={k: sum(c[k] for c in launches) for k in names},
                phase_s=phase_s)


def train_step_check(torch, seed: int, fs, ft, rows: int = 64,
                     dev: str = "cuda"):
    """One train step at `rows` rows, full vocabulary widths, injected
    dropout mask: GPU against CPU (plain versions)."""
    import numpy as np

    from code2vec_tpu_torch.kernels import adam as kadam
    from code2vec_tpu_torch.models.code2vec import Code2VecModule, ModelDims
    from code2vec_tpu_torch.training.state import DTYPES

    dims = ModelDims(fs.vocab["token"] + 1, fs.vocab["path"] + 1,
                     fs.vocab["target"] + 1, token_dim=fs.token_dim,
                     path_dim=fs.path_dim)
    gpu = Code2VecModule(dims, device=dev, dropout_keep_rate=ft.keep,
                         generator=torch.Generator(device=dev
                                                   ).manual_seed(seed))
    cpu = Code2VecModule(dims, device="cpu", dropout_keep_rate=ft.keep)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rng = np.random.default_rng(seed)
    m, k_dim = ft.contexts, dims.context_dim
    arrays = [rng.integers(0, hi, (rows, m)).astype(np.int32)
              for hi in (dims.token_vocab_size, dims.path_vocab_size,
                         dims.token_vocab_size)]
    mask = (rng.random((rows, m)) > 0.2).astype(np.float32)
    mask[0] = 0.0
    labels = rng.integers(1, dims.target_vocab_size, rows).astype(np.int32)
    valid = np.ones(rows, np.float32)
    valid[1] = 0.0
    drop = rng.random((rows, m, k_dim)) < ft.keep
    host = [torch.from_numpy(x) for x in (*arrays, mask, labels, valid,
                                          drop)]
    grads, losses = {}, {}
    for name, mod, where in (("gpu", gpu, dev), ("cpu", cpu, "cpu")):
        x = [h.to(where) for h in host]
        mod.requires_grad_(True)
        t0 = time.perf_counter()
        cv, _ = mod.encode(*x[:4], deterministic=False, dropout_mask=x[6])
        loss = mod.train_loss(cv, x[4], x[5])
        loss.backward()
        losses[name] = float(loss.detach())
        grads[name] = {k: p.grad.detach().cpu()
                       for k, p in mod.named_parameters()}
        log(f"step check: forward + backward on the {name} in "
            f"{time.perf_counter() - t0:.1f}s")
    if not abs(losses["gpu"] - losses["cpu"]) <= 1e-5 * abs(losses["cpu"]):
        fail(f"GPU vs CPU step: loss {losses['gpu']} vs {losses['cpu']}")
    # No share of moved elements here (check_flips): each side's kernels
    # take inputs that already differ by rounding flips upstream (a bf16
    # code vector element one step apart moves a whole column of the
    # target gradient), which moved 3.2% of its elements on an H100. The
    # kernel phase holds each kernel's precision on identical inputs.
    errs = {}
    for k in grads["cpu"]:
        errs[k], ok = step_err(grads["gpu"][k], grads["cpu"][k])
        if not ok:
            fail(f"GPU vs CPU step: gradient of {k} max error {errs[k]} > "
                 f"one bf16 step at {float(grads['cpu'][k].abs().max())}")
    # the target rows that are no label get ~1/V of a label row's
    # gradient: each row within one bf16 step at its own largest value
    others = torch.ones(dims.target_vocab_size, dtype=torch.bool)
    others[host[4].long()] = False
    row_ratio, rows_off = row_step_err(
        grads["gpu"]["target_embedding"][others],
        grads["cpu"]["target_embedding"][others])
    if rows_off:
        fail(f"GPU vs CPU step: {rows_off} target rows that are no label "
             f"off by more than one bf16 step at their largest value "
             f"(worst {row_ratio:.3g} steps)")
    # K8 on identical inputs: the GPU's gradients, the same parameters
    hyper = kadam.AdamHyper(mu_dtype=DTYPES[ft.mu], nu_dtype=DTYPES[ft.nu])
    outs = {}
    for name, mod, where in (("gpu", gpu, dev), ("cpu", cpu, "cpu")):
        ps = [p.detach() for p in mod.parameters()]
        gs = [grads["gpu"][k].to(where) for k, _ in mod.named_parameters()]
        mus = [torch.zeros_like(p, dtype=hyper.mu_dtype) for p in ps]
        nus = [torch.zeros_like(p, dtype=hyper.nu_dtype) for p in ps]
        kadam.adam(ps, gs, mus, nus, 1, hyper)
        outs[name] = [x.cpu() for x in ps + mus + nus]
    k = len(outs["gpu"]) // 3
    err8, err_m = adam_errors(*(outs[w][i * k:(i + 1) * k]
                                for w in ("gpu", "cpu") for i in range(3)),
                              "GPU vs CPU adam")
    log(f"step check: GPU vs CPU at B={rows}, m={m}, injected mask: loss "
        f"{losses['gpu']:.6f} vs {losses['cpu']:.6f}; gradient max errors "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f" (tol one bf16 step at each largest value); target rows that "
        f"are no label within {row_ratio:.3g} of a bf16 step at their "
        f"largest value; adam max error "
        f"parameters {err8:.3g} (tol {TOL_ADAM}) moments {err_m:.3g} (tol "
        f"{TOL_MOMENT})")


def sparse_step_check(torch, seed: int, fs, ft, rows: int = 64,
                      dev: str = "cuda"):
    """One sparse train step at `rows` rows, full vocabulary widths, an
    injected dropout mask and mid-training row moments (global step 100):
    GPU against CPU (plain versions). The loss, the tables, mu and nu
    within one bf16 step of each tensor's largest value, and rows no id
    touched bit-equal to their start."""
    import numpy as np

    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.models.code2vec import Code2VecModule, ModelDims
    from code2vec_tpu_torch.training.state import (
        SPARSE_PARAM_NAMES, create_train_state, make_optimizer,
    )
    from code2vec_tpu_torch.training.step import TrainStepBuilder

    dims = ModelDims(fs.vocab["token"] + 1, fs.vocab["path"] + 1,
                     fs.vocab["target"] + 1, token_dim=fs.token_dim,
                     path_dim=fs.path_dim)
    config = Config(use_sparse_embedding_update=True,
                    dropout_keep_rate=ft.keep, adam_mu_dtype=ft.mu,
                    adam_nu_dtype=ft.nu)
    hyper = make_optimizer(config)
    gpu = Code2VecModule(dims, device=dev, dropout_keep_rate=ft.keep,
                         generator=torch.Generator(device=dev
                                                   ).manual_seed(seed))
    cpu = Code2VecModule(dims, device="cpu", dropout_keep_rate=ft.keep)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rng = np.random.default_rng(seed + 5)
    m, k_dim = ft.contexts, dims.context_dim
    arrays = [rng.integers(0, hi, (rows, m)).astype(np.int32)
              for hi in (dims.token_vocab_size, dims.path_vocab_size,
                         dims.token_vocab_size)]
    mask = (rng.random((rows, m)) > 0.2).astype(np.float32)
    mask[0] = 0.0
    labels = rng.integers(1, dims.target_vocab_size, rows).astype(np.int32)
    valid = np.ones(rows, np.float32)
    valid[1] = 0.0
    drop = rng.random((rows, m, k_dim)) < ft.keep
    host = [torch.from_numpy(x) for x in (*arrays, mask, labels, valid,
                                          drop)]
    # mid-training row moments, the same on both sides
    slots0 = {}
    for name in SPARSE_PARAM_NAMES:
        shape = getattr(cpu, name).shape
        mu = torch.from_numpy((rng.standard_normal(shape) * 1e-3).astype(
            np.float32)).to(hyper.mu_dtype)
        nu = torch.from_numpy((rng.random(shape) * 1e-6).astype(np.float32))
        slots0[name] = (mu, nu)
    start = {k: p.detach().clone() for k, p in cpu.named_parameters()
             if k in SPARSE_PARAM_NAMES}
    outs, losses = {}, {}
    for side, mod, where in (("gpu", gpu, dev), ("cpu", cpu, "cpu")):
        state = create_train_state(mod, hyper, config)
        for name, (mu, nu) in slots0.items():
            state.opt_state.slots[name].mu.copy_(mu)
            state.opt_state.slots[name].nu.copy_(nu)
        state.step = 99
        step = TrainStepBuilder(mod, hyper, config).make_train_step(state)
        x = [h.to(where) for h in host]
        t0 = time.perf_counter()
        state, loss = step(state, *x[:6], seed, dropout_mask=x[6])
        losses[side] = float(loss)
        outs[side] = {name: (state.params[name].detach().cpu(),
                             state.opt_state.slots[name].mu.cpu(),
                             state.opt_state.slots[name].nu.cpu())
                      for name in SPARSE_PARAM_NAMES}
        log(f"sparse step check: one sparse step on the {side} in "
            f"{time.perf_counter() - t0:.1f}s")
    if not abs(losses["gpu"] - losses["cpu"]) <= 1e-5 * abs(losses["cpu"]):
        fail(f"GPU vs CPU sparse step: loss {losses['gpu']} vs "
             f"{losses['cpu']}")
    errs = {}
    touched_ids = {"token_embedding": torch.cat([host[0].flatten(),
                                                 host[2].flatten()]),
                   "path_embedding": host[1].flatten()}
    for name in SPARSE_PARAM_NAMES:
        touched = torch.zeros(start[name].shape[0], dtype=torch.bool)
        touched[touched_ids[name].long()] = True
        g_out, c_out = outs["gpu"][name], outs["cpu"][name]
        for what, got, want, first in zip(
                ("table", "mu", "nu"), g_out, c_out,
                (start[name], *slots0[name])):
            e, ok = step_err(got[touched], want[touched])
            errs[f"{name} {what}"] = e
            if not ok:
                fail(f"GPU vs CPU sparse step: {name} {what} max error {e} "
                     f"> one bf16 step at "
                     f"{float(want[touched].float().abs().max())}")
            if not (torch.equal(got[~touched], first[~touched])
                    and torch.equal(want[~touched], first[~touched])):
                fail(f"GPU vs CPU sparse step: an untouched {name} {what} "
                     f"row changed")
    log(f"sparse step check: GPU vs CPU at B={rows}, m={m}, injected mask, "
        f"global step 100: loss {losses['gpu']:.6f} vs {losses['cpu']:.6f}; "
        f"touched rows' max errors "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + " (tol one bf16 step at each largest value); untouched rows "
        "bit-equal")


# -------------------------------------------------------------------- main


# ------------------------------------------------------ retrieval phases

# Retrieval tolerances, and why: K9 and K10 and K11 and K3's float32
# mode work in f32 and differ from their plain versions only in the order
# of f32 sums (TOL_F32SUM). An assignment of K9 may differ from the plain
# version's only where the two centroids' distances lie within
# TOL_ASSIGN (relative) of each other; K11's and K3's positions only at
# near-ties of the plain version's scores.
TOL_ASSIGN = 1e-5


def assign_agreement(torch, x, c, got, want):
    """(rows equal, rows that differ away from a near-tie of their two
    distances, the largest gap between those distances), distances in
    float64."""
    diff = torch.nonzero(got != want).flatten()
    if diff.numel() == 0:
        return int(got.numel()), 0, 0.0
    xd, cd = x[diff].double(), c.double()

    def dist(idx):
        cc = cd[idx.long()]
        return (cc * cc).sum(1) - 2 * (xd * cc).sum(1)

    dg, dw = dist(got[diff]), dist(want[diff])
    gap = (dg - dw).abs()
    scale = torch.maximum(dg.abs(), dw.abs()).clamp(min=1.0)
    bad = int((gap > TOL_ASSIGN * scale).sum())
    return int(got.numel() - diff.numel()), bad, float(gap.max())


def probed_rows(torch, q, cent, offsets, nprobe):
    """(rows of the union of the probed lists, probed rows summed over
    the queries): what K11 must read and score for these queries."""
    from code2vec_tpu_torch.kernels.ivf import top_positions
    _, probe = top_positions(q @ cent.T, nprobe)
    lens = (offsets[1:] - offsets[:-1])
    return (int(lens[torch.unique(probe)].sum()), int(lens[probe].sum()))


def kmeans_cases(torch, timer, x, c0, spherical, what, skew_seed=None):
    """K9 and K10 at one shape against their plain versions: agreement,
    determinism, times, bounds and library calls; K10 also on skewed
    lists where `skew_seed` is given (its entry's skew_* keys). Returns
    (K9 entry, K10 entry, K9's assignment)."""
    import numpy as np

    from code2vec_tpu_torch.kernels import kmeans

    n, d = x.shape
    c = c0.shape[0]
    got = kmeans.kmeans_assign(x, c0)
    want = kmeans.kmeans_assign_plain(x, c0)
    torch.cuda.synchronize()
    same, bad, gap = assign_agreement(torch, x, c0, got, want)
    if bad:
        fail(f"kmeans_assign {what}: {bad} assignments differ away from "
             f"near-ties ({same}/{n} equal)")
    nbytes = (n * d + c * d) * 4 + n * 4
    bms, by = bound(nbytes, 3 * 2.0 * n * c * d, TF32_FLOP_PER_S)
    fma_ms, _ = bound(nbytes, 2.0 * n * c * d, F32_FLOP_PER_S)
    ms = timer(lambda: kmeans.kmeans_assign(x, c0))
    plain_ms = timer(lambda: kmeans.kmeans_assign_plain(x, c0), spin_ms=20)
    cn = (c0 * c0).sum(1)
    lib_ms = timer(lambda: torch.argmin(torch.addmm(cn[None, :], x, c0.T,
                                                    alpha=-2.0), dim=1),
                   spin_ms=20)
    log(f"K9 kmeans_assign {what} N={n} C={c} D={d}: assignments equal "
        f"{same}/{n} (the rest near-ties within {TOL_ASSIGN}; largest "
        f"distance gap {gap:.3g}) ms {ms:.4f} "
        f"plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} (addmm + argmin) "
        f"bound_ms {bms:.4f} ({by}; 3xTF32; f32 FMAs {fma_ms:.4f})")
    # max_abs_err: the largest gap between the distances of the two
    # centroids where the assignments differ (0 where all agree)
    k9 = dict(max_abs_err=gap, ms=ms, plain_ms=plain_ms,
              bound_ms=bms, bound_by=by, library_ms=lib_ms,
              f32_fma_bound_ms=fma_ms)

    k10 = update_case(torch, timer, x, got, c0, spherical, what)
    if skew_seed is not None:
        # half the rows in one list, the rest spread over the others but
        # every eighth, which stays empty
        rng = np.random.default_rng(skew_seed)
        live = np.array([j for j in range(1, c) if j % 8 != 0])
        a = live[rng.integers(0, len(live), n)]
        a[rng.permutation(n)[:n // 2]] = 0
        skew = update_case(torch, timer, x,
                           torch.from_numpy(a.astype(np.int32)).to(x.device),
                           c0, spherical, f"{what} skewed lists")
        k10.update({f"skew_{k}": v for k, v in skew.items()})
    return k9, k10, got


def update_case(torch, timer, x, assign, c0, spherical, what):
    """K10 on one assignment against its plain version: two runs
    bit-equal, within TOL_F32SUM, empty clusters kept; timed beside its
    bound, the plain version and index_add_ of the sums."""
    from code2vec_tpu_torch.kernels import kmeans

    n, d = x.shape
    c = c0.shape[0]
    upd = kmeans.kmeans_update(x, assign, c0, spherical)
    again = kmeans.kmeans_update(x, assign, c0, spherical)
    want_c = kmeans.kmeans_update_plain(x, assign, c0, spherical)
    torch.cuda.synchronize()
    if not torch.equal(upd, again):
        fail(f"kmeans_update {what}: two runs gave different bits")
    err, ok = max_err(upd, want_c, TOL_F32SUM)
    if not ok:
        fail(f"kmeans_update {what}: max error {err}")
    counts = torch.bincount(assign.long(), minlength=c)
    empty = counts == 0
    if empty.any() and not torch.equal(upd[empty], c0[empty]):
        fail(f"kmeans_update {what}: an empty cluster moved")
    nbytes = n * d * 4 + n * 4 + 2 * c * d * 4
    bms, by = bound(nbytes, float(n * d), F32_FLOP_PER_S)
    ms = timer(lambda: kmeans.kmeans_update(x, assign, c0, spherical))
    plain_ms = timer(lambda: kmeans.kmeans_update_plain(x, assign, c0,
                                                        spherical),
                     spin_ms=20)
    idx = assign.long()
    sums = torch.zeros_like(c0)
    lib_ms = timer(lambda: sums.index_add_(0, idx, x))
    log(f"K10 kmeans_update {what} N={n} C={c} D={d} spherical="
        f"{spherical}: max_abs_err {err:.3g} (tol {TOL_F32SUM}), two runs "
        f"bit-equal, {int(empty.sum())} empty clusters kept, largest list "
        f"{int(counts.max())}; ms {ms:.4f} plain_ms {plain_ms:.4f} "
        f"library_ms {lib_ms:.4f} (index_add_) bound_ms {bms:.4f} ({by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)


def ivf_bound(torch, q, cent, rows, offsets, nprobe, k, scales=None,
              global_ids=None):
    """K11's least time (ms, by) on these queries: every row of the union
    of the probed lists read once (with its scale and id), the centroids,
    queries, offsets and results; 2 D f32 operations per centroid and
    per scored row. Also (union rows, rows scored)."""
    b, d = q.shape
    union, scanned = probed_rows(torch, q, cent, offsets, nprobe)
    row_bytes = rows.shape[1] * rows.element_size() \
        + (4 if scales is not None else 0) \
        + (4 if global_ids is not None else 0)
    c = cent.shape[0]
    nbytes = (union * row_bytes + c * d * 4 + b * d * 4
              + (offsets.numel() * 8) + b * k * 8)
    bms, by = bound(nbytes, 2.0 * d * (b * c + scanned), F32_FLOP_PER_S)
    return bms, by, union, scanned


def ivf_chains(torch, timer, q, cent, rows, offsets, nprobe, k,
               scales=None):
    """K11's two PyTorch yardsticks: (library_ms, library_full_ms). The
    first starts from the candidates (gather, bmm, topk; the probe is
    given); the second is the whole function in PyTorch calls: the
    centroid matmul, topk(nprobe), the padded lists' gather, bmm, the
    scales and dead slots, topk(k)."""
    from code2vec_tpu_torch.kernels.ivf import padded_lists, top_positions
    from code2vec_tpu_torch.ops.quant import decode_rows

    b, d = q.shape
    max_len = int((offsets[1:] - offsets[:-1]).max())
    pad = padded_lists(offsets, max_len)
    _, probe = top_positions(q @ cent.T, nprobe)
    cand = pad[probe].reshape(b, -1)
    safe = cand.clamp(min=0)
    kk = min(k, cand.shape[1])
    lib_ms = timer(lambda: torch.topk(torch.bmm(
        decode_rows(rows[safe], d), q[:, :, None]).squeeze(-1), kk),
        spin_ms=20)
    del cand, safe
    flat_scales = None if scales is None else scales.reshape(-1)

    def full():
        _, pr = torch.topk(q @ cent.T, nprobe)
        c = pad[pr].reshape(b, -1)
        sf = c.clamp(min=0)
        sc = torch.bmm(decode_rows(rows[sf], d), q[:, :, None]).squeeze(-1)
        if flat_scales is not None:
            sc = sc * flat_scales[sf]
        return torch.topk(sc.masked_fill(c < 0, -math.inf), kk)

    full_ms = timer(full, spin_ms=20)
    return lib_ms, full_ms


def ivf_case(torch, timer, q, cent, rows, offsets, nprobe, k, what,
             scales=None, global_ids=None):
    """K11 against its plain version on one batch of queries; `rows` in
    any format."""
    from code2vec_tpu_torch.kernels.ivf import ivf_search, ivf_search_plain

    b, d = q.shape
    max_len = int((offsets[1:] - offsets[:-1]).max())
    kw = dict(scales=scales, global_ids=global_ids, max_len=max_len)
    args = (q, cent, rows, offsets, nprobe, k)
    got_v, got_i = ivf_search(*args, **kw)
    again_v, again_i = ivf_search(*args, **kw)
    # the plain version's (k+1)-th value is the k-th one's lower neighbour
    want_v, want_i = ivf_search_plain(*args[:-1], k + 1, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(got_i, again_i) and torch.equal(got_v, again_v)):
        fail(f"ivf_search {what} B={b}: two runs gave different results")
    del again_v, again_i
    nxt, want_v, want_i = want_v[:, k], want_v[:, :k], want_i[:, :k]
    err, ok = max_err(got_v, want_v, TOL_F32SUM)
    same, bad = topk_agreement(got_i, want_i, want_v, TOL_F32SUM,
                               next_vals=nxt)
    if not ok or bad:
        fail(f"ivf_search {what}: value error {err}, {bad} positions differ "
             f"away from near-ties: "
             f"{topk_detail(got_i, want_i, want_v, nxt)}")
    bms, by, union, scanned = ivf_bound(torch, q, cent, rows, offsets,
                                        nprobe, k, scales, global_ids)
    ms = timer(lambda: ivf_search(*args, **kw))
    plain_ms = timer(lambda: ivf_search_plain(*args, **kw), spin_ms=20)
    lib_ms, full_ms = ivf_chains(torch, timer, q, cent, rows, offsets,
                                 nprobe, k, scales)
    log(f"K11 ivf_search {what} B={b} nprobe={nprobe} k={k}: max_abs_err "
        f"{err:.3g} (tol {TOL_F32SUM}) positions equal {same}/"
        f"{got_i.numel()}, two runs equal; {union} rows in the probed "
        f"lists, {scanned} scored; ms {ms:.4f} plain_ms {plain_ms:.4f} "
        f"library_ms {lib_ms:.4f} (from the candidates: gather + bmm + "
        f"topk) library_full_ms {full_ms:.4f} (the whole function: matmul "
        f"+ topk(nprobe) + gather + bmm + topk(k)) bound_ms {bms:.4f} "
        f"({by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms, library_full_ms=full_ms)


def mips_batches(q, fs):
    """The MIPS head's batches of `q`: B 64 (the serving batch), B 8 with
    one live row and seven zero rows (a one-method request as the
    dispatch pads it, release/runtime.py) and B 1."""
    q8 = q[:MIPS_ROWS].clone()
    q8[1:] = 0.0
    return {fs.rows: q[:fs.rows].contiguous(), "b8": q8,
            1: q[:1].contiguous()}


def brute_case(torch, timer, q, table, k, what, timed=True):
    """K3's float32 mode against its plain version (above k 64 its
    large-k mode, through K13); timed unless `timed` is false."""
    from code2vec_tpu_torch.kernels import topk

    b, d = q.shape
    v = table.shape[0]
    args = (q, table, k, 4096)
    kw = dict(compute_dtype=torch.float32)
    got = topk.blockwise_topk(*args, **kw)
    # the plain version's (k+1)-th value is the k-th one's lower neighbour
    want = topk.blockwise_topk_plain(q, table, k + 1, 4096, **kw)
    torch.cuda.synchronize()
    nxt, want_v, want_i = (want.values[:, k], want.values[:, :k],
                           want.indices[:, :k])
    err_v, ok_v = max_err(got.values, want_v, TOL_F32SUM)
    err_l, ok_l = max_err(got.lse, want.lse, TOL_F32SUM)
    same, bad = topk_agreement(got.indices, want_i, want_v, TOL_F32SUM,
                               next_vals=nxt)
    if not (ok_v and ok_l) or bad:
        fail(f"blockwise_topk f32 {what}: value error {err_v}, lse error "
             f"{err_l}, {bad} index mismatches away from near-ties: "
             f"{topk_detail(got.indices, want_i, want_v, nxt)}")
    if not timed:
        log(f"K3 blockwise_topk float32 mode {what} B={b} V={v} k={k}: "
            f"max_abs_err values {err_v:.3g} lse {err_l:.3g} (tol "
            f"{TOL_F32SUM}) indices equal {same}/{got.indices.numel()} "
            f"(the rest near-ties)")
        return dict(max_abs_err=max(err_v, err_l)), got
    nbytes = v * d * 4 + b * d * 4 + b * k * 8 + b * 4
    bms, by = bound(nbytes, 3 * 2.0 * b * v * d, TF32_FLOP_PER_S)
    fma_ms, _ = bound(nbytes, 2.0 * b * v * d, F32_FLOP_PER_S)
    ms = timer(lambda: topk.blockwise_topk(*args, **kw))
    plain_ms = timer(lambda: topk.blockwise_topk_plain(*args, **kw),
                     spin_ms=100)
    lib_ms = timer(lambda: torch.topk(torch.matmul(q, table.T), k))
    log(f"K3 blockwise_topk float32 mode {what} B={b} V={v} k={k}: "
        f"max_abs_err values {err_v:.3g} lse {err_l:.3g} (tol "
        f"{TOL_F32SUM}) indices equal {same}/{got.indices.numel()} ms "
        f"{ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} "
        f"(f32 matmul + topk) bound_ms {bms:.4f} ({by}; 3xTF32; f32 FMAs "
        f"{fma_ms:.4f})")
    return dict(max_abs_err=max(err_v, err_l), ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=lib_ms,
                f32_fma_bound_ms=fma_ms), got


def select_case(torch, timer, scores, k, what, n=None, timed=True):
    """K13 alone against its plain version on one score matrix (its first
    `n` columns): the same positions and the same values (read back from
    the scores), bit for bit; timed unless `timed` is false."""
    from code2vec_tpu_torch.kernels.select import (
        select_topk, select_topk_plain,
    )
    b = scores.shape[0]
    n = scores.shape[1] if n is None else n
    got_v, got_p = select_topk(scores, k, n=n)
    want_v, want_p = select_topk_plain(scores, k, n=n)
    torch.cuda.synchronize()
    if not (torch.equal(got_p, want_p) and torch.equal(
            got_v.view(torch.int32), want_v.view(torch.int32))):
        diff = int((got_p != want_p).sum())
        fail(f"select_topk {what}: {diff} positions differ from the plain "
             f"version's (or a value's bits)")
    if not timed:
        log(f"K13 select_topk {what} B={b} n={n} k={k}: positions and value "
            f"bits equal to the plain version's")
        return None
    nbytes = b * n * 4 + b * k * 8
    bms, by = bound(nbytes, float(b * n))
    view = scores[:, :n]
    ms = timer(lambda: select_topk(scores, k, n=n))
    plain_ms = timer(lambda: select_topk_plain(scores, k, n=n), spin_ms=20)
    lib_ms = timer(lambda: torch.topk(view, k), spin_ms=20)
    log(f"K13 select_topk {what} B={b} n={n} k={k}: positions and values "
        f"equal to the plain version's; ms {ms:.4f} plain_ms {plain_ms:.4f} "
        f"library_ms {lib_ms:.4f} (torch.topk) bound_ms {bms:.4f} ({by})")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)


def select_adversarial(torch, timer, g, b, n, dev):
    """K13 on rows built against it, B b x n (the main path's batch over
    the 1M index): every value equal; distinct values packed into one
    11-bit bin of the first digit; NaN, +-inf and +-0 spread over the row;
    equal values across the slices' boundaries, which the k-th falls
    among. At B 64 x 1M the first two overflow a slice's candidate buffer
    (the filter's counts are checked against the plan's cap; the NaN rows
    do too, a ninth of each row being one NaN key), so all of a row's CTAs
    refine it; those two are timed at k 1000 (`one_value_*`,
    `one_bin_*`)."""
    from code2vec_tpu_torch.kernels import select
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = {
        "one value": torch.full((b, n), 0.25, device=dev),
        "one 11-bit bin": 1.0 + 0.24 * torch.rand((b, n), generator=g,
                                                  device=dev),
    }
    x = torch.randn((b, n), generator=g, device=dev)
    x[:, ::9] = float("nan")
    x[:, 1::97] = float("inf")
    x[:, 2::89] = float("-inf")
    x[:, 3::7] = 0.0
    x[:, 4::11] = -0.0
    rows["NaN, +-inf, +-0"] = x
    x = torch.randn((b, n), generator=g, device=dev)
    cut = select.plan(b, n, 5, sms).slice
    for j in range(1, 4):
        x[:, j * cut - 3:j * cut + 3] = 9.0
    rows["ties across slices"] = x
    timed = {}
    for what, scores in rows.items():
        for k in (5, 1000):
            p = select.plan(b, n, k, sms)
            over = int((select.slice_candidates(scores, k, p).max(1).values
                        > p.cap).sum())
            if what in ("one value", "one 11-bit bin") and over != b:
                fail(f"select_topk {what} {b}x{n} k={k}: {over} of {b} rows "
                     f"overflow a slice's candidate buffer (cap {p.cap}), "
                     f"not all")
            log(f"K13 select_topk {what} {b}x{n} k={k}: {over} of {b} rows "
                f"overflow a slice's candidate buffer (cap {p.cap})")
            r = select_case(torch, timer if k == 1000 and over else None,
                            scores, k, f"{what} {b}x{n}",
                            timed=k == 1000 and over > 0)
            if r is not None:
                timed[what] = r
    return dict(one_value=timed["one value"],
                one_bin=timed["one 11-bit bin"])


def recorded_select(module, call):
    """The (scores, k, n) that `call` hands to K13 through `module` (K3's
    and K11's large-k modes), copied."""
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


def mips_against_exact(torch, head, cv, table, scales, real_vocab, fs):
    """The MIPS head over every list against the served exact head (K3,
    bf16 compute) on code vectors `cv`: (positions equal, positions that
    differ away from near-ties, tolerance). The exact head rounds the
    code vectors to bf16, which moves a logit by up to about 2^-8 of the
    largest; the values at each rank must agree within that, and an index
    may differ only where the exact head's neighbouring values (its
    (k+1)-th included) lie within it."""
    from code2vec_tpu_torch.kernels import topk

    k = fs.topk
    vals, ids = head.topk_fn(k, head.nlist)(cv)
    exact = topk.blockwise_topk(cv, table, k + 1, fs.block, scales=scales,
                                valid_rows=real_vocab)
    tol = PATH_REL_TOL * float(exact.values.abs().max())
    err, ok = max_err(vals, exact.values[:, :k], (tol, 0.0))
    if not ok:
        fail(f"MIPS head at nprobe = nlist: values off the exact head's by "
             f"{err} > {tol}")
    same, bad = topk_agreement(ids, exact.indices[:, :k],
                               exact.values[:, :k], (tol, 0.0),
                               next_vals=exact.values[:, k])
    return same, bad, tol


def retrieval_kernel_phase(torch, seed: int, timer, fs, work_dir: str,
                           dev="cuda", index_rows: int = 1_000_000,
                           index_nlist: int = 1000, index_iters: int = 10,
                           mips_iters: int = 6, nprobe: int = 16):
    """K9, K10, K11 and K3's float32 mode at two shapes: the approximate-
    MIPS head over the flagship int8 classifier (261,245 real rows x 384,
    nlist 511, 6 Lloyd steps, nprobe 16, B 64 and 1, k 10) and an index
    of 1,000,000 L2-normalised f32 vectors (nlist 1000, 10 spherical
    Lloyd steps, nprobe 16, B 64, k 16; brute force at B 64, k 16), built
    by the `index-build` command from a store written under `work_dir`.
    Returns (kernel entries, the 1M index's build and load seconds)."""
    import numpy as np

    from code2vec_tpu_torch import cli
    from code2vec_tpu_torch.kernels.ivf import ivf_search
    from code2vec_tpu_torch.retrieval.index import load_index
    from code2vec_tpu_torch.retrieval.mips import MipsHead
    from code2vec_tpu_torch.retrieval.store import VectorStoreWriter

    dev = torch.device(dev)
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    d = fs.code_dim
    report = {}

    # -- the MIPS head over the flagship int8 classifier
    v_real = fs.vocab["target"]
    table = (torch.rand((v_real + 1, d), generator=g, device=dev) * 2 - 1
             ) * math.sqrt(3 / d)
    q8, s8 = quantize(torch, table)
    x = q8[:v_real].float() * s8[:v_real]
    nlist = max(1, math.isqrt(v_real))
    rng = np.random.default_rng(seed)
    c0 = x[torch.from_numpy(rng.permutation(v_real)[:nlist]).to(dev)]
    k9m, k10m, _ = kmeans_cases(torch, timer, x, c0, False, "MIPS",
                                skew_seed=seed + 5)
    del x, c0
    t0 = time.perf_counter()
    head = MipsHead.build(q8.cpu().numpy(), s8.cpu().numpy(),
                          real_vocab=v_real, nprobe=nprobe,
                          kmeans_iters=mips_iters, seed=seed, device=dev)
    torch.cuda.synchronize()
    log(f"MIPS head: built over {v_real} rows in "
        f"{time.perf_counter() - t0:.2f}s (host clock, {mips_iters} Lloyd "
        f"steps + assignment + list reorder): nlist {head.nlist}, longest "
        f"list {head.max_len}")
    cv = (torch.rand((fs.rows, d), generator=g, device=dev) * 2 - 1)
    mips = {b: ivf_case(torch, timer, x, head._centroids, head._rows,
                        head._offsets, nprobe, fs.topk,
                        f"MIPS int8 {v_real}x{d}", scales=head._scales,
                        global_ids=head._global_ids)
            for b, x in mips_batches(cv, fs).items()}
    # the large-k mode: K11 int8 at B 64, k 100, through K13
    mips_k100 = ivf_case(torch, timer, cv, head._centroids, head._rows,
                         head._offsets, nprobe, 100,
                         f"MIPS int8 {v_real}x{d} (large-k mode)",
                         scales=head._scales, global_ids=head._global_ids)
    # K13 alone on the large-k modes' own scores: K3's at the serving
    # shape (B 64 x 261,245, k 100) and K11's candidates (nprobe x the
    # longest list) at k 100, B 64 and 1
    from code2vec_tpu_torch.kernels import ivf as kivf, topk as ktopk
    s13, k_, n_ = recorded_select(ktopk, lambda: ktopk.blockwise_topk(
        cv, q8, 100, fs.block, scales=s8, valid_rows=v_real))
    k13_serve = select_case(torch, timer, s13, k_, f"K3 scores {v_real}",
                            n=n_)
    k13_mips = {}
    for b in (fs.rows, 1):
        s13, k_, n_ = recorded_select(kivf, lambda: head.topk_fn(100)(
            cv[:b].contiguous()))
        k13_mips[b] = select_case(torch, timer, s13, k_,
                                  f"K11 candidates nprobe {nprobe}", n=n_)
    del s13
    # over every list the head is the exact head (the served bf16 one,
    # whose bf16 code vectors move a logit by up to ~2^-8 of the largest)
    same, bad, tol = mips_against_exact(torch, head, cv, q8, s8, v_real,
                                        fs)
    if bad:
        fail(f"MIPS head at nprobe = nlist: {bad} indices differ from the "
             f"exact head away from near-ties")
    log(f"MIPS head at nprobe = nlist = {head.nlist}: indices equal to the "
        f"exact head's {same}/{cv.shape[0] * fs.topk} (the rest near-ties "
        f"within {tol:.3g})")
    del head, table, q8, s8
    torch.cuda.empty_cache()

    # -- an index of 1M normalised f32 vectors: a store written from the
    # seed, then the `index-build` command and the index loaded as
    # `serve --retrieval_index` loads it
    x = torch.randn((index_rows, d), generator=g, device=dev)
    x /= torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp(min=1e-12)
    c0 = x[torch.from_numpy(rng.permutation(index_rows)[:index_nlist]
                            ).to(dev)]
    k9, k10, _ = kmeans_cases(torch, timer, x, c0, True, "index")
    store, idx_dir = (os.path.join(work_dir, "index1m", s)
                      for s in ("store", "index"))
    t0 = time.perf_counter()
    writer = VectorStoreWriter(store, d, "float32", "artifact:seed",
                               source=f"chip_smoke --seed {seed}")
    writer.append(x.cpu().numpy(), [f"m{i}" for i in range(index_rows)])
    writer.finalize()
    write_s = time.perf_counter() - t0
    del x, c0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    meta = cli.main(["index-build", "--vectors", store, "--index_out",
                     idx_dir, "--nlist", str(index_nlist), "--kmeans_iters",
                     str(index_iters), "--nprobe", str(nprobe), "--seed",
                     str(seed), "--device", str(dev)])
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = load_index(idx_dir, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    lens = index._offsets[1:] - index._offsets[:-1]
    log(f"index: store of {index_rows} rows written in {write_s:.2f}s; "
        f"`index-build` ({index_iters} spherical Lloyd steps, assignment, "
        f"reorder and files) in {build_s:.2f}s (build_seconds "
        f"{meta['build_seconds']}s: all but reading and normalising the "
        f"store); loaded in {load_s:.2f}s (host clock); "
        f"lists {int(lens.min())}..{int(lens.max())} rows")
    if meta["backend"] != "ivf_flat" or index.nlist != index_nlist:
        fail(f"index-build gave {meta['backend']} with nlist {index.nlist}")
    rows, cent, offsets = index._vectors, index._centroids, index._offsets
    qi = rows[torch.from_numpy(rng.choice(index_rows, fs.rows,
                                          replace=False)).to(dev)]
    qi = qi + 0.05 * torch.randn(qi.shape, generator=g, device=dev)
    qi = (qi / torch.linalg.vector_norm(qi, dim=1, keepdim=True)
          ).contiguous()
    k11 = ivf_case(torch, timer, qi, cent, rows, offsets, nprobe, 16,
                   f"index f32 {index_rows}x{d}")
    k11_b1 = ivf_case(torch, timer, qi[:1].contiguous(), cent, rows,
                      offsets, nprobe, 16, f"index f32 {index_rows}x{d}")
    k3f, brute = brute_case(torch, timer, qi, rows, 16,
                            f"index {index_rows}x{d}")
    # the large-k mode: K3's float32 mode at k 1000 through K13, then
    # K13 alone on the same queries' scores
    k3_large, _ = brute_case(torch, timer, qi, rows, 1000,
                             f"index {index_rows}x{d} (large-k mode)",
                             timed=False)
    scores = torch.matmul(qi, rows.T)
    k13 = select_case(torch, timer, scores, 1000,
                      f"index {index_rows}x{d} scores")
    k13_b1 = select_case(torch, timer, scores[:1].contiguous(), 1000,
                         f"index {index_rows}x{d} scores")
    del scores
    k13_over = select_adversarial(torch, timer, g, fs.rows, index_rows, dev)
    _, approx = ivf_search(qi, cent, rows, offsets, nprobe, 16,
                           max_len=int(lens.max()))
    hits = sum(len(set(a.tolist()) & set(e.tolist()))
               for a, e in zip(approx.cpu(), brute.indices.cpu()))
    log(f"index: recall@16 of IVF (nprobe {nprobe}) against brute force "
        f"{hits / brute.indices.numel():.4f}")
    del index, rows, cent, offsets, qi
    shutil.rmtree(os.path.join(work_dir, "index1m"))
    torch.cuda.empty_cache()

    def merged(main, extra, prefix):
        out = dict(main)
        out.update({f"{prefix}_{k}": v for k, v in extra.items()})
        return out

    report["kmeans_assign"] = merged(k9, k9m, "mips")
    report["kmeans_update"] = merged(k10, k10m, "mips")
    report["ivf_search"] = merged(k11, k11_b1, "b1")
    report["ivf_search_int8"] = merged(merged(merged(
        mips[fs.rows], mips[1], "b1"), mips["b8"], "b8"), mips_k100, "k100")
    report["blockwise_topk_f32"] = merged(k3f, k3_large, "k1000")
    # K13: B 64 x 1M above, B 1 x 1M as b1_*, K3's scores as b64_261k_*,
    # K11's candidates as mips_b64_* and mips_b1_*, the overflowing rows
    # of one value and of one 11-bit bin as one_value_* and one_bin_*
    report["select_topk"] = merged(merged(merged(merged(merged(merged(
        k13, k13_b1, "b1"), k13_serve, "b64_261k"), k13_mips[fs.rows],
        "mips_b64"), k13_mips[1], "mips_b1"), k13_over["one_value"],
        "one_value"), k13_over["one_bin"], "one_bin")
    return report, dict(index_build_1m_s=build_s,
                        index_kmeans_1m_s=meta["build_seconds"],
                        index_load_1m_s=load_s)


def many_methods_source(n: int) -> str:
    """A Java class of `n` small methods: one request whose methods fill
    a device batch beyond the MIPS crossover."""
    body = "\n".join(
        f"    int m{i}(int a, int b) {{ if (a > b + {i}) {{ return a - {i};"
        f" }} return b * {i + 1}; }}" for i in range(n))
    return f"class Many {{\n{body}\n}}"


def post_json(url: str, payload: dict):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 method="POST",
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        status, data = r.status, r.read()
    return status, json.loads(data), time.perf_counter() - t0


def check_neighbors_body(body, fingerprint, k):
    if sorted(body) != ["embedding_fingerprint", "index", "methods", "model",
                        "model_fingerprint"]:
        fail(f"/neighbors keys {sorted(body)}")
    if body["model_fingerprint"] != fingerprint or \
            body["embedding_fingerprint"] != fingerprint:
        fail(f"/neighbors fingerprints {str(body)[:300]}")
    if not body["methods"]:
        fail("/neighbors: no methods")
    for m in body["methods"]:
        nb = m["neighbors"]
        if sorted(m) != ["neighbors", "original_name"] or len(nb) != k:
            fail(f"/neighbors method {str(m)[:300]}")
        scores = [n["score"] for n in nb]
        if not all(math.isfinite(s) and -1.0 - 1e-4 <= s <= 1.0 + 1e-4
                   for s in scores) or scores != sorted(scores, reverse=True):
            fail(f"/neighbors scores {scores}")
        for n in nb:
            if sorted(n) != ["distance", "id", "score", "store_row"] or \
                    abs(n["distance"] - (1.0 - n["score"])) > 1e-6:
                fail(f"/neighbors neighbor {n}")


def retrieval_path_phase(torch, seed: int, work_dir: str, fs, ft,
                         n_methods: int = 20_000, n_timed: int = 300,
                         dev: str = "cuda"):
    """embed -> index-build -> serve --retrieval_index --serve_mips_nprobe
    16 --serve_mips_crossover 8 -> POST /neighbors and /predict, through
    the port's CLI, over the serving path's full-width artifact. Then
    `n_timed` /neighbors requests of one method, one at a time after a
    warm-up, for the request latency (a third as many at k 1000, K11's
    large-k mode and K13), and the extractor alone on the same
    source."""
    import numpy as np

    from code2vec_tpu_torch import cli, kernels
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.release.runtime import ReleaseModel
    from code2vec_tpu_torch.retrieval.embed_job import run_embed_job
    from code2vec_tpu_torch.retrieval.index import measure_recall
    from code2vec_tpu_torch.retrieval.store import VectorStore
    from code2vec_tpu_torch.serving.extractor_bridge import PathExtractor
    from code2vec_tpu_torch.serving.server import PredictionServer

    art = os.path.join(work_dir, "artifact")   # the serving path's
    rdir = os.path.join(work_dir, "retrieval")
    os.makedirs(rdir)
    sources = dict(SOURCES)
    with open(os.path.join(REPO, "Input.java")) as f:
        sources["Input.java"] = f.read()
    extractor = PathExtractor(Config(device=dev, max_contexts=fs.contexts,
                                     verbose_mode=0))
    extracted = [ln for s in sources.values()
                 for ln in extractor.extract_source(s)[0]]
    t0 = time.perf_counter()
    prefix = write_train_corpus(rdir, seed, fs, ft, n_methods,
                                stems=("tok", "path", "name|filler"),
                                with_dict=False)
    corpus = prefix + ".train.c2v"
    # the request sources' methods are stored too, twice (exact ties)
    with open(corpus, "a") as f:
        f.write("\n".join(extracted * 2) + "\n")
    log(f"retrieval: wrote a {n_methods + 2 * len(extracted)}-method corpus "
        f"over the artifact's vocabularies in "
        f"{time.perf_counter() - t0:.1f}s")
    store, idx = os.path.join(rdir, "store"), os.path.join(rdir, "index")
    # the pack `embed` writes beside the corpus on first use, on its own
    timed_pack(ReleaseModel(Config(serve_artifact=art, device="cpu",
                                   verbose_mode=0)), corpus, "retrieval")
    gc.collect()
    torch.cuda.empty_cache()

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    summary = cli.main(["embed", "--artifact", art, "--test", corpus,
                        "--embed_out", store, "--device", dev])
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    log(f"retrieval: embed {summary['rows']} rows in {embed_s:.1f}s "
        f"({summary['rows'] / embed_s:.0f} rows/s end to end, "
        f"{summary['rows_per_sec']:.0f} rows/s in the job's loop)")
    t0 = time.perf_counter()
    meta = cli.main(["index-build", "--vectors", store, "--index_out", idx,
                     "--device", dev])
    build_s = time.perf_counter() - t0
    log(f"retrieval: index-build {meta['backend']} nlist {meta['nlist']} "
        f"nprobe {meta['nprobe']} in {build_s:.2f}s "
        f"(k-means {meta['build_seconds']}s)")
    if meta["backend"] != "ivf_flat":
        fail(f"index-build gave a {meta['backend']} index")

    _, config = cli.config_from_args(
        ["serve", "--artifact", art, "--retrieval_index", idx,
         "--serve_mips_nprobe", "16", "--serve_mips_crossover", "8",
         "--serve_cache_entries", "0", "--device", dev])
    config.verbose_mode = 0
    t0 = time.perf_counter()
    model = ReleaseModel(config)   # what `cli.main(argv)` runs
    model.warmup()
    server = PredictionServer(model, config)
    port = server.start(port=0)
    url = f"http://127.0.0.1:{port}"
    log(f"retrieval: server with the index mounted and the MIPS head "
        f"(nlist {model.mips_head.nlist}) up in "
        f"{time.perf_counter() - t0:.1f}s")
    fp = model.model_fingerprint()
    try:
        if not server.pool.warm:
            fail("retrieval: the server's extractor pool came up cold")
        own = 0
        for name, src in sources.items():
            status, body, _ = post_json(f"{url}/neighbors", {"code": src})
            if status != 200:
                fail(f"/neighbors {name}: HTTP {status}")
            check_neighbors_body(body, fp, config.retrieval_topk)
            for m in body["methods"]:
                top = m["neighbors"][0]
                if top["id"] != m["original_name"] or \
                        top["score"] < 1 - 1e-4:
                    fail(f"/neighbors {name}: {m['original_name']}'s top "
                         f"neighbor is {top}")
                own += 1
        # k 64 (the lists of K11), 65 and 1000 (its large-k mode, K13):
        # each answered in full, each method still its own top neighbor
        for k in (64, 65, 1000):
            status, body, _ = post_json(f"{url}/neighbors",
                                        {"code": sources["Input.java"],
                                         "k": k, "nprobe": 32})
            if status != 200:
                fail(f"/neighbors k={k}: HTTP {status}")
            check_neighbors_body(body, fp, k)
            for m in body["methods"]:
                top = m["neighbors"][0]
                if top["id"] != m["original_name"] or \
                        top["score"] < 1 - 1e-4:
                    fail(f"/neighbors k={k}: {m['original_name']}'s top "
                         f"neighbor is {top}")
        # head dispatch: a one-request batch of few methods takes the MIPS
        # head (K11), a 12-method one the exact head (K3)
        for src, want in ((sources["Max.java"], "mips"),
                          (many_methods_source(12), "exact")):
            before = kernels.launch_counts()
            heads = dict(model.head_dispatches)
            status, body, _ = post(f"{url}/predict", src)
            if status != 200:
                fail(f"/predict ({want} head): HTTP {status}")
            check_predict_body(body, fp)
            after = kernels.launch_counts()
            d_k3 = after["blockwise_topk"] - before["blockwise_topk"]
            d_k11 = after["ivf_search_int8"] - before["ivf_search_int8"]
            d_head = {h: model.head_dispatches[h] - heads[h] for h in heads}
            if (want == "mips") != (d_k11 == 1 and d_k3 == 0) or \
                    d_head[want] != 1:
                fail(f"/predict of {len(body['methods'])} methods: head "
                     f"dispatches {d_head}, K3 +{d_k3}, K11 +{d_k11}; "
                     f"expected the {want} head")
            log(f"retrieval: /predict of {len(body['methods'])} methods took "
                f"the {want} head (K3 +{d_k3}, K11 +{d_k11})")
        # the request latency: /neighbors of one method (the MIPS head,
        # then the index), one client, one request at a time
        src = sources["Max.java"]
        for _ in range(10):
            post_json(f"{url}/neighbors", {"code": src})
        m0 = scrape(url)
        latencies = []
        for _ in range(n_timed):
            status, body, dt = post_json(f"{url}/neighbors", {"code": src})
            if status != 200:
                fail(f"/neighbors (timed): HTTP {status}")
            latencies.append(dt)
        neighbor_phases = phase_means(m0, scrape(url))
        check_neighbors_body(body, fp, config.retrieval_topk)
        # the same at k 1000 (K11's large-k mode, then K13), over enough
        # lists to hold 1000 rows
        big = {"code": src, "k": 1000, "nprobe": 32}
        for _ in range(10):
            post_json(f"{url}/neighbors", big)
        latencies_1000 = []
        for _ in range(n_timed // 3):
            status, body, dt = post_json(f"{url}/neighbors", big)
            if status != 200:
                fail(f"/neighbors k 1000 (timed): HTTP {status}")
            latencies_1000.append(dt)
        check_neighbors_body(body, fp, 1000)
        extract, extract_warm = [], []
        for _ in range(50):
            t0 = time.perf_counter()
            extractor.extract_source(src)
            extract.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            server.pool.extract_source(src)
            extract_warm.append(time.perf_counter() - t0)
        vecs = VectorStore.open(store).load()
        recall = measure_recall(server.retrieval.index,
                                vecs[:: max(1, len(vecs) // fs.rows)][:fs.rows],
                                10)
        counts = kernels.launch_counts()
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        server.shutdown()
    if health["retrieval"]["status"] != "attached" or \
            health["retrieval"]["fingerprint"] != fp:
        fail(f"/healthz retrieval {health['retrieval']}")
    lat = sorted(latencies)
    lat_1000 = sorted(latencies_1000)
    stats = dict(p50_ms=statistics.median(lat) * 1e3,
                 p99_ms=lat[int(0.99 * (len(lat) - 1))] * 1e3,
                 max_ms=lat[-1] * 1e3,
                 k1000_p50_ms=statistics.median(lat_1000) * 1e3,
                 k1000_p99_ms=lat_1000[int(0.99 * (len(lat_1000) - 1))] * 1e3,
                 extract_p50_ms=statistics.median(extract) * 1e3,
                 extract_warm_p50_ms=statistics.median(extract_warm) * 1e3,
                 phases_ms=neighbor_phases)
    log(f"retrieval: {len(lat)} /neighbors requests of Max.java (1 method, "
        f"k {config.retrieval_topk}) after 10 warm-up: p50 "
        f"{stats['p50_ms']:.2f} ms, p99 {stats['p99_ms']:.2f} ms, max "
        f"{stats['max_ms']:.2f} ms (mean ms by phase "
        f"{stats['phases_ms']}); at k 1000 (nprobe 32), "
        f"{len(lat_1000)} requests: "
        f"p50 {stats['k1000_p50_ms']:.2f} ms, p99 "
        f"{stats['k1000_p99_ms']:.2f} ms (warm pool, cache off); the "
        f"extractor alone on it p50 {stats['extract_p50_ms']:.2f} ms cold "
        f"(one process a call), {stats['extract_warm_p50_ms']:.3f} ms "
        f"through the warm pool, over {len(extract)} calls each; "
        f"{own} methods found themselves first; recall@10 of IVF (nprobe "
        f"{meta['nprobe']}) against brute force {recall:.4f}; kernel "
        f"launches {counts}")
    missing = [k for k in SERVE_KERNELS + kernels.RETRIEVAL_KERNELS
               if counts[k] <= 0]
    if missing:
        fail(f"the retrieval path launched no {missing}")

    # the MIPS head over every list returns the exact head's indices, on
    # the code vectors the embed job stored
    same, bad, tol = mips_against_exact(
        torch, model.mips_head, torch.from_numpy(vecs[:fs.rows].copy()
                                                 ).to(dev),
        model.params["target_embedding"],
        model.params["target_embedding_scale"],
        int(model.meta["dims"]["real_target_vocab_size"]), fs)
    if bad:
        fail(f"MIPS head at nprobe = nlist: {bad} indices differ from the "
             f"exact head away from near-ties")
    log(f"retrieval: MIPS head at nprobe = nlist = {model.mips_head.nlist} "
        f"equals the exact head on {same}/{fs.rows * fs.topk} indices (the "
        f"rest near-ties within {tol:.3g})")
    del model, server
    torch.cuda.empty_cache()

    # the embed job's vectors on the GPU against a CPU run of the same rows
    small = os.path.join(rdir, "small.c2v")
    with open(corpus) as f, open(small, "w") as out:
        for _ in range(fs.rows):
            out.write(next(f))
    cpu = ReleaseModel(Config(serve_artifact=art, device="cpu",
                              verbose_mode=0, test_batch_size=fs.rows))
    run_embed_job(cpu, corpus_path=small,
                  out_dir=os.path.join(rdir, "cpu-store"))
    want = VectorStore.open(os.path.join(rdir, "cpu-store"))
    got = vecs[:want.rows]
    w = want.load()
    err = float(np.abs(got - w).max())
    tol = PATH_REL_TOL * float(np.abs(w).max())
    if want.ids != VectorStore.open(store).ids[:want.rows] or err > tol:
        fail(f"embed GPU vs CPU: max error {err} > {tol} or ids differ")
    log(f"retrieval: embed GPU vs CPU on {want.rows} rows: max error "
        f"{err:.3g} (tolerance {tol:.3g})")
    return counts, dict(stats, embed_rows_per_s=summary["rows"] / embed_s,
                        index_build_s=build_s, recall=recall)


# ---------------------------------------- fp8 and int4 tables: kernel phase

QUANT_FORMATS = ("e4m3", "e5m2", "int4")
FORMAT_SCHEMES = {"e4m3": "fp8_e4m3", "e5m2": "fp8_e5m2", "int4": "int4"}
VALUE_BYTES = {"int8": 1.0, "e4m3": 1.0, "e5m2": 1.0, "int4": 0.5,
               "float32": 4.0}


def mode_of(fmt: str) -> str:
    """The launch-counter suffix of a table format's kernel modes."""
    return "int4" if fmt == "int4" else "fp8"


def quantize_format(torch, table, fmt):
    """The port's int8, fp8 or packed-int4 row quantizer (ops/quant.py),
    on the device: (the payload in the dtype that names its format, (V, 1)
    f32 scales); float32 tables as they are, with no scales."""
    from code2vec_tpu_torch.ops.quant import FP8_DTYPES, FP8_MAX, INT4_QMAX
    if fmt == "float32":
        return table, None
    absmax = table.abs().amax(dim=1, keepdim=True)
    qmax = {"int8": 127.0, "int4": INT4_QMAX}.get(fmt) or FP8_MAX[fmt]
    scales = (absmax / qmax).float()
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    if fmt == "int8":
        return (torch.clamp(torch.round(table / safe), -127, 127)
                .to(torch.int8), scales)
    if fmt != "int4":
        return (table / safe).to(FP8_DTYPES[fmt]), scales
    u = (torch.clamp(torch.round(table / safe), -INT4_QMAX, INT4_QMAX)
         + 8).to(torch.uint8)
    if u.shape[1] % 2:
        u = torch.cat([u, torch.full((u.shape[0], 1), 8, dtype=torch.uint8,
                                     device=u.device)], dim=1)
    return (u[:, 0::2] | (u[:, 1::2] << 4)).contiguous(), scales


def fp8_codes_case(torch, fmt, dev):
    """All 256 codes of an fp8 format through two kernels: K3's large-k
    mode (row j holds code j in its first column and the code vector
    picks that column with +1, then with -1, so each logit is the code's
    value or its negative: NaN and the infinities included; a logit of
    -inf ranks last, where the reference's top-k keeps its empty slot, so
    each pass checks the codes it does not send to -inf) and K4 (the
    finite codes; the rest -1e30)."""
    from code2vec_tpu_torch.kernels import label_logits, topk
    from code2vec_tpu_torch.ops.quant import FP8_DTYPES
    codes = torch.arange(256, dtype=torch.uint8)
    want = codes.view(FP8_DTYPES[fmt]).float()
    rows = torch.zeros((256, 16), dtype=torch.uint8)
    rows[:, 0] = codes
    tbl = rows.to(dev).view(FP8_DTYPES[fmt])
    ones = torch.ones((256, 1), device=dev)
    pick = torch.zeros((256, 16), device=dev)
    pick[:, 0] = 1.0
    nan = torch.isnan(want)
    finite = torch.isfinite(want)
    for sign in (1.0, -1.0):
        out = topk.blockwise_topk(sign * pick[:1], tbl, 256, 4096,
                                  scales=ones)
        logit = torch.full((256,), -math.inf)
        vals, idx = out.values[0].cpu(), out.indices[0].cpu().long()
        keep = vals != -math.inf   # an empty slot holds (-inf, 0)
        logit[idx[keep]] = vals[keep]
        w = sign * want
        held = w != -math.inf
        if not (torch.equal(torch.isnan(logit[held]), nan[held])
                and torch.equal(logit[held & ~nan], w[held & ~nan])):
            bad = torch.nonzero(held & ~nan & (logit != w)).flatten()
            bad = bad[:8].tolist()
            fail(f"fp8 {fmt}: codes {bad} x {sign} decode to "
                 f"{[float(logit[i]) for i in bad]}, not "
                 f"{[float(w[i]) for i in bad]}")
    k4 = label_logits.label_logits(
        pick, tbl, torch.arange(256, dtype=torch.int32, device=dev),
        scales=ones).cpu()
    if not (torch.equal(k4[finite], want[finite])
            and bool((k4[~finite] == -1e30).all())):
        fail(f"fp8 {fmt}: K4 decodes codes "
             f"{torch.nonzero(finite & (k4 != want)).flatten()[:8].tolist()}"
             f" wrongly")
    log(f"fp8 {fmt}: all 256 codes decode exactly through K3 (large-k "
        f"mode; {int(nan.sum())} NaN, {int((~finite & ~nan).sum())} "
        f"infinite) and K4 ({int(finite.sum())} finite)")


def quant_kernel_phase(torch, seed: int, timer, slow_timer, fs,
                       dev="cuda", mips_iters: int = 6, nprobe: int = 16):
    """The fp8 (e4m3, e5m2) and packed-int4 modes of K1, K3, K4 and K11
    against their plain versions at the flagship serving shapes: tables
    at the java14m sizes quantized on the device from one seeded f32
    set, K1 at 200 and 32 contexts, K3 at k 10 and k 100 (the large-k
    mode), K4, and K11 on the MIPS head's lists (B 64 and 1 at k 10, B 64
    at k 100), each to the int8 mode's tolerances (every fp8 and int4
    value decodes exactly), timed with its bound, its plain version and
    a library call; and all 256 fp8 codes of each format. Returns the
    kernel entries, keyed by mode (`context_encoder_fp8`: e4m3 with the
    e5m2 numbers as e5m2_*)."""
    from code2vec_tpu_torch.kernels import attention, encoder, label_logits
    from code2vec_tpu_torch.kernels import topk
    from code2vec_tpu_torch.ops.quant import unpack_int4
    from code2vec_tpu_torch.retrieval.index import ivf_lists

    dev = torch.device(dev)
    g = torch.Generator(device=dev).manual_seed(seed + 5)

    def uniform(shape, limit):
        return (torch.rand(shape, generator=g, device=dev) * 2 - 1) * limit

    v_tok, v_path, v_tgt = (fs.vocab["token"] + 1, fs.vocab["path"] + 1,
                            fs.vocab["target"] + 1)
    v_real = fs.vocab["target"]
    td, pd, d = fs.token_dim, fs.path_dim, fs.code_dim
    f32 = {"tok": uniform((v_tok, td), math.sqrt(3 / td)),
           "path": uniform((v_path, pd), math.sqrt(3 / pd)),
           "tgt": uniform((v_tgt, d), math.sqrt(3 / d))}
    w = uniform((d, d), 1.0)
    a = uniform((d,), 0.25)
    ids = {m: (torch.randint(0, v_tok, (fs.rows, m), generator=g, device=dev,
                             dtype=torch.int32),
               torch.randint(0, v_path, (fs.rows, m), generator=g,
                             device=dev, dtype=torch.int32),
               torch.randint(0, v_tok, (fs.rows, m), generator=g, device=dev,
                             dtype=torch.int32))
           for m in (fs.contexts, 32)}
    mask = (torch.rand((fs.rows, fs.contexts), generator=g, device=dev)
            > 0.3).float()
    labels = torch.randint(0, v_tgt, (fs.rows,), generator=g, device=dev,
                           dtype=torch.int32)
    # the MIPS head's lists: k-means over the f32 classifier's real rows
    # (K9, K10), the same lists for every format
    nlist = max(1, math.isqrt(v_real))
    cent, order, offsets = ivf_lists(f32["tgt"][:v_real], nlist, mips_iters,
                                     seed, device=dev)
    gids = order.to(torch.int32)
    torch.cuda.synchronize()
    report = {}
    for fmt in QUANT_FORMATS:
        mode = mode_of(fmt)
        main = fmt != "e5m2"   # e5m2's numbers go beside e4m3's
        esize = VALUE_BYTES[fmt]
        tok, tok_s = quantize_format(torch, f32["tok"], fmt)
        path, path_s = quantize_format(torch, f32["path"], fmt)
        entries = {}
        # -- K1
        for m in ((fs.contexts, 32) if main else (fs.contexts,)):
            src, pth, tgt = ids[m]
            args = (tok, tok_s, path, path_s, w, src, pth, tgt)
            got = encoder.context_encoder(*args)
            want = encoder.context_encoder_plain(*args)
            torch.cuda.synchronize()
            err, ok = max_err(got, want, TOL_K1)
            if not ok:
                fail(f"context_encoder {fmt} m={m}: max error {err}")
            if m != fs.contexts:
                log(f"K1 context_encoder {fmt} B={fs.rows} m={m}: "
                    f"max_abs_err {err:.3g} (tol {TOL_K1})")
                continue
            transformed = got
            uniq_tok = torch.unique(torch.cat([src, tgt])).numel()
            uniq_path = torch.unique(pth).numel()
            nbytes = (uniq_tok * (td * esize + 4) + uniq_path * (pd * esize
                                                                + 4)
                      + 3 * src.numel() * 4 + w.numel() * 4
                      + got.numel() * 2)
            bms, by = bound(nbytes, 2.0 * src.numel() * d * d)
            ms = timer(lambda: encoder.context_encoder(*args))
            plain_ms = timer(lambda: encoder.context_encoder_plain(*args),
                             spin_ms=20)
            lib_ms = timer(lambda: k1_library(
                torch, tok, tok_s, path, path_s, w, (src, pth, tgt)))
            log(f"K1 context_encoder {fmt} B={fs.rows} m={m}: max_abs_err "
                f"{err:.3g} (tol {TOL_K1}) ms {ms:.4f} plain_ms "
                f"{plain_ms:.4f} library_ms {lib_ms:.4f} bound_ms "
                f"{bms:.4f} ({by})")
            entries["context_encoder"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)
        del tok, path, tok_s, path_s
        cv, _ = attention.masked_attention(transformed, a, mask)
        cv = cv.contiguous()
        del transformed
        tbl, scl = quantize_format(torch, f32["tgt"], fmt)
        tbl_bytes = tbl.numel() * tbl.element_size() + tbl.shape[0] * 4
        # -- K3 at k 10 and k 100 (the large-k mode, through K13)
        for k in (fs.topk, 100):
            kw = dict(scales=scl, valid_rows=v_tgt)
            got = topk.blockwise_topk(cv, tbl, k, fs.block, **kw)
            # the plain version's (k+1)-th value is the k-th one's lower
            # neighbour
            want = topk.blockwise_topk_plain(cv, tbl, k + 1, fs.block,
                                             compute_dtype=torch.bfloat16,
                                             **kw)
            torch.cuda.synchronize()
            nxt, w_v, w_i = (want.values[:, k], want.values[:, :k],
                             want.indices[:, :k])
            err_v, ok_v = max_err(got.values, w_v, TOL_F32SUM)
            err_l, ok_l = max_err(got.lse, want.lse, TOL_F32SUM)
            same, bad = topk_agreement(got.indices, w_i, w_v, TOL_F32SUM,
                                       next_vals=nxt)
            if not (ok_v and ok_l) or bad:
                fail(f"blockwise_topk {fmt} k={k}: value error {err_v}, lse "
                     f"error {err_l}, {bad} index mismatches away from "
                     f"near-ties: {topk_detail(got.indices, w_i, w_v, nxt)}")
            nbytes = tbl_bytes + cv.numel() * 4 + fs.rows * k * 8 \
                + fs.rows * 4
            bms, by = bound(nbytes, 2.0 * fs.rows * tbl.shape[0] * d)
            ms = timer(lambda: topk.blockwise_topk(cv, tbl, k, fs.block,
                                                   **kw))
            plain_ms = slow_timer(lambda: topk.blockwise_topk_plain(
                cv, tbl, k, fs.block, compute_dtype=torch.bfloat16, **kw),
                spin_ms=100)
            cv_bf16 = cv.to(torch.bfloat16)
            if fmt != "int4":   # the cast, a bf16 matmul and torch.topk
                lib_ms = timer(lambda: torch.topk(torch.matmul(
                    cv_bf16, tbl.to(torch.bfloat16).T), k))
            else:             # torch's unpack, then the same
                lib_ms = timer(lambda: torch.topk(torch.matmul(
                    cv_bf16, unpack_int4(tbl, d).to(torch.bfloat16).T),
                    k), spin_ms=20)
            log(f"K3 blockwise_topk {fmt} B={fs.rows} V={tbl.shape[0]} "
                f"k={k}: max_abs_err values {err_v:.3g} lse {err_l:.3g} "
                f"(tol {TOL_F32SUM}) indices equal {same}/"
                f"{got.indices.numel()} ms {ms:.4f} plain_ms {plain_ms:.4f}"
                f" library_ms {lib_ms:.4f} bound_ms {bms:.4f} ({by})")
            r = dict(max_abs_err=max(err_v, err_l), ms=ms,
                     plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                     library_ms=lib_ms)
            if k == fs.topk:
                entries["blockwise_topk"] = r
            else:
                entries["blockwise_topk"].update(
                    {f"k100_{n}": x for n, x in r.items()})
        # -- K4
        kw = dict(scales=scl)
        got = label_logits.label_logits(cv, tbl, labels, **kw)
        want = label_logits.label_logits_plain(
            cv, tbl, labels, compute_dtype=torch.bfloat16, **kw)
        torch.cuda.synchronize()
        err, ok = max_err(got, want, TOL_F32SUM)
        if not ok:
            fail(f"label_logits {fmt}: max error {err}")
        uniq = torch.unique(labels).numel()
        nbytes = uniq * (d * esize + 4) + cv.numel() * 4 + fs.rows * 8
        bms, by = bound(nbytes, 2.0 * fs.rows * d)
        ms = timer(lambda: label_logits.label_logits(cv, tbl, labels, **kw))
        plain_ms = timer(lambda: label_logits.label_logits_plain(
            cv, tbl, labels, compute_dtype=torch.bfloat16, **kw),
            spin_ms=20)
        lib_ms = timer(lambda: k4_library(torch, cv, tbl, labels, scl))
        log(f"K4 label_logits {fmt} B={fs.rows}: max_abs_err {err:.3g} "
            f"(tol {TOL_F32SUM}) ms {ms:.4f} plain_ms {plain_ms:.4f} "
            f"library_ms {lib_ms:.4f} (gather, decode, row-wise dot in "
            f"PyTorch calls) bound_ms {bms:.4f} ({by})")
        entries["label_logits"] = dict(max_abs_err=err, ms=ms,
                                       plain_ms=plain_ms, bound_ms=bms,
                                       bound_by=by, library_ms=lib_ms)
        # -- K11 on the MIPS head's lists, rows in this format
        rows = tbl[:v_real][order].contiguous()
        rs = scl[:v_real][order].reshape(-1).contiguous()
        del tbl, scl
        q = (torch.rand((fs.rows, d), generator=g, device=dev) * 2 - 1)
        what = f"MIPS {fmt} {v_real}x{d}"
        kw = dict(scales=rs, global_ids=gids)
        mips = {b: ivf_case(torch, timer, x, cent, rows, offsets, nprobe,
                            fs.topk, what, **kw)
                for b, x in mips_batches(q, fs).items()}
        k100 = ivf_case(torch, timer, q, cent, rows, offsets, nprobe, 100,
                        f"{what} (large-k mode)", **kw)
        entries["ivf_search"] = dict(mips[fs.rows])
        for b, prefix in ((1, "b1"), ("b8", "b8")):
            entries["ivf_search"].update({f"{prefix}_{n}": x
                                          for n, x in mips[b].items()})
        entries["ivf_search"].update({f"k100_{n}": x
                                      for n, x in k100.items()})
        del rows, rs, q, cv
        torch.cuda.empty_cache()
        if fmt != "int4":
            fp8_codes_case(torch, fmt, dev)
        for name, r in entries.items():
            key = f"{name}_{mode}"
            if main:
                report[key] = r
            else:
                report[key].update({f"e5m2_{n}": x for n, x in r.items()})
    del f32, cent, order, offsets, gids
    torch.cuda.empty_cache()
    return report


EVAL_FORMATS = {"float32": "float32", "int8": "int8", "fp8_e4m3": "e4m3",
                "fp8_e5m2": "e5m2", "int4": "int4"}   # scheme -> format


def eval_shape_phase(torch, seed: int, timer, fs, rows: int, dev="cuda"):
    """The kernels of the `evaluate` path at its batch shape (`rows` x
    200 contexts, each row 1 to 200 of them live; K3 over the real target
    rows at k 10), in the table format of every artifact scheme: K1, K3
    and K4 against their plain versions on the same inputs on the card, to
    the serving shape's tolerances (K3's rows span rows / 64 row tiles),
    and the device time of one batch's K1 + K2 + K3 + K4 (CUDA events).
    Returns ({scheme: that time in ms}, {format: K1's time alone, its
    whole function in PyTorch calls (`k1_library`) and its bound})."""
    from code2vec_tpu_torch.kernels import attention, encoder, label_logits
    from code2vec_tpu_torch.kernels import topk

    dev = torch.device(dev)
    g = torch.Generator(device=dev).manual_seed(seed + 9)

    def uniform(shape, limit):
        return (torch.rand(shape, generator=g, device=dev) * 2 - 1) * limit

    def ids(n):
        return torch.randint(0, n, (rows, fs.contexts), generator=g,
                             device=dev, dtype=torch.int32)

    v_tok, v_path, v_tgt = (fs.vocab["token"] + 1, fs.vocab["path"] + 1,
                            fs.vocab["target"] + 1)
    v_real, d = fs.vocab["target"], fs.code_dim
    f32 = {"tok": uniform((v_tok, fs.token_dim), math.sqrt(3 / fs.token_dim)),
           "path": uniform((v_path, fs.path_dim), math.sqrt(3 / fs.path_dim)),
           "tgt": uniform((v_tgt, d), math.sqrt(3 / d))}
    w = uniform((d, d), math.sqrt(6 / (2 * d)))
    a = uniform((d,), math.sqrt(6 / (d + 1)))
    src, pth, tgt = ids(v_tok), ids(v_path), ids(v_tok)
    live = torch.randint(1, fs.contexts + 1, (rows, 1), generator=g,
                         device=dev)
    mask = (torch.arange(fs.contexts, device=dev)[None, :] < live).float()
    labels = torch.randint(0, v_tgt, (rows,), generator=g, device=dev,
                           dtype=torch.int32)
    step_ms, k1 = {}, {}
    for scheme, fmt in EVAL_FORMATS.items():
        tok, tok_s = quantize_format(torch, f32["tok"], fmt)
        path, path_s = quantize_format(torch, f32["path"], fmt)
        tbl, scl = quantize_format(torch, f32["tgt"], fmt)
        args = (tok, tok_s, path, path_s, w, src, pth, tgt)
        got = encoder.context_encoder(*args)
        err_k1, ok = max_err(got, encoder.context_encoder_plain(*args),
                             TOL_K1)
        if not ok:
            fail(f"evaluate shape {fmt}: context_encoder max error {err_k1}")
        cv = attention.masked_attention(got, a, mask)[0].contiguous()
        del got
        kw = dict(scales=scl, valid_rows=v_real)
        out = topk.blockwise_topk(cv, tbl, fs.topk, fs.block, **kw)
        # the plain version's (k+1)-th value is the k-th one's lower
        # neighbour
        want = topk.blockwise_topk_plain(cv, tbl, fs.topk + 1, fs.block,
                                         compute_dtype=torch.bfloat16, **kw)
        k = fs.topk
        nxt, w_v, w_i = (want.values[:, k], want.values[:, :k],
                         want.indices[:, :k])
        err_v, ok_v = max_err(out.values, w_v, TOL_F32SUM)
        err_l, ok_l = max_err(out.lse, want.lse, TOL_F32SUM)
        same, bad = topk_agreement(out.indices, w_i, w_v, TOL_F32SUM,
                                   next_vals=nxt)
        if not (ok_v and ok_l) or bad:
            fail(f"evaluate shape {fmt}: blockwise_topk value error {err_v}, "
                 f"lse error {err_l}, {bad} index mismatches away from "
                 f"near-ties: {topk_detail(out.indices, w_i, w_v, nxt)}")
        got4 = label_logits.label_logits(cv, tbl, labels, scales=scl)
        err_k4, ok = max_err(got4, label_logits.label_logits_plain(
            cv, tbl, labels, scales=scl, compute_dtype=torch.bfloat16),
            TOL_F32SUM)
        if not ok:
            fail(f"evaluate shape {fmt}: label_logits max error {err_k4}")

        def batch():
            t = encoder.context_encoder(*args)
            c = attention.masked_attention(t, a, mask)[0].contiguous()
            topk.blockwise_topk(c, tbl, fs.topk, fs.block, **kw)
            label_logits.label_logits(c, tbl, labels, scales=scl)

        step_ms[scheme] = timer(batch, spin_ms=10)
        # K1 alone at this shape, beside its bound and its whole function
        # in PyTorch calls
        uniq_tok = torch.unique(torch.cat([src, tgt])).numel()
        uniq_path = torch.unique(pth).numel()
        esize, ssize = VALUE_BYTES[fmt], (0 if fmt == "float32" else 4)
        nbytes = (uniq_tok * (fs.token_dim * esize + ssize)
                  + uniq_path * (fs.path_dim * esize + ssize)
                  + 3 * src.numel() * 4 + w.numel() * 4 + src.numel() * d * 2)
        bms, by = bound(nbytes, 2.0 * src.numel() * w.shape[0] * d)
        k1[fmt] = dict(
            ms=timer(lambda: encoder.context_encoder(*args)),
            library_ms=timer(lambda: k1_library(
                torch, tok, tok_s, path, path_s, w, (src, pth, tgt)),
                spin_ms=5),
            bound_ms=bms, bound_by=by)
        log(f"evaluate shape {fmt} B={rows} m={fs.contexts}: K1 alone ms "
            f"{k1[fmt]['ms']:.4f} library_ms {k1[fmt]['library_ms']:.4f} "
            f"(the whole function in PyTorch calls) bound_ms {bms:.4f} "
            f"({by})")
        log(f"evaluate shape {fmt} B={rows} m={fs.contexts}: K1 max_abs_err "
            f"{err_k1:.3g} (tol {TOL_K1}); K3 k={k} values {err_v:.3g} lse "
            f"{err_l:.3g} (tol {TOL_F32SUM}) indices equal {same}/"
            f"{out.indices.numel()}; K4 {err_k4:.3g}; K1+K2+K3+K4 "
            f"{step_ms[scheme]:.4f} ms a batch")
        del tok, path, tbl, scl, tok_s, path_s, cv, out, want, got4, args
        torch.cuda.empty_cache()
    del f32, w, src, pth, tgt, mask
    torch.cuda.empty_cache()
    return step_ms, k1


K3_GRID_BATCHES = (1, 12, 64, 1024)
K3_GRID_K = (10, 100)
K3_GRID_FORMATS = ("float32", "int8", "e4m3", "e5m2", "int4")


def topk_grid_phase(torch, seed: int, timer, fs, dev="cuda"):
    """K3 over the flagship target table (261,246 x 384, the last row
    dead) in every table format at B 1, 12, 64 and 1024 (N tiles of 8
    and 16, 2 chunks of 32, 16 chunks of 64) and k 10 and 100 (the
    large-k mode, through K13), against its plain version on the same
    inputs: values and logsumexp within TOL_F32SUM, indices equal away
    from near-ties. As the serving path pads a batch, one code vector of
    B 12 and the second half of B 64 are zero (every logit equal).
    At B 1024, k 10 (the evaluate batch) each format is timed beside its
    bound, its plain version (3 samples) and a bf16 matmul + torch.topk
    (int4: torch's unpack first). Returns {format: that B 1024 entry}."""
    from code2vec_tpu_torch.kernels import topk
    from code2vec_tpu_torch.ops.quant import unpack_int4

    dev = torch.device(dev)
    g = torch.Generator(device=dev).manual_seed(seed + 13)
    v_tgt, v_real, d = (fs.vocab["target"] + 1, fs.vocab["target"],
                        fs.code_dim)
    f32 = (torch.rand((v_tgt, d), generator=g, device=dev) * 2 - 1
           ) * math.sqrt(3 / d)
    cvs = {b: torch.rand((b, d), generator=g, device=dev) * 2 - 1
           for b in K3_GRID_BATCHES}
    cvs[12][11] = 0.0
    cvs[64][32:] = 0.0
    out = {}
    slow = Timer(torch, 3)   # the plain version at B 1024: 3 samples
    for fmt in K3_GRID_FORMATS:
        tbl, scl = quantize_format(torch, f32, fmt)
        kw = dict(scales=scl, valid_rows=v_real)
        errs, equal, total = [], 0, 0
        for b in K3_GRID_BATCHES:
            cv = cvs[b]
            for k in K3_GRID_K:
                got = topk.blockwise_topk(cv, tbl, k, fs.block, **kw)
                # the plain version's (k+1)-th value is the k-th one's
                # lower neighbour
                want = topk.blockwise_topk_plain(
                    cv, tbl, k + 1, fs.block, compute_dtype=torch.bfloat16,
                    **kw)
                torch.cuda.synchronize()
                nxt, w_v, w_i = (want.values[:, k], want.values[:, :k],
                                 want.indices[:, :k])
                err_v, ok_v = max_err(got.values, w_v, TOL_F32SUM)
                err_l, ok_l = max_err(got.lse, want.lse, TOL_F32SUM)
                same, bad = topk_agreement(got.indices, w_i, w_v,
                                           TOL_F32SUM, next_vals=nxt)
                if not (ok_v and ok_l) or bad:
                    fail(f"blockwise_topk {fmt} B={b} k={k}: value error "
                         f"{err_v}, lse error {err_l}, {bad} index "
                         f"mismatches away from near-ties: "
                         f"{topk_detail(got.indices, w_i, w_v, nxt)}")
                errs.append(max(err_v, err_l))
                equal += same
                total += got.indices.numel()
        b, cv = 1024, cvs[1024]
        ms = timer(lambda: topk.blockwise_topk(cv, tbl, fs.topk, fs.block,
                                               **kw))
        cv_bf16 = cv.to(torch.bfloat16)
        if fmt == "int4":
            lib_ms = timer(lambda: torch.topk(torch.matmul(
                cv_bf16, unpack_int4(tbl, d).to(torch.bfloat16).T),
                fs.topk), spin_ms=20)
        else:
            lib_ms = timer(lambda: torch.topk(torch.matmul(
                cv_bf16, tbl.to(torch.bfloat16).T), fs.topk))
        plain_ms = slow(lambda: topk.blockwise_topk_plain(
            cv, tbl, fs.topk, fs.block, compute_dtype=torch.bfloat16, **kw),
            spin_ms=20)
        nbytes = (tbl.numel() * tbl.element_size()
                  + (0 if scl is None else v_tgt * 4) + cv.numel() * 4
                  + b * fs.topk * 8 + b * 4)
        bms, by = bound(nbytes, 2.0 * b * v_tgt * d)
        out[fmt] = dict(max_abs_err=max(errs), ms=ms, library_ms=lib_ms,
                        plain_ms=plain_ms, bound_ms=bms, bound_by=by)
        log(f"K3 blockwise_topk {fmt} V={v_tgt}: B {K3_GRID_BATCHES} x k "
            f"{K3_GRID_K} max_abs_err {max(errs):.3g} (tol {TOL_F32SUM}) "
            f"indices equal {equal}/{total} (the rest near-ties); B=1024 "
            f"k={fs.topk} ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
            f"{lib_ms:.4f} (bf16 matmul + topk) bound_ms {bms:.4f} ({by})")
        del tbl, scl
        torch.cuda.empty_cache()
    del f32, cvs
    torch.cuda.empty_cache()
    return out


# ------------------------------------- fp8 and int4 artifacts: serving path

def letters(i: int) -> str:
    """i in base 26 over a-z: a method-name part with no digits, so that
    names built from it are legal predictions (^[a-zA-Z|]+$)."""
    out = ""
    while True:
        out = chr(97 + i % 26) + out
        i //= 26
        if i == 0:
            return out


def write_scheme_artifacts(work_dir: str, params, vocabs, fs, schemes):
    """Release artifacts of `schemes` from one set of f32 params, written
    in parallel threads: {scheme: (directory, meta)}."""
    from code2vec_tpu_torch.release.artifact import write_artifact

    def one(scheme):
        out = os.path.join(work_dir, f"artifact-{scheme}")
        return scheme, out, write_artifact(
            params, vocabs, out, scheme, max_contexts=fs.contexts,
            compute_dtype=fs.compute_dtype, topk=fs.topk,
            topk_block_size=fs.block, serve_batch_size=fs.rows,
            buckets=fs.buckets)

    with concurrent.futures.ThreadPoolExecutor(len(schemes)) as ex:
        return {s: (out, meta) for s, out, meta in ex.map(one, schemes)}


def serving_weights(seed: int, fs, dev: str = "cuda"):
    """(f32 params, vocabularies, extracted methods, request sources) of
    the serving, fp8/int4 and evaluate phases: the request sources, the
    methods the extractor finds in them, and flagship_weights."""
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.serving.extractor_bridge import PathExtractor

    sources = dict(SOURCES)
    with open(os.path.join(REPO, "Input.java")) as f:
        sources["Input.java"] = f.read()
    extractor = PathExtractor(Config(device=dev, max_contexts=fs.contexts,
                                     verbose_mode=0))
    extracted = [extractor.extract_source(s) for s in sources.values()]
    params, vocabs = flagship_weights(seed, extracted, fs)
    return params, vocabs, extracted, sources


def timed_posts(url: str, body: str, n: int, warm: int = 10):
    """`warm` then `n` timed POSTs of one body, one at a time: (the
    latencies in seconds, the last response body)."""
    for _ in range(warm):
        post(url, body)
    lat = []
    for _ in range(n):
        status, resp, dt = post(url, body)
        if status != 200:
            fail(f"{url} (timed): HTTP {status}")
        lat.append(dt)
    return lat, resp


def latency_stats(lat):
    lat = sorted(lat)
    return dict(p50_ms=statistics.median(lat) * 1e3,
                p99_ms=lat[int(0.99 * (len(lat) - 1))] * 1e3,
                max_ms=lat[-1] * 1e3, requests=len(lat))


SCHEME_MODES = {"float32": "int8", "int8": "int8", "fp8_e4m3": "fp8",
                "fp8_e5m2": "fp8", "int4": "int4"}   # launch-counter suffix


def quant_path_phase(torch, seed: int, work_dir: str, fs, weights,
                     arts, dev: str = "cuda", n_one: int = 300,
                     n_many: int = 100):
    """Serving the int8, e4m3 and int4 artifacts of one set of weights
    over HTTP, and the e5m2 one in process, each with the MIPS head
    beside the exact one (--serve_mips_nprobe 16 --serve_mips_crossover
    8: batches of up to 8 methods take K11 in the table's format, larger
    ones K3 and K4). Over HTTP: every request source and one 12-method
    request with their bodies checked; then the request latency, one
    request at a time after 10 warm-up, of `n_one` requests of one method
    (the MIPS head) and `n_many` of 12 methods (the exact head). In
    process: one method through predict, then 14. Each run with both
    heads dispatched, its mode's kernels launched (K11 in the table's
    format included) and no other mode's, and the exact step on one padded
    batch of the extracted methods against the CPU. Returns ({scheme: the
    launch counts of its run}, {scheme: {head: latency stats}})."""
    from code2vec_tpu_torch import kernels
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.release.runtime import ReleaseModel
    from code2vec_tpu_torch.serving.server import PredictionServer

    _, _, extracted, sources = weights
    many = many_methods_source(12)
    runs, latency = {}, {}
    for scheme, http in (("int8", True), ("fp8_e4m3", True), ("int4", True),
                         ("fp8_e5m2", False)):
        art, _ = arts[scheme]
        mode = SCHEME_MODES[scheme]
        # cache off: the timed loops repeat one body and must time the
        # miss path (warm pool, batcher, kernels)
        config = Config(serve_artifact=art, device=dev, verbose_mode=0,
                        serve=True, serve_mips_nprobe=16,
                        serve_mips_crossover=8, serve_cache_entries=0)
        t0 = time.perf_counter()
        model = ReleaseModel(config)
        model.warmup()
        mb = model.artifact.table_bytes() / 1e6
        log(f"quant path: loaded {scheme} ({mb:.1f} MB of tables), built "
            f"its MIPS head and warmed it in "
            f"{time.perf_counter() - t0:.1f}s")
        kernels.reset_launch_counts()
        if http:
            server = PredictionServer(model)
            root = f"http://127.0.0.1:{server.start(port=0)}"
            url = f"{root}/predict"
            fp = model.model_fingerprint()
            try:
                if not server.pool.warm:
                    fail(f"quant path: the {scheme} server's extractor "
                         f"pool came up cold")
                for src in list(sources.values()) + [many]:
                    status, body, _ = post(url, src)
                    if status != 200:
                        fail(f"/predict on the {scheme} artifact: HTTP "
                             f"{status}")
                    check_predict_body(body, fp)
                m0 = scrape(root)
                one, body = timed_posts(url, sources["Max.java"], n_one)
                check_predict_body(body, fp)
                m1 = scrape(root)
                twelve, body = timed_posts(url, many, n_many)
                check_predict_body(body, fp)
                m2 = scrape(root)
                counts = kernels.launch_counts()
            finally:
                server.shutdown()
            latency[scheme] = {
                "mips": dict(latency_stats(one),
                             phases_ms=phase_means(m0, m1)),
                "exact": dict(latency_stats(twelve),
                              phases_ms=phase_means(m1, m2))}
            log(f"quant path: {scheme}: " + "; ".join(
                f"{st['requests']} /predict requests of {what} ({head} "
                f"head, warm pool, cache off) after 10 warm-up: p50 "
                f"{st['p50_ms']:.2f} ms, p99 "
                f"{st['p99_ms']:.2f}, max {st['max_ms']:.2f} (mean ms by "
                f"phase, warm-up included {st['phases_ms']})"
                for head, what, st in (("mips", "1 method",
                                        latency[scheme]["mips"]),
                                       ("exact", "12 methods",
                                        latency[scheme]["exact"])))
                + f"; heads {model.head_dispatches}")
        else:   # one method (the MIPS head), then 2 x 7 (the exact one)
            lines = [ln for ls, _ in extracted for ln in ls]
            for res in model.predict(lines[:1]) + model.predict(lines * 2):
                if not res.topk_predicted_words:
                    fail(f"{scheme}: predict gave no words")
            counts = kernels.launch_counts()
        if not (model.head_dispatches["exact"]
                and model.head_dispatches["mips"]):
            fail(f"{scheme}: the heads ran {model.head_dispatches}")
        need = list(kernels.SERVE_KERNELS[mode]) + [f"ivf_search_{mode}"]
        missing = [k for k in need if counts[k] <= 0]
        stray = [k for m in kernels.SERVE_KERNELS if m != mode
                 for k in kernels.SERVE_KERNELS[m] + (f"ivf_search_{m}",)
                 if k != "masked_attention" and counts[k]]
        if missing or stray:
            fail(f"{scheme}: launched no {missing}; launched other modes "
                 f"{stray}: {counts}")
        log(f"quant path: {scheme}: K11's {scheme} instantiation "
            f"(ivf_search_{mode}) launched {counts[f'ivf_search_{mode}']} "
            f"times on this run")
        step_gpu_vs_cpu(torch, model, art, extracted, fs, scheme, dev)
        runs[scheme] = counts
        del model
        torch.cuda.empty_cache()
    return runs, latency


class LogLines(logging.Handler):
    """The messages of the port's logger while attached."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def evaluate_phase(torch, seed: int, work_dir: str, fs, weights, arts,
                   batch_ms, n_rows: int = 4 * 1024 + 37, subset: int = 64,
                   dev: str = "cuda"):
    """The `evaluate` command on the GPU over the artifacts of all five
    schemes (one set of seeded weights) and a synthetic labelled corpus:
    `n_rows` methods (4 batches of 1024 and a partial one) of 1 to 200
    random contexts over the artifacts' vocabularies, each labelled with
    the float32 artifact's first legal top-10 name on the GPU. So the
    float32 artifact must score top-1 1.0 (the same kernels on the same
    batches), and every scheme's top-1 accuracy is the share of rows
    whose top-1 equals the float32 artifact's. Per scheme, from the
    command's own timing line (host clock): the artifact's load seconds
    and the evaluation's examples/s, beside the packed reader alone (the
    corpus packed once first, on a line of its own), the text reader
    alone and the device time of its batches (`batch_ms`,
    eval_shape_phase); table
    bytes, top-1/top-10 accuracy, F1 and loss, its mode's kernels
    launched; then the same on a `subset`-row file on the
    GPU against the CPU (plain versions): the top-k of its one batch
    within PATH_REL_TOL away from near-ties, the metrics equal but for
    rows with such a near-tie, the loss within TOL_F32SUM. Returns
    ({scheme: the launch counts of its run}, {scheme: stats})."""
    import numpy as np

    from code2vec_tpu_torch import cli, kernels
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.data.reader import (
        EstimatorAction, PathContextReader,
    )
    from code2vec_tpu_torch.evaluation.evaluator import Evaluator
    from code2vec_tpu_torch.evaluation.metrics import TargetWordTables
    from code2vec_tpu_torch.release.runtime import ReleaseModel

    _, vocabs, _, _ = weights
    rng = np.random.default_rng(seed + 7)
    tw, pw = vocabs.token_vocab.index_to_word, vocabs.path_vocab.index_to_word
    n_tok, n_path = vocabs.token_vocab.size, vocabs.path_vocab.size
    t0 = time.perf_counter()
    bodies = []
    for _ in range(n_rows):
        m = int(rng.integers(1, fs.contexts + 1))
        s, p, t = (rng.integers(1, n_tok, m), rng.integers(1, n_path, m),
                   rng.integers(1, n_tok, m))
        bodies.append(" ".join(f"{tw[int(a)]},{pw[int(b)]},{tw[int(c)]}"
                               for a, b, c in zip(s, p, t)))
    edir = os.path.join(work_dir, "evaluate")
    os.makedirs(edir)
    unlabelled = os.path.join(edir, "unlabelled.c2v")
    with open(unlabelled, "w") as f:
        f.write("".join(f"unlabelled {b}\n" for b in bodies))

    def scored(model):
        """The evaluation of config.test_data_path (one batch) and the
        step's outputs on it."""
        step, params = model.eval_callable()
        outs = []

        def recording(p, *arrays):
            outs.append(step(p, *arrays))
            return outs[-1]

        res = Evaluator(model.config, model.vocabs, recording, model.device,
                        log_path=None).evaluate(params,
                                                model._eval_batches())
        [out] = outs
        return res, out

    def batches(model, path, rows):
        reader = PathContextReader(model.vocabs, model.config,
                                   EstimatorAction.Evaluate, data_path=path,
                                   batch_size=rows, with_target_strings=True)
        for batch in reader:
            yield batch, tuple(torch.from_numpy(np.ascontiguousarray(a))
                               for a in batch.model_arrays())

    f32 = ReleaseModel(Config(serve_artifact=arts["float32"][0], device=dev,
                              verbose_mode=0))
    tables = TargetWordTables(f32.vocabs.target_vocab)
    labels = []
    for batch, arrays in batches(f32, unlabelled, 1024):
        out = f32.eval_step(*(a.to(dev) for a in arrays))
        for row in out.topk_indices.cpu().numpy()[batch.example_valid]:
            legal = [int(i) for i in row if tables.legal(int(i))]
            labels.append(tables.word(legal[0]) if legal else "unlabelled")
    if len(labels) != n_rows:
        fail(f"evaluate: the reader kept {len(labels)} of {n_rows} rows")
    labelled = sum(lb != "unlabelled" for lb in labels) / n_rows
    corpus = os.path.join(edir, "test.c2v")
    with open(corpus, "w") as f:
        f.write("".join(f"{lb} {b}\n" for lb, b in zip(labels, bodies)))
    sub = os.path.join(edir, "subset.c2v")
    with open(sub, "w") as f:
        f.write("".join(f"{lb} {b}\n" for lb, b in
                        zip(labels[:subset], bodies[:subset])))
    log(f"evaluate: a {n_rows}-method labelled corpus written in "
        f"{time.perf_counter() - t0:.1f}s ({labelled:.4f} of the rows "
        f"have a legal float32 top-10 name)")
    # the reader alone, no step: the text reader over the corpus at the
    # evaluation's batch size (its native parse), the one-time pack, and
    # the packed reader the evaluation takes
    t0 = time.perf_counter()
    n_batches = sum(1 for _ in PathContextReader(
        f32.vocabs, f32.config, EstimatorAction.Evaluate, data_path=corpus,
        batch_size=f32.config.test_batch_size, with_target_strings=True))
    text_s = time.perf_counter() - t0
    ds = timed_pack(f32, corpus, "evaluate")
    t0 = time.perf_counter()
    if sum(1 for _ in ds.iter_batches(f32.config.test_batch_size,
                                      EstimatorAction.Evaluate,
                                      with_target_strings=True)) != n_batches:
        fail("evaluate: the packed and text readers give other batch counts")
    parse_s = time.perf_counter() - t0
    del f32, ds
    torch.cuda.empty_cache()
    log(f"evaluate: the readers alone: the packed reader gives the "
        f"{n_batches} batches in {parse_s:.3f}s ({n_rows / parse_s:.0f} "
        f"rows/s), the text reader (native parse) in {text_s:.3f}s "
        f"({n_rows / text_s:.0f} rows/s)")

    runs, stats = {}, {}
    logger = logging.getLogger("code2vec_tpu_torch")
    for scheme in EVAL_FORMATS:
        art, meta = arts[scheme]
        mode = SCHEME_MODES[scheme]
        kernels.reset_launch_counts()
        captured = LogLines()
        logger.addHandler(captured)
        level = logger.level
        logger.setLevel(logging.INFO)
        t0 = time.perf_counter()
        try:
            res = cli.main(["evaluate", "--artifact", art, "--test", corpus,
                            "--eval_log", os.path.join(edir, f"{scheme}.log"),
                            "--device", dev])
            torch.cuda.synchronize()
        finally:
            logger.removeHandler(captured)
            logger.setLevel(level)
        secs = time.perf_counter() - t0
        timing = [re.search(r"artifact load ([0-9.]+)s, (\d+) examples "
                            r"scored in ([0-9.]+)s", ln)
                  for ln in captured.lines]
        timing = [m for m in timing if m]
        if len(timing) != 1 or int(timing[0].group(2)) != n_rows:
            fail(f"evaluate {scheme}: no timing line for {n_rows} examples "
                 f"in the command's log: {captured.lines[-3:]}")
        load_s, eval_s = float(timing[0].group(1)), float(timing[0].group(3))
        counts = kernels.launch_counts()
        runs[scheme] = counts
        missing = [k for k in kernels.SERVE_KERNELS[mode] if counts[k] <= 0]
        if missing:
            fail(f"evaluate {scheme}: launched no {missing}")
        if not (np.isfinite(res.loss) and np.isfinite(res.topk_acc).all()):
            fail(f"evaluate {scheme}: {res}")
        if scheme == "float32" and res.topk_acc[0] != labelled:
            fail(f"evaluate float32: top-1 {res.topk_acc[0]} on its own "
                 f"top-1 labels (want {labelled})")
        nbytes = meta["table_bytes"]["artifact"]
        device_s = batch_ms[scheme] * n_batches / 1e3
        stats[scheme] = dict(
            examples_per_s=n_rows / eval_s, load_s=load_s, eval_s=eval_s,
            command_s=secs, parse_s=parse_s, text_s=text_s,
            device_s=device_s,
            table_bytes=nbytes, top1=float(res.topk_acc[0]),
            top10=float(res.topk_acc[-1]), f1=float(res.subtoken_f1),
            loss=float(res.loss), top1_agrees_with_f32=float(res.topk_acc[0]))
        log(f"evaluate {scheme}: the command in {secs:.2f}s: artifact load "
            f"{load_s:.3f}s, {n_rows} methods scored in {eval_s:.3f}s "
            f"({n_rows / eval_s:.0f} examples/s; the packed reader alone "
            f"{parse_s:.3f}s, the kernels {device_s:.3f}s of device time "
            f"for {n_batches} batches); tables {nbytes / 1e6:.1f} MB; top-1 "
            f"{res.topk_acc[0]:.4f} (= the share of rows whose top-1 equals "
            f"float32's) top-10 {res.topk_acc[-1]:.4f} F1 "
            f"{res.subtoken_f1:.4f} loss {res.loss:.4f}")

        # the subset on the GPU against the CPU: one batch, whose step
        # outputs the evaluation keeps
        cfg = dict(serve_artifact=art, test_data_path=sub,
                   test_batch_size=subset, verbose_mode=0)
        gpu = ReleaseModel(Config(device=dev, **cfg))
        cpu = ReleaseModel(Config(device="cpu", **cfg),
                           artifact=gpu.artifact)
        (g_res, got), (c_res, want) = scored(gpu), scored(cpu)
        tol = (PATH_REL_TOL * float(want.topk_values.abs().max()), 0.0)
        err, ok = max_err(got.topk_values.cpu(), want.topk_values, tol)
        same, bad = topk_agreement(got.topk_indices.cpu(),
                                   want.topk_indices, want.topk_values,
                                   (2 * tol[0], 0.0))
        near_rows = int((got.topk_indices.cpu() != want.topk_indices)
                        .any(dim=1).sum())
        acc_rows = np.abs(g_res.topk_acc - c_res.topk_acc) * subset
        err_l, ok_l = max_err(torch.tensor(g_res.loss),
                              torch.tensor(c_res.loss), TOL_F32SUM)
        if not ok or bad or not ok_l or (acc_rows > near_rows + 1e-9).any() \
                or (near_rows == 0 and g_res.subtoken_f1
                    != c_res.subtoken_f1):
            fail(f"evaluate {scheme} GPU vs CPU on {subset} rows: values "
                 f"{err} (tol {tol[0]:.3g}), {bad} indices away from "
                 f"near-ties, accuracy {g_res.topk_acc} vs "
                 f"{c_res.topk_acc} ({near_rows} near-tie rows), F1 "
                 f"{g_res.subtoken_f1} vs {c_res.subtoken_f1}, loss "
                 f"{g_res.loss} vs {c_res.loss}")
        log(f"evaluate {scheme}: GPU vs CPU on {subset} rows: top-k "
            f"indices equal {same}/{got.topk_indices.numel()} ({near_rows} "
            f"rows with a near-tie), values within {err:.3g}, top-1 "
            f"{g_res.topk_acc[0]:.4f} vs {c_res.topk_acc[0]:.4f}, F1 "
            f"{g_res.subtoken_f1:.4f} vs {c_res.subtoken_f1:.4f}, loss "
            f"{g_res.loss:.6f} vs {c_res.loss:.6f}")
        del gpu, cpu, got, want
        torch.cuda.empty_cache()
    return runs, stats


# ------------------------------------------------------------- data path

DATA_ROWS = 64 * 1024      # 64 steps an epoch at B 1024
TEXT_STEPS = 8             # the --no_packed_data runs beside them


def write_data_corpus(work_dir: str, seed: int, fs, ft, n_rows: int,
                      n_names: int = 64, tokens_per_name: int = 64):
    """PREFIX.dict.c2v with the java14m vocabulary sizes and
    PREFIX.train.c2v (PREFIX: `data` under `work_dir`) of `n_rows`
    methods of ft.contexts contexts each, written as write_train_corpus
    writes them (each of `n_names` names owns `tokens_per_name` tokens;
    paths drawn from the whole vocabulary), but built as byte arrays: the
    words are the vocabulary's six-digit ones, so every context is 23
    bytes."""
    import pickle

    import numpy as np

    rng = np.random.default_rng(seed)
    v_tok, v_path, v_tgt = (fs.vocab["token"], fs.vocab["path"],
                            fs.vocab["target"])
    prefix = os.path.join(work_dir, "data")
    with open(prefix + ".dict.c2v", "wb") as f:
        pickle.dump({f"t{i}": v_tok - i for i in range(v_tok)}, f)
        pickle.dump({f"p{i}": v_path - i for i in range(v_path)}, f)
        pickle.dump({f"name|w{i}": v_tgt - i for i in range(v_tgt)}, f)
        pickle.dump(n_rows, f)
    owned = 10 ** 5 + rng.choice(v_tok - 10 ** 5,
                                 size=(n_names, tokens_per_name),
                                 replace=False)
    names = rng.integers(0, n_names, n_rows)
    name_bytes = [f"name|w{n * 997 % v_tgt} ".encode()
                  for n in range(n_names)]
    m = ft.contexts
    powers = 10 ** np.arange(5, -1, -1)

    def digits(x):   # (..., 6) ASCII digits of six-digit numbers
        return (x[..., None] // powers % 10 + 48).astype(np.uint8)

    with open(prefix + ".train.c2v", "wb", buffering=16 * 2 ** 20) as f:
        for start in range(0, n_rows, 4096):
            rows = names[start:start + 4096]
            toks = owned[rows[:, None, None],
                         rng.integers(0, tokens_per_name, (len(rows), 2, m))]
            pths = rng.integers(10 ** 5, v_path, (len(rows), m))
            rec = np.empty((len(rows), m, 24), np.uint8)
            rec[..., 0], rec[..., 8], rec[..., 16] = ord("t"), ord("p"), \
                ord("t")
            rec[..., 7] = rec[..., 15] = ord(",")
            rec[..., 23] = ord(" ")
            rec[:, -1, 23] = ord("\n")
            rec[..., 1:7] = digits(toks[:, 0])
            rec[..., 9:15] = digits(pths)
            rec[..., 17:23] = digits(toks[:, 1])
            for name, line in zip(rows.tolist(), rec):
                f.write(name_bytes[name])
                f.write(line.tobytes())
    return prefix


def require_native(what: str) -> None:
    """Fail unless the data path takes the native route: the library
    that make built loads."""
    from code2vec_tpu_torch.data import native
    if native.load_library() is None:
        fail(f"{what}: libc2vdata.so does not load from "
             f"{native.library_path()}; the data path would fall back to "
             f"the Python parse")


def timed_pack(model, c2v_path: str, what: str):
    """`model`'s one-time pack of `c2v_path` (what its reader would do
    on first use), timed and logged on its own line, the native tables
    of its vocabularies (built once per vocabularies) apart."""
    from code2vec_tpu_torch.data import native
    from code2vec_tpu_torch.data.packed import PackedDataset
    require_native(what)
    existed = os.path.exists(c2v_path + "b")
    t0 = time.perf_counter()
    native.tables_for(model.vocabs)
    tables_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = model._packed_dataset(c2v_path)
    secs = time.perf_counter() - t0
    rows = PackedDataset.read_header(c2v_path + "b")[0]
    log(f"{what}: one-time pack of {os.path.basename(c2v_path)} "
        + ("(already packed)" if existed else
           f"-> .c2vb, {rows} rows in {secs:.2f}s ({rows / secs:.0f} "
           f"rows/s, native; the vocabularies' native tables built in "
           f"{tables_s:.2f}s before)"))
    return ds


class python_parse:
    """Within it, the port's parse and pack take their Python route, in
    this process and in the pack's worker processes."""

    def __enter__(self):
        from code2vec_tpu_torch.data import native
        self.native = native
        self.env = os.environ.get("C2V_NATIVE_DATALOADER")
        self.saved = native._lib, native._lib_checked
        os.environ["C2V_NATIVE_DATALOADER"] = os.path.join(
            REPO, "cpp", "build", "absent", "libc2vdata.so")
        native._lib, native._lib_checked = None, True
        return self

    def __exit__(self, *exc):
        self.native._lib, self.native._lib_checked = self.saved
        if self.env is None:
            os.environ.pop("C2V_NATIVE_DATALOADER", None)
        else:
            os.environ["C2V_NATIVE_DATALOADER"] = self.env


def id_checksum(arrays, weights):
    """A position-weighted int64 sum of a batch's ids on the device
    (source, path and target tokens, the label): a byte moved or
    overwritten changes it."""
    src, pth, tgt, _, label = arrays[:5]
    n = src.numel()
    return (sum((a.reshape(-1).long() * weights[:n]).sum()
                for a in (src, pth, tgt))
            + (label.long() * weights[:label.numel()]).sum())


def host_checksum(np, batch, weights) -> int:
    """id_checksum of a host RowBatch."""
    ids = (batch.source_token_indices, batch.path_indices,
           batch.target_token_indices)
    n = ids[0].size
    return int(sum(int((a.reshape(-1).astype(np.int64) * weights[:n]).sum())
                   for a in ids)
               + int((batch.target_index.astype(np.int64)
                      * weights[:batch.target_index.size]).sum()))


def traced_train(torch, argv, label: str, checksum_steps: int = 0):
    """The `train` command's model (as `cli.main(argv)` builds it) trained
    with CUDA events around every step and the host time of each log
    line; its one-time packs on lines of their own first. The first
    `checksum_steps` steps also sum their ids on the device
    (id_checksum). Returns (model, stats)."""
    from code2vec_tpu_torch import cli, kernels
    from code2vec_tpu_torch.model_facade import Code2VecModel

    _, config = cli.config_from_args(argv)
    stamps = []
    config.verbose_mode = 0
    config.log = lambda msg: stamps.append((time.perf_counter(), msg))
    t0 = time.perf_counter()
    model = Code2VecModel(config)
    build_s = time.perf_counter() - t0
    if config.use_packed_data:
        timed_pack(model, config.train_data_path, label)
        if config.is_testing:
            timed_pack(model, config.test_data_path, label)
    make = model.builder.make_train_step
    events, sums = [], []
    weights = (torch.arange(config.train_batch_size * config.max_contexts,
                            dtype=torch.int64, device=model.device)
               % 65521 + 1)

    def make_traced(state):
        step = make(state)

        def run(state, *arrays):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = step(state, *arrays)
            e1.record()
            events.append((e0, e1))
            if len(events) <= checksum_steps:
                sums.append(id_checksum(arrays, weights))
            return out
        return run

    model.builder.make_train_step = make_traced
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    model.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ends = [t for t, msg in stamps
            if msg.startswith("Epoch ") and " done: " in msg]
    start = [t for t, msg in stamps if msg.startswith("Starting training")]
    return model, dict(
        build_s=build_s, wall_s=wall, epoch_ends=ends, start=start[0],
        busy_ms=[e0.elapsed_time(e1) for e0, e1 in events],
        sums=torch.stack(sums).cpu().tolist() if sums else [],
        counts=kernels.launch_counts(), losses=model.trainer.epoch_losses)


def data_path_phase(torch, seed: int, work_dir: str, fs, ft,
                    n_rows: int = DATA_ROWS, dev: str = "cuda"):
    """The data path at full width: a synthetic corpus of `n_rows`
    methods with the java14m vocabularies (M 200), packed by the port's
    pack_c2v natively and by its Python route (all host cores), the two
    byte-identical; the pack, a PackedDataset gather of a batch and the
    text parse of the same rows (native and Python) timed alone, rows/s;
    `train` from the `.c2vb` for 2 epochs of 64 steps, dense and then
    sparse: examples/s over the second epoch (host clock between the
    epochs' ends, which wait for the device) and the device's busy share
    (CUDA events around each step against that wall time), beside the
    same numbers for TEXT_STEPS steps read from text with
    --no_packed_data; every train kernel once a step; and the
    prefetcher's check: over the dense run's first epoch, each batch's
    id checksum as the device received it equals the host's. Returns
    ({run: launch counts}, stats)."""
    import filecmp

    import numpy as np

    from code2vec_tpu_torch import kernels
    from code2vec_tpu_torch.data import native, packed
    from code2vec_tpu_torch.data.reader import (
        EstimatorAction, parse_context_lines,
    )
    from code2vec_tpu_torch.vocab import Code2VecVocabs, load_word_freq_dicts

    ddir = os.path.join(work_dir, "data")
    os.makedirs(ddir)
    t_phase = t0 = time.perf_counter()
    prefix = write_data_corpus(ddir, seed + 13, fs, ft, n_rows)
    text = prefix + ".train.c2v"
    log(f"data: wrote a {n_rows}-method corpus "
        f"({os.path.getsize(text) / 1e6:.0f} MB of text) with java14m "
        f"vocabularies in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    vocabs = Code2VecVocabs.create_from_freq_dicts(
        load_word_freq_dicts(prefix + ".dict.c2v"),
        max_token_vocab_size=fs.vocab["token"],
        max_path_vocab_size=fs.vocab["path"],
        max_target_vocab_size=fs.vocab["target"])
    log(f"data: vocabularies built in {time.perf_counter() - t0:.1f}s")

    # the pack, native and Python
    require_native("data")
    t0 = time.perf_counter()
    native.tables_for(vocabs)
    tables_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nat = packed.pack_c2v(text, vocabs, ft.contexts,
                          out_path=prefix + ".native.c2vb")
    native_s = time.perf_counter() - t0
    workers = os.cpu_count() or 1
    with python_parse():
        t0 = time.perf_counter()
        py = packed.pack_c2v(text, vocabs, ft.contexts,
                             out_path=prefix + ".python.c2vb",
                             num_workers=workers)
        python_s = time.perf_counter() - t0
    same = {s: filecmp.cmp(nat + s, py + s, shallow=False)
            for s in ("", ".targets")}
    rows = packed.PackedDataset.read_header(nat)[0]
    log(f"data: pack_c2v of {rows} rows: native {native_s:.2f}s "
        f"({rows / native_s:.0f} rows/s; its tables built in "
        f"{tables_s:.2f}s), Python route on {workers} processes "
        f"{python_s:.2f}s ({rows / python_s:.0f} rows/s); .c2vb and "
        f".targets byte-identical: {same}")
    if rows != n_rows or not all(same.values()):
        fail(f"data: the native and Python packs differ ({same}) or hold "
             f"{rows} rows")
    os.replace(nat, prefix + ".train.c2vb")
    for s in (".targets", ".meta.json"):
        os.replace(nat + s, prefix + ".train.c2vb" + s)
        os.unlink(py + s)
    os.unlink(py)

    # alone: the gather of a batch, the text parse of the same rows
    ds = packed.PackedDataset(prefix + ".train.c2vb", vocabs)
    rng = np.random.default_rng(seed)
    times = []
    for _ in range(21):
        batch_rows = rng.permutation(n_rows)[:ft.rows]
        t0 = time.perf_counter()
        ds.gather(batch_rows)
        times.append(time.perf_counter() - t0)
    gather_s = statistics.median(times[1:])
    with open(text) as f:
        lines = [next(f) for _ in range(8 * ft.rows)]
    t0 = time.perf_counter()
    parsed = parse_context_lines(lines, vocabs, ft.contexts,
                                 keep_strings=False)
    native_parse_s = time.perf_counter() - t0
    n_py = 2 * ft.rows
    with python_parse():
        t0 = time.perf_counter()
        py_parsed = parse_context_lines(lines[:n_py], vocabs, ft.contexts,
                                        keep_strings=False)
        python_parse_s = time.perf_counter() - t0
    gathered = ds.gather(np.arange(n_py))
    for name in ("source_token_indices", "path_indices",
                 "target_token_indices", "context_valid_mask",
                 "target_index"):
        if not (np.array_equal(getattr(parsed, name)[:n_py],
                               getattr(py_parsed, name))
                and np.array_equal(getattr(gathered, name),
                                   getattr(py_parsed, name))):
            fail(f"data: {name} differs between the native parse, the "
                 f"Python parse and the gather")
    stats = dict(pack_native_rows_per_s=rows / native_s,
                 pack_python_rows_per_s=rows / python_s,
                 pack_python_workers=workers,
                 gather_rows_per_s=ft.rows / gather_s,
                 parse_native_rows_per_s=len(lines) / native_parse_s,
                 parse_python_rows_per_s=n_py / python_parse_s)
    log(f"data: alone: PackedDataset.gather of {ft.rows} random rows "
        f"{gather_s * 1e3:.2f} ms ({stats['gather_rows_per_s']:.0f} rows/s, "
        f"median of 20, warm page cache); text parse native "
        f"{native_parse_s:.3f}s for {len(lines)} rows "
        f"({stats['parse_native_rows_per_s']:.0f} rows/s), Python "
        f"{python_parse_s:.3f}s for {n_py} rows "
        f"({stats['parse_python_rows_per_s']:.0f} rows/s); the three give "
        f"the same arrays")
    del ds, lines, parsed, py_parsed, gathered

    # train from .c2vb, dense and sparse, beside TEXT_STEPS steps of text
    steps = n_rows // ft.rows
    tprefix = os.path.join(ddir, "text")
    with open(text) as f, open(tprefix + ".train.c2v", "w") as out:
        for _ in range(TEXT_STEPS * ft.rows):
            out.write(next(f))
    os.symlink(prefix + ".dict.c2v", tprefix + ".dict.c2v")
    base = ["train", "--seed", str(seed), "--batch_size", str(ft.rows),
            "--max_contexts", str(ft.contexts), "--device", dev]
    runs, counts = {}, {}
    for mode in ("dense", "sparse"):
        extra = ["--sparse_embedding_update"] if mode == "sparse" else []
        names = (kernels.SPARSE_TRAIN_KERNELS if mode == "sparse"
                 else kernels.TRAIN_KERNELS)
        for src in ("packed", "text"):
            n_steps, n_epochs = ((steps, 2) if src == "packed"
                                 else (TEXT_STEPS, 1))
            argv = base + extra + ["--epochs", str(n_epochs)] + (
                ["--data", prefix] if src == "packed"
                else ["--data", tprefix, "--no_packed_data"])
            check = (mode, src) == ("dense", "packed")
            model, st = traced_train(torch, argv, f"data {mode}",
                                     n_steps if check else 0)
            losses = st["losses"]
            if [len(e) for e in losses] != [n_steps] * n_epochs or \
                    not all(math.isfinite(x) for e in losses for x in e):
                fail(f"data {mode} {src}: epochs of "
                     f"{[len(e) for e in losses]} steps (want {n_epochs} of "
                     f"{n_steps}) or a loss not finite")
            want = {k: n_steps * n_epochs for k in names}
            if mode == "sparse":
                want["encoder_backward"] = 0
            got = {k: st["counts"][k] for k in want}
            if got != want:
                fail(f"data {mode} {src}: launches {got}, expected {want}")
            counts[f"{mode}_{src}"] = st["counts"]
            if src == "packed":
                t1, t2 = st["epoch_ends"]
                wall = t2 - t1
                busy = sum(st["busy_ms"][n_steps:]) / 1e3
            else:
                wall = st["epoch_ends"][0] - st["start"]
                busy = sum(st["busy_ms"]) / 1e3
            runs[f"{mode}_{src}"] = dict(
                examples_per_s=n_steps * ft.rows / wall, wall_s=wall,
                busy_share=busy / wall, step_ms=statistics.median(
                    st["busy_ms"]), build_s=st["build_s"])
            r = runs[f"{mode}_{src}"]
            log(f"data: train {mode} from {src}: "
                + (f"epoch 2 ({n_steps} steps)" if src == "packed" else
                   f"{n_steps} steps, the text read and parsed included")
                + f" in {wall:.3f}s, {r['examples_per_s']:.0f} examples/s, "
                f"device busy {r['busy_share']:.3f} of it (median step "
                f"{r['step_ms']:.2f} ms by CUDA events); model built in "
                f"{st['build_s']:.1f}s; epoch means "
                f"{[round(statistics.mean(e), 4) for e in losses]}")
            if check:
                weights = np.arange(ft.rows * ft.contexts,
                                    dtype=np.int64) % 65521 + 1
                host = [host_checksum(np, b, weights)
                        for b in model._train_corpus().iter_batches(
                            ft.rows, EstimatorAction.Train, num_epochs=1,
                            seed=seed)]
                if host != st["sums"] or len(host) != steps:
                    bad = [i for i, (a, b) in enumerate(zip(host, st["sums"]))
                           if a != b]
                    fail(f"data: the prefetcher delivered {len(st['sums'])} "
                         f"batches whose device checksums differ from the "
                         f"host's at {bad[:8]} (of {len(host)})")
                log(f"data: prefetcher check: the {len(host)} batches of "
                    f"epoch 1 as the device received them have the host's "
                    f"id checksums")
            del model
            gc.collect()
            torch.cuda.empty_cache()
    stats["runs"] = runs
    shutil.rmtree(ddir)
    stats["phase_s"] = time.perf_counter() - t_phase
    log(f"data: the phase in {stats['phase_s']:.1f}s")
    return counts, stats


# -------------------------------------------------------------- capstone

CAPSTONE_EPOCHS = 14
# the reference's test scores on this corpus (experiments/results/
# accuracy.json and accuracy_sparse.json), and the floors the port is held
# to: its dropout bits differ (Philox, not threefry), so it is held to a
# floor, not to equality; a broken shuffle, vocabulary or row filter lands
# far below it
CAPSTONE_REFERENCE = {"dense": (0.660, 0.467), "sparse": (0.654, 0.464)}
CAPSTONE_FLOOR = (0.62, 0.42)   # test F1, top-1


def capstone_phase(torch, work_dir: str, dev: str = "cuda"):
    """The accuracy run of the in-repo generated Java corpus through the
    port's own commands, as experiments/accuracy_bench.py:35-72 builds it:
    experiments/javagen.py generate_corpus (seed 17; 2,400/260/260
    files), the port's extract_dir over cpp/build/c2v-extract, its
    preprocess (M 200); then `train --data P --test P.val.c2v --save M
    --epochs 14 --batch_size 1024` at the default dims and bf16 moments,
    dense and then with --sparse_embedding_update, each followed by
    `evaluate --load M --test P.test.c2v`: the val F1 of every epoch, the
    test F1 and top-1 (held to CAPSTONE_FLOOR), each stage's wall seconds
    and the train examples/s. The dense run also takes --profile_dir,
    --tensorboard, --heartbeat_file, --metrics_file and --trace_export
    (capstone_exports), so its examples/s includes torch.profiler over
    batches 10-20 and the exports; the sparse run's does not. Also
    compile_corpus on 4 workers over the
    same raw files: its `.c2vb` rows equal the pack of the serial
    preprocess's text (under the compile's vocabularies) wherever a
    method holds at most 200 contexts; the over-budget ones, which the
    two sample independently (per method against one stream), keep their
    label. Returns (launch counts, stats)."""
    import numpy as np

    from code2vec_tpu_torch import cli, kernels
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.data import packed
    from code2vec_tpu_torch.data import preprocess as pp
    from code2vec_tpu_torch.vocab import Code2VecVocabs, load_word_freq_dicts
    from experiments import javagen

    root = os.path.join(work_dir, "capstone")
    quiet = lambda *a: None  # noqa: E731
    stages = {}
    t_phase = t0 = time.perf_counter()
    dirs = javagen.generate_corpus(os.path.join(root, "src"), log=quiet)
    stages["generate_s"] = time.perf_counter() - t0
    cores = os.cpu_count() or 1
    t0 = time.perf_counter()
    raws = {role: pp.extract_dir(dirs[role],
                                 os.path.join(root, f"{role}.raw.txt"),
                                 num_threads=cores,
                                 shuffle=role == "train",
                                 num_workers=min(4, cores), log=quiet)
            for role in ("train", "val", "test")}
    stages["extract_s"] = time.perf_counter() - t0
    shutil.rmtree(os.path.join(root, "src"))
    prefix = os.path.join(root, "genjava")
    require_native("capstone")
    t0 = time.perf_counter()
    pp.preprocess(raws["train"], raws["val"], raws["test"], prefix,
                  max_contexts=200, log=quiet)
    stages["preprocess_s"] = time.perf_counter() - t0
    cprefix = os.path.join(root, "compiled", "genjava")
    os.makedirs(os.path.dirname(cprefix))
    t0 = time.perf_counter()
    pp.compile_corpus(raws["train"], raws["val"], raws["test"], cprefix,
                      max_contexts=200, num_workers=4, log=quiet)
    stages["compile_s"] = time.perf_counter() - t0
    cfg = Config()
    sizes = dict(max_token_vocab_size=cfg.max_token_vocab_size,
                 max_path_vocab_size=cfg.max_path_vocab_size,
                 max_target_vocab_size=cfg.max_target_vocab_size)
    cvocabs = Code2VecVocabs.create_from_freq_dicts(
        load_word_freq_dicts(cprefix + ".dict.c2v"), **sizes)
    compared = {}
    for role in ("train", "val", "test"):
        over = []
        with open(raws[role], "rb") as f:
            for line in f:
                k = line.count(b" ")
                if k:
                    over.append(k > 200)
        over = np.asarray(over)
        serial = packed.pack_c2v(f"{prefix}.{role}.c2v", cvocabs, 200,
                                 out_path=f"{cprefix}.{role}.serial.c2vb")
        a = packed.PackedDataset(f"{cprefix}.{role}.c2vb", cvocabs)._rec
        b = packed.PackedDataset(serial, cvocabs)._rec
        with open(f"{cprefix}.{role}.c2vb.targets", "rb") as f, \
                open(serial + ".targets", "rb") as g:
            same_names = f.read() == g.read()
        if a.shape != b.shape or len(over) != a.shape[0] or \
                not same_names or not np.array_equal(a[~over], b[~over]) or \
                not np.array_equal(a[over, 0], b[over, 0]):
            fail(f"capstone: compile_corpus's {role} rows differ from the "
                 f"pack of preprocess's text ({a.shape} vs {b.shape}, "
                 f"{int(over.sum())} over-budget methods, names equal "
                 f"{same_names})")
        compared[role] = (a.shape[0], int(over.sum()))
    n_train = packed.PackedDataset.read_header(cprefix + ".train.c2vb")[0]
    log(f"capstone: generate {stages['generate_s']:.1f}s, extract "
        f"{stages['extract_s']:.1f}s, preprocess (serial, M 200) "
        f"{stages['preprocess_s']:.1f}s, compile_corpus (4 workers) "
        f"{stages['compile_s']:.1f}s; {n_train} train methods; the "
        f"compile's rows equal the serial pack's, row for row, but for "
        f"the over-budget methods' sampled contexts: "
        + ", ".join(f"{r} {n} rows ({o} over budget)"
                    for r, (n, o) in compared.items()))
    shutil.rmtree(os.path.dirname(cprefix))

    results, all_counts, exports = {}, {}, {}
    for mode in ("dense", "sparse"):
        save = os.path.join(root, mode, "model")
        os.makedirs(os.path.dirname(save))
        argv = ["train", "--data", prefix, "--test", prefix + ".val.c2v",
                "--save", save, "--epochs", str(CAPSTONE_EPOCHS),
                "--batch_size", "1024", "--eval_log",
                os.path.join(root, mode, "val.log"), "--device", dev]
        if mode == "sparse":
            argv.append("--sparse_embedding_update")
        else:
            # the loop's exports on the dense run (capstone_exports)
            argv += ["--profile_dir", os.path.join(root, mode, "profile"),
                     "--tensorboard", "--heartbeat_file",
                     os.path.join(root, mode, "heartbeat.json"),
                     "--metrics_file", os.path.join(root, mode, "m.prom"),
                     "--trace_export", os.path.join(root, mode, "spans.json")]
        model, st = traced_train(torch, argv, f"capstone {mode}")
        if mode == "dense":
            exports = capstone_exports(os.path.join(root, mode), save,
                                       int(model.state.step))
        curve = [float(r.subtoken_f1) for _, r in model.trainer.eval_results]
        n_steps = int(model.state.step)
        examples = n_steps * 1024
        del model
        gc.collect()
        torch.cuda.empty_cache()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        # a sparse checkpoint loads under its own optimizer layout
        res = cli.main(["evaluate", "--load", save, "--test",
                        prefix + ".test.c2v", "--eval_log",
                        os.path.join(root, mode, "test.log"), "--device",
                        dev] + argv[argv.index("--device") + 2:])
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        counts = {k: st["counts"][k] + v
                  for k, v in kernels.launch_counts().items()}
        all_counts[mode] = counts
        names = (kernels.SPARSE_TRAIN_KERNELS if mode == "sparse"
                 else kernels.TRAIN_KERNELS) + SERVE_KERNELS
        missing = [k for k in names if counts[k] <= 0]
        f1, top1 = float(res.subtoken_f1), float(res.topk_acc[0])
        train_s = st["wall_s"]
        with_exports = ("" if mode == "sparse" else ", and the profiler "
                        "over batches 10-20 and the exports on")
        results[mode] = dict(val_f1=curve, test_f1=f1, test_top1=top1,
                             train_s=train_s, evaluate_s=eval_s,
                             steps=n_steps,
                             examples_per_s=examples / train_s,
                             step_ms=statistics.median(st["busy_ms"]))
        ref = CAPSTONE_REFERENCE[mode]
        log(f"capstone {mode}: val F1 by epoch {[round(x, 4) for x in curve]}"
            f"; test F1 {f1:.4f} top-1 {top1:.4f} (reference {ref[0]:.3f} / "
            f"{ref[1]:.3f}; floor {CAPSTONE_FLOOR[0]} / {CAPSTONE_FLOOR[1]});"
            f" train {train_s:.1f}s for {CAPSTONE_EPOCHS} epochs, "
            f"{n_steps} steps ({examples / train_s:.0f} examples/s with the "
            f"epoch-end evaluations and saves{with_exports}; median step "
            f"{results[mode]['step_ms']:.2f} ms by CUDA events), evaluate "
            f"{eval_s:.1f}s")
        if missing or len(curve) != CAPSTONE_EPOCHS:
            fail(f"capstone {mode}: launched no {missing}, or "
                 f"{len(curve)} val points")
        if f1 < CAPSTONE_FLOOR[0] or top1 < CAPSTONE_FLOOR[1]:
            fail(f"capstone {mode}: test F1 {f1:.4f} / top-1 {top1:.4f} "
                 f"below the floor {CAPSTONE_FLOOR}")
        shutil.rmtree(os.path.join(root, mode))
    shutil.rmtree(root)
    stages["phase_s"] = time.perf_counter() - t_phase
    log(f"capstone: the phase in {stages['phase_s']:.1f}s")
    return all_counts, dict(stages, exports=exports, **results)


def capstone_exports(run_dir: str, save: str, steps: int) -> dict:
    """What the capstone's dense `train --profile_dir --tensorboard
    --heartbeat_file --metrics_file --trace_export` wrote: a
    torch.profiler Chrome trace of batches 10-20 that names K1, K2 and
    K5-K8 by their CUDA symbols (TRACE_SYMBOLS), an event file under
    `<save>_tb` that decodes (every record's CRC) to train/loss and eval/*
    scalars, the heartbeat `done` at the last step, the metrics file, and
    the host spans of the step loop. Returns their sizes and counts."""
    import glob

    from code2vec_tpu_torch.utils.tb import read_scalars

    traces = glob.glob(os.path.join(run_dir, "profile", "*.json"))
    if len(traces) != 1:
        fail(f"capstone: profiler traces {traces}, expected one")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernel_names = {e.get("name", "") for e in events
                    if str(e.get("cat", "")).lower() == "kernel"}
    missing = [k for k, sym in TRACE_SYMBOLS.items()
               if not any(sym in name for name in kernel_names)]
    if missing:
        fail(f"capstone: the profiler trace names no kernel of {missing} "
             f"({len(kernel_names)} kernel names, e.g. "
             f"{sorted(kernel_names)[:8]})")
    files = glob.glob(save + "_tb/events.out.tfevents.*")
    if len(files) != 1:
        fail(f"capstone: event files {files}, expected one")
    scalars = read_scalars(files[0])
    tags = {t for t, _, _ in scalars}
    if "train/loss" not in tags or not any(t.startswith("eval/")
                                           for t in tags):
        fail(f"capstone: the event file's tags {sorted(tags)[:20]} lack "
             f"train/loss or eval/*")
    beat = read_heartbeat(os.path.join(run_dir, "heartbeat.json"))
    if beat["status"] != "done" or beat["step"] != steps:
        fail(f"capstone: heartbeat {beat}, expected done at step {steps}")
    with open(os.path.join(run_dir, "m.prom")) as f:
        exported = metric_values(f.read())
    if exported.get(("train_batches_total", ()), 0) < steps:
        fail("capstone: the metrics file lacks the run's train batches")
    with open(os.path.join(run_dir, "spans.json")) as f:
        spans = {e.get("name") for e in json.load(f)["traceEvents"]}
    if not {"data_wait", "step_dispatch", "loss_sync"} <= spans:
        fail(f"capstone: the host spans {sorted(spans)[:20]}")
    stats = dict(trace_mb=os.path.getsize(traces[0]) / 1e6,
                 kernel_names=len(kernel_names), scalars=len(scalars),
                 train_loss_points=sum(t == "train/loss"
                                       for t, _, _ in scalars))
    log(f"capstone: the dense run's exports: profiler trace "
        f"{stats['trace_mb']:.1f} MB naming K1, K2, K5-K8 ("
        + ", ".join(sorted({next(n for n in kernel_names if sym in n)
                            for sym in TRACE_SYMBOLS.values()}))
        + f"); {stats['scalars']} TensorBoard scalars "
        f"({stats['train_loss_points']} train/loss); heartbeat done at "
        f"step {steps}; metrics file and host spans written")
    return stats


# ------------------------------------------------------- the parallel steps

# The plans the parallel phase runs, each as ranks that share cuda:0 over
# gloo: (name, (dp, tp, cp), sparse)
PARALLEL_PLANS = (("tp2 dense", (1, 2, 1), False),
                  ("tp2 sparse", (1, 2, 1), True),
                  ("cp2 dense", (1, 1, 2), False),
                  ("dp2 sparse", (2, 1, 1), True),
                  ("dp2 tp2 cp2 dense", (2, 2, 2), False))
PARALLEL_RANKS = 8
PARALLEL_STEPS = 2
PARALLEL_TIMEOUT_S = 600
# Against the single-device step after PARALLEL_STEPS steps: the loss
# within 1e-3 relative (the f32 sums over ranks and split products run in
# another order, and a bf16 rounding they move changes the second step's
# inputs by a step); a parameter moves by at most 2 lr a step apart (an
# Adam step whose gradient is near 0 can change sign), and at most
# PARALLEL_FLIP_SHARE of a tensor's elements by more than 1e-5 + 1e-5 |p|.
PARALLEL_LOSS_RTOL = 1e-3
PARALLEL_FLIP_SHARE = 0.02
# Each plan's gradients of the first batch, before any step, against the
# single-device step's, leaf by leaf (a table's on this rank's shard):
# within one bf16 step at the leaf's largest value (the step check's
# bar: both sides round the code vectors' cotangent, the attention
# weights and the row gradients to bf16, and sums over ranks move those
# roundings), a table row within one such step per position that names
# it (each adds a bf16 row gradient), and |g - ref| / |ref| (Frobenius)
# at most PARALLEL_GRAD_RESID: bf16 flips move an element by 2^-8 of
# itself at most, while a leaf counted twice, or missing a rank's part,
# is off by a share of 1 or 1/2.
PARALLEL_GRAD_RESID = 1e-2


def parallel_dims(fs):
    """The java14m tables padded to a multiple of 2 (tp 2), the real
    target rows and the OOV/PAD floor."""
    from code2vec_tpu_torch.models.code2vec import ModelDims
    return ModelDims(fs.vocab["token"] + 1, fs.vocab["path"] + 1,
                     fs.vocab["target"] + 1, token_dim=fs.token_dim,
                     path_dim=fs.path_dim, target_oov_floor=1).padded_to(2)


def parallel_config(ft, shape, sparse: bool):
    from code2vec_tpu_torch.config import Config
    dp, tp, cp = shape
    return Config(dp=dp, tp=tp, cp=cp, dropout_keep_rate=ft.keep,
                  use_sparse_embedding_update=sparse,
                  adam_mu_dtype=ft.mu, adam_nu_dtype=ft.nu,
                  train_batch_size=ft.rows, max_contexts=ft.contexts)


def parallel_weights(torch, seed: int, dims, ft):
    """The full parameters from the seed on the card, as the facade draws
    them (every rank draws the same and keeps its shards)."""
    from code2vec_tpu_torch.models.code2vec import Code2VecModule
    g = torch.Generator(device="cuda").manual_seed(seed + 11)
    module = Code2VecModule(dims, device="cuda", generator=g,
                            dropout_keep_rate=ft.keep)
    return module


def parallel_batches(torch, seed: int, dims, ft):
    """PARALLEL_STEPS global batches (B x M) and their dropout masks
    (B x M x 384 at the keep rate) from the seed on the card: ids over
    the real rows, ~80% valid contexts, an all-invalid row, labels past
    the OOV floor, one invalid example."""
    g = torch.Generator(device="cuda").manual_seed(seed + 12)
    b, m = ft.rows, ft.contexts
    out = []
    for _ in range(PARALLEL_STEPS):
        def ids(hi):
            return torch.randint(0, hi, (b, m), generator=g, device="cuda",
                                 dtype=torch.int32)
        src, pth, tgt = (ids(dims.token_vocab_size - 1),
                         ids(dims.path_vocab_size),
                         ids(dims.token_vocab_size - 1))
        mask = (torch.rand((b, m), generator=g, device="cuda") > 0.2
                ).float()
        mask[0] = 0.0
        labels = torch.randint(2, dims.real_target_vocab_size, (b,),
                               generator=g, device="cuda",
                               dtype=torch.int32)
        valid = torch.ones(b, dtype=torch.bool, device="cuda")
        valid[1] = False
        drop = torch.rand((b, m, dims.context_dim), generator=g,
                          device="cuda") < ft.keep
        out.append((src, pth, tgt, mask, labels, valid, drop))
    return out


def rank_part(batch, mesh):
    """A rank's (data, ctx) part of a global batch's tensors."""
    from code2vec_tpu_torch.parallel.mesh import shard_slice
    plan, c = mesh.plan, mesh.coords
    rows = shard_slice(batch[0].shape[0], plan.dp, c["data"])
    cols = shard_slice(batch[0].shape[1], plan.cp, c["ctx"])
    return [x[rows][:, cols].contiguous() if x.dim() >= 2
            else x[rows].contiguous() for x in batch]


def parallel_reference(torch, seed: int, work_dir: str, fs, ft):
    """The single-device steps on the card from the same weights, batches
    and masks: (per mode, the path of its saved losses, final parameters
    and, dense, the eval step's outputs and the gradients of every
    parameter on the first batch before any step; the ms of a step)."""
    from code2vec_tpu_torch.training.state import (
        create_train_state, make_optimizer,
    )
    from code2vec_tpu_torch.training.step import TrainStepBuilder
    dims = parallel_dims(fs)
    batches = parallel_batches(torch, seed, dims, ft)
    paths, ms = {}, {}
    for sparse in (False, True):
        mode = "sparse" if sparse else "dense"
        config = parallel_config(ft, (1, 1, 1), sparse)
        module = parallel_weights(torch, seed, dims, ft)
        hyper = make_optimizer(config)
        state = create_train_state(module, hyper, config)
        builder = TrainStepBuilder(module, hyper, config)
        ref = {}
        if not sparse:
            params = {k: p.detach() for k, p in state.params.items()}
            with torch.no_grad():
                ev = builder.make_eval_step()(params, *batches[0][:6])
            ref["eval"] = {f: getattr(ev, f).cpu() for f in ev._fields}
            src, pth, tgt, mask, labels, valid, drop = batches[0]
            cv, _ = module.encode(src, pth, tgt, mask, deterministic=False,
                                  dropout_seed=seed, dropout_step=state.step,
                                  dropout_mask=drop)
            loss = module.train_loss(cv, labels, valid.float())
            loss.backward()
            ref["grad_loss"] = float(loss.detach())
            ref["grads"] = {k: p.grad.detach().cpu()
                            for k, p in state.params.items()}
            for p in state.params.values():
                p.grad = None
            del cv, loss
        step = builder.make_train_step(state)
        losses, times = [], []
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, *batch[:6], seed,
                               dropout_mask=batch[6])
            losses.append(float(loss))
            times.append((time.perf_counter() - t0) * 1e3)
        ref.update(losses=losses, params={
            k: p.detach().cpu() for k, p in state.params.items()})
        paths[mode] = os.path.join(work_dir, f"parallel_ref_{mode}.pt")
        torch.save(ref, paths[mode])
        ms[mode] = times[-1]
        del module, state, builder, step, ref
        gc.collect()
        torch.cuda.empty_cache()
    return paths, ms


def parallel_plan_run(torch, spec, mesh, name: str, sparse: bool):
    """One plan on this rank: the eval step (dense plans) and
    PARALLEL_STEPS train steps on its part of the batches, with the
    launch counts of the run, held against the single-device reference."""
    from code2vec_tpu_torch import kernels
    from code2vec_tpu_torch.parallel.mesh import shard_slice
    from code2vec_tpu_torch.training.state import (
        make_optimizer, sharded_train_state,
    )
    from code2vec_tpu_torch.training.step import ParallelStepBuilder
    fs, ft = flagship(), flagship_train()
    seed = spec["seed"]
    dims = parallel_dims(fs)
    plan = mesh.plan
    config = parallel_config(ft, (plan.dp, plan.tp, plan.cp), sparse)
    hyper = make_optimizer(config)
    module = parallel_weights(torch, seed, dims, ft)
    state = sharded_train_state(dict(module.named_parameters()), hyper,
                                config, mesh)
    del module
    torch.cuda.empty_cache()
    full = parallel_batches(torch, seed, dims, ft)
    batches = [rank_part(b, mesh) for b in full]
    # the first global batch's ids of each table (its gradient's terms)
    table_ids = {"token_embedding": torch.cat([full[0][0], full[0][2]]),
                 "path_embedding": full[0][1]}
    del full
    builder = ParallelStepBuilder(dims, hyper, config, mesh)
    ref = torch.load(spec["refs"]["sparse" if sparse else "dense"],
                     mmap=True)
    out = dict(plan=name, index=mesh.index, coords=mesh.coords,
               backend=mesh.backend)
    kernels.reset_launch_counts()
    if not sparse:
        with torch.no_grad():
            ev = builder.make_eval_step()(state.params, *batches[0][:6])
        rows = shard_slice(ft.rows, plan.dp, mesh.coords["data"])
        want = {k: v[rows].cuda() if v.dim() else v
                for k, v in ref["eval"].items()}
        same, off = topk_agreement(ev.topk_indices, want["topk_indices"],
                                   want["topk_values"], TOL_F32SUM)
        out["eval"] = dict(
            select_launches=kernels.launch_counts()["select_topk"],
            same=same, off=off, n=int(ev.topk_indices.numel()),
            values_err=float((ev.topk_values - want["topk_values"]).abs()
                             .max()),
            loss_sum=float(ev.loss_sum),
            ref_loss_sum=float(want["loss_sum"]))
    # the gradients of the first batch before any step, leaf by leaf (the
    # dense reference holds them; both modes start from the same weights)
    loss0, grads = builder.loss_and_grads(state, *batches[0][:6], seed,
                                          dropout_mask=batches[0][6])
    grad_ref = torch.load(spec["refs"]["dense"], mmap=True)
    out["grad_loss"] = (float(loss0), grad_ref["grad_loss"])
    out["grads"] = {}
    for n, g in grads.items():
        want = grad_ref["grads"][n]
        rows = slice(0, want.shape[0])
        if g.shape[0] != want.shape[0]:
            rows = shard_slice(want.shape[0], plan.tp, mesh.coords["model"])
            want = want[rows]
        want = want.cuda()
        err, ok = step_err(g, want)
        if n in table_ids:
            # a table row sums one bf16 row gradient per position that
            # names it, each of which may round the other way: a step
            # at the leaf's largest per term (rows named nowhere exact)
            local = table_ids[n].reshape(-1).long() - rows.start
            local = local[(local >= 0) & (local < g.shape[0])]
            hits = torch.bincount(local, minlength=g.shape[0])
            step = bf16_step(float(want.abs().max()))
            ok = bool(((g - want).abs()
                       <= hits[:, None].float() * step).all())
            del local, hits
        resid = float(torch.linalg.vector_norm(g - want)
                      / torch.linalg.vector_norm(want))
        out["grads"][n] = dict(max=err, resid=resid,
                               ok=ok and resid <= PARALLEL_GRAD_RESID)
        del want
    del grads, loss0, grad_ref
    torch.cuda.empty_cache()
    step = builder.make_train_step(state)
    losses, times = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, *batch[:6], seed, dropout_mask=batch[6])
        losses.append(float(loss))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out.update(counts=kernels.launch_counts(), losses=losses,
               ref_losses=ref["losses"], step_ms=times)
    lr = config.learning_rate
    errs = {}
    for n, p in state.params.items():
        want = ref["params"][n]
        if p.shape[0] != want.shape[0]:
            want = want[shard_slice(want.shape[0], plan.tp,
                                    mesh.coords["model"])]
        want = want.cuda()
        diff = (p - want).abs()
        off = int((diff > 1e-5 + 1e-5 * want.abs()).sum())
        errs[n] = dict(max=float(diff.max()), off_share=off / p.numel(),
                       ok=bool(float(diff.max()) <= 2 * lr * len(batches)
                               * 1.01 + 1e-5
                               and off <= PARALLEL_FLIP_SHARE * p.numel()))
        del want, diff
    out["params"] = errs
    del state, step, builder, batches, ref
    gc.collect()
    torch.cuda.empty_cache()
    return out


def parallel_rank_main(spec_path: str, rank: int) -> None:
    """One of the parallel phase's processes: a rank of a gloo world of
    PARALLEL_RANKS on cuda:0, running every plan whose mesh holds it (the
    first dp x tp x cp ranks) and waiting for the others'."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, REPO)
    from code2vec_tpu_torch.parallel import distributed
    from code2vec_tpu_torch.parallel.mesh import MeshPlan, make_mesh
    with open(spec_path) as f:
        spec = json.load(f)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.initialize(spec["init"], spec["world"], rank,
                           timeout_s=PARALLEL_TIMEOUT_S)
    results = []
    for name, shape, sparse in PARALLEL_PLANS:
        plan = MeshPlan(*shape)
        mesh = make_mesh(plan, device=torch.device("cuda", 0),
                         backend="gloo", members=list(range(plan.size)),
                         timeout_s=PARALLEL_TIMEOUT_S)
        if mesh is not None:
            results.append(parallel_plan_run(torch, spec, mesh, name,
                                             sparse))
        dist.barrier()
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(results, f)
    distributed.shutdown()


def k15_edges(torch, k15, g) -> None:
    """K15's passes against their plain versions where the flagship
    slice does not reach: a small odd width (rows at every 16-byte start
    alignment), a wholly padded rank slice in train and floor mode, an
    all-invalid row, floor mode's non-finite logits at a padded row
    stride; every call twice, the same bits."""
    for b, v, n_valid, extra, floor in ((5, 13, 13, 0, False),
                                        (5, 13, 11, 3, True),
                                        (4, 40000, 0, 0, False),
                                        (4, 40000, 0, 0, True),
                                        (6, 70, 65, 0, False)):
        x = torch.randn((b, v + extra), generator=g, device="cuda") * 3
        if floor:
            x[0, :3] = torch.tensor([math.inf, math.nan, -math.inf])
        labels = torch.randint(0, 2 * v, (b,), generator=g, device="cuda",
                               dtype=torch.int32)
        valid = torch.ones(b, device="cuda")
        valid[b // 2] = 0
        st = k15.tp_xent_stats(x, v, n_valid, labels, v, floor)
        want = k15.tp_xent_stats_plain(x, v, n_valid, labels, v, floor)
        err, ok = max_err(st, want, TOL_F32SUM)
        same = torch.equal(st, k15.tp_xent_stats(x, v, n_valid, labels, v,
                                                 floor))
        if not floor and not extra:
            gr = k15.tp_xent_grad(x, n_valid, st[0], st[1], labels, valid,
                                  v, 2 * b)
            gw = k15.tp_xent_grad_plain(x, n_valid, st[0], st[1], labels,
                                        valid, v, 2 * b)
            e2, ok2 = max_err(gr[0].float() + gr[1].float(),
                              gw[0].float() + gw[1].float(), (1e-9, 1e-5))
            err, ok = max(err, e2), ok and ok2 and bool(
                (gr[:, :, n_valid:] == 0).all())
            same = same and torch.equal(gr, k15.tp_xent_grad(
                x, n_valid, st[0], st[1], labels, valid, v, 2 * b))
        if not (ok and same):
            fail(f"K15 edge case b {b} v {v} n_valid {n_valid} stride "
                 f"{v + extra} floor {floor}: max error {err}, a second "
                 f"call the same bits {same}")
    log("K15 edge cases (odd widths 13 and 70, a wholly padded slice of "
        "40,000 in train and floor mode, non-finite logits in floor mode "
        "at a padded stride, an all-invalid row): within TOL_F32SUM "
        "(gradient rtol 1e-5), second calls bit-equal")


def k16_edges(torch, k16, g) -> None:
    """K16's phases against their plain versions at one context a row,
    a row with no valid context, width 128, and rows of 300 contexts;
    every call twice, the same bits."""
    for b, m, d in ((3, 1, 384), (5, 7, 128), (64, 50, 384),
                    (4, 300, 384)):
        t = torch.tanh(torch.randn((b, m, d), generator=g,
                                   device="cuda")).to(torch.bfloat16)
        a = torch.randn((d,), generator=g, device="cuda") * 0.25
        mask = (torch.rand((b, m), generator=g, device="cuda") > 0.2
                ).float()
        mask[0] = 0.0
        s, st = k16.cp_attention_scores(t, a, mask)
        cv, attn = k16.cp_attention_combine(t, s, st[0], st[1])
        s2, st2 = k16.scores_plain(t, a, mask)
        _, attn2 = k16.combine_plain(t, s, st[0], st[1])
        live = torch.isfinite(s2)
        errs = [max_err(torch.where(live, s, 0.0),
                        torch.where(live, s2, 0.0), TOL_F32SUM),
                max_err(st, st2, TOL_F32SUM),
                max_err(attn, attn2, TOL_F32SUM),
                max_err(cv, (attn.to(torch.bfloat16).float()[:, :, None]
                             * t.float()).sum(dim=1), TOL_F32SUM)]
        s3, st3 = k16.cp_attention_scores(t, a, mask)
        cv3, attn3 = k16.cp_attention_combine(t, s3, st3[0], st3[1])
        same = all(torch.equal(x, y) for x, y in ((s, s3), (st, st3),
                                                   (cv, cv3), (attn, attn3)))
        if not (all(ok for _, ok in errs) and same
                and torch.equal(live, torch.isfinite(s))
                and cv[0].abs().max() == 0):
            fail(f"K16 edge case b {b} m {m} d {d}: max errors "
                 f"{[e for e, _ in errs]}, a second call the same bits "
                 f"{same}")
    log("K16 edge cases (one context a row, width 128, B 64 x 50, rows of "
        "300 contexts, a row with no valid context): within TOL_F32SUM, "
        "second calls bit-equal")


K17_PASSES = (("cp_fs_kernel", "fs"), ("cp_dt_kernel", "dt"),
              ("cp_da_kernel", "da"))


def k17_direct_da(torch, attn, mask, fs, wfs, t):
    """K17's d a as the reference sums it, over rows and contexts of ds
    t, on the kernel's own fs and sum of w fs (f32)."""
    ds = torch.where(mask > 0, attn * (fs - wfs[:, None]), 0.0)
    return torch.einsum("bm,bmd->d", ds, t.float())


def k17_check(torch, k16, t, a, mask, attn, dcv, what: str):
    """K17's two phases on `t` against their plain versions on the same
    inputs: fs within one bf16 step of each row's largest, its weighted
    row sum against the kernel's own fs (1e-5 of the sum of |w fs|), P
    and Q against their sums on the kernel's own fs (TOL_F32SUM); dT
    within one bf16 step of each context's largest (and whether it is
    bit-equal), d a within one bf16 step of its largest against the plain
    version's and against the direct sum of ds t (step_err); a second
    call of each phase bit-equal. Returns (the largest error, a log
    fragment)."""
    fs, wfs, pq = k16.cp_attention_backward_fs(t, attn, mask, dcv)
    fs_ratio, fs_off = row_step_err(fs, k16.backward_fs_plain(
        t, attn, mask, dcv)[0])
    wfs_err = (wfs - (attn * fs).sum(dim=1)).abs()
    wfs_ok = bool((wfs_err <= 1e-5 * (attn * fs.abs()).sum(dim=1)).all())
    wv = torch.where(mask > 0, attn, 0.0)
    tf = t.float()
    pq_err, pq_ok = max_err(pq, torch.stack(
        [torch.einsum("bm,bmd->bd", wv * (fs - fs[:, :1]), tf),
         torch.einsum("bm,bmd->bd", wv, tf)]), TOL_F32SUM)
    del tf, wv
    direct = k17_direct_da(torch, attn, mask, fs, wfs, t)
    dt, da = k16.cp_attention_backward_dt(a, mask, attn, fs, wfs, dcv, pq)
    dt2, da2 = k16.backward_dt_plain(a, mask, attn, fs, wfs, dcv, pq)
    d = t.shape[2]
    dt_ratio, dt_off = row_step_err(dt.reshape(-1, d), dt2.reshape(-1, d))
    dt_exact = torch.equal(dt, dt2)
    dt_err = float((dt.float() - dt2.float()).abs().max())
    del dt2
    da_err, da_ok = step_err(da, da2)
    dd_err, dd_ok = step_err(da, direct)
    fs3 = k16.cp_attention_backward_fs(t, attn, mask, dcv)
    dt3, da3 = k16.cp_attention_backward_dt(a, mask, attn, fs3[0], fs3[1],
                                            dcv, fs3[2])
    same = all(torch.equal(x, y) for x, y in zip(
        (fs, wfs, pq, dt, da), (*fs3, dt3, da3)))
    if fs_off or not (wfs_ok and pq_ok and da_ok and dd_ok and same) \
            or dt_off:
        fail(f"K17 cp_attention_backward {what}: fs rows off by more than "
             f"one bf16 step of their largest {fs_off} (worst "
             f"{fs_ratio:.3g} steps), weighted fs sum max err "
             f"{float(wfs_err.max())}, P and Q max err {pq_err} (tol "
             f"{TOL_F32SUM}), dT rows off {dt_off} (worst {dt_ratio:.3g} "
             f"steps), da max err {da_err} against the plain version, "
             f"{dd_err} against the sum of ds t (tol one bf16 step at "
             f"the largest of each), a second call the same bits {same}")
    return max(dt_err, da_err, dd_err), (
        f"fs rows within {fs_ratio:.3g} of a bf16 step of their largest, "
        f"P and Q max_abs_err {pq_err:.3g} (tol {TOL_F32SUM}), dT rows "
        f"within {dt_ratio:.3g} of a step of their largest (bit-equal to "
        f"the plain version's on the kernel's own fs, wfs, P and Q: "
        f"{dt_exact}), da max_abs_err {da_err:.3g} against the plain "
        f"version and {dd_err:.3g} against the sum of ds t (tol one bf16 "
        f"step at the largest, {bf16_step(float(direct.abs().max())):.3g}"
        f"); a second call of each phase bit-equal")


def k17_edges(torch, k16, g) -> None:
    """K17's phases (k17_check) on K16's weights where the flagship batch
    does not reach: one context a row, width 128, rows of 300 contexts,
    the widest rows (1024), each with a row that has no valid context and
    a row whose t is one vector on every context (fs equals the row's
    sum of w fs, so each ds is a rounding of 0); that row alone too,
    its d a within one bf16 step of the largest of the plain version's
    and of the direct sum of ds t."""
    for b, m, d in ((3, 1, 384), (5, 7, 128), (64, 100, 384),
                    (4, 300, 384), (3, 130, 1024)):
        t = torch.tanh(torch.randn((b, m, d), generator=g,
                                   device="cuda")).to(torch.bfloat16)
        t[1] = t[1, 0]
        a = torch.randn((d,), generator=g, device="cuda") * 0.25
        mask = (torch.rand((b, m), generator=g, device="cuda") > 0.2
                ).float()
        mask[0] = 0.0
        mask[1, 0] = 1.0
        dcv = torch.randn((b, d), generator=g, device="cuda")
        s, st = k16.cp_attention_scores(t, a, mask)
        _, attn = k16.cp_attention_combine(t, s, st[0], st[1])
        k17_check(torch, k16, t, a, mask, attn, dcv, f"b {b} m {m} d {d}")
        r = [x[1:2].contiguous() for x in (t, attn, mask, dcv)]
        fs, wfs, pq = k16.cp_attention_backward_fs(*r)
        _, da = k16.cp_attention_backward_dt(a, r[2], r[1], fs, wfs, r[3],
                                             pq)
        errs = (step_err(da, k16.backward_dt_plain(
                    a, r[2], r[1], fs, wfs, r[3], pq)[1]),
                step_err(da, k17_direct_da(torch, r[1], r[2], fs, wfs,
                                           r[0])))
        if not all(ok for _, ok in errs):
            fail(f"K17 the fs = total row (b {b} m {m} d {d}) alone: d a "
                 f"max err {errs[0][0]} against the plain version, "
                 f"{errs[1][0]} against the sum of ds t (tol one bf16 "
                 f"step at the largest of each)")
    log("K17 edge cases (one context a row, width 128, B 64 x 100, rows of "
        "300 contexts, width 1024; a row with no valid context and a row "
        "with fs equal to its sum of w fs): each within k17_check's "
        "tolerances, second calls bit-equal; the fs = total row alone "
        "gives d a within one bf16 step of the plain version's and of "
        "the sum of ds t")


def empty_launch(torch):
    """A thunk that launches a kernel doing nothing (one CTA of 32
    threads, csrc/gather_probe.cu c2v_empty_kernel): what one launch
    costs under the timer, which a bound counting the launch adds (as
    K4's row of PERF.md counts it)."""
    from code2vec_tpu_torch.kernels import launch
    fn = launch.bind("gather_probe", "c2v_empty_kernel",
                     [launch.I32, launch.I32, launch.P])
    stream = launch.stream(torch.device("cuda"))
    return lambda: launch.check_launch(fn(1, 32, stream), "empty_kernel")


def merge_case(torch, timer, g, b: int, parts: int, k_local: int,
               empty_ms: float, k: int = 10):
    """K13's merge of the eval step's tp x k candidates (ops/sharded.py
    tp_top_k after its all-gathers): `parts` ranks' top k_local values
    and ids (parts, b, k_local), quarters in [-2, 2] (ties across ranks),
    a NaN, the last rank wholly -inf on a quarter of the rows; the merge
    entry and the small-width mode over the same candidates laid out
    rank-major, each exactly against its plain version, one launch a
    call, a second call bit-equal; timed beside the plain merge and
    torch.topk + gather over the rank-major candidates, with two bounds:
    the bytes, and the bytes plus one empty launch (`empty_ms`). Returns
    its report keys."""
    from code2vec_tpu_torch import kernels
    from code2vec_tpu_torch.kernels.select import (
        merge_topk, merge_topk_plain, padded_width, select_topk,
        select_topk_plain,
    )
    n = parts * k_local
    values = torch.randint(-8, 9, (parts, b, k_local), generator=g,
                           device="cuda").float() * 0.25
    values[0, 0, 0] = float("nan")
    values[-1, :b // 4] = float("-inf")
    ids = (torch.arange(parts, device="cuda")[:, None, None] * 130623
           + torch.randint(0, 130623, (parts, b, k_local), generator=g,
                           device="cuda")).int()
    flat = torch.full((b, padded_width(n)), float("-inf"), device="cuda")
    flat[:, :n] = values.permute(1, 0, 2).reshape(b, n)
    flat_ids = ids.permute(1, 0, 2).reshape(b, n)

    def same(x, y):
        return torch.equal(x[1], y[1]) and torch.equal(
            x[0].nan_to_num(), y[0].nan_to_num()) and torch.equal(
            torch.isnan(x[0]), torch.isnan(y[0]))

    before = kernels.launch_counts()["select_topk"]
    got = merge_topk(values, ids, k)
    launches = kernels.launch_counts()["select_topk"] - before
    small = select_topk(flat, k, n)
    ok = (same(got, merge_topk_plain(values, ids, k))
          and same(small, select_topk_plain(flat, k, n))
          and same(got, merge_topk(values, ids, k)) and launches == 1)
    if not ok:
        fail(f"K13 merge of {parts} x {k_local} candidates, B {b}, k {k}: "
             f"the merge or the small-width mode differs from its plain "
             f"version, or a second call from the first, or the merge took "
             f"{launches} launches")

    def library():
        v, p = torch.topk(flat[:, :n], k)
        return v, flat_ids.gather(1, p)

    ms = timer(lambda: merge_topk(values, ids, k))
    small_ms = timer(lambda: select_topk(flat, k, n))
    plain_ms = timer(lambda: merge_topk_plain(values, ids, k), spin_ms=20)
    lib_ms = timer(library)
    bms, by = bound(b * n * 8 + b * k * 8, float(b * n), F32_FLOP_PER_S)
    log(f"K13 merge of {parts} ranks' top {k_local} ({b} x {n} candidates, "
        f"k {k}): values and ids exact against the plain version (the "
        f"small-width mode over the rank-major copy too), {launches} "
        f"launch, a second call bit-equal; ms {ms:.4f} (small-width mode "
        f"over the copy {small_ms:.4f}) plain_ms {plain_ms:.4f} library_ms "
        f"{lib_ms:.4f} (torch.topk + gather) bound_ms {bms:.6f} ({by}), "
        f"with one empty launch {bms + empty_ms:.4f}")
    return dict(max_abs_err=0.0, ms=ms, small_ms=small_ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                bound_by=by, launch_bound_ms=bms + empty_ms,
                launches=launches)


def parallel_kernel_phase(torch, seed: int, timer, fs, ft):
    """K14-K17 against their plain versions on the card at the shapes the
    parallel path gives them (tp 2: the token shard 650,569 x 128 and the
    2 x 1024 x 200 gathered ids, the logits' 1024 x 130,623 slice; cp 2:
    the 1024 x 100 x 384 contexts), each phase timed beside its plain
    version and a PyTorch call of the same function. Returns their report
    entries."""
    import torch.nn.functional as F

    from code2vec_tpu_torch.kernels import cp_attention as k16
    from code2vec_tpu_torch.kernels import sharded as k15
    from code2vec_tpu_torch.kernels.select import padded_width
    dims = parallel_dims(fs)
    g = torch.Generator(device="cuda").manual_seed(seed + 13)
    b, m, td, d = ft.rows, ft.contexts, fs.token_dim, fs.code_dim
    rows = dims.token_vocab_size // 2
    n = 2 * b * m
    table = torch.randn((rows, td), generator=g, device="cuda")
    ids = torch.randint(0, dims.token_vocab_size - 1, (n,), generator=g,
                        device="cuda", dtype=torch.int32)
    offset = rows  # the second shard: the padded last row is its own
    report = {}

    def entry(what, got_want, tol, time_fns, nbytes, flops,
              peak=F32_FLOP_PER_S):
        """Checks the (got, want) pairs first, then times the kernel,
        its plain version and the library call (`time_fns`, thunks)."""
        errs = [max_err(x, y, tol) for x, y in got_want]
        if not all(ok for _, ok in errs):
            fail(f"{what}: max errors {[e for e, _ in errs]} (tol {tol})")
        ms, plain_ms, lib_ms = (timer(fn, spin_ms=spin) for fn, spin in
                                zip(time_fns, (2.0, 20.0, 2.0)))
        bms, by = bound(nbytes, flops, peak)
        log(f"{what}: max_abs_err {max(e for e, _ in errs):.3g} (tol {tol}); "
            f"ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} "
            f"bound_ms {bms:.4f} ({by})")
        return dict(max_abs_err=max(e for e, _ in errs), ms=ms,
                    plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                    library_ms=lib_ms)

    # K14: the gather, the scatter-add and the local ids
    local = ids.long() - offset
    live = (local >= 0) & (local < rows)
    n_live = int(live.sum())
    n_rows_live = int(torch.unique(local[live]).numel())
    got = k15.shard_gather(table, ids, offset)
    want = k15.shard_gather_plain(table, ids, offset)
    clamped = local.clamp(0, rows - 1)
    report["shard_gather"] = entry(
        "K14 shard_gather 650,569 x 128 shard, 409,600 ids",
        [(got, want)], (0.0, 0.0),
        (lambda: k15.shard_gather(table, ids, offset),
         lambda: k15.shard_gather_plain(table, ids, offset),
         lambda: F.embedding(clamped, table)),
        n_rows_live * td * 4 + n * td * 4 + n * 4, 0.0)
    grows = torch.randn((n, td), generator=g, device="cuda").to(
        torch.bfloat16)
    acc = torch.zeros_like(table)
    k15.shard_scatter_add(acc, ids, grows, offset)
    want = torch.zeros_like(table)
    k15.shard_scatter_add_plain(want, ids, grows, offset)
    # f32 atomics add a row's terms in any order: a few f32 roundings
    grows_f32 = grows.float()
    report["shard_scatter_add"] = entry(
        "K14 shard_scatter_add (bf16 rows into the f32 shard)",
        [(acc, want)], (1e-5, 1e-5),
        (lambda: k15.shard_scatter_add(acc, ids, grows, offset),
         lambda: k15.shard_scatter_add_plain(acc, ids, grows, offset),
         lambda: acc.index_add_(0, clamped, grows_f32)),
        n_live * td * 2 + n * 4 + 2 * n_rows_live * td * 4, n_live * td)
    del acc, want
    report["shard_local_ids"] = entry(
        "K14 shard_local_ids", [(k15.shard_local_ids(ids, offset, rows),
                                 k15.shard_local_ids_plain(ids, offset,
                                                           rows))],
        (0.0, 0.0),
        (lambda: k15.shard_local_ids(ids, offset, rows),
         lambda: k15.shard_local_ids_plain(ids, offset, rows),
         lambda: torch.where(live, local, torch.full_like(local, rows))),
        2 * n * 4, n)
    del table, grows, grows_f32, got, local, clamped, live
    # K15: the stats and gradient passes over the tp-2 slice of the logits
    v = dims.target_vocab_size // 2
    n_valid = k15.valid_columns(v, v, dims.real_target_vocab_size)
    logits = torch.randn((b, v), generator=g, device="cuda") * 3
    labels = torch.randint(2, dims.real_target_vocab_size, (b,), generator=g,
                           device="cuda", dtype=torch.int32)
    valid = torch.ones(b, device="cuda")
    valid[1] = 0

    def passes(stats_fn, grad_fn):
        # one rank's merged stats are its own, bit for bit
        # (merge_xent_stats), so the function timed is the two passes
        st = stats_fn(logits, v, n_valid, labels, v)
        return st, grad_fn(logits, n_valid, st[0], st[1], labels, valid, v,
                           2 * b)

    got = passes(k15.tp_xent_stats, k15.tp_xent_grad)
    want = passes(k15.tp_xent_stats_plain, k15.tp_xent_grad_plain)
    merged = k15.merge_xent_stats(got[0].view(1, 3, b))
    again = passes(k15.tp_xent_stats, k15.tp_xent_grad)
    if not all(torch.equal(x, y) for x, y in zip(
            (got[0][0], got[0][1], got[0][2]), merged)) \
            or not all(torch.equal(x, y) for x, y in zip(got, again)):
        fail("K15 tp_softmax_xent: one rank's merged stats are not its "
             "own, or a second call wrote other bits")
    hi_lo = [(x[0].float() + x[1].float()) for x in (got[1], want[1])]
    # the gradient's entries are (p - onehot) / 2048, most of them far
    # below TOL_F32SUM's atol: held at rtol 1e-4 (hi + lo carry ~17 bits)
    # with an atol of 1e-6 of its largest value
    g_tol = (1e-6 * float(hi_lo[1].abs().max()), TOL_F32SUM[1])
    g_err, g_ok = max_err(*hi_lo, g_tol)
    if not g_ok:
        fail(f"K15 tp_softmax_xent gradient: max error {g_err} (tol "
             f"{g_tol})")
    log(f"K15 tp_softmax_xent gradient (hi + lo): max_abs_err {g_err:.3g} "
        f"(tol {g_tol[0]:.3g}, {g_tol[1]}) of max "
        f"{float(hi_lo[1].abs().max()):.3g}; a second call bit-equal")
    k15_edges(torch, k15, g)
    lab = (labels.long() - v).clamp(0, v - 1)
    xg = logits.clone().requires_grad_()

    def xent_library():
        # F.cross_entropy's forward and backward over the slice
        xg.grad = None
        F.cross_entropy(xg, lab).backward()

    report["tp_softmax_xent"] = entry(
        "K15 tp_softmax_xent 1024 x 130,623 slice (stats, gradient)",
        [(got[0], want[0])], TOL_F32SUM,
        (lambda: passes(k15.tp_xent_stats, k15.tp_xent_grad),
         lambda: passes(k15.tp_xent_stats_plain, k15.tp_xent_grad_plain),
         xent_library),
        2 * logits.numel() * 4 + 2 * logits.numel() * 2 + 4 * b * 4,
        6.0 * logits.numel())
    report["tp_softmax_xent"]["max_abs_err"] = max(
        report["tp_softmax_xent"]["max_abs_err"], g_err)
    del xg, got, want, hi_lo, again
    # the eval step's pass: the stats alone, floor mode, the row stride
    # padded for K13 (the -inf padded columns as the step masks them)
    ld = padded_width(v)
    wide = torch.full((b, ld), float("-inf"), device="cuda")
    wide[:, :v] = logits
    del logits
    stats = entry(
        "K15 tp_softmax_xent eval (stats alone, floor mode, row stride "
        f"{ld:,})",
        [(k15.tp_xent_stats(wide, v, n_valid, labels, v, True),
          k15.tp_xent_stats_plain(wide, v, n_valid, labels, v, True))],
        TOL_F32SUM,
        (lambda: k15.tp_xent_stats(wide, v, n_valid, labels, v, True),
         lambda: k15.tp_xent_stats_plain(wide, v, n_valid, labels, v, True),
         lambda: torch.logsumexp(wide[:, :v], dim=1)),
        b * v * 4 + 3 * b * 4, 3.0 * b * v)
    report["tp_softmax_xent"].update(
        {f"stats_{k}": x for k, x in stats.items()})
    del wide
    # K16 and K17 over the cp-2 contexts of K1-like activations
    mc = m // 2
    t = torch.tanh(torch.randn((b, mc, d), generator=g, device="cuda")).to(
        torch.bfloat16)
    a = torch.randn((d,), generator=g, device="cuda") * 0.25
    mask = (torch.rand((b, mc), generator=g, device="cuda") > 0.2).float()
    mask[0] = 0.0
    dcv = torch.randn((b, d), generator=g, device="cuda")

    def forward(sc, co):
        # one rank's merged (max, sum) are its own, bit for bit
        # (merge_softmax_stats), so the function timed is the two phases
        s, st = sc(t, a, mask)
        return co(t, s, st[0], st[1]) + (s, st)

    got = forward(k16.cp_attention_scores, k16.cp_attention_combine)
    want = forward(k16.scores_plain, k16.combine_plain)
    again = forward(k16.cp_attention_scores, k16.cp_attention_combine)
    merged = k15.merge_softmax_stats(got[3][:1], got[3][1:])
    if not all(torch.equal(x, y) for x, y in zip(got, again)) \
            or not all(torch.equal(x, y) for x, y in zip(got[3], merged)):
        fail("K16 cp_attention: a second call wrote other bits, or one "
             "rank's merged stats are not its own")
    attn = got[1]
    q = a.to(torch.bfloat16).view(1, 1, 1, d).expand(b, 1, 1, d).contiguous()
    kv = t.view(b, 1, mc, d)
    keep = (mask > 0).view(b, 1, 1, mc)
    # as K2's check (attention_case): the scores, the stats and the
    # weights at TOL_F32SUM, the code vector exactly the weighted sum of
    # the kernel's own bf16 weights (TOL_F32SUM), and against the plain
    # version within two weight flips (a weight at a bf16 rounding
    # boundary may round the other way)
    live = torch.isfinite(want[2])
    err_sc, ok_sc = max_err(torch.where(live, got[2], 0.0),
                            torch.where(live, want[2], 0.0), TOL_F32SUM)
    ok_sc = ok_sc and torch.equal(live, torch.isfinite(got[2]))
    err_st, ok_st = max_err(got[3], want[3], TOL_F32SUM)
    err_at, ok_at = max_err(got[1], want[1], TOL_F32SUM)
    sum_cv = (attn.to(torch.bfloat16).float()[:, :, None]
              * t.float()).sum(dim=1)
    err_sum, ok_sum = max_err(got[0], sum_cv, TOL_F32SUM)
    del sum_cv
    if not (ok_sc and ok_st and ok_at and ok_sum) \
            or got[0][0].abs().max() != 0 or got[1][0].abs().max() != 0:
        fail(f"K16 cp_attention: max errors scores {err_sc}, stats "
             f"{err_st}, weights {err_at}, weighted sum {err_sum} (tol "
             f"{TOL_F32SUM}); the all-invalid row's max "
             f"{float(got[0][0].abs().max())}")
    log(f"K16 cp_attention: scores max_abs_err {err_sc:.3g}, stats "
        f"{err_st:.3g}, weights {err_at:.3g}, code vector against the "
        f"weighted sum of its own weights {err_sum:.3g} (tol {TOL_F32SUM}); "
        f"the all-invalid row zero; a second call bit-equal")
    k16_edges(torch, k16, g)
    flip = 2 * 2.0 ** -8 * float(want[1].abs().max() * t.abs().max())
    report["cp_attention"] = entry(
        "K16 cp_attention 1024 x 100 x 384 (scores, combine)",
        [(got[0], want[0])],
        (flip + TOL_F32SUM[0], TOL_F32SUM[1]),
        (lambda: forward(k16.cp_attention_scores, k16.cp_attention_combine),
         lambda: forward(k16.scores_plain, k16.combine_plain),
         lambda: F.scaled_dot_product_attention(q, kv, kv, attn_mask=keep,
                                                scale=1.0)),
        2 * t.numel() * 2 + 3 * b * mc * 4 + b * d * 4, 4.0 * t.numel(),
        peak=BF16_FLOP_PER_S)
    report["cp_attention"]["max_abs_err"] = max(
        report["cp_attention"]["max_abs_err"], err_at, err_sc, err_st)
    del again, merged

    def backward(fs_fn, dt_fn):
        f, w, pq = fs_fn(t, attn, mask, dcv)
        return dt_fn(a, mask, attn, f, w, dcv, pq)

    # each phase against its plain version on the same inputs: fs (a bf16
    # dot product) within one bf16 step of each row's largest, its
    # weighted row sum exactly against the kernel's own fs (f32 sums of
    # at most 100 terms: 1e-5 of the sum of |w fs|), P and Q against
    # their sums on the kernel's own fs (TOL_F32SUM); then dT (the same
    # f32 products and bf16 roundings as the plain version) within one
    # bf16 step of each context's largest, and d a (P - total Q summed
    # over the rows) within one bf16 step of its largest, against the
    # plain version's and against its direct sum of ds t
    err, bits = k17_check(torch, k16, t, a, mask, attn, dcv, "1024 x 100 x "
                          "384")
    k17_edges(torch, k16, g)
    bms, by = k6_bound(t)
    ms = timer(lambda: backward(k16.cp_attention_backward_fs,
                                k16.cp_attention_backward_dt))
    plain_ms = timer(lambda: backward(k16.backward_fs_plain,
                                      k16.backward_dt_plain), spin_ms=20)
    lib_ms = k6_library(torch, timer, t, a, mask, dcv)
    split = device_passes(torch, lambda: backward(
        k16.cp_attention_backward_fs, k16.cp_attention_backward_dt),
        K17_PASSES)
    log(f"K17 cp_attention_backward 1024 x 100 x 384 (fs with P and Q, dt + "
        f"da): {bits}; ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
        f"{lib_ms:.4f} (SDPA backward by autograd) bound_ms {bms:.4f} ({by}: "
        f"T read once, dT written once); launches (us, back to back): "
        + (", ".join(f"{k} {v:.1f}" for k, v in split.items())
           if split else "not measured"))
    report["cp_attention_backward"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=lib_ms, pass_us=split)
    del t, attn, dcv, mask
    torch.cuda.empty_cache()
    empty_ms = timer(empty_launch(torch))
    report["shard_local_ids"].update(
        empty_launch_ms=empty_ms,
        launch_bound_ms=report["shard_local_ids"]["bound_ms"] + empty_ms)
    log(f"an empty kernel launch: {empty_ms:.4f} ms under the same timer; "
        f"K14 shard_local_ids against its bound with one launch: "
        f"{report['shard_local_ids']['ms']:.4f} / "
        f"{report['shard_local_ids']['launch_bound_ms']:.4f}")
    report["select_topk_merge"] = {
        f"merge{n}_{key}": x for n in (20, 40)
        for key, x in merge_case(torch, timer, g, b, n // 10, 10,
                                 empty_ms).items()}
    return report


def nccl_check(torch, work_dir: str) -> None:
    """The NCCL route at world size 1 on the card: an all-reduce SUM and
    an all-gather through the communicator's collective."""
    import torch.distributed as dist

    from code2vec_tpu_torch.parallel import comm
    dist.init_process_group(
        "nccl", init_method=f"file://{os.path.join(work_dir, 'nccl')}",
        world_size=1, rank=0)
    try:
        x = torch.arange(4.0, device="cuda")
        comm._run("all_reduce", x, dist.group.WORLD, "nccl")
        y = comm._run("all_gather", torch.ones((3, 2), device="cuda"),
                      dist.group.WORLD, "nccl")
        torch.cuda.synchronize()
        if x.tolist() != [0.0, 1.0, 2.0, 3.0] or tuple(y.shape) != (3, 2):
            fail(f"NCCL at world size 1: all-reduce {x.tolist()}, "
                 f"all-gather {tuple(y.shape)}")
    finally:
        dist.destroy_process_group()
    log("parallel: NCCL at world size 1 on the card: all-reduce SUM and "
        "all-gather ran (the route of one rank a card; several cards not "
        "run here)")


def torchrun_train(torch, seed: int, work_dir: str, ft):
    """`train --tp 2 --test` through torchrun on two processes sharing
    cuda:0 (--dist_backend gloo), one epoch of the train path's corpus:
    rank 0's epoch loss and evaluation line."""
    import socket
    prefix = os.path.join(work_dir, "corpus")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    argv = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
            "--nproc-per-node", "2", "--master-addr", "127.0.0.1",
            "--master-port", str(port), "-m", "code2vec_tpu_torch", "train",
            "--data", prefix, "--epochs", "1", "--seed", str(seed),
            "--batch_size", str(ft.rows), "--max_contexts",
            str(ft.contexts), "--tp", "2", "--dist_backend", "gloo",
            "--device", "cuda:0", "--test",
            os.path.join(work_dir, "test.train.c2v"), "--eval_log",
            os.path.join(work_dir, "parallel_eval.log")]
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.perf_counter()
    r = subprocess.run(argv, cwd=work_dir, env=env, capture_output=True,
                       text=True, timeout=PARALLEL_TIMEOUT_S)
    wall = time.perf_counter() - t0
    text = r.stdout + r.stderr
    epoch = re.findall(r"Epoch 1 done: (\d+) batches, mean loss ([\d.]+)",
                       text)
    after = re.findall(r"After 1 epochs -- (.*)", text)
    if r.returncode != 0 or len(epoch) != 1 or len(after) != 1 or not \
            math.isfinite(float(epoch[0][1])):
        fail(f"torchrun train --tp 2: exit {r.returncode}, epoch lines "
             f"{epoch}, evaluation lines {after}:\n{text[-3000:]}")
    log(f"parallel: torchrun --nproc-per-node 2 train --tp 2 --dist_backend "
        f"gloo --test (ranks share cuda:0): {epoch[0][0]} steps, mean loss "
        f"{epoch[0][1]}, then {after[0]}; {wall:.1f}s with start-up")


def parallel_phase(torch, seed: int, work_dir: str, fs, ft):
    """The parallel steps at full width: the single-device reference on
    the card, then PARALLEL_PLANS on PARALLEL_RANKS processes that share
    cuda:0 over gloo (one world; each plan's mesh is its first ranks),
    each plan's loss, parameters and eval step held against the
    reference; then NCCL at world size 1 and `train --tp 2` through
    torchrun. Returns (the plans' launch counts, summed over ranks and
    plans; stats)."""
    from code2vec_tpu_torch import kernels
    t_phase = time.perf_counter()
    pdir = os.path.join(work_dir, "parallel")
    os.makedirs(pdir, exist_ok=True)
    t0 = time.perf_counter()
    refs, ref_ms = parallel_reference(torch, seed, pdir, fs, ft)
    log(f"parallel: single-device reference (dense and sparse, "
        f"{PARALLEL_STEPS} steps each) in {time.perf_counter() - t0:.1f}s; "
        f"a step {ref_ms['dense']:.1f} ms dense, {ref_ms['sparse']:.1f} ms "
        f"sparse")
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    spec = dict(init=f"file://{os.path.join(pdir, 'rendezvous')}",
                world=PARALLEL_RANKS, seed=seed, refs=refs, out=pdir)
    spec_path = os.path.join(pdir, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.perf_counter()
    logs = [open(os.path.join(pdir, f"rank{r}.log"), "w")
            for r in range(PARALLEL_RANKS)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--parallel-rank", spec_path, str(r)],
                              cwd=REPO, env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT)
             for r in range(PARALLEL_RANKS)]
    deadline = time.monotonic() + PARALLEL_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        with open(os.path.join(pdir, f"rank{bad[0]}.log")) as f:
            fail(f"parallel: ranks {bad} failed (exit "
                 f"{[procs[r].returncode for r in bad]}):\n"
                 f"{f.read()[-4000:]}")
    ranks_s = time.perf_counter() - t0
    results = []
    for r in range(PARALLEL_RANKS):
        with open(os.path.join(pdir, f"rank{r}.json")) as f:
            results += json.load(f)
    counts = dict.fromkeys(kernels.KERNEL_MODULES, 0)
    stats = {}
    for name, shape, sparse in PARALLEL_PLANS:
        runs = [x for x in results if x["plan"] == name]
        if len(runs) != math.prod(shape):
            fail(f"parallel {name}: {len(runs)} ranks reported")
        for x in runs:
            for k, c in x["counts"].items():
                counts[k] += c
        need = kernels.PARALLEL_SPARSE_KERNELS if sparse else \
            kernels.PARALLEL_DENSE_KERNELS
        need = need + (kernels.CP_KERNELS if shape[2] > 1 else
                       ("masked_attention", "masked_attention_backward"))
        if not sparse:   # the eval step's local and merged top-k
            need = need + ("select_topk",)
        missing = sorted({k for x in runs for k in need
                          if x["counts"].get(k, 0) == 0})
        losses = runs[0]["losses"]
        ref = runs[0]["ref_losses"]
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
        same = all(x["losses"] == losses for x in runs)
        bad_params = sorted({f"{n}@{x['index']}" for x in runs
                             for n, e in x["params"].items() if not e["ok"]})
        max_err = max(e["max"] for x in runs for e in x["params"].values())
        off = max(e["off_share"] for x in runs for e in x["params"].values())
        ev = [x["eval"] for x in runs if "eval" in x]
        ev_off = sum(e["off"] for e in ev)
        # an eval step's K13 launches a rank: the local top-k, then (tp >
        # 1) the merge of the gathered candidates
        ev_select = sorted({e["select_launches"] for e in ev})
        ev_bad = bool(ev) and ev_select != [2 if shape[1] > 1 else 1]
        ev_loss = max((abs(e["loss_sum"] - e["ref_loss_sum"])
                       / abs(e["ref_loss_sum"]) for e in ev), default=0.0)
        step_ms = max(x["step_ms"][-1] for x in runs)
        bad_grads = sorted({f"{n}@{x['index']}" for x in runs
                            for n, e in x["grads"].items() if not e["ok"]})
        grad_resid = max(e["resid"] for x in runs
                         for e in x["grads"].values())
        grad_steps = {n: max(x["grads"][n]["max"] for x in runs)
                      for n in runs[0]["grads"]}
        grad_loss_err = max(abs(a - b) / abs(b)
                            for a, b in (x["grad_loss"] for x in runs))
        log(f"parallel {name} (dp {shape[0]} tp {shape[1]} cp {shape[2]}, "
            f"{len(runs)} ranks sharing cuda:0, backend "
            f"{runs[0]['backend']}, every collective on the CUDA tensors "
            f"themselves, none staged): "
            f"{step_ms:.1f} ms a step (the mesh's ranks one after another "
            f"on one card; single device {ref_ms['sparse' if sparse else 'dense']:.1f}); "
            f"losses {[round(v, 6) for v in losses]} vs single device "
            f"{[round(v, 6) for v in ref]} (rel err {loss_err:.2e}, same on "
            f"every rank {same}); parameters max err {max_err:.3g}, largest "
            f"share off by >1e-5 {off:.2e}; first-batch gradients leaf by "
            f"leaf max err "
            + ", ".join(f"{n} {v:.3g}" for n, v in grad_steps.items())
            + f" (tol one bf16 step at each leaf's largest, a table row's "
            f"one per position naming it), largest "
            f"|g - ref| / |ref| {grad_resid:.2e} (tol "
            f"{PARALLEL_GRAD_RESID}), their loss rel err {grad_loss_err:.2e}"
            + (f"; eval top-k {sum(e['same'] for e in ev)} positions equal, "
               f"{ev_off} off without a near-tie, loss sum rel err "
               f"{ev_loss:.2e}, K13 launches an eval step a rank "
               f"{ev_select}" if ev else "")
            + f"; launches {json.dumps({k: sum(x['counts'][k] for x in runs) for k in need})}")
        if (missing or not same or loss_err > PARALLEL_LOSS_RTOL or bad_params
                or bad_grads or grad_loss_err > PARALLEL_LOSS_RTOL
                or ev_off or ev_loss > 1e-3 or ev_bad):
            fail(f"parallel {name}: kernels never launched {missing}, losses "
                 f"equal on every rank {same}, loss rel err {loss_err}, "
                 f"parameters off {bad_params}, gradients off {bad_grads} "
                 f"(their loss rel err {grad_loss_err}), eval off {ev_off} "
                 f"(loss sum {ev_loss}), K13 launches an eval step "
                 f"{ev_select}")
        stats[name] = dict(step_ms=step_ms, loss_err=loss_err,
                           max_err=max_err, off=off, grad_resid=grad_resid,
                           ranks=len(runs))
    log(f"parallel: {PARALLEL_RANKS} rank processes ran "
        f"{len(PARALLEL_PLANS)} plans in {ranks_s:.1f}s")
    nccl_check(torch, pdir)
    torchrun_train(torch, seed, work_dir, ft)
    for mode in refs.values():
        os.unlink(mode)
    stats["phase_s"] = time.perf_counter() - t_phase
    return counts, stats


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--samples", type=int, default=25,
                   help="timed runs per kernel (median reported)")
    p.add_argument("--parallel-rank", nargs=2, metavar=("SPEC", "RANK"),
                   help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.parallel_rank:   # one rank of the parallel phase
        parallel_rank_main(args.parallel_rank[0], int(args.parallel_rank[1]))
        return

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a "
             "CUDA GPU")
    if not os.path.isdir(os.path.join(REPO, "code2vec_tpu_torch")):
        fail(f"code2vec_tpu_torch not found beside {__file__}; run from "
             f"the repo root")
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"card: {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind}")

    from code2vec_tpu_torch import kernels
    from code2vec_tpu_torch.kernels import build
    t0 = time.perf_counter()
    make = None
    cpp = os.path.join(REPO, "cpp")
    native_targets = ["build/c2v-extract", "build/libc2vdata.so"]
    if not all(os.path.isfile(os.path.join(cpp, t))
               for t in native_targets):
        make = subprocess.Popen(["make", "-C", cpp, "-j8"] + native_targets,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)
    # every kernel library with csrc/gather_probe.cu's empty kernel (what
    # one launch costs, for the bounds that count it), all nvcc at once
    tb = time.perf_counter()
    build.build_all(list(build.SOURCES) + ["gather_probe"])
    build.timed_build_all()  # loads each library
    build_s = time.perf_counter() - tb
    log(f"build: {len(build.SOURCES)} kernel libraries and the empty "
        f"kernel with nvcc in {build_s:.1f}s")
    if make is not None:
        out, _ = make.communicate()
        if make.returncode != 0:
            fail(f"building the extractor: "
                 f"{out.decode(errors='replace')[-2000:]}")
    log(f"build: done in {time.perf_counter() - t0:.1f}s (extractor and "
        f"libc2vdata.so {'built' if make is not None else 'present'})")
    require_native("build")
    # each phase's seconds, for the budget of the whole run
    phase_s, lap_t = {"build": time.perf_counter() - t_start}, \
        [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        phase_s[name] = phase_s.get(name, 0.0) + now - lap_t[0]
        lap_t[0] = now

    timer = Timer(torch, args.samples)
    fs = flagship()
    ft = flagship_train()
    report = kernel_phase(torch, args.seed, timer, fs)
    torch.cuda.empty_cache()
    lap("kernels")
    report.update(quant_kernel_phase(torch, args.seed, timer,
                                     Timer(torch, 5), fs))
    torch.cuda.empty_cache()
    lap("fp8/int4 kernels")
    from code2vec_tpu_torch.config import Config
    eval_batch_ms, k1_eval = eval_shape_phase(torch, args.seed, timer, fs,
                                              Config().test_batch_size)
    # K3 at B 1024 per format, beside each mode's B 64 entry: the int8 and
    # float32 tables' as b1024_* and b1024_float32_* of blockwise_topk,
    # e4m3's (e5m2's) as b1024_* (e5m2_b1024_*) of blockwise_topk_fp8,
    # int4's as b1024_* of blockwise_topk_int4
    grid = topk_grid_phase(torch, args.seed, timer, fs)
    lap("evaluate shape and K3 grid")
    for fmt, key, prefix in (
            ("int8", "blockwise_topk", "b1024"),
            ("float32", "blockwise_topk", "b1024_float32"),
            ("e4m3", "blockwise_topk_fp8", "b1024"),
            ("e5m2", "blockwise_topk_fp8", "e5m2_b1024"),
            ("int4", "blockwise_topk_int4", "b1024")):
        report[key].update({f"{prefix}_{n}": x for n, x in grid[fmt].items()})
    report.update(train_kernel_phase(torch, args.seed, timer, fs, ft))
    torch.cuda.empty_cache()
    lap("train kernels")
    report.update(sparse_kernel_phase(torch, args.seed, timer, fs, ft))
    torch.cuda.empty_cache()
    lap("sparse kernels")
    report.update(parallel_kernel_phase(torch, args.seed, timer, fs, ft))
    torch.cuda.empty_cache()
    lap("parallel kernels")
    work_dir = os.path.join(REPO, ".smoke")
    shutil.rmtree(work_dir, ignore_errors=True)
    os.makedirs(work_dir)
    try:
        retrieval_report, index_stats = retrieval_kernel_phase(
            torch, args.seed, timer, fs, work_dir)
        report.update(retrieval_report)
        # K13's merge of the eval step's candidates, from the parallel
        # kernels, as merge20_* and merge40_* of its entry
        report["select_topk"].update(report.pop("select_topk_merge"))
        del timer
        torch.cuda.empty_cache()
        lap("retrieval kernels")
        weights = serving_weights(args.seed, fs)
        counts, int8_art, host_stats = path_phase(
            torch, args.seed, work_dir, fs, weights)
        lap("serving path")
        t0 = time.perf_counter()
        arts = write_scheme_artifacts(work_dir, weights[0], weights[1], fs,
                                      ("fp8_e4m3", "fp8_e5m2", "int4",
                                       "float32"))
        arts["int8"] = int8_art   # the serving path's, same weights
        log(f"quant path: wrote the artifacts of four more schemes from the "
            f"serving path's weights in {time.perf_counter() - t0:.1f}s: "
            + ", ".join(f"{k} {m['table_bytes']['artifact'] / 1e6:.1f} MB"
                        for k, (_, m) in arts.items()))
        quant_runs, quant_latency = quant_path_phase(
            torch, args.seed, work_dir, fs, weights, arts)
        lap("fp8/int4 serving")
        eval_runs, eval_stats = evaluate_phase(torch, args.seed, work_dir,
                                               fs, weights, arts,
                                               eval_batch_ms)
        lap("evaluate")
        del weights
        for scheme, (art, _) in arts.items():
            if scheme != "int8":   # the retrieval path serves that one
                shutil.rmtree(art)
        train_counts, train_stats = train_path_phase(
            torch, args.seed, work_dir, fs, ft, lifecycle=True)
        lap("train path and lifecycle")
        ops_stats = ops_phase(torch, args.seed, work_dir, fs, ft,
                              train_stats)
        lap("operations")
        sparse_counts, sparse_stats = train_path_phase(
            torch, args.seed, work_dir, fs, ft, sparse=True)
        lap("sparse train path")
        parallel_counts, parallel_stats = parallel_phase(
            torch, args.seed, work_dir, fs, ft)
        lap("parallel")
        retrieval_counts, retrieval_stats = retrieval_path_phase(
            torch, args.seed, work_dir, fs, ft)
        lap("retrieval path")
        data_counts, data_stats = data_path_phase(torch, args.seed, work_dir,
                                                  fs, ft)
        lap("data path")
        capstone_counts, capstone_stats = capstone_phase(torch, work_dir)
        lap("capstone")
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    train_step_check(torch, args.seed, fs, ft)
    sparse_step_check(torch, args.seed, fs, ft)
    lap("step checks")

    sources = {
        "context_encoder": ("encoder.cu",
                            "code2vec_tpu/models/code2vec.py:145"),
        "masked_attention": ("attention.cu",
                             "code2vec_tpu/ops/attention.py:28"),
        "blockwise_topk": ("topk.cu", "code2vec_tpu/ops/topk.py:99"),
        "label_logits": ("label_logits.cu", "code2vec_tpu/ops/topk.py:182"),
        "encoder_backward": ("encoder_backward.cu",
                             "code2vec_tpu/models/code2vec.py:145"),
        "masked_attention_backward": ("attention_backward.cu",
                                      "code2vec_tpu/ops/attention.py:28"),
        "softmax_xent": ("softmax_xent.cu",
                         "code2vec_tpu/training/step.py:170"),
        "adam": ("adam.cu", "code2vec_tpu/training/state.py:62"),
        "kmeans_assign": ("kmeans.cu",
                          "code2vec_tpu/retrieval/index.py:117"),
        "kmeans_update": ("kmeans.cu", "code2vec_tpu/retrieval/index.py:96"),
        "ivf_search": ("ivf_search.cu",
                       "code2vec_tpu/retrieval/index.py:319"),
        "ivf_search_int8": ("ivf_search.cu",
                            "code2vec_tpu/retrieval/mips.py:139"),
        "blockwise_topk_f32": ("topk.cu",
                               "code2vec_tpu/retrieval/index.py:306"),
        "encoder_backward_rows": ("encoder_backward.cu",
                                  "code2vec_tpu/models/code2vec.py:145"),
        "sparse_adam": ("sparse_adam.cu",
                        "code2vec_tpu/training/sparse_adam.py:86"),
        "select_topk": ("select.cu", "code2vec_tpu/ops/topk.py:99"),
        "shard_gather": ("sharded.cu", "code2vec_tpu/ops/sharded.py:32"),
        "shard_scatter_add": ("sharded.cu",
                              "code2vec_tpu/ops/sharded.py:32"),
        "shard_local_ids": ("sharded.cu",
                            "code2vec_tpu/training/step.py:452"),
        "tp_softmax_xent": ("sharded.cu", "code2vec_tpu/ops/sharded.py:59"),
        "cp_attention": ("cp_attention.cu",
                         "code2vec_tpu/ops/attention.py:52"),
        "cp_attention_backward": ("cp_attention.cu",
                                  "code2vec_tpu/ops/attention.py:52"),
    }
    parallel_only = ("shard_gather", "shard_scatter_add", "shard_local_ids",
                     "tp_softmax_xent", "cp_attention",
                     "cp_attention_backward")
    entries = []
    for name, (src, replaces) in sources.items():
        r = report[name]
        serving = name in SERVE_KERNELS
        launches = (parallel_counts[name] if name in parallel_only
                    else retrieval_counts[name]
                    if name in kernels.RETRIEVAL_KERNELS
                    else counts[name] if serving
                    else sparse_counts[name]
                    if name in ("encoder_backward_rows", "sparse_adam")
                    else train_counts[name])
        entry = {
            "name": name, "route": "cuda",
            "source": f"code2vec_tpu_torch/kernels/csrc/{src}",
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        if name in ("context_encoder", "masked_attention"):
            # serving numbers above; the train shape's and the train
            # path's launches here
            entry["train_launches"] = train_counts[name]
            t = report[f"{name}_train"]
            entry.update({f"train_{k}": t[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")})
        # K9/K10: the index shape above, the MIPS shape's numbers as
        # mips_*; K2: B 64 x 200 above, 32 contexts as m32_*, the MIPS
        # batch (B 8) as b8_* and b8_m32_*; K11: B 64 above, B 1 as b1_*,
        # the int8 one's B 8 (7 zero queries) as b8_*, its large-k mode
        # (k 100) as k100_*; K3's float32 mode at k 1000 as k1000_*; K12:
        # uniform ids above, Zipf(1.07) as zipf_*; K6: B 1024 x 200 above,
        # B 64 and 1 and 32 contexts as b<B>_m<M>_*; K5's row mode: its
        # allocation beside the dense mode's; K13's merge of the eval
        # step's 2 x 10 and 4 x 10 candidates as merge20_* and merge40_*;
        # K14's local ids with the bound that counts one launch
        entry.update({k: v for k, v in r.items()
                      if k.startswith(("mips", "b1", "b8", "b64", "m32",
                                       "k100", "zipf", "stats", "merge"))
                      or k.endswith("alloc_gb")
                      or k in ("unique_rows", "library_full_ms", "pass_ms",
                               "pass_us", "f32_fma_bound_ms",
                               "empty_launch_ms", "launch_bound_ms")})
        if name == "context_encoder":
            # K1 alone at the evaluate batch, per format, as eval_<format>_*
            entry.update({f"eval_{fmt}_{k}": x for fmt, r in k1_eval.items()
                          for k, x in r.items()})
        if name in SERVE_KERNELS:
            entry["retrieval_launches"] = retrieval_counts[name]
            # the serving host path's runs, each batcher on its own
            entry.update({f"{k}_launches": host_stats["launches"][k][name]
                          for k in ("dynamic", "continuous")})
        if name in ("kmeans_assign", "kmeans_update", "ivf_search"):
            # the MIPS head from `serve --load` (built, warmed, one
            # /predict)
            entry["load_mips_launches"] = \
                train_stats["mips_s"]["launches"][name]
        if name not in parallel_only and parallel_counts[name]:
            # the parallel phase's plans, every rank
            entry["parallel_launches"] = parallel_counts[name]
        # the data path's runs: train from .c2vb (2 x 64 steps, dense and
        # sparse) and the 8 text steps beside each; the capstone's train
        # and evaluate runs, dense and sparse
        data = sum(c[name] for c in data_counts.values())
        capstone = sum(c[name] for c in capstone_counts.values())
        if data or capstone:
            entry.update(data_launches=data, capstone_launches=capstone)
        entries.append(entry)
    # the fp8 and int4 modes: e4m3's numbers (e5m2's as e5m2_*), the
    # launches of the serving and evaluate runs of those formats (fp8's
    # also per format, as e4m3_launches and e5m2_launches)
    path_runs = [(scheme, c) for runs in (quant_runs, eval_runs)
                 for scheme, c in runs.items()]
    quant_replaces = {
        "fp8": dict.fromkeys(kernels.QUANT_MODE_KERNELS,
                             "code2vec_tpu/release/runtime.py:352"),
        "int4": {"context_encoder": "code2vec_tpu/ops/quant.py:174",
                 "blockwise_topk": "code2vec_tpu/ops/topk.py:142",
                 "label_logits": "code2vec_tpu/ops/topk.py:193",
                 "ivf_search": "code2vec_tpu/retrieval/mips.py:166"}}
    for kernel in kernels.QUANT_MODE_KERNELS:
        for mode in ("fp8", "int4"):
            name = f"{kernel}_{mode}"
            r = report[name]
            per_scheme = {
                scheme: sum(c[name] for s_, c in path_runs if s_ == scheme)
                for scheme in (("fp8_e4m3", "fp8_e5m2") if mode == "fp8"
                               else ("int4",))}
            if not all(per_scheme.values()):
                fail(f"the fp8/int4 paths launched {name} {per_scheme} "
                     f"times by scheme")
            entry = {
                "name": name, "route": "cuda",
                "source": ("code2vec_tpu_torch/kernels/csrc/"
                           f"{sources[kernel][0]}"),
                "replaces": quant_replaces[mode][kernel],
                "launches": sum(per_scheme.values()),
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
            entry.update({k: v for k, v in r.items()
                          if k.startswith(("e5m2", "b1", "b8", "k100"))
                          or k == "library_full_ms"})
            if mode == "fp8":
                entry.update(e4m3_launches=per_scheme["fp8_e4m3"],
                             e5m2_launches=per_scheme["fp8_e5m2"])
            entries.append(entry)
    log("serving host path (warm pool): " + "; ".join(
        f"{k} burst p50 {host_stats[k]['p50_ms']:.2f} ms p99 "
        f"{host_stats[k]['p99_ms']:.2f} ms, {host_stats[k]['batches']} "
        f"batches of {host_stats[k]['mean_rows']:.2f} rows, "
        f"{host_stats[k]['rides']} rides" for k in ("dynamic", "continuous"))
        + f"; cache hits p50 {host_stats['hit']['p50_ms']:.3f} ms p99 "
        f"{host_stats['hit']['p99_ms']:.3f} ms; the phase "
        f"{host_stats['phase_s']:.1f}s")
    for scheme, heads in quant_latency.items():
        log(f"serving {scheme}: " + "; ".join(
            f"{head} head p50 {st['p50_ms']:.2f} ms, p99 "
            f"{st['p99_ms']:.2f}, max {st['max_ms']:.2f} over "
            f"{st['requests']} requests" for head, st in heads.items()))
    for scheme, st in eval_stats.items():
        log(f"evaluate {scheme}: load {st['load_s']:.3f}s, "
            f"{st['examples_per_s']:.0f} examples/s scored ({st['eval_s']:.3f}"
            f"s; packed reader alone {st['parse_s']:.3f}s, text reader "
            f"{st['text_s']:.3f}s, kernels "
            f"{st['device_s']:.3f}s), tables {st['table_bytes'] / 1e6:.1f} "
            f"MB, top-1 {st['top1']:.4f} top-10 {st['top10']:.4f} F1 "
            f"{st['f1']:.4f}, top-1 equal to float32's "
            f"{st['top1_agrees_with_f32']:.4f}")
    log(f"train step: dense {train_stats['step_ms']:.2f} ms, "
        f"{train_stats['examples_per_s']:.0f} examples/s, peak "
        f"{train_stats['peak_gb']:.3f} GB ({train_stats['step_gb']:.3f} GB "
        f"above {train_stats['held_gb']:.3f} GB held); sparse "
        f"{sparse_stats['step_ms']:.2f} ms, "
        f"{sparse_stats['examples_per_s']:.0f} examples/s, peak "
        f"{sparse_stats['peak_gb']:.3f} GB ({sparse_stats['step_gb']:.3f} "
        f"GB above {sparse_stats['held_gb']:.3f} GB held)")
    log(f"lifecycle: saves {[round(x, 2) for x in train_stats['save_s']]} s "
        f"of {train_stats['ckpt_gb']:.3f} GB (trainable); load "
        f"{train_stats['load_s']:.2f} s (model built in "
        f"{train_stats['build_s']:.2f} s); --release "
        f"{train_stats['release_s']:.2f} s, {train_stats['release_gb']:.3f} "
        f"GB; export float32 {train_stats['export_s']['float32']:.2f} s, "
        f"int8 {train_stats['export_s']['int8']:.2f} s; evaluation during "
        f"training {[round(x) for x in train_stats['eval_eps']]} examples/s; "
        f"int8 top-1 agreement {train_stats['int8_agreement']:.4f}; MIPS "
        f"head from --load built in {train_stats['mips_s']['build_s']}s "
        f"(warm-up {train_stats['mips_s']['warm_s']:.2f}s), top-1 equal "
        f"to the exact head's on {train_stats['mips_s']['top1_agree']}/"
        f"{train_stats['mips_s']['methods']} methods; export "
        f"--serve_mips_nprobe 16 {train_stats['export_s']['int8-mips']:.2f}"
        f" s, crossover {train_stats['crossover']} "
        f"(calibration {train_stats['calibration']})")
    stall = {k: ops_stats[f"stall_{k}"] for k in ("sync", "async")}
    log(f"operations: the epoch-1 save (3.145 GB at full width) stalls "
        f"the step loop {stall['sync']['to_next_step_s']:.3f}s synchronous"
        f", {stall['async']['to_next_step_s']:.3f}s with "
        f"--async_checkpointing (save start to the next step's start, "
        f"less the evaluation; the save call alone "
        f"{stall['sync']['save_s']:.3f}s / {stall['async']['save_s']:.3f}"
        f"s; a later async save {ops_stats['steady_s']:.3f}s); resumed "
        f"loss rel err {ops_stats['loss_err']:.2e}, state "
        f"{ops_stats['state_err']:.2e}; launches "
        f"{ops_stats['launches']}; the phase {ops_stats['phase_s']:.1f}s")
    log("parallel: " + "; ".join(
        f"{k} {v['step_ms']:.1f} ms a step over {v['ranks']} ranks (loss "
        f"rel err {v['loss_err']:.2e}, parameters max err "
        f"{v['max_err']:.3g}, share off {v['off']:.2e}, gradients' largest "
        f"|g - ref| / |ref| {v['grad_resid']:.2e})"
        for k, v in parallel_stats.items() if k != "phase_s")
        + f"; the phase {parallel_stats['phase_s']:.1f}s")
    log(f"retrieval: embed {retrieval_stats['embed_rows_per_s']:.0f} rows/s; "
        f"index-build {retrieval_stats['index_build_s']:.2f}s at 20K rows, "
        f"{index_stats['index_build_1m_s']:.2f}s at 1M rows (load "
        f"{index_stats['index_load_1m_s']:.2f}s); /neighbors p50 "
        f"{retrieval_stats['p50_ms']:.2f} ms p99 "
        f"{retrieval_stats['p99_ms']:.2f} ms max "
        f"{retrieval_stats['max_ms']:.2f} ms (k 1000: p50 "
        f"{retrieval_stats['k1000_p50_ms']:.2f} ms); recall@10 "
        f"{retrieval_stats['recall']:.4f}")
    runs = data_stats["runs"]
    log(f"data path: pack {data_stats['pack_native_rows_per_s']:.0f} rows/s "
        f"native, {data_stats['pack_python_rows_per_s']:.0f} rows/s Python "
        f"({data_stats['pack_python_workers']} processes); gather "
        f"{data_stats['gather_rows_per_s']:.0f} rows/s; text parse "
        f"{data_stats['parse_native_rows_per_s']:.0f} rows/s native, "
        f"{data_stats['parse_python_rows_per_s']:.0f} rows/s Python; train "
        + "; ".join(f"{k.replace('_', ' from ')} "
                    f"{r['examples_per_s']:.0f} examples/s, busy "
                    f"{r['busy_share']:.3f}" for k, r in runs.items())
        + f"; the phase {data_stats['phase_s']:.1f}s")
    log("capstone: " + "; ".join(
        f"{mode} test F1 {capstone_stats[mode]['test_f1']:.4f} top-1 "
        f"{capstone_stats[mode]['test_top1']:.4f}, train "
        f"{capstone_stats[mode]['train_s']:.1f}s "
        f"({capstone_stats[mode]['examples_per_s']:.0f} examples/s)"
        for mode in ("dense", "sparse"))
        + f"; generate {capstone_stats['generate_s']:.1f}s, extract "
        f"{capstone_stats['extract_s']:.1f}s, preprocess "
        f"{capstone_stats['preprocess_s']:.1f}s, compile "
        f"{capstone_stats['compile_s']:.1f}s; the phase "
        f"{capstone_stats['phase_s']:.1f}s")
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                      for k, v in phase_s.items()))
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
