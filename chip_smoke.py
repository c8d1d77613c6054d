#!/usr/bin/env python3
"""Drive the PyTorch port (code2vec_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--samples N]

Run from the root of a checkout, on a machine with one CUDA GPU, nvcc and
a C++ compiler. Phases, each fatal on failure:

1. The card: `nvidia-smi` name and power limit, torch's device name.
2. Build: every kernel under code2vec_tpu_torch/kernels/csrc with nvcc
   (one process per source, in parallel) and, where missing, the native
   path extractor (`make -C cpp`).
3. Kernels: each kernel of the serving path against its plain PyTorch
   version on the same inputs at the serving shapes (64 rows, 32 and 200
   contexts, int8 and f32 tables at the java14m vocabulary sizes):
   largest error against the stated tolerance, top-k index agreement,
   median device time over --samples runs with the L2 cache flushed,
   the plain version's and a library call's time, and the least time the
   card could take (bytes over 3.35 TB/s, or bf16 operations over 989
   TFLOP/s, whichever is larger).
4. Train kernels: K1 in train mode, K2 and K5-K8 against their plain
   versions at the flagship train shapes (1024 rows x 200 contexts x 384;
   1024 x 261,246 logits; Adam over all 383.7M parameters with bf16
   moments), timed the same way; K5's and K6's gradients also by the
   share of elements that moved (check_flips). The dropout mask is drawn
   by K1's write-out mode: its kept share must lie within 5 sigma of the
   keep rate, the same (seed, step) must draw the same mask and the next
   step another, and K5 must give exactly 0 to every dropped element.
5. Serving path: a full-width int8 release artifact written from random
   weights (seeded), served over HTTP by the port's server on the GPU;
   /predict and /embed requests with Java source run through the real
   extractor; every response checked, every serving kernel's launch count
   must rise, and the step's outputs on one padded batch of the extracted
   methods must agree with the same step on the CPU (plain versions).
6. Train path: a synthetic corpus at full width (a `.dict.c2v` with the
   java14m vocabulary sizes, 4 x 1024 methods whose name follows their
   tokens) trained for 2 epochs by the `train` command of the port's CLI
   on the GPU: every loss finite, the second epoch's mean loss below the
   first's, every train kernel launched once per step; then the step
   time and examples/s of a steady step.
7. One train step at 64 rows with full vocabulary widths and an injected
   dropout mask, on the GPU against the same step on the CPU (plain
   versions): the loss and the five gradients within one bf16 step of
   each tensor's largest value, the target rows that are no label within
   one bf16 step of their own largest value, and K8's update on
   identical inputs.
8. Retrieval kernels: K9 kmeans_assign, K10 kmeans_update (two runs
   bit-equal), K11 ivf_search and K3's float32 mode against their plain
   versions, timed the same way (bounds over the float32 peak of 67
   TFLOP/s where operations bound them), at two shapes: the MIPS head
   over the flagship int8 classifier (261,245 rows, nlist 511, 6 Lloyd
   steps, nprobe 16, B 64 and 1, k 10; at nprobe = nlist it must return
   the exact head's indices away from near-ties) and an index of
   1,000,000 normalised f32 vectors (nlist 1000, 10 spherical Lloyd
   steps, nprobe 16, B 64, k 16; brute force at B 64, k 16). The large-k
   mode (K13 select_topk): K3's float32 mode over the 1M index at B 64,
   k 1000, and K11 int8 on the MIPS head at B 64, k 100, against their
   plain versions (indices exact away from near-ties); K13 alone on the
   1M index's scores, exact against its plain version, timed.
9. Retrieval path, through the port's CLI on the serving path's
   artifact: `embed` of a 20,000-method synthetic corpus (plus the
   request sources' methods, twice), `index-build`, then `serve
   --retrieval_index --serve_mips_nprobe 16 --serve_mips_crossover 8`
   over HTTP: well-formed /neighbors bodies, each stored method its own
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
   K5's row mode, K12 (twice) and K8 (over the dense subtree only)
   launched every step; the steady step's time, examples/s and peak
   device memory beside the dense step's.
12. One sparse step (run after 7) at 64 rows with full vocabulary
   widths, an injected dropout mask and mid-training row moments, GPU
   against CPU: the loss, the updated rows of both tables, mu and nu
   within one bf16 step of each tensor's largest value, untouched rows
   bit-equal.

13. fp8 and int4 kernels (run after 3): the e4m3, e5m2 and packed-int4
   modes of K1 (200 and 32 contexts), K3 (k 10, and k 100 through its
   large-k mode and K13), K4 and K11 (the MIPS head's lists over the
   classifier in that format; B 64 and 1 at k 10, B 64 at k 100) against
   their plain versions at the serving shapes, to the int8 mode's
   tolerances, timed with their bounds, plain versions and library
   calls (the cast or torch's int4 unpack, a bf16 matmul and
   torch.topk); all 256 codes of each fp8 format through K3 and K4.
14. fp8 and int4 serving (run after 5): full-width artifacts of all five
   schemes written from one set of seeded weights; the e4m3 artifact
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

Prints one line per kernel, then a JSON line {"kernels": [...]}, the
card's name and power limit, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, printing no result, where torch sees no CUDA device or
the package is not beside this script.
"""

from __future__ import annotations

import argparse
import concurrent.futures
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


def attention_case(torch, timer, t, a, mask):
    """K2 on K1's output `t` against its plain version: the weights at
    TOL_F32SUM, the code vectors exactly against the weighted sum of the
    kernel's own bf16 weights and against the plain version within two
    bf16 weight flips, zeros for the all-invalid row 0; then timed beside
    the plain version and scaled_dot_product_attention. Returns (report
    entry, the kernel's code vectors, its weights)."""
    from code2vec_tpu_torch.kernels import attention
    import torch.nn.functional as F

    b, m, d = t.shape
    got_cv, got_attn = attention.masked_attention(t, a, mask)
    want_cv, want_attn = attention.masked_attention_plain(t, a, mask)
    torch.cuda.synchronize()
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
    if got_cv[0].abs().max() != 0 or got_attn[0].abs().max() != 0:
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
        f"{float(want_cv.abs().max()):.3g} ms {ms:.4f} plain_ms "
        f"{plain_ms:.4f} library_ms {lib_ms:.4f} bound_ms {bms:.4f} ({by})")
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
            log(f"K1 context_encoder {scheme} B={fs.rows} m={m}: "
                f"max_abs_err {err:.3g} (tol {TOL_K1}) ms "
                f"{ms:.4f} plain_ms {plain_ms:.4f} bound_ms "
                f"{bms:.4f} ({by})")
            if (scheme, m) == ("int8", fs.contexts):
                report["context_encoder"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                    bound_by=by, library_ms=None)

    for m in (fs.contexts, 32):
        t = transformed[("int8", m)]
        mask = (torch.rand((fs.rows, m), generator=g, device=dev)
                > 0.3).float()
        mask[0] = 0.0  # an all-invalid row
        r, got_cv, _ = attention_case(torch, timer, t, a, mask)
        if m == fs.contexts:
            report["masked_attention"] = r
            cv = got_cv.contiguous()

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
        log(f"K4 label_logits {scheme} B={fs.rows}: max_abs_err "
            f"{err:.3g} (tol {TOL_F32SUM}) ms {ms:.4f} plain_ms "
            f"{plain_ms:.4f} bound_ms {bms:.4f} ({by})")
        if scheme == "int8":
            report["label_logits"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None)
    del tables, transformed
    torch.cuda.empty_cache()
    return report


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


def path_phase(torch, seed: int, work_dir: str, fs, weights,
               dev: str = "cuda"):
    """The int8 artifact of `weights` (serving_weights) served over HTTP.
    Returns (the launch counts, (the artifact's directory, its meta))."""
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
    log(f"path: loaded and warmed the model on {model.device} in "
        f"{time.perf_counter() - t0:.1f}s")
    server = PredictionServer(model)
    port = server.start(port=0)
    url = f"http://127.0.0.1:{port}"
    try:
        kernels.reset_launch_counts()
        latencies = []
        for name, src in sources.items():
            status, body, dt = post(f"{url}/predict", src)
            if status != 200:
                fail(f"/predict {name}: HTTP {status}")
            check_predict_body(body, model.model_fingerprint())
            latencies.append(dt)
        status, body, dt = post(f"{url}/embed", sources["Input.java"])
        latencies.append(dt)
        vecs = body.get("vectors") or []
        if status != 200 or not vecs or not all(
                len(v) == fs.code_dim and all(math.isfinite(x) for x in v)
                for v in vecs):
            fail(f"/embed: HTTP {status}, {len(vecs)} vectors")
        with concurrent.futures.ThreadPoolExecutor(8) as ex:
            burst = list(ex.map(lambda s: post(f"{url}/predict", s),
                                list(sources.values()) * 2))
        for status, body, dt in burst:
            if status != 200:
                fail(f"/predict burst: HTTP {status}")
            check_predict_body(body, model.model_fingerprint())
            latencies.append(dt)
        counts = kernels.launch_counts()
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        server.shutdown()
    n_requests = len(latencies)
    log(f"path: {n_requests} requests ({len(sources) + len(burst)} "
        f"/predict, 1 /embed) in {server.batcher.batches_dispatched} device "
        f"batches; latency p50 {statistics.median(latencies) * 1e3:.1f} ms, "
        f"max {max(latencies) * 1e3:.1f} ms; kernel launches {counts}")
    if health["kernel_launches"] != counts:
        fail(f"/healthz launch counts {health['kernel_launches']} != "
             f"{counts}")
    missing = [k for k in SERVE_KERNELS if counts[k] <= 0]
    if missing:
        fail(f"the path launched no {missing}")

    step_gpu_vs_cpu(torch, model, art_dir, extracted, fs, "path", dev)
    return counts, (art_dir, meta)


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
    log(f"K1 context_encoder train B={b} m={m} keep={ft.keep}: max_abs_err "
        f"{err:.3g} (tol {TOL_K1}) with residual {err_lo:.3g} (tol one "
        f"bf16 step at the largest value) kept {share:.5f} (5 sigma "
        f"{5 * sigma:.2g}) ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms "
        f"{bms:.4f} ({by})")
    report["context_encoder_train"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        library_ms=None)

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

    # K6: the backward of K2 on K1's train output
    mask = (torch.rand((b, m), generator=g, device=dev) > 0.3).float()
    mask[0] = 0.0
    report["masked_attention_train"], _, attn = attention_case(
        torch, timer, t, a, mask)
    dcv = uniform((b, d), 0.05).to(torch.bfloat16).float()
    got = attention.masked_attention_backward(t, a, mask, attn, dcv)
    want = attention.masked_attention_backward_plain(t, a, mask, attn, dcv)
    torch.cuda.synchronize()
    errs6 = [step_err(x, y) for x, y in zip(got, want)]
    if not all(ok for _, ok in errs6) or got[0][0].abs().max() != 0:
        fail(f"masked_attention_backward: max errors "
             f"{[e for e, _ in errs6]}, all-masked row max "
             f"{float(got[0][0].abs().max())}")
    flips6 = [check_flips(x, y, f"masked_attention_backward {name}")
              for x, y, name in zip(got, want, ("dT", "da"))]
    nbytes = 2 * t.numel() * 2 + 2 * b * m * 4 + b * d * 4 + 2 * d * 4
    bms, by = bound(nbytes, 6.0 * t.numel())
    ms = timer(lambda: attention.masked_attention_backward(t, a, mask, attn,
                                                           dcv))
    plain_ms = timer(lambda: attention.masked_attention_backward_plain(
        t, a, mask, attn, dcv), spin_ms=20)
    log(f"K6 masked_attention_backward B={b} m={m}: max_abs_err dT "
        f"{errs6[0][0]:.3g} da {errs6[1][0]:.3g} (tol one bf16 step at "
        f"the largest), elements moved {flips6[0]:.2e} {flips6[1]:.2e} (tol "
        f"{FLIP_SHARE}) ms {ms:.4f} plain_ms {plain_ms:.4f} bound_ms "
        f"{bms:.4f} ({by})")
    report["masked_attention_backward"] = dict(
        max_abs_err=max(e for e, _ in errs6), ms=ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=None)
    del t, t_lo, dt, got, want, drawn, again, other, attn, mask, dcv

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

    # K12 on both tables: ids uniform and Zipf(1.07) over the real sizes
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
    cases = {}
    for dist in ("uniform", "zipf"):
        case = {}
        for name, (v, cnt) in tables.items():
            idx = (zipf_ids(torch, g, cnt, v, dev) if dist == "zipf"
                   else torch.randint(0, v, (cnt,), generator=g, device=dev,
                                      dtype=torch.int32))
            rows = (torch.randint(-127, 128, (cnt, 128), generator=g,
                                  device=dev).float() * 2.0 ** -12
                    ).to(torch.bfloat16)
            case[name] = (idx, rows)
        cases[dist] = case
    k12 = {}
    for dist, case in cases.items():
        errs_p, errs_m, uniq = [], [], {}
        for name, (idx, rows) in case.items():
            p0, m0, n0 = states[name]
            runs = []
            for _ in range(2):
                p, slots = p0.clone(), RowAdamSlots(mu=m0.clone(),
                                                    nu=n0.clone())
                ksa.sparse_adam(p, slots, idx, rows, t=7, **hyper)
                runs.append((p, slots.mu, slots.nu))
            if not all(torch.equal(x, y) for x, y in zip(*runs)):
                fail(f"sparse_adam {name} {dist}: two runs gave different "
                     f"bits")
            p, slots = p0.clone(), RowAdamSlots(mu=m0.clone(), nu=n0.clone())
            ksa.sparse_adam_plain(p, slots, idx, rows, t=7, **hyper)
            torch.cuda.synchronize()
            got_p, got_m, got_n = runs[0]
            del runs
            touched = torch.zeros(p0.shape[0], dtype=torch.bool, device=dev)
            touched[idx.long()] = True
            uniq[name] = int(touched.sum())
            for x, x0 in ((got_p, p0), (got_m, m0), (got_n, n0)):
                if not torch.equal(x[~touched], x0[~touched]):
                    fail(f"sparse_adam {name} {dist}: an untouched row "
                         f"changed")
            e, ok = max_err(got_p[touched], p[touched], TOL_ADAM)
            en, ok_n = max_err(got_n[touched], slots.nu[touched], TOL_ADAM)
            em, ok_m = max_err(got_m[touched], slots.mu[touched], TOL_MOMENT)
            if not (ok and ok_n and ok_m):
                fail(f"sparse_adam {name} {dist}: max errors table {e} nu "
                     f"{en} (tol {TOL_ADAM}) mu {em} (tol {TOL_MOMENT})")
            errs_p.append(max(e, en))
            errs_m.append(em)
            del got_p, got_m, got_n, p, slots, touched
        msz = 2 if mu_dtype == torch.bfloat16 else 4
        nbytes = sum(cnt * 128 * 2 + cnt * 4 + uniq[name] * 128 * (
            2 * 4 + 2 * msz + 2 * 4) for name, (_, cnt) in tables.items())
        bms, by = bound(nbytes, 20.0 * 128 * sum(uniq.values()))
        work = {name: (states[name][0].clone(), RowAdamSlots(
            mu=states[name][1].clone(), nu=states[name][2].clone()))
            for name in tables}

        def run(fn):
            for name, (idx, rows) in case.items():
                fn(work[name][0], work[name][1], idx, rows, t=7, **hyper)

        ms = timer(lambda: run(ksa.sparse_adam))
        plain_ms = timer(lambda: run(ksa.sparse_adam_plain), spin_ms=20)
        # yardstick: torch.optim.SparseAdam.step on coalesced COO
        # gradients of the same ids and rows (f32 moments)
        lib_params = [torch.nn.Parameter(states[name][0].clone())
                      for name in tables]
        for lp, (idx, rows) in zip(lib_params, case.values()):
            lp.grad = torch.sparse_coo_tensor(
                idx.long()[None, :], rows.float(), lp.shape).coalesce()
        opt = torch.optim.SparseAdam(lib_params, lr=hyper["lr"],
                                     betas=(hyper["b1"], hyper["b2"]),
                                     eps=hyper["eps"])
        lib_ms = timer(opt.step, spin_ms=20)
        del opt, lib_params, work
        torch.cuda.empty_cache()
        log(f"K12 sparse_adam {dist} ids: token {tables['token'][1]} ids -> "
            f"{uniq['token']} unique rows of {tables['token'][0]}, path "
            f"{tables['path'][1]} ids -> {uniq['path']} unique rows of "
            f"{tables['path'][0]}; mu {ft.mu}: max_abs_err table/nu "
            f"{max(errs_p):.3g} (tol {TOL_ADAM}) mu {max(errs_m):.3g} (tol "
            f"{TOL_MOMENT}); untouched rows bit-equal, two runs bit-equal; "
            f"ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} "
            f"(torch.optim.SparseAdam, f32 moments) bound_ms {bms:.4f} "
            f"({by})")
        k12[dist] = dict(max_abs_err=max(errs_p), ms=ms, plain_ms=plain_ms,
                         bound_ms=bms, bound_by=by, library_ms=lib_ms,
                         unique_rows=uniq["token"] + uniq["path"])
    report["sparse_adam"] = dict(k12["uniform"])
    report["sparse_adam"].update({f"zipf_{k}": v
                                  for k, v in k12["zipf"].items()})
    del states, cases, tok, path, w, ids
    torch.cuda.empty_cache()
    return report


# --------------------------------------------------------- train path phase


def write_train_corpus(work_dir: str, seed: int, fs, ft, n_rows: int,
                       n_names: int = 64, tokens_per_name: int = 64,
                       stems=("t", "p", "name|w"), with_dict: bool = True):
    """PREFIX.dict.c2v with the java14m vocabulary sizes (unless
    `with_dict` is false) and PREFIX.train.c2v of `n_rows` methods whose
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
    prefix = os.path.join(work_dir, "corpus")
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
    lines = []
    for r in range(n_rows):
        toks = owned[names[r]][rng.integers(0, tokens_per_name, (2, m))]
        pths = rng.integers(0, v_path, m)
        ctx = " ".join(f"{st}{toks[0, j]},{sp}{pths[j]},{st}{toks[1, j]}"
                       for j in range(m))
        lines.append(f"{sn}{names[r] * 997 % v_tgt} {ctx}")
    with open(prefix + ".train.c2v", "w") as f:
        f.write("\n".join(lines) + "\n")
    return prefix


def train_path_phase(torch, seed: int, work_dir: str, fs, ft,
                     epochs: int = 2, steps_per_epoch: int = 4,
                     dev: str = "cuda", sparse: bool = False):
    """The `train` command (with --sparse_embedding_update when `sparse`)
    on the synthetic corpus under `work_dir` (written by the first call):
    the epochs' losses, one launch per step of each kernel of the step,
    then a steady step's time, examples/s and peak device memory."""
    from code2vec_tpu_torch import cli, kernels
    from code2vec_tpu_torch.data.reader import parse_context_lines
    from code2vec_tpu_torch.model_facade import Code2VecModel
    from code2vec_tpu_torch.training.state import SPARSE_PARAM_NAMES

    # The reference's `.repeat(epochs).shuffle(buffer)` moves an epoch's
    # boundary by the shuffle buffer, and the default buffer (10,000
    # lines) would hold this whole corpus until the last pass. A buffer of
    # rows/16 lines, and that many methods beyond 4 x 1024, give each of
    # the two epochs exactly 4 full batches (the run's ragged tail is
    # dropped).
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
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    model.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
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
    want = {k: steps * (2 if k == "sparse_adam" else 1) for k in names}
    if sparse:  # no dense K5: no table-shaped gradient
        want["encoder_backward"] = 0
    train_counts = {k: counts[k] for k in want}
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

    # a steady step on one batch: host clock around synchronised steps
    with open(config.train_data_path) as f:
        lines = [next(f) for _ in range(ft.rows)]
    arrays = model.trainer._to_device(parse_context_lines(
        lines, model.vocabs, ft.contexts, keep_strings=False))
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
    torch.cuda.empty_cache()
    return counts, dict(step_ms=step_ms, examples_per_s=ft.rows / step_ms
                        * 1e3, epoch_means=means, peak_gb=peak / 1e9,
                        step_gb=(peak - held) / 1e9, held_gb=held / 1e9)


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


def kmeans_cases(torch, timer, x, c0, spherical, what):
    """K9 and K10 at one shape against their plain versions: agreement,
    determinism, times, bounds and library calls. Returns (K9 entry, K10
    entry, K9's assignment)."""
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
    bms, by = bound(nbytes, 2.0 * n * c * d, F32_FLOP_PER_S)
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
        f"bound_ms {bms:.4f} ({by})")
    # max_abs_err: the largest gap between the distances of the two
    # centroids where the assignments differ (0 where all agree)
    k9 = dict(max_abs_err=gap, ms=ms, plain_ms=plain_ms,
              bound_ms=bms, bound_by=by, library_ms=lib_ms)

    upd = kmeans.kmeans_update(x, got, c0, spherical)
    again = kmeans.kmeans_update(x, got, c0, spherical)
    want_c = kmeans.kmeans_update_plain(x, got, c0, spherical)
    torch.cuda.synchronize()
    if not torch.equal(upd, again):
        fail(f"kmeans_update {what}: two runs gave different bits")
    err, ok = max_err(upd, want_c, TOL_F32SUM)
    if not ok:
        fail(f"kmeans_update {what}: max error {err}")
    counts = torch.bincount(got.long(), minlength=c)
    empty = counts == 0
    if empty.any() and not torch.equal(upd[empty], c0[empty]):
        fail(f"kmeans_update {what}: an empty cluster moved")
    nbytes = n * d * 4 + n * 4 + 2 * c * d * 4
    bms, by = bound(nbytes, float(n * d), F32_FLOP_PER_S)
    ms = timer(lambda: kmeans.kmeans_update(x, got, c0, spherical))
    plain_ms = timer(lambda: kmeans.kmeans_update_plain(x, got, c0,
                                                        spherical),
                     spin_ms=20)
    idx = got.long()
    sums = torch.zeros_like(c0)
    lib_ms = timer(lambda: sums.index_add_(0, idx, x))
    log(f"K10 kmeans_update {what} N={n} C={c} D={d} spherical="
        f"{spherical}: max_abs_err {err:.3g} (tol {TOL_F32SUM}), two runs "
        f"bit-equal, {int(empty.sum())} empty clusters kept; ms {ms:.4f} "
        f"plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} (index_add_) "
        f"bound_ms {bms:.4f} ({by})")
    k10 = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
               bound_by=by, library_ms=lib_ms)
    return k9, k10, got


def ivf_case(torch, timer, q, cent, rows, offsets, nprobe, k, what,
             scales=None, global_ids=None):
    """K11 against its plain version on one batch of queries; `rows` in
    any format."""
    from code2vec_tpu_torch.kernels.ivf import ivf_search, ivf_search_plain
    from code2vec_tpu_torch.ops.quant import decode_rows

    b, d = q.shape
    max_len = int((offsets[1:] - offsets[:-1]).max())
    kw = dict(scales=scales, global_ids=global_ids, max_len=max_len)
    args = (q, cent, rows, offsets, nprobe, k)
    got_v, got_i = ivf_search(*args, **kw)
    # the plain version's (k+1)-th value is the k-th one's lower neighbour
    want_v, want_i = ivf_search_plain(*args[:-1], k + 1, **kw)
    torch.cuda.synchronize()
    nxt, want_v, want_i = want_v[:, k], want_v[:, :k], want_i[:, :k]
    err, ok = max_err(got_v, want_v, TOL_F32SUM)
    same, bad = topk_agreement(got_i, want_i, want_v, TOL_F32SUM,
                               next_vals=nxt)
    if not ok or bad:
        fail(f"ivf_search {what}: value error {err}, {bad} positions differ "
             f"away from near-ties: "
             f"{topk_detail(got_i, want_i, want_v, nxt)}")
    union, scanned = probed_rows(torch, q, cent, offsets, nprobe)
    row_bytes = rows.shape[1] * rows.element_size() \
        + (4 if scales is not None else 0) \
        + (4 if global_ids is not None else 0)
    c = cent.shape[0]
    nbytes = (union * row_bytes + c * d * 4 + b * d * 4
              + (offsets.numel() * 8) + b * k * 8)
    bms, by = bound(nbytes, 2.0 * d * (b * c + scanned), F32_FLOP_PER_S)
    ms = timer(lambda: ivf_search(*args, **kw))
    plain_ms = timer(lambda: ivf_search_plain(*args, **kw), spin_ms=20)
    # the library chain from precomputed candidates: gather, bmm, topk
    from code2vec_tpu_torch.kernels.ivf import padded_lists, top_positions
    _, probe = top_positions(q @ cent.T, nprobe)
    cand = padded_lists(offsets, max_len)[probe].reshape(b, -1)
    safe = cand.clamp(min=0)
    lib_ms = timer(lambda: torch.topk(torch.bmm(
        decode_rows(rows[safe], d), q[:, :, None]).squeeze(-1), k),
        spin_ms=20)
    del cand, safe
    log(f"K11 ivf_search {what} B={b} nprobe={nprobe} k={k}: max_abs_err "
        f"{err:.3g} (tol {TOL_F32SUM}) positions equal {same}/"
        f"{got_i.numel()}; {union} rows in the probed lists, {scanned} "
        f"scored; ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
        f"{lib_ms:.4f} (gather + bmm + topk) bound_ms {bms:.4f} ({by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)


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
    bms, by = bound(nbytes, 2.0 * b * v * d, F32_FLOP_PER_S)
    ms = timer(lambda: topk.blockwise_topk(*args, **kw))
    plain_ms = timer(lambda: topk.blockwise_topk_plain(*args, **kw),
                     spin_ms=100)
    lib_ms = timer(lambda: torch.topk(torch.matmul(q, table.T), k))
    log(f"K3 blockwise_topk float32 mode {what} B={b} V={v} k={k}: "
        f"max_abs_err values {err_v:.3g} lse {err_l:.3g} (tol "
        f"{TOL_F32SUM}) indices equal {same}/{got.indices.numel()} ms "
        f"{ms:.4f} plain_ms {plain_ms:.4f} library_ms {lib_ms:.4f} "
        f"(f32 matmul + topk) bound_ms {bms:.4f} ({by})")
    return dict(max_abs_err=max(err_v, err_l), ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=lib_ms), got


def select_case(torch, timer, scores, k, what):
    """K13 alone against its plain version on one score matrix: the same
    positions and the same values (read back from the scores)."""
    from code2vec_tpu_torch.kernels.select import (
        select_topk, select_topk_plain,
    )
    b, n = scores.shape
    got_v, got_p = select_topk(scores, k)
    want_v, want_p = select_topk_plain(scores, k)
    torch.cuda.synchronize()
    if not (torch.equal(got_p, want_p) and torch.equal(got_v, want_v)):
        diff = int((got_p != want_p).sum())
        fail(f"select_topk {what}: {diff} positions differ from the plain "
             f"version's")
    nbytes = b * n * 4 + b * k * 8
    bms, by = bound(nbytes, float(b * n))
    ms = timer(lambda: select_topk(scores, k))
    plain_ms = timer(lambda: select_topk_plain(scores, k), spin_ms=20)
    lib_ms = timer(lambda: torch.topk(scores, k), spin_ms=20)
    log(f"K13 select_topk {what} B={b} n={n} k={k}: positions and values "
        f"equal to the plain version's; ms {ms:.4f} plain_ms {plain_ms:.4f} "
        f"library_ms {lib_ms:.4f} (torch.topk) bound_ms {bms:.4f} ({by})")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)


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
    k9m, k10m, _ = kmeans_cases(torch, timer, x, c0, False, "MIPS")
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
    mips = {}
    for b in (fs.rows, 1):
        mips[b] = ivf_case(torch, timer, cv[:b].contiguous(),
                           head._centroids, head._rows, head._offsets,
                           nprobe, fs.topk, f"MIPS int8 {v_real}x{d}",
                           scales=head._scales, global_ids=head._global_ids)
    # the large-k mode: K11 int8 at B 64, k 100, through K13
    mips_k100 = ivf_case(torch, timer, cv, head._centroids, head._rows,
                         head._offsets, nprobe, 100,
                         f"MIPS int8 {v_real}x{d} (large-k mode)",
                         scales=head._scales, global_ids=head._global_ids)
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
    del scores
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
    report["ivf_search"] = k11
    report["ivf_search_int8"] = merged(merged(mips[fs.rows], mips[1], "b1"),
                                       mips_k100, "k100")
    report["blockwise_topk_f32"] = merged(k3f, k3_large, "k1000")
    report["select_topk"] = k13
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
    warm-up, for the request latency, and the extractor alone on the
    same source."""
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
         "--device", dev])
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
        latencies = []
        for _ in range(n_timed):
            status, body, dt = post_json(f"{url}/neighbors", {"code": src})
            if status != 200:
                fail(f"/neighbors (timed): HTTP {status}")
            latencies.append(dt)
        check_neighbors_body(body, fp, config.retrieval_topk)
        extract = []
        for _ in range(50):
            t0 = time.perf_counter()
            extractor.extract_source(src)
            extract.append(time.perf_counter() - t0)
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
    stats = dict(p50_ms=statistics.median(lat) * 1e3,
                 p99_ms=lat[int(0.99 * (len(lat) - 1))] * 1e3,
                 max_ms=lat[-1] * 1e3,
                 extract_p50_ms=statistics.median(extract) * 1e3)
    log(f"retrieval: {len(lat)} /neighbors requests of Max.java (1 method, "
        f"k {config.retrieval_topk}) after 10 warm-up: p50 "
        f"{stats['p50_ms']:.2f} ms, p99 {stats['p99_ms']:.2f} ms, max "
        f"{stats['max_ms']:.2f} ms; the extractor alone on it p50 "
        f"{stats['extract_p50_ms']:.2f} ms over {len(extract)} calls; "
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
            log(f"K1 context_encoder {fmt} B={fs.rows} m={m}: max_abs_err "
                f"{err:.3g} (tol {TOL_K1}) ms {ms:.4f} plain_ms "
                f"{plain_ms:.4f} bound_ms {bms:.4f} ({by})")
            entries["context_encoder"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=None)
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
        log(f"K4 label_logits {fmt} B={fs.rows}: max_abs_err {err:.3g} "
            f"(tol {TOL_F32SUM}) ms {ms:.4f} plain_ms {plain_ms:.4f} "
            f"bound_ms {bms:.4f} ({by})")
        entries["label_logits"] = dict(max_abs_err=err, ms=ms,
                                       plain_ms=plain_ms, bound_ms=bms,
                                       bound_by=by, library_ms=None)
        # -- K11 on the MIPS head's lists, rows in this format
        rows = tbl[:v_real][order].contiguous()
        rs = scl[:v_real][order].reshape(-1).contiguous()
        del tbl, scl
        q = (torch.rand((fs.rows, d), generator=g, device=dev) * 2 - 1)
        what = f"MIPS {fmt} {v_real}x{d}"
        kw = dict(scales=rs, global_ids=gids)
        mips = {b: ivf_case(torch, timer, q[:b].contiguous(), cent, rows,
                            offsets, nprobe, fs.topk, what, **kw)
                for b in (fs.rows, 1)}
        k100 = ivf_case(torch, timer, q, cent, rows, offsets, nprobe, 100,
                        f"{what} (large-k mode)", **kw)
        entries["ivf_search"] = dict(mips[fs.rows])
        entries["ivf_search"].update({f"b1_{n}": x
                                      for n, x in mips[1].items()})
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
    Returns {scheme: that time in ms}."""
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
    step_ms = {}
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
        log(f"evaluate shape {fmt} B={rows} m={fs.contexts}: K1 max_abs_err "
            f"{err_k1:.3g} (tol {TOL_K1}); K3 k={k} values {err_v:.3g} lse "
            f"{err_l:.3g} (tol {TOL_F32SUM}) indices equal {same}/"
            f"{out.indices.numel()}; K4 {err_k4:.3g}; K1+K2+K3+K4 "
            f"{step_ms[scheme]:.4f} ms a batch")
        del tok, path, tbl, scl, tok_s, path_s, cv, out, want, got4, args
        torch.cuda.empty_cache()
    del f32, w, src, pth, tgt, mask
    torch.cuda.empty_cache()
    return step_ms


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
        config = Config(serve_artifact=art, device=dev, verbose_mode=0,
                        serve=True, serve_mips_nprobe=16,
                        serve_mips_crossover=8)
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
            url = f"http://127.0.0.1:{server.start(port=0)}/predict"
            fp = model.model_fingerprint()
            try:
                for src in list(sources.values()) + [many]:
                    status, body, _ = post(url, src)
                    if status != 200:
                        fail(f"/predict on the {scheme} artifact: HTTP "
                             f"{status}")
                    check_predict_body(body, fp)
                one, body = timed_posts(url, sources["Max.java"], n_one)
                check_predict_body(body, fp)
                twelve, body = timed_posts(url, many, n_many)
                check_predict_body(body, fp)
                counts = kernels.launch_counts()
            finally:
                server.shutdown()
            latency[scheme] = {"mips": latency_stats(one),
                               "exact": latency_stats(twelve)}
            log(f"quant path: {scheme}: " + "; ".join(
                f"{st['requests']} /predict requests of {what} ({head} "
                f"head) after 10 warm-up: p50 {st['p50_ms']:.2f} ms, p99 "
                f"{st['p99_ms']:.2f}, max {st['max_ms']:.2f}"
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
    and the evaluation's examples/s, beside the text parse alone and the
    device time of its batches (`batch_ms`, eval_shape_phase); table
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
    # the text parse alone: the evaluation's reader over the corpus at its
    # batch size, no step
    t0 = time.perf_counter()
    n_batches = sum(1 for _ in PathContextReader(
        f32.vocabs, f32.config, EstimatorAction.Evaluate, data_path=corpus,
        batch_size=f32.config.test_batch_size, with_target_strings=True))
    parse_s = time.perf_counter() - t0
    del f32
    torch.cuda.empty_cache()
    log(f"evaluate: the reader alone parses the corpus into {n_batches} "
        f"batches in {parse_s:.3f}s ({n_rows / parse_s:.0f} rows/s)")

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
            command_s=secs, parse_s=parse_s, device_s=device_s,
            table_bytes=nbytes, top1=float(res.topk_acc[0]),
            top10=float(res.topk_acc[-1]), f1=float(res.subtoken_f1),
            loss=float(res.loss), top1_agrees_with_f32=float(res.topk_acc[0]))
        log(f"evaluate {scheme}: the command in {secs:.2f}s: artifact load "
            f"{load_s:.3f}s, {n_rows} methods scored in {eval_s:.3f}s "
            f"({n_rows / eval_s:.0f} examples/s; the parse alone "
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


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--samples", type=int, default=25,
                   help="timed runs per kernel (median reported)")
    args = p.parse_args()

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
    if not os.path.isfile(os.path.join(cpp, "build", "c2v-extract")):
        make = subprocess.Popen(["make", "-C", cpp, "-j8",
                                 "build/c2v-extract"],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)
    build_s = build.timed_build_all()
    log(f"build: {len(build.SOURCES)} kernel libraries with nvcc in "
        f"{build_s:.1f}s")
    if make is not None:
        out, _ = make.communicate()
        if make.returncode != 0:
            fail(f"building the extractor: "
                 f"{out.decode(errors='replace')[-2000:]}")
    log(f"build: done in {time.perf_counter() - t0:.1f}s (extractor "
        f"{'built' if make is not None else 'present'})")

    timer = Timer(torch, args.samples)
    fs = flagship()
    ft = flagship_train()
    report = kernel_phase(torch, args.seed, timer, fs)
    torch.cuda.empty_cache()
    report.update(quant_kernel_phase(torch, args.seed, timer,
                                     Timer(torch, 5), fs))
    torch.cuda.empty_cache()
    from code2vec_tpu_torch.config import Config
    eval_batch_ms = eval_shape_phase(torch, args.seed, timer, fs,
                                     Config().test_batch_size)
    report.update(train_kernel_phase(torch, args.seed, timer, fs, ft))
    torch.cuda.empty_cache()
    report.update(sparse_kernel_phase(torch, args.seed, timer, fs, ft))
    torch.cuda.empty_cache()
    work_dir = os.path.join(REPO, ".smoke")
    shutil.rmtree(work_dir, ignore_errors=True)
    os.makedirs(work_dir)
    try:
        retrieval_report, index_stats = retrieval_kernel_phase(
            torch, args.seed, timer, fs, work_dir)
        report.update(retrieval_report)
        del timer
        torch.cuda.empty_cache()
        weights = serving_weights(args.seed, fs)
        counts, int8_art = path_phase(torch, args.seed, work_dir, fs,
                                      weights)
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
        eval_runs, eval_stats = evaluate_phase(torch, args.seed, work_dir,
                                               fs, weights, arts,
                                               eval_batch_ms)
        del weights
        for scheme, (art, _) in arts.items():
            if scheme != "int8":   # the retrieval path serves that one
                shutil.rmtree(art)
        train_counts, train_stats = train_path_phase(torch, args.seed,
                                                     work_dir, fs, ft)
        sparse_counts, sparse_stats = train_path_phase(
            torch, args.seed, work_dir, fs, ft, sparse=True)
        retrieval_counts, retrieval_stats = retrieval_path_phase(
            torch, args.seed, work_dir, fs, ft)
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    train_step_check(torch, args.seed, fs, ft)
    sparse_step_check(torch, args.seed, fs, ft)

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
    }
    entries = []
    for name, (src, replaces) in sources.items():
        r = report[name]
        serving = name in SERVE_KERNELS
        launches = (retrieval_counts[name]
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
        # mips_*; the int8 K11: B 64 above, B 1 as b1_*, its large-k mode
        # (k 100) as k100_*; K3's float32 mode at k 1000 as k1000_*; K12:
        # uniform ids above, Zipf(1.07) as zipf_*; K5's row mode: its
        # allocation beside the dense mode's
        entry.update({k: v for k, v in r.items()
                      if k.startswith(("mips", "b1", "k100", "zipf"))
                      or k.endswith("alloc_gb")
                      or k in ("unique_rows", "library_full_ms", "pass_ms")})
        if name in SERVE_KERNELS:
            entry["retrieval_launches"] = retrieval_counts[name]
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
                          if k.startswith(("e5m2", "b1", "k100"))})
            if mode == "fp8":
                entry.update(e4m3_launches=per_scheme["fp8_e4m3"],
                             e5m2_launches=per_scheme["fp8_e5m2"])
            entries.append(entry)
    for scheme, heads in quant_latency.items():
        log(f"serving {scheme}: " + "; ".join(
            f"{head} head p50 {st['p50_ms']:.2f} ms, p99 "
            f"{st['p99_ms']:.2f}, max {st['max_ms']:.2f} over "
            f"{st['requests']} requests" for head, st in heads.items()))
    for scheme, st in eval_stats.items():
        log(f"evaluate {scheme}: load {st['load_s']:.3f}s, "
            f"{st['examples_per_s']:.0f} examples/s scored ({st['eval_s']:.3f}"
            f"s; parse alone {st['parse_s']:.3f}s, kernels "
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
    log(f"retrieval: embed {retrieval_stats['embed_rows_per_s']:.0f} rows/s; "
        f"index-build {retrieval_stats['index_build_s']:.2f}s at 20K rows, "
        f"{index_stats['index_build_1m_s']:.2f}s at 1M rows (load "
        f"{index_stats['index_load_1m_s']:.2f}s); /neighbors p50 "
        f"{retrieval_stats['p50_ms']:.2f} ms p99 "
        f"{retrieval_stats['p99_ms']:.2f} ms max "
        f"{retrieval_stats['max_ms']:.2f} ms; recall@10 "
        f"{retrieval_stats['recall']:.4f}")
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
