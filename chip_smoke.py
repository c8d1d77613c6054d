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
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import types
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12        # dense bf16 tensor-core peak, same source
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


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want, tol):
    """(max |got - want|, ok under |got - want| <= atol + rtol |want|);
    NaN must meet NaN."""
    torch = sys.modules["torch"]
    g, w = got.float(), want.float()
    same_nan = torch.isnan(g) == torch.isnan(w)
    diff = torch.where(torch.isnan(w), torch.zeros_like(w), (g - w).abs())
    ok = bool(same_nan.all()) and bool(
        (diff <= tol[0] + tol[1] * w.abs().nan_to_num()).all())
    return float(diff.max()), ok


def topk_agreement(idx, want_idx, want_vals, tol):
    """(positions equal, positions differing without a near-tie): a
    position may differ only where the reference's neighbouring values
    lie within tolerance of each other."""
    torch = sys.modules["torch"]
    diff = idx != want_idx
    v = want_vals.float()
    gap_prev = torch.full_like(v, math.inf)
    gap_next = torch.full_like(v, math.inf)
    gap_prev[:, 1:] = (v[:, 1:] - v[:, :-1]).abs()
    gap_next[:, :-1] = (v[:, 1:] - v[:, :-1]).abs()
    near = torch.minimum(gap_prev, gap_next) <= tol[0] + tol[1] * v.abs()
    return int((~diff).sum()), int((diff & ~near).sum())


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


def write_flagship_artifact(out_dir: str, seed: int, extracted, fs):
    """A full-width int8 artifact from seeded random weights. The
    vocabularies hold the tokens, hashed paths and method names the
    extractor gives for the request sources, padded with filler words to
    the java14m sizes, so requests gather real rows."""
    import numpy as np

    from code2vec_tpu_torch.release.artifact import write_artifact
    from code2vec_tpu_torch.vocab import Code2VecVocabs

    tokens, paths, names = {}, {}, {}
    for lines, _ in extracted:
        for line in lines:
            parts = line.split()
            names[parts[0]] = None
            for ctx in parts[1:]:
                w1, p, w2 = ctx.split(",")
                tokens[w1] = tokens[w2] = paths[p] = None

    def padded(seen, n, stem):
        words = list(seen)[:n]
        return words + [f"{stem}{i}" for i in range(n - len(words))]

    vocabs = Code2VecVocabs.from_words(
        padded(tokens, fs.vocab["token"], "tok"),
        padded(paths, fs.vocab["path"], "path"),
        padded(names, fs.vocab["target"], "name|filler"))
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
    return write_artifact(params, vocabs, out_dir, fs.scheme,
                          max_contexts=fs.contexts,
                          compute_dtype=fs.compute_dtype,
                          topk=fs.topk, topk_block_size=fs.block,
                          serve_batch_size=fs.rows, buckets=fs.buckets)


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


def path_phase(torch, seed: int, work_dir: str, fs, dev: str = "cuda"):
    from code2vec_tpu_torch import kernels
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.data.reader import parse_context_lines
    from code2vec_tpu_torch.kernels import label_logits
    from code2vec_tpu_torch.release.runtime import ReleaseModel
    from code2vec_tpu_torch.serving.extractor_bridge import PathExtractor
    from code2vec_tpu_torch.serving.server import PredictionServer

    sources = dict(SOURCES)
    with open(os.path.join(REPO, "Input.java")) as f:
        sources["Input.java"] = f.read()
    config = Config(device=dev, max_contexts=fs.contexts, verbose_mode=0)
    extractor = PathExtractor(config)
    extracted = [extractor.extract_source(s) for s in sources.values()]
    t0 = time.perf_counter()
    art_dir = os.path.join(work_dir, "artifact")
    meta = write_flagship_artifact(art_dir, seed, extracted, fs)
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

    # the step on the GPU against the same step on the CPU (plain
    # versions) on the same padded batch of every extracted method
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
            fail(f"GPU vs CPU step: {name} max error {errs[name]} > {tol}")
    errs["loss_sum"], ok = max_err(got.loss_sum.cpu(), want.loss_sum,
                                   TOL_F32SUM)
    if not ok:
        fail(f"GPU vs CPU step: loss_sum {float(got.loss_sum)} vs "
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
        fail(f"GPU vs CPU step: top-k indices: logits at the GPU's indices "
             f"off by {errs['logit_at_index']}, {bad} positions differ "
             f"away from near-ties")
    log(f"path: GPU vs CPU step on {n} methods (bucket "
        f"{batch.context_valid_mask.shape[1]}): top-k indices equal "
        f"{same}/{g_idx.numel()}; max errors "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f" (tolerance {PATH_REL_TOL:.3g} x max|value|; loss_sum "
        f"{TOL_F32SUM})")
    return counts


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
    log(f"K5 encoder_backward B={b} m={m} keep={ft.keep}: max_abs_err "
        f"d_token {errs5[0][0]:.3g} d_path {errs5[1][0]:.3g} d_transform "
        f"{errs5[2][0]:.3g} (tol one bf16 step at the largest), elements "
        f"moved {', '.join(f'{x:.2e}' for x in flips5)} (tol "
        f"{FLIP_SHARE}); dropped "
        f"elements with a gradient {dropped_nonzero}, kept with one "
        f"{kept_nonzero:.4f}; ms {ms:.4f} plain_ms {plain_ms:.4f} "
        f"library_ms {lib_ms:.4f} bound_ms {bms:.4f} ({by})")
    report["encoder_backward"] = dict(
        max_abs_err=max(e for e, _ in errs5), ms=ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=lib_ms)

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


# --------------------------------------------------------- train path phase


def write_train_corpus(work_dir: str, seed: int, fs, ft, n_rows: int,
                       n_names: int = 64, tokens_per_name: int = 64):
    """PREFIX.dict.c2v with the java14m vocabulary sizes and
    PREFIX.train.c2v of `n_rows` methods whose name follows their tokens
    (the pattern of tests/test_end_to_end.py at full width): each of
    `n_names` names owns `tokens_per_name` tokens spread over the token
    vocabulary; paths are drawn from the whole path vocabulary."""
    import pickle

    import numpy as np

    rng = np.random.default_rng(seed)
    v_tok, v_path, v_tgt = (fs.vocab["token"], fs.vocab["path"],
                            fs.vocab["target"])
    prefix = os.path.join(work_dir, "corpus")
    with open(prefix + ".dict.c2v", "wb") as f:
        # descending counts: the vocabulary order is the word order
        pickle.dump({f"t{i}": v_tok - i for i in range(v_tok)}, f)
        pickle.dump({f"p{i}": v_path - i for i in range(v_path)}, f)
        pickle.dump({f"name|w{i}": v_tgt - i for i in range(v_tgt)}, f)
        pickle.dump(n_rows, f)
    owned = rng.choice(v_tok, size=(n_names, tokens_per_name), replace=False)
    names = rng.integers(0, n_names, n_rows)
    m = ft.contexts
    lines = []
    for r in range(n_rows):
        toks = owned[names[r]][rng.integers(0, tokens_per_name, (2, m))]
        pths = rng.integers(0, v_path, m)
        ctx = " ".join(f"t{toks[0, j]},p{pths[j]},t{toks[1, j]}"
                       for j in range(m))
        lines.append(f"name|w{names[r] * 997 % v_tgt} {ctx}")
    with open(prefix + ".train.c2v", "w") as f:
        f.write("\n".join(lines) + "\n")
    return prefix


def train_path_phase(torch, seed: int, work_dir: str, fs, ft,
                     epochs: int = 2, steps_per_epoch: int = 4,
                     dev: str = "cuda"):
    from code2vec_tpu_torch import cli, kernels
    from code2vec_tpu_torch.data.reader import parse_context_lines
    from code2vec_tpu_torch.model_facade import Code2VecModel

    # The reference's `.repeat(epochs).shuffle(buffer)` moves an epoch's
    # boundary by the shuffle buffer, and the default buffer (10,000
    # lines) would hold this whole corpus until the last pass. A buffer of
    # rows/16 lines, and that many methods beyond 4 x 1024, give each of
    # the two epochs exactly 4 full batches (the run's ragged tail is
    # dropped).
    buffer = max(ft.rows // 16, 1)
    n_rows = steps_per_epoch * ft.rows + buffer
    t0 = time.perf_counter()
    prefix = write_train_corpus(work_dir, seed, fs, ft, n_rows)
    log(f"train: wrote a {n_rows}-method corpus with java14m vocabularies "
        f"in {time.perf_counter() - t0:.1f}s")
    argv = ["train", "--data", prefix, "--epochs", str(epochs), "--seed",
            str(seed), "--batch_size", str(ft.rows), "--max_contexts",
            str(ft.contexts), "--device", dev]
    _, config = cli.config_from_args(argv)
    config.shuffle_buffer_size = buffer
    config.verbose_mode = 0
    t0 = time.perf_counter()
    model = Code2VecModel(config)   # what `cli.main(argv)` runs
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.module.parameters())
    log(f"train: built vocabularies and a {n_params}-"
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
    log(f"train: {epochs} epochs, {steps} steps in {wall:.1f}s; losses "
        f"{[round(x, 4) for e in losses for x in e]}; epoch means "
        f"{[round(x, 4) for x in means]}; kernel launches {counts}")
    if len(losses) != epochs or any(len(e) != steps_per_epoch
                                    for e in losses):
        fail(f"train: epochs of {[len(e) for e in losses]} steps, expected "
             f"{epochs} of {steps_per_epoch}")
    if not all(math.isfinite(x) for e in losses for x in e):
        fail("train: a loss is not finite")
    if not means[1] < means[0]:
        fail(f"train: the second epoch's mean loss {means[1]} is not below "
             f"the first's {means[0]}")
    train_counts = {k: counts[k] for k in kernels.TRAIN_KERNELS}
    if any(v != steps for v in train_counts.values()):
        fail(f"train: launches {train_counts} are not one per step "
             f"({steps})")

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
    log(f"train: steady step {step_ms:.2f} ms (median of 5, host clock "
        f"around synchronised steps), {ft.rows / step_ms * 1e3:.0f} "
        f"examples/s")
    del model
    torch.cuda.empty_cache()
    return counts, dict(step_ms=step_ms, examples_per_s=ft.rows / step_ms
                        * 1e3, epoch_means=means)


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


# -------------------------------------------------------------------- main


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
    report.update(train_kernel_phase(torch, args.seed, timer, fs, ft))
    del timer
    torch.cuda.empty_cache()

    work_dir = os.path.join(REPO, ".smoke")
    shutil.rmtree(work_dir, ignore_errors=True)
    os.makedirs(work_dir)
    try:
        counts = path_phase(torch, args.seed, work_dir, fs)
        train_counts, train_stats = train_path_phase(torch, args.seed,
                                                     work_dir, fs, ft)
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    train_step_check(torch, args.seed, fs, ft)

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
    }
    entries = []
    for name, (src, replaces) in sources.items():
        r = report[name]
        serving = name in SERVE_KERNELS
        entry = {
            "name": name, "route": "cuda",
            "source": f"code2vec_tpu_torch/kernels/csrc/{src}",
            "replaces": replaces,
            "launches": counts[name] if serving else train_counts[name],
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
        entries.append(entry)
    log(f"train step: {train_stats['step_ms']:.2f} ms, "
        f"{train_stats['examples_per_s']:.0f} examples/s")
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
