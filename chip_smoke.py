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
4. Path: a full-width int8 release artifact written from random weights
   (seeded), served over HTTP by the port's server on the GPU; /predict
   and /embed requests with Java source run through the real extractor;
   every response checked, every kernel's launch count must rise, and
   the step's outputs on one padded batch of the extracted methods must
   agree with the same step on the CPU (plain versions).

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


def kernel_phase(torch, seed: int, timer, fs, dev="cuda"):
    from code2vec_tpu_torch.kernels import attention, encoder, label_logits
    from code2vec_tpu_torch.kernels import topk
    import torch.nn.functional as F

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
        got_cv, got_attn = attention.masked_attention(t, a, mask)
        want_cv, want_attn = attention.masked_attention_plain(t, a, mask)
        torch.cuda.synchronize()
        err_at, ok_at = max_err(got_attn, want_attn, TOL_F32SUM)
        # the weighted sum, exact given the kernel's own weights
        sum_cv = (got_attn.to(torch.bfloat16).float()[:, :, None]
                  * t.float()).sum(dim=1)
        err_sum, ok_sum = max_err(got_cv, sum_cv, TOL_F32SUM)
        # against the plain version: a weight whose f32 value lies at a
        # bf16 rounding boundary may round the other way there, moving
        # the sum by one bf16 step of that weight's term; allow two
        flip = 2 * 2.0 ** -8 * float(want_attn.abs().max() * t.abs().max())
        tol_cv = (flip + TOL_F32SUM[0], TOL_F32SUM[1])
        err_cv, ok_cv = max_err(got_cv, want_cv, tol_cv)
        if not (ok_cv and ok_at and ok_sum):
            fail(f"masked_attention m={m}: max errors cv {err_cv} (tol "
                 f"{tol_cv}) attn {err_at} weighted sum {err_sum}")
        if got_cv[0].abs().max() != 0 or got_attn[0].abs().max() != 0:
            fail("masked_attention: an all-invalid row must give zeros")
        nbytes = (t.numel() * 2 + mask.numel() * 4 * 2 + d * 4
                  + fs.rows * d * 4)
        bms, by = bound(nbytes, 4.0 * t.numel())
        ms = timer(lambda: attention.masked_attention(t, a, mask))
        plain_ms = timer(lambda: attention.masked_attention_plain(t, a, mask),
                         spin_ms=20)
        q = a.to(torch.bfloat16).view(1, 1, 1, d).expand(
            fs.rows, 1, 1, d).contiguous()
        kv = t.view(fs.rows, 1, m, d)
        keep = (mask > 0).view(fs.rows, 1, 1, m)
        lib_ms = timer(lambda: F.scaled_dot_product_attention(
            q, kv, kv, attn_mask=keep, scale=1.0))
        log(f"K2 masked_attention B={fs.rows} m={m}: max_abs_err cv "
            f"{err_cv:.3g} (tol {tol_cv[0]:.3g}, {tol_cv[1]}) weighted sum "
            f"{err_sum:.3g} attn {err_at:.3g} (tol {TOL_F32SUM}) max|cv| "
            f"{float(want_cv.abs().max()):.3g} ms {ms:.4f} plain_ms "
            f"{plain_ms:.4f} "
            f"library_ms {lib_ms:.4f} bound_ms {bms:.4f} ({by})")
        if m == fs.contexts:
            report["masked_attention"] = dict(
                max_abs_err=max(err_cv, err_at), ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=lib_ms)
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
    missing = [k for k, n in counts.items() if n <= 0]
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
    report = kernel_phase(torch, args.seed, timer, fs)
    del timer
    torch.cuda.empty_cache()

    work_dir = os.path.join(REPO, ".smoke")
    shutil.rmtree(work_dir, ignore_errors=True)
    os.makedirs(work_dir)
    try:
        counts = path_phase(torch, args.seed, work_dir, fs)
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)

    sources = {"context_encoder": ("encoder.cu",
                                   "code2vec_tpu/models/code2vec.py:145"),
               "masked_attention": ("attention.cu",
                                    "code2vec_tpu/ops/attention.py:28"),
               "blockwise_topk": ("topk.cu", "code2vec_tpu/ops/topk.py:99"),
               "label_logits": ("label_logits.cu",
                                "code2vec_tpu/ops/topk.py:182")}
    entries = []
    for name, (src, replaces) in sources.items():
        r = report[name]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"code2vec_tpu_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
