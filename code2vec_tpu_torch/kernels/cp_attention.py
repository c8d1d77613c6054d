"""K16 cp_attention and K17 cp_attention_backward: masked single-query
attention with the contexts split over the `ctx` axis, and its backward,
as phases between the collectives over `ctx`.

K16 replaces code2vec_tpu/ops/attention.py masked_single_query_attention
with `axis_name` set (:52, :60, :67): the scores and the rank's (max, sum
of exp), which the caller all-gathers and merges in rank order
(kernels/sharded.py merge_softmax_stats), then the weights at the global
max and sum and the rank's part of the code vector. K17 replaces its
autodiff in the manual train step: fs = bf16(g . t), the rank's sum of
w fs (the cotangent of the denominator, summed over ctx by the caller)
and each row's sums of w (fs - fs_0) t and w t (fs_0 the fs of its
first context), in the one read of t; then dt and the rank's part of
d a from those, without t. The CUDA source is
csrc/cp_attention.cu; its header gives the arithmetic, the rounding
points (K6's), what bounds each phase on an H100 and the design. The `*_plain` functions are the same in plain
PyTorch: CPU tensors take them, CUDA tensors launch the kernels. With one
ctx rank the phases compose to K2's and K6's plain versions
(ops/attention.py), which tests hold.

`launches` counts K16's phases (two a forward), `backward_launches`
K17's (two a backward); each wrapper adds one where it launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from code2vec_tpu_torch.kernels import launch

launches = 0
backward_launches = 0
_fns = {}


def _safe(m: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


# ------------------------------------------------------- plain versions


def scores_plain(t, a, mask):
    s = torch.einsum("bmd,d->bm", t.float(), a.to(t.dtype).float())
    s = torch.where(mask > 0, s, torch.full_like(s, float("-inf")))
    lm = s.amax(dim=1)
    ls = torch.exp(s - _safe(lm)[:, None]).sum(dim=1)
    return s, torch.stack([lm, ls])


def combine_plain(t, scores, gmax, gsum):
    attn = torch.exp(scores - _safe(gmax)[:, None]) / torch.clamp(
        gsum, min=1e-30)[:, None]
    cv = torch.einsum("bm,bmd->bd", attn.to(t.dtype).float(), t.float())
    return cv, attn


def backward_fs_plain(t, attn, mask, g):
    tf = t.float()
    fs = torch.einsum("bd,bmd->bm", g.float(), tf).to(t.dtype).float()
    wv = torch.where(mask > 0, attn, torch.zeros_like(attn))
    pq = torch.stack([torch.einsum("bm,bmd->bd", wv * (fs - fs[:, :1]), tf),
                      torch.einsum("bm,bmd->bd", wv, tf)])
    return fs, (attn * fs).sum(dim=1), pq


def backward_dt_plain(a, mask, attn, fs, wfs, g, pq, dtype=torch.bfloat16):
    cd = dtype
    ds = torch.where(mask > 0, attn * (fs - wfs[:, None]),
                     torch.zeros_like(fs))
    ac = a.to(cd).float()
    w = attn.to(cd).float()
    dt = ((w[:, :, None] * g.float()[:, None, :]).to(cd).float()
          + (ds[:, :, None] * ac).to(cd).float()).to(cd)
    da = (pq[0] + (fs[:, :1] - wfs[:, None]) * pq[1]).sum(dim=0).to(
        cd).float()
    return dt, da


# ------------------------------------------------------------- wrappers


def _fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        P, I32 = launch.P, launch.I32
        args = {
            "c2v_cp_attention_scores": [P, P, P, I32, I32, I32, P, P, P],
            "c2v_cp_attention_combine": [P, P, P, P, I32, I32, I32, P, P,
                                         P],
            "c2v_cp_attention_backward_fs": [P, P, P, P, I32, I32, I32, P,
                                             P, P, P],
            "c2v_cp_attention_backward_dt": [P, P, P, P, P, P, P, I32, I32,
                                             I32, P, P, P, P],
        }[name]
        fn = _fns[name] = launch.bind("cp_attention", name, args)
    return fn


def _check_t16(t: torch.Tensor):
    """K16's activations: 16-byte aligned rows of a width that is a
    multiple of 8, at most 1024, few enough contexts for a CTA's shared
    memory (the combine's m weights and 3 x d sums, at most 48 KB)."""
    launch.check_tensor(t, "transformed", [torch.bfloat16], 3, align=16)
    _, m, d = t.shape
    launch.require(d % 8 == 0 and d <= 1024,
                   f"code width {d} is not a multiple of 8 up to 1024")
    launch.require(4 * (m + 3 * d) <= 48 * 1024,
                   f"{m} contexts of width {d} take more than 48 KB of "
                   f"shared memory a CTA")
    return t.shape


def _check(name, x, dtype, shape):
    launch.check_tensor(x, name, [dtype], len(shape))
    launch.require(tuple(x.shape) == tuple(shape),
                   f"{name}: expected {tuple(shape)}, got {tuple(x.shape)}")


def _f32(shape, device):
    return torch.empty(shape, dtype=torch.float32, device=device)


def cp_attention_scores(t: torch.Tensor, a: torch.Tensor,
                        mask: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K16 phase 1: (scores (b, m) f32, -inf where masked; stats (2, b)
    f32: each row's max over this rank's contexts, then its sum of
    exp(scores - that max), one buffer for one all-gather)."""
    if launch.runs_plain(t, a, mask):
        return scores_plain(t, a, mask)
    fn = _fn("c2v_cp_attention_scores")
    b, m, d = _check_t16(t)
    _check("attention_param", a, torch.float32, (d,))
    _check("mask", mask, torch.float32, (b, m))
    scores, stats = _f32((b, m), t.device), _f32((2, b), t.device)
    err = fn(t.data_ptr(), a.data_ptr(), mask.data_ptr(), b, m, d,
             scores.data_ptr(), stats.data_ptr(), launch.stream(t.device))
    launch.check_launch(err, "cp_attention_scores")
    launch.count(__name__)
    return scores, stats


def cp_attention_combine(t: torch.Tensor, scores: torch.Tensor,
                         gmax: torch.Tensor, gsum: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K16 phase 2, from every ctx rank's merged stats: (this rank's part
    of the code vector (b, d) f32, the weights exp(scores - gmax) /
    max(gsum, 1e-30) (b, m) f32; a non-finite max counts as 0)."""
    if launch.runs_plain(t, scores, gmax, gsum):
        return combine_plain(t, scores, gmax, gsum)
    fn = _fn("c2v_cp_attention_combine")
    b, m, d = _check_t16(t)
    _check("scores", scores, torch.float32, (b, m))
    _check("gmax", gmax, torch.float32, (b,))
    _check("gsum", gsum, torch.float32, (b,))
    cv, attn = _f32((b, d), t.device), _f32((b, m), t.device)
    err = fn(t.data_ptr(), scores.data_ptr(), gmax.data_ptr(),
             gsum.data_ptr(), b, m, d, cv.data_ptr(), attn.data_ptr(),
             launch.stream(t.device))
    launch.check_launch(err, "cp_attention_combine")
    launch.count(__name__)
    return cv, attn


def cp_attention_backward_fs(t: torch.Tensor, attn: torch.Tensor,
                             mask: torch.Tensor, g: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """K17 phase 1, the one read of t: (fs = bf16(g . t) (b, m) f32,
    this rank's sum of w fs (b,), and (2, b, d) f32 each row's sums over
    its valid contexts of w (fs - fs_0) t, then of w t, fs_0 the fs of
    its first context, for the d a that phase 2 writes without t)."""
    if launch.runs_plain(t, attn, mask, g):
        return backward_fs_plain(t, attn, mask, g)
    fn = _fn("c2v_cp_attention_backward_fs")
    b, m, d = _check_t16(t)
    _check("attention", attn, torch.float32, (b, m))
    _check("mask", mask, torch.float32, (b, m))
    _check("d_code_vectors", g, torch.float32, (b, d))
    fs, wfs = _f32((b, m), t.device), _f32((b,), t.device)
    pq = _f32((2, b, d), t.device)
    err = fn(t.data_ptr(), attn.data_ptr(), mask.data_ptr(), g.data_ptr(),
             b, m, d, fs.data_ptr(), wfs.data_ptr(), pq.data_ptr(),
             launch.stream(t.device))
    launch.check_launch(err, "cp_attention_backward_fs")
    launch.count(__name__, "backward_launches")
    return fs, wfs, pq


def cp_attention_backward_dt(a: torch.Tensor, mask: torch.Tensor,
                             attn: torch.Tensor, fs: torch.Tensor,
                             wfs: torch.Tensor, g: torch.Tensor,
                             pq: torch.Tensor,
                             dtype: torch.dtype = torch.bfloat16
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K17 phase 2, from the sum of w fs over every ctx rank and phase
    1's row sums, without t: (dt (b, m, d) in `dtype`, which is t's;
    this rank's part of d a (d,) f32, rounded to `dtype`)."""
    if launch.runs_plain(a, mask, attn, fs, wfs, g, pq):
        return backward_dt_plain(a, mask, attn, fs, wfs, g, pq, dtype)
    fn = _fn("c2v_cp_attention_backward_dt")
    launch.require(dtype == torch.bfloat16,
                   f"dt dtype {dtype}: the kernel writes bfloat16")
    launch.check_tensor(fs, "fs", [torch.float32], 2)
    launch.check_tensor(a, "attention_param", [torch.float32], 1)
    (b, m), d = fs.shape, a.shape[0]
    launch.require(d % 8 == 0 and d <= 1024,
                   f"code width {d} is not a multiple of 8 up to 1024")
    launch.require(8 * m <= 48 * 1024,
                   f"{m} contexts take more than 48 KB of shared memory "
                   f"a CTA")
    for name, x in (("mask", mask), ("attention", attn)):
        _check(name, x, torch.float32, (b, m))
    _check("wfs", wfs, torch.float32, (b,))
    _check("d_code_vectors", g, torch.float32, (b, d))
    _check("pq", pq, torch.float32, (2, b, d))
    dt = torch.empty((b, m, d), dtype=dtype, device=fs.device)
    da_rows, da = _f32((b, d), fs.device), _f32((d,), fs.device)
    err = fn(a.data_ptr(), mask.data_ptr(), attn.data_ptr(), fs.data_ptr(),
             wfs.data_ptr(), g.data_ptr(), pq.data_ptr(), b, m, d,
             dt.data_ptr(), da_rows.data_ptr(), da.data_ptr(),
             launch.stream(fs.device))
    launch.check_launch(err, "cp_attention_backward_dt")
    launch.count(__name__, "backward_launches")
    return dt, da
