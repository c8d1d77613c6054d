"""K16 cp_attention and K17 cp_attention_backward: masked single-query
attention with the contexts split over the `ctx` axis, and its backward,
as phases between the collectives over `ctx`.

K16 replaces code2vec_tpu/ops/attention.py masked_single_query_attention
with `axis_name` set (:52, :60, :67): scores and the rank's max, exp at
the global max and the rank's denominator, then the weights and the
rank's part of the code vector. K17 replaces its autodiff in the manual
train step: fs = bf16(g . t) and the rank's sum of w fs (the cotangent
of the denominator, summed over ctx by the caller), then dt and the
rank's part of d a. The CUDA source is csrc/cp_attention.cu; its header
gives the arithmetic, the rounding points (K6's), what bounds each phase
on an H100 and the design. The `*_plain` functions are the same in plain
PyTorch: CPU tensors take them, CUDA tensors launch the kernels. With one
ctx rank the phases compose to K2's and K6's plain versions
(ops/attention.py), which tests hold.

`launches` counts K16's phases (three a forward), `backward_launches`
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
    return s, s.amax(dim=1)


def exp_plain(scores, gmax):
    u = torch.exp(scores - _safe(gmax)[:, None])
    return u, u.sum(dim=1)


def combine_plain(t, unnorm, gdenom):
    attn = unnorm / torch.clamp(gdenom, min=1e-30)[:, None]
    cv = torch.einsum("bm,bmd->bd", attn.to(t.dtype).float(), t.float())
    return cv, attn


def backward_fs_plain(t, attn, g):
    fs = torch.einsum("bd,bmd->bm", g.float(), t.float()).to(
        t.dtype).float()
    return fs, (attn * fs).sum(dim=1)


def backward_dt_plain(t, a, mask, attn, fs, wfs, g):
    cd = t.dtype
    ds = torch.where(mask > 0, attn * (fs - wfs[:, None]),
                     torch.zeros_like(fs))
    ac = a.to(cd).float()
    w = attn.to(cd).float()
    dt = ((w[:, :, None] * g.float()[:, None, :]).to(cd).float()
          + (ds[:, :, None] * ac).to(cd).float()).to(cd)
    da = torch.einsum("bm,bmd->d", ds, t.float()).to(cd).float()
    return dt, da


# ------------------------------------------------------------- wrappers


def _fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        P, I32 = launch.P, launch.I32
        args = {
            "c2v_cp_attention_scores": [P, P, P, I32, I32, I32, P, P, P],
            "c2v_cp_attention_exp": [P, P, I32, I32, P, P, P],
            "c2v_cp_attention_combine": [P, P, P, I32, I32, I32, P, P, P],
            "c2v_cp_attention_backward_fs": [P, P, P, I32, I32, I32, P, P,
                                             P],
            "c2v_cp_attention_backward_dt": [P, P, P, P, P, P, P, I32, I32,
                                             I32, P, P, P, P],
        }[name]
        fn = _fns[name] = launch.bind("cp_attention", name, args)
    return fn


def _check_t(t: torch.Tensor):
    launch.check_tensor(t, "transformed", [torch.bfloat16], 3)
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
    """K16 phase 1: (scores (b, m) f32, -inf where masked; the row max
    over this rank's contexts (b,))."""
    if launch.runs_plain(t, a, mask):
        return scores_plain(t, a, mask)
    fn = _fn("c2v_cp_attention_scores")
    b, m, d = _check_t(t)
    _check("attention_param", a, torch.float32, (d,))
    _check("mask", mask, torch.float32, (b, m))
    scores, lmax = _f32((b, m), t.device), _f32((b,), t.device)
    err = fn(t.data_ptr(), a.data_ptr(), mask.data_ptr(), b, m, d,
             scores.data_ptr(), lmax.data_ptr(), launch.stream(t.device))
    launch.check_launch(err, "cp_attention_scores")
    launch.count(__name__)
    return scores, lmax


def cp_attention_exp(scores: torch.Tensor, gmax: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K16 phase 2: (exp(scores - global max) (b, m), this rank's
    denominators (b,)); a non-finite max counts as 0."""
    if launch.runs_plain(scores, gmax):
        return exp_plain(scores, gmax)
    fn = _fn("c2v_cp_attention_exp")
    launch.check_tensor(scores, "scores", [torch.float32], 2)
    b, m = scores.shape
    _check("gmax", gmax, torch.float32, (b,))
    unnorm, den = _f32((b, m), scores.device), _f32((b,), scores.device)
    err = fn(scores.data_ptr(), gmax.data_ptr(), b, m, unnorm.data_ptr(),
             den.data_ptr(), launch.stream(scores.device))
    launch.check_launch(err, "cp_attention_exp")
    launch.count(__name__)
    return unnorm, den


def cp_attention_combine(t: torch.Tensor, unnorm: torch.Tensor,
                         gdenom: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K16 phase 3: (this rank's part of the code vector (b, d) f32, the
    weights (b, m) f32)."""
    if launch.runs_plain(t, unnorm, gdenom):
        return combine_plain(t, unnorm, gdenom)
    fn = _fn("c2v_cp_attention_combine")
    b, m, d = _check_t(t)
    _check("unnorm", unnorm, torch.float32, (b, m))
    _check("gdenom", gdenom, torch.float32, (b,))
    cv, attn = _f32((b, d), t.device), _f32((b, m), t.device)
    err = fn(t.data_ptr(), unnorm.data_ptr(), gdenom.data_ptr(), b, m, d,
             cv.data_ptr(), attn.data_ptr(), launch.stream(t.device))
    launch.check_launch(err, "cp_attention_combine")
    launch.count(__name__)
    return cv, attn


def cp_attention_backward_fs(t: torch.Tensor, attn: torch.Tensor,
                             g: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K17 phase 1: (fs = bf16(g . t) (b, m) f32, this rank's sum of
    w fs (b,))."""
    if launch.runs_plain(t, attn, g):
        return backward_fs_plain(t, attn, g)
    fn = _fn("c2v_cp_attention_backward_fs")
    b, m, d = _check_t(t)
    _check("attention", attn, torch.float32, (b, m))
    _check("d_code_vectors", g, torch.float32, (b, d))
    fs, wfs = _f32((b, m), t.device), _f32((b,), t.device)
    err = fn(t.data_ptr(), attn.data_ptr(), g.data_ptr(), b, m, d,
             fs.data_ptr(), wfs.data_ptr(), launch.stream(t.device))
    launch.check_launch(err, "cp_attention_backward_fs")
    launch.count(__name__, "backward_launches")
    return fs, wfs


def cp_attention_backward_dt(t: torch.Tensor, a: torch.Tensor,
                             mask: torch.Tensor, attn: torch.Tensor,
                             fs: torch.Tensor, wfs: torch.Tensor,
                             g: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K17 phase 2, from the sum of w fs over every ctx rank: (dt
    (b, m, d) in t's dtype, this rank's part of d a (d,) f32, rounded to
    t's dtype)."""
    if launch.runs_plain(t, a, mask, attn, fs, wfs, g):
        return backward_dt_plain(t, a, mask, attn, fs, wfs, g)
    fn = _fn("c2v_cp_attention_backward_dt")
    b, m, d = _check_t(t)
    _check("attention_param", a, torch.float32, (d,))
    for name, x in (("mask", mask), ("attention", attn), ("fs", fs)):
        _check(name, x, torch.float32, (b, m))
    _check("wfs", wfs, torch.float32, (b,))
    _check("d_code_vectors", g, torch.float32, (b, d))
    dt = torch.empty_like(t)
    da_rows, da = _f32((b, d), t.device), _f32((d,), t.device)
    err = fn(t.data_ptr(), a.data_ptr(), mask.data_ptr(), attn.data_ptr(),
             fs.data_ptr(), wfs.data_ptr(), g.data_ptr(), b, m, d,
             dt.data_ptr(), da_rows.data_ptr(), da.data_ptr(),
             launch.stream(t.device))
    launch.check_launch(err, "cp_attention_backward_dt")
    launch.count(__name__, "backward_launches")
    return dt, da
