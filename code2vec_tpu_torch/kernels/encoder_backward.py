"""K5 encoder_backward: the backward of K1 into dense table gradients,
or (row mode) into the gradients of the gathered rows.

Replaces the autodiff of code2vec_tpu/models/code2vec.py
transform_contexts / transform_gathered (:128-177) in the dense train
step, and (row mode, `encoder_backward_rows`) in the sparse one, whose
gradients are taken with respect to the gathered rows of
`apply_from_rows` (:213-224). The CUDA source is
csrc/encoder_backward.cu; its header lists the reference's rounding
points, what bounds it on an H100 and how its design answers that.
`encoder_backward_plain` and `encoder_backward_rows_plain` below are the
same functions in plain PyTorch: CPU tensors take them, CUDA tensors
launch the kernel. The row mode is counted apart, in `rows_launches`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from code2vec_tpu_torch.kernels import launch
from code2vec_tpu_torch.kernels.encoder import (
    Dropout, _cpu_draw, dropout_launch_args, gathered_context_plain,
)

launches = 0       # dense table gradients
rows_launches = 0  # row mode
_fns = {}


def _scatter_rows(table_grad: torch.Tensor, ids: torch.Tensor,
                  rows: torch.Tensor) -> None:
    """table_grad[ids] += rows; ids outside the table are dropped, as the
    reference's FILL_OR_DROP scatter drops them."""
    ids = ids.reshape(-1).long()
    rows = rows.reshape(-1, rows.shape[-1])
    ok = (ids >= 0) & (ids < table_grad.shape[0])
    table_grad.index_add_(0, ids[ok], rows[ok])


def _dctx_dw_plain(dt, t, t_lo, token_table, path_table, transform, src,
                   pth, tgt, cd, dropout):
    """The context cotangent (B, M, 3d) in the compute dtype and dW
    (k, d) f32."""
    k_dim, d = transform.shape
    g, tv = dt.float(), t.float() + t_lo.float()
    gp = g * (1 - tv)
    dpre = gp + gp * tv                                   # f32, tanh's rule
    ctx = gathered_context_plain(token_table, None, path_table, None, src,
                                 pth, tgt, cd, dropout)
    dctx = (dpre @ transform.to(cd).float().T).to(cd)
    if dropout is not None:
        mask = (dropout.mask if dropout.mask is not None
                else _cpu_draw(dropout, dctx.shape))
        keep = torch.tensor(dropout.keep, dtype=cd).float()
        dctx = torch.where(mask, (dctx.float() / keep).to(cd),
                           torch.zeros((), dtype=cd))
    dw = (ctx.float().reshape(-1, k_dim).T @ dpre.reshape(-1, d)).to(cd)
    return dctx, dw.float()


def encoder_backward_plain(dt: torch.Tensor, t: torch.Tensor,
                           t_lo: torch.Tensor,
                           token_table: torch.Tensor,
                           path_table: torch.Tensor,
                           transform: torch.Tensor, src: torch.Tensor,
                           pth: torch.Tensor, tgt: torch.Tensor, *,
                           compute_dtype: torch.dtype = torch.bfloat16,
                           dropout: Optional[Dropout] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(d_token_table, d_path_table, d_transform), all f32."""
    td, pd = token_table.shape[1], path_table.shape[1]
    dctx, dw = _dctx_dw_plain(dt, t, t_lo, token_table, path_table,
                              transform, src, pth, tgt, compute_dtype,
                              dropout)
    dctx = dctx.float()
    d_tok = torch.zeros_like(token_table, dtype=torch.float32)
    d_path = torch.zeros_like(path_table, dtype=torch.float32)
    _scatter_rows(d_tok, src, dctx[..., :td])
    _scatter_rows(d_path, pth, dctx[..., td:td + pd])
    _scatter_rows(d_tok, tgt, dctx[..., td + pd:])
    return d_tok, d_path, dw


def encoder_backward_rows_plain(dt: torch.Tensor, t: torch.Tensor,
                                t_lo: torch.Tensor,
                                token_table: torch.Tensor,
                                path_table: torch.Tensor,
                                transform: torch.Tensor, src: torch.Tensor,
                                pth: torch.Tensor, tgt: torch.Tensor, *,
                                compute_dtype: torch.dtype = torch.bfloat16,
                                dropout: Optional[Dropout] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """(token rows (2, B, M, td): the sources' then the targets', path
    rows (B, M, pd), both in the compute dtype, d_transform f32): the
    gradients of the gathered rows, with no scatter."""
    td, pd = token_table.shape[1], path_table.shape[1]
    dctx, dw = _dctx_dw_plain(dt, t, t_lo, token_table, path_table,
                              transform, src, pth, tgt, compute_dtype,
                              dropout)
    tok_rows = torch.stack([dctx[..., :td], dctx[..., td + pd:]])
    return tok_rows, dctx[..., td:td + pd].contiguous(), dw


def _fn():
    fn = _fns.get("encoder_backward")
    if fn is None:
        P, I32, I64, F32, U64 = (launch.P, launch.I32, launch.I64,
                                 launch.F32, launch.U64)
        fn = _fns["encoder_backward"] = launch.bind(
            "encoder_backward", "c2v_encoder_backward",
            [P, P, P, I32, P, P, I64, I32, P, I64, I32, P, P, P, I64,
             I32, F32, U64, U64, P, P, P, P, P, P, P, P, P, P, P, P])
        _fns["rows_padded"] = launch.bind(
            "encoder_backward", "c2v_encoder_backward_rows_padded", [I64],
            restype=I64)
        _fns["slices"] = launch.bind(
            "encoder_backward", "c2v_encoder_backward_slices", [I64])
    return fn


def encoder_backward(dt: torch.Tensor, t: torch.Tensor,
                     t_lo: torch.Tensor,
                     token_table: torch.Tensor, path_table: torch.Tensor,
                     transform: torch.Tensor, src: torch.Tensor,
                     pth: torch.Tensor, tgt: torch.Tensor, *,
                     compute_dtype: torch.dtype = torch.bfloat16,
                     dropout: Optional[Dropout] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cotangent dt of K1's output t (B, M, D) and K1's residual t_lo ->
    (d_token_table, d_path_table, d_transform) in f32. Tables are
    f32; `dropout` must be the forward's (the same mask, or the same
    (seed, step, keep))."""
    args = (dt, t, t_lo, token_table, path_table, transform, src, pth, tgt)
    masks = () if dropout is None else (dropout.mask,)
    if launch.runs_plain(*args, *masks):
        return encoder_backward_plain(*args, compute_dtype=compute_dtype,
                                      dropout=dropout)
    return _launch(*args, compute_dtype, dropout, rows=False)


def encoder_backward_rows(dt: torch.Tensor, t: torch.Tensor,
                          t_lo: torch.Tensor, token_table: torch.Tensor,
                          path_table: torch.Tensor, transform: torch.Tensor,
                          src: torch.Tensor, pth: torch.Tensor,
                          tgt: torch.Tensor, *,
                          compute_dtype: torch.dtype = torch.bfloat16,
                          dropout: Optional[Dropout] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """K5's row mode: as `encoder_backward`, but the table gradients stay
    rows: (token rows (2, B, M, td), the sources' then the targets', path
    rows (B, M, pd), in the compute dtype (bf16 on the card), and
    d_transform f32)."""
    args = (dt, t, t_lo, token_table, path_table, transform, src, pth, tgt)
    masks = () if dropout is None else (dropout.mask,)
    if launch.runs_plain(*args, *masks):
        return encoder_backward_rows_plain(
            *args, compute_dtype=compute_dtype, dropout=dropout)
    return _launch(*args, compute_dtype, dropout, rows=True)


def _launch(dt, t, t_lo, token_table, path_table, transform, src, pth, tgt,
            compute_dtype, dropout, *, rows: bool):
    fn = _fn()  # builds the library first: raises where nvcc is missing
    launch.require(compute_dtype == torch.bfloat16,
                   f"encoder_backward kernel computes in bfloat16, "
                   f"not {compute_dtype}")
    launch.require(dropout is None or dropout.out_mask is None,
                   "the backward takes no out_mask")
    for name, x in (("dt", dt), ("t", t), ("t_lo", t_lo)):
        launch.check_tensor(x, name, [torch.bfloat16], 3, align=16)
        launch.require(x.shape == t.shape, f"{name}: expected "
                                           f"{tuple(t.shape)}")
    b, m, d = t.shape
    for name, tbl in (("token_table", token_table),
                      ("path_table", path_table)):
        launch.check_tensor(tbl, name, [torch.float32], 2, align=16)
    td, pd = token_table.shape[1], path_table.shape[1]
    k_dim = 2 * td + pd
    launch.check_tensor(transform, "transform", [torch.float32], 2)
    launch.require(tuple(transform.shape) == (k_dim, d),
                   f"transform: expected ({k_dim}, {d})")
    launch.require(td % 4 == 0 and pd % 4 == 0 and k_dim % 128 == 0
                   and k_dim <= 384 and d % 128 == 0,
                   f"widths {td}, {pd} -> {d}: the kernel takes row widths "
                   f"in multiples of 4, a context width in multiples of 128 "
                   f"up to 384 and a code width in multiples of 128")
    for name, ids in (("src", src), ("pth", pth), ("tgt", tgt)):
        launch.check_tensor(ids, name, [torch.int32], 2)
        launch.require(tuple(ids.shape) == (b, m), f"{name}: expected "
                                                   f"({b}, {m})")
    device = t.device
    n_ctx = b * m
    drop = dropout_launch_args(dropout, (b, m, k_dim))
    n_pad = _fns["rows_padded"](n_ctx)
    slices = _fns["slices"](n_ctx)
    bf16 = dict(dtype=torch.bfloat16, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    wb = torch.empty((k_dim, d), **bf16)
    dpre_hi = torch.empty((n_pad, d), **bf16)
    dpre_lo = torch.empty((n_pad, d), **bf16)
    ctx_s = torch.empty((n_pad, k_dim), **bf16)
    partial = torch.empty((slices, k_dim, d), **f32)
    if rows:
        d_tok = torch.empty((2, b, m, td), **bf16)
        d_path = torch.empty((b, m, pd), **bf16)
    else:
        d_tok = torch.zeros(token_table.shape, **f32)
        d_path = torch.zeros(path_table.shape, **f32)
    dw = torch.empty((k_dim, d), **f32)
    g_out = (d_tok.data_ptr(), d_path.data_ptr()) if rows else (None, None)
    d_out = (None, None) if rows else (d_tok.data_ptr(), d_path.data_ptr())
    err = fn(dt.data_ptr(), t.data_ptr(), t_lo.data_ptr(), d,
             transform.data_ptr(),
             token_table.data_ptr(), token_table.shape[0], td,
             path_table.data_ptr(), path_table.shape[0], pd, src.data_ptr(),
             pth.data_ptr(), tgt.data_ptr(), n_ctx, *drop, wb.data_ptr(),
             dpre_hi.data_ptr(), dpre_lo.data_ptr(), ctx_s.data_ptr(),
             partial.data_ptr(), *d_out, dw.data_ptr(), *g_out,
             launch.stream(device))
    launch.check_launch(err, "encoder_backward")
    launch.count(__name__, "rows_launches" if rows else "launches")
    return d_tok, d_path, dw
