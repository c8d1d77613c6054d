"""K1 context_encoder: gather + dequant + concat + bf16 cast + dropout +
tanh(ctx @ W).

Replaces code2vec_tpu/models/code2vec.py transform_contexts /
transform_gathered (:128-177) and its mirror in the release step
(code2vec_tpu/release/runtime.py:113-122). The CUDA source is
csrc/encoder.cu; what bounds it on an H100 and how its design answers
that is written at the top of that file. `context_encoder_plain` below is
the same function in plain PyTorch: CPU tensors take it, CUDA tensors
launch the kernel.

Dropout (train mode) follows the reference's `transform_gathered`
(:167-173): after the cast to the compute dtype, kept elements become
x / keep rounded to that dtype, dropped ones 0. Which elements are kept
is given by a `Dropout`:
- `mask` set: the caller's (B, M, 3d) bool mask (tests, and the CPU
  backward, which reuses the mask its forward drew);
- otherwise drawn from (seed, step): on a CUDA tensor by the Philox
  generator inside the kernel, keyed by each element's flat index, so the
  backward kernel redraws the same bits; on the CPU by a torch.Generator
  seeded from (seed, step). The two draw different masks, as JAX's rbg
  and threefry do; `out_mask` receives the mask that was drawn.

With `residual=True` it also returns bf16(tanh - out), so that the
backward (K5) can differentiate tanh at its f32 value, as the reference
does, without a saved f32 copy of the activations.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from code2vec_tpu_torch.kernels import launch
from code2vec_tpu_torch.ops.quant import table_gather

launches = 0
_fns = {}

DROP_NONE, DROP_DRAW, DROP_MASK = 0, 1, 2  # csrc/common.cuh c2v::Dropout


@dataclasses.dataclass(frozen=True)
class Dropout:
    """Train-mode dropout of the (B, M, 3d) context: keep rate, the
    (seed, step) key of a drawn mask, or an injected bool `mask`, and an
    optional bool buffer `out_mask` that receives the mask used."""
    keep: float
    seed: int = 0
    step: int = 0
    mask: Optional[torch.Tensor] = None
    out_mask: Optional[torch.Tensor] = None


def _cpu_draw(d: Dropout, shape) -> torch.Tensor:
    g = torch.Generator().manual_seed(
        (d.seed * 0x9E3779B97F4A7C15 + d.step) % (1 << 63))
    return torch.rand(shape, generator=g) < d.keep


def dropout_plain(ctx: torch.Tensor, d: Optional[Dropout]) -> torch.Tensor:
    """where(mask, ctx / keep, 0) in ctx's dtype (bf16: the quotient of the
    bf16 value by bf16(keep), rounded to bf16), as the reference."""
    if d is None:
        return ctx
    mask = d.mask if d.mask is not None else _cpu_draw(d, ctx.shape)
    if d.out_mask is not None:
        d.out_mask.copy_(mask)
    keep = torch.tensor(d.keep, dtype=ctx.dtype).float()
    return torch.where(mask, (ctx.float() / keep).to(ctx.dtype),
                       torch.zeros((), dtype=ctx.dtype))


def gathered_context_plain(token_table, token_scales, path_table,
                           path_scales, src, pth, tgt, compute_dtype,
                           dropout: Optional[Dropout] = None):
    """The (B, M, 3d) context in the compute dtype, after dropout."""
    src_rows = table_gather(token_table, token_scales, src)
    pth_rows = table_gather(path_table, path_scales, pth)
    tgt_rows = table_gather(token_table, token_scales, tgt)
    ctx = torch.cat([src_rows, pth_rows, tgt_rows], dim=-1).to(compute_dtype)
    return dropout_plain(ctx, dropout)


def context_encoder_plain(token_table: torch.Tensor,
                          token_scales: Optional[torch.Tensor],
                          path_table: torch.Tensor,
                          path_scales: Optional[torch.Tensor],
                          transform: torch.Tensor, src: torch.Tensor,
                          pth: torch.Tensor, tgt: torch.Tensor, *,
                          compute_dtype: torch.dtype = torch.bfloat16,
                          dropout: Optional[Dropout] = None,
                          residual: bool = False):
    ctx = gathered_context_plain(token_table, token_scales, path_table,
                                 path_scales, src, pth, tgt, compute_dtype,
                                 dropout)
    w = transform.to(compute_dtype).float()
    th = torch.tanh(ctx.float() @ w)
    out = th.to(compute_dtype)
    if residual:
        return out, (th - out.float()).to(compute_dtype)
    return out


def dropout_launch_args(d: Optional[Dropout], shape):
    """(mode, keep, seed, step, mask pointer) for a kernel's C entry point,
    after checking the masks against the (B, M, 3d) `shape`."""
    if d is None:
        return DROP_NONE, 1.0, 0, 0, None
    launch.require(0.0 < d.keep <= 1.0, f"keep rate {d.keep} not in (0, 1]")
    for name, m in (("mask", d.mask), ("out_mask", d.out_mask)):
        if m is not None:
            launch.check_tensor(m, name, [torch.bool], 3)
            launch.require(tuple(m.shape) == tuple(shape),
                           f"{name}: expected {tuple(shape)}")
    seed, step = int(d.seed) % (1 << 64), int(d.step) % (1 << 64)
    if d.mask is not None:
        launch.require(d.out_mask is None,
                       "an injected mask takes no out_mask")
        return DROP_MASK, float(d.keep), seed, step, d.mask.data_ptr()
    return DROP_DRAW, float(d.keep), seed, step, launch.ptr(d.out_mask)


def _fn():
    fn = _fns.get("encoder")
    if fn is None:
        P, I32, I64, F32, U64 = (launch.P, launch.I32, launch.I64,
                                 launch.F32, launch.U64)
        fn = _fns["encoder"] = launch.bind(
            "encoder", "c2v_context_encoder",
            [P, P, I64, I32, P, P, I64, I32, I32, P, I32, P, P, P, I64, P,
             P, I32, F32, U64, U64, P, P])
        _fns["smem"] = launch.bind("encoder", "c2v_context_encoder_smem",
                                   [I32], restype=I64)
    return fn


def context_encoder(token_table: torch.Tensor,
                    token_scales: Optional[torch.Tensor],
                    path_table: torch.Tensor,
                    path_scales: Optional[torch.Tensor],
                    transform: torch.Tensor, src: torch.Tensor,
                    pth: torch.Tensor, tgt: torch.Tensor, *,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    dropout: Optional[Dropout] = None,
                    residual: bool = False):
    """(B, M) token/path/token ids -> (B, M, D) transformed contexts in
    `compute_dtype`, and with `residual` their residual as a second
    result. Tables are int8 with (V, 1) f32 scales, or f32 with scales
    None. `dropout` set: train mode (module docstring)."""
    args = (token_table, token_scales, path_table, path_scales, transform,
            src, pth, tgt)
    masks = () if dropout is None else (dropout.mask, dropout.out_mask)
    if launch.runs_plain(*args, *masks):
        return context_encoder_plain(*args, compute_dtype=compute_dtype,
                                     dropout=dropout, residual=residual)
    fn = _fn()  # builds the library first: raises where nvcc is missing
    launch.require(compute_dtype == torch.bfloat16,
                   f"context_encoder kernel computes in bfloat16, "
                   f"not {compute_dtype}")
    int8 = token_table.dtype == torch.int8
    table_dtypes = [torch.int8] if int8 else [torch.float32]
    launch.check_tensor(token_table, "token_table", table_dtypes, 2,
                        align=16)
    launch.check_tensor(path_table, "path_table", table_dtypes, 2, align=16)
    for name, s, t in (("token_scales", token_scales, token_table),
                       ("path_scales", path_scales, path_table)):
        if int8:
            launch.require(s is not None, f"{name}: int8 tables need scales")
            launch.check_tensor(s, name, [torch.float32], 2)
            launch.require(tuple(s.shape) == (t.shape[0], 1),
                           f"{name}: expected ({t.shape[0]}, 1)")
        else:
            launch.require(s is None, f"{name}: f32 tables take no scales")
    tok_dim, path_dim = token_table.shape[1], path_table.shape[1]
    k_dim = 2 * tok_dim + path_dim
    launch.check_tensor(transform, "transform", [torch.float32], 2,
                        align=16)
    launch.require(transform.shape[0] == k_dim,
                   f"transform: expected {k_dim} rows, got "
                   f"{transform.shape[0]}")
    launch.require(tok_dim % 4 == 0 and path_dim % 4 == 0
                   and k_dim % 16 == 0 and transform.shape[1] % 16 == 0,
                   f"widths {tok_dim}, {path_dim} -> {transform.shape[1]}: "
                   f"the kernel takes row widths in multiples of 4 and "
                   f"context/code widths in multiples of 16")
    for name, ids in (("src", src), ("pth", pth), ("tgt", tgt)):
        launch.check_tensor(ids, name, [torch.int32], 2)
        launch.require(ids.shape == src.shape, f"{name}: shape mismatch")
    device = src.device
    smem = _fns["smem"](k_dim)
    launch.require(smem <= launch.shared_memory_limit(device),
                   f"context width {k_dim} needs {smem} bytes of shared "
                   f"memory per block")
    b, m = src.shape
    d_out = transform.shape[1]
    drop = dropout_launch_args(dropout, (b, m, k_dim))
    out = torch.empty((b, m, d_out), dtype=torch.bfloat16, device=device)
    out_lo = torch.empty_like(out) if residual else None
    err = fn(token_table.data_ptr(), launch.ptr(token_scales),
             token_table.shape[0], tok_dim, path_table.data_ptr(),
             launch.ptr(path_scales), path_table.shape[0], path_dim,
             int(int8), transform.data_ptr(), d_out, src.data_ptr(),
             pth.data_ptr(), tgt.data_ptr(), b * m, out.data_ptr(),
             launch.ptr(out_lo), *drop, launch.stream(device))
    launch.check_launch(err, "context_encoder")
    launch.count(__name__)
    return (out, out_lo) if residual else out
