"""K1 context_encoder: gather + dequant + concat + bf16 cast + tanh(ctx @ W).

Replaces code2vec_tpu/models/code2vec.py transform_contexts /
transform_gathered (:128-177) and its mirror in the release step
(code2vec_tpu/release/runtime.py:113-122). The CUDA source is
csrc/encoder.cu; what bounds it on an H100 and how its design answers
that is written at the top of that file. `context_encoder_plain` below is
the same function in plain PyTorch: CPU tensors take it, CUDA tensors
launch the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from code2vec_tpu_torch.kernels import launch
from code2vec_tpu_torch.ops.quant import table_gather

launches = 0
_fns = {}


def context_encoder_plain(token_table: torch.Tensor,
                          token_scales: Optional[torch.Tensor],
                          path_table: torch.Tensor,
                          path_scales: Optional[torch.Tensor],
                          transform: torch.Tensor, src: torch.Tensor,
                          pth: torch.Tensor, tgt: torch.Tensor, *,
                          compute_dtype: torch.dtype = torch.bfloat16
                          ) -> torch.Tensor:
    src_rows = table_gather(token_table, token_scales, src)
    pth_rows = table_gather(path_table, path_scales, pth)
    tgt_rows = table_gather(token_table, token_scales, tgt)
    ctx = torch.cat([src_rows, pth_rows, tgt_rows], dim=-1).to(compute_dtype)
    w = transform.to(compute_dtype).float()
    return torch.tanh(ctx.float() @ w).to(compute_dtype)


def _fn():
    fn = _fns.get("encoder")
    if fn is None:
        P, I32, I64 = launch.P, launch.I32, launch.I64
        fn = _fns["encoder"] = launch.bind(
            "encoder", "c2v_context_encoder",
            [P, P, I64, I32, P, P, I64, I32, I32, P, I32, P, P, P, I64, P, P])
        _fns["smem"] = launch.bind("encoder", "c2v_context_encoder_smem",
                                   [I32], restype=I64)
    return fn


def context_encoder(token_table: torch.Tensor,
                    token_scales: Optional[torch.Tensor],
                    path_table: torch.Tensor,
                    path_scales: Optional[torch.Tensor],
                    transform: torch.Tensor, src: torch.Tensor,
                    pth: torch.Tensor, tgt: torch.Tensor, *,
                    compute_dtype: torch.dtype = torch.bfloat16
                    ) -> torch.Tensor:
    """(B, M) token/path/token ids -> (B, M, D) transformed contexts in
    `compute_dtype`. Tables are int8 with (V, 1) f32 scales, or f32 with
    scales None."""
    args = (token_table, token_scales, path_table, path_scales, transform,
            src, pth, tgt)
    if launch.runs_plain(*args):
        return context_encoder_plain(*args, compute_dtype=compute_dtype)
    global launches
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
    out = torch.empty((b, m, d_out), dtype=torch.bfloat16, device=device)
    err = fn(token_table.data_ptr(), launch.ptr(token_scales),
             token_table.shape[0], tok_dim, path_table.data_ptr(),
             launch.ptr(path_scales), path_table.shape[0], path_dim,
             int(int8), transform.data_ptr(), d_out, src.data_ptr(),
             pth.data_ptr(), tgt.data_ptr(), b * m, out.data_ptr(),
             launch.stream(device))
    launch.check_launch(err, "context_encoder")
    launches += 1
    return out
