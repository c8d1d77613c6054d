"""K2 masked_attention and K6 masked_attention_backward: masked
single-query attention over the contexts, and its backward.

K2 replaces code2vec_tpu/ops/attention.py masked_single_query_attention
(:28-69, axis_name=None), K6 its autodiff in the dense train step. The
CUDA sources are csrc/attention.cu and csrc/attention_backward.cu; what
bounds each on an H100, how its design answers that and (K6) the
reference's rounding points are written at the top of those files. The
plain versions are ops/attention.py masked_single_query_attention and
masked_single_query_attention_backward: CPU tensors take them, CUDA
tensors launch the kernels. K6 keeps its own count, `backward_launches`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from code2vec_tpu_torch.kernels import launch
from code2vec_tpu_torch.ops.attention import (
    masked_single_query_attention, masked_single_query_attention_backward,
)

launches = 0
backward_launches = 0
_fns = {}

masked_attention_plain = masked_single_query_attention
masked_attention_backward_plain = masked_single_query_attention_backward


def _fn():
    fn = _fns.get("attention")
    if fn is None:
        P, I32 = launch.P, launch.I32
        fn = _fns["attention"] = launch.bind(
            "attention", "c2v_masked_attention",
            [P, P, P, I32, I32, I32, P, P, P])
    return fn


def masked_attention(transformed: torch.Tensor,
                     attention_param: torch.Tensor,
                     context_valid_mask: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, M, D) contexts, (D,) query, (B, M) mask -> (code vectors
    (B, D) f32, attention (B, M) f32)."""
    if launch.runs_plain(transformed, attention_param, context_valid_mask):
        return masked_attention_plain(transformed, attention_param,
                                      context_valid_mask)
    fn = _fn()  # builds the library first: raises where nvcc is missing
    launch.check_tensor(transformed, "transformed", [torch.bfloat16], 3,
                        align=16)
    b, m, d = transformed.shape
    launch.require(d % 8 == 0, f"code width {d} is not a multiple of 8")
    launch.check_tensor(attention_param, "attention_param",
                        [torch.float32], 1)
    launch.require(attention_param.shape[0] == d,
                   f"attention_param: expected ({d},)")
    launch.check_tensor(context_valid_mask, "context_valid_mask",
                        [torch.float32], 2)
    launch.require(tuple(context_valid_mask.shape) == (b, m),
                   f"context_valid_mask: expected ({b}, {m})")
    smem = 4 * (m + d + 8)
    launch.require(smem <= launch.shared_memory_limit(transformed.device),
                   f"{m} contexts need {smem} bytes of shared memory")
    cv = torch.empty((b, d), dtype=torch.float32, device=transformed.device)
    attn = torch.empty((b, m), dtype=torch.float32,
                       device=transformed.device)
    err = fn(transformed.data_ptr(), attention_param.data_ptr(),
             context_valid_mask.data_ptr(), b, m, d, cv.data_ptr(),
             attn.data_ptr(), launch.stream(transformed.device))
    launch.check_launch(err, "masked_attention")
    launch.count(__name__)
    return cv, attn


def _backward_fn():
    fn = _fns.get("attention_backward")
    if fn is None:
        P, I32 = launch.P, launch.I32
        fn = _fns["attention_backward"] = launch.bind(
            "attention_backward", "c2v_attention_backward",
            [P, P, P, P, P, I32, I32, I32, P, P, P, P])
    return fn


def masked_attention_backward(transformed: torch.Tensor,
                              attention_param: torch.Tensor,
                              context_valid_mask: torch.Tensor,
                              attention: torch.Tensor,
                              d_code_vectors: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward's inputs and f32 weights, and the code vectors'
    cotangent (B, D) f32 -> (d_transformed (B, M, D) in its dtype,
    d_attention_param (D,) f32)."""
    args = (transformed, attention_param, context_valid_mask, attention,
            d_code_vectors)
    if launch.runs_plain(*args):
        return masked_attention_backward_plain(*args)
    fn = _backward_fn()  # builds the library first: raises without nvcc
    launch.check_tensor(transformed, "transformed", [torch.bfloat16], 3,
                        align=16)
    b, m, d = transformed.shape
    launch.require(d % 8 == 0, f"code width {d} is not a multiple of 8")
    launch.check_tensor(attention_param, "attention_param",
                        [torch.float32], 1)
    launch.require(attention_param.shape[0] == d,
                   f"attention_param: expected ({d},)")
    for name, x in (("context_valid_mask", context_valid_mask),
                    ("attention", attention)):
        launch.check_tensor(x, name, [torch.float32], 2)
        launch.require(tuple(x.shape) == (b, m), f"{name}: expected "
                                                 f"({b}, {m})")
    launch.check_tensor(d_code_vectors, "d_code_vectors", [torch.float32], 2)
    launch.require(tuple(d_code_vectors.shape) == (b, d),
                   f"d_code_vectors: expected ({b}, {d})")
    smem = 4 * (m + 2 * d + 8)
    launch.require(smem <= launch.shared_memory_limit(transformed.device),
                   f"{m} contexts need {smem} bytes of shared memory")
    device = transformed.device
    dt = torch.empty_like(transformed)
    da_rows = torch.empty((b, d), dtype=torch.float32, device=device)
    da = torch.empty((d,), dtype=torch.float32, device=device)
    err = fn(transformed.data_ptr(), attention_param.data_ptr(),
             context_valid_mask.data_ptr(), attention.data_ptr(),
             d_code_vectors.data_ptr(), b, m, d, dt.data_ptr(),
             da_rows.data_ptr(), da.data_ptr(), launch.stream(device))
    launch.check_launch(err, "masked_attention_backward")
    launch.count(__name__, "backward_launches")
    return dt, da
