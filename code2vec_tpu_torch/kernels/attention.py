"""K2 masked_attention: masked single-query attention over the contexts.

Replaces code2vec_tpu/ops/attention.py masked_single_query_attention
(:28-69, axis_name=None). The CUDA source is csrc/attention.cu; what
bounds it on an H100 and how its design answers that is written at the
top of that file. The plain version is ops/attention.py
masked_single_query_attention: CPU tensors take it, CUDA tensors launch
the kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from code2vec_tpu_torch.kernels import launch
from code2vec_tpu_torch.ops.attention import masked_single_query_attention

launches = 0
_fns = {}

masked_attention_plain = masked_single_query_attention


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
    global launches
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
    launches += 1
    return cv, attn
