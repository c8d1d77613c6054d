"""Masked single-query attention over the bag of path-contexts, in plain
PyTorch: the counterpart of code2vec_tpu/ops/attention.py
masked_single_query_attention (:28-69) with axis_name=None, and the plain
version of kernel K2 (kernels/attention.py).

    scores = T . bf16(a)                 f32, -inf on invalid contexts
    attn   = softmax(scores)             max-stabilised; all-invalid -> 0
    cv     = sum(bf16(attn) * T)         f32

Products of values already rounded to the compute dtype are computed in
f32, which is exact for bf16 operands, so only the summation order can
differ from the reference.
"""

from __future__ import annotations

from typing import Tuple

import torch


def masked_single_query_attention(
    transformed: torch.Tensor,        # (B, M, D) tanh(ctx @ W)
    attention_param: torch.Tensor,    # (D,)
    context_valid_mask: torch.Tensor,  # (B, M) float {0, 1}
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (code_vectors (B, D) f32, attention_weights (B, M) f32)."""
    t = transformed.float()
    a = attention_param.to(transformed.dtype).float()
    scores = torch.einsum("bmd,d->bm", t, a)
    scores = torch.where(context_valid_mask > 0, scores,
                         torch.full_like(scores, float("-inf")))
    local_max = scores.amax(dim=1, keepdim=True)
    # all-invalid rows: exp(-inf - -inf) would be nan, so pin the max to 0
    safe_max = torch.where(torch.isfinite(local_max), local_max,
                           torch.zeros_like(local_max))
    unnorm = torch.exp(scores - safe_max)
    denom = unnorm.sum(dim=1, keepdim=True)
    attention = unnorm / torch.clamp(denom, min=1e-30)
    code_vectors = torch.einsum(
        "bm,bmd->bd", attention.to(transformed.dtype).float(), t)
    return code_vectors, attention
