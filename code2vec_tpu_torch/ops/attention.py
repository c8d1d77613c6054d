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

`masked_single_query_attention_backward` is the backward with respect to
the contexts and the query, the plain version of kernel K6; its rounding
points are those of `jax.grad` of the reference (csrc/attention_backward.cu
lists them).
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


def masked_single_query_attention_backward(
    transformed: torch.Tensor,         # (B, M, D) the forward's input
    attention_param: torch.Tensor,     # (D,)
    context_valid_mask: torch.Tensor,  # (B, M)
    attention: torch.Tensor,           # (B, M) f32 weights of the forward
    d_code_vectors: torch.Tensor,      # (B, D) f32 cotangent
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d_transformed (B, M, D) in transformed's dtype, d_attention_param
    (D,) f32)."""
    cd = transformed.dtype
    t = transformed.float()
    g = d_code_vectors.float()
    fs = torch.einsum("bd,bmd->bm", g, t).to(cd).float()
    wfs = (attention * fs).sum(dim=1, keepdim=True)
    ds = torch.where(context_valid_mask > 0, attention * (fs - wfs),
                     torch.zeros_like(fs))
    a = attention_param.to(cd).float()
    w = attention.to(cd).float()
    dt = ((w[:, :, None] * g[:, None, :]).to(cd).float()
          + (ds[:, :, None] * a).to(cd).float()).to(cd)
    da = torch.einsum("bm,bmd->d", ds, t).to(cd).float()
    return dt, da
