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

`context_parallel_attention` and its backward are the reference's
function with `axis_name` set (the contexts split over the mesh's ctx
axis): kernels K16 and K17 (kernels/cp_attention.py) between the
collectives, or K2 and K6 on one ctx rank.
"""

from __future__ import annotations

from typing import Tuple

import torch

from code2vec_tpu_torch.kernels.cp_attention import (
    cp_attention_backward_dt, cp_attention_backward_fs, cp_attention_combine,
    cp_attention_scores,
)
from code2vec_tpu_torch.kernels.sharded import merge_softmax_stats


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


def context_parallel_attention(transformed: torch.Tensor,
                               attention_param: torch.Tensor,
                               context_valid_mask: torch.Tensor,
                               comm=None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """masked_single_query_attention (:28-69 of the reference) with the
    contexts split over the ranks of `comm` (the mesh's ctx axis; None or
    one rank: K2 as the single-device step calls it). K16's two phases
    around an all-gather of each rank's (max, sum of exp) of the scores,
    merged in rank order into the global ones, and a SUM of the code
    vector's parts; returns (code_vectors (B, D) f32, this rank's
    attention weights (B, M_local) f32)."""
    from code2vec_tpu_torch.kernels.attention import masked_attention
    if comm is None or comm.size == 1:
        return masked_attention(transformed, attention_param,
                                context_valid_mask)
    scores, stats = cp_attention_scores(transformed, attention_param,
                                        context_valid_mask)
    parts = comm.all_gather(stats).view(comm.size, 2, -1)
    gmax, gsum = merge_softmax_stats(parts[:, 0], parts[:, 1])
    code_vectors, attention = cp_attention_combine(transformed, scores,
                                                   gmax, gsum)
    comm.all_reduce(code_vectors)
    return code_vectors, attention


def context_parallel_attention_backward(
        transformed: torch.Tensor, attention_param: torch.Tensor,
        context_valid_mask: torch.Tensor, attention: torch.Tensor,
        d_code_vectors: torch.Tensor, comm=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward of context_parallel_attention from the cotangent of
    the (global) code vectors: (d_transformed of this rank's contexts,
    this rank's part of d attention_param, which the caller sums over the
    ranks). K17's two phases around a SUM of each row's sum of w fs (t
    read once, by the first); K6 with one rank."""
    from code2vec_tpu_torch.kernels.attention import (
        masked_attention_backward,
    )
    if comm is None or comm.size == 1:
        return masked_attention_backward(transformed, attention_param,
                                         context_valid_mask, attention,
                                         d_code_vectors)
    fs, wfs, pq = cp_attention_backward_fs(transformed, attention,
                                           context_valid_mask,
                                           d_code_vectors)
    comm.all_reduce(wfs)
    return cp_attention_backward_dt(attention_param, context_valid_mask,
                                    attention, fs, wfs, d_code_vectors, pq,
                                    transformed.dtype)
