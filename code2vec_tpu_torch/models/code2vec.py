"""The code2vec model as an `nn.Module`.

The counterpart of code2vec_tpu/models/code2vec.py (:128-232):

  token/path embedding gathers -> concat (B, M, 3d) -> compute dtype
  -> dropout (train) -> tanh(. @ transform)   K1, backward K5 (or its
                                                row mode: RowGrads)
  -> masked single-query attention -> code vector      K2, backward K6
  -> logits = code_vector @ target_embedding.T         plain product
  -> softmax cross-entropy (train loss)                K7

Parameters keep the Flax names and shapes (:110-126): `transform` is
(in, out) and `attention` is (D, 1), so a Flax param tree loads with no
transpose (weights.py). `torch.autograd.Function`s tie each kernel to its
backward, so the module trains once its parameters require grad
(training/state.py). As in the reference, `deterministic=False` turns
dropout on; its mask is drawn from (dropout_seed, dropout_step) or given
as `dropout_mask` (kernels/encoder.py).

For the sparse train step (training/step.py), `encode(...,
row_grads=RowGrads())` runs the same forward, and its backward leaves
the gradients of the gathered rows in the RowGrads (K5's row mode) in
place of table-shaped gradients: the reference's gather outside the
differentiated function, then `apply_from_rows` (:213-224), whose rows
take the same values as the gather inside K1.

The classifier product is left to the library, as the reference leaves
it to XLA: bf16 operands with f32 results (`matmul_f32`), forward and
backward.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from code2vec_tpu_torch.kernels.attention import (
    masked_attention, masked_attention_backward,
)
from code2vec_tpu_torch.kernels.encoder import Dropout, context_encoder
from code2vec_tpu_torch.kernels.encoder_backward import (
    encoder_backward, encoder_backward_rows,
)
from code2vec_tpu_torch.kernels.softmax_xent import softmax_xent


@dataclasses.dataclass(frozen=True)
class ModelDims:
    token_vocab_size: int
    path_vocab_size: int
    target_vocab_size: int
    token_dim: int = 128
    path_dim: int = 128
    # rows >= real_target_vocab_size are padding; their logits are -inf
    real_target_vocab_size: int = 0
    # labels <= this are PAD/OOV and carry no CE term
    target_oov_floor: int = 0

    def __post_init__(self):
        if self.real_target_vocab_size == 0:
            object.__setattr__(self, "real_target_vocab_size",
                               self.target_vocab_size)

    @property
    def context_dim(self) -> int:
        return self.path_dim + 2 * self.token_dim

    @property
    def code_dim(self) -> int:
        return self.context_dim

    @property
    def has_padded_targets(self) -> bool:
        return self.real_target_vocab_size < self.target_vocab_size

    def padded_to(self, tp: int) -> "ModelDims":
        """The table row counts rounded up to a multiple of `tp`, so that
        the row shards of a tp-way mesh are equal; the padded target rows
        never win (their logits are -inf), as the reference's
        (code2vec_tpu/models/code2vec.py:67-80)."""
        def up(n):
            return -(-n // tp) * tp
        return dataclasses.replace(
            self, token_vocab_size=up(self.token_vocab_size),
            path_vocab_size=up(self.path_vocab_size),
            target_vocab_size=up(self.target_vocab_size),
            real_target_vocab_size=self.real_target_vocab_size)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with f32 results. bf16 operands: their products are exact in
    f32 and summed in f32 (cuBLAS on the card, an f32 product of the
    widened values on the CPU), the reference's preferred_element_type."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class RowGrads:
    """Where the row-gradient encoder's backward leaves the gradients of
    the gathered rows: `tok` (2, B, M, td), the source then the target
    rows, and `path` (B, M, pd), in the compute dtype."""

    def __init__(self):
        self.tok: Optional[torch.Tensor] = None
        self.path: Optional[torch.Tensor] = None


class _EncoderFn(torch.autograd.Function):
    """K1 forward, K5 backward. The backward re-gathers the context and
    redraws the dropout mask instead of saving them; it differentiates
    tanh at K1's output plus K1's residual (kernels/encoder.py). With
    `row_grads` it runs K5's row mode: the tables' gradients go there as
    rows, never to the tables."""

    @staticmethod
    def forward(ctx, token_embedding, path_embedding, transform, src, pth,
                tgt, compute_dtype, dropout, row_grads):
        t, t_lo = context_encoder(
            token_embedding, None, path_embedding, None, transform, src,
            pth, tgt, compute_dtype=compute_dtype, dropout=dropout,
            residual=True)
        ctx.save_for_backward(token_embedding, path_embedding, transform,
                              src, pth, tgt, t, t_lo)
        ctx.mark_non_differentiable(t_lo)
        ctx.compute_dtype, ctx.dropout = compute_dtype, dropout
        ctx.row_grads = row_grads
        return t, t_lo

    @staticmethod
    def backward(ctx, dt, d_t_lo):
        tok, path, w, src, pth, tgt, t, t_lo = ctx.saved_tensors
        args = (dt.contiguous(), t, t_lo, tok, path, w, src, pth, tgt)
        kw = dict(compute_dtype=ctx.compute_dtype, dropout=ctx.dropout)
        if ctx.row_grads is None:
            d_tok, d_path, dw = encoder_backward(*args, **kw)
        else:
            rows = ctx.row_grads
            rows.tok, rows.path, dw = encoder_backward_rows(*args, **kw)
            d_tok = d_path = None
        return d_tok, d_path, dw, None, None, None, None, None, None


class _AttentionFn(torch.autograd.Function):
    """K2 forward, K6 backward (with respect to the contexts and the
    query; the attention weights output carries no gradient)."""

    @staticmethod
    def forward(ctx, transformed, attention_param, context_valid_mask):
        cv, attn = masked_attention(transformed, attention_param,
                                    context_valid_mask)
        ctx.save_for_backward(transformed, attention_param,
                              context_valid_mask, attn)
        ctx.mark_non_differentiable(attn)
        return cv, attn

    @staticmethod
    def backward(ctx, d_cv, d_attn):
        t, a, mask, attn = ctx.saved_tensors
        dt, da = masked_attention_backward(t, a, mask, attn,
                                           d_cv.float().contiguous())
        return dt, da, None


class _LogitsXentFn(torch.autograd.Function):
    """The train loss from the code vectors: the classifier product
    (`matmul_f32`), then K7, which also writes d loss / d logits (for bf16
    compute as two bf16 planes hi + lo, which stack into one product of
    twice the rows); the backward is the two products of that gradient,
    each result rounded to the compute dtype where the reference's
    cotangents of the bf16 operands are."""

    @staticmethod
    def forward(ctx, code_vectors, target_embedding, labels, valid,
                compute_dtype, n_real):
        cv = code_vectors.to(compute_dtype)
        tgt = target_embedding.to(compute_dtype)
        logits = matmul_f32(cv, tgt.T)
        loss, g = softmax_xent(logits, labels, valid, n_real=n_real,
                               grad_dtype=compute_dtype)
        del logits
        ctx.save_for_backward(cv, tgt, g)
        return loss

    @staticmethod
    def backward(ctx, d_loss):
        cv, tgt, g = ctx.saved_tensors
        cd = cv.dtype
        if g.dim() == 3:  # hi and lo planes: (2B, V) against [cv; cv]
            b = cv.shape[0]
            g = g.reshape(2 * b, -1)
            d_cv = matmul_f32(g, tgt)
            d_cv = d_cv[:b] + d_cv[b:]
            cv = torch.cat([cv, cv])
        else:
            d_cv = matmul_f32(g, tgt)
        d_cv = (d_cv * d_loss).to(cd).float()
        d_tgt = (matmul_f32(g.T, cv) * d_loss).to(cd).float()
        return d_cv, d_tgt, None, None, None, None


def _uniform(shape, limit, generator, device):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return t.uniform_(-limit, limit, generator=generator)


class Code2VecModule(nn.Module):
    """Initialised as the reference: embeddings variance_scaling(1.0,
    fan_out, uniform), transform and attention glorot_uniform."""

    def __init__(self, dims: ModelDims,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None,
                 dropout_keep_rate: float = 0.75):
        super().__init__()
        self.dims = dims
        self.compute_dtype = compute_dtype
        self.dropout_keep_rate = dropout_keep_rate
        d = dims

        def emb(rows, cols):
            return nn.Parameter(_uniform((rows, cols), math.sqrt(3.0 / cols),
                                         generator, device),
                                requires_grad=False)

        def glorot(fan_in, fan_out):
            return nn.Parameter(_uniform(
                (fan_in, fan_out), math.sqrt(6.0 / (fan_in + fan_out)),
                generator, device), requires_grad=False)

        self.token_embedding = emb(d.token_vocab_size, d.token_dim)
        self.path_embedding = emb(d.path_vocab_size, d.path_dim)
        self.target_embedding = emb(d.target_vocab_size, d.code_dim)
        self.transform = glorot(d.context_dim, d.code_dim)
        self.attention = glorot(d.code_dim, 1)

    def _dropout(self, deterministic: bool, dropout_seed: int,
                 dropout_step: int, dropout_mask: Optional[torch.Tensor]
                 ) -> Optional[Dropout]:
        if deterministic:
            return None
        return Dropout(keep=self.dropout_keep_rate, seed=dropout_seed,
                       step=dropout_step, mask=dropout_mask)

    def transform_contexts(self, source_token_indices: torch.Tensor,
                           path_indices: torch.Tensor,
                           target_token_indices: torch.Tensor,
                           deterministic: bool = True,
                           dropout_seed: int = 0, dropout_step: int = 0,
                           dropout_mask: Optional[torch.Tensor] = None,
                           row_grads: Optional[RowGrads] = None
                           ) -> torch.Tensor:
        """(B, M) ids -> (B, M, code_dim) in the compute dtype; with
        deterministic=False, dropout on the (B, M, 3d) context. With
        `row_grads`, the backward leaves the tables' gradients there as
        rows (the sparse step)."""
        return _EncoderFn.apply(
            self.token_embedding, self.path_embedding, self.transform,
            source_token_indices, path_indices, target_token_indices,
            self.compute_dtype,
            self._dropout(deterministic, dropout_seed, dropout_step,
                          dropout_mask), row_grads)[0]

    def encode(self, source_token_indices, path_indices,
               target_token_indices, context_valid_mask,
               deterministic: bool = True, dropout_seed: int = 0,
               dropout_step: int = 0,
               dropout_mask: Optional[torch.Tensor] = None,
               row_grads: Optional[RowGrads] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Code vectors (B, code_dim) f32 + attention weights (B, M)."""
        transformed = self.transform_contexts(
            source_token_indices, path_indices, target_token_indices,
            deterministic, dropout_seed, dropout_step, dropout_mask,
            row_grads)
        code_vectors, attention = _AttentionFn.apply(
            transformed, self.attention[:, 0], context_valid_mask)
        return code_vectors.float(), attention

    def logits_from_code_vectors(self, code_vectors: torch.Tensor
                                 ) -> torch.Tensor:
        """(B, target_vocab) f32; padded target rows get -inf. A plain
        product, as the reference leaves it to XLA."""
        cd = self.compute_dtype
        logits = matmul_f32(code_vectors.to(cd),
                            self.target_embedding.to(cd).T)
        if self.dims.has_padded_targets:
            col = torch.arange(self.dims.target_vocab_size,
                               device=logits.device)
            logits = torch.where(
                col[None, :] < self.dims.real_target_vocab_size, logits,
                torch.full_like(logits, float("-inf")))
        return logits

    def train_loss(self, code_vectors: torch.Tensor, labels: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
        """The reference's train loss (training/step.py:170-175): softmax
        cross-entropy of the logits against int32 `labels`, times `valid`
        (B,) f32, summed over the batch and divided by its size."""
        return _LogitsXentFn.apply(code_vectors, self.target_embedding,
                                   labels, valid, self.compute_dtype,
                                   self.dims.real_target_vocab_size)

    def forward(self, source_token_indices, path_indices,
                target_token_indices, context_valid_mask,
                deterministic: bool = True, dropout_seed: int = 0,
                dropout_step: int = 0,
                dropout_mask: Optional[torch.Tensor] = None):
        code_vectors, attention = self.encode(
            source_token_indices, path_indices, target_token_indices,
            context_valid_mask, deterministic, dropout_seed, dropout_step,
            dropout_mask)
        return (self.logits_from_code_vectors(code_vectors), code_vectors,
                attention)
