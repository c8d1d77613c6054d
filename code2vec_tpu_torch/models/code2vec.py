"""The code2vec model as an `nn.Module`, inference only.

The counterpart of code2vec_tpu/models/code2vec.py with deterministic=True:

  token/path embedding gathers -> concat (B, M, 3d) -> compute dtype
  -> tanh(. @ transform)                      kernel K1 (kernels/encoder.py)
  -> masked single-query attention -> code vector      K2
  -> logits = code_vector @ target_embedding.T

Parameters keep the Flax names and shapes (:110-126): `transform` is
(in, out) and `attention` is (D, 1), so a Flax param tree loads with no
transpose (weights.py). The kernels have no backward yet, so the module
computes no gradients; training comes with the next slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from code2vec_tpu_torch.kernels.attention import masked_attention
from code2vec_tpu_torch.kernels.encoder import context_encoder


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


def _uniform(shape, limit, generator, device):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return t.uniform_(-limit, limit, generator=generator)


class Code2VecModule(nn.Module):
    """Initialised as the reference: embeddings variance_scaling(1.0,
    fan_out, uniform), transform and attention glorot_uniform."""

    def __init__(self, dims: ModelDims,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device: Optional[torch.device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dims = dims
        self.compute_dtype = compute_dtype
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

    def transform_contexts(self, source_token_indices: torch.Tensor,
                           path_indices: torch.Tensor,
                           target_token_indices: torch.Tensor
                           ) -> torch.Tensor:
        """(B, M) ids -> (B, M, code_dim) in the compute dtype."""
        return context_encoder(
            self.token_embedding, None, self.path_embedding, None,
            self.transform, source_token_indices, path_indices,
            target_token_indices, compute_dtype=self.compute_dtype)

    def encode(self, source_token_indices, path_indices,
               target_token_indices, context_valid_mask
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Code vectors (B, code_dim) f32 + attention weights (B, M)."""
        transformed = self.transform_contexts(
            source_token_indices, path_indices, target_token_indices)
        code_vectors, attention = masked_attention(
            transformed, self.attention[:, 0], context_valid_mask)
        return code_vectors.float(), attention

    def logits_from_code_vectors(self, code_vectors: torch.Tensor
                                 ) -> torch.Tensor:
        """(B, target_vocab) f32; padded target rows get -inf. A plain
        product, as the reference leaves it to XLA."""
        cd = self.compute_dtype
        logits = (code_vectors.to(cd).float()
                  @ self.target_embedding.to(cd).float().T)
        if self.dims.has_padded_targets:
            col = torch.arange(self.dims.target_vocab_size,
                               device=logits.device)
            logits = torch.where(
                col[None, :] < self.dims.real_target_vocab_size, logits,
                torch.full_like(logits, float("-inf")))
        return logits

    def forward(self, source_token_indices, path_indices,
                target_token_indices, context_valid_mask):
        code_vectors, attention = self.encode(
            source_token_indices, path_indices, target_token_indices,
            context_valid_mask)
        return (self.logits_from_code_vectors(code_vectors), code_vectors,
                attention)
