"""The single-device train steps: dense, and sparse (touched-rows Adam
for the token and path tables); and the eval step, which the release
runtime shares.

The counterpart of code2vec_tpu/training/step.py TrainStepBuilder with
mesh=None: `_make_gspmd_train_step` (:177-199) and
`_make_gspmd_sparse_train_step` (:198-269), with `_loss_from_logits`
(:170-175). Both run the forward with dropout keyed by (seed, step), the
softmax cross-entropy over the logits and the backward. The dense step
then runs Adam over every parameter (K8). The sparse step takes the
tables' gradients as rows (K5's row mode) and runs K8 over the dense
subtree only and K12 over each table's touched rows, with bias
correction from the global step. On CUDA tensors every stage runs a
hand-written kernel (K1, K2, K7, then K6, K5 and K8, and K12) or raises;
on CPU tensors their plain versions run. The tensor- and
context-parallel steps are not ported yet.

`make_eval_step` is the counterpart of `make_eval_step` (:487-560) with
the blockwise head, and the one body of both eval steps of the port: the
trainer's (the live f32 tables in the config's compute dtype) and a
release artifact's (its tables in their stored format,
release/runtime.py `make_release_step`): encode (K1, K2), the top-k and
logsumexp over the live target rows (K3) and each row's label logit
(K4), and the cross-entropy summed over rows with an in-vocabulary
label. On CUDA tensors it launches those kernels or raises.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from code2vec_tpu_torch.kernels.adam import AdamHyper, adam
from code2vec_tpu_torch.kernels.attention import masked_attention
from code2vec_tpu_torch.kernels.encoder import context_encoder
from code2vec_tpu_torch.kernels.label_logits import label_logits
from code2vec_tpu_torch.kernels.sparse_adam import sparse_adam_tables
from code2vec_tpu_torch.kernels.topk import blockwise_topk
from code2vec_tpu_torch.models.code2vec import Code2VecModule, RowGrads
from code2vec_tpu_torch.training.sparse_adam import HybridOptState
from code2vec_tpu_torch.training.state import (
    SPARSE_PARAM_NAMES, TrainState, uses_sparse_update,
)

# the reference keys dropout with jax.random.key(config.seed + 2)
# (training/state.py dropout_rng)
DROPOUT_SEED_SALT = 2


def dropout_seed(config) -> int:
    return int(config.seed) + DROPOUT_SEED_SALT


class EvalOutputs(NamedTuple):
    topk_values: torch.Tensor    # (B, k) f32
    topk_indices: torch.Tensor   # (B, k) int32
    code_vectors: torch.Tensor   # (B, D) f32
    attention: torch.Tensor      # (B, M) f32
    loss_sum: torch.Tensor       # () f32, CE summed over valid rows


def make_eval_step(*, real_target_vocab_size: int, target_oov_floor: int,
                   compute_dtype: torch.dtype, topk: int, block_size: int,
                   quantized: bool = False, mips_topk=None) -> Callable:
    """(params, src, pth, tgt, mask, labels, valid) -> EvalOutputs.

    `params` holds the Flax names; with `quantized`, also
    `<table>_scale` for each table. Each table's format is its tensor's
    dtype. k is clamped to the live target rows; `block_size` <= 0 is
    one block of the whole table. `mips_topk` (a `MipsHead.topk_fn`
    closure) replaces the exact head (K3, K4) with the approximate-MIPS
    search; such steps report loss_sum 0 (no logsumexp exists over a
    candidate subset)."""
    real_v = int(real_target_vocab_size)
    k = min(int(topk), real_v)

    def scale(params, name):
        return params[f"{name}_scale"] if quantized else None

    def step(params, src, pth, tgt, mask, labels, valid) -> EvalOutputs:
        transformed = context_encoder(
            params["token_embedding"], scale(params, "token_embedding"),
            params["path_embedding"], scale(params, "path_embedding"),
            params["transform"], src, pth, tgt, compute_dtype=compute_dtype)
        code_vectors, attention = masked_attention(
            transformed, params["attention"][:, 0], mask)
        if mips_topk is not None:
            values, indices = mips_topk(code_vectors)
            return EvalOutputs(values, indices, code_vectors, attention,
                               torch.zeros((), dtype=torch.float32,
                                           device=code_vectors.device))
        target, target_s = (params["target_embedding"],
                            scale(params, "target_embedding"))
        block = block_size if block_size > 0 else target.shape[0]
        out = blockwise_topk(code_vectors, target, k, block, scales=target_s,
                             valid_rows=real_v, compute_dtype=compute_dtype)
        label_logit = label_logits(code_vectors, target, labels,
                                   scales=target_s,
                                   compute_dtype=compute_dtype)
        loss_rows = valid & (labels > target_oov_floor)
        ce = (out.lse - label_logit) * loss_rows.float()
        return EvalOutputs(out.values, out.indices, code_vectors, attention,
                           ce.sum())

    return step


class TrainStepBuilder:
    """Builds the train step for a module + optimizer on one device."""

    def __init__(self, module: Code2VecModule, optimizer: AdamHyper,
                 config):
        self.module = module
        self.optimizer = optimizer
        self.config = config

    def make_train_step(self, example_state: TrainState) -> Callable:
        """(state, src, pth, tgt, mask, labels, valid, dropout_seed,
        dropout_mask=None) -> (state, loss). The state is updated in place
        and returned; `dropout_mask` (B, M, 3d) bool replaces the drawn
        mask (tests). The state's optimizer state says which step: a
        HybridOptState the sparse one, which the config must ask for."""
        if set(example_state.params) != set(
                dict(self.module.named_parameters())):
            raise ValueError("the state's parameters are not the module's")
        sparse = isinstance(example_state.opt_state, HybridOptState)
        if sparse != uses_sparse_update(self.config):
            raise ValueError(
                f"TrainState opt_state is {'sparse' if sparse else 'dense'} "
                f"but config.use_sparse_embedding_update="
                f"{uses_sparse_update(self.config)}; pass the same config "
                f"to create_train_state and TrainStepBuilder.")
        if sparse:
            return self._make_sparse_train_step()
        module, hyper = self.module, self.optimizer

        def train_step(state: TrainState, src, pth, tgt, mask, labels,
                       valid, seed: int,
                       dropout_mask: Optional[torch.Tensor] = None
                       ) -> Tuple[TrainState, torch.Tensor]:
            names = list(state.params)
            params = [state.params[n] for n in names]
            for p in params:
                p.grad = None
            code_vectors, _ = module.encode(
                src, pth, tgt, mask, deterministic=False, dropout_seed=seed,
                dropout_step=state.step, dropout_mask=dropout_mask)
            loss = module.train_loss(code_vectors, labels, valid.float())
            loss.backward()
            count = state.opt_state.count + 1
            with torch.no_grad():
                adam(params, [p.grad for p in params],
                     [state.opt_state.mu[n] for n in names],
                     [state.opt_state.nu[n] for n in names], count, hyper)
            for p in params:
                p.grad = None
            state.opt_state.count = count
            state.step += 1
            return state, loss.detach()

        return train_step

    def make_eval_step(self, k: Optional[int] = None) -> Callable:
        """The eval step over the module's live f32 parameters in its
        compute dtype: top-k with k from the config (clamped to the
        vocabulary, reference: tensorflow_model.py:298-299)."""
        dims = self.module.dims
        return make_eval_step(
            real_target_vocab_size=dims.real_target_vocab_size,
            target_oov_floor=dims.target_oov_floor,
            compute_dtype=self.module.compute_dtype,
            topk=k or self.config.top_k_words_considered_during_prediction,
            block_size=int(self.config.topk_block_size))

    def _adam_kwargs(self) -> dict:
        """K12's hyper-parameters: those of the dense subtree's Adam, so
        the two updates agree on the rows they both could touch."""
        cfg = self.config
        return dict(lr=cfg.learning_rate, b1=cfg.adam_beta1,
                    b2=cfg.adam_beta2, eps=cfg.adam_eps)

    def _make_sparse_train_step(self) -> Callable:
        module, hyper = self.module, self.optimizer
        row_adam = self._adam_kwargs()

        def train_step(state: TrainState, src, pth, tgt, mask, labels,
                       valid, seed: int,
                       dropout_mask: Optional[torch.Tensor] = None
                       ) -> Tuple[TrainState, torch.Tensor]:
            names = [n for n in state.params if n not in SPARSE_PARAM_NAMES]
            params = [state.params[n] for n in names]
            for p in params:
                p.grad = None
            rows = RowGrads()
            code_vectors, _ = module.encode(
                src, pth, tgt, mask, deterministic=False, dropout_seed=seed,
                dropout_step=state.step, dropout_mask=dropout_mask,
                row_grads=rows)
            loss = module.train_loss(code_vectors, labels, valid.float())
            loss.backward()
            dense = state.opt_state.dense
            count = dense.count + 1
            t = state.step + 1   # bias correction from the global step
            slots = state.opt_state.slots
            tok = state.params["token_embedding"]
            path = state.params["path_embedding"]
            with torch.no_grad():
                adam(params, [p.grad for p in params],
                     [dense.mu[n] for n in names],
                     [dense.nu[n] for n in names], count, hyper)
                # the source positions first, then the targets: the
                # reference's concat of the token ids; both tables in one
                # launch sequence where their widths agree
                sparse_adam_tables(
                    [(tok, slots["token_embedding"],
                      torch.cat([src.reshape(-1), tgt.reshape(-1)]),
                      rows.tok.reshape(-1, tok.shape[1])),
                     (path, slots["path_embedding"], pth.reshape(-1),
                      rows.path.reshape(-1, path.shape[1]))],
                    t=t, **row_adam)
            for p in params:
                p.grad = None
            dense.count = count
            state.step = t
            return state, loss.detach()

        return train_step
