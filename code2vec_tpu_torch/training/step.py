"""The dense single-device train step.

The counterpart of code2vec_tpu/training/step.py TrainStepBuilder with
mesh=None (`_make_gspmd_train_step` :177-199 and `_loss_from_logits`
:170-175): forward with dropout keyed by (seed, step), the softmax
cross-entropy over the logits, backward, and Adam over every parameter.
On CUDA tensors every stage runs a hand-written kernel (K1, K2, K7, then
K6, K5 and K8) or raises; on CPU tensors their plain versions run. The
sparse, tensor- and context-parallel steps are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from code2vec_tpu_torch.kernels.adam import AdamHyper, adam
from code2vec_tpu_torch.models.code2vec import Code2VecModule
from code2vec_tpu_torch.training.state import TrainState

# the reference keys dropout with jax.random.key(config.seed + 2)
# (training/state.py dropout_rng)
DROPOUT_SEED_SALT = 2


def dropout_seed(config) -> int:
    return int(config.seed) + DROPOUT_SEED_SALT


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
        mask (tests)."""
        if set(example_state.params) != set(
                dict(self.module.named_parameters())):
            raise ValueError("the state's parameters are not the module's")
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
