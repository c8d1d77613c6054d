"""Training state: the parameters and Adam's state.

The counterpart of code2vec_tpu/training/state.py (TrainState :27,
make_optimizer :99-115, create_train_state :139, num_params :176) for
one device with the dense update. The state is mutable: the train step
updates the parameters and both moments in place (kernel K8), where the
reference returns a new pytree.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from code2vec_tpu_torch.kernels.adam import AdamHyper
from code2vec_tpu_torch.models.code2vec import Code2VecModule

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass
class AdamState:
    """optax's ScaleByAdamState: the update count and the moments, each in
    its storage dtype, keyed by parameter name."""
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, torch.nn.Parameter]  # the module's own parameters
    opt_state: AdamState


def make_optimizer(config) -> AdamHyper:
    """Adam with the reference's defaults (lr 1e-3, b1 .9, b2 .999, eps
    1e-8) and moment storage dtypes; K8 picks the update rule of the
    branch make_optimizer would take (kernels/adam.py)."""
    return AdamHyper(learning_rate=config.learning_rate, b1=config.adam_beta1,
                     b2=config.adam_beta2, eps=config.adam_eps,
                     mu_dtype=DTYPES[config.adam_mu_dtype],
                     nu_dtype=DTYPES[config.adam_nu_dtype])


def create_train_state(module: Code2VecModule,
                       optimizer: AdamHyper) -> TrainState:
    """The state of a fresh run over `module`'s (already initialised)
    parameters, which start requiring grad; zero moments, count 0."""
    module.requires_grad_(True)
    params = dict(module.named_parameters())
    return TrainState(step=0, params=params, opt_state=AdamState(
        count=0,
        mu={k: torch.zeros_like(p, dtype=optimizer.mu_dtype,
                                requires_grad=False)
            for k, p in params.items()},
        nu={k: torch.zeros_like(p, dtype=optimizer.nu_dtype,
                                requires_grad=False)
            for k, p in params.items()}))


def num_params(state: TrainState) -> int:
    return sum(p.numel() for p in state.params.values())
