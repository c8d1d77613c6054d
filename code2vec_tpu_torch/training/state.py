"""Training state: the parameters and Adam's state.

The counterpart of code2vec_tpu/training/state.py (TrainState :27,
SPARSE_PARAM_NAMES / split_sparse_dense / uses_sparse_update :37-48,
make_optimizer :99-115, create_train_state :139-173, num_params :176)
for one device. With `config.use_sparse_embedding_update` the optimizer
state is a HybridOptState: K8's AdamState over the dense subtree and
row slots for the token and path tables (training/sparse_adam.py). The
state is mutable: the train step updates the parameters and the moments
in place (kernels K8 and K12), where the reference returns a new pytree.
`sharded_train_state` is a mesh rank's state: its row shards of the
tables with their moments or row slots, the small leaves whole.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Union

import torch

from code2vec_tpu_torch.kernels.adam import AdamHyper
from code2vec_tpu_torch.models.code2vec import Code2VecModule
from code2vec_tpu_torch.training.sparse_adam import HybridOptState, init_slots

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
    opt_state: Union[AdamState, HybridOptState]


# The tables the sparse step updates by touched rows. target_embedding
# stays dense: its gradient flows through the full softmax, so every row
# is touched every step.
SPARSE_PARAM_NAMES = ("token_embedding", "path_embedding")


def split_sparse_dense(params):
    """Partition a param dict into (sparse tables, dense rest)."""
    sparse = {k: v for k, v in params.items() if k in SPARSE_PARAM_NAMES}
    dense = {k: v for k, v in params.items() if k not in SPARSE_PARAM_NAMES}
    return sparse, dense


def uses_sparse_update(config) -> bool:
    return bool(config is not None
                and getattr(config, "use_sparse_embedding_update", False))


def make_optimizer(config) -> AdamHyper:
    """Adam with the reference's defaults (lr 1e-3, b1 .9, b2 .999, eps
    1e-8) and moment storage dtypes; K8 picks the update rule of the
    branch make_optimizer would take (kernels/adam.py)."""
    return AdamHyper(learning_rate=config.learning_rate, b1=config.adam_beta1,
                     b2=config.adam_beta2, eps=config.adam_eps,
                     mu_dtype=DTYPES[config.adam_mu_dtype],
                     nu_dtype=DTYPES[config.adam_nu_dtype])


def _adam_state(optimizer: AdamHyper, params) -> AdamState:
    return AdamState(
        count=0,
        mu={k: torch.zeros_like(p, dtype=optimizer.mu_dtype,
                                requires_grad=False)
            for k, p in params.items()},
        nu={k: torch.zeros_like(p, dtype=optimizer.nu_dtype,
                                requires_grad=False)
            for k, p in params.items()})


def create_train_state(module: Code2VecModule, optimizer: AdamHyper,
                       config=None) -> TrainState:
    """The state of a fresh run over `module`'s (already initialised)
    parameters, which start requiring grad; zero moments, count 0. With
    `config.use_sparse_embedding_update`, `optimizer` covers the dense
    subtree, the token and path tables get row slots (mu in its storage
    dtype, nu in f32) and require no grad: their gradients stay rows."""
    module.requires_grad_(True)
    params = dict(module.named_parameters())
    if not uses_sparse_update(config):
        return TrainState(step=0, params=params,
                          opt_state=_adam_state(optimizer, params))
    tables, dense = split_sparse_dense(params)
    for p in tables.values():
        p.requires_grad_(False)
    return TrainState(step=0, params=params, opt_state=HybridOptState(
        dense=_adam_state(optimizer, dense),
        slots={k: init_slots(p.detach(), optimizer.mu_dtype)
               for k, p in tables.items()}))


def num_params(state: TrainState) -> int:
    return sum(p.numel() for p in state.params.values())


def sharded_train_state(params, optimizer: AdamHyper, config, mesh,
                        opt_state=None, step: int = 0) -> TrainState:
    """A mesh rank's state (the parallel steps', training/step.py
    ParallelStepBuilder): its part of the full parameters `params` (name
    -> tensor or numpy array, the tables padded to a multiple of tp,
    weights.shard_params) as plain tensors on its device, and of
    `opt_state` (an AdamState or HybridOptState over the full
    parameters) where given, else zero moments (row slots for the
    tables with config.use_sparse_embedding_update)."""
    from code2vec_tpu_torch.weights import shard_opt_state, shard_params
    dev = mesh.device
    shards = {k: v.to(dev) for k, v in shard_params(
        params, mesh.plan, mesh.index).items()}
    if opt_state is not None:
        opt = _to_device(shard_opt_state(opt_state, mesh.plan, mesh.index),
                         dev)
        return TrainState(step=step, params=shards, opt_state=opt)
    if not uses_sparse_update(config):
        return TrainState(step=step, params=shards,
                          opt_state=_adam_state(optimizer, shards))
    tables, dense = split_sparse_dense(shards)
    return TrainState(step=step, params=shards, opt_state=HybridOptState(
        dense=_adam_state(optimizer, dense),
        slots={k: init_slots(p, optimizer.mu_dtype)
               for k, p in tables.items()}))


def _to_device(opt_state, device):
    if isinstance(opt_state, HybridOptState):
        from code2vec_tpu_torch.training.sparse_adam import RowAdamSlots
        return HybridOptState(
            dense=_to_device(opt_state.dense, device),
            slots={k: RowAdamSlots(mu=s.mu.to(device), nu=s.nu.to(device))
                   for k, s in opt_state.slots.items()})
    return AdamState(count=opt_state.count,
                     mu={k: v.to(device) for k, v in opt_state.mu.items()},
                     nu={k: v.to(device) for k, v in opt_state.nu.items()})
