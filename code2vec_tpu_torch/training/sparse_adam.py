"""Touched-rows (lazy) Adam for the token and path tables.

The counterpart of code2vec_tpu/training/sparse_adam.py. The sparse
train step (training/step.py) takes the gradients of the two embedding
tables as rows, one per gathered position (B*M, d), never as (V, d)
tables; duplicate ids are summed (Adam is nonlinear in the gradient),
and only the rows a batch touches are updated:

  mu' = b1 mu + (1 - b1) g;  nu' = b2 nu + (1 - b2) g^2
  p'  = p + (-lr mu'/(1 - b1^t)) / (sqrt(nu'/(1 - b2^t)) + eps)

with t the global step (1-based). Untouched rows keep every bit of the
table, mu and nu (lazy Adam: their moments do not decay). Ids outside
the table are read clamped and written nowhere (the reference's
mode="clip" reads and mode="drop" scatters).

The functions below are the plain versions, on tensors; kernel K12
(kernels/sparse_adam.py) computes the same on the card. They keep the
reference's rounding points: the table gets `table + f32(delta)`, nu gets
`nu + (new_nu - nu)` in f32, and a bf16 mu gets `mu + bf16(bf16(new_mu)
- mu)`, so the stored mu equals the dense optimizer's `bf16(new_mu)`
(code2vec_tpu/training/sparse_adam.py:113-126). The port updates the
state in place where the reference returns new arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from code2vec_tpu_torch.kernels.adam import AdamHyper


@dataclasses.dataclass
class RowAdamSlots:
    """Adam moments of one embedding table (its shape): mu in the
    configured storage dtype, nu in f32."""
    mu: torch.Tensor
    nu: torch.Tensor


@dataclasses.dataclass
class HybridOptState:
    """Optimizer state of the sparse step: K8's AdamState over the dense
    subtree (target, transform, attention) plus row slots for the two
    tables."""
    dense: "AdamState"  # noqa: F821 (training.state.AdamState)
    slots: Dict[str, RowAdamSlots]


def init_slots(table: torch.Tensor,
               mu_dtype: torch.dtype = torch.float32) -> RowAdamSlots:
    return RowAdamSlots(mu=torch.zeros_like(table, dtype=mu_dtype),
                        nu=torch.zeros_like(table, dtype=torch.float32))


def combine_duplicate_rows(ids: torch.Tensor, grads: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Sort ids (stably) and sum the gradient rows of duplicates, in
    position order and in f32, onto the first occurrence. Returns
    (ids_sorted, summed rows, is_representative): every other position
    carries a row of exact zeros."""
    ids = ids.reshape(-1)
    n = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    ids_s = ids[order]
    g_s = grads.reshape(n, -1)[order].float()
    first = torch.ones(n, dtype=torch.bool, device=ids.device)
    first[1:] = ids_s[1:] != ids_s[:-1]
    seg = torch.cumsum(first.long(), 0) - 1
    g_sum = torch.zeros_like(g_s).index_add_(0, seg, g_s)
    g_u = torch.where(first[:, None], g_sum[seg], torch.zeros_like(g_s))
    return ids_s, g_u, first


def sparse_adam_rows(table: torch.Tensor, slots: RowAdamSlots,
                     ids: torch.Tensor, grads: torch.Tensor, *, t: int,
                     lr: float, b1: float, b2: float, eps: float) -> None:
    """Lazy-Adam-update, in place, the rows of `table` (V, d) f32 and of
    its slots named by `ids` (duplicates allowed) with the gradient rows
    `grads` (len(ids), d); `t` is the 1-based global step."""
    v = table.shape[0]
    ids_s, g_u, first = combine_duplicate_rows(ids.long(), grads)
    keep = first & (ids_s >= 0) & (ids_s < v)   # writes drop the rest
    uid, g = ids_s[keep], g_u[keep]
    # K8's f32 constants; the bias corrections from the global step
    c = AdamHyper(learning_rate=lr, b1=b1, b2=b2, eps=eps).scalars(t)
    mu_rows = slots.mu[uid].float()
    nu_rows = slots.nu[uid]
    new_mu = c["b1"] * mu_rows + c["one_minus_b1"] * g
    new_nu = c["b2"] * nu_rows + c["one_minus_b2"] * (g * g)
    mu_hat = new_mu / c["b1c"]
    nu_hat = new_nu / c["b2c"]
    delta = (c["neg_lr"] * mu_hat) / (torch.sqrt(nu_hat) + c["eps"])
    table[uid] = table[uid] + delta
    mu_dtype = slots.mu.dtype
    mu_step = (new_mu.to(mu_dtype).float() - mu_rows).to(mu_dtype).float()
    slots.mu[uid] = (mu_rows + mu_step).to(mu_dtype)
    slots.nu[uid] = nu_rows + (new_nu - nu_rows)
