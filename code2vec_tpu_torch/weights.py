"""Carry weights and optimizer state across frameworks as numpy arrays,
and cut them into the parts the ranks of a mesh hold.

Parameter names and shapes are the Flax tree's (code2vec_tpu/models/
code2vec.py:110-126), so nothing is transposed. On a dp x tp x cp mesh
(parallel/mesh.py) the three tables are row-split over `model` and the
other leaves replicated: `shard_params` / `shard_opt_state` cut a full
tree (the JAX package's numpy parameters, or the port's) into a rank's
part, and `unshard_params` joins the model ranks' parts again.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from code2vec_tpu_torch.release.artifact import FP8_TABLE_DTYPES

PARAM_NAMES = ("token_embedding", "path_embedding", "target_embedding",
               "transform", "attention")


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A Flax param dict (name -> array) -> a state dict for
    `Code2VecModule`."""
    missing = [k for k in PARAM_NAMES if k not in tree]
    if missing:
        raise KeyError(f"param tree lacks {missing}")
    return {k: torch.from_numpy(np.array(tree[k], dtype=np.float32))
            for k in PARAM_NAMES}


def table_tensor(artifact, name: str) -> torch.Tensor:
    """One table of a loaded release artifact as a host tensor whose dtype
    names its format: int8, f32, an fp8 payload as a zero-copy view of its
    uint8 bytes as torch.float8_e4m3fn / torch.float8_e5m2, packed int4 as
    uint8; scales and dense params f32."""
    t = torch.from_numpy(np.array(artifact.tables[name]))  # copies the mmap
    fp8 = FP8_TABLE_DTYPES.get(artifact.scheme)
    if fp8 is not None and not name.endswith(".scale") \
            and t.dtype == torch.uint8:
        t = t.view(fp8)
    return t


def release_params_from_artifact(artifact, device, skip: Tuple[str, ...] = ()
                                 ) -> Dict[str, torch.Tensor]:
    """Device tensors of a loaded release artifact (release/artifact.py):
    the tables in the dtype that names their format (`table_tensor`),
    `<table>_scale` f32 (V, 1) for a quantized scheme, and the dense f32
    params; names that start with an entry of `skip` stay on the host."""
    device = torch.device(device)
    params = {}
    for name in artifact.tables:
        if name.startswith(tuple(skip)):
            continue
        params[name.replace(".scale", "_scale")] = table_tensor(
            artifact, name).to(device)
    return params


def _adam_leaf(opt_state):
    """The (count, mu, nu) state inside an optax state: a chain is a tuple
    of states, of which the adam one has all three fields."""
    if all(hasattr(opt_state, f) for f in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _adam_leaf(s)
            if found is not None:
                return found
    return None


def _tensor(a) -> torch.Tensor:
    """An array (numpy or device, bf16 or f32) -> a tensor of its dtype."""
    a = np.asarray(a)
    dtype = torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32
    # widened losslessly to f32 for numpy, then narrowed back
    return torch.from_numpy(a.astype(np.float32)).to(dtype)


def opt_state_from_jax(opt_state):
    """optax's ScaleByAdamState (alone or inside a chain, with numpy or
    device arrays) -> training.state.AdamState over the parameters it
    holds; a sparse step's HybridOptState (the dense subtree's optax
    state and the tables' `slots[name].mu/.nu`) ->
    training.sparse_adam.HybridOptState. Each moment keeps its storage
    dtype (bf16 or f32)."""
    from code2vec_tpu_torch.training.sparse_adam import (
        HybridOptState, RowAdamSlots,
    )
    from code2vec_tpu_torch.training.state import AdamState
    if hasattr(opt_state, "dense") and hasattr(opt_state, "slots"):
        return HybridOptState(
            dense=opt_state_from_jax(opt_state.dense),
            slots={k: RowAdamSlots(mu=_tensor(s.mu), nu=_tensor(s.nu))
                   for k, s in opt_state.slots.items()})
    leaf = _adam_leaf(opt_state)
    if leaf is None:
        raise KeyError("optimizer state holds no (count, mu, nu) state")

    def tensors(tree):
        unknown = [k for k in tree if k not in PARAM_NAMES]
        if unknown:
            raise KeyError(f"optimizer state names unknown parameters "
                           f"{unknown}")
        return {k: _tensor(tree[k]) for k in PARAM_NAMES if k in tree}

    return AdamState(count=int(np.asarray(leaf.count)), mu=tensors(leaf.mu),
                     nu=tensors(leaf.nu))


# the leaves a mesh row-splits over `model` (parallel/mesh.py PARAM_SPECS)
SHARDED_NAMES = ("token_embedding", "path_embedding", "target_embedding")


def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else _tensor(a)


def shard_params(tree: Mapping, plan, rank: int) -> Dict[str, torch.Tensor]:
    """The part of a full parameter tree (name -> numpy array or tensor,
    tables padded to a multiple of the plan's tp) that mesh rank `rank`
    holds: the row shard of its model coordinate of each table, the
    other leaves whole; each a contiguous copy in its own dtype."""
    from code2vec_tpu_torch.parallel.mesh import AXIS_MODEL, shard_slice
    m = plan.coords(rank)[AXIS_MODEL]
    out = {}
    for name, a in tree.items():
        t = _as_tensor(a)
        if name in SHARDED_NAMES:
            t = t[shard_slice(t.shape[0], plan.tp, m)]
        out[name] = t.contiguous().clone()
    return out


def unshard_params(shards: Sequence[Mapping], plan) -> Dict[str, torch.Tensor]:
    """The full tree from the parts of the ranks of model coordinates
    0 .. tp-1 (in that order): the tables' row shards joined, the other
    leaves from the first."""
    if len(shards) != plan.tp:
        raise ValueError(f"{len(shards)} parts for tp={plan.tp}")
    return {name: (torch.cat([_as_tensor(s[name]) for s in shards])
                   if name in SHARDED_NAMES else _as_tensor(shards[0][name]))
            for name in shards[0]}


def shard_opt_state(opt_state, plan, rank: int):
    """An optimizer state over full parameters (training.state.AdamState,
    or the sparse step's HybridOptState) as mesh rank `rank` holds it:
    the tables' moments (and row slots) row-split as shard_params splits
    the tables."""
    from code2vec_tpu_torch.training.sparse_adam import (
        HybridOptState, RowAdamSlots,
    )
    from code2vec_tpu_torch.training.state import AdamState
    if isinstance(opt_state, HybridOptState):
        return HybridOptState(
            dense=shard_opt_state(opt_state.dense, plan, rank),
            slots={k: RowAdamSlots(mu=_row_shard(s.mu, plan, rank),
                                   nu=_row_shard(s.nu, plan, rank))
                   for k, s in opt_state.slots.items()})
    return AdamState(count=opt_state.count,
                     mu=shard_params(opt_state.mu, plan, rank),
                     nu=shard_params(opt_state.nu, plan, rank))


def _row_shard(t: torch.Tensor, plan, rank: int) -> torch.Tensor:
    from code2vec_tpu_torch.parallel.mesh import AXIS_MODEL, shard_slice
    m = plan.coords(rank)[AXIS_MODEL]
    return t[shard_slice(t.shape[0], plan.tp, m)].contiguous().clone()
