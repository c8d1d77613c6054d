"""Carry weights and optimizer state across frameworks as numpy arrays.

Parameter names and shapes are the Flax tree's (code2vec_tpu/models/
code2vec.py:110-126), so nothing is transposed.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

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


def release_params_from_artifact(artifact, device, skip: Tuple[str, ...] = ()
                                 ) -> Dict[str, torch.Tensor]:
    """Device tensors of a loaded release artifact (release/artifact.py):
    the tables in their stored dtype (int8 or f32), `<table>_scale` f32
    (V, 1) for a quantized scheme, and the dense f32 params; names that
    start with an entry of `skip` stay on the host."""
    device = torch.device(device)
    params = {}
    for name, arr in artifact.tables.items():
        if name.startswith(tuple(skip)):
            continue
        t = torch.from_numpy(np.array(arr))  # copies the mmap
        params[name.replace(".scale", "_scale")] = t.to(device)
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


def opt_state_from_jax(opt_state):
    """optax's ScaleByAdamState (alone or inside a chain, with numpy or
    device arrays) -> training.state.AdamState. Each moment keeps its
    storage dtype (bf16 or f32)."""
    from code2vec_tpu_torch.training.state import AdamState
    leaf = _adam_leaf(opt_state)
    if leaf is None:
        raise KeyError("optimizer state holds no (count, mu, nu) state")

    def tensors(tree):
        out = {}
        for k in PARAM_NAMES:
            a = np.asarray(tree[k])
            dtype = torch.bfloat16 if a.dtype.name == "bfloat16" \
                else torch.float32
            # widened losslessly to f32 for numpy, then narrowed back
            out[k] = torch.from_numpy(a.astype(np.float32)).to(dtype)
        return out

    return AdamState(count=int(np.asarray(leaf.count)), mu=tensors(leaf.mu),
                     nu=tensors(leaf.nu))
