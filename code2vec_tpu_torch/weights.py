"""Carry weights across frameworks as numpy arrays.

Parameter names and shapes are the Flax tree's (code2vec_tpu/models/
code2vec.py:110-126), so nothing is transposed.
"""

from __future__ import annotations

from typing import Dict, Mapping

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


def release_params_from_artifact(artifact, device) -> Dict[str, torch.Tensor]:
    """Device tensors of a loaded release artifact (release/artifact.py):
    the tables in their stored dtype (int8 or f32), `<table>_scale` f32
    (V, 1) for a quantized scheme, and the dense f32 params."""
    device = torch.device(device)
    params = {}
    for name, arr in artifact.tables.items():
        t = torch.from_numpy(np.array(arr))  # copies the mmap
        params[name.replace(".scale", "_scale")] = t.to(device)
    return params
