"""The two collectives of the parallel steps over one group of the
mesh: all-reduce SUM and all-gather along dim 0.

A `Communicator` of one rank does nothing (its all-gather returns its
input), so a step written for the mesh runs unchanged where an axis has
size 1. The backend follows the device: `nccl` for CUDA tensors, one
rank a card; `gloo` for CPU tensors, and for CUDA tensors where ranks
share a card (`--dist_backend gloo`: NCCL refuses two ranks on one
device). Gloo takes both on CUDA tensors (it copies them through
the host itself, torch 2.11); a version that refused one would raise
here, since nothing stages a collective by another route.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _run(op: str, t: torch.Tensor, group, backend: str) -> torch.Tensor:
    """One collective on `t` (the all-gather's result is new). Gloo
    gathers into a list (its oldest form, on every version)."""
    if op == "all_gather":
        n = dist.get_world_size(group)
        t = t.contiguous()
        if backend == "nccl":
            out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]),
                              dtype=t.dtype, device=t.device)
            dist.all_gather_into_tensor(out, t, group=group)
            return out
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class Communicator:
    """The collectives over one process group (`group` None and size 1:
    none). `index` is this rank's place in the group (along an axis, its
    coordinate: a row shard's number), `backend` the group's: "nccl" or
    "gloo"."""

    def __init__(self, group=None, size: int = 1, index: int = 0,
                 backend: str = "gloo"):
        self.group = group
        self.size = int(size)
        self.index = int(index)
        self.backend = backend

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` in place over the group; returns it."""
        if self.size == 1:
            return t
        return _run("all_reduce", t, self.group, self.backend)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The group's tensors stacked along dim 0, in group rank order:
        (size * n, ...) from (n, ...). Types other than f32 and int32 move
        as their bytes (a gather changes no bit)."""
        if self.size == 1:
            return t
        if t.dtype in (torch.float32, torch.int32):
            return _run("all_gather", t, self.group, self.backend)
        raw = t.contiguous().view(torch.uint8)
        return _run("all_gather", raw, self.group, self.backend).view(t.dtype)


LOCAL = Communicator()  # the group of one rank
