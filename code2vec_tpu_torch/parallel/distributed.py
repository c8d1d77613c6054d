"""The process runtime of a run on a mesh: joining it, this process's
place in it, and the host-side reductions the evaluator and the loop
need.

The counterpart of the parts of code2vec_tpu/parallel/distributed.py
(:71-260) that a run on one host needs. A process is one rank of the
mesh (the reference's processes are hosts, each with several devices).
`initialize` joins the runtime from `torchrun`'s environment (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/MASTER_PORT: `env://`) or from an
explicit rendezvous (`file://PATH` or `tcp://HOST:PORT` with the rank and
world size), with a timeout. The default process group is always gloo:
`allreduce_host_scalars` and `agree_scalar` reduce CPU tensors over it
(NCCL reduces no CPU tensor), and the mesh's device groups, NCCL or
gloo, are made beside it (mesh.make_mesh).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the runtime; returns whether this is a run of several
    processes. Without an init method it reads torchrun's environment;
    with neither (one process) it does nothing. Idempotent."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env_world = os.environ.get("WORLD_SIZE")
    if world_size is None and env_world is not None:
        world_size = int(env_world)
    if rank is None and os.environ.get("RANK") is not None:
        rank = int(os.environ["RANK"])
    if init_method is None:
        if not world_size or world_size == 1:
            return False
        init_method = "env://"
    if world_size is None or rank is None:
        raise ValueError(f"rendezvous {init_method} needs the world size "
                         f"and this process's rank (WORLD_SIZE, RANK)")
    dist.init_process_group(
        "gloo", init_method=init_method, world_size=int(world_size),
        rank=int(rank), timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_world_size() > 1


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank() -> int:
    """This process's index among those of its host (torchrun's
    LOCAL_RANK; 0 alone): the card it takes unless --device pins one."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def local_batch_size(global_batch_size: int, dp: int) -> int:
    """The rows each data rank takes of a global batch."""
    if global_batch_size % dp:
        raise ValueError(f"global batch size {global_batch_size} is not "
                         f"divisible by the data-parallel degree dp={dp}")
    return global_batch_size // dp


def allreduce_host_scalars(values, group=None) -> np.ndarray:
    """Sum a small 1-D host array over the processes of `group` (default:
    all), exactly in float64: the evaluator's counters become global
    totals before any ratio is taken. One process: the values."""
    values = np.ascontiguousarray(np.asarray(values, dtype=np.float64))
    if not dist.is_initialized():
        return values
    t = torch.from_numpy(values.copy())
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t.numpy()


def agree_scalar(value: int, reduce: str = "min", group=None) -> int:
    """Every process of `group` gets the min (or max) of their integers:
    the loop checks that all ranks ran the same number of steps."""
    if not dist.is_initialized():
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MIN if reduce == "min"
                    else dist.ReduceOp.MAX, group=group)
    return int(t.item())
