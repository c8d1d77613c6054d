"""The dp x tp x cp mesh of the parallel steps, over torch.distributed.

The counterpart of code2vec_tpu/parallel/mesh.py (:1-143). Three axes,
`data` outermost as the reference orders them:

  - `data`:  the batch's rows (data parallelism);
  - `model`: the rows of the three embedding tables, and so the target
             classifier's columns (tensor parallelism);
  - `ctx`:   the MAX_CONTEXTS axis (context parallelism).

A rank's coordinates follow from its place in the mesh's rank list,
`(d * tp + m) * cp + c`. `make_mesh` builds the process groups the steps
reduce over: one per axis and one over `data` and `ctx` together (the
sparse step gathers its rows over both, in data-major order, as the
reference's tiled all_gather over (data, ctx) does). It builds them with
`new_group` rather than `init_device_mesh`, which makes one group per
axis only and ties a mesh to one device per rank: ranks that share a
card under gloo are a mesh here too. PARAM_SPECS and BATCH_SPECS are the
reference's partition specs as plain tuples (an axis name, or None for a
dimension that is not split).
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Dict, Optional, Sequence, Tuple

import torch

from code2vec_tpu_torch.parallel.comm import Communicator, LOCAL

AXIS_DATA = "data"
AXIS_MODEL = "model"
AXIS_CTX = "ctx"
MESH_AXES = (AXIS_DATA, AXIS_MODEL, AXIS_CTX)

# the partition of each parameter (code2vec_tpu/parallel/mesh.py
# PARAM_SPECS): the embedding tables row-split over `model`, the small
# dense parameters replicated
PARAM_SPECS = {
    "token_embedding": (AXIS_MODEL, None),
    "path_embedding": (AXIS_MODEL, None),
    "target_embedding": (AXIS_MODEL, None),
    "transform": (),
    "attention": (),
}
# the partition of each batch field (data.reader.RowBatch)
BATCH_SPECS = {
    "source_token_indices": (AXIS_DATA, AXIS_CTX),
    "path_indices": (AXIS_DATA, AXIS_CTX),
    "target_token_indices": (AXIS_DATA, AXIS_CTX),
    "context_valid_mask": (AXIS_DATA, AXIS_CTX),
    "target_index": (AXIS_DATA,),
    "example_valid": (AXIS_DATA,),
}
# the axis groups the steps use
GROUP_AXES = ((AXIS_DATA,), (AXIS_MODEL,), (AXIS_CTX,),
              (AXIS_DATA, AXIS_CTX))
DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    dp: int = 1
    tp: int = 1
    cp: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.tp * self.cp

    @classmethod
    def from_config(cls, config) -> "MeshPlan":
        return cls(dp=config.dp, tp=config.tp, cp=config.cp)

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "MeshPlan":
        """A plan from a `{"dp", "tp", "cp"}` record (missing axes 1)."""
        d = d or {}
        return cls(dp=int(d.get("dp", 1)), tp=int(d.get("tp", 1)),
                   cp=int(d.get("cp", 1)))

    def to_dict(self) -> dict:
        return {"dp": self.dp, "tp": self.tp, "cp": self.cp}

    def describe(self) -> str:
        return f"dp={self.dp} tp={self.tp} cp={self.cp}"

    def axis_size(self, axis: str) -> int:
        return {AXIS_DATA: self.dp, AXIS_MODEL: self.tp,
                AXIS_CTX: self.cp}[axis]

    def coords(self, index: int) -> Dict[str, int]:
        """The (data, model, ctx) coordinates of the index-th rank."""
        c = index % self.cp
        m = (index // self.cp) % self.tp
        d = index // (self.cp * self.tp)
        return {AXIS_DATA: d, AXIS_MODEL: m, AXIS_CTX: c}

    def groups(self, axes: Sequence[str]):
        """Every group of mesh indices that differ only along `axes`, each
        in ascending order (so along several axes in the mesh's order),
        the groups in ascending order of their first index."""
        out = {}
        for i in range(self.size):
            key = tuple(v for a, v in self.coords(i).items()
                        if a not in axes)
            out.setdefault(key, []).append(i)
        return sorted(out.values())


def replicated_axes_for_spec(spec: Tuple) -> Tuple[str, ...]:
    """The mesh axes over which a leaf with this spec is stored
    replicated (code2vec_tpu/parallel/mesh.py replicated_axes_for_spec)."""
    used = set()
    for part in spec:
        if part is None:
            continue
        used.update(part if isinstance(part, (tuple, list)) else (part,))
    return tuple(a for a in MESH_AXES if a not in used)


def shard_slice(rows: int, parts: int, index: int) -> slice:
    """The rows of the index-th of `parts` equal row shards."""
    if rows % parts:
        raise ValueError(f"{rows} rows do not split into {parts} equal "
                         f"shards; pad them first (ModelDims.padded_to)")
    n = rows // parts
    return slice(index * n, (index + 1) * n)


class Mesh:
    """One rank's view of the mesh: its plan, its coordinates, its
    device and the communicator of each axis group (`comm`)."""

    def __init__(self, plan: MeshPlan, index: int, device: torch.device,
                 backend: str, comms: Dict[Tuple[str, ...], Communicator],
                 host_group=None):
        self.plan = plan
        self.index = index
        self.device = torch.device(device)
        self.backend = backend
        self.coords = plan.coords(index)
        self._comms = comms
        # a gloo group over the mesh's ranks, for host-side scalars
        self.host_group = host_group

    def comm(self, *axes: str) -> Communicator:
        """The communicator over `axes` (in the mesh's order)."""
        key = tuple(a for a in MESH_AXES if a in axes)
        return self._comms.get(key, LOCAL)

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]


def local_mesh(device="cpu") -> Mesh:
    """The mesh of one rank (every communicator does nothing)."""
    return Mesh(MeshPlan(), 0, torch.device(device), "gloo", {})


def check_devices_distinct(members: Sequence[int], device: torch.device
                           ) -> None:
    """NCCL refuses two ranks on one device: every member posts its
    (host, device) over the default (gloo) group, and a repeat raises
    with the reason, before any NCCL group exists."""
    import socket

    import torch.distributed as dist
    mine = (socket.gethostname(), str(device))
    posted = [None] * dist.get_world_size()
    dist.all_gather_object(posted, mine)
    seen = {}
    for r in members:
        key = tuple(posted[r])
        if key in seen:
            raise ValueError(
                f"ranks {seen[key]} and {r} both run on {key[1]} of "
                f"{key[0]}: NCCL refuses two ranks on one device. Give "
                f"each rank its own card, or pass --dist_backend gloo so "
                f"that ranks share a card (collectives then pass through "
                f"the host)")
        seen[key] = r


def make_mesh(plan: MeshPlan, device=None, backend: Optional[str] = None,
              members: Optional[Sequence[int]] = None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Optional[Mesh]:
    """This rank's Mesh over `members` (default: every rank of the
    default process group, whose count must equal the plan's size).
    Every rank of the default group calls it, members or not (a group is
    made by all ranks together); it returns None to the others. The
    backend follows the device (nccl for CUDA, gloo for the CPU) unless
    given."""
    import torch.distributed as dist
    if not dist.is_initialized():
        if plan.size == 1:
            return local_mesh(device or "cpu")
        raise RuntimeError(f"a {plan.describe()} mesh needs "
                           f"torch.distributed (parallel/distributed.py "
                           f"initialize)")
    world = dist.get_world_size()
    members = list(range(world)) if members is None else list(members)
    if len(members) != plan.size:
        raise ValueError(
            f"the mesh plan {plan.describe()} has {plan.size} ranks but "
            f"{len(members)} processes run it; launch as many processes "
            f"as dp x tp x cp")
    rank = dist.get_rank()
    device = torch.device(device or "cpu")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        check_devices_distinct(members, device)
    timeout = datetime.timedelta(seconds=timeout_s)
    index = members.index(rank) if rank in members else None
    groups = {}
    for axes in GROUP_AXES:
        size = 1
        for a in axes:
            size *= plan.axis_size(a)
        if size == 1:
            continue
        for group in plan.groups(axes):
            pg = dist.new_group([members[i] for i in group], timeout=timeout,
                                backend=backend)
            if index in group:
                groups[axes] = (pg, size, group.index(index))
    host = dist.new_group(members, timeout=timeout, backend="gloo")
    if index is None:
        return None
    comms = {axes: Communicator(pg, size, i, backend)
             for axes, (pg, size, i) in groups.items()}
    return Mesh(plan, index, device, backend, comms, host_group=host)


def batch_slice(batch, mesh: Mesh):
    """A rank's part of a host batch (data.reader.RowBatch, or any
    dataclass of its fields): its data rank's rows of every field, and
    its ctx rank's columns of the (B, M) ones (BATCH_SPECS; the string
    arrays alike), the method names' rows too. Every rank reads the same
    global batch and keeps its part."""
    plan, c = mesh.plan, mesh.coords
    if plan.dp == 1 and plan.cp == 1:
        return batch
    rows = shard_slice(batch.target_index.shape[0], plan.dp, c[AXIS_DATA])
    cols = shard_slice(batch.source_token_indices.shape[1], plan.cp,
                       c[AXIS_CTX])

    def part(x):
        if x is None:
            return None
        x = x[rows]
        return x[:, cols] if getattr(x, "ndim", 1) == 2 else x

    return dataclasses.replace(batch, **{
        f.name: part(getattr(batch, f.name))
        for f in dataclasses.fields(batch)})
