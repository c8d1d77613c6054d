"""K12 sparse_adam: duplicate combining and touched-rows (lazy) Adam for
one embedding table, in place.

Replaces code2vec_tpu/training/sparse_adam.py `combine_duplicate_rows`
(:64-83) and `sparse_adam_rows` (:86-130). The CUDA source is
csrc/sparse_adam.cu; its header gives the update's rounding points, what
bounds it on an H100 and how its design answers that (a stable radix
sort of the ids, then one warp per 64 sorted positions summing rows in
order). The plain version is training/sparse_adam.py `sparse_adam_rows`,
the reference's chain on tensors (a stable argsort, a segment sum, the
update of the representatives): CPU tensors take it, CUDA tensors launch
the kernel. Both update the table and its slots in place.
"""

from __future__ import annotations

import torch

from code2vec_tpu_torch.kernels import launch
from code2vec_tpu_torch.kernels.adam import AdamHyper
from code2vec_tpu_torch.training.sparse_adam import (
    RowAdamSlots, sparse_adam_rows,
)

launches = 0
_fns = {}
MAX_D = 512

sparse_adam_plain = sparse_adam_rows


def _fn():
    fn = _fns.get("sparse_adam")
    if fn is None:
        P, I32, I64, F32 = launch.P, launch.I32, launch.I64, launch.F32
        fn = _fns["sparse_adam"] = launch.bind(
            "sparse_adam", "c2v_sparse_adam",
            [P, P, I32, P, I32, I32, P, P, I64] + [F32] * 8 + [P, P])
        _fns["scratch"] = launch.bind(
            "sparse_adam", "c2v_sparse_adam_scratch_bytes", [I64, I32],
            restype=I64)
    return fn


def sparse_adam(table: torch.Tensor, slots: RowAdamSlots, ids: torch.Tensor,
                grads: torch.Tensor, *, t: int, lr: float, b1: float,
                b2: float, eps: float) -> None:
    """Lazy Adam, in place, over the rows of `table` (V, d) f32 and its
    slots named by `ids` (n,) int32, with gradient rows `grads` (n, d)
    (bf16 for the kernel); `t` is the 1-based global step."""
    args = (table, slots.mu, slots.nu, ids, grads)
    if launch.runs_plain(*args):
        return sparse_adam_plain(table, slots, ids, grads, t=t, lr=lr,
                                 b1=b1, b2=b2, eps=eps)
    fn = _fn()  # builds the library first: raises where nvcc is missing
    launch.check_tensor(table, "table", [torch.float32], 2, align=16)
    v, d = table.shape
    launch.require(d % 128 == 0 and d <= MAX_D,
                   f"width {d}: the kernel takes multiples of 128 up to "
                   f"{MAX_D}")
    launch.check_tensor(slots.mu, "mu", [torch.bfloat16, torch.float32], 2,
                        align=16)
    launch.check_tensor(slots.nu, "nu", [torch.float32], 2, align=16)
    launch.require(slots.mu.shape == table.shape == slots.nu.shape,
                   "table, mu and nu differ in shape")
    launch.check_tensor(ids, "ids", [torch.int32], 1)
    n = ids.shape[0]
    launch.check_tensor(grads, "grads", [torch.bfloat16], 2, align=16)
    launch.require(tuple(grads.shape) == (n, d), f"grads: expected ({n}, "
                                                 f"{d})")
    launch.require(v < 2 ** 31 - 1 and n < 2 ** 31 - 1,
                   "more than 2^31 rows or ids")
    device = table.device
    scratch = torch.empty(max(int(_fns["scratch"](n, d)), 1),
                          dtype=torch.uint8, device=device)
    c = AdamHyper(learning_rate=lr, b1=b1, b2=b2, eps=eps).scalars(t)
    err = fn(table.data_ptr(), slots.mu.data_ptr(),
             int(slots.mu.dtype == torch.bfloat16), slots.nu.data_ptr(), v,
             d, ids.data_ptr(), grads.data_ptr(), n, c["b1"], c["b2"],
             c["one_minus_b1"], c["one_minus_b2"], c["b1c"], c["b2c"],
             c["eps"], c["neg_lr"], scratch.data_ptr(),
             launch.stream(device))
    launch.check_launch(err, "sparse_adam")
    launch.count(__name__)
