"""K3 blockwise_topk: top-k and logsumexp of the classifier logits.

Replaces code2vec_tpu/ops/topk.py blockwise_matmul_top_k (:99-179) with
`_merge_top_k` and `_fold_lse`. The CUDA source is csrc/topk.cu; what
bounds it on an H100 and how its design answers that is written at the
top of that file. One call is two launches: a split-V partial over chunks
of table rows, then a merge of the partials. The plain version is
ops/topk.py blockwise_matmul_top_k: CPU tensors take it, CUDA tensors
launch the kernel.

Two modes: bf16 compute (the serving head: operands rounded to bf16,
tensor cores, f32 accumulation; int8 or f32 tables), counted in
`launches`, and float32 compute (the retrieval index's brute-force
search: f32 operands, f32 FMAs, no TF32; f32 tables), counted in
`f32_launches`.
"""

from __future__ import annotations

from typing import Optional

import torch

from code2vec_tpu_torch.kernels import launch
from code2vec_tpu_torch.ops.topk import (
    BlockTopKOutputs, blockwise_matmul_top_k,
)

launches = 0      # bf16 compute
f32_launches = 0  # float32 compute
_fns = {}
MAX_K = 64        # the kernel's compiled maximum (csrc/topk.cu kMaxK)
TILE_ROWS = 64    # table rows per tile (csrc/topk.cu kTileV)
MAX_INT8_D = 512  # widest int8 row a tile prefetch holds (csrc/topk.cu)

blockwise_topk_plain = blockwise_matmul_top_k


def _fn():
    fn = _fns.get("topk")
    if fn is None:
        P, I32, I64 = launch.P, launch.I32, launch.I64
        fn = _fns["topk"] = launch.bind(
            "topk", "c2v_blockwise_topk",
            [P, I32, I32, P, P, I32, I32, I64, I64, I32, I64, P, P, P, P, P,
             P, P, P])
    return fn


def chunk_rows_for(v: int, device: torch.device) -> int:
    """Table rows per CTA: about two chunks per SM, whole tiles."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows = -(-v // (2 * sms))
    return max(TILE_ROWS, -(-rows // TILE_ROWS) * TILE_ROWS)


def blockwise_topk(code_vectors: torch.Tensor, target_table: torch.Tensor,
                   k: int, block_rows: int, *,
                   scales: Optional[torch.Tensor] = None,
                   valid_rows: Optional[int] = None,
                   compute_dtype: torch.dtype = torch.bfloat16
                   ) -> BlockTopKOutputs:
    """Top-k (values, int32 indices) and logsumexp of code_vectors @
    target_table.T. `block_rows` is the reference's sequential block
    size; the plain version walks the table in such blocks, the kernel
    in its own chunks (the result does not depend on it)."""
    if launch.runs_plain(code_vectors, target_table, scales):
        return blockwise_topk_plain(
            code_vectors, target_table, k, block_rows, scales=scales,
            valid_rows=valid_rows, compute_dtype=compute_dtype)
    fn = _fn()  # builds the library first: raises where nvcc is missing
    launch.require(compute_dtype in (torch.bfloat16, torch.float32),
                   f"blockwise_topk kernel computes in bfloat16 or float32, "
                   f"not {compute_dtype}")
    compute_f32 = compute_dtype == torch.float32
    launch.check_tensor(code_vectors, "code_vectors", [torch.float32], 2,
                        align=16)
    b, d = code_vectors.shape
    int8 = target_table.dtype == torch.int8
    launch.check_tensor(target_table, "target_table",
                        [torch.int8] if int8 else [torch.float32], 2,
                        align=16)
    v = target_table.shape[0]
    launch.require(target_table.shape[1] == d,
                   f"target_table: expected {d} columns")
    launch.require(d % 16 == 0, f"code width {d} is not a multiple of 16")
    launch.require(not int8 or d <= MAX_INT8_D,
                   f"int8 rows wider than {MAX_INT8_D} are not supported")
    launch.require(not (int8 and compute_f32),
                   "the float32 mode takes f32 tables")
    if int8:
        launch.require(scales is not None, "int8 tables need scales")
        launch.check_tensor(scales, "scales", [torch.float32], 2)
        launch.require(tuple(scales.shape) == (v, 1),
                       f"scales: expected ({v}, 1)")
    else:
        launch.require(scales is None, "f32 tables take no scales")
    valid = v if valid_rows is None else int(valid_rows)
    k = min(int(k), valid)
    launch.require(1 <= k <= MAX_K,
                   f"k={k} outside the kernel's range 1..{MAX_K}")
    device = code_vectors.device
    chunk = chunk_rows_for(v, device)
    n_chunks = -(-v // chunk)
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    part_vals = torch.empty((b, n_chunks, k), **f32)
    part_idx = torch.empty((b, n_chunks, k), **i32)
    part_max = torch.empty((b, n_chunks), **f32)
    part_sum = torch.empty((b, n_chunks), **f32)
    values = torch.empty((b, k), **f32)
    indices = torch.empty((b, k), **i32)
    lse = torch.empty((b,), **f32)
    err = fn(code_vectors.data_ptr(), b, d, target_table.data_ptr(),
             launch.ptr(scales), int(int8), int(compute_f32), v, valid, k,
             chunk,
             part_vals.data_ptr(), part_idx.data_ptr(), part_max.data_ptr(),
             part_sum.data_ptr(), values.data_ptr(), indices.data_ptr(),
             lse.data_ptr(), launch.stream(device))
    launch.check_launch(err, "blockwise_topk")
    launch.count(__name__, "f32_launches" if compute_f32 else "launches")
    return BlockTopKOutputs(values, indices, lse)
