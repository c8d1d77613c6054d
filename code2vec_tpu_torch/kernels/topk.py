"""K3 blockwise_topk: top-k and logsumexp of the classifier logits.

Replaces code2vec_tpu/ops/topk.py blockwise_matmul_top_k (:99-179) with
`_merge_top_k` and `_fold_lse`. The CUDA source is csrc/topk.cu; what
bounds it on an H100 and how its design answers that is written at the
top of that file. One call is two launches: a split-V partial over chunks
of table rows, then a merge of the partials. The plain version is
ops/topk.py blockwise_matmul_top_k: CPU tensors take it, CUDA tensors
launch the kernel.

For k above the 64 entries a list holds (MAX_K), K3 runs its large-k
mode: it writes every logit to a (B, V) f32 score matrix and folds the
logsumexp, and K13 (kernels/select.py) selects the top k from the scores.

Two modes: bf16 compute (the serving head: operands rounded to bf16,
tensor cores, f32 accumulation), and float32 compute (the retrieval
index's brute-force search: f32 operands, f32 FMAs, no TF32; f32 tables),
counted in `f32_launches`. The bf16 mode reads the table in its stored
format, which its dtype names: f32 or int8 (counted in `launches`), fp8
e4m3 or e5m2 (`fp8_launches`), or packed int4, uint8 with two values a
byte (`int4_launches`); quantized tables come with per-row scales. Widths it
takes: the code width a multiple of 16, with int8 and fp8 rows up to 512
wide and int4 rows a multiple of 32 up to 1024 (a tile's rows are whole
16-byte vectors held in registers).
"""

from __future__ import annotations

from typing import Optional

import torch

from code2vec_tpu_torch.kernels import launch, select
from code2vec_tpu_torch.ops.topk import (
    BlockTopKOutputs, blockwise_matmul_top_k,
)

launches = 0       # bf16 compute, f32 or int8 tables
fp8_launches = 0   # bf16 compute, fp8 tables
int4_launches = 0  # bf16 compute, packed int4 tables
f32_launches = 0   # float32 compute
_fns = {}
MAX_K = 64         # a list's length (csrc/topk.cu kMaxK); above: K13
TILE_ROWS = 64     # table rows per tile (csrc/topk.cu kTileV)
MAX_BYTE_D = 512   # widest int8/fp8 row a tile prefetch holds (topk.cu)

blockwise_topk_plain = blockwise_matmul_top_k


def _fn():
    fn = _fns.get("topk")
    if fn is None:
        P, I32, I64 = launch.P, launch.I32, launch.I64
        fn = _fns["topk"] = launch.bind(
            "topk", "c2v_blockwise_topk",
            # cv, b, d, table, scales, fmt, compute_f32, v, valid_rows,
            # k, chunk_rows, 4 partials, values, indices, lse, scores,
            # scores_ld, stream
            [P, I32, I32, P, P, I32, I32, I64, I64, I32, I64, P, P, P, P, P,
             P, P, P, I64, P])
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
    target_table.T, for any k (clamped to the live rows). `block_rows`
    is the reference's sequential block size; the plain version walks
    the table in such blocks, the kernel in its own chunks (the result
    does not depend on it)."""
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
    fmt = launch.table_format(target_table, "target_table")
    launch.check_tensor(target_table, "target_table", [target_table.dtype],
                        2, align=16)
    v = target_table.shape[0]
    launch.require(target_table.shape[1] == launch.stored_width(fmt, d),
                   f"target_table: expected "
                   f"{launch.stored_width(fmt, d)} columns")
    launch.require(d % 16 == 0, f"code width {d} is not a multiple of 16")
    launch.require(fmt not in (launch.FMT_INT8, launch.FMT_E4M3, launch.FMT_E5M2)
                   or d <= MAX_BYTE_D,
                   f"int8 and fp8 rows wider than {MAX_BYTE_D} are not "
                   f"supported")
    launch.require(fmt != launch.FMT_INT4 or (d % 32 == 0
                                          and d <= 2 * MAX_BYTE_D),
                   f"int4 rows take a width in multiples of 32 up to "
                   f"{2 * MAX_BYTE_D}, not {d}")
    launch.require(not (fmt != launch.FMT_F32 and compute_f32),
                   "the float32 mode takes f32 tables")
    launch.check_scales(scales, fmt, v, "scales")
    valid = v if valid_rows is None else int(valid_rows)
    k = min(int(k), valid)
    launch.require(k >= 1, f"k={k}: at least one live row is needed")
    device = code_vectors.device
    chunk = chunk_rows_for(v, device)
    n_chunks = -(-v // chunk)
    large = k > MAX_K
    k_list = 0 if large else k
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    part_vals = torch.empty((b, n_chunks, k_list), **f32)
    part_idx = torch.empty((b, n_chunks, k_list), **i32)
    part_max = torch.empty((b, n_chunks), **f32)
    part_sum = torch.empty((b, n_chunks), **f32)
    values = torch.empty((b, k_list), **f32)
    indices = torch.empty((b, k_list), **i32)
    lse = torch.empty((b,), **f32)
    scores = (torch.empty((b, select.padded_width(v)), **f32) if large
              else None)
    err = fn(code_vectors.data_ptr(), b, d, target_table.data_ptr(),
             launch.ptr(scales), fmt, int(compute_f32), v, valid,
             k_list, chunk,
             part_vals.data_ptr(), part_idx.data_ptr(), part_max.data_ptr(),
             part_sum.data_ptr(), values.data_ptr(), indices.data_ptr(),
             lse.data_ptr(), launch.ptr(scores),
             0 if scores is None else scores.shape[1],
             launch.stream(device))
    launch.check_launch(err, "blockwise_topk")
    launch.count(__name__, "f32_launches" if compute_f32
                 else launch.format_counter(fmt))
    if large:
        values, indices = select.select_topk(scores, k, n=valid)
    return BlockTopKOutputs(values, indices, lse)
