"""K3 blockwise_topk: top-k and logsumexp of the classifier logits.

Replaces code2vec_tpu/ops/topk.py blockwise_matmul_top_k (:99-179) with
`_merge_top_k` and `_fold_lse`. The CUDA source is csrc/topk.cu; what
bounds it on an H100 and how its design answers that is written at the
top of that file. One call is two launches: a split-V partial (persistent
CTAs over runs of 64-row table tiles, `plan` below), then a merge of the
partials. The plain version is ops/topk.py blockwise_matmul_top_k: CPU
tensors take it, CUDA tensors launch the kernel.

For k above the 64 entries a list holds (MAX_K), K3 runs its large-k
mode: it writes every logit to a (B, V) f32 score matrix and folds the
logsumexp, and K13 (kernels/select.py) selects the top k from the scores.

Two modes: bf16 compute (the serving head: operands rounded to bf16,
tensor cores, f32 accumulation), and float32 compute (the retrieval
index's brute-force search: f32 operands and f32 tables, each operand
split into tf32 hi and lo parts for three tensor-core products, 3xTF32;
`blockwise_topk_3xtf32` is that arithmetic in plain PyTorch, for tests),
counted in `f32_launches`. The bf16 mode reads the table in its stored
format, which its dtype names: f32 or int8 (counted in `launches`), fp8
e4m3 or e5m2 (`fp8_launches`), or packed int4, uint8 with two values a
byte (`int4_launches`); quantized tables come with per-row scales. Widths it
takes: the code width a multiple of 16, with int8 and fp8 rows up to 512
wide and int4 rows a multiple of 32 up to 1024 (a tile of 64 rows is one
bulk copy into a shared-memory ring stage).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from code2vec_tpu_torch.kernels import launch, select, tf32
from code2vec_tpu_torch.ops.topk import (
    BlockTopKOutputs, _fold_lse, blockwise_matmul_top_k,
    blockwise_top_k_from_logits,
)

launches = 0       # bf16 compute, f32 or int8 tables
fp8_launches = 0   # bf16 compute, fp8 tables
int4_launches = 0  # bf16 compute, packed int4 tables
f32_launches = 0   # float32 compute
_fns = {}
MAX_K = 64         # a list's length (csrc/topk.cu kMaxK); above: K13
TILE_ROWS = 64     # table rows per tile, wgmma's M (csrc/topk.cu)
MAX_BYTE_D = 512   # widest int8/fp8 row the kernel takes (topk.cu `takes`)
N_TILES = (8, 16, 32, 64)  # code vectors a CTA may hold (`plan`)
STAGES = (4, 2)            # ring depths, deepest first; half to each warpgroup
WARPGROUPS = 2             # consumers a CTA, alternate tiles: 2 partials
SMEM_LIMIT = 232448        # an H100's shared memory a block may opt into

blockwise_topk_plain = blockwise_matmul_top_k


class TopkPlan(NamedTuple):
    n_tile: int     # code vectors a CTA holds (wgmma's N)
    b_chunks: int   # CTAs per run of table tiles: ceil(b / n_tile)
    runs: int       # runs of table tiles (persistent CTAs per b-chunk)
    stages: int     # ring depth
    partials: int   # partial results per code vector: 2 per run
    grid: int       # CTAs
    smem: int       # dynamic shared memory per CTA


def plan(b: int, compute_f32: bool, v: int, sms: int,
         smem: Callable[[int, int], int],
         smem_limit: int = SMEM_LIMIT) -> TopkPlan:
    """How K3 covers a batch of b code vectors against v table rows on
    `sms` SMs, where smem(n_tile, stages) is a CTA's shared memory (the
    kernel's own layout, c2v_topk_smem): the smallest N tile that holds
    the batch, up to 32 (a batch of 33 to 64 in two chunks of 32; above
    64, chunks of 64 in the bf16 mode), halved while a CTA's shared
    memory (ring of 4 or 2 stages) does not fit; then as many runs of
    table tiles as leave one CTA per SM, the b-chunks of a run side by
    side. On the H100 two chunks of 32 beat one tile of 64 at the
    serving batch (each thread folds half the columns), and tiles of 64
    win at the evaluate batch (half the tile decodes)."""
    top = 64 if b > 64 and not compute_f32 else 32
    n = next(t for t in N_TILES if t >= min(b, top))
    while True:
        stages = next((s for s in STAGES if smem(n, s) <= smem_limit), None)
        if stages is not None:
            break
        if n == N_TILES[0]:
            raise ValueError(f"blockwise_topk: no tile fits {smem_limit} "
                             f"bytes of shared memory")
        n //= 2
    b_chunks = -(-b // n)
    tiles = -(-v // TILE_ROWS)
    runs = max(1, min(tiles, sms // b_chunks))
    return TopkPlan(n, b_chunks, runs, stages, WARPGROUPS * runs,
                    runs * b_chunks, smem(n, stages))


def blockwise_topk_3xtf32(code_vectors: torch.Tensor,
                          target_table: torch.Tensor, k: int, *,
                          valid_rows: Optional[int] = None
                          ) -> BlockTopKOutputs:
    """The float32 mode's arithmetic in plain PyTorch (tests only): the
    logits as 3xTF32 forms them (kernels/tf32.py), rows at or above
    `valid_rows` dead, then the plain version's top-k order and
    logsumexp with its nonfinite guard."""
    logits = tf32.matmul_3xtf32(code_vectors, target_table)
    b, v = logits.shape
    valid = v if valid_rows is None else int(valid_rows)
    live = torch.arange(v, device=logits.device) < valid
    logits = torch.where(live[None, :], logits,
                         torch.full_like(logits, float("-inf")))
    vals, idx = blockwise_top_k_from_logits(logits, min(k, valid), v)
    lse_in = torch.where(live[None, :] & ~torch.isfinite(logits),
                         torch.full_like(logits, -1e30), logits)
    m, s = _fold_lse(torch.full((b,), float("-inf"), device=logits.device),
                     torch.zeros((b,), device=logits.device), lse_in)
    lse = torch.where(torch.isfinite(m),
                      torch.log(torch.clamp(s, min=1e-30)) + m, m)
    return BlockTopKOutputs(vals, idx, lse)


def _smem_fn():
    fn = _fns.get("smem")
    if fn is None:
        I32 = launch.I32
        fn = _fns["smem"] = launch.bind(
            "topk", "c2v_topk_smem", [I32] * 6, restype=launch.I64)
    return fn


def _fn():
    fn = _fns.get("topk")
    if fn is None:
        P, I32, I64 = launch.P, launch.I32, launch.I64
        fn = _fns["topk"] = launch.bind(
            "topk", "c2v_blockwise_topk",
            # cv, b, d, table, scales, fmt, compute_f32, v, valid_rows,
            # k, n_tile, runs, stages, 4 partials, values, indices, lse,
            # scores, scores_ld, stream
            [P, I32, I32, P, P, I32, I32, I64, I64, I32, I32, I32, I32, P,
             P, P, P, P, P, P, P, I64, P])
    return fn


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
    large = k > MAX_K
    k_list = 0 if large else k
    smem = _smem_fn()
    p = plan(b, compute_f32, v,
             torch.cuda.get_device_properties(device).multi_processor_count,
             lambda n, s: smem(fmt, int(compute_f32), d, k_list, n, s),
             launch.shared_memory_limit(device))
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    part_vals = torch.empty((b, p.partials, k_list), **f32)
    part_idx = torch.empty((b, p.partials, k_list), **i32)
    part_max = torch.empty((b, p.partials), **f32)
    part_sum = torch.empty((b, p.partials), **f32)
    values = torch.empty((b, k_list), **f32)
    indices = torch.empty((b, k_list), **i32)
    lse = torch.empty((b,), **f32)
    scores = (torch.empty((b, select.padded_width(v)), **f32) if large
              else None)
    err = fn(code_vectors.data_ptr(), b, d, target_table.data_ptr(),
             launch.ptr(scales), fmt, int(compute_f32), v, valid,
             k_list, p.n_tile, p.runs, p.stages,
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
