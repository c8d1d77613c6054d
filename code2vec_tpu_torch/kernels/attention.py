"""K2 masked_attention and K6 masked_attention_backward: masked
single-query attention over the contexts, and its backward.

K2 replaces code2vec_tpu/ops/attention.py masked_single_query_attention
(:28-69, axis_name=None), K6 its autodiff in the dense train step. The
CUDA sources are csrc/attention.cu and csrc/attention_backward.cu; what
bounds each on an H100, how its design answers that and (K6) the
reference's rounding points are written at the top of those files. The
plain versions are ops/attention.py masked_single_query_attention and
masked_single_query_attention_backward: CPU tensors take them, CUDA
tensors launch the kernels. K6 keeps its own count, `backward_launches`.

K2 and K6 each run a thread-block cluster of C CTAs per batch row, each
CTA owning a chunk of the row's contexts; `plan` and `backward_plan` pick
C and the chunk on the host (plain Python, held on the CPU by
tests/test_torch_attention_ivf_plans.py and
tests/test_torch_sparse_adam_attention_plans.py), and `split_softmax` and
`split_backward` are the kernels' arithmetic, chunk by chunk, in plain
PyTorch.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from code2vec_tpu_torch.kernels import launch
from code2vec_tpu_torch.ops.attention import (
    masked_single_query_attention, masked_single_query_attention_backward,
)

launches = 0
backward_launches = 0
_fns = {}
MAX_CLUSTER = 8        # portable cluster size (csrc/attention.cu kMaxCluster)
WARPS = 8              # a CTA's warps (csrc/attention.cu kWarps)
THREADS = 32 * WARPS
SUM_RUNS = 32          # runs of rows K6's da sum takes (kSumRuns)
SMEM_LIMIT = 232448    # an H100's shared memory a block may opt into
SMS = 132              # an H100 SXM's SMs

masked_attention_plain = masked_single_query_attention
masked_attention_backward_plain = masked_single_query_attention_backward


class AttentionPlan(NamedTuple):
    cluster: int   # CTAs per batch row (a thread-block cluster)
    chunk: int     # contexts a CTA owns: ceil(m / cluster)
    staged: bool   # the chunk lives in shared memory (else read twice)
    smem: int      # dynamic shared memory per CTA
    grid: int      # CTAs: b * cluster


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


def smem_bytes(chunk: int, d: int, staged: bool) -> int:
    """A CTA's shared memory (csrc/attention.cu `Layout`): the
    mbarrier's 128 bytes, the staged contexts, the query, the chunk's
    mask and scores, the slices of partial code vectors pushed here, the
    reduction slots and the ranks' posts."""
    return (128 + (chunk * d * 2 if staged else 0) + d * 4
            + 2 * _align16(chunk * 4) + _align16((d + 2 * MAX_CLUSTER) * 4)
            + _align16(WARPS * 4) + 2 * MAX_CLUSTER * 4)


def _cluster_plan(b: int, m: int, d: int, smem_bytes_fn, smem_limit: int,
                  sms: int, what: str) -> AttentionPlan:
    cluster = 1
    while (cluster < MAX_CLUSTER and cluster < m
           and (b * cluster < sms or smem_bytes_fn(-(-m // cluster), d, True)
                > smem_limit // 4)):
        cluster *= 2
    chunk = -(-m // cluster)
    staged = smem_bytes_fn(chunk, d, True) <= smem_limit
    smem = smem_bytes_fn(chunk, d, staged)
    if smem > smem_limit:
        raise ValueError(f"{what}: {m} contexts of width {d} need {smem} "
                         f"bytes of shared memory a CTA")
    return AttentionPlan(cluster, chunk, staged, smem, b * cluster)


def plan(b: int, m: int, d: int, smem_limit: int = SMEM_LIMIT,
         sms: int = SMS) -> AttentionPlan:
    """How K2 covers b rows of m contexts of width d: the cluster size C
    doubles from 1 (up to 8, and while C < m) until b x C CTAs cover the
    SMs and a staged chunk takes at most a quarter of the shared memory a
    block may use (four CTAs an SM, some loading while others compute); a
    chunk that does not fit at all is read from device memory instead."""
    return _cluster_plan(b, m, d, smem_bytes, smem_limit, sms,
                         "masked_attention")


def da_groups(d: int) -> int:
    """K6's groups of contexts for a CTA's da share: a thread per 8
    columns of a group, as many groups as fill the CTA (csrc/
    attention_backward.cu `da_groups`)."""
    return 1 if d // 8 >= THREADS else THREADS // (d // 8)


def backward_smem_bytes(chunk: int, d: int, staged: bool) -> int:
    """A K6 CTA's shared memory (csrc/attention_backward.cu `Layout`): the
    mbarrier's 128 bytes, the staged contexts, dcv and the query, the
    chunk's weights, mask and fs, the groups' da shares, the column
    slices of da pushed here, the reduction slots and the ranks' posts."""
    return (128 + (chunk * d * 2 if staged else 0) + 2 * d * 4
            + 3 * _align16(chunk * 4) + da_groups(d) * d * 4
            + _align16((d + 2 * MAX_CLUSTER) * 4) + _align16(WARPS * 4)
            + MAX_CLUSTER * 4)


def backward_plan(b: int, m: int, d: int, smem_limit: int = SMEM_LIMIT,
                  sms: int = SMS) -> AttentionPlan:
    """How K6 covers b rows of m contexts of width d: K2's rule (`plan`)
    over K6's shared memory."""
    return _cluster_plan(b, m, d, backward_smem_bytes, smem_limit, sms,
                         "masked_attention_backward")


def split_softmax(transformed: torch.Tensor, attention_param: torch.Tensor,
                  context_valid_mask: torch.Tensor, cluster: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's arithmetic in plain PyTorch, chunk by chunk (tests only): each
    of `cluster` chunks posts its max and its sum of exp(s - max) (an
    all-masked chunk's max pinned to 0 there); the denominator is the
    posts' sums rescaled to the row's max, exp(max_r - max), added in rank
    order; the weights exp(s - max) / denominator; the code vector the
    chunks' partial sums added in rank order."""
    t = transformed.float()
    b, m, _ = t.shape
    a = attention_param.to(transformed.dtype).float()
    scores = torch.einsum("bmd,d->bm", t, a)
    scores = torch.where(context_valid_mask > 0, scores,
                         torch.full_like(scores, float("-inf")))
    chunk = -(-m // cluster)
    spans = [(min(m, r * chunk), min(m, (r + 1) * chunk))
             for r in range(cluster)]
    neg = torch.full((b,), float("-inf"), dtype=torch.float32,
                     device=t.device)
    posts = []
    for lo, hi in spans:
        mx = scores[:, lo:hi].amax(dim=1) if hi > lo else neg
        local = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
        posts.append((mx, torch.exp(scores[:, lo:hi] - local[:, None]
                                    ).sum(dim=1)))
    gmax = neg
    for mx, _ in posts:
        gmax = torch.maximum(gmax, mx)
    safe = torch.where(torch.isfinite(gmax), gmax, torch.zeros_like(gmax))
    total = torch.zeros_like(gmax)
    for mx, sm in posts:
        total = total + torch.where(
            torch.isnan(sm), sm, torch.where(torch.isfinite(mx),
                                             sm * torch.exp(mx - safe),
                                             torch.zeros_like(sm)))
    unnorm = torch.exp(scores - safe[:, None])
    denom = torch.where(torch.isnan(total), total,
                        torch.clamp(total, min=1e-30))
    attention = unnorm / denom[:, None]
    w = attention.to(transformed.dtype).float()
    cv = torch.zeros((b, t.shape[2]), dtype=torch.float32, device=t.device)
    for lo, hi in spans:
        cv = cv + torch.einsum("bm,bmd->bd", w[:, lo:hi], t[:, lo:hi])
    return cv, attention


def split_backward(transformed: torch.Tensor, attention_param: torch.Tensor,
                   context_valid_mask: torch.Tensor, attention: torch.Tensor,
                   d_code_vectors: torch.Tensor, cluster: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's arithmetic in plain PyTorch, chunk by chunk (tests only): each
    of `cluster` chunks posts its sum of w fs, added in rank order; ds and
    dT as the plain version; a chunk's da share is `da_groups` groups of
    contexts (group r takes contexts r, r + groups, ...), added in group
    order, the chunks' shares added in rank order; the rows' da in
    SUM_RUNS contiguous runs, each in row order, then the runs in order,
    rounded to bf16."""
    cd = transformed.dtype
    t = transformed.float()
    b, m, d = t.shape
    g = d_code_vectors.float()
    fs = torch.einsum("bd,bmd->bm", g, t).to(cd).float()
    chunk = -(-m // cluster)
    spans = [(min(m, r * chunk), min(m, (r + 1) * chunk))
             for r in range(cluster)]
    wfs = torch.zeros((b,), dtype=torch.float32)
    for lo, hi in spans:
        wfs = wfs + (attention[:, lo:hi] * fs[:, lo:hi]).sum(dim=1)
    ds = torch.where(context_valid_mask > 0,
                     attention * (fs - wfs[:, None]), torch.zeros_like(fs))
    a = attention_param.to(cd).float()
    w = attention.to(cd).float()
    dt = ((w[:, :, None] * g[:, None, :]).to(cd).float()
          + (ds[:, :, None] * a).to(cd).float()).to(cd)
    groups = da_groups(d)
    rows = torch.zeros((b, d), dtype=torch.float32)
    for lo, hi in spans:
        share = torch.zeros((b, d), dtype=torch.float32)
        for gr in range(groups):
            js = list(range(lo + gr, hi, groups))
            share = share + (torch.einsum("bm,bmd->bd", ds[:, js], t[:, js])
                             if js else 0.0)
        rows = rows + share
    per = -(-b // SUM_RUNS)
    da = torch.zeros((d,), dtype=torch.float32)
    for r0 in range(0, b, per):
        run = torch.zeros((d,), dtype=torch.float32)
        for q in range(r0, min(b, r0 + per)):
            run = run + rows[q]
        da = da + run
    return dt, da.to(cd).float()


def _fn():
    fn = _fns.get("attention")
    if fn is None:
        P, I32 = launch.P, launch.I32
        fn = _fns["attention"] = launch.bind(
            "attention", "c2v_masked_attention",
            [P, P, P, I32, I32, I32, I32, I32, I32, P, P, P])
        _fns["smem"] = launch.bind("attention", "c2v_attention_smem",
                                   [I32, I32, I32], restype=launch.I64)
    return fn


def kernel_smem_bytes(chunk: int, d: int, staged: bool) -> int:
    """The kernel's own count of a CTA's shared memory (tests hold
    `smem_bytes` to it)."""
    _fn()
    return int(_fns["smem"](chunk, d, int(staged)))


def masked_attention(transformed: torch.Tensor,
                     attention_param: torch.Tensor,
                     context_valid_mask: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, M, D) contexts, (D,) query, (B, M) mask -> (code vectors
    (B, D) f32, attention (B, M) f32)."""
    if launch.runs_plain(transformed, attention_param, context_valid_mask):
        return masked_attention_plain(transformed, attention_param,
                                      context_valid_mask)
    fn = _fn()  # builds the library first: raises where nvcc is missing
    launch.check_tensor(transformed, "transformed", [torch.bfloat16], 3,
                        align=16)
    b, m, d = transformed.shape
    launch.require(d % 8 == 0, f"code width {d} is not a multiple of 8")
    launch.check_tensor(attention_param, "attention_param",
                        [torch.float32], 1)
    launch.require(attention_param.shape[0] == d,
                   f"attention_param: expected ({d},)")
    launch.check_tensor(context_valid_mask, "context_valid_mask",
                        [torch.float32], 2)
    launch.require(tuple(context_valid_mask.shape) == (b, m),
                   f"context_valid_mask: expected ({b}, {m})")
    device = transformed.device
    p = plan(b, m, d, launch.shared_memory_limit(device),
             torch.cuda.get_device_properties(device).multi_processor_count)
    cv = torch.empty((b, d), dtype=torch.float32, device=device)
    attn = torch.empty((b, m), dtype=torch.float32, device=device)
    err = fn(transformed.data_ptr(), attention_param.data_ptr(),
             context_valid_mask.data_ptr(), b, m, d, p.cluster, p.chunk,
             int(p.staged), cv.data_ptr(), attn.data_ptr(),
             launch.stream(device))
    launch.check_launch(err, "masked_attention")
    launch.count(__name__)
    return cv, attn


def _backward_fn():
    fn = _fns.get("attention_backward")
    if fn is None:
        P, I32 = launch.P, launch.I32
        fn = _fns["attention_backward"] = launch.bind(
            "attention_backward", "c2v_attention_backward",
            [P, P, P, P, P, I32, I32, I32, I32, I32, I32, P, P, P, P])
        _fns["backward_smem"] = launch.bind(
            "attention_backward", "c2v_attention_backward_smem",
            [I32, I32, I32], restype=launch.I64)
    return fn


def kernel_backward_smem_bytes(chunk: int, d: int, staged: bool) -> int:
    """K6's own count of a CTA's shared memory (tests hold
    `backward_smem_bytes` to it)."""
    _backward_fn()
    return int(_fns["backward_smem"](chunk, d, int(staged)))


def masked_attention_backward(transformed: torch.Tensor,
                              attention_param: torch.Tensor,
                              context_valid_mask: torch.Tensor,
                              attention: torch.Tensor,
                              d_code_vectors: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward's inputs and f32 weights, and the code vectors'
    cotangent (B, D) f32 -> (d_transformed (B, M, D) in its dtype,
    d_attention_param (D,) f32)."""
    args = (transformed, attention_param, context_valid_mask, attention,
            d_code_vectors)
    if launch.runs_plain(*args):
        return masked_attention_backward_plain(*args)
    fn = _backward_fn()  # builds the library first: raises without nvcc
    launch.check_tensor(transformed, "transformed", [torch.bfloat16], 3,
                        align=16)
    b, m, d = transformed.shape
    launch.require(d % 8 == 0, f"code width {d} is not a multiple of 8")
    launch.check_tensor(attention_param, "attention_param",
                        [torch.float32], 1)
    launch.require(attention_param.shape[0] == d,
                   f"attention_param: expected ({d},)")
    for name, x in (("context_valid_mask", context_valid_mask),
                    ("attention", attention)):
        launch.check_tensor(x, name, [torch.float32], 2)
        launch.require(tuple(x.shape) == (b, m), f"{name}: expected "
                                                 f"({b}, {m})")
    launch.check_tensor(d_code_vectors, "d_code_vectors", [torch.float32], 2)
    launch.require(tuple(d_code_vectors.shape) == (b, d),
                   f"d_code_vectors: expected ({b}, {d})")
    device = transformed.device
    p = backward_plan(
        b, m, d, launch.shared_memory_limit(device),
        torch.cuda.get_device_properties(device).multi_processor_count)
    dt = torch.empty_like(transformed)
    da_rows = torch.empty((b, d), dtype=torch.float32, device=device)
    da = torch.empty((d,), dtype=torch.float32, device=device)
    err = fn(transformed.data_ptr(), attention_param.data_ptr(),
             context_valid_mask.data_ptr(), attention.data_ptr(),
             d_code_vectors.data_ptr(), b, m, d, p.cluster, p.chunk,
             int(p.staged), dt.data_ptr(), da_rows.data_ptr(), da.data_ptr(),
             launch.stream(device))
    launch.check_launch(err, "masked_attention_backward")
    launch.count(__name__, "backward_launches")
    return dt, da
