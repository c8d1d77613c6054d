"""K7 softmax_xent: the train loss and its gradient over the logits.

Replaces code2vec_tpu/training/step.py _loss_from_logits (:170-175)
(optax.softmax_cross_entropy_with_integer_labels times `valid`, summed,
divided by the batch size) and its gradient. The CUDA source is
csrc/softmax_xent.cu; what bounds it on an H100 and how its design
answers that is written at the top of that file. `softmax_xent_plain`
below is the same function in plain PyTorch: CPU tensors take it, CUDA
tensors launch the kernel.

The kernel runs a thread-block cluster of C CTAs per row, each holding a
slice of the row in shared memory; `plan` picks C on the host from the
kernel's own shared-memory layout (`c2v_softmax_xent_smem`), and
`row_slices` cuts a row as the kernel does (plain Python, held on the CPU
by tests/test_torch_encoder_xent_plans.py), and `split_softmax_xent` is
the kernel's merge, slice by slice, in plain PyTorch.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from code2vec_tpu_torch.kernels import launch

launches = 0
_fns = {}
MAX_CLUSTER = 16       # csrc/softmax_xent.cu kMaxCluster (16: non-portable)
SMEM_LIMIT = 232448    # an H100's shared memory a block may opt into
# A CTA's slice takes at most this share of the shared memory a block may
# use: 1 allows one CTA an SM (C 8 at the flagship's 261,246 columns), 2
# two or more (C 16: three CTAs an SM, 0.869 ms against C 8's 1.12 at
# 1024 rows on the H100; PERF.md)
SLICE_SHARE = 2


class XentPlan(NamedTuple):
    cluster: int   # CTAs a row (0: one CTA a row reading it twice)
    units: int     # 16-byte units of the row's aligned interior a CTA owns
    smem: int      # dynamic shared memory a CTA
    grid: int      # CTAs: b x cluster


def plan(b: int, v: int, sms: int, smem: Callable[[int], int],
         smem_limit: int = SMEM_LIMIT) -> XentPlan:
    """How K7 covers b rows of v logits on `sms` SMs, where smem(units)
    is the shared memory of a CTA owning that many 16-byte units, or -1
    where the kernel cannot stage them (its own layout,
    c2v_softmax_xent_smem): C doubles from 1 (up to 16) while a CTA's
    slice of ceil((v // 4) / C) units takes more than smem_limit /
    SLICE_SHARE, or b x C CTAs do not cover the SMs. A row that 16 CTAs
    cannot hold goes to the two-read kernel (cluster 0)."""
    def units(c):
        return -(-(v // 4) // c)

    def need(c):
        n = smem(units(c))
        return n if n >= 0 else smem_limit + 1

    cluster = 1
    while cluster < MAX_CLUSTER and (
            need(cluster) > smem_limit // SLICE_SHARE or b * cluster < sms):
        cluster *= 2
    if need(cluster) > smem_limit:
        return XentPlan(0, 0, 0, b)
    return XentPlan(cluster, units(cluster), need(cluster), b * cluster)


def row_slices(row: int, v: int, cluster: int, units: int
               ) -> List[Tuple[int, int]]:
    """The columns [lo, hi) each rank of the kernel reads of row `row`:
    rank r the 16-byte units [r units, (r + 1) units) of the interior
    that starts h = (-row v) mod 4 columns in (16-byte aligned in memory),
    rank 0 also the h columns before it and rank C - 1 the fewer than 4
    after it. Together they cover [0, v) once, in rank order."""
    h = min(v, (4 - (row * v) % 4) % 4)
    n = (v - h) // 4
    out = []
    for r in range(cluster):
        u0, u1 = min(n, r * units), min(n, (r + 1) * units)
        lo, hi = h + 4 * u0, h + 4 * u1
        if r == 0:
            lo = 0
        if r == cluster - 1:
            hi = v
        out.append((lo, hi))
    return out


def split_softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                       valid: torch.Tensor, n_real: int, cluster: int,
                       units: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7's arithmetic in plain PyTorch, slice by slice (tests only):
    each rank's slice of a row (`row_slices`, columns at or past n_real
    left out) posts its max and its sum of exp(x - max) (an empty or
    wholly masked slice posts (-inf, 0)); the posts are folded in rank
    order, each rescaled to the running max; the gradient and loss then
    follow from that (max, sum) as in `softmax_xent_plain`. Returns the
    loss and the f32 (B, V) gradient."""
    b, v = logits.shape
    x = logits.float()
    grad = torch.zeros((b, v), dtype=torch.float32)
    ce = torch.zeros(b, dtype=torch.float32)
    nan = torch.tensor(float("nan"))
    for row in range(b):
        mx, sm = torch.tensor(float("-inf")), torch.tensor(0.0)
        for lo, hi in row_slices(row, v, cluster, units):
            part = x[row, lo:min(hi, n_real)]
            pm = part.max() if part.numel() else torch.tensor(float("-inf"))
            safe = pm if torch.isfinite(pm) else torch.tensor(0.0)
            ps = torch.exp(part - safe).sum() if torch.isfinite(pm) \
                else torch.tensor(0.0)
            if torch.isnan(part).any():
                ps = nan
            nm = torch.maximum(mx, pm)
            if torch.isnan(sm) or torch.isnan(ps):
                mx, sm = nm, nan
                continue
            base = nm if torch.isfinite(nm) else torch.tensor(0.0)
            zero = torch.tensor(0.0)
            sm = ((sm * torch.exp(mx - base) if torch.isfinite(mx) else zero)
                  + (ps * torch.exp(pm - base) if torch.isfinite(pm)
                     else zero))
            mx = nm
        scale = valid[row].float() / b
        g = torch.exp(x[row, :n_real] - mx) / sm * scale
        lab = int(labels[row])
        if 0 <= lab < n_real:
            g[lab] = g[lab] - scale
            ce[row] = (mx + torch.log(sm) - x[row, lab]) * valid[row]
        else:
            ce[row] = nan * valid[row]
        grad[row, :n_real] = g
    return ce.sum() / b, grad


def softmax_xent_plain(logits: torch.Tensor, labels: torch.Tensor,
                       valid: torch.Tensor, *,
                       n_real: Optional[int] = None,
                       grad_dtype: torch.dtype = torch.bfloat16
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss () f32, d loss / d logits). The gradient is (B, V) f32 for
    grad_dtype float32, and for bfloat16 the f32 gradient as two bf16
    planes (2, B, V), hi = bf16(g) and lo = bf16(g - hi). Columns at or
    past `n_real` count as -inf; `valid` is (B,) f32 {0, 1}."""
    b, v = logits.shape
    n = v if n_real is None else int(n_real)
    x = logits[:, :n].float()
    mx = x.amax(dim=1, keepdim=True)
    mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    e = torch.exp(x - mx)
    s = e.sum(dim=1, keepdim=True)
    lse = (mx + torch.log(s))[:, 0]
    lab = labels.long()
    in_range = (lab >= 0) & (lab < n)
    label_logit = torch.where(
        in_range, x.gather(1, lab.clamp(0, n - 1)[:, None])[:, 0],
        torch.full_like(lse, float("nan")))
    valid = valid.float()
    ce = (lse - label_logit) * valid
    loss = ce.sum() / b
    scale = valid * (torch.tensor(1.0) / b)
    g = (e / s) * scale[:, None]
    rows = torch.nonzero(in_range)[:, 0]
    g[rows, lab[rows]] = g[rows, lab[rows]] - scale[rows]
    if grad_dtype == torch.float32:
        grad = torch.zeros((b, v), dtype=torch.float32, device=logits.device)
        grad[:, :n] = g
        return loss, grad
    grad = torch.zeros((2, b, v), dtype=grad_dtype, device=logits.device)
    hi = g.to(grad_dtype)
    grad[0, :, :n] = hi
    grad[1, :, :n] = (g - hi.float()).to(grad_dtype)
    return loss, grad


def _fn():
    fn = _fns.get("softmax_xent")
    if fn is None:
        P, I32, I64 = launch.P, launch.I32, launch.I64
        fn = _fns["softmax_xent"] = launch.bind(
            "softmax_xent", "c2v_softmax_xent",
            [P, I32, I64, I64, P, P, P, P, P, I32, I32, P])
        _fns["smem"] = launch.bind("softmax_xent", "c2v_softmax_xent_smem",
                                   [I32], restype=launch.I64)
    return fn


def device_plan(b: int, v: int, device: torch.device) -> XentPlan:
    """`plan` on the card's SMs and shared memory and the kernel's layout
    (builds the library first)."""
    _fn()
    return plan(b, v,
                torch.cuda.get_device_properties(device).multi_processor_count,
                lambda units: int(_fns["smem"](units)),
                launch.shared_memory_limit(device))


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 valid: torch.Tensor, *, n_real: Optional[int] = None,
                 grad_dtype: torch.dtype = torch.bfloat16
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss () f32, d loss / d logits): see `softmax_xent_plain`. The
    kernel writes the bf16 planes only; grad_dtype float32 (f32 compute)
    is the plain version's."""
    if launch.runs_plain(logits, labels, valid):
        return softmax_xent_plain(logits, labels, valid, n_real=n_real,
                                  grad_dtype=grad_dtype)
    fn = _fn()  # builds the library first: raises where nvcc is missing
    launch.check_tensor(logits, "logits", [torch.float32], 2, align=16)
    b, v = logits.shape
    n = v if n_real is None else int(n_real)
    launch.require(0 < n <= v, f"n_real {n} outside (0, {v}]")
    launch.check_tensor(labels, "labels", [torch.int32], 1)
    launch.check_tensor(valid, "valid", [torch.float32], 1)
    launch.require(labels.shape[0] == b and valid.shape[0] == b,
                   f"labels, valid: expected ({b},)")
    launch.require(grad_dtype == torch.bfloat16,
                   f"softmax_xent kernel writes bfloat16 hi/lo planes, "
                   f"not {grad_dtype}")
    device = logits.device
    p = device_plan(b, v, device)
    grad = torch.empty((2, b, v), dtype=grad_dtype, device=device)
    ce = torch.empty((b,), dtype=torch.float32, device=device)
    loss = torch.empty((), dtype=torch.float32, device=device)
    err = fn(logits.data_ptr(), b, v, n, labels.data_ptr(), valid.data_ptr(),
             grad.data_ptr(), ce.data_ptr(), loss.data_ptr(), p.cluster,
             p.units, launch.stream(device))
    launch.check_launch(err, "softmax_xent")
    launch.count(__name__)
    return loss, grad
