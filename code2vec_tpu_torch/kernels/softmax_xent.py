"""K7 softmax_xent: the train loss and its gradient over the logits.

Replaces code2vec_tpu/training/step.py _loss_from_logits (:170-175)
(optax.softmax_cross_entropy_with_integer_labels times `valid`, summed,
divided by the batch size) and its gradient. The CUDA source is
csrc/softmax_xent.cu; what bounds it on an H100 and how its design
answers that is written at the top of that file. `softmax_xent_plain`
below is the same function in plain PyTorch: CPU tensors take it, CUDA
tensors launch the kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from code2vec_tpu_torch.kernels import launch

launches = 0
_fns = {}


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
            [P, I32, I64, I64, P, P, P, P, P, P])
    return fn


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
    launch.check_tensor(logits, "logits", [torch.float32], 2)
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
    grad = torch.empty((2, b, v), dtype=grad_dtype, device=device)
    ce = torch.empty((b,), dtype=torch.float32, device=device)
    loss = torch.empty((), dtype=torch.float32, device=device)
    err = fn(logits.data_ptr(), b, v, n, labels.data_ptr(), valid.data_ptr(),
             grad.data_ptr(), ce.data_ptr(), loss.data_ptr(),
             launch.stream(device))
    launch.check_launch(err, "softmax_xent")
    launch.count(__name__)
    return loss, grad
