"""K8 adam: dense Adam over every parameter in one multi-tensor launch,
with bf16 or f32 storage for each moment.

Replaces code2vec_tpu/training/state.py make_optimizer (:99-115): the
`_scale_by_adam_nu_dtype` chain (:62-96) when nu is stored in bf16, and
`optax.adam(mu_dtype=...)` when it is f32, each followed by
optax.apply_updates. The CUDA source is csrc/adam.cu; the update rule of
each branch, what bounds it on an H100 and how its design answers that
are written at the top of that file. `adam_plain` below is the same update
in plain PyTorch: CPU tensors take it, CUDA tensors launch the kernel.
Both update the parameters and moments in place and leave the gradients
as they are.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence

import numpy as np
import torch

from code2vec_tpu_torch.kernels import launch

launches = 0
_fns = {}


@dataclasses.dataclass(frozen=True)
class AdamHyper:
    """Adam's constants and moment storage dtypes (config.learning_rate,
    adam_beta1/2, adam_eps, adam_mu_dtype, adam_nu_dtype)."""
    learning_rate: float = 0.001
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    mu_dtype: torch.dtype = torch.bfloat16
    nu_dtype: torch.dtype = torch.bfloat16

    @property
    def optax_mu(self) -> bool:
        """optax.adam's branch (f32 nu) with a bf16 mu: optax multiplies
        the stored bf16 moment by b1 in bf16."""
        return self.nu_dtype == torch.float32 and \
            self.mu_dtype == torch.bfloat16

    def scalars(self, count: int) -> dict:
        """The f32 constants of the update at the incremented `count`."""
        f = np.float32
        return dict(
            b1=float(f(self.b1)), b2=float(f(self.b2)),
            one_minus_b1=float(f(1.0 - self.b1)),
            one_minus_b2=float(f(1.0 - self.b2)),
            b1_bf16=float(torch.tensor(self.b1, dtype=torch.bfloat16)),
            b1c=float(f(1) - f(self.b1) ** f(count)),
            b2c=float(f(1) - f(self.b2) ** f(count)),
            eps=float(f(self.eps)), neg_lr=float(f(-self.learning_rate)))


def adam_plain(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
               mus: Sequence[torch.Tensor], nus: Sequence[torch.Tensor],
               count: int, hyper: AdamHyper) -> None:
    """One Adam step at the incremented `count`, in place."""
    c = hyper.scalars(count)
    for p, g, mu, nu in zip(params, grads, mus, nus):
        g = g.float()
        ms, vs = mu.float(), nu.float()
        if hyper.optax_mu:
            m = c["one_minus_b1"] * g + (c["b1_bf16"] * ms).to(
                torch.bfloat16).float()
        else:
            m = c["b1"] * ms + c["one_minus_b1"] * g
        v = c["b2"] * vs + c["one_minus_b2"] * (g * g)
        u = (m / c["b1c"]) / (torch.sqrt(v / c["b2c"]) + c["eps"])
        p.add_(u * c["neg_lr"])
        mu.copy_(m.to(mu.dtype))
        nu.copy_(v.to(nu.dtype))


def _fn():
    fn = _fns.get("adam")
    if fn is None:
        P, I32, F32 = launch.P, launch.I32, launch.F32
        fn = _fns["adam"] = launch.bind(
            "adam", "c2v_adam",
            [I32, P, P, P, P, P, I32, I32, I32] + [F32] * 9 + [P])
        _fns["max_tensors"] = launch.bind("adam", "c2v_adam_max_tensors", [])
    return fn


def adam(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
         mus: Sequence[torch.Tensor], nus: Sequence[torch.Tensor],
         count: int, hyper: AdamHyper) -> None:
    """One Adam step over all tensors at the incremented `count`, in
    place: f32 params and grads, moments in hyper's storage dtypes."""
    tensors = [*params, *grads, *mus, *nus]
    if launch.runs_plain(*tensors):
        return adam_plain(params, grads, mus, nus, count, hyper)
    fn = _fn()  # builds the library first: raises where nvcc is missing
    n = len(params)
    launch.require(len(grads) == len(mus) == len(nus) == n,
                   "params, grads, mus and nus differ in length")
    launch.require(0 < n <= _fns["max_tensors"](),
                   f"{n} tensors: the kernel takes 1 to "
                   f"{_fns['max_tensors']()}")
    device = params[0].device
    for i, (p, g, mu, nu) in enumerate(zip(params, grads, mus, nus)):
        launch.check_tensor(p, f"params[{i}]", [torch.float32], p.dim())
        launch.check_tensor(g, f"grads[{i}]", [torch.float32], p.dim())
        launch.check_tensor(mu, f"mus[{i}]", [hyper.mu_dtype], p.dim())
        launch.check_tensor(nu, f"nus[{i}]", [hyper.nu_dtype], p.dim())
        launch.require(p.numel() > 0 and g.shape == p.shape == mu.shape
                       == nu.shape, f"tensor {i}: shapes differ or empty")
        launch.require(p.device == device, "tensors on several devices")
    ptrs = ctypes.c_void_p * n

    def table(ts):
        return ptrs(*(t.data_ptr() for t in ts))

    sizes = (ctypes.c_int64 * n)(*(p.numel() for p in params))
    c = hyper.scalars(count)
    err = fn(n, table(params), table(grads), table(mus), table(nus), sizes,
             int(hyper.mu_dtype == torch.bfloat16),
             int(hyper.nu_dtype == torch.bfloat16), int(hyper.optax_mu),
             c["b1"], c["b2"], c["one_minus_b1"], c["one_minus_b2"],
             c["b1_bf16"], c["b1c"], c["b2c"], c["eps"], c["neg_lr"],
             launch.stream(device))
    launch.check_launch(err, "adam")
    launch.count(__name__)
