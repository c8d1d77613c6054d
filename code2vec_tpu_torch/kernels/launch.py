"""What every kernel wrapper shares: device dispatch, argument checks,
ctypes binding and error reporting.

A wrapper takes the plain PyTorch version only when every tensor it was
given lies on the CPU. CUDA tensors launch the kernel, and anything else
(a mix of devices, the meta device) raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from code2vec_tpu_torch.kernels import build

P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_int64


def runs_plain(*tensors: Optional[torch.Tensor]) -> bool:
    """True for all-CPU arguments, False for all-CUDA ones; raises
    otherwise."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"kernel wrappers take CPU tensors (plain version) or "
                     f"CUDA tensors (kernel), got devices {sorted(kinds)}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_tensor(t: torch.Tensor, name: str, dtypes: Sequence[torch.dtype],
                 ndim: int, align: int = 4) -> None:
    require(t.dtype in dtypes,
            f"{name}: dtype {t.dtype} not in {list(dtypes)}")
    require(t.dim() == ndim, f"{name}: expected {ndim} dims, got "
                             f"{tuple(t.shape)}")
    require(t.is_contiguous(), f"{name}: must be contiguous")
    require(t.data_ptr() % align == 0,
            f"{name}: data pointer not {align}-byte aligned")


def bind(lib_name: str, fn_name: str, argtypes, restype=I32):
    """The C entry point with its argtypes set. Every pointer (and the
    stream) is c_void_p: an unset argtype would pass a 64-bit pointer as
    a 32-bit int."""
    fn = getattr(build.load(lib_name), fn_name)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError "
                           f"{err}")


def shared_memory_limit(device: torch.device) -> int:
    props = torch.cuda.get_device_properties(device)
    return int(getattr(props, "shared_memory_per_block_optin", 232448))
