"""What every kernel wrapper shares: device dispatch, argument checks,
ctypes binding and error reporting.

A wrapper takes the plain PyTorch version only when every tensor it was
given lies on the CPU. CUDA tensors launch the kernel, and anything else
(a mix of devices, the meta device) raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import sys
import threading
from typing import Optional, Sequence

import torch

from code2vec_tpu_torch.kernels import build

P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_int64
U64 = ctypes.c_uint64
F32 = ctypes.c_float

_count_lock = threading.Lock()


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


# How a table's values are stored, as the kernels' C entry points name it
# (csrc/common.cuh c2v::TableFormat), named by the table's dtype: a uint8
# table is packed int4, two values a byte.
FMT_F32, FMT_INT8, FMT_E4M3, FMT_E5M2, FMT_INT4 = range(5)
_FORMAT_OF_DTYPE = {torch.float32: FMT_F32, torch.int8: FMT_INT8,
                    torch.float8_e4m3fn: FMT_E4M3,
                    torch.float8_e5m2: FMT_E5M2, torch.uint8: FMT_INT4}
# the launch counter of each format's instantiation, beside the module's
# `launches` (f32 and int8)
FORMAT_COUNTERS = {FMT_E4M3: "fp8_launches", FMT_E5M2: "fp8_launches",
                   FMT_INT4: "int4_launches"}


def table_format(table: torch.Tensor, name: str) -> int:
    """The format of a table tensor, which its dtype names: f32, int8,
    float8_e4m3fn, float8_e5m2, or uint8 for packed int4."""
    fmt = _FORMAT_OF_DTYPE.get(table.dtype)
    require(fmt is not None,
            f"{name}: dtype {table.dtype} is no table format (f32, int8, "
            f"float8_e4m3fn, float8_e5m2, uint8 packed int4)")
    return fmt


def stored_width(fmt: int, dim: int) -> int:
    """The columns of a `dim`-value row as stored: ceil(dim / 2) bytes for
    packed int4, else `dim`."""
    return (dim + 1) // 2 if fmt == FMT_INT4 else dim


def check_scales(scales: Optional[torch.Tensor], fmt: int, rows: int,
                 name: str) -> None:
    """A quantized table carries f32 (rows, 1) scales; an f32 one none."""
    if fmt == FMT_F32:
        require(scales is None, f"{name}: f32 tables take no scales")
        return
    require(scales is not None, f"{name}: quantized tables need scales")
    check_tensor(scales, name, [torch.float32], 2)
    require(tuple(scales.shape) == (rows, 1),
            f"{name}: expected ({rows}, 1)")


def format_counter(fmt: int) -> str:
    return FORMAT_COUNTERS.get(fmt, "launches")


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


def count(module: str, counter: str = "launches") -> None:
    """Add one to a wrapper's launch counter (an attribute of its module).
    The server launches kernels from its HTTP threads and its batcher
    thread at once, so the add holds a lock."""
    mod = sys.modules[module]
    with _count_lock:
        setattr(mod, counter, getattr(mod, counter) + 1)


def check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError "
                           f"{err}")


def shared_memory_limit(device: torch.device) -> int:
    props = torch.cuda.get_device_properties(device)
    return int(getattr(props, "shared_memory_per_block_optin", 232448))
