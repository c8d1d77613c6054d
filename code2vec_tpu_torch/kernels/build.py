"""Build the CUDA sources under csrc/ with nvcc and load them with ctypes.

Each `csrc/<name>.cu` becomes its own shared library with a plain C
interface, compiled for Hopper (`sm_90a`) at first use into `_build/`
beside this file (listed in .gitignore). Libraries are keyed by a hash of
their source, the shared headers and the flags, so an edited kernel is
rebuilt and an unchanged one is reused. `build_all()` starts one nvcc per
source at once and waits for all of them.

Nothing here runs at import time: a machine without nvcc imports the
package, runs the plain PyTorch versions on CPU tensors, and only a call
on a CUDA tensor reaches `load()`, which raises if the library cannot be
built.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, List, Optional

SOURCES = ("encoder", "attention", "topk", "label_logits",
           "encoder_backward", "attention_backward", "softmax_xent", "adam",
           "kmeans", "ivf_search", "sparse_adam", "select")
# csrc/gather_probe.cu is no kernel of the port: measurements that
# scripts/profile_torch_encoder_xent.py,
# scripts/profile_torch_sparse_adam_attention.py and
# scripts/profile_torch_label_logits.py build by name (`load`)
CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """A kernel library could not be built or loaded."""


def nvcc_path() -> Optional[str]:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    return default if os.path.isfile(default) else None


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in (f"{name}.cu", "common.cuh", "hopper.cuh"):
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_all(names: Iterable[str] = SOURCES) -> List[str]:
    """Compile every library that is not built yet, all nvcc processes in
    parallel; returns the library paths. Raises KernelBuildError with the
    compiler's output if any build fails."""
    names = list(names)
    paths = [library_path(n) for n in names]
    todo = [(n, p) for n, p in zip(names, paths) if not os.path.isfile(p)]
    if not todo:
        return paths
    nvcc = nvcc_path()
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (put the CUDA toolkit on PATH); "
            "the CUDA kernels cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name, path in todo:
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        procs.append((name, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, path, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}.cu (exit {proc.returncode}):\n"
                          f"{out.decode(errors='replace')}")
            continue
        os.replace(tmp, path)
    if errors:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            [path] = build_all([name])
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise KernelBuildError(f"cannot load {path}: {e}") from e
            _libs[name] = lib
    return lib


def timed_build_all() -> float:
    """Build every kernel library (parallel nvcc); returns seconds."""
    t0 = time.perf_counter()
    build_all()
    for name in SOURCES:
        load(name)
    return time.perf_counter() - t0
