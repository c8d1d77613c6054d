"""The port stands alone: it imports nothing of JAX or of code2vec_tpu,
its CUDA wrappers never fall back to their plain versions, and
chip_smoke.py refuses to run without a GPU or without the repo."""

import ast
import os
import pkgutil
import shutil
import subprocess
import sys

import pytest
import torch

import code2vec_tpu_torch
from code2vec_tpu_torch import kernels
from code2vec_tpu_torch.kernels import build

pytestmark = pytest.mark.torch_port
# the shapes are tiny; one intra-op thread leaves the CPU cores to the
# other pytest workers
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(os.path.abspath(code2vec_tpu_torch.__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "orbax",
             "code2vec_tpu")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG_DIR], prefix="code2vec_tpu_torch."))


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py"),
           os.path.join(REPO, "scripts", "profile_torch_kernels.py"),
           os.path.join(REPO, "scripts", "profile_torch_train.py")]
    for root, _, files in os.walk(PKG_DIR):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _clean_env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = REPO
    return env


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "code2vec_tpu_torch.serving.server" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=_clean_env(), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_import_in_source(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def _cuda_calls():
    """One call per CUDA wrapper, on fake CUDA tensors (no storage)."""
    from code2vec_tpu_torch.kernels.adam import AdamHyper, adam
    from code2vec_tpu_torch.kernels.attention import (
        masked_attention, masked_attention_backward,
    )
    from code2vec_tpu_torch.kernels.encoder import context_encoder
    from code2vec_tpu_torch.kernels.encoder_backward import (
        encoder_backward, encoder_backward_rows,
    )
    from code2vec_tpu_torch.kernels.label_logits import label_logits
    from code2vec_tpu_torch.kernels.softmax_xent import softmax_xent
    from code2vec_tpu_torch.kernels.ivf import ivf_search
    from code2vec_tpu_torch.kernels.kmeans import kmeans_assign, kmeans_update
    from code2vec_tpu_torch.kernels.select import select_topk
    from code2vec_tpu_torch.kernels.sparse_adam import sparse_adam
    from code2vec_tpu_torch.kernels.topk import blockwise_topk
    from code2vec_tpu_torch.training.sparse_adam import RowAdamSlots

    def t(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="cuda")

    phases = _parallel_phase_calls()
    return {
        "shard_gather": phases["shard_gather"],
        "shard_scatter_add": phases["shard_scatter_add"],
        "shard_local_ids": phases["shard_local_ids"],
        "tp_softmax_xent": phases["tp_xent_stats"],
        "cp_attention": phases["cp_attention_scores"],
        "cp_attention_backward": phases["cp_attention_backward_fs"],
        "context_encoder": lambda: context_encoder(
            t((50, 128), torch.int8), t((50, 1)), t((40, 128), torch.int8),
            t((40, 1)), t((384, 384)), t((2, 3), torch.int32),
            t((2, 3), torch.int32), t((2, 3), torch.int32)),
        "masked_attention": lambda: masked_attention(
            t((2, 3, 384), torch.bfloat16), t((384,)), t((2, 3))),
        "blockwise_topk": lambda: blockwise_topk(
            t((2, 384)), t((70, 384), torch.int8), 10, 4096,
            scales=t((70, 1))),
        "label_logits": lambda: label_logits(
            t((2, 384)), t((70, 384), torch.int8), t((2,), torch.int32),
            scales=t((70, 1))),
        "encoder_backward": lambda: encoder_backward(
            t((2, 3, 384), torch.bfloat16), t((2, 3, 384), torch.bfloat16),
            t((2, 3, 384), torch.bfloat16), t((50, 128)), t((40, 128)), t((384, 384)),
            t((2, 3), torch.int32), t((2, 3), torch.int32),
            t((2, 3), torch.int32)),
        "encoder_backward_rows": lambda: encoder_backward_rows(
            t((2, 3, 384), torch.bfloat16), t((2, 3, 384), torch.bfloat16),
            t((2, 3, 384), torch.bfloat16), t((50, 128)), t((40, 128)),
            t((384, 384)), t((2, 3), torch.int32), t((2, 3), torch.int32),
            t((2, 3), torch.int32)),
        "sparse_adam": lambda: sparse_adam(
            t((50, 128)), RowAdamSlots(mu=t((50, 128), torch.bfloat16),
                                       nu=t((50, 128))),
            t((12,), torch.int32), t((12, 128), torch.bfloat16), t=1,
            lr=1e-3, b1=0.9, b2=0.999, eps=1e-8),
        "select_topk": lambda: select_topk(t((2, 100)), 70),
        "masked_attention_backward": lambda: masked_attention_backward(
            t((2, 3, 384), torch.bfloat16), t((384,)), t((2, 3)), t((2, 3)),
            t((2, 384))),
        "softmax_xent": lambda: softmax_xent(
            t((2, 70)), t((2,), torch.int32), t((2,))),
        "adam": lambda: adam([t((5, 4))], [t((5, 4))],
                             [t((5, 4), torch.bfloat16)],
                             [t((5, 4), torch.bfloat16)], 1, AdamHyper()),
        "blockwise_topk_f32": lambda: blockwise_topk(
            t((2, 384)), t((70, 384)), 10, 4096,
            compute_dtype=torch.float32),
        "kmeans_assign": lambda: kmeans_assign(t((50, 384)), t((7, 384))),
        "kmeans_update": lambda: kmeans_update(
            t((50, 384)), t((50,), torch.int32), t((7, 384))),
        "ivf_search": lambda: ivf_search(
            t((2, 384)), t((7, 384)), t((50, 384)), t((8,), torch.int64),
            3, 10, max_len=20),
        "ivf_search_int8": lambda: ivf_search(
            t((2, 384)), t((7, 384)), t((50, 384), torch.int8),
            t((8,), torch.int64), 3, 10, scales=t((50,)),
            global_ids=t((50,), torch.int32), max_len=20),
        # the fp8 and int4 modes (an fp8 table is a float8 tensor, an int4
        # one packed uint8, two values a byte)
        "context_encoder_fp8": lambda: context_encoder(
            t((50, 128), torch.float8_e4m3fn), t((50, 1)),
            t((40, 128), torch.float8_e4m3fn), t((40, 1)), t((384, 384)),
            t((2, 3), torch.int32), t((2, 3), torch.int32),
            t((2, 3), torch.int32)),
        "context_encoder_int4": lambda: context_encoder(
            t((50, 64), torch.uint8), t((50, 1)), t((40, 64), torch.uint8),
            t((40, 1)), t((384, 384)), t((2, 3), torch.int32),
            t((2, 3), torch.int32), t((2, 3), torch.int32)),
        "blockwise_topk_fp8": lambda: blockwise_topk(
            t((2, 384)), t((70, 384), torch.float8_e5m2), 10, 4096,
            scales=t((70, 1))),
        "blockwise_topk_int4": lambda: blockwise_topk(
            t((2, 384)), t((70, 192), torch.uint8), 10, 4096,
            scales=t((70, 1))),
        "label_logits_fp8": lambda: label_logits(
            t((2, 384)), t((70, 384), torch.float8_e4m3fn),
            t((2,), torch.int32), scales=t((70, 1))),
        "label_logits_int4": lambda: label_logits(
            t((2, 384)), t((70, 192), torch.uint8), t((2,), torch.int32),
            scales=t((70, 1))),
        "ivf_search_fp8": lambda: ivf_search(
            t((2, 384)), t((7, 384)), t((50, 384), torch.float8_e5m2),
            t((8,), torch.int64), 3, 10, scales=t((50,)),
            global_ids=t((50,), torch.int32), max_len=20),
        "ivf_search_int4": lambda: ivf_search(
            t((2, 384)), t((7, 384)), t((50, 192), torch.uint8),
            t((8,), torch.int64), 3, 10, scales=t((50,)),
            global_ids=t((50,), torch.int32), max_len=20),
    }


def _parallel_phase_calls():
    """One call per wrapper of K14-K17's phases and of K13's merge of the
    tp x k candidates, on fake CUDA tensors."""
    from code2vec_tpu_torch.kernels import cp_attention as k16
    from code2vec_tpu_torch.kernels import select
    from code2vec_tpu_torch.kernels import sharded as k15

    def t(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="cuda")

    i32 = torch.int32
    return {
        "shard_gather": lambda: k15.shard_gather(
            t((50, 128)), t((2, 3), i32), 50),
        "shard_scatter_add": lambda: k15.shard_scatter_add(
            t((50, 128)), t((6,), i32), t((6, 128), torch.bfloat16), 50),
        "shard_local_ids": lambda: k15.shard_local_ids(
            t((6,), i32), 50, 50),
        "tp_xent_stats": lambda: k15.tp_xent_stats(
            t((2, 70)), 70, 65, t((2,), i32), 70),
        "tp_xent_grad": lambda: k15.tp_xent_grad(
            t((2, 70)), 65, t((2,)), t((2,)), t((2,), i32), t((2,)), 70,
            4),
        "cp_attention_scores": lambda: k16.cp_attention_scores(
            t((2, 3, 384), torch.bfloat16), t((384,)), t((2, 3))),
        "cp_attention_combine": lambda: k16.cp_attention_combine(
            t((2, 3, 384), torch.bfloat16), t((2, 3)), t((2,)), t((2,))),
        "cp_attention_backward_fs": lambda: k16.cp_attention_backward_fs(
            t((2, 3, 384), torch.bfloat16), t((2, 3)), t((2, 3)),
            t((2, 384))),
        "cp_attention_backward_dt": lambda: k16.cp_attention_backward_dt(
            t((384,)), t((2, 3)), t((2, 3)), t((2, 3)), t((2,)),
            t((2, 384)), t((2, 2, 384))),
        "merge_topk": lambda: select.merge_topk(
            t((2, 3, 10)), t((2, 3, 10), i32), 10),
    }


PARALLEL_PHASES = ("shard_gather", "shard_scatter_add", "shard_local_ids",
                   "tp_xent_stats", "tp_xent_grad",
                   "cp_attention_scores", "cp_attention_combine",
                   "cp_attention_backward_fs", "cp_attention_backward_dt",
                   "merge_topk")


@pytest.mark.parametrize("name", PARALLEL_PHASES)
def test_parallel_phase_wrapper_raises_without_kernel_library(
        name, tmp_path, monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from code2vec_tpu_torch.kernels import cp_attention, select, sharded
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "empty"))
    monkeypatch.setattr(build, "nvcc_path", lambda: None)
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(sharded, "_fns", {})
    monkeypatch.setattr(cp_attention, "_fns", {})
    monkeypatch.setattr(select, "_fns", {})
    before = kernels.launch_counts()
    with FakeTensorMode():
        with pytest.raises(build.KernelBuildError, match="nvcc not found"):
            _parallel_phase_calls()[name]()
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("name", sorted(kernels.KERNEL_MODULES))
def test_cuda_wrapper_raises_without_kernel_library(name, tmp_path,
                                                    monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "empty"))
    monkeypatch.setattr(build, "nvcc_path", lambda: None)
    monkeypatch.setattr(build, "_libs", {})
    mod = __import__(kernels.KERNEL_MODULES[name], fromlist=["_fns"])
    monkeypatch.setattr(mod, "_fns", {})
    before = kernels.launch_counts()
    with FakeTensorMode():
        call = _cuda_calls()[name]
        with pytest.raises(build.KernelBuildError, match="nvcc not found"):
            call()
    assert kernels.launch_counts() == before


def test_mixed_devices_are_refused():
    from code2vec_tpu_torch.kernels.attention import masked_attention
    with pytest.raises(ValueError, match="devices"):
        masked_attention(torch.zeros(1, 2, 16, device="meta"),
                         torch.zeros(16), torch.ones(1, 2))


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_refuses_without_gpu_or_repo(alone, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the refusal is for hosts without")
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        cwd, script = str(tmp_path), str(tmp_path / "chip_smoke.py")
    env = _clean_env()
    env.pop("PYTHONPATH")
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
