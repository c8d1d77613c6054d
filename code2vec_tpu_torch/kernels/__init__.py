"""Hand-written CUDA kernels of the serving path, each beside its plain
PyTorch version and its launch count.

    K1 context_encoder   kernels/encoder.py       csrc/encoder.cu
    K2 masked_attention  kernels/attention.py     csrc/attention.cu
    K3 blockwise_topk    kernels/topk.py          csrc/topk.cu
    K4 label_logits      kernels/label_logits.py  csrc/label_logits.cu

Each wrapper adds one to its module's `launches` where it launches its
kernel, and nowhere else.
"""

from __future__ import annotations

import importlib
from typing import Dict

KERNEL_MODULES = {
    "context_encoder": "code2vec_tpu_torch.kernels.encoder",
    "masked_attention": "code2vec_tpu_torch.kernels.attention",
    "blockwise_topk": "code2vec_tpu_torch.kernels.topk",
    "label_logits": "code2vec_tpu_torch.kernels.label_logits",
}


def launch_counts() -> Dict[str, int]:
    return {name: importlib.import_module(mod).launches
            for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES.values():
        importlib.import_module(mod).launches = 0
