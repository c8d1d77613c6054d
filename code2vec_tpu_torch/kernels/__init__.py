"""Hand-written CUDA kernels of the serving and train paths, each beside
its plain PyTorch version and its launch count.

    K1 context_encoder            kernels/encoder.py           csrc/encoder.cu
    K2 masked_attention           kernels/attention.py         csrc/attention.cu
    K3 blockwise_topk             kernels/topk.py              csrc/topk.cu
    K4 label_logits               kernels/label_logits.py      csrc/label_logits.cu
    K5 encoder_backward           kernels/encoder_backward.py  csrc/encoder_backward.cu
    K6 masked_attention_backward  kernels/attention.py         csrc/attention_backward.cu
    K7 softmax_xent               kernels/softmax_xent.py      csrc/softmax_xent.cu
    K8 adam                       kernels/adam.py              csrc/adam.cu

Each wrapper adds one to its counter (`launches` of its module, or the
attribute KERNEL_COUNTERS names) where it launches its kernel, and
nowhere else.
"""

from __future__ import annotations

import importlib
from typing import Dict

KERNEL_MODULES = {
    "context_encoder": "code2vec_tpu_torch.kernels.encoder",
    "masked_attention": "code2vec_tpu_torch.kernels.attention",
    "blockwise_topk": "code2vec_tpu_torch.kernels.topk",
    "label_logits": "code2vec_tpu_torch.kernels.label_logits",
    "encoder_backward": "code2vec_tpu_torch.kernels.encoder_backward",
    "masked_attention_backward": "code2vec_tpu_torch.kernels.attention",
    "softmax_xent": "code2vec_tpu_torch.kernels.softmax_xent",
    "adam": "code2vec_tpu_torch.kernels.adam",
}
# counters other than the module's `launches`
KERNEL_COUNTERS = {"masked_attention_backward": "backward_launches"}

# the kernels every train step launches (K1 in train mode)
TRAIN_KERNELS = ("context_encoder", "masked_attention", "encoder_backward",
                 "masked_attention_backward", "softmax_xent", "adam")


def launch_counts() -> Dict[str, int]:
    return {name: getattr(importlib.import_module(mod),
                          KERNEL_COUNTERS.get(name, "launches"))
            for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for name, mod in KERNEL_MODULES.items():
        setattr(importlib.import_module(mod),
                KERNEL_COUNTERS.get(name, "launches"), 0)
