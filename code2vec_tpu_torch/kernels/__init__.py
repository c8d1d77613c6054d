"""Hand-written CUDA kernels of the serving, train and retrieval paths,
each beside its plain PyTorch version and its launch count.

    K1 context_encoder            kernels/encoder.py           csrc/encoder.cu
    K2 masked_attention           kernels/attention.py         csrc/attention.cu
    K3 blockwise_topk             kernels/topk.py              csrc/topk.cu
    K4 label_logits               kernels/label_logits.py      csrc/label_logits.cu
    K5 encoder_backward           kernels/encoder_backward.py  csrc/encoder_backward.cu
    K6 masked_attention_backward  kernels/attention.py         csrc/attention_backward.cu
    K7 softmax_xent               kernels/softmax_xent.py      csrc/softmax_xent.cu
    K8 adam                       kernels/adam.py              csrc/adam.cu
    K9 kmeans_assign              kernels/kmeans.py            csrc/kmeans.cu
    K10 kmeans_update             kernels/kmeans.py            csrc/kmeans.cu
    K11 ivf_search                kernels/ivf.py               csrc/ivf_search.cu

K3 has a float32-compute mode (the retrieval index's brute-force
search), counted apart as `blockwise_topk_f32`; K11's int8-row
instantiation (the MIPS head over an int8 classifier) is counted apart
from its f32-row one as `ivf_search_int8`.

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
    "kmeans_assign": "code2vec_tpu_torch.kernels.kmeans",
    "kmeans_update": "code2vec_tpu_torch.kernels.kmeans",
    "ivf_search": "code2vec_tpu_torch.kernels.ivf",
    "ivf_search_int8": "code2vec_tpu_torch.kernels.ivf",
    "blockwise_topk_f32": "code2vec_tpu_torch.kernels.topk",
}
# counters other than the module's `launches`
KERNEL_COUNTERS = {"masked_attention_backward": "backward_launches",
                   "kmeans_update": "update_launches",
                   "blockwise_topk_f32": "f32_launches",
                   "ivf_search_int8": "int8_launches"}

# the kernels every train step launches (K1 in train mode)
TRAIN_KERNELS = ("context_encoder", "masked_attention", "encoder_backward",
                 "masked_attention_backward", "softmax_xent", "adam")
# the kernels of k-means and the index and MIPS searches
RETRIEVAL_KERNELS = ("kmeans_assign", "kmeans_update", "ivf_search",
                     "ivf_search_int8", "blockwise_topk_f32")


def launch_counts() -> Dict[str, int]:
    return {name: getattr(importlib.import_module(mod),
                          KERNEL_COUNTERS.get(name, "launches"))
            for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for name, mod in KERNEL_MODULES.items():
        setattr(importlib.import_module(mod),
                KERNEL_COUNTERS.get(name, "launches"), 0)
