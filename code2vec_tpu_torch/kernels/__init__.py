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
    K12 sparse_adam               kernels/sparse_adam.py       csrc/sparse_adam.cu
    K13 select_topk               kernels/select.py            csrc/select.cu
    K14 shard_gather,             kernels/sharded.py           csrc/sharded.cu
        shard_scatter_add,
        shard_local_ids
    K15 tp_softmax_xent           kernels/sharded.py           csrc/sharded.cu
    K16 cp_attention              kernels/cp_attention.py      csrc/cp_attention.cu
    K17 cp_attention_backward     kernels/cp_attention.py      csrc/cp_attention.cu

K3 has a float32-compute mode (the retrieval index's brute-force
search), counted apart as `blockwise_topk_f32`; K11's int8-row
instantiation (the MIPS head over an int8 classifier) is counted apart
from its f32-row one as `ivf_search_int8`. K5's row mode (the sparse
train step's row gradients) is counted apart as `encoder_backward_rows`.
K13 is the large-k mode of K3 and K11 (k above 64). K14-K17 are the
parallel steps' (training/step.py ParallelStepBuilder): each runs as
phases between collectives, and K15, K16 and K17 count every phase.

K1, K3, K4 and K11 read their tables in the stored format of a release
artifact: f32, int8, fp8 (e4m3 or e5m2) or packed int4. The fp8 and int4
modes are counted apart per kernel, as `<kernel>_fp8` (both fp8 formats)
and `<kernel>_int4`.

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
    "encoder_backward_rows": "code2vec_tpu_torch.kernels.encoder_backward",
    "sparse_adam": "code2vec_tpu_torch.kernels.sparse_adam",
    "select_topk": "code2vec_tpu_torch.kernels.select",
    "shard_gather": "code2vec_tpu_torch.kernels.sharded",
    "shard_scatter_add": "code2vec_tpu_torch.kernels.sharded",
    "shard_local_ids": "code2vec_tpu_torch.kernels.sharded",
    "tp_softmax_xent": "code2vec_tpu_torch.kernels.sharded",
    "cp_attention": "code2vec_tpu_torch.kernels.cp_attention",
    "cp_attention_backward": "code2vec_tpu_torch.kernels.cp_attention",
}
# the fp8 and int4 modes of the kernels that read a release artifact's
# tables
QUANT_MODE_KERNELS = ("context_encoder", "blockwise_topk", "label_logits",
                      "ivf_search")
for _kernel in QUANT_MODE_KERNELS:
    for _mode in ("fp8", "int4"):
        KERNEL_MODULES[f"{_kernel}_{_mode}"] = KERNEL_MODULES[_kernel]
# counters other than the module's `launches`
KERNEL_COUNTERS = {"masked_attention_backward": "backward_launches",
                   "kmeans_update": "update_launches",
                   "blockwise_topk_f32": "f32_launches",
                   "ivf_search_int8": "int8_launches",
                   "encoder_backward_rows": "rows_launches",
                   "shard_scatter_add": "scatter_launches",
                   "shard_local_ids": "local_ids_launches",
                   "tp_softmax_xent": "xent_launches",
                   "cp_attention_backward": "backward_launches",
                   **{f"{k}_{m}": f"{m}_launches"
                      for k in QUANT_MODE_KERNELS for m in ("fp8", "int4")}}

# the kernels every train step launches (K1 in train mode)
TRAIN_KERNELS = ("context_encoder", "masked_attention", "encoder_backward",
                 "masked_attention_backward", "softmax_xent", "adam")
# the kernels every sparse train step launches: K5's row mode in place
# of K5, K8 over the dense subtree, K12 once per table
SPARSE_TRAIN_KERNELS = ("context_encoder", "masked_attention",
                        "encoder_backward_rows", "masked_attention_backward",
                        "softmax_xent", "adam", "sparse_adam")
# the kernels of the parallel dense and sparse train steps on a mesh with
# tp > 1 (K14, K15) or cp > 1 (K16, K17; K2 and K6 at cp 1), beside the
# single-device steps' K1, K5's row mode, K8 and (sparse) K12
PARALLEL_TRAIN_KERNELS = ("shard_gather", "context_encoder",
                          "tp_softmax_xent", "encoder_backward_rows", "adam")
PARALLEL_DENSE_KERNELS = PARALLEL_TRAIN_KERNELS + ("shard_scatter_add",)
PARALLEL_SPARSE_KERNELS = PARALLEL_TRAIN_KERNELS + ("shard_local_ids",
                                                    "sparse_adam")
CP_KERNELS = ("cp_attention", "cp_attention_backward")
# the kernels of serving an artifact of a given scheme: K1-K4 in the
# tables' format (K2 has none)
SERVE_KERNELS = {
    "int8": ("context_encoder", "masked_attention", "blockwise_topk",
             "label_logits"),
    "fp8": ("context_encoder_fp8", "masked_attention", "blockwise_topk_fp8",
            "label_logits_fp8"),
    "int4": ("context_encoder_int4", "masked_attention",
             "blockwise_topk_int4", "label_logits_int4"),
}
# the kernels of k-means and the index and MIPS searches (K13 for k
# above 64)
RETRIEVAL_KERNELS = ("kmeans_assign", "kmeans_update", "ivf_search",
                     "ivf_search_int8", "blockwise_topk_f32", "select_topk")


def launch_counts() -> Dict[str, int]:
    return {name: getattr(importlib.import_module(mod),
                          KERNEL_COUNTERS.get(name, "launches"))
            for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for name, mod in KERNEL_MODULES.items():
        setattr(importlib.import_module(mod),
                KERNEL_COUNTERS.get(name, "launches"), 0)
