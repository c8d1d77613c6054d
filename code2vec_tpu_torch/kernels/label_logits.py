"""K4 label_logits: the logit of each row's own label.

Replaces code2vec_tpu/ops/topk.py gathered_label_logits (:182-202). The
CUDA source is csrc/label_logits.cu; what bounds it on an H100 and how its
design answers that is written at the top of that file. The plain version
is ops/topk.py gathered_label_logits: CPU tensors take it, CUDA tensors
launch the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from code2vec_tpu_torch.kernels import launch
from code2vec_tpu_torch.ops.topk import gathered_label_logits

launches = 0
_fns = {}

label_logits_plain = gathered_label_logits


def _fn():
    fn = _fns.get("label_logits")
    if fn is None:
        P, I32, I64 = launch.P, launch.I32, launch.I64
        fn = _fns["label_logits"] = launch.bind(
            "label_logits", "c2v_label_logits",
            [P, I32, I32, P, P, I32, I64, P, P, P])
    return fn


def label_logits(code_vectors: torch.Tensor, target_table: torch.Tensor,
                 labels: torch.Tensor, *,
                 scales: Optional[torch.Tensor] = None,
                 compute_dtype: torch.dtype = torch.bfloat16
                 ) -> torch.Tensor:
    """(B,) f32 logit of each row's label; non-finite -> -1e30."""
    if launch.runs_plain(code_vectors, target_table, labels, scales):
        return label_logits_plain(code_vectors, target_table, labels,
                                  scales=scales, compute_dtype=compute_dtype)
    fn = _fn()  # builds the library first: raises where nvcc is missing
    launch.require(compute_dtype == torch.bfloat16,
                   f"label_logits kernel computes in bfloat16, "
                   f"not {compute_dtype}")
    launch.check_tensor(code_vectors, "code_vectors", [torch.float32], 2)
    b, d = code_vectors.shape
    int8 = target_table.dtype == torch.int8
    launch.check_tensor(target_table, "target_table",
                        [torch.int8] if int8 else [torch.float32], 2)
    launch.require(target_table.shape[1] == d,
                   f"target_table: expected {d} columns")
    v = target_table.shape[0]
    if int8:
        launch.require(scales is not None, "int8 tables need scales")
        launch.check_tensor(scales, "scales", [torch.float32], 2)
        launch.require(tuple(scales.shape) == (v, 1),
                       f"scales: expected ({v}, 1)")
    else:
        launch.require(scales is None, "f32 tables take no scales")
    launch.check_tensor(labels, "labels", [torch.int32], 1)
    launch.require(labels.shape[0] == b, f"labels: expected ({b},)")
    out = torch.empty((b,), dtype=torch.float32, device=code_vectors.device)
    err = fn(code_vectors.data_ptr(), b, d, target_table.data_ptr(),
             launch.ptr(scales), int(int8), v, labels.data_ptr(),
             out.data_ptr(), launch.stream(code_vectors.device))
    launch.check_launch(err, "label_logits")
    launch.count(__name__)
    return out
