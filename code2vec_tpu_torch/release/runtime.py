"""Release-artifact runtime: the serving path on the card.

The counterpart of code2vec_tpu/release/runtime.py with the exact head
only. `ReleaseModel` loads an artifact (int8 + per-row scales, or f32)
onto one device and answers `predict` through the bucketed path of
model_facade.py. Its step runs four hand-written kernels on CUDA tensors
(the plain PyTorch versions on CPU tensors):

    K1 context_encoder   gather + dequant + concat + tanh(ctx @ W)
    K2 masked_attention  attention weights and code vectors
    K3 blockwise_topk    top-k and logsumexp over the target table
    K4 label_logits      each row's label logit, for the eval loss

The MIPS head, AOT lowerings and the head-crossover calibration of the
reference are not ported.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from code2vec_tpu_torch.kernels.attention import masked_attention
from code2vec_tpu_torch.kernels.encoder import context_encoder
from code2vec_tpu_torch.kernels.label_logits import label_logits
from code2vec_tpu_torch.kernels.topk import blockwise_topk
from code2vec_tpu_torch.model_facade import BucketedPredictMixin
from code2vec_tpu_torch.release.artifact import (
    QUANTIZED_SCHEMES, ArtifactError, ReleaseArtifact, load_artifact,
    require_ported_scheme,
)
from code2vec_tpu_torch.vocab import Code2VecVocabs
from code2vec_tpu_torch.weights import release_params_from_artifact

COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class EvalOutputs(NamedTuple):
    topk_values: torch.Tensor    # (B, k) f32
    topk_indices: torch.Tensor   # (B, k) int32
    code_vectors: torch.Tensor   # (B, D) f32
    attention: torch.Tensor      # (B, M) f32
    loss_sum: torch.Tensor       # () f32, CE summed over valid rows


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; CUDA must be present when it is
    asked for (no silent CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but "
                           "torch.cuda.is_available() is false; pass "
                           "--device cpu / device='cpu' to run on the CPU")
    return device


def make_release_step(meta: dict):
    """(params, src, pth, tgt, mask, labels, valid) -> EvalOutputs."""
    require_ported_scheme(meta["quantization"]["scheme"])
    dims = meta["dims"]
    quantized = meta["quantization"]["scheme"] in QUANTIZED_SCHEMES
    if meta["compute_dtype"] not in COMPUTE_DTYPES:
        raise ArtifactError("compute_dtype",
                            f"unsupported {meta['compute_dtype']!r}")
    compute_dtype = COMPUTE_DTYPES[meta["compute_dtype"]]
    real_v = int(dims["real_target_vocab_size"])
    k = min(int(meta["topk"]), real_v)
    raw_block = meta.get("topk_block_size")
    block = 4096 if raw_block is None else int(raw_block)
    if block <= 0:
        block = int(dims["target_vocab_size"])
    oov_floor = int(dims["target_oov_floor"])

    def scale(params, name):
        return params[f"{name}_scale"] if quantized else None

    def step(params, src, pth, tgt, mask, labels, valid) -> EvalOutputs:
        transformed = context_encoder(
            params["token_embedding"], scale(params, "token_embedding"),
            params["path_embedding"], scale(params, "path_embedding"),
            params["transform"], src, pth, tgt, compute_dtype=compute_dtype)
        code_vectors, attention = masked_attention(
            transformed, params["attention"][:, 0], mask)
        target, target_s = (params["target_embedding"],
                            scale(params, "target_embedding"))
        out = blockwise_topk(code_vectors, target, k, block, scales=target_s,
                             valid_rows=real_v, compute_dtype=compute_dtype)
        label_logit = label_logits(code_vectors, target, labels,
                                   scales=target_s,
                                   compute_dtype=compute_dtype)
        loss_rows = valid & (labels > oov_floor)
        ce = (out.lse - label_logit) * loss_rows.float()
        return EvalOutputs(out.values, out.indices, code_vectors, attention,
                           ce.sum())

    return step


class ReleaseModel(BucketedPredictMixin):
    """Serving model over a release artifact, on one device."""

    def __init__(self, config, artifact: Optional[ReleaseArtifact] = None,
                 log=None, device=None):
        self.config = config
        self.log = log or config.log
        self.device = resolve_device(device or config.device)
        self.artifact = artifact or load_artifact(config.serve_artifact)
        meta = self.meta = self.artifact.meta
        require_ported_scheme(self.artifact.scheme)
        # the artifact is authoritative for what shaped its export
        config.max_contexts = int(meta["max_contexts"])
        config.separate_oov_and_pad = bool(meta["separate_oov_and_pad"])
        if config.top_k_words_considered_during_prediction != \
                int(meta["topk"]):
            self.log(f"topk {config.top_k_words_considered_during_prediction}"
                     f" differs from the artifact's exported {meta['topk']}: "
                     f"the artifact is authoritative")
            config.top_k_words_considered_during_prediction = \
                int(meta["topk"])
        self.context_buckets: Tuple[int, ...] = tuple(
            int(b) for b in meta["buckets"])
        self.vocabs = Code2VecVocabs.load(
            self.artifact.dictionaries_path,
            separate_oov_and_pad=config.separate_oov_and_pad)
        self.params = release_params_from_artifact(self.artifact,
                                                   self.device)
        self._step_fn = make_release_step(meta)
        self._predict_steps: Dict[Tuple[int, int], object] = {}
        self.log(f"Release model loaded from {self.artifact.path} on "
                 f"{self.device}: scheme={self.artifact.scheme}, tables "
                 f"{self.artifact.table_bytes() / 1e6:.1f} MB, buckets "
                 f"{list(self.context_buckets)}, fingerprint "
                 f"{self.artifact.fingerprint[:12]}")

    def model_fingerprint(self) -> str:
        return f"artifact:{self.artifact.fingerprint[:16]}"

    def _make_predict_step(self, batch_rows: int, m: int):
        return self._step_fn

    @torch.no_grad()
    def _call_predict_step(self, step, arrays) -> EvalOutputs:
        return step(self.params, *arrays)

    def eval_step(self, *arrays) -> EvalOutputs:
        """The step on one device batch (src, pth, tgt, mask, labels,
        valid), all tensors on this model's device."""
        rows, m = arrays[0].shape
        return self._call_predict_step(
            self._get_bucketed_predict_step(rows, m), arrays)

    def dummy_batch(self, rows: int, m: int):
        """An all-padding batch of one serve shape."""
        i32 = dict(dtype=torch.int32, device=self.device)
        return (torch.zeros((rows, m), **i32), torch.zeros((rows, m), **i32),
                torch.zeros((rows, m), **i32),
                torch.ones((rows, m), dtype=torch.float32,
                           device=self.device),
                torch.zeros((rows,), **i32),
                torch.ones((rows,), dtype=torch.bool, device=self.device))

    def warmup(self, rows: Optional[int] = None) -> None:
        """Run every (rows, bucket) serve shape once on a dummy batch."""
        rows = int(rows or self.config.serve_batch_size)
        for m in self.context_buckets:
            self.eval_step(*self.dummy_batch(rows, m))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
