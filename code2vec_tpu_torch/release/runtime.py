"""Release-artifact runtime: the serving and evaluation path on the card.

The counterpart of code2vec_tpu/release/runtime.py with the exact head
and the MIPS head. `ReleaseModel` loads an artifact of any scheme (int8,
fp8 e4m3 or e5m2, or packed int4 tables with per-row scales, or f32)
onto one device, answers `predict` through the bucketed path of
model_facade.py and scores a labelled corpus with `evaluate`. Its step
runs four hand-written kernels on CUDA tensors (the plain PyTorch
versions on CPU tensors), each reading the tables in their stored
format:

    K1 context_encoder   gather + dequant + concat + tanh(ctx @ W)
    K2 masked_attention  attention weights and code vectors
    K3 blockwise_topk    top-k and logsumexp over the target table
    K4 label_logits      each row's label logit, for the eval loss

With `serve_mips_nprobe` > 0 an approximate-MIPS head (retrieval/mips.py,
kernel K11) replaces K3 and K4 for small batches, dispatched per batch
shape as code2vec_tpu/release/runtime.py:315-403 and :467-490 do. The
AOT lowerings and the export-time crossover calibration of the reference
(`calibrate_mips_crossover`) are not ported, nor its `obs` counters.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from code2vec_tpu_torch.model_facade import BucketedPredictMixin
from code2vec_tpu_torch.release.artifact import (
    QUANTIZED_SCHEMES, SCHEME_INT4, ArtifactError, ReleaseArtifact,
    load_artifact, table_dim,
)
from code2vec_tpu_torch.training.step import EvalOutputs, make_eval_step
from code2vec_tpu_torch.vocab import Code2VecVocabs
from code2vec_tpu_torch.weights import (
    release_params_from_artifact, table_tensor,
)

COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; CUDA must be present when it is
    asked for (no silent CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but "
                           "torch.cuda.is_available() is false; pass "
                           "--device cpu / device='cpu' to run on the CPU")
    return device


def make_release_step(meta: dict, mips_topk=None):
    """The eval step (training/step.py `make_eval_step`) over an
    artifact's tables, shaped by its meta; `mips_topk` as there. The
    kernels work out a packed int4 table's width from the operand it
    meets (runtime.py:91-150)."""
    dims = meta["dims"]
    if meta["compute_dtype"] not in COMPUTE_DTYPES:
        raise ArtifactError("compute_dtype",
                            f"unsupported {meta['compute_dtype']!r}")
    raw_block = meta.get("topk_block_size")
    return make_eval_step(
        real_target_vocab_size=int(dims["real_target_vocab_size"]),
        target_oov_floor=int(dims["target_oov_floor"]),
        compute_dtype=COMPUTE_DTYPES[meta["compute_dtype"]],
        topk=int(meta["topk"]),
        block_size=4096 if raw_block is None else int(raw_block),
        quantized=meta["quantization"]["scheme"] in QUANTIZED_SCHEMES,
        mips_topk=mips_topk)


class ReleaseModel(BucketedPredictMixin):
    """Serving model over a release artifact, on one device."""

    def __init__(self, config, artifact: Optional[ReleaseArtifact] = None,
                 log=None, device=None):
        self.config = config
        self.log = log or config.log
        self.device = resolve_device(device or config.device)
        self.artifact = artifact or load_artifact(config.serve_artifact)
        meta = self.meta = self.artifact.meta
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
        self._adopt_serve_batch_size()
        self.vocabs = Code2VecVocabs.load(
            self.artifact.dictionaries_path,
            separate_oov_and_pad=config.separate_oov_and_pad)
        self._resolve_mips_dispatch()
        # all-MIPS never runs the exact head, and the head holds its own
        # list-ordered copy of the target table: keep the original off
        # the device
        self.params = release_params_from_artifact(
            self.artifact, self.device,
            skip=("target_embedding",) if self._mips_all else ())
        self._step_fn = make_release_step(meta)
        self._predict_steps: Dict[Tuple[int, int], object] = {}
        self.head_dispatches = {"exact": 0, "mips": 0}
        self.mips_head = None
        self._mips_step = None
        if self.mips_nprobe > 0:
            self._build_mips_head()
        self.log(f"Release model loaded from {self.artifact.path} on "
                 f"{self.device}: scheme={self.artifact.scheme}, tables "
                 f"{self.artifact.table_bytes() / 1e6:.1f} MB, buckets "
                 f"{list(self.context_buckets)}, fingerprint "
                 f"{self.artifact.fingerprint[:12]}")

    def _adopt_serve_batch_size(self) -> None:
        """A config that holds the default serve_batch_size, with no
        --serve_batch_size on the command line, takes the artifact's
        (code2vec_tpu/release/runtime.py:275-300); an explicit size
        always wins, even one equal to the default."""
        config = self.config
        art_rows = int(self.meta["serve_batch_size"])
        if config.serve_batch_size == art_rows:
            return
        default_rows = type(config).__dataclass_fields__[
            "serve_batch_size"].default
        explicit = "serve_batch_size" in config.explicit_knobs
        if config.serve_batch_size == default_rows and not explicit:
            self.log(f"adopting the artifact's serve_batch_size {art_rows} "
                     f"(config held the default {default_rows})")
            config.serve_batch_size = art_rows
        else:
            self.log(f"serve_batch_size {config.serve_batch_size} differs "
                     f"from the artifact's {art_rows}")

    def _resolve_mips_dispatch(self) -> None:
        """Batch-shape head dispatch: batches with <= mips_rows live rows
        take the MIPS head. Crossover -1 adopts the artifact's calibrated
        `mips_crossover`, or all-MIPS when it has none; 0 means exact
        only; a crossover at or above the serve batch is all-MIPS."""
        config = self.config
        self.mips_nprobe = int(config.serve_mips_nprobe or 0)
        crossover = int(config.serve_mips_crossover)
        self.mips_rows = 0
        self._mips_all = False
        if self.mips_nprobe <= 0:
            return
        if crossover == 0:
            self.mips_nprobe = 0
            return
        if crossover < 0:
            calibrated = int(self.meta.get("mips_crossover", 0) or 0)
            if calibrated > 0:
                self.mips_rows = calibrated
            else:
                self._mips_all = True
        else:
            self.mips_rows = crossover
        if self.mips_rows >= int(config.serve_batch_size):
            self._mips_all, self.mips_rows = True, 0

    def _build_mips_head(self) -> None:
        from code2vec_tpu_torch.retrieval.mips import MipsHead
        dims = self.meta["dims"]
        if self.artifact.scheme == SCHEME_INT4 and \
                table_dim(dims, "target_embedding") % 2:
            raise ArtifactError("target_embedding",
                                "the MIPS head takes int4 target rows of "
                                "even width (two values a byte)")
        scale = self.artifact.tables.get("target_embedding.scale")
        # the host table in the dtype that names its format (fp8 viewed
        # from its bytes, int4 packed), as runtime.py:362-386 builds it
        self.mips_head = MipsHead.build(
            table_tensor(self.artifact, "target_embedding"),
            None if scale is None else np.asarray(scale),
            real_vocab=int(dims["real_target_vocab_size"]),
            nlist=int(self.config.serve_mips_nlist or 0),
            nprobe=self.mips_nprobe,
            seed=int(self.config.seed), log=self.log, device=self.device)
        k = min(int(self.meta["topk"]), int(dims["real_target_vocab_size"]))
        self._mips_step = make_release_step(
            self.meta,
            mips_topk=self.mips_head.topk_fn(k, self.mips_nprobe))
        mode = ("all batches" if self._mips_all
                else f"batches with <= {self.mips_rows} live rows (exact "
                     f"blockwise head above)")
        self.log(f"Approximate-MIPS head active for {mode}: nprobe "
                 f"{self.mips_head.nprobe}/{self.mips_head.nlist} lists per "
                 f"prediction")

    def model_fingerprint(self) -> str:
        return f"artifact:{self.artifact.fingerprint[:16]}"

    @property
    def code_vector_size(self) -> int:
        dims = self.meta["dims"]
        return int(dims["path_dim"]) + 2 * int(dims["token_dim"])

    def _make_predict_step(self, batch_rows: int, m: int):
        return self._mips_step if self._mips_all else self._step_fn

    def _dispatch_predict_step(self, n: int, batch_rows: int, m: int):
        """Batches with at most `mips_rows` live rows take the MIPS head
        at that row count (small batches pad to it, not to the serve
        batch); the rest take the exact head at the serve shape."""
        if self._mips_all:
            head = "mips"
            step, rows = self._get_bucketed_predict_step(batch_rows, m), \
                batch_rows
        elif 0 < n <= self.mips_rows:
            head = "mips"
            step, rows = self._mips_step, self.mips_rows
        else:
            head = "exact"
            step, rows = self._get_bucketed_predict_step(batch_rows, m), \
                batch_rows
        self.head_dispatches[head] += 1
        return step, rows, head

    @torch.no_grad()
    def _call_predict_step(self, step, arrays) -> EvalOutputs:
        return step(self.params, *arrays)

    def eval_step(self, *arrays) -> EvalOutputs:
        """The step on one device batch (src, pth, tgt, mask, labels,
        valid), all tensors on this model's device."""
        rows, m = arrays[0].shape
        return self._call_predict_step(
            self._get_bucketed_predict_step(rows, m), arrays)

    def eval_callable(self):
        """(eval_step, params), the reference's surface for code that runs
        the eval step itself (retrieval/embed_job.py): the step takes the
        params slot first and ignores it, since the artifact's params are
        bound."""
        def step(_params_unused, *arrays) -> EvalOutputs:
            return self.eval_step(*arrays)
        return step, None

    def evaluate(self, log_path: Optional[str] = "log.txt",
                 prefetch: bool = True):
        """Score the artifact on config.test_data_path with the reference
        metrics (runtime.py:522-533): top-k accuracy, subtoken precision,
        recall and F1, and the mean CE over rows with an in-vocabulary
        label; the per-example outcomes go to `log_path` (None: none)."""
        from code2vec_tpu_torch.evaluation.evaluator import Evaluator
        config = self.config
        config.num_test_examples = self._count_examples(
            config.test_data_path)
        self.log(f"Number of test examples: {config.num_test_examples}")
        eval_step, params = self.eval_callable()
        evaluator = Evaluator(config, self.vocabs, eval_step, self.device,
                              log_path=log_path)
        return evaluator.evaluate(params, self._eval_batches(),
                                  prefetch=prefetch)

    def _warm_shape(self, rows: int, m: int) -> None:
        self.eval_step(*self.dummy_batch(rows, m))
        if self.mips_rows > 0:
            self._call_predict_step(self._mips_step,
                                    self.dummy_batch(self.mips_rows, m))
