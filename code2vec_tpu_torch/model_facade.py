"""The model facade: training (`Code2VecModel`) and the bucketed predict
path (`BucketedPredictMixin`).

`Code2VecModel` is the counterpart of code2vec_tpu/model_facade.py
Code2VecModel on one process and device: `--load` resolution and
restore (:418-527, vocabularies from the checkpoint's
`dictionaries.bin`), `_train_batches` (:557-640: by default the packed
`.c2vb` beside `<data>.train.c2v`, or the shards of
`--train_corpus_manifest` (`_train_corpus` :129-154), each epoch a
permutation keyed by (seed, absolute epoch); with `--no_packed_data`
the text reader), `train` with the epoch saves and their rotation
(:690-870), `evaluate` / `_evaluate_with_params` with `--release` and
the code-vector outputs (:877-940), predict over the live params with
the exact head or, with --serve_mips_nprobe, the MIPS head built over
the live target table (`_get_mips_topk` :945-998), the model
fingerprint, the final `save` and the word2vec exports (:1010-1062).
Left out: the async committer, preemption and mid-epoch cursors (nothing
sets `iter_batches`' `skip_rows` yet) and the training `obs` metrics.

On a dp x tp x cp mesh (config.mesh_size > 1; the reference's mesh parts
:458-469, :536, :565) each process is one rank: it joins the runtime
(parallel/distributed.py), pads the dims to tp, draws the whole
parameters from the seed and keeps its shards, and trains with the
parallel steps (training/step.py ParallelStepBuilder). Every rank reads
the same global batches (the same seeded shuffle of the `.c2vb`) and
keeps its (data, ctx) part; the epoch-end evaluation with --test runs
the parallel eval step and sums the counters over the mesh. Rank 0 alone
logs and writes the evaluation log. `--save`/`--load` on a mesh are
refused (config.py).

The predict part is the counterpart of BucketedPredictMixin (:66-395):
line parsing, context bucketing, row padding, the (rows, bucket) step
cache, the host-side assembly of results, the zero-copy slot surface of
the continuous batcher (`alloc_predict_batch`, `parse_lines_into`,
`predict_parsed` :290-341) and `serving_head_dispatch_total{head}`
(:56-63). The serving batchers call it from several threads at once, so
the step cache, the head counts and the lazy MIPS head build hold a
lock; with the eval-batch
plumbing that ReleaseModel shares (`_count_examples` :88-107, the
memoised `_packed_dataset` :109-128, which packs a `.c2v` once beside
itself, and `_eval_batches` :167-190, packed or text). Each device batch
is padded to a fixed row count and its context axis cut to the smallest
bucket that holds its deepest valid context, so the shapes the kernels
see are bounded by len(buckets) per row count.
"""

from __future__ import annotations

import glob
import itertools
import os
import shutil
import threading
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from code2vec_tpu_torch import obs
from code2vec_tpu_torch.common import count_lines_in_file, save_word2vec_file
from code2vec_tpu_torch.data.packed import (
    PackedDataset, ShardedCorpus, pack_c2v,
)
from code2vec_tpu_torch.data.reader import (
    EstimatorAction, PathContextReader, RowBatch, _pad_rows,
    empty_predict_batch, parse_context_lines, slice_contexts, truncate_rows,
)
from code2vec_tpu_torch.models.code2vec import Code2VecModule, ModelDims
from code2vec_tpu_torch.serving.batcher import bucket_for, parse_buckets
from code2vec_tpu_torch.training import checkpoint as ckpt
from code2vec_tpu_torch.training.loop import Trainer
from code2vec_tpu_torch.training.state import (
    DTYPES, create_train_state, make_optimizer, num_params,
)
from code2vec_tpu_torch.training.step import TrainStepBuilder, dropout_seed
from code2vec_tpu_torch.vocab import Code2VecVocabs, VocabType


class ModelPredictionResults(NamedTuple):
    original_name: str
    topk_predicted_words: List[str]
    topk_predicted_words_scores: np.ndarray
    attention_per_context: Dict[Tuple[str, str, str], float]
    code_vector: Optional[np.ndarray] = None


def _head_dispatch_counter(head: str):
    return obs.counter(
        "serving_head_dispatch_total",
        "device predict batches routed per retrieval head "
        "(head=exact|mips; batch-shape-aware dispatch)", head=head)


class BucketedPredictMixin:
    """Requires on the host class: config, log, vocabs, device,
    context_buckets, _predict_steps (dict), `_make_predict_step(rows, m)`
    and `_call_predict_step(step, arrays)`."""

    @property
    def _predict_lock(self) -> threading.RLock:
        """Guards the step cache, the head counts and the lazy MIPS head
        build against the batchers' concurrent device calls (dict
        setdefault is atomic, so the first use creates exactly one)."""
        return self.__dict__.setdefault("_predict_lock_obj",
                                        threading.RLock())

    def _make_predict_step(self, batch_rows: int, m: int):
        raise NotImplementedError

    def _call_predict_step(self, step, arrays):
        raise NotImplementedError

    def model_fingerprint(self) -> str:
        raise NotImplementedError

    def _get_bucketed_predict_step(self, batch_rows: int, m: int):
        key = (batch_rows, m)
        step = self._predict_steps.get(key)
        if step is None:
            with self._predict_lock:
                step = self._predict_steps.get(key)
                if step is None:
                    step = self._make_predict_step(batch_rows, m)
                    self._predict_steps[key] = step
                    self.log(f"Built predict step for shape (rows="
                             f"{batch_rows}, contexts={m}) "
                             f"[{len(self._predict_steps)} of <= "
                             f"{len(self.context_buckets)} buckets]")
        return step

    def predict_compile_count(self) -> int:
        """Distinct (rows, bucket) predict shapes seen so far."""
        return len(self._predict_steps)

    def _default_predict_batch_size(self) -> int:
        return int(self.config.serve_batch_size)

    @staticmethod
    def _count_examples(dataset_path: str) -> int:
        """Lines of a `.c2v` file, cached in a `.num_examples` sidecar
        beside it, as the reference caches them; the packed header's row
        count where a fused compile left no text."""
        sidecar = dataset_path + ".num_examples"
        if os.path.isfile(sidecar):
            with open(sidecar) as f:
                return int(f.readline())
        if not os.path.exists(dataset_path) and os.path.exists(
                dataset_path + "b"):
            return PackedDataset.read_header(dataset_path + "b")[0]
        n = count_lines_in_file(dataset_path)
        try:
            with open(sidecar, "w") as f:
                f.write(str(n))
        except OSError:
            pass
        return n

    def _packed_dataset(self, c2v_path: str) -> PackedDataset:
        """The `.c2vb` beside `c2v_path`, packed on first use; memoised,
        so the row filter scans the file once per model."""
        cached = self.__dict__.setdefault("_packed_cache", {})
        if c2v_path in cached:
            return cached[c2v_path]
        packed_path = c2v_path + "b"
        if not os.path.exists(packed_path):
            self.log(f"Packing {c2v_path} -> {packed_path} (one-time)")
            pack_c2v(c2v_path, self.vocabs, self.config.max_contexts,
                     out_path=packed_path,
                     num_workers=self.config.preprocess_workers)
        cached[c2v_path] = ds = PackedDataset(packed_path, self.vocabs)
        return ds

    def _eval_batches(self) -> Iterable:
        """The Evaluate stream over config.test_data_path: file order,
        rows with no valid context dropped, the tail batch padded with
        invalid rows, each row's method name kept; from the packed file
        unless --no_packed_data."""
        config = self.config
        if config.use_packed_data:
            return self._packed_dataset(config.test_data_path).iter_batches(
                config.test_batch_size, EstimatorAction.Evaluate,
                with_target_strings=True)
        return PathContextReader(self.vocabs, config,
                                 EstimatorAction.Evaluate,
                                 batch_size=config.test_batch_size,
                                 with_target_strings=True)

    def predict(self, predict_data_lines: Iterable[str],
                batch_size: Optional[int] = None,
                with_code_vectors: Optional[bool] = None
                ) -> List[ModelPredictionResults]:
        """Per-line top-k words with softmax-normalised scores, attention
        per context and (optionally) the code vector, in `batch_size`-row
        chunks."""
        results: List[ModelPredictionResults] = []
        bs = int(batch_size or self._default_predict_batch_size())
        if with_code_vectors is None:
            with_code_vectors = self.config.export_code_vectors
        it = iter(predict_data_lines)
        while True:
            lines = list(itertools.islice(it, bs))
            if not lines:
                return results
            results.extend(self._predict_chunk(lines, bs, with_code_vectors))

    def _predict_chunk(self, lines: List[str], bs: int,
                       with_code_vectors: bool
                       ) -> List[ModelPredictionResults]:
        chunk = parse_context_lines(lines, self.vocabs,
                                    self.config.max_contexts)
        return self._predict_parsed(chunk, len(lines), bs, with_code_vectors)

    def alloc_predict_batch(self, batch_size: int) -> RowBatch:
        """A reusable PAD-filled slot buffer for the continuous batcher:
        requests parse into disjoint row ranges of it with
        `parse_lines_into`, and the whole buffer goes to
        `predict_parsed`."""
        return empty_predict_batch(batch_size, self.config.max_contexts,
                                   self.vocabs)

    def parse_lines_into(self, lines: List[str], out: RowBatch,
                         row_offset: int) -> None:
        """Parse extractor lines into `out`'s rows from `row_offset` on
        (no per-request RowBatch in between)."""
        parse_context_lines(lines, self.vocabs, self.config.max_contexts,
                            out=out, row_offset=row_offset)

    def predict_parsed(self, chunk: RowBatch, n: int,
                       batch_size: Optional[int] = None,
                       with_code_vectors: Optional[bool] = None
                       ) -> List[ModelPredictionResults]:
        """Predict over an already-parsed RowBatch whose first `n` rows
        are live (a slot buffer, rows past its claimed ones invalid)."""
        bs = int(batch_size or self._default_predict_batch_size())
        if with_code_vectors is None:
            with_code_vectors = self.config.export_code_vectors
        return self._predict_parsed(chunk, n, bs, with_code_vectors)

    def _to_device(self, batch: RowBatch):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                     for a in batch.model_arrays())

    def context_bucket(self, chunk: RowBatch) -> int:
        """The smallest bucket that holds the deepest valid context."""
        any_valid_col = chunk.context_valid_mask.any(axis=0)
        deepest = (int(np.nonzero(any_valid_col)[0][-1]) + 1
                   if any_valid_col.any() else 1)
        return bucket_for(deepest, self.context_buckets)

    def bucketed_batch(self, chunk: RowBatch, bs: int) -> RowBatch:
        """`chunk` as one device batch: its context axis cut to the
        smallest bucket that holds its deepest valid context, its rows
        cut or padded to `bs`."""
        chunk = slice_contexts(chunk, self.context_bucket(chunk))
        if chunk.target_index.shape[0] > bs:
            chunk = truncate_rows(chunk, bs)
        return _pad_rows(chunk, bs)

    def dummy_batch(self, rows: int, m: int):
        """An all-padding batch of one serve shape."""
        i32 = dict(dtype=torch.int32, device=self.device)
        return (torch.zeros((rows, m), **i32), torch.zeros((rows, m), **i32),
                torch.zeros((rows, m), **i32),
                torch.ones((rows, m), dtype=torch.float32,
                           device=self.device),
                torch.zeros((rows,), **i32),
                torch.ones((rows,), dtype=torch.bool, device=self.device))

    def _warm_shape(self, rows: int, m: int) -> None:
        self._call_predict_step(self._get_bucketed_predict_step(rows, m),
                                self.dummy_batch(rows, m))

    def warmup(self, rows: Optional[int] = None) -> None:
        """Run every (rows, bucket) serve shape once on a dummy batch."""
        rows = int(rows or self.config.serve_batch_size)
        for m in self.context_buckets:
            self._warm_shape(rows, m)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _dispatch_predict_step(self, n: int, bs: int, m: int):
        """(step, padded rows, head) for a batch with `n` live rows: one
        head for every shape here; ReleaseModel dispatches by shape."""
        return self._get_bucketed_predict_step(bs, m), bs, "exact"

    def _predict_parsed(self, chunk: RowBatch, n: int, bs: int,
                        with_code_vectors: bool
                        ) -> List[ModelPredictionResults]:
        m = self.context_bucket(chunk)
        step, rows, head = self._dispatch_predict_step(n, bs, m)
        _head_dispatch_counter(head).inc()
        chunk = self.bucketed_batch(chunk, rows)
        out = self._call_predict_step(step, self._to_device(chunk))
        topk_idx = out.topk_indices[:n].cpu().numpy()
        topk_val = out.topk_values[:n].cpu().numpy()
        code_vectors = out.code_vectors[:n].cpu().numpy()
        attention = out.attention[:n].cpu().numpy()
        # normalize_scores: softmax over the k values
        e = np.exp(topk_val - topk_val.max(axis=1, keepdims=True))
        scores = e / e.sum(axis=1, keepdims=True)
        results: List[ModelPredictionResults] = []
        for i in range(n):
            words = [self.vocabs.target_vocab.lookup_word(int(j))
                     for j in topk_idx[i]]
            attention_per_context: Dict[Tuple[str, str, str], float] = {}
            for j in range(m):
                s = chunk.source_strings[i, j]
                p = chunk.path_strings[i, j]
                t = chunk.target_token_strings[i, j]
                if s or p or t:
                    attention_per_context[(s, p, t)] = float(attention[i, j])
            results.append(ModelPredictionResults(
                original_name=(chunk.target_strings[i]
                               if chunk.target_strings else ""),
                topk_predicted_words=words,
                topk_predicted_words_scores=scores[i],
                attention_per_context=attention_per_context,
                code_vector=code_vectors[i] if with_code_vectors else None))
        return results


class Code2VecModel(BucketedPredictMixin):
    """A model on one device (config.device: cuda unless asked for cpu):
    fresh from `config.seed`, or restored from `--load`;
    `Code2VecModel(config).train()` trains it, with the saves and
    evaluations the config asks for."""

    def __init__(self, config):
        from code2vec_tpu_torch.release.runtime import resolve_device
        config.verify()
        self.config = config
        self.log = config.log
        self.device = resolve_device(config.device)
        self.initial_epoch = 0
        self.mesh = self._join_mesh() if config.mesh_size > 1 else None
        if config.is_loading:
            self._resolve_load_path()
        self.vocabs = Code2VecVocabs.load_or_create(config)
        tv = self.vocabs.target_vocab
        self.dims = ModelDims(
            token_vocab_size=self.vocabs.token_vocab.size,
            path_vocab_size=self.vocabs.path_vocab.size,
            target_vocab_size=tv.size,
            token_dim=config.token_embeddings_size,
            path_dim=config.path_embeddings_size,
            target_oov_floor=max(tv.pad_index, tv.oov_index))
        if config.tp > 1:
            # equal row shards (the reference's from_config_and_vocabs)
            self.dims = self.dims.padded_to(config.tp)
        generator = torch.Generator(device=self.device).manual_seed(
            config.seed)
        self.module = Code2VecModule(
            self.dims, compute_dtype=DTYPES[config.compute_dtype],
            device=self.device, generator=generator,
            dropout_keep_rate=config.dropout_keep_rate)
        self.optimizer = make_optimizer(config)
        if self.mesh is None:
            self.state = create_train_state(self.module, self.optimizer,
                                            config)
            self.builder = TrainStepBuilder(self.module, self.optimizer,
                                            config)
        else:
            self._shard_params(dict(self.module.named_parameters()))
            # every rank drew the whole tables and keeps its shards
            self.module = None
        self.trainer = None
        self._eval_step = None
        self._predict_steps: Dict[Tuple[int, int], object] = {}
        self.mips_head = self._mips_topk = None
        self.context_buckets: Tuple[int, ...] = parse_buckets(
            config.serve_buckets, config.max_contexts)
        if config.is_loading:
            # --release and export read the params alone, whatever the
            # saved optimizer state's layout (reference :480-487)
            params_only = config.release or bool(config.export_artifact_path)
            ckpt.load_model(config.model_load_path, self.state, config=config,
                            params_only=params_only)
            self.initial_epoch = int(ckpt.load_model_meta(
                config.model_load_path).get("epoch", 0))
            self.log(f"Loaded model weights from {config.model_load_path} "
                     f"(epoch {self.initial_epoch}, step {self.state.step})")
        update = ("sparse (touched-rows)"
                  if config.use_sparse_embedding_update else "dense")
        where = (self.device if self.mesh is None else
                 f"a {self.mesh.plan.describe()} mesh over "
                 f"{self.mesh.backend} (rank 0 on {self.device})")
        self.log(f"Model on {where}: vocabularies {self.dims.token_vocab_size} "
                 f"tokens, {self.dims.path_vocab_size} paths, "
                 f"{self.dims.target_vocab_size} targets; "
                 f"{num_params(self.state)} parameters"
                 f"{'' if self.mesh is None else ' a rank'}; {update} "
                 f"embedding update")

    # ------------------------------------------------------------- mesh

    def _join_mesh(self):
        """Join the run's processes (torchrun's environment, or
        --dist_init) and build this rank's mesh; the plan's product must
        equal the process count. Ranks other than 0 log nothing."""
        from code2vec_tpu_torch.parallel import distributed
        from code2vec_tpu_torch.parallel.mesh import MeshPlan, make_mesh
        config = self.config
        plan = MeshPlan.from_config(config)
        distributed.initialize(config.dist_init_method)
        if distributed.process_count() != plan.size:
            raise ValueError(
                f"the mesh plan {plan.describe()} has {plan.size} ranks but "
                f"{distributed.process_count()} processes run; launch "
                f"dp x tp x cp processes (python -m torch.distributed.run "
                f"--nproc-per-node N)")
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        mesh = make_mesh(plan, device=self.device,
                         backend=config.dist_backend or None)
        if mesh.index != 0:
            config.verbose_mode = 0
        return mesh

    def _shard_params(self, params) -> None:
        """This rank's state and steps from the full (padded) parameters
        (name -> tensor or numpy array), with fresh moments."""
        from code2vec_tpu_torch.training.state import sharded_train_state
        from code2vec_tpu_torch.training.step import ParallelStepBuilder
        self.state = sharded_train_state(
            {k: (v.detach() if isinstance(v, torch.Tensor) else v)
             for k, v in params.items()}, self.optimizer, self.config,
            self.mesh)
        self.builder = ParallelStepBuilder(self.dims, self.optimizer,
                                           self.config, self.mesh)
        self._eval_step = None

    def load_params(self, params) -> None:
        """Start from these full parameters (name -> numpy array or
        tensor, the Flax names and shapes, tables padded as the dims
        are): on a mesh each rank keeps its shards."""
        if self.mesh is not None:
            return self._shard_params(params)
        from code2vec_tpu_torch.weights import params_from_jax
        self.module.load_state_dict(params_from_jax(
            {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                           else v) for k, v in params.items()}))

    def _packed_dataset(self, c2v_path: str) -> PackedDataset:
        """On a mesh, rank 0 packs a `.c2vb` that is not there yet while
        the others wait, so that no two ranks write one file."""
        if self.mesh is not None and not os.path.exists(c2v_path + "b"):
            import torch.distributed as dist
            if self.mesh.index == 0:
                super()._packed_dataset(c2v_path)
            dist.barrier(group=self.mesh.host_group)
        return super()._packed_dataset(c2v_path)

    def _rank_batches(self, batches: Iterable) -> Iterable:
        """The stream with each batch cut to this rank's part (every rank
        reads the same global batches)."""
        if self.mesh is None:
            return batches
        from code2vec_tpu_torch.data.reader import EpochEnd
        from code2vec_tpu_torch.parallel.mesh import batch_slice
        return (b if isinstance(b, EpochEnd) else batch_slice(b, self.mesh)
                for b in batches)

    def _resolve_load_path(self) -> None:
        """`--load` names an artifact directory or a save base, which
        resolves to its newest artifact that passes its integrity check
        (reference :418-456); a release artifact is refused."""
        from code2vec_tpu_torch.release.artifact import META_NAME
        config = self.config
        if os.path.isfile(os.path.join(config.model_load_path, META_NAME)):
            raise ValueError(
                f"--load points at a release artifact "
                f"({config.model_load_path}): its `quantization.scheme` "
                f"tables are not an fp32 checkpoint. Serve it with `serve "
                f"--artifact {config.model_load_path}` instead.")
        trail: List[Dict] = []
        resolved = ckpt.resolve_load_path(config.model_load_path,
                                          log=self.log, trail=trail)
        rejected = [t for t in trail if t["outcome"] == "rejected"]
        for t in rejected:
            self.log(f"Resume REJECTED candidate {t['path']}: {t['reason']}")
        if rejected:
            self.log(f"Resume fell back past {len(rejected)} rejected "
                     f"artifact(s) to {resolved}")
        if resolved != os.path.abspath(config.model_load_path):
            self.log(f"Resolved --load {config.model_load_path} -> "
                     f"{resolved}")
        config.model_load_path = resolved

    # ------------------------------------------------------------ train

    def _train_corpus(self):
        """The packed training rows: the manifest's shards as one row
        space with --train_corpus_manifest, else the `.c2vb` of --data
        (reference :129-154); memoised beside `_packed_dataset`'s."""
        config = self.config
        manifest = config.train_corpus_manifest
        if not manifest:
            return self._packed_dataset(config.train_data_path)
        cached = self.__dict__.setdefault("_packed_cache", {})
        if manifest not in cached:
            ds = ShardedCorpus(manifest, self.vocabs)
            self.log(f"Training corpus: {manifest} "
                     f"({ds.num_shard_files} shard(s), "
                     f"{ds.num_rows_total} rows)")
            cached[manifest] = ds
        return cached[manifest]

    def _train_batches(self) -> Iterable:
        """The train stream with EpochEnd markers: the epochs left of
        `num_train_epochs` after the loaded ones, keyed by their absolute
        index (reference :557-640); a full permutation of the packed rows
        per epoch, or the text reader's shuffle buffer with
        --no_packed_data."""
        config = self.config
        epochs = max(config.num_train_epochs - self.initial_epoch, 0)
        if config.is_loading and epochs == 0:
            self.log(f"Loaded model already trained {self.initial_epoch} "
                     f"epochs (budget {config.num_train_epochs}); nothing "
                     f"to train. Raise --epochs to continue.")
        if config.use_packed_data:
            return self._train_corpus().iter_batches(
                config.train_batch_size, EstimatorAction.Train,
                num_epochs=epochs, seed=config.seed,
                yield_epoch_markers=True, start_epoch=self.initial_epoch)
        return PathContextReader(self.vocabs, config, EstimatorAction.Train,
                                 batch_size=config.train_batch_size,
                                 num_epochs=epochs, yield_epoch_markers=True,
                                 start_epoch=self.initial_epoch)

    def train(self) -> None:
        """Train for the epochs left; at each scheduled epoch end save
        `<save>_iter<N>` (with rotation) and evaluate on --test; then
        save `<save>` (reference :690-737)."""
        config = self.config
        step = self.builder.make_train_step(self.state)
        self.trainer = Trainer(
            config, step, self.device,
            evaluate_fn=((lambda state: self._evaluate_with_params(
                state.params)) if config.is_testing else None),
            save_fn=self._make_save_fn() if config.is_saving else None,
            initial_epoch=self.initial_epoch,
            host_group=None if self.mesh is None else self.mesh.host_group)
        try:
            self.state = self.trainer.train(
                self.state, self._rank_batches(self._train_batches()),
                dropout_seed(config))
        finally:
            # the callbacks hold this model: without them a dropped model
            # frees its device memory at once, not at the next gc pass
            self.trainer.evaluate_fn = self.trainer.save_fn = None
        self.initial_epoch = self.trainer.final_epoch
        if config.is_saving:
            self.save()
            self.log(f"Model saved in: {config.model_save_path}")

    def _make_save_fn(self):
        config = self.config

        def save_fn(state, epoch):
            path = f"{config.model_save_path}_iter{epoch}"
            ckpt.save_model(path, state, self.vocabs, config, epoch=epoch,
                            data_cursor=self._cursor(epoch))
            self.log(f"Saved after {epoch} epochs in: {path}")
            self._rotate_epoch_checkpoints()

        return save_fn

    def _cursor(self, epoch: int) -> dict:
        """The data cursor of a save at an epoch boundary."""
        return {"epoch": epoch, "global_row_ordinal": 0,
                "global_batch_size": self.config.train_batch_size}

    def _rotate_epoch_checkpoints(self) -> None:
        """Sweep the commit directories of killed saves (promoting a
        complete one whose slot is empty), then keep the newest
        `max_to_keep` epoch checkpoints, never deleting the only one that
        verifies (reference :802-870)."""
        config = self.config
        pattern = f"{config.model_save_path}_iter*"
        # `.tmp-` first, so the newer state wins an empty slot over its
        # `.old-` predecessor
        orphans = [p for p in glob.glob(pattern) if ckpt.is_staging_path(p)
                   and not ckpt.staging_owner_alive(p)]
        for p in sorted(orphans,
                        key=lambda p: ckpt.BACKUP_INFIX in os.path.basename(p)):
            if ckpt.reclaim_orphan(p, log=self.log) == "removed":
                self.log(f"Swept orphaned checkpoint staging dir {p}")
        parsed = {p: ckpt.parse_iter_name(p) for p in glob.glob(pattern)}
        valid: Dict[str, bool] = {}

        def is_valid(p: str) -> bool:
            if p not in valid:
                try:
                    ckpt.verify_checkpoint(p)
                    valid[p] = True
                except ckpt.CheckpointIntegrityError:
                    valid[p] = False
            return valid[p]

        clean = sorted((p for p, v in parsed.items() if v is not None),
                       key=lambda p: parsed[p])
        victims = clean[:-config.max_to_keep] if config.max_to_keep else []
        retained = clean[len(victims):]
        if victims and not any(is_valid(p) for p in retained):
            for p in reversed(victims):
                if is_valid(p):
                    self.log(f"Rotation keeping over-quota checkpoint {p}: "
                             f"it is the only one passing verification")
                    victims.remove(p)
                    break
        for stale in victims:
            shutil.rmtree(stale, ignore_errors=True)

    def save(self, model_save_path: Optional[str] = None) -> str:
        path = model_save_path or self.config.model_save_path
        return ckpt.save_model(path, self.state, self.vocabs, self.config,
                               epoch=self.initial_epoch,
                               data_cursor=self._cursor(self.initial_epoch))

    # ------------------------------------------------------------- eval

    def _get_eval_step(self):
        if self._eval_step is None:
            self._eval_step = self.builder.make_eval_step()
        return self._eval_step

    def evaluate(self):
        """`--release`: re-save the loaded model weights-only as
        `<load>.release` and return None; else the evaluation of
        config.test_data_path (reference :882-891)."""
        config = self.config
        if config.release:
            released = ckpt.save_model(config.model_load_path, self.state,
                                       self.vocabs, config, released=True)
            self.log(f"Releasing model, output model: {released}")
            return None
        return self._evaluate_with_params(self.state.params)

    def _evaluate_with_params(self, params):
        """Score config.test_data_path with the live params (K1-K4 on the
        card); with --export_code_vectors, the code vectors go to
        `<test>.vectors`: a vector store, or the reference's text layout
        under --vectors_text (reference :893-940)."""
        from code2vec_tpu_torch.evaluation.evaluator import Evaluator
        config = self.config
        config.num_test_examples = self._count_examples(config.test_data_path)
        evaluator = Evaluator(config, self.vocabs, self._get_eval_step(),
                              self.device, log_path=config.eval_log_path,
                              mesh=self.mesh)
        if not config.export_code_vectors:
            return evaluator.evaluate(
                params, self._rank_batches(self._eval_batches()))
        from code2vec_tpu_torch.retrieval.store import (
            MANIFEST_NAME, VectorStoreWriter,
        )
        vectors_base = config.test_data_path + ".vectors"
        if config.vectors_text:
            if os.path.isdir(vectors_base):
                if not os.path.isfile(os.path.join(vectors_base,
                                                   MANIFEST_NAME)):
                    raise ValueError(
                        f"{vectors_base} is a directory that is not a "
                        f"code2vec vector store; refusing to replace it "
                        f"with the text export")
                shutil.rmtree(vectors_base)
            return evaluator.evaluate(params, self._eval_batches(),
                                      code_vectors_path=vectors_base)
        if os.path.isfile(vectors_base):
            os.unlink(vectors_base)
        writer = VectorStoreWriter(
            vectors_base, dim=config.code_vector_size,
            dtype=config.embed_dtype,
            model_fingerprint=self.model_fingerprint(),
            source=config.test_data_path,
            shard_rows=config.embed_shard_rows, resume=False, log=self.log)
        results = evaluator.evaluate(params, self._eval_batches(),
                                     code_vectors_sink=writer.append)
        manifest = writer.finalize()
        self.log(f"Code vectors exported as a vector store at "
                 f"{vectors_base} ({manifest['rows']} rows, "
                 f"{len(manifest['shards'])} shard(s); --vectors_text "
                 f"restores the reference text layout)")
        return results

    # ---------------------------------------------------------- predict

    @property
    def code_vector_size(self) -> int:
        return self.dims.code_dim

    def _make_predict_step(self, batch_rows: int, m: int):
        # one step for every shape: the kernels take any (rows, m)
        mips = self._get_mips_topk()
        if mips is None:
            return self._get_eval_step()
        # the approximate-MIPS head (--serve_mips_nprobe): encode
        # exactly, then search nprobe lists of the target table (K11)
        # instead of all of it; predict and serve only, evaluation keeps
        # the exact head
        return self.builder.make_eval_step(mips_topk=mips)

    def _get_mips_topk(self):
        """The MIPS head's top-k closure, built on first use over the
        live target table with the config's nlist, nprobe and seed
        (K9, K10), or None when the knob is off (reference :960-998)."""
        nprobe = int(self.config.serve_mips_nprobe or 0)
        if nprobe <= 0:
            return None
        cached = self._mips_topk
        if cached is None:
            with self._predict_lock:
                cached = self._mips_topk
                if cached is None:
                    from code2vec_tpu_torch.retrieval.mips import MipsHead
                    real = self.dims.real_target_vocab_size
                    self.mips_head = MipsHead.build(
                        self.state.params["target_embedding"].detach(),
                        None, real_vocab=real,
                        nlist=int(self.config.serve_mips_nlist or 0),
                        nprobe=nprobe, seed=int(self.config.seed),
                        log=self.log, device=self.device)
                    k = min(self.config
                            .top_k_words_considered_during_prediction, real)
                    cached = self._mips_topk = self.mips_head.topk_fn(
                        k, nprobe)
        return cached

    def _dispatch_predict_step(self, n: int, bs: int, m: int):
        """One head for every shape: MIPS when the knob is on."""
        head = "exact" if self._get_mips_topk() is None else "mips"
        return self._get_bucketed_predict_step(bs, m), bs, head

    @torch.no_grad()
    def _call_predict_step(self, step, arrays):
        return step(self.state.params, *arrays)

    def eval_callable(self):
        """(eval_step, params): the surface of the embed job and other
        callers that drive the eval step themselves."""
        return self._get_eval_step(), self.state.params

    def model_fingerprint(self) -> str:
        ident = os.path.abspath(self.config.model_load_path
                                or self.config.model_save_path
                                or f"seed{self.config.seed}")
        return (f"ckpt:{ident}@step{int(self.state.step)}"
                f"#p{num_params(self.state)}")

    # ---------------------------------------------------------- exports

    def _vocab_embedding(self, vocab_type: VocabType) -> np.ndarray:
        name = {VocabType.Token: "token_embedding",
                VocabType.Path: "path_embedding",
                VocabType.Target: "target_embedding"}[vocab_type]
        table = self.state.params[name].detach().cpu().numpy()
        return table[:self.vocabs.get(vocab_type).size]

    def save_word2vec_format(self, dest_save_path: str,
                             vocab_type: VocabType) -> None:
        """One table in word2vec text format (reference :1031-1047)."""
        matrix = self._vocab_embedding(vocab_type)
        index_to_word = self.vocabs.get(vocab_type).index_to_word
        with open(dest_save_path, "w") as f:
            save_word2vec_file(f, index_to_word, matrix)
        self.log(f"Saved {vocab_type} word2vec format to {dest_save_path}")

    def export_embeddings(self, out_dir: str) -> Dict[str, str]:
        """The `export-embeddings` command: `tokens.w2v` and
        `targets.w2v` in word2vec text format (reference :1049-1062)."""
        os.makedirs(out_dir, exist_ok=True)
        paths = {"tokens": os.path.join(out_dir, "tokens.w2v"),
                 "targets": os.path.join(out_dir, "targets.w2v")}
        self.save_word2vec_format(paths["tokens"], VocabType.Token)
        self.save_word2vec_format(paths["targets"], VocabType.Target)
        self.log(f"Embedding tables exported to {out_dir} (word2vec text "
                 f"format)")
        return paths
