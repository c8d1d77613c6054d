"""The single-device train steps: dense, and sparse (touched-rows Adam
for the token and path tables); and the eval step, which the release
runtime shares.

The counterpart of code2vec_tpu/training/step.py TrainStepBuilder with
mesh=None: `_make_gspmd_train_step` (:177-199) and
`_make_gspmd_sparse_train_step` (:198-269), with `_loss_from_logits`
(:170-175). Both run the forward with dropout keyed by (seed, step), the
softmax cross-entropy over the logits and the backward. The dense step
then runs Adam over every parameter (K8). The sparse step takes the
tables' gradients as rows (K5's row mode) and runs K8 over the dense
subtree only and K12 over each table's touched rows, with bias
correction from the global step. On CUDA tensors every stage runs a
hand-written kernel (K1, K2, K7, then K6, K5 and K8, and K12) or raises;
on CPU tensors their plain versions run.

`ParallelStepBuilder` holds the tensor-, context- and data-parallel
steps of one rank of a dp x tp x cp mesh (parallel/mesh.py): the
reference's explicit-collective ("manual") dense, sparse and eval steps
(:270-605), over torch.distributed, with K14-K17 between the collectives
(its docstring gives the order).

`make_eval_step` is the counterpart of `make_eval_step` (:487-560) with
the blockwise head, and the one body of both eval steps of the port: the
trainer's (the live f32 tables in the config's compute dtype) and a
release artifact's (its tables in their stored format,
release/runtime.py `make_release_step`): encode (K1, K2), the top-k and
logsumexp over the live target rows (K3) and each row's label logit
(K4), and the cross-entropy summed over rows with an in-vocabulary
label. On CUDA tensors it launches those kernels or raises.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from code2vec_tpu_torch.kernels.adam import AdamHyper, adam
from code2vec_tpu_torch.kernels.attention import masked_attention
from code2vec_tpu_torch.kernels.encoder import Dropout, context_encoder
from code2vec_tpu_torch.kernels.encoder_backward import encoder_backward_rows
from code2vec_tpu_torch.kernels.label_logits import label_logits
from code2vec_tpu_torch.kernels.select import padded_width
from code2vec_tpu_torch.kernels.sharded import (
    shard_gather, shard_local_ids, shard_scatter_add, tp_xent_grad,
    valid_columns,
)
from code2vec_tpu_torch.kernels.sparse_adam import sparse_adam_tables
from code2vec_tpu_torch.kernels.topk import blockwise_topk
from code2vec_tpu_torch.models.code2vec import (
    Code2VecModule, ModelDims, RowGrads, matmul_f32,
)
from code2vec_tpu_torch.ops.attention import (
    context_parallel_attention, context_parallel_attention_backward,
)
from code2vec_tpu_torch.ops.sharded import (
    tp_logits, tp_softmax_stats, tp_top_k,
)
from code2vec_tpu_torch.parallel.mesh import AXIS_CTX, AXIS_DATA, AXIS_MODEL
from code2vec_tpu_torch.training.sparse_adam import HybridOptState
from code2vec_tpu_torch.training.state import (
    DTYPES, SPARSE_PARAM_NAMES, TrainState, uses_sparse_update,
)

# the reference keys dropout with jax.random.key(config.seed + 2)
# (training/state.py dropout_rng)
DROPOUT_SEED_SALT = 2


def dropout_seed(config) -> int:
    return int(config.seed) + DROPOUT_SEED_SALT


class EvalOutputs(NamedTuple):
    topk_values: torch.Tensor    # (B, k) f32
    topk_indices: torch.Tensor   # (B, k) int32
    code_vectors: torch.Tensor   # (B, D) f32
    attention: torch.Tensor      # (B, M) f32
    loss_sum: torch.Tensor       # () f32, CE summed over valid rows


def make_eval_step(*, real_target_vocab_size: int, target_oov_floor: int,
                   compute_dtype: torch.dtype, topk: int, block_size: int,
                   quantized: bool = False, mips_topk=None) -> Callable:
    """(params, src, pth, tgt, mask, labels, valid) -> EvalOutputs.

    `params` holds the Flax names; with `quantized`, also
    `<table>_scale` for each table. Each table's format is its tensor's
    dtype. k is clamped to the live target rows; `block_size` <= 0 is
    one block of the whole table. `mips_topk` (a `MipsHead.topk_fn`
    closure) replaces the exact head (K3, K4) with the approximate-MIPS
    search; such steps report loss_sum 0 (no logsumexp exists over a
    candidate subset)."""
    real_v = int(real_target_vocab_size)
    k = min(int(topk), real_v)

    def scale(params, name):
        return params[f"{name}_scale"] if quantized else None

    def step(params, src, pth, tgt, mask, labels, valid) -> EvalOutputs:
        transformed = context_encoder(
            params["token_embedding"], scale(params, "token_embedding"),
            params["path_embedding"], scale(params, "path_embedding"),
            params["transform"], src, pth, tgt, compute_dtype=compute_dtype)
        code_vectors, attention = masked_attention(
            transformed, params["attention"][:, 0], mask)
        if mips_topk is not None:
            values, indices = mips_topk(code_vectors)
            return EvalOutputs(values, indices, code_vectors, attention,
                               torch.zeros((), dtype=torch.float32,
                                           device=code_vectors.device))
        target, target_s = (params["target_embedding"],
                            scale(params, "target_embedding"))
        block = block_size if block_size > 0 else target.shape[0]
        out = blockwise_topk(code_vectors, target, k, block, scales=target_s,
                             valid_rows=real_v, compute_dtype=compute_dtype)
        label_logit = label_logits(code_vectors, target, labels,
                                   scales=target_s,
                                   compute_dtype=compute_dtype)
        loss_rows = valid & (labels > target_oov_floor)
        ce = (out.lse - label_logit) * loss_rows.float()
        return EvalOutputs(out.values, out.indices, code_vectors, attention,
                           ce.sum())

    return step


class TrainStepBuilder:
    """Builds the train step for a module + optimizer on one device."""

    def __init__(self, module: Code2VecModule, optimizer: AdamHyper,
                 config):
        self.module = module
        self.optimizer = optimizer
        self.config = config

    def make_train_step(self, example_state: TrainState) -> Callable:
        """(state, src, pth, tgt, mask, labels, valid, dropout_seed,
        dropout_mask=None) -> (state, loss). The state is updated in place
        and returned; `dropout_mask` (B, M, 3d) bool replaces the drawn
        mask (tests). The state's optimizer state says which step: a
        HybridOptState the sparse one, which the config must ask for."""
        if set(example_state.params) != set(
                dict(self.module.named_parameters())):
            raise ValueError("the state's parameters are not the module's")
        sparse = isinstance(example_state.opt_state, HybridOptState)
        if sparse != uses_sparse_update(self.config):
            raise ValueError(
                f"TrainState opt_state is {'sparse' if sparse else 'dense'} "
                f"but config.use_sparse_embedding_update="
                f"{uses_sparse_update(self.config)}; pass the same config "
                f"to create_train_state and TrainStepBuilder.")
        if sparse:
            return self._make_sparse_train_step()
        module, hyper = self.module, self.optimizer

        def train_step(state: TrainState, src, pth, tgt, mask, labels,
                       valid, seed: int,
                       dropout_mask: Optional[torch.Tensor] = None
                       ) -> Tuple[TrainState, torch.Tensor]:
            names = list(state.params)
            params = [state.params[n] for n in names]
            for p in params:
                p.grad = None
            code_vectors, _ = module.encode(
                src, pth, tgt, mask, deterministic=False, dropout_seed=seed,
                dropout_step=state.step, dropout_mask=dropout_mask)
            loss = module.train_loss(code_vectors, labels, valid.float())
            loss.backward()
            count = state.opt_state.count + 1
            with torch.no_grad():
                adam(params, [p.grad for p in params],
                     [state.opt_state.mu[n] for n in names],
                     [state.opt_state.nu[n] for n in names], count, hyper)
            for p in params:
                p.grad = None
            state.opt_state.count = count
            state.step += 1
            return state, loss.detach()

        return train_step

    def make_eval_step(self, k: Optional[int] = None,
                       mips_topk=None) -> Callable:
        """The eval step over the module's live f32 parameters in its
        compute dtype: top-k with k from the config (clamped to the
        vocabulary, reference: tensorflow_model.py:298-299); `mips_topk`
        as in `make_eval_step`."""
        dims = self.module.dims
        return make_eval_step(
            real_target_vocab_size=dims.real_target_vocab_size,
            target_oov_floor=dims.target_oov_floor,
            compute_dtype=self.module.compute_dtype,
            topk=k or self.config.top_k_words_considered_during_prediction,
            block_size=int(self.config.topk_block_size), mips_topk=mips_topk)

    def _adam_kwargs(self) -> dict:
        """K12's hyper-parameters: those of the dense subtree's Adam, so
        the two updates agree on the rows they both could touch."""
        cfg = self.config
        return dict(lr=cfg.learning_rate, b1=cfg.adam_beta1,
                    b2=cfg.adam_beta2, eps=cfg.adam_eps)

    def _make_sparse_train_step(self) -> Callable:
        module, hyper = self.module, self.optimizer
        row_adam = self._adam_kwargs()

        def train_step(state: TrainState, src, pth, tgt, mask, labels,
                       valid, seed: int,
                       dropout_mask: Optional[torch.Tensor] = None
                       ) -> Tuple[TrainState, torch.Tensor]:
            names = [n for n in state.params if n not in SPARSE_PARAM_NAMES]
            params = [state.params[n] for n in names]
            for p in params:
                p.grad = None
            rows = RowGrads()
            code_vectors, _ = module.encode(
                src, pth, tgt, mask, deterministic=False, dropout_seed=seed,
                dropout_step=state.step, dropout_mask=dropout_mask,
                row_grads=rows)
            loss = module.train_loss(code_vectors, labels, valid.float())
            loss.backward()
            dense = state.opt_state.dense
            count = dense.count + 1
            t = state.step + 1   # bias correction from the global step
            slots = state.opt_state.slots
            tok = state.params["token_embedding"]
            path = state.params["path_embedding"]
            with torch.no_grad():
                adam(params, [p.grad for p in params],
                     [dense.mu[n] for n in names],
                     [dense.nu[n] for n in names], count, hyper)
                # the source positions first, then the targets: the
                # reference's concat of the token ids; both tables in one
                # launch sequence where their widths agree
                sparse_adam_tables(
                    [(tok, slots["token_embedding"],
                      torch.cat([src.reshape(-1), tgt.reshape(-1)]),
                      rows.tok.reshape(-1, tok.shape[1])),
                     (path, slots["path_embedding"], pth.reshape(-1),
                      rows.path.reshape(-1, path.shape[1]))],
                    t=t, **row_adam)
            for p in params:
                p.grad = None
            dense.count = count
            state.step = t
            return state, loss.detach()

        return train_step


def rank_dropout_seed(seed: int, data_index: int, ctx_index: int) -> int:
    """The dropout key of a mesh rank: the run's seed with its data and
    ctx coordinates folded in, as the reference folds them into its key
    (code2vec_tpu/training/step.py:284-292). The model ranks of one
    (data, ctx) cell draw the same mask, since their activations are
    replicated; other cells draw other masks. The cell (0, 0) keeps the
    seed, so a mesh of one rank draws the single-device step's mask."""
    if data_index == 0 and ctx_index == 0:
        return int(seed)
    h = hashlib.blake2b(f"{int(seed)}:{data_index}:{ctx_index}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "little") % (1 << 63)


class _Forward(NamedTuple):
    tok_ids: torch.Tensor     # (2 b m,) the source then the target ids
    tok_rows: torch.Tensor    # (2 b m, td) f32, gathered and summed
    path_rows: torch.Tensor   # (b m, pd) f32
    ids: Tuple[torch.Tensor, ...]  # K1's ids into the gathered rows
    t: torch.Tensor           # (b, m, D) K1's output
    t_lo: torch.Tensor        # its residual
    code_vectors: torch.Tensor  # (b, D) f32, summed over ctx
    attention: torch.Tensor   # (b, m) f32


class ParallelStepBuilder:
    """The explicit-collective train and eval steps of one rank of a
    dp x tp x cp mesh (parallel/mesh.py): the counterpart of the
    reference's manual shard_map steps, `_make_manual_train_step`,
    `_make_manual_sparse_train_step` and `_make_manual_eval_step` with
    `_manual_gather`, `_manual_rows_to_code`, `_manual_encode` and
    `_manual_ce` (code2vec_tpu/training/step.py:270-605). Torch has no
    GSPMD: `--gspmd` runs these steps too.

    A rank takes its (data, ctx) slice of the global batch: b = B/dp rows
    and m = M/cp contexts. The forward:
      K14 gathers the rows of the rank's table shards (zeros elsewhere),
        one all-reduce over model sums them;
      K1 runs over the gathered rows as tables with identity ids (the
        sources', then the targets' token rows; the path rows), dropout
        keyed by rank_dropout_seed;
      K2, or K16 with its collectives over ctx, gives the code vectors;
      the local logits (B/dp, V/tp) are a product (matmul_f32); K15's
        stats pass and one all-gather over model, merged in rank order,
        give the global max, sum of exp and label logit, and the loss
        sums over data.
    The backward computes the true gradient of the loss, leaf by leaf:
      K15's gradient pass, the two products of its planes; the code
        vectors' cotangent is summed over model at once (each rank's
        logits are a part of every row's), so everything below it is
        equal on the model ranks of a cell;
      K6, or K17 with a SUM over ctx; K5's row mode;
      dense: K14 scatter-adds the row gradients of the rank's ids into
        its table shards' gradients, which (with those of the transform
        and the query) sum over data and ctx; the target shard's, which
        its ctx ranks compute whole, over data alone; K8;
      sparse: the ids and row gradients are all-gathered over (data,
        ctx), K14 maps foreign ids to the dropped id rows_local, K12
        updates both table shards; K8 over the dense subtree.
    The reference differentiates the psum'd loss on every device and
    psums each leaf over its replicated axes (replicated_axes_for_spec),
    which scales every gradient by the mesh size; Adam does not see a
    constant factor, so both give the same parameters.

    The eval step: the same forward without dropout, the local logits
    (rows of a stride K13 reads), 12e (K13, an all-gather over model,
    K13), K15's stats pass and its all-gather with the reference's -inf
    -> -1e30 substitution, and the loss summed over data."""

    def __init__(self, dims: ModelDims, optimizer: AdamHyper, config, mesh):
        self.dims = dims
        self.optimizer = optimizer
        self.config = config
        self.mesh = mesh
        self.compute_dtype = DTYPES[config.compute_dtype]
        plan = mesh.plan
        for name, rows in (("token", dims.token_vocab_size),
                           ("path", dims.path_vocab_size),
                           ("target", dims.target_vocab_size)):
            if rows % plan.tp:
                raise ValueError(f"{rows} {name} rows do not split over "
                                 f"tp={plan.tp}: pad them "
                                 f"(ModelDims.padded_to)")
        self.model = mesh.comm(AXIS_MODEL)
        self.ctx = mesh.comm(AXIS_CTX)
        self.data = mesh.comm(AXIS_DATA)
        self.data_ctx = mesh.comm(AXIS_DATA, AXIS_CTX)
        self.data_index = mesh.axis_index(AXIS_DATA)
        self.ctx_index = mesh.axis_index(AXIS_CTX)
        self.v_local = dims.target_vocab_size // plan.tp
        self.target_offset = self.model.index * self.v_local
        self.n_valid = valid_columns(self.v_local, self.target_offset,
                                     dims.real_target_vocab_size)
        self._ids = {}

    # ---------------------------------------------------------- forward

    def _offset(self, table: torch.Tensor) -> int:
        return self.model.index * table.shape[0]

    def _identity_ids(self, b: int, m: int, device):
        """K1's ids into the gathered rows: the source rows 0..bm-1 and
        the target rows bm..2bm-1 of the token buffer, the path rows
        0..bm-1."""
        key = (b, m, str(device))
        if key not in self._ids:
            n = b * m
            pos = torch.arange(n, dtype=torch.int32, device=device)
            self._ids[key] = (pos.view(b, m), pos.view(b, m),
                              (pos + n).view(b, m))
        return self._ids[key]

    def _forward(self, params, src, pth, tgt, mask,
                 dropout: Optional[Dropout]) -> _Forward:
        b, m = src.shape
        n = b * m
        tok, path = params["token_embedding"], params["path_embedding"]
        td, pd = tok.shape[1], path.shape[1]
        buf = torch.empty(2 * n * td + n * pd, dtype=torch.float32,
                          device=src.device)
        tok_rows = buf[:2 * n * td].view(2 * n, td)
        path_rows = buf[2 * n * td:].view(n, pd)
        tok_ids = torch.cat([src.reshape(-1), tgt.reshape(-1)])
        shard_gather(tok, tok_ids, self._offset(tok), out=tok_rows)
        shard_gather(path, pth.reshape(-1), self._offset(path),
                     out=path_rows)
        self.model.all_reduce(buf)
        ids = self._identity_ids(b, m, src.device)
        t, t_lo = context_encoder(
            tok_rows, None, path_rows, None, params["transform"], *ids,
            compute_dtype=self.compute_dtype, dropout=dropout,
            residual=True)
        code_vectors, attention = context_parallel_attention(
            t, params["attention"][:, 0], mask, self.ctx)
        return _Forward(tok_ids, tok_rows, path_rows, ids, t, t_lo,
                        code_vectors.float(), attention)

    def _dropout(self, seed: int, step: int,
                 mask: Optional[torch.Tensor]) -> Dropout:
        return Dropout(keep=self.config.dropout_keep_rate,
                       seed=rank_dropout_seed(seed, self.data_index,
                                              self.ctx_index),
                       step=step, mask=mask)

    # --------------------------------------------------------- backward

    def _loss_and_backward(self, params, src, pth, tgt, mask, labels,
                           valid, dropout):
        """(loss, forward, the row gradients (token (2, b, m, td), path
        (b, m, pd)) before any reduction, and the dense leaves' gradients
        {target: this rank's whole, transform, attention: this (data,
        ctx) cell's part})."""
        cd = self.compute_dtype
        b = src.shape[0]
        count = b * self.mesh.plan.dp
        fwd = self._forward(params, src, pth, tgt, mask, dropout)
        target = params["target_embedding"]
        logits = tp_logits(fwd.code_vectors, target, cd)
        gmax, gsum, label_logit = tp_softmax_stats(
            logits, labels, self.model, n_valid=self.n_valid)
        valid_f = valid.float()
        total = ((torch.log(gsum) + gmax - label_logit) * valid_f).sum()
        total = self.data.all_reduce(total.reshape(1))
        loss = total[0] / count
        grad_dtype = cd if cd == torch.bfloat16 else torch.float32
        g = tp_xent_grad(logits, self.n_valid, gmax, gsum, labels, valid_f,
                         self.target_offset, count, grad_dtype=grad_dtype)
        del logits
        tgt_c, cv_c = target.to(cd), fwd.code_vectors.to(cd)
        if g.dim() == 3:  # hi and lo planes: (2b, V/tp) against [cv; cv]
            g = g.reshape(2 * b, -1)
            d_cv = matmul_f32(g, tgt_c)
            d_cv = d_cv[:b] + d_cv[b:]
            cv_c = torch.cat([cv_c, cv_c])
        else:
            d_cv = matmul_f32(g, tgt_c)
        d_target = matmul_f32(g.T, cv_c).to(cd).float()
        del g
        d_cv = self.model.all_reduce(d_cv).to(cd).float()
        dt, d_att = context_parallel_attention_backward(
            fwd.t, params["attention"][:, 0], mask, fwd.attention, d_cv,
            self.ctx)
        tok_g, path_g, d_w = encoder_backward_rows(
            dt.contiguous(), fwd.t, fwd.t_lo, fwd.tok_rows, fwd.path_rows,
            params["transform"], *fwd.ids, compute_dtype=cd,
            dropout=dropout)
        return loss, fwd, tok_g, path_g, {
            "target_embedding": d_target, "transform": d_w,
            "attention": d_att[:, None]}

    def _reduce_dense(self, dense: Dict[str, torch.Tensor]) -> None:
        """The transform's and the query's gradients sum over data and
        ctx, the target shard's over data (in place)."""
        small = torch.cat([dense["transform"].reshape(-1),
                           dense["attention"].reshape(-1)])
        self.data_ctx.all_reduce(small)
        nw = dense["transform"].numel()
        dense["transform"].copy_(small[:nw].view_as(dense["transform"]))
        dense["attention"].copy_(small[nw:].view_as(dense["attention"]))
        self.data.all_reduce(dense["target_embedding"])

    def loss_and_grads(self, state: TrainState, src, pth, tgt, mask,
                       labels, valid, seed: int,
                       dropout_mask: Optional[torch.Tensor] = None):
        """(global loss, this rank's part of the gradient of every
        parameter, summed over the mesh: the tables' row shards)."""
        params = state.params
        dropout = self._dropout(seed, state.step, dropout_mask)
        loss, fwd, tok_g, path_g, grads = self._loss_and_backward(
            params, src, pth, tgt, mask, labels, valid, dropout)
        tok, path = params["token_embedding"], params["path_embedding"]
        flat = torch.zeros(tok.numel() + path.numel(), dtype=torch.float32,
                           device=tok.device)
        d_tok = flat[:tok.numel()].view_as(tok)
        d_path = flat[tok.numel():].view_as(path)
        shard_scatter_add(d_tok, fwd.tok_ids,
                          tok_g.reshape(-1, tok.shape[1]), self._offset(tok))
        shard_scatter_add(d_path, pth.reshape(-1),
                          path_g.reshape(-1, path.shape[1]),
                          self._offset(path))
        self.data_ctx.all_reduce(flat)
        self._reduce_dense(grads)
        grads.update(token_embedding=d_tok, path_embedding=d_path)
        return loss, grads

    # ------------------------------------------------------------ steps

    def make_train_step(self, example_state: TrainState) -> Callable:
        """(state, src, pth, tgt, mask, labels, valid, dropout_seed,
        dropout_mask=None) -> (state, global loss), on this rank's slice
        of the batch (`dropout_mask` its (b, m, 3d) slice of an injected
        mask). The state (its shards) is updated in place."""
        sparse = isinstance(example_state.opt_state, HybridOptState)
        if sparse != uses_sparse_update(self.config):
            raise ValueError(
                f"TrainState opt_state is {'sparse' if sparse else 'dense'} "
                f"but config.use_sparse_embedding_update="
                f"{uses_sparse_update(self.config)}")
        if sparse:
            return self._make_sparse_train_step()
        hyper = self.optimizer

        def train_step(state: TrainState, src, pth, tgt, mask, labels,
                       valid, seed: int,
                       dropout_mask: Optional[torch.Tensor] = None):
            loss, grads = self.loss_and_grads(state, src, pth, tgt, mask,
                                              labels, valid, seed,
                                              dropout_mask)
            names = list(state.params)
            count = state.opt_state.count + 1
            with torch.no_grad():
                adam([state.params[n] for n in names],
                     [grads[n] for n in names],
                     [state.opt_state.mu[n] for n in names],
                     [state.opt_state.nu[n] for n in names], count, hyper)
            state.opt_state.count = count
            state.step += 1
            return state, loss

        return train_step

    def _make_sparse_train_step(self) -> Callable:
        hyper = self.optimizer
        cfg = self.config
        row_adam = dict(lr=cfg.learning_rate, b1=cfg.adam_beta1,
                        b2=cfg.adam_beta2, eps=cfg.adam_eps)

        def train_step(state: TrainState, src, pth, tgt, mask, labels,
                       valid, seed: int,
                       dropout_mask: Optional[torch.Tensor] = None):
            params = state.params
            dropout = self._dropout(seed, state.step, dropout_mask)
            loss, fwd, tok_g, path_g, grads = self._loss_and_backward(
                params, src, pth, tgt, mask, labels, valid, dropout)
            self._reduce_dense(grads)
            names = [n for n in params if n not in SPARSE_PARAM_NAMES]
            dense = state.opt_state.dense
            count = dense.count + 1
            t = state.step + 1   # bias correction from the global step
            tok, path = params["token_embedding"], params["path_embedding"]
            slots = state.opt_state.slots
            # every (data, ctx) cell's rows, in data-major order, on every
            # rank: each model rank applies those of its shard
            tok_ids = self.data_ctx.all_gather(fwd.tok_ids)
            tok_rows = self.data_ctx.all_gather(
                tok_g.reshape(-1, tok.shape[1]))
            path_ids = self.data_ctx.all_gather(pth.reshape(-1))
            path_rows = self.data_ctx.all_gather(
                path_g.reshape(-1, path.shape[1]))
            with torch.no_grad():
                adam([params[n] for n in names], [grads[n] for n in names],
                     [dense.mu[n] for n in names],
                     [dense.nu[n] for n in names], count, hyper)
                sparse_adam_tables(
                    [(tok, slots["token_embedding"],
                      shard_local_ids(tok_ids, self._offset(tok),
                                      tok.shape[0]), tok_rows),
                     (path, slots["path_embedding"],
                      shard_local_ids(path_ids, self._offset(path),
                                      path.shape[0]), path_rows)],
                    t=t, **row_adam)
            dense.count = count
            state.step = t
            return state, loss

        return train_step

    def make_eval_step(self, k: Optional[int] = None) -> Callable:
        """(params, src, pth, tgt, mask, labels, valid) -> EvalOutputs of
        this rank's rows (top-k, code vectors, its contexts' attention)
        and the loss summed over the global batch."""
        dims = self.dims
        real_v = dims.real_target_vocab_size
        k = min(int(k or self.config.top_k_words_considered_during_prediction),
                real_v)
        v, n_valid = self.v_local, self.n_valid
        ld = padded_width(v)
        oov_floor = dims.target_oov_floor

        @torch.no_grad()
        def step(params, src, pth, tgt, mask, labels, valid) -> EvalOutputs:
            fwd = self._forward(params, src, pth, tgt, mask, None)
            logits = tp_logits(fwd.code_vectors, params["target_embedding"],
                               self.compute_dtype, ld=ld)
            # the padded target columns never win (the reference's
            # _mask_padded_target_cols)
            logits[:, n_valid:v] = float("-inf")
            values, indices = tp_top_k(logits, k, self.model, n_cols=v)
            gmax, gsum, label_logit = tp_softmax_stats(
                logits, labels, self.model, n_cols=v, n_valid=n_valid,
                floor=True)
            loss_rows = (valid & (labels > oov_floor)).float()
            total = ((torch.log(gsum) + gmax - label_logit)
                     * loss_rows).sum()
            total = self.data.all_reduce(total.reshape(1))
            return EvalOutputs(values, indices, fwd.code_vectors,
                               fwd.attention, total[0])

        return step
