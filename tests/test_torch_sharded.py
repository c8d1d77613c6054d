"""The port's tensor- and context-parallel device functions (ops/sharded.py
12a-12e, ops/attention.py 12f) on gloo ranks on the CPU, against the JAX
package's functions under shard_map on the 8 virtual CPU devices; K14-K17's
plain versions against the unsplit plain K2, K6 and K7; the mesh's layout
against the reference's; K12's dropped id; dropout keying.

Each plan's ranks run in one spawn of tests/torch_rank_child.py (the
`ops` task; 60 s, joined with a deadline): tp 2 with cp 2, tp 4, cp 4.
Inputs are made with numpy from a seed: a 20-row table (5 a shard at tp
4) and ids outside every shard; (8, 20) logits whose last 3 columns are
padded (-inf) and whose values are halves in [-2, 2] (many exact ties),
labels on every shard; attention inputs (8 rows, 8 contexts, width 24)
with an all-invalid row and a row valid in the first ctx shard only.

Tolerances, and why:
- the gathered rows and top-k (values and ids) exact: a gather plus
  zeros, and selections (ties by ascending id on both sides);
- f32 cross-entropy, logsumexp, logits, attention outputs and their
  gradients: rtol 1e-5, atol 1e-6 (only the order of f32 sums differs);
- the phases against the unsplit plain versions: the same f32 bounds
  (K15's bf16 gradient planes compared as hi + lo, the f32 value they
  carry); in bf16, dT within one bf16 step of its largest value (a
  shard's sum of w fs adds in another order, which can move a rounding)
  and d a within one step a shard (each rounds its part).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from code2vec_tpu.models.code2vec import ModelDims as JaxDims
from code2vec_tpu.ops import sharded as jax_sharded
from code2vec_tpu.ops.attention import (
    masked_single_query_attention as jax_attention,
)
from code2vec_tpu.parallel import mesh as jax_mesh
from code2vec_tpu.training.step import _shard_map
from code2vec_tpu_torch.data.reader import RowBatch
from code2vec_tpu_torch.kernels import cp_attention as k16
from code2vec_tpu_torch.kernels import sharded as k15
from code2vec_tpu_torch.kernels.encoder import Dropout, dropout_plain
from code2vec_tpu_torch.kernels.softmax_xent import softmax_xent_plain
from code2vec_tpu_torch.models.code2vec import ModelDims
from code2vec_tpu_torch.ops.attention import (
    masked_single_query_attention, masked_single_query_attention_backward,
)
from code2vec_tpu_torch.parallel import mesh
from code2vec_tpu_torch.parallel.comm import LOCAL
from code2vec_tpu_torch.parallel.mesh import MeshPlan
from code2vec_tpu_torch.training.sparse_adam import (
    init_slots, sparse_adam_rows,
)
from code2vec_tpu_torch.training.step import rank_dropout_seed
from code2vec_tpu_torch.weights import shard_params, unshard_params
from torch_rank_child import Ranks

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-6)
B, M, D, V, V_REAL, TD = 8, 8, 24, 20, 17, 8
KS = (1, 3, 7)
PLANS = [MeshPlan(1, 2, 2), MeshPlan(1, 4, 1), MeshPlan(1, 1, 4)]


def _inputs(seed=11):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-3, V + 4, (B, 6)).astype(np.int32)
    logits = (rng.integers(-4, 5, (B, V)) * 0.5).astype(np.float32)
    logits[:, V_REAL:] = -np.inf
    labels = (np.arange(B) * 5 % V_REAL).astype(np.int32)
    t = np.tanh(rng.standard_normal((B, M, D))).astype(np.float32)
    mask = (rng.random((B, M)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    mask[2] = 0.0
    mask[3, 1:] = 0.0
    return {
        "op_table": rng.standard_normal((V, TD)).astype(np.float32),
        "op_ids": ids, "op_logits": logits, "op_labels": labels,
        "op_ks": np.asarray(KS),
        "op_cv": rng.standard_normal((B, D)).astype(np.float32),
        "op_target": rng.standard_normal((V, D)).astype(np.float32),
        "op_t": t, "op_a": rng.standard_normal(D).astype(np.float32),
        "op_mask": mask,
        "op_dcv": rng.standard_normal((B, D)).astype(np.float32),
    }


def _jax_ops(plan, x):
    """The reference's functions under shard_map on the plan's mesh."""
    jmesh = jax_mesh.make_mesh(jax_mesh.MeshPlan(plan.dp, plan.tp, plan.cp))

    def per_shard(table, ids, logits, labels, cv, target, t, a, mask):
        floor = jnp.where(jnp.isfinite(logits), logits, -1e30)
        gmax, lse = jax_sharded.tp_log_softmax_at_topk(logits, "model")
        topk = [jax_sharded.tp_top_k(logits, k, "model") for k in KS]
        cvs, attn = jax_attention(t, a, mask, axis_name="ctx")
        return (jax_sharded.tp_embedding_lookup(table, ids, "model"),
                jax_sharded.tp_softmax_ce(logits, labels, "model"),
                jax_sharded.tp_softmax_ce(floor, labels, "model"),
                gmax, lse, topk,
                jax_sharded.tp_logits(cv, target, jnp.float32), cvs, attn)

    f = _shard_map(
        per_shard, mesh=jmesh,
        in_specs=(P("model", None), P(), P(None, "model"), P(), P(),
                  P("model", None), P(None, "ctx", None), P(),
                  P(None, "ctx")),
        out_specs=(P(), P(), P(), P(), P(), [(P(), P())] * len(KS),
                   P(None, "model"), P(), P(None, "ctx")),
        check_vma=False)
    out = f(x["op_table"], x["op_ids"], x["op_logits"], x["op_labels"],
            x["op_cv"], x["op_target"], x["op_t"], x["op_a"], x["op_mask"])
    return jax.device_get(out)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """plan -> (inputs, the ranks' outputs, the reference's outputs); all
    plans' ranks start at once and run while the reference compiles."""
    x = _inputs()
    started = {}
    for plan in PLANS:
        tmp = tmp_path_factory.mktemp(f"ops{plan.tp}{plan.cp}")
        np.savez(tmp / "inputs.npz", **x)
        started[plan] = Ranks(tmp, plan, ["ops"], str(tmp / "inputs.npz"))
    want = {plan: _jax_ops(plan, x) for plan in PLANS}
    runs = {plan: (x, r.wait(), want[plan]) for plan, r in started.items()}
    return runs.__getitem__


def _id(plan):
    return f"tp{plan.tp}cp{plan.cp}"


def _by(outs, axis, key):
    """`key` joined over the ranks along one axis (index 1 model, 2 ctx)
    at coordinate 0 of the others."""
    parts = sorted((int(o["coords"][axis]), o[key]) for o in outs
                   if all(o["coords"][a] == 0 for a in (0, 1, 2)
                          if a != axis))
    return [p for _, p in parts]


@pytest.mark.parametrize("plan", PLANS, ids=_id)
def test_tp_embedding_lookup_matches_reference(plan, ranks):
    """12a: ids in every shard and outside all of them (zeros)."""
    x, outs, want = ranks(plan)
    for o in outs:
        np.testing.assert_array_equal(o["emb"], np.asarray(want[0]))
    ids = x["op_ids"]
    assert ((ids < 0) | (ids >= V)).any()


@pytest.mark.parametrize("plan", PLANS, ids=_id)
def test_tp_softmax_ce_matches_reference(plan, ranks):
    """12c (and the eval step's -1e30 form): padded -inf columns, the
    label on every shard."""
    x, outs, want = ranks(plan)
    for o in outs:
        np.testing.assert_allclose(o["ce"], np.asarray(want[1]), **F32)
        np.testing.assert_allclose(o["ce_floor"], np.asarray(want[2]),
                                   **F32)
    assert len({int(lab) * plan.tp // V for lab in x["op_labels"]}) == \
        plan.tp


@pytest.mark.parametrize("plan", PLANS, ids=_id)
def test_tp_log_softmax_at_topk_matches_reference(plan, ranks):
    """12d."""
    _, outs, want = ranks(plan)
    for o in outs:
        np.testing.assert_allclose(o["gmax"], np.asarray(want[3]), **F32)
        np.testing.assert_allclose(o["lse"], np.asarray(want[4]), **F32)


@pytest.mark.parametrize("plan", PLANS, ids=_id)
@pytest.mark.parametrize("k", KS)
def test_tp_top_k_matches_reference(plan, k, ranks):
    """12e: K13 twice around the all-gather; ties (the logits are halves)
    go by ascending global id, as lax.top_k orders them."""
    _, outs, want = ranks(plan)
    values, ids = want[5][KS.index(k)]
    for o in outs:
        np.testing.assert_array_equal(o[f"topk{k}_values"],
                                      np.asarray(values))
        np.testing.assert_array_equal(o[f"topk{k}_ids"], np.asarray(ids))


@pytest.mark.parametrize("plan", PLANS, ids=_id)
def test_tp_logits_matches_reference(plan, ranks):
    """12b: each model rank's slice of the logits."""
    _, outs, want = ranks(plan)
    np.testing.assert_allclose(np.concatenate(_by(outs, 1, "logits"), 1),
                               np.asarray(want[6]), **F32)


@pytest.mark.parametrize("plan", PLANS, ids=_id)
def test_context_parallel_attention_matches_reference(plan, ranks):
    """12f forward (K16 at cp > 1): an all-invalid row (weights 0) and a
    row whose later ctx shards hold no valid context."""
    _, outs, want = ranks(plan)
    for o in outs:
        np.testing.assert_allclose(o["att_cv"], np.asarray(want[7]), **F32)
    np.testing.assert_allclose(np.concatenate(_by(outs, 2, "att_w"), 1),
                               np.asarray(want[8]), **F32)


@pytest.mark.parametrize("plan", PLANS, ids=_id)
def test_context_parallel_attention_backward_matches_reference(plan, ranks):
    """12f backward (K17 at cp > 1) against jax.vjp of the unsplit
    reference: d t of each rank's contexts, d a summed over ctx."""
    x, outs, _ = ranks(plan)
    _, vjp = jax.vjp(lambda t, a: jax_attention(t, a, x["op_mask"])[0],
                     x["op_t"], x["op_a"])
    dt, da = jax.device_get(vjp(x["op_dcv"]))
    np.testing.assert_allclose(np.concatenate(_by(outs, 2, "att_dt"), 1),
                               np.asarray(dt), **F32)
    for o in outs:
        np.testing.assert_allclose(o["att_da"], np.asarray(da), **F32)


# ----------------------------- the phases against the unsplit versions


def _shards(n, parts):
    return [slice(i * n // parts, (i + 1) * n // parts)
            for i in range(parts)]


@pytest.mark.parametrize("parts", [1, 2, 4])
def test_shard_gather_and_scatter_compose_to_the_whole_table(parts):
    """K14 on every shard, summed, is the plain gather (zeros outside);
    the scatter-adds into every shard are the whole table's."""
    x = _inputs()
    table = torch.from_numpy(x["op_table"])
    ids = torch.from_numpy(x["op_ids"])
    rows = sum(k15.shard_gather(table[s], ids, s.start)
               for s in _shards(V, parts))
    ok = ((ids >= 0) & (ids < V)).reshape(-1)
    want = torch.zeros(ids.numel(), TD)
    want[ok] = table[ids.reshape(-1)[ok].long()]
    torch.testing.assert_close(rows, want, rtol=0, atol=0)
    grads = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (ids.numel(), TD)).astype(np.float32))
    whole = torch.zeros(V, TD).index_add_(0, ids.reshape(-1)[ok].long(),
                                          grads[ok])
    parts_g = []
    for s in _shards(V, parts):
        g = torch.zeros(s.stop - s.start, TD)
        k15.shard_scatter_add(g, ids, grads, s.start)
        parts_g.append(g)
    torch.testing.assert_close(torch.cat(parts_g), whole, **F32)


@pytest.mark.parametrize("parts", [1, 2, 4])
@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16])
def test_tp_xent_passes_compose_to_k7(parts, grad_dtype):
    """K15's passes over every shard, with the collectives done by hand
    (max, then sums), give K7's plain loss and gradient."""
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.standard_normal((B, V)).astype(
        np.float32) * 3)
    labels = torch.from_numpy((np.arange(B) * 3 % V_REAL).astype(np.int32))
    valid = torch.ones(B)
    valid[1] = 0
    shards = _shards(V, parts)
    n_valid = [k15.valid_columns(s.stop - s.start, s.start, V_REAL)
               for s in shards]
    gmax = torch.stack([k15.tp_xent_max(logits[:, s], s.stop - s.start, n)
                        for s, n in zip(shards, n_valid)]).amax(0)
    stats = sum(k15.tp_xent_sum(logits[:, s].contiguous(), s.stop - s.start,
                                n, gmax, labels, s.start)
                for s, n in zip(shards, n_valid))
    ce = (torch.log(stats[0]) + gmax - stats[1]) * valid
    loss, grad = softmax_xent_plain(logits, labels, valid, n_real=V_REAL,
                                    grad_dtype=grad_dtype)
    torch.testing.assert_close(ce.sum() / B, loss, **F32)
    g = torch.cat([k15.tp_xent_grad(logits[:, s].contiguous(), n, gmax,
                                    stats[0], labels, valid, s.start, B,
                                    grad_dtype)
                   for s, n in zip(shards, n_valid)], dim=-1)
    if grad_dtype == torch.bfloat16:
        g, grad = g[0].float() + g[1].float(), grad[0].float() + \
            grad[1].float()
    torch.testing.assert_close(g, grad, **F32)
    assert (g[:, V_REAL:] == 0).all()


@pytest.mark.parametrize("parts", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cp_attention_phases_compose_to_k2_and_k6(parts, dtype):
    """K16's and K17's phases over every ctx shard, with the collectives
    done by hand, give K2's and K6's plain versions."""
    x = _inputs()
    t = torch.from_numpy(x["op_t"]).to(dtype)
    a = torch.from_numpy(x["op_a"])
    mask = torch.from_numpy(x["op_mask"])
    dcv = torch.from_numpy(x["op_dcv"])
    shards = _shards(M, parts)
    s = [k16.cp_attention_scores(t[:, c].contiguous(), a,
                                 mask[:, c].contiguous()) for c in shards]
    gmax = torch.stack([m for _, m in s]).amax(0)
    e = [k16.cp_attention_exp(sc, gmax) for sc, _ in s]
    den = sum(d for _, d in e)
    parts_cv = [k16.cp_attention_combine(t[:, c].contiguous(), u, den)
                for c, (u, _) in zip(shards, e)]
    cv = sum(p for p, _ in parts_cv)
    attn = torch.cat([w for _, w in parts_cv], dim=1)
    want_cv, want_attn = masked_single_query_attention(t, a, mask)
    torch.testing.assert_close(cv, want_cv, **F32)
    torch.testing.assert_close(attn, want_attn, **F32)
    fs = [k16.cp_attention_backward_fs(t[:, c].contiguous(),
                                       attn[:, c].contiguous(), dcv)
          for c in shards]
    wfs = sum(w for _, w in fs)
    back = [k16.cp_attention_backward_dt(
        t[:, c].contiguous(), a, mask[:, c].contiguous(),
        attn[:, c].contiguous(), f, wfs, dcv)
        for c, (f, _) in zip(shards, fs)]
    want_dt, want_da = masked_single_query_attention_backward(
        t, a, mask, attn, dcv)
    # bf16: a shard's sum of w fs adds in another order, which can move a
    # rounding of dt one bf16 step; d a is rounded once per shard
    def tol(want, rounds=1):
        if dtype == torch.float32:
            return F32
        return dict(rtol=0, atol=2.0 ** -8 * float(want.abs().max())
                    * rounds)
    torch.testing.assert_close(torch.cat([d for d, _ in back], 1).float(),
                               want_dt.float(), **tol(want_dt.float()))
    da = sum(d for _, d in back)
    torch.testing.assert_close(da, want_da, **tol(want_da, parts))


# ----------------------------------------------------- K12, dropout, mesh


def test_sparse_update_drops_the_id_rows_local():
    """K14 maps a foreign id to rows_local, and K12's plain version (as
    the kernel, which tests/test_torch_kernels_cuda.py holds to it)
    updates no row for it."""
    rows_local = 6
    ids = torch.tensor([3, 9, -2, 14], dtype=torch.int32)
    local = k15.shard_local_ids(ids, 8, rows_local)
    torch.testing.assert_close(local, torch.tensor([6, 1, 6, 6],
                                                   dtype=torch.int32))
    table = torch.randn(rows_local, 4)
    slots = init_slots(table, torch.bfloat16)
    before = table.clone()
    grads = torch.ones(4, 4)
    sparse_adam_rows(table, slots, local, grads, t=1, lr=1e-3, b1=0.9,
                     b2=0.999, eps=1e-8)
    changed = (table != before).any(dim=1)
    assert changed.tolist() == [False, True, False, False, False, False]
    assert (slots.nu[0] == 0).all() and (slots.nu[2:] == 0).all()


def test_dropout_keys_fold_in_the_data_and_ctx_coordinates():
    """The model ranks of a (data, ctx) cell draw one mask; other cells
    other masks; the cell (0, 0) draws the single-device mask."""
    plan = MeshPlan(2, 2, 2)
    ctx = torch.ones(4, 6, 24)
    masks = {}
    for i in range(plan.size):
        c = plan.coords(i)
        out = torch.zeros(ctx.shape, dtype=torch.bool)
        dropout_plain(ctx, Dropout(0.75, seed=rank_dropout_seed(
            42, c["data"], c["ctx"]), step=3, out_mask=out))
        masks[(c["data"], c["model"], c["ctx"])] = out
    for d in range(2):
        for c in range(2):
            assert torch.equal(masks[(d, 0, c)], masks[(d, 1, c)])
    assert not torch.equal(masks[(0, 0, 0)], masks[(1, 0, 0)])
    assert not torch.equal(masks[(0, 0, 0)], masks[(0, 0, 1)])
    assert rank_dropout_seed(42, 0, 0) == 42


@pytest.mark.parametrize("tp", [1, 2, 4, 3])
def test_padded_to_matches_reference(tp):
    dims = ModelDims(1301137, 911418, 261246, real_target_vocab_size=261245,
                     target_oov_floor=1)
    jdims = JaxDims(1301137, 911418, 261246, real_target_vocab_size=261245,
                    target_oov_floor=1)
    assert dataclasses.asdict(dims.padded_to(tp)) == \
        dataclasses.asdict(jdims.padded_to(tp))


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 4, 1), (2, 1, 4),
                                   (8, 1, 1)])
def test_mesh_layout_matches_reference(shape):
    """Rank i sits where the reference's device grid puts device i (data
    outermost); the groups along each axis are those of the grid."""
    plan = MeshPlan(*shape)
    grid = np.arange(plan.size).reshape(shape)
    for i in range(plan.size):
        c = plan.coords(i)
        assert grid[c["data"], c["model"], c["ctx"]] == i
    want = sorted(sorted(grid[d, :, c].tolist()) for d in range(shape[0])
                  for c in range(shape[2]))
    assert plan.groups(("model",)) == want
    want = sorted(sorted(grid[:, m, :].reshape(-1).tolist())
                  for m in range(shape[1]))
    assert plan.groups(("data", "ctx")) == want


def test_partition_specs_match_reference():
    for name, spec in mesh.PARAM_SPECS.items():
        assert mesh.replicated_axes_for_spec(spec) == \
            jax_mesh.replicated_axes_for_spec(jax_mesh.PARAM_SPECS[name])
    for name, spec in mesh.BATCH_SPECS.items():
        assert tuple(spec) == tuple(jax_mesh.BATCH_SPECS[name])


def test_batch_slice_takes_the_ranks_rows_and_contexts():
    plan = MeshPlan(2, 2, 2)
    rng = np.random.default_rng(0)
    batch = RowBatch(*[rng.integers(0, 9, (4, 6)).astype(np.int32)
                       for _ in range(3)],
                     rng.random((4, 6)).astype(np.float32),
                     np.arange(4, dtype=np.int32), np.ones(4, bool),
                     target_strings=["a", "b", "c", "d"])
    for i in range(plan.size):
        m = mesh.Mesh(plan, i, torch.device("cpu"), "gloo", {})
        d, c = m.coords["data"], m.coords["ctx"]
        part = mesh.batch_slice(batch, m)
        np.testing.assert_array_equal(
            part.path_indices,
            batch.path_indices[2 * d:2 * d + 2, 3 * c:3 * c + 3])
        np.testing.assert_array_equal(part.target_index, [2 * d, 2 * d + 1])
        assert part.target_strings == batch.target_strings[2 * d:2 * d + 2]


def test_shard_params_round_trip():
    plan = MeshPlan(1, 4, 1)
    x = _inputs()
    tree = {"token_embedding": x["op_table"], "transform": x["op_target"]}
    parts = [shard_params(tree, plan, i) for i in range(4)]
    assert parts[2]["token_embedding"].shape == (5, TD)
    assert torch.equal(parts[3]["transform"], torch.from_numpy(
        x["op_target"]))
    back = unshard_params(parts, plan)
    assert torch.equal(back["token_embedding"],
                       torch.from_numpy(x["op_table"]))
    with pytest.raises(ValueError, match="equal shards"):
        shard_params({"token_embedding": x["op_table"][:19]}, plan, 0)


def test_one_rank_communicator_does_nothing():
    t = torch.arange(6.0)
    assert LOCAL.all_reduce(t, "max") is t and LOCAL.all_gather(t) is t
    assert mesh.local_mesh().comm("data", "ctx") is LOCAL
