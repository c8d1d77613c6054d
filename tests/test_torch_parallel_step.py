"""The port's parallel train and eval steps (training/step.py
ParallelStepBuilder) on a dp x tp x cp mesh of gloo ranks on the CPU,
against the JAX package's explicit-collective (shard_map) steps on the
8 virtual CPU devices and against the port's single-device steps.

Each plan's ranks run in one spawn of tests/torch_rank_child.py (port
only: no JAX, no conftest), rendezvousing through a file under tmp_path;
the spawn has 60 s and is joined with a deadline. Sizes are tiny:
vocabularies of 42 tokens, 26 paths and 13 targets (OOV and PAD
included) padded to 44 / 28 / 16 rows, so the last target shard holds
padded columns at tp 2 and 4; widths 8 / 8 -> 24; B 8, M 8. Every rank
and both packages start from the JAX package's initial state with its
parameters scaled up (activations and gradients of order one) and zero
moments: the reference's manual gradients are the mesh size times the
true ones (below), which Adam does not see only where every moment came
from the same route. Dropout is off (keep 1.0) against JAX, whose bits
differ; against the port's single-device step one step runs with an
injected mask (keep 0.75), each rank taking its slice.

Tolerances (the parity bar of ROADMAP.md), and why:
- f32 losses rtol 1e-5: the same f32 arithmetic, only the order of the
  sums over ranks and contractions differs.
- f32 parameters after three steps, against the port's single-device
  step: |got - want| <= 1e-5 + 1e-5 |want| everywhere.
- Against the JAX manual step: the same bound, except where Adam's eps
  meets a gradient near 0. The reference differentiates the loss on
  every device and psums each leaf over its replicated axes, so its
  gradients are the mesh size times the true ones (the port computes
  the true ones, which the gradient test holds); Adam's update ignores a
  constant factor except against eps (1e-8), so an element whose
  gradient is within a few eps of 0 moves by at most 2 lr a step
  differently; at most 2% of a tensor's elements may.
- bf16 compute: losses rtol 1e-2; parameters as above with that 2%
  allowance (an f32 difference in a sum can move a bf16 rounding one
  step, which can flip the sign of an Adam step near 0).
- Gradients, leaf by leaf against the port's single-device gradients:
  f32 rtol 1e-5, atol 1e-6.
- Eval: top-k indices exact (no near-ties in these logits, checked;
  exact ties go by ascending id on both sides), values and the loss sum
  rtol 1e-5 (f32).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from code2vec_tpu.config import Config as JaxConfig
from code2vec_tpu.data.reader import RowBatch as JaxRowBatch
from code2vec_tpu.model_facade import Code2VecModel as JaxModel
from code2vec_tpu.models.code2vec import Code2VecModule as FlaxModule
from code2vec_tpu.models.code2vec import ModelDims as JaxDims
from code2vec_tpu.parallel import mesh as jax_mesh_lib
from code2vec_tpu.parallel.mesh import MeshPlan as JaxPlan
from code2vec_tpu.parallel.mesh import make_mesh as jax_make_mesh
from code2vec_tpu.training.state import create_train_state as jax_state
from code2vec_tpu.training.state import make_optimizer as jax_optimizer
from code2vec_tpu.training.state import state_spec_tree
from code2vec_tpu.training.step import TrainStepBuilder as JaxBuilder
from code2vec_tpu.training.step import device_put_batch
from code2vec_tpu_torch import cli
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.models.code2vec import Code2VecModule, ModelDims
from code2vec_tpu_torch.parallel.mesh import MeshPlan
from code2vec_tpu_torch.training.state import (
    create_train_state, make_optimizer,
)
from code2vec_tpu_torch.training.step import TrainStepBuilder
from code2vec_tpu_torch.weights import opt_state_from_jax, params_from_jax
from torch_rank_child import Ranks, spawn_ranks

pytestmark = pytest.mark.torch_port
torch.set_num_threads(1)

NAMES = ("token_embedding", "path_embedding", "target_embedding",
         "transform", "attention")
TABLES = NAMES[:3]
# token, path, target rows (padded to a multiple of 4), widths, the real
# target rows, the OOV/PAD floor
DIMS = (44, 28, 16, 8, 8, 13, 1)
B, M, K, STEPS = 8, 8, 3, 3
F32 = dict(rtol=1e-5, atol=1e-6)
PLANS = [MeshPlan(2, 2, 2), MeshPlan(1, 4, 1), MeshPlan(2, 1, 4)]
FIELDS = ("src", "pth", "tgt", "mask", "labels", "valid")


# ------------------------------------------------------------ the inputs


def _batch(rng):
    src = rng.integers(0, 42, (B, M)).astype(np.int32)
    pth = rng.integers(0, 26, (B, M)).astype(np.int32)
    tgt = rng.integers(0, 42, (B, M)).astype(np.int32)
    mask = (rng.random((B, M)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    mask[2] = 0.0            # an all-invalid row
    mask[3, 1:] = 0.0        # valid in the first ctx shard only
    labels = rng.integers(2, 13, B).astype(np.int32)
    labels[6] = 1            # OOV: no eval loss
    valid = np.ones(B, bool)
    valid[5] = False
    return dict(zip(FIELDS, (src, pth, tgt, mask, labels, valid)))


def _jax_batch(b):
    return JaxRowBatch(source_token_indices=b["src"], path_indices=b["pth"],
                       target_token_indices=b["tgt"],
                       context_valid_mask=b["mask"],
                       target_index=b["labels"], example_valid=b["valid"])


def _jax_config(cd, sparse, plan=None, keep=1.0, manual=True):
    plan = plan or MeshPlan()
    return JaxConfig(train_data_path_prefix="unused", compute_dtype=cd,
                     train_batch_size=B, test_batch_size=B, max_contexts=M,
                     dropout_keep_rate=keep, adam_nu_dtype="float32",
                     use_sparse_embedding_update=sparse, dp=plan.dp,
                     tp=plan.tp, cp=plan.cp, use_manual_tp_kernels=manual,
                     top_k_words_considered_during_prediction=K)


def _jax_module(cd):
    dims = JaxDims(*DIMS[:3], token_dim=DIMS[3], path_dim=DIMS[4],
                   real_target_vocab_size=DIMS[5], target_oov_floor=DIMS[6])
    jdt = jnp.float32 if cd == "float32" else jnp.bfloat16
    return FlaxModule(dims=dims, dropout_keep_rate=1.0, compute_dtype=jdt)


def _bits(t):
    """A moment for the npz: bf16 as its uint16 bits, f32 as it is."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


class Case:
    """One compute dtype's inputs: the mid-training states, batches and
    the JAX package's and the port's single-device results."""

    def __init__(self, cd):
        self.cd = cd
        self._jax = {}
        rng = np.random.default_rng(3)
        self.batches = [_batch(rng) for _ in range(STEPS + 1)]
        self.drop_mask = rng.random((B, M, 24)) < 0.75
        self.start = {}
        for sparse in (False, True):
            cfg = _jax_config(cd, sparse)
            module = _jax_module(cd)
            opt = jax_optimizer(cfg)
            state = jax_state(module, opt, jax.random.PRNGKey(7), mesh=None,
                              config=cfg)
            state = state.replace(params=jax.tree.map(lambda x: 3.0 * x,
                                                      state.params))
            self.start[sparse] = jax.device_get(state)

    def inputs(self):
        out = {"dims": np.asarray(DIMS), "names": np.asarray(NAMES),
               "compute_dtype": np.asarray(self.cd),
               "mu_dtype": np.asarray("bfloat16"),
               "nu_dtype": np.asarray("float32"), "k": np.asarray(K),
               "n_steps": np.asarray(STEPS), "drop_mask": self.drop_mask}
        for i, b in enumerate(self.batches[:STEPS + 1]):
            out.update({f"b{i}_{f}": a for f, a in b.items()})
        for sparse, prefix in ((False, "d_"), (True, "s_")):
            st = self.start[sparse]
            out.update({f"{prefix}p_{n}": np.asarray(st.params[n], np.float32)
                        for n in NAMES})
            opt = opt_state_from_jax(st.opt_state)
            dense = opt.dense if sparse else opt
            out.update({f"{prefix}mu_{n}": _bits(v)
                        for n, v in dense.mu.items()})
            out.update({f"{prefix}nu_{n}": _bits(v)
                        for n, v in dense.nu.items()})
            for n, s in getattr(opt, "slots", {}).items():
                out[f"{prefix}smu_{n}"] = _bits(s.mu)
                out[f"{prefix}snu_{n}"] = _bits(s.nu)
            out[f"{prefix}count"] = np.asarray(dense.count)
            out[f"{prefix}step"] = np.asarray(int(st.step))
        return out

    # ------------------------------------------------- the references

    def port_single(self, sparse, keep=1.0, mask=None, steps=None):
        """The port's single-device step from the same state: (losses,
        params, state)."""
        cfg = Config(compute_dtype=self.cd, dropout_keep_rate=keep,
                     use_sparse_embedding_update=sparse,
                     adam_nu_dtype="float32")
        module = self.port_module(keep)
        st = self.start[sparse]
        module.load_state_dict(params_from_jax(st.params))
        hyper = make_optimizer(cfg)
        state = create_train_state(module, hyper, cfg)
        state.opt_state = opt_state_from_jax(st.opt_state)
        state.step = int(st.step)
        step = TrainStepBuilder(module, hyper, cfg).make_train_step(state)
        losses = []
        for b in steps or self.batches[1:STEPS + 1]:
            state, loss = step(state, *_tensors(b), 0, dropout_mask=mask)
            losses.append(float(loss))
        return losses, {n: p.detach().numpy()
                        for n, p in state.params.items()}

    def port_module(self, keep=1.0):
        dims = ModelDims(*DIMS[:3], token_dim=DIMS[3], path_dim=DIMS[4],
                         real_target_vocab_size=DIMS[5],
                         target_oov_floor=DIMS[6])
        return Code2VecModule(dims, compute_dtype=getattr(torch, self.cd),
                              device="cpu", dropout_keep_rate=keep)

    def jax_manual(self, plan, sparse, manual=True):
        """The JAX manual steps (or with `manual` false, its GSPMD steps)
        on the plan's mesh from the same state: (losses, params, eval
        outputs of batch 0 from the start state); memoised."""
        key = (plan, sparse, manual)
        if key not in self._jax:
            self._jax[key] = self._jax_mesh_steps(plan, sparse, manual)
        return self._jax[key]

    def _jax_mesh_steps(self, plan, sparse, manual):
        cfg = _jax_config(self.cd, sparse, plan, manual=manual)
        module = _jax_module(self.cd)
        mesh = jax_make_mesh(JaxPlan(plan.dp, plan.tp, plan.cp))
        start = self.start[sparse]
        state = jax.device_put(start, jax_mesh_lib.shardings(
            mesh, state_spec_tree(start)))
        builder = JaxBuilder(module, jax_optimizer(cfg), cfg, mesh=mesh)
        assert builder.manual == manual
        ev = None
        if not sparse:
            ev = jax.device_get(builder.make_eval_step(state, k=K)(
                state.params, *device_put_batch(
                    _jax_batch(self.batches[0]), mesh)))
        step = builder.make_train_step(state)
        losses = []
        for b in self.batches[1:STEPS + 1]:
            state, loss = step(state, *device_put_batch(_jax_batch(b), mesh),
                               jax.random.PRNGKey(0))
            losses.append(float(loss))
        return losses, {n: np.asarray(jax.device_get(state.params[n]),
                                      np.float32) for n in NAMES}, ev


def _tensors(b):
    return [torch.from_numpy(np.ascontiguousarray(b[f])) for f in FIELDS]


_CASES = {}


def case(cd):
    if cd not in _CASES:
        _CASES[cd] = Case(cd)
    return _CASES[cd]


RUNS = PLANS + [MeshPlan(2, 2, 2)]   # the last in bf16


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(plan, dtype) -> the ranks' outputs: every run's ranks start at
    once, and the references compute while they run."""
    started = {}
    for i, plan in enumerate(RUNS):
        cd = "bfloat16" if i == len(PLANS) else "float32"
        tmp = tmp_path_factory.mktemp(f"mesh{plan.dp}{plan.tp}{plan.cp}{cd}")
        path = str(tmp / "inputs.npz")
        np.savez(path, **case(cd).inputs())
        started[(plan, cd)] = Ranks(tmp, plan, ["steps"], path)
    for plan in PLANS:   # the JAX manual steps compile meanwhile
        for sparse in (False, True):
            case("float32").jax_manual(plan, sparse)
    for sparse in (False, True):
        case("float32").jax_manual(PLANS[0], sparse, manual=False)
    done = {key: r.wait() for key, r in started.items()}

    def get(plan, cd="float32"):
        return done[(plan, cd)]
    return get


def joined(outs, plan, key):
    """The full tensor from the ranks' parts: the tables' row shards of
    the ranks at data 0, ctx 0 by model coordinate; other leaves rank
    0's."""
    by_model = {}
    for o in outs:
        d, m, c = o["coords"]
        if d == 0 and c == 0:
            by_model[int(m)] = o[key]
    if any(key.endswith(t) for t in TABLES) and plan.tp > 1:
        return np.concatenate([by_model[m] for m in range(plan.tp)])
    return by_model[0]


def rows_of(outs, plan, key):
    """A per-row output joined over the data ranks (model 0, ctx 0)."""
    parts = sorted((int(o["coords"][0]), o[key]) for o in outs
                   if o["coords"][1] == 0 and o["coords"][2] == 0)
    return np.concatenate([p for _, p in parts])


def assert_params(got, want, *, flips_allowed, steps=STEPS, lr=1e-3,
                  what=""):
    for n in NAMES:
        g, w = got[n], want[n]
        assert g.shape == w.shape, (what, n)
        off = np.abs(g - w) > 1e-5 + 1e-5 * np.abs(w)
        assert np.abs(g - w).max() <= 2 * lr * steps + 1e-5, (what, n)
        allowed = 0.02 * g.size if flips_allowed else 0
        assert off.sum() <= allowed, (what, n, int(off.sum()))


def _id(plan):
    return f"dp{plan.dp}tp{plan.tp}cp{plan.cp}"


# ------------------------------------------------------------------ tests


@pytest.mark.parametrize("plan", PLANS, ids=_id)
@pytest.mark.parametrize("mode", ["dense", "sparse"])
def test_steps_match_single_device_and_jax_manual(plan, mode, runs):
    outs = runs(plan)
    c = case("float32")
    sparse = mode == "sparse"
    got = {n: joined(outs, plan, f"{mode}_p_{n}") for n in NAMES}
    losses = outs[0][f"{mode}_losses"]
    for o in outs:   # one loss on every rank
        np.testing.assert_array_equal(o[f"{mode}_losses"], losses)
        assert int(o[f"{mode}_step"]) == int(c.start[sparse].step) + STEPS
    want_losses, want = c.port_single(sparse)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    assert_params(got, want, flips_allowed=False, what="single device")
    jax_losses, jax_params, _ = c.jax_manual(plan, sparse)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5)
    assert_params(got, jax_params, flips_allowed=True, what="jax manual")


@pytest.mark.parametrize("mode", ["dense", "sparse"])
def test_steps_match_jax_gspmd(mode, runs):
    """`--gspmd` runs the same explicit-collective steps in the port; they
    equal the reference's GSPMD steps (whose gradients are the true ones,
    as the port's: no eps allowance)."""
    plan = PLANS[0]
    outs = runs(plan)
    losses, params, _ = case("float32").jax_manual(plan, mode == "sparse",
                                                   manual=False)
    np.testing.assert_allclose(outs[0][f"{mode}_losses"], losses,
                               rtol=1e-5)
    got = {n: joined(outs, plan, f"{mode}_p_{n}") for n in NAMES}
    assert_params(got, params, flips_allowed=False, what="jax gspmd")


@pytest.mark.parametrize("plan", PLANS, ids=_id)
def test_gradients_match_single_device_leaf_by_leaf(plan, runs):
    outs = runs(plan)
    c = case("float32")
    module = c.port_module()
    module.load_state_dict(params_from_jax(c.start[False].params))
    cfg = Config(compute_dtype="float32", dropout_keep_rate=1.0)
    state = create_train_state(module, make_optimizer(cfg), cfg)
    src, pth, tgt, mask, labels, valid = _tensors(c.batches[0])
    cv, _ = module.encode(src, pth, tgt, mask, deterministic=False,
                          dropout_step=state.step)
    loss = module.train_loss(cv, labels, valid.float())
    loss.backward()
    np.testing.assert_allclose(float(outs[0]["grad_loss"]),
                               float(loss.detach()), rtol=1e-5)
    for n in NAMES:
        np.testing.assert_allclose(
            joined(outs, plan, f"grad_{n}"),
            state.params[n].grad.numpy(), err_msg=n, **F32)


@pytest.mark.parametrize("plan", PLANS, ids=_id)
def test_eval_step_matches_single_device_and_jax_manual(plan, runs):
    outs = runs(plan)
    c = case("float32")
    module = c.port_module()
    module.load_state_dict(params_from_jax(c.start[False].params))
    cfg = Config(compute_dtype="float32", topk_block_size=5,
                 top_k_words_considered_during_prediction=K)
    params = {n: p.detach() for n, p in module.named_parameters()}
    want = TrainStepBuilder(module, make_optimizer(cfg), cfg).make_eval_step()(
        params, *_tensors(c.batches[0]))
    _, _, jax_ev = c.jax_manual(plan, sparse=False)
    values = rows_of(outs, plan, "eval_topk_values")
    indices = rows_of(outs, plan, "eval_topk_indices")
    cv = rows_of(outs, plan, "eval_code_vectors")
    # no near-ties: the top-k values of a row are apart, or exactly equal
    # (the all-invalid row's logits are all 0: equal values go by id)
    gaps = np.diff(-want.topk_values.numpy(), axis=1)
    assert ((gaps == 0) | (gaps > 1e-4)).all()
    for ref_values, ref_indices, ref_loss, ref_cv in (
            (want.topk_values.numpy(), want.topk_indices.numpy(),
             float(want.loss_sum), want.code_vectors.numpy()),
            (np.asarray(jax_ev.topk_values), np.asarray(jax_ev.topk_indices),
             float(jax_ev.loss_sum), np.asarray(jax_ev.code_vectors))):
        np.testing.assert_array_equal(indices, ref_indices)
        np.testing.assert_allclose(values, ref_values, **F32)
        np.testing.assert_allclose(cv, ref_cv, **F32)
        for o in outs:
            np.testing.assert_allclose(float(o["eval_loss_sum"]), ref_loss,
                                       rtol=1e-5)
    assert indices.max() < DIMS[5]   # padded targets never win


@pytest.mark.parametrize("plan", PLANS, ids=_id)
def test_dropout_mask_slices_match_single_device(plan, runs):
    """One dense step with an injected (B, M, 3d) mask at keep 0.75, each
    rank on its slice, equals the single-device step with the mask."""
    outs = runs(plan)
    c = case("float32")
    losses, want = c.port_single(False, keep=0.75,
                                 mask=torch.from_numpy(c.drop_mask),
                                 steps=[c.batches[1]])
    np.testing.assert_allclose(float(outs[0]["drop_loss"]), losses[0],
                               rtol=1e-5)
    got = {n: joined(outs, plan, f"drop_p_{n}") for n in NAMES}
    assert_params(got, want, flips_allowed=False, steps=1)


@pytest.mark.parametrize("plan", PLANS, ids=_id)
def test_replicas_stay_bit_equal(plan, runs):
    """The ranks that hold one shard (or a replicated leaf) hold the same
    bits after the steps: every update is the same on each of them."""
    outs = runs(plan)
    for mode in ("dense", "sparse"):
        for n in NAMES:
            first = {}
            for o in outs:
                m = int(o["coords"][1]) if n in TABLES else 0
                first.setdefault(m, o[f"{mode}_p_{n}"])
                np.testing.assert_array_equal(o[f"{mode}_p_{n}"], first[m],
                                              err_msg=f"{mode} {n}")


def test_bf16_steps_match_single_device(runs):
    plan = MeshPlan(2, 2, 2)
    outs = runs(plan, "bfloat16")
    c = case("bfloat16")
    for mode in ("dense", "sparse"):
        losses, want = c.port_single(mode == "sparse")
        np.testing.assert_allclose(outs[0][f"{mode}_losses"], losses,
                                   rtol=1e-2)
        got = {n: joined(outs, plan, f"{mode}_p_{n}") for n in NAMES}
        assert_params(got, want, flips_allowed=True, what=mode)


# ------------------------------------------------------ facade and CLI


def _facade_dataset(tmp_path, n_rows=96, max_contexts=8, seed=0):
    """tests/test_end_to_end.py's learnable dataset (the target follows
    the tokens) with odd vocabularies (13 tokens, 7 paths, 5 targets
    before PAD and OOV), so the tables pad where tp 2 needs it."""
    import pickle
    import random
    rng = random.Random(seed)
    letters = ["alpha", "beta", "gamma", "delta", "eps"]
    tokens = [f"tok{i}" for i in range(13)]
    paths = [f"path{i}" for i in range(7)]
    targets = [f"name|{letters[i]}" for i in range(5)]
    rows = []
    for _ in range(n_rows):
        t = rng.randrange(4)
        contexts = []
        for _ in range(rng.randint(3, max_contexts)):
            tok = tokens[t * 3 + rng.randrange(3)]
            contexts.append(f"{tok},{rng.choice(paths)},{tok}")
        pad = " " * (max_contexts - len(contexts))
        rows.append(f"{targets[t]} " + " ".join(contexts) + pad)
    prefix = str(tmp_path / "synthetic")
    with open(prefix + ".train.c2v", "w") as f:
        f.write("\n".join(rows) + "\n")
    with open(prefix + ".dict.c2v", "wb") as f:
        pickle.dump({w: 10 + i for i, w in enumerate(tokens)}, f)
        pickle.dump({p: 10 for p in paths}, f)
        pickle.dump({t: 10 for t in targets}, f)
        pickle.dump(len(rows), f)
    return prefix


def test_train_tp2_through_the_facade_matches_jax_facade(tmp_path,
                                                         monkeypatch):
    """`train --tp 2 --test` on two processes against the JAX facade at
    dp1 tp2 cp1, both from the JAX facade's initial parameters: the
    losses (bf16 compute: rtol 1e-2) and the evaluation's metrics."""
    monkeypatch.chdir(tmp_path)   # the JAX evaluator writes ./log.txt
    prefix = _facade_dataset(tmp_path)
    test_file = prefix + ".train.c2v"
    common = dict(train_data_path_prefix=prefix, max_contexts=8,
                  train_batch_size=16, test_batch_size=16,
                  num_train_epochs=2, shuffle_buffer_size=32,
                  dropout_keep_rate=1.0, verbose_mode=0, tp=2,
                  test_data_path=test_file)
    jcfg = JaxConfig(use_packed_data=False, save_every_epochs=1000,
                     num_batches_to_log_progress=1000, **common)
    jmodel = JaxModel(jcfg)
    assert jmodel.builder.manual
    params = {f"p_{k}": np.asarray(v, np.float32)
              for k, v in jax.device_get(jmodel.state.params).items()}
    jlosses = []
    make_step = jmodel.builder.make_train_step

    def recording(state):
        step = make_step(state)

        def run(state, *arrays):
            state, loss = step(state, *arrays)
            jlosses.append(float(loss))
            return state, loss
        return run

    jmodel.builder.make_train_step = recording
    jmodel.train()
    jeval = jmodel._evaluate_with_params(jmodel.state.params)
    np.savez(tmp_path / "inputs.npz", **params)
    argv = ["train", "--data", prefix, "--epochs", "2", "--batch_size",
            "16", "--max_contexts", "8", "--tp", "2", "--test", test_file,
            "--no_packed_data", "--device", "cpu", "--dist_init",
            f"file://{tmp_path}/rendezvous", "--eval_log",
            str(tmp_path / "port_log.txt")]
    outs = spawn_ranks(tmp_path, 2, ["facade"], str(tmp_path / "inputs.npz"),
                       extra={"argv": argv,
                              "config": {"dropout_keep_rate": 1.0,
                                         "shuffle_buffer_size": 32}})
    tlosses = outs[0]["losses"]
    np.testing.assert_array_equal(outs[1]["losses"], tlosses)
    assert len(tlosses) == len(jlosses) > 6
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-2)
    assert np.mean(tlosses[-3:]) < np.mean(tlosses[:3])
    final = outs[0]["eval"][-1]
    np.testing.assert_array_equal(outs[1]["eval"], outs[0]["eval"])
    want = [*jeval.topk_acc, jeval.subtoken_precision,
            jeval.subtoken_recall, jeval.subtoken_f1]
    np.testing.assert_allclose(final[:-1], want, atol=0.05)
    np.testing.assert_allclose(final[-1], jeval.loss, rtol=2e-2)
    assert os.path.isfile(tmp_path / "port_log.txt")


@pytest.mark.parametrize("flag", ["--save", "--load"])
def test_save_and_load_on_a_mesh_are_refused(flag, tmp_path, capsys):
    argv = ["train", "--data", str(tmp_path / "d"), "--tp", "2", flag,
            str(tmp_path / "m")]
    if flag == "--load":
        (tmp_path / "m").mkdir()
    with pytest.raises(SystemExit):
        cli.config_from_args(argv)
    assert "not ported yet" in capsys.readouterr().err


@pytest.mark.parametrize("argv,message", [
    (["train", "--data", "d", "--cp", "3", "--max_contexts", "8"],
     "divisible by the context-parallel degree"),
    (["train", "--data", "d", "--dp", "3", "--batch_size", "16"],
     "divisible by the data-parallel degree"),
    (["serve", "--artifact", "a", "--tp", "2"], "runs `train`"),
])
def test_mesh_config_checks(argv, message, capsys):
    with pytest.raises(SystemExit):
        cli.config_from_args(argv)
    assert message in capsys.readouterr().err


def test_gspmd_flag_runs_the_same_steps():
    """`--gspmd` is accepted for the reference's command line and changes
    nothing: the config, and so the step, is the one without it."""
    _, gspmd = cli.config_from_args(["train", "--data", "d", "--tp", "2",
                                     "--gspmd"])
    _, manual = cli.config_from_args(["train", "--data", "d", "--tp", "2"])
    assert gspmd == manual


def test_plan_must_match_the_process_count(tmp_path):
    """A mesh plan of 2 ranks in a run of one process raises."""
    import torch.distributed as dist

    from code2vec_tpu_torch.parallel import distributed
    from code2vec_tpu_torch.parallel.mesh import make_mesh
    assert distributed.initialize(f"file://{tmp_path}/rdv", 1, 0,
                                  timeout_s=30) is False
    try:
        with pytest.raises(ValueError, match="processes run it"):
            make_mesh(MeshPlan(tp=2))
        assert make_mesh(MeshPlan()).plan.size == 1
    finally:
        dist.destroy_process_group()


class _RecordingComm:
    """A communicator of `size` ranks that all hold this rank's values:
    it records each collective's shape and returns what the group would
    if every rank were this one."""

    def __init__(self, size, index, calls):
        self.size, self.index, self.calls = size, index, calls

    def all_reduce(self, t, op="sum"):
        self.calls.append((f"all_reduce_{op}", t.numel()))
        if op == "sum":
            t.mul_(self.size)
        return t

    def all_gather(self, t):
        self.calls.append(("all_gather", t.numel()))
        return torch.cat([t] * self.size)


def test_sparse_step_exchanges_rows_not_tables():
    """The sparse step gathers the ids and gradient rows of the batch and
    all-reduces no table gradient (the property the reference pins in its
    HLO, tests/test_hlo_regression.py); the dense step all-reduces its
    table shards' gradients over data and ctx."""
    from code2vec_tpu_torch.parallel.mesh import Mesh
    from code2vec_tpu_torch.training.state import sharded_train_state
    from code2vec_tpu_torch.training.step import ParallelStepBuilder
    plan = MeshPlan(2, 2, 2)
    c = case("float32")
    dims = ModelDims(*DIMS[:3], token_dim=DIMS[3], path_dim=DIMS[4],
                     real_target_vocab_size=DIMS[5],
                     target_oov_floor=DIMS[6])
    b = {f: (a[:B // 2, :M // 2] if a.ndim == 2 else a[:B // 2])
         for f, a in c.batches[1].items()}
    # the token and path shards' gradient, one all-reduce in the dense step
    tables = (DIMS[0] * DIMS[3] + DIMS[1] * DIMS[4]) // plan.tp
    ids = 2 * (B // 2) * (M // 2)   # the sources' and the targets' token ids
    for sparse in (True, False):
        calls = []
        comms = {axes: _RecordingComm(plan.size // 2 if len(axes) == 1
                                      else 4, 0, calls)
                 for axes in (("data",), ("model",), ("ctx",),
                              ("data", "ctx"))}
        mesh = Mesh(plan, 0, torch.device("cpu"), "gloo", comms)
        cfg = Config(compute_dtype="float32", dropout_keep_rate=1.0,
                     use_sparse_embedding_update=sparse, dp=2, tp=2, cp=2)
        hyper = make_optimizer(cfg)
        st = sharded_train_state(
            {n: np.asarray(c.start[sparse].params[n], np.float32)
             for n in NAMES}, hyper, cfg, mesh)
        step = ParallelStepBuilder(dims, hyper, cfg,
                                   mesh).make_train_step(st)
        step(st, *_tensors(b), 0)
        assert (("all_reduce_sum", tables) in calls) != sparse, calls
        if sparse:
            assert ("all_gather", ids) in calls
            assert ("all_gather", ids * DIMS[3]) in calls   # their rows
