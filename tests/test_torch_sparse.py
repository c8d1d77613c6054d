"""The port's sparse-embedding train step against the JAX package, on the
CPU.

Seeded numpy inputs go through both packages: the duplicate combining
and the lazy row Adam (`combine_duplicate_rows`, `sparse_adam_rows`,
the plain version of K12), the row gradients of the encoder (the plain
version of K5's row mode) against `jax.grad` of `apply_from_rows`, the
hybrid optimizer state carried across, three sparse train steps against
`TrainStepBuilder(mesh=None)`, and both facades' sparse runs. On CPU
tensors the port runs the plain versions of its kernels and launches
none; chip_smoke.py holds K12 and K5's row mode against them on the card.

Tolerances, and why:
- F32 (rtol 1e-5, atol 1e-6): the same f32 arithmetic; sums (segment
  sums of duplicate rows, contractions) may run in another order.
- Adam (rtol 1e-6, atol 1e-9 on tables and nu; a bf16 mu equal or one
  bf16 step apart): the update is elementwise in the same operation
  order; only an f32 rounding of the bias correction (f32 pow) or of a
  fused product may differ, and a bf16 mu rounds that value.
- One bf16 step (2^-8 of the largest value of each compared tensor): row
  gradients under bf16 compute, where both sides round an f32 value to
  bf16 and a difference in its last f32 bits moves it one step.
- Train steps: tests/test_torch_train.py's (losses rtol 1e-5 in f32,
  1e-2 in bf16; parameters within 1e-5 + 1e-5 |p| except at most 2% of
  a tensor's elements under bf16, each within 2 lr per step).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from code2vec_tpu.config import Config as JaxConfig
from code2vec_tpu.model_facade import Code2VecModel as JaxModel
from code2vec_tpu.models.code2vec import Code2VecModule as FlaxModule
from code2vec_tpu.models.code2vec import ModelDims as JaxDims
from code2vec_tpu.training import sparse_adam as jsparse
from code2vec_tpu.training.state import create_train_state as jax_state
from code2vec_tpu.training.state import make_optimizer as jax_optimizer
from code2vec_tpu.training.step import TrainStepBuilder as JaxBuilder
from code2vec_tpu_torch import cli, kernels
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.kernels.encoder import context_encoder
from code2vec_tpu_torch.kernels.encoder_backward import (
    encoder_backward_plain, encoder_backward_rows,
)
from code2vec_tpu_torch.kernels.sparse_adam import sparse_adam
from code2vec_tpu_torch.model_facade import Code2VecModel
from code2vec_tpu_torch.models.code2vec import (
    Code2VecModule, ModelDims, RowGrads,
)
from code2vec_tpu_torch.training import sparse_adam as tsparse
from code2vec_tpu_torch.training.state import (
    SPARSE_PARAM_NAMES, create_train_state, make_optimizer,
    split_sparse_dense,
)
from code2vec_tpu_torch.training.step import TrainStepBuilder
from code2vec_tpu_torch.weights import opt_state_from_jax, params_from_jax

from test_torch_train import (
    B, DTYPES, F32, M, PD, TD, V_PATH, V_TGT, V_TOK, _batch, _configs,
    _jax_initial_params, _make_synthetic_dataset, _models, _np,
    _one_bf16_step, _t,
)

pytestmark = pytest.mark.torch_port
# the shapes are tiny; one intra-op thread leaves the CPU cores to the
# other pytest workers
torch.set_num_threads(1)

ADAM = dict(rtol=1e-6, atol=1e-9)
HYPER = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)


def _ids(kind, n, v, rng):
    if kind == "all_unique":
        return rng.permutation(v)[:n].astype(np.int32)
    if kind == "all_same":
        return np.full(n, 3, np.int32)
    return rng.integers(0, max(2, v // 4), n).astype(np.int32)


# ------------------------------------------------- duplicates, row Adam


@pytest.mark.parametrize("kind", ["all_unique", "all_same", "mixed"])
def test_combine_duplicate_rows_matches_jax(kind):
    rng = np.random.default_rng(3)
    ids = _ids(kind, 24, 40, rng)
    grads = rng.standard_normal((24, 8)).astype(np.float32)
    want = jsparse.combine_duplicate_rows(jnp.asarray(ids),
                                          jnp.asarray(grads))
    got = tsparse.combine_duplicate_rows(*_t(ids, grads))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **F32)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # every non-representative position carries exact zeros
    assert not got[1][~got[2]].any()


@pytest.mark.parametrize("steps", [1, 4])
@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_sparse_adam_rows_matches_jax(mu_dtype, steps):
    """Lazy Adam over `steps` steps from a mid-training state, with
    duplicate ids and ids past the table (dropped): the touched rows
    against the reference's, every other row bit-equal to its start."""
    jdt, tdt = DTYPES[mu_dtype]
    rng = np.random.default_rng(11)
    v, d, n = 30, 8, 40
    table0 = rng.standard_normal((v, d)).astype(np.float32)
    mu0 = (rng.standard_normal((v, d)) * 1e-2).astype(np.float32)
    nu0 = (rng.random((v, d)) * 1e-4).astype(np.float32)
    jtable = jnp.asarray(table0)
    jslots = jsparse.RowAdamSlots(mu=jnp.asarray(mu0).astype(jdt),
                                  nu=jnp.asarray(nu0))
    ttable = torch.from_numpy(table0.copy())
    tslots = tsparse.RowAdamSlots(mu=torch.from_numpy(mu0).to(tdt),
                                  nu=torch.from_numpy(nu0.copy()))
    mu_start, touched = tslots.mu.clone(), np.zeros(v, bool)
    before = kernels.launch_counts()
    for step in range(steps):
        ids = rng.integers(0, 20, n).astype(np.int32)
        ids[:3] = [v, v + 5, 10 ** 6]          # past the table: dropped
        touched[ids[(ids >= 0) & (ids < v)]] = True
        grads = (rng.standard_normal((n, d))
                 * 10.0 ** rng.uniform(-4, 0)).astype(np.float32)
        t = 7 + step
        jtable, jslots = jsparse.sparse_adam_rows(
            jtable, jslots, jnp.asarray(ids), jnp.asarray(grads),
            t=jnp.asarray(t, jnp.int32), **HYPER)
        sparse_adam(ttable, tslots, *_t(ids, grads), t=t, **HYPER)
    assert kernels.launch_counts() == before   # the plain version ran
    assert tslots.mu.dtype == tdt and tslots.nu.dtype == torch.float32
    np.testing.assert_allclose(ttable.numpy(), np.asarray(jtable), **ADAM)
    np.testing.assert_allclose(tslots.nu.numpy(), np.asarray(jslots.nu),
                               **ADAM)
    got_mu, want_mu = _np(tslots.mu), _np(jslots.mu)
    step_mu = (2.0 ** -7 if mu_dtype == "bfloat16" else 1e-6) * \
        np.abs(want_mu) + 1e-12
    assert (np.abs(got_mu - want_mu) <= step_mu).all()
    # untouched rows keep every bit
    assert touched.sum() < v
    np.testing.assert_array_equal(ttable.numpy()[~touched], table0[~touched])
    np.testing.assert_array_equal(tslots.nu.numpy()[~touched],
                                  nu0[~touched])
    assert torch.equal(tslots.mu[torch.from_numpy(~touched)],
                       mu_start[torch.from_numpy(~touched)])


# ------------------------------------------------ K5's row mode, plain


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_gradients_match_jax_grad_of_apply_from_rows(dtype):
    """The port's row gradients (K5's row mode through the module's
    row-gradient encoder) against jax.grad of the reference's
    apply_from_rows with respect to the gathered rows; summed by id they
    are the dense mode's table gradients."""
    fmod, params, tmod = _models(dtype, seed=7)
    batch = _batch(7, touched_tokens=12)    # many duplicate ids
    src, pth, tgt, mask, labels, valid = batch

    def loss(rows):
        logits, _, _ = fmod.apply({"params": params}, *rows, mask,
                                  method=FlaxModule.apply_from_rows)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
        return jnp.sum(ce * valid.astype(jnp.float32)) / labels.shape[0]

    rows = (jnp.take(params["token_embedding"], src, axis=0),
            jnp.take(params["path_embedding"], pth, axis=0),
            jnp.take(params["token_embedding"], tgt, axis=0))
    jloss, (g_src, g_path, g_tgt) = jax.value_and_grad(loss)(rows)
    tmod.requires_grad_(True)
    for name in SPARSE_PARAM_NAMES:
        getattr(tmod, name).requires_grad_(False)
    got = RowGrads()
    tsrc, tpth, ttgt, tmask, tlabels, tvalid = _t(*batch)
    cv, _ = tmod.encode(tsrc, tpth, ttgt, tmask, row_grads=got)
    tloss = tmod.train_loss(cv, tlabels, tvalid.float())
    tloss.backward()
    assert tmod.token_embedding.grad is None
    assert tmod.path_embedding.grad is None
    assert got.tok.shape == (2, B, M, TD) and got.path.shape == (B, M, PD)
    assert got.tok.dtype == got.path.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5)
    for g, w, what in ((got.tok[0], g_src, "source rows"),
                       (got.tok[1], g_tgt, "target rows"),
                       (got.path, g_path, "path rows")):
        if dtype == "float32":
            np.testing.assert_allclose(_np(g), _np(w), **F32, err_msg=what)
        else:
            _one_bf16_step(g, w, what)
    # the same backward into dense tables: the rows summed by id
    tmod.requires_grad_(False)
    t, t_lo = context_encoder(tmod.token_embedding, None,
                              tmod.path_embedding, None, tmod.transform,
                              tsrc, tpth, ttgt,
                              compute_dtype=tmod.compute_dtype,
                              residual=True)
    dt = torch.from_numpy(np.random.default_rng(2).standard_normal(
        t.shape).astype(np.float32)).to(t.dtype)
    args = (dt, t, t_lo, tmod.token_embedding.detach(),
            tmod.path_embedding.detach(), tmod.transform.detach(), tsrc,
            tpth, ttgt)
    d_tok, d_path, dw = encoder_backward_plain(
        *args, compute_dtype=tmod.compute_dtype)
    r_tok, r_path, r_dw = encoder_backward_rows(
        *args, compute_dtype=tmod.compute_dtype)
    assert torch.equal(dw, r_dw)
    tok_ids = torch.cat([tsrc.reshape(-1), ttgt.reshape(-1)]).long()
    summed = torch.zeros_like(d_tok).index_add_(
        0, tok_ids, r_tok.reshape(-1, TD).float())
    np.testing.assert_allclose(summed.numpy(), d_tok.numpy(), **F32)
    summed = torch.zeros_like(d_path).index_add_(
        0, tpth.reshape(-1).long(), r_path.reshape(-1, PD).float())
    np.testing.assert_allclose(summed.numpy(), d_path.numpy(), **F32)


# ------------------------------------------------------- the sparse step


def _jax_sparse_state(dtype, **cfg_kw):
    jdt, _ = DTYPES[dtype]
    cfg = JaxConfig(compute_dtype=dtype, dropout_keep_rate=1.0,
                    use_sparse_embedding_update=True, **cfg_kw)
    fmod = FlaxModule(JaxDims(V_TOK, V_PATH, V_TGT, token_dim=TD,
                              path_dim=PD),
                      dropout_keep_rate=1.0, compute_dtype=jdt)
    opt = jax_optimizer(cfg)
    state = jax_state(fmod, opt, jax.random.PRNGKey(1), mesh=None,
                      config=cfg)
    state = state.replace(params=jax.tree.map(lambda x: 3.0 * x,
                                              state.params))
    return cfg, fmod, opt, state


def _port_state(jstate, dtype, sparse=True, **cfg_kw):
    tmod = Code2VecModule(ModelDims(V_TOK, V_PATH, V_TGT, token_dim=TD,
                                    path_dim=PD),
                          compute_dtype=DTYPES[dtype][1], device="cpu",
                          dropout_keep_rate=1.0)
    tmod.load_state_dict(params_from_jax(jax.device_get(jstate.params)))
    config = Config(compute_dtype=dtype, dropout_keep_rate=1.0,
                    use_sparse_embedding_update=sparse, **cfg_kw)
    hyper = make_optimizer(config)
    tstate = create_train_state(tmod, hyper, config)
    return tmod, config, hyper, tstate


def test_opt_state_from_jax_takes_a_hybrid_state():
    _, _, _, jstate = _jax_sparse_state("bfloat16")
    state = opt_state_from_jax(jax.device_get(jstate.opt_state))
    assert isinstance(state, tsparse.HybridOptState)
    assert state.dense.count == 0
    assert sorted(state.dense.mu) == sorted(state.dense.nu) == [
        "attention", "target_embedding", "transform"]
    assert state.dense.mu["transform"].dtype == torch.bfloat16
    assert state.dense.nu["transform"].dtype == torch.bfloat16
    assert sorted(state.slots) == sorted(SPARSE_PARAM_NAMES)
    for name, (rows, dim) in (("token_embedding", (V_TOK, TD)),
                              ("path_embedding", (V_PATH, PD))):
        slot = state.slots[name]
        assert slot.mu.dtype == torch.bfloat16 and slot.mu.shape == (rows,
                                                                     dim)
        assert slot.nu.dtype == torch.float32 and not slot.nu.any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_sparse_steps_match_jax_step(dtype):
    cfg, fmod, opt, jstate = _jax_sparse_state(dtype)
    jstep = JaxBuilder(fmod, opt, cfg, mesh=None).make_train_step(jstate)
    rng = jax.random.PRNGKey(0)
    batches = [_batch(40 + i, b=16, touched_tokens=25) for i in range(4)]
    # one JAX step first: both packages start from its mid-training state
    jstate, _ = jstep(jstate, *batches[0], rng)
    tmod, config, hyper, tstate = _port_state(jstate, dtype)
    assert isinstance(tstate.opt_state, tsparse.HybridOptState)
    tstate.opt_state = opt_state_from_jax(jax.device_get(jstate.opt_state))
    tstate.step = int(jstate.step)
    tstep = TrainStepBuilder(tmod, hyper, config).make_train_step(tstate)
    start = {k: p.detach().clone() for k, p in tstate.params.items()}
    before = kernels.launch_counts()
    for batch in batches[1:]:
        jstate, jloss = jstep(jstate, *batch, rng)
        tstate, tloss = tstep(tstate, *_t(*batch), 0)
        np.testing.assert_allclose(
            float(tloss), float(jloss),
            rtol=1e-5 if dtype == "float32" else 1e-2)
    assert kernels.launch_counts() == before  # CPU: plain versions only
    assert tstate.step == int(jstate.step) == 4
    assert tstate.opt_state.dense.count == 4
    lr_steps = 2 * cfg.learning_rate * 3
    for name, p in tstate.params.items():
        got, want = _np(p), _np(jstate.params[name])
        off = np.abs(got - want) > 1e-5 + 1e-5 * np.abs(want)
        assert np.abs(got - want).max() <= lr_steps + 1e-5, name
        allowed = 0 if dtype == "float32" else 0.02 * got.size
        assert off.sum() <= allowed, (name, int(off.sum()))
    # rows no batch touched (token ids >= 25, path ids >= V_PATH - 5)
    # keep every bit of the table and of both moments
    jslots = jax.device_get(jstate.opt_state.slots)
    for name, first in (("token_embedding", 25),
                        ("path_embedding", V_PATH - 5)):
        assert torch.equal(tstate.params[name][first:], start[name][first:])
        slot = tstate.opt_state.slots[name]
        assert not slot.mu[first:].any() and not slot.nu[first:].any()
        # nu is a sum of squared gradients: held at the gradients'
        # tolerance relative to its largest value (F32 in f32 compute,
        # a few bf16 steps under bf16 compute)
        want = np.asarray(jslots[name].nu)
        tol = 1e-5 if dtype == "float32" else 0.05
        np.testing.assert_allclose(slot.nu.numpy(), want, rtol=tol,
                                   atol=tol * float(np.abs(want).max()))


def test_sparse_step_with_every_row_touched_equals_dense_step():
    """From a fresh state, one step whose batch touches every token and
    path row: lazy Adam is dense Adam there (f32 nu on both sides)."""
    cfg_kw = dict(adam_nu_dtype="float32")
    _, _, _, jstate = _jax_sparse_state("float32")
    rng = np.random.default_rng(4)
    src = (np.arange(B * M) % V_TOK).reshape(B, M).astype(np.int32)
    tgt = rng.integers(0, V_TOK, (B, M)).astype(np.int32)
    pth = (np.arange(B * M) % V_PATH).reshape(B, M).astype(np.int32)
    mask = np.ones((B, M), np.float32)
    labels = rng.integers(1, V_TGT, B).astype(np.int32)
    valid = np.ones(B, bool)
    batch = _t(src, pth, tgt, mask, labels, valid)
    states = {}
    for sparse in (True, False):
        tmod, config, hyper, tstate = _port_state(jstate, "float32",
                                                  sparse=sparse, **cfg_kw)
        step = TrainStepBuilder(tmod, hyper, config).make_train_step(tstate)
        tstate, loss = step(tstate, *batch, 0)
        states[sparse] = (tstate, float(loss))
    (s, ls), (d, ld) = states[True], states[False]
    assert ls == ld
    for name in s.params:
        np.testing.assert_allclose(_np(s.params[name]), _np(d.params[name]),
                                   **ADAM, err_msg=name)
    tables, dense = split_sparse_dense(s.params)
    for name in dense:
        assert torch.equal(s.params[name], d.params[name]), name
    for name in tables:
        slot = s.opt_state.slots[name]
        assert torch.equal(slot.mu, d.opt_state.mu[name]), name
        assert torch.equal(slot.nu, d.opt_state.nu[name]), name


@pytest.mark.parametrize("state_sparse", [False, True])
def test_train_step_refuses_a_state_of_the_other_kind(state_sparse):
    _, _, _, jstate = _jax_sparse_state("float32")
    tmod, config, hyper, tstate = _port_state(jstate, "float32",
                                              sparse=state_sparse)
    config.use_sparse_embedding_update = not state_sparse
    with pytest.raises(ValueError, match="use_sparse_embedding_update"):
        TrainStepBuilder(tmod, hyper, config).make_train_step(tstate)


# -------------------------------------------------------- facades, CLI


def test_sparse_training_through_both_facades(tmp_path):
    """Two epochs of the synthetic dataset with the sparse update through
    both facades from the same initial parameters: loss curves within the
    bf16 tolerance, falling, and no kernel launched on the CPU."""
    prefix = _make_synthetic_dataset(tmp_path)
    jcfg, tcfg = _configs(prefix, use_sparse_embedding_update=True)
    jmodel = JaxModel(jcfg)
    jlosses = []
    make_step = jmodel.builder.make_train_step

    def recording_step_builder(state):
        step = make_step(state)

        def run(state, *arrays):
            state, loss = step(state, *arrays)
            jlosses.append(float(loss))
            return state, loss
        return run

    jmodel.builder.make_train_step = recording_step_builder
    jmodel.train()
    assert isinstance(jmodel.state.opt_state, jsparse.HybridOptState)

    tmodel = Code2VecModel(tcfg)
    tmodel.module.load_state_dict(params_from_jax(jax.device_get(
        _jax_initial_params(jcfg))))
    assert isinstance(tmodel.state.opt_state, tsparse.HybridOptState)
    before = kernels.launch_counts()
    tmodel.train()
    assert kernels.launch_counts() == before
    tlosses = [x for e in tmodel.trainer.epoch_losses for x in e]
    assert len(tmodel.trainer.epoch_losses) == 2
    assert len(tlosses) == len(jlosses) > 6
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-2)
    assert np.mean(tlosses[-3:]) < np.mean(tlosses[:3])


def test_cli_sparse_embedding_update_on_cpu(tmp_path):
    prefix = _make_synthetic_dataset(tmp_path)
    model = cli.main(["train", "--data", prefix, "--epochs", "2",
                      "--batch_size", "16", "--max_contexts", "8",
                      "--sparse_embedding_update", "--device", "cpu"])
    assert model.config.use_sparse_embedding_update
    assert isinstance(model.state.opt_state, tsparse.HybridOptState)
    steps = sum(len(e) for e in model.trainer.epoch_losses)
    assert model.state.step == model.state.opt_state.dense.count == steps > 0
    assert model.module.token_embedding.grad is None
    _, dense = cli.config_from_args(["train", "--data", prefix])
    assert not dense.use_sparse_embedding_update
