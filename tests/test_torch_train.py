"""The port's train path against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages; the
model is tiny (vocabularies of tens of words, dims 8-16, M <= 10,
B <= 16). On CPU tensors the port runs the plain PyTorch versions of its
kernels (K1 train mode, K5-K8); tests/test_torch_kernels_cuda.py and
chip_smoke.py hold the CUDA kernels against those on the card.

Tolerances, and why:
- F32 (rtol 1e-5, atol 1e-6): the same f32 arithmetic; only the order of
  the sums in the contractions differs between XLA and PyTorch.
- One bf16 step (2^-8 of the largest value of each compared tensor):
  where both sides round an f32 value to bf16, a difference in its last
  f32 bits can move the rounded value one bf16 step; a gradient is a sum
  of such terms, so its error stays within a step of its largest entry.
- Adam (rtol 1e-6 on parameters, moments equal or one bf16 step apart):
  the update is elementwise with the same operation order; only an f32
  rounding of the bias correction (f32 pow) or of a product may differ.
- Softmax cross-entropy (rtol 1e-6, atol 1e-7): elementwise f32 plus one
  f32 sum over V per row.
- Train-step losses: rtol 1e-5 (f32), 1e-2 (bf16): the loss is f32, but
  under bf16 compute it comes from parameters updated by gradients that
  may differ by a bf16 step.
- Train-step parameters: within 1e-5 + 1e-5 |p| except where a gradient
  close to 0 flips the sign of an Adam step between the two packages:
  such elements move by at most 2 lr per step, and fewer than 2% of a
  tensor's elements may do so (bf16 compute; none in f32).
"""

import os
import pickle
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from code2vec_tpu.config import Config as JaxConfig
from code2vec_tpu.data.reader import EstimatorAction as JaxAction
from code2vec_tpu.data.reader import PathContextReader as JaxReader
from code2vec_tpu.model_facade import Code2VecModel as JaxModel
from code2vec_tpu.models.code2vec import Code2VecModule as FlaxModule
from code2vec_tpu.models.code2vec import ModelDims as JaxDims
from code2vec_tpu.ops.attention import masked_single_query_attention
from code2vec_tpu.training.state import create_train_state as jax_state
from code2vec_tpu.training.state import make_optimizer as jax_optimizer
from code2vec_tpu.training.step import TrainStepBuilder as JaxBuilder
from code2vec_tpu.vocab import Code2VecVocabs as JaxVocabs
from code2vec_tpu_torch import cli, kernels
from code2vec_tpu_torch.config import Config
from code2vec_tpu_torch.data.reader import EpochEnd
from code2vec_tpu_torch.data.reader import EstimatorAction, PathContextReader
from code2vec_tpu_torch.kernels.adam import adam
from code2vec_tpu_torch.kernels.encoder import Dropout, context_encoder
from code2vec_tpu_torch.kernels.softmax_xent import softmax_xent
from code2vec_tpu_torch.model_facade import Code2VecModel
from code2vec_tpu_torch.models.code2vec import Code2VecModule, ModelDims
from code2vec_tpu_torch.training.loop import NonFiniteLossError, Trainer
from code2vec_tpu_torch.training.state import (
    create_train_state, make_optimizer, num_params,
)
from code2vec_tpu_torch.training.step import TrainStepBuilder
from code2vec_tpu_torch.vocab import Code2VecVocabs
from code2vec_tpu_torch.weights import opt_state_from_jax, params_from_jax

pytestmark = pytest.mark.torch_port
# the shapes are tiny; one intra-op thread leaves the CPU cores to the
# other pytest workers
torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-6)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
V_TOK, V_PATH, V_TGT, TD, PD = 40, 25, 12, 8, 16
B, M = 8, 10


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _one_bf16_step(got, want, what=""):
    got, want = _np(got), _np(want)
    tol = 2.0 ** -8 * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max error {err} > one bf16 step {tol}"


def _batch(seed, b=B, m=M, touched_tokens=30):
    """src/pth/tgt ids, mask (a fully masked row 2), labels and valid
    (row 5 invalid); token ids stay below `touched_tokens`."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, touched_tokens, (b, m)).astype(np.int32)
    pth = rng.integers(0, V_PATH - 5, (b, m)).astype(np.int32)
    tgt = rng.integers(0, touched_tokens, (b, m)).astype(np.int32)
    mask = (rng.random((b, m)) > 0.3).astype(np.float32)
    mask[2] = 0.0
    labels = rng.integers(1, V_TGT, b).astype(np.int32)
    valid = np.ones(b, bool)
    valid[5] = False
    return src, pth, tgt, mask, labels, valid


def _models(dtype, seed=0, keep=1.0):
    """The Flax module with scaled-up random params (so activations and
    gradients are of order one), and the port's module holding them."""
    jdt, tdt = DTYPES[dtype]
    fmod = FlaxModule(JaxDims(V_TOK, V_PATH, V_TGT, token_dim=TD,
                              path_dim=PD),
                      dropout_keep_rate=keep, compute_dtype=jdt)
    src, pth, tgt, mask, _, _ = _batch(seed)
    params = fmod.init(jax.random.PRNGKey(seed), src, pth, tgt,
                       mask)["params"]
    params = jax.tree.map(lambda x: 3.0 * x, params)
    tmod = Code2VecModule(ModelDims(V_TOK, V_PATH, V_TGT, token_dim=TD,
                                    path_dim=PD),
                          compute_dtype=tdt, device="cpu",
                          dropout_keep_rate=keep)
    tmod.load_state_dict(params_from_jax(jax.device_get(params)))
    return fmod, params, tmod


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


# ------------------------------------------------------- K1 in train mode


def _jax_dropout_encoder(params, src, pth, tgt, mask3, keep, jdt):
    """The reference's transform_gathered (:158-177) with its bernoulli
    draw replaced by `mask3`, built from the JAX package's own ops."""
    ctx = jnp.concatenate([jnp.take(params["token_embedding"], src, axis=0),
                           jnp.take(params["path_embedding"], pth, axis=0),
                           jnp.take(params["token_embedding"], tgt, axis=0)],
                          axis=-1).astype(jdt)
    ctx = jnp.where(mask3, ctx / jnp.asarray(keep, ctx.dtype),
                    jnp.zeros((), ctx.dtype))
    return jnp.tanh(jnp.einsum(
        "bmc,cd->bmd", ctx, params["transform"].astype(jdt),
        preferred_element_type=jnp.float32)).astype(jdt)


@pytest.mark.parametrize("keep", [0.75, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_train_mode_matches_reference(dtype, keep):
    fmod, params, tmod = _models(dtype, seed=1)
    src, pth, tgt, _, _, _ = _batch(1)
    mask3 = np.random.default_rng(2).random((B, M, 2 * TD + PD)) < keep
    want = _jax_dropout_encoder(params, src, pth, tgt, mask3, keep,
                                DTYPES[dtype][0])
    before = kernels.launch_counts()
    got = context_encoder(
        tmod.token_embedding.data, None, tmod.path_embedding.data, None,
        tmod.transform.data, *_t(src, pth, tgt), compute_dtype=tmod.compute_dtype,
        dropout=Dropout(keep=keep, mask=torch.from_numpy(mask3)))
    assert kernels.launch_counts() == before  # CPU: plain version
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), **F32)
    else:
        _one_bf16_step(got, want, "K1 train mode")


def test_encoder_keep_one_equals_deterministic_forward():
    _, _, tmod = _models("bfloat16", seed=3)
    src, pth, tgt, _, _, _ = _batch(3)
    args = (tmod.token_embedding.data, None, tmod.path_embedding.data, None,
            tmod.transform.data, *_t(src, pth, tgt))
    det = context_encoder(*args)
    drawn = context_encoder(*args, dropout=Dropout(keep=1.0, seed=7, step=2))
    assert torch.equal(det, drawn)


def test_drawn_mask_is_keyed_by_seed_and_step():
    _, _, tmod = _models("bfloat16", seed=4)
    src, pth, tgt, _, _, _ = _batch(4, b=16)
    args = (tmod.token_embedding.data, None, tmod.path_embedding.data, None,
            tmod.transform.data, *_t(src, pth, tgt))

    def draw(seed, step):
        out = torch.empty((16, M, 2 * TD + PD), dtype=torch.bool)
        context_encoder(*args, dropout=Dropout(keep=0.75, seed=seed,
                                               step=step, out_mask=out))
        return out

    a, b, c = draw(1, 0), draw(1, 0), draw(1, 1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    n = a.numel()  # kept share within 5 sigma of 0.75
    assert abs(float(a.float().mean()) - 0.75) < 5 * (0.75 * 0.25 / n) ** 0.5


# ------------------------------------------------- gradients vs jax.grad


def _jax_loss_and_grads(fmod, params, batch, rng=None):
    src, pth, tgt, mask, labels, valid = batch

    def loss(p):
        logits, _, _ = fmod.apply(
            {"params": p}, src, pth, tgt, mask, deterministic=rng is None,
            rngs=None if rng is None else {"dropout": rng})
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
        return jnp.sum(ce * valid.astype(jnp.float32)) / labels.shape[0]

    return jax.value_and_grad(loss)(params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradients_match_jax_grad(dtype):
    fmod, params, tmod = _models(dtype, seed=5)
    batch = _batch(5, touched_tokens=30)
    jloss, jgrads = _jax_loss_and_grads(fmod, params, batch,
                                        rng=jax.random.PRNGKey(9))
    tmod.requires_grad_(True)
    src, pth, tgt, mask, labels, valid = _t(*batch)
    cv, _ = tmod.encode(src, pth, tgt, mask, deterministic=False,
                        dropout_seed=9)
    loss = tmod.train_loss(cv, labels, valid.float())
    loss.backward()
    if dtype == "float32":
        np.testing.assert_allclose(float(loss.detach()), float(jloss), **F32)
    else:
        np.testing.assert_allclose(float(loss.detach()), float(jloss),
                                   rtol=1e-5)
    for name, p in tmod.named_parameters():
        if dtype == "float32":
            np.testing.assert_allclose(_np(p.grad), _np(jgrads[name]),
                                       **F32, err_msg=name)
        else:
            _one_bf16_step(p.grad, jgrads[name], name)
    # token rows 30.. and path rows 20.. are touched by no id
    assert not tmod.token_embedding.grad[30:].any()
    assert not tmod.path_embedding.grad[V_PATH - 5:].any()


def test_gradients_with_dropout_match_reference_on_the_same_mask():
    """Dropout's backward: the port's gradients with an injected mask
    against jax.grad of the reference's dropout math on that mask."""
    keep = 0.75
    fmod, params, tmod = _models("float32", seed=6, keep=keep)
    src, pth, tgt, mask, labels, valid = _batch(6)
    mask3 = np.random.default_rng(3).random((B, M, 2 * TD + PD)) < keep

    def loss(p):
        t = _jax_dropout_encoder(p, src, pth, tgt, mask3, keep, jnp.float32)
        cv, _ = masked_single_query_attention(t, p["attention"][:, 0], mask)
        logits = cv @ p["target_embedding"].T
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
        return jnp.sum(ce * valid) / B

    jgrads = jax.grad(loss)(params)
    tmod.requires_grad_(True)
    cv, _ = tmod.encode(*_t(src, pth, tgt, mask), deterministic=False,
                        dropout_mask=torch.from_numpy(mask3))
    tmod.train_loss(cv, torch.from_numpy(labels),
                    torch.from_numpy(valid).float()).backward()
    for name, p in tmod.named_parameters():
        np.testing.assert_allclose(_np(p.grad), _np(jgrads[name]), **F32,
                                   err_msg=name)


# --------------------------------------------------------- K7 and K8


def test_softmax_xent_matches_loss_from_logits():
    rng = np.random.default_rng(11)
    b, v = 9, 37
    logits = (3 * rng.standard_normal((b, v))).astype(np.float32)
    labels = rng.integers(0, v, b).astype(np.int32)
    valid = (rng.random(b) > 0.3)
    valid[0], valid[1] = False, True
    builder = JaxBuilder(None, None, JaxConfig())
    jloss, jgrad = jax.value_and_grad(
        lambda x: builder._loss_from_logits(x, labels, valid))(logits)
    for grad_dtype in (torch.float32, torch.bfloat16):
        loss, grad = softmax_xent(*_t(logits, labels),
                                  torch.from_numpy(valid).float(),
                                  grad_dtype=grad_dtype)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
        if grad_dtype == torch.bfloat16:  # hi + lo planes carry the f32 g
            assert grad.shape == (2, b, v)
            grad = grad[0].float() + grad[1].float()
            np.testing.assert_allclose(_np(grad), _np(jgrad), rtol=1e-5,
                                       atol=1e-8)
        else:
            np.testing.assert_allclose(_np(grad), _np(jgrad), rtol=1e-6,
                                       atol=1e-7)
        assert not grad[~torch.from_numpy(valid)].any()


def test_softmax_xent_padded_columns_carry_nothing():
    rng = np.random.default_rng(12)
    logits = rng.standard_normal((4, 10)).astype(np.float32)
    labels = np.array([1, 2, 3, 0], np.int32)
    valid = torch.ones(4)
    full, gfull = softmax_xent(*_t(logits[:, :7], labels), valid,
                               grad_dtype=torch.float32)
    cut, gcut = softmax_xent(*_t(logits, labels), valid, n_real=7,
                             grad_dtype=torch.float32)
    assert torch.equal(full, cut)
    assert torch.equal(gcut[:, :7], gfull) and not gcut[:, 7:].any()


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("mu_dtype,nu_dtype", [
    ("bfloat16", "bfloat16"), ("bfloat16", "float32"),
    ("float32", "float32")])
def test_adam_matches_make_optimizer(mu_dtype, nu_dtype, steps):
    cfg = JaxConfig(adam_mu_dtype=mu_dtype, adam_nu_dtype=nu_dtype)
    opt = jax_optimizer(cfg)
    rng = np.random.default_rng(13)
    shapes = {"token_embedding": (30, 8), "path_embedding": (20, 16),
              "target_embedding": (12, 32), "transform": (32, 32),
              "attention": (32, 1)}
    params = {k: jnp.asarray(rng.standard_normal(s).astype(np.float32))
              for k, s in shapes.items()}
    state = opt.init(params)
    names = list(shapes)
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    hyper = make_optimizer(Config(adam_mu_dtype=mu_dtype,
                                  adam_nu_dtype=nu_dtype))
    # start both from the same mid-training state (one step first)
    for step in range(steps + 1):
        grads = {k: (rng.standard_normal(s) * 10.0 ** rng.uniform(-4, 0)
                     ).astype(np.float32) for k, s in shapes.items()}
        if step == 1:
            tstate = opt_state_from_jax(state)
            tparams = {k: torch.from_numpy(np.array(v))
                       for k, v in params.items()}
        if step >= 1:
            adam([tparams[k] for k in names],
                 [torch.from_numpy(grads[k]) for k in names],
                 [tstate.mu[k] for k in names],
                 [tstate.nu[k] for k in names], tstate.count + 1, hyper)
            tstate.count += 1
        updates, state = opt.update({k: jnp.asarray(g)
                                     for k, g in grads.items()}, state,
                                    params)
        params = optax.apply_updates(params, updates)
    jstate = opt_state_from_jax(state)
    assert jstate.count == tstate.count == steps + 1
    for k in names:
        np.testing.assert_allclose(_np(tparams[k]), _np(params[k]),
                                   rtol=1e-6, atol=0, err_msg=k)
        for which in ("mu", "nu"):
            got = getattr(tstate, which)[k]
            want = getattr(jstate, which)[k]
            assert got.dtype == want.dtype
            step = (2.0 ** -7 if got.dtype == torch.bfloat16 else 2.0 ** -22
                    ) * want.float().abs()
            assert ((got.float() - want.float()).abs() <= step).all(), \
                (k, which)


# ------------------------------------------------------ the train step


def _jax_step_state(dtype, keep=1.0):
    jdt, _ = DTYPES[dtype]
    cfg = JaxConfig(compute_dtype=dtype, dropout_keep_rate=keep)
    fmod = FlaxModule(JaxDims(V_TOK, V_PATH, V_TGT, token_dim=TD,
                              path_dim=PD),
                      dropout_keep_rate=keep, compute_dtype=jdt)
    opt = jax_optimizer(cfg)
    state = jax_state(fmod, opt, jax.random.PRNGKey(1), mesh=None,
                      config=cfg)
    state = state.replace(params=jax.tree.map(lambda x: 3.0 * x,
                                              state.params))
    return cfg, fmod, opt, state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_train_steps_match_jax_step(dtype):
    cfg, fmod, opt, jstate = _jax_step_state(dtype)
    jstep = JaxBuilder(fmod, opt, cfg, mesh=None).make_train_step(jstate)
    rng = jax.random.PRNGKey(0)
    batches = [_batch(20 + i, b=16) for i in range(4)]
    # one JAX step first: both packages start from its mid-training state
    jstate, _ = jstep(jstate, *batches[0], rng)
    tmod = Code2VecModule(ModelDims(V_TOK, V_PATH, V_TGT, token_dim=TD,
                                    path_dim=PD),
                          compute_dtype=DTYPES[dtype][1], device="cpu",
                          dropout_keep_rate=1.0)
    tmod.load_state_dict(params_from_jax(jax.device_get(jstate.params)))
    config = Config(compute_dtype=dtype, dropout_keep_rate=1.0)
    hyper = make_optimizer(config)
    tstate = create_train_state(tmod, hyper)
    tstate.opt_state = opt_state_from_jax(jax.device_get(jstate.opt_state))
    tstate.step = int(jstate.step)
    tstep = TrainStepBuilder(tmod, hyper, config).make_train_step(tstate)
    before = kernels.launch_counts()
    for batch in batches[1:]:
        jstate, jloss = jstep(jstate, *batch, rng)
        tstate, tloss = tstep(tstate, *_t(*batch), 0)
        np.testing.assert_allclose(
            float(tloss), float(jloss),
            rtol=1e-5 if dtype == "float32" else 1e-2)
    assert kernels.launch_counts() == before  # CPU: plain versions only
    assert tstate.step == int(jstate.step) == 4
    assert tstate.opt_state.count == 4
    lr_steps = 2 * cfg.learning_rate * 3
    for name, p in tstate.params.items():
        got, want = _np(p), _np(jstate.params[name])
        off = np.abs(got - want) > 1e-5 + 1e-5 * np.abs(want)
        assert np.abs(got - want).max() <= lr_steps + 1e-5, name
        allowed = 0 if dtype == "float32" else 0.02 * got.size
        assert off.sum() <= allowed, (name, int(off.sum()))


def test_nonfinite_loss_halts_or_warns():
    def step(state, *arrays):
        return state, torch.tensor(float("nan"))

    batch = type("Batch", (), {})()
    (batch.source_token_indices, batch.path_indices,
     batch.target_token_indices, batch.context_valid_mask,
     batch.target_index, batch.example_valid) = _batch(0)
    logs = []
    config = Config(num_batches_to_log_progress=1, verbose_mode=0)
    config.log = logs.append
    with pytest.raises(NonFiniteLossError):
        Trainer(config, step, "cpu").train(None, [batch, EpochEnd(1)], 0)
    config.on_nonfinite_loss = "warn"
    trainer = Trainer(config, step, "cpu")
    trainer.train(None, [batch, batch, EpochEnd(1)], 0)
    assert len(trainer.epoch_losses[0]) == 2
    assert any("Non-finite loss" in m for m in logs)


# ----------------------------------------- vocab, reader, facade, CLI


def _make_synthetic_dataset(tmp_path, n_rows=96, max_contexts=8, seed=0):
    """tests/test_end_to_end.py's learnable dataset: the target follows
    the tokens."""
    rng = random.Random(seed)
    letters = ["alpha", "beta", "gamma", "delta"]
    tokens = [f"tok{i}" for i in range(12)]
    paths = [f"path{i}" for i in range(6)]
    targets = [f"name|{letters[i]}" for i in range(4)]
    rows = []
    for _ in range(n_rows):
        t = rng.randrange(len(targets))
        contexts = []
        for _ in range(rng.randint(3, max_contexts)):
            tok = tokens[t * 3 + rng.randrange(3)]
            contexts.append(f"{tok},{rng.choice(paths)},{tok}")
        pad = " " * (max_contexts - len(contexts))
        rows.append(f"{targets[t]} " + " ".join(contexts) + pad)
    rows.append("name|unknown tok1,path1,tok1")  # OOV target: filtered
    rows.append("name|alpha " + " " * 4)        # no context: filtered
    prefix = str(tmp_path / "synthetic")
    with open(prefix + ".train.c2v", "w") as f:
        f.write("\n".join(rows) + "\n")
    with open(prefix + ".dict.c2v", "wb") as f:
        pickle.dump({w: 10 + i for i, w in enumerate(tokens)}, f)
        pickle.dump({p: 10 for p in paths}, f)
        pickle.dump({t: 10 for t in targets}, f)
        pickle.dump(len(rows), f)
    return prefix


def _configs(prefix, **kw):
    common = dict(train_data_path_prefix=prefix, max_contexts=8,
                  train_batch_size=16, num_train_epochs=2,
                  shuffle_buffer_size=32, dropout_keep_rate=1.0,
                  verbose_mode=0, **kw)
    return (JaxConfig(use_packed_data=False, save_every_epochs=1000,
                      num_batches_to_log_progress=1000, **common),
            Config(device="cpu", num_batches_to_log_progress=2, **common))


@pytest.mark.parametrize("separate", [False, True])
def test_vocabs_from_freq_dicts_match_jax(tmp_path, separate):
    prefix = _make_synthetic_dataset(tmp_path)
    jcfg, tcfg = _configs(prefix, separate_oov_and_pad=separate)
    jv, tv = JaxVocabs.load_or_create(jcfg), Code2VecVocabs.load_or_create(
        tcfg)
    for name in ("token_vocab", "path_vocab", "target_vocab"):
        assert getattr(jv, name).word_to_index == \
            getattr(tv, name).word_to_index


def test_train_reader_matches_jax(tmp_path):
    prefix = _make_synthetic_dataset(tmp_path, n_rows=150)
    jcfg, tcfg = _configs(prefix)
    jv = JaxVocabs.load_or_create(jcfg)
    tv = Code2VecVocabs.load_or_create(tcfg)
    jb = list(JaxReader(jv, jcfg, JaxAction.Train, parse_chunk_lines=40,
                        yield_epoch_markers=True))
    tb = list(PathContextReader(tv, tcfg, EstimatorAction.Train,
                                parse_chunk_lines=40,
                                yield_epoch_markers=True))
    assert len(jb) == len(tb) and any(isinstance(x, EpochEnd) for x in tb)
    for a, b in zip(jb, tb):
        if isinstance(b, EpochEnd):
            assert a.epoch == b.epoch
            continue
        for name in ("source_token_indices", "path_indices",
                     "target_token_indices", "context_valid_mask",
                     "target_index", "example_valid"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_end_to_end_train_through_both_facades(tmp_path):
    """Two epochs of the synthetic dataset through both facades from the
    same initial parameters: the same batches (ids) in the same order, and
    loss curves within the bf16 tolerance."""
    prefix = _make_synthetic_dataset(tmp_path)
    jcfg, tcfg = _configs(prefix)
    jmodel = JaxModel(jcfg)
    jlosses, jbatches = [], []
    make_step = jmodel.builder.make_train_step

    def recording_step_builder(state):
        step = make_step(state)

        def run(state, *arrays):
            jbatches.append([np.asarray(a) for a in arrays[:5]])
            state, loss = step(state, *arrays)
            jlosses.append(float(loss))
            return state, loss
        return run

    jmodel.builder.make_train_step = recording_step_builder
    jmodel.train()

    tmodel = Code2VecModel(tcfg)
    tmodel.module.load_state_dict(params_from_jax(jax.device_get(
        _jax_initial_params(jcfg))))
    tbatches = []
    trainer_cls_step = tmodel.builder.make_train_step

    def recording_port_builder(state):
        step = trainer_cls_step(state)

        def run(state, *arrays):
            tbatches.append([a.numpy() for a in arrays[:5]])
            return step(state, *arrays)
        return run

    tmodel.builder.make_train_step = recording_port_builder
    tmodel.train()
    tlosses = [x for e in tmodel.trainer.epoch_losses for x in e]
    assert len(tmodel.trainer.epoch_losses) == 2
    assert len(tbatches) == len(jbatches) == len(tlosses) > 6
    for a, b in zip(jbatches, tbatches):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-2)
    assert np.mean(tlosses[-3:]) < np.mean(tlosses[:3])


def _jax_initial_params(jcfg):
    """The JAX facade's initial parameters (create_train_state from
    PRNGKey(config.seed)), rebuilt for the port to start from."""
    return JaxModel(jcfg).state.params


def test_cli_train_on_cpu(tmp_path):
    prefix = _make_synthetic_dataset(tmp_path)
    model = cli.main(["train", "--data", prefix, "--epochs", "3",
                      "--batch_size", "16", "--max_contexts", "8",
                      "--device", "cpu"])
    assert model.config.num_train_epochs == 3
    assert model.config.train_batch_size == 16
    assert model.state.step == sum(len(e) for e in
                                   model.trainer.epoch_losses) > 0
    assert num_params(model.state) == sum(
        p.numel() for p in model.module.parameters())


@pytest.mark.parametrize("argv,message", [
    (["train"], "needs --data"),
    (["train", "--data", "x", "--save", "m"], "unrecognized"),
    # --test is now the embed command's corpus, refused for train (the
    # id keeps its name from when argparse did not know the flag)
    pytest.param(["train", "--data", "x", "--test", "t.c2v"],
                 "--test is the `embed` command's corpus",
                 id="argv2-unrecognized"),
    (["serve"], "needs --artifact"),
])
def test_cli_refuses(argv, message, capsys):
    with pytest.raises(SystemExit):
        cli.config_from_args(argv)
    assert message in capsys.readouterr().err


def test_train_refuses_cuda_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the refusal is for hosts without")
    prefix = _make_synthetic_dataset(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        Code2VecModel(Config(train_data_path_prefix=prefix, verbose_mode=0))


def test_opt_state_from_jax_keeps_dtypes():
    cfg = JaxConfig(adam_mu_dtype="bfloat16", adam_nu_dtype="float32")
    params = {k: jnp.ones((3, 2)) for k in
              ("token_embedding", "path_embedding", "target_embedding",
               "transform", "attention")}
    state = opt_state_from_jax(jax_optimizer(cfg).init(params))
    assert state.count == 0
    assert state.mu["transform"].dtype == torch.bfloat16
    assert state.nu["transform"].dtype == torch.float32
