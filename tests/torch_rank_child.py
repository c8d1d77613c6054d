"""One rank of a mesh for tests/test_torch_sharded.py and
tests/test_torch_parallel_step.py — NOT a pytest module.

It imports torch and code2vec_tpu_torch only (no JAX, no conftest), joins
a gloo process group through a `file://` rendezvous, builds the mesh of
the spec's plan on the CPU, runs the spec's tasks on its slice of the
inputs and writes what it computed to OUT/rank<R>.npz:

- `ops`: 12a-12f (ops/sharded.py, ops/attention.py) on the `op_*`
  inputs: the table row-split over model, the logits' columns split over
  model, the attention inputs' contexts split over ctx;
- `steps`: the parallel dense step's gradients, the eval step, three
  dense and three sparse steps from the `d_*` / `s_*` states, and one
  dense step with an injected dropout mask (keep 0.75);
- `facade`: `train` through Code2VecModel from the spec's argv (and
  config fields the command line has no flag for), starting from the
  `p_*` parameters.

Usage: python tests/torch_rank_child.py SPEC.json RANK
(`Ranks` and `spawn_ranks` below start the ranks from a test.)
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from code2vec_tpu_torch.parallel import distributed  # noqa: E402
from code2vec_tpu_torch.parallel.mesh import (  # noqa: E402
    AXIS_CTX, AXIS_DATA, AXIS_MODEL, MeshPlan, make_mesh,
)

torch.set_num_threads(1)
CHILD = os.path.abspath(__file__)
SPAWN_TIMEOUT_S = 60
BATCH_FIELDS = ("src", "pth", "tgt", "mask", "labels", "valid")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cols(a, parts, index, axis):
    n = a.shape[axis] // parts
    return np.take(a, np.arange(index * n, (index + 1) * n), axis=axis)


class Ranks:
    """(In the test process.) This script started once per rank of a
    mesh plan (or a world size); `wait` joins them within the deadline,
    counted from the start, and returns each rank's outputs, or raises
    with the first failed rank's log."""

    def __init__(self, tmp, plan_or_world, tasks, inputs_path, extra=None):
        plan = plan_or_world if isinstance(plan_or_world, MeshPlan) else None
        self.tmp = str(tmp)
        self.world = plan.size if plan else int(plan_or_world)
        spec = {"init": f"file://{self.tmp}/rendezvous",
                "world": self.world, "tasks": tasks, "inputs": inputs_path,
                "out": self.tmp, "timeout": SPAWN_TIMEOUT_S, **(extra or {})}
        if plan:
            spec["plan"] = dict(dp=plan.dp, tp=plan.tp, cp=plan.cp)
        spec_path = os.path.join(self.tmp, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("JAX", "XLA"))}
        env["PYTHONPATH"] = REPO
        self.logs = [open(os.path.join(self.tmp, f"rank{r}.log"), "w")
                     for r in range(self.world)]
        self.deadline = time.monotonic() + SPAWN_TIMEOUT_S
        self.procs = [subprocess.Popen(
            [sys.executable, CHILD, spec_path, str(r)], cwd=self.tmp,
            env=env, stdout=self.logs[r], stderr=subprocess.STDOUT)
            for r in range(self.world)]

    def wait(self):
        try:
            for p in self.procs:
                p.wait(timeout=max(self.deadline - time.monotonic(), 1))
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in self.logs:
                f.close()
        bad = [r for r, p in enumerate(self.procs) if p.returncode != 0]
        if bad:
            with open(os.path.join(self.tmp, f"rank{bad[0]}.log")) as f:
                raise RuntimeError(f"ranks {bad} failed:\n"
                                   f"{f.read()[-4000:]}")
        return [dict(np.load(os.path.join(self.tmp, f"rank{r}.npz")))
                for r in range(self.world)]


def spawn_ranks(tmp, plan_or_world, tasks, inputs_path, extra=None):
    """Ranks(...).wait(): run the ranks and return their outputs."""
    return Ranks(tmp, plan_or_world, tasks, inputs_path, extra).wait()


def batch_slice(inputs, prefix, mesh):
    """This rank's (data, ctx) slice of a global batch, as tensors."""
    plan, c = mesh.plan, mesh.coords
    out = []
    for name in BATCH_FIELDS:
        a = _cols(inputs[f"{prefix}{name}"], plan.dp, c[AXIS_DATA], 0)
        if a.ndim == 2:
            a = _cols(a, plan.cp, c[AXIS_CTX], 1)
        out.append(_t(a))
    return out


def ops_task(inputs, mesh, out):
    from code2vec_tpu_torch.kernels.select import padded_width
    from code2vec_tpu_torch.ops import sharded
    from code2vec_tpu_torch.ops.attention import (
        context_parallel_attention, context_parallel_attention_backward,
    )
    plan, c = mesh.plan, mesh.coords
    model, ctx = mesh.comm(AXIS_MODEL), mesh.comm(AXIS_CTX)
    table = _t(_cols(inputs["op_table"], plan.tp, c[AXIS_MODEL], 0))
    out["emb"] = sharded.tp_embedding_lookup(
        table, _t(inputs["op_ids"]), model).numpy()
    logits = _cols(inputs["op_logits"], plan.tp, c[AXIS_MODEL], 1)
    labels = _t(inputs["op_labels"])
    n_cols = logits.shape[1]
    # the stride K13 reads, with the columns past n_cols left at -inf
    wide = np.full((logits.shape[0], padded_width(n_cols)), -np.inf,
                   np.float32)
    wide[:, :n_cols] = logits
    out["ce"] = sharded.tp_softmax_ce(_t(logits), labels, model).numpy()
    out["ce_floor"] = sharded.tp_softmax_ce(
        _t(logits), labels, model, floor=True).numpy()
    gmax, lse = sharded.tp_log_softmax_at_topk(_t(logits), model)
    out["gmax"], out["lse"] = gmax.numpy(), lse.numpy()
    for k in inputs["op_ks"]:
        vals, ids = sharded.tp_top_k(_t(wide), int(k), model, n_cols=n_cols)
        out[f"topk{k}_values"], out[f"topk{k}_ids"] = vals.numpy(), \
            ids.numpy()
    cv = _t(inputs["op_cv"])
    tgt = _t(_cols(inputs["op_target"], plan.tp, c[AXIS_MODEL], 0))
    out["logits"] = sharded.tp_logits(cv, tgt, torch.float32).numpy()
    t = _t(_cols(inputs["op_t"], plan.cp, c[AXIS_CTX], 1))
    mask = _t(_cols(inputs["op_mask"], plan.cp, c[AXIS_CTX], 1))
    a = _t(inputs["op_a"])
    cvs, attn = context_parallel_attention(t, a, mask, ctx)
    out["att_cv"], out["att_w"] = cvs.numpy(), attn.numpy()
    dt, da = context_parallel_attention_backward(
        t, a, mask, attn, _t(inputs["op_dcv"]), ctx)
    out["att_dt"] = dt.numpy()
    out["att_da"] = ctx.all_reduce(da).numpy()


def steps_task(inputs, mesh, out):
    from code2vec_tpu_torch.config import Config
    from code2vec_tpu_torch.models.code2vec import ModelDims
    from code2vec_tpu_torch.training.sparse_adam import (
        HybridOptState, RowAdamSlots,
    )
    from code2vec_tpu_torch.training.state import (
        AdamState, make_optimizer, sharded_train_state,
    )
    from code2vec_tpu_torch.training.step import ParallelStepBuilder
    dims = ModelDims(*[int(x) for x in inputs["dims"]])
    plan = mesh.plan
    names = [str(n) for n in inputs["names"]]
    cd = str(inputs["compute_dtype"])

    def state(prefix, config):
        params = {n: inputs[f"{prefix}p_{n}"] for n in names}
        dense_names = [n for n in names if f"{prefix}mu_{n}" in inputs]
        adam = AdamState(
            count=int(inputs[f"{prefix}count"]),
            mu={n: _moment(inputs[f"{prefix}mu_{n}"]) for n in dense_names},
            nu={n: _moment(inputs[f"{prefix}nu_{n}"]) for n in dense_names})
        opt = adam
        if config.use_sparse_embedding_update:
            opt = HybridOptState(dense=adam, slots={
                n: RowAdamSlots(mu=_moment(inputs[f"{prefix}smu_{n}"]),
                                nu=_moment(inputs[f"{prefix}snu_{n}"]))
                for n in ("token_embedding", "path_embedding")})
        hyper = make_optimizer(config)
        return hyper, sharded_train_state(params, hyper, config, mesh,
                                          opt_state=opt,
                                          step=int(inputs[f"{prefix}step"]))

    base = dict(compute_dtype=cd, adam_mu_dtype=str(inputs["mu_dtype"]),
                adam_nu_dtype=str(inputs["nu_dtype"]), dp=plan.dp,
                tp=plan.tp, cp=plan.cp, top_k_words_considered_during_prediction
                =int(inputs["k"]))
    n_steps = int(inputs["n_steps"])
    # the gradients and the eval step, from the dense start state
    cfg = Config(dropout_keep_rate=1.0, **base)
    hyper, st = state("d_", cfg)
    builder = ParallelStepBuilder(dims, hyper, cfg, mesh)
    batch = batch_slice(inputs, "b0_", mesh)
    loss, grads = builder.loss_and_grads(st, *batch, 0)
    out["grad_loss"] = loss.numpy()
    for n, g in grads.items():
        out[f"grad_{n}"] = g.numpy()
    ev = builder.make_eval_step()(st.params, *batch)
    for f in ev._fields:
        out[f"eval_{f}"] = getattr(ev, f).numpy()
    for mode, prefix in (("dense", "d_"), ("sparse", "s_")):
        cfg = Config(dropout_keep_rate=1.0,
                     use_sparse_embedding_update=mode == "sparse", **base)
        hyper, st = state(prefix, cfg)
        step = ParallelStepBuilder(dims, hyper, cfg, mesh).make_train_step(st)
        losses = []
        for i in range(1, n_steps + 1):
            st, loss = step(st, *batch_slice(inputs, f"b{i}_", mesh), 0)
            losses.append(float(loss))
        out[f"{mode}_losses"] = np.asarray(losses)
        out[f"{mode}_step"] = np.asarray(st.step)
        _save_state(out, mode, st)
    # dropout: an injected (B, M, 3d) mask, this rank's slice of it
    cfg = Config(dropout_keep_rate=0.75, **base)
    hyper, st = state("d_", cfg)
    step = ParallelStepBuilder(dims, hyper, cfg, mesh).make_train_step(st)
    c = mesh.coords
    drop = _cols(_cols(inputs["drop_mask"], plan.dp, c[AXIS_DATA], 0),
                 plan.cp, c[AXIS_CTX], 1)
    st, loss = step(st, *batch_slice(inputs, "b1_", mesh), 0,
                    dropout_mask=_t(drop))
    out["drop_loss"] = loss.numpy()
    _save_state(out, "drop", st)


def _moment(a):
    """A moment as the state stores it: bf16 where saved as uint16 bits."""
    if a.dtype == np.uint16:
        return _t(a.view(np.int16)).view(torch.bfloat16)
    return _t(a)


def _save_state(out, prefix, st):
    for n, p in st.params.items():
        out[f"{prefix}_p_{n}"] = p.numpy()
    opt = getattr(st.opt_state, "dense", st.opt_state)
    for n, m in opt.mu.items():
        out[f"{prefix}_mu_{n}"] = m.float().numpy()
    slots = getattr(st.opt_state, "slots", {})
    for n, s in slots.items():
        out[f"{prefix}_smu_{n}"] = s.mu.float().numpy()
        out[f"{prefix}_snu_{n}"] = s.nu.float().numpy()


def facade_task(spec, rank, out):
    """`train` through the facade from the `p_*` parameters (the JAX
    facade's initial ones), as cli.main runs it."""
    from code2vec_tpu_torch import cli
    from code2vec_tpu_torch.model_facade import Code2VecModel
    inputs = np.load(spec["inputs"])
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(spec["world"]),
                      LOCAL_RANK=str(rank))
    args, config = cli.config_from_args(spec["argv"])
    for name, value in spec.get("config", {}).items():
        setattr(config, name, value)
    model = Code2VecModel(config)
    model.load_params({k[2:]: inputs[k] for k in inputs.files
                       if k.startswith("p_")})
    model.train()
    out["losses"] = np.asarray([x for e in model.trainer.epoch_losses
                                for x in e])
    results = [r for _, r in model.trainer.eval_results]
    out["eval"] = np.asarray([[*r.topk_acc, r.subtoken_precision,
                               r.subtoken_recall, r.subtoken_f1, r.loss]
                              for r in results])
    out["steps"] = np.asarray(model.state.step)


def main():
    spec_path, rank = sys.argv[1], int(sys.argv[2])
    with open(spec_path) as f:
        spec = json.load(f)
    out = {}
    if "facade" in spec["tasks"]:
        facade_task(spec, rank, out)
    else:
        distributed.initialize(spec["init"], spec["world"], rank,
                               timeout_s=spec["timeout"])
        mesh = make_mesh(MeshPlan(**spec["plan"]),
                         timeout_s=spec["timeout"])
        inputs = np.load(spec["inputs"])
        if "ops" in spec["tasks"]:
            ops_task(inputs, mesh, out)
        if "steps" in spec["tasks"]:
            steps_task(inputs, mesh, out)
        out["coords"] = np.asarray([mesh.coords[a] for a in
                                    (AXIS_DATA, AXIS_MODEL, AXIS_CTX)])
    np.savez(os.path.join(spec["out"], f"rank{rank}.npz"), **out)
    distributed.shutdown()


if __name__ == "__main__":
    main()
