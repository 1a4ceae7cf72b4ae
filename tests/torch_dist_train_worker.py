"""The port's side of tests/test_torch_dist_train.py, run by every spawned
gloo rank (torch only, so the ranks never import JAX): on each case's mesh
with the train rules, ``LM.loss`` and its reduced gradient, then one
``step_fn`` with microbatches and int8 gradients (the batch carries an
enc-dec config's frames and a VLM's patches); on (2, 1, 2) each
collective's backward and the trainer's crash, resume and checkpoint."""
import pickle
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint import restore_checkpoint
from repro_torch.data.pipeline import DataConfig
from repro_torch.distributed.sharding import (gather_tree, make_rules, param_partition_specs,
                                              shard_slices, shard_tree, use_sharding)
from repro_torch.launch.mesh import Mesh
from repro_torch.models import RunCtx, build_model
from repro_torch.models.params import params_from_numpy, tree_leaves, tree_unflatten
from repro_torch.training.optimizer import global_norm
from repro_torch.training.train_step import (TrainConfig, make_train_step, reduce_grads,
                                            spec_leaves)
from repro_torch.training.trainer import CrashForTest, TrainerConfig, train
from torch_dist_worker import AXES, config


def train_rules(strategy):
    return make_rules("train", moe="ep" if strategy == "ep_shardmap" else "tp",
                      tensor_axis="tensor", expert_axis="expert")


def train_ctx(strategy, mesh):
    return RunCtx(mode="train", mesh=mesh, moe_strategy=strategy, ep_axis="expert",
                  tp_axis="tensor", remat=True)


def _numpy(ts):
    return [t.detach().numpy().copy() for t in ts]


def _case(mesh, case, params_np, batch_np, loss_kw, step_kw):
    arch, _, strategy = case
    model = build_model(config(arch))
    rules = train_rules(strategy)
    ctx = train_ctx(strategy, mesh)
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    with use_sharding(mesh, rules):
        specs = param_partition_specs(model.param_specs(), mesh, rules)
        params = params_from_numpy(shard_tree(params_np, specs, mesh), device="cpu")
        slices = [tuple((s.start, s.stop) for s in shard_slices(a.shape, sp, mesh))
                  for a, sp in zip(tree_leaves(params_np), spec_leaves(specs))]
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        loss, metrics = model.loss(tree_unflatten(params, leaves), batch, ctx, **loss_kw)
        grads = reduce_grads(list(torch.autograd.grad(loss, leaves)), mesh, specs)
        gnorm = global_norm(tree_unflatten(params, grads), mesh, specs)
        init_fn, step_fn = make_train_step(model, TrainConfig(**step_kw), ctx)
        before = _numpy(tree_leaves(params))
        params, (opt, err), smet = step_fn(params, init_fn(params), batch)
    return dict(loss=float(loss), aux=float(metrics["aux"]), grads=_numpy(grads), slices=slices,
                gnorm=float(gnorm),
                step_loss=float(smet["loss"]), lr=float(smet["lr"]), step=int(opt.step),
                before=before, after=_numpy(tree_leaves(params)), m=_numpy(tree_leaves(opt.m)),
                v=_numpy(tree_leaves(opt.v)), err=_numpy(tree_leaves(err)))


def _trainer(mesh, job, ckpt_dir):
    """The trainer on ``mesh``: uninterrupted, then crashing at step 2 after
    a checkpoint at step 2, then resumed; the mesh's first rank then
    restores the last checkpoint unsharded through the trainer."""
    arch, _, strategy = job["case"]
    model = build_model(config(arch))
    dcfg = DataConfig(vocab=model.cfg.vocab, batch=4, seq_len=16)
    tcfg = TrainConfig(**job["step_kw"])
    ctx = train_ctx(strategy, mesh)
    out = {}
    with use_sharding(mesh, train_rules(strategy)):
        full = train(model, dcfg, tcfg, TrainerConfig(steps=4), ctx=ctx, device="cpu")
        try:
            train(model, dcfg, tcfg, TrainerConfig(steps=4, ckpt_dir=ckpt_dir, ckpt_every=2,
                                                   crash_at=2), ctx=ctx, device="cpu")
            out["crashed"] = False
        except CrashForTest as crash:
            out["crashed"], out["crash_losses"] = True, crash.losses
        resumed = train(model, dcfg, tcfg, TrainerConfig(steps=4, ckpt_dir=ckpt_dir,
                                                          ckpt_every=2), ctx=ctx, device="cpu")
        specs = param_partition_specs(model.param_specs(), mesh, train_rules(strategy))
        whole = gather_tree(resumed["params"], specs, mesh)
        opt, err = resumed["state"]
        whole_m, whole_v, whole_err = (gather_tree(t, specs, mesh) for t in (opt.m, opt.v, err))
    out.update(losses=full["losses"], resumed_losses=resumed["losses"], start=resumed["start"],
               full_after=_numpy(tree_leaves(full["params"])),
               resumed_after=_numpy(tree_leaves(resumed["params"])))
    if mesh.rank == 0:
        # the checkpoint holds the global tree: unsharded, the trainer takes
        # it whole (and runs no step: it is at step 4 of 4)
        plain = train(model, dcfg, tcfg, TrainerConfig(steps=4, ckpt_dir=ckpt_dir), device="cpu")
        restored, step = restore_checkpoint(ckpt_dir, (plain["params"], plain["state"]))
        popt, perr = plain["state"]
        out["unsharded"] = dict(
            start=plain["start"], step=step,
            params_equal=all(torch.equal(a, b) for a, b in zip(tree_leaves(plain["params"]),
                                                               tree_leaves(whole))),
            moments_equal=all(torch.equal(a, b) for a, b in zip(
                tree_leaves((popt.m, popt.v, perr)), tree_leaves((whole_m, whole_v, whole_err)))),
            step_count=int(popt.step))
        del restored
    return out


COLLECTIVE_AXES = ("data", "tensor")


def _collectives(mesh):
    """Each collective's gradient on this rank: ``x`` the rank's own (seeded
    by rank), the loss ``shared_out(sum(op(x) * w))`` with ``w`` the same
    on every rank. Returns {op: (x, op(x), d loss / d x)}."""
    from repro_torch.distributed.collectives import (all_gather, all_to_all, pmax, pmean,
                                                     psum, shared_out)
    x = torch.randn(4, 6, generator=torch.Generator().manual_seed(100 + mesh.rank))
    ops = {"psum": lambda t: psum(t, mesh, COLLECTIVE_AXES),
           "pmean": lambda t: pmean(t, mesh, COLLECTIVE_AXES),
           "pmax": lambda t: pmax(t, mesh, COLLECTIVE_AXES),
           "all_gather": lambda t: all_gather(t, mesh, COLLECTIVE_AXES, dim=1),
           "all_to_all": lambda t: all_to_all(t, mesh, "tensor")}
    out = {}
    for name, op in ops.items():
        xr = x.clone().requires_grad_()
        y = op(xr)
        w = torch.randn(y.shape, generator=torch.Generator().manual_seed(7))
        shared_out((y * w).sum(), mesh).backward()
        out[name] = (x.numpy(), y.detach().numpy(), xr.grad.numpy())
    return out


def run_all(rank, world, inputs_path):
    """Every case on this rank; a mesh smaller than the world binds the
    first ranks, and the others skip its cases."""
    with open(inputs_path, "rb") as f:
        inp = pickle.load(f)
    meshes = {}
    for case in inp["cases"]:
        if case[1] not in meshes:
            meshes[case[1]] = Mesh(case[1], AXES).bind(ranks=range(int(np.prod(case[1]))))
    out = {"cases": {}, "collectives": _collectives(meshes[(2, 1, 2)])}
    for case in inp["cases"]:
        if meshes[case[1]].rank >= 0:
            out["cases"][case] = _case(meshes[case[1]], case, inp["params"][case[0]],
                                       inp["batches"][case[0]], inp["loss_kw"], inp["step_kw"])
    job = inp["trainer"]
    out["trainer"] = _trainer(meshes[job["case"][1]], job,
                              str(Path(inputs_path).parent / "ckpt"))
    return out
