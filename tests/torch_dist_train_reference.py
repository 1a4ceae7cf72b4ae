"""The reference's side of tests/test_torch_dist_train.py, run as a child
process whose environment alone sets
``XLA_FLAGS=--xla_force_host_platform_device_count=4``: on each case's mesh,
the JAX package's ``value_and_grad(model.loss)`` and one ``step_fn`` of its
``make_train_step``, jitted with the train rules' shardings as
``repro/launch/dryrun.py``'s train cell builds them (the parameters', the
moments' and the error feedback's ``NamedSharding``s, the batch's; an
enc-dec batch's frames and a VLM's patches as its ``_batch_shardings``).
Each case is traced and lowered here while the earlier ones compile and run
on four threads (XLA compiles outside the GIL): 44 s for six cases on 8 CPU
cores, against 67 s one after another. The test runs two such children on
parts of its cases at once (tracing holds one core a child).

    python tests/torch_dist_train_reference.py INPUTS.pkl OUTPUTS.pkl
"""
import pickle
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding

from repro.distributed.sharding import (make_rules, param_partition_specs, partition_spec,
                                        use_sharding)
from repro.models import RunCtx, build_model
from repro.models.params import param_specs
from repro.training.optimizer import AdamWState
from repro.training.train_step import TrainConfig, make_train_step
from torch_dist_reference import AXES, config, per_device


# dryrun.py's ``_batch_shardings``
BATCH_LOGICAL = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
                 "frames": ("batch", "seq", None), "patches": ("batch", None, None)}


def lower(case, params_np, batch_np, loss_kw, step_kw):
    arch, shape, strategy = case
    cfg = config(arch)
    model = build_model(cfg)
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), AXES)
    rules = make_rules("train", moe="ep" if strategy == "ep_shardmap" else "tp",
                       tensor_axis="tensor", expert_axis="expert")
    # dryrun's train cell has remat=True: the same function, slower to compile
    ctx = RunCtx(mode="train", mesh=mesh, attn_backend="xla",
                 moe_strategy=strategy if cfg.moe is not None else "capacity", remat=False,
                 ep_axis="expert", tp_axis="tensor")
    init_fn, step_fn = make_train_step(model, TrainConfig(**step_kw), ctx)
    p_sh = jax.tree.map(lambda s: NamedSharding(mesh, s),
                        param_partition_specs(param_specs(cfg), mesh, rules))
    opt_sh = AdamWState(step=NamedSharding(mesh, partition_spec((), (), mesh, rules)),
                        m=p_sh, v=p_sh)
    b_sh = {k: NamedSharding(mesh, partition_spec(v.shape, BATCH_LOGICAL[k], mesh, rules))
            for k, v in batch_np.items()}
    params = jax.tree.map(jnp.asarray, params_np)
    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    state = init_fn(params)

    def both(p, s, b):
        (loss, met), grads = jax.value_and_grad(
            lambda p, b: model.loss(p, b, ctx, **loss_kw), has_aux=True)(p, b)
        gnorm = jnp.sqrt(sum(jnp.sum(jnp.square(g)) for g in jax.tree.leaves(grads)))
        return (loss, met["aux"], grads, gnorm), step_fn(p, s, b)

    with use_sharding(mesh, rules):
        lowered = jax.jit(both, in_shardings=(p_sh, (opt_sh, p_sh), b_sh)).lower(
            params, state, batch)
    return mesh, lowered, (params, state, batch)


def run(mesh, lowered, args):
    (loss, aux, grads, gnorm), (new_p, (opt, err), met) = lowered.compile()(*args)
    leaves = lambda t: [np.asarray(x) for x in jax.tree.leaves(t)]  # noqa: E731
    return dict(loss=[float(x) for x in per_device(loss, mesh)],
                aux=[float(x) for x in per_device(aux, mesh)], grads=leaves(grads),
                gnorm=float(gnorm),
                step_loss=[float(x) for x in per_device(met["loss"], mesh)],
                lr=float(met["lr"]), after=leaves(new_p), m=leaves(opt.m), v=leaves(opt.v),
                err=leaves(err))


def main(inputs_path, outputs_path):
    assert jax.device_count() >= 4, jax.devices()
    with open(inputs_path, "rb") as f:
        inp = pickle.load(f)
    with ThreadPoolExecutor(4) as pool:
        futures = {case: pool.submit(run, *lower(case, inp["params"][case[0]],
                                                 inp["batches"][case[0]], inp["loss_kw"],
                                                 inp["step_kw"]))
                   for case in inp["cases"]}
        out = {case: f.result() for case, f in futures.items()}
    with open(outputs_path, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
