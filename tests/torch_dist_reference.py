"""The reference's side of tests/test_torch_distributed.py, run as a child
process whose environment alone sets
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (the suite keeps
one device in-process): the JAX package's ``tp_shardmap`` / ``ep_shardmap``
on meshes of the test's shapes, and its unsharded model calls on the same
numpy parameters (an enc-dec config's with the io's frames, a VLM's with
its patches) and, for the archs the test serves an int8 tree of, on
``dequantize_tree(quantize_params_int8(params), float32)`` through the
same jitted functions (the same shapes and dtypes: no new compile), on
four threads: 37 s against 71 s one case after another (8 CPU cores).

    python tests/torch_dist_reference.py INPUTS.pkl OUTPUTS.pkl
"""
import dataclasses
import pickle
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from repro.configs import tiny_config
from repro.models import RunCtx, build_model
from repro.models.moe import moe_sublayer

AXES = ("data", "expert", "tensor")


def config(arch, cf=None):
    cfg = tiny_config(arch)
    if cfg.moe is not None:
        cf = cfg.moe.num_experts / cfg.moe.top_k if cf is None else cf
        cfg = cfg.scaled(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    return cfg


def moe_case(case, p_np, h_np):
    arch, strategy, shape, cf, quant = case
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), AXES)
    ctx = RunCtx(moe_strategy=strategy, mesh=mesh, ep_axis="expert", tp_axis="tensor",
                 quant=quant)
    p = jax.tree.map(jnp.asarray, p_np)
    cfg = config(arch, cf)
    with mesh:                 # jitted: an eager shard_map dispatches op by op
        y, aux = jax.jit(lambda p, h: moe_sublayer(p, h, cfg, ctx))(p, jnp.asarray(h_np))
    return per_device(y, mesh), [float(a) for a in per_device(aux, mesh)]


def per_device(a, mesh):
    """Each device's own buffer of ``a``, by mesh position: with
    ``check_rep=False`` a replicated out_spec need not hold one value."""
    devs = list(mesh.devices.flat)
    out = [None] * len(devs)
    for s in a.addressable_shards:
        out[devs.index(s.device)] = np.asarray(s.data)
    return out


def model_case(arch, trees, io):
    """The unsharded paths on each of ``trees`` (numpy parameter trees of
    one shape), through one set of jitted functions."""
    model = build_model(config(arch))
    ctx = RunCtx(attn_backend="xla", moe_strategy="capacity")
    j = jnp.asarray
    ext, M, off = io["extras"][arch]
    ext = {k: j(v) for k, v in ext.items()}
    prefill = jax.jit(lambda p, b, c: model.prefill(p, b, c, ctx))
    step = jax.jit(lambda p, t, c, pos: model.decode_step(p, t, c, pos, ctx))
    paged = jax.jit(lambda p, t, c, pos, pt: model.decode_step(p, t, c, pos, ctx, page_table=pt,
                                                               lengths=pos + 1))
    chunk = jax.jit(lambda p, t, c, st, nv, pt, e, a: model.decode_chunk(
        p, t, c, st, nv, jnp.arange(t.shape[0], dtype=jnp.int32), st == 0, ctx, pt, **e,
        all_logits=a), static_argnums=7)
    return [paths(jax.tree.map(jnp.asarray, t), io, ext, M, off, model, prefill, step, paged,
                  chunk) for t in trees]


def paths(jp, io, ext, M, off, model, prefill, step, paged, chunk):
    j = jnp.asarray
    out = {}
    B = io["prompt"].shape[0]
    ring = model.init_cache(B, io["max_seq"], jnp.float32, memory_len=M)
    out["prefill"], ring = prefill(jp, {"tokens": j(io["prompt"]), **ext}, ring)
    for i, (tok, pos) in enumerate(io["ring_steps"]):
        out[f"ring{i}"], ring = step(jp, j(tok), ring, j(pos + off))
    pool = model.init_cache(B, io["max_seq"], jnp.float32, kind="paged", page_size=io["ps"],
                            num_pages=io["num_pages"], memory_len=M)
    tok, st, nv, pt = io["pack"]
    out["pack"], pool = chunk(jp, j(tok), pool, j(st), j(nv), j(pt), ext, False)
    for i, (tok, pos) in enumerate(io["paged_steps"]):
        out[f"paged{i}"], pool = paged(jp, j(tok), pool, j(pos + off), j(pt))
    tok, st, nv = io["verify"]
    out["verify"], pool = chunk(jp, j(tok), pool, j(st), j(nv), j(pt), {}, True)
    return {k: np.asarray(v) for k, v in out.items()}


def main(inputs_path, outputs_path):
    assert jax.device_count() >= 4, jax.devices()
    with open(inputs_path, "rb") as f:
        inp = pickle.load(f)
    # four threads: XLA compiles outside the GIL, so one case compiles
    # while others trace; the slowest (jamba's model calls) first
    archs = sorted({c[0] for c in inp["model_cases"]}, key=lambda a: a != "jamba-v0.1-52b")
    int8 = inp["int8_ref_params"]
    with ThreadPoolExecutor(4) as pool:
        model = {a: pool.submit(model_case, a, [inp["params"][a]] + ([int8[a]] if a in int8
                                                                     else []), inp["io"])
                 for a in archs}
        moe = {c: pool.submit(moe_case, c, inp["moe_params"][c[0]], inp["moe_h"])
               for c in inp["moe_cases"]}
        out = {"moe": {c: f.result() for c, f in moe.items()},
               "model": {a: f.result()[0] for a, f in model.items()},
               "int8": {a: model[a].result()[1] for a in archs if a in int8}}
    with open(outputs_path, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
