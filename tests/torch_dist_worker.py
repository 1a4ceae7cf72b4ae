"""The port's side of tests/test_torch_distributed.py, run by every spawned
gloo rank (torch only, so the ranks never import JAX): the MoE layer's
shard_map strategies and the sharded model paths on the cases the test
module writes, each on its mesh (a mesh smaller than the world binds the
first ranks; the others skip its cases). A model case's fourth entry,
where it has one, names its variant: "int8" (the int8 tree the test module
quantized, sharded by the float specs' int8 rule) or "seq" (the
sequence-parallel rule, ``make_rules(seq_shard=True)``). And the walk
cases: the dry-run's cell (``launch.dryrun.build_cell``) of a tiny config
run for real on the ranks, its collectives and FLOPs recorded, to hold
against the walk of the same rank on ``meta``."""
import dataclasses
import pickle

import numpy as np
import torch

from repro_torch.configs import tiny_config
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import (gather_tree, make_rules, param_partition_specs,
                                              shard_tree, use_sharding)
from repro_torch.launch.mesh import Mesh
from repro_torch.models import RunCtx, build_model
from repro_torch.models.moe import count_drops, moe_sublayer
from repro_torch.models.params import _moe_specs, params_from_numpy, tree_leaves

AXES = ("data", "expert", "tensor")


def config(arch, cf=None):
    """The tiny config; MoE capacity factor ``cf`` (None: E / K, nothing
    drops)."""
    cfg = tiny_config(arch)
    if cfg.moe is not None:
        cf = cfg.moe.num_experts / cfg.moe.top_k if cf is None else cf
        cfg = cfg.scaled(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    return cfg


def rules_for(strategy, seq_shard=False):
    return make_rules("serve", moe="ep" if strategy == "ep_shardmap" else "tp",
                      tensor_axis="tensor", expert_axis="expert", seq_shard=seq_shard)


def _moe_case(mesh, case, p_np, h_np):
    arch, strategy, shape, cf, quant = case
    cfg = config(arch, cf)
    rules = rules_for(strategy)
    # the layer's leaves with a repeat dim of 1, sliced by their specs
    specs = param_partition_specs(_moe_specs(cfg, 1), mesh, rules)
    stacked = {k: ({n: v[None] for n, v in p_np[k].items()} if isinstance(p_np[k], dict)
                   else p_np[k][None]) for k in p_np}
    local = params_from_numpy(shard_tree(stacked, specs, mesh), device="cpu")
    local = {k: ({n: v[0] for n, v in local[k].items()} if isinstance(local[k], dict)
                 else local[k][0]) for k in local}
    ctx = RunCtx(moe_strategy=strategy, mesh=mesh, ep_axis="expert", tp_axis="tensor",
                 quant=quant)
    with count_drops() as drops:
        y, aux = moe_sublayer(local, torch.from_numpy(h_np), cfg, ctx)
    return y.numpy(), float(aux), drops.total()


def _model_case(mesh, case, params_np, io):
    arch, shape, strategy = case[:3]
    variant = case[3] if len(case) > 3 else ""
    model = build_model(config(arch))
    rules = rules_for(strategy, seq_shard=variant == "seq")
    t = torch.from_numpy
    ext, M, off = io["extras"][arch]
    ext = {k: t(v) for k, v in ext.items()}
    # the reduce-scatters the sequence-parallel rule runs in place of psums
    scattered, reduce_scatter = [0], collectives.reduce_scatter

    def counted(*args, **kw):
        scattered[0] += 1
        return reduce_scatter(*args, **kw)
    collectives.reduce_scatter = counted
    try:
        out = _paths(model, mesh, rules, strategy, params_np, io, ext, M, off)
    finally:
        collectives.reduce_scatter = reduce_scatter
    out["scattered"] = scattered[0]
    return out


def _paths(model, mesh, rules, strategy, params_np, io, ext, M, off):
    t = torch.from_numpy
    ctx = RunCtx(moe_strategy=strategy, mesh=mesh, ep_axis="expert", tp_axis="tensor")
    out = {}
    with use_sharding(mesh, rules), torch.inference_mode():
        specs = param_partition_specs(model.param_specs(), mesh, rules)
        params = params_from_numpy(shard_tree(params_np, specs, mesh), device="cpu")
        # gather_tree undoes shard_tree: every rank holds the whole tree again
        whole = [t.numpy() for t in tree_leaves(gather_tree(params, specs, mesh))]
        round_trip = all(a.dtype == b.dtype and np.array_equal(a, b)
                         for a, b in zip(whole, tree_leaves(params_np)))
        B = io["prompt"].shape[0]
        ring = model.init_cache(B, io["max_seq"], memory_len=M, device="cpu")
        out["prefill"], ring = model.prefill(params, {"tokens": t(io["prompt"]), **ext}, ring,
                                             ctx)
        for i, (tok, pos) in enumerate(io["ring_steps"]):
            out[f"ring{i}"], ring = model.decode_step(params, t(tok), ring, t(pos + off), ctx)
        pool = model.init_cache(B, io["max_seq"], kind="paged", page_size=io["ps"],
                                num_pages=io["num_pages"], memory_len=M, device="cpu")
        tok, st, nv, pt = io["pack"]
        slots, first = t(np.arange(B, dtype=np.int32)), t(st == 0)
        out["pack"], pool = model.decode_chunk(params, t(tok), pool, t(st), t(nv), slots, first,
                                               ctx, t(pt), **ext)
        for i, (tok, pos) in enumerate(io["paged_steps"]):
            out[f"paged{i}"], pool = model.decode_step(params, t(tok), pool, t(pos + off), ctx,
                                                       page_table=t(pt),
                                                       lengths=t(pos + off + 1))
        tok, st, nv = io["verify"]
        out["verify"], pool = model.decode_chunk(params, t(tok), pool, t(st), t(nv), slots,
                                                 t(st == 0), ctx, t(pt), all_logits=True)
        out = {k: v.numpy() for k, v in out.items()}
        out["round_trip"] = round_trip
        if mesh.shape["data"] > 1 and (model.cfg.ssm is not None or model.cfg.encoder is not None):
            # the slot-pooled caches hold the slots of the rank's batch block:
            # a pack whose rows name each other's slots is refused
            try:
                model.decode_chunk(params, t(tok), pool, t(st), t(nv), slots.flip(0), t(st == 0),
                                   ctx, t(pt))
                out["refused"] = ""
            except ValueError as e:
                out["refused"] = str(e)
    return out


def _walk_cases(mesh, cases):
    """Each walk case's cell (arch, (seq_len, batch, kind), moe, seq_shard)
    built on the CPU over the bound mesh and walked: the log of its
    collectives and its FLOPs. And a psum over the tensor axis under the
    recorder: a bound mesh's collectives still run there."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import build_cell, walk
    out = {}
    for name, (arch, (S, B, kind), moe, seq) in cases.items():
        cell = build_cell(tiny_config(arch), ShapeConfig(name, S, B, kind), mesh, moe_mode=moe,
                          seq_shard=seq, device="cpu")
        w = walk(cell)
        out[name] = {"log": w.log, "flops": w.flops}
    with collectives.record_collectives() as log:
        total = collectives.psum(torch.full((2,), float(mesh.rank + 1)), mesh, "tensor")
    out["psum"] = (total.tolist(), list(log))
    return out


def run_all(rank, world, inputs_path):
    """Every case on this rank; returns {case: result} of the cases whose
    mesh holds it."""
    with open(inputs_path, "rb") as f:
        inp = pickle.load(f)
    shapes = sorted({c[2] for c in inp["moe_cases"]} | {c[1] for c in inp["model_cases"]})
    meshes = {s: Mesh(s, AXES).bind(ranks=range(int(np.prod(s)))) for s in shapes}
    out = {"moe": {}, "model": {}}
    for case in inp["moe_cases"]:
        mesh = meshes[case[2]]
        if mesh.rank >= 0:
            out["moe"][case] = _moe_case(mesh, case, inp["moe_params"][case[0]],
                                         inp["moe_h"])
    for case in inp["model_cases"]:
        mesh = meshes[case[1]]
        if mesh.rank >= 0:
            trees = inp["int8_params"] if case[3:] == ("int8",) else inp["params"]
            out["model"][case] = _model_case(mesh, case, trees[case[0]], inp["io"])
    walk_mesh = Mesh(inp["walk_mesh"], AXES).bind()
    out["walk"] = _walk_cases(walk_mesh, inp["walk_cases"])
    return out

