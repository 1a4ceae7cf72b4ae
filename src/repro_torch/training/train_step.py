"""Training step factory (the reference's ``repro.training.train_step``):
loss -> gradients (autograd over the parameter tree's leaves, optionally
accumulated over microbatches in fp32) -> optional int8 gradient
compression with error feedback -> AdamW at the cosine schedule's lr.

On the card the attention gradient comes from the flash attention backward
kernel and the SSD scan's from its backward kernel; the grouped and w8a16
matmuls and paged attention have none and raise if the loss would need one
(``kernels/grad_guard.py``), so the step trains every family through the
capacity MoE on float weights there (int8 trees only on the CPU).

Under a mesh (``ctx.mesh``, inside ``use_sharding(mesh, make_rules("train",
...))``) the step is the reference's jitted with the parameters' shardings:
every tree (parameters, AdamW's moments, the error feedback) holds the
rank's shards, ``batch`` is the global batch (the loss takes the rank's
rows), and the gradient's shares (``distributed.collectives``) are summed
by ``reduce_grads``: the explicit form of the reductions GSPMD inserts. A
microbatch is global rows, as the reference's reshape cuts them, and the
shares of all microbatches are summed once. int8 compression acts on the
reduced gradient, each leaf's scale the absmax of the global leaf.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from repro_torch.distributed.collectives import (compress_grads_with_feedback,
                                                 decompress_grads, pmax, psum,
                                                 zeros_error_like)
from repro_torch.distributed.sharding import (PartitionSpec, active, held_alike_axes,
                                              param_partition_specs, split_axes)
from repro_torch.models.common import RunCtx
from repro_torch.models.params import map_tree, tree_leaves, tree_unflatten
from repro_torch.training.optimizer import adamw_init, adamw_update, cosine_schedule

# ``reduce_grads`` sums leaves held alike along the same axes in flat
# buckets of at most this many elements: one collective a bucket
_BUCKET_ELEMS = 1 << 24


@dataclass(frozen=True)
class TrainConfig:
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    aux_weight: float = 0.01
    grad_compression: bool = False     # int8 + error feedback
    remat: bool = True
    xent_chunk: int = 0                # >0: sequence-chunked cross-entropy
    microbatches: int = 1              # >1: gradient accumulation (memory)


def spec_leaves(specs) -> list:
    out = []
    map_tree(out.append, specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return out


def mesh_specs(model, ctx: RunCtx):
    """(mesh, the parameters' PartitionSpec tree) of a step under
    ``ctx.mesh`` (inside its ``use_sharding``), or (None, None)."""
    if ctx.mesh is None:
        return None, None
    mesh, rules = active()
    if mesh is not ctx.mesh or rules is None:
        raise ValueError("under a mesh, run inside use_sharding(ctx.mesh, rules)")
    return mesh, param_partition_specs(model.param_specs(), mesh, rules)


def reduce_grads(grads: list, mesh, specs) -> list:
    """Each gradient leaf's shares (``grads`` in tree order) psum'd over the
    axes along which the leaf is held alike; a leaf split on an axis has
    that axis's sum already (its FSDP gather's reduce-scatter, or the
    collectives that routed it there). Leaves with the same axes and dtype
    go in flat buckets. Returns the reduced leaves."""
    out = list(grads)
    buckets = {}
    for i, (g, spec) in enumerate(zip(grads, spec_leaves(specs))):
        axes = held_alike_axes(spec, mesh)
        if axes:
            buckets.setdefault((axes, g.dtype), []).append(i)
    for (axes, _), idx in buckets.items():
        while idx:
            take, n = [], 0
            while idx and (not take or n + grads[idx[0]].numel() <= _BUCKET_ELEMS):
                n += grads[idx[0]].numel()
                take.append(idx.pop(0))
            flat = psum(torch.cat([grads[i].reshape(-1) for i in take]), mesh, axes)
            for i, part in zip(take, torch.split(flat, [grads[i].numel() for i in take])):
                out[i] = part.view_as(grads[i])
    return out


def make_train_step(model, tcfg: TrainConfig, ctx: Optional[RunCtx] = None
                    ) -> Tuple[Callable, Callable]:
    """Returns (init_fn(params) -> state, step_fn(params, state, batch) ->
    (params, state, metrics)); state = (AdamWState, error feedback tree or
    None). ``step_fn`` updates the parameters and the optimizer state in
    place and returns them; ``batch`` holds tensors on the parameters'
    device (the global batch under a mesh); metrics ``loss``, ``xent``,
    ``aux`` and ``lr`` are 0-d fp32 tensors (under a mesh ``loss`` and
    ``aux`` are the rank's, as the reference's devices report them)."""
    ctx = ctx or RunCtx(mode="train", moe_strategy="capacity", remat=tcfg.remat)

    def init_fn(params):
        err = zeros_error_like(params) if tcfg.grad_compression else None
        return (adamw_init(params), err)

    def loss_and_grads(leaves, params_g, batch):
        loss, metrics = model.loss(params_g, batch, ctx, aux_weight=tcfg.aux_weight,
                                   xent_chunk=tcfg.xent_chunk)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss does not reach (none in the configs) gets a zero gradient
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def step_fn(params, state, batch):
        opt_state, err = state
        mesh, specs = mesh_specs(model, ctx)
        # aliases of the leaves that autograd tracks (same storage, no copy)
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        params_g = tree_unflatten(params, leaves)
        nm = tcfg.microbatches
        if nm <= 1:
            loss, metrics, grads = loss_and_grads(leaves, params_g, batch)
        else:
            # gradient accumulation: the activation working set shrinks nm x;
            # grads accumulate in a params-sized fp32 buffer. Microbatch i is
            # the global rows [i B / nm, (i + 1) B / nm), as the reference's
            # reshape cuts them (under a mesh the loss takes the rank's)
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            ms = []
            for i in range(nm):
                b_i = {k: v.reshape(nm, v.shape[0] // nm, *v.shape[1:])[i]
                       for k, v in batch.items()}
                l, m, g = loss_and_grads(leaves, params_g, b_i)
                for a, x in zip(grads, g):
                    a.add_(x.float() / nm)
                loss = loss + l / nm
                ms.append(m)
            metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        del leaves, params_g
        if mesh is not None:
            grads = reduce_grads(grads, mesh, specs)
        grads = tree_unflatten(params, grads)
        if tcfg.grad_compression:
            absmax = None
            if mesh is not None:
                axes = [split_axes(s, mesh) for s in spec_leaves(specs)]

                def absmax(i, g):
                    amax = torch.max(torch.abs(g))
                    return pmax(amax, mesh, axes[i]) if axes[i] else amax
            qtree, err = compress_grads_with_feedback(grads, err, absmax)
            grads = decompress_grads(qtree)
        lr = cosine_schedule(opt_state.step + 1, peak_lr=tcfg.peak_lr, warmup=tcfg.warmup,
                             total=tcfg.total_steps)
        with torch.no_grad():
            params, opt_state = adamw_update(grads, opt_state, params, lr=lr,
                                             weight_decay=tcfg.weight_decay,
                                             grad_clip=tcfg.grad_clip, mesh=mesh, specs=specs)
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["lr"] = lr
        return params, (opt_state, err), metrics

    return init_fn, step_fn
