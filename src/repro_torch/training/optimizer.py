"""AdamW and the cosine schedule as plain functions over the parameter tree
(the reference's ``repro.training.optimizer``).

The state is a NamedTuple of an int32 step counter and fp32 moments ``m`` /
``v`` mirroring the parameter tree. ``adamw_update`` computes each leaf's
update in fp32 and casts it back to the leaf's dtype, as the reference does
(``torch.optim.AdamW`` would do its arithmetic in bf16 on bf16 leaves, a
different result). Unlike the reference's pure function it updates the
parameters and moments in place, so a full-width model never holds two
copies of its training state; it returns them. Under a mesh the moments are
the parameters' shards (the reference's moments take the parameters'
shardings), updated where they lie.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.models.params import map_tree, tree_leaves

# leaves above this many elements are updated in slices of about as many
# along their first axis, which bounds the fp32 temporaries of a full-width
# leaf (elementwise: the result does not depend on the slicing)
_SLICE_ELEMS = 1 << 26


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar: updates taken
    m: Any
    v: Any


def adamw_init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=map_tree(zeros, params), v=map_tree(zeros, params))


def global_norm(grads, mesh=None, specs=None) -> torch.Tensor:
    """sqrt(sum of every leaf's squares + 1e-20), fp32. Under a mesh
    (``grads`` the rank's shards, ``specs`` their PartitionSpec tree) each
    leaf's squares are summed over the axes that split it, and a leaf held
    alike along an axis counts once: the norm of the global tree, on every
    rank."""
    sq = [torch.sum(torch.square(g.float())) for g in tree_leaves(grads)]
    if mesh is None:
        return torch.sqrt(torch.stack(sq).sum() + 1e-20)
    from repro_torch.distributed.collectives import psum
    from repro_torch.distributed.sharding import PartitionSpec, split_axes
    spec_list = []
    map_tree(spec_list.append, specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    by_axes = {}                                   # one psum per set of splitting axes
    for s, spec in zip(sq, spec_list):
        by_axes.setdefault(split_axes(spec, mesh), []).append(s)
    total = sum((psum(torch.stack(v), mesh, axes) if axes else torch.stack(v)).sum()
                for axes, v in by_axes.items())
    return torch.sqrt(total + 1e-20)


def _update_leaf(p, g, m, v, *, lr, b1, b2, eps, wd, scale, bc1, bc2) -> None:
    g = g.float() * scale
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * torch.square(g))
    delta = (m / bc1) / (torch.sqrt(v / bc2) + eps) + wd * p.float()
    p.copy_((p.float() - lr * delta).to(p.dtype))


def adamw_update(grads, state: AdamWState, params, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, grad_clip=1.0, mesh=None, specs=None):
    """One AdamW step: a global-norm clip of ``grads`` to ``grad_clip``,
    bias correction with the incremented step, weight decay on every leaf
    inside the update. ``lr`` is a float or a 0-d tensor. Updates
    ``params``, ``state.m`` and ``state.v`` in place; returns (params, new
    state). Under a mesh every tree holds the rank's shards (``specs``:
    their PartitionSpecs): only the norm needs the other ranks'."""
    gnorm = global_norm(grads, mesh, specs)
    # a true division (a Python number over a tensor is a reciprocal times it)
    scale = torch.clamp_max(torch.full_like(gnorm, grad_clip) / gnorm, 1.0)
    step = state.step + 1
    stepf = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=stepf.device), stepf)
    kw = dict(lr=lr, b1=b1, b2=b2, eps=eps, wd=weight_decay, scale=scale, bc1=bc1, bc2=bc2)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state.m),
                          tree_leaves(state.v)):
        rows = max(1, _SLICE_ELEMS * p.shape[0] // max(p.numel(), 1)) if p.dim() else 1
        if p.dim() == 0 or rows >= p.shape[0]:
            _update_leaf(p, g, m, v, **kw)
            continue
        for i in range(0, p.shape[0], rows):
            _update_leaf(p[i:i + rows], g[i:i + rows], m[i:i + rows], v[i:i + rows], **kw)
    return params, AdamWState(step=step, m=state.m, v=state.v)


def cosine_schedule(step, *, peak_lr=3e-4, warmup=100, total=10_000, floor=0.1):
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine to
    ``floor * peak_lr`` at ``total``. Returns an fp32 0-d tensor."""
    step = torch.as_tensor(step).float()
    warm = peak_lr * step / max(warmup, 1)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup, warm, cos)
