"""Collectives over one axis of a bound mesh (``launch.mesh.Mesh.bind``),
the ``jax.lax`` ones the reference's sharded code calls: ``psum``,
``pmean``, ``pmax``, ``all_to_all`` (split and concatenate on dim 0) and
``all_gather``; and the int8 gradient compression with error feedback (the
reference's ``repro.distributed.collectives``, the part the train step
imports).

The collectives take whatever backend the axis's process group has. One
branch names a backend: gloo, the backend the single-card checks run their
several ranks over, is handed CUDA tensors through the host (a copy to
the CPU and back), since it lacks some collectives on CUDA tensors. NCCL,
a multi-card machine's backend, takes them where they lie. None of them is
differentiable: training under a mesh is not in the port yet, so a tensor
that needs a gradient raises.

Gradients are quantized to int8 with one absmax scale a leaf before the
data-axis all-reduce, and the quantization residual is carried to the next
step, so the compression is unbiased in the long run. On one process this
is a quantize / dequantize round trip with error feedback.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import spec_axes


def _check(x):
    if x.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError("a mesh collective on a tensor that needs a gradient: "
                                  "training under a mesh is not in the port yet")


def _through_host(x, group) -> bool:
    """gloo gets CUDA tensors through the host (see the module's note)."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _all_reduce(x, mesh, axis, op):
    _check(x)
    out = x.contiguous()
    out = out.clone() if out is x else out
    for a in spec_axes(axis):
        g = mesh.group(a)
        if _through_host(out, g):
            host = out.cpu()
            dist.all_reduce(host, op=op, group=g)
            out.copy_(host)
        else:
            dist.all_reduce(out, op=op, group=g)
    return out


def psum(x, mesh, axis):
    """Sum of ``x`` over the ranks along ``axis`` (a name or a tuple), in
    ``x``'s dtype, as ``jax.lax.psum``. Returns a new tensor."""
    return _all_reduce(x, mesh, axis, dist.ReduceOp.SUM)


def pmax(x, mesh, axis):
    return _all_reduce(x, mesh, axis, dist.ReduceOp.MAX)


def pmean(x, mesh, axis):
    return psum(x, mesh, axis) / mesh.count(axis)


def all_to_all(x, mesh, axis: str):
    """``jax.lax.all_to_all(x, axis, 0, 0)``: chunk i of dim 0 goes to the
    i-th rank along ``axis``; the result's chunk j came from the j-th."""
    _check(x)
    g = mesh.group(axis)
    x = x.contiguous()
    if _through_host(x, g):
        host = x.cpu()
        out = torch.empty_like(host)
        dist.all_to_all_single(out, host, group=g)
        return out.to(x.device)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=g)
    return out


def all_gather(x, mesh, axis, dim: int = 0):
    """The ranks' tensors along ``axis`` (a name, or a tuple gathered
    row-major as a PartitionSpec entry splits) concatenated on ``dim``."""
    _check(x)
    for a in reversed(spec_axes(axis)):
        g = mesh.group(a)
        n = mesh.shape[a]
        src = x.contiguous()
        host = _through_host(src, g)
        src_ = src.cpu() if host else src
        parts = [torch.empty_like(src_) for _ in range(n)]
        dist.all_gather(parts, src_, group=g)
        x = torch.cat(parts, dim=dim)
        x = x.to(src.device) if host else x
    return x


def compress_int8(g):
    amax = torch.max(torch.abs(g)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q, scale):
    return q.float() * scale


def compress_grads_with_feedback(grads, error):
    """Returns (the tree of (q int8, scale) pairs, the new error tree).
    ``error`` is the running residual (the grads' tree, fp32; zeros at
    first)."""
    from repro_torch.models.params import tree_leaves, tree_unflatten   # the models import us
    pairs, errs = [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(error)):
        g = g.float() + e
        q, scale = compress_int8(g)
        pairs.append((q, scale))
        errs.append(g - decompress_int8(q, scale))
    return tree_unflatten(grads, pairs), tree_unflatten(grads, errs)


def _is_pair(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], torch.Tensor)


def decompress_grads(qtree):
    from repro_torch.models.params import map_tree
    return map_tree(lambda pair: decompress_int8(*pair), qtree, is_leaf=_is_pair)


def zeros_error_like(grads):
    from repro_torch.models.params import map_tree
    return map_tree(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)
