"""Collectives over one axis of a bound mesh (``launch.mesh.Mesh.bind``),
the ``jax.lax`` ones the reference's sharded code calls: ``psum``,
``pmean``, ``pmax``, ``all_to_all`` (split and concatenate on dim 0),
``all_gather`` and ``reduce_scatter`` (the sum of which each rank keeps its
part along a dim, the sequence-parallel rule's pair of the gather); and
the int8 gradient compression with error feedback (the
reference's ``repro.distributed.collectives``, the part the train step
imports).

The collectives take whatever backend the axis's process group has. One
branch names a backend: gloo, the backend the single-card checks run their
several ranks over, is handed CUDA tensors through the host (a copy to
the CPU and back), since it lacks some collectives on CUDA tensors. NCCL,
a multi-card machine's backend, takes them where they lie. The backward
passes run the same collectives, through the same branch.

Every collective is differentiable, under one convention, the one the
reference's ``shard_map(check_rep=False)`` transposes by: **a tensor that
several ranks hold alike carries its cotangent in shares, one a rank, that
sum to the true cotangent.** Each backward is then its forward's linear
transpose:

- ``psum``: the output is held alike, each input is the rank's own; its
  backward is a psum of the shares (every input gets the whole cotangent).
  ``pmean``: psum / n both ways. ``pmax``: the psum of the shares goes to
  the inputs that hold the max (shared among ties).
- ``all_gather``: its backward sums the shares and keeps the rank's slice
  (a reduce-scatter).
- ``reduce_scatter``: each input is the rank's own partial of the sum, and
  each output the rank's own part of it; its backward all-gathers the
  parts' cotangents (every input gets the whole cotangent of the sum).
- ``all_to_all``: a permutation of chunks among ranks; its backward is the
  same all_to_all (it is its own inverse).

So Megatron's f / g pair needs no operator of its own: a replicated
activation entering a column-split projection keeps on each rank the share
its columns give, and the row-split projection's psum sums the shares in
the backward. Two places finish the convention:

- ``shared_out``: a value every rank of the mesh computes, the loss, starts
  its backward with 1 / (ranks) of the cotangent on each rank (the
  reference's transpose of an ``out_specs`` ``P()``). A term that differs
  by rank, such as the MoE aux loss of each data shard's tokens, then
  enters the gradient as its mean over the ranks, as in the reference.
- the parameters' gradients: a leaf held alike along a mesh axis (the axis
  does not split it) has its shares psum'd over that axis
  (``training.train_step.reduce_grads``), the tensor and expert axes as
  well as the data axis. A leaf split on data by FSDP gets its data-axis
  sum from its gather's backward (the reduce-scatter).

``record_collectives()`` logs every collective that moves data: one entry
``(kind, bytes, axis)`` an axis of more than one rank, the kinds the
reference's dry-run reads out of its optimised HLO (``all-gather``,
``all-reduce``, ``reduce-scatter``, ``all-to-all``; the port has no
collective-permute), the bytes the size of the rank's result buffer, as
``repro.launch.roofline.parse_collective_bytes`` sums them. On a bound mesh
the collective still runs. On a mesh placed at one rank with no process
group (``Mesh.at``), and only inside the context, it runs nothing and
returns a tensor of the result's shape, dtype and device: ``psum`` /
``pmax`` / ``all_to_all`` give ``x``, ``all_gather`` its ``n`` copies
concatenated, ``reduce_scatter`` the rank's chunk of ``x``. These are not
the sharded program's values: a walk on a placed mesh (``launch.dryrun``)
proves shapes, memory and counts, never numbers. Outside the context a
placed mesh's collective raises, as an unbound mesh's does.

Gradients are quantized to int8 with one absmax scale a leaf before the
data-axis all-reduce, and the quantization residual is carried to the next
step, so the compression is unbiased in the long run. On one process this
is a quantize / dequantize round trip with error feedback; under a mesh a
leaf's scale is the pmax of its shards' absmax (``compress_int8(amax=)``).
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import spec_axes


class _Recording(threading.local):
    log = None


_recording = _Recording()


@contextlib.contextmanager
def record_collectives():
    """While open, every collective adds ``(kind, result bytes, axis)`` to
    the list it yields, and a placed mesh's collectives stand in for
    their results (the module's note)."""
    prev, log = _recording.log, []
    _recording.log = log
    try:
        yield log
    finally:
        _recording.log = prev


def _stand_in(mesh, kind: str, nbytes: int, axis: str) -> bool:
    """Logs the collective when recording; True when it is not to run (a
    placed mesh inside ``record_collectives``). A mesh with no process
    group outside the context raises here."""
    log = _recording.log
    if log is not None:
        log.append((kind, int(nbytes), axis))
    if mesh.bound:
        return False
    if log is None:
        mesh.group(axis)                           # raises: no process group
    return True


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _through_host(x, group) -> bool:
    """gloo gets CUDA tensors through the host (see the module's note)."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _pinned(shape, dtype):
    """A host buffer from PyTorch's caching pinned allocator: reused from
    call to call (a fresh pageable buffer is page-faulted in on every
    collective) and copied to and from the card by DMA."""
    return torch.empty(shape, dtype=dtype, pin_memory=True)


def _to_host(x):
    return _pinned(x.shape, x.dtype).copy_(x)


def _all_reduce(x, mesh, axis, op):
    """All-reduce over ``axis`` into a new tensor (no autograd). An axis of
    one rank is skipped, as every collective skips it."""
    out = x.contiguous()
    out = out.clone() if out is x else out
    for a in spec_axes(axis):
        if mesh.shape[a] == 1 or _stand_in(mesh, "all-reduce", _nbytes(out), a):
            continue
        g = mesh.group(a)
        if _through_host(out, g):
            host = _to_host(out)
            dist.all_reduce(host, op=op, group=g)
            out.copy_(host)
        else:
            dist.all_reduce(out, op=op, group=g)
    return out


def _all_to_all(x, mesh, axis: str, record: bool = True):
    """(``record`` False: a reduce-scatter's exchange, logged as that.)"""
    if mesh.shape[axis] == 1:
        return x.clone()
    if record and _stand_in(mesh, "all-to-all", _nbytes(x), axis):
        return x.clone()
    g = mesh.group(axis)
    x = x.contiguous()
    if _through_host(x, g):
        out = _pinned(x.shape, x.dtype)
        dist.all_to_all_single(out, _to_host(x), group=g)
        return out.to(x.device)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=g)
    return out


def _all_gather(x, mesh, axis, dim: int):
    """(The parts come back to the device before they are concatenated:
    a strided concatenation on the host runs on one CPU thread.)"""
    for a in reversed(spec_axes(axis)):
        n = mesh.shape[a]
        if n == 1:
            continue
        if _stand_in(mesh, "all-gather", n * _nbytes(x), a):
            x = torch.cat([x] * n, dim=dim)
            continue
        g = mesh.group(a)
        src = x.contiguous()
        host = _through_host(src, g)
        src_ = _to_host(src) if host else src
        parts = [_pinned(src.shape, src.dtype) if host else torch.empty_like(src)
                 for _ in range(n)]
        dist.all_gather(parts, src_, group=g)
        x = torch.cat([p.to(src.device) for p in parts] if host else parts, dim=dim)
    return x


def _reduce_scatter(x, mesh, axis, dim: int):
    """The transpose of ``_all_gather``: the sum over ``axis``'s ranks of
    ``x``, of which this rank keeps its part along ``dim``. Each part goes
    to its rank by all_to_all (half the bytes of an all-reduce at two
    ranks) and the parts received are summed in rank order; over a tuple
    the outer axis first, as the gather's concatenation nests."""
    for a in spec_axes(axis):
        n = mesh.shape[a]
        if n == 1:
            continue
        if _stand_in(mesh, "reduce-scatter", _nbytes(x) // n, a):
            x = x.chunk(n, dim)[mesh.index(a)].contiguous()
            continue
        x = _all_to_all(torch.stack(x.chunk(n, dim)), mesh, a, record=False).sum(0)
    return x


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_reduce(x, mesh, axis, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axis, dist.ReduceOp.SUM), None, None


class _PMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        out = _all_reduce(x, mesh, axis, dist.ReduceOp.MAX)
        ctx.mesh, ctx.axis = mesh, axis
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        hit = (x == out).to(g.dtype)
        ties = _all_reduce(hit, ctx.mesh, ctx.axis, dist.ReduceOp.SUM)
        g = _all_reduce(g, ctx.mesh, ctx.axis, dist.ReduceOp.SUM)
        return g * hit / ties.clamp_min(1), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_to_all(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.mesh, ctx.axis), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _reduce_scatter(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _SharedOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def psum(x, mesh, axis):
    """Sum of ``x`` over the ranks along ``axis`` (a name or a tuple), in
    ``x``'s dtype, as ``jax.lax.psum``. Returns a new tensor."""
    return _PSum.apply(x, mesh, axis)


def pmax(x, mesh, axis):
    return _PMax.apply(x, mesh, axis)


def pmean(x, mesh, axis):
    return psum(x, mesh, axis) / mesh.count(axis)


def all_to_all(x, mesh, axis: str):
    """``jax.lax.all_to_all(x, axis, 0, 0)``: chunk i of dim 0 goes to the
    i-th rank along ``axis``; the result's chunk j came from the j-th."""
    return _AllToAll.apply(x, mesh, axis)


def all_gather(x, mesh, axis, dim: int = 0):
    """The ranks' tensors along ``axis`` (a name, or a tuple gathered
    row-major as a PartitionSpec entry splits) concatenated on ``dim``."""
    dim = dim % x.dim()
    return _AllGather.apply(x, mesh, axis, dim)


def reduce_scatter(x, mesh, axis, dim: int = 0):
    """The sum of ``x`` over the ranks along ``axis``, of which this rank
    keeps its part along ``dim`` (``all_gather``'s row-major order): a
    row-split projection's partial sum onto the sequence shard. Returns a
    new tensor."""
    dim = dim % x.dim()
    return _ReduceScatter.apply(x, mesh, axis, dim)


def shared_out(x, mesh):
    """``x``, a value every rank of ``mesh`` computes (the loss): identity
    forward; the backward hands each rank 1 / (ranks) of the cotangent, its
    share (see the module's note)."""
    return _SharedOut.apply(x, mesh.size)


def compress_int8(g, amax=None):
    """(q int8, scale) of ``g`` with one absmax scale; ``amax``: the leaf's
    absmax when ``g`` is one shard of it (the pmax of the shards')."""
    amax = (torch.max(torch.abs(g)) if amax is None else amax) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q, scale):
    return q.float() * scale


def compress_grads_with_feedback(grads, error, absmax=None):
    """Returns (the tree of (q int8, scale) pairs, the new error tree).
    ``error`` is the running residual (the grads' tree, fp32; zeros at
    first). ``absmax(i, g)``: the absmax of leaf i whose local part is
    ``g`` (under a mesh, the pmax over the axes that split it); default
    ``g``'s own."""
    from repro_torch.models.params import tree_leaves, tree_unflatten   # the models import us
    pairs, errs = [], []
    for i, (g, e) in enumerate(zip(tree_leaves(grads), tree_leaves(error))):
        g = g.float() + e
        q, scale = compress_int8(g, None if absmax is None else absmax(i, g))
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
