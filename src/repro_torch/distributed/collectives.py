"""int8 gradient compression with error feedback (the reference's
``repro.distributed.collectives``, the part the train step imports).

Gradients are quantized to int8 with one absmax scale a leaf before the
data-axis all-reduce, and the quantization residual is carried to the next
step, so the compression is unbiased in the long run. On one process (the
port has no all-reduce yet) this is a quantize / dequantize round trip with
error feedback.
"""
from __future__ import annotations

import torch

from repro_torch.models.params import map_tree, tree_leaves, tree_unflatten


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
    return map_tree(lambda pair: decompress_int8(*pair), qtree, is_leaf=_is_pair)


def zeros_error_like(grads):
    return map_tree(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)
