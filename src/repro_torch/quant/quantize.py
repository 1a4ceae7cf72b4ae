"""Serving-time quantization (paper §4.1 Model Quantization), as the
reference's ``repro.quant.quantize``.

- weight-only int8: every large floating leaf of at least two dims becomes a
  ``QuantizedLinear`` (int8 values + fp32 absmax scale). The scale is taken
  over the leaf's LAST axis, as the reference's ``_quant_leaf`` does: a
  ``(K, N)`` projection gets one scale per input row ``(K, 1)``, a
  ``(d, H, hd)`` one per (input row, head) ``(d, H, 1)``. The model's
  ``linear`` hands that scale to the w8a16 kernel as its ``row_scale``.
- fp8 (e4m3) storage cast for comparison.
- int8 KV-cache quantization, per (position, head).

Same arithmetic as the reference, so the int8 values and scales are
bit-equal to JAX's: ``max(amax, 1e-8) / 127`` in fp32, round half to even,
clip to +-127. A large leaf is quantized one slice of its leading axes at a
time (the reduction runs over the last axis only, so the result is the
same) to keep the fp32 working copy small: a full-depth mixtral expert leaf
is 15 G elements. Leaves stay on their device.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch


class QuantizedLinear(NamedTuple):
    q: torch.Tensor        # int8, same shape as the original weight
    scale: torch.Tensor    # fp32, the weight's shape with its last axis 1


_QUANT_MIN_SIZE = 1 << 14   # only quantize big matmul weights
_SLICE_ELEMS = 1 << 26      # quantize larger leaves one leading slice at a time


def quantizable(shape, dtype: torch.dtype) -> bool:
    """The reference's predicate: floating, at least 2-D, at least
    ``_QUANT_MIN_SIZE`` elements. It takes norms, routers, convs and
    embeddings too once they are large enough (at full depth the stacked
    ``(R, d)`` norms are)."""
    n = 1
    for s in shape:
        n *= s
    return len(shape) >= 2 and n >= _QUANT_MIN_SIZE and dtype.is_floating_point


def _quant_into(w: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> None:
    if w.dim() > 2 and w.numel() > _SLICE_ELEMS:
        for i in range(w.shape[0]):
            _quant_into(w[i], q[i], scale[i])
        return
    wf = w.float()
    s = torch.clamp_min(wf.abs().amax(dim=-1, keepdim=True), 1e-8) / 127.0
    q.copy_(torch.round(wf / s).clamp_(-127, 127))
    scale.copy_(s)


def quantize_leaf(w: torch.Tensor) -> QuantizedLinear:
    """int8 absmax quantization of one tensor over its last axis."""
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty((*w.shape[:-1], 1), dtype=torch.float32, device=w.device)
    _quant_into(w, q, scale)
    return QuantizedLinear(q=q, scale=scale)


def dequant(leaf, dtype: torch.dtype):
    """A ``QuantizedLinear`` -> ``q * scale`` in ``dtype``; any other leaf is
    returned as it is (the reference's ``dequantize_tree``, leaf by leaf)."""
    if isinstance(leaf, QuantizedLinear):
        return (leaf.q.float() * leaf.scale).to(dtype)
    return leaf


def _map(fn, tree, quantized_leaf: bool = False):
    """``jax.tree.map`` over dicts, lists and tuples; a ``QuantizedLinear``
    is a node (of ``q`` and ``scale``) unless ``quantized_leaf``."""
    if isinstance(tree, QuantizedLinear):
        return fn(tree) if quantized_leaf else QuantizedLinear(*(_map(fn, v) for v in tree))
    if isinstance(tree, dict):
        return {k: _map(fn, v, quantized_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, quantized_leaf) for v in tree)
    return fn(tree)


def quantize_params_int8(params) -> Any:
    """Quantize every large >=2-D floating leaf to ``QuantizedLinear`` (int8
    + scale over the last axis); small leaves (norms, biases at small
    sizes) stay as they are."""
    def one(w):
        if isinstance(w, torch.Tensor) and quantizable(w.shape, w.dtype):
            return quantize_leaf(w)
        return w
    return _map(one, params)


def dequantize_tree(qparams, dtype: torch.dtype = torch.bfloat16):
    return _map(lambda leaf: dequant(leaf, dtype), qparams, quantized_leaf=True)


def fp8_cast_tree(params):
    """fp8 (e4m3) storage cast of every >=2-D floating leaf."""
    def one(w):
        if isinstance(w, torch.Tensor) and w.dim() >= 2 and w.dtype.is_floating_point:
            return w.to(torch.float8_e4m3fn)
        return w
    return _map(one, params)


# ---------------------------------------------------------------- KV cache
def kv_quantize(kv) -> Tuple[torch.Tensor, torch.Tensor]:
    """kv (..., hd) -> (int8 kv, fp32 scale (..., 1)): per-(position, head)."""
    qt = quantize_leaf(kv)
    return qt.q, qt.scale


def kv_dequantize(q, scale, dtype: torch.dtype = torch.float32):
    return (q.float() * scale).to(dtype)
