"""Parameter specification, seeded init and the weight bridge from JAX.

The tree mirrors ``repro.models.params``: a nested dict whose leaves are
tensors, with repeated layers stacked on a leading ``(R, ...)`` repeat axis
per layer group and the same leaf names, so a parameter pytree of the JAX
package maps onto this one leaf for leaf (``params_from_numpy``).

It covers every family of the reference: dense and MoE attention, the SSM
and hybrid ones, enc-dec (cross attention leaves ``ln_x`` / ``cross`` on
each decoder layer, and the ``encoder`` stack) and VLM (``vision_proj``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import resolve_device
from repro_torch.quant.quantize import QuantizedLinear, quantizable, quantize_leaf


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "lecun"          # lecun | normal02 | zeros | ones | a_log | dt_bias
    tag: str = ""                # "routed_expert" marks MoE routed weights (active-count)

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def _attn_specs(cfg: ModelConfig, R: int) -> Dict[str, Any]:
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s: Dict[str, Any] = {
        "wq": ParamSpec((R, d, H, hd), ("layers", "embed", "heads", "head_dim")),
        "wk": ParamSpec((R, d, Hkv, hd), ("layers", "embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((R, d, Hkv, hd), ("layers", "embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((R, H, hd, d), ("layers", "heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((R, H, hd), ("layers", "heads", "head_dim"), "zeros")
        s["bk"] = ParamSpec((R, Hkv, hd), ("layers", "kv_heads", "head_dim"), "zeros")
        s["bv"] = ParamSpec((R, Hkv, hd), ("layers", "kv_heads", "head_dim"), "zeros")
    return s


def _dense_mlp_specs(cfg: ModelConfig, R: int, d_ff: int) -> Dict[str, Any]:
    d = cfg.d_model
    return {
        "wi": ParamSpec((R, d, d_ff), ("layers", "embed", "mlp")),
        "wg": ParamSpec((R, d, d_ff), ("layers", "embed", "mlp")),
        "wo": ParamSpec((R, d_ff, d), ("layers", "mlp", "embed")),
    }


def _moe_specs(cfg: ModelConfig, R: int) -> Dict[str, Any]:
    d, m = cfg.d_model, cfg.moe
    fe = m.d_expert or cfg.d_ff
    s: Dict[str, Any] = {
        "router": ParamSpec((R, d, m.num_experts), ("layers", "embed", None), "normal02"),
        "wg": ParamSpec((R, m.num_experts, d, fe), ("layers", "experts", "embed", "expert_mlp"), tag="routed_expert"),
        "wu": ParamSpec((R, m.num_experts, d, fe), ("layers", "experts", "embed", "expert_mlp"), tag="routed_expert"),
        "wd": ParamSpec((R, m.num_experts, fe, d), ("layers", "experts", "expert_mlp", "embed"), tag="routed_expert"),
    }
    if m.num_shared_experts > 0:
        fs = fe * m.num_shared_experts
        s["shared"] = _dense_mlp_specs(cfg, R, fs)
    return s


def _ssm_specs(cfg: ModelConfig, R: int) -> Dict[str, Any]:
    d, ssm = cfg.d_model, cfg.ssm
    d_in = cfg.d_inner
    H = cfg.ssm_heads
    G, N = ssm.n_groups, ssm.d_state
    d_proj = 2 * d_in + 2 * G * N + H     # z, x, B, C, dt
    conv_dim = d_in + 2 * G * N           # x, B, C go through the causal conv
    return {
        "in_proj": ParamSpec((R, d, d_proj), ("layers", "embed", "ssm_proj")),
        "conv_w": ParamSpec((R, conv_dim, ssm.d_conv), ("layers", "conv_dim", None)),
        "conv_b": ParamSpec((R, conv_dim), ("layers", "conv_dim"), "zeros"),
        "A_log": ParamSpec((R, H), ("layers", "ssm_heads"), "a_log"),
        "D": ParamSpec((R, H), ("layers", "ssm_heads"), "ones"),
        "dt_bias": ParamSpec((R, H), ("layers", "ssm_heads"), "dt_bias"),
        "norm": ParamSpec((R, d_in), ("layers", "ssm_inner"), "ones"),
        "out_proj": ParamSpec((R, d_in, d), ("layers", "ssm_inner", "embed")),
    }


def _layer_specs(cfg: ModelConfig, kind: str, is_moe: bool, R: int, *, cross: bool = False,
                 dense_first: bool = False) -> Dict[str, Any]:
    d = cfg.d_model
    spec: Dict[str, Any] = {"ln1": ParamSpec((R, d), ("layers", "embed"), "ones")}
    if kind == "M":
        spec["ssm"] = _ssm_specs(cfg, R)
    else:
        spec["attn"] = _attn_specs(cfg, R)
    if cross:
        spec["ln_x"] = ParamSpec((R, d), ("layers", "embed"), "ones")
        spec["cross"] = _attn_specs(cfg, R)
    if is_moe and cfg.moe is not None:
        spec["ln2"] = ParamSpec((R, d), ("layers", "embed"), "ones")
        spec["moe"] = _moe_specs(cfg, R)
    elif cfg.d_ff > 0 or dense_first:
        d_ff = cfg.dense_d_ff if (dense_first and cfg.dense_d_ff) else cfg.d_ff
        spec["ln2"] = ParamSpec((R, d), ("layers", "embed"), "ones")
        spec["mlp"] = _dense_mlp_specs(cfg, R, d_ff)
    return spec


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    specs: Dict[str, Any] = {
        "embed": {"w": ParamSpec((cfg.vocab, d), ("vocab", "embed"), "normal02")},
        "final_norm": {"w": ParamSpec((d,), ("embed",), "ones")},
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = {"w": ParamSpec((d, cfg.vocab), ("embed", "vocab"))}
    groups = []
    cross = cfg.family == "encdec"
    for gi, g in enumerate(cfg.layer_groups):
        layers = []
        for pos, kind in enumerate(g.pattern):
            is_moe = bool(g.moe_mask and g.moe_mask[pos % len(g.moe_mask)] == "1")
            dense_first = (gi == 0 and pos == 0 and cfg.dense_d_ff > 0 and not is_moe)
            layers.append(_layer_specs(cfg, kind, is_moe, g.repeats, cross=cross,
                                       dense_first=dense_first))
        groups.append({"layers": layers})
    specs["groups"] = groups
    if cfg.encoder is not None:
        enc_layers = [_layer_specs(cfg, "A", False, cfg.encoder.n_layers)]
        specs["encoder"] = {
            "groups": [{"layers": enc_layers}],
            "final_norm": {"w": ParamSpec((d,), ("embed",), "ones")},
        }
    if cfg.vision is not None:
        specs["vision_proj"] = {
            "w": ParamSpec((cfg.vision.d_patch, d), (None, "embed")),
            "b": ParamSpec((d,), ("embed",), "zeros"),
        }
    return specs


def map_tree(fn, tree, is_leaf=None):
    """Apply ``fn`` to every leaf of a dict/list/tuple tree of parameters,
    caches or optimizer state, in JAX pytree order (dict keys sorted, lists
    and tuples in order). A NamedTuple (``QuantizedLinear``, the optimizer's
    state) is a node of its fields, as in JAX, unless ``is_leaf`` takes it
    whole; None is an empty node, as in JAX."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], is_leaf) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tree(fn, v, is_leaf) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, is_leaf) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a tree in ``map_tree``'s order."""
    out = []
    map_tree(out.append, tree)
    return out


def tree_unflatten(tree, leaves):
    """``tree``'s structure with ``leaves`` (in ``map_tree``'s order) in
    place of its own."""
    it = iter(leaves)
    return map_tree(lambda _: next(it), tree)


# --------------------------------------------------------------------------
def _init_slices(spec: ParamSpec, gen: torch.Generator, device: torch.device,
                 dtype: torch.dtype):
    """Yields (r, values in ``dtype``): one repeat r of a stacked (>= 3-D)
    normal leaf at a time, drawn in float32, so a full-width expert stack
    never needs a float32 copy of the whole leaf; any other leaf whole,
    with r None."""
    shape = spec.shape
    if spec.init == "zeros":
        yield None, torch.zeros(shape, dtype=dtype, device=device)
        return
    if spec.init == "ones":
        yield None, torch.ones(shape, dtype=dtype, device=device)
        return
    if spec.init in ("a_log", "dt_bias"):
        u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
        if spec.init == "a_log":                   # mamba2: A ~ uniform[1, 16], stored as log
            yield None, torch.log(1.0 + 15.0 * u).to(dtype)
            return
        dt = 1e-3 + (1e-1 - 1e-3) * u              # inverse softplus of dt ~ uniform[1e-3, 1e-1]
        yield None, (dt + torch.log(-torch.expm1(-dt))).to(dtype)
        return
    if spec.init == "normal02":
        std = 0.02
    else:
        # lecun: fan_in = the input dim after the stacking dim (as the JAX init)
        fan_in = shape[-2] if len(shape) >= 2 else shape[0]
        if len(shape) == 4:            # (R, in, h, hd) or (R, E, in, out)
            fan_in = shape[1] if spec.logical[1] == "embed" else shape[2]
        std = 1.0 / math.sqrt(max(fan_in, 1))
    if len(shape) < 3:
        yield None, torch.randn(shape, generator=gen, dtype=torch.float32,
                                device=device).mul_(std).to(dtype)
        return
    for r in range(shape[0]):
        tmp = torch.randn(shape[1:], generator=gen, dtype=torch.float32, device=device)
        yield r, tmp.mul_(std).to(dtype)


def _init_leaf(spec: ParamSpec, gen: torch.Generator, device: torch.device,
               dtype: torch.dtype, where: Optional[Tuple[slice, ...]] = None) -> torch.Tensor:
    """The leaf's values; with ``where`` (the rank's slice of each dim, the
    repeat dim whole) only that shard, taken from each repeat as it is
    drawn, so the stream of numbers is the whole init's."""
    out = None
    for r, part in _init_slices(spec, gen, device, dtype):
        if r is None:
            return part if where is None else part[where].clone()
        if out is None:
            shape = spec.shape if where is None else (
                spec.shape[0], *(s.stop - s.start for s in where[1:]))
            out = torch.empty(shape, dtype=dtype, device=device)
        out[r].copy_(part if where is None else part[where[1:]])
    return out


def _init_leaf_int8(spec: ParamSpec, gen: torch.Generator, device: torch.device,
                    dtype: torch.dtype):
    """``quantize_leaf`` of ``_init_leaf``'s tensor when the reference's
    predicate takes the leaf, quantized one repeat at a time; the float
    leaf otherwise."""
    if not quantizable(spec.shape, dtype):
        return _init_leaf(spec, gen, device, dtype)
    out = None
    for r, part in _init_slices(spec, gen, device, dtype):
        if r is None:
            return quantize_leaf(part)
        if out is None:
            out = QuantizedLinear(
                q=torch.empty(spec.shape, dtype=torch.int8, device=device),
                scale=torch.empty((*spec.shape[:-1], 1), dtype=torch.float32, device=device))
        qr = quantize_leaf(part)
        out.q[r].copy_(qr.q)
        out.scale[r].copy_(qr.scale)
    return out


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: Optional[Union[str, torch.device]] = None,
                dtype: torch.dtype = torch.float32, mesh=None, rules=None) -> Dict[str, Any]:
    """Random parameters following the reference's distributions (normal
    0.02 for embeddings and router, LeCun normal for projections, ones for
    norms, zeros for biases; for SSM layers A_log = log U[1, 16] and dt_bias
    the inverse softplus of U[1e-3, 1e-1]), drawn from a seeded generator on
    ``device``.
    The numbers differ from the JAX init of the same seed; to hold the port
    against the reference, bridge the JAX tree with ``params_from_numpy``.
    With a bound ``mesh`` and its ``rules``: this rank's shards by
    ``param_partition_specs``, equal to the slices of the whole init on the
    same device type, drawn one repeat at a time, so no rank ever holds a
    whole stacked leaf."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if mesh is None:
        return map_tree(lambda s: _init_leaf(s, gen, dev, dtype), param_specs(cfg))
    from repro_torch.distributed.sharding import partition_spec, shard_slices

    def leaf(s):
        ps = partition_spec(s.shape, s.logical, mesh, rules)
        where = shard_slices(s.shape, ps, mesh)
        if len(s.shape) >= 3 and ps[0] is not None:
            raise ValueError(f"the repeat dim of {s.shape} is split: {ps}")
        return _init_leaf(s, gen, dev, dtype, where)
    return map_tree(leaf, param_specs(cfg))


def init_params_int8(cfg: ModelConfig, seed: int = 0, *,
                     device: Optional[Union[str, torch.device]] = None,
                     dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """``quantize_params_int8(init_params(cfg, seed, device=device,
    dtype=dtype))``, leaf for leaf and bit for bit (the same generator
    stream, each repeat rounded to ``dtype`` before it is quantized), while
    never holding more than one repeat of a leaf in float: the full-depth
    mixtral-8x7b is ~93 GB in bf16 and ~47 GB in int8, so only this way
    does it fit on one 80 GB card."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return map_tree(lambda s: _init_leaf_int8(s, gen, dev, dtype), param_specs(cfg))


def _is_quantized(a) -> bool:
    """A quantized leaf of either package (duck typed: the JAX package's
    ``QuantizedLinear`` cannot be imported here)."""
    return hasattr(a, "q") and hasattr(a, "scale")


def params_from_numpy(tree, device: Optional[Union[str, torch.device]] = None,
                      dtype: Optional[torch.dtype] = None):
    """The weight bridge: a parameter tree with array leaves (``np.asarray``
    of each JAX leaf, or the JAX arrays themselves) -> the same tree of
    tensors on ``device``, cast to ``dtype`` when given. A quantized leaf
    (``q`` / ``scale``, as ``quantize_params_int8`` of either package makes
    it) becomes a ``QuantizedLinear`` whose ``q`` stays int8 and ``scale``
    fp32. Leaves are copied, because ``np.asarray`` of a JAX array is
    read-only and ``torch.from_numpy`` needs a writable buffer."""
    dev = resolve_device(device)

    def tensor(a, dt):
        t = torch.from_numpy(np.array(a, copy=True))
        return t.to(device=dev, dtype=dt or t.dtype)

    def leaf(a):
        if _is_quantized(a):
            return QuantizedLinear(q=tensor(a.q, torch.int8), scale=tensor(a.scale, torch.float32))
        return tensor(a, dtype)
    return map_tree(leaf, tree, is_leaf=_is_quantized)


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    def count(s: ParamSpec) -> int:
        n = int(np.prod(s.shape))
        if active_only and s.tag == "routed_expert":
            n = int(n * cfg.moe.top_k / cfg.moe.num_experts)
        return n
    counts = []
    map_tree(lambda s: counts.append(count(s)), param_specs(cfg))
    return sum(counts)
