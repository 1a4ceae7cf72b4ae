"""Logical-axis sharding rules with divisibility fallback (the reference's
``repro.distributed.sharding``), and the rank's shard of a tree.

Every parameter / cache / activation dim carries a *logical* axis name; a
RuleSet maps logical names to ordered candidate mesh-axis assignments. A mesh
axis is assigned to a dim only if (a) it exists in the mesh, (b) it is not
already used by another dim of the same tensor, and (c) its size divides the
dim. Assignment order follows per-name priority (kv_heads outranks kv_seq, so
a GQA cache shards heads first and falls back to sequence sharding only when
the head count doesn't divide).

The reference hands the specs to GSPMD, which moves data to match them. The
port runs explicit collectives over local tensors, so here a spec says which
slice of each global tensor a rank holds (``shard`` / ``shard_tree``, what
``jax.device_put(x, NamedSharding)`` does), and ``constrain`` checks that a
local tensor has the shape of its spec's shard.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.launch.mesh import spec_axes

Candidate = Tuple[str, ...]          # one candidate = tuple of mesh axes used together


class PartitionSpec(tuple):
    """One entry per dim: None (whole), a mesh axis name, or a tuple of
    names (split over their product, row-major). A tuple, so its entries
    compare equal to ``jax.sharding.PartitionSpec``'s."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True, eq=False)
class RuleSet:
    rules: Dict[str, Tuple[Candidate, ...]]
    priority: Dict[str, int]
    name: str = "custom"

    def candidates(self, logical: str) -> Tuple[Candidate, ...]:
        return self.rules.get(logical, ())

    def prio(self, logical: str) -> int:
        return self.priority.get(logical, 0)


_PRIORITY = {
    "experts": 10, "heads": 10, "kv_heads": 10,
    "expert_mlp": 9, "mlp": 9, "vocab": 9, "ssm_proj": 9, "ssm_inner": 9,
    "conv_dim": 9, "ssm_heads": 9,
    "batch": 8,
    "embed": 5,
    "kv_seq": 3, "seq": 2,
    "layers": 0, "head_dim": 0, "vision_patch": 0,
}


def make_rules(mode: str = "serve", moe: str = "ep", *, multi_pod: bool = False,
               seq_shard: bool = False, tensor_axis: str = "model",
               expert_axis: Optional[str] = None) -> RuleSet:
    """mode: "serve" | "train". moe: "ep" (hybrid TP x EP: experts on the
    expert axis, the paper's optimized config) | "tp" (the paper's baseline
    pure TP: experts replicated). On the fixed production mesh the expert
    axis IS the data axis; the factored Exp4 mesh ("data", "expert",
    "tensor") names them explicitly."""
    t = tensor_axis
    e = expert_axis or "data"
    if multi_pod:
        batch: Tuple[Candidate, ...] = (("pod", "data"), ("data",))
    else:
        batch = (("data",),)
    r: Dict[str, Tuple[Candidate, ...]] = {
        "batch": batch,
        "heads": ((t,),),
        "kv_heads": ((t,),),
        "mlp": ((t,),),
        "expert_mlp": ((t,),),
        "vocab": ((t,),),
        "experts": ((e,),) if moe == "ep" else (),
        # kv_seq: the fallback when kv_heads can't take the tensor axis; on
        # the factored Exp4 mesh it may also spill onto the expert axis
        "kv_seq": ((t,), (e,)) if expert_axis else ((t,),),
        "ssm_proj": ((t,),),
        "ssm_inner": ((t,),),
        "conv_dim": ((t,),),
        "ssm_heads": ((t,),),
    }
    if mode == "train":
        r["embed"] = (("data",),)             # FSDP within pod
    if seq_shard:
        r["seq"] = ((t,),)                    # sequence parallelism
    return RuleSet(rules=r, priority=dict(_PRIORITY), name=f"{mode}/{moe}/{t}")


def _mesh_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def partition_spec(shape: Sequence[int], logical: Sequence[Optional[str]], mesh,
                   ruleset: RuleSet) -> PartitionSpec:
    """Build a PartitionSpec for ``shape`` with divisibility + axis-reuse
    checks. ``mesh`` needs only ``axis_names`` and ``devices.shape``."""
    assert len(shape) == len(logical), (shape, logical)
    mesh_sizes = _mesh_sizes(mesh)
    assign: Dict[int, Tuple[str, ...]] = {}
    used: set = set()
    order = sorted(range(len(shape)),
                   key=lambda i: -ruleset.prio(logical[i]) if logical[i] else 1)
    for i in order:
        name = logical[i]
        if name is None:
            continue
        for cand in ruleset.candidates(name):
            if any(a not in mesh_sizes for a in cand):
                continue
            if any(a in used for a in cand):
                continue
            prod = int(np.prod([mesh_sizes[a] for a in cand]))
            if prod > 1 and shape[i] % prod == 0:
                assign[i] = cand
                used.update(cand)
                break
    entries = []
    for i in range(len(shape)):
        if i in assign:
            entries.append(assign[i] if len(assign[i]) > 1 else assign[i][0])
        else:
            entries.append(None)
    return PartitionSpec(*entries)


# --------------------------------------------------------------------------
# The rank's shard of a global tensor
# --------------------------------------------------------------------------
def local_shape(shape: Sequence[int], spec: PartitionSpec, mesh) -> Tuple[int, ...]:
    """The shape of one shard of a ``shape`` tensor laid out by ``spec``."""
    sizes = _mesh_sizes(mesh)
    out = []
    for n, entry in zip(shape, spec):
        out.append(n // int(np.prod([sizes[a] for a in spec_axes(entry)], dtype=np.int64)))
    return tuple(out) + tuple(shape[len(spec):])


def shard_start(n: int, entry, mesh) -> int:
    """The first index of the bound rank's block of a dim of ``n`` split
    on ``entry`` (None, a mesh axis or a tuple of axes): 0 where whole."""
    return 0 if entry is None else mesh.index(entry) * (n // mesh.count(entry))


def shard_slices(shape: Sequence[int], spec: PartitionSpec, mesh) -> Tuple[slice, ...]:
    """The bound rank's slice of each dim."""
    local = local_shape(shape, spec, mesh)
    out = []
    for i, n in enumerate(local):
        entry = spec[i] if i < len(spec) else None
        k = 0 if entry is None else mesh.index(entry)
        out.append(slice(k * n, (k + 1) * n))
    return tuple(out)


def split_axes(spec: PartitionSpec, mesh) -> Tuple[str, ...]:
    """The mesh axes (of size > 1) that split a tensor laid out by
    ``spec``, in mesh order."""
    used = {a for entry in spec for a in spec_axes(entry)}
    return tuple(a for a in mesh.axis_names if a in used and mesh.shape[a] > 1)


def held_alike_axes(spec: PartitionSpec, mesh) -> Tuple[str, ...]:
    """The mesh axes (of size > 1) along which every rank holds the same
    shard of a tensor laid out by ``spec``: the ones it does not use."""
    used = {a for entry in spec for a in spec_axes(entry)}
    return tuple(a for a in mesh.axis_names if a not in used and mesh.shape[a] > 1)


def shard(x, spec: PartitionSpec, mesh):
    """The bound rank's shard of ``x`` (numpy array or tensor) as a new
    contiguous array or tensor: ``jax.device_put(x, NamedSharding(mesh,
    spec))`` seen from one rank."""
    part = x[shard_slices(x.shape, spec, mesh)]
    if isinstance(part, np.ndarray):
        return np.ascontiguousarray(part)
    return part.clone(memory_format=torch.contiguous_format)   # the whole leaf can be freed


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def shard_tree(tree, spec_tree, mesh):
    """``shard`` leaf by leaf; ``spec_tree`` mirrors ``tree`` (as
    ``param_partition_specs`` / ``cache_partition_specs`` give it)."""
    from repro_torch.models.params import map_tree      # the models import this module
    specs = []
    map_tree(specs.append, spec_tree, is_leaf=_is_spec)
    it = iter(specs)
    return map_tree(lambda leaf: shard(leaf, next(it), mesh), tree)


def gather_tree(tree, spec_tree, mesh):
    """The inverse of ``shard_tree``: every leaf all-gathered over the axes
    its spec splits it on, so each rank holds the global tree. A collective:
    every rank of the mesh calls it with its own shards."""
    from repro_torch.distributed.collectives import all_gather
    from repro_torch.models.params import map_tree
    specs = []
    map_tree(specs.append, spec_tree, is_leaf=_is_spec)
    it = iter(specs)

    def leaf(t):
        for dim, entry in enumerate(next(it)):
            if entry is not None and mesh.count(entry) > 1:
                t = all_gather(t, mesh, entry, dim=dim)
        return t
    return map_tree(leaf, tree)


# --------------------------------------------------------------------------
# Active context (thread-local): installs (mesh, ruleset) so model code can
# find the layout without threading it through every function.
# --------------------------------------------------------------------------
class _Active(threading.local):
    mesh = None
    ruleset: Optional[RuleSet] = None


_active = _Active()


@contextlib.contextmanager
def use_sharding(mesh, ruleset: Optional[RuleSet]):
    prev = (_active.mesh, _active.ruleset)
    _active.mesh, _active.ruleset = mesh, ruleset
    try:
        yield
    finally:
        _active.mesh, _active.ruleset = prev


def active():
    """(mesh, ruleset) installed by ``use_sharding``, or (None, None)."""
    return _active.mesh, _active.ruleset


def constrain(x, logical: Sequence[Optional[str]], shape: Optional[Sequence[int]] = None):
    """Under ``use_sharding``, check that the local tensor ``x`` is the
    shard its spec gives the global ``shape`` (default: ``x``'s own, for a
    tensor no rule splits), and return it. The reference's
    ``with_sharding_constraint`` moves data to match; here the layers hold
    their shards already, so a mismatch is a fault and raises."""
    mesh, rules = active()
    if mesh is None or rules is None:
        return x
    shape = tuple(x.shape) if shape is None else tuple(shape)
    spec = partition_spec(shape, logical, mesh, rules)
    want = local_shape(shape, spec, mesh)
    if tuple(x.shape) != want:
        raise ValueError(f"local tensor {tuple(x.shape)} is not the shard {want} of "
                         f"{shape} {tuple(logical)} under {spec}")
    return x


# --------------------------------------------------------------------------
# Whole-tree spec builders
# --------------------------------------------------------------------------
def param_partition_specs(spec_tree, mesh, ruleset: RuleSet):
    """ParamSpec tree -> PartitionSpec tree."""
    from repro_torch.models.params import ParamSpec, map_tree
    return map_tree(lambda s: partition_spec(s.shape, s.logical, mesh, ruleset), spec_tree,
                    is_leaf=lambda x: isinstance(x, ParamSpec))


_CACHE_LOGICAL = {
    "k": ("layers", "batch", "kv_seq", "kv_heads", None),
    "v": ("layers", "batch", "kv_seq", "kv_heads", None),
    "slot_pos": ("layers", "batch", "kv_seq"),
    "kp": ("layers", None, None, "kv_heads", None),
    "vp": ("layers", None, None, "kv_heads", None),
    "ck": ("layers", "batch", None, "kv_heads", None),
    "cv": ("layers", "batch", None, "kv_heads", None),
    "state": ("layers", "batch", "ssm_heads", None, None),
    "conv": ("layers", "batch", "conv_dim", None),
}


def cache_partition_specs(cache_shapes, mesh, ruleset: RuleSet):
    """Map a cache tree (tensors, ``meta`` tensors or anything with a
    ``shape``) to PartitionSpecs by leaf name."""
    def walk(node):
        if isinstance(node, dict):
            out = {}
            for key, val in node.items():
                if key in _CACHE_LOGICAL and hasattr(val, "shape"):
                    out[key] = partition_spec(tuple(val.shape), _CACHE_LOGICAL[key], mesh,
                                              ruleset)
                else:
                    out[key] = walk(val)
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        if hasattr(node, "shape"):   # unnamed leaf
            return PartitionSpec()
        return node
    return walk(cache_shapes)
