"""Meshes: named axes over ranks, as ``repro.launch.mesh`` builds them over
TPU chips. Functions, not module constants.

Single pod : (16, 16)    axes ("data", "model")          = 256 ranks
Multi-pod  : (2, 16, 16) axes ("pod", "data", "model")   = 512 ranks
Exp4       : (chips // (ep tp), ep, tp) axes ("data", "expert", "tensor")

A ``Mesh`` is axis names and sizes alone: its ``devices`` array holds the
rank of each coordinate (row-major), so specs for the 256- and 512-rank
meshes are computed anywhere. ``Mesh.bind`` ties it to the running
``torch.distributed`` process group: the rank's coordinates and one
subgroup per axis, over which ``distributed.collectives`` runs. Nothing
here names a backend: the subgroups take the default group's (gloo with
CPU or CUDA tensors, NCCL on a machine of several cards).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


class Mesh:
    """Named axes over ranks. ``shape`` maps each axis name to its size, in
    order, as ``jax.sharding.Mesh.shape``; ``devices[coords]`` is the rank
    at those coordinates. A bound mesh (``bind``) also knows its own rank's
    coordinates and holds a process group per axis."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axis names {axis_names}")
        self.axis_names = axis_names
        self.devices = np.arange(int(np.prod(shape))).reshape(shape)
        self.rank: Optional[int] = None            # set by bind
        self.coords: Dict[str, int] = {}
        self.ranks = list(range(self.size))        # the global rank at each position
        self._groups: Dict[str, object] = {}

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        sizes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({sizes}{'' if self.rank is None else f'; rank {self.rank}'})"

    # ------------------------------------------------------------ bound
    @property
    def bound(self) -> bool:
        return self.rank is not None

    def bind(self, ranks: Optional[Sequence[int]] = None) -> "Mesh":
        """Tie the mesh to the running process group: mesh position i is
        global rank ``ranks[i]`` (default: every rank, in order; the mesh's
        size must equal their count). Creates one subgroup per axis and per
        line of the mesh along it, in the same order on every rank (each
        rank of the default group must call ``bind`` with the same
        arguments, members or not), and keeps the ones its rank lies on.
        Returns a new bound mesh; ``self`` stays shape-only. A rank outside
        ``ranks`` gets a mesh whose ``rank`` is -1 and holds no group."""
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("Mesh.bind: init_process_group first")
        ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
        if len(ranks) != self.size or ranks != sorted(set(ranks)):
            raise ValueError(f"{self!r} needs {self.size} increasing ranks, got {ranks}")
        out = Mesh(self.devices.shape, self.axis_names)
        out.ranks = ranks
        me = dist.get_rank()
        out.rank = ranks.index(me) if me in ranks else -1
        if out.rank >= 0:
            at = np.unravel_index(out.rank, self.devices.shape)
            out.coords = {a: int(i) for a, i in zip(self.axis_names, at)}
        for ax, name in enumerate(self.axis_names):
            lines = np.moveaxis(self.devices, ax, -1).reshape(-1, self.devices.shape[ax])
            for line in lines:
                members = [ranks[int(i)] for i in line]   # increasing: group rank == coordinate
                group = dist.new_group(members)
                if out.rank >= 0 and out.rank in line:
                    out._groups[name] = group
        return out

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        if not self.bound:
            raise RuntimeError(f"{self!r} is not bound to a process group: Mesh.bind()")
        return self._groups[axis]

    def index(self, axes) -> int:
        """This rank's index along ``axes`` (one name or a tuple, row-major
        over the tuple, as a PartitionSpec entry of several axes splits)."""
        idx = 0
        for a in spec_axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def count(self, axes) -> int:
        """The number of shards ``axes`` (None, a name or a tuple) make."""
        return int(np.prod([self.shape[a] for a in spec_axes(axes)], dtype=np.int64))

    def axis_ranks(self, axis: str) -> Tuple[int, ...]:
        """The global ranks along ``axis`` through this rank, in order (the
        members of ``group(axis)``)."""
        at = [self.coords[a] for a in self.axis_names]
        ax = self.axis_names.index(axis)
        return tuple(self.ranks[int(self.devices[tuple(at[:ax] + [i] + at[ax + 1:])])]
                     for i in range(self.shape[axis]))


def spec_axes(axes) -> Tuple[str, ...]:
    """The mesh axes of a PartitionSpec entry: None, a name or a tuple."""
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_moe_mesh(ep: int, tp: int, *, chips: int = 256) -> Mesh:
    """Factored Exp4 mesh: ("data", "expert", "tensor"). ep * tp must
    divide chips; the rest is data parallelism."""
    if chips % (ep * tp):
        raise ValueError(f"ep {ep} x tp {tp} does not divide {chips} chips")
    return Mesh((chips // (ep * tp), ep, tp), ("data", "expert", "tensor"))


def make_dev_mesh(data: int = 1, model: int = 1) -> Mesh:
    """Small mesh for CPU tests."""
    return Mesh((data, model), ("data", "model"))
