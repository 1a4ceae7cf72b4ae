"""Roofline terms of one rank's step on an NVIDIA H100 SXM, from the
dry-run's walk of that rank's program (``launch.dryrun``): the counterpart
of ``repro.launch.roofline``, whose terms are a TPU's.

  compute term    = FLOPs of the rank's step / the bf16 dense peak
  memory term     = bytes the rank's ops read and write / HBM bandwidth
  collective term = bytes of the rank's collective results / NVLink, each way

What each term counts in the port:

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the aten ops the
  step runs (matmuls, batched matmuls, convolutions), at the rank's local
  shapes. These are the plain versions' ops, masked attention tiles
  included: the kernels' own work is not what is counted.
- bytes: each op's inputs read once and outputs written once, views and
  other aliasing ops counting nothing: the unfused upper bound, as XLA's
  "bytes accessed" is one. ``memory_floor_s`` in the dry-run's JSON is the
  lower bound: the rank's weights and cache read once.
- collective bytes: the size of the rank's result buffer of every
  collective (``distributed.collectives.record_collectives``), summed by
  kind as ``parse_collective_bytes`` sums the reference's optimised HLO.

The peaks are NVIDIA's data sheet figures for the H100 SXM at its 700 W
power limit (dense, no sparsity), not measured: a card set to a lower limit
reaches less. No figure here is a TPU's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Tuple

import numpy as np

H100_SXM = {
    "name": "NVIDIA H100 SXM (data sheet, 700 W)",
    "peak_flops_bf16": 989e12,      # dense tensor core, per card
    "peak_flops_fp32": 67e12,       # non-tensor fp32
    "hbm_bw": 3.35e12,              # bytes/s HBM3
    "nvlink_bw": 450e9,             # bytes/s each way (900 GB/s both ways)
    "hbm_capacity": 80e9,
}

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                    "collective-permute")


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> Dict[str, float]:
        return {"compute_s": self.compute_s, "memory_s": self.memory_s,
                "collective_s": self.collective_s, "dominant": self.dominant}


def roofline(flops_per_dev: float, bytes_per_dev: float, coll_bytes_per_dev: float,
             hw=H100_SXM) -> RooflineTerms:
    return RooflineTerms(
        compute_s=flops_per_dev / hw["peak_flops_bf16"],
        memory_s=bytes_per_dev / hw["hbm_bw"],
        collective_s=coll_bytes_per_dev / hw["nvlink_bw"],
    )


def _leaves_with_specs(tree, spec_tree):
    """(leaf, PartitionSpec) pairs: ``distributed.sharding``'s pairing, a
    ``QuantizedLinear`` leaf taking a ``QuantizedLinear`` of specs or a
    float spec by ``int8_spec``."""
    from repro_torch.distributed.sharding import _paired_specs
    from repro_torch.models.params import tree_leaves
    return zip(tree_leaves(tree), _paired_specs(tree, spec_tree))


def local_bytes(tree, spec_tree, mesh) -> int:
    """Per-rank bytes of a sharded tree of tensors (``meta`` ones too) or
    anything with ``shape`` and ``dtype``: each leaf's size over the product
    of the mesh axes its spec assigns, as ``repro.launch.roofline``. The
    mesh needs only ``axis_names`` and ``devices.shape``."""
    import torch
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    total = 0
    for v, spec in _leaves_with_specs(tree, spec_tree):
        n = int(np.prod(tuple(v.shape))) if len(v.shape) else 1
        denom = 1
        for entry in tuple(spec):
            if entry is None:
                continue
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                denom *= sizes.get(a, 1)
        itemsize = (v.dtype.itemsize if isinstance(v.dtype, torch.dtype)
                    else np.dtype(v.dtype).itemsize)
        total += (n // max(denom, 1)) * itemsize
    return total


def model_flops(cfg, shape) -> float:
    """Useful-FLOPs yardstick: 6·N·D for training (fwd+bwd), 2·N·D for
    serving, with N = active params for MoE. D = tokens processed."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch             # decode: one token per sequence


def collective_bytes(log: Iterable[Tuple[str, int, str]]) -> Dict[str, int]:
    """Per-rank bytes of each collective kind from ``record_collectives``'
    entries, with ``count`` and ``total``: ``parse_collective_bytes``'s
    keys."""
    out: Dict[str, int] = {k: 0 for k in COLLECTIVE_KINDS}
    out["count"] = 0
    for kind, nbytes, _axis in log:
        out[kind] += int(nbytes)
        out["count"] += 1
    out["total"] = sum(out[k] for k in COLLECTIVE_KINDS)
    return out
