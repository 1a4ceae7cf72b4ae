"""Grouped matmul op, dispatched on the tensors' device: the CUDA kernel for
CUDA tensors, the plain version for CPU tensors (no fallback between them).

``gmm(x, w, group_sizes)`` computes ``out[m] = x[m] @ w[expert_of(m)]`` for
rows sorted by expert; ``w`` is an (E, K, N) tensor or a ``QuantizedLinear``
of the int8 tree (q (E, K, N) int8, scale (E, K, 1) per expert and input
row). The kernel reads the rows from a tile-aligned padded buffer (each
expert starts on a ``block_m`` boundary; static worst case Mp =
(ceil(M / block_m) + E) * block_m), whose row tile the kernel's plan sets
from M: 16 rows for M <= 16 (decode), else 64. ``GroupedRows`` builds that
layout once, so a caller with several matmuls over the same rows (the MoE
layer's three) scatters into it once and gathers out of it once.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.moe_gmm.kernel import block_m_for, gmm_tiles_cuda
from repro_torch.kernels.moe_gmm.ref import expert_of_rows, gmm_reference
from repro_torch.quant.quantize import QuantizedLinear


def tile_layout(group_sizes, M: int, block_m: int):
    """Returns (dst (M,) row of each sorted row in the padded buffer,
    tile_expert (T,) int32, tile_rows (T,) int32 real rows per tile, Mp).
    Tiles past the last expert's are padding: their expert is clamped to
    E-1, as in the reference, and they hold 0 real rows."""
    E = group_sizes.shape[0]
    dev = group_sizes.device
    gs = group_sizes.long()
    padded = (gs + block_m - 1) // block_m * block_m
    Mp = ((M + block_m - 1) // block_m + E) * block_m
    pad_ends = torch.cumsum(padded, 0)
    pad_starts = pad_ends - padded
    grp_starts = torch.cumsum(gs, 0) - gs
    eid = expert_of_rows(gs, M)
    dst = pad_starts[eid] + torch.arange(M, device=dev) - grp_starts[eid]
    t = torch.arange(Mp // block_m, device=dev)
    tile_expert = torch.searchsorted(pad_ends // block_m, t, right=True).clamp_max(E - 1)
    tile_rows = (gs[tile_expert] - (t - pad_starts[tile_expert] // block_m) * block_m)
    tile_rows = tile_rows.clamp(0, block_m)
    return dst, tile_expert.to(torch.int32), tile_rows.to(torch.int32), Mp


class GroupedRows:
    """M rows sorted by expert (``group_sizes`` (E,)), laid out for the
    grouped matmul of ``x``'s device. On a CUDA tensor ``pack`` scatters the
    rows into the kernel's tile-aligned buffer and ``unpack`` gathers them
    back; the buffer's padding rows are never read or written by the
    kernel, so it is not zeroed. On a CPU tensor the rows stay as they are
    and ``matmul`` is the plain version."""

    def __init__(self, group_sizes, x):
        self.group_sizes = group_sizes
        self.cuda = x.device.type != "cpu"
        if self.cuda:
            self.M = x.shape[0]
            self.block_m = block_m_for(self.M)
            self.dst, self.tile_expert, self.tile_rows, self.Mp = tile_layout(
                group_sizes, self.M, self.block_m)

    def pack(self, x):
        if not self.cuda:
            return x
        buf = x.new_empty((self.Mp, x.shape[1]))
        buf[self.dst] = x
        return buf

    def matmul(self, xb, w):
        if not self.cuda:
            return gmm_reference(xb, w, self.group_sizes)
        tiles = (self.tile_expert, self.tile_rows, self.block_m)
        if isinstance(w, QuantizedLinear):
            return gmm_tiles_cuda(xb, w.q, *tiles, w_scale=w.scale.reshape(w.q.shape[:2]),
                                  rows=self.M)
        return gmm_tiles_cuda(xb, w, *tiles, rows=self.M)

    def unpack(self, yb):
        return yb[self.dst] if self.cuda else yb


def gmm(x, w, group_sizes):
    rows = GroupedRows(group_sizes, x)
    return rows.unpack(rows.matmul(rows.pack(x), w))
