"""Plain PyTorch grouped (ragged) expert matmul.

x:           (M, K)  rows sorted by expert id
w:           (E, K, N), or a QuantizedLinear of the int8 tree: q (E, K, N)
             int8 with its scale (E, K, 1) per expert and input row
group_sizes: (E,)    sum == M
out[m] = x[m] @ w[expert_of(m)]

A loop over experts: the reference's dense (E, M, N) select does E times
the work.
"""
from __future__ import annotations

import torch

from repro_torch.quant.quantize import QuantizedLinear


def expert_of_rows(group_sizes, M: int):
    """(M,) expert id per row from group sizes (rows sorted by expert)."""
    ends = torch.cumsum(group_sizes.long(), 0)
    return torch.searchsorted(ends, torch.arange(M, device=ends.device), right=True)


def gmm_reference(x, w, group_sizes, sizes=None):
    """``sizes``: the group sizes as Python ints where the caller knows them
    (read from ``group_sizes`` otherwise, which a ``meta`` tensor cannot
    give)."""
    M, K = x.shape
    quant = isinstance(w, QuantizedLinear)
    N = (w.q if quant else w).shape[2]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    off = 0
    for e, n in enumerate(group_sizes.tolist() if sizes is None else sizes):
        if n:
            we = w.q[e].float() * w.scale[e] if quant else w[e].float()
            out[off:off + n] = (x[off:off + n].float() @ we).to(x.dtype)
        off += n
    return out
