"""Plain PyTorch grouped (ragged) expert matmul.

x:           (M, K)  rows sorted by expert id
w:           (E, K, N)
group_sizes: (E,)    sum == M
out[m] = x[m] @ w[expert_of(m)]

A loop over experts: the reference's dense (E, M, N) select does E times
the work.
"""
from __future__ import annotations

import torch


def expert_of_rows(group_sizes, M: int):
    """(M,) expert id per row from group sizes (rows sorted by expert)."""
    ends = torch.cumsum(group_sizes.long(), 0)
    return torch.searchsorted(ends, torch.arange(M, device=ends.device), right=True)


def gmm_reference(x, w, group_sizes):
    M, K = x.shape
    E, _, N = w.shape
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    off = 0
    for e, n in enumerate(group_sizes.tolist()):
        out[off:off + n] = (x[off:off + n].float() @ w[e].float()).to(x.dtype)
        off += n
    return out
