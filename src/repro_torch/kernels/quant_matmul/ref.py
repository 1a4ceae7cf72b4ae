"""Plain PyTorch w8a16 matmul: x (M, K) fp32 / bf16 times int8 q (K, N),
fp32 math, the output in x's dtype.

``col_scale`` (N,) is the reference's per-output-channel scale
(``repro/kernels/quant_matmul/ref.py``); ``row_scale`` (K, G) is the int8
tree's scale over each leaf's last axis, G groups of N / G columns (G = 1
for a (K, N) projection, G = heads for wq / wk / wv flattened to
(d, H * hd)). Either may be absent.
"""
from __future__ import annotations

import torch


def dequantize_weight(w_q, row_scale=None):
    """(K, N) int8 -> fp32 with the row scale applied (none: q as fp32)."""
    w = w_q.float()
    if row_scale is None:
        return w
    K, N = w.shape
    G = row_scale.shape[1]
    return (w.reshape(K, G, N // G) * row_scale.float()[:, :, None]).reshape(K, N)


def w8a16_matmul_reference(x, w_q, col_scale=None, row_scale=None):
    out = torch.einsum("mk,kn->mn", x.float(), dequantize_weight(w_q, row_scale))
    if col_scale is not None:
        out = out * col_scale.float()[None, :]
    return out.to(x.dtype)
