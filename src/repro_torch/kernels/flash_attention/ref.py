"""Plain PyTorch attention: the masked-softmax oracle of
``repro.kernels.flash_attention.ref.mha_reference``.

  q: (B, Sq, H, D)    k, v: (B, Skv, Hkv, D)   with H % Hkv == 0 (GQA)

``q_offset`` is the absolute position of q[0] relative to k[0] (q is a
suffix of the kv stream); ``lengths`` (B,) masks kv positions >= length.
"""
from __future__ import annotations

import torch


def mha_reference(q, k, v, *, causal: bool = True, window: int = 0, softcap: float = 0.0,
                  q_offset: int = 0, lengths=None, scale: float | None = None):
    """Returns (B, Sq, H, D) in q's dtype, computed in fp32. A query row
    with no visible key gives zeros."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    if scale is None:
        scale = D ** -0.5
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    qi = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kj = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window > 0:
        mask &= kj > qi - window
    mask = mask[None, None]                                   # (1, 1, Sq, Skv)
    if lengths is not None:
        mask = mask & (kj[None] < lengths.to(q.device)[:, None, None])[:, None]
    s = torch.where(mask, s, torch.full_like(s, float("-inf")))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    denom = p.sum(dim=-1, keepdim=True)
    p = torch.where(denom > 0, p / denom.clamp_min(1e-30), torch.zeros_like(p))
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)
