"""Plain PyTorch attention: the masked-softmax oracle of
``repro.kernels.flash_attention.ref.mha_reference``, the row logsumexp the
forward kernel writes for training (``mha_reference_lse``), and the
backward kernel's plain version (``mha_reference_bwd``).

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
    H, D = q.shape[2], q.shape[3]
    if scale is None:
        scale = D ** -0.5
    s, _ = _scores(q, k, causal=causal, window=window, softcap=softcap, q_offset=q_offset,
                   scale=scale)
    if lengths is not None:
        kj = torch.arange(k.shape[1], device=q.device)
        live = kj[None] < lengths.to(q.device)[:, None]                   # (B, Skv)
        s = torch.where(live[:, None, None], s, torch.full_like(s, float("-inf")))
    vf = v.float().repeat_interleave(H // k.shape[2], dim=2)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    denom = p.sum(dim=-1, keepdim=True)
    p = torch.where(denom > 0, p / denom.clamp_min(1e-30), torch.zeros_like(p))
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def _scores(q, k, *, causal, window, softcap, q_offset, scale):
    """fp32 scaled (softcapped) scores (B, H, Sq, Skv) over K repeated to
    the query heads, -inf where masked, and tanh(s / softcap) (None
    without a softcap)."""
    Sq, H = q.shape[1], q.shape[2]
    Skv, Hkv = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    t = None
    if softcap > 0.0:
        t = torch.tanh(s / softcap)
        s = softcap * t
    qi = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kj = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window > 0:
        mask &= kj > qi - window
    return torch.where(mask, s, torch.full_like(s, float("-inf"))), t


def mha_reference_lse(q, k, *, causal: bool = True, window: int = 0, softcap: float = 0.0,
                      q_offset: int = 0, scale: float | None = None):
    """(B, H, Sq) fp32: each query row's logsumexp of its scaled,
    softcapped visible scores (what the forward kernel writes with
    ``lse=True``); -inf for a row with no visible key."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s, _ = _scores(q, k, causal=causal, window=window, softcap=softcap, q_offset=q_offset,
                   scale=scale)
    return torch.logsumexp(s, dim=-1)


def mha_reference_bwd(q, k, v, out, dout, lse, *, causal: bool = True, window: int = 0,
                      softcap: float = 0.0, q_offset: int = 0, scale: float | None = None):
    """The gradients (dq, dk, dv) of ``mha_reference`` at (q, k, v), given
    its output ``out``, the output's gradient ``dout`` and the row
    logsumexp ``lse`` (B, H, Sq): the backward kernel's formulas in fp32,
    P = exp(S - lse), dV = P^T dO, dS = P (dO V^T - rowsum(dO o O)) (times
    1 - tanh^2 under a softcap), dQ = dS K scale, dK = dS^T Q scale, with dk
    and dv summed over each kv head's group. A row with no visible key
    (lse = -inf) gets zero gradients. Each in its input's dtype."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    if scale is None:
        scale = D ** -0.5
    s, t = _scores(q, k, causal=causal, window=window, softcap=softcap, q_offset=q_offset,
                   scale=scale)
    lse = lse.float()[..., None]
    live = torch.isfinite(s) & torch.isfinite(lse)
    p = torch.where(live, torch.exp(s - torch.where(torch.isfinite(lse), lse, 0.0)), 0.0)
    g = dout.float()
    vf = v.float().repeat_interleave(G, dim=2)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, g)
    dp = torch.einsum("bqhd,bkhd->bhqk", g, vf)
    delta = (g * out.float()).sum(-1).transpose(1, 2)[..., None]      # (B, H, Sq, 1)
    ds = p * (dp - delta)
    if t is not None:
        ds = ds * (1.0 - t * t)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float().repeat_interleave(G, dim=2)) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale

    def group_sum(x):
        return x.reshape(B, Skv, Hkv, G, D).sum(3)
    return dq.to(q.dtype), group_sum(dk).to(k.dtype), group_sum(dv).to(v.dtype)
