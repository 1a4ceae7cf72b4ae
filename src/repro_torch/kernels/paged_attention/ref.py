"""Plain PyTorch paged attention: the gather-based oracles of
``repro.kernels.paged_attention.ref`` — ``chunked_prefill_reference`` (a
chunk of query tokens per sequence), built from the softmax state over a
key range (``chunked_prefill_partials``) and the merge of such states
(``merge_partials``, the split path's two passes), and
``paged_attention_reference`` (decode: one query token per sequence, q
(B, H, D)).

  q:           (B, S, H, D)     a chunk of S query tokens per sequence
  k_pages:     (P, page_size, Hkv, D)   global physical page pool
  v_pages:     (P, page_size, Hkv, D)
  page_table:  (B, max_pages)   int32 physical page id per logical page
  lengths:     (B,)             total resident kv entries (incl. this chunk)
  q_positions: (B, S) int32     absolute position of each query token
"""
from __future__ import annotations

import torch


def chunked_prefill_partials(
    q, k_pages, v_pages, page_table, lengths, q_positions, *,
    scale=None, softcap: float = 0.0, window: int = 0, key_range=None,
):
    """The softmax state of each query over the kv positions in
    ``key_range`` = (lo, hi) (the whole pool row by default), with the
    masks of ``chunked_prefill_reference``: m (B, S, H), the largest
    visible score (-1e30 where none is visible); l (B, S, H), the sum of
    exp(score - m) over the visible keys; acc (B, S, H, D), the unnormalised
    P V. All fp32: the split kernel's first pass on one key range."""
    B, S, H, D = q.shape
    P, ps, Hkv, _ = k_pages.shape
    maxp = page_table.shape[1]
    group = H // Hkv
    if scale is None:
        scale = D ** -0.5

    pt = page_table.long()
    k = k_pages[pt].reshape(B, maxp * ps, Hkv, D).repeat_interleave(group, dim=2)
    v = v_pages[pt].reshape(B, maxp * ps, Hkv, D).repeat_interleave(group, dim=2)

    s = torch.einsum("bshd,bkhd->bhsk", q.float(), k.float()) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    kv_pos = torch.arange(maxp * ps, device=q.device)[None, None, :]   # (1, 1, K)
    q_pos = q_positions[:, :, None]                                     # (B, S, 1)
    mask = (kv_pos < lengths[:, None, None]) & (kv_pos <= q_pos)
    if window > 0:
        mask &= kv_pos > q_pos - window
    if key_range is not None:
        mask &= (kv_pos >= key_range[0]) & (kv_pos < key_range[1])
    mask = mask[:, None]                                                # (B, 1, S, K)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1)                                                  # (B, H, S)
    p = torch.where(mask, torch.exp(s - m[..., None]), torch.zeros_like(s))
    acc = torch.einsum("bhsk,bkhd->bshd", p, v.float())
    return m.transpose(1, 2), p.sum(dim=-1).transpose(1, 2), acc


def merge_partials(parts):
    """Outputs (B, S, H, D) fp32 from the partials of disjoint key ranges
    (``chunked_prefill_partials``), as the split path's merge kernel takes
    them: each range rescaled to the common max and summed in order; a
    query with no visible key gives zeros."""
    M = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    L, A = 0.0, 0.0
    for m, l, acc in parts:
        w = torch.exp(m - M)
        L = L + l * w
        A = A + acc * w[..., None]
    L = L[..., None]
    return torch.where(L > 0, A / L.clamp_min(1e-30), torch.zeros_like(A))


def chunked_prefill_reference(
    q, k_pages, v_pages, page_table, lengths, q_positions, *,
    scale=None, softcap: float = 0.0, window: int = 0,
):
    """Returns (B, S, H, D) in q's dtype. Query token i of row b attends
    causally to kv positions <= q_positions[b, i] (clipped to lengths[b]);
    a row with no visible key gives zeros."""
    part = chunked_prefill_partials(q, k_pages, v_pages, page_table, lengths, q_positions,
                                    scale=scale, softcap=softcap, window=window)
    return merge_partials([part]).to(q.dtype)


def paged_attention_reference(q, k_pages, v_pages, page_table, lengths, *,
                              scale=None, softcap: float = 0.0, window: int = 0):
    """Decode over the pool: q (B, H, D), one token per row, attends to
    the row's kv positions < lengths[b] and, with a window, >
    lengths[b] - 1 - window. Returns (B, H, D) in q's dtype; a row of
    length 0 gives zeros."""
    B, H, D = q.shape
    P, ps, Hkv, _ = k_pages.shape
    maxp = page_table.shape[1]
    group = H // Hkv
    if scale is None:
        scale = D ** -0.5

    pt = page_table.long()
    k = k_pages[pt].reshape(B, maxp * ps, Hkv, D).repeat_interleave(group, dim=2)
    v = v_pages[pt].reshape(B, maxp * ps, Hkv, D).repeat_interleave(group, dim=2)

    s = torch.einsum("bhd,bkhd->bhk", q.float(), k.float()) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(maxp * ps, device=q.device)[None, :]
    last = lengths.long()[:, None]
    mask = pos < last
    if window > 0:
        mask &= pos > (last - 1) - window
    mask = mask[:, None, :]                                             # (B, 1, K)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(mask, p, torch.zeros_like(p))
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhk,bkhd->bhd", p / denom, v.float())
    return out.to(q.dtype)
