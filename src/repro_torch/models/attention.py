"""GQA attention sublayer in chunk mode (the serving engine's unified
iteration): each batch row carries a chunk of S tokens of one sequence
(S == 1 is decode); the chunk's KV is written straight into the paged pool
and its queries attend causally over the pool, which then holds the chunk
itself.

Cache format (per layer): {"kp": (P, ps, Hkv, hd), "vp": ...} plus the
engine's page_table / lengths. The train, prefill, dense-decode and cross
attention modes of the reference come with later slices.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.paged_attention import chunked_prefill_attention
from repro_torch.models.common import RunCtx, rope


def _project_qkv(p, h, cfg: ModelConfig):
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    k = torch.einsum("bsd,dnk->bsnk", h, p["wk"])
    v = torch.einsum("bsd,dnk->bsnk", h, p["wv"])
    if "bq" in p:
        q = q + p["bq"][None, None]
        k = k + p["bk"][None, None]
        v = v + p["bv"][None, None]
    return q, k, v


def _out_proj(p, o):
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


def _write_paged_chunk(cache, k, v, positions, page_table, valid):
    """Scatter a whole chunk's KV into the paged pool in one shot.

    k/v (B, S, Hkv, hd); positions (B, S) absolute; valid (B, S). Invalid
    positions are routed to the reserved null page 0 (the allocator never
    hands it out), so one fixed-shape scatter serves ragged chunks. The
    write is an in-place ``index_put_`` on the pool, where the JAX version
    returns a new pool: the engine owns the only reference to it."""
    ps = cache["kp"].shape[1]
    B, S = positions.shape
    maxp = page_table.shape[1]
    logical = torch.clamp(positions // ps, 0, maxp - 1)
    phys = torch.where(valid, torch.gather(page_table.long(), 1, logical.long()), 0)
    slot = positions % ps
    pf, sf = phys.reshape(-1), slot.reshape(-1).long()
    kf = k.reshape(B * S, *k.shape[2:]).to(cache["kp"].dtype)
    vf = v.reshape(B * S, *v.shape[2:]).to(cache["vp"].dtype)
    cache["kp"].index_put_((pf, sf), kf)
    cache["vp"].index_put_((pf, sf), vf)


def attention_sublayer(
    p: Dict[str, Any],
    h,                       # normed input (B, S, d)
    ctx: RunCtx,
    cfg: ModelConfig,
    kind: str,               # 'A' | 'L' | 'G'
    cache: Dict[str, Any],
    positions,               # (B, S) absolute
    page_table,
    lengths,
    valid,                   # (B, S) live positions of each row's chunk
):
    """Returns attn_out (B,S,d); the cache's pools are updated in place."""
    window = cfg.sliding_window if kind == "L" else 0
    scale = cfg.head_dim ** -0.5
    q, k, v = _project_qkv(p, h, cfg)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    _write_paged_chunk(cache, k, v, positions, page_table, valid)
    o = chunked_prefill_attention(
        q, cache["kp"], cache["vp"], page_table, lengths, positions,
        scale=scale, softcap=cfg.attn_softcap, window=window,
    )
    return _out_proj(p, o)
