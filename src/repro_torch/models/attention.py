"""GQA attention sublayer: train / prefill / chunk (paged serving) / decode
(dense ring-buffer cache or paged cache). One code path per mode, shared
projections, as in the reference.

Cache formats (per layer, one repeat of the stacked cache):
  dense: {"k": (B, W, Hkv, hd), "v": ..., "slot_pos": (B, W) int32}
         W = min(max_seq, window) — a ring buffer; slot_pos holds the
         absolute position stored in each slot (-1 = empty). Full attention
         is W = max_seq (slot == position) through the same code.
  paged: {"kp": (P, ps, Hkv, hd), "vp": ...} plus the caller's page_table /
         lengths.

Mode "train" / "prefill" runs flash attention over the whole sequence
(prefill also writes the ring cache). Mode "decode" takes one new token per
row, writes its KV into the ring or the pool and attends over it: plain
einsum over the ring (as the reference, outside any kernel), the paged
decode kernel over the pool. Mode "chunk" is the serving engine's unified
iteration: each batch row carries a chunk of S tokens of one sequence
(S == 1 is decode); the chunk's KV is written straight into the paged pool
and its queries attend causally over the pool, which then holds the chunk
itself.

Every cache write is in place (``index_put_`` on the cache's tensors, which
are views of the stacked per-group cache), where the JAX version returns a
new cache: the caller owns the only reference to it. Cross attention and
the bidirectional encoder come with the enc-dec slice.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import chunked_prefill_attention, paged_attention
from repro_torch.models.common import RunCtx, dequant, linear, rope


def _project_qkv(p, h, cfg: ModelConfig):
    q = linear(h, p["wq"])
    k = linear(h, p["wk"])
    v = linear(h, p["wv"])
    if "bq" in p:
        q = q + dequant(p["bq"], h.dtype)[None, None]
        k = k + dequant(p["bk"], h.dtype)[None, None]
        v = v + dequant(p["bv"], h.dtype)[None, None]
    return q, k, v


def _out_proj(p, o):
    return linear(o, p["wo"], n_in=2)


def _decode_dense_attn(q, cache, positions, *, window: int, softcap: float, scale: float):
    """q: (B,1,H,hd); ring-buffer cache. Plain einsum in fp32 (one query
    token needs no tiling), as the reference computes it."""
    k, v, slot_pos = cache["k"], cache["v"], cache["slot_pos"]
    B, W, Hkv, hd = k.shape
    H = q.shape[2]
    q5 = q.reshape(B, 1, Hkv, H // Hkv, hd)
    s = torch.einsum("bqngd,bsnd->bnqgs", q5.float(), k.float()) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    pos = positions[:, None]                       # (B,1) current absolute position
    ok = (slot_pos >= 0) & (slot_pos <= pos)
    if window > 0:
        ok &= slot_pos > pos - window
    s = torch.where(ok[:, None, None, None, :], s, torch.full_like(s, -1e30))
    p_attn = torch.softmax(s, dim=-1)
    o = torch.einsum("bnqgs,bsnd->bqngd", p_attn, v.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)


def _write_ring(cache, k, v, positions):
    """Write new kv at positions into the ring buffer, in place. decode: k
    (B,1,Hkv,hd), positions (B,). prefill: k (B,S,...), positions (S,)
    shared across the batch; with S > W the last W tokens are kept."""
    W = cache["k"].shape[1]
    dt = cache["k"].dtype
    if k.shape[1] == 1 and positions.dim() == 1 and positions.shape[0] == k.shape[0]:
        slots = positions.long() % W               # (B,)
        b_idx = torch.arange(k.shape[0], device=k.device)
        cache["k"][b_idx, slots] = k[:, 0].to(dt)
        cache["v"][b_idx, slots] = v[:, 0].to(dt)
        cache["slot_pos"][b_idx, slots] = positions.to(torch.int32)
    else:                                          # prefill: positions (S,)
        if k.shape[1] > W:                         # keep the last W tokens
            k, v, positions = k[:, -W:], v[:, -W:], positions[-W:]
        slots = positions.long() % W
        cache["k"][:, slots] = k.to(dt)
        cache["v"][:, slots] = v.to(dt)
        cache["slot_pos"][:, slots] = positions.to(torch.int32)[None, :]


def _write_paged_chunk(cache, k, v, positions, page_table, valid):
    """Scatter a whole chunk's KV into the paged pool in one shot.

    k/v (B, S, Hkv, hd); positions (B, S) absolute; valid (B, S). Invalid
    positions are routed to the reserved null page 0 (the allocator never
    hands it out), so one fixed-shape scatter serves ragged chunks."""
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
    cache: Optional[Dict[str, Any]] = None,
    positions=None,          # decode: (B,) abs position of the new token;
                             # train / prefill: (S,); chunk: (B, S) absolute
    page_table=None,
    lengths=None,
    valid=None,              # chunk: (B, S) live positions of each row's chunk
):
    """Returns attn_out (B,S,d); the cache, if any, is updated in place."""
    window = cfg.sliding_window if kind == "L" else 0
    softcap = cfg.attn_softcap
    scale = cfg.head_dim ** -0.5
    q, k, v = _project_qkv(p, h, cfg)

    if ctx.mode == "chunk":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        _write_paged_chunk(cache, k, v, positions, page_table, valid)
        o = chunked_prefill_attention(
            q, cache["kp"], cache["vp"], page_table, lengths, positions,
            scale=scale, softcap=softcap, window=window,
        )
        return _out_proj(p, o)

    if ctx.mode == "decode":
        q = rope(q, positions[:, None], cfg.rope_theta)   # (B,1,...)
        k = rope(k, positions[:, None], cfg.rope_theta)
        if "kp" in cache:                                 # paged: a chunk of one
            pos = positions[:, None]
            _write_paged_chunk(cache, k, v, pos, page_table,
                               torch.ones_like(pos, dtype=torch.bool))
            o = paged_attention(
                q[:, 0], cache["kp"], cache["vp"], page_table, lengths,
                scale=scale, softcap=softcap, window=window,
            )[:, None]                                    # (B,1,H,hd)
        else:                                             # dense ring cache
            _write_ring(cache, k, v, positions)
            o = _decode_dense_attn(q, cache, positions, window=window,
                                   softcap=softcap, scale=scale)
        return _out_proj(p, o)

    # ---------------- train / prefill ----------------
    if positions is None:
        positions = torch.arange(h.shape[1], device=h.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = flash_attention(q, k, v, causal=True, window=window, softcap=softcap, scale=scale)
    if cache is not None and "k" in cache:                # prefill: persist kv
        _write_ring(cache, k, v, positions)
    return _out_proj(p, o)
