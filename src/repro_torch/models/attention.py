"""GQA attention sublayer: train / prefill / chunk (paged serving) / decode
(dense ring-buffer cache or paged cache) / cross attention / the
bidirectional encoder. One code path per mode, shared projections, as in
the reference.

Cache formats (per layer, one repeat of the stacked cache):
  dense: {"k": (B, W, Hkv, hd), "v": ..., "slot_pos": (B, W) int32}
         W = min(max_seq, window) — a ring buffer; slot_pos holds the
         absolute position stored in each slot (-1 = empty). Full attention
         is W = max_seq (slot == position) through the same code.
  paged: {"kp": (P, ps, Hkv, hd), "vp": ...} plus the caller's page_table /
         lengths.
  cross: {"ck": (B, M, Hkv, hd), "cv": ...} the encoder memory's keys and
         values, one row per batch row (dense) or engine slot (paged).

Mode "train" / "prefill" runs flash attention over the whole sequence
(prefill also writes the ring cache). Mode "decode" takes one new token per
row, writes its KV into the ring or the pool and attends over it: plain
einsum over the ring (as the reference, outside any kernel), the paged
decode kernel over the pool. Mode "chunk" is the serving engine's unified
iteration: each batch row carries a chunk of S tokens of one sequence
(S == 1 is decode); the chunk's KV is written straight into the paged pool
and its queries attend causally over the pool, which then holds the chunk
itself.

Kind "X" is cross attention over the encoder memory: its keys and values
are computed from ``memory`` where it is given and persisted in the cross
cache (at the rows' slots in chunk mode, on rows with a live token), and
read from the cache where it is not; the queries attend to every memory
position (flash attention, not causal). Kind "E" is an encoder layer: flash
attention over the whole frame sequence, not causal, in every mode.

Every cache write is in place (``index_put_`` on the cache's tensors, which
are views of the stacked per-group cache), where the JAX version returns a
new cache: the caller owns the only reference to it.

Under a mesh (``layout`` given) a rank projects its own query heads
(``heads`` on the tensor axis), runs the kernels on them, and ``wo`` is
row-split with a psum over the axis. Its cache holds the shards
``cache_partition_specs`` gives; of the dense ring its rows and, where the
rules split the ring's sequence (``kv_seq``), its slots: a decode step then
combines the softmax over the slots' ranks (a max, then two sums). The pool
is whole on every rank of a batch split, so each rank writes every row's
keys there. The kv heads take the tensor axis where it divides them; where
it does not (the reference's ``kv_seq`` fallback: qwen2.5's 2 kv heads at
tensor 4, mixtral's 8 at 16) ``wk`` / ``wv`` are whole, each rank projects
every kv head and its query heads read the one (or ones) of their group
(``_Heads``): a contiguous slice of the fresh K / V for flash attention,
the whole pool through the kernels' ``q_head0`` / ``group`` (every rank
writes every kv head of the pool, the same values), and the ring, split on
the sequence over the tensor axis, through a regrouping: a decode step
all-gathers the step's queries over the axis, scores every head against
the rank's slots, combines over the axis and keeps the rank's heads.
Under grad (training: no cache) a kv_seq rank's ``wk`` / ``wv`` gradient
is the share of its query heads' slice, summed over the tensor axis by the
train step.

The encoder's kind "E" runs under a mesh as self-attention does, on the
encoder's own layout (its heads on the tensor axis, ``_Heads``' slice of
a whole K / V under kv_seq). Kind "X" projects the rank's query heads from
its rows and the kv heads of its ``ck`` / ``cv`` shard from the memory of
those rows (every kv head where kv_seq keeps them whole; its query heads
read theirs through ``_Heads``), writes them at its slots of the cross
cache, which holds the slots of its batch block, and ``wo`` is row-split
with a psum.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import chunked_prefill_attention, paged_attention
from repro_torch.distributed.collectives import all_gather, pmax, psum
from repro_torch.distributed.sharding import constrain, shard_start
from repro_torch.launch.mesh import spec_axes
from repro_torch.models.common import RunCtx, dequant, linear, rope, row_linear


def _project_qkv(p, h, cfg: ModelConfig):
    q = linear(h, p["wq"])
    k = linear(h, p["wk"])
    v = linear(h, p["wv"])
    if "bq" in p:
        q = q + dequant(p["bq"], h.dtype)[None, None]
        k = k + dequant(p["bk"], h.dtype)[None, None]
        v = v + dequant(p["bv"], h.dtype)[None, None]
    return q, k, v


def _out_proj(p, o, mesh=None, heads_ax=None):
    return row_linear(o, p["wo"], mesh, heads_ax, n_in=2)


@dataclass(frozen=True)
class _Heads:
    """This rank's query heads and the kv heads they read: its first query
    head ``h0`` of the config's, split on ``axis``; ``kv0``, the first kv
    head of the k / v / pool it holds (0 where they hold every kv head:
    the kv_seq layout); the config's GQA ``group``."""
    axis: Any
    h0: int
    kv0: int
    group: int

    @staticmethod
    def of(layout, cfg: ModelConfig, name: str = "attn") -> "_Heads":
        """Of the layer's sublayer ``name`` ("attn", or "cross" for X)."""
        wq, wk = layout.p[name]["wq"][2], layout.p[name]["wk"][2]
        return _Heads(wq, shard_start(cfg.n_heads, wq, layout.mesh),
                      shard_start(cfg.n_kv_heads, wk, layout.mesh),
                      cfg.n_heads // cfg.n_kv_heads)

    @property
    def q_head0(self) -> int:
        """The first query head's index against the held kv heads: the
        kernels' ``q_head0``."""
        return self.h0 - self.kv0 * self.group

    def kv(self, t, n: int):
        """The held kv heads (dim 2 of ``t``) that query heads [h0, h0 + n)
        read: a contiguous slice (a view)."""
        return t[:, :, self.h0 // self.group - self.kv0:
                 (self.h0 + n - 1) // self.group + 1 - self.kv0]


class _RingShard:
    """Where this rank's shard of a dense ring sits: the first slot of its
    k / v (``k0``, split on ``k_axes``) and of its slot_pos (``s0``, split on
    ``s_axes``) in the ring of ``W`` slots."""

    def __init__(self, cache, cspec, mesh):
        self.mesh = mesh
        self.k_axes, self.s_axes = cspec["k"][2], cspec["slot_pos"][2]
        Wk, Ws = cache["k"].shape[1], cache["slot_pos"].shape[1]
        self.Wk, self.Ws = Wk, Ws
        self.k0 = mesh.index(self.k_axes) * Wk if self.k_axes else 0
        self.s0 = mesh.index(self.s_axes) * Ws if self.s_axes else 0
        self.W = Wk * mesh.count(self.k_axes)

    def slot_pos(self, cache):
        """slot_pos of this rank's k / v slots (B, Wk)."""
        sp = cache["slot_pos"]
        if self.s_axes:
            sp = all_gather(sp, self.mesh, self.s_axes, dim=1)
        return sp[:, self.k0:self.k0 + self.Wk]


def _decode_dense_attn(q, cache, positions, *, window: int, softcap: float, scale: float,
                       ring: Optional[_RingShard] = None, heads: Optional[_Heads] = None):
    """q: (B,1,H,hd); ring-buffer cache. Plain einsum in fp32 (one query
    token needs no tiling), as the reference computes it. With the ring's
    slots split over ranks (``ring.k_axes``), each rank's softmax partials
    are combined over them. Where those ranks also split the query heads
    (``heads.axis``; the kv_seq layout) each scores every head: the step's
    queries are all-gathered over the heads' axis first, and the rank's
    heads kept after the combine."""
    k, v = cache["k"], cache["v"]
    slot_pos = cache["slot_pos"] if ring is None else ring.slot_pos(cache)
    Hq = q.shape[2]
    regroup = (ring is not None and heads is not None and heads.axis is not None
               and set(spec_axes(heads.axis)) <= set(spec_axes(ring.k_axes)))
    if regroup:
        own = heads.h0                             # the rank's heads, kept after the combine
        q = all_gather(q, ring.mesh, heads.axis, dim=2)
        heads = _Heads(None, 0, heads.kv0, heads.group)
    if heads is not None:
        k, v = heads.kv(k, q.shape[2]), heads.kv(v, q.shape[2])
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
    if ring is None or not ring.k_axes:
        p_attn = torch.softmax(s, dim=-1)
        o = torch.einsum("bnqgs,bsnd->bqngd", p_attn, v.float())
    else:
        mesh, axes = ring.mesh, ring.k_axes
        m = pmax(torch.amax(s, dim=-1, keepdim=True), mesh, axes)
        p_attn = torch.exp(s - m)
        den = psum(p_attn.sum(dim=-1), mesh, axes)                  # (B, Hkv, 1, G)
        o = psum(torch.einsum("bnqgs,bsnd->bqngd", p_attn, v.float()), mesh, axes)
        o = o / den.permute(0, 2, 1, 3)[..., None]
    o = o.reshape(B, 1, H, hd)
    if regroup:
        o = o[:, :, own:own + Hq]
    return o.to(q.dtype)


def _write_ring_shard(cache, k, v, positions, ring: _RingShard):
    """``_write_ring`` into this rank's slots of a ring split over ranks:
    each of k / v and slot_pos takes the writes that land in its slots."""
    W, dt = ring.W, cache["k"].dtype
    if k.shape[1] == 1 and positions.dim() == 1 and positions.shape[0] == k.shape[0]:
        # decode: rows whose slot is elsewhere write their own old values back
        b_idx = torch.arange(k.shape[0], device=k.device)
        slots = positions.long() % W
        for names, first, width, new in ((("k", "v"), ring.k0, ring.Wk, (k[:, 0], v[:, 0])),
                                         (("slot_pos",), ring.s0, ring.Ws,
                                          (positions.to(torch.int32),))):
            loc = slots - first
            mine = (loc >= 0) & (loc < width)
            loc = loc.clamp(0, width - 1)
            for name, val in zip(names, new):
                old = cache[name][b_idx, loc]
                m = mine.reshape(-1, *([1] * (old.dim() - 1)))
                cache[name][b_idx, loc] = torch.where(m, val.to(old.dtype), old)
        return
    if k.shape[1] > W:                             # prefill: keep the last W tokens
        k, v, positions = k[:, -W:], v[:, -W:], positions[-W:]
    slots = positions.long() % W
    for names, first, width in ((("k", "v"), ring.k0, ring.Wk), (("slot_pos",), ring.s0,
                                                                  ring.Ws)):
        loc = slots - first
        mine = (loc >= 0) & (loc < width)
        for name in names:
            if name == "slot_pos":
                cache[name][:, loc[mine]] = positions[mine].to(torch.int32)[None, :]
            else:
                cache[name][:, loc[mine]] = (k if name == "k" else v)[:, mine].to(dt)


def _write_ring(cache, k, v, positions, ring: Optional[_RingShard] = None):
    """Write new kv at positions into the ring buffer, in place. decode: k
    (B,1,Hkv,hd), positions (B,). prefill: k (B,S,...), positions (S,)
    shared across the batch; with S > W the last W tokens are kept."""
    if ring is not None:
        return _write_ring_shard(cache, k, v, positions, ring)
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


def _cross_attention(p, h, ctx: RunCtx, cfg: ModelConfig, cache, memory, chunk, layout=None):
    """Kind "X": queries from h, keys and values of the encoder memory
    (B, M, d). chunk mode: with ``memory`` (a pack with a first chunk) they
    are computed and written at the rows' slots where the row feeds a token
    (other rows keep their slot's values); without it they are gathered
    from the slots. decode: read from the cache. train / prefill: computed,
    and written into the cache when there is one. Under a mesh h and the
    memory are the rank's rows, the rank computes the kv heads of its
    ``ck`` / ``cv`` shard (every kv head where the kv_seq layout keeps
    them whole) and its query heads read theirs (``_Heads``); the cache
    holds the slots of its batch block."""
    mesh = heads = heads_ax = None
    slot0 = 0
    if layout is not None:
        mesh, heads = layout.mesh, _Heads.of(layout, cfg, "cross")
        heads_ax = heads.axis
        if cache is not None:
            batch = layout.c["cross"]["ck"][1]
            slot0 = shard_start(cache["ck"].shape[0] * mesh.count(batch), batch, mesh)
    q = linear(h, p["wq"])
    if ctx.mode == "chunk":
        slots = chunk["slots"].long() - slot0
        if memory is not None:
            ck, cv = linear(memory, p["wk"]), linear(memory, p["wv"])
            keep = chunk["nvalid"] > 0
            rows = slots[keep]
            cache["ck"].index_put_((rows,), ck[keep].to(cache["ck"].dtype))
            cache["cv"].index_put_((rows,), cv[keep].to(cache["cv"].dtype))
        else:
            ck, cv = cache["ck"][slots], cache["cv"][slots]
    elif cache is not None and ctx.mode == "decode":
        ck, cv = cache["ck"], cache["cv"]
    else:
        ck, cv = linear(memory, p["wk"]), linear(memory, p["wv"])
        if cache is not None:
            if cache["ck"].shape != ck.shape:
                raise ValueError(f"cross cache {tuple(cache['ck'].shape)} does not hold the "
                                 f"memory's keys {tuple(ck.shape)}: init_cache(memory_len=)")
            cache["ck"].copy_(ck)
            cache["cv"].copy_(cv)
    if heads is not None:
        ck, cv = heads.kv(ck, q.shape[2]), heads.kv(cv, q.shape[2])
    o = flash_attention(q, ck.to(q.dtype), cv.to(q.dtype), causal=False,
                        softcap=cfg.attn_softcap, scale=cfg.head_dim ** -0.5)
    return _out_proj(p, o, mesh, heads_ax)


def attention_sublayer(
    p: Dict[str, Any],
    h,                       # normed input (B, S, d)
    ctx: RunCtx,
    cfg: ModelConfig,
    kind: str,               # 'A' | 'L' | 'G' | 'X' (cross) | 'E' (encoder, bidirectional)
    cache: Optional[Dict[str, Any]] = None,
    positions=None,          # decode: (B,) abs position of the new token;
                             # train / prefill: (S,); chunk: (B, S) absolute
    page_table=None,
    lengths=None,
    valid=None,              # chunk: (B, S) live positions of each row's chunk
    memory=None,             # cross: encoder output (B, M, d)
    chunk=None,              # chunk mode: {"slots", "nvalid", ...} of the pack
    layout=None,             # under a mesh: the call's Layout at this layer
):
    """Returns attn_out (B,S,d); the cache, if any, is updated in place.
    Under a mesh h holds this rank's rows, and so do positions /
    page_table / lengths / valid (``layout.glob`` holds every row's)."""
    if kind == "X":
        return _cross_attention(p, h, ctx, cfg, cache, memory, chunk, layout)
    window = cfg.sliding_window if kind == "L" else 0
    softcap = cfg.attn_softcap
    scale = cfg.head_dim ** -0.5
    mesh = heads_ax = ring = heads = None
    fold = {}                                     # the kernels' q_head0 / group
    if layout is not None:
        mesh = layout.mesh
        heads = _Heads.of(layout, cfg)
        heads_ax = heads.axis
        fold = dict(q_head0=heads.q_head0, group=heads.group)
        if cache is not None and "k" in cache:
            ring = _RingShard(cache, layout.c["attn"], mesh)
            ring = ring if ring.k_axes or ring.s_axes else None   # slots whole: the plain ring
    q, k, v = _project_qkv(p, h, cfg)
    if layout is not None:                        # the reference's shard_act on q and k
        constrain(q, ("batch", None, "heads", None), (layout.B, q.shape[1], cfg.n_heads,
                                                      cfg.head_dim))
        constrain(k, ("batch", None, "kv_heads", None), (layout.B, k.shape[1], cfg.n_kv_heads,
                                                         cfg.head_dim))

    def pool_rows(k, v, positions, page_table, valid):
        """Every row's keys for a pool write: the pool is whole on each
        rank of a batch split."""
        if layout is None or layout.batch is None:
            return k, v, positions, page_table, valid
        g = layout.glob
        return (layout.gather_rows(k), layout.gather_rows(v), g["positions"], g["page_table"],
                g.get("valid"))

    if ctx.mode == "chunk" and kind != "E":       # the encoder runs full-sequence below
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        _write_paged_chunk(cache, *pool_rows(k, v, positions, page_table, valid))
        # a vision patch prefix makes a row's positions non-affine; the
        # pack then names each row's query positions as the kernel reads
        # them, affine from the row's first position (chunk["q_positions"])
        q_positions = positions if chunk is None else chunk.get("q_positions", positions)
        o = chunked_prefill_attention(
            q, cache["kp"], cache["vp"], page_table, lengths, q_positions,
            scale=scale, softcap=softcap, window=window, **fold,
        )
        return _out_proj(p, o, mesh, heads_ax)

    if ctx.mode == "decode":
        q = rope(q, positions[:, None], cfg.rope_theta)   # (B,1,...)
        k = rope(k, positions[:, None], cfg.rope_theta)
        if "kp" in cache:                                 # paged: a chunk of one
            kw, vw, pos, pt, _ = pool_rows(k, v, positions, page_table, None)
            pos = pos[:, None]
            _write_paged_chunk(cache, kw, vw, pos, pt, torch.ones_like(pos, dtype=torch.bool))
            o = paged_attention(
                q[:, 0], cache["kp"], cache["vp"], page_table, lengths,
                scale=scale, softcap=softcap, window=window, **fold,
            )[:, None]                                    # (B,1,H,hd)
        else:                                             # dense ring cache
            _write_ring(cache, k, v, positions, ring)
            o = _decode_dense_attn(q, cache, positions, window=window,
                                   softcap=softcap, scale=scale, ring=ring, heads=heads)
        return _out_proj(p, o, mesh, heads_ax)

    # ---------------- train / prefill / encoder ----------------
    if positions is None:
        positions = torch.arange(h.shape[1], device=h.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    kq, vq = (k, v) if heads is None else (heads.kv(k, q.shape[2]), heads.kv(v, q.shape[2]))
    o = flash_attention(q, kq, vq, causal=kind != "E", window=window, softcap=softcap,
                        scale=scale)
    if cache is not None and "k" in cache:                # prefill: persist kv
        _write_ring(cache, k, v, positions, ring)
    return _out_proj(p, o, mesh, heads_ax)
