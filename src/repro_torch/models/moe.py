"""Mixture-of-Experts layer, the reference's four strategies
(``RunCtx.moe_strategy``), sharing the router:

  "dropless"  the serving engine's path: exact token-choice routing, rows
              sorted by expert, three grouped matmuls (the hand-written CUDA
              kernel on the card, on int8 experts too), weighted
              scatter-add combine.
  "capacity"  the training path: a capacity buffer of ``cap`` rows an
              expert, filled by scatter in token-major order (assignments
              past an expert's capacity are dropped into a trash row), the
              three expert products as dense batched matmuls (outside any
              kernel, as in the reference), and a weighted gather combine.
  "tp_shardmap"  the paper's baseline "original TP" under a mesh: experts
              replicated, the expert FFN split on ``tp_axis``, capacity
              buffers as "capacity", down-projection partials psum'd over
              tp. No all-to-all.
  "ep_shardmap"  the paper's hybrid TP x EP under a mesh: experts split
              on ``ep_axis``; each (token, choice) row is sent by
              all-to-all to the rank owning its expert (``cap_s`` rows a
              destination), run there through that rank's experts
              (capacity buffers of ``cap2`` rows, the FFN split on
              tp), and returned by a second all-to-all; with
              ``quant="a2a_int8"`` both carry int8 rows and a scale each.

The two shard_map strategies are the reference's ``shard_map`` bodies run
by each rank on its own shards over ``torch.distributed``; without a mesh
they run "capacity", as in the reference. Under a mesh "dropless" and
"capacity" raise: on local shards they would compute something else. The
per-expert products on float experts stay batched matmuls outside any
kernel, as the reference computes them with ``jnp.einsum``; on the rank's
int8 experts (an int8 tree under a mesh: q and the scale of its shard, as
``distributed.sharding.int8_spec`` lays them out) each capacity buffer of
``cap`` rows an expert goes through the grouped matmul kernel as one group
an expert, on the int8 weights (``expert_ffn``), never a dequantized copy.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import all_gather, all_to_all, pmean, psum
from repro_torch.kernels.moe_gmm import GroupedRows
from repro_torch.launch.mesh import spec_axes
from repro_torch.models.common import QuantizedLinear, RunCtx, act_fn, dequant, linear

# drop counts of the capacity strategies, summed while ``count_drops`` is open
_drops = None


class count_drops:
    """While open, the capacity dispatches add the (token, choice) rows
    they drop (device tensors, no sync) to ``.dispatch`` (a rank's
    ``cap_s`` in ep_shardmap) and ``.expert`` (an expert's capacity)."""

    def __enter__(self):
        global _drops
        self.dispatch, self.expert, self._prev = 0, 0, _drops
        _drops = self
        return self

    def __exit__(self, *exc):
        global _drops
        _drops = self._prev

    def total(self) -> int:
        return int(self.dispatch) + int(self.expert)


def _dropped(kind: str, count) -> None:
    """Adds ``count()`` to the open counter's ``kind`` (nothing runs when
    no counter is open)."""
    if _drops is not None:
        setattr(_drops, kind, getattr(_drops, kind) + count())


def router_topk(xf, router_w, k: int):
    """xf (T, d) -> (topw (T,k) f32, topi (T,k) int64, aux scalar)."""
    logits = xf.float() @ dequant(router_w, xf.dtype).float()
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, k, dim=-1)
    topw = topw / torch.clamp(topw.sum(dim=-1, keepdim=True), min=1e-9)
    E = probs.shape[-1]
    # Switch-style load-balance loss: E * sum_e f_e * P_e
    f = F.one_hot(topi, E).float().sum(dim=1).mean(dim=0) / k
    aux = E * torch.sum(f * probs.mean(dim=0))
    return topw, topi, aux


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def capacity_dispatch(xf, topi, E: int, cap: int):
    """Scatter each (token, choice) row into its expert's buffer at the slot
    its token-major rank gives; ranks at or past ``cap`` are dropped (into
    the trash row E). Returns (ebuf (E, cap, d), (e_safe, p_safe, keep)),
    each of the last three (T * K,)."""
    T, K = topi.shape
    e = topi.reshape(-1)
    oh = F.one_hot(e, E + 1)[:, :E]          # id E (trash) -> an all-zero row, as jax.nn.one_hot
    pos = torch.sum(torch.cumsum(oh, dim=0) * oh, dim=-1) - 1     # slot in the expert
    keep = (pos >= 0) & (pos < cap)
    e_safe = torch.where(keep, e, torch.full_like(e, E))
    p_safe = torch.where(keep, pos, torch.zeros_like(pos))
    tok = torch.arange(T * K, device=xf.device) // K
    ebuf = xf.new_zeros((E + 1, cap, xf.shape[-1])).index_put((e_safe, p_safe), xf[tok])
    _dropped("expert", lambda: torch.sum((e < E) & ~keep))
    return ebuf[:E], (e_safe, p_safe, keep)


def capacity_combine(ye, info, topw):
    """ye (E, cap, d) expert outputs -> (T, d) fp32: each token's kept rows
    weighted by their routing weights and summed."""
    e_safe, p_safe, keep = info
    T, K = topw.shape
    ybuf = torch.cat([ye, ye.new_zeros((1,) + tuple(ye.shape[1:]))], dim=0)
    rows = ybuf[e_safe, p_safe].float()
    w = topw.reshape(-1)[:, None] * keep[:, None]
    return (rows * w).reshape(T, K, -1).sum(dim=1)


def expert_ffn_dense(ebuf, wg, wu, wd):
    """(E, C, d) through each expert's SwiGLU FFN -> (E, C, d): batched
    matmuls against (E, d, f) / (E, f, d) weights."""
    h1 = torch.bmm(ebuf, wg)
    h2 = torch.bmm(ebuf, wu)
    return torch.bmm(F.silu(h1) * h2, wd)


def expert_ffn(ebuf, wg, wu, wd):
    """``expert_ffn_dense`` on float experts; on int8 experts
    (``QuantizedLinear``, scale (E, K, 1)) the three products through the
    grouped matmul, each expert's ``cap`` rows one group (its kernel on the
    card, the plain version on the CPU)."""
    if not isinstance(wg, QuantizedLinear):
        return expert_ffn_dense(ebuf, wg, wu, wd)
    E, C, d = ebuf.shape
    xf = ebuf.reshape(E * C, d)
    rows = GroupedRows(torch.full((E,), C, dtype=torch.int64, device=xf.device), xf,
                       sizes=[C] * E)
    xb = rows.pack(xf)
    h = F.silu(rows.matmul(xb, wg)) * rows.matmul(xb, wu)
    return rows.unpack(rows.matmul(h, wd)).reshape(E, C, -1)


def _shared_ffn(p_shared, xf, act_name):
    h = linear(xf, p_shared["wi"])
    g = linear(xf, p_shared["wg"])
    return linear(act_fn(act_name)(g) * h, p_shared["wo"])


def moe_dropless(p, xf, cfg: ModelConfig, ctx: RunCtx):
    m = cfg.moe
    E, K = m.num_experts, m.top_k
    T, d = xf.shape
    topw, topi, aux = router_topk(xf, p["router"], K)
    e = topi.reshape(-1)
    tok = torch.arange(T * K, device=xf.device) // K
    # stable, as jnp.argsort: the order feeds the scatter-add combine
    order = torch.argsort(e, stable=True)
    xs = xf[tok[order]]
    gs = torch.bincount(e, minlength=E)
    # one layout for the three matmuls: on the card the rows are scattered
    # once into the kernel's tile-aligned buffer (its row tile from the
    # kernel's plan: (1 + E) x 16 rows at decode) and gathered once at the
    # end; the activation runs over the buffer's padding rows too (garbage
    # the kernel never reads) rather than gathering the real rows out
    rows = GroupedRows(gs, xs)
    xb = rows.pack(xs)
    h1 = rows.matmul(xb, p["wg"])
    h2 = rows.matmul(xb, p["wu"])
    ys = rows.unpack(rows.matmul((F.silu(h1.float()) * h2.float()).to(xs.dtype), p["wd"]))
    w_flat = topw.reshape(-1)[order]
    y = torch.zeros((T, d), dtype=torch.float32, device=xf.device)
    y.index_add_(0, tok[order], ys.float() * w_flat[:, None])
    if "shared" in p:
        y = y + _shared_ffn(p["shared"], xf, cfg.act).float()
    return y.to(xf.dtype), aux


def moe_capacity(p, xf, cfg: ModelConfig, ctx: RunCtx):
    """The capacity strategy: cap = round_up(max(ceil(T K / E cf), 8), 8)
    rows an expert. Float experts only: the reference never trains int8."""
    m = cfg.moe
    E, K = m.num_experts, m.top_k
    T, d = xf.shape
    if any(isinstance(p[n], QuantizedLinear) for n in ("wg", "wu", "wd")):
        raise NotImplementedError("the capacity strategy runs on float experts only, "
                                  "not on an int8 tree")
    cap = _round_up(max(int(math.ceil(T * K / E * m.capacity_factor)), 8), 8)
    topw, topi, aux = router_topk(xf, p["router"], K)
    ebuf, info = capacity_dispatch(xf, topi, E, cap)
    ye = expert_ffn_dense(ebuf, p["wg"], p["wu"], p["wd"])
    y = capacity_combine(ye, info, topw)
    if "shared" in p:
        y = y + _shared_ffn(p["shared"], xf, cfg.act).float()
    return y.to(xf.dtype), aux


# --------------------------------------------------------------------------
# Strategies: tp_shardmap / ep_shardmap (explicit collectives)
# --------------------------------------------------------------------------
def _shared_ffn_tp(shared, xf, act_name, mesh, tp_axis):
    """The shared experts split on tp: the local partial, psum'd."""
    return psum(_shared_ffn(shared, xf, act_name), mesh, tp_axis).float()


def _moe_local_tp(xf, router_w, wg, wu, wd, shared, cfg, mesh, tp_axis, cf):
    """One rank's shard_map body: experts REPLICATED, the FFN dim split on
    tp. xf (T_l, d). Down-projection partials psum over tp."""
    m = cfg.moe
    E, K = m.num_experts, m.top_k
    T = xf.shape[0]
    cap = _round_up(max(int(math.ceil(T * K / E * cf)), 8), 8)
    topw, topi, aux = router_topk(xf, router_w, K)
    ebuf, info = capacity_dispatch(xf, topi, E, cap)
    ye = psum(expert_ffn(ebuf, wg, wu, wd), mesh, tp_axis)     # partials over f
    y = capacity_combine(ye, info, topw)
    if shared is not None:
        y = y + _shared_ffn_tp(shared, xf, cfg.act, mesh, tp_axis)
    return y.to(xf.dtype), aux


def _a2a_int8(buf, mesh, axis):
    """int8-compressed all-to-all (beyond the paper): rows quantized with
    their absmax, int8 payload + f32 scales exchanged. No gradient: the
    rounding's is zero almost everywhere (the reference's too), so a loss
    through it would train nothing before it; it raises under grad."""
    if buf.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError("quant='a2a_int8' under grad: the int8 all-to-all's rounding "
                                  "has no useful gradient (zero almost everywhere); train with "
                                  "quant='none'")
    amax = torch.amax(torch.abs(buf.float()), dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(buf.float() / scale), -127, 127).to(torch.int8)
    q = all_to_all(q, mesh, axis)
    scale = all_to_all(scale, mesh, axis)
    return (q.float() * scale).to(buf.dtype)


def _moe_local_ep(xf, router_w, wg, wu, wd, shared, cfg, mesh, ep_axis, tp_axis, cf,
                  a2a_quant: bool = False):
    """One rank's shard_map body: hybrid TP x EP. Experts split on the ep
    axis (all-to-all dispatch and return), the FFN dim on the tp axis."""
    m = cfg.moe
    E, K = m.num_experts, m.top_k
    dp = mesh.shape[ep_axis]
    E_l = E // dp
    T, d = xf.shape
    dev = xf.device
    topw, topi, aux = router_topk(xf, router_w, K)
    e = topi.reshape(-1)                                          # (TK,) global expert
    tok = torch.arange(T * K, device=dev) // K

    # --- stage 1: dispatch to the shard owning each expert ------------------
    dest = e // E_l
    ohd = F.one_hot(dest, dp)
    posd = torch.sum(torch.cumsum(ohd, dim=0) * ohd, dim=-1) - 1
    # min-capacity 4 (not 8): at decode the dispatch is padding-dominated
    cap_s = _round_up(max(int(math.ceil(T * K * cf / dp)), 4), 4)
    keep = posd < cap_s
    _dropped("dispatch", lambda: torch.sum(~keep))
    d_safe = torch.where(keep, dest, torch.full_like(dest, dp))
    p_safe = torch.where(keep, posd, torch.zeros_like(posd))
    sx = xf.new_zeros((dp + 1, cap_s, d)).index_put((d_safe, p_safe), xf[tok])
    se = torch.zeros((dp + 1, cap_s), dtype=torch.int32, device=dev).index_put(
        (d_safe, p_safe), (e % E_l).to(torch.int32))
    sv = torch.zeros((dp + 1, cap_s), dtype=torch.int32, device=dev).index_put(
        (d_safe, p_safe), keep.to(torch.int32))
    rx = _a2a_int8(sx[:dp], mesh, ep_axis) if a2a_quant else all_to_all(sx[:dp], mesh, ep_axis)
    re = all_to_all(se[:dp], mesh, ep_axis)
    rv = all_to_all(sv[:dp], mesh, ep_axis)

    # --- stage 2: local expert FFN over received rows (capacity buffers) ----
    R = dp * cap_s
    rxf, ref_, rvf = rx.reshape(R, d), re.reshape(R).long(), rv.reshape(R) > 0
    e2 = torch.where(rvf, ref_, torch.full_like(ref_, E_l))       # invalid -> trash id
    cap2 = _round_up(max(int(math.ceil(R / E_l * cf)), 8), 8)
    ebuf2, info2 = capacity_dispatch(rxf, e2[:, None], E_l, cap2)
    ye = psum(expert_ffn(ebuf2, wg, wu, wd), mesh, tp_axis)   # partials over f (TP)
    y_rows = capacity_combine(ye, info2, torch.ones((R, 1), dtype=torch.float32, device=dev))
    ybuf = y_rows.reshape(dp, cap_s, d).to(xf.dtype)

    # --- stage 3: return + combine ------------------------------------------
    yret = _a2a_int8(ybuf, mesh, ep_axis) if a2a_quant else all_to_all(ybuf, mesh, ep_axis)
    yret = torch.cat([yret, yret.new_zeros((1, cap_s, d))], dim=0)
    rows = yret[d_safe, p_safe].float()                           # (TK, d)
    w = topw.reshape(-1)[:, None] * keep[:, None]
    y = (rows * w).reshape(T, K, d).sum(dim=1)
    if shared is not None:
        y = y + _shared_ffn_tp(shared, xf, cfg.act, mesh, tp_axis)
    return y.to(xf.dtype), aux


def _split_axes(mesh, axes):
    """``axes`` with the size-1 ones dropped (a split over them is none)."""
    return tuple(a for a in spec_axes(axes) if mesh.shape[a] > 1)


def _check_shard(name, t, want):
    """``t`` (a tensor, or an int8 leaf: q of the shard's shape, its scale
    that with the last dim 1) is the shard of shape ``want``."""
    want = tuple(want)
    if isinstance(t, QuantizedLinear):
        ok = tuple(t.q.shape) == want and tuple(t.scale.shape) == want[:-1] + (1,)
        held = f"q {tuple(t.q.shape)}, scale {tuple(t.scale.shape)}"
    else:
        ok, held = tuple(t.shape) == want, str(tuple(t.shape))
    if not ok:
        raise ValueError(f"MoE weight {name}: this rank holds {held}, the strategy wants its "
                         f"shard {want}")


def moe_shardmap(p, h, cfg: ModelConfig, ctx: RunCtx, batch_axes=None):
    """The mesh branch of the reference's ``moe_sublayer``: h (B_l, S, d)
    holds this rank's rows of the batch split over ``batch_axes`` (None:
    every row). The tokens split on the data axis only when the global B
    divides it (else replicated), EP only when E divides the ep axis (else
    the TP body), and the weights must be the rank's shards of that layout:
    experts split on ``ep_axis`` (EP) or whole (TP), the FFN dim on
    ``tp_axis``, float or int8 (``expert_ffn``). Returns (out (B_l, S, d),
    aux pmean'd over ep, then tp)."""
    mesh = ctx.mesh
    ep_ax, tp_ax = ctx.ep_axis, ctx.tp_axis
    m = cfg.moe
    E = m.num_experts
    dp, tp = mesh.shape[ep_ax], mesh.shape[tp_ax]
    B_l, S, d = h.shape
    B = B_l * mesh.count(batch_axes)
    b_ax = "data" if "data" in mesh.axis_names else ep_ax
    bsz = mesh.shape[b_ax]
    bspec = b_ax if (B % bsz == 0 and B >= bsz) else None
    ep = ctx.moe_strategy == "ep_shardmap" and E % dp == 0 and E >= dp
    fe = m.d_expert or cfg.d_ff
    E_l = E // dp if ep else E
    _check_shard("wg", p["wg"], (E_l, d, fe // tp))
    _check_shard("wu", p["wu"], (E_l, d, fe // tp))
    _check_shard("wd", p["wd"], (E_l, fe // tp, d))
    shared = p.get("shared")
    if shared is not None:
        fs = fe * m.num_shared_experts
        _check_shard("shared wi", shared["wi"], (d, fs // tp))
        _check_shard("shared wg", shared["wg"], (d, fs // tp))
        _check_shard("shared wo", shared["wo"], (fs // tp, d))
    # the tokens this body sees: the rows of bspec's split; the caller's
    # rows are re-split only where the two layouts differ
    have, want = _split_axes(mesh, batch_axes), _split_axes(mesh, bspec)
    x = h
    if have != want:
        x = all_gather(x, mesh, have, dim=0) if have else x
        if want:
            n = B // mesh.count(want)
            x = x[mesh.index(want) * n:(mesh.index(want) + 1) * n]
    xf = x.reshape(-1, d)
    if ep:
        y, aux = _moe_local_ep(xf, p["router"], p["wg"], p["wu"], p["wd"], shared, cfg, mesh,
                               ep_ax, tp_ax, m.capacity_factor,
                               a2a_quant=ctx.quant == "a2a_int8")
    else:
        y, aux = _moe_local_tp(xf, p["router"], p["wg"], p["wu"], p["wd"], shared, cfg, mesh,
                               tp_ax, m.capacity_factor)
    aux = pmean(pmean(aux.reshape(1), mesh, ep_ax), mesh, tp_ax)[0]
    y = y.reshape(x.shape)
    if have != want:
        y = all_gather(y, mesh, want, dim=0) if want else y
        if have:
            y = y[mesh.index(have) * B_l:(mesh.index(have) + 1) * B_l]
    return y, aux


MOE_STRATEGIES = {"dropless": moe_dropless, "capacity": moe_capacity}
SHARDMAP_STRATEGIES = ("tp_shardmap", "ep_shardmap")


def moe_sublayer(p: Dict[str, Any], h, cfg: ModelConfig, ctx: RunCtx,
                 batch_axes=None) -> Tuple[Any, Any]:
    """h: (B, S, d) normed input. Returns (out (B,S,d), aux loss scalar).
    Under a mesh h is this rank's rows of the batch split over
    ``batch_axes`` (None: every row) and the strategy a shard_map one."""
    strategy = ctx.moe_strategy
    if strategy not in MOE_STRATEGIES and strategy not in SHARDMAP_STRATEGIES:
        raise ValueError(f"moe_strategy {strategy!r}: one of "
                         f"{sorted(MOE_STRATEGIES) + list(SHARDMAP_STRATEGIES)}")
    if ctx.mesh is not None:
        if strategy not in SHARDMAP_STRATEGIES:
            raise ValueError(f"moe_strategy {strategy!r} under a mesh: on local shards it "
                             f"would compute another function; use tp_shardmap or ep_shardmap")
        return moe_shardmap(p, h, cfg, ctx, batch_axes)
    B, S, d = h.shape
    fn = MOE_STRATEGIES.get(strategy, moe_capacity)    # the shard_map ones without a mesh
    y, aux = fn(p, h.reshape(B * S, d), cfg, ctx)
    return y.reshape(B, S, d), aux
