"""Mixture-of-Experts layer, two of the reference's strategies
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

The reference's shard_map strategies come with the distribution slice.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.moe_gmm import GroupedRows
from repro_torch.models.common import QuantizedLinear, RunCtx, act_fn, dequant, linear


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
    oh = F.one_hot(e, E)
    pos = torch.sum(torch.cumsum(oh, dim=0) * oh, dim=-1) - 1     # slot in the expert
    keep = (pos >= 0) & (pos < cap)
    e_safe = torch.where(keep, e, torch.full_like(e, E))
    p_safe = torch.where(keep, pos, torch.zeros_like(pos))
    tok = torch.arange(T * K, device=xf.device) // K
    ebuf = xf.new_zeros((E + 1, cap, xf.shape[-1])).index_put((e_safe, p_safe), xf[tok])
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


MOE_STRATEGIES = {"dropless": moe_dropless, "capacity": moe_capacity}


def moe_sublayer(p: Dict[str, Any], h, cfg: ModelConfig, ctx: RunCtx) -> Tuple[Any, Any]:
    """h: (B, S, d) normed input. Returns (out (B,S,d), aux loss scalar)."""
    if ctx.moe_strategy not in MOE_STRATEGIES:
        raise ValueError(f"moe_strategy {ctx.moe_strategy!r}: one of {sorted(MOE_STRATEGIES)}")
    B, S, d = h.shape
    y, aux = MOE_STRATEGIES[ctx.moe_strategy](p, h.reshape(B * S, d), cfg, ctx)
    return y.reshape(B, S, d), aux
