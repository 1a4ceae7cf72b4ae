"""Mixture-of-Experts layer, dropless strategy (the serving engine's path):
exact token-choice routing, rows sorted by expert, three grouped matmuls
(the hand-written CUDA kernel on the card, on int8 experts too), weighted
scatter-add combine.

The reference's capacity and shard_map strategies come with the training
and distribution slices.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.moe_gmm import GroupedRows
from repro_torch.models.common import RunCtx, act_fn, dequant, linear


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


def moe_sublayer(p: Dict[str, Any], h, cfg: ModelConfig, ctx: RunCtx) -> Tuple[Any, Any]:
    """h: (B, S, d) normed input. Returns (out (B,S,d), aux loss scalar)."""
    B, S, d = h.shape
    y, aux = moe_dropless(p, h.reshape(B * S, d), cfg, ctx)
    return y.reshape(B, S, d), aux
