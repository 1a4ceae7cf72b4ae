"""The plain reference: a decoder-only MoE transformer (Mixtral,
arXiv:2401.04088; DeepSeekMoE, arXiv:2401.06066) written in plain PyTorch in
float32 (TF32 off), one sequence at a time, no cache, no batching, no
kernel. It draws the weights again from the run's seed (``portbench.weights``)
and works their int8 (or int4) form out itself (``quant.py``): it takes
nothing the program made.

Per layer: x += Wo · attn(RoPE(Wq h), RoPE(Wk h), Wv h) with h = RMSNorm(x),
causal softmax attention with 1/sqrt(head_dim) scaling, query heads sharing
kv heads in groups; then x += FFN(RMSNorm(x)): a SwiGLU MLP (dense layers)
or the MoE: router softmax over all experts, the top-k, their weights
renormalized to sum 1 where the configuration says so (``norm_topk_prob``),
each chosen expert's SwiGLU output weighted and summed, plus the shared
experts' SwiGLU. RoPE rotates the two halves of each head (theta^(-i/half)).
Then the final RMSNorm and the head.

The layers run in turn over every sequence of a batch of sequences, so only
one layer's weights are held at a time (the full mixtral-8x7b is 93 GB in
bf16).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from portbench.reference.quant import dequantized
from portbench.weights import Shapes, draw_layer, draw_top

Q_BLOCK = 1024          # query rows of one attention block


def rmsnorm(x, w, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x, theta: float):
    """x (S, H, D) at positions 0 .. S-1."""
    S, _, D = x.shape
    half = D // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(h, w: Dict[str, torch.Tensor], s: Shapes):
    S = h.shape[0]
    q = rope(torch.einsum("sd,dhk->shk", h, w["attn.wq"]), s.rope_theta)
    k = rope(torch.einsum("sd,dhk->shk", h, w["attn.wk"]), s.rope_theta)
    v = torch.einsum("sd,dhk->shk", h, w["attn.wv"])
    g = s.heads // s.kv_heads
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    out = torch.empty_like(q)
    scale = s.head_dim ** -0.5
    for a in range(0, S, Q_BLOCK):
        b = min(S, a + Q_BLOCK)
        sc = torch.einsum("qhk,shk->hqs", q[a:b], k[:b]) * scale
        keys = torch.arange(b, device=h.device)
        mask = keys[None, :] > torch.arange(a, b, device=h.device)[:, None]
        sc.masked_fill_(mask[None], float("-inf"))
        out[a:b] = torch.einsum("hqs,shk->qhk", torch.softmax(sc, dim=-1), v[:b])
    return torch.einsum("shk,hkd->sd", out, w["attn.wo"])


def swiglu(h, wg, wu, wd):
    return (torch.nn.functional.silu(h @ wg) * (h @ wu)) @ wd


def moe(h, w: Dict[str, torch.Tensor], s: Shapes):
    probs = torch.softmax(h @ w["moe.router"], dim=-1)
    topw, topi = torch.topk(probs, s.top_k, dim=-1)
    if s.norm_topk:
        topw = topw / topw.sum(-1, keepdim=True)
    y = torch.zeros_like(h)
    for e in range(s.experts):
        tok, slot = torch.nonzero(topi == e, as_tuple=True)
        if tok.numel():
            ye = swiglu(h[tok], w["moe.wg"][e], w["moe.wu"][e], w["moe.wd"][e])
            y.index_add_(0, tok, ye * topw[tok, slot][:, None])
    if s.shared:
        y = y + swiglu(h, w["moe.shared.wg"], w["moe.shared.wi"], w["moe.shared.wo"])
    return y


def layer_forward(x, w: Dict[str, torch.Tensor], s: Shapes, layer: int):
    x = x + attention(rmsnorm(x, w["ln1"], s.rms_eps), w, s)
    h = rmsnorm(x, w["ln2"], s.rms_eps)
    if s.is_moe(layer):
        return x + moe(h, w, s)
    return x + swiglu(h, w["mlp.wg"], w["mlp.wi"], w["mlp.wo"])


def stacked(s: Shapes, layer: int) -> int:
    """How many layers share the stack of a leaf of ``layer`` (the int8
    rule counts a leaf's elements over its stack)."""
    return s.layers - s.dense_layers if s.is_moe(layer) else s.dense_layers


class Reference:
    """Logits of whole sequences under each of several weight precisions
    ("bf16": the draws as they are; "int8" / "int4": the weight-only
    ``rule`` at 8 or 4 bits), computed side by side, layer by layer, in
    float32."""

    def __init__(self, cfg: Dict, seed: int, device, precisions: Sequence[str],
                 rule: Optional[Dict] = None):
        self.cfg, self.s = cfg, Shapes.of(cfg)
        self.seed, self.device = seed, device
        self.precisions = list(precisions)
        self.quant = rule

    def _weights(self, raw: Dict[str, torch.Tensor], layer: Optional[int], prec: str):
        st = 0 if layer is None else stacked(self.s, layer)
        return {k: dequantized(v, prec, self.quant, st) for k, v in raw.items()}

    @torch.no_grad()
    def logits(self, seqs: List[torch.Tensor], positions: List[Sequence[int]]
               ) -> Dict[str, List[torch.Tensor]]:
        """For each precision, each sequence's float32 logits (n, vocab) at
        its ``positions``."""
        prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return self._logits(seqs, positions)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev

    def _logits(self, seqs, positions):
        s, dev = self.s, self.device
        top = draw_top(s, self.seed, dev)
        xs = {}
        for p in self.precisions:
            emb = dequantized(top["embed"], p, self.quant, 0)
            xs[p] = [emb[t.to(dev).long()] for t in seqs]
            del emb
        for layer in range(s.layers):
            raw = draw_layer(s, self.seed, layer, dev)
            for p in self.precisions:
                w = self._weights(raw, layer, p)
                xs[p] = [layer_forward(x, w, s, layer) for x in xs[p]]
                del w
            del raw
        out = {}
        for p in self.precisions:
            head = dequantized(top["lm_head"], p, self.quant, 0)
            norm = top["final_norm"].float()
            out[p] = [rmsnorm(x[torch.as_tensor(list(pos), device=dev)], norm, s.rms_eps) @ head
                      for x, pos in zip(xs[p], positions)]
        return out
