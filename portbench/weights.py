"""The benchmark's own weights: seeded bf16 draws, made on the device one
layer at a time, handed both to the program (``system.py``) and to the plain
reference (``reference/``), which draws them again.

A configuration file (``configs/<name>.json``) holds the published keys of
a decoder-only MoE transformer; ``Shapes`` reads them. Each layer's normal
leaves come from one ``torch.randn`` call in bf16 on a generator seeded from
(run seed, layer), sliced into leaves and scaled in place, so any layer can
be drawn again alone, bit for bit on the same device. Distributions: normal
0.02 for the embedding and the router, LeCun normal (1 / sqrt(fan in)) for
every projection, ones for the norms.

This module imports torch alone: the reference builds on it.
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

ORDER_ATTN = ("wq", "wk", "wv", "wo")
ORDER_MOE = ("router", "wg", "wu", "wd")
ORDER_MLP = ("wi", "wg", "wo")


@dataclass(frozen=True)
class Shapes:
    """The sizes a configuration file states, in the names used here."""
    d: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    vocab: int
    d_ff: int                 # the dense layers' FFN width
    experts: int
    top_k: int
    d_expert: int
    shared: int               # shared experts, each d_expert wide
    dense_layers: int         # leading dense layers
    norm_topk: bool
    rope_theta: float
    rms_eps: float

    @staticmethod
    def of(cfg: Dict) -> "Shapes":
        d, H = cfg["hidden_size"], cfg["num_attention_heads"]
        experts = cfg.get("num_local_experts", cfg.get("n_routed_experts"))
        return Shapes(
            d=d, layers=cfg["num_hidden_layers"], heads=H,
            kv_heads=cfg.get("num_key_value_heads", H),
            head_dim=cfg.get("head_dim") or d // H, vocab=cfg["vocab_size"],
            d_ff=cfg["intermediate_size"], experts=experts,
            top_k=cfg["num_experts_per_tok"],
            d_expert=cfg.get("moe_intermediate_size") or cfg["intermediate_size"],
            shared=cfg.get("n_shared_experts") or 0,
            dense_layers=cfg.get("first_k_dense_replace", 0),
            norm_topk=bool(cfg.get("norm_topk_prob", True)),
            rope_theta=float(cfg["rope_theta"]), rms_eps=float(cfg["rms_norm_eps"]))

    def is_moe(self, layer: int) -> bool:
        return layer >= self.dense_layers

    def layer_leaves(self, layer: int) -> List[Tuple[str, Tuple[int, ...], float]]:
        """(path, shape, std) of the layer's normal leaves, in draw order."""
        d, H, Hkv, hd = self.d, self.heads, self.kv_heads, self.head_dim
        out = [("attn.wq", (d, H, hd), d ** -0.5), ("attn.wk", (d, Hkv, hd), d ** -0.5),
               ("attn.wv", (d, Hkv, hd), d ** -0.5), ("attn.wo", (H, hd, d), (H * hd) ** -0.5)]
        if not self.is_moe(layer):
            f = self.d_ff
            return out + [("mlp.wi", (d, f), d ** -0.5), ("mlp.wg", (d, f), d ** -0.5),
                          ("mlp.wo", (f, d), f ** -0.5)]
        E, fe = self.experts, self.d_expert
        out += [("moe.router", (d, E), 0.02), ("moe.wg", (E, d, fe), d ** -0.5),
                ("moe.wu", (E, d, fe), d ** -0.5), ("moe.wd", (E, fe, d), fe ** -0.5)]
        if self.shared:
            fs = fe * self.shared
            out += [("moe.shared.wi", (d, fs), d ** -0.5), ("moe.shared.wg", (d, fs), d ** -0.5),
                    ("moe.shared.wo", (fs, d), fs ** -0.5)]
        return out

    def top_leaves(self) -> List[Tuple[str, Tuple[int, ...], float]]:
        return [("embed", (self.vocab, self.d), 0.02),
                ("lm_head", (self.d, self.vocab), self.d ** -0.5)]

    def norms(self) -> Tuple[str, ...]:
        return ("ln1", "ln2")

    def param_count(self) -> int:
        n = sum(math.prod(s) for _, s, _ in self.top_leaves()) + self.d
        for layer in range(self.layers):
            n += sum(math.prod(s) for _, s, _ in self.layer_leaves(layer)) + 2 * self.d
        return n


def stream_seed(seed: int, part: str) -> int:
    """A generator seed for one part ("top", "layer.<i>") of a run's draws."""
    h = hashlib.blake2b(f"portbench:{int(seed)}:{part}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") & ((1 << 63) - 1)


def _draw(leaves, seed: int, part: str, device) -> Dict[str, torch.Tensor]:
    n = sum(math.prod(s) for _, s, _ in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, part))
    flat = torch.randn(n, generator=gen, dtype=torch.bfloat16, device=device)
    out, at = {}, 0
    for name, shape, std in leaves:
        k = math.prod(shape)
        out[name] = flat[at:at + k].view(shape).mul_(std)
        at += k
    return out


def draw_layer(shapes: Shapes, seed: int, layer: int, device) -> Dict[str, torch.Tensor]:
    """Layer ``layer``'s weights in bf16 on ``device``: its normal leaves as
    views of one draw, and its norms (ones)."""
    out = _draw(shapes.layer_leaves(layer), seed, f"layer.{layer}", device)
    for name in shapes.norms():
        out[name] = torch.ones(shapes.d, dtype=torch.bfloat16, device=device)
    return out


def draw_top(shapes: Shapes, seed: int, device) -> Dict[str, torch.Tensor]:
    """The embedding, the head and the final norm in bf16 on ``device``."""
    out = _draw(shapes.top_leaves(), seed, "top", device)
    out["final_norm"] = torch.ones(shapes.d, dtype=torch.bfloat16, device=device)
    return out
