"""Config registry: ``get_config("<arch-id>")`` and reduced smoke configs.

The port carries the configurations its paths run so far:
``mixtral-8x7b`` (the paper's evaluation model, MoE), ``qwen2.5-3b`` (the
dense family, with QKV bias), ``gemma2-27b`` (alternating sliding-window
and global attention, attention and logit softcaps, tied and scaled
embeddings, gelu), ``mamba2-1.3b`` (the SSM family: SSD layers only) and
``jamba-v0.1-52b`` (the hybrid family: mamba and attention layers, MoE on
every other layer).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401 (re-export)
    DECODE_32K,
    EncoderConfig,
    LayerGroup,
    LONG_500K,
    ModelConfig,
    MoEConfig,
    PREFILL_32K,
    ShapeConfig,
    SHAPES,
    SSMConfig,
    TRAIN_4K,
    VisionConfig,
    shape_applicable,
)

_MODULES = {
    "qwen2.5-3b": "qwen2_5_3b",
    "gemma2-27b": "gemma2_27b",
    "mamba2-1.3b": "mamba2_1_3b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "mixtral-8x7b": "mixtral_8x7b",
}

ALL_ARCHS: List[str] = list(_MODULES)

_cache: Dict[str, ModelConfig] = {}


def get_config(name: str) -> ModelConfig:
    if name not in _cache:
        if name not in _MODULES:
            raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
        mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
        _cache[name] = mod.CONFIG
    return _cache[name]


def tiny_config(name: str, *, seq_len: int = 64) -> ModelConfig:
    """A reduced same-family config for CPU smoke tests: same layer pattern
    shape (fewer repeats), tiny widths, tiny vocab. Exercises the identical
    code paths as the full config."""
    cfg = get_config(name)
    groups = tuple(
        dataclasses.replace(g, repeats=min(g.repeats, 2)) for g in cfg.layer_groups
    )
    n_layers = sum(g.n_layers for g in groups)
    moe = (
        dataclasses.replace(
            cfg.moe,
            num_experts=min(cfg.moe.num_experts, 4),
            top_k=min(cfg.moe.top_k, 2),
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
            d_expert=64,
        )
        if cfg.moe
        else None
    )
    ssm = (
        dataclasses.replace(cfg.ssm, d_state=16, head_dim=16, chunk_size=16)
        if cfg.ssm
        else None
    )
    return cfg.scaled(
        name=cfg.name + "-tiny",
        n_layers=n_layers,
        d_model=64,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        dense_d_ff=160 if cfg.dense_d_ff else 0,
        vocab=256,
        sliding_window=min(cfg.sliding_window, seq_len // 4) if cfg.sliding_window else 0,
        moe=moe,
        ssm=ssm,
        layer_groups=groups,
    )
