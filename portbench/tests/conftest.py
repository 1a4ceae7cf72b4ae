"""Shared fixtures of the benchmark's CPU tests: tiny configurations and
cells built from the committed ones (same keys, small sizes), and the card
fixture for the tests marked ``cuda``."""
from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
PB = HERE.parent
ROOT = PB.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def _json(kind: str, name: str):
    with open(PB / kind / f"{name}.json") as f:
        return json.load(f)


def tiny_config(name: str, weights: str = None, d: int = 64, layers: int = 3):
    """A committed configuration at CPU size: every width small, the same
    keys, the same serving section."""
    c = _json("configs", name)
    c.update(hidden_size=d, num_hidden_layers=layers, vocab_size=512)
    if "n_routed_experts" in c:          # deepseek-like: MHA, a dense first layer
        c.update(num_attention_heads=4, num_key_value_heads=4, intermediate_size=160,
                 moe_intermediate_size=32, n_routed_experts=8)
    else:                                # mixtral-like: GQA
        c.update(num_attention_heads=4, num_key_value_heads=2, intermediate_size=128,
                 num_local_experts=4)
    if weights is not None:
        c["serving"]["weights"] = weights
    return c


TINY_MIX = {"clients": 6, "prompt": {"median": 20, "sigma": 0.8, "min": 4, "max": 64},
            "output": {"max": 16}, "sizes_seed": 0, "block": 6, "blocks": 40}


def tiny_cell(name: str):
    c = copy.deepcopy(_json("workloads", name))
    c["engine"].update(slots=6, pages=128, max_seq=96, prefill_chunk=32)
    c["check"].update(requests=12)
    return c


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda:0")
