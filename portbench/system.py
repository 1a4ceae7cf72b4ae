"""The system under test: the port's model, its weights in the port's tree
(the benchmark's own draws, quantized by the port where the configuration
serves int8), and the serving stack in front of one engine:
``Gateway`` (scale config) -> ``ReplicaRouter`` (least loaded) -> one
``Replica`` -> ``InferenceEngine``.

Everything the harness takes from the program goes through this module.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from portbench.weights import Shapes, draw_layer, draw_top


SERVING_KERNELS = ("chunked_prefill", "moe_gmm", "quant_matmul")


def prebuild(device) -> Optional[threading.Thread]:
    """On the card, a thread that builds the serving path's kernel libraries
    (the port's ``kernels.build``: one nvcc each, all at once; nothing to do
    once a checkout has them) while the weights are drawn."""
    if torch.device(device).type != "cuda":
        return None
    from repro_torch.kernels.build import build
    t = threading.Thread(target=build, args=(SERVING_KERNELS,), name="prebuild")
    t.start()
    return t


def port_config(cfg: Dict[str, Any]):
    """The port's ``ModelConfig`` for a configuration file's keys."""
    from repro_torch.configs.base import LayerGroup, ModelConfig, MoEConfig
    s = Shapes.of(cfg)
    groups = []
    if s.dense_layers:
        groups.append(LayerGroup("A", s.dense_layers, moe_mask="0"))
    groups.append(LayerGroup("A", s.layers - s.dense_layers, moe_mask="1"))
    return ModelConfig(
        name=cfg["name"], family="moe", n_layers=s.layers, d_model=s.d, n_heads=s.heads,
        n_kv_heads=s.kv_heads, head_dim=s.head_dim, d_ff=s.d_ff, vocab=s.vocab,
        rope_theta=s.rope_theta, rms_eps=s.rms_eps,
        dense_d_ff=s.d_ff if s.dense_layers else 0,
        moe=MoEConfig(num_experts=s.experts, top_k=s.top_k, num_shared_experts=s.shared,
                      d_expert=s.d_expert, impl="dropless"),
        layer_groups=tuple(groups), source=cfg["source"])


def _get(tree, path: str):
    for k in path.split("."):
        tree = tree[k]
    return tree


def port_params(cfg: Dict[str, Any], seed: int, device, weights: str):
    """The port's parameter tree for the configuration, on ``device``:
    bf16 leaves (``weights`` "bf16") or the port's int8 tree ("int8":
    every leaf the port's ``quantizable`` takes goes through its
    ``quantize_leaf``, one layer at a time, as the port's own
    ``init_params_int8`` does). Values are the benchmark's draws
    (``weights.draw_layer`` / ``draw_top``)."""
    from repro_torch.models.params import map_tree, param_specs
    from repro_torch.quant.quantize import QuantizedLinear, quantizable, quantize_leaf
    s = Shapes.of(cfg)
    pcfg = port_config(cfg)
    specs = param_specs(pcfg)
    int8 = weights == "int8"
    bf16 = torch.bfloat16

    def alloc(spec):
        if int8 and quantizable(spec.shape, bf16):
            return QuantizedLinear(
                q=torch.empty(spec.shape, dtype=torch.int8, device=device),
                scale=torch.empty((*spec.shape[:-1], 1), dtype=torch.float32, device=device))
        return torch.empty(spec.shape, dtype=bf16, device=device)
    tree = map_tree(alloc, specs, is_leaf=lambda x: hasattr(x, "logical"))

    def put(leaf, idx, value):
        if isinstance(leaf, QuantizedLinear):
            ql = quantize_leaf(value)
            (leaf.q if idx is None else leaf.q[idx]).copy_(ql.q)
            (leaf.scale if idx is None else leaf.scale[idx]).copy_(ql.scale)
        else:
            (leaf if idx is None else leaf[idx]).copy_(value)

    top = draw_top(s, seed, device)
    for name in ("embed", "lm_head", "final_norm"):
        put(tree[name]["w"], None, top[name])
    del top
    first = {}
    for gi, g in enumerate(pcfg.layer_groups):
        first[gi] = sum(x.repeats for x in pcfg.layer_groups[:gi])
    for gi, g in enumerate(pcfg.layer_groups):
        layer_tree = tree["groups"][gi]["layers"][0]
        for r in range(g.repeats):
            lw = draw_layer(s, seed, first[gi] + r, device)
            for path, value in lw.items():
                put(_get(layer_tree, path), r, value)
            del lw
    return pcfg, tree


@dataclass
class Stack:
    engine: Any
    replica: Any
    gateway: Any

    def stop(self) -> None:
        self.replica.stop()


def build_stack(pcfg, params, engine_cfg: Dict[str, Any], seed: int, device) -> Stack:
    """One engine on ``params`` behind the scale gateway, its replica
    thread started."""
    from repro_torch.core import (EngineConfig, Gateway, InferenceEngine, Replica,
                                  ReplicaRouter, RouterConfig, scale_gateway_config)
    from repro_torch.models import LM
    model = LM(pcfg)
    ecfg = EngineConfig(
        max_slots=engine_cfg["slots"], page_size=engine_cfg["page_size"],
        num_pages=engine_cfg["pages"], max_seq=engine_cfg["max_seq"],
        prefill_chunk=engine_cfg["prefill_chunk"], greedy=True,
        cache_dtype=getattr(torch, engine_cfg["kv_dtype"]), device=str(device),
        seed=int(seed) & 0x7FFFFFFF)
    engine = InferenceEngine(model, params, ecfg)
    replica = Replica("r0", engine)
    router = ReplicaRouter([replica], RouterConfig(policy="least_loaded"))
    gateway = Gateway(router, scale_gateway_config())
    replica.start()
    return Stack(engine, replica, gateway)
