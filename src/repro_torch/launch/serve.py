"""Serving launcher: build a replica fleet + gateway for an --arch config and
drive a synthetic OpenOrca-like workload against it (the reduced config by
default). Runs on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
      --replicas 2 --concurrency 8 --requests 32 --gateway scale [--device cpu]
"""
from __future__ import annotations

import argparse
import asyncio
import json

from repro_torch.configs import get_config, tiny_config
from repro_torch.core import (EngineConfig, Gateway, InferenceEngine, Replica,
                              ReplicaRouter, RouterConfig, baseline_gateway_config,
                              scale_gateway_config, summarize)
from repro_torch.core.client import merge_engine_timestamps, run_workload
from repro_torch.data.workload import WorkloadSpec, sample_workload
from repro_torch.models import build_model
from repro_torch.models.common import resolve_device


def build_fleet(arch: str, n_replicas: int, *, engine_kwargs=None, tiny: bool = True,
                klass: str = "default", seed: int = 0, device=None):
    """``n_replicas`` engines on one set of weights (shared, not copied),
    each stepped by its own started :class:`Replica` thread."""
    dev = resolve_device(device)
    cfg = tiny_config(arch) if tiny else get_config(arch)
    model = build_model(cfg)
    params = model.init_params(seed, device=dev)
    kw = dict(max_slots=8, page_size=16, num_pages=256, max_seq=256,
              prefill_chunk=32, greedy=False, device=str(dev))
    kw.update(engine_kwargs or {})
    replicas = []
    for i in range(n_replicas):
        eng = InferenceEngine(model, params, EngineConfig(**kw))
        replicas.append(Replica(f"{arch}-r{i}", eng, klass=klass).start())
    return cfg, replicas


async def serve_and_measure(arch: str, *, replicas: int, concurrency: int,
                            n_requests: int, gateway_kind: str, policy: str,
                            max_new: int = 24, seed: int = 0, device=None):
    cfg, fleet = build_fleet(arch, replicas, seed=seed, device=device)
    try:
        router = ReplicaRouter(fleet, RouterConfig(policy=policy))
        gw_cfg = scale_gateway_config() if gateway_kind == "scale" else baseline_gateway_config()
        gw = Gateway(router, gw_cfg)
        prompts, _ = sample_workload(WorkloadSpec(n_requests=n_requests, vocab=cfg.vocab,
                                                  scale=0.05, seed=seed))
        res = await run_workload(gw, prompts, concurrency=concurrency,
                                 max_new_tokens=max_new)
        merge_engine_timestamps(res.requests, gw)
        return summarize(res.requests, res.t_start, res.t_end, concurrency)
    finally:
        for r in fleet:
            r.stop()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--gateway", default="scale", choices=["scale", "baseline"])
    ap.add_argument("--policy", default="least_loaded",
                    choices=["round_robin", "least_loaded", "dynamic"])
    ap.add_argument("--device", default="cuda",
                    help="torch device the engines run on (cpu: the plain PyTorch path)")
    args = ap.parse_args(argv)
    s = asyncio.run(serve_and_measure(
        args.arch, replicas=args.replicas, concurrency=args.concurrency,
        n_requests=args.requests, gateway_kind=args.gateway, policy=args.policy,
        device=args.device))
    print(json.dumps({
        "arch": args.arch, "gateway": args.gateway, "policy": args.policy,
        "device": args.device,
        "concurrency": s.concurrency, "throughput_tok_s": s.throughput_tok_s,
        "mean": s.mean, "p99": s.p99, "timeout_frac": s.timeout_frac,
    }, indent=1))


if __name__ == "__main__":
    main()
