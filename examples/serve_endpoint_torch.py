"""End-to-end serving driver on the PyTorch port (the paper's system in one
script): gateway with auth + rate limiting + content filtering, replica
router, two continuous-batching replicas, concurrent streaming clients —
then the §5.1 latency decomposition, comparing the baseline (FastAPI-style)
and ScaleLLM gateways. On the card unless ``--device cpu``.

    PYTHONPATH=src python examples/serve_endpoint_torch.py
    PYTHONPATH=src python examples/serve_endpoint_torch.py --device cpu
"""
import argparse
import asyncio

from repro_torch.configs import tiny_config
from repro_torch.core import (EngineConfig, Gateway, InferenceEngine, MetricsSink,
                              Replica, ReplicaRouter, RouterConfig,
                              baseline_gateway_config, scale_gateway_config, summarize)
from repro_torch.core.client import merge_engine_timestamps, run_workload
from repro_torch.core.safety import Authenticator, ContentFilter, TokenBucket
from repro_torch.data.workload import WorkloadSpec, sample_workload
from repro_torch.models import build_model

ARCH = "mixtral-8x7b"       # the paper's model (reduced config)


async def serve_once(gateway_cfg, model, params, cfg, device, concurrency=6, n_requests=18,
                     max_new=12):
    replicas = [Replica(f"rep{i}", InferenceEngine(model, params, EngineConfig(
        max_slots=4, page_size=8, num_pages=256, max_seq=160, device=device,
    ))).start() for i in range(2)]
    sink = MetricsSink()
    router = ReplicaRouter(replicas, RouterConfig(policy="least_loaded"), sink=sink)
    auth = Authenticator()
    gw = Gateway(router, gateway_cfg, auth=auth,
                 rate_limiter=TokenBucket(rate=500, burst=1000),
                 content_filter=ContentFilter(blocked=set()),
                 require_auth=True)
    prompts, _ = sample_workload(WorkloadSpec(n_requests=n_requests, vocab=cfg.vocab,
                                              scale=0.05, seed=1))
    try:
        res = await run_workload(gw, prompts, concurrency=concurrency,
                                 max_new_tokens=max_new, auth_token=auth.issue("demo-user"))
        merge_engine_timestamps(res.requests, gw)
    finally:
        for r in replicas:
            r.stop()
    return summarize(res.requests, res.t_start, res.t_end, concurrency), res.requests


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--requests", type=int, default=18)
    ap.add_argument("--concurrency", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    cfg = tiny_config(ARCH)
    model = build_model(cfg)
    params = model.init_params(args.seed, device=args.device)
    print(f"serving {ARCH} (reduced) on 2 replicas on {args.device}, temp=0.5 top_p=0.7\n")
    print(f"{'gateway':<10} {'thpt tok/s':>10} {'TTFT ms':>9} {'TBT ms':>8} "
          f"{'gw-lat ms':>10} {'engine ms':>10}")
    out = {}
    for name, gw_cfg in (("baseline", baseline_gateway_config()),
                         ("scale", scale_gateway_config())):
        s, reqs = asyncio.run(serve_once(gw_cfg, model, params, cfg, args.device,
                                         args.concurrency, args.requests, args.max_new))
        out[name] = (s, reqs)
        print(f"{name:<10} {s.throughput_tok_s:>10.0f} {s.mean['ttft_user'] * 1e3:>9.1f} "
              f"{s.mean['tbt'] * 1e3:>8.2f} {s.mean['gateway_latency'] * 1e3:>10.1f} "
              f"{s.mean['engine_latency'] * 1e3:>10.1f}")
    return out


if __name__ == "__main__":
    main()
