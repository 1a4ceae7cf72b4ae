"""Quickstart on the PyTorch port: load an architecture config, build the
model, and generate tokens through the continuous-batching engine (greedy,
reduced config), on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/quickstart_torch.py --arch qwen2.5-3b
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.configs import ALL_ARCHS, get_config, tiny_config
from repro_torch.core import EngineConfig, InferenceEngine, Request, now, request_metrics
from repro_torch.models import build_model


def make_requests(cfg, max_new: int, n: int = 3):
    rng = np.random.default_rng(0)
    return [Request(req_id=f"demo-{i}",
                    prompt_tokens=rng.integers(1, cfg.vocab, 12).astype(np.int32),
                    max_new_tokens=max_new) for i in range(n)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b", choices=ALL_ARCHS)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = tiny_config(args.arch)
    print(f"arch={cfg.name}  layers={cfg.n_layers}  d_model={cfg.d_model}  "
          f"params={cfg.param_count():,} (reduced; full config: "
          f"{get_config(args.arch).param_count() / 1e9:.1f}B)  device={args.device}")
    model = build_model(cfg)
    params = model.init_params(args.seed, device=args.device)

    engine = InferenceEngine(model, params, EngineConfig(
        max_slots=2, page_size=8, num_pages=128, max_seq=128, greedy=True,
        device=args.device))

    reqs = make_requests(cfg, args.max_new)
    t0 = now()
    engine.generate(reqs)
    dt = now() - t0
    for r in reqs:
        m = request_metrics(r)
        print(f"{r.req_id}: {r.generated[:10]}...  "
              f"ttft={m.ttft * 1e3:.0f}ms tbt={m.tbt * 1e3:.1f}ms/token")
    total = sum(r.n_generated for r in reqs)
    print(f"generated {total} tokens in {dt:.2f}s "
          f"({total / dt:.0f} tok/s; on the card the kernels' first build is included)")
    return reqs


if __name__ == "__main__":
    main()
