"""Traffic: the one general generator that every traffic mix's data file
(``traffic/<name>.json``) feeds.

``WorkloadSpec``, ``sample_workload`` and ``sample_arrivals`` are a frozen
copy of the port's ``repro_torch.data.workload`` (OpenOrca-like lengths:
LogNormal prompts, geometric outputs), so that a later change to the program
cannot move the yardstick. The copy adds one field, ``output_mean`` (0: the
source's mean of half the output cap), so that a mix can cap its outputs
above twice their mean; with it at 0 every draw equals the source's.

``build_stream`` turns a mix and a run's seed into the requests the clients
send. Every seed gets the same sizes: the mix draws one block of (prompt
length, output length) pairs from its own ``sizes_seed``, and a run's seed
only orders each block and draws the token ids. So any run of a cell does
the same work per block, whatever its seed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np


@dataclass(frozen=True)
class WorkloadSpec:
    n_requests: int
    vocab: int
    prompt_median: int = 150
    prompt_sigma: float = 0.8
    max_prompt: int = 2048
    min_prompt: int = 4
    max_new_tokens: int = 512
    scale: float = 1.0
    seed: int = 0
    shared_prefix_len: int = 0
    n_shared_prefixes: int = 1
    extractive_frac: float = 0.0
    boilerplate_frac: float = 0.0
    boilerplate_period: int = 4
    arrival_rate: float = 0.0
    burst_mult: float = 1.0
    burst_period_s: float = 10.0
    burst_duty: float = 0.3
    output_mean: float = 0.0        # 0: max_new_tokens * scale / 2, as the source


def sample_workload(spec: WorkloadSpec) -> Tuple[List[np.ndarray], List[int]]:
    """Returns (prompts, max_new_tokens per request)."""
    rng = np.random.default_rng(spec.seed)
    mu = np.log(spec.prompt_median)
    lens = np.exp(rng.normal(mu, spec.prompt_sigma, spec.n_requests))
    lens = np.clip(lens * spec.scale, max(int(spec.min_prompt * spec.scale), 2),
                   max(int(spec.max_prompt * spec.scale), 4)).astype(int)
    mean = spec.output_mean or spec.max_new_tokens * spec.scale / 2
    outs = np.minimum(
        rng.geometric(1.0 / max(mean, 2), spec.n_requests),
        max(int(spec.max_new_tokens * spec.scale), 4),
    ).astype(int)
    outs = np.maximum(outs, 2)
    prompts = [rng.integers(1, spec.vocab, n).astype(np.int32) for n in lens]
    shapes = rng.random(spec.n_requests)
    for i, n in enumerate(lens):
        if shapes[i] < spec.extractive_frac and n >= 8:
            q = max(n // 8, 2)
            passage = rng.integers(1, spec.vocab, (n - q + 1) // 2).astype(np.int32)
            query = rng.integers(1, spec.vocab, q).astype(np.int32)
            prompts[i] = np.concatenate([passage, query, passage])[:n]
        elif shapes[i] < spec.extractive_frac + spec.boilerplate_frac and n >= 4:
            per = max(min(spec.boilerplate_period, n // 2), 1)
            motif = rng.integers(1, spec.vocab, per).astype(np.int32)
            prompts[i] = np.tile(motif, -(-n // per))[:n]
    if spec.shared_prefix_len > 0:
        prefixes = [rng.integers(1, spec.vocab, spec.shared_prefix_len).astype(np.int32)
                    for _ in range(max(spec.n_shared_prefixes, 1))]
        prompts = [np.concatenate([prefixes[i % len(prefixes)], p])
                   for i, p in enumerate(prompts)]
    return prompts, outs.tolist()


def sample_arrivals(spec: WorkloadSpec) -> List[float]:
    """Arrival offsets (seconds from the start, sorted) of the open loop: a
    Poisson process at ``arrival_rate``, stepped up to ``burst_mult`` x for
    the first ``burst_duty`` of every ``burst_period_s``."""
    if spec.arrival_rate <= 0:
        return [0.0] * spec.n_requests
    rng = np.random.default_rng((spec.seed, 0xA221))

    def rate_at(t: float) -> float:
        if spec.burst_mult <= 1.0 or spec.burst_period_s <= 0:
            return spec.arrival_rate
        phase = (t % spec.burst_period_s) / spec.burst_period_s
        return spec.arrival_rate * (spec.burst_mult if phase < spec.burst_duty
                                    else 1.0)

    peak = spec.arrival_rate * max(spec.burst_mult, 1.0)
    t = 0.0
    out: List[float] = []
    while len(out) < spec.n_requests:
        t += float(rng.exponential(1.0 / peak))
        if rng.random() < rate_at(t) / peak:
            out.append(t)
    return out


@dataclass
class StreamRequest:
    index: int
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int
    arrival_s: float = 0.0      # open loop: offset from the loop's start


def block_sizes(mix: Dict[str, Any], vocab: int) -> Tuple[List[int], List[int]]:
    """The mix's one block of (prompt length, output length) pairs, drawn by
    ``sample_workload`` from the mix's ``sizes_seed``."""
    p, o = mix["prompt"], mix["output"]
    spec = WorkloadSpec(n_requests=mix["block"], vocab=vocab, prompt_median=p["median"],
                        prompt_sigma=p["sigma"], max_prompt=p["max"], min_prompt=p["min"],
                        max_new_tokens=o["max"], output_mean=o.get("mean", 0.0),
                        seed=mix["sizes_seed"])
    prompts, outs = sample_workload(spec)
    return [len(x) for x in prompts], outs


def build_stream(mix: Dict[str, Any], vocab: int, seed: int) -> List[StreamRequest]:
    """``mix["blocks"]`` blocks, each the mix's block of sizes in an order
    drawn from ``seed``, with token ids drawn from ``seed`` in [1, vocab).
    An open-loop mix (``arrival_rate`` > 0) also gets ``sample_arrivals``'
    schedule, seeded from ``seed``."""
    lens, outs = block_sizes(mix, vocab)
    rng = np.random.default_rng((int(seed), 0x5EED))
    out: List[StreamRequest] = []
    for _ in range(mix["blocks"]):
        for j in rng.permutation(len(lens)):
            ids = rng.integers(1, vocab, lens[j]).astype(np.int32)
            out.append(StreamRequest(len(out), ids, int(outs[j])))
    rate = mix.get("arrival_rate", 0.0)
    if rate > 0:
        arr = sample_arrivals(WorkloadSpec(
            n_requests=len(out), vocab=vocab, arrival_rate=rate,
            burst_mult=mix.get("burst_mult", 1.0),
            burst_period_s=mix.get("burst_period_s", 10.0),
            burst_duty=mix.get("burst_duty", 0.3), seed=int(seed)))
        for r, t in zip(out, arr):
            r.arrival_s = t
    return out


def client_requests(stream: List[StreamRequest], clients: int) -> List[List[StreamRequest]]:
    """Closed loop: client i sends requests i, i + clients, ... in order."""
    return [stream[i::clients] for i in range(clients)]
