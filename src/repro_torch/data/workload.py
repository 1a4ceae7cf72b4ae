"""Synthetic serving workload matched to OpenOrca's published length
statistics (the dataset itself is not redistributable offline — DESIGN.md §9).

Prompt lengths ~ LogNormal fitted so median ≈ 150 tokens, long tail to ~2k
(system prompt + question); output lengths capped at the paper's
max-generation 512. All lengths are scaled down proportionally for the
tiny-model CPU benches via ``scale``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

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
    scale: float = 1.0              # shrink for tiny-model CPU benches
    seed: int = 0
    # shared-system-prompt traffic: every request's prompt begins with one of
    # ``n_shared_prefixes`` fixed prefixes of exactly ``shared_prefix_len``
    # tokens (NOT scaled — callers size it in pages for the prefix-cache
    # benches). 0 disables.
    shared_prefix_len: int = 0
    n_shared_prefixes: int = 1
    # repetition-friendly (RAG-style extractive) traffic for the speculative-
    # decoding benches: a fraction of prompts are [passage, query, passage]
    # (the grounding span appears twice, as in retrieval-augmented serving)
    # and a fraction are periodic boilerplate (a short motif tiled to the
    # prompt length, as in templated/form traffic). Both give prompt-lookup
    # drafting earlier n-gram occurrences to match. 0 disables (default).
    extractive_frac: float = 0.0
    boilerplate_frac: float = 0.0
    boilerplate_period: int = 4
    # open-loop arrival schedule (bench_traffic): Poisson arrivals at
    # ``arrival_rate`` req/s, with a periodic burst phase — for
    # ``burst_duty`` of every ``burst_period_s`` the rate is multiplied by
    # ``burst_mult`` (bursty production traffic; §5's constant-concurrency
    # driver is the closed-loop special case). 0 disables (closed loop).
    arrival_rate: float = 0.0
    burst_mult: float = 1.0
    burst_period_s: float = 10.0
    burst_duty: float = 0.3


def sample_workload(spec: WorkloadSpec) -> Tuple[List[np.ndarray], List[int]]:
    """Returns (prompts, max_new_tokens per request)."""
    rng = np.random.default_rng(spec.seed)
    mu = np.log(spec.prompt_median)
    lens = np.exp(rng.normal(mu, spec.prompt_sigma, spec.n_requests))
    lens = np.clip(lens * spec.scale, max(int(spec.min_prompt * spec.scale), 2),
                   max(int(spec.max_prompt * spec.scale), 4)).astype(int)
    outs = np.minimum(
        rng.geometric(1.0 / max(spec.max_new_tokens * spec.scale / 2, 2), spec.n_requests),
        max(int(spec.max_new_tokens * spec.scale), 4),
    ).astype(int)
    outs = np.maximum(outs, 2)
    prompts = [rng.integers(1, spec.vocab, n).astype(np.int32) for n in lens]
    shapes = rng.random(spec.n_requests)
    for i, n in enumerate(lens):
        if shapes[i] < spec.extractive_frac and n >= 8:
            # passage + query + passage: the passage span repeats verbatim
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
    """Arrival offsets (seconds from bench start, sorted) for the open-loop
    schedule: a piecewise-constant-rate Poisson process — base rate
    ``arrival_rate``, stepped up to ``burst_mult`` x for the first
    ``burst_duty`` fraction of every ``burst_period_s`` window. Seeded from
    ``spec.seed`` but decoupled from prompt sampling (a different stream), so
    changing the schedule never reshuffles the prompts."""
    if spec.arrival_rate <= 0:
        return [0.0] * spec.n_requests
    rng = np.random.default_rng((spec.seed, 0xA221))

    def rate_at(t: float) -> float:
        if spec.burst_mult <= 1.0 or spec.burst_period_s <= 0:
            return spec.arrival_rate
        phase = (t % spec.burst_period_s) / spec.burst_period_s
        return spec.arrival_rate * (spec.burst_mult if phase < spec.burst_duty
                                    else 1.0)

    # thinning: draw at the peak rate, accept with prob rate(t)/peak
    peak = spec.arrival_rate * max(spec.burst_mult, 1.0)
    t = 0.0
    out: List[float] = []
    while len(out) < spec.n_requests:
        t += float(rng.exponential(1.0 / peak))
        if rng.random() < rate_at(t) / peak:
            out.append(t)
    return out
