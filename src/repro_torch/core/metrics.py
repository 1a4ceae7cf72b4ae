"""Request lifecycle + the paper's §5.1 metrics.

Timestamps (paper Figure 4):
  t0 user submits          t1 router receives        t2 engine starts inference
  t3 engine finishes       t4 gateway received first engine output
  t5 user receives first token                       t6 user receives full output

Metrics:
  average latency   = t5 - t0   (paper's formula; we also report t6 - t0)
  gateway latency   = (t2 - t0) + (t5 - t3)
  engine latency    = t3 - t2
  throughput        = N_tokens / (T1 - T0)
  TTFT              = t4 - t0   (paper formula; t5-t0 from the user side)
  TBT               = (t6 - t5) / (N_g - 1)   [seconds/token, like every
                       duration here; the paper's printed formula is its
                       reciprocal — see DESIGN.md §9]
"""
from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np


def now() -> float:
    return time.perf_counter()


@dataclass
class Request:
    req_id: str
    prompt_tokens: np.ndarray                 # (S,) int32
    max_new_tokens: int = 64
    temperature: float = 0.5
    top_p: float = 0.7
    greedy: bool = False
    auth_token: str = ""
    user_id: str = "anon"
    # lifecycle timestamps
    t0: float = 0.0
    t1: float = 0.0
    t2: float = 0.0
    t3: float = 0.0
    t4: float = 0.0
    t5: float = 0.0
    t6: float = 0.0
    # outputs
    generated: List[int] = field(default_factory=list)
    token_times: List[float] = field(default_factory=list)   # client-side receive times
    finished: bool = False
    error: Optional[str] = None
    preemptions: int = 0
    replica_id: Optional[str] = None
    hedged: bool = False
    # request-lifecycle hardening (DESIGN.md §5): a deadline budget in
    # seconds (propagated gateway -> router -> scheduler) and its absolute
    # cutoff on the monotonic clock (t1 + deadline_s); 0.0 = no deadline.
    deadline_s: Optional[float] = None
    deadline_at: float = 0.0
    retries: int = 0                          # transient-submit retries spent

    @property
    def n_generated(self) -> int:
        return len(self.generated)


@dataclass
class RequestMetrics:
    req_id: str
    avg_latency: float          # t5 - t0 (paper formula)
    full_latency: float         # t6 - t0
    gateway_latency: float      # (t2-t0)+(t5-t3)
    engine_latency: float       # t3 - t2
    ttft: float                 # t4 - t0
    ttft_user: float            # t5 - t0
    tbt: float                  # (t6-t5)/(Ng-1) seconds per token
    n_tokens: int
    preemptions: int
    timed_out: bool


def request_metrics(r: Request, timeout_s: float = 60.0) -> RequestMetrics:
    ng = max(r.n_generated, 1)
    tbt = (r.t6 - r.t5) / (ng - 1) if ng > 1 else 0.0
    return RequestMetrics(
        req_id=r.req_id,
        avg_latency=r.t5 - r.t0,
        full_latency=r.t6 - r.t0,
        gateway_latency=(r.t2 - r.t0) + (r.t5 - r.t3 if r.t5 > r.t3 else 0.0),
        engine_latency=r.t3 - r.t2,
        ttft=r.t4 - r.t0,
        ttft_user=r.t5 - r.t0,
        tbt=tbt,
        n_tokens=r.n_generated,
        preemptions=r.preemptions,
        timed_out=(r.t6 - r.t0) > timeout_s or not r.finished,
    )


@dataclass
class BenchmarkSummary:
    concurrency: int
    n_requests: int
    throughput_tok_s: float
    mean: Dict[str, float]
    p50: Dict[str, float]
    p99: Dict[str, float]
    timeout_frac: float
    extras: Dict[str, Any] = field(default_factory=dict)


def summarize(requests: List[Request], t_start: float, t_end: float,
              concurrency: int, timeout_s: float = 60.0,
              extras: Optional[Dict[str, Any]] = None) -> BenchmarkSummary:
    """``extras`` carries engine-level counters (prefix-cache hit rate, COW
    copies, evictions — see ``InferenceEngine.stats``) alongside the
    request-latency aggregates."""
    ms = [request_metrics(r, timeout_s) for r in requests]
    total_tokens = sum(m.n_tokens for m in ms)
    fields = ["avg_latency", "full_latency", "gateway_latency", "engine_latency",
              "ttft", "ttft_user", "tbt"]

    def agg(fn):
        return {f: fn([getattr(m, f) for m in ms]) if ms else 0.0 for f in fields}

    return BenchmarkSummary(
        concurrency=concurrency,
        n_requests=len(requests),
        throughput_tok_s=total_tokens / max(t_end - t_start, 1e-9),
        mean=agg(lambda v: float(statistics.fmean(v)) if v else 0.0),
        p50=agg(lambda v: float(np.percentile(v, 50)) if v else 0.0),
        p99=agg(lambda v: float(np.percentile(v, 99)) if v else 0.0),
        timeout_frac=sum(m.timed_out for m in ms) / max(len(ms), 1),
        extras=dict(extras or {}),
    )
