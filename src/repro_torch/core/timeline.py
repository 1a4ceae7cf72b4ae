"""Windowed serving timeline + SLO attainment (DESIGN.md §4).

Turns two raw streams into the dashboard panel vocabulary (the ROADMAP
item-3 referee: p50/p99 TTFT and TBT, queue depth/time, throughput,
utilization, preemption and eviction rates):

  * ``StepRecord`` — one row per engine iteration (``InferenceEngine``
    keeps them in a bounded ring buffer): what was packed against the
    token budget, batch occupancy, queue depth, KV page pressure, spec
    acceptance, wall time.
  * completed ``Request`` objects — per-request latency metrics
    (``request_metrics``) bucketed by completion time, each judged
    against configurable TTFT/TBT SLO targets.

Percentiles come from log-bucketed histograms (geometric buckets, sparse
dict storage, no dependencies) so a window costs O(observations) to build
and O(buckets) to summarize, with bounded relative error (one bucket
width, ~9% at the default growth factor).
"""
from __future__ import annotations

import math
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.core.metrics import Request, request_metrics


@dataclass
class StepRecord:
    """One engine iteration (``InferenceEngine.step``). Token counts are
    tokens *fed* this step (rejected speculative drafts included — they
    consumed compute); ``preemptions`` / ``cow_pages`` are per-step deltas
    of the engine's cumulative counters."""
    step: int
    t0: float                      # monotonic wall-clock (metrics.now)
    t1: float
    budget: int                    # per-iteration token budget
    tokens_packed: int             # all tokens fed (prefill+decode+drafts)
    n_admitted: int
    prefill_rows: int
    prefill_tokens: int
    decode_rows: int
    decode_tokens: int             # committed decode tokens
    drafted_tokens: int
    accepted_tokens: int
    occupancy: int                 # running slots after the step
    max_slots: int
    queue_depth: int               # waiting requests after the step
    kv_free_pages: int
    kv_total_pages: int
    preemptions: int
    cow_pages: int

    @property
    def duration(self) -> float:
        return self.t1 - self.t0


class LogHistogram:
    """Sparse log-bucketed histogram for positive values.

    Bucket ``i`` covers ``[min_value * growth**i, min_value * growth**(i+1))``;
    values below ``min_value`` (including 0) land in a dedicated underflow
    bucket reported as ``min_value``. Percentiles return the geometric
    midpoint of the selected bucket, so relative error is bounded by the
    growth factor (default 1.2 → <10%)."""

    def __init__(self, growth: float = 1.2, min_value: float = 1e-6):
        assert growth > 1.0 and min_value > 0.0
        self.growth = growth
        self.min_value = min_value
        self._log_g = math.log(growth)
        self.buckets: Dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def record(self, value: float) -> None:
        if value < self.min_value:
            idx = -1
        else:
            idx = int(math.log(value / self.min_value) / self._log_g)
        self.buckets[idx] = self.buckets.get(idx, 0) + 1
        self.count += 1
        self.total += value
        self.vmin = min(self.vmin, value)
        self.vmax = max(self.vmax, value)

    def merge(self, other: "LogHistogram") -> None:
        assert other.growth == self.growth and other.min_value == self.min_value
        for idx, n in other.buckets.items():
            self.buckets[idx] = self.buckets.get(idx, 0) + n
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)

    def _bucket_value(self, idx: int) -> float:
        if idx < 0:
            return self.min_value
        return self.min_value * self.growth ** (idx + 0.5)

    def percentile(self, p: float) -> float:
        """p in [0, 100]. Exact at the extremes (tracked min/max); bucket
        geometric midpoint otherwise."""
        if self.count == 0:
            return 0.0
        if p <= 0:
            return self.vmin
        if p >= 100:
            return self.vmax
        rank = p / 100.0 * self.count
        seen = 0
        for idx in sorted(self.buckets):
            seen += self.buckets[idx]
            if seen >= rank:
                return min(max(self._bucket_value(idx), self.vmin), self.vmax)
        return self.vmax

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


@dataclass
class SLOConfig:
    """Per-request service-level objectives. A request attains its SLO when
    TTFT (t4 - t0, the paper's formula) and TBT (seconds/token) both meet
    their targets. ``None`` disables that component."""
    ttft_target_s: Optional[float] = 1.0
    tbt_target_s: Optional[float] = 0.1


@dataclass
class _Window:
    ttft: LogHistogram = field(default_factory=LogHistogram)
    tbt: LogHistogram = field(default_factory=LogHistogram)
    queue_wait: LogHistogram = field(default_factory=LogHistogram)
    steps: int = 0
    busy_s: float = 0.0
    tokens: int = 0                 # all tokens fed by the engine
    decode_tokens: int = 0
    prefill_tokens: int = 0
    budget: int = 0                 # sum of per-step budgets
    occupancy_sum: int = 0
    slots_sum: int = 0
    queue_depth_sum: int = 0
    queue_depth_max: int = 0
    kv_used_frac_sum: float = 0.0
    drafted: int = 0
    accepted: int = 0
    preemptions: int = 0
    cow_pages: int = 0
    admitted: int = 0
    completed: int = 0
    completed_tokens: int = 0
    slo_attained: int = 0
    ttft_ok: int = 0
    tbt_ok: int = 0
    # resilience events (DESIGN.md §5), bucketed by occurrence time
    events: Dict[str, int] = field(default_factory=dict)
    failover_latencies: List[float] = field(default_factory=list)


class TimelineAggregator:
    """Buckets step records and request completions into fixed wall-clock
    windows. The time origin is the first timestamp ever added; windows are
    reported relative to it (``t`` seconds). Ingestion is offline-friendly:
    feed it after a run from the engine ring buffers and the finished
    request list — order does not matter."""

    def __init__(self, window_s: float = 1.0, slo: Optional[SLOConfig] = None):
        assert window_s > 0
        self.window_s = window_s
        self.slo = slo or SLOConfig()
        self._origin: Optional[float] = None
        self._windows: Dict[int, _Window] = {}
        self.n_requests = 0
        self.n_steps = 0
        self._ttft_all = LogHistogram()
        self._tbt_all = LogHistogram()
        self._slo_attained = 0

    def _window(self, t: float) -> _Window:
        if self._origin is None:
            self._origin = t
        idx = math.floor((t - self._origin) / self.window_s)
        w = self._windows.get(idx)
        if w is None:
            w = self._windows[idx] = _Window()
        return w

    # --------------------------------------------------------------- ingest
    def add_step(self, rec: StepRecord) -> None:
        w = self._window(rec.t1)
        w.steps += 1
        w.busy_s += max(rec.duration, 0.0)
        w.tokens += rec.tokens_packed
        w.decode_tokens += rec.decode_tokens
        w.prefill_tokens += rec.prefill_tokens
        w.budget += rec.budget
        w.occupancy_sum += rec.occupancy
        w.slots_sum += rec.max_slots
        w.queue_depth_sum += rec.queue_depth
        w.queue_depth_max = max(w.queue_depth_max, rec.queue_depth)
        if rec.kv_total_pages > 0:
            w.kv_used_frac_sum += 1.0 - rec.kv_free_pages / rec.kv_total_pages
        w.drafted += rec.drafted_tokens
        w.accepted += rec.accepted_tokens
        w.preemptions += rec.preemptions
        w.cow_pages += rec.cow_pages
        w.admitted += rec.n_admitted
        self.n_steps += 1

    def add_steps(self, records) -> None:
        for rec in records:
            self.add_step(rec)

    def add_request(self, r: Request) -> None:
        """Bucket a completed request by its completion timestamp (t6 when
        the client saw the tail, else t3). Queue wait is t2 - t1 (arrival at
        the serving stack to engine admission)."""
        m = request_metrics(r)
        t_done = r.t6 if r.t6 > 0 else r.t3
        w = self._window(t_done)
        w.completed += 1
        w.completed_tokens += m.n_tokens
        w.ttft.record(max(m.ttft, 0.0))
        self._ttft_all.record(max(m.ttft, 0.0))
        if m.n_tokens > 1:
            w.tbt.record(max(m.tbt, 0.0))
            self._tbt_all.record(max(m.tbt, 0.0))
        if r.t2 > 0 and r.t1 > 0:
            w.queue_wait.record(max(r.t2 - r.t1, 0.0))
        ttft_ok = (self.slo.ttft_target_s is None
                   or m.ttft <= self.slo.ttft_target_s)
        tbt_ok = (self.slo.tbt_target_s is None or m.n_tokens <= 1
                  or m.tbt <= self.slo.tbt_target_s)
        w.ttft_ok += ttft_ok
        w.tbt_ok += tbt_ok
        attained = ttft_ok and tbt_ok
        w.slo_attained += attained
        self._slo_attained += attained
        self.n_requests += 1

    def add_requests(self, requests) -> None:
        for r in requests:
            self.add_request(r)

    def add_event(self, name: str, t: float, n: int = 1) -> None:
        """Count a resilience event (shed / retry / deadline_exceeded / ...)
        in the window containing ``t``."""
        w = self._window(t)
        w.events[name] = w.events.get(name, 0) + n

    def add_failover(self, t: float, latency_s: float) -> None:
        """One replica failover: counted as an event and its detection
        latency (last heartbeat to detection) kept for the summary."""
        w = self._window(t)
        w.events["failovers"] = w.events.get("failovers", 0) + 1
        w.failover_latencies.append(latency_s)

    # --------------------------------------------------------------- output
    def timeline(self) -> List[Dict[str, Any]]:
        """One dict per non-empty window, time-ordered. Gaps (windows with
        no activity at all) are omitted."""
        out: List[Dict[str, Any]] = []
        ws = self.window_s
        for idx in sorted(self._windows):
            w = self._windows[idx]
            out.append({
                "t": idx * ws,
                "window_s": ws,
                "steps": w.steps,
                "completed": w.completed,
                "admitted": w.admitted,
                "throughput_tok_s": w.tokens / ws,
                "decode_tok_s": w.decode_tokens / ws,
                "prefill_tok_s": w.prefill_tokens / ws,
                "p50_ttft_s": w.ttft.percentile(50),
                "p99_ttft_s": w.ttft.percentile(99),
                "p50_tbt_s": w.tbt.percentile(50),
                "p99_tbt_s": w.tbt.percentile(99),
                "p50_queue_wait_s": w.queue_wait.percentile(50),
                "p99_queue_wait_s": w.queue_wait.percentile(99),
                "queue_depth_mean": w.queue_depth_sum / w.steps if w.steps else 0.0,
                "queue_depth_max": w.queue_depth_max,
                "occupancy_frac": (w.occupancy_sum / w.slots_sum
                                   if w.slots_sum else 0.0),
                "budget_util": w.tokens / w.budget if w.budget else 0.0,
                "kv_util_mean": w.kv_used_frac_sum / w.steps if w.steps else 0.0,
                "busy_frac": min(w.busy_s / ws, 1.0),
                "preemptions_per_s": w.preemptions / ws,
                "cow_pages_per_s": w.cow_pages / ws,
                "spec_acceptance": (w.accepted / w.drafted if w.drafted else 0.0),
                "slo_attainment": (w.slo_attained / w.completed
                                   if w.completed else None),
                "ttft_ok_frac": (w.ttft_ok / w.completed
                                 if w.completed else None),
                "tbt_ok_frac": (w.tbt_ok / w.completed if w.completed else None),
                "shed": w.events.get("shed", 0),
                "retries": w.events.get("retries", 0),
                "deadline_exceeded": w.events.get("deadline_exceeded", 0),
                "failovers": w.events.get("failovers", 0),
            })
        return out

    def summary(self) -> Dict[str, Any]:
        wins = self._windows.values()
        total_tokens = sum(w.tokens for w in wins)
        span_s = len(self._windows) * self.window_s
        return {
            "window_s": self.window_s,
            "n_windows": len(self._windows),
            "n_steps": self.n_steps,
            "n_requests": self.n_requests,
            "slo": asdict(self.slo),
            "slo_attainment": (self._slo_attained / self.n_requests
                               if self.n_requests else None),
            "p50_ttft_s": self._ttft_all.percentile(50),
            "p99_ttft_s": self._ttft_all.percentile(99),
            "p50_tbt_s": self._tbt_all.percentile(50),
            "p99_tbt_s": self._tbt_all.percentile(99),
            "throughput_tok_s": total_tokens / span_s if span_s else 0.0,
            "preemptions": sum(w.preemptions for w in wins),
            "completed_tokens": sum(w.completed_tokens for w in wins),
            "shed": sum(w.events.get("shed", 0) for w in wins),
            "retries": sum(w.events.get("retries", 0) for w in wins),
            "deadline_exceeded": sum(w.events.get("deadline_exceeded", 0)
                                     for w in wins),
            "failovers": sum(w.events.get("failovers", 0) for w in wins),
            "failover_latency_max_s": max(
                (v for w in wins for v in w.failover_latencies), default=0.0),
            "failover_latency_mean_s": (
                (lambda vs: sum(vs) / len(vs) if vs else 0.0)(
                    [v for w in wins for v in w.failover_latencies])),
        }
