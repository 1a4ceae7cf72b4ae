"""Observability module (paper Figure 1's Observability Module).

Three layers:

``Tracer`` / ``Span``
  Per-request span lists covering the whole serving path: gateway
  admission, routing, queue wait, each prefill chunk, decode runs,
  speculative verify sweeps, COW copies, preemption/resume. Spans use the
  monotonic clock (``metrics.now``), are collected under one lock, and the
  whole tracer is a no-op when disabled (``Tracer(enabled=False)`` or a
  ``None`` tracer on the instrumented component) — the hot path pays one
  truthiness check. Consecutive same-name spans of a request can be
  coalesced (``merge=True``) so a thousand decode iterations become a few
  "decode run" spans instead of a thousand entries.

``MetricsSink``
  Thread-safe in-memory counters + JSONL persistence. Records buffer in
  memory and reach disk on ``flush()``; with ``flush_interval_s`` a daemon
  thread flushes periodically, and sinks with a path always flush once
  more at interpreter exit (``atexit``) or on ``close()``, so a benchmark
  that crashes mid-run still leaves its records on disk.

Timeline aggregation (windowed percentiles, SLO attainment) lives in
``repro_torch.core.timeline``; the per-iteration engine profile is
``InferenceEngine.step_records``.
"""
from __future__ import annotations

import atexit
import os
import threading
import weakref
from collections import defaultdict, deque
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Tuple

try:                                    # orjson is optional (3-10x faster)
    import orjson as _orjson
except ImportError:                     # stdlib fallback keeps the module importable
    _orjson = None
    import json as _json

from repro_torch.core.metrics import Request, now, request_metrics


def _dumps(obj: Any) -> bytes:
    if _orjson is not None:
        return _orjson.dumps(obj)
    return _json.dumps(obj, default=str, separators=(",", ":")).encode()


# ----------------------------------------------------------------- tracing
@dataclass
class Span:
    """One attributed stage of a request's life. ``t0``/``t1`` are
    monotonic-clock seconds (same clock as the Figure-4 timestamps);
    instant events carry t0 == t1."""
    name: str
    t0: float
    t1: float
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.t1 - self.t0


class Tracer:
    """Thread-safe per-request span collector.

    ``begin``/``end`` bracket an open stage (keyed by request + name, e.g.
    the queue wait closed at admission); ``add`` records a closed span;
    ``event`` records an instant. ``pop`` removes and returns a request's
    ordered span list for export. Bounded: at most ``max_spans`` spans per
    request (overflow counted in ``dropped_spans``) and ``max_requests``
    tracked requests (oldest evicted), so an exporter that never pops a
    cancelled request cannot leak memory.

    A disabled tracer is falsy — instrumentation guards with
    ``if tracer: ...`` and pays nothing else.
    """

    def __init__(self, enabled: bool = True, max_spans: int = 512,
                 max_requests: int = 8192):
        self.enabled = enabled
        self.max_spans = max_spans
        self.max_requests = max_requests
        self._spans: Dict[str, List[Span]] = {}
        self._open: Dict[Tuple[str, str], Span] = {}
        self._order: deque = deque()        # req_id insertion order (eviction)
        self._lock = threading.Lock()
        self.dropped_spans = 0
        self.evicted_requests = 0

    def __bool__(self) -> bool:
        return self.enabled

    # -- internal: caller holds the lock
    def _bucket(self, req_id: str) -> List[Span]:
        spans = self._spans.get(req_id)
        if spans is None:
            spans = self._spans[req_id] = []
            self._order.append(req_id)
            while len(self._spans) > self.max_requests and self._order:
                victim = self._order.popleft()
                if victim in self._spans:
                    del self._spans[victim]
                    self.evicted_requests += 1
        return spans

    def _append(self, req_id: str, span: Span, merge: bool) -> None:
        spans = self._bucket(req_id)
        if merge and spans and spans[-1].name == span.name:
            last = spans[-1]
            last.t1 = span.t1
            for k, v in span.attrs.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    last.attrs[k] = last.attrs.get(k, 0) + v
                else:
                    last.attrs[k] = v
            return
        if len(spans) >= self.max_spans:
            self.dropped_spans += 1
            return
        spans.append(span)

    # -- public API (all no-ops when disabled)
    def begin(self, req_id: str, name: str, **attrs: Any) -> None:
        if not self.enabled:
            return
        t = now()
        with self._lock:
            self._open[(req_id, name)] = Span(name, t, t, dict(attrs))

    def end(self, req_id: str, name: str, **attrs: Any) -> None:
        if not self.enabled:
            return
        t = now()
        with self._lock:
            span = self._open.pop((req_id, name), None)
            if span is None:
                return
            span.t1 = t
            span.attrs.update(attrs)
            self._append(req_id, span, merge=False)

    def add(self, req_id: str, name: str, t0: float, t1: float,
            merge: bool = False, **attrs: Any) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._append(req_id, Span(name, t0, t1, dict(attrs)), merge)

    def event(self, req_id: str, name: str, **attrs: Any) -> None:
        if not self.enabled:
            return
        t = now()
        with self._lock:
            self._append(req_id, Span(name, t, t, dict(attrs)), merge=False)

    def pop(self, req_id: str) -> List[Span]:
        """Remove and return the request's spans (ordered by insertion).
        Open (unclosed) spans for the request are dropped."""
        with self._lock:
            spans = self._spans.pop(req_id, [])
            for key in [k for k in self._open if k[0] == req_id]:
                del self._open[key]
            return spans

    def discard(self, req_id: str) -> None:
        self.pop(req_id)

    def peek(self, req_id: str) -> List[Span]:
        with self._lock:
            return list(self._spans.get(req_id, ()))

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


def spans_to_dicts(spans: List[Span]) -> List[Dict[str, Any]]:
    return [asdict(s) for s in spans]


# ------------------------------------------------------------------- sink
# Sinks with a path register here once; a single atexit hook flushes any
# still alive at interpreter exit (weak refs: a collected sink is skipped).
_LIVE_SINKS: "weakref.WeakSet" = weakref.WeakSet()
_ATEXIT_ARMED = False


def _flush_live_sinks() -> None:
    for sink in list(_LIVE_SINKS):
        try:
            sink.close()
        except Exception:
            pass


class MetricsSink:
    """Thread-safe in-memory counters + JSONL persistence with optional
    periodic auto-flush (``flush_interval_s``) and a guaranteed exit-time
    flush (``close()`` / ``atexit``) for sinks that have a path."""

    def __init__(self, path: Optional[str] = None,
                 flush_interval_s: Optional[float] = None):
        self.path = path
        self.counters: Dict[str, float] = defaultdict(float)
        self._records: List[bytes] = []
        self._lock = threading.Lock()
        self._closed = False
        self._stop = threading.Event()
        self._flusher: Optional[threading.Thread] = None
        if path is not None:
            global _ATEXIT_ARMED
            _LIVE_SINKS.add(self)
            if not _ATEXIT_ARMED:
                atexit.register(_flush_live_sinks)
                _ATEXIT_ARMED = True
        if flush_interval_s is not None and path is not None:
            self._flusher = threading.Thread(
                target=self._flush_loop, args=(float(flush_interval_s),),
                name="metrics-sink-flush", daemon=True)
            self._flusher.start()

    def _flush_loop(self, interval: float) -> None:
        while not self._stop.wait(interval):
            self.flush()

    def incr(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] += value

    def observe(self, name: str, value: float) -> None:
        """One observation of a distribution-valued metric (e.g. failover
        latency): keeps ``.count`` / ``.sum`` / ``.max`` counters so the
        snapshot exposes mean and worst case without storing samples."""
        with self._lock:
            self.counters[f"{name}.count"] += 1
            self.counters[f"{name}.sum"] += value
            if value > self.counters[f"{name}.max"]:
                self.counters[f"{name}.max"] = value

    def record_request(self, r: Request) -> None:
        m = request_metrics(r)
        rec = _dumps({"kind": "request", **asdict(m)})
        with self._lock:
            self._records.append(rec)
            self.counters["requests_completed"] += 1
            self.counters["tokens_generated"] += r.n_generated

    def record(self, kind: str, **fields: Any) -> None:
        rec = _dumps({"kind": kind, **fields})
        with self._lock:
            self._records.append(rec)

    def record_trace(self, r: Request, spans: List[Span]) -> None:
        """Export a finished request's span list (DESIGN.md §4) alongside
        the Figure-4 timestamps it must reconcile with."""
        rec = _dumps({
            "kind": "trace", "req_id": r.req_id, "replica_id": r.replica_id,
            "t0": r.t0, "t1": r.t1, "t2": r.t2, "t3": r.t3, "t4": r.t4,
            "t5": r.t5, "t6": r.t6, "n_generated": r.n_generated,
            "preemptions": r.preemptions, "spans": spans_to_dicts(spans),
        })
        with self._lock:
            self._records.append(rec)
            self.counters["traces_exported"] += 1

    def record_engine(self, engine_id: str, stats: Dict[str, float]) -> None:
        """Snapshot an engine's cumulative counters (``InferenceEngine.stats``):
        prefix-cache hit/miss pages, COW copies, evictions, hit-rate gauge.
        Cumulative counters become gauges (last value wins)."""
        rec = _dumps({"kind": "engine", "engine_id": engine_id, **stats})
        with self._lock:
            self._records.append(rec)
            for k, v in stats.items():
                self.counters[f"engine.{k}"] = float(v)

    def flush(self) -> int:
        """Persist buffered records to disk; returns count written."""
        with self._lock:
            records, self._records = self._records, []
        if self.path and records:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(self.path, "ab") as f:
                f.write(b"\n".join(records) + b"\n")
        return len(records)

    def close(self) -> int:
        """Stop the auto-flusher and flush whatever is buffered. Idempotent;
        also runs via ``atexit`` for sinks with a path."""
        first = False
        with self._lock:
            if not self._closed:
                self._closed = True
                first = True
        if first:
            self._stop.set()
            if self._flusher is not None and self._flusher.is_alive():
                self._flusher.join(timeout=5)
        return self.flush()

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.counters)
