"""The port's observability layer, as tests/test_observability.py holds the
reference's: Tracer/Span semantics, MetricsSink durability + thread-safety,
LogHistogram/TimelineAggregator math, and the TBT unit contract (seconds per
token, not ms). Then the port's timeline, metrics and dashboard against the
reference's on the same inputs."""
import json
import threading
import time

import numpy as np
import pytest

from repro_torch.core.metrics import Request, request_metrics
from repro_torch.core.observability import MetricsSink, Span, Tracer, spans_to_dicts
from repro_torch.core.timeline import (LogHistogram, SLOConfig, StepRecord,
                                 TimelineAggregator)


# ------------------------------------------------------------------ tracer
def test_tracer_begin_end_and_attrs():
    tr = Tracer()
    tr.begin("r1", "queue", requeued=False)
    time.sleep(0.002)
    tr.end("r1", "queue", cached_tokens=16)
    (span,) = tr.peek("r1")
    assert span.name == "queue"
    assert span.duration > 0
    assert span.attrs == {"requeued": False, "cached_tokens": 16}


def test_tracer_end_without_begin_is_noop():
    tr = Tracer()
    tr.end("r1", "queue")
    assert tr.peek("r1") == []


def test_tracer_merge_coalesces_consecutive_spans():
    tr = Tracer()
    for i in range(5):
        tr.add("r1", "decode", float(i), float(i) + 0.5, merge=True,
               n_iters=1, tokens=1, last=(i == 4))
    spans = tr.pop("r1")
    assert len(spans) == 1
    s = spans[0]
    assert (s.t0, s.t1) == (0.0, 4.5)
    assert s.attrs["n_iters"] == 5 and s.attrs["tokens"] == 5
    assert s.attrs["last"] is True          # bools overwrite, never sum
    # a different name in between breaks the run
    tr.add("r2", "decode", 0.0, 1.0, merge=True, tokens=1)
    tr.add("r2", "preempt", 1.0, 1.0)
    tr.add("r2", "decode", 2.0, 3.0, merge=True, tokens=1)
    assert [s.name for s in tr.pop("r2")] == ["decode", "preempt", "decode"]


def test_tracer_disabled_is_falsy_noop():
    tr = Tracer(enabled=False)
    assert not tr
    tr.begin("r1", "queue")
    tr.end("r1", "queue")
    tr.add("r1", "x", 0.0, 1.0)
    tr.event("r1", "y")
    assert tr.pop("r1") == [] and len(tr) == 0


def test_tracer_bounds_spans_and_requests():
    tr = Tracer(max_spans=4, max_requests=2)
    for i in range(10):
        tr.add("r1", f"s{i}", 0.0, 1.0)
    assert len(tr.peek("r1")) == 4 and tr.dropped_spans == 6
    tr.add("r2", "a", 0.0, 1.0)
    tr.add("r3", "a", 0.0, 1.0)          # evicts r1 (oldest)
    assert len(tr) == 2 and tr.evicted_requests == 1
    assert tr.peek("r1") == [] and tr.peek("r3")


def test_tracer_pop_removes_open_spans():
    tr = Tracer()
    tr.begin("r1", "queue")
    tr.add("r1", "route", 0.0, 1.0)
    spans = tr.pop("r1")
    assert [s.name for s in spans] == ["route"]    # open span dropped
    tr.end("r1", "queue")                          # stale end: no-op
    assert tr.peek("r1") == []


def test_spans_to_dicts():
    d = spans_to_dicts([Span("x", 1.0, 2.0, {"k": 3})])
    assert d == [{"name": "x", "t0": 1.0, "t1": 2.0, "attrs": {"k": 3}}]
    json.dumps(d)                                   # JSONL-exportable


# -------------------------------------------------------------------- sink
def test_sink_concurrent_writers_no_torn_lines(tmp_path):
    path = str(tmp_path / "m.jsonl")
    sink = MetricsSink(path=path)
    n_threads, n_each = 8, 50
    stop = threading.Event()

    def writer(t):
        for i in range(n_each):
            sink.incr("ops")
            sink.record("probe", thread=t, i=i, payload="x" * 64)

    def flusher():
        while not stop.is_set():
            sink.flush()

    fl = threading.Thread(target=flusher)
    fl.start()
    threads = [threading.Thread(target=writer, args=(t,)) for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    stop.set()
    fl.join()
    sink.close()
    lines = open(path, "rb").read().splitlines()
    assert len(lines) == n_threads * n_each
    seen = set()
    for line in lines:
        rec = json.loads(line)                     # every line parses whole
        assert rec["kind"] == "probe"
        seen.add((rec["thread"], rec["i"]))
    assert len(seen) == n_threads * n_each          # none lost or duplicated
    assert sink.snapshot()["ops"] == n_threads * n_each


def test_sink_autoflush_and_idempotent_close(tmp_path):
    path = str(tmp_path / "auto.jsonl")
    sink = MetricsSink(path=path, flush_interval_s=0.02)
    sink.record("tick", i=1)
    deadline = time.time() + 2.0
    while time.time() < deadline:                  # reaches disk with no flush()
        try:
            if open(path).read().strip():
                break
        except FileNotFoundError:
            pass
        time.sleep(0.01)
    assert json.loads(open(path).read().splitlines()[0])["kind"] == "tick"
    sink.record("tock", i=2)
    assert sink.close() >= 0
    assert sink.close() == 0                       # idempotent
    assert not sink._flusher.is_alive()
    kinds = [json.loads(x)["kind"] for x in open(path).read().splitlines()]
    assert kinds == ["tick", "tock"]


def test_record_engine_gauge_semantics(tmp_path):
    sink = MetricsSink()
    sink.record_engine("e0", {"cow_copies": 3, "hit_rate": 0.5})
    sink.record_engine("e0", {"cow_copies": 7, "hit_rate": 0.25})
    snap = sink.snapshot()
    # cumulative engine counters are gauges: last value wins, never summed
    assert snap["engine.cow_copies"] == 7.0
    assert snap["engine.hit_rate"] == 0.25


def test_record_trace_roundtrip(tmp_path):
    path = str(tmp_path / "t.jsonl")
    sink = MetricsSink(path=path)
    r = Request(req_id="r1", prompt_tokens=np.arange(4, dtype=np.int32))
    r.t0, r.t4, r.t6 = 1.0, 1.5, 2.0
    r.generated = [1, 2, 3]
    sink.record_trace(r, [Span("queue", 1.1, 1.2, {"cached_tokens": 0})])
    sink.close()
    rec = json.loads(open(path).read())
    assert rec["kind"] == "trace" and rec["req_id"] == "r1"
    assert rec["n_generated"] == 3
    assert rec["spans"][0]["name"] == "queue"


# ------------------------------------------------------- tbt unit contract
def test_tbt_is_seconds_per_token():
    r = Request(req_id="r", prompt_tokens=np.arange(4, dtype=np.int32))
    r.t0, r.t4, r.t5 = 0.0, 0.5, 0.5
    r.t6 = 0.5 + 9 * 0.020                         # 10 tokens, 20ms apart
    r.generated = list(range(10))
    r.finished = True
    m = request_metrics(r)
    # TBT = (t6 - t5) / (Ng - 1) in SECONDS per token (docstring contract):
    # 20ms gaps must read as 0.02, not 20.
    assert m.tbt == pytest.approx(0.020)
    assert m.ttft == pytest.approx(0.5)


# --------------------------------------------------------------- histogram
def test_log_histogram_percentiles():
    h = LogHistogram()
    vals = [0.001 * (i + 1) for i in range(1000)]   # 1ms .. 1s uniform
    for v in vals:
        h.record(v)
    assert h.percentile(0) == pytest.approx(0.001)
    assert h.percentile(100) == pytest.approx(1.0)
    for p in (50, 90, 99):
        exact = vals[int(p / 100 * len(vals)) - 1]
        assert h.percentile(p) == pytest.approx(exact, rel=0.15)
    assert h.mean() == pytest.approx(sum(vals) / len(vals))


def test_log_histogram_underflow_and_merge():
    h = LogHistogram()
    h.record(0.0)                # below min_value: underflow bucket, but the
    assert h.percentile(50) == 0.0   # clamp to tracked min/max makes it exact
    other = LogHistogram()
    other.record(1.0)
    h.merge(other)
    assert h.count == 2 and h.percentile(100) == 1.0


# --------------------------------------------------------------- aggregator
def _step(step, t0, t1, **kw):
    base = dict(step=step, t0=t0, t1=t1, budget=64, tokens_packed=32,
                n_admitted=0, prefill_rows=0, prefill_tokens=0, decode_rows=8,
                decode_tokens=32, drafted_tokens=0, accepted_tokens=0,
                occupancy=8, max_slots=8, queue_depth=2, kv_free_pages=50,
                kv_total_pages=100, preemptions=0, cow_pages=0)
    base.update(kw)
    return StepRecord(**base)


def _req(req_id, t0, ttft_s, n_tokens, tbt_s):
    r = Request(req_id=req_id, prompt_tokens=np.arange(4, dtype=np.int32))
    r.t0, r.t1, r.t2 = t0, t0 + 0.001, t0 + 0.011
    r.t4 = r.t5 = t0 + ttft_s
    r.t6 = r.t5 + (n_tokens - 1) * tbt_s
    r.t3 = r.t6
    r.generated = list(range(n_tokens))
    r.finished = True
    return r


def test_timeline_windows_and_slo():
    agg = TimelineAggregator(window_s=1.0,
                             slo=SLOConfig(ttft_target_s=0.5, tbt_target_s=0.05))
    agg.add_steps([_step(0, 100.0, 100.1), _step(1, 100.5, 100.6),
                   _step(2, 101.2, 101.3, queue_depth=5, preemptions=1)])
    agg.add_request(_req("ok", 100.0, ttft_s=0.1, n_tokens=11, tbt_s=0.01))
    agg.add_request(_req("slow-ttft", 100.0, ttft_s=0.9, n_tokens=11,
                         tbt_s=0.01))
    agg.add_request(_req("slow-tbt", 101.0, ttft_s=0.1, n_tokens=11,
                         tbt_s=0.2))
    tl = agg.timeline()
    # origin = 100.1 (first ingested timestamp). Steps land in windows 0/0/1;
    # completions at t6 = 100.2, 101.0 (window 0) and 103.1 (window 3).
    assert [w["t"] for w in tl] == [0.0, 1.0, 3.0]
    w0 = tl[0]
    assert w0["steps"] == 2 and w0["throughput_tok_s"] == pytest.approx(64.0)
    assert w0["queue_depth_max"] == 2
    assert w0["kv_util_mean"] == pytest.approx(0.5)
    assert w0["occupancy_frac"] == pytest.approx(1.0)
    assert w0["budget_util"] == pytest.approx(0.5)
    # both completions land in window 0 (t6 ≈ 100.2 / 101.0): one attains
    assert w0["completed"] == 2 and w0["slo_attainment"] == pytest.approx(0.5)
    assert w0["p50_queue_wait_s"] == pytest.approx(0.01, rel=0.2)
    w1 = tl[1]
    assert w1["preemptions_per_s"] == pytest.approx(1.0)
    assert w1["queue_depth_max"] == 5
    w3 = tl[2]
    assert w3["completed"] == 1 and w3["slo_attainment"] == 0.0
    assert w3["ttft_ok_frac"] == 1.0 and w3["tbt_ok_frac"] == 0.0
    s = agg.summary()
    assert s["n_requests"] == 3 and s["n_steps"] == 3
    assert s["slo_attainment"] == pytest.approx(1 / 3)
    assert s["p50_ttft_s"] == pytest.approx(0.1, rel=0.2)


def test_timeline_empty_summary():
    agg = TimelineAggregator()
    assert agg.timeline() == []
    s = agg.summary()
    assert s["n_requests"] == 0 and s["slo_attainment"] is None
    assert s["throughput_tok_s"] == 0.0


# ------------------------------------------------------ against the reference
def _filled_aggregators():
    """One set of steps and requests, fed to the port's aggregator and to
    the reference's (each with its own StepRecord / Request types)."""
    from repro.core import metrics as ref_metrics
    from repro.core import timeline as ref_timeline

    def fill(tl_mod, req_cls, step_cls):
        agg = tl_mod.TimelineAggregator(
            window_s=1.0, slo=tl_mod.SLOConfig(ttft_target_s=0.5, tbt_target_s=0.05))
        rng = np.random.default_rng(11)
        t = 100.0
        for i in range(40):
            t += float(rng.uniform(0.01, 0.2))
            base = dict(step=i, t0=t, t1=t + 0.05, budget=64,
                        tokens_packed=int(rng.integers(1, 64)), n_admitted=int(i % 3 == 0),
                        prefill_rows=int(i % 4 == 0), prefill_tokens=int(rng.integers(0, 32)),
                        decode_rows=8, decode_tokens=int(rng.integers(0, 8)),
                        drafted_tokens=0, accepted_tokens=0, occupancy=int(rng.integers(0, 9)),
                        max_slots=8, queue_depth=int(rng.integers(0, 6)),
                        kv_free_pages=int(rng.integers(0, 100)), kv_total_pages=100,
                        preemptions=int(rng.integers(0, 2)), cow_pages=int(rng.integers(0, 3)))
            agg.add_steps([step_cls(**base)])
        for i in range(25):
            r = req_cls(req_id=f"r{i}", prompt_tokens=np.arange(4, dtype=np.int32))
            t0 = 100.0 + float(rng.uniform(0, 8))
            r.t0, r.t1, r.t2 = t0, t0 + 0.001, t0 + float(rng.uniform(0.002, 0.05))
            r.t4 = r.t5 = t0 + float(rng.uniform(0.05, 0.9))
            n = int(rng.integers(2, 30))
            r.t6 = r.t5 + (n - 1) * float(rng.uniform(0.005, 0.1))
            r.t3 = r.t6
            r.generated = list(range(n))
            r.finished = True
            agg.add_request(r)
        return agg

    from repro_torch.core import timeline as port_timeline
    return (fill(port_timeline, Request, StepRecord),
            fill(ref_timeline, ref_metrics.Request, ref_timeline.StepRecord))


def test_timeline_and_dashboard_equal_reference():
    """The copied host modules give the reference's windows, summary,
    metrics and rendered dashboard (HTML and markdown) on the same data."""
    from repro.core import dashboard as ref_dashboard
    from repro.core.metrics import Request as RefRequest
    from repro.core.metrics import request_metrics as ref_request_metrics
    from repro_torch.core import dashboard
    port, ref = _filled_aggregators()
    assert port.timeline() == ref.timeline()
    assert port.summary() == ref.summary()
    tl, summary = port.timeline(), port.summary()
    assert dashboard.render_markdown(tl, summary) == ref_dashboard.render_markdown(tl, summary)
    assert dashboard.render_dashboard(tl, summary) == ref_dashboard.render_dashboard(tl, summary)
    r, q = _req("m", 1.0, 0.3, 12, 0.02), RefRequest(req_id="m", prompt_tokens=np.arange(4))
    for k in ("t0", "t1", "t2", "t3", "t4", "t5", "t6", "generated", "finished"):
        setattr(q, k, getattr(r, k))
    assert request_metrics(r).__dict__ == ref_request_metrics(q).__dict__
