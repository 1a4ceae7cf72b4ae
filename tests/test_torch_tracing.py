"""The port's end-to-end request tracing + iteration profiling, as
tests/test_tracing.py holds the reference's: span lists must reconcile with
the Figure-4 timestamps, the engine must leave one StepRecord per iteration,
and the open-loop arrival schedule must drive the client (and equal the
reference's schedule). Tiny qwen2.5 in fp32 on the CPU."""
import asyncio
import dataclasses
import json

import numpy as np
import pytest

from repro_torch.configs import tiny_config
from repro_torch.core import (EngineConfig, Gateway, InferenceEngine, MetricsSink,
                        Replica, ReplicaRouter, RouterConfig, Tracer,
                        scale_gateway_config)
from repro_torch.core.client import merge_engine_timestamps, run_workload
from repro_torch.core.metrics import Request
from repro_torch.data.workload import (WorkloadSpec, sample_arrivals,
                                 sample_workload)
from repro_torch.models import build_model

TOL = 0.25                       # CPU-scheduling slack for timestamp checks


@pytest.fixture(scope="module")
def stack():
    cfg = tiny_config("qwen2.5-3b")
    model = build_model(cfg)
    params = model.init_params(0, device="cpu")
    return cfg, model, params


def _engine(model, params, tracer=None, **over):
    kw = dict(max_slots=3, page_size=8, num_pages=64, max_seq=64,
              prefill_chunk=16, greedy=True, device="cpu")
    kw.update(over)
    return InferenceEngine(model, params, EngineConfig(**kw), tracer=tracer)


def _reqs(cfg, n, length=12, max_new=6, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(req_id=f"x{i}",
                    prompt_tokens=rng.integers(1, cfg.vocab, length).astype(np.int32),
                    max_new_tokens=max_new) for i in range(n)]


# ----------------------------------------------------------- engine tracing
def test_engine_spans_cover_serving_path(stack):
    cfg, model, params = stack
    tracer = Tracer()
    eng = _engine(model, params, tracer=tracer)
    reqs = _reqs(cfg, 3)
    eng.generate(reqs)
    for r in reqs:
        spans = tracer.pop(r.req_id)
        names = [s.name for s in spans]
        assert names[0] == "queue"
        assert "prefill_chunk" in names and "decode" in names
        # queue ends at engine admission (Figure-4 t2), within tolerance
        q = spans[0]
        assert abs(q.t1 - r.t2) < TOL
        # prefill chunks account for every uncached prompt token
        fed = sum(s.attrs["n_tokens"] for s in spans
                  if s.name == "prefill_chunk")
        assert fed + q.attrs["cached_tokens"] == len(r.prompt_tokens)
        # decode iterations coalesce: one span, one iter per generated token
        # after the first (the last prefill chunk emits token #1)
        dec = [s for s in spans if s.name == "decode"]
        assert sum(s.attrs["n_iters"] for s in dec) == r.n_generated - 1
        # every span sits inside the engine phase of the request's life
        for s in spans:
            assert s.t0 <= s.t1 + 1e-9
            assert r.t1 - TOL <= s.t0 and s.t1 <= r.t3 + TOL
    assert len(tracer) == 0


def test_engine_cancel_discards_trace(stack):
    cfg, model, params = stack
    tracer = Tracer()
    eng = _engine(model, params, tracer=tracer)
    (r,) = _reqs(cfg, 1, max_new=50)
    eng.submit(r)
    for _ in range(3):
        eng.step()
    assert tracer.peek(r.req_id)
    assert eng.cancel(r.req_id)
    assert tracer.peek(r.req_id) == []


def test_tracing_disabled_records_nothing(stack):
    cfg, model, params = stack
    tracer = Tracer(enabled=False)
    eng = _engine(model, params, tracer=tracer)
    reqs = _reqs(cfg, 2)
    eng.generate(reqs)
    assert all(r.finished for r in reqs)
    assert len(tracer) == 0


# --------------------------------------------------------- step profiling
def test_step_records_one_per_iteration(stack):
    cfg, model, params = stack
    eng = _engine(model, params)
    reqs = _reqs(cfg, 3, max_new=5)
    eng.generate(reqs)
    recs = list(eng.step_records)
    assert len(recs) == eng.steps
    assert [r.step for r in recs] == sorted(r.step for r in recs)
    for rec in recs:
        assert rec.t1 >= rec.t0
        assert 0 <= rec.tokens_packed <= rec.budget
        assert rec.occupancy <= rec.max_slots
        assert 0 <= rec.kv_free_pages <= rec.kv_total_pages
        assert rec.prefill_tokens + rec.decode_tokens <= rec.tokens_packed
    # prefill accounting: every prompt token fed exactly once
    assert (sum(r.prefill_tokens for r in recs)
            == sum(len(r.prompt_tokens) for r in reqs))
    # each request emits token #1 from prefill, the rest from decode
    assert (sum(r.decode_tokens for r in recs)
            == sum(r.n_generated - 1 for r in reqs))


def test_step_profile_disabled_and_ring_cap(stack):
    cfg, model, params = stack
    eng = _engine(model, params, profile_steps=False)
    reqs = _reqs(cfg, 2, max_new=4)
    eng.generate(reqs)
    assert list(eng.step_records) == [] and eng.steps > 0
    eng2 = _engine(model, params, step_records_cap=4)
    reqs2 = _reqs(cfg, 2, max_new=8, seed=1)
    eng2.generate(reqs2)
    recs = list(eng2.step_records)
    assert len(recs) == 4                           # bounded ring
    assert recs[-1].step == eng2.steps              # keeps the newest


# ------------------------------------------------------------ e2e export
def test_gateway_trace_export_figure4_consistency(stack, tmp_path):
    cfg, model, params = stack
    path = str(tmp_path / "traces.jsonl")
    tracer = Tracer()
    sink = MetricsSink(path)
    prompts = [np.random.default_rng(i).integers(1, cfg.vocab, 10 + 3 * i)
               .astype(np.int32) for i in range(5)]

    async def main():
        rep = Replica("t0", _engine(model, params, tracer=tracer,
                                    max_slots=4, num_pages=128,
                                    max_seq=128)).start()
        router = ReplicaRouter([rep], RouterConfig(policy="least_loaded"),
                               sink=sink, tracer=tracer)
        gw = Gateway(router, scale_gateway_config())
        try:
            res = await run_workload(gw, prompts, concurrency=3,
                                     max_new_tokens=6, timeout_s=120)
        finally:
            rep.stop()
        merge_engine_timestamps(res.requests, gw)
        return res

    res = asyncio.run(main())
    assert all(r.finished for r in res.requests)
    sink.close()
    traces = {rec["req_id"]: rec
              for rec in map(json.loads, open(path)) if rec["kind"] == "trace"}
    assert len(traces) == len(prompts)
    assert len(tracer) == 0                        # popped on export
    for r in res.requests:
        rec = traces[r.req_id]
        spans = rec["spans"]
        names = [s["name"] for s in spans]
        for expected in ("gateway_admission", "route", "queue",
                         "prefill_chunk", "decode"):
            assert expected in names, (r.req_id, names)
        # Figure-4 reconciliation: the exported t0..t6 are the request's own,
        # and every span fits the [t1, t6] serving window
        assert rec["t1"] == pytest.approx(r.t1)
        assert rec["n_generated"] == r.n_generated
        for s in spans:
            assert r.t1 - TOL <= s["t0"] <= s["t1"] <= r.t6 + TOL
        q = next(s for s in spans if s["name"] == "queue")
        assert abs(q["t1"] - r.t2) < TOL
        fed = sum(s["attrs"]["n_tokens"] for s in spans
                  if s["name"] == "prefill_chunk")
        assert fed + q["attrs"]["cached_tokens"] == len(r.prompt_tokens)


# ------------------------------------------------------- open-loop arrivals
def test_sample_arrivals_schedule():
    spec = WorkloadSpec(n_requests=400, vocab=100, arrival_rate=50.0,
                        burst_mult=4.0, burst_period_s=1.0, burst_duty=0.25,
                        seed=3)
    arr = sample_arrivals(spec)
    assert len(arr) == 400
    assert arr == sorted(arr) and arr[0] > 0
    # mean rate sits between the base and burst rates
    mean_rate = len(arr) / arr[-1]
    assert 50.0 < mean_rate < 200.0
    # the schedule stream is decoupled from prompt sampling
    p1, o1 = sample_workload(spec)
    p2, o2 = sample_workload(dataclasses.replace(spec, arrival_rate=5.0))
    assert o1 == o2 and all((a == b).all() for a, b in zip(p1, p2))
    # closed loop: no schedule
    assert sample_arrivals(dataclasses.replace(spec, arrival_rate=0.0,
                                               n_requests=7)) == [0.0] * 7


@pytest.mark.parametrize("spec", [
    WorkloadSpec(n_requests=64, vocab=32000, seed=0),
    WorkloadSpec(n_requests=10, vocab=256, scale=0.05, seed=7),
    WorkloadSpec(n_requests=30, vocab=512, scale=0.1, seed=3, shared_prefix_len=32,
                 n_shared_prefixes=2, extractive_frac=0.3, boilerplate_frac=0.3,
                 arrival_rate=20.0, burst_mult=3.0),
], ids=["openorca", "tiny", "shaped"])
def test_workload_equals_reference(spec):
    """One seed draws the same prompts, output lengths and arrivals in both
    packages."""
    from repro.data import workload as ref
    p1, o1 = sample_workload(spec)
    p2, o2 = ref.sample_workload(ref.WorkloadSpec(**dataclasses.asdict(spec)))
    assert o1 == o2 and len(p1) == len(p2)
    assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(p1, p2))
    assert sample_arrivals(spec) == ref.sample_arrivals(
        ref.WorkloadSpec(**dataclasses.asdict(spec)))


def test_open_loop_client(stack):
    cfg, model, params = stack

    async def main():
        rep = Replica("o0", _engine(model, params, max_slots=4,
                                    num_pages=128, max_seq=128)).start()
        router = ReplicaRouter([rep], RouterConfig(policy="least_loaded"))
        gw = Gateway(router, scale_gateway_config())
        prompts = [np.arange(1, 9, dtype=np.int32) + i for i in range(4)]
        arrivals = [0.0, 0.05, 0.10, 0.40]
        try:
            return await run_workload(gw, prompts, concurrency=1,  # ignored
                                      max_new_tokens=4, timeout_s=60,
                                      arrivals=arrivals)
        finally:
            rep.stop()

    res = asyncio.run(main())
    assert all(r.finished for r in res.requests)
    by_id = {r.req_id: r for r in res.requests}
    # each request was submitted no earlier than its scheduled arrival
    t_base = min(r.t0 for r in res.requests)
    for i, off in enumerate([0.0, 0.05, 0.10, 0.40]):
        assert by_id[f"req-{i}"].t0 >= t_base + off - 0.02
