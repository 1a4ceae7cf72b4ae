"""End-to-end behaviour of the port's serving system, as tests/test_system.py
holds the reference's: the full gateway -> router -> replicas ->
continuous-batching engine path with real streaming, plus the
observability/metrics pipeline. Tiny mixtral in fp32 on the CPU, on the JAX
package's weights: every request's greedy stream through the stack equals
the JAX engine's for the same prompt, under both gateway configs and through
a mid-run failover. Then the serving launcher."""
import asyncio
import contextlib
import json
import os
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.configs import tiny_config as jax_tiny_config
from repro.core.engine import EngineConfig as JaxEngineConfig
from repro.core.engine import InferenceEngine as JaxInferenceEngine
from repro.core.metrics import Request as JaxRequest
from repro.models import build_model as jax_build_model
from repro_torch.configs import tiny_config
from repro_torch.core import (EngineConfig, Gateway, InferenceEngine, MetricsSink,
                              Replica, ReplicaRouter, RouterConfig,
                              baseline_gateway_config, scale_gateway_config, summarize)
from repro_torch.core.client import merge_engine_timestamps, run_workload
from repro_torch.data.workload import WorkloadSpec, sample_workload
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models.params import params_from_numpy

NAME = "mixtral-8x7b"                  # the paper's model family
ENGINE = dict(max_slots=4, page_size=8, num_pages=128, max_seq=128, prefill_chunk=16,
              greedy=True)
MAX_NEW = 10
GATEWAYS = {"scale": scale_gateway_config, "baseline": baseline_gateway_config}


@pytest.fixture(scope="module")
def stack():
    """Both packages' tiny mixtral on the JAX init, the workload of the
    reference's system test, and the JAX engine's greedy stream per prompt."""
    jmodel = jax_build_model(jax_tiny_config(NAME))
    jp = jmodel.init_params(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    cfg = tiny_config(NAME)
    prompts, _ = sample_workload(WorkloadSpec(n_requests=10, vocab=cfg.vocab, scale=0.05,
                                              seed=7))
    jreqs = [JaxRequest(req_id=f"req-{i}", prompt_tokens=p, max_new_tokens=MAX_NEW)
             for i, p in enumerate(prompts)]
    JaxInferenceEngine(jmodel, jp, JaxEngineConfig(**ENGINE)).generate(jreqs)
    assert all(r.finished and len(r.generated) == MAX_NEW for r in jreqs)
    return cfg, build_model(cfg), params, prompts, {r.req_id: r.generated for r in jreqs}


@contextlib.contextmanager
def _fleet(model, params, n, **kw):
    reps = [Replica(f"r{i}", InferenceEngine(model, params, EngineConfig(
        device="cpu", **{**ENGINE, **kw}))).start() for i in range(n)]
    try:
        yield reps
    finally:
        for r in reps:
            r.stop()


def _serve(model, params, prompts, gw_cfg, *, fail_after=None):
    """Serve ``prompts`` through the gateway onto two least-loaded replicas;
    with ``fail_after``, replica r0 is failed over by hand once the stack
    has streamed that many tokens."""
    partial = []          # tokens each of r0's requests had when it failed

    async def main():
        with _fleet(model, params, 2, host_overhead_s=0.005 if fail_after else 0.0) as reps:
            sink = MetricsSink()
            router = ReplicaRouter(reps, RouterConfig(policy="least_loaded"), sink=sink)
            gw = Gateway(router, gw_cfg)

            async def killer():
                if fail_after is None:
                    return
                while sum(r.n_generated for r in gw.requests.values()) < fail_after:
                    await asyncio.sleep(0.001)
                with reps[0]._lock:
                    partial.extend(len(q.generated) for q, _ in reps[0]._inflight.values())
                router.handle_failure(reps[0])

            res, _ = await asyncio.wait_for(asyncio.gather(
                run_workload(gw, prompts, concurrency=4, max_new_tokens=MAX_NEW,
                             timeout_s=120, extra_params=[{"greedy": True}] * len(prompts)),
                killer()), timeout=300)
            merge_engine_timestamps(res.requests, gw)
            for r in reps:
                r.engine.allocator.check_invariants()
            return res, sink, router, partial

    return asyncio.run(main())


@pytest.mark.parametrize("gw_name", ["scale", "baseline"])
def test_end_to_end_serving_both_gateways(stack, gw_name):
    cfg, model, params, prompts, jax_streams = stack
    res, sink, router, _ = _serve(model, params, prompts, GATEWAYS[gw_name]())
    assert all(r.finished and r.error is None for r in res.requests), gw_name
    assert all(len(r.generated) == MAX_NEW for r in res.requests)
    for r in res.requests:
        assert r.generated == jax_streams[r.req_id], (gw_name, r.req_id)
    assert {r.replica_id for r in res.requests} == {"r0", "r1"}
    assert router.failover_events == []
    s = summarize(res.requests, res.t_start, res.t_end, 4)
    # lifecycle ordering: t0 <= t1 <= t2 <= t4 <= t5 <= t6, t2 <= t3
    for r in res.requests:
        assert r.t0 <= r.t1 <= r.t2 <= r.t4 <= r.t5 <= r.t6
        assert r.t2 <= r.t3 <= r.t6
    assert s.throughput_tok_s > 0
    counters = sink.snapshot()
    assert counters["requests_completed"] == len(res.requests)
    assert counters["tokens_generated"] == sum(r.n_generated for r in res.requests)


@pytest.mark.parametrize("gw_name", ["scale", "baseline"])
def test_failover_streams_equal_jax(stack, gw_name):
    """r0 fails after 20 streamed tokens: its requests re-prefill their
    prompt and partial generation on r1, and every stream still equals the
    JAX engine's."""
    cfg, model, params, prompts, jax_streams = stack
    res, sink, router, partial = _serve(model, params, prompts, GATEWAYS[gw_name](),
                                        fail_after=20)
    (ev,) = router.failover_events
    assert ev.reason == "manual" and ev.n_requests >= 1
    assert any(0 < n < MAX_NEW for n in partial), partial      # resumed mid-stream
    assert all(r.finished and r.error is None for r in res.requests)
    for r in res.requests:
        assert r.generated == jax_streams[r.req_id], (gw_name, r.req_id)
    assert sink.snapshot()["failovers"] == ev.n_requests
    assert router.replicas[1].engine.allocator.live_pages == 0


def test_metrics_persisted_to_disk(stack):
    cfg, model, params, _, _ = stack
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "metrics.jsonl")
        sink = MetricsSink(path)

        async def main():
            with _fleet(model, params, 1, max_slots=2, num_pages=64, max_seq=64) as (rep,):
                router = ReplicaRouter([rep], sink=sink)
                gw = Gateway(router, scale_gateway_config(), sink=sink)
                prompts = [np.arange(1, 9, dtype=np.int32)] * 3
                return await run_workload(gw, prompts, concurrency=3, max_new_tokens=4,
                                          timeout_s=60)

        res = asyncio.run(main())
        assert all(r.finished for r in res.requests)
        n = sink.flush()
        assert n >= 3
        lines = [json.loads(ln) for ln in open(path)]
        assert all(ln["kind"] == "request" for ln in lines)
        assert all("engine_latency" in ln for ln in lines)


@pytest.mark.parametrize("gateway", ["scale", "baseline"])
def test_serve_launcher_on_cpu(gateway, capsys):
    """The serving entry point on the reduced config, on the CPU: every
    request finishes in time and the summary prints as JSON."""
    serve.main(["--device", "cpu", "--arch", NAME, "--requests", "8", "--concurrency", "4",
                "--gateway", gateway])
    out = json.loads(capsys.readouterr().out)
    assert out["device"] == "cpu" and out["gateway"] == gateway
    assert out["throughput_tok_s"] > 0 and out["timeout_frac"] == 0.0
    assert out["mean"]["ttft"] > 0 and out["concurrency"] == 4


def test_serve_launcher_needs_a_card_by_default():
    """Without ``--device`` the launcher runs on the card, and raises
    without one instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--requests", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.build_fleet(NAME, 1)
