"""The port's router + gateway over its own engine, as
tests/test_router_gateway.py holds the reference's: policies, the dynamic
blueprint, failover with mid-stream resume, hedging, auth rejection end to
end. Tiny qwen2.5 in fp32 on the CPU; every wait is bounded."""
import asyncio
import contextlib
import time

import numpy as np
import pytest

from repro_torch.configs import tiny_config
from repro_torch.core import (EngineConfig, Gateway, InferenceEngine, Replica, ReplicaRouter,
                              RouterConfig, baseline_gateway_config, scale_gateway_config)
from repro_torch.core.client import merge_engine_timestamps, run_workload
from repro_torch.core.metrics import Request
from repro_torch.core.safety import Authenticator
from repro_torch.data.workload import WorkloadSpec, sample_workload
from repro_torch.models import build_model


@pytest.fixture(scope="module")
def model_setup():
    cfg = tiny_config("qwen2.5-3b")
    model = build_model(cfg)
    params = model.init_params(0, device="cpu")
    return cfg, model, params


def _replica(model, params, rid, klass="default", **kw):
    ekw = dict(max_slots=4, page_size=8, num_pages=128, max_seq=128,
               prefill_chunk=16, greedy=True, device="cpu")
    ekw.update(kw)
    return Replica(rid, InferenceEngine(model, params, EngineConfig(**ekw)),
                   klass=klass).start()


@contextlib.contextmanager
def _stopping(*replicas):
    try:
        yield replicas
    finally:
        for r in replicas:
            r.stop()


def test_least_loaded_spreads(model_setup):
    cfg, model, params = model_setup
    reps = [_replica(model, params, f"r{i}") for i in range(3)]
    with _stopping(*reps):
        router = ReplicaRouter(reps, RouterConfig(policy="round_robin"))
        seen = {router.select().replica_id for _ in range(6)}
    assert seen == {"r0", "r1", "r2"}


def test_least_loaded_picks_the_lightest():
    """least_loaded reads the synchronous submit-time load counter."""
    class _EngineStub:
        pass

    reps = [Replica(f"l{i}", _EngineStub()) for i in range(3)]      # threads never started
    router = ReplicaRouter(reps, RouterConfig(policy="least_loaded"))
    for i, n in enumerate((2, 0, 1)):
        for j in range(n):
            reps[i].submit(Request(req_id=f"{i}-{j}", prompt_tokens=np.arange(1, 3)),
                           lambda ev: None)
    assert router.select().replica_id == "l1"
    reps[1].submit(Request(req_id="x", prompt_tokens=np.arange(1, 3)), lambda ev: None)
    reps[1].submit(Request(req_id="y", prompt_tokens=np.arange(1, 3)), lambda ev: None)
    assert router.select().replica_id == "l2"


def test_dynamic_blueprint_policy(model_setup):
    """Paper §6: < threshold -> high_tp class; >= threshold -> high_replica."""
    cfg, model, params = model_setup
    tp_rep = _replica(model, params, "bigtp", klass="high_tp")
    small = [_replica(model, params, f"small{i}", klass="high_replica") for i in range(2)]
    with _stopping(tp_rep, *small):
        router = ReplicaRouter([tp_rep] + small,
                               RouterConfig(policy="dynamic", dynamic_threshold=4))
        router._live = 0
        assert router.select().klass == "high_tp"
        router._live = 10
        assert router.select().klass == "high_replica"


def test_kill_surrenders_inbox_requests():
    # a request submitted just before the failure sits in the inbox, not yet
    # moved to the engine: kill() must surrender it with the in-flight ones
    # or the client waits out its full timeout (failover race)
    class _EngineStub:
        pass

    rep = Replica("k0", _EngineStub())       # thread never started
    r = Request(req_id="k", prompt_tokens=np.arange(1, 4, dtype=np.int32))
    rep.submit(r, lambda ev: None)
    orphans = rep.kill()
    assert [o[0].req_id for o in orphans] == ["k"]


def test_failover_resumes_inflight(model_setup):
    """Replica f0 fails once the stack has streamed 8 tokens: its in-flight
    requests resume on f1 with their partial generations and finish."""
    cfg, model, params = model_setup

    async def main():
        reps = [_replica(model, params, f"f{i}", host_overhead_s=0.005) for i in range(2)]
        with _stopping(*reps):
            router = ReplicaRouter(reps, RouterConfig(policy="round_robin"))
            gw = Gateway(router, scale_gateway_config())
            prompts, _ = sample_workload(WorkloadSpec(n_requests=8, vocab=cfg.vocab,
                                                      scale=0.05, seed=2))

            async def killer():
                while sum(r.n_generated for r in gw.requests.values()) < 8:
                    await asyncio.sleep(0.001)
                router.handle_failure(reps[0])

            res, _ = await asyncio.wait_for(asyncio.gather(
                run_workload(gw, prompts, concurrency=4, max_new_tokens=12, timeout_s=60),
                killer()), timeout=120)
            merge_engine_timestamps(res.requests, gw)
        return res, router

    res, router = asyncio.run(main())
    assert all(r.finished and r.error is None for r in res.requests)
    assert all(len(r.generated) == 12 for r in res.requests)
    (ev,) = router.failover_events
    assert ev.reason == "manual" and ev.n_requests >= 1
    assert router.replicas[1].total_completed == len(res.requests) - \
        router.replicas[0].total_completed


@pytest.mark.parametrize("gw_cfg", [scale_gateway_config, baseline_gateway_config],
                         ids=["scale", "baseline"])
def test_cold_burst_spreads_over_replicas(model_setup, gw_cfg):
    """8 requests admitted at once onto two fresh least-loaded replicas: a
    replica chosen for a request counts it while the gateway connects, so
    the burst splits 4 / 4 (instead of piling onto the replica that looked
    idle before any of them was submitted)."""
    cfg, model, params = model_setup

    async def main():
        reps = [_replica(model, params, f"b{i}") for i in range(2)]
        with _stopping(*reps):
            gw = Gateway(ReplicaRouter(reps, RouterConfig(policy="least_loaded")), gw_cfg())
            prompts = [np.arange(1, 8, dtype=np.int32) + i for i in range(8)]
            res = await run_workload(gw, prompts, concurrency=8, max_new_tokens=3,
                                     timeout_s=60)
            merge_engine_timestamps(res.requests, gw)
        return res, reps

    res, reps = asyncio.run(main())
    assert all(r.finished and len(r.generated) == 3 for r in res.requests)
    assert sorted(r.replica_id for r in res.requests) == ["b0"] * 4 + ["b1"] * 4
    assert [r.total_completed for r in reps] == [4, 4]
    assert all(r.load == 0 and r.connecting == 0 for r in reps)


def test_gateway_auth_rejection(model_setup):
    cfg, model, params = model_setup

    async def main():
        rep = _replica(model, params, "a0")
        with _stopping(rep):
            router = ReplicaRouter([rep])
            auth = Authenticator(secret=b"s3cret")
            gw = Gateway(router, scale_gateway_config(), auth=auth, require_auth=True)
            prompts = [np.arange(1, 8, dtype=np.int32)] * 2
            ok = await run_workload(gw, prompts, concurrency=2, max_new_tokens=4,
                                    timeout_s=60, auth_token=auth.issue("bob"))
            bad = await run_workload(gw, prompts, concurrency=2, max_new_tokens=4,
                                     timeout_s=60, auth_token="bob:forged")
        return ok, bad

    ok, bad = asyncio.run(main())
    assert all(r.finished and len(r.generated) == 4 for r in ok.requests)
    assert all(r.error == "rejected" for r in bad.requests)


def test_hedging_straggler(model_setup):
    """A slow replica (large host overhead) gets hedged to a fast one. The
    client sees exactly one stream, the shadow's, even though the slow
    primary's first step finishes while the shadow is streaming. Timing:
    the hedge fires at 0.3 s and the shadow's 8 tokens come about 0.4, 0.5,
    ..., 1.1 s after submission (a 0.1 s host overhead a step); the
    primary's first token comes about 0.75 s in, ~0.35 s after the shadow's
    first and before its last, so two replica threads sharing the CPU with
    other test processes do not reorder them."""
    cfg, model, params = model_setup
    prompt = np.arange(1, 8, dtype=np.int32)
    ref = Request(req_id="ref", prompt_tokens=prompt, max_new_tokens=8)
    InferenceEngine(model, params, EngineConfig(
        max_slots=4, page_size=8, num_pages=128, max_seq=128, prefill_chunk=16,
        greedy=True, device="cpu")).generate([ref])
    slow = _replica(model, params, "slow", host_overhead_s=0.75)
    fast = _replica(model, params, "fast", host_overhead_s=0.1)
    done, delivered = {}, []
    with _stopping(slow, fast):
        router = ReplicaRouter([slow, fast],
                               RouterConfig(policy="round_robin", hedge_after_s=0.3))

        def on_event(ev):
            delivered.append(ev.token)
            if ev.finished:
                done["generated"] = list(ev.request.generated)

        req = Request(req_id="h1", prompt_tokens=prompt, max_new_tokens=8)
        router.submit(req, on_event, replica=slow)       # force primary = slow
        deadline = time.time() + 20
        while "generated" not in done and time.time() < deadline:
            time.sleep(0.05)
    assert "generated" in done
    assert router.sink.snapshot().get("hedges", 0) >= 1
    assert router.sink.snapshot().get("hedge_wins", 0) == 1
    assert delivered == ref.generated
    assert done["generated"] == ref.generated


def test_elastic_add_remove(model_setup):
    cfg, model, params = model_setup
    r0 = _replica(model, params, "e0")
    r1 = _replica(model, params, "e1")
    with _stopping(r0, r1):
        router = ReplicaRouter([r0])
        router.add_replica(r1)
        assert len(router.replicas) == 2
        router.remove_replica("e0")
        assert [r.replica_id for r in router.replicas] == ["e1"]
        assert router.select().replica_id == "e1"
