"""The port's fault injection, automatic failure detection and graceful
degradation, as tests/test_faults.py holds the reference's: deterministic
fault plans, the router's health monitor turning injected crashes/stalls into
automatic failover, the transient-submit retry budget, the hedge-timer leak
regression, orphan-drop terminal events, load shedding, and the brown-out
hysteresis controller.

Most use a FakeEngine so they run fast and deterministically; the port's own
engine then takes the injector's per-step hook (slow steps, KV page
pressure), the host-overhead knob and the step fence, and goes through a
crash + cancel + failover without leaking a page (the reference holds that
last one in tests/test_kv_cache.py).
"""
import asyncio
import threading
import time

import numpy as np

from repro_torch.core import (FaultInjector, FaultPlan, Gateway, GatewayConfig,
                        PagedAllocator, Replica, ReplicaRouter, RouterConfig,
                        TransientSubmitError)
from repro_torch.core.client import merge_engine_timestamps, run_workload
from repro_torch.core.engine import TokenEvent
from repro_torch.core.metrics import Request, now


class FakeEngine:
    """Minimal engine contract for Replica: one token per active request per
    step, finishing at max_new_tokens. ``step_sleep`` makes generations take
    wall time so faults can land mid-stream."""

    def __init__(self, step_sleep: float = 0.0):
        self.step_sleep = step_sleep
        self.active = {}
        self.injector = None
        self.fault_key = None
        self.degraded = False
        self.step_records = []

    def submit(self, req):
        self.active[req.req_id] = req

    def cancel(self, rid):
        self.active.pop(rid, None)

    def has_work(self):
        return bool(self.active)

    def step(self):
        if self.injector is not None:
            self.injector.on_engine_step(self)
        if self.step_sleep:
            time.sleep(self.step_sleep)
        events = []
        for rid in list(self.active):
            req = self.active[rid]
            req.generated.append(len(req.generated) + 1)
            t = now()
            fin = len(req.generated) >= req.max_new_tokens
            if fin:
                req.finished = True
                req.t3 = t
                del self.active[rid]
            events.append(TokenEvent(req, req.generated[-1], t, fin))
        return events

    def stats(self):
        return {}


def _req(rid="r", max_new=4):
    return Request(req_id=rid, prompt_tokens=np.arange(1, 4, dtype=np.int32),
                   max_new_tokens=max_new)


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pred(), "condition not reached before timeout"


# --------------------------------------------------------------- plan/injector
def test_coin_deterministic_across_injectors():
    a = FaultInjector(FaultPlan(seed=7))
    b = FaultInjector(FaultPlan(seed=7))
    assert a._coin("submit", "req-1", 0) == b._coin("submit", "req-1", 0)
    c = FaultInjector(FaultPlan(seed=8))
    assert a._coin("submit", "req-1", 0) != c._coin("submit", "req-1", 0)
    # independent of evaluation order
    x = a._coin("submit", "req-2", 3)
    assert a._coin("submit", "req-2", 3) == x


def test_plan_windows_and_single_shot_crash():
    t = {"v": 0.0}
    inj = FaultInjector(FaultPlan().stall("r", 1.0, 2.0).crash("r", 5.0),
                        clock=lambda: t["v"]).start()
    assert inj.replica_action("r") is None
    assert inj.replica_action("other") is None
    t["v"] = 1.5
    kind, remaining = inj.replica_action("r")
    assert kind == "stall" and abs(remaining - 1.5) < 1e-9
    t["v"] = 3.5                        # stall window closed
    assert inj.replica_action("r") is None
    t["v"] = 5.0
    assert inj.replica_action("r") == ("crash", 0.0)
    assert inj.replica_action("r") is None      # crash fires exactly once
    assert inj.injected["crash"] == 1


def test_kv_pressure_hold_and_release():
    t = {"v": 0.5}
    inj = FaultInjector(FaultPlan().kv_pressure("r", 0.0, 1.0, pages=5),
                        clock=lambda: t["v"]).start()
    eng = FakeEngine()
    eng.fault_key = "r"
    eng.allocator = PagedAllocator(num_pages=16, page_size=8,
                                   max_pages_per_seq=8)
    inj.on_engine_step(eng)
    assert eng.allocator.held_pages(FaultInjector.HOLD_KEY) == 5
    eng.allocator.check_invariants()
    t["v"] = 2.0                        # window closed: hold returned
    inj.on_engine_step(eng)
    assert eng.allocator.held_pages(FaultInjector.HOLD_KEY) == 0
    assert eng.allocator.live_pages == 0
    eng.allocator.check_invariants()


def test_submit_error_coin_respects_prob():
    inj = FaultInjector(FaultPlan(seed=3).submit_error(0.0, 100.0, prob=1.0),
                        clock=lambda: 1.0).start()
    try:
        inj.on_submit("r0", "req-1", 0)
        raise AssertionError("expected TransientSubmitError")
    except TransientSubmitError:
        pass
    inj2 = FaultInjector(FaultPlan(seed=3).submit_error(0.0, 100.0, prob=0.0),
                         clock=lambda: 1.0).start()
    inj2.on_submit("r0", "req-1", 0)    # prob 0: never fires


# --------------------------------------------------------------- auto failover
def test_crash_detected_and_failed_over_automatically():
    inj = FaultInjector(FaultPlan().crash("c0", 0.05)).start()
    r0 = Replica("c0", FakeEngine(step_sleep=0.01), injector=inj).start()
    r1 = Replica("c1", FakeEngine()).start()
    router = ReplicaRouter([r0, r1], RouterConfig(monitor_interval_s=0.01))
    router.start_monitor()
    done = {}

    def on_event(ev):
        if ev.finished:
            done["req"] = ev.request

    router.submit(_req("x", max_new=200), on_event, replica=r0)
    _wait(lambda: "req" in done)
    router.stop_monitor()
    r0.stop()
    r1.stop()
    assert r0.crashed and not r0.healthy
    assert done["req"].error is None
    assert len(done["req"].generated) == 200
    assert router.auto_failovers == 1 and router.manual_failovers == 0
    assert [e.reason for e in router.failover_events] == ["crash"]
    assert router.failover_events[0].latency_s >= 0.0


def test_stall_detected_by_watchdog_and_failed_over():
    inj = FaultInjector(FaultPlan().stall("s0", 0.0, 30.0)).start()
    r0 = Replica("s0", FakeEngine(), injector=inj, step_watchdog_s=0.05).start()
    r1 = Replica("s1", FakeEngine()).start()
    router = ReplicaRouter([r0, r1], RouterConfig(monitor_interval_s=0.01))
    router.start_monitor()
    done = {}

    def on_event(ev):
        if ev.finished:
            done["req"] = ev.request

    # lands in the stalled replica's inbox and is never drained — the
    # watchdog must treat undrained submissions as work
    router.submit(_req("y", max_new=5), on_event, replica=r0)
    _wait(lambda: "req" in done)
    router.stop_monitor()
    r0.stop()
    r1.stop()
    assert done["req"].error is None and len(done["req"].generated) == 5
    assert router.auto_failovers == 1 and router.manual_failovers == 0
    assert [e.reason for e in router.failover_events] == ["stall"]


def test_orphans_get_terminal_event_when_no_replica_left():
    r0 = Replica("o0", FakeEngine(step_sleep=0.05)).start()
    router = ReplicaRouter([r0])
    done = {}

    def on_event(ev):
        if ev.finished:
            done["req"] = ev.request

    router.submit(_req("z", max_new=1000), on_event, replica=r0)
    time.sleep(0.1)                     # in flight on the only replica
    n = router.handle_failure(r0)
    assert n == 0                       # nothing re-dispatched...
    assert "req" in done                # ...but the client saw a terminal
    assert done["req"].error == "no replica for failover"
    assert router.sink.snapshot().get("failover_dropped") == 1
    assert router.manual_failovers == 1


# --------------------------------------------------------------- retry budget
def test_transient_submit_errors_retried_to_success():
    inj = FaultInjector(FaultPlan().submit_error(0.0, 0.1, prob=1.0)).start()
    r0 = Replica("t0", FakeEngine()).start()
    router = ReplicaRouter(
        [r0], RouterConfig(retry_budget=10, retry_backoff_s=0.02),
        injector=inj)
    done = {}

    def on_event(ev):
        if ev.finished:
            done["req"] = ev.request

    req = _req("t", max_new=3)
    router.submit(req, on_event)        # backoff outlasts the 0.1 s window
    _wait(lambda: "req" in done)
    r0.stop()
    assert done["req"].error is None and len(done["req"].generated) == 3
    assert req.retries >= 1
    assert router.sink.snapshot().get("retries", 0) >= 1
    assert inj.injected["submit_error"] >= 1


def test_retry_budget_exhaustion_is_terminal_not_a_hang():
    inj = FaultInjector(FaultPlan().submit_error(0.0, 300.0, prob=1.0)).start()
    r0 = Replica("e0", FakeEngine()).start()
    router = ReplicaRouter(
        [r0], RouterConfig(retry_budget=2, retry_backoff_s=0.001),
        injector=inj)
    done = {}

    def on_event(ev):
        if ev.finished:
            done["req"] = ev.request

    router.submit(_req("e", max_new=3), on_event)
    r0.stop()
    assert "req" in done
    assert done["req"].error.startswith("submit failed after")
    assert router.sink.snapshot().get("retry_exhausted") == 1
    assert router._req_state == {}      # accounting closed out


# --------------------------------------------------------------- hedge timer
def test_hedge_timer_cancelled_when_request_finishes_first():
    # regression: a request finishing before hedge_after_s used to leave a
    # live threading.Timer (and its _req_state) behind for every request
    timers_before = sum(isinstance(t, threading.Timer)
                        for t in threading.enumerate())
    r0 = Replica("h0", FakeEngine()).start()
    r1 = Replica("h1", FakeEngine()).start()
    router = ReplicaRouter([r0, r1],
                           RouterConfig(hedge_after_s=30.0))
    done = {}

    def on_event(ev):
        if ev.finished:
            done["req"] = ev.request

    router.submit(_req("h", max_new=2), on_event)
    _wait(lambda: "req" in done)
    _wait(lambda: router._req_state == {})
    _wait(lambda: sum(isinstance(t, threading.Timer)
                      for t in threading.enumerate()) <= timers_before)
    r0.stop()
    r1.stop()
    assert router.sink.snapshot().get("hedges", 0) == 0


# --------------------------------------------------------------- degradation
def test_gateway_sheds_over_admission_bound():
    async def main():
        r0 = Replica("g0", FakeEngine(step_sleep=0.02)).start()
        router = ReplicaRouter([r0])
        gw = Gateway(router, GatewayConfig(max_inflight=1))
        prompts = [np.arange(1, 6, dtype=np.int32)] * 4
        res = await run_workload(gw, prompts, concurrency=4,
                                 max_new_tokens=30, timeout_s=30.0,
                                 arrivals=[0.0, 0.02, 0.04, 0.06])
        merge_engine_timestamps(res.requests, gw)
        r0.stop()
        return res, gw

    res, gw = asyncio.run(main())
    shed = [r for r in res.requests if r.error == "shed"]
    ok = [r for r in res.requests if r.error is None and r.finished]
    assert len(shed) >= 1               # overflow answered immediately...
    assert len(ok) >= 1                 # ...while admitted work completes
    assert gw.inflight_max <= 1
    assert gw.sink.snapshot().get("shed", 0) == len(shed)


def test_brownout_hysteresis_and_degraded_broadcast():
    eng = FakeEngine()
    r0 = Replica("b0", eng)             # thread never started: state-only
    router = ReplicaRouter([r0])
    gw = Gateway(router, GatewayConfig(brownout_high=2, brownout_low=1,
                                       brownout_sustain_s=1.0,
                                       brownout_recover_s=2.0))
    gw._inflight = 3
    gw._update_brownout(100.0)          # overload observed...
    gw._update_brownout(100.5)          # ...but not yet sustained
    assert not gw.brownout
    gw._update_brownout(101.1)          # sustained past brownout_sustain_s
    assert gw.brownout and eng.degraded
    assert gw.brownout_activations == 1
    gw._inflight = 0
    gw._update_brownout(101.2)          # calm observed...
    gw._update_brownout(102.0)          # ...but not yet sustained
    assert gw.brownout
    gw._update_brownout(103.3)          # sustained past brownout_recover_s
    assert not gw.brownout and not eng.degraded
    s = gw.sink.snapshot()
    assert s.get("brownout_on") == 1 and s.get("brownout_off") == 1


def test_brownout_blip_below_sustain_never_arms():
    r0 = Replica("b1", FakeEngine())
    gw = Gateway(ReplicaRouter([r0]),
                 GatewayConfig(brownout_high=2, brownout_low=1,
                               brownout_sustain_s=1.0))
    gw._inflight = 5
    gw._update_brownout(10.0)
    gw._inflight = 0                    # blip over the watermark, then calm
    gw._update_brownout(10.5)
    gw._inflight = 5
    gw._update_brownout(11.2)           # over again, but the clock restarted
    assert not gw.brownout and gw.brownout_activations == 0


# --------------------------------------------------------------- real engine
def _engine(**kw):
    from repro_torch.configs import tiny_config
    from repro_torch.core import EngineConfig, InferenceEngine
    from repro_torch.models import build_model
    model = build_model(tiny_config("qwen2.5-3b"))
    ekw = dict(max_slots=4, page_size=8, num_pages=128, max_seq=128, prefill_chunk=16,
               greedy=True, device="cpu")
    ekw.update(kw)
    return InferenceEngine(model, model.init_params(0, device="cpu"), EngineConfig(**ekw))


def _prompts(n, length=12, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, length).astype(np.int32) for _ in range(n)]


def test_engine_step_runs_the_injectors_hooks():
    """A replica wires its injector into the port's engine: each step then
    holds the planned KV pages out of the pool and sleeps the slow window,
    and the hold is returned once the window closes."""
    t = {"v": 0.5}
    inj = FaultInjector(FaultPlan().kv_pressure("k0", 0.0, 1.0, pages=5)
                        .slow("k0", 0.0, 1.0, factor=1.0, delay_s=0.01),
                        clock=lambda: t["v"]).start()
    eng = _engine()
    Replica("k0", eng, injector=inj)             # wiring only: no thread
    assert eng.injector is inj and eng.fault_key == "k0"
    eng.submit(Request(req_id="a", prompt_tokens=_prompts(1)[0], max_new_tokens=4))
    eng.step()
    assert eng.allocator.held_pages(FaultInjector.HOLD_KEY) == 5
    assert inj.injected["slow_steps"] == 1 and inj.injected["kv_pressure"] == 1
    eng.allocator.check_invariants()
    t["v"] = 2.0                                 # both windows closed
    while eng.has_work():
        eng.step()
    assert eng.allocator.held_pages(FaultInjector.HOLD_KEY) == 0
    assert inj.injected["slow_steps"] == 1
    assert eng.allocator.live_pages == 0
    eng.allocator.check_invariants()


def test_engine_host_overhead_fence_and_degraded_flag():
    """host_overhead_s sleeps once a step (the baseline endpoints'
    emulation); profile_fence is a no-op on the CPU; the gateway's brown-out
    reaches the engine's ``degraded`` flag through the replica."""
    eng = _engine(host_overhead_s=0.02, profile_fence=True)
    eng.generate([Request(req_id="h", prompt_tokens=_prompts(1)[0], max_new_tokens=3)])
    recs = list(eng.step_records)
    assert len(recs) == eng.steps >= 2
    assert all(r.duration >= 0.02 for r in recs)
    rep = Replica("d0", eng)
    assert not eng.degraded
    ReplicaRouter([rep]).set_degraded(True)
    assert eng.degraded
    rep.set_degraded(False)
    assert not eng.degraded


def test_crash_cancel_failover_leaks_nothing():
    """The port's engines under a crash, two cancels and the failover: every
    live request finishes with its tokens, nothing is delivered after a
    terminal event, and both allocators drain."""
    inj = FaultInjector(FaultPlan().crash("x0", 0.25)).start()
    r0 = Replica("x0", _engine(), injector=inj).start()
    r1 = Replica("x1", _engine()).start()
    router = ReplicaRouter([r0, r1], RouterConfig(policy="round_robin",
                                                  monitor_interval_s=0.01))
    router.start_monitor()
    events = {}                  # rid -> [finished flags, in delivery order]
    lock = threading.Lock()

    def on_event(ev):
        with lock:
            events.setdefault(ev.request.req_id, []).append(ev.finished)

    reqs, targets = [], []
    try:
        for i, p in enumerate(_prompts(6)):
            req = Request(req_id=f"cc{i}", prompt_tokens=p, max_new_tokens=48)
            reqs.append(req)
            targets.append(router.submit(req, on_event))
        time.sleep(0.1)
        cancelled = set()
        for req, target in zip(reqs, targets):
            if target.replica_id == "x1" and len(cancelled) < 2:
                target.cancel(req.req_id)
                cancelled.add(req.req_id)
        live = [r for r in reqs if r.req_id not in cancelled]
        _wait(lambda: all(r.finished for r in live), timeout=60.0)
    finally:
        router.stop_monitor()
        for r in (r0, r1):
            r.stop()
    assert all(r.error is None and len(r.generated) == 48 for r in live)
    assert router.auto_failovers == 1 and router.manual_failovers == 0
    assert [e.reason for e in router.failover_events] == ["crash"]
    for rid, flags in events.items():
        if True in flags:
            assert flags.index(True) == len(flags) - 1, f"{rid}: events after its terminal"
    for r in (r0, r1):
        r.engine.allocator.check_invariants()
        assert r.engine.allocator.live_pages == 0, f"{r.replica_id} leaked pages"
