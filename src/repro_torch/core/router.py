"""Replica router: load balancing, failover, straggler hedging, and the §6
dynamic-blueprint policy.

Policies:
  round_robin    cycle through healthy replicas
  least_loaded   min(active + queued)
  dynamic        the paper's blueprint: concurrency < threshold -> route to
                 the "high_tp" replica class (few big replicas, best at small
                 batch); >= threshold -> the "high_replica" class (many small
                 replicas, best at high concurrency). Least-loaded inside the
                 chosen class; falls through to the other class if one is
                 empty/unhealthy.

Fault tolerance:
  - failover: when a replica dies, its in-flight requests (with partial
    generations) are resubmitted to healthy replicas and RESUME mid-stream
    (the engine re-prefills prompt+generated).
  - hedging: if a request produces no first token within ``hedge_after_s``,
    a shadow copy is dispatched to another replica; the first stream to
    produce tokens wins and the loser is cancelled. The loser's events are
    dropped, so the client never sees the two streams interleaved.
"""
from __future__ import annotations

import copy
import hashlib
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


from repro_torch.core.engine import TokenEvent
from repro_torch.core.faults import FaultInjector, TransientSubmitError
from repro_torch.core.metrics import Request, now
from repro_torch.core.observability import MetricsSink, Tracer
from repro_torch.core.replica import OnEvent, Replica


class NoReplicaAvailable(Exception):
    pass


@dataclass
class RouterConfig:
    policy: str = "least_loaded"            # round_robin | least_loaded | dynamic
    dynamic_threshold: int = 64             # paper §6: <64 -> high TP; >=64 -> replicas
    hedge_after_s: Optional[float] = None   # straggler hedging deadline (None = off)
    retry_budget: int = 2                   # transient-submit retries per request
    retry_backoff_s: float = 0.005          # exponential backoff base; kept tiny
                                            # because submit can run on the
                                            # gateway's event-loop thread
    monitor_interval_s: float = 0.05        # health-monitor poll period


@dataclass
class FailoverEvent:
    """One detected replica failure: when, which replica, why (manual |
    crash | stall), how long between the replica's last heartbeat and
    detection, and how many in-flight requests were re-dispatched."""
    t: float
    replica_id: str
    reason: str
    latency_s: float
    n_requests: int = 0
    extra: Dict[str, float] = field(default_factory=dict)


class ReplicaRouter:
    def __init__(self, replicas: List[Replica], cfg: Optional[RouterConfig] = None,
                 sink: Optional[MetricsSink] = None,
                 tracer: Optional[Tracer] = None,
                 injector: Optional[FaultInjector] = None):
        self.replicas = list(replicas)
        self.cfg = cfg or RouterConfig()
        self.sink = sink or MetricsSink()
        self.tracer = tracer
        self.injector = injector             # transient submit-error hook
        self._rr = 0
        self._lock = threading.Lock()
        self._live = 0                       # live concurrency estimate
        self._hedges: Dict[str, dict] = {}
        # per-request delivery state (DESIGN.md §5): terminal guard (no event
        # after the terminal one — retry/failover/hedge never double-deliver),
        # the armed hedge timer (cancelled at terminal: the timer-leak fix),
        # and the shadow to reap when the primary wins.
        self._req_state: Dict[str, dict] = {}
        self._fail_lock = threading.Lock()
        self._failed: set = set()            # replica ids already failed over
        self.failover_events: List[FailoverEvent] = []
        self.manual_failovers = 0
        self.auto_failovers = 0
        self._monitor: Optional[threading.Thread] = None
        self._monitor_stop = threading.Event()

    # ------------------------------------------------------------- selection
    def _healthy(self) -> List[Replica]:
        return [r for r in self.replicas if r.healthy]

    def add_replica(self, replica: Replica) -> None:
        """Elastic scale-out."""
        with self._lock:
            self.replicas.append(replica)

    def remove_replica(self, replica_id: str) -> None:
        """Elastic scale-in (drain is the caller's concern)."""
        with self._lock:
            self.replicas = [r for r in self.replicas if r.replica_id != replica_id]

    def select(self) -> Replica:
        healthy = self._healthy()
        if not healthy:
            raise NoReplicaAvailable("no healthy replicas")
        policy = self.cfg.policy
        if policy == "round_robin":
            with self._lock:
                r = healthy[self._rr % len(healthy)]
                self._rr += 1
            return r
        if policy == "dynamic":
            want = "high_tp" if self._live < self.cfg.dynamic_threshold else "high_replica"
            klass = [r for r in healthy if r.klass == want]
            pool = klass or healthy
            return min(pool, key=lambda r: r.load)
        return min(healthy, key=lambda r: r.load)

    # ------------------------------------------------------------- delivery
    def _deliver(self, rid: str, on_event: OnEvent, ev: TokenEvent) -> None:
        """Terminal-guarded delivery for ``rid``: drops any event after the
        request's terminal event (idempotency across retry, failover, and
        hedging), cancels the hedge timer and reaps the shadow at terminal,
        and closes out router accounting exactly once."""
        timer = shadow = None
        with self._lock:
            st = self._req_state.get(rid)
            if st is None or st["terminal"]:
                return
            st["got_first"] = True
            if ev.finished:
                st["terminal"] = True
                timer = st.get("timer")
                shadow = st.get("shadow")
                self._req_state.pop(rid, None)
                self._live -= 1
        if ev.finished:
            if timer is not None:
                timer.cancel()               # hedge-timer leak fix: a request
                                             # finishing before hedge_after_s
                                             # must not leave a live Timer
            if shadow is not None:
                backup, shadow_id = shadow
                backup.cancel(shadow_id)
            self.sink.record_request(ev.request)
            if self.tracer:
                # the request's span list is complete once its terminal
                # event fires — export through the JSONL sink and drop
                self.sink.record_trace(ev.request, self.tracer.pop(rid))
        on_event(ev)

    @staticmethod
    def _jitter(rid: str, attempt: int) -> float:
        """Deterministic backoff jitter in [0.5, 1.5): a pure hash of
        (req_id, attempt), so retry timing replays under a fixed schedule."""
        h = hashlib.blake2b(f"{rid}:{attempt}".encode(), digest_size=2).digest()
        return 0.5 + int.from_bytes(h, "little") / 65536.0

    # ------------------------------------------------------------- dispatch
    def submit(self, request: Request, on_event: OnEvent,
               replica: Optional[Replica] = None) -> Replica:
        t_route0 = now()
        rid = request.req_id
        tracer = self.tracer
        with self._lock:
            if rid not in self._req_state:
                self._req_state[rid] = {"terminal": False, "got_first": False,
                                        "timer": None, "shadow": None, "winner": None}
                self._live += 1

        def wrapped(ev: TokenEvent) -> None:
            if self._claim(rid, "primary"):
                self._deliver(rid, on_event, ev)

        if replica is None or not replica.healthy:
            replica = self.select()
        # transient submit errors are retried against the budget with
        # exponential backoff + deterministic jitter; exhaustion emits a
        # terminal error event through the guard — a shed, never a hang.
        attempt = 0
        while True:
            try:
                if self.injector is not None:
                    self.injector.on_submit(replica.replica_id, rid, attempt)
                replica.submit(request, wrapped)
                break
            except (TransientSubmitError, RuntimeError, NoReplicaAvailable) as e:
                attempt += 1
                if attempt > self.cfg.retry_budget:
                    request.error = f"submit failed after {attempt} attempts: {e}"
                    request.finished = True
                    self.sink.incr("retry_exhausted")
                    if tracer:
                        tracer.event(rid, "retry_exhausted", attempts=attempt)
                    wrapped(TokenEvent(request, -1, now(), True))
                    return replica
                request.retries += 1
                self.sink.incr("retries")
                if tracer:
                    tracer.event(rid, "retry", attempt=attempt, error=str(e))
                time.sleep(self.cfg.retry_backoff_s * (2 ** (attempt - 1))
                           * self._jitter(rid, attempt))
                try:
                    replica = self.select()
                except NoReplicaAvailable as e2:
                    e = e2               # loop once more; budget decides
        if tracer:
            tracer.add(rid, "route", t_route0, now(),
                       replica=replica.replica_id, policy=self.cfg.policy,
                       attempts=attempt + 1)
        self.sink.incr(f"routed_to.{replica.replica_id}")

        if self.cfg.hedge_after_s is not None:
            timer = threading.Timer(self.cfg.hedge_after_s, self._maybe_hedge,
                                    args=(request, replica, on_event))
            timer.daemon = True
            with self._lock:
                st = self._req_state.get(rid)
                if st is not None and not st["terminal"] and st["timer"] is None:
                    st["timer"] = timer
                else:
                    timer = None         # finished before the timer armed
            if timer is not None:
                timer.start()
        return replica

    # ------------------------------------------------------------- hedging
    def _claim(self, rid: str, stream: str) -> bool:
        """Whether ``stream`` ("primary" | "shadow") may deliver for
        ``rid``: the first stream to deliver owns the request from then on.
        True once the request's state is gone (the terminal guard decides)."""
        with self._lock:
            st = self._req_state.get(rid)
            if st is None:
                return True
            if st["winner"] is None:
                st["winner"] = stream
            return st["winner"] == stream

    def _maybe_hedge(self, request: Request, primary: Replica,
                     on_event: OnEvent) -> None:
        rid = request.req_id
        with self._lock:
            st = self._req_state.get(rid)
            if st is None or st["terminal"] or st["got_first"]:
                return
        if request.finished or not primary.healthy:
            return
        others = [r for r in self._healthy() if r.replica_id != primary.replica_id]
        if not others:
            return
        shadow = copy.deepcopy(request)
        shadow.req_id = rid + "#hedge"
        shadow.hedged = True
        request.hedged = True
        winner_decided = {"v": False}
        self.sink.incr("hedges")
        if self.tracer:
            self.tracer.event(rid, "hedge", primary=primary.replica_id)

        def shadow_events(ev: TokenEvent) -> None:
            if not self._claim(rid, "shadow"):
                backup.cancel(shadow.req_id)  # the primary streamed first
                return
            if not winner_decided["v"]:
                winner_decided["v"] = True
                primary.cancel(rid)
                self.sink.incr("hedge_wins")
            if ev.request.req_id.endswith("#hedge"):
                # merge shadow progress into the primary request object and
                # deliver through the terminal guard (a dead-heat primary
                # terminal and shadow terminal can never both reach the
                # client). A copy, never the shadow's list: a primary step
                # still in flight appends to the primary object, and the
                # next merge overwrites that token.
                request.generated = list(ev.request.generated)
                request.t2, request.t3 = ev.request.t2, ev.request.t3
                request.finished = ev.request.finished
                self._deliver(rid, on_event,
                              TokenEvent(request, ev.token, ev.t_emit, ev.finished))

        backup = min(others, key=lambda r: r.load)
        try:
            backup.submit(shadow, shadow_events)
        except (TransientSubmitError, RuntimeError):
            return                            # hedging is best-effort
        with self._lock:
            st = self._req_state.get(rid)
            if st is None or st["terminal"]:
                # primary finished while we were dispatching: reap the shadow
                backup.cancel(shadow.req_id)
                return
            st["shadow"] = (backup, shadow.req_id)

    # ------------------------------------------------------------- failover
    def handle_failure(self, replica: Replica, reason: str = "manual") -> int:
        """Re-dispatch a dead replica's in-flight requests; returns count.
        Idempotent per replica (monitor sweep and a manual call can race).
        ``reason`` is "manual" | "crash" | "stall" — crash/stall come from
        the automatic detector in :meth:`health_sweep`."""
        with self._fail_lock:
            if replica.replica_id in self._failed:
                return 0
            self._failed.add(replica.replica_id)
        # heartbeat -> detection gap on the replica's own monotonic clock
        latency_s = time.monotonic() - replica.last_step_at
        orphans = replica.kill()
        n = 0
        for req, cb in orphans:
            req.finished = False
            try:
                target = self.select()
            except NoReplicaAvailable:
                # orphan fix: the client must observe a terminal event, not
                # hang until its own timeout
                req.error = "no replica for failover"
                req.finished = True
                self.sink.incr("failover_dropped")
                if self.tracer:
                    self.tracer.event(req.req_id, "failover_dropped",
                                      from_replica=replica.replica_id)
                cb(TokenEvent(req, -1, now(), True))
                continue
            target.submit(req, cb)
            self.sink.incr("failovers")
            if self.tracer:
                self.tracer.event(req.req_id, "failover",
                                  from_replica=replica.replica_id,
                                  to_replica=target.replica_id, reason=reason)
            n += 1
        if reason == "manual":
            self.manual_failovers += 1
        else:
            self.auto_failovers += 1
        self.sink.incr(f"failover_{reason}")
        self.sink.observe("failover_latency_s", latency_s)
        with self._lock:
            self.failover_events.append(FailoverEvent(
                t=now(), replica_id=replica.replica_id, reason=reason,
                latency_s=latency_s, n_requests=n))
        return n

    def health_sweep(self) -> List[str]:
        """Automatic failure detection (DESIGN.md §5): a dead serving thread
        is a crash, an expired step watchdog is a stall; both fail over
        without manual intervention."""
        failed = []
        for r in list(self.replicas):
            if not r.healthy:
                continue
            if getattr(r, "thread_dead", lambda: False)():
                self.handle_failure(r, reason="crash")
                failed.append(r.replica_id)
            elif r.watchdog_expired():
                self.handle_failure(r, reason="stall")
                failed.append(r.replica_id)
        return failed

    def start_monitor(self, interval_s: Optional[float] = None) -> None:
        """Spawn the health-monitor thread: a periodic :meth:`health_sweep`
        turning watchdog expiry / thread death into automatic failover."""
        if self._monitor is not None:
            return
        period = interval_s if interval_s is not None else self.cfg.monitor_interval_s

        def _run() -> None:
            while not self._monitor_stop.wait(period):
                try:
                    self.health_sweep()
                except Exception:            # the monitor must never die
                    self.sink.incr("monitor_errors")

        self._monitor = threading.Thread(target=_run, name="router-monitor",
                                         daemon=True)
        self._monitor.start()

    def stop_monitor(self) -> None:
        if self._monitor is None:
            return
        self._monitor_stop.set()
        self._monitor.join(timeout=2)
        self._monitor = None
        self._monitor_stop.clear()

    # ------------------------------------------------------------- degradation
    def set_degraded(self, on: bool) -> None:
        """Broadcast the gateway's brown-out state to every replica (disables
        speculative drafting while overloaded)."""
        for r in list(self.replicas):
            if hasattr(r, "set_degraded"):
                r.set_degraded(on)
