"""Replica: one inference engine + its serving thread + health state.

"A replica represents the smallest unit of resource allocation and is
designed to be homogeneous" (paper §3.1). Each replica owns an engine
(optionally with a mesh slice / TP degree on real hardware) and steps it on a
dedicated thread; token events are delivered to per-request callbacks from
that thread (the gateway bridges them into asyncio).

``kill()`` simulates a replica failure: the thread stops and the in-flight
requests (with their partial generations) are returned so the router can
resume them on a healthy replica.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.engine import InferenceEngine, TokenEvent
from repro_torch.core.metrics import Request

OnEvent = Callable[[TokenEvent], None]


class Replica:
    def __init__(self, replica_id: str, engine: InferenceEngine, *,
                 klass: str = "default", tp_degree: int = 1,
                 step_watchdog_s: float = 30.0, injector=None):
        self.replica_id = replica_id
        self.engine = engine
        self.klass = klass                     # blueprint class: "high_tp" | "high_replica" | ...
        self.tp_degree = tp_degree
        self.healthy = True
        self.crashed = False                   # injected crash fired (thread exited)
        self.step_watchdog_s = step_watchdog_s
        # fault injection (DESIGN.md §5): evaluated once per loop iteration;
        # also wired into the engine's per-step hook under this replica's id.
        self.injector = injector
        if injector is not None and hasattr(engine, "injector"):
            engine.injector = injector
            engine.fault_key = replica_id
        self.last_step_at = time.monotonic()
        self._inbox: "queue.Queue[Tuple[Request, OnEvent]]" = queue.Queue()
        self._inflight: Dict[str, Tuple[Request, OnEvent]] = {}
        self._cancel: "queue.Queue[str]" = queue.Queue()
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self.total_completed = 0
        # synchronous load counter: incremented at submit() time so the
        # router's least-loaded choice never races the replica thread
        self._outstanding = 0
        # requests the gateway routed here that are still connecting (set
        # and read on the gateway's event loop): part of the load, so a
        # burst of admissions spreads before any of them is submitted
        self.connecting = 0

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "Replica":
        self._thread = threading.Thread(target=self._loop, name=f"replica-{self.replica_id}",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop = True
        self._wake.set()
        if self._thread:
            self._thread.join(timeout=5)

    def kill(self) -> List[Tuple[Request, OnEvent]]:
        """Simulated failure: stop serving, surrender in-flight requests —
        including ones still in the inbox (submitted but not yet moved to the
        engine when the serving thread died), which would otherwise be lost
        until the client times out."""
        self.healthy = False
        self.stop()
        with self._lock:
            orphans = list(self._inflight.values())
            self._inflight.clear()
        while True:
            try:
                orphans.append(self._inbox.get_nowait())
            except queue.Empty:
                break
        # free the dead engine's KV: a crashed replica's allocator must not
        # leak its orphans' pages (the leak check at bench exit covers dead
        # replicas too). getattr-guarded: tests stub the engine.
        cancel = getattr(self.engine, "cancel", None)
        if cancel is not None:
            for req, _ in orphans:
                cancel(req.req_id)
        return orphans

    def thread_dead(self) -> bool:
        """Crash detection: the serving thread exited without being asked to
        stop (injected crash / unhandled exception in the loop)."""
        return (self._thread is not None and not self._thread.is_alive()
                and not self._stop)

    def set_degraded(self, on: bool) -> None:
        """Brown-out toggle from the gateway: disables speculative drafting
        on this replica's engine while overloaded."""
        if hasattr(self.engine, "degraded"):
            self.engine.degraded = on

    # ------------------------------------------------------------- load stats
    def engine_stats(self) -> Dict[str, float]:
        """TokenEvent-level engine counters (prefix cache, COW, eviction) —
        safe to sample from any thread (all cumulative scalars)."""
        return self.engine.stats()

    def step_records(self) -> list:
        """Snapshot of the engine's iteration-profile ring buffer
        (``StepRecord`` rows, oldest first). Safe to call from any thread:
        deque snapshots are atomic under the GIL and records are immutable
        once appended."""
        return list(self.engine.step_records)

    @property
    def load(self) -> int:
        return self._outstanding + self.connecting

    @property
    def active(self) -> int:
        return len(self._inflight)

    # ------------------------------------------------------------- submit
    def submit(self, request: Request, on_event: OnEvent) -> None:
        if not self.healthy:
            raise RuntimeError(f"replica {self.replica_id} is down")
        request.replica_id = self.replica_id
        with self._lock:
            self._outstanding += 1
        self._inbox.put((request, on_event))
        self._wake.set()

    def cancel(self, req_id: str) -> None:
        self._cancel.put(req_id)
        self._wake.set()

    # ------------------------------------------------------------- engine loop
    def _loop(self) -> None:
        while not self._stop:
            if self.injector is not None:
                act = self.injector.replica_action(self.replica_id)
                if act is not None:
                    kind, remaining = act
                    if kind == "crash":
                        # the serving thread exits WITHOUT cleanup: healthy
                        # stays True, inflight/inbox stay populated — exactly
                        # what a real process death looks like. Detection is
                        # the router monitor's job (thread_dead()).
                        self.crashed = True
                        return
                    # stall: frozen loop — no stepping, no inbox drain, no
                    # heartbeat update, so the watchdog fires.
                    time.sleep(min(max(remaining, 0.0), 0.02))
                    continue
            moved = False
            while True:
                try:
                    req, cb = self._inbox.get_nowait()
                except queue.Empty:
                    break
                with self._lock:
                    self._inflight[req.req_id] = (req, cb)
                self.engine.submit(req)
                moved = True
            while True:
                try:
                    rid = self._cancel.get_nowait()
                except queue.Empty:
                    break
                self.engine.cancel(rid)
                with self._lock:
                    if self._inflight.pop(rid, None) is not None:
                        self._outstanding -= 1
                moved = True

            if self.engine.has_work():
                self.last_step_at = time.monotonic()
                for ev in self.engine.step():
                    rid = ev.request.req_id
                    with self._lock:
                        entry = self._inflight.get(rid)
                    if entry is None:
                        continue                        # cancelled mid-step
                    _, cb = entry
                    cb(ev)
                    if ev.finished:
                        with self._lock:
                            if self._inflight.pop(rid, None) is not None:
                                self._outstanding -= 1
                        self.total_completed += 1
            elif not moved:
                self._wake.wait(timeout=0.002)
                self._wake.clear()

    def watchdog_expired(self) -> bool:
        """Straggler detection: the replica has work (in the engine OR stuck
        in an undrained inbox — a stalled loop drains nothing) but hasn't
        stepped lately."""
        return (self.healthy
                and (self.engine.has_work() or not self._inbox.empty())
                and time.monotonic() - self.last_step_at > self.step_watchdog_s)
