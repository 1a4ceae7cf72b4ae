"""Deterministic fault injection for the serving stack (DESIGN.md §5).

A :class:`FaultPlan` is an explicit, seeded schedule of fault events; a
:class:`FaultInjector` evaluates it against a monotonic clock at three hook
points:

  * ``Replica._loop``        — replica crashes (the serving thread exits
                               without cleanup) and step stalls (the loop
                               freezes: no stepping, no inbox drain, no
                               heartbeat)
  * ``InferenceEngine.step`` — slow-step latency multipliers (sleep scaled
                               by the previous step's measured duration) and
                               artificial KV page pressure (pages held out
                               of the allocator's free list for a window)
  * ``ReplicaRouter.submit`` — transient submit errors
                               (:class:`TransientSubmitError`), retried by
                               the router's retry budget

Everything is reproducible from ``(plan, seed)``: the only stochastic
choice — whether a given submit attempt fails inside an error window — is
a pure hash of ``(seed, req_id, attempt)``, so it does not depend on
thread interleaving. The injector never mutates serving state directly; it
only tells the hook site what to do, so a ``None`` injector costs one
attribute check on the hot path.
"""
from __future__ import annotations

import hashlib
import threading
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

# fault kinds understood by the hook points
KINDS = ("crash", "stall", "slow", "submit_error", "kv_pressure")


class TransientSubmitError(Exception):
    """A submit attempt failed for a transient reason (injected network
    blip / replica hiccup). The router's retry budget handles these."""


@dataclass
class FaultEvent:
    """One scheduled fault. ``at_s`` is the offset from ``FaultInjector.
    start()``; windowed kinds (stall/slow/submit_error/kv_pressure) are
    active for ``duration_s`` from ``at_s``; ``crash`` fires once at
    ``at_s``. ``replica_id=None`` matches any replica (submit_error is
    typically router-wide)."""
    kind: str
    at_s: float
    replica_id: Optional[str] = None
    duration_s: float = 0.0
    factor: float = 1.0          # slow: multiplier on the previous step time
    delay_s: float = 0.0         # slow: additive per-step delay
    prob: float = 1.0            # submit_error: per-attempt failure prob
    pages: int = 0               # kv_pressure: pages held out of the pool

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(known: {', '.join(KINDS)})")


@dataclass
class FaultPlan:
    """A seeded schedule of fault events. The plan is data — serializable,
    diffable, and replayable; the seed only drives the injector's
    per-attempt coin flips."""
    events: List[FaultEvent] = field(default_factory=list)
    seed: int = 0

    def crash(self, replica_id: str, at_s: float) -> "FaultPlan":
        self.events.append(FaultEvent("crash", at_s, replica_id))
        return self

    def stall(self, replica_id: str, at_s: float, duration_s: float) -> "FaultPlan":
        self.events.append(FaultEvent("stall", at_s, replica_id,
                                      duration_s=duration_s))
        return self

    def slow(self, replica_id: Optional[str], at_s: float, duration_s: float,
             factor: float = 2.0, delay_s: float = 0.0) -> "FaultPlan":
        self.events.append(FaultEvent("slow", at_s, replica_id,
                                      duration_s=duration_s, factor=factor,
                                      delay_s=delay_s))
        return self

    def submit_error(self, at_s: float, duration_s: float,
                     prob: float = 1.0) -> "FaultPlan":
        self.events.append(FaultEvent("submit_error", at_s, None,
                                      duration_s=duration_s, prob=prob))
        return self

    def kv_pressure(self, replica_id: Optional[str], at_s: float,
                    duration_s: float, pages: int) -> "FaultPlan":
        self.events.append(FaultEvent("kv_pressure", at_s, replica_id,
                                      duration_s=duration_s, pages=pages))
        return self


class FaultInjector:
    """Evaluates a :class:`FaultPlan` at the serving stack's hook points.
    Thread-safe: hooks are called from replica threads, the router monitor,
    and the gateway's event loop concurrently."""

    HOLD_KEY = "fault"               # allocator hold bucket for kv_pressure

    def __init__(self, plan: Optional[FaultPlan] = None,
                 clock=time.monotonic):
        self.plan = plan or FaultPlan()
        self.clock = clock
        self._t0: Optional[float] = None
        self._lock = threading.Lock()
        self._fired_crashes: set = set()
        self.injected: Counter = Counter()   # per-kind fire/active counts

    # ------------------------------------------------------------- clock
    def start(self) -> "FaultInjector":
        """Arm the schedule; ``at_s`` offsets are relative to this call.
        Auto-armed on first hook evaluation if never called."""
        with self._lock:
            if self._t0 is None:
                self._t0 = self.clock()
        return self

    def elapsed(self) -> float:
        if self._t0 is None:
            self.start()
        return self.clock() - self._t0

    # ------------------------------------------------------------- matching
    def _match(self, kind: str, replica_id: Optional[str],
               t: float) -> Optional[FaultEvent]:
        """First active event of ``kind`` applying to ``replica_id``."""
        for ev in self.plan.events:
            if ev.kind != kind:
                continue
            if ev.replica_id is not None and ev.replica_id != replica_id:
                continue
            if kind == "crash":
                if t >= ev.at_s:
                    return ev
            elif ev.at_s <= t < ev.at_s + ev.duration_s:
                return ev
        return None

    def _coin(self, *key) -> float:
        """Deterministic uniform [0, 1) from (seed, key): independent of
        call order and thread interleaving, so an injected schedule replays
        bit-identically."""
        data = repr((self.plan.seed,) + key).encode()
        h = hashlib.blake2b(data, digest_size=8).digest()
        return int.from_bytes(h, "little") / 2.0 ** 64

    # ------------------------------------------------------------- hooks
    def replica_action(self, replica_id: str) -> Optional[Tuple[str, float]]:
        """Called by ``Replica._loop`` once per loop iteration. Returns
        ``("crash", 0.0)`` exactly once when a crash is due, ``("stall",
        remaining_s)`` while a stall window is open, else ``None``."""
        t = self.elapsed()
        ev = self._match("crash", replica_id, t)
        if ev is not None:
            with self._lock:
                if (replica_id, id(ev)) not in self._fired_crashes:
                    self._fired_crashes.add((replica_id, id(ev)))
                    self.injected["crash"] += 1
                    return ("crash", 0.0)
        ev = self._match("stall", replica_id, t)
        if ev is not None:
            self.injected["stall_ticks"] += 1
            return ("stall", ev.at_s + ev.duration_s - t)
        return None

    def on_engine_step(self, engine) -> None:
        """Called by ``InferenceEngine.step`` before each iteration: applies
        slow-step latency (factor x previous measured step duration +
        additive delay) and adjusts the artificial KV hold."""
        key = getattr(engine, "fault_key", None)
        t = self.elapsed()
        ev = self._match("slow", key, t)
        if ev is not None:
            base = 0.0
            records = getattr(engine, "step_records", None)
            if records:
                base = max(records[-1].duration, 0.0)
            delay = max(ev.factor - 1.0, 0.0) * base + ev.delay_s
            if delay > 0:
                self.injected["slow_steps"] += 1
                time.sleep(min(delay, 1.0))
        alloc = getattr(engine, "allocator", None)
        if alloc is not None:
            ev = self._match("kv_pressure", key, t)
            want = ev.pages if ev is not None else 0
            held = alloc.held_pages(self.HOLD_KEY)
            if want != held:
                alloc.release_hold(self.HOLD_KEY)
                if want > 0:
                    got = alloc.hold(want, self.HOLD_KEY)
                    if got and held == 0:
                        self.injected["kv_pressure"] += 1

    def on_submit(self, replica_id: str, req_id: str, attempt: int) -> None:
        """Called by ``ReplicaRouter.submit`` before handing a request to a
        replica. Raises :class:`TransientSubmitError` when an error window
        is open and the (req_id, attempt) coin lands under ``prob``."""
        ev = self._match("submit_error", replica_id, self.elapsed())
        if ev is None:
            return
        if self._coin("submit", req_id, attempt) < ev.prob:
            self.injected["submit_error"] += 1
            raise TransientSubmitError(
                f"injected submit error for {req_id} (attempt {attempt})")

    # ------------------------------------------------------------- teardown
    def release_holds(self, engines) -> None:
        """Return any artificially held KV pages (end-of-run cleanup so the
        leak check sees the allocator's true state)."""
        for engine in engines:
            alloc = getattr(engine, "allocator", None)
            if alloc is not None:
                alloc.release_hold(self.HOLD_KEY)
