"""The gateway — where the paper's end-to-end contribution lives (§4.2).

Two real, measured implementations:

``BaselineGateway`` (the FastAPI/HTTP1.1+JSON stand-in)
  - verbose OpenAI-style JSON chunks via stdlib ``json``
  - per-request connection establishment to the engine (HTTP/1.1 handshake,
    modeled as an awaited latency constant — documented in EXPERIMENTS.md)
  - a bounded sync-worker semaphore (FastAPI's threadpool under GIL): request
    validation + serde run inside it

``ScaleGateway`` (the Axum/Tokio + gRPC/protobuf adaptation)
  - compact msgpack frames (protobuf stand-in, C-speed codec)
  - connection POOL to replicas: handshake paid once per replica, not per
    request
  - fully async admission path, no sync-worker ceiling

Both share the Safety module (auth/rate-limit/content-filter), the router,
and the Observability sink, and stream per-token messages back to the client
through asyncio queues (events cross from replica threads via
``loop.call_soon_threadsafe`` — the zero-copy bridge).
"""
from __future__ import annotations

import asyncio
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Set

import numpy as np

from repro_torch.core.engine import TokenEvent
from repro_torch.core.metrics import Request, now
from repro_torch.core.observability import MetricsSink, Tracer
from repro_torch.core.router import NoReplicaAvailable, ReplicaRouter
from repro_torch.core.safety import AuthError, Authenticator, ContentBlocked, ContentFilter, RateLimited, TokenBucket
from repro_torch.core.serde import CODECS


@dataclass
class GatewayConfig:
    codec: str = "binary"              # "json" (baseline) | "binary" (scale)
    conn_setup_s: float = 0.0003       # per-connection handshake latency
    pooled_connections: bool = True    # pool (scale) vs per-request (baseline)
    sync_workers: int = 0              # >0: bounded sync path (baseline)
    name: str = "scale"
    # graceful degradation (DESIGN.md §5)
    max_inflight: int = 0              # >0: bounded admission; overflow is SHED
                                       # with an immediate terminal event
    default_deadline_s: Optional[float] = None   # per-request deadline default
    brownout_high: int = 0             # inflight watermark arming brown-out
                                       # (0: brown-out disabled)
    brownout_low: int = 0              # watermark disarming it (hysteresis)
    brownout_sustain_s: float = 0.5    # overload must persist this long to arm
    brownout_recover_s: float = 1.0    # calm must persist this long to disarm
    brownout_max_new_tokens: int = 8   # max_new_tokens clamp while degraded


def baseline_gateway_config() -> GatewayConfig:
    return GatewayConfig(codec="json", conn_setup_s=0.0003,
                         pooled_connections=False, sync_workers=8, name="baseline")


def scale_gateway_config() -> GatewayConfig:
    return GatewayConfig(codec="binary", conn_setup_s=0.0003,
                         pooled_connections=True, sync_workers=0, name="scale")


class Gateway:
    def __init__(self, router: ReplicaRouter, cfg: Optional[GatewayConfig] = None,
                 auth: Optional[Authenticator] = None,
                 rate_limiter: Optional[TokenBucket] = None,
                 content_filter: Optional[ContentFilter] = None,
                 sink: Optional[MetricsSink] = None,
                 require_auth: bool = False,
                 tracer: Optional[Tracer] = None):
        self.router = router
        self.cfg = cfg or scale_gateway_config()
        self.codec = CODECS[self.cfg.codec]
        self.auth = auth or Authenticator()
        self.rate_limiter = rate_limiter
        self.content_filter = content_filter
        self.sink = sink or router.sink
        self.tracer = tracer or router.tracer
        self.require_auth = require_auth
        self._pool_ready: Set[str] = set()     # replicas with a live connection
        self._sem: Optional[asyncio.Semaphore] = None
        self.requests: Dict[str, Request] = {}  # server-side registry (metrics join)
        # degradation state: inflight accounting crosses threads (admission on
        # the event loop, completion on replica threads), hence the lock
        self._degrade_lock = threading.Lock()
        self._inflight = 0
        self.inflight_max = 0                  # high-water mark (bound check)
        self.brownout = False
        self.brownout_activations = 0
        self._over_since: Optional[float] = None
        self._calm_since: Optional[float] = None

    # ------------------------------------------------------------- degradation
    def _update_brownout(self, t: float) -> None:
        """Hysteresis brown-out controller: sustained inflight above the high
        watermark arms degraded mode (clamped ``max_new_tokens``, speculative
        decoding off); sustained calm below the low watermark disarms it."""
        cfg = self.cfg
        if cfg.brownout_high <= 0:
            return
        flipped = None
        with self._degrade_lock:
            inflight = self._inflight
            if not self.brownout:
                if inflight >= cfg.brownout_high:
                    if self._over_since is None:
                        self._over_since = t
                    elif t - self._over_since >= cfg.brownout_sustain_s:
                        self.brownout = flipped = True
                        self.brownout_activations += 1
                        self._calm_since = None
                else:
                    self._over_since = None
            else:
                if inflight <= cfg.brownout_low:
                    if self._calm_since is None:
                        self._calm_since = t
                    elif t - self._calm_since >= cfg.brownout_recover_s:
                        self.brownout = False
                        flipped = False
                        self._over_since = None
                else:
                    self._calm_since = None
        if flipped is not None:
            self.sink.incr("brownout_on" if flipped else "brownout_off")
            self.router.set_degraded(flipped)

    def poll_brownout(self) -> bool:
        """Re-evaluate the brown-out controller now (recovery is time-based,
        so someone must look at the clock when traffic goes quiet)."""
        self._update_brownout(now())
        return self.brownout

    def _semaphore(self) -> Optional[asyncio.Semaphore]:
        if self.cfg.sync_workers > 0 and self._sem is None:
            self._sem = asyncio.Semaphore(self.cfg.sync_workers)
        return self._sem

    # ------------------------------------------------------------------
    async def handle(self, raw: bytes, client_q: "asyncio.Queue[bytes]",
                     auth_token: str = "") -> None:
        """Accept one streaming request. Returns after admission; tokens
        stream into ``client_q`` (b"" sentinel on error)."""
        t1 = now()
        sem = self._semaphore()
        if sem is not None:
            await sem.acquire()
        try:
            req_id, tokens, params = self.codec.decode_request(raw)
            if self.require_auth:
                user = self.auth.verify(auth_token)
            else:
                user = "anon"
            if self.rate_limiter is not None:
                self.rate_limiter.check(user)
            if self.content_filter is not None:
                self.content_filter.check(tokens)
        except (AuthError, RateLimited, ContentBlocked) as e:
            self.sink.incr(f"rejected.{type(e).__name__}")
            client_q.put_nowait(b"")
            if sem is not None:
                sem.release()
            return
        finally:
            pass

        # ---- load shedding: bounded admission. Overflow gets an immediate
        # terminal "shed" event — an explicit no, never a silent hang.
        self._update_brownout(t1)
        if self.cfg.max_inflight > 0:
            with self._degrade_lock:
                over = self._inflight >= self.cfg.max_inflight
            if over:
                request = Request(req_id=req_id,
                                  prompt_tokens=np.asarray(tokens, np.int32))
                request.t1 = t1
                request.error = "shed"
                request.finished = True
                request.t3 = now()
                self.requests[req_id] = request
                self.sink.incr("shed")
                if self.tracer:
                    self.tracer.event(req_id, "shed")
                    self.tracer.discard(req_id)
                client_q.put_nowait(self.codec.encode_token(req_id, -1, 0, True))
                if sem is not None:
                    sem.release()
                return

        max_new = int(params.get("max_new_tokens", 64))
        if self.brownout:
            # brown-out clamp: shorter generations drain the backlog faster
            max_new = min(max_new, self.cfg.brownout_max_new_tokens)
            self.sink.incr("brownout_clamped")
        request = Request(
            req_id=req_id,
            prompt_tokens=np.asarray(tokens, np.int32),
            max_new_tokens=max_new,
            temperature=float(params.get("temperature", 0.5)),
            top_p=float(params.get("top_p", 0.7)),
            greedy=bool(params.get("greedy", False)),
            user_id=user,
        )
        request.t1 = t1
        deadline_s = params.get("deadline_s", self.cfg.default_deadline_s)
        if deadline_s is not None:
            # absolute cutoff on the shared monotonic clock; enforced by the
            # engine's per-step deadline sweep
            request.deadline_s = float(deadline_s)
            request.deadline_at = t1 + float(deadline_s)
        self.requests[req_id] = request
        with self._degrade_lock:
            self._inflight += 1
            if self._inflight > self.inflight_max:
                self.inflight_max = self._inflight
        if self.tracer:
            # decode + auth/rate-limit/content checks (the sync-worker path)
            self.tracer.add(req_id, "gateway_admission", t1, now(),
                            codec=self.cfg.codec, n_prompt=len(tokens))

        loop = asyncio.get_running_loop()
        codec = self.codec

        def on_event(ev: TokenEvent) -> None:
            # replica-thread side: timestamp + encode, then hop to the loop
            r = ev.request
            if r.t4 == 0.0:
                r.t4 = ev.t_emit
            payload = codec.encode_token(r.req_id, ev.token, r.n_generated - 1,
                                         ev.finished)
            if ev.finished:
                with self._degrade_lock:
                    self._inflight -= 1
                if r.error == "deadline_exceeded":
                    self.sink.incr("deadline_exceeded")
                self._update_brownout(now())
            loop.call_soon_threadsafe(client_q.put_nowait, payload)

        # connection to the chosen replica
        try:
            replica = self.router.select()
        except NoReplicaAvailable:
            # total outage: still a terminal event, not a hang
            request.error = "no replica available"
            request.finished = True
            request.t3 = now()
            with self._degrade_lock:
                self._inflight -= 1
            self.sink.incr("no_replica")
            if self.tracer:
                self.tracer.discard(req_id)
            client_q.put_nowait(codec.encode_token(req_id, -1, 0, True))
            if sem is not None:
                sem.release()
            return
        t_conn0 = now()
        handshake = False
        # the choice counts toward the replica's load while the connection is
        # set up: concurrent admissions would otherwise all pick the replica
        # that looked idle before any of them was submitted
        replica.connecting += 1
        try:
            if not self.cfg.pooled_connections:
                await asyncio.sleep(self.cfg.conn_setup_s)      # per-request handshake
                handshake = True
            elif replica.replica_id not in self._pool_ready:
                await asyncio.sleep(self.cfg.conn_setup_s)      # pay once, then reuse
                self._pool_ready.add(replica.replica_id)
                handshake = True
        finally:
            replica.connecting -= 1
        if self.tracer and handshake:
            self.tracer.add(req_id, "connect", t_conn0, now(),
                            pooled=self.cfg.pooled_connections,
                            replica=replica.replica_id)

        self.router.submit(request, on_event, replica=replica)
        if sem is not None:
            sem.release()
