"""The benchmark's own client: it encodes each request as a wire frame, calls
``Gateway.handle`` on the asyncio loop, and stamps submit and receive times
on its own clock (``time.perf_counter``, the clock of the program's
Figure-4 stamps). Closed loop: each client sends its next request as soon
as its previous one has finished. Open loop (a mix with ``arrival_rate``):
each request is sent at its arrival time, whatever is in flight.

The window opens once every closed-loop client has received a first token
(or, open loop, ``ramp_s`` after the first arrival) and closes ``seconds``
later. A traced run then keeps the load on for a second, shorter window
(``trace_s``), the one its profiler watches, so that the first window's
host-clock numbers are not those of a traced program. Then every client
task is cancelled and the replica stopped.
"""
from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from portbench.traffic import StreamRequest


@dataclass
class ClientRecord:
    req_id: str
    client: int
    index: int
    prompt: np.ndarray
    max_new_tokens: int
    t_submit: float = 0.0
    times: List[float] = field(default_factory=list)
    tokens: List[int] = field(default_factory=list)
    indices: List[int] = field(default_factory=list)
    finished: bool = False
    t_finish: float = 0.0
    error: Optional[str] = None

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))


@dataclass
class LoopResult:
    records: List[ClientRecord]
    t_open: float
    t_close: float


async def request(gateway, rec: ClientRecord, on_first: Callable[[ClientRecord], None],
                  due: Optional[float] = None) -> None:
    """Sends ``rec``'s request as a wire frame through ``Gateway.handle`` and
    records every token frame that comes back, stamped on arrival. An open
    loop's request is timed from ``due``, when it should have been sent, so
    a stall also counts against the requests it delays."""
    codec = gateway.codec
    raw = codec.encode_request(rec.req_id, rec.prompt.tolist(),
                               {"max_new_tokens": rec.max_new_tokens, "greedy": True,
                                "temperature": 0.0})
    q: "asyncio.Queue[bytes]" = asyncio.Queue()
    rec.t_submit = time.perf_counter() if due is None else due
    await gateway.handle(raw, q)
    while True:
        data = await q.get()
        t = time.perf_counter()
        if data == b"":
            rec.error = "rejected"
            return
        _, token, idx, fin = codec.decode_token(data)
        if token >= 0:
            rec.tokens.append(int(token))
            rec.indices.append(int(idx))
            rec.times.append(t)
            if len(rec.tokens) == 1:
                on_first(rec)
        elif not fin:
            rec.error = f"token {token}"
        if fin:
            rec.finished = True
            rec.t_finish = t
            if token < 0:
                rec.error = rec.error or "terminal without a token"
            return


async def run_loop(gateway, per_client: List[List[StreamRequest]], seconds: float, *,
                   open_loop: bool = False, ramp_s: float = 0.0, trace_s: float = 0.0,
                   on_trace_open: Optional[Callable[[], None]] = None,
                   on_trace_close: Optional[Callable[[], None]] = None,
                   stop_replica: Optional[Callable[[], None]] = None) -> LoopResult:
    """Drives the clients until the window closes and, with ``trace_s``,
    through a second window right after it: ``on_trace_open`` /
    ``on_trace_close`` run on the loop at its edges (the traced run starts
    and stops its profiler there). ``stop_replica`` runs in an executor once
    the clients are cancelled."""
    records: List[ClientRecord] = []
    n_clients = len(per_client)
    started = set()
    opened = asyncio.Event()

    def on_first(rec: ClientRecord) -> None:
        started.add(rec.client)
        if not open_loop and len(started) == n_clients:
            opened.set()

    async def closed(ci: int, reqs: List[StreamRequest]) -> None:
        for r in reqs:
            rec = ClientRecord(f"c{ci}-{r.index}", ci, r.index, r.prompt, r.max_new_tokens)
            records.append(rec)
            await request(gateway, rec, on_first)

    async def scheduled(reqs: List[StreamRequest], t0: float) -> None:
        tasks = []
        for r in reqs:
            due = t0 + r.arrival_s
            await asyncio.sleep(max(0.0, due - time.perf_counter()))
            rec = ClientRecord(f"c0-{r.index}", 0, r.index, r.prompt, r.max_new_tokens)
            records.append(rec)
            tasks.append(asyncio.ensure_future(request(gateway, rec, on_first, due)))
        await asyncio.gather(*tasks)

    t_first = time.perf_counter()
    if open_loop:
        stream = sorted((r for reqs in per_client for r in reqs), key=lambda r: r.arrival_s)
        tasks = [asyncio.ensure_future(scheduled(stream, t_first))]
        await asyncio.sleep(max(0.0, (stream[0].arrival_s if stream else 0.0) + ramp_s))
    else:
        tasks = [asyncio.ensure_future(closed(i, reqs)) for i, reqs in enumerate(per_client)]
        waiter = asyncio.ensure_future(opened.wait())
        done, _ = await asyncio.wait([waiter, *tasks], return_when=asyncio.FIRST_COMPLETED)
        if waiter not in done:
            waiter.cancel()
            for t in tasks:
                if t.done() and t.exception() is not None:
                    raise t.exception()
            raise RuntimeError("a client ran out of requests before every client had a "
                               "first token")
    t_open = time.perf_counter()
    await asyncio.sleep(max(0.0, t_open + seconds - time.perf_counter()))
    t_close = time.perf_counter()
    if trace_s > 0:
        if on_trace_open is not None:
            on_trace_open()
        t_trace = time.perf_counter()
        await asyncio.sleep(max(0.0, t_trace + trace_s - time.perf_counter()))
        if on_trace_close is not None:
            on_trace_close()
    for t in tasks:
        t.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)
    if stop_replica is not None:
        await asyncio.get_running_loop().run_in_executor(None, stop_replica)
    return LoopResult(records, t_open, t_close)
