"""Async client workload driver — simulates users submitting OpenAI-API-style
requests "in a concurrent and continuous manner" (paper §5): a fixed
concurrency window of in-flight requests, 20 x concurrency total requests,
streaming consumption with client-side t0/t5/t6 timestamps.
"""
from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.gateway import Gateway
from repro_torch.core.metrics import Request, now
from repro_torch.core.serde import CODECS


@dataclass
class ClientResult:
    requests: List[Request]
    t_start: float
    t_end: float


async def run_workload(
    gateway: Gateway,
    prompts: List[np.ndarray],
    *,
    concurrency: int,
    max_new_tokens: int = 64,
    timeout_s: float = 60.0,
    auth_token: str = "",
    arrivals: Optional[Sequence[float]] = None,
    extra_params: Optional[Sequence[Optional[dict]]] = None,
) -> ClientResult:
    """Closed loop by default (a ``concurrency``-wide window of in-flight
    requests). With ``arrivals`` — offsets in seconds from the start, e.g.
    from ``sample_arrivals`` — runs open loop: request *i* is submitted at
    ``t_start + arrivals[i]`` regardless of how many are in flight, the
    arrival pattern production traffic actually has (``concurrency`` is
    ignored). ``extra_params[i]`` (e.g. ``{"deadline_s": 0.05, "greedy":
    True}``) merges into request *i*'s wire params."""
    codec = CODECS[gateway.cfg.codec]
    sem = asyncio.Semaphore(concurrency)
    requests: List[Request] = []
    t_start = now()

    async def one(i: int, prompt: np.ndarray) -> Request:
        if arrivals is not None:
            await asyncio.sleep(max(0.0, t_start + arrivals[i] - now()))
            return await _one_body(i, prompt)
        async with sem:
            return await _one_body(i, prompt)

    async def _one_body(i: int, prompt: np.ndarray) -> Request:
        req_id = f"req-{i}"
        shadow = Request(req_id=req_id, prompt_tokens=prompt,
                         max_new_tokens=max_new_tokens)
        requests.append(shadow)
        shadow.t0 = now()
        params = {"max_new_tokens": max_new_tokens}
        if extra_params is not None and extra_params[i]:
            params.update(extra_params[i])
        raw = codec.encode_request(req_id, prompt.tolist(), params)
        q: "asyncio.Queue[bytes]" = asyncio.Queue()
        await gateway.handle(raw, q, auth_token=auth_token)
        n = 0
        while True:
            try:
                data = await asyncio.wait_for(q.get(), timeout=timeout_s)
            except asyncio.TimeoutError:
                shadow.error = "timeout"
                break
            if data == b"":
                shadow.error = "rejected"
                break
            _, token, idx, fin = codec.decode_token(data)
            t = now()
            if shadow.t5 == 0.0:
                shadow.t5 = t
            if token >= 0:             # < 0: terminal no-token sentinel
                shadow.generated.append(token)
                shadow.token_times.append(t)
                n += 1
            if fin:
                shadow.t6 = t
                shadow.finished = True
                break
        return shadow

    await asyncio.gather(*(one(i, p) for i, p in enumerate(prompts)))
    t_end = now()
    return ClientResult(requests=requests, t_start=t_start, t_end=t_end)


def merge_engine_timestamps(client_reqs: List[Request], gateway: Gateway) -> None:
    """Join the client-side shadows (t0/t5/t6, received tokens) with the
    gateway-side records (t1..t4, preemptions, replica id) by req_id — the
    same log-join the paper's end-to-end measurement performs."""
    for r in client_reqs:
        g = gateway.requests.get(r.req_id)
        if g is None:
            continue
        r.t1, r.t2, r.t3, r.t4 = g.t1, g.t2, g.t3, g.t4
        r.preemptions = g.preemptions
        r.replica_id = g.replica_id
        r.hedged = g.hedged
        r.error = r.error or g.error          # shed / deadline / no-replica
        r.retries = g.retries
        r.deadline_s = g.deadline_s
