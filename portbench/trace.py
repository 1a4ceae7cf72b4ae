"""The traced run's instruments, all in the benchmark's own files.

``Instruments`` wraps, in a ``--trace 1`` run only, installed before its
clients start:
  - each model call's rows (starts, tokens fed), for the model's count,
    through both windows (two small host copies a call);
and records, in its traced window only:
  - host spans: ``Gateway.handle`` (the gateway call, on the loop),
    ``InferenceEngine.step`` (the engine step), ``LM.decode_chunk`` (the
    model call's host dispatch), the rest of ``InferenceEngine._run`` after
    it (sampling and the read-back of the tokens) and
    ``ReplicaRouter._deliver`` (a token event on its way to the gateway);
  - each kernel call's shapes at the op's Python entry (the grouped matmul,
    w8a16, chunked attention), and references to the call's own small
    tensors that its operations and bytes depend on (group sizes, lengths,
    positions), read once the window has closed: nothing in the window
    waits for the card or launches work of its own.

Outside the traced window a wrapper only tests a flag (and the engine
step's takes an uncontended lock).

``DeviceTrace`` starts ``torch.profiler`` (device activity only) when the
traced window opens and stops it when it closes. A spin kernel launched on an idle
card right after a host timestamp, at each edge, maps the trace's clock
onto the host's. It keeps every device operation of the window as
(name, start, end) on the host clock.
"""
from __future__ import annotations

import functools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, List, Tuple

import torch


SPIN_CYCLES = 2000


@dataclass
class Span:
    name: str
    thread: int
    t0: float
    t1: float


@dataclass
class Instruments:
    active: bool = False
    spans: List[Span] = field(default_factory=list)
    calls: List[Tuple[float, Any, Any]] = field(default_factory=list)   # (t, starts, nvalid)
    gmm: List[Tuple[int, int, int, int, bool, Any]] = field(default_factory=list)
    w8a16: List[Tuple[int, int, int, int]] = field(default_factory=list)
    attn: List[Tuple[Any, ...]] = field(default_factory=list)
    t_open: float = 0.0
    t_close: float = 0.0
    _undo: List[Tuple[Any, str, Any]] = field(default_factory=list)
    # held by the replica thread for each engine step, and by the window's
    # edges while they mark the clocks: no model call is in flight then
    gate: Any = field(default_factory=threading.Lock)

    def _patch(self, owner, name: str, make):
        orig = getattr(owner, name)
        self._undo.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def open(self) -> None:
        """Opens the traced window without a profiler (the CPU's rehearsal)."""
        self.active = True
        self.t_open = time.perf_counter()

    def close(self) -> None:
        self.t_close = time.perf_counter()
        self.active = False

    def span(self, name: str, t0: float) -> None:
        if self.active:
            self.spans.append(Span(name, threading.get_ident(), t0, time.perf_counter()))

    def install(self) -> None:
        from repro_torch.core.engine import InferenceEngine
        from repro_torch.core.gateway import Gateway
        from repro_torch.core.router import ReplicaRouter
        from repro_torch.kernels.moe_gmm import ops as gops
        from repro_torch.models import attention, common
        from repro_torch.models.transformer import LM
        from repro_torch.quant.quantize import QuantizedLinear
        ins = self

        def step(orig):
            @functools.wraps(orig)
            def wrapped(engine, *a, **k):
                with ins.gate:
                    t0 = time.perf_counter()
                    try:
                        return orig(engine, *a, **k)
                    finally:
                        ins.span("engine_step", t0)
            return wrapped

        def run(orig):
            @functools.wraps(orig)
            def wrapped(engine, tokens, starts, nvalid, *a, **k):
                t0 = time.perf_counter()
                ins.calls.append((t0, starts.copy(), nvalid.copy()))
                ins._tls.t_model_end = None
                try:
                    return orig(engine, tokens, starts, nvalid, *a, **k)
                finally:
                    t_end = ins._tls.t_model_end
                    if t_end is not None and ins.active:
                        ins.spans.append(Span("readback", threading.get_ident(), t_end,
                                              time.perf_counter()))
            return wrapped

        def decode_chunk(orig):
            @functools.wraps(orig)
            def wrapped(*a, **k):
                t0 = time.perf_counter()
                try:
                    return orig(*a, **k)
                finally:
                    ins.span("model_call", t0)
                    ins._tls.t_model_end = time.perf_counter()
            return wrapped

        def handle(orig):
            @functools.wraps(orig)
            async def wrapped(*a, **k):
                t0 = time.perf_counter()
                try:
                    return await orig(*a, **k)
                finally:
                    ins.span("gateway_call", t0)
            return wrapped

        def deliver(orig):
            @functools.wraps(orig)
            def wrapped(*a, **k):
                t0 = time.perf_counter()
                try:
                    return orig(*a, **k)
                finally:
                    ins.span("token_delivery", t0)
            return wrapped

        def gmm_matmul(orig):
            @functools.wraps(orig)
            def wrapped(rows, xb, w):
                if ins.active and rows.cuda:
                    int8 = isinstance(w, QuantizedLinear)
                    E, K, N = (w.q if int8 else w).shape
                    ins.gmm.append((rows.M, K, N, E, int8, rows.group_sizes))
                return orig(rows, xb, w)
            return wrapped

        def w8a16(orig):
            @functools.wraps(orig)
            def wrapped(x, w_q, col_scale=None, *, row_scale=None):
                if ins.active and x.is_cuda:
                    G = 1 if row_scale is None else row_scale.shape[-1]
                    ins.w8a16.append((x.shape[0], w_q.shape[0], w_q.shape[1], G))
                return orig(x, w_q, col_scale, row_scale=row_scale)
            return wrapped

        def chunked(orig):
            @functools.wraps(orig)
            def wrapped(q, k_pages, v_pages, page_table, lengths, q_positions, **k):
                if ins.active and q.is_cuda:
                    ins.attn.append((tuple(q.shape), k_pages.shape[1], k_pages.shape[2],
                                     k_pages.element_size(), q.element_size(),
                                     k.get("window", 0), lengths, q_positions))
                return orig(q, k_pages, v_pages, page_table, lengths, q_positions, **k)
            return wrapped

        self._tls = threading.local()
        self._patch(InferenceEngine, "step", step)
        self._patch(InferenceEngine, "_run", run)
        self._patch(LM, "decode_chunk", decode_chunk)
        self._patch(Gateway, "handle", handle)
        self._patch(ReplicaRouter, "_deliver", deliver)
        self._patch(gops.GroupedRows, "matmul", gmm_matmul)
        self._patch(common, "w8a16_matmul", w8a16)
        self._patch(attention, "chunked_prefill_attention", chunked)

    def uninstall(self) -> None:
        while self._undo:
            owner, name, orig = self._undo.pop()
            setattr(owner, name, orig)


@dataclass
class DeviceTrace:
    """Device operations of the window on the host clock."""
    ops: List[Tuple[str, float, float]] = field(default_factory=list)
    t_open: float = 0.0
    t_close: float = 0.0
    drift_s: float = 0.0
    t_marked_close: float = 0.0
    _prof: Any = None
    _marks: List[float] = field(default_factory=list)

    def open(self, ins: Instruments) -> None:
        """Starts the profiler, marks the clocks between two engine steps,
        then opens the window."""
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        with ins.gate:
            self._mark()
            ins.active = True
            self.t_open = time.perf_counter()

    def close(self, ins: Instruments) -> None:
        """Closes the window, marks the clocks once the step in flight has
        ended, and stops the profiler."""
        self.t_close = time.perf_counter()
        ins.active = False
        with ins.gate:
            self._mark()
        self._prof.stop()

    def _mark(self) -> None:
        torch.cuda.synchronize()
        self._marks.append(time.perf_counter())
        torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()

    def reduce(self) -> None:
        """The trace's device events, mapped onto the host clock by the two
        spin kernels (their starts against the host times just before)."""
        from torch.autograd import DeviceType
        evs = []
        spins = []
        cuda = DeviceType.CUDA
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != cuda:
                continue
            d = e.duration_ns()
            if d <= 0:
                continue
            t0 = e.start_ns()
            name = e.name()
            (spins if "spin_kernel" in name else evs).append((name, t0, t0 + d))
        self._prof = None
        if len(spins) < 2:
            raise RuntimeError(f"the trace holds {len(spins)} spin markers, not 2")
        spins.sort(key=lambda x: x[1])
        a, b = spins[0][1], spins[-1][1]
        ha, hb = self._marks[0], self._marks[-1]
        rate = (hb - ha) / ((b - a) * 1e-9)
        self.drift_s = abs((hb - ha) - (b - a) * 1e-9)

        def host(ns: float) -> float:
            return ha + (ns - a) * 1e-9 * rate
        # the device's work between the two marks: the window, and the
        # rest of the engine step in flight when it closed
        self.ops = sorted(((n, host(s), host(e)) for n, s, e in evs
                           if s >= spins[0][2] and e <= b), key=lambda x: x[1])
        self.t_marked_close = host(b)
