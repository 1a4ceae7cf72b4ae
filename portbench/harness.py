"""One run of one cell: set-up, the measured window, the metrics, and the
check that decides ``correct``.

Everything is found by name: the cell ``workloads/<cell>.json`` names its
configuration ``configs/<config>.json`` and its traffic mix
``traffic/<traffic>.json``; the metrics a run reports are those that
``BENCHMARK.json`` lists for the cell, each read by
``metrics/<metric>.py``'s ``read(run)`` (None: nothing to read, and the
metric is left out of the line).

Every run measures one window of ``--seconds``, on the host clock, with no
tracer on: the end-to-end metrics, and with ``--trace 1`` the per-layer
metrics of the host clock, the program's stamps and its counters. A
``--trace 1`` run then keeps the load on for a second window of
``TRACE_S`` seconds under the profiler and the kernel-shape instruments,
for the metrics of the device trace (the kernels' rooflines, the device's
idle share) and the breakdown.
"""
from __future__ import annotations

import asyncio
import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from portbench import check, client, system, trace as trace_mod
from portbench.traffic import build_stream, client_requests
from portbench.weights import Shapes

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_S = 15.0          # the traced window (or --seconds, where shorter)


def load(kind: str, name: str, root: Path = HERE) -> Dict[str, Any]:
    """``<root>/<kind>/<name>.json``."""
    with open(root / kind / f"{name}.json") as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_metrics(bench: Dict[str, Any], cell: str, traced: bool) -> List[Dict[str, Any]]:
    """The metric entries a run of ``cell`` reports: its end-to-end ones
    (``--trace 0``) or its per-layer ones (``--trace 1``)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}

    def listed(m):
        return cell in m["workloads"] if "workloads" in m else m["moves"] in names
    return [m for m in bench["per_layer"] if listed(m)]


def reader(name: str, root: Path = HERE) -> Callable[[Any], Optional[float]]:
    """``metrics/<name>.py``'s ``read``."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Run:
    """What a metric reader reads."""
    cell: Dict[str, Any]
    cfg: Dict[str, Any]
    shapes: Shapes
    mix: Dict[str, Any]
    seed: int
    setup_s: float
    t_open: float
    t_close: float
    records: List[client.ClientRecord]
    server: Dict[str, Any]                 # req_id -> the gateway's Request (t1 .. t4)
    steps: List[Any]                       # the engine's StepRecord ring
    ins: Optional[trace_mod.Instruments] = None
    device: Optional[trace_mod.DeviceTrace] = None
    notes: Dict[str, Any] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open

    @property
    def trace_window(self) -> Tuple[float, float]:
        """The traced window's edges (the device trace's, or on the CPU the
        instruments')."""
        src = self.device if self.device is not None else self.ins
        return src.t_open, src.t_close


def _warm(stack, prompt_len: int, vocab: int) -> None:
    """One request through the stack: a prefill pack and a decode sweep, the
    engine's two call shapes (the replica thread's first matmul also makes
    its cuBLAS handle)."""
    import numpy as np
    rec = client.ClientRecord("warm", 0, 0, np.arange(1, prompt_len + 1, dtype=np.int32)
                              % (vocab - 1) + 1, 2)

    async def go():
        await asyncio.wait_for(client.request(stack.gateway, rec, lambda r: None), 1800)
    asyncio.run(go())
    if not rec.finished or rec.error:
        raise RuntimeError(f"the warm-up request did not finish: {rec.error}")
    stack.gateway.requests.clear()
    stack.engine.step_records.clear()


def imported_forbidden() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell: Dict[str, Any], cfg: Dict[str, Any], mix: Dict[str, Any],
             bench: Dict[str, Any], *, seed: int, seconds: float, traced: bool, device,
             t_start: float, control: bool = False, log=print,
             root: Path = HERE) -> Dict[str, Any]:
    """Runs the cell once and returns the result line's object (``metrics``
    by the readers in ``<root>/metrics``, ``checks`` last). With ``control``
    the cell's control stands in the program's place and the run reads
    ``correct`` false (``_judge``)."""
    dev = torch.device(device)
    shapes = Shapes.of(cfg)
    ctl = cell["check"].get("control") if control else None
    weights = cfg["serving"]["weights"]
    log(f"[{time.perf_counter() - t_start:.1f}s] imports done")
    builder = system.prebuild(dev)
    pcfg, params = system.port_params(cfg, seed, dev, weights)
    if builder is not None:
        builder.join()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    log(f"[{time.perf_counter() - t_start:.1f}s] {weights} weights on {dev}")
    stack = system.build_stack(pcfg, params, cell["engine"], seed, dev)
    log(f"[{time.perf_counter() - t_start:.1f}s] engine and KV pool")
    ins = dtrace = None
    try:
        _warm(stack, cell["engine"]["prefill_chunk"], shapes.vocab)
        log(f"[{time.perf_counter() - t_start:.1f}s] warm-up done")
        stream = build_stream(mix, shapes.vocab, seed)
        per_client = client_requests(stream, mix["clients"])
        on_open = on_close = None
        if traced:
            # installed before the clients start, idle but for the model
            # calls' rows until the traced window; the device trace needs the
            # card, on the CPU only the host's instruments run (the
            # rehearsal of a traced run)
            ins = trace_mod.Instruments()
            ins.install()
            if dev.type == "cuda":
                dtrace = trace_mod.DeviceTrace()
                on_open, on_close = (lambda: dtrace.open(ins)), (lambda: dtrace.close(ins))
            else:
                on_open, on_close = ins.open, ins.close
        res = asyncio.run(client.run_loop(
            stack.gateway, per_client, seconds, open_loop=mix.get("arrival_rate", 0) > 0,
            ramp_s=mix.get("ramp_s", 0.0), trace_s=min(TRACE_S, seconds) if traced else 0.0,
            on_trace_open=on_open, on_trace_close=on_close, stop_replica=stack.stop))
    finally:
        stack.stop()
        if ins is not None:
            ins.uninstall()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
    else:
        peak = 0
    log(f"[{time.perf_counter() - t_start:.1f}s] window {res.t_open - t_start:.1f} .. "
        f"{res.t_close - t_start:.1f}s closed; {len(res.records)} requests")
    if dtrace is not None:
        dtrace.reduce()
        log(f"[{time.perf_counter() - t_start:.1f}s] trace reduced: {len(dtrace.ops)} device "
            f"operations, clock drift {dtrace.drift_s * 1e6:.1f} us")
    run = Run(cell, cfg, shapes, mix, seed, res.t_open - t_start, res.t_open, res.t_close,
              res.records, dict(stack.gateway.requests), list(stack.engine.step_records),
              ins, dtrace)
    metrics = {}
    for m in cell_metrics(bench, cell["name"], traced):
        v = reader(m["name"], root)(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    run.notes.setdefault("extra", {})["window_steps"] = sum(
        1 for s in run.steps if run.t_open <= s.t0 < run.t_close)
    log(f"[{time.perf_counter() - t_start:.1f}s] metrics read")
    # the program's state goes before the reference runs
    del stack, params, pcfg
    if ins is not None:
        ins.gmm.clear()
        ins.attn.clear()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    result = _judge(run, dev, ctl)
    log(f"[{time.perf_counter() - t_start:.1f}s] reference done")
    attempted = len(res.records)
    failed = sum(r.error is not None for r in res.records)
    out = {"correct": result["correct"], "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": _device(dev, peak, run)}
    if traced and dtrace is not None:
        out["breakdown"] = _breakdown(run)
    out.update(run.notes.get("extra", {}))
    out["checks"] = result["checks"]
    return out


def _device(dev, peak: int, run: Run) -> Dict[str, Any]:
    d = {"platform": "gpu" if dev.type == "cuda" else dev.type,
         "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
         "count": 1, "memory_peak_bytes": int(peak)}
    if run.device is not None:
        lo, hi = run.trace_window
        d["busy_s"] = _busy(run)
        d["window_s"] = hi - lo
    return d


def _busy(run: Run) -> float:
    from portbench.readers import busy_intervals
    from portbench.stats import covered
    return covered(busy_intervals(run))


def _breakdown(run: Run) -> Dict[str, Any]:
    """The device operations that took most time in the traced window, and
    its longest idle gaps, each named by the benchmark's host span open at its
    middle: the replica thread's (the engine step, the model call's dispatch,
    the read-back, the delivery of a token event), else the gateway call on
    the loop's, else "between engine steps"."""
    from portbench.readers import busy_intervals
    t_open, t_close = run.trace_window
    acc: Dict[str, float] = {}
    for n, a, b in run.device.ops:
        lo, hi = max(a, t_open), min(b, t_close)
        if hi > lo:
            acc[n] = acc.get(n, 0.0) + (hi - lo)
    ops = sorted(acc.items(), key=lambda kv: -kv[1])[:10]
    busy = busy_intervals(run)
    idle, at = [], t_open
    for a, b in busy + [(t_close, t_close)]:
        if a > at:
            idle.append((at, a))
        at = max(at, b)
    idle.sort(key=lambda g: g[0] - g[1])
    rank = {"readback": 4, "model_call": 3, "engine_step": 2, "token_delivery": 1,
            "gateway_call": 0}
    out = []
    for a, b in idle[:10]:
        mid = (a + b) / 2
        open_ = [s for s in run.ins.spans if s.t0 <= mid <= s.t1]
        name = (max(open_, key=lambda s: rank.get(s.name, -1)).name if open_
                else "between engine steps")
        out.append([name, b - a])
    return {"device_ops": [[n, t] for n, t in ops], "idle_gaps": out}


def _judge(run: Run, dev, ctl) -> Dict[str, Any]:
    """The comparison with the plain reference (``check``). In a control run
    the control, the reference in the next lower precision, stands in the
    program's place: the cell's limits hold its ``control_*`` readings, under
    their own names, and the run reads ``correct`` false."""
    from portbench.reference.model import Reference
    spec = run.cell["check"]
    picked = check.sample(run.records, run.seed, spec["requests"])
    truth = run.cfg["serving"]["weights"]
    rule = run.cfg["serving"].get("quant_rule")
    precisions = [truth]
    if ctl is not None:
        precisions.append(ctl["precision"])
        rule = rule or ctl.get("quant_rule")
    stand_in = ctl is not None
    limits = {(k.replace("logit", "control", 1) if stand_in else k): v
              for k, v in spec["limits"].items()}
    checks: Dict[str, Dict[str, float]] = {}
    t0 = time.perf_counter()
    if picked:
        seqs, poss, toks = check.sequences(picked)
        lg = Reference(run.cfg, run.seed, dev, precisions, rule).logits(seqs, poss)
        got = check.readings(lg, truth, toks, precisions[1] if stand_in else None)
        for name, limit in limits.items():
            checks[name] = {"value": got[name], "limit": limit}
        run.notes.setdefault("extra", {}).update(
            {k: v for k, v in got.items() if k not in checks})
        served = sum(len(t) for t in toks)
    else:
        checks.update({k: {"value": float("nan"), "limit": v} for k, v in limits.items()})
        served = 0
    checks["bad_streams"] = {"value": check.bad_streams(run.records, run.shapes.vocab),
                             "limit": 0}
    checks["failed_requests"] = {"value": sum(r.error is not None for r in run.records),
                                 "limit": 0}
    ok = bool(picked) and all(c["value"] <= c["limit"] for c in checks.values())
    run.notes.setdefault("extra", {}).update(
        reference_s=time.perf_counter() - t0, checked_requests=len(picked),
        checked_tokens=served, misindexed_streams=check.misindexed(run.records))
    return {"correct": ok, "checks": checks}
