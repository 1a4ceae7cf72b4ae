"""What the per-layer metrics read, shared by the readers in ``metrics/``:
in the run's window (untraced), the program's stamps, the engine's step
ring and the model calls' count against the chip's peaks; in the traced
window, the device operations by kernel family against the operations and
bytes of the calls that launched them, and the device's busy time. Each
returns None where the run holds nothing to read."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from portbench import roofline
from portbench.stats import covered, percentile, ttfts, union

# kernel families by the names of the port's CUDA kernels (csrc/); the split
# reduce that gemm_common.cuh shares belongs to the matmul launched before it
FAMILIES = {"gmm": ("gmm_",), "w8a16": ("w8a16_",), "attn": ("chunked_",)}
SHARED = ("split_reduce_kernel",)


def _first_in_window(run):
    """(client record, the gateway's Request) of each request whose first
    token reached its client in the window and that the engine admitted."""
    for r in run.records:
        g = run.server.get(r.req_id)
        if g is not None and g.t2 and r.times and run.t_open <= r.times[0] <= run.t_close:
            yield r, g


def gateway_ms(run) -> Optional[float]:
    """The paper's gateway latency (t2 - t0) + (t5 - t3 where t5 > t3), t0 /
    t5 the client's stamps, t1 .. t3 the program's Figure-4 stamps on the
    gateway's ``Request`` (joined by id, as ``merge_engine_timestamps``
    does); the median over the window's requests."""
    vals = [(g.t2 - r.t_submit) + (r.times[0] - g.t3 if g.t3 and r.times[0] > g.t3 else 0.0)
            for r, g in _first_in_window(run)]
    p = percentile(vals, 50)
    return None if p is None else 1e3 * p


def queue_wait_ms(run) -> Optional[float]:
    """t2 - t1 (the gateway had it -> the engine admitted it), the 90th
    percentile over the window's requests."""
    p = percentile([g.t2 - g.t1 for _, g in _first_in_window(run)], 90)
    return None if p is None else 1e3 * p


def ttft_ms(run) -> Optional[float]:
    """90th percentile of client submit -> first token over every request
    submitted in the window (``stats.ttfts``)."""
    p = percentile(ttfts(run.records, run.t_open, run.t_close), 90)
    return None if p is None else 1e3 * p


def step_ms(run) -> Optional[float]:
    """The window's wall time over the engine iterations that began in it."""
    n = sum(1 for s in run.steps if run.t_open <= s.t0 < run.t_close)
    return 1e3 * run.window_s / n if n else None


def _family(name: str) -> Optional[str]:
    if any(k in name for k in SHARED):
        return "shared"
    return next((f for f, keys in FAMILIES.items() if any(k in name for k in keys)), None)


def family_ops(run) -> Dict[str, List[Tuple[float, float]]]:
    """Device intervals of each kernel family between the traced window's
    opening and the mark after its close (the last engine step's kernels whole);
    worked out once a run."""
    if "family_ops" in run.notes:
        return run.notes["family_ops"]
    out: Dict[str, List[Tuple[float, float]]] = {k: [] for k in FAMILIES}
    names: Dict[str, Optional[str]] = {}
    last = None
    for name, a, b in run.device.ops:
        fam = names.get(name, 0)
        if fam == 0:
            fam = names[name] = _family(name)
        if fam == "shared":
            fam = last
        elif fam is not None:
            last = fam
        if fam is not None:
            out[fam].append((a, b))
    run.notes["family_ops"] = out
    return out


def _device_s(run, fam: str) -> float:
    return covered(union(family_ops(run)[fam], run.device.t_open, run.device.t_marked_close))


def _share(bound: float, device_s: float) -> Optional[float]:
    return 100.0 * bound / device_s if bound > 0 and device_s > 0 else None


def gmm_roofline(run) -> Optional[float]:
    if run.device is None or not run.ins.gmm:
        return None
    active = torch.stack([torch.count_nonzero(c[5]) for c in run.ins.gmm]).cpu().tolist()
    bound = sum(roofline.bound_s(*roofline.gmm_cost(M, K, N, E, a, int8))[0]
                for (M, K, N, E, int8, _), a in zip(run.ins.gmm, active))
    return _share(bound, _device_s(run, "gmm"))


def w8a16_roofline(run) -> Optional[float]:
    if run.device is None or not run.ins.w8a16:
        return None
    bound = sum(roofline.bound_s(*roofline.w8a16_cost(*c))[0] for c in run.ins.w8a16)
    return _share(bound, _device_s(run, "w8a16"))


def attn_roofline(run) -> Optional[float]:
    if run.device is None or not run.ins.attn:
        return None
    memo = {}        # the layers of one model call share its lengths and positions
    costs = []
    for shape, ps, hkv, kv_b, q_b, win, lengths, qpos in run.ins.attn:
        key = (shape, ps, hkv, kv_b, q_b, win, id(lengths), id(qpos))
        if key not in memo:
            memo[key] = roofline.attention_cost(shape, ps, hkv, kv_b, lengths, qpos,
                                                q_bytes=q_b, window=win)
        costs.append(memo[key])
    nbytes = torch.stack([torch.as_tensor(b).double() for b, _ in costs]).cpu()
    flops = torch.stack([torch.as_tensor(f).double() for _, f in costs]).cpu()
    bound = sum(roofline.bound_s(float(b), float(f))[0] for b, f in zip(nbytes, flops))
    return _share(bound, _device_s(run, "attn"))


def mfu(run) -> Optional[float]:
    """The model calls of the (untraced) window: the sum of each call's least time on
    the chip (its operations at the bf16 peak, or its bytes at the HBM
    bandwidth, whichever is longer) over the window's seconds. Notes which
    term bounds the most of that sum."""
    if run.device is None:           # no card, no share of its peak
        return None
    serving = run.cfg["serving"]
    rule = serving.get("quant_rule") if serving["weights"] == "int8" else None
    total, by = 0.0, {"bytes": 0.0, "operations": 0.0}
    for t, starts, nvalid in run.ins.calls:
        if not run.t_open <= t < run.t_close:
            continue
        b, term = roofline.bound_s(*roofline.model_call_cost(run.shapes, starts, nvalid, rule))
        total += b
        by[term] += b
    if total <= 0:
        return None
    run.notes.setdefault("extra", {})["mfu_bound_by"] = max(by, key=by.get)
    return 100.0 * total / run.window_s


def busy_intervals(run) -> List[Tuple[float, float]]:
    """The traced window's time with a device operation running, as
    disjoint intervals; worked out once a run."""
    if "busy" not in run.notes:
        run.notes["busy"] = union(((a, b) for _, a, b in run.device.ops), *run.trace_window)
    return run.notes["busy"]


def device_idle(run) -> Optional[float]:
    """The share of the traced window in which no device operation ran."""
    if run.device is None:
        return None
    lo, hi = run.trace_window
    return 100.0 * (1.0 - covered(busy_intervals(run)) / (hi - lo))
