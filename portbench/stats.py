"""The metric arithmetic the readers share. A rate is all the work of the
window over all its seconds; a tail is taken over every sample of the
window, never from medians of parts of it. A request that failed counts as
beyond every tail (``FAILED``)."""
from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

FAILED = math.inf


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile (linear interpolation between closest ranks, as
    numpy's default), or None without samples. A tail that lands among
    failed samples reads ``FAILED``."""
    v = np.sort(np.asarray(list(values), dtype=np.float64))
    if v.size == 0:
        return None
    pos = (v.size - 1) * q / 100.0
    lo, hi = int(math.floor(pos)), int(math.ceil(pos))
    if math.isinf(v[hi]):
        return FAILED
    return float(v[lo] + (v[hi] - v[lo]) * (pos - lo))


def ttfts(records, t_open: float, t_close: float) -> List[float]:
    """Submit to first token of every request submitted in the window; a
    request still waiting at the close counts with the time it waited."""
    out = []
    for r in records:
        if not (t_open <= r.t_submit < t_close):
            continue
        if r.error is not None:
            out.append(FAILED)
        elif r.times and r.times[0] <= t_close:
            out.append(r.times[0] - r.t_submit)
        else:
            out.append(t_close - r.t_submit)
    return out


def gaps(records, t_open: float, t_close: float) -> List[float]:
    """Gaps between consecutive tokens of a request as its client received
    them, each gap that ends in the window, and the open gap of every
    request still streaming at the close (its time since its last token)."""
    out = []
    for r in records:
        ts = [t for t in r.times if t <= t_close]
        for a, b in zip(ts, ts[1:]):
            if b >= t_open:
                out.append(b - a)
        if ts and r.error is None and not (r.finished and r.t_finish <= t_close):
            out.append(t_close - ts[-1])
    return out


def tokens_in(records, t_open: float, t_close: float) -> int:
    return sum(1 for r in records for t in r.times if t_open <= t <= t_close)


def union(intervals: Iterable[Tuple[float, float]], lo: float,
          hi: float) -> List[Tuple[float, float]]:
    """The union of intervals, clipped to [lo, hi], as disjoint intervals."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def covered(intervals: Sequence[Tuple[float, float]]) -> float:
    return sum(b - a for a, b in intervals)
