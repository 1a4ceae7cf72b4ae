"""The metric arithmetic, on synthetic runs: a rate is all the window's work
over all its seconds, a tail is taken over every sample of the window, a
stall placed inside the window moves both, a request still waiting at the
close counts with the time it waited, a failed one counts beyond every
tail; the traced readers' shares of rooflines and of the window."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import harness, readers, roofline, stats
from portbench.client import ClientRecord
from portbench.trace import DeviceTrace, Instruments
from portbench.weights import Shapes
from portbench.tests.conftest import tiny_config


def rec(i, t_submit, times, n=None, finished=None, prompt=10):
    r = ClientRecord(f"c{i}-{i}", i, i, np.ones(prompt, np.int32), n or len(times))
    r.t_submit = t_submit
    r.times = list(times)
    r.tokens = [1] * len(times)
    r.finished = len(times) == r.max_new_tokens if finished is None else finished
    r.t_finish = times[-1] if r.finished and times else 0.0
    return r


def run_of(records, t_open=10.0, t_close=20.0, steps=()):
    cfg = tiny_config("mixtral-8x7b-int8")
    return harness.Run({}, cfg, Shapes.of(cfg), {}, 0, t_open, t_open, t_close, records, {},
                       list(steps))


def read(name, run):
    return harness.reader(name)(run)


def steady(step=0.1, clients=8, t_end=30.0):
    """Clients each receiving a token every ``step`` from t = 1."""
    return [rec(i, 0.5, np.arange(1.0, t_end, step), n=10**6, finished=False)
            for i in range(clients)]


def test_rate_is_all_tokens_over_all_seconds():
    run = run_of(steady())
    want = sum(1 for r in run.records for t in r.times if 10 <= t <= 20) / 10.0
    assert read("output_tok_s", run) == pytest.approx(want)
    assert want == pytest.approx(8 / 0.1, rel=0.02)


def test_stall_in_window_moves_rate_and_tail():
    base = run_of(steady())
    stalled = steady()
    for r in stalled:     # a 2 s stall at t = 14: every later token comes 2 s late
        r.times = [t if t < 14 else t + 2.0 for t in r.times]
    run = run_of(stalled)
    assert read("output_tok_s", run) == pytest.approx(0.8 * read("output_tok_s", base), rel=0.02)
    assert read("itl_p99_ms", base) == pytest.approx(100.0)
    assert read("itl_p99_ms", run) > 10 * read("itl_p99_ms", base)


def test_tails_are_over_all_samples_not_chunk_medians():
    gaps = [0.1] * 95 + [2.0] * 5      # 5% of gaps long: p99 sees them
    t, times = 10.0, []
    for g in gaps:
        t += g
        times.append(t)
    run = run_of([rec(0, 9.0, [9.5] + times, n=10**6, finished=False)], t_close=t + 0.01)
    assert read("itl_p99_ms", run) == pytest.approx(2000.0, rel=1e-6)
    assert stats.percentile(gaps, 50) == pytest.approx(0.1)


def test_ttft_counts_waiting_and_failed_requests():
    recs = [rec(i, 10.0 + i, [10.5 + i, 11 + i], n=2) for i in range(9)]
    waiting = rec(9, 12.0, [], n=5, finished=False)
    recs.append(waiting)
    run = run_of(recs)
    v = stats.ttfts(run.records, 10.0, 20.0)
    assert sorted(v)[-1] == pytest.approx(8.0)       # waited from 12 to the close
    assert read("ttft_p90_ms.chat", run) == pytest.approx(
        1e3 * stats.percentile([0.5] * 9 + [8.0], 90))
    recs[0].error = "rejected"
    recs[1].error = "rejected"
    assert read("ttft_p90_ms.docqa", run_of(recs)) == stats.FAILED


def test_prompt_rate_counts_first_tokens_in_window():
    recs = [rec(i, 9.0, [9.5 + i, 30.0], n=2, prompt=100 + i) for i in range(15)]
    run = run_of(recs)
    want = sum(100 + i for i in range(15) if 10 <= 9.5 + i <= 20) / 10.0
    assert read("prompt_tok_s", run) == pytest.approx(want)


class Step:
    def __init__(self, t0):
        self.t0 = t0


def test_step_ms_is_window_over_iterations():
    run = run_of(steady(), steps=[Step(t) for t in np.arange(0, 30, 0.25)])
    assert read("step_ms.chat", run) == pytest.approx(250.0, rel=1e-9)


def traced_run(ops, gmm=(), t_open=10.0, t_close=11.0):
    run = run_of([], t_open, t_close)
    run.ins = Instruments()
    run.ins.gmm = list(gmm)
    run.device = DeviceTrace(ops=list(ops), t_open=t_open, t_close=t_close,
                             t_marked_close=t_close)
    return run


def test_device_idle_is_the_union_of_operations():
    ops = [("a", 10.0, 10.2), ("b", 10.1, 10.3), ("c", 10.5, 10.6), ("d", 9.0, 10.05)]
    run = traced_run(ops)
    assert read("device_idle.chat", run) == pytest.approx(100 * (1 - 0.4))


def test_gmm_roofline_is_bound_over_kernel_time():
    M, K, N, E = 256, 4096, 14336, 8
    b, f = roofline.gmm_cost(M, K, N, E, 8, True)
    bound = roofline.bound_s(b, f)[0]
    ops = [("void gmm_mma_kernel<signed char>", 10.1, 10.1 + 2 * bound),
           ("void split_reduce_kernel<bf16>", 10.1 + 2 * bound, 10.1 + 4 * bound),
           ("void w8a16_mma_kernel", 10.5, 10.6)]
    run = traced_run(ops, gmm=[(M, K, N, E, True, torch.tensor([32] * 8))])
    assert read("gmm_roofline.chat", run) == pytest.approx(25.0)
    assert readers.family_ops(run)["w8a16"] == [(10.5, 10.6)]


def test_readers_return_nothing_without_a_trace():
    run = run_of(steady())
    for name in ("gmm_roofline.chat", "w8a16_roofline.chat", "attn_roofline.docqa",
                 "mfu.chat", "device_idle.chat"):
        assert read(name, run) is None


def test_mfu_is_bound_time_over_the_window():
    run = traced_run([])
    run.ins.calls = [(10.2, np.array([0, 100]), np.array([128, 1]))] * 4
    s = run.shapes
    b, f = roofline.model_call_cost(s, [0, 100], [128, 1], run.cfg["serving"]["quant_rule"])
    assert read("mfu.chat", run) == pytest.approx(100 * 4 * roofline.bound_s(b, f)[0] / 1.0)


def test_traced_run_reads_the_device_in_its_traced_window():
    """A traced run: the device's readers read the traced window that
    follows the run's window, the host clock's and the step ring's readers
    the run's own window, where no tracer was on."""
    steps = [Step(t) for t in np.arange(0, 10, 0.5)] + [Step(t) for t in np.arange(10, 13, 1.5)]
    run = run_of(steady(), 0.0, 10.0, steps=steps)
    run.ins = Instruments(t_open=10.5, t_close=12.5)
    run.device = DeviceTrace(ops=[("a", 11.0, 11.5), ("b", 5.0, 6.0)], t_open=10.5,
                             t_close=12.5, t_marked_close=12.5)
    assert run.trace_window == (10.5, 12.5)
    assert read("device_idle.chat", run) == pytest.approx(75.0)
    assert read("step_ms.chat", run) == pytest.approx(500.0)
    assert harness._device(torch.device("cpu"), 0, run)["window_s"] == pytest.approx(2.0)
