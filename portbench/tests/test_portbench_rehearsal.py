"""The whole run on the CPU at a tiny size, the harness's look for a chip
skipped: client -> gateway -> router -> replica -> engine -> the port's
plain kernels, the window, the metrics and the check against the reference.
A sound run comes out correct, traced or not; with the timed path broken
underneath, ``correct`` comes out false, once for each fault a served cell
can have on one chip:

  - a step that returns its state unchanged: each model call's writes to
    the KV pool are undone;
  - half of the batch left out: every other row of each model call feeds no
    token, and its logits are what the rest leave;
  - a token altered where it is produced: the engine's sampler returns the
    next token id.

The fourth fault, the exchange between chips left out, has no place in a
cell on one chip.

The control at a small size (d_model 512, 4 layers): the reference in the
next lower precision (mixtral's int8 -> int4) reads mean gaps well above a
sound run's; a control run reads ``correct`` false.

The runs and faults above also go through a deepseek-shaped model (a dense
first layer, shared experts), served with its top-k weights renormalized,
as the port routes every model (its published configuration does not
renormalize, so it has no cell)."""
from __future__ import annotations

import time

import numpy as np
import pytest

from portbench import harness
from portbench.tests.conftest import TINY_MIX, tiny_cell, tiny_config

CELL = "mixtral-8x7b-int8.chat64"
CELLS = {"mixtral": "mixtral-8x7b-int8", "deepseek": "deepseek-moe-16b-bf16"}


def run(kind, seed=11, traced=False, control=False, seconds=1.5, **size):
    cfg = tiny_config(CELLS[kind], **size)
    cfg["norm_topk_prob"] = True
    return harness.run_cell(tiny_cell(CELL), cfg, TINY_MIX,
                            harness.load_benchmark(), seed=seed, seconds=seconds,
                            traced=traced, device="cpu", t_start=time.perf_counter(),
                            control=control)


@pytest.mark.parametrize("kind", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_sound_run_is_correct(kind, traced):
    out = run(kind, traced=traced)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0 and out["checked_tokens"] > 0
    assert list(out)[-1] == "checks"
    want = {m["name"] for m in harness.cell_metrics(harness.load_benchmark(), CELL, traced)}
    got = set(out["metrics"])
    if traced:        # the device's readers need the card
        device = {m for m in want if m.split(".")[0] in ("gmm_roofline", "w8a16_roofline",
                                                          "mfu", "device_idle")}
        assert got == want - device and "step_ms.chat" in got
    else:
        assert got == want


def _pool_tensors(cache):
    out = []
    for group in cache["groups"]:
        for c in group:
            out += list(c.get("attn", {}).values())
    return out


def state_unchanged(monkeypatch):
    from repro_torch.models.transformer import LM
    orig = LM.decode_chunk

    def broken(self, params, tokens, cache, *a, **k):
        saved = [t.clone() for t in _pool_tensors(cache)]
        out = orig(self, params, tokens, cache, *a, **k)
        for t, s in zip(_pool_tensors(cache), saved):
            t.copy_(s)
        return out
    monkeypatch.setattr(LM, "decode_chunk", broken)


def half_batch(monkeypatch):
    from repro_torch.models.transformer import LM
    orig = LM.decode_chunk

    def broken(self, params, tokens, cache, starts, nvalid, *a, **k):
        nvalid = nvalid.clone()
        nvalid[1::2] = 0
        return orig(self, params, tokens, cache, starts, nvalid, *a, **k)
    monkeypatch.setattr(LM, "decode_chunk", broken)


def altered_token(monkeypatch):
    from repro_torch.core import engine
    orig = engine.sample_tokens

    def broken(logits, *a, **k):
        return (orig(logits, *a, **k) + 1) % logits.shape[-1]
    monkeypatch.setattr(engine, "sample_tokens", broken)


@pytest.mark.parametrize("kind", CELLS)
@pytest.mark.parametrize("fault", [state_unchanged, half_batch, altered_token],
                         ids=lambda f: f.__name__)
def test_fault_makes_the_run_incorrect(kind, fault, monkeypatch):
    fault(monkeypatch)
    out = run(kind)
    assert not out["correct"], out["checks"]


def test_control_reads_far_above_a_sound_run():
    seeds = (11, 12, 13)
    size = dict(seconds=2.5, d=512, layers=4)
    ctl = [mean_gap(run("mixtral", seed=s, control=True, **size), "control") for s in seeds]
    sound = [mean_gap(run("mixtral", seed=s, **size)) for s in seeds]
    assert np.median(ctl) > 3 * np.median(sound), (ctl, sound)


def test_control_run_reads_incorrect(monkeypatch):
    """A control run holds the control to the cell's limits in the
    program's place: with the limit between the sound and the control
    readings, the sound run passes and the control run fails."""
    from portbench import check
    monkeypatch.setattr(check, "summary", lambda g, prefix: {
        f"{prefix}_mean_gap": 0.01 if prefix == "logit" else 1.0})
    sound, ctl = run("mixtral"), run("mixtral", control=True)
    assert sound["correct"] and sound["checks"]["logit_mean_gap"]["value"] == 0.01
    assert not ctl["correct"], ctl["checks"]
    assert ctl["checks"]["control_mean_gap"] == {"value": 1.0, "limit": 0.35}
    assert ctl["logit_mean_gap"] == 0.01 and "logit_mean_gap" not in ctl["checks"]


def mean_gap(out, prefix="logit"):
    """The mean gap, among the compared numbers or beside them."""
    c = out["checks"].get(f"{prefix}_mean_gap")
    return c["value"] if c is not None else out[f"{prefix}_mean_gap"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["mixtral-8x7b-int8.chat64", "mixtral-8x7b-int8.docqa16"])
def test_control_fails_at_the_cells_own_size(card, cell):
    """On the card: the cell's control, at the cell's own size and load, in
    the program's place, makes the run read ``correct`` false (the readings
    in PERF.md come from this call's path: ``run.py --control 1``)."""
    b = harness.load_benchmark()
    entry = {w["name"]: w for w in b["workloads"]}[cell]
    c = harness.load("workloads", cell)
    out = harness.run_cell(c, harness.load("configs", entry["config"]),
                           harness.load("traffic", entry["traffic"]), b, seed=2**31 + 99,
                           seconds=b["run_seconds"], traced=False, device=card,
                           t_start=time.perf_counter(), control=True)
    assert not out["correct"], out["checks"]


def test_open_loop_mix_runs_on_data_alone():
    """A traffic file with ``arrival_rate`` (and bursts) drives the open
    loop: requests go out on the schedule, each timed from its due time."""
    mix = dict(TINY_MIX, arrival_rate=20.0, burst_mult=3.0, burst_period_s=1.0,
               burst_duty=0.3, ramp_s=0.3)
    out = harness.run_cell(tiny_cell(CELL), tiny_config(CELLS["mixtral"]),
                           mix, harness.load_benchmark(), seed=4, seconds=1.5, traced=False,
                           device="cpu", t_start=time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["attempted"] > 10 and out["metrics"]["output_tok_s"]["value"] > 0
