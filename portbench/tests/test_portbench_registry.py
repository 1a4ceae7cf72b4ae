"""Cells, configurations, traffic mixes and metrics are found by name, and a
later change adds one of each as files, editing none; ``BENCHMARK.json``
keeps to the benchmark's contract."""
from __future__ import annotations

import hashlib
import json
import re
import shutil
import time

from portbench import harness
from portbench.tests.conftest import PB, ROOT, TINY_MIX, tiny_cell, tiny_config

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return harness.load_benchmark(ROOT)


def test_every_entry_loads_by_name():
    b = bench()
    names = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        cfg = json.load(open(ROOT / c["file"]))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    for w in b["workloads"]:
        cell = harness.load("workloads", w["name"])
        assert cell["config"] == w["config"] in names and cell["traffic"] == w["traffic"]
        harness.load("traffic", w["traffic"])
        harness.load("configs", w["config"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_benchmark_keeps_to_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"][1].startswith("portbench/")
    assert 1 <= b["run_seconds"] <= 51
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and 1 <= len(c["why"]) <= 200
        assert c["file"].startswith("portbench/")
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
        assert w["chips"] == 1
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                  "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:       # setup_s, another end-to-end metric, a per-layer one
        got = {m["name"] for m in harness.cell_metrics(b, cell, False)}
        assert "setup_s" in got and len(got) >= 2
        assert harness.cell_metrics(b, cell, True)
    assert len(json.dumps(b)) < 64 * 1024


def digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_config_and_metric_are_files_alone(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a cell
    and a per-layer metric as new files (and their entries in
    ``BENCHMARK.json``); the run finds them by name and no file of the
    benchmark changes."""
    before = digest(PB)
    root = tmp_path / "portbench"
    shutil.copytree(PB, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = tiny_config("mixtral-8x7b-int8")
    cfg["name"] = "tiny-moe"
    (root / "configs" / "tiny-moe.json").write_text(json.dumps(cfg))
    (root / "traffic" / "tinychat.json").write_text(json.dumps(TINY_MIX))
    cell = tiny_cell("mixtral-8x7b-int8.chat64")
    cell.update(name="tiny-moe.tinychat", config="tiny-moe", traffic="tinychat")
    (root / "workloads" / "tiny-moe.tinychat.json").write_text(json.dumps(cell))
    (root / "metrics" / "decode_rows.tinychat.py").write_text(
        "def read(run):\n    return sum(s.decode_rows for s in run.steps) or None\n")
    b = bench()
    b["workloads"].append({"name": "tiny-moe.tinychat", "config": "tiny-moe",
                           "traffic": "tinychat", "chips": 1, "why": "test"})
    for m in b["end_to_end"]:
        if m["name"] == "output_tok_s":
            m["workloads"].append("tiny-moe.tinychat")
    b["per_layer"].append({"name": "decode_rows.tinychat", "unit": "rows", "better": "higher",
                           "source": "program_counter", "layer": "engine step",
                           "moves": "output_tok_s", "workloads": ["tiny-moe.tinychat"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    b2 = harness.load_benchmark(tmp_path)
    cell2 = harness.load("workloads", "tiny-moe.tinychat", root)
    mix = harness.load("traffic", cell2["traffic"], root)
    cfg2 = harness.load("configs", cell2["config"], root)
    assert [m["name"] for m in harness.cell_metrics(b2, "tiny-moe.tinychat", True)] == [
        "decode_rows.tinychat"]
    out = harness.run_cell(cell2, cfg2, mix, b2, seed=5, seconds=1.5, traced=False,
                           device="cpu", t_start=time.perf_counter(), root=root)
    assert set(out["metrics"]) == {"output_tok_s", "setup_s"}
    out = harness.run_cell(cell2, cfg2, mix, b2, seed=6, seconds=1.5, traced=True,
                           device="cpu", t_start=time.perf_counter(), root=root)
    assert set(out["metrics"]) == {"decode_rows.tinychat"}
    assert out["metrics"]["decode_rows.tinychat"]["value"] > 0
    assert digest(PB) == before
