"""Aggregate the dry-run's JSONs (``launch.dryrun``) into the roofline and
dry-run tables, with the columns of ``repro.launch.report``: the JSONs keep
the reference's keys, so the same tables read them. Run it as
``python -m repro_torch.launch.report --dir experiments/dryrun_torch``
(``--kind roofline`` or ``dryrun``)."""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List


def load_cells(dryrun_dir: str) -> List[dict]:
    cells = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(path) as f:
            d = json.load(f)
        d["_file"] = os.path.basename(path)
        cells.append(d)
    return cells


def _fmt_s(x) -> str:
    if x is None:
        return "-"
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.2f}ms"
    return f"{x*1e6:.0f}us"


def _fmt_b(x) -> str:
    if x is None:
        return "-"
    for unit, div in (("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if x >= div:
            return f"{x/div:.2f}{unit}"
    return f"{x:.0f}B"


def roofline_table(cells: List[dict], *, moe: str = "tp") -> str:
    rows = ["| arch | shape | dominant | compute | memory (ub) | mem floor | collective | useful | roofline-frac | HBM args+temp |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for d in cells:
        if d.get("multi_pod") or d.get("seq_shard"):
            continue
        if d.get("moe") not in (None, moe):
            continue
        # baseline table: exclude hillclimb variants
        if (d.get("quant") not in (None, "none") or d.get("exp4")
                or d.get("xent_chunk") or (d.get("microbatches") or 1) > 1):
            continue
        if "skipped" in d:
            rows.append(f"| {d['arch']} | {d['shape']} | SKIP | - | - | - | - | - | - | {d['skipped'][:40]}... |")
            continue
        if "roofline" not in d:
            continue
        r = d["roofline"]
        mem = d.get("memory", {})
        hbm = (mem.get("argument_bytes") or 0) + (mem.get("temp_bytes") or 0)
        rows.append(
            f"| {d['arch']} | {d['shape']} | **{r['dominant']}** "
            f"| {_fmt_s(r['compute_s'])} | {_fmt_s(r['memory_s'])} "
            f"| {_fmt_s(r.get('memory_floor_s'))} | {_fmt_s(r['collective_s'])} "
            f"| {d.get('useful_ratio', 0):.2f} | {d.get('roofline_fraction', 0):.4f} "
            f"| {_fmt_b(hbm)} |")
    return "\n".join(rows)


def dryrun_table(cells: List[dict]) -> str:
    rows = ["| arch | shape | mesh | compiled | lower | compile | args/dev | temp/dev | collectives seen |",
            "|---|---|---|---|---|---|---|---|---|"]
    for d in cells:
        if d.get("seq_shard") or d.get("moe") == "ep":
            continue
        if (d.get("quant") not in (None, "none") or d.get("exp4")
                or d.get("xent_chunk") or (d.get("microbatches") or 1) > 1):
            continue
        mesh = "2x16x16" if d.get("multi_pod") else "16x16"
        if "skipped" in d:
            rows.append(f"| {d['arch']} | {d['shape']} | {mesh} | SKIP | - | - | - | - | {d['skipped'][:36]} |")
            continue
        mem = d.get("memory", {})
        coll = d.get("collectives", {})
        kinds = ",".join(k for k in ("all-gather", "all-reduce", "reduce-scatter",
                                     "all-to-all", "collective-permute")
                         if coll.get(k, 0) > 0) or "(cost probes skipped)" if not coll else \
            ",".join(k for k in ("all-gather", "all-reduce", "reduce-scatter",
                                 "all-to-all", "collective-permute") if coll.get(k, 0) > 0)
        rows.append(
            f"| {d['arch']} | {d['shape']} | {mesh} | {'yes' if d.get('compiled_ok') else 'NO'} "
            f"| {d.get('lower_s', 0):.1f}s | {d.get('compile_s', 0):.1f}s "
            f"| {_fmt_b(mem.get('argument_bytes'))} | {_fmt_b(mem.get('temp_bytes'))} | {kinds} |")
    return "\n".join(rows)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--kind", default="roofline", choices=["roofline", "dryrun"])
    ap.add_argument("--moe", default="tp")
    args = ap.parse_args()
    cells = load_cells(args.dir)
    if args.kind == "roofline":
        print(roofline_table(cells, moe=args.moe))
    else:
        print(dryrun_table(cells))


if __name__ == "__main__":
    main()
