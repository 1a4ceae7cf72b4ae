"""Runs one cell of the port's benchmark once, on the card it starts on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as the last line of standard output (one JSON object)
and each number that decided ``correct`` beside its limit as the last lines
of standard error. Exits non-zero, printing no result, without enough CUDA
devices, or if JAX or the JAX package was imported by the time the window
closed. ``--control 1`` puts the cell's control (the check's lower precision) in
the program's place, so that ``correct`` reads false; the benchmark's own
runs leave it off.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _paths() -> None:
    """The checkout's ``src`` (the port) and root (this package) on the
    path, in place of this script's folder (whose module names would shadow
    others); every cache the program writes inside the checkout."""
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p and Path(p).resolve() != Path(here)]
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    cache = ROOT / "build" / "portbench-cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "nv"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    import torch
    from portbench import harness

    bench = harness.load_benchmark(ROOT)
    entry = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if entry is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"needs {entry['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    cell = harness.load("workloads", args.workload)
    cfg = harness.load("configs", entry["config"])
    mix = harness.load("traffic", entry["traffic"])
    torch.cuda.set_device(0)
    out = harness.run_cell(cell, cfg, mix, bench, seed=args.seed, seconds=args.seconds,
                           traced=bool(args.trace), device="cuda:0", t_start=T_START,
                           control=bool(args.control),
                           log=lambda *a: print(*a, file=sys.stderr))
    bad = harness.imported_forbidden()
    if bad:
        print(f"imported after the window: {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
