#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 14 (distributed training) alone on one
card, after building the flash and SSD kernels and their backwards and
holding phase 2's flash and SSD forward and backward rows (which cover
phase 14's call shapes) against their plain versions:

    python3 chip_dist_train.py                 # flash and SSD rows, then phase 14
    python3 chip_dist_train.py --noflash       # phase 14 alone
    python3 chip_dist_train.py --out FILE      # also write the results as JSON

Prints chip_smoke's phase-14 lines and the phase's seconds. Phase 14
spawns its ranks with the ``spawn`` start method, which imports this module
again in each rank: everything runs under the ``__main__`` guard.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import torch

import chip_smoke as cs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--noflash", action="store_true",
                    help="skip phase 2's flash and SSD rows")
    ap.add_argument("--out", default=None, help="write the results to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_dist_train: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build as kbuild     # chip_smoke put src on the path
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cs.log(f"card: {cs.card_line()}")
    t0 = time.perf_counter()
    kernels = ("flash_attention", "flash_attention_bwd", "ssd_scan", "ssd_scan_bwd")
    kbuild.build(kernels)
    for name in kernels:
        kbuild.load_library(name)
    cs.log(f"built in {time.perf_counter() - t0:.1f} s")
    results = []
    if not args.noflash:
        flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
        cs.run_flash(dev, flush, results)
        cs.run_flash_bwd(dev, flush, results)
        cs.run_ssd(dev, flush, results)
        cs.run_ssd_bwd(dev, flush, results)
        del flush
    t0 = time.perf_counter()
    with cs.served_shapes():
        res = cs.run_dist_training(dev)
    cs.log(f"phase 14 took {time.perf_counter() - t0:.1f} s")
    if results:
        unchecked = {k: sorted(cs.SERVED[k] - cs.CHECKED[k]) for k in kernels}
        assert not any(unchecked.values()), f"phase 14 shapes phase 2 never held: {unchecked}"
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(dict(card=cs.card_line(), cases=results, dist_training=res),
                                  indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
