#!/usr/bin/env python3
"""Time chunked attention's plan constants on one card: the measurements
behind ``SPLIT_MAX_ROWS`` and ``SPLIT_BLOCKS_PER_SM`` in
``src/repro_torch/kernels/paged_attention/kernel.py``.

At Mixtral's width (32 query heads over 8 KV heads of 128, pages of 16, 4
rows, bf16) over a pool row of 512 positions, each chunk width C = 1, 2, 4,
5 and 8 (C * G = 4 to 32 folded rows) is timed on the split path and on the
tensor-core path; over 512 and 4096 positions the decode sweep is timed at
2, 4, 8 and 16 split blocks a SM. Each time is ``chip_smoke.cuda_ms`` of the
launch wrapper alone (cold L2, host dispatch queued out of the events).

    python3 chip_tune.py            # on the card, from the repository root
"""
import sys

import torch

import chip_smoke as cs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_tune: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.paged_attention import chunked_prefill_cuda
    from repro_torch.kernels.paged_attention import kernel as pk
    dev = torch.device("cuda", 0)
    print("card:", cs.card_line(), flush=True)
    flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
    cs.cuda_ms(flush.zero_, flush=flush)
    defaults = pk.SPLIT_MAX_ROWS, pk.SPLIT_BLOCKS_PER_SM

    def time_case(name, C, maxp, num_pages, rows_and_blocks):
        *t, kw = cs.attention_case(dev, B=4, C=C, H=32, Hkv=8, D=128, ps=16, maxp=maxp,
                                   num_pages=num_pages, starts=[s - C for s in (132, 220, 300, 167)]
                                   if maxp == 32 else [4000, 4095, 3900, 4050],
                                   nvalid=[C] * 4, dtype=torch.bfloat16, seed=1)
        q, kp, vp, pt, lengths, qpos = t
        starts = qpos[:, 0].contiguous()
        for max_rows, blocks in rows_and_blocks:
            pk.SPLIT_MAX_ROWS, pk.SPLIT_BLOCKS_PER_SM = max_rows, blocks
            plan = pk.plan_for(q, kp, pt)
            ms = cs.cuda_ms(lambda: chunked_prefill_cuda(q, kp, vp, pt, lengths, starts, **kw),
                            flush=flush)
            print(f"TUNE {name} C={C} rows={4 * C} {plan.path} splits={plan.splits} "
                  f"blocks_per_sm={blocks}: {ms:.5f} ms", flush=True)
        pk.SPLIT_MAX_ROWS, pk.SPLIT_BLOCKS_PER_SM = defaults

    # the split threshold: each width on the split path, then on the tensor cores
    for C in (1, 2, 4, 5, 8):
        time_case("width", C, 32, 256, [(defaults[0], defaults[1]), (0, defaults[1])])
    # the split count: 512 and 4096 positions a row
    for maxp, num_pages in ((32, 256), (256, 1040)):
        time_case(f"positions={maxp * 16}", 1, maxp, num_pages,
                  [(defaults[0], b) for b in (2, 4, 8, 16)])
    return 0


if __name__ == "__main__":
    sys.exit(main())
