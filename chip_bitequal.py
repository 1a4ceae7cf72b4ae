#!/usr/bin/env python3
"""Hold one tree's attention kernels bit for bit against another's (a
change against its parent) on one card: chunked attention on each of its
three paths and paged decode, at the default head fold (every kv head of
the pool read), on the same seeded inputs.

    python3 chip_bitequal.py TREE OUT.pt        # TREE's kernels: save outputs
    python3 chip_bitequal.py --compare A.pt B.pt

Run the first form once per tree, each in its own process (the two trees'
packages share a name), then the second: it prints one ``BITEQUAL`` line
and exits non-zero if any output differs in a bit.
"""
import sys
from pathlib import Path

import torch

# (name, B, C, H, Hkv, D, ps, maxp, starts, nvalid, dtypes): the decode
# sweep and a 4-token verify (split), the prefill pack (mma in bf16, tiled
# in fp32), a long context, the small head dims with a window
CASES = [("decode", 4, 1, 32, 8, 128, 16, 32, [131, 219, 299, 166], [1, 1, 1, 1]),
         ("decode C=4", 4, 4, 32, 8, 128, 16, 32, [128, 216, 296, 163], [4, 4, 4, 4]),
         ("prefill", 2, 128, 32, 8, 128, 16, 32, [0, 128], [128, 100]),
         ("decode long", 4, 1, 32, 8, 128, 16, 256, [4000, 4095, 3900, 4050], [1, 1, 1, 1]),
         ("edge D=16", 4, 24, 4, 2, 16, 8, 8, [5, 0, 13, 0], [8, 6, 3, 0]),
         ("pack D=64", 2, 128, 16, 16, 64, 16, 32, [0, 128], [128, 97]),
         ("pack D=96", 2, 128, 32, 32, 96, 16, 32, [0, 128], [128, 97])]


def run(tree: Path, out: Path) -> None:
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels.paged_attention.kernel import (chunked_prefill_cuda,
                                                            paged_attention_cuda)
    dev = torch.device("cuda", 0)
    res = {}
    for name, B, C, H, Hkv, D, ps, maxp, starts, nvalid in CASES:
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device=dev).manual_seed(B * C + maxp + D)
            P = B * maxp + 1
            q = torch.randn((B, C, H, D), generator=g, device=dev).to(dtype)
            kp, vp = (torch.randn((P, ps, Hkv, D), generator=g, device=dev).to(dtype)
                      for _ in range(2))
            pt = (torch.randperm(P - 1, generator=g, device=dev) + 1).reshape(B, maxp).int()
            st = torch.tensor(starts, dtype=torch.int32, device=dev)
            lengths = st + torch.tensor(nvalid, dtype=torch.int32, device=dev)
            for window, softcap in ((0, 0.0), (5, 30.0)):
                kw = dict(scale=D ** -0.5, softcap=softcap, window=window)
                key = f"{name} {str(dtype)[6:]} window={window}"
                res[f"chunked {key}"] = chunked_prefill_cuda(q, kp, vp, pt, lengths, st,
                                                             **kw).cpu()
                if C == 1:
                    res[f"paged {key}"] = paged_attention_cuda(q[:, 0].contiguous(), kp, vp, pt,
                                                               lengths, **kw).cpu()
    torch.cuda.synchronize()
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save(res, out)
    print(f"saved {len(res)} outputs of {tree} to {out}")


def compare(a: Path, b: Path) -> int:
    ra, rb = torch.load(a), torch.load(b)
    differ = sorted(k for k in ra if k not in rb or not torch.equal(ra[k], rb[k]))
    print(f"BITEQUAL {len(ra) - len(differ)} of {len(ra)} outputs bit-equal"
          + (f"; differ: {differ}" if differ else ""))
    return 1 if differ or set(ra) != set(rb) else 0


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        sys.exit(compare(Path(sys.argv[2]), Path(sys.argv[3])))
    run(Path(sys.argv[1]).resolve(), Path(sys.argv[2]))
