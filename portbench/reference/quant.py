"""Weight-only quantization as a configuration states it, worked out by the
reference from the bf16 draws: symmetric absmax over a leaf's last axis,
``scale = max(amax, 1e-8) / qmax`` in float32, values rounded half to even
and clipped to +-qmax (127 for int8, 7 for int4), dequantized as
``q * scale``. A leaf takes it when it has at least two dims and
``min_elems`` elements, both counted over the stack of layers it is stored
in (``stacked``; 0: a leaf stored alone)."""
from __future__ import annotations

import torch

QMAX = {"int8": 127.0, "int4": 7.0}


def applies(quant, shape, stacked: int) -> bool:
    if quant is None:
        return False
    numel = 1
    for x in shape:
        numel *= x
    dims = len(shape) + (1 if stacked else 0)
    return dims >= 2 and numel * max(stacked, 1) >= quant["min_elems"]


def dequantized(w: torch.Tensor, precision: str, quant, stacked: int) -> torch.Tensor:
    """``w`` (bf16) in float32 as ``precision`` ("bf16", "int8", "int4")
    stores it."""
    wf = w.float()
    if precision == "bf16" or not applies(quant, w.shape, stacked):
        return wf
    qmax = QMAX[precision]
    scale = torch.clamp_min(wf.abs().amax(dim=-1, keepdim=True), 1e-8) / qmax
    return torch.round(wf / scale).clamp_(-qmax, qmax).mul_(scale)
