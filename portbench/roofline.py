"""The yardstick's arithmetic: the H100's published peaks, each kernel's
operations and bytes (a frozen copy of ``chip_smoke.py``'s bound
arithmetic: each input read once, each output written once, only the
experts that hold rows), and the whole model call's operations and bytes
(from the rows the engine fed and the configuration's shapes: weights read
once a call, the KV cache read and written).

Peaks: NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense
(the same figures as the port's ``launch/roofline.py``). int8 weights are
counted against the bf16 peak: the kernels multiply in bf16.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from portbench.weights import Shapes

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, flops: float, dtype: str = "bfloat16") -> Tuple[float, str]:
    """The least time the chip could take, and which term sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------ kernels
def gmm_cost(M: int, K: int, N: int, E: int, active: int, int8: bool,
             x_bytes: int = 2) -> Tuple[float, float]:
    """(bytes, operations) of one grouped matmul: x and out once, the weights
    of the ``active`` experts (those holding rows) once (int8 values with an
    fp32 scale a row), the group sizes (int64)."""
    wbytes = active * K * (N + 4) if int8 else active * K * N * x_bytes
    return (M * K + M * N) * x_bytes + wbytes + E * 8, 2.0 * M * K * N


def w8a16_cost(M: int, K: int, N: int, G: int, x_bytes: int = 2) -> Tuple[float, float]:
    """(bytes, operations) of one w8a16 matmul: x and out once in x's dtype,
    the int8 weights and the fp32 row scales (K, G) once."""
    return M * K * x_bytes + K * N + 4 * K * G + M * N * x_bytes, 2.0 * M * K * N


def attention_cost(q_shape: Sequence[int], page_size: int, kv_heads: int, kv_bytes: int,
                   lengths, qpos, q_bytes: int = 2, window: int = 0):
    """(bytes, operations) of one chunked attention call, as tensors (so a
    caller on the card needs no sync): q and out once; K and V once at each
    position some query of the row can see, and the page ids of those
    positions' pages; 4 D operations per visible (query head, key) pair.
    ``lengths`` (B,), ``qpos`` (B, C) absolute query positions."""
    import torch
    B, C, H, D = q_shape
    ps = page_size
    L, pos = lengths.long(), qpos.long()
    hi = torch.minimum(L, pos[:, -1] + 1)
    lo = (pos[:, 0] - window + 1).clamp_min(0) if window else torch.zeros_like(hi)
    keys = (hi - lo).clamp_min(0)
    pages = torch.where(keys > 0, (hi + ps - 1) // ps - lo // ps, 0)
    nbytes = (2 * B * C * H * D * q_bytes + 2 * keys.sum() * kv_heads * D * kv_bytes
              + 4 * pages.sum())
    q_lo = (pos - window + 1).clamp_min(0) if window else torch.zeros_like(pos)
    vis = (torch.minimum(pos + 1, L[:, None]) - q_lo).clamp_min(0).sum()
    return nbytes, 4.0 * D * H * vis


# ------------------------------------------------------------ the model call
def expected_experts(E: int, k: int, tokens: int) -> float:
    """Experts a layer's router is expected to touch for ``tokens`` tokens
    routed uniformly: each expert misses a token with probability 1 - k/E."""
    return E * (1.0 - (1.0 - k / E) ** tokens) if tokens > 0 else 0.0


def quantized(quant: Optional[Dict], shape: Sequence[int], stacked: int) -> bool:
    """The configuration's int8 rule for a leaf of ``shape`` stored in a
    stack of ``stacked`` layers (0: a leaf of its own): at least two dims and
    ``min_elems`` elements, counted over the stack."""
    if quant is None:
        return False
    numel = 1
    for x in shape:
        numel *= x
    dims = len(shape) + (1 if stacked else 0)
    return dims >= 2 and numel * max(stacked, 1) >= quant["min_elems"]


def leaf_bytes(quant: Optional[Dict], shape: Sequence[int], stacked: int) -> float:
    """Bytes of one layer's leaf: bf16, or int8 values with an fp32 scale
    for each row of its last axis."""
    numel = 1
    for x in shape:
        numel *= x
    if quantized(quant, shape, stacked):
        return numel + 4 * numel // shape[-1]
    return 2.0 * numel


def model_call_cost(s: Shapes, starts: Sequence[int], nvalid: Sequence[int],
                    quant: Optional[Dict] = None, kv_bytes: int = 2) -> Tuple[float, float]:
    """(bytes, operations) of one model call over rows at ``starts`` feeding
    ``nvalid`` tokens (0: an idle row, not counted). Operations: every
    matmul of the live tokens (projections, attention over the keys each
    query sees, the router, the top-k and shared experts, dense FFNs), the
    head at each live row's last position. Bytes: every weight read once
    (of a MoE layer's routed experts, those the live tokens are expected to
    touch), the embedding rows gathered, each live row's visible keys and
    values read once and its new ones written. ``quant``: the
    configuration's int8 rule, None for bf16 weights."""
    d, H, Hkv, hd = s.d, s.heads, s.kv_heads, s.head_dim
    rows = [(int(a), int(n)) for a, n in zip(starts, nvalid) if n > 0]
    T = sum(n for _, n in rows)
    if T == 0:
        return 0.0, 0.0
    # visible (query, key) pairs: the query at position p sees p + 1 keys
    pairs = sum(n * a + n * (n + 1) // 2 for a, n in rows)
    keys_read = sum(a + n for a, n in rows)
    touched = expected_experts(s.experts, s.top_k, T)
    flops = 0.0
    nbytes = 0.0
    for layer in range(s.layers):
        stacked = s.layers - s.dense_layers if s.is_moe(layer) else s.dense_layers
        flops += T * 2.0 * d * (H * hd + 2 * Hkv * hd) + T * 2.0 * H * hd * d
        flops += 4.0 * H * hd * pairs
        for name, shape, _ in s.layer_leaves(layer):
            b = leaf_bytes(quant, shape, stacked)
            if name in ("moe.wg", "moe.wu", "moe.wd"):     # routed experts
                b *= touched / s.experts
            nbytes += b
        nbytes += len(s.norms()) * leaf_bytes(quant, (d,), stacked)
        if s.is_moe(layer):
            flops += T * 2.0 * d * s.experts
            flops += T * (s.top_k + s.shared) * 3 * 2.0 * d * s.d_expert
        else:
            flops += T * 3 * 2.0 * d * s.d_ff
    nbytes += 2.0 * s.layers * Hkv * hd * kv_bytes * (keys_read + T)
    flops += len(rows) * 2.0 * d * s.vocab
    nbytes += leaf_bytes(quant, (d, s.vocab), 0) + 2.0 * d
    nbytes += T * leaf_bytes(quant, (s.vocab, d), 0) / s.vocab
    return nbytes, flops
