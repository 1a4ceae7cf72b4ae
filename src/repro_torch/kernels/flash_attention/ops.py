"""Public flash attention op, dispatched on the tensors' device: the CUDA
kernel for CUDA tensors, the plain PyTorch version for CPU tensors. There
is no fallback between the two: a CUDA tensor reaches the kernel or an
error. The layout is the reference's, (B, S, H, D)."""
from __future__ import annotations

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import mha_reference


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, softcap: float = 0.0,
                    q_offset: int = 0, scale: float | None = None):
    """q (B, Sq, H, D) against k / v (B, Skv, Hkv, D). Query row i sits at
    absolute position i + q_offset; a row with no visible key gives
    zeros."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset, scale=scale)
    if q.device.type == "cpu":
        return mha_reference(q, k, v, **kw)
    return flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(), **kw)
