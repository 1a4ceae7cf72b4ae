"""w8a16 matmul op, dispatched on the tensors' device: the CUDA kernel for
CUDA tensors, the plain version for CPU tensors (no fallback between them),
and the reference's per-output-channel quantize helper. On the card the
kernel has no backward yet: a call that would need a gradient raises."""
from __future__ import annotations

import torch

from repro_torch.kernels.grad_guard import refuse_grad
from repro_torch.kernels.quant_matmul.kernel import w8a16_matmul_cuda
from repro_torch.kernels.quant_matmul.ref import w8a16_matmul_reference


def quantize_int8(w, axis: int = 0):
    """Per-output-channel symmetric int8 quantization of a (K, N) weight.
    Returns (w_q int8, scale fp32 per column)."""
    wf = w.float()
    scale = torch.clamp_min(wf.abs().amax(dim=axis, keepdim=True), 1e-8) / 127.0
    w_q = torch.round(wf / scale).clamp_(-127, 127).to(torch.int8)
    return w_q, scale.reshape(-1)


def w8a16_matmul(x, w_q, col_scale=None, *, row_scale=None):
    """x (M, K) @ int8 w_q (K, N), scaled by ``row_scale`` (K, G) per weight
    and ``col_scale`` (N,) per output column; returns (M, N) in x's dtype.
    ``w_q`` may be a strided view (the transposed tied embedding)."""
    if x.device.type == "cpu":
        return w8a16_matmul_reference(x, w_q, col_scale, row_scale)
    refuse_grad("w8a16_matmul", x, col_scale, row_scale)
    if x.stride(-1) != 1:
        x = x.contiguous()
    f32 = torch.float32
    return w8a16_matmul_cuda(
        x, w_q, None if col_scale is None else col_scale.to(f32).contiguous(),
        None if row_scale is None else row_scale.to(f32).contiguous())
