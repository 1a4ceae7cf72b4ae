"""Public flash attention op, dispatched on the tensors' device: the CUDA
kernel for CUDA tensors, the plain PyTorch version for CPU and meta tensors
(``kernels.route``). There is no fallback between the two: a CUDA tensor
reaches the kernel or an error. The layout is the reference's, (B, S, H, D).

On CUDA tensors that need a gradient the op is ``FlashAttention``, an
autograd function whose forward launches the forward kernel with its row
logsumexp and whose backward launches the backward kernel: the gradient
the reference gets by autodiff of its XLA attention. Without a gradient
(serving, ``torch.inference_mode``) the forward kernel writes no logsumexp.
On CPU tensors autograd differentiates the plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd_cuda,
                                                        flash_attention_cuda)
from repro_torch.kernels.flash_attention.ref import mha_reference
from repro_torch.kernels.route import plain


class FlashAttention(torch.autograd.Function):
    """q, k, v -> out through the kernels; saves q, k, v, out and the row
    logsumexp for the backward, which computes only the gradients asked
    for (dq, and dk with dv)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset, scale):
        kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset, scale=scale)
        out, lse = flash_attention_cuda(q, k, v, lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        need_q, need_k, need_v = ctx.needs_input_grad[:3]
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, dout.contiguous(), lse,
                                              need_dq=need_q, need_dkv=need_k or need_v,
                                              **ctx.kw)
        return (dq, dk if need_k else None, dv if need_v else None,
                None, None, None, None, None)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, softcap: float = 0.0,
                    q_offset: int = 0, scale: float | None = None):
    """q (B, Sq, H, D) against k / v (B, Skv, Hkv, D). Query row i sits at
    absolute position i + q_offset; a row with no visible key gives
    zeros."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset, scale=scale)
    if plain(q, "flash_attention"):
        return mha_reference(q, k, v, **kw)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, softcap, q_offset, scale)
    return flash_attention_cuda(q, k, v, **kw)
