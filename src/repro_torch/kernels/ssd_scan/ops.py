"""Public SSD chunk-scan ops, dispatched on the tensors' device: the CUDA
kernel for CUDA tensors, the plain PyTorch version for CPU tensors. There is
no fallback between the two: a CUDA tensor reaches the kernel or an error.

``ssd_chunked`` is what the model calls: it takes a carried ``init_state``
and returns the final state. ``ssd_scan`` has the reference op's signature
(``repro/kernels/ssd_scan/ops.py::ssd_scan``): zero initial state, ``y`` in
``x``'s dtype. Both pad L up to a multiple of the chunk on the CPU, as the
reference does; the kernel masks the ragged tail itself.

On CUDA tensors that need a gradient the op is ``SSDScan``, an autograd
function whose forward launches the forward kernel with the state entering
each tile and whose backward launches the backward kernel: the gradient the
reference takes by XLA autodiff of its plain scan. Without a gradient
(serving, ``torch.inference_mode``) the forward writes no states. On CPU
tensors autograd differentiates the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.kernel import ssd_scan_bwd_cuda, ssd_scan_cuda
from repro_torch.kernels.ssd_scan.ref import ssd_reference


class SSDScan(torch.autograd.Function):
    """(x, dt, A, B_, C, init_state) -> (y, final_state) through the
    kernels; saves the inputs and the tiles' entry states for the backward,
    which writes only the gradients asked for."""

    @staticmethod
    def forward(ctx, x, dt, A, B_, C, init_state):
        y, final, states = ssd_scan_cuda(x, dt, A, B_, C, init_state=init_state, states=True)
        ctx.save_for_backward(x, dt, A, B_, C, states)
        ctx.set_materialize_grads(False)       # an unused final state sends no zeros
        return y, final

    @staticmethod
    def backward(ctx, dy, d_final):
        x, dt, A, B_, C, states = ctx.saved_tensors
        need_x, need_dt, need_A, need_B, need_C, need_init = ctx.needs_input_grad
        dy = (torch.zeros(x.shape, dtype=torch.float32, device=x.device) if dy is None
              else dy.float().contiguous())
        if d_final is not None:
            d_final = d_final.float().contiguous()
        dx, ddt, dA, dB, dC, d_init = ssd_scan_bwd_cuda(
            x, dt, A, B_, C, states, dy, d_final, need_x=need_x, need_dt=need_dt,
            need_A=need_A, need_BC=need_B or need_C, need_init=need_init)
        return dx, ddt, dA, dB if need_B else None, dC if need_C else None, d_init


def ssd_chunked(x, dt, A, B_, C, chunk: int, init_state=None):
    """x (B,L,H,P); dt (B,L,H) post-softplus; A (H,) negative; B_ / C
    (B,L,G,N) with G dividing H (head h reads group h // (H // G); G == H is
    the reference's layout); init_state (B,H,P,N) or None (zeros).
    Returns (y (B,L,H,P) fp32, final_state (B,H,P,N) fp32)."""
    if chunk < 1:
        raise ValueError(f"chunk {chunk} must be positive")
    if x.device.type == "cpu":
        rep = x.shape[2] // B_.shape[2]
        if rep > 1:
            B_, C = B_.repeat_interleave(rep, 2), C.repeat_interleave(rep, 2)
        return ssd_reference(x, dt, A, B_, C, chunk, init_state=init_state)
    if init_state is not None:
        init_state = init_state.float().contiguous()
    dt, A = dt.float().contiguous(), A.float().contiguous()
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, dt, A, B_, C, init_state)):
        return SSDScan.apply(x, dt, A, B_, C, init_state)
    return ssd_scan_cuda(x, dt, A, B_, C, init_state=init_state)


def ssd_scan(x, dt, A, B_, C, chunk: int):
    """The reference op: zero initial state. Returns y (B,L,H,P) in x's
    dtype (the TPU kernel's output type)."""
    return ssd_chunked(x, dt, A, B_, C, chunk)[0].to(x.dtype)
