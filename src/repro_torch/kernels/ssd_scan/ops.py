"""Public SSD chunk-scan ops, dispatched on the tensors' device: the CUDA
kernel for CUDA tensors, the plain PyTorch version for CPU tensors. There is
no fallback between the two: a CUDA tensor reaches the kernel or an error.

``ssd_chunked`` is what the model calls: it takes a carried ``init_state``
and returns the final state. ``ssd_scan`` has the reference op's signature
(``repro/kernels/ssd_scan/ops.py::ssd_scan``): zero initial state, ``y`` in
``x``'s dtype. Both pad L up to a multiple of the chunk on the CPU, as the
reference does; the kernel masks the ragged tail itself. On the card the
kernel has no backward yet: a call that would need a gradient raises.
"""
from __future__ import annotations

from repro_torch.kernels.grad_guard import refuse_grad
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
from repro_torch.kernels.ssd_scan.ref import ssd_reference


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
    refuse_grad("ssd_scan", x, dt, A, B_, C, init_state)
    if init_state is not None:
        init_state = init_state.float().contiguous()
    return ssd_scan_cuda(x, dt.float().contiguous(), A.float().contiguous(), B_, C,
                         init_state=init_state)


def ssd_scan(x, dt, A, B_, C, chunk: int):
    """The reference op: zero initial state. Returns y (B,L,H,P) in x's
    dtype (the TPU kernel's output type)."""
    return ssd_chunked(x, dt, A, B_, C, chunk)[0].to(x.dtype)
