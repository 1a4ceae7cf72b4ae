"""The guard of the CUDA kernels that have no backward yet (the grouped
and w8a16 matmuls, chunked and paged attention; flash attention and the
SSD scan have theirs): on the card their ops raise when autograd would need
a gradient through them, rather than return a result that autograd cannot
see through (a silent zero gradient). CPU tensors take the plain versions,
which autograd differentiates, and never reach the guard."""
from __future__ import annotations

import torch


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise if grad mode is on and any of ``tensors`` (None skipped)
    requires a gradient."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward yet, and an input requires a gradient; "
            f"run it under torch.no_grad() / torch.inference_mode(), or on CPU tensors")
