"""Public paged attention ops (decode and chunked prefill), dispatched on
the tensors' device: the CUDA kernel for CUDA tensors, the plain PyTorch
version for CPU tensors. There is no fallback between the two: a CUDA
tensor reaches the kernel or an error. On the card the kernels have no
backward yet: a call that would need a gradient raises. ``q_head0`` /
``group`` place q's heads among the config's (``kernel.head_fold``): a rank
of a tensor split wider than the kv heads reads its heads' kv head of the
whole pool, with no copy of it."""
from __future__ import annotations

import torch

from repro_torch.kernels.grad_guard import refuse_grad
from repro_torch.kernels.paged_attention.kernel import chunked_prefill_cuda, paged_attention_cuda
from repro_torch.kernels.paged_attention.ref import (chunked_prefill_reference,
                                                     paged_attention_reference)


def paged_attention(q, k_pages, v_pages, page_table, lengths, *,
                    scale: float | None = None, softcap: float = 0.0, window: int = 0,
                    q_head0: int = 0, group: int = 0):
    """Decode over the paged pool: q (B, H, D), one new token per row,
    attends to the row's entries at positions < lengths[b] (the new token's
    KV already written), within the window that ends at lengths[b] - 1."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, page_table, lengths,
                                         scale=scale, softcap=softcap, window=window,
                                         q_head0=q_head0, group=group)
    refuse_grad("paged_attention", q, k_pages, v_pages)
    i32 = torch.int32
    return paged_attention_cuda(
        q.contiguous(), k_pages, v_pages, page_table.to(i32).contiguous(),
        lengths.to(i32).contiguous(), scale=scale, softcap=softcap, window=window,
        q_head0=q_head0, group=group)


def chunked_prefill_attention(
    q, k_pages, v_pages, page_table, lengths, q_positions, *,
    scale: float | None = None, softcap: float = 0.0, window: int = 0, q_head0: int = 0,
    group: int = 0,
):
    """Chunked paged attention: q (B, C, H, D) at absolute q_positions
    (B, C) attends causally over the pool (the chunk's own KV included).

    The kernel takes a row's positions as contiguous
    (``q_positions[b, i] == q_positions[b, 0] + i``, true for every
    engine-issued chunk) and reads only ``q_positions[:, 0]``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return chunked_prefill_reference(
            q, k_pages, v_pages, page_table, lengths, q_positions,
            scale=scale, softcap=softcap, window=window, q_head0=q_head0, group=group,
        )
    refuse_grad("chunked_prefill_attention", q, k_pages, v_pages)
    i32 = torch.int32
    return chunked_prefill_cuda(
        q.contiguous(), k_pages, v_pages, page_table.to(i32).contiguous(),
        lengths.to(i32).contiguous(), q_positions[:, 0].to(i32).contiguous(),
        scale=scale, softcap=softcap, window=window, q_head0=q_head0, group=group,
    )
