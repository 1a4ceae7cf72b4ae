"""Binding of the CUDA chunked paged attention kernel
(``csrc/chunked_prefill.cu``), which replaces the TPU kernel
``repro/kernels/paged_attention/kernel.py::chunked_prefill_pallas``.

The wrapper validates its operands, allocates the output, launches on the
current stream and raises if the launch failed. ``launches`` counts the
launches made, so a run can show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load_library

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 128)    # the tiny test configs' and Mixtral / Qwen's


@functools.cache
def _launcher():
    fn = load_library("chunked_prefill").chunked_prefill_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"chunked_prefill_cuda: {msg}")


def chunked_prefill_cuda(q, k_pages, v_pages, page_table, lengths, starts, *,
                         scale: float, softcap: float = 0.0, window: int = 0):
    """q (B, C, H, D) at positions starts[b] + c attends causally over the
    paged pool (P, ps, Hkv, D), which already holds the chunk's own KV.
    fp32 or bf16 in (q and the pool may differ), fp32 math, output in q's
    dtype."""
    B, C, H, D = q.shape
    P, ps, Hkv, Dk = k_pages.shape
    dev = q.device
    _check(dev.type == "cuda", f"q is on {dev}, the kernel runs on CUDA tensors")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages), ("page_table", page_table),
                    ("lengths", lengths), ("starts", starts)):
        _check(t.device == dev, f"{name} is on {t.device}, q on {dev}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    _check(q.is_contiguous(), "q must be contiguous")
    _check(q.dtype in DTYPE_CODES, f"q dtype {q.dtype} not in {list(DTYPE_CODES)}")
    _check(k_pages.dtype in DTYPE_CODES and v_pages.dtype == k_pages.dtype,
           f"pool dtypes {k_pages.dtype}/{v_pages.dtype}")
    _check(v_pages.shape == k_pages.shape, "k/v pools differ in shape")
    _check(Dk == D and D in HEAD_DIMS, f"head_dim {D} (pool {Dk}) not in {HEAD_DIMS}")
    _check(Hkv > 0 and H % Hkv == 0, f"{H} query heads over {Hkv} kv heads")
    _check(B <= 65535, f"{B} rows exceed the grid's z limit")
    maxp = page_table.shape[1] if page_table.dim() == 2 else -1
    _check(page_table.shape == (B, maxp) and page_table.dtype == torch.int32,
           "page_table must be (B, max_pages) int32")
    _check(lengths.shape == (B,) and lengths.dtype == torch.int32, "lengths must be (B,) int32")
    _check(starts.shape == (B,) and starts.dtype == torch.int32, "starts must be (B,) int32")

    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        err = _launcher()(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
            lengths.data_ptr(), starts.data_ptr(), out.data_ptr(),
            B, C, H, Hkv, D, ps, maxp, float(scale), float(softcap), int(window),
            DTYPE_CODES[q.dtype], DTYPE_CODES[k_pages.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"chunked_prefill kernel launch failed (code {err})")
    chunked_prefill_cuda.launches += 1
    return out


chunked_prefill_cuda.launches = 0
