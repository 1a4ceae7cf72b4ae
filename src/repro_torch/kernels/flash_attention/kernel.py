"""Binding of the CUDA flash attention kernel (``csrc/flash_attention.cu``),
which replaces the TPU kernel
``repro/kernels/flash_attention/kernel.py::flash_attention_bhsd``.

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
HEAD_DIMS = (16, 128)    # the tiny test configs' and Mixtral / Qwen / Gemma2's


@functools.cache
def _launcher():
    fn = load_library("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention_cuda: {msg}")


def flash_attention_cuda(q, k, v, *, causal: bool, window: int = 0, softcap: float = 0.0,
                         q_offset: int = 0, scale: float):
    """q (B, Sq, H, D) against k / v (B, Skv, Hkv, D), one dtype (fp32 or
    bf16), fp32 math, output in q's dtype. Query row i sits at position
    i + q_offset; any Sq and Skv (the kernel masks the ragged edges)."""
    B, Sq, H, D = q.shape
    dev = q.device
    _check(dev.type == "cuda", f"q is on {dev}, the kernel runs on CUDA tensors")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t.device == dev, f"{name} is on {t.device}, q on {dev}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
        _check(t.dtype == q.dtype, f"{name} dtype {t.dtype}, q {q.dtype}")
    _check(q.dtype in DTYPE_CODES, f"dtype {q.dtype} not in {list(DTYPE_CODES)}")
    _check(k.dim() == 4 and k.shape[0] == B and k.shape[3] == D, f"k shape {tuple(k.shape)}")
    _check(v.shape == k.shape, "k and v differ in shape")
    Skv, Hkv = k.shape[1], k.shape[2]
    _check(D in HEAD_DIMS, f"head_dim {D} not in {HEAD_DIMS}")
    _check(Hkv > 0 and H % Hkv == 0, f"{H} query heads over {Hkv} kv heads")
    _check(B <= 65535 and H <= 65535, f"{B} rows / {H} heads exceed the grid's limits")

    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        err = _launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Skv, H, Hkv, D, float(scale), float(softcap), int(bool(causal)),
            int(window), int(q_offset), DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed (code {err})")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
