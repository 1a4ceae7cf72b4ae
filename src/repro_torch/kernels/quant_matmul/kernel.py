"""Binding of the CUDA w8a16 matmul (``csrc/quant_matmul.cu``), which
replaces the TPU kernel
``repro/kernels/quant_matmul/kernel.py::w8a16_matmul_pallas`` and adds the
row scale of the model's int8 tree.

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
BLOCK_M = 64        # rows per tile: kBlockM of csrc/quant_matmul.cu (checked at load)


@functools.cache
def _launcher():
    lib = load_library("quant_matmul")
    lib.w8a16_block_m.argtypes = []
    lib.w8a16_block_m.restype = ctypes.c_int
    if lib.w8a16_block_m() != BLOCK_M:
        raise RuntimeError(f"quant_matmul library tiles {lib.w8a16_block_m()} rows, "
                           f"expected {BLOCK_M}")
    fn = lib.w8a16_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                    ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"w8a16_matmul_cuda: {msg}")


def w8a16_matmul_cuda(x, w_q, col_scale=None, row_scale=None):
    """x (M, K) fp32 / bf16 with unit column stride; w_q (K, N) int8 at any
    strides; col_scale (N,) and row_scale (K, G) contiguous fp32 or None,
    G dividing N. Returns (M, N) in x's dtype."""
    dev = x.device
    _check(dev.type == "cuda", f"x is on {dev}, the kernel runs on CUDA tensors")
    _check(x.dim() == 2 and w_q.dim() == 2 and w_q.shape[0] == x.shape[1],
           f"x {tuple(x.shape)} vs w_q {tuple(w_q.shape)}")
    _check(x.dtype in DTYPE_CODES, f"x dtype {x.dtype} not in {list(DTYPE_CODES)}")
    _check(w_q.dtype == torch.int8, f"w_q dtype {w_q.dtype}, expected int8")
    _check(x.stride(1) == 1 or x.shape[1] <= 1, f"x needs unit column stride {x.stride()}")
    M, K = x.shape
    N = w_q.shape[1]
    _check(w_q.device == dev, f"w_q is on {w_q.device}, x on {dev}")
    for name, t in (("col_scale", col_scale), ("row_scale", row_scale)):
        _check(t is None or (t.device == dev and t.dtype == torch.float32
                             and t.is_contiguous()), f"{name} must be contiguous fp32 on {dev}")
    if col_scale is not None:
        _check(tuple(col_scale.shape) == (N,),
               f"col_scale {tuple(col_scale.shape)}, expected ({N},)")
    G = 1
    if row_scale is not None:
        _check(row_scale.dim() == 2 and row_scale.shape[0] == K and row_scale.shape[1] >= 1
               and N % row_scale.shape[1] == 0,
               f"row_scale {tuple(row_scale.shape)} must be ({K}, G) with G dividing {N}")
        G = row_scale.shape[1]
    _check((M + BLOCK_M - 1) // BLOCK_M <= 65535, f"{M} rows exceed the grid's y limit")

    out = torch.empty((M, N), dtype=x.dtype, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        err = _launcher()(
            x.data_ptr(), x.stride(0), w_q.data_ptr(), w_q.stride(0), w_q.stride(1),
            None if row_scale is None else row_scale.data_ptr(), G,
            None if col_scale is None else col_scale.data_ptr(), out.data_ptr(), M, K, N,
            DTYPE_CODES[x.dtype], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"w8a16 kernel launch failed (code {err})")
    w8a16_matmul_cuda.launches += 1
    return out


w8a16_matmul_cuda.launches = 0
