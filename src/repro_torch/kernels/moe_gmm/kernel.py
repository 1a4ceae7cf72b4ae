"""Binding of the CUDA grouped expert matmul (``csrc/moe_gmm.cu``), which
replaces the TPU kernel ``repro/kernels/moe_gmm/kernel.py::gmm_pallas``.

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
INT8 = 2            # kInt8 of csrc/common.cuh: a weight type only
BLOCK_M = 64        # rows per tile: kBlockM of csrc/moe_gmm.cu (checked at load)


@functools.cache
def _launcher():
    lib = load_library("moe_gmm")
    lib.gmm_block_m.argtypes = []
    lib.gmm_block_m.restype = ctypes.c_int
    if lib.gmm_block_m() != BLOCK_M:
        raise RuntimeError(f"moe_gmm library tiles {lib.gmm_block_m()} rows, expected {BLOCK_M}")
    fn = lib.gmm_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"gmm_tiles_cuda: {msg}")


def gmm_tiles_cuda(x_pad, w, tile_expert, tile_rows, block_m: int = BLOCK_M, w_scale=None):
    """x_pad (T*BLOCK_M, K) in the tile-aligned layout, w (E, K, N) fp32 /
    bf16, or int8 with ``w_scale`` (E, K) fp32 (the int8 tree's scale per
    expert and input row), tile_expert / tile_rows (T,) int32. Returns
    (T*BLOCK_M, N) in x's dtype, written only at each tile's real rows."""
    _check(block_m == BLOCK_M, f"block_m {block_m}: the kernel tiles {BLOCK_M} rows")
    dev = x_pad.device
    _check(dev.type == "cuda", f"x is on {dev}, the kernel runs on CUDA tensors")
    for name, t in (("x", x_pad), ("w", w), ("tile_expert", tile_expert),
                    ("tile_rows", tile_rows)):
        _check(t.device == dev, f"{name} is on {t.device}, x on {dev}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    _check(x_pad.dtype in DTYPE_CODES, f"x dtype {x_pad.dtype} not in {list(DTYPE_CODES)}")
    _check(x_pad.dim() == 2 and w.dim() == 3 and w.shape[1] == x_pad.shape[1],
           f"x {tuple(x_pad.shape)} vs w {tuple(w.shape)}")
    if w.dtype == torch.int8:
        _check(w_scale is not None and w_scale.device == dev
               and w_scale.dtype == torch.float32 and w_scale.is_contiguous()
               and tuple(w_scale.shape) == tuple(w.shape[:2]),
               f"int8 w needs a contiguous fp32 w_scale {tuple(w.shape[:2])} on {dev}")
        w_code = INT8
    else:
        _check(w.dtype in DTYPE_CODES, f"w dtype {w.dtype} not in {list(DTYPE_CODES)} or int8")
        _check(w_scale is None, f"w_scale goes with int8 weights, w is {w.dtype}")
        w_code = DTYPE_CODES[w.dtype]
    Mp, K = x_pad.shape
    N = w.shape[2]
    T = Mp // BLOCK_M
    _check(Mp == T * BLOCK_M, f"{Mp} rows is not a whole number of {BLOCK_M}-row tiles")
    _check(T <= 65535, f"{T} row tiles exceed the grid's y limit")
    for name, t in (("tile_expert", tile_expert), ("tile_rows", tile_rows)):
        _check(t.shape == (T,) and t.dtype == torch.int32, f"{name} must be ({T},) int32")

    out = torch.empty((Mp, N), dtype=x_pad.dtype, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        err = _launcher()(
            x_pad.data_ptr(), w.data_ptr(), None if w_scale is None else w_scale.data_ptr(),
            tile_expert.data_ptr(), tile_rows.data_ptr(), out.data_ptr(), T, K, N,
            DTYPE_CODES[x_pad.dtype], w_code, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gmm kernel launch failed (code {err})")
    gmm_tiles_cuda.launches += 1
    return out


gmm_tiles_cuda.launches = 0
