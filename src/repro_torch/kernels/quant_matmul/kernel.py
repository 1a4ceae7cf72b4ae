"""Binding of the CUDA w8a16 matmul (``csrc/quant_matmul.cu``), which
replaces the TPU kernel
``repro/kernels/quant_matmul/kernel.py::w8a16_matmul_pallas`` and adds the
row scale of the model's int8 tree.

``_plan`` picks one of the three kernels by the call's shape, with its
grid: the streaming kernels for M <= 16 rows (decode: bound by the bytes of
the weights, K split across blocks so that the whole card streams them),
the tensor-core kernel for bf16 x above that (prefill: bound by
operations), the fp32 tiled kernel for fp32 x above that. The wrapper
validates its operands, allocates the output and the split-K workspace,
launches on the current stream and raises if the launch failed.
``launches`` counts the calls that launched, one per call whatever the
path; ``launches_by_path`` counts them by path, so a run can show that its
path went through the kernel it planned.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels.build import load_library

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
PATHS = ("tiled", "stream_n", "stream_k", "mma")   # codes 0..3 of csrc/quant_matmul.cu
# constants of csrc/quant_matmul.cu (checked at load, in w8a16_constants' order)
STREAM_BLOCK_N = 256    # n-major streaming: 16 threads x 16 columns a block
KMAJOR_BLOCK_N = 32     # k-major streaming: 8 warps x 4 columns a block
XS_FLOATS = 4096        # streaming: x rows x split length staged as fp32
SPLIT_ROWS = 16         # split ranges start at multiples of 16 rows of K
MMA_TILE = (128, 64)    # output tile (rows, columns) of the tensor-core kernel
MMA_MIN_SPLIT_K = 256   # rows of K a split keeps at least (4 steps of 64)
TILED_TILE = (64, 64)   # and of the fp32 tiled kernel
STREAM_MAX_M = 16       # at most this many rows take the streaming kernels
# blocks of each streaming kernel a SM holds at once (its registers): the
# plan aims the grid at one full wave of them
RESIDENT = {"stream_n": 4, "stream_k": 2}
STREAM_MIN_SPLIT_K = 64   # rows of K a split keeps while the grid fills that wave
GRID_LIMITS = (2 ** 31 - 1, 65535, 65535)


@dataclass(frozen=True)
class Plan:
    path: str        # one of PATHS
    grid: tuple      # (x, y, z) blocks
    rows: int        # rows of x a streaming block takes (1, 2 or 4); the tile's otherwise
    splits: int      # K ranges summed by the split reduce (1: none)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _plan(M: int, K: int, N: int, dtype, k_major: bool, n_sm: int) -> Plan:
    """The kernel and grid for x (M, K) @ q (K, N), M >= 1. Streaming: K is
    split so that the grid has >= 2 blocks a SM and, short of one wave of
    resident blocks, splits of >= STREAM_MIN_SPLIT_K rows, and at least so
    far that a split's slice of x fits the staging buffer."""
    if M <= STREAM_MAX_M:
        path = "stream_k" if k_major else "stream_n"
        rows = next(r for r in (1, 2, 4) if r >= min(M, 4))
        mb = _cdiv(M, rows)
        nb = _cdiv(N, KMAJOR_BLOCK_N if k_major else STREAM_BLOCK_N)
        units = max(1, _cdiv(K, SPLIT_ROWS))
        fit = _cdiv(units, XS_FLOATS // (rows * SPLIT_ROWS))
        wave = min(RESIDENT[path] * n_sm // (nb * mb), units * SPLIT_ROWS // STREAM_MIN_SPLIT_K)
        splits = min(units, max(fit, _cdiv(2 * n_sm, nb * mb), wave, 1))
        return Plan(path, (nb, splits, mb), rows, splits)
    if dtype != torch.bfloat16:
        return Plan("tiled", (_cdiv(N, TILED_TILE[1]), _cdiv(M, TILED_TILE[0]), 1),
                    TILED_TILE[0], 1)
    # tensor cores: split K (>= MMA_MIN_SPLIT_K rows a split) only while the
    # tiles alone leave SMs idle: the workspace and the reduce cost more than
    # a second block a SM gains (on an H100, 256 x 4096 x 4096 took 0.0929 ms
    # split in two, 0.0868 ms whole)
    tiles = _cdiv(N, MMA_TILE[1]) * _cdiv(M, MMA_TILE[0])
    splits = max(1, min(n_sm // tiles, K // MMA_MIN_SPLIT_K))
    return Plan("mma", (_cdiv(N, MMA_TILE[1]), _cdiv(M, MMA_TILE[0]), splits), MMA_TILE[0],
                splits)


def split_ranges(K: int, splits: int):
    """The rows [kb, ke) of K each split sums: ``split_range`` of the CUDA
    source, ceil(K / 16) units of 16 rows cut as evenly as integers allow."""
    units = _cdiv(K, SPLIT_ROWS)
    edge = [min(K, s * units // splits * SPLIT_ROWS) for s in range(splits + 1)]
    return list(zip(edge[:-1], edge[1:]))


def is_k_major(w_q) -> bool:
    """The kernels' test for a weight read along K (the transposed tied
    embedding): unit stride along K and not along N."""
    return w_q.stride(0) == 1 and w_q.stride(1) != 1


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(x, w_q) -> Plan:
    """The plan of a call on CUDA tensors x (M, K) and w_q (K, N)."""
    return _plan(x.shape[0], x.shape[1], w_q.shape[1], x.dtype, is_k_major(w_q),
                 _sm_count(x.device.index if x.device.index is not None
                           else torch.cuda.current_device()))


@functools.cache
def _launcher():
    lib = load_library("quant_matmul")
    consts = (ctypes.c_int * 8)()
    lib.w8a16_constants.argtypes = [ctypes.c_void_p]
    lib.w8a16_constants.restype = None
    lib.w8a16_constants(consts)
    want = (STREAM_BLOCK_N, KMAJOR_BLOCK_N, XS_FLOATS, SPLIT_ROWS, *MMA_TILE, *TILED_TILE)
    if tuple(consts) != want:
        raise RuntimeError(f"quant_matmul library constants {tuple(consts)}, expected {want}")
    fn = lib.w8a16_launch
    fn.argtypes = ([ctypes.c_int] * 6
                   + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                      ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
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

    out = torch.empty((M, N), dtype=x.dtype, device=dev)
    if out.numel() == 0:
        return out
    plan = plan_for(x, w_q)
    _check(all(g <= lim for g, lim in zip(plan.grid, GRID_LIMITS)),
           f"grid {plan.grid} of {M}x{K}x{N} exceeds CUDA's limits")
    ws = (torch.empty((plan.splits, M, N), dtype=torch.float32, device=dev)
          if plan.splits > 1 else None)
    with torch.cuda.device(dev):
        err = _launcher()(
            PATHS.index(plan.path), plan.rows, *plan.grid, plan.splits,
            x.data_ptr(), x.stride(0), w_q.data_ptr(), w_q.stride(0), w_q.stride(1),
            None if row_scale is None else row_scale.data_ptr(), G,
            None if col_scale is None else col_scale.data_ptr(),
            None if ws is None else ws.data_ptr(), out.data_ptr(), M, K, N,
            DTYPE_CODES[x.dtype], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"w8a16 kernel launch failed (code {err}, plan {plan})")
    w8a16_matmul_cuda.launches += 1
    w8a16_matmul_cuda.launches_by_path[plan.path] += 1
    return out


w8a16_matmul_cuda.launches = 0
w8a16_matmul_cuda.launches_by_path = dict.fromkeys(PATHS, 0)
