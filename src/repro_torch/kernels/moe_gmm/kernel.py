"""Binding of the CUDA grouped expert matmul (``csrc/moe_gmm.cu``), which
replaces the TPU kernel ``repro/kernels/moe_gmm/kernel.py::gmm_pallas``.

``_plan`` picks one of three kernels from what the host knows, the total
rows M, K, N, E and the dtypes (the rows per expert stay on the device, so
nothing is read back): the streaming kernel for M <= 16 rows (decode: bound
by the bytes of the active experts' weights, K split across blocks so that
the card streams them), the tensor-core kernel for bf16 x with bf16 or int8
experts above that (prefill), the fp32 tiled kernel otherwise. The plan
also sets the row tile of the layout (``block_m_for``). The wrapper
validates its operands, allocates the output, the split-K workspace and,
for int8 experts on the tensor cores, the three bf16 parts of x s,
launches on the current stream and raises if the launch failed.
``launches`` counts the calls that launched, one per call whatever the
path; ``launches_by_path`` counts them by path.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels.build import load_library

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
INT8 = 2            # kInt8 of csrc/common.cuh: a weight type only
PATHS = ("tiled", "stream", "mma")   # codes 0..2 of csrc/moe_gmm.cu
# constants of csrc/moe_gmm.cu (checked at load, in gmm_constants' order)
STREAM_BLOCK_M = 16     # rows a tile of the streaming layout
STREAM_BLOCK_N = 256    # columns a streaming block: 16 threads x 16 columns
XS_FLOATS = 4096        # streaming: x rows x split length staged as fp32
SPLIT_ROWS = 16         # split ranges start at multiples of 16 rows of K
MMA_TILE = (64, 128)    # output tile (rows, columns) of the tensor-core kernel
TILED_TILE = (64, 64)   # and of the fp32 tiled kernel
STREAM_MAX_M = 16       # at most this many rows take the streaming kernel
RESIDENT = 4            # streaming blocks a SM holds at once (its registers)
STREAM_MIN_SPLIT_K = 64   # rows of K a split keeps while the grid fills that wave
MMA_MIN_SPLIT_K = 256   # rows of K a tensor-core split keeps at least (4 steps of 64)
MMA_MAX_SPLITS = 4      # the (splits, Mp, N) fp32 workspace stays a few times the output
MMA_RESIDENT = 2        # tensor-core blocks a SM holds at once (shared memory)
MMA_SPLIT_GAIN = 0.85   # split K only if the last, part-empty wave costs >= 15% of the time
GRID_LIMITS = (2 ** 31 - 1, 65535, 65535)


@dataclass(frozen=True)
class Plan:
    path: str        # one of PATHS
    grid: tuple      # (x, y, z) blocks
    block_m: int     # rows a tile of the layout
    rows: int        # rows of a tile a streaming block takes (1, 2 or 4); the tile's otherwise
    groups: int      # streaming: row groups a tile (block x = column block * groups + group)
    splits: int      # K ranges summed by the split reduce (1: none)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def block_m_for(M: int) -> int:
    """The row tile of the layout for M rows in all: 16 on the streaming
    path (M <= 16 puts at most 16 rows on an expert), else 64 (the
    tensor-core and tiled kernels' output tile)."""
    return STREAM_BLOCK_M if M <= STREAM_MAX_M else TILED_TILE[0]


def _plan(M: int, K: int, N: int, E: int, x_dtype, w_dtype, n_sm: int) -> Plan:
    """The kernel and grid for M >= 1 rows sorted by expert over E experts
    (K, N). Streaming: K is split so that the likely-active tiles, min(M,
    E), give >= 2 blocks a SM and, short of one wave of resident blocks,
    splits of >= STREAM_MIN_SPLIT_K rows, and at least so far that a
    split's slice of x fits the staging buffer. Tensor cores: K is split
    (>= MMA_MIN_SPLIT_K rows a split, at most MMA_MAX_SPLITS) only where
    the likely tiles leave SMs idle: a grid a little over a whole number of
    waves spends its last wave mostly empty."""
    bm = block_m_for(M)
    tiles = _cdiv(M, bm) + E          # the layout's worst case
    if M <= STREAM_MAX_M:
        rows = next(r for r in (1, 2, 4) if r >= min(M, 4))
        groups = _cdiv(min(M, bm), rows)
        nb = _cdiv(N, STREAM_BLOCK_N)
        live = nb * min(M, E)
        units = max(1, _cdiv(K, SPLIT_ROWS))
        fit = _cdiv(units, XS_FLOATS // (rows * SPLIT_ROWS))
        wave = min(RESIDENT * n_sm // live, units * SPLIT_ROWS // STREAM_MIN_SPLIT_K)
        splits = min(units, max(fit, _cdiv(2 * n_sm, live), wave, 1))
        return Plan("stream", (nb * groups, splits, tiles), bm, rows, groups, splits)
    if x_dtype == torch.bfloat16 and w_dtype in (torch.bfloat16, torch.int8):
        nbn = _cdiv(N, MMA_TILE[1])
        # the real tiles: one per 64 rows, and about one partial tile for
        # every other expert the rows reach
        blocks = nbn * (_cdiv(M, bm) + min(M, E) // 2)

        def waves(s):      # rounds of MMA_RESIDENT blocks a SM, in units of one unsplit block
            return _cdiv(s * blocks, MMA_RESIDENT * n_sm) / s

        best = min(range(1, max(1, min(MMA_MAX_SPLITS, K // MMA_MIN_SPLIT_K)) + 1), key=waves)
        splits = best if waves(best) <= MMA_SPLIT_GAIN * waves(1) else 1
        return Plan("mma", (nbn, tiles, splits), bm, bm, 1, splits)
    return Plan("tiled", (_cdiv(N, TILED_TILE[1]), tiles, 1), bm, bm, 1, 1)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(M: int, x, w) -> Plan:
    """The plan of a call on CUDA tensors: M rows in all, x in the layout,
    w (E, K, N) (the int8 q of a quantized expert stack)."""
    E, K, N = w.shape
    return _plan(M, K, N, E, x.dtype, w.dtype,
                 _sm_count(x.device.index if x.device.index is not None
                           else torch.cuda.current_device()))


@functools.cache
def _launcher():
    lib = load_library("moe_gmm")
    consts = (ctypes.c_int * 8)()
    lib.gmm_constants.argtypes = [ctypes.c_void_p]
    lib.gmm_constants.restype = None
    lib.gmm_constants(consts)
    want = (STREAM_BLOCK_M, STREAM_BLOCK_N, XS_FLOATS, SPLIT_ROWS, *MMA_TILE, *TILED_TILE)
    if tuple(consts) != want:
        raise RuntimeError(f"moe_gmm library constants {tuple(consts)}, expected {want}")
    fn = lib.gmm_launch
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"gmm_tiles_cuda: {msg}")


def gmm_tiles_cuda(x_pad, w, tile_expert, tile_rows, block_m: int = TILED_TILE[0],
                   w_scale=None, rows=None):
    """x_pad (T*block_m, K) in the tile-aligned layout of ``rows`` rows in
    all (default: as many as its real tiles could hold, T - E of them),
    block_m = ``block_m_for(rows)``; w (E, K, N) fp32 / bf16, or int8 with
    ``w_scale`` (E, K) fp32 (the int8 tree's scale per expert and input
    row); tile_expert / tile_rows (T,) int32. Returns (T*block_m, N) in x's
    dtype, written only at each tile's real rows."""
    _check(block_m in (STREAM_BLOCK_M, TILED_TILE[0]),
           f"block_m {block_m}: the kernels tile {STREAM_BLOCK_M} or {TILED_TILE[0]} rows")
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
    E, _, N = w.shape
    T = Mp // block_m
    rows = (T - E) * block_m if rows is None else rows
    _check(block_m == block_m_for(rows),
           f"block_m {block_m}: the plan for {rows} rows tiles {block_m_for(rows)}")
    _check(Mp == T * block_m and T > E,
           f"{Mp} rows is not a whole number of {block_m}-row tiles, more than {E}")
    for name, t in (("tile_expert", tile_expert), ("tile_rows", tile_rows)):
        _check(t.shape == (T,) and t.dtype == torch.int32, f"{name} must be ({T},) int32")

    out = torch.empty((Mp, N), dtype=x_pad.dtype, device=dev)
    if out.numel() == 0:
        return out
    plan = plan_for(rows, x_pad, w)
    _check(all(g <= lim for g, lim in zip(plan.grid, GRID_LIMITS)),
           f"grid {plan.grid} of {rows}x{K}x{N} over {E} experts exceeds CUDA's limits")
    ws = (torch.empty((plan.splits, Mp, N), dtype=torch.float32, device=dev)
          if plan.splits > 1 else None)
    # int8 experts on the tensor cores: x s as three bf16 parts, made by the
    # kernel's pre-pass
    xs3 = (torch.empty((3, Mp, K), dtype=torch.bfloat16, device=dev)
           if plan.path == "mma" and w.dtype == torch.int8 else None)
    with torch.cuda.device(dev):
        err = _launcher()(
            PATHS.index(plan.path), plan.rows, plan.groups, *plan.grid, plan.splits,
            x_pad.data_ptr(), w.data_ptr(), None if w_scale is None else w_scale.data_ptr(),
            tile_expert.data_ptr(), tile_rows.data_ptr(), None if ws is None else ws.data_ptr(),
            None if xs3 is None else xs3.data_ptr(), out.data_ptr(), T, K, N,
            DTYPE_CODES[x_pad.dtype], w_code, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gmm kernel launch failed (code {err}, plan {plan})")
    gmm_tiles_cuda.launches += 1
    gmm_tiles_cuda.launches_by_path[plan.path] += 1
    return out


gmm_tiles_cuda.launches = 0
gmm_tiles_cuda.launches_by_path = dict.fromkeys(PATHS, 0)
