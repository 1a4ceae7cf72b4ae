"""Binding of the CUDA flash attention kernels (``csrc/flash_attention.cu``),
which replace the TPU kernel
``repro/kernels/flash_attention/kernel.py::flash_attention_bhsd``, and of
their backward (``csrc/flash_attention_bwd.cu``, ``flash_attention_bwd_cuda``).

``_plan`` picks one of the source's two kernels from the shapes and dtype:

- ``mma`` for bf16 q, k and v: ``mma.sync`` tensor-core tiles of
  ``MMA_ROWS`` folded rows (r = s * G + g: the query heads of one KV head's
  GQA group fold into the row axis, so a staged K/V tile serves all of
  them), walking ``MMA_KEYS``-key tiles (``key_tiles``);
- ``tiled`` for fp32: IEEE fp32 on the CUDA cores, ``TILED_ROWS`` query
  rows of one query head a block.

The wrapper validates its operands, allocates the output, launches on the
current stream and raises if the launch failed; a call no kernel takes
raises ValueError. ``launches`` counts the launches made, so a run can show
that its path went through the kernel; ``launches_by_path`` counts them by
path. The forward writes each row's logsumexp when asked (``lse=True``),
for the backward; serving never asks.

The backward (``flash_attention_bwd_cuda``) has two paths, which
``bwd_plan`` picks by dtype; both launch a preprocess of Delta = rowsum(dO
o O), a dK / dV kernel and a dQ kernel, with no atomics (a repeat gives the
same bits):

- ``mma`` for bf16: ``mma.sync`` tensor-core tiles, P and dS as hi + lo
  bf16 parts. A dK / dV block takes ``BWD_MMA_TILE`` keys of one kv head
  and one of ``splits`` subsets of its GQA group (the fewest that give
  ``BWD_MIN_BLOCKS_PER_SM`` blocks a SM); with ``splits`` > 1 each subset
  writes fp32 partials and a reduce kernel sums them in subset order. A dQ
  block takes ``BWD_MMA_TILE`` query rows of one query head.
- ``tiled`` for fp32: IEEE fp32 on the CUDA cores; dK / dV with one block
  per (``BWD_KEYS``-key tile, kv head, batch row) summing its GQA group in
  the block, then dQ with one block per (``BWD_ROWS``-row query tile, query
  head, batch row).
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels.build import load_library

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64, 96, 128)   # tiny test configs; seamless; phi3 / phi-3-vision; Mixtral
PATHS = ("tiled", "mma")  # codes 0..1 of csrc/flash_attention.cu
# constants of csrc/flash_attention.cu (checked at load, in
# flash_attention_constants' order)
TILED_ROWS = 64          # query rows a block of the fp32 tiled kernel
MMA_ROWS = 64            # folded rows a block of the tensor-core kernel
MMA_KEYS = 64            # and its key tile
GRID_LIMITS = (2 ** 31 - 1, 65535, 65535)
# constants of csrc/flash_attention_bwd.cu (checked at load, in
# flash_attention_bwd_constants' order)
BWD_ROWS = 64            # tiled: query rows a tile of the dq kernel (and of dkdv's walk)
BWD_KEYS = 32            # tiled: keys a tile of the dkdv kernel (and of dq's walk)
BWD_MMA_TILE = 64        # mma: keys a dK / dV block, rows a dQ block, and the tiles each walks
BWD_PATHS = ("tiled", "mma")   # codes 0..1 of csrc/flash_attention_bwd.cu
BWD_MIN_BLOCKS_PER_SM = 2      # mma: the dK / dV grid's target (chip_tune.py bwd)
BWD_REDUCE_THREADS = 256       # mma: the partials' reduce, 4 elements a thread


@dataclass(frozen=True)
class Plan:
    path: str        # one of PATHS
    grid: tuple      # (x, y, z) blocks


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _plan(B: int, Sq: int, H: int, Hkv: int, D: int, dtype) -> Plan:
    """The kernel and grid for q (B, Sq, H, D) against k / v (B, Skv, Hkv,
    D) of one dtype. Raises ValueError for a call no kernel takes."""
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head_dim {D} not in {HEAD_DIMS}")
    if dtype not in DTYPE_CODES:
        raise ValueError(f"flash_attention_cuda: dtype {dtype} not in {list(DTYPE_CODES)}")
    if Hkv <= 0 or H % Hkv:
        raise ValueError(f"flash_attention_cuda: {H} query heads over {Hkv} kv heads")
    if dtype == torch.bfloat16:
        plan = Plan("mma", (_cdiv(Sq * (H // Hkv), MMA_ROWS), Hkv, B))
    else:
        plan = Plan("tiled", (_cdiv(Sq, TILED_ROWS), H, B))
    if not all(g <= lim for g, lim in zip(plan.grid, GRID_LIMITS)):
        raise ValueError(f"flash_attention_cuda: grid {plan.grid} of q {(B, Sq, H, D)} exceeds "
                         f"CUDA's limits")
    return plan


def key_tiles(q_lo: int, q_hi: int, Skv: int, causal: bool, window: int) -> tuple:
    """The MMA_KEYS tiles [t0, t0 + tiles) that a block whose queries sit at
    positions q_lo .. q_hi walks (csrc/attention_mma.cuh's mma_key_tiles):
    the keys below Skv, up to q_hi when causal, from q_lo's window on."""
    hi = max(min(Skv, q_hi + 1) if causal else Skv, 0)
    lo = max(q_lo - window + 1, 0) if window > 0 else 0
    t0 = lo // MMA_KEYS
    return t0, (_cdiv(hi, MMA_KEYS) - t0 if hi > lo else 0)


def block_positions(block: int, Sq: int, G: int, q_offset: int) -> tuple:
    """The first and last query positions of the mma kernel's block of
    MMA_ROWS folded rows (r = s * G + g, row s at s + q_offset)."""
    r0 = block * MMA_ROWS
    return q_offset + r0 // G, q_offset + (min(r0 + MMA_ROWS, Sq * G) - 1) // G


def bind(lib):
    """``lib``'s launch function with its C signature, once the library's
    constants are checked against the ones ``_plan`` mirrors."""
    consts = (ctypes.c_int * 3)()
    lib.flash_attention_constants.argtypes = [ctypes.c_void_p]
    lib.flash_attention_constants.restype = None
    lib.flash_attention_constants(consts)
    want = (TILED_ROWS, MMA_ROWS, MMA_KEYS)
    if tuple(consts) != want:
        raise RuntimeError(f"flash_attention library constants {tuple(consts)}, expected {want}")
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _launcher():
    return bind(load_library("flash_attention"))


def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention_cuda: {msg}")


def plan_for(q, k) -> Plan:
    """The plan of a call: q (B, Sq, H, D), k (B, Skv, Hkv, D)."""
    B, Sq, H, D = q.shape
    return _plan(B, Sq, H, k.shape[2], D, q.dtype)


def flash_attention_cuda(q, k, v, *, causal: bool, window: int = 0, softcap: float = 0.0,
                         q_offset: int = 0, scale: float, lse: bool = False):
    """q (B, Sq, H, D) against k / v (B, Skv, Hkv, D), one dtype (fp32 or
    bf16), fp32 math, output in q's dtype. Query row i sits at position
    i + q_offset; any Sq and Skv (the kernels mask the ragged edges). The
    kernel is the one ``plan_for`` names. With ``lse`` returns (out, lse):
    lse (B, H, Sq) fp32 is each row's logsumexp of its scaled, softcapped
    scores, -inf for a row with no visible key."""
    dev = q.device
    _check(dev.type == "cuda", f"q is on {dev}, the kernel runs on CUDA tensors")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t.device == dev, f"{name} is on {t.device}, q on {dev}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
        _check(t.dtype == q.dtype, f"{name} dtype {t.dtype}, q {q.dtype}")
    B, Sq, H, D = q.shape
    _check(k.dim() == 4 and k.shape[0] == B and k.shape[3] == D, f"k shape {tuple(k.shape)}")
    _check(v.shape == k.shape, "k and v differ in shape")
    Skv, Hkv = k.shape[1], k.shape[2]

    plan = plan_for(q, k)
    out = torch.empty_like(q)
    row_lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev) if lse else None
    if out.numel() == 0:
        return (out, row_lse) if lse else out
    if plan.path == "mma":     # 16-byte cp.async copies of q, k and v rows
        _check(all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
               "q, k and v must be 16-byte aligned")
    with torch.cuda.device(dev):
        err = _launcher()(
            PATHS.index(plan.path), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if row_lse is None else row_lse.data_ptr(), B, Sq, Skv, H, Hkv, D,
            float(scale), float(softcap), int(bool(causal)), int(window), int(q_offset),
            DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed (code {err}, plan {plan})")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.launches_by_path[plan.path] += 1
    return (out, row_lse) if lse else out


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_by_path = dict.fromkeys(PATHS, 0)


def bwd_plan(B: int, Sq: int, Skv: int, H: int, Hkv: int, D: int, dtype,
             n_sm: int = 132) -> dict:
    """The backward's path, GQA subsets (``splits``) and the grids of its
    kernels (delta: one warp a row, 8 a block; dkdv; reduce, only with
    splits > 1; dq) for q (B, Sq, H, D) against k / v (B, Skv, Hkv, D) on a
    card of ``n_sm`` SMs (the H100's 132 by default). Raises ValueError for a
    call no kernel takes."""
    _plan(B, Sq, H, Hkv, D, dtype)     # the forward's checks of head dim, dtype and heads
    grids = {"delta": (_cdiv(B * Sq * H, 8), 1, 1)}
    if dtype == torch.bfloat16:
        # the fewest subsets of each GQA group that give the dK / dV grid
        # BWD_MIN_BLOCKS_PER_SM blocks a SM (all G if none does); key tiles
        # on z, so that the first ones, the heaviest when causal, go first
        G, n_kt = H // Hkv, _cdiv(Skv, BWD_MMA_TILE)
        splits = next((s for s in range(1, G + 1)
                       if G % s == 0 and n_kt * Hkv * B * s >= BWD_MIN_BLOCKS_PER_SM * n_sm), G)
        path = "mma"
        grids["dkdv"] = (Hkv * splits, B, n_kt)
        if splits > 1:
            grids["reduce"] = (_cdiv(2 * B * Skv * Hkv * D // 4, BWD_REDUCE_THREADS), 1, 1)
        grids["dq"] = (H, B, _cdiv(Sq, BWD_MMA_TILE))   # z counts query tiles from the last
    else:
        path, splits = "tiled", 1
        grids.update(dkdv=(_cdiv(Skv, BWD_KEYS), Hkv, B), dq=(_cdiv(Sq, BWD_ROWS), H, B))
    for name, grid in grids.items():
        if not all(g <= lim for g, lim in zip(grid, GRID_LIMITS)):
            raise ValueError(f"flash_attention_bwd_cuda: {name} grid {grid} exceeds CUDA's limits")
    return dict(path=path, splits=splits, grids=grids)


def bwd_query_tiles(k0: int, k_last: int, Sq: int, causal: bool, window: int,
                    q_offset: int) -> tuple:
    """The BWD_MMA_TILE-row query tiles [qt_lo, qt_lo + n) that an ``mma``
    dK / dV block of keys k0 .. k_last walks for each of its query heads
    (csrc/flash_attention_bwd.cu's bwd_query_tiles): the rows at or after
    k0 when causal, before k_last + window when windowed."""
    i_lo = max(0, k0 - q_offset) if causal else 0
    i_hi = min(Sq - 1, k_last + window - 1 - q_offset) if window > 0 else Sq - 1
    qt_lo = i_lo // BWD_MMA_TILE
    return qt_lo, (i_hi // BWD_MMA_TILE - qt_lo + 1 if i_hi >= i_lo else 0)


def dkdv_block(x: int, y: int, z: int, splits: int, H: int, Hkv: int) -> tuple:
    """What ``mma`` dK / dV block (x, y, z) owns: (batch row, kv head, its
    first key, its query heads)."""
    G = H // Hkv
    hk, split = divmod(x, splits)
    h0 = hk * G + split * (G // splits)
    return y, hk, z * BWD_MMA_TILE, range(h0, h0 + G // splits)


def bind_bwd(lib):
    """``lib``'s backward launch function with its C signature, once the
    library's constants are checked against the ones ``bwd_plan`` mirrors."""
    consts = (ctypes.c_int * 3)()
    lib.flash_attention_bwd_constants.argtypes = [ctypes.c_void_p]
    lib.flash_attention_bwd_constants.restype = None
    lib.flash_attention_bwd_constants(consts)
    want = (BWD_ROWS, BWD_KEYS, BWD_MMA_TILE)
    if tuple(consts) != want:
        raise RuntimeError(f"flash_attention_bwd library constants {tuple(consts)}, expected {want}")
    fn = lib.flash_attention_bwd_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_launcher():
    return bind_bwd(load_library("flash_attention_bwd"))


def flash_attention_bwd_cuda(q, k, v, out, dout, lse, *, causal: bool, window: int = 0,
                             softcap: float = 0.0, q_offset: int = 0, scale: float,
                             need_dq: bool = True, need_dkv: bool = True):
    """The gradients (dq, dk, dv) of ``flash_attention_cuda(q, k, v, ...)``
    given its output ``out``, the output's gradient ``dout`` and the
    forward's ``lse`` (B, H, Sq) fp32: one dtype for q, k, v, out and dout
    (fp32 or bf16), fp32 math, gradients in that dtype. dk and dv are
    summed over each kv head's group of query heads. ``need_dq`` /
    ``need_dkv`` False skip a kernel and return None in its place."""
    dev = q.device
    _check(dev.type == "cuda", f"q is on {dev}, the kernel runs on CUDA tensors")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout), ("lse", lse)):
        _check(t.device == dev, f"{name} is on {t.device}, q on {dev}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
        if name != "lse":
            _check(t.dtype == q.dtype, f"{name} dtype {t.dtype}, q {q.dtype}")
    B, Sq, H, D = q.shape
    _check(k.dim() == 4 and k.shape[0] == B and k.shape[3] == D, f"k shape {tuple(k.shape)}")
    _check(v.shape == k.shape, "k and v differ in shape")
    _check(out.shape == q.shape and dout.shape == q.shape, "out / dout must have q's shape")
    _check(lse.dtype == torch.float32 and lse.shape == (B, H, Sq),
           f"lse must be fp32 {(B, H, Sq)}, got {lse.dtype} {tuple(lse.shape)}")
    Skv, Hkv = k.shape[1], k.shape[2]
    plan = bwd_plan(B, Sq, Skv, H, Hkv, D, q.dtype,
                    _sm_count(dev.index if dev.index is not None else torch.cuda.current_device()))
    dq = torch.empty_like(q) if need_dq else None
    dk = torch.empty_like(k) if need_dkv else None
    dv = torch.empty_like(v) if need_dkv else None
    if q.numel() == 0 or k.numel() == 0 or not (need_dq or need_dkv):
        for t in (dq, dk, dv):
            if t is not None:
                t.zero_()
        return dq, dk, dv
    if plan["path"] == "mma":     # 16-byte cp.async copies of q, k, v and dO rows
        _check(all(t.data_ptr() % 16 == 0 for t in (q, k, v, dout)),
               "q, k, v and dout must be 16-byte aligned")
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    # the mma path's fp32 partial dK / dV of each GQA subset, summed by its reduce
    ws = (torch.empty((2, plan["splits"], B, Skv, Hkv, D), dtype=torch.float32, device=dev)
          if need_dkv and plan["splits"] > 1 else None)
    with torch.cuda.device(dev):
        err = _bwd_launcher()(
            BWD_PATHS.index(plan["path"]), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            None if ws is None else ws.data_ptr(), None if dq is None else dq.data_ptr(),
            None if dk is None else dk.data_ptr(), None if dv is None else dv.data_ptr(),
            B, Sq, Skv, H, Hkv, D, plan["splits"], float(scale), float(softcap),
            int(bool(causal)), int(window), int(q_offset), DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed (code {err}, plan {plan})")
    flash_attention_bwd_cuda.launches += 1
    flash_attention_bwd_cuda.launches_by_path[plan["path"]] += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0
flash_attention_bwd_cuda.launches_by_path = dict.fromkeys(BWD_PATHS, 0)
