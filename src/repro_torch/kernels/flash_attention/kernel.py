"""Binding of the CUDA flash attention kernels (``csrc/flash_attention.cu``),
which replace the TPU kernel
``repro/kernels/flash_attention/kernel.py::flash_attention_bhsd``.

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
path.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels.build import load_library

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 128)    # the tiny test configs' and Mixtral / Qwen / Gemma2's
PATHS = ("tiled", "mma")  # codes 0..1 of csrc/flash_attention.cu
# constants of csrc/flash_attention.cu (checked at load, in
# flash_attention_constants' order)
TILED_ROWS = 64          # query rows a block of the fp32 tiled kernel
MMA_ROWS = 64            # folded rows a block of the tensor-core kernel
MMA_KEYS = 64            # and its key tile
GRID_LIMITS = (2 ** 31 - 1, 65535, 65535)


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
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _launcher():
    return bind(load_library("flash_attention"))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention_cuda: {msg}")


def plan_for(q, k) -> Plan:
    """The plan of a call: q (B, Sq, H, D), k (B, Skv, Hkv, D)."""
    B, Sq, H, D = q.shape
    return _plan(B, Sq, H, k.shape[2], D, q.dtype)


def flash_attention_cuda(q, k, v, *, causal: bool, window: int = 0, softcap: float = 0.0,
                         q_offset: int = 0, scale: float):
    """q (B, Sq, H, D) against k / v (B, Skv, Hkv, D), one dtype (fp32 or
    bf16), fp32 math, output in q's dtype. Query row i sits at position
    i + q_offset; any Sq and Skv (the kernels mask the ragged edges). The
    kernel is the one ``plan_for`` names."""
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
    if out.numel() == 0:
        return out
    if plan.path == "mma":     # 16-byte cp.async copies of q, k and v rows
        _check(all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
               "q, k and v must be 16-byte aligned")
    with torch.cuda.device(dev):
        err = _launcher()(
            PATHS.index(plan.path), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Skv, H, Hkv, D, float(scale), float(softcap), int(bool(causal)),
            int(window), int(q_offset), DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed (code {err}, plan {plan})")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.launches_by_path[plan.path] += 1
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_by_path = dict.fromkeys(PATHS, 0)
