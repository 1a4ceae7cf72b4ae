"""Bindings of the CUDA paged attention kernels, which replace the TPU
kernels of ``repro/kernels/paged_attention/kernel.py``:

- ``chunked_prefill_cuda`` (``csrc/chunked_prefill.cu``) replaces
  ``chunked_prefill_pallas``: a chunk of C queries per row, the engine's
  path;
- ``paged_attention_cuda`` (``csrc/paged_attention.cu``) replaces
  ``paged_attention_pallas``: one query token per row, ``LM.decode_step``
  over a paged cache.

Each wrapper validates its operands, allocates the output (and scratch),
launches on the current stream and raises if the launch failed. Its
``launches`` counts the calls that launched the kernel, so a run can show
that its path went through it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import load_library

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 128)    # the tiny test configs' and Mixtral / Qwen / Gemma2's
MAX_GROUP = 8            # query heads per kv head in paged_attention_cuda (kMaxG)


@functools.cache
def _launcher():
    fn = load_library("chunked_prefill").chunked_prefill_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _decode_launcher():
    lib = load_library("paged_attention")
    lib.paged_attention_splits.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.paged_attention_splits.restype = ctypes.c_int
    fn = lib.paged_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib.paged_attention_splits, fn


def _check(cond: bool, msg: str, who: str = "chunked_prefill_cuda") -> None:
    if not cond:
        raise ValueError(f"{who}: {msg}")


def _check_pool(q, k_pages, v_pages, page_table, lengths, who):
    """Checks shared by both wrappers: devices, layouts, dtypes, head dims,
    the page table and lengths. Returns (Hkv, D, ps, maxp)."""
    H, D = q.shape[-2:]
    P, ps, Hkv, Dk = k_pages.shape
    dev = q.device
    _check(dev.type == "cuda", f"q is on {dev}, the kernel runs on CUDA tensors", who)
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("lengths", lengths)):
        _check(t.device == dev, f"{name} is on {t.device}, q on {dev}", who)
        _check(t.is_contiguous(), f"{name} must be contiguous", who)
    _check(q.dtype in DTYPE_CODES, f"q dtype {q.dtype} not in {list(DTYPE_CODES)}", who)
    _check(k_pages.dtype in DTYPE_CODES and v_pages.dtype == k_pages.dtype,
           f"pool dtypes {k_pages.dtype}/{v_pages.dtype}", who)
    _check(v_pages.shape == k_pages.shape, "k/v pools differ in shape", who)
    _check(Dk == D and D in HEAD_DIMS, f"head_dim {D} (pool {Dk}) not in {HEAD_DIMS}", who)
    _check(Hkv > 0 and H % Hkv == 0, f"{H} query heads over {Hkv} kv heads", who)
    B = q.shape[0]
    _check(B <= 65535, f"{B} rows exceed the grid's z limit", who)
    maxp = page_table.shape[1] if page_table.dim() == 2 else -1
    _check(page_table.shape == (B, maxp) and page_table.dtype == torch.int32,
           "page_table must be (B, max_pages) int32", who)
    _check(lengths.shape == (B,) and lengths.dtype == torch.int32,
           "lengths must be (B,) int32", who)
    return Hkv, D, ps, maxp


def chunked_prefill_cuda(q, k_pages, v_pages, page_table, lengths, starts, *,
                         scale: float, softcap: float = 0.0, window: int = 0):
    """q (B, C, H, D) at positions starts[b] + c attends causally over the
    paged pool (P, ps, Hkv, D), which already holds the chunk's own KV.
    fp32 or bf16 in (q and the pool may differ), fp32 math, output in q's
    dtype."""
    B, C, H, D = q.shape
    Hkv, D, ps, maxp = _check_pool(q, k_pages, v_pages, page_table, lengths,
                                   "chunked_prefill_cuda")
    dev = q.device
    _check(starts.device == dev and starts.is_contiguous(),
           f"starts must be contiguous on {dev}")
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


def paged_attention_cuda(q, k_pages, v_pages, page_table, lengths, *,
                         scale: float, softcap: float = 0.0, window: int = 0):
    """q (B, H, D), one new token per row, attends to its row's pool
    entries at positions < lengths[b] (and, with a window, > lengths[b] - 1
    - window). fp32 or bf16 in (q and the pool may differ), fp32 math,
    output in q's dtype. One call launches the split pass and its combine
    on the current stream."""
    who = "paged_attention_cuda"
    _check(q.dim() == 3, f"q must be (B, H, D), got {tuple(q.shape)}", who)
    B, H, D = q.shape
    Hkv, D, ps, maxp = _check_pool(q, k_pages, v_pages, page_table, lengths, who)
    _check(H // Hkv <= MAX_GROUP, f"{H // Hkv} query heads per kv head > {MAX_GROUP}", who)

    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    splits, launch = _decode_launcher()
    nsplit = splits(ps, maxp)
    dev = q.device
    part_acc = torch.empty((B, Hkv, nsplit, H // Hkv, D), dtype=torch.float32, device=dev)
    part_ml = torch.empty((B, Hkv, nsplit, H // Hkv, 2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
            B, H, Hkv, D, ps, maxp, float(scale), float(softcap), int(window),
            DTYPE_CODES[q.dtype], DTYPE_CODES[k_pages.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed (code {err})")
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0
