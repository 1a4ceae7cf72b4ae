"""Bindings of the CUDA paged attention kernels of
``csrc/chunked_prefill.cu``, which replace the TPU kernels of
``repro/kernels/paged_attention/kernel.py``:

- ``chunked_prefill_cuda`` replaces ``chunked_prefill_pallas``: a chunk of
  C queries per row, the engine's path;
- ``paged_attention_cuda`` replaces ``paged_attention_pallas``: one query
  token per row, ``LM.decode_step`` over a paged cache. It is the chunked
  function at C = 1 with the query at position lengths[b] - 1, so it runs
  the ``split`` path in the kernels' decode mode (no starts: each block
  takes lengths[b] - 1 itself, so no device op computes it first).

``_plan`` picks one of chunked_prefill.cu's three kernels from what the
host knows, the shapes and dtypes (lengths and starts stay on the device,
so nothing is read back; blocks whose keys no query can see exit at once):

- ``split`` for at most ``SPLIT_MAX_ROWS`` = 32 folded query rows a KV
  head (C * G: the decode sweep, C = 1; verify chunks up to 8 tokens at G
  = 4), any dtype: flash-decoding, the pool row's key positions cut into
  ``splits`` ranges of whole ``SPLIT_KEYS`` tiles so that the grid holds
  ``SPLIT_BLOCKS_PER_SM`` blocks a SM where the capacity allows, then a
  fixed-order merge of each row's live splits. The threshold is measured
  (``chip_tune.py``: Mixtral's width over 512 positions, bf16, one H100 at
  700 W): split takes 0.0157 / 0.0192 / 0.0222 / 0.0266 / 0.0314 ms at 4 /
  8 / 16 / 20 / 32 rows, the tensor-core kernel 0.0249-0.0268 ms at any of
  them, so it wins from 20 rows; no caller sends 17-32 rows yet (verify
  chunks of 5-8 tokens), and the threshold stays at 32 until one does;
- ``mma`` for bf16 q and pool above that (prefill packs): ``mma.sync``
  tensor-core tiles of ``MMA_ROWS`` folded rows;
- ``tiled`` for fp32 or mixed dtypes above that: IEEE fp32 on the CUDA
  cores, ``TILED_ROWS`` folded rows a block.

Each wrapper validates its operands, allocates the output (and scratch),
launches on the current stream and raises if the launch failed; a call no
kernel takes raises ValueError. Its ``launches`` counts the calls that
launched the kernel, so a run can show that its path went through it;
``chunked_prefill_cuda.launches_by_path`` counts the chunked calls by path.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels.build import load_library

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 128)    # the tiny test configs' and Mixtral / Qwen / Gemma2's
PATHS = ("tiled", "split", "mma")   # codes 0..2 of csrc/chunked_prefill.cu
# constants of csrc/chunked_prefill.cu (checked at load, in
# chunked_prefill_constants' order)
SPLIT_KEYS = 32          # keys a tile of the split kernel; splits cut whole tiles
SPLIT_MAX_ROWS = 32      # at most this many folded rows (C * G) take the split kernel
MMA_ROWS = 64            # folded rows a block of the tensor-core kernel
MMA_KEYS = 64            # and its key tile
TILED_ROWS = 32          # folded rows a block of the fp32 tiled kernel
# split blocks the plan aims at a SM (a bf16 block at D = 128 and 4 rows
# takes ~37 KB of shared memory): blocks past the row's length exit at
# once, so a full grid keeps >= 2 a SM at typical fills. chip_tune.py on
# one H100 (bf16, 4 rows x 8 KV heads): over 4096 positions 2 / 4 / 8 / 16
# gave 0.0598 / 0.0505 / 0.0591 / 0.0661 ms; over 512 all in 0.0151-0.0167
SPLIT_BLOCKS_PER_SM = 4
GRID_LIMITS = (2 ** 31 - 1, 65535, 65535)


@dataclass(frozen=True)
class Plan:
    path: str        # one of PATHS
    splits: int      # key ranges merged by the split path (1 on the others)
    grid: tuple      # (x, y, z) blocks of the path's main kernel


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _plan(B: int, C: int, H: int, Hkv: int, D: int, ps: int, maxp: int, q_dtype, kv_dtype,
          n_sm: int) -> Plan:
    """The kernel and grid for q (B, C, H, D) over a pool of pages of ``ps``
    with ``maxp`` pages a row. Raises ValueError for a call no kernel
    takes."""
    if D not in HEAD_DIMS:
        raise ValueError(f"chunked_prefill_cuda: head_dim {D} not in {HEAD_DIMS}")
    if q_dtype not in DTYPE_CODES or kv_dtype not in DTYPE_CODES:
        raise ValueError(f"chunked_prefill_cuda: dtypes {q_dtype} / {kv_dtype} not in "
                         f"{list(DTYPE_CODES)}")
    if Hkv <= 0 or H % Hkv:
        raise ValueError(f"chunked_prefill_cuda: {H} query heads over {Hkv} kv heads")
    R = C * (H // Hkv)
    if R <= SPLIT_MAX_ROWS:
        units = max(1, _cdiv(maxp * ps, SPLIT_KEYS))
        splits = min(units, max(1, _cdiv(SPLIT_BLOCKS_PER_SM * n_sm, B * Hkv)))
        plan = Plan("split", splits, (splits, Hkv, B))
    elif q_dtype == torch.bfloat16 and kv_dtype == torch.bfloat16:
        plan = Plan("mma", 1, (_cdiv(R, MMA_ROWS), Hkv, B))
    else:
        plan = Plan("tiled", 1, (_cdiv(R, TILED_ROWS), Hkv, B))
    if not all(g <= lim for g, lim in zip(plan.grid, GRID_LIMITS)):
        raise ValueError(f"chunked_prefill_cuda: grid {plan.grid} of q {(B, C, H, D)} exceeds "
                         f"CUDA's limits")
    return plan


def split_ranges(cap: int, splits: int) -> list:
    """Key positions [k0, k1) of each split of a pool row of ``cap``
    positions: ceil(cap / SPLIT_KEYS) whole tiles cut as evenly as integers
    allow (csrc/chunked_prefill.cu's split_keys)."""
    units = max(1, _cdiv(cap, SPLIT_KEYS))
    return [(min(cap, s * units // splits * SPLIT_KEYS),
             min(cap, (s + 1) * units // splits * SPLIT_KEYS)) for s in range(splits)]


def visible_keys(length: int, start: int, C: int, cap: int, window: int) -> tuple:
    """Key positions [lo, hi) that some query of a row's chunk can see
    (csrc/chunked_prefill.cu's chunk_keys): below its length, its last
    query's position + 1 and the capacity, and inside its first query's
    window."""
    hi = max(min(length, start + C, cap), 0)
    lo = max(start - window + 1, 0) if window > 0 else 0
    return lo, hi


def live_splits(lo: int, hi: int, cap: int, splits: int) -> tuple:
    """The splits [s_lo, s_hi) whose ranges meet the visible keys [lo, hi)
    (csrc/chunked_prefill.cu's live_splits): only their blocks run, and the
    merge reads only theirs."""
    if lo >= hi:
        return 0, 0
    units = max(1, _cdiv(cap, SPLIT_KEYS))
    return (_cdiv((lo // SPLIT_KEYS + 1) * splits, units) - 1,
            _cdiv(_cdiv(hi, SPLIT_KEYS) * splits, units))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(q, k_pages, page_table) -> Plan:
    """The plan of a call on CUDA tensors: q (B, C, H, D), the pool (P, ps,
    Hkv, D), page_table (B, maxp)."""
    B, C, H, D = q.shape
    _, ps, Hkv, _ = k_pages.shape
    index = q.device.index if q.device.index is not None else torch.cuda.current_device()
    return _plan(B, C, H, Hkv, D, ps, page_table.shape[1], q.dtype, k_pages.dtype,
                 _sm_count(index))


@functools.cache
def _launcher():
    lib = load_library("chunked_prefill")
    consts = (ctypes.c_int * 5)()
    lib.chunked_prefill_constants.argtypes = [ctypes.c_void_p]
    lib.chunked_prefill_constants.restype = None
    lib.chunked_prefill_constants(consts)
    want = (SPLIT_KEYS, SPLIT_MAX_ROWS, MMA_ROWS, MMA_KEYS, TILED_ROWS)
    if tuple(consts) != want:
        raise RuntimeError(f"chunked_prefill library constants {tuple(consts)}, expected {want}")
    fn = lib.chunked_prefill_launch
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


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


def _launch(plan, q, k_pages, v_pages, page_table, lengths, starts, out, *, scale, softcap,
            window, who):
    """Launch ``plan`` for q / out (B, C, H, D) over the pool; ``starts``
    None is the split path's decode mode."""
    B, C, H, D = q.shape
    _, ps, Hkv, _ = k_pages.shape
    dev = q.device
    if plan.path != "tiled":   # 16-byte cp.async copies of q and the pool rows
        _check(all(t.data_ptr() % 16 == 0 for t in (q, k_pages, v_pages)),
               "q and the pools must be 16-byte aligned", who)
    part_acc = part_ml = None
    if plan.path == "split":   # (B, Hkv, splits, C * G) rows of P V (D), then of (max, sum)
        rows = B * Hkv * plan.splits * C * (H // Hkv)
        part_acc = torch.empty(rows * (D + 2), dtype=torch.float32, device=dev)
        part_ml = part_acc[rows * D:]
    with torch.cuda.device(dev):
        err = _launcher()(
            PATHS.index(plan.path), plan.splits, q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
            None if starts is None else starts.data_ptr(), out.data_ptr(),
            None if part_acc is None else part_acc.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(),
            B, C, H, Hkv, D, ps, page_table.shape[1], float(scale), float(softcap), int(window),
            DTYPE_CODES[q.dtype], DTYPE_CODES[k_pages.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{who}: kernel launch failed (code {err}, plan {plan})")


def chunked_prefill_cuda(q, k_pages, v_pages, page_table, lengths, starts, *,
                         scale: float, softcap: float = 0.0, window: int = 0):
    """q (B, C, H, D) at positions starts[b] + c attends causally over the
    paged pool (P, ps, Hkv, D), which already holds the chunk's own KV.
    fp32 or bf16 in (q and the pool may differ), fp32 softmax, output in
    q's dtype; the kernel is the one ``plan_for`` names."""
    who = "chunked_prefill_cuda"
    B = q.shape[0]
    _check_pool(q, k_pages, v_pages, page_table, lengths, who)
    dev = q.device
    _check(starts.device == dev and starts.is_contiguous(),
           f"starts must be contiguous on {dev}")
    _check(starts.shape == (B,) and starts.dtype == torch.int32, "starts must be (B,) int32")

    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    plan = plan_for(q, k_pages, page_table)
    _launch(plan, q, k_pages, v_pages, page_table, lengths, starts, out, scale=scale,
            softcap=softcap, window=window, who=who)
    chunked_prefill_cuda.launches += 1
    chunked_prefill_cuda.launches_by_path[plan.path] += 1
    return out


chunked_prefill_cuda.launches = 0
chunked_prefill_cuda.launches_by_path = dict.fromkeys(PATHS, 0)


def paged_attention_cuda(q, k_pages, v_pages, page_table, lengths, *,
                         scale: float, softcap: float = 0.0, window: int = 0):
    """q (B, H, D), one new token per row, attends to its row's pool
    entries at positions < lengths[b] (and, with a window, > lengths[b] - 1
    - window). fp32 or bf16 in (q and the pool may differ), fp32 math,
    output in q's dtype. One call launches the split kernel and its merge
    on the current stream (``plan_for`` at C = 1 names the splits)."""
    who = "paged_attention_cuda"
    _check(q.dim() == 3, f"q must be (B, H, D), got {tuple(q.shape)}", who)
    B, H, D = q.shape
    Hkv = _check_pool(q, k_pages, v_pages, page_table, lengths, who)[0]
    _check(H // Hkv <= SPLIT_MAX_ROWS,
           f"{H // Hkv} query heads per kv head > {SPLIT_MAX_ROWS}, the split path's most", who)

    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    q4 = q.view(B, 1, H, D)
    plan = plan_for(q4, k_pages, page_table)
    _launch(plan, q4, k_pages, v_pages, page_table, lengths, None, out.view(B, 1, H, D),
            scale=scale, softcap=softcap, window=window, who=who)
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0
