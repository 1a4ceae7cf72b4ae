"""Binding of the CUDA SSD chunk scan (``csrc/ssd_scan.cu``), which
replaces the TPU kernel ``repro/kernels/ssd_scan/kernel.py::ssd_scan_pallas``
and adds the carried initial state and the final state that the model's
chunked prefill needs.

``_plan`` picks one of the source's two kernels from the shapes and dtype:

- ``mma`` for bf16 x, B and C: ``mma.sync`` tensor-core tiles, each block
  taking ``pb`` columns of the head dimension P of one (row, head), grid
  (H * ceil(P / pb), B); the widest ``pb`` whose grid still puts a block on
  ``MIN_FILL`` of the SMs; N is padded to 16 ``nk``;
- ``tiled`` for fp32: IEEE fp32 on the CUDA cores, one block a (row, head).

The wrapper validates its operands, allocates the outputs, launches on the
current stream and raises if the launch failed. ``launches`` counts the
launches made, so a run can show that its path went through the kernel;
``launches_by_path`` counts them by path.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels.build import load_library

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
PATHS = ("tiled", "mma")   # codes 0..1 of csrc/ssd_scan.cu
# constants of csrc/ssd_scan.cu (checked at load, in ssd_scan_constants' order)
TILE = 64              # tokens a tile (kT)
MAX_HEAD_DIM = 64      # P: kMaxP
MAX_STATE = 128        # N: kMaxN
COLUMN_BLOCKS = (64, 32, 16)   # pb, widest first
STATE_STEPS = (1, 2, 4, 8)     # nk: N padded to 16 nk
MIN_FILL = 0.75        # a block's pb is the widest whose grid puts a block on 3/4 of the SMs


@dataclass(frozen=True)
class Plan:
    path: str        # one of PATHS
    grid: tuple      # (x, y, z) blocks
    pb: int          # columns of P a block (tiled: the whole head)
    nk: int          # k16 steps over N (mma); 0 on tiled


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _plan(B: int, L: int, H: int, P: int, N: int, G: int, dtype, n_sm: int) -> Plan:
    """The kernel and grid of a scan over x (B, L, H, P) with B / C (B, L, G,
    N) of ``dtype``. bf16 takes the tensor cores: of the column widths that
    fit P (rounded up to 16), the widest whose grid still puts a block on
    MIN_FILL of the SMs, else the narrowest (the most blocks). Every block
    stages its tile's whole B and C and computes its scores, so fewer,
    wider blocks move less and repeat less, as long as the card is busy.
    fp32 takes the tiled kernel."""
    if dtype == torch.bfloat16:
        nk = next(k for k in STATE_STEPS if 16 * k >= N)
        widths = [pb for pb in COLUMN_BLOCKS if pb <= max(16, _cdiv(P, 16) * 16)]
        pb = next((pb for pb in widths if H * _cdiv(P, pb) * B >= MIN_FILL * n_sm), widths[-1])
        return Plan("mma", (H * _cdiv(P, pb), B, 1), pb, nk)
    return Plan("tiled", (H, B, 1), P, 0)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(x, B_) -> Plan:
    """The plan of a call: x (B, L, H, P), B_ (B, L, G, N), on the card."""
    Bb, L, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    return _plan(Bb, L, H, P, N, G, x.dtype,
                 _sm_count(x.device.index if x.device.index is not None
                           else torch.cuda.current_device()))


def bind(lib):
    """``lib``'s launch function with its C signature, once the library's
    constants are checked against the ones ``_plan`` mirrors."""
    consts = (ctypes.c_int * 3)()
    lib.ssd_scan_constants.argtypes = [ctypes.c_void_p]
    lib.ssd_scan_constants.restype = None
    lib.ssd_scan_constants(consts)
    want = (TILE, MAX_HEAD_DIM, MAX_STATE)
    if tuple(consts) != want:
        raise RuntimeError(f"ssd_scan library constants {tuple(consts)}, expected {want}")
    fn = lib.ssd_scan_launch
    fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 6 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _launcher():
    return bind(load_library("ssd_scan"))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ssd_scan_cuda: {msg}")


def _rows(t, name: str, B: int, L: int, inner: tuple):
    """The (batch, token) strides of a (B, L, *inner) operand whose inner
    dims are contiguous; raises otherwise."""
    _check(tuple(t.shape) == (B, L, *inner), f"{name} shape {tuple(t.shape)}, "
           f"expected {(B, L, *inner)}")
    _check((inner[1] == 1 or t.stride(3) == 1) and (inner[0] == 1 or t.stride(2) == inner[1]),
           f"{name}'s last two dims must be contiguous (strides {t.stride()})")
    return t.stride(0), t.stride(1)


def ssd_scan_cuda(x, dt, A, B_, C, init_state=None):
    """x (B, L, H, P); dt (B, L, H) fp32 post-softplus; A (H,) fp32
    negative; B_ / C (B, L, G, N) with G dividing H (head h reads group
    h // (H // G)); init_state (B, H, P, N) fp32 or None (zeros). x, B_ and
    C share one dtype (fp32 or bf16) and may be strided views whose last two
    dims are contiguous. P <= 64, N <= 128. The kernel is the one
    ``plan_for`` names. Returns (y (B, L, H, P) fp32, final_state (B, H, P,
    N) fp32)."""
    dev = x.device
    _check(dev.type == "cuda", f"x is on {dev}, the kernel runs on CUDA tensors")
    _check(x.dim() == 4, f"x shape {tuple(x.shape)}")
    Bb, L, H, P = x.shape
    _check(B_.dim() == 4, f"B_ shape {tuple(B_.shape)}")
    G, N = B_.shape[2], B_.shape[3]
    for name, t in (("dt", dt), ("A", A), ("B_", B_), ("C", C)):
        _check(t.device == dev, f"{name} is on {t.device}, x on {dev}")
    _check(x.dtype in DTYPE_CODES, f"dtype {x.dtype} not in {list(DTYPE_CODES)}")
    _check(B_.dtype == x.dtype and C.dtype == x.dtype,
           f"B_ / C dtype {B_.dtype} / {C.dtype}, x {x.dtype}")
    _check(1 <= P <= MAX_HEAD_DIM and 1 <= N <= MAX_STATE,
           f"head_dim {P} / d_state {N} beyond the kernel's {MAX_HEAD_DIM} / {MAX_STATE}")
    _check(G >= 1 and H % G == 0, f"{H} heads over {G} groups")
    _check(Bb <= 65535, f"{Bb} rows exceed the grid's limit")
    sx = _rows(x, "x", Bb, L, (H, P))
    sb = _rows(B_, "B_", Bb, L, (G, N))
    sc = _rows(C, "C", Bb, L, (G, N))
    _check(dt.dtype == torch.float32 and dt.is_contiguous() and tuple(dt.shape) == (Bb, L, H),
           f"dt must be contiguous fp32 {(Bb, L, H)}, got {dt.dtype} {tuple(dt.shape)}")
    _check(A.dtype == torch.float32 and A.is_contiguous() and tuple(A.shape) == (H,),
           f"A must be contiguous fp32 ({H},)")
    if init_state is not None:
        _check(init_state.device == dev and init_state.dtype == torch.float32
               and init_state.is_contiguous() and tuple(init_state.shape) == (Bb, H, P, N),
               f"init_state must be contiguous fp32 {(Bb, H, P, N)} on {dev}")

    y = torch.empty((Bb, L, H, P), dtype=torch.float32, device=dev)
    final = torch.empty((Bb, H, P, N), dtype=torch.float32, device=dev)
    if Bb == 0 or H == 0:
        return y, final
    plan = plan_for(x, B_)
    with torch.cuda.device(dev):
        err = _launcher()(
            PATHS.index(plan.path), plan.pb, plan.nk, x.data_ptr(), dt.data_ptr(),
            A.data_ptr(), B_.data_ptr(), C.data_ptr(),
            init_state.data_ptr() if init_state is not None else None,
            y.data_ptr(), final.data_ptr(), Bb, L, H, P, N, G, *sx, *sb, *sc,
            DTYPE_CODES[x.dtype], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed (code {err}, plan {plan})")
    ssd_scan_cuda.launches += 1
    ssd_scan_cuda.launches_by_path[plan.path] += 1
    return y, final


ssd_scan_cuda.launches = 0
ssd_scan_cuda.launches_by_path = dict.fromkeys(PATHS, 0)
