"""Bindings of the CUDA SSD chunk scan (``csrc/ssd_scan.cu``), which
replaces the TPU kernel ``repro/kernels/ssd_scan/kernel.py::ssd_scan_pallas``
and adds the carried initial state and the final state that the model's
chunked prefill needs, and of its backward (``csrc/ssd_scan_bwd.cu``), the
gradient the reference takes by XLA autodiff of its plain scan.

``_plan`` picks one of the source's two kernels from the shapes and dtype:

- ``mma`` for bf16 x, B and C: ``mma.sync`` tensor-core tiles, each block
  taking ``pb`` columns of the head dimension P of one (row, head), grid
  (H * ceil(P / pb), B); the widest ``pb`` whose grid still puts a block on
  ``MIN_FILL`` of the SMs; N is padded to 16 ``nk``;
- ``tiled`` for fp32: IEEE fp32 on the CUDA cores, one block a (row, head).

The wrapper validates its operands, allocates the outputs, launches on the
current stream and raises if the launch failed. ``launches`` counts the
launches made, so a run can show that its path went through the kernel;
``launches_by_path`` counts them by path. ``ssd_scan_cuda(...,
states=True)`` also writes the state entering each 64-token tile, which
``ssd_scan_bwd_cuda`` reads; ``bwd_plan`` picks the backward's kernel
(``mma``: tensor-core tiles for bf16, ``hb`` heads of a group a block;
``tiled``: fp32 on the CUDA cores) and gives its grid and fp32 partials.
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
    fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
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


def ssd_scan_cuda(x, dt, A, B_, C, init_state=None, states: bool = False):
    """x (B, L, H, P); dt (B, L, H) fp32 post-softplus; A (H,) fp32
    negative; B_ / C (B, L, G, N) with G dividing H (head h reads group
    h // (H // G)); init_state (B, H, P, N) fp32 or None (zeros). x, B_ and
    C share one dtype (fp32 or bf16) and may be strided views whose last two
    dims are contiguous. P <= 64, N <= 128. The kernel is the one
    ``plan_for`` names. Returns (y (B, L, H, P) fp32, final_state (B, H, P,
    N) fp32), and with ``states`` also the state entering each tile of TILE
    tokens (B, ceil(L / TILE), H, P, N) fp32, the backward's input."""
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
    st = (torch.empty((Bb, _cdiv(L, TILE), H, P, N), dtype=torch.float32, device=dev)
          if states else None)
    if Bb == 0 or H == 0:
        return (y, final, st) if states else (y, final)
    plan = plan_for(x, B_)
    with torch.cuda.device(dev):
        err = _launcher()(
            PATHS.index(plan.path), plan.pb, plan.nk, x.data_ptr(), dt.data_ptr(),
            A.data_ptr(), B_.data_ptr(), C.data_ptr(),
            init_state.data_ptr() if init_state is not None else None,
            y.data_ptr(), final.data_ptr(), st.data_ptr() if states else None,
            Bb, L, H, P, N, G, *sx, *sb, *sc,
            DTYPE_CODES[x.dtype], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed (code {err}, plan {plan})")
    ssd_scan_cuda.launches += 1
    ssd_scan_cuda.launches_by_path[plan.path] += 1
    return (y, final, st) if states else (y, final)


ssd_scan_cuda.launches = 0
ssd_scan_cuda.launches_by_path = dict.fromkeys(PATHS, 0)


# ------------------------------------------------------------------ backward
BWD_PATHS = ("tiled", "mma")   # codes 0..1 of csrc/ssd_scan_bwd.cu
BWD_THREADS = 256        # constants of csrc/ssd_scan_bwd.cu, checked at load: tiled's threads
BWD_SMEM_MAX = 221248    # and its bytes a block at P 64, N 128
HEAD_BLOCKS = (4, 2, 1)  # mma: hb heads of one group a block, widest first
MMA_BWD_STEPS = {1: (1, 2, 4, 8), 2: (1, 2, 4, 8), 4: (1, 2)}   # nk built for each hb
SMEM_LIMIT = 232448      # bytes of shared memory a block may use on the H100
GRID_LIMITS = (2 ** 31 - 1, 65535, 65535)


def bwd_smem_bytes(P: int, N: int) -> int:
    """A tiled backward block's shared memory (csrc/ssd_scan_bwd.cu's smem_floats)."""
    PP, NP, kTP = _cdiv(P, 4) * 4, _cdiv(N, 8) * 8, TILE + 4
    return 4 * (2 * PP * kTP + TILE * PP + 2 * NP * kTP + PP * (NP + 4) + 3 * TILE * kTP
                + 3 * 16 * TILE + 8 * TILE + 16)


def bwd_mma_smem_bytes(hb: int, nk: int) -> int:
    """An mma backward block's shared memory (csrc/ssd_scan_bwd.cu's
    BwdShape): B and C [64][16 nk + 8] bf16; per head x, dy's hi and lo
    parts [64][72] bf16 and the state's (then dS''s) hi and lo parts
    [64][16 nk + 8] bf16; the head sum of M2 as hi and lo [64][72] bf16 and,
    with hb > 1, in fp32 [64][68]; per head 11 + hb vectors of 64 fp32 and
    8 scalars."""
    nr, xr = 16 * nk + 8, TILE + 8
    return (2 * TILE * nr * 2 + 3 * hb * TILE * xr * 2 + 2 * hb * MAX_HEAD_DIM * nr * 2
            + 2 * TILE * xr * 2 + (TILE * (TILE + 4) * 4 if hb > 1 else 0)
            + 4 * (TILE * hb * (11 + hb) + 8 * hb))


def bwd_plan(B: int, L: int, H: int, P: int, N: int, G: int, dtype, n_sm: int) -> dict:
    """The backward of a scan over x (B, L, H, P) with B / C (B, L, G, N) of
    ``dtype`` on ``n_sm`` SMs. A block walks its ``tiles`` of TILE tokens
    last to first.

    - bf16 takes ``mma``: a block takes ``hb`` heads of one group (4 warps
      a head), grid (H / hb, B); hb is the widest of HEAD_BLOCKS that
      divides the group's heads, whose block fits SMEM_LIMIT and whose
      grid still puts a block on MIN_FILL of the SMs, else the narrowest
      that fits. N is padded to 16 ``nk``.
    - fp32 takes ``tiled``: one block of BWD_THREADS a (row, head).

    The fp32 partials the wrapper reduces in a fixed order: dB and dC,
    summed over each group's ``group_sum`` slots (mma: (H / G / hb, B, L, G,
    N), each block's already summed over its heads, by the library's
    reduce kernel; tiled: (B, L, H, N) per head, in head order); dA per
    (row, head) (B, H), summed over rows. Raises ValueError for a call no
    path takes."""
    if not (1 <= P <= MAX_HEAD_DIM and 1 <= N <= MAX_STATE):
        raise ValueError(f"ssd_scan_bwd_cuda: head_dim {P} / d_state {N} beyond the kernel's "
                         f"{MAX_HEAD_DIM} / {MAX_STATE}")
    if G < 1 or H % G:
        raise ValueError(f"ssd_scan_bwd_cuda: {H} heads over {G} groups")
    rep = H // G
    if dtype == torch.bfloat16:
        nk = next(k for k in STATE_STEPS if 16 * k >= N)
        fits = [hb for hb in HEAD_BLOCKS if rep % hb == 0 and nk in MMA_BWD_STEPS[hb]
                and bwd_mma_smem_bytes(hb, nk) <= SMEM_LIMIT]
        hb = next((hb for hb in fits if B * (H // hb) >= MIN_FILL * n_sm), fits[-1])
        path, threads, smem = "mma", 128 * hb, bwd_mma_smem_bytes(hb, nk)
    else:
        hb, nk, path, threads, smem = 1, 0, "tiled", BWD_THREADS, bwd_smem_bytes(P, N)
    grid = (H // hb, B, 1)
    if not all(g <= lim for g, lim in zip(grid, GRID_LIMITS)):
        raise ValueError(f"ssd_scan_bwd_cuda: grid {grid} exceeds CUDA's limits")
    part = (rep // hb, B, L, G, N) if path == "mma" else (B, L, H, N)
    return dict(path=path, hb=hb, nk=nk, grid=grid, blocks=grid[0] * grid[1],
                threads=threads, tiles=_cdiv(L, TILE), smem=smem,
                partials={"dB": part, "dC": part, "dA": (B, H)}, group_sum=rep // hb)


def bwd_plan_for(x, B_) -> dict:
    """The backward plan of a call: x (B, L, H, P), B_ (B, L, G, N), on the card."""
    Bb, L, H, P = x.shape
    return bwd_plan(Bb, L, H, P, B_.shape[3], B_.shape[2], x.dtype,
                    _sm_count(x.device.index if x.device.index is not None
                              else torch.cuda.current_device()))


def bind_bwd(lib):
    """``lib``'s backward launch function with its C signature, once the
    library's constants and the mma blocks' shared memory are checked
    against the ones ``bwd_plan`` mirrors."""
    consts = (ctypes.c_int * 5)()
    lib.ssd_scan_bwd_constants.argtypes = [ctypes.c_void_p]
    lib.ssd_scan_bwd_constants.restype = None
    lib.ssd_scan_bwd_constants(consts)
    want = (TILE, MAX_HEAD_DIM, MAX_STATE, BWD_THREADS, BWD_SMEM_MAX)
    if tuple(consts) != want:
        raise RuntimeError(f"ssd_scan_bwd library constants {tuple(consts)}, expected {want}")
    lib.ssd_scan_bwd_mma_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ssd_scan_bwd_mma_smem.restype = ctypes.c_int
    for hb, steps in MMA_BWD_STEPS.items():
        for nk in steps:
            got = lib.ssd_scan_bwd_mma_smem(hb, nk)
            if got != bwd_mma_smem_bytes(hb, nk):
                raise RuntimeError(f"ssd_scan_bwd mma block (hb {hb}, nk {nk}): {got} bytes of "
                                   f"shared memory, expected {bwd_mma_smem_bytes(hb, nk)}")
    fn = lib.ssd_scan_bwd_launch
    fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 6 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_launcher():
    return bind_bwd(load_library("ssd_scan_bwd"))


@functools.cache
def _group_sum():
    fn = load_library("ssd_scan_bwd").ssd_scan_bwd_group_sum
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bwd_sums(plan, dB_part, dC_part, dA_part, dtype):
    """The backward's fixed-order sums: dB and dC (B, L, G, N) in ``dtype``
    over each group's ``group_sum`` partial slots (mma: the library's reduce
    kernel; tiled: over the group's heads, in head order), dA over rows.
    A part given as None gives None."""
    dA = None if dA_part is None else dA_part.sum(0)
    if dB_part is None:
        return None, None, dA
    if plan["path"] == "tiled":
        B, L, H, N = dB_part.shape
        return (*(t.view(B, L, H // plan["group_sum"], plan["group_sum"], N).sum(3).to(dtype)
                  for t in (dB_part, dC_part)), dA)
    gs, B, L, G, N = dB_part.shape
    outs = []
    dev = dB_part.device
    for part in (dB_part, dC_part):
        out = torch.empty((B, L, G, N), dtype=dtype, device=dev)
        if out.numel():
            with torch.cuda.device(dev):
                err = _group_sum()(part.data_ptr(), gs, out.data_ptr(), B * L * G, N,
                                   DTYPE_CODES[dtype], torch.cuda.current_stream(dev).cuda_stream)
            if err != 0:
                raise RuntimeError(f"ssd_scan_bwd group sum failed (code {err}, plan {plan})")
        outs.append(out)
    return (*outs, dA)


def ssd_scan_bwd_cuda(x, dt, A, B_, C, states, dy, d_final=None, *, need_x: bool = True,
                      need_dt: bool = True, need_A: bool = True, need_BC: bool = True,
                      need_init: bool = True):
    """The gradients (dx, ddt, dA, dB, dC, d_init_state) of
    ``ssd_scan_cuda(x, dt, A, B_, C, init_state)``'s (y, final_state), given
    dy (B, L, H, P) and d_final (B, H, P, N) (None: zeros) fp32 and the
    forward's ``states`` (B, ceil(L / TILE), H, P, N) fp32. Operands as the
    forward takes them (x / B_ / C strided views whose last two dims are
    contiguous). dx, dB and dC come back in x's dtype, ddt, dA and
    d_init_state in fp32; dB and dC are summed over each group's heads.
    A gradient whose ``need_*`` is False is None and not written."""
    dev = x.device
    _check(dev.type == "cuda", f"x is on {dev}, the kernel runs on CUDA tensors")
    _check(x.dim() == 4 and B_.dim() == 4, f"x / B_ shapes {tuple(x.shape)} / {tuple(B_.shape)}")
    Bb, L, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    for name, t in (("dt", dt), ("A", A), ("B_", B_), ("C", C), ("states", states), ("dy", dy)):
        _check(t.device == dev, f"{name} is on {t.device}, x on {dev}")
    _check(x.dtype in DTYPE_CODES, f"dtype {x.dtype} not in {list(DTYPE_CODES)}")
    _check(B_.dtype == x.dtype and C.dtype == x.dtype,
           f"B_ / C dtype {B_.dtype} / {C.dtype}, x {x.dtype}")
    plan = bwd_plan_for(x, B_)
    sx = _rows(x, "x", Bb, L, (H, P))
    sb = _rows(B_, "B_", Bb, L, (G, N))
    sc = _rows(C, "C", Bb, L, (G, N))
    for name, t, shape in (("dt", dt, (Bb, L, H)), ("A", A, (H,)), ("dy", dy, (Bb, L, H, P)),
                           ("states", states, (Bb, plan["tiles"], H, P, N)),
                           ("d_final", d_final, (Bb, H, P, N))):
        _check(t is None and name == "d_final" or (
            t.device == dev and t.dtype == torch.float32 and t.is_contiguous()
            and tuple(t.shape) == shape), f"{name} must be contiguous fp32 {shape} on {dev}")
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((Bb, L, H, P), dtype=x.dtype, device=dev) if need_x else None
    ddt = torch.empty((Bb, L, H), **f32) if need_dt else None
    dA_part = torch.empty((Bb, H), **f32) if need_A else None
    dB_part = torch.empty(plan["partials"]["dB"], **f32) if need_BC else None
    dC_part = torch.empty(plan["partials"]["dC"], **f32) if need_BC else None
    d_init = torch.empty((Bb, H, P, N), **f32) if need_init else None
    outs = (dx, ddt, dA_part, dB_part, dC_part, d_init)
    if Bb == 0 or H == 0 or not any(t is not None for t in outs):
        for t in outs:
            if t is not None:
                t.zero_()
    else:
        with torch.cuda.device(dev):
            err = _bwd_launcher()(
                BWD_PATHS.index(plan["path"]), plan["hb"], plan["nk"], x.data_ptr(),
                dt.data_ptr(), A.data_ptr(), B_.data_ptr(), C.data_ptr(),
                states.data_ptr(), dy.data_ptr(),
                None if d_final is None else d_final.data_ptr(),
                *(None if t is None else t.data_ptr() for t in outs),
                Bb, L, H, P, N, G, *sx, *sb, *sc, DTYPE_CODES[x.dtype],
                torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"ssd_scan_bwd kernel launch failed (code {err}, plan {plan})")
        ssd_scan_bwd_cuda.launches += 1
        ssd_scan_bwd_cuda.launches_by_path[plan["path"]] += 1
    dB, dC, dA = bwd_sums(plan, dB_part, dC_part, dA_part, x.dtype)
    return dx, ddt, dA, dB, dC, d_init


ssd_scan_bwd_cuda.launches = 0
ssd_scan_bwd_cuda.launches_by_path = dict.fromkeys(BWD_PATHS, 0)
