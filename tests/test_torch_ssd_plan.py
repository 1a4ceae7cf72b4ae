"""The SSD scan's host-side plan (``kernels/ssd_scan/kernel.py::_plan``) and
its tensor-core path, on the CPU: the path, column width ``pb``, state steps
``nk`` and grid by dtype and shape; then a NumPy emulation of the ``mma``
path's arithmetic (64-token tiles, ``pb`` columns of P a block, bf16-exact
x / B / C, the cumulative sum in log2 units, M, the staged state and w x
rounded to hi + lo bf16 parts, each tile's products summed from zero in
fp32, the state carried in fp32 across tiles, a zero-filled tail) against
the JAX Pallas kernel in interpret mode and against the reference's
``ssd_chunked`` with a carried state, at the card tests' 1e-4."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.models.mamba import ssd_chunked
from repro_torch.kernels.ssd_scan.kernel import (COLUMN_BLOCKS, MIN_FILL, STATE_STEPS, TILE,
                                                 _plan)

F32, BF16 = torch.float32, torch.bfloat16
TOL = 1e-4                      # tests/test_torch_cuda.py's y / state bound for bf16 inputs
H100_SMS = 132
jax_ssd_chunked = jax.jit(ssd_chunked, static_argnums=5)   # one compile a shape


@pytest.mark.parametrize("shape,dtype,path,pb,nk,grid", [
    # chip_smoke's phase-2 rows: mamba2's pack (2 x 128 tokens) at pb 64
    # (128 blocks), one 297-token prompt and the 1024- and 4096-token
    # prefills at pb 32 (128 blocks; pb 64 would leave half the SMs idle),
    # jamba's pack (N 16) at pb 64
    ((2, 128, 64, 64, 128, 1), BF16, "mma", 64, 8, (64, 2, 1)),
    ((1, 297, 64, 64, 128, 1), BF16, "mma", 32, 8, (128, 1, 1)),
    ((1, 1024, 64, 64, 128, 1), BF16, "mma", 32, 8, (128, 1, 1)),
    ((1, 4096, 64, 64, 128, 1), BF16, "mma", 32, 8, (128, 1, 1)),
    ((2, 128, 128, 64, 16, 1), BF16, "mma", 64, 1, (128, 2, 1)),
    # fp32 stays IEEE fp32 on the tiled kernel, one block a (row, head)
    ((2, 128, 64, 64, 128, 1), F32, "tiled", 64, 0, (64, 2, 1)),
    ((1, 16, 2, 3, 4, 2), F32, "tiled", 3, 0, (2, 1, 1)),
    # tiny widths pad to one 16-column block and one k16 step; a small
    # grid takes the narrowest block (the most blocks), N pads to 16 nk
    ((1, 16, 2, 3, 4, 2), BF16, "mma", 16, 1, (2, 1, 1)),
    ((2, 17, 3, 4, 5, 3), BF16, "mma", 16, 1, (3, 2, 1)),
    ((2, 40, 8, 16, 16, 1), BF16, "mma", 16, 1, (8, 2, 1)),
    ((1, 8, 2, 48, 17, 1), BF16, "mma", 16, 2, (6, 1, 1)),
    ((1, 8, 2, 64, 33, 1), BF16, "mma", 16, 4, (8, 1, 1)),
    # more rows: the widest block
    ((8, 256, 64, 64, 128, 1), BF16, "mma", 64, 8, (64, 8, 1)),
    ((4, 256, 128, 64, 16, 1), BF16, "mma", 64, 1, (128, 4, 1)),
])
def test_plan_path_and_grid(shape, dtype, path, pb, nk, grid):
    plan = _plan(*shape, dtype, H100_SMS)
    assert (plan.path, plan.pb, plan.nk, plan.grid) == (path, pb, nk, grid)


@pytest.mark.parametrize("n_sm", [1, 16, 66, 132, 264])
@pytest.mark.parametrize("B,H,P,N", [(1, 64, 64, 128), (2, 64, 64, 128), (2, 128, 64, 16),
                                     (3, 8, 16, 16), (1, 2, 64, 64), (16, 64, 64, 128),
                                     (1, 40, 48, 128)])
def test_plan_fills_the_card(n_sm, B, H, P, N):
    """pb is the widest column block (no wider than P rounded up to 16)
    whose grid puts a block on MIN_FILL of the SMs, or else the narrowest."""
    plan = _plan(B, 100, H, P, N, 1, BF16, n_sm)
    widths = [pb for pb in COLUMN_BLOCKS if pb <= max(16, -(-P // 16) * 16)]
    assert plan.path == "mma" and plan.pb in widths
    blocks = H * -(-P // plan.pb) * B
    assert plan.grid == (H * -(-P // plan.pb), B, 1)
    assert all(H * -(-P // pb) * B < MIN_FILL * n_sm for pb in widths if pb > plan.pb)
    assert blocks >= MIN_FILL * n_sm or plan.pb == widths[-1]


@pytest.mark.parametrize("N,nk", [(1, 1), (16, 1), (17, 2), (32, 2), (33, 4), (64, 4), (65, 8),
                                  (128, 8)])
def test_state_is_padded_to_whole_k16_steps(N, nk):
    """N pads to 16 nk, nk a power of two: the kernel is built for nk = 1,
    2, 4 and 8 only."""
    assert nk in STATE_STEPS and _plan(1, 64, 8, 64, N, 1, BF16, H100_SMS).nk == nk


# ------------------------------------------------------------ emulation
def bf16_rn(a):
    """fp32 -> the nearest bf16 (ties to even), as fp32."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16 << 16).astype(np.uint32).view(np.float32)


def split(a):
    """hi + lo bf16 parts, each rounded to nearest (csrc/ssd_scan.cu's split_rn)."""
    hi = bf16_rn(a)
    return hi, bf16_rn(np.float32(a) - hi)


def emulate_mma(x, dt, A, Bm, Cm, init_state, pb):
    """The mma kernel's arithmetic in NumPy fp32: x (B, L, H, P), B / C (B,
    L, G, N) bf16-exact, dt (B, L, H), A (H,), init_state (B, H, P, N) or
    None. Returns (y (B, L, H, P), final state (B, H, P, N))."""
    f32 = np.float32
    Bb, L, H, P = x.shape
    G, N = Bm.shape[2:]
    plan = _plan(Bb, L, H, P, N, G, BF16, H100_SMS)
    assert plan.path == "mma"
    Np, Pp = 16 * plan.nk, -(-P // pb) * pb
    tiles = -(-L // TILE)
    Lp = tiles * TILE
    # zero-filled tail (dt = 0 there), zero columns past P and N
    xp = np.zeros((Bb, Lp, H, Pp), f32)
    xp[:, :L, :, :P] = x
    dtp = np.zeros((Bb, Lp, H), f32)
    dtp[:, :L] = dt
    Bp, Cp = (np.zeros((Bb, Lp, G, Np), f32) for _ in range(2))
    Bp[:, :L, :, :N], Cp[:, :L, :, :N] = Bm, Cm
    y = np.zeros((Bb, Lp, H, Pp), f32)
    final = np.zeros((Bb, H, Pp, Np), f32)
    causal = np.tril(np.ones((TILE, TILE), bool))
    for b in range(Bb):
        for h in range(H):
            g = h // (H // G)
            a2 = f32(A[h]) * f32(1.4426950408889634)
            for p0 in range(0, Pp, pb):              # one block: pb columns of one head
                cols = slice(p0, p0 + pb)
                S = np.zeros((Np, pb), f32)          # S[n][p], fp32 across tiles
                if init_state is not None:
                    live = init_state[b, h, p0:min(p0 + pb, P)].T
                    S[:N, :live.shape[1]] = live
                for t in range(tiles):
                    rows = slice(t * TILE, (t + 1) * TILE)
                    xs, d = xp[b, rows, h, cols], dtp[b, rows, h]
                    Bt, Ct = Bp[b, rows, g], Cp[b, rows, g]
                    a0 = d[0::2] * a2
                    a1 = a0 + d[1::2] * a2
                    incl = np.cumsum(a1, dtype=f32)
                    excl = np.concatenate([[f32(0)], incl[:-1]]).astype(f32)
                    cum = np.stack([excl + a0, excl + a1], 1).reshape(-1)
                    last = cum[-1]
                    w = np.exp2(last - cum) * d
                    sh, sl = split(S)
                    y_off = Ct @ sl + Ct @ sh
                    scores = Ct @ Bt.T
                    diff = np.where(causal, cum[:, None] - cum[None, :], -np.inf).astype(f32)
                    M = np.where(causal, scores * np.exp2(diff) * d[None, :], 0).astype(f32)
                    mh, ml = split(M)
                    y_diag = ml @ xs + mh @ xs
                    y[b, rows, h, cols] = y_diag + np.exp2(cum)[:, None] * y_off
                    xh, xl = split(xs * w[:, None])
                    S = np.exp2(last) * S + (Bt.T @ xl + Bt.T @ xh)
                final[b, h, cols] = S.T
    return y[:, :L, :, :P], final[:, :, :P, :N]


def _inputs(seed, Bb, L, H, P, N, G=None, init=False, nvalid=None):
    """bf16-exact x / B / C, fp32 dt (0 past each row's nvalid live tokens)
    and A, an fp32 initial state when ``init``."""
    r = np.random.default_rng(seed)
    G = G or H
    x = bf16_rn(r.standard_normal((Bb, L, H, P)))
    dt = r.uniform(0.01, 0.2, (Bb, L, H)).astype(np.float32)
    if nvalid is not None:
        dt[np.arange(L)[None, :] >= np.asarray(nvalid)[:, None]] = 0.0
    A = -r.uniform(0.5, 2.0, (H,)).astype(np.float32)
    Bm, Cm = (bf16_rn(r.standard_normal((Bb, L, G, N))) for _ in range(2))
    s0 = r.standard_normal((Bb, H, P, N)).astype(np.float32) if init else None
    return x, dt, A, Bm, Cm, s0


@pytest.mark.parametrize("Bb,L,H,P,N,Q", [
    (2, 32, 3, 8, 4, 8),
    (1, 24, 2, 16, 8, 8),
    (1, 16, 1, 4, 2, 16),
    (2, 27, 2, 8, 4, 8),
])
def test_mma_emulation_matches_pallas(Bb, L, H, P, N, Q):
    """tests/test_torch_ssd_scan.py's Pallas cases, on bf16-exact inputs."""
    x, dt, A, Bm, Cm, _ = _inputs(L, Bb, L, H, P, N)
    ref = jax_ssd_scan(*map(jnp.asarray, (x, dt, A, Bm, Cm)), Q, backend="pallas",
                       interpret=True)
    y, _ = emulate_mma(x, dt, A, Bm, Cm, None, 16)
    np.testing.assert_allclose(y, np.asarray(ref), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("L,chunk", [(16, 4), (17, 4), (32, 8), (8, 16), (40, 16)])
def test_mma_emulation_with_state_matches_jax(L, chunk):
    """tests/test_torch_ssd_scan.py's carried-state cases (P 4, N 5)."""
    x, dt, A, Bm, Cm, s0 = _inputs(L + chunk, 2, L, 3, 4, 5, init=True)
    y_ref, s_ref = jax_ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk,
                                   init_state=jnp.asarray(s0))
    y, s = emulate_mma(x, dt, A, Bm, Cm, s0, 16)
    np.testing.assert_allclose(y, np.asarray(y_ref), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(s, np.asarray(s_ref), atol=TOL, rtol=TOL)


@functools.cache
def _grouped_case(Bb, L, H, P, N, G, chunk, nvalid):
    """Inputs with B / C per group, and the reference's y and state (B / C
    repeated over each group's heads), computed once for every pb."""
    x, dt, A, Bm, Cm, s0 = _inputs(L + G, Bb, L, H, P, N, G=G, init=True, nvalid=nvalid)
    rep = H // G
    y_ref, s_ref = jax_ssd_chunked(
        *map(jnp.asarray, (x, dt, A, Bm.repeat(rep, 2), Cm.repeat(rep, 2))), chunk,
        init_state=jnp.asarray(s0))
    return (x, dt, A, Bm, Cm, s0), np.asarray(y_ref), np.asarray(s_ref)


@pytest.mark.parametrize("pb", [16, 32, 64])
@pytest.mark.parametrize("Bb,L,H,P,N,G,chunk,nvalid", [
    (2, 150, 4, 16, 16, 2, 16, (150, 70)),   # groups, three tiles, a ragged row
    (1, 200, 2, 64, 128, 1, 256, None),      # mamba2's head width and state over four tiles
])
def test_mma_emulation_ragged_groups_and_full_width(pb, Bb, L, H, P, N, G, chunk, nvalid):
    """Against the reference's ssd_chunked with a carried state at every
    column width: the split over P is exact, and the hi + lo scheme keeps
    y and the state within 1e-4 at mamba2's N = 128 and P = 64 over several
    tiles; a ragged row's state is that of its live tokens."""
    (x, dt, A, Bm, Cm, s0), y_ref, s_ref = _grouped_case(Bb, L, H, P, N, G, chunk, nvalid)
    y, s = emulate_mma(x, dt, A, Bm, Cm, s0, pb)
    np.testing.assert_allclose(y, y_ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(s, s_ref, atol=TOL, rtol=TOL)
    if nvalid is not None:
        n = nvalid[1]
        _, s1 = emulate_mma(x[1:, :n], dt[1:, :n], A, Bm[1:, :n], Cm[1:, :n], s0[1:], pb)
        np.testing.assert_allclose(s[1:], s1, atol=TOL, rtol=TOL)


def test_hi_alone_would_miss_the_bound():
    """Why the lo parts stay: at mamba2's width, M and the state rounded
    once to bf16 leave y beyond 1e-4 of the reference (the emulation
    above, lo parts dropped)."""
    x, dt, A, Bm, Cm, s0 = _inputs(3, 1, 130, 2, 64, 128, init=True)
    y_ref, _ = jax_ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), 256,
                               init_state=jnp.asarray(s0))
    global split
    full = split
    try:
        split = lambda a: (bf16_rn(a), np.zeros_like(a, np.float32))  # noqa: E731
        y, _ = emulate_mma(x, dt, A, Bm, Cm, s0, 16)
    finally:
        split = full
    err = np.abs(y - np.asarray(y_ref)) - TOL * (1 + np.abs(np.asarray(y_ref)))
    assert err.max() > 0
