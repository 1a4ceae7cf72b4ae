"""The SSD backward's host-side plan (``kernels/ssd_scan/kernel.py::bwd_plan``)
and its tensor-core path, on the CPU: the path, heads a block ``hb``, state
steps ``nk``, grid, partials and shared memory by dtype and shape; then a
NumPy emulation of the ``mma`` path's arithmetic (64-token tiles walked last
to first, ``hb`` heads of a group a block, bf16-exact x / B / C, every fp32
operand of a product rounded to hi + lo bf16 parts, each product summed
from zero over the tile, M2 summed over the block's heads in head order,
dS' carried in fp32 across tiles) against ``ssd_reference_bwd`` and against
``jax.vjp`` of the reference's ``ssd_chunked``, at the card tests' 1e-4 of
each gradient's max |g|."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mamba import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssd_scan import kernel as K
from test_torch_ssd_bwd import CASES, GRAD_TOL, NAMES, _plain_bwd
from test_torch_ssd_plan import bf16_rn, split

F32, BF16 = torch.float32, torch.bfloat16
H100_SMS = 132
LOG2E = np.float32(1.4426950408889634)


# ------------------------------------------------------------------ plan
@pytest.mark.parametrize("shape,dtype,path,hb,nk,grid", [
    # the training shapes: mamba2 at hb 2 (hb 4's block would need 320 KB
    # of shared memory), jamba at hb 4, both 128 blocks
    ((4, 512, 64, 64, 128, 1), BF16, "mma", 2, 8, (32, 4, 1)),
    ((4, 512, 128, 64, 16, 1), BF16, "mma", 4, 1, (32, 4, 1)),
    # fp32 keeps the tiled kernel, one block a (row, head)
    ((4, 512, 64, 64, 128, 1), F32, "tiled", 1, 0, (64, 4, 1)),
    ((4, 512, 128, 64, 16, 1), F32, "tiled", 1, 0, (128, 4, 1)),
    # a group of one head (G = H), three heads a group: hb 1
    ((2, 17, 3, 4, 5, 3), BF16, "mma", 1, 1, (3, 2, 1)),
    ((1, 40, 3, 4, 6, 1), BF16, "mma", 1, 1, (3, 1, 1)),
    # small grids take the narrowest block
    ((2, 32, 4, 5, 4, 2), BF16, "mma", 1, 1, (4, 2, 1)),
    ((2, 150, 4, 64, 128, 2), BF16, "mma", 1, 8, (4, 2, 1)),
    # more rows: the widest block that fits
    ((16, 512, 64, 64, 128, 1), BF16, "mma", 2, 8, (32, 16, 1)),
    ((16, 512, 128, 64, 16, 1), BF16, "mma", 4, 1, (32, 16, 1)),
    ((16, 512, 64, 64, 64, 1), BF16, "mma", 2, 4, (32, 16, 1)),
    ((16, 512, 64, 64, 32, 1), BF16, "mma", 4, 2, (16, 16, 1)),
])
def test_bwd_plan_path_and_grid(shape, dtype, path, hb, nk, grid):
    plan = K.bwd_plan(*shape, dtype, H100_SMS)
    assert (plan["path"], plan["hb"], plan["nk"], plan["grid"]) == (path, hb, nk, grid)
    assert plan["threads"] == (128 * hb if path == "mma" else K.BWD_THREADS)


@pytest.mark.parametrize("n_sm", [1, 66, 132, 264])
@pytest.mark.parametrize("B,H,N,G", [(4, 64, 128, 1), (4, 128, 16, 1), (1, 64, 128, 1),
                                     (2, 8, 16, 2), (8, 40, 64, 1), (3, 24, 32, 1),
                                     (2, 6, 16, 3)])
def test_bwd_plan_fills_the_card(n_sm, B, H, N, G):
    """hb is the widest of 4 / 2 / 1 that divides the group's heads, fits
    the card's shared memory and still puts a block on MIN_FILL of the
    SMs, or else the narrowest that fits; the partials are (H / G / hb, B,
    L, G, N): each group's H / G / hb blocks' slots, summed."""
    plan = K.bwd_plan(B, 100, H, 64, N, G, BF16, n_sm)
    rep = H // G
    fits = [hb for hb in K.HEAD_BLOCKS if rep % hb == 0 and plan["nk"] in K.MMA_BWD_STEPS[hb]
            and K.bwd_mma_smem_bytes(hb, plan["nk"]) <= K.SMEM_LIMIT]
    hb = plan["hb"]
    assert plan["path"] == "mma" and hb in fits and plan["grid"] == (H // hb, B, 1)
    assert all(B * H // w < K.MIN_FILL * n_sm for w in fits if w > hb)
    assert B * H // hb >= K.MIN_FILL * n_sm or hb == fits[-1]
    part = (rep // hb, B, 100, G, N)
    assert plan["partials"] == {"dB": part, "dC": part, "dA": (B, H)}
    assert plan["group_sum"] * hb == rep
    assert plan["smem"] == K.bwd_mma_smem_bytes(hb, plan["nk"]) <= K.SMEM_LIMIT == 232448


@pytest.mark.parametrize("hb", [1, 2, 4])
@pytest.mark.parametrize("nk", [1, 2, 4, 8])
def test_mma_bwd_shared_memory(hb, nk):
    """The kernels built (MMA_BWD_STEPS) are exactly the (hb, nk) whose
    block fits the card: mamba2's (hb 2, nk 8) at 202304 bytes, jamba's
    (hb 4, nk 1) at 192640; hb 4 at nk 4 would need 254080."""
    size = K.bwd_mma_smem_bytes(hb, nk)
    assert (size <= K.SMEM_LIMIT) == (nk in K.MMA_BWD_STEPS[hb])
    nr = 16 * nk + 8
    arrays = dict(bc=2 * 64 * nr * 2, x=hb * 64 * 72 * 2, dy=2 * hb * 64 * 72 * 2,
                  sd=2 * hb * 64 * nr * 2, m2=2 * 64 * 72 * 2, m2f=64 * 68 * 4 * (hb > 1),
                  vectors=4 * 64 * hb * (11 + hb), scalars=4 * 8 * hb)
    assert size == sum(arrays.values()) and size % 16 == 0
    assert K.bwd_mma_smem_bytes(2, 8) == 202304 and K.bwd_mma_smem_bytes(4, 1) == 192640


# ------------------------------------------------------------------ emulation
def _scan(d, a2):
    """The kernel's inclusive scan of dt A in log2 units: two tokens a lane,
    then across the 32 lanes."""
    a0 = d[0::2] * a2
    a1 = a0 + d[1::2] * a2
    incl = np.cumsum(a1, dtype=np.float32)
    excl = np.concatenate([[np.float32(0)], incl[:-1]]).astype(np.float32)
    return np.stack([excl + a0, excl + a1], 1).reshape(-1)


def emulate_bwd_mma(x, dt, A, Bm, Cm, states, dy, d_final, hb, parts=None):
    """The mma backward's arithmetic in NumPy fp32: x (B, L, H, P) and B /
    C (B, L, G, N) bf16-exact, dt (B, L, H), A (H,), the tiles' entry
    states (B, ceil(L / 64), H, P, N), dy (B, L, H, P) and d_final (B, H,
    P, N) or None. ``parts`` rounds an fp32 operand to its bf16 parts
    (default: hi + lo, each to nearest). Returns (dx, ddt, dA, dB, dC,
    d_init), fp32, dB / dC summed over each group's heads."""
    parts = parts or split
    f32, T = np.float32, K.TILE
    Bb, L, H, P = x.shape
    G, N = Bm.shape[2:]
    rep = H // G
    assert rep % hb == 0
    Np = 16 * next(k for k in K.STATE_STEPS if 16 * k >= N)
    Pp, tiles = K.MAX_HEAD_DIM, -(-L // T)
    Lp = tiles * T

    def pad(a, shape, live):
        out = np.zeros(shape, f32)
        out[tuple(slice(0, n) for n in live)] = a
        return out

    xp = pad(x, (Bb, Lp, H, Pp), x.shape)
    dyp = pad(dy, (Bb, Lp, H, Pp), dy.shape)
    dtp = pad(dt, (Bb, Lp, H), dt.shape)
    Bp, Cp = (pad(a, (Bb, Lp, G, Np), a.shape) for a in (Bm, Cm))
    Sp = pad(states, (Bb, tiles, H, Pp, Np), states.shape)
    dx, dyz = np.zeros((Bb, Lp, H, Pp), f32), np.zeros((Bb, Lp, H), f32)
    ddt, dA = dyz.copy(), np.zeros((Bb, H), f32)
    dB, dC = (np.zeros((Bb, Lp, H // hb, Np), f32) for _ in range(2))
    d_init = np.zeros((Bb, H, Pp, Np), f32)
    causal = np.tril(np.ones((T, T), bool))
    for b in range(Bb):
        for blk in range(H // hb):
            heads = range(blk * hb, (blk + 1) * hb)
            g = heads[0] // rep
            dS = {h: (np.zeros((Pp, Np), f32) if d_final is None
                      else pad(d_final[b, h], (Pp, Np), d_final.shape[2:])) for h in heads}
            dA_acc = {h: f32(0) for h in heads}
            for t in reversed(range(tiles)):
                rows = slice(t * T, (t + 1) * T)
                Bt, Ct = Bp[b, rows, g], Cp[b, rows, g]
                CB = Ct @ Bt.T                       # bf16 x bf16: one product
                v, M2sum = {}, None
                for h in heads:
                    xs, d = xp[b, rows, h], dtp[b, rows, h]
                    cum = _scan(d, f32(A[h]) * LOG2E)
                    last = cum[-1]
                    Lm = np.where(causal, np.exp2(np.where(causal, cum[:, None] - cum[None, :],
                                                           0)), 0).astype(f32)
                    dyh, dyl = parts(dyp[b, rows, h])
                    # (i, j): rows i, keys j <= i
                    D = dyl @ xs.T + dyh @ xs.T
                    Gm = CB * Lm
                    M2 = Lm * d[None, :] * D
                    R = Gm * d[None, :] * D
                    M2sum = M2 if M2sum is None else M2sum + M2
                    # (j, i): G^T dy, G^T as hi + lo parts, three products
                    Gh, Gl = parts(Gm.T)
                    gdy = Gl @ dyh + Gh @ dyl + Gh @ dyh
                    # V = dy S from the staged state's parts; <dS', S>
                    Sh, Sl = parts(Sp[b, t, h])
                    V = dyl @ Sh + dyh @ Sl + dyh @ Sh
                    v[h] = dict(xs=xs, d=d, cum=cum, ecum=np.exp2(cum), wt=np.exp2(last - cum),
                                tot=np.exp2(last), dyh=dyh, dyl=dyl, rowr=R.sum(1),
                                colgd=(Gm * D).sum(0), gdy=gdy, V=V,
                                cv=(Ct * V).sum(1), dot=(dS[h] * (Sh + Sl)).sum(dtype=f32))
                # dC: the head sum of M2 against B, then each head's e^{a_i} V_i
                mh, ml = parts(M2sum)
                dCt = ml @ Bt + mh @ Bt
                for h in heads:
                    dCt = v[h]["ecum"][:, None] * v[h]["V"] + dCt
                # the staged dS': dx, x . U; dB
                dBt = ml.T @ Ct + mh.T @ Ct
                for h in heads:
                    e = v[h]
                    dSh, dSl = parts(dS[h])
                    U = Bt @ dSl.T + Bt @ dSh.T
                    e["dx"] = e["d"][:, None] * (e["wt"][:, None] * U + e["gdy"])
                    e["xu"] = (e["xs"] * U).sum(1)
                    W = e["xs"] @ dSl + e["xs"] @ dSh
                    dBt = (e["d"] * e["wt"])[:, None] * W + dBt
                # dS' <- 2^cum_Q dS' + (e^{a_i} dy_i)^T C, e^{a} dy from the
                # staged parts, rounded to hi + lo again
                for h in heads:
                    e = v[h]
                    eh, el = parts((e["dyh"] + e["dyl"]) * e["ecum"][:, None])
                    dS[h] = e["tot"] * dS[h] + (el.T @ Ct + eh.T @ Ct)
                # da, its suffix sums, ddt and dA (the tiled kernel's formulas)
                for h in heads:
                    e = v[h]
                    d, wt = e["d"], e["wt"]
                    s = d * wt * e["xu"]
                    da = e["rowr"] - d * e["colgd"] + e["ecum"] * e["cv"] - s
                    da[-1] += s.sum(dtype=f32) + e["tot"] * e["dot"]
                    suf = np.cumsum(da[::-1], dtype=f32)[::-1]
                    ddt[b, rows, h] = e["colgd"] + wt * e["xu"] + f32(A[h]) * suf
                    dA_acc[h] += (d * suf).sum(dtype=f32)
                    dx[b, rows, h] = e["dx"]
                dB[b, rows, blk], dC[b, rows, blk] = dBt, dCt
            for h in heads:
                d_init[b, h], dA[b, h] = dS[h], dA_acc[h]
    # the wrapper's sums: over each group's blocks in head order, over rows
    dBg, dCg = (a[:, :L].reshape(Bb, L, G, rep // hb, Np).sum(3)[..., :N] for a in (dB, dC))
    return (dx[:, :L, :, :P], ddt[:, :L], dA.sum(0), dBg, dCg, d_init[:, :, :P, :N])


def _bf16_inputs(seed, B, L, H, P, N, G, init, nvalid):
    """test_torch_ssd_bwd's inputs with x, B and C rounded to bf16, as the
    kernel takes them; the tiles' entry states from ssd_reference."""
    r = np.random.default_rng(seed)
    x = bf16_rn(r.standard_normal((B, L, H, P)))
    dt = r.uniform(0.01, 0.2, (B, L, H)).astype(np.float32)
    if nvalid is not None:
        dt *= (np.arange(L)[None, :] < np.asarray(nvalid)[:, None])[..., None]
    A = -r.uniform(0.5, 2.0, (H,)).astype(np.float32)
    Bm, Cm = (bf16_rn(r.standard_normal((B, L, G, N))) for _ in range(2))
    s0 = r.standard_normal((B, H, P, N)).astype(np.float32) if init else None
    dy = r.standard_normal((B, L, H, P)).astype(np.float32)
    d_final = r.standard_normal((B, H, P, N)).astype(np.float32)
    return x, dt, A, Bm, Cm, s0, dy, d_final


@functools.cache
def _case(seed, B, L, H, P, N, G, init, nvalid, final):
    """Inputs, the entry states and the plain gradients, computed once."""
    x, dt, A, Bm, Cm, s0, dy, d_final = _bf16_inputs(seed, B, L, H, P, N, G, init, nvalid)
    d_final = d_final if final else None
    t = [None if a is None else torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, s0, dy, d_final)]
    rep = H // G
    from repro_torch.kernels.ssd_scan import ssd_reference
    _, _, states = ssd_reference(t[0], t[1], t[2], t[3].repeat_interleave(rep, 2),
                                 t[4].repeat_interleave(rep, 2), K.TILE, init_state=t[5],
                                 states=True)
    plain = _plain_bwd(*t, K.TILE)
    return ((x, dt, A, Bm, Cm, s0, dy, d_final), states.numpy(),
            [None if g is None else g.numpy() for g in plain])


def _rel_errs(got, want, init):
    out = {}
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            continue
        assert g.shape == w.shape, (name, g.shape, w.shape)
        out[name] = float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1e-30)
    assert ("d_init" in out) == init
    return out


def _valid_hbs(H, G):
    return [hb for hb in (1, 2, 4) if (H // G) % hb == 0]


# the edge cases of test_torch_ssd_bwd (ragged L, groups, P 3 / N 4, G = H,
# a carried state, a padded row), each with a gradient into the final state
@pytest.mark.parametrize("case", list(CASES))
def test_mma_bwd_emulation_matches_reference(case):
    """Every hb the case's groups allow, against ssd_reference_bwd on the
    same bf16-exact inputs, states and cotangents."""
    B, L, H, P, N, G, init, nvalid = CASES[case]
    (x, dt, A, Bm, Cm, s0, dy, d_final), states, want = _case(
        7, B, L, H, P, N, G, init, None if nvalid is None else tuple(nvalid), True)
    for hb in _valid_hbs(H, G):
        got = emulate_bwd_mma(x, dt, A, Bm, Cm, states, dy, d_final, hb)
        errs = _rel_errs(got[:5] + (got[5] if init else None,), want, init)
        assert max(errs.values()) <= GRAD_TOL, (hb, errs)
        if case == "padded row":   # tokens past a row's end get no gradient through dt = 0
            assert not got[0][1, 13:].any() and not got[3][1, 13:].any()


@pytest.mark.parametrize("case", list(CASES))
def test_mma_bwd_emulation_matches_jax_vjp(case):
    """At the widest hb, against jax.vjp of repro.models.mamba.ssd_chunked
    (B / C repeated to the heads on the JAX side, its dB / dC summed back
    over each group)."""
    B, L, H, P, N, G, init, nvalid = CASES[case]
    (x, dt, A, Bm, Cm, s0, dy, d_final), states, _ = _case(
        11, B, L, H, P, N, G, init, None if nvalid is None else tuple(nvalid), True)
    rep = H // G

    def f(x_, dt_, A_, B_, C_, *s):
        return jax_ssd_chunked(x_, dt_, A_, jnp.repeat(B_, rep, 2), jnp.repeat(C_, rep, 2), 8,
                               init_state=s[0] if s else None)

    args = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)] + ([jnp.asarray(s0)] if init else [])
    _, vjp = jax.vjp(f, *args)
    want = [np.asarray(g) for g in vjp((jnp.asarray(dy), jnp.asarray(d_final)))]
    got = emulate_bwd_mma(x, dt, A, Bm, Cm, states, dy, d_final, _valid_hbs(H, G)[-1])
    errs = _rel_errs(got[:5] + (got[5] if init else None,), want + [None] * (not init), init)
    assert max(errs.values()) <= GRAD_TOL, errs


FULL = (2, 150, 4, 64, 128, 2, True, (150, 70))   # mamba2's widths, groups, 3 tiles, a ragged row


@pytest.mark.parametrize("hb", [1, 2])
def test_mma_bwd_emulation_full_width(hb):
    """P 64, N 128 over three tiles with a carried state, a padded row and a
    gradient into the final state: against ssd_reference_bwd and jax.vjp."""
    (x, dt, A, Bm, Cm, s0, dy, d_final), states, plain = _case(5, *FULL, True)
    got = emulate_bwd_mma(x, dt, A, Bm, Cm, states, dy, d_final, hb)
    errs = _rel_errs(got, plain, True)
    assert max(errs.values()) <= GRAD_TOL, errs
    rep = FULL[2] // FULL[5]

    def f(x_, dt_, A_, B_, C_, s_):
        return jax_ssd_chunked(x_, dt_, A_, jnp.repeat(B_, rep, 2), jnp.repeat(C_, rep, 2), 64,
                               init_state=s_)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm, s0)))
    want = [np.asarray(g) for g in vjp((jnp.asarray(dy), jnp.asarray(d_final)))]
    errs = _rel_errs(got, want, True)
    assert max(errs.values()) <= GRAD_TOL, errs


def test_hi_alone_would_miss_the_bound():
    """Why the lo parts stay: at mamba2's width, every fp32 operand rounded
    once to bf16 leaves a gradient beyond 1e-4 of its max |g| (the
    emulation above, lo parts dropped)."""
    (x, dt, A, Bm, Cm, s0, dy, d_final), states, plain = _case(5, *FULL, True)
    hi_only = emulate_bwd_mma(x, dt, A, Bm, Cm, states, dy, d_final, 2,
                              parts=lambda a: (bf16_rn(a), np.zeros_like(a, np.float32)))
    assert max(_rel_errs(hi_only, plain, True).values()) > GRAD_TOL
