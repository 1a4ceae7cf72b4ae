"""Flash attention's host-side plan (``kernels/flash_attention/kernel.py::
_plan``) and its tensor-core path, on the CPU: the path and grid by dtype,
head dim and shape; the closed form of the key tiles each block of 64
folded rows walks against a brute force of the mask; and a NumPy emulation of the mma path's arithmetic
(folded rows, 64-key tiles, log2-unit online softmax, P as truncated hi + lo
bf16 parts, each tile's P V summed from zero) against the JAX Pallas kernel
in interpret mode, at the reference's bf16 tolerance and, in fp32, within
the hi + lo split's bound.

Paged decode runs chunked attention's split path at C = 1 with the query at
lengths[b] - 1: the identity that route rests on is checked here too, the
plain chunked version against ``paged_attention_reference`` and both, with
the split path's emulation, against ``paged_attention_pallas`` in interpret
mode."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.paged_attention import paged_attention as jax_paged
from repro_torch.kernels.flash_attention.kernel import (MMA_KEYS, MMA_ROWS, _plan,
                                                        block_positions, key_tiles)
from repro_torch.kernels.paged_attention import (chunked_prefill_partials,
                                                 chunked_prefill_reference, merge_partials,
                                                 paged_attention_reference)
from repro_torch.kernels.paged_attention import kernel as pk

F32, BF16 = torch.float32, torch.bfloat16
TOL = 2e-5                                  # tests/test_kernels_flash.py, fp32
LOG2E = np.float32(1.4426950408889634)


@pytest.mark.parametrize("B,Sq,H,Hkv,D,dtype,path,grid", [
    (4, 297, 32, 8, 128, BF16, "mma", (19, 8, 4)),      # chip_smoke's prefill: 1188 folded rows
    (4, 297, 32, 16, 128, BF16, "mma", (10, 16, 4)),    # gemma2's heads: G = 2
    (4, 297, 32, 8, 128, F32, "tiled", (5, 32, 4)),     # fp32 stays IEEE on the CUDA cores
    (2, 37, 16, 2, 128, BF16, "mma", (5, 2, 2)),        # 296 rows: a ragged last block
    (1, 1, 8, 8, 16, BF16, "mma", (1, 8, 1)),           # G = 1, one row
    (3, 50, 4, 2, 16, F32, "tiled", (1, 4, 3)),
    (2, 1024, 16, 16, 64, BF16, "mma", (16, 16, 2)),    # seamless-m4t's encoder, G = 1
    (4, 1, 16, 16, 64, BF16, "mma", (1, 16, 4)),        # its cross attention at decode
    (2, 128, 16, 16, 64, F32, "tiled", (2, 16, 2)),
    (1, 704, 32, 32, 96, BF16, "mma", (11, 32, 1)),     # phi-3-vision's prefixed chunk
])
def test_plan_path_and_grid(B, Sq, H, Hkv, D, dtype, path, grid):
    """bf16 takes the tensor cores over ceil(Sq * G / 64) blocks of folded
    rows a KV head; fp32 the tiled kernel, 64 query rows of one head a
    block."""
    plan = _plan(B, Sq, H, Hkv, D, dtype)
    assert (plan.path, plan.grid) == (path, grid)


@pytest.mark.parametrize("args,msg", [
    ((2, 64, 32, 8, 80, BF16), "head_dim"),
    ((2, 64, 32, 8, 128, torch.float16), "dtype"),
    ((2, 64, 32, 6, 128, BF16), "query heads"),
    ((70000, 64, 32, 8, 128, BF16), "grid"),
    ((2, 64, 70000, 70000, 16, F32), "grid"),
    ((2, 64, 70000, 70000, 16, BF16), "grid"),
])
def test_plan_rejects_what_no_kernel_takes(args, msg):
    with pytest.raises(ValueError, match=msg):
        _plan(*args)


def _visible(Sq, Skv, G, causal, window, q_offset, r0):
    """Brute force: the (row, key) pairs of block r0's folded rows that the
    mask lets through, as a boolean (rows, Skv) array."""
    rows = np.arange(r0, min(r0 + MMA_ROWS, Sq * G))
    pos = rows // G + q_offset
    keys = np.arange(Skv)
    vis = np.ones((len(rows), Skv), bool)
    if causal:
        vis &= keys[None] <= pos[:, None]
    if window > 0:
        vis &= keys[None] > pos[:, None] - window
    return vis


@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 5, 64, 100])
def test_block_key_tiles_match_the_mask(G, causal, window):
    """Each block walks exactly the 64-key tiles that hold a key one of its
    rows sees: q_offset 0 / 17 / 64, Sq and Skv of no tile multiple."""
    for Sq, Skv, q_offset in ((50, 70, 0), (130, 130, 0), (33, 200, 17), (20, 84, 64)):
        for blk in range(-(-Sq * G // MMA_ROWS)):
            q_lo, q_hi = block_positions(blk, Sq, G, q_offset)
            t0, tiles = key_tiles(q_lo, q_hi, Skv, causal, window)
            vis = _visible(Sq, Skv, G, causal, window, q_offset, blk * MMA_ROWS)
            want = sorted({int(j) // MMA_KEYS for j in np.nonzero(vis.any(0))[0]})
            assert list(range(t0, t0 + tiles)) == want, (Sq, Skv, q_offset, blk)


def _trunc(x):
    """x truncated to bf16 (its upper 16 bits), as split_pair does."""
    return (x.astype(np.float32).view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)


def _mma_emulation(q, k, v, *, causal, window, softcap, q_offset, scale):
    """The mma path's arithmetic in fp32: per KV head, blocks of 64 folded
    rows (r = s * G + g) walk the tiles ``key_tiles`` names (keys past Skv
    zero), scores in log2 units, masked, an online softmax with the running
    max, P as truncated hi + lo bf16 parts, each tile's lo V + hi V added to
    the rescaled accumulator."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1:3]
    G, R = H // Hkv, Sq * (H // Hkv)
    out = np.zeros_like(q)
    for b in range(B):
        for h in range(Hkv):
            Q = q[b, :, h * G:(h + 1) * G].reshape(R, D)
            for blk in range(-(-R // MMA_ROWS)):
                rows = np.arange(blk * MMA_ROWS, min((blk + 1) * MMA_ROWS, R))
                t0, tiles = key_tiles(*block_positions(blk, Sq, G, q_offset), Skv, causal,
                                      window)
                pos = rows // G + q_offset
                m = np.full(len(rows), -1e30, np.float32)
                l = np.zeros(len(rows), np.float32)
                o = np.zeros((len(rows), D), np.float32)
                for t in range(t0, t0 + tiles):
                    keys = np.arange(t * MMA_KEYS, (t + 1) * MMA_KEYS)
                    live = keys < Skv
                    kt, vt = np.zeros((2, MMA_KEYS, D), np.float32)
                    kt[live], vt[live] = k[b, keys[live], h], v[b, keys[live], h]
                    x = (Q[rows] @ kt.T) * np.float32(scale)
                    if softcap > 0:
                        x = np.float32(softcap) * np.tanh(x / np.float32(softcap))
                    mask = np.broadcast_to(live[None], x.shape)
                    if causal:
                        mask = mask & (keys[None] <= pos[:, None])
                    if window > 0:
                        mask = mask & (keys[None] > pos[:, None] - window)
                    x = np.where(mask, x * LOG2E, -np.inf).astype(np.float32)
                    m_new = np.maximum(m, x.max(1))
                    alpha = np.exp2(m - m_new).astype(np.float32)
                    p = np.exp2(x - m_new[:, None]).astype(np.float32)
                    l = alpha * l + p.sum(1, dtype=np.float32)
                    m = m_new
                    hi = _trunc(p)
                    o = o * alpha[:, None] + (_trunc(p - hi) @ vt + hi @ vt)
                res = np.where(l[:, None] > 0, o / np.where(l > 0, l, 1)[:, None], 0)
                out[b, rows // G, h * G + rows % G] = res
    return out


@pytest.mark.parametrize("case", [
    # B, Sq, Skv, H, Hkv, D, causal, window, softcap, q_offset
    (2, 64, 64, 4, 2, 16, True, 0, 0.0, 0),
    (1, 96, 96, 4, 2, 64, True, 32, 0.0, 0),        # sliding window
    (1, 80, 80, 8, 1, 16, True, 16, 30.0, 0),       # window + softcap, G = 8
    (2, 32, 96, 8, 2, 16, True, 0, 0.0, 64),        # chunked-prefill offset
    (1, 50, 70, 4, 2, 16, False, 0, 0.0, 0),        # non-causal, ragged Skv
    (1, 150, 150, 16, 2, 16, True, 0, 0.0, 0),      # G = 8, 1200 folded rows
    (1, 45, 130, 4, 2, 16, False, 20, 50.0, 85),    # non-causal window and offset
    (2, 70, 70, 4, 4, 64, False, 0, 0.0, 0),        # seamless-m4t's encoder
    (2, 9, 130, 4, 4, 64, False, 0, 0.0, 0),        # its cross attention: a chunk
    (3, 1, 77, 4, 4, 64, False, 0, 0.0, 0),         # and one token
    (1, 90, 90, 4, 4, 96, True, 0, 0.0, 0),         # phi3 / phi-3-vision's head dim
    (1, 33, 100, 4, 2, 96, True, 16, 30.0, 67),
])
def test_mma_emulation_matches_pallas(case):
    """On bf16 inputs (what the mma path reads), the path's arithmetic
    against flash_attention_bhsd in interpret mode, every row (those that
    see no key included): rounded to bf16, within the reference's bf16
    tolerance 2e-2 of the Pallas kernel's bf16 output; in fp32, within the
    hi + lo split's bound of the Pallas kernel's fp32 output: each P loses
    less than 2^-14 of itself to the two truncations, so an output moves by
    less than 2^-14 max |v|, beside the fp32 tolerance 2e-5 for the order of
    summation."""
    B, Sq, Skv, H, Hkv, D, causal, window, softcap, q_offset = case
    rng = np.random.default_rng(sum(case[:6]))
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16()
               for s in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset)
    emu = _mma_emulation(*(t.float().numpy() for t in (q, k, v)), scale=D ** -0.5, **kw)
    assert np.isfinite(emu).all()

    def pallas(*ts):
        return jax_flash(*map(jnp.asarray, ts), block_q=16, block_kv=32, backend="pallas",
                         interpret=True, **kw)

    pal32 = np.asarray(pallas(*(t.float().numpy() for t in (q, k, v))))
    bound = 2.0 ** -14 * float(v.float().abs().max()) + TOL
    np.testing.assert_allclose(emu, pal32, atol=bound, rtol=0)
    pal16 = np.asarray(pallas(*(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v))),
                       np.float32)
    emu16 = torch.from_numpy(emu).bfloat16().float().numpy()
    np.testing.assert_allclose(emu16, pal16, atol=2e-2, rtol=2e-2)


def _decode_case(seed, *, ps, G, B=5, Hkv=2, D=16, maxp=8):
    """One query a row over the pool: lengths 0, 1, a page edge, a split
    (32-key tile) edge and the pool row's capacity."""
    rng = np.random.default_rng(seed)
    P = B * maxp + 1
    kp, vp = (rng.standard_normal((P, ps, Hkv, D)).astype(np.float32) for _ in range(2))
    pt = (rng.permutation(P - 1)[:B * maxp].reshape(B, maxp) + 1).astype(np.int32)
    lengths = np.minimum(np.asarray([0, 1, ps, pk.SPLIT_KEYS, maxp * ps]), maxp * ps)
    q = rng.standard_normal((B, G * Hkv, D)).astype(np.float32)
    return q, kp, vp, pt, lengths.astype(np.int32)


@pytest.mark.parametrize("ps", [4, 8, 16])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (9, 0.0), (0, 30.0), (5, 2.0)])
@pytest.mark.parametrize("G", [1, 4, 16])
def test_paged_decode_is_chunked_at_one_token(ps, window, softcap, G):
    """Paged decode equals the chunked function at C = 1 with the query at
    lengths - 1 (the split path's decode mode): the plain chunked version
    equals paged_attention_reference, and both, with the split path's
    emulation at the plan's splits, match paged_attention_pallas in
    interpret mode within 2e-5; a length-0 row gives zeros."""
    q, kp, vp, pt, lengths = _decode_case(ps + G + window, ps=ps, G=G)
    kw = dict(scale=q.shape[-1] ** -0.5, softcap=softcap, window=window)
    t = [torch.from_numpy(a) for a in (q, kp, vp, pt, lengths)]
    qpos = (t[4] - 1)[:, None]
    chunked = chunked_prefill_reference(t[0][:, None], *t[1:], qpos, **kw)[:, 0].numpy()
    paged = paged_attention_reference(*t, **kw).numpy()
    np.testing.assert_allclose(chunked, paged, atol=1e-6, rtol=0)
    # the split path's arithmetic: each live split's softmax state, merged
    B, H, D = q.shape
    cap = pt.shape[1] * ps
    splits = pk._plan(B, 1, H, kp.shape[2], D, ps, pt.shape[1], F32, F32, 132).splits
    emu = np.zeros_like(q)
    for b in range(B):
        lo, hi = pk.visible_keys(int(lengths[b]), int(lengths[b]) - 1, 1, cap, window)
        s_lo, s_hi = pk.live_splits(lo, hi, cap, splits)
        row = [t[0][b:b + 1, None], t[1], t[2], t[3][b:b + 1], t[4][b:b + 1], qpos[b:b + 1]]
        parts = [chunked_prefill_partials(*row, key_range=r, **kw)
                 for r in pk.split_ranges(cap, splits)[s_lo:s_hi]]
        if parts:
            emu[b] = merge_partials(parts)[0, 0].numpy()
    pal = np.asarray(jax_paged(*map(jnp.asarray, (q, kp, vp, pt, lengths)), backend="pallas",
                               interpret=True, **kw))
    for got in (chunked, paged, emu):
        np.testing.assert_allclose(got, pal, atol=TOL, rtol=0)
    assert not emu[0].any() and not chunked[0].any(), "a length-0 row must give zeros"
