"""The chunked attention kernel's host-side plan (``kernels/paged_attention/
kernel.py::_plan``) and its split path, on the CPU: the path, split count
and grid at the engine's shapes; the split key ranges, which must hold every
key a chunk can see exactly once; and an emulation of the split path (the
plain version's softmax state on each live split's key range, merged by the
merge kernel's rule) against the JAX Pallas kernel in interpret mode, within
2e-5 (fp32, reduction order only), on the sweep of
test_torch_paged_attention.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import chunked_prefill_attention as jax_attention
from repro_torch.kernels.paged_attention import (chunked_prefill_partials,
                                                 chunked_prefill_reference, merge_partials)
from repro_torch.kernels.paged_attention import kernel as pk
from repro_torch.kernels.paged_attention.kernel import (_plan, live_splits, split_ranges,
                                                        visible_keys)

F32, BF16 = torch.float32, torch.bfloat16
MIXTRAL = dict(H=32, Hkv=8, D=128, ps=16, maxp=32)   # the serving runs' pool: 512 positions


@pytest.mark.parametrize("C,q_dtype,kv_dtype,path,grid", [
    (1, BF16, BF16, "split", (16, 8, 4)),      # the decode sweep: 4 slots
    (1, F32, F32, "split", (16, 8, 4)),
    (1, F32, BF16, "split", (16, 8, 4)),
    (2, BF16, BF16, "split", (16, 8, 4)),      # verify widths 1 + k: 8..20 folded rows
    (3, BF16, BF16, "split", (16, 8, 4)),
    (4, F32, BF16, "split", (16, 8, 4)),
    (5, BF16, BF16, "split", (16, 8, 4)),
    (8, F32, F32, "split", (16, 8, 4)),        # 32 rows: the split kernel's most
    (9, BF16, BF16, "mma", (1, 8, 4)),
    (9, F32, F32, "tiled", (2, 8, 4)),
    (9, BF16, F32, "tiled", (2, 8, 4)),
])
def test_plan_at_engine_decode_shapes(C, q_dtype, kv_dtype, path, grid):
    """Up to SPLIT_MAX_ROWS = 32 folded rows (C * G, G = 4) take the split
    kernel in any dtype: 4 rows x 8 KV heads give 32 (row, head) pairs, so
    the 512 positions are cut into all 16 tiles of 32 (4 blocks a SM would
    ask for 17). Above it bf16 takes the tensor cores, anything else the
    fp32 tiles."""
    plan = _plan(4, C, MIXTRAL["H"], MIXTRAL["Hkv"], MIXTRAL["D"], MIXTRAL["ps"],
                 MIXTRAL["maxp"], q_dtype, kv_dtype, 132)
    assert (plan.path, plan.grid) == (path, grid)
    assert plan.splits == (grid[0] if path == "split" else 1)


@pytest.mark.parametrize("q_dtype,kv_dtype,path,grid", [
    (BF16, BF16, "mma", (8, 8, 2)),            # 512 folded rows: 8 tiles of 64
    (F32, F32, "tiled", (16, 8, 2)),           # 16 tiles of 32
    (F32, BF16, "tiled", (16, 8, 2)),
    (BF16, F32, "tiled", (16, 8, 2)),
])
def test_plan_at_prefill_pack(q_dtype, kv_dtype, path, grid):
    """The engine's prefill pack, 2 rows of 128 tokens: the tensor cores
    only for bf16 q and pool (an fp32 case stays IEEE fp32)."""
    plan = _plan(2, 128, 32, 8, 128, 16, 32, q_dtype, kv_dtype, 132)
    assert (plan.path, plan.splits, plan.grid) == (path, 1, grid)


@pytest.mark.parametrize("n_sm", [132, 114, 78, 16])
@pytest.mark.parametrize("B,maxp,ps", [(4, 32, 16), (4, 256, 16), (1, 8, 4), (64, 16, 16)])
@pytest.mark.parametrize("D", [16, 128])
def test_plan_split_count(n_sm, B, maxp, ps, D):
    """The split count aims at SPLIT_BLOCKS_PER_SM blocks a SM over the
    B * Hkv (row, KV head) pairs, never cuts a tile (at most one split a
    tile of the capacity), and at least one split."""
    Hkv = 8 if D == 128 else 2
    plan = _plan(B, 1, 4 * Hkv, Hkv, D, ps, maxp, BF16, BF16, n_sm)
    units = -(-maxp * ps // pk.SPLIT_KEYS)
    want = min(units, max(1, -(-pk.SPLIT_BLOCKS_PER_SM * n_sm // (B * Hkv))))
    assert plan.path == "split" and plan.splits == want and plan.grid == (want, Hkv, B)
    assert 1 <= plan.splits <= units


def test_plan_long_context_decode():
    """chip_smoke.py's long-context decode: 4 slots over 256 pages of 16
    (4096 positions, 128 tiles) take 17 splits of 7-8 tiles, 544 blocks."""
    plan = _plan(4, 1, 32, 8, 128, 16, 256, BF16, BF16, 132)
    assert (plan.path, plan.splits, plan.grid) == ("split", 17, (17, 8, 4))
    sizes = {b - a for a, b in split_ranges(256 * 16, 17)}
    assert sizes == {7 * pk.SPLIT_KEYS, 8 * pk.SPLIT_KEYS}


@pytest.mark.parametrize("D,dtype,msg", [(64, BF16, "head_dim"), (128, torch.float16, "dtypes")])
def test_plan_rejects_what_no_kernel_takes(D, dtype, msg):
    with pytest.raises(ValueError, match=msg):
        _plan(2, 128, 32, 8, D, 16, 32, dtype, dtype, 132)
    with pytest.raises(ValueError, match="grid"):
        _plan(70000, 1, 32, 8, 128, 16, 32, BF16, BF16, 132)


@pytest.mark.parametrize("cap,splits", [(512, 16), (512, 9), (4096, 17), (32, 1), (128, 3),
                                        (100, 4), (16, 1)])
def test_split_ranges_hold_every_visible_key_once(cap, splits):
    """The ranges tile [0, cap) in whole SPLIT_KEYS tiles; for rows with
    mid-page starts, ragged and zero lengths, padding (length < start + C),
    windows and chunks past the capacity, every visible key lies in exactly
    one live split and a dead split holds none."""
    ranges = split_ranges(cap, splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == cap
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(k0 % pk.SPLIT_KEYS == 0 and k0 < k1 for k0, k1 in ranges)
    rng = np.random.default_rng(cap + splits)
    rows = [(0, 0, 1, 0), (cap, cap - 1, 1, 0), (5, 0, 8, 0), (cap, cap - 8, 8, 3)]
    rows += [(int(s + n), int(s), int(c), int(w)) for s, n, c, w in zip(
        rng.integers(0, cap, 20), rng.integers(0, 9, 20), rng.integers(1, 9, 20),
        rng.choice([0, 1, 5, 40], 20))]
    for length, start, C, window in rows:
        lo, hi = visible_keys(length, start, C, cap, window)
        s_lo, s_hi = live_splits(lo, hi, cap, splits)
        live = ranges[s_lo:s_hi]
        visible = set()
        for c in range(C):                 # the keys some query of the chunk sees
            q_pos = start + c
            first = max(q_pos - window + 1, 0) if window else 0
            visible |= set(range(first, min(length, q_pos + 1, cap)))
        assert visible <= set(range(lo, hi))
        for key in visible:
            assert sum(k0 <= key < k1 for k0, k1 in live) == 1
        for k0, k1 in ranges:
            if (k0, k1) not in live:
                assert not visible & set(range(k0, k1))


@pytest.mark.parametrize("cap", [16, 32, 100, 128, 512])
def test_live_splits_are_the_ranges_that_meet_the_visible_keys(cap):
    """The closed form the kernels use for the live splits equals the
    splits whose ranges meet [lo, hi), for every split count the plan can
    give and every key range."""
    units = -(-cap // pk.SPLIT_KEYS)
    for splits in range(1, units + 1):
        ranges = split_ranges(cap, splits)
        for lo in range(0, cap + 1, 3):
            for hi in range(0, cap + 1, 5):
                s_lo, s_hi = live_splits(lo, hi, cap, splits)
                want = [s for s, (k0, k1) in enumerate(ranges) if lo < hi and k0 < hi and k1 > lo]
                assert list(range(s_lo, s_hi)) == want, (splits, lo, hi)


def _case(seed, *, ps, B=4, C=8, H=4, Hkv=2, D=16, maxp=8, starts=(5, 0, 13, 0),
          nvalid=(8, 6, 3, 0)):
    """test_torch_paged_attention.py's sweep: mid-page starts, ragged
    lengths, padding rows (row 2 holds 3 live tokens of its chunk of 8) and
    an idle row 3 (length 0)."""
    rng = np.random.default_rng(seed)
    P = B * maxp + 1
    kp = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    pt = np.array([[1 + b * maxp + i for i in range(maxp)] for b in range(B)], np.int32)
    starts = np.asarray(starts[:B], np.int32)
    lengths = (starts + np.asarray(nvalid[:B], np.int32)).astype(np.int32)
    q = rng.standard_normal((B, C, H, D)).astype(np.float32)
    qpos = (starts[:, None] + np.arange(C)[None]).astype(np.int32)
    return q, kp, vp, pt, lengths, qpos


def _split_emulation(q, kp, vp, pt, lengths, qpos, splits, **kw):
    """Each row's output from the plain version's softmax state on each of
    its live splits' key ranges, merged in split order."""
    t = [torch.from_numpy(a) for a in (q, kp, vp, pt, lengths, qpos)]
    B, C = q.shape[:2]
    cap = pt.shape[1] * kp.shape[1]
    out = []
    for b in range(B):
        lo, hi = visible_keys(int(lengths[b]), int(qpos[b, 0]), C, cap, kw["window"])
        s_lo, s_hi = live_splits(lo, hi, cap, splits)
        row = [x if i in (1, 2) else x[b:b + 1] for i, x in enumerate(t)]   # the pool whole
        parts = [chunked_prefill_partials(*row, key_range=r, **kw)
                 for r in split_ranges(cap, splits)[s_lo:s_hi]]
        if parts:
            out.append(merge_partials(parts))
        else:
            out.append(torch.zeros((1,) + q.shape[1:]))
    return torch.cat(out).numpy()


@pytest.mark.parametrize("ps,window,softcap", [(4, 0, 0.0), (4, 5, 0.0), (8, 0, 2.0),
                                               (16, 3, 2.0), (8, 9, 0.0)])
@pytest.mark.parametrize("splits", ["plan", "uneven"])
def test_split_emulation_matches_pallas(ps, window, softcap, splits):
    """The split path's arithmetic against chunked_prefill_pallas in
    interpret mode at every position, padding rows and the idle row
    included: the plan's split count over a pool row of 32-128 positions
    (every tile of 32 its own split), and 3 splits of 1 and 2 tiles over
    128."""
    maxp = 8 if splits == "plan" else 128 // ps
    q, kp, vp, pt, lengths, qpos = _case(ps + window, ps=ps, maxp=maxp)
    B, C, H, D = q.shape
    cap = maxp * ps
    if splits == "plan":
        splits = _plan(B, C, H, kp.shape[2], D, ps, maxp, F32, F32, 132).splits
        assert splits == cap // pk.SPLIT_KEYS
    else:
        splits = 3
    kw = dict(scale=D ** -0.5, softcap=softcap, window=window)
    emu = _split_emulation(q, kp, vp, pt, lengths, qpos, splits, **kw)
    jq = [jnp.asarray(a) for a in (q, kp, vp, pt, lengths, qpos)]
    pal = np.asarray(jax_attention(*jq, backend="pallas", interpret=True, **kw))
    np.testing.assert_allclose(emu, pal, atol=2e-5, rtol=0)
    assert np.isfinite(emu).all() and not emu[3].any(), "a length-0 row must give zeros"
    whole = chunked_prefill_reference(*map(torch.from_numpy, (q, kp, vp, pt, lengths, qpos)),
                                      **kw).numpy()
    np.testing.assert_allclose(emu, whole, atol=2e-5, rtol=0)
