"""The flash attention gradient of the port on the CPU: the backward kernel's
plain version (``mha_reference_bwd``, the formulas the CUDA kernel runs)
against autograd through the forward's plain version, the row logsumexp,
rows with no visible key, the autograd function's plumbing with both
launches stubbed by their plain versions, and the guards of the kernels
that have no backward yet. The CUDA kernels themselves are held against
the plain versions in test_torch_cuda.py."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (FlashAttention, flash_attention,
                                                 mha_reference, mha_reference_bwd,
                                                 mha_reference_lse)
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.kernel import (BWD_KEYS, BWD_MMA_TILE, BWD_ROWS,
                                                        MMA_KEYS, bwd_plan, bwd_query_tiles,
                                                        dkdv_block, key_tiles)
from repro_torch.kernels.grad_guard import refuse_grad

TOL = 1e-5     # fp32: the two differ in the order of their sums only
CASES = [
    # B, Sq, Skv, H, Hkv, D, causal, window, softcap, q_offset
    (2, 24, 24, 4, 4, 16, True, 0, 0.0, 0),          # MHA, causal
    (1, 20, 20, 4, 1, 16, True, 0, 0.0, 0),          # G = 4
    (1, 18, 18, 8, 1, 16, True, 0, 0.0, 0),          # G = 8 (MQA)
    (2, 30, 30, 8, 2, 64, False, 0, 0.0, 0),         # encoder: not causal
    (1, 9, 40, 4, 4, 64, False, 0, 0.0, 0),          # cross attention: Sq != Skv
    (1, 32, 32, 4, 2, 16, True, 6, 0.0, 0),          # sliding window
    (1, 26, 26, 4, 2, 128, True, 0, 50.0, 0),        # softcap (gemma2)
    (1, 26, 26, 4, 2, 16, True, 5, 30.0, 0),         # window + softcap
    (2, 12, 40, 4, 2, 96, True, 0, 0.0, 28),         # chunked prefill: q_offset
    (1, 10, 50, 8, 1, 128, True, 8, 20.0, 33),       # all of them at once
]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny tensors: one intra-op thread, so the suite's parallel workers do
    not oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, Sq, Skv, H, Hkv, D):
    r = np.random.default_rng(seed)
    return [torch.from_numpy(r.standard_normal(s).astype(np.float32))
            for s in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D), (B, Sq, H, D))]


def _autograd(q, k, v, do, **kw):
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    out = mha_reference(q, k, v, **kw)
    return out.detach(), torch.autograd.grad(out, (q, k, v), do)


@pytest.mark.parametrize("case", CASES)
def test_plain_bwd_matches_autograd(case):
    B, Sq, Skv, H, Hkv, D, causal, window, softcap, qoff = case
    q, k, v, do = _inputs(sum(case[:6]), B, Sq, Skv, H, Hkv, D)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=qoff)
    out, want = _autograd(q, k, v, do, **kw)
    lse = mha_reference_lse(q, k, **kw)
    got = mha_reference_bwd(q, k, v, out, do, lse, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=TOL, rtol=TOL)


def test_lse_is_the_rows_logsumexp():
    """lse = log sum_j exp(s_ij) over the visible keys, which makes
    P = exp(S - lse) the forward's softmax: P V is the forward's output."""
    q, k, v, _ = _inputs(1, 2, 20, 30, 4, 2, 16)
    kw = dict(causal=True, window=7, softcap=25.0, q_offset=10)
    lse = mha_reference_lse(q, k, **kw)
    assert lse.shape == (2, 4, 20) and lse.dtype == torch.float32
    kf = k.repeat_interleave(2, dim=2)
    s = 25.0 * torch.tanh(torch.einsum("bqhd,bkhd->bhqk", q, kf) * 16 ** -0.5 / 25.0)
    qi, kj = torch.arange(20)[:, None] + 10, torch.arange(30)[None]
    s = torch.where((kj <= qi) & (kj > qi - 7), s, torch.tensor(float("-inf")))
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.repeat_interleave(2, dim=2))
    np.testing.assert_allclose(out.numpy(), mha_reference(q, k, v, **kw).numpy(), atol=TOL)


def test_rows_with_no_visible_key_get_zero_gradients():
    """A window shorter than the gap q_offset leaves to Skv gives query rows
    that see no key: lse -inf, output 0, and zero gradients (not NaN), in
    the plain backward and in autograd alike."""
    B, Sq, Skv, H, Hkv, D = 1, 12, 8, 4, 2, 16
    q, k, v, do = _inputs(7, B, Sq, Skv, H, Hkv, D)
    kw = dict(causal=True, window=4, q_offset=6)       # rows 5.. sit at 11..: see nothing
    lse = mha_reference_lse(q, k, **kw)
    dead = torch.isinf(lse)
    assert dead.any() and not dead.all()
    out, want = _autograd(q, k, v, do, **kw)
    got = mha_reference_bwd(q, k, v, out, do, lse, **kw)
    dead_rows = dead[0, 0]                               # the same rows in every head
    assert (out[:, dead_rows] == 0).all()
    for g, w in zip(got, want):
        assert torch.isfinite(g).all() and torch.isfinite(w).all()
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=TOL, rtol=TOL)
    assert (got[0][:, dead_rows] == 0).all()
    # a key no live row sees gets zero dk / dv
    seen = torch.zeros(Skv, dtype=torch.bool)
    for i in torch.nonzero(~dead_rows).flatten().tolist():
        pos = i + 6
        seen[max(0, pos - 3):min(Skv, pos + 1)] = True
    assert (got[1][:, ~seen] == 0).all() and (got[2][:, ~seen] == 0).all()


@pytest.fixture
def stubbed(monkeypatch):
    """The forward and backward launches replaced by their plain versions
    (run on CPU tensors), each call recorded."""
    calls = {"fwd": [], "bwd": []}

    def fwd(q, k, v, *, causal, window=0, softcap=0.0, q_offset=0, scale, lse=False):
        kw = dict(causal=causal, window=window, softcap=softcap, q_offset=q_offset, scale=scale)
        calls["fwd"].append(dict(kw, lse=lse))
        out = mha_reference(q, k, v, **kw)
        return (out, mha_reference_lse(q, k, **kw)) if lse else out

    def bwd(q, k, v, out, dout, lse, *, need_dq=True, need_dkv=True, **kw):
        calls["bwd"].append(dict(kw, need_dq=need_dq, need_dkv=need_dkv, out=out, lse=lse))
        dq, dk, dv = mha_reference_bwd(q, k, v, out, dout, lse, **kw)
        return dq if need_dq else None, dk if need_dkv else None, dv if need_dkv else None

    monkeypatch.setattr(fops, "flash_attention_cuda", fwd)
    monkeypatch.setattr(fops, "flash_attention_bwd_cuda", bwd)
    return calls


@pytest.mark.parametrize("need", ["qkv", "q", "kv", "k"])
def test_function_plumbing(stubbed, need):
    """FlashAttention asks the forward for its lse, hands the backward the
    saved q, k, v, out and lse with the call's options, launches only the
    kernels the inputs need, and returns the GQA-summed dk / dv in the kv
    heads' shape: the gradients equal autograd through the plain version."""
    B, Sq, Skv, H, Hkv, D = 2, 14, 14, 8, 2, 16
    q, k, v, do = _inputs(3, B, Sq, Skv, H, Hkv, D)
    kw = dict(causal=True, window=5, softcap=20.0, q_offset=0, scale=0.3)
    leaves = [t.clone().requires_grad_(n in need) for t, n in zip((q, k, v), "qkv")]
    out = FlashAttention.apply(*leaves, *kw.values())
    assert stubbed["fwd"] == [dict(kw, lse=True)]
    wanted = [t for t in leaves if t.requires_grad]
    grads = torch.autograd.grad(out, wanted, do)
    (call,) = stubbed["bwd"]
    assert call["need_dq"] == ("q" in need) and call["need_dkv"] == ("k" in need or "v" in need)
    assert torch.equal(call["out"], out.detach())
    assert torch.equal(call["lse"], mha_reference_lse(q, k, **kw))
    assert {k_: call[k_] for k_ in kw} == kw
    _, want = _autograd(q, k, v, do, **kw)
    want = [w for w, t in zip(want, leaves) if t.requires_grad]
    for g, w, t in zip(grads, want, wanted):
        assert g.shape == t.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=TOL, rtol=TOL)


def test_op_dispatch(stubbed):
    """On CPU tensors the op is the plain version under autograd (no
    launch); the autograd function is what a CUDA tensor that needs a
    gradient reaches."""
    q, k, v, do = _inputs(4, 1, 10, 10, 4, 2, 16)
    qg = q.clone().requires_grad_()
    out = flash_attention(qg, k, v, causal=True)
    (g,) = torch.autograd.grad(out, qg, do)
    assert stubbed["fwd"] == [] and stubbed["bwd"] == []
    _, want = _autograd(q, k, v, do, causal=True)
    np.testing.assert_allclose(g.numpy(), want[0].numpy(), atol=TOL)


def test_bwd_plan():
    """bf16 -> mma, each GQA group cut into the fewest subsets that give the
    dK / dV grid 2 blocks a SM (a reduce grid only when it is cut); fp32 ->
    tiled as before; head dims, head counts and grids the kernels do not
    take raise."""
    cdiv = lambda a, b: -(-a // b)                                # noqa: E731
    T = BWD_MMA_TILE
    p = bwd_plan(4, 512, 512, 16, 2, 128, torch.bfloat16)         # qwen2.5-3b's training shape
    assert p["path"] == "mma" and p["splits"] == 8
    assert p["grids"] == {"delta": (4 * 512 * 16 // 8, 1, 1), "dkdv": (2 * 8, 4, 512 // T),
                          "reduce": (cdiv(2 * 4 * 512 * 2 * 128 // 4, 256), 1, 1),
                          "dq": (16, 4, 512 // T)}
    assert np.prod(p["grids"]["dkdv"]) == 512 >= 2 * 132
    p = bwd_plan(4, 512, 512, 32, 8, 128, torch.bfloat16)         # mixtral: 256 blocks, cut in 2
    assert p["splits"] == 2 and p["grids"]["dkdv"] == (16, 4, 8)
    for args in ((2, 1024, 1024, 16, 16, 64), (4, 512, 512, 32, 16, 128)):   # seamless, gemma2
        p = bwd_plan(*args, torch.bfloat16)
        assert p["splits"] == 1 and "reduce" not in p["grids"]
    assert bwd_plan(4, 512, 512, 16, 2, 128, torch.bfloat16, n_sm=32)["splits"] == 1
    assert bwd_plan(1, 40, 40, 8, 1, 64, torch.bfloat16)["splits"] == 8   # none suffices: all G
    p = bwd_plan(1, 9, 130, 4, 4, 64, torch.bfloat16)
    assert p["grids"]["dkdv"] == (4, 1, cdiv(130, T)) and p["grids"]["dq"] == (4, 1, 1)
    p = bwd_plan(4, 512, 512, 16, 2, 128, torch.float32)
    assert p["path"] == "tiled" and p["splits"] == 1
    assert p["grids"] == {"delta": (4 * 512 * 16 // 8, 1, 1), "dkdv": (512 // BWD_KEYS, 2, 4),
                          "dq": (512 // BWD_ROWS, 16, 4)}
    p = bwd_plan(2, 9, 130, 4, 4, 64, torch.float32)
    assert p["grids"]["dkdv"] == (-(-130 // BWD_KEYS), 4, 2) and p["grids"]["dq"] == (1, 4, 2)
    for dtype in (torch.float32, torch.bfloat16):
        for bad in (dict(D=48), dict(H=6, Hkv=4), dict(B=70000)):
            args = {**dict(B=1, Sq=8, Skv=8, H=4, Hkv=2, D=16, dtype=dtype), **bad}
            with pytest.raises(ValueError):
                bwd_plan(**args)


# the chip check's backward edge cases (B, Sq, Skv, H, Hkv, causal, window,
# q_offset; chip_smoke.FLASH_BWD_EDGE), two of its full shapes, and rows
# that see no key
PARTITION_CASES = [(2, 64, 64, 4, 1, True, 0, 0), (1, 80, 80, 4, 2, True, 16, 0),
                   (2, 32, 96, 2, 2, True, 0, 64), (1, 50, 70, 4, 2, False, 0, 0),
                   (1, 40, 40, 8, 1, True, 8, 20), (2, 9, 130, 4, 4, False, 0, 0),
                   (1, 70, 70, 8, 2, True, 0, 0), (1, 33, 100, 8, 1, True, 0, 67),
                   (4, 512, 512, 16, 2, True, 0, 0), (4, 512, 512, 32, 16, True, 128, 0),
                   (1, 33, 40, 8, 2, True, 4, 30)]


@pytest.mark.parametrize("n_sm", [1, 132])
@pytest.mark.parametrize("case", PARTITION_CASES)
def test_mma_partition_gives_each_visible_triple_to_one_block(case, n_sm):
    """A Python mirror of the mma kernels' partition: each dK / dV block
    (a key tile, a kv head, a batch row, a subset of the GQA group) walks
    ``bwd_query_tiles`` for each of its query heads, each dQ block (a query
    tile of one head, tiles counted from the last) walks ``key_tiles``.
    Against a brute-force mask, every visible (batch row, query head,
    query, key) falls in exactly one block of each kernel, whatever the
    split (n_sm 1: none; 132: the H100's)."""
    B, Sq, Skv, H, Hkv, causal, window, qoff = case
    G, T = H // Hkv, BWD_MMA_TILE
    assert T == MMA_KEYS          # the dQ kernel walks the forward's key tiles
    plan = bwd_plan(B, Sq, Skv, H, Hkv, 64, torch.bfloat16, n_sm)
    qpos, kpos = np.arange(Sq)[:, None] + qoff, np.arange(Skv)[None]
    vis = np.ones((Sq, Skv), bool)
    if causal:
        vis &= kpos <= qpos
    if window:
        vis &= kpos > qpos - window
    seen = np.zeros((B, H, Sq, Skv), np.int8)
    gx, gy, gz = plan["grids"]["dkdv"]
    assert gx == Hkv * plan["splits"] and G % plan["splits"] == 0
    for x in range(gx):
        for y in range(gy):
            for z in range(gz):
                b, hk, k0, heads = dkdv_block(x, y, z, plan["splits"], H, Hkv)
                k1 = min(k0 + T, Skv)
                qt_lo, n = bwd_query_tiles(k0, k1 - 1, Sq, causal, window, qoff)
                r0, r1 = qt_lo * T, min((qt_lo + n) * T, Sq)
                for h in heads:
                    assert h // G == hk
                    seen[b, h, r0:r1, k0:k1] += vis[r0:r1, k0:k1]
    assert np.array_equal(seen, np.broadcast_to(vis, seen.shape))
    seen[:] = 0
    gx, gy, gz = plan["grids"]["dq"]
    for h in range(gx):
        for b in range(gy):
            for z in range(gz):
                q0 = (gz - 1 - z) * T
                q1 = min(q0 + T, Sq)
                t0, tiles = key_tiles(q0 + qoff, q1 - 1 + qoff, Skv, causal, window)
                k0, k1 = t0 * T, min((t0 + tiles) * T, Skv)
                seen[b, h, q0:q1, k0:k1] += vis[q0:q1, k0:k1]
    assert np.array_equal(seen, np.broadcast_to(vis, seen.shape))


def test_grad_guard():
    """``refuse_grad`` raises only when grad mode is on and an input needs a
    gradient; None inputs are skipped."""
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="ssd_scan: the CUDA kernel has no backward yet"):
        refuse_grad("ssd_scan", None, x)
    refuse_grad("ssd_scan", torch.zeros(3), None)
    with torch.no_grad():
        refuse_grad("ssd_scan", x)
    with torch.inference_mode():
        refuse_grad("ssd_scan", torch.zeros(3))


def test_guarded_ops_stay_differentiable_on_cpu():
    """The ops whose kernels have no backward keep their plain, differentiable
    path for CPU tensors: gradients reach every input that asks."""
    from repro_torch.kernels.moe_gmm import gmm
    from repro_torch.kernels.paged_attention import chunked_prefill_attention, paged_attention
    from repro_torch.kernels.quant_matmul import quantize_int8, w8a16_matmul
    from repro_torch.kernels.ssd_scan import ssd_chunked
    r = np.random.default_rng(0)

    def t(*shape, grad=True):
        return torch.from_numpy(r.standard_normal(shape).astype(np.float32)).requires_grad_(grad)

    x, dt, A, Bm, Cm = t(1, 8, 2, 4), t(1, 8, 2).abs(), -t(2).abs(), t(1, 8, 1, 4), t(1, 8, 1, 4)
    y, _ = ssd_chunked(x, dt, A, Bm, Cm, 4)
    assert all(g is not None for g in torch.autograd.grad(y.sum(), (x, Bm, Cm)))
    xs, w = t(6, 4), t(2, 4, 3)
    out = gmm(xs, w, torch.tensor([2, 4]))
    assert all(g is not None for g in torch.autograd.grad(out.sum(), (xs, w)))
    q, kp, vp = t(1, 2, 4, 16), t(3, 4, 2, 16), t(3, 4, 2, 16)
    pt, lengths = torch.tensor([[1, 2]], dtype=torch.int32), torch.tensor([6], dtype=torch.int32)
    o = chunked_prefill_attention(q, kp, vp, pt, lengths, torch.tensor([[4, 5]]))
    assert all(g is not None for g in torch.autograd.grad(o.sum(), (q, kp, vp)))
    o = paged_attention(q[:, 0], kp, vp, pt, lengths)
    assert all(g is not None for g in torch.autograd.grad(o.sum(), (q, kp, vp)))
    wq, scale = quantize_int8(t(4, 3, grad=False))
    xm = t(2, 4)
    (g,) = torch.autograd.grad(w8a16_matmul(xm, wq, scale).sum(), xm)
    assert g is not None
