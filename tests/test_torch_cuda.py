"""The port's CUDA kernels against their plain PyTorch versions, and the
engine on the card against the engine on the CPU. Every test here needs a
card (marker ``cuda``) and skips without one; the file imports only torch
and numpy, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

(``-k attention`` for the chunked attention kernels alone.)
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import tiny_config
from repro_torch.core import EngineConfig, InferenceEngine, Request
from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_cuda,
                                                 mha_reference)
from repro_torch.kernels.flash_attention.kernel import plan_for as flash_plan_for
from repro_torch.kernels.moe_gmm import gmm, gmm_reference, gmm_tiles_cuda, tile_layout
from repro_torch.kernels.moe_gmm.kernel import block_m_for
from repro_torch.kernels.moe_gmm.kernel import plan_for as gmm_plan_for
from repro_torch.kernels.paged_attention import (chunked_prefill_attention,
                                                 chunked_prefill_cuda,
                                                 chunked_prefill_reference, paged_attention,
                                                 paged_attention_cuda,
                                                 paged_attention_reference)
from repro_torch.kernels.paged_attention.kernel import SPLIT_MAX_ROWS, _sm_count, _split_plan
from repro_torch.kernels.paged_attention.kernel import plan_for as attn_plan_for
from repro_torch.kernels.quant_matmul import (w8a16_matmul, w8a16_matmul_cuda,
                                              w8a16_matmul_reference)
from repro_torch.kernels.quant_matmul.kernel import is_k_major, plan_for
from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_reference, ssd_scan, ssd_scan_cuda
from repro_torch.kernels.ssd_scan.kernel import plan_for as ssd_scan_plan_for
from repro_torch.models import RunCtx, build_model
from repro_torch.models.params import map_tree
from repro_torch.quant import quantize_leaf, quantize_params_int8

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run with `pytest -m cuda` on the card")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False         # the SSM layers' depthwise conv
    return torch.device("cuda")


def _attn_case(seed, *, ps, D, B=4, C=8, H=4, Hkv=2, maxp=8):
    """Starts mid-page, ragged lengths, and an idle row 3 (length 0)."""
    rng = np.random.default_rng(seed)
    P = B * maxp + 1
    kp = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    pt = np.array([[1 + b * maxp + i for i in range(maxp)] for b in range(B)], np.int32)
    starts = np.asarray([5, 0, 13, 0], np.int32)
    lengths = (starts + np.asarray([8, 6, 3, 0], np.int32)).astype(np.int32)
    q = rng.standard_normal((B, C, H, D)).astype(np.float32)
    qpos = (starts[:, None] + np.arange(C)[None]).astype(np.int32)
    return q, kp, vp, pt, lengths, qpos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ps,D,window,softcap", [(4, 16, 0, 0.0), (8, 16, 5, 0.0),
                                                 (16, 128, 3, 2.0), (4, 128, 0, 0.0),
                                                 (16, 64, 0, 0.0), (8, 96, 5, 2.0)])
def test_attention_kernel_matches_plain(cuda, dtype, ps, D, window, softcap):
    q, kp, vp, pt, lengths, qpos = _attn_case(ps, ps=ps, D=D)
    args = [torch.from_numpy(a).to(cuda) for a in (q, kp, vp, pt, lengths, qpos)]
    for i in range(3):
        args[i] = args[i].to(dtype)
    kw = dict(scale=D ** -0.5, softcap=softcap, window=window)
    n0 = chunked_prefill_cuda.launches
    out = chunked_prefill_attention(*args, **kw)
    torch.cuda.synchronize()
    assert chunked_prefill_cuda.launches == n0 + 1
    plain = chunked_prefill_reference(*args, **kw)
    # fp32: reduction order only; bf16: one rounding of outputs of size ~1
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), plain.float(), atol=tol, rtol=tol)
    assert not out[3].any(), "a length-0 row must give zeros"


# (C, G, q dtype, pool dtype, the path the plan names): <= 16 folded rows
# (C * G) split in any dtype (4 and 16 rows: two of the kernel's three row
# classes; paged decode at G = 32 takes the third); above, bf16 q and pool
# take the tensor cores, anything else the fp32 tiles
ATTN_PATH_CASES = [
    (1, 2, torch.float32, torch.float32, "split"),
    (8, 2, torch.bfloat16, torch.bfloat16, "split"),
    (4, 4, torch.float32, torch.bfloat16, "split"),
    (8, 4, torch.bfloat16, torch.bfloat16, "mma"),
    (24, 2, torch.bfloat16, torch.bfloat16, "mma"),
    (40, 4, torch.bfloat16, torch.bfloat16, "mma"),      # 160 rows: 3 tiles, the last ragged
    (24, 2, torch.float32, torch.float32, "tiled"),
    (24, 2, torch.bfloat16, torch.float32, "tiled"),
]


@pytest.mark.parametrize("ps,D,window,softcap", [(4, 16, 0, 0.0), (8, 16, 5, 0.0),
                                                 (16, 128, 3, 2.0), (8, 128, 0, 0.0),
                                                 (16, 64, 0, 0.0), (16, 96, 3, 0.0)])
@pytest.mark.parametrize("case", ATTN_PATH_CASES)
def test_attention_reaches_planned_path(cuda, case, ps, D, window, softcap):
    """Each call launches the kernel its plan names, within
    test_attention_kernel_matches_plain's tolerances of the plain version at
    every position (padding rows and the idle row included), and a second
    call gives the same bits (the split path merges its splits in a fixed
    order)."""
    C, G, q_dtype, kv_dtype, want = case
    q, kp, vp, pt, lengths, qpos = _attn_case(ps + C, ps=ps, D=D, C=C, H=2 * G, Hkv=2)
    args = [torch.from_numpy(a).to(cuda) for a in (q, kp, vp, pt, lengths, qpos)]
    args[0] = args[0].to(q_dtype)
    args[1], args[2] = args[1].to(kv_dtype), args[2].to(kv_dtype)
    kw = dict(scale=D ** -0.5, softcap=softcap, window=window)
    assert attn_plan_for(args[0], args[1], args[3]).path == want
    before = dict(chunked_prefill_cuda.launches_by_path)
    a = chunked_prefill_attention(*args, **kw)
    b = chunked_prefill_attention(*args, **kw)
    torch.cuda.synchronize()
    after = chunked_prefill_cuda.launches_by_path
    assert {p: after[p] - before[p] for p in after} == {p: 2 * (p == want) for p in after}
    assert torch.equal(a, b) and a.dtype == q_dtype
    tol = 1e-5 if q_dtype == kv_dtype == torch.float32 else 1e-2
    plain = chunked_prefill_reference(*args, **kw)
    torch.testing.assert_close(a.float(), plain.float(), atol=tol, rtol=tol)
    assert not a[3].any(), "a length-0 row must give zeros"


# (C, rank heads Hl, config heads H / kv heads Hkv, dtype, path): a rank's
# heads over the whole pool (the kv_seq layout) on each of the three paths
FOLD_CASES = [
    (1, 4, 16, 2, torch.bfloat16, "split"),      # qwen2.5-3b's decode sweep at tensor 4
    (3, 4, 16, 2, torch.float32, "split"),       # its verify width 3: 12 folded rows
    (24, 4, 16, 2, torch.bfloat16, "mma"),       # a pack: 96 rows of one kv head
    (24, 4, 16, 2, torch.float32, "tiled"),
    (8, 1, 4, 2, torch.float32, "split"),        # tiny qwen2.5 at tensor 4: one head
    (24, 4, 8, 4, torch.bfloat16, "mma"),        # two whole groups of 2
]


@pytest.mark.parametrize("C,Hl,H,Hkv,dtype,want", FOLD_CASES)
def test_attention_q_head0_matches_plain_on_every_path(cuda, C, Hl, H, Hkv, dtype, want):
    """Chunked attention and paged decode on a rank's heads [q_head0,
    q_head0 + Hl) of H over the whole pool of Hkv heads: the planned path,
    each rank's heads within test_attention_kernel_matches_plain's
    tolerances of the plain twin, bit-equal repeats."""
    q, kp, vp, pt, lengths, qpos = _attn_case(C + Hl, ps=8, D=128, C=C, H=Hl, Hkv=Hkv)
    args = [torch.from_numpy(a).to(cuda) for a in (q, kp, vp, pt, lengths, qpos)]
    for i in range(3):
        args[i] = args[i].to(dtype)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for h0 in range(0, H, Hl):
        kw = dict(scale=128 ** -0.5, q_head0=h0, group=H // Hkv)
        assert attn_plan_for(args[0], args[1], args[3], h0, H // Hkv).path == want
        before = dict(chunked_prefill_cuda.launches_by_path)
        a = chunked_prefill_attention(*args, **kw)
        assert chunked_prefill_cuda.launches_by_path[want] == before[want] + 1
        assert torch.equal(a, chunked_prefill_attention(*args, **kw))
        torch.testing.assert_close(a.float(), chunked_prefill_reference(*args, **kw).float(),
                                   atol=tol, rtol=tol)
        if C == 1:
            d = paged_attention(args[0][:, 0], *args[1:5], **kw)
            torch.testing.assert_close(
                d.float(), paged_attention_reference(args[0][:, 0], *args[1:5], **kw).float(),
                atol=3e-2 if dtype == torch.bfloat16 else 2e-5, rtol=0)


@pytest.mark.parametrize("name,B,C,starts,nvalid,maxp,want", [
    ("decode", 4, 1, [131, 219, 299, 166], [1, 1, 1, 1], 32, "split"),
    ("decode C=4", 4, 4, [128, 216, 296, 163], [4, 4, 4, 4], 32, "split"),
    ("decode long", 4, 1, [4000, 4095, 3900, 4050], [1, 1, 1, 1], 256, "split"),
    ("prefill", 2, 128, [0, 128], [128, 100], 32, "mma"),
])
def test_attention_full_width_bit_equal_repeats(cuda, name, B, C, starts, nvalid, maxp, want):
    """chip_smoke.py's phase-2 shapes at Mixtral's width (32 query heads over
    8 KV heads of 128, pages of 16) in bf16: two calls give the same bits,
    within the phase's tolerance of the plain version (one rounding of
    outputs |o| < 4)."""
    g = torch.Generator(device=cuda).manual_seed(B * C + maxp)
    P = B * maxp + 1
    q = torch.randn((B, C, 32, 128), generator=g, device=cuda).bfloat16()
    kp, vp = (torch.randn((P, 16, 8, 128), generator=g, device=cuda).bfloat16()
              for _ in range(2))
    pt = (torch.randperm(P - 1, generator=g, device=cuda) + 1).reshape(B, maxp).int()
    st = torch.tensor(starts, dtype=torch.int32, device=cuda)
    lengths = st + torch.tensor(nvalid, dtype=torch.int32, device=cuda)
    qpos = st[:, None] + torch.arange(C, dtype=torch.int32, device=cuda)[None]
    plan = attn_plan_for(q, kp, pt)
    assert plan.path == want
    a = chunked_prefill_attention(q, kp, vp, pt, lengths, qpos)
    b = chunked_prefill_attention(q, kp, vp, pt, lengths, qpos)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    plain = chunked_prefill_reference(q, kp, vp, pt, lengths, qpos)
    assert float((a.float() - plain.float()).abs().max()) <= 2e-2


def test_attention_cuda_tensor_goes_to_kernel_or_raises(cuda, monkeypatch):
    """A call no kernel takes raises; none reaches the plain version."""
    from repro_torch.kernels.paged_attention import ops

    def plain(*args, **kw):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(ops, "chunked_prefill_reference", plain)
    q, kp, vp, pt, lengths, qpos = (torch.from_numpy(a).to(cuda)
                                    for a in _attn_case(1, ps=8, D=16))
    n0 = chunked_prefill_cuda.launches
    with pytest.raises(ValueError, match="head_dim"):
        chunked_prefill_attention(q[..., :8].contiguous(), kp[..., :8].contiguous(),
                                  vp[..., :8].contiguous(), pt, lengths, qpos)
    with pytest.raises(ValueError, match="dtype"):
        chunked_prefill_attention(q.half(), kp, vp, pt, lengths, qpos)
    flat = torch.empty(kp.numel() + 1, device=cuda)      # a pool 4 bytes off alignment
    kp_off = flat[1:].view(kp.shape).copy_(kp)
    with pytest.raises(ValueError, match="aligned"):
        chunked_prefill_attention(q, kp_off, vp, pt, lengths, qpos)
    assert chunked_prefill_cuda.launches == n0
    out = chunked_prefill_attention(q, kp, vp, pt, lengths, qpos)
    torch.cuda.synchronize()
    assert chunked_prefill_cuda.launches == n0 + 1 and torch.isfinite(out).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sizes,K,N", [([8, 8, 8, 8], 16, 24), ([0, 70, 0, 1], 40, 72),
                                       ([1, 1, 1, 1, 129], 64, 130)])
def test_gmm_kernel_matches_plain(cuda, dtype, sizes, K, N):
    rng = np.random.default_rng(len(sizes))
    gs = torch.tensor(sizes, device=cuda)
    M = int(gs.sum())
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(cuda, dtype)
    w = torch.from_numpy(rng.standard_normal((len(sizes), K, N)).astype(np.float32))
    w = w.to(cuda, dtype)
    n0 = gmm_tiles_cuda.launches
    out = gmm(x, w, gs)
    torch.cuda.synchronize()
    assert gmm_tiles_cuda.launches == n0 + 1
    # fp32: reduction order only; bf16: one rounding of outputs of size ~sqrt(K)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(out.float(), gmm_reference(x, w, gs).float(), atol=tol, rtol=tol)


# the cases of tests/test_torch_flash_attention.py at head_dims 16, 64, 96
# and 128, plus ragged edges (Sq, Skv of no tile multiple) and
# seamless-m4t's cross attention (Sq != Skv, not causal)
FLASH_CASES = [
    # B, Sq, Skv, H, Hkv, D, causal, window, softcap, q_offset
    (2, 64, 64, 4, 2, 16, True, 0, 0.0, 0),
    (2, 64, 64, 4, 1, 16, True, 0, 0.0, 0),
    (1, 96, 96, 4, 2, 128, True, 32, 0.0, 0),
    (1, 64, 64, 4, 4, 16, True, 0, 50.0, 0),
    (2, 32, 96, 2, 2, 16, True, 0, 0.0, 64),
    (2, 48, 48, 4, 2, 128, False, 0, 0.0, 0),
    (1, 80, 80, 4, 2, 16, True, 16, 30.0, 0),
    (1, 50, 70, 4, 2, 16, False, 0, 0.0, 0),
    (2, 97, 97, 8, 2, 128, True, 0, 0.0, 0),
    (2, 70, 70, 4, 4, 64, False, 0, 0.0, 0),        # encoder
    (2, 9, 130, 4, 4, 64, False, 0, 0.0, 0),        # cross attention, a chunk
    (3, 1, 77, 4, 4, 64, False, 0, 0.0, 0),         # cross attention, one token
    (1, 100, 100, 4, 4, 96, True, 0, 0.0, 0),
    (1, 45, 130, 4, 2, 96, True, 20, 30.0, 85),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, dtype, case):
    B, Sq, Skv, H, Hkv, D, causal, window, softcap, qoff = case
    rng = np.random.default_rng(Sq + Skv + D)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda, dtype)
               for s in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=qoff)
    n0 = flash_attention_cuda.launches
    path = "tiled" if dtype == torch.float32 else "mma"    # bf16 on the tensor cores
    p0 = flash_attention_cuda.launches_by_path[path]
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == n0 + 1 and out.dtype == dtype
    assert flash_attention_cuda.launches_by_path[path] == p0 + 1
    plain = mha_reference(q, k, v, **kw)
    # tests/test_kernels_flash.py's tolerances: fp32 2e-5, bf16 2e-2
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), plain.float(), atol=tol, rtol=tol)


# the mma path's edges: Sq * G and Skv of no 64 multiple, G = 8, a window
# narrower than a block's positions, non-causal with a window and an
# offset, a 1024-token causal prompt
FLASH_MMA_CASES = [
    # B, Sq, Skv, H, Hkv, D, causal, window, softcap, q_offset
    (2, 37, 53, 8, 2, 128, True, 0, 0.0, 16),
    (1, 71, 71, 16, 2, 128, True, 0, 0.0, 0),
    (2, 50, 50, 16, 2, 16, True, 5, 30.0, 0),
    (1, 45, 130, 4, 2, 128, False, 20, 0.0, 85),
    (1, 129, 129, 8, 1, 16, False, 0, 50.0, 0),
    (1, 1024, 1024, 8, 2, 128, True, 0, 0.0, 0),
    (1, 300, 300, 4, 2, 128, True, 128, 50.0, 0),
    (2, 1024, 1024, 16, 16, 64, False, 0, 0.0, 0),  # seamless-m4t's encoder
    (2, 128, 1024, 16, 16, 64, False, 0, 0.0, 0),   # its cross attention, a pack
    (4, 1, 1024, 16, 16, 64, False, 0, 0.0, 0),     # and a decode sweep
    (1, 300, 300, 32, 32, 96, True, 0, 0.0, 0),     # phi3's heads
    (2, 37, 53, 8, 2, 96, True, 0, 30.0, 16),
]


@pytest.mark.parametrize("case", FLASH_MMA_CASES)
def test_flash_mma_matches_plain(cuda, case):
    """bf16 on the mma path against the plain version, its plan's grid,
    launches_by_path, and bit-equal repeats."""
    B, Sq, Skv, H, Hkv, D, causal, window, softcap, qoff = case
    rng = np.random.default_rng(Sq + Skv + H)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda).bfloat16()
               for s in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=qoff)
    plan = flash_plan_for(q, k)
    assert (plan.path, plan.grid) == ("mma", (-(-Sq * (H // Hkv) // 64), Hkv, B))
    p0 = dict(flash_attention_cuda.launches_by_path)
    a = flash_attention(q, k, v, **kw)
    b = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches_by_path == dict(p0, mma=p0["mma"] + 2)
    assert torch.equal(a, b)
    plain = mha_reference(q, k, v, **kw)
    torch.testing.assert_close(a.float(), plain.float(), atol=2e-2, rtol=2e-2)


def test_flash_cuda_tensor_goes_to_kernel_or_raises(cuda, monkeypatch):
    """A call no kernel takes raises; none reaches the plain version."""
    from repro_torch.kernels.flash_attention import ops

    def plain(*args, **kw):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(ops, "mha_reference", plain)
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda).bfloat16()
               for s in ((1, 40, 4, 128), (1, 40, 2, 128), (1, 40, 2, 128)))
    n0 = flash_attention_cuda.launches
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q[..., :80], k[..., :80], v[..., :80])
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q.half(), k.half(), v.half())
    flat = torch.empty(k.numel() + 1, dtype=torch.bfloat16, device=cuda)  # 2 bytes off
    k_off = flat[1:].view(k.shape).copy_(k)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention(q, k_off, v)
    big = [torch.zeros((70000, 1, h, 128), dtype=torch.bfloat16, device=cuda) for h in (4, 2, 2)]
    with pytest.raises(ValueError, match="grid"):
        flash_attention(*big)
    assert flash_attention_cuda.launches == n0
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == n0 + 1 and torch.isfinite(out).all()


# the backward's cases: head dims 16 / 64 / 96 / 128, G 1 / 4 / 8, causal or
# not, window, softcap, q_offset, Sq != Skv, ragged tiles (tiled: 64 query
# rows and 32 keys; mma: 64 of each), rows with no visible key (window +
# q_offset), and a training shape; in bf16 (mma) the small grids cut each
# GQA group into subsets (fp32 partials and their reduce) where G > 1
FLASH_BWD_CASES = [
    # B, Sq, Skv, H, Hkv, D, causal, window, softcap, q_offset
    (2, 37, 53, 8, 2, 128, True, 0, 0.0, 16),
    (1, 70, 70, 4, 4, 16, True, 0, 0.0, 0),
    (2, 50, 50, 16, 2, 16, True, 5, 30.0, 0),
    (1, 45, 130, 4, 1, 64, False, 0, 0.0, 0),
    (2, 9, 130, 4, 4, 64, False, 0, 0.0, 0),
    (1, 100, 100, 8, 1, 96, True, 0, 0.0, 0),
    (1, 33, 40, 8, 2, 128, True, 4, 20.0, 30),       # rows 14.. see no key
    (1, 129, 129, 8, 8, 128, False, 0, 50.0, 0),
    (2, 512, 512, 16, 2, 128, True, 0, 0.0, 0),      # qwen2.5-3b's heads, 512 tokens
]


def _bwd_inputs(cuda, dtype, case):
    B, Sq, Skv, H, Hkv, D = case[:6]
    rng = np.random.default_rng(Sq + Skv + H + D)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda, dtype)
            for s in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D), (B, Sq, H, D))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_BWD_CASES)
def test_flash_bwd_kernel_matches_plain(cuda, dtype, case):
    """The forward's lse against the plain logsumexp; the backward kernel
    against mha_reference_bwd on the same (q, k, v, out, dO, lse), relative
    to the plain version's max |grad| (fp32 1e-4, bf16 5e-2), finite, zero
    on rows with no visible key, bit-equal on a repeat; one launch a call,
    counted under the path ``bwd_plan`` names (fp32 tiled, bf16 mma)."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     mha_reference_bwd, mha_reference_lse)
    from repro_torch.kernels.flash_attention.kernel import bwd_plan
    B, Sq, Skv, H, Hkv, D, causal, window, softcap, qoff = case
    path = bwd_plan(B, Sq, Skv, H, Hkv, D, dtype, _sm_count(cuda.index or 0))["path"]
    assert path == ("mma" if dtype == torch.bfloat16 else "tiled")
    q, k, v, do = _bwd_inputs(cuda, dtype, case)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=qoff, scale=D ** -0.5)
    out, lse = flash_attention_cuda(q, k, v, lse=True, **kw)
    plse = mha_reference_lse(q, k, **kw)
    live = torch.isfinite(plse)
    assert torch.equal(live, torch.isfinite(lse))
    torch.testing.assert_close(lse[live], plse[live], atol=1e-4, rtol=0)
    n0, p0 = flash_attention_bwd_cuda.launches, dict(flash_attention_bwd_cuda.launches_by_path)
    got = flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw)
    again = flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw)
    torch.cuda.synchronize()
    assert flash_attention_bwd_cuda.launches == n0 + 2
    assert flash_attention_bwd_cuda.launches_by_path == dict(p0, **{path: p0[path] + 2})
    plain = mha_reference_bwd(q, k, v, out, do, lse, **kw)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    for g, a, w in zip(got, again, plain):
        assert g.dtype == dtype and g.shape == w.shape and torch.isfinite(g).all()
        assert torch.equal(g, a)
        scale = float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= tol * scale
    dead = ~live[:, 0]                       # (B, Sq): a row's heads see the same keys
    assert (got[0][dead] == 0).all()


# bf16 against fp32 autograd of the plain version on the same (bf16-valued)
# inputs: the gradients are rounded to bf16 once (2^-9 of each) and Delta
# reads the forward's bf16 output, so 2e-2 of max |grad| leaves ~10x room;
# fp32 differs from it in the order of sums only
THROUGH_AUTOGRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_through_autograd(cuda, dtype):
    """flash_attention on CUDA tensors that need a gradient is the autograd
    function: the forward writes its lse, the backward kernel (on the path
    ``bwd_plan`` names: fp32 tiled, bf16 mma) gives autograd's gradients
    through the plain version in fp32, only the kernels the inputs need
    run, and without a gradient no lse is asked for (serving's launches
    stay as they were)."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    from repro_torch.kernels.flash_attention import ops
    q, k, v, do = _bwd_inputs(cuda, dtype, (2, 40, 40, 8, 2, 64))
    kw = dict(causal=True, window=12, softcap=30.0)
    path = "mma" if dtype == torch.bfloat16 else "tiled"
    calls = []
    fwd = ops.flash_attention_cuda

    def spy(*args, **kwargs):
        calls.append(kwargs.get("lse", False))
        return fwd(*args, **kwargs)

    ops.flash_attention_cuda = spy
    try:
        with torch.inference_mode():
            flash_attention(q, k, v, **kw)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        n0, p0 = flash_attention_bwd_cuda.launches, flash_attention_bwd_cuda.launches_by_path[path]
        out = flash_attention(*leaves, **kw)
        got = torch.autograd.grad(out, leaves, do)
        assert flash_attention_bwd_cuda.launches == n0 + 1 and calls == [False, True]
        assert flash_attention_bwd_cuda.launches_by_path[path] == p0 + 1
    finally:
        ops.flash_attention_cuda = fwd
    ref = [t.float().clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(mha_reference(*ref, **kw), ref, do.float())
    for g, w in zip(got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), w, atol=THROUGH_AUTOGRAD_TOL[dtype] *
                                   float(w.abs().max()), rtol=0)
    only_q = q.clone().requires_grad_()
    (gq,) = torch.autograd.grad(flash_attention(only_q, k, v, **kw), only_q, do)
    torch.testing.assert_close(gq, got[0], atol=0, rtol=0)


def test_kernels_without_backward_raise_under_grad(cuda):
    """On CUDA tensors that need a gradient the grouped and w8a16 matmuls
    and both paged attention ops raise, naming the kernel; without one
    (inference_mode) they run."""
    from repro_torch.kernels.quant_matmul import quantize_int8
    rng = np.random.default_rng(0)

    def t(*shape, grad=True, dtype=torch.float32):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda, dtype)
        return x.requires_grad_(grad)

    xs, w = t(20, 64), t(2, 64, 32)
    with pytest.raises(RuntimeError, match="moe_gmm: the CUDA kernel has no backward"):
        gmm(xs, w, torch.tensor([8, 12], device=cuda))
    q, kp, vp = t(1, 2, 4, 16), t(3, 16, 2, 16), t(3, 16, 2, 16)
    pt = torch.tensor([[1, 2]], dtype=torch.int32, device=cuda)
    lengths = torch.tensor([6], dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="chunked_prefill_attention: the CUDA kernel"):
        chunked_prefill_attention(q, kp, vp, pt, lengths, torch.tensor([[4, 5]], device=cuda))
    with pytest.raises(RuntimeError, match="paged_attention: the CUDA kernel"):
        paged_attention(q[:, 0], kp, vp, pt, lengths)
    wq, scale = quantize_int8(t(64, 32, grad=False))
    with pytest.raises(RuntimeError, match="w8a16_matmul: the CUDA kernel"):
        w8a16_matmul(t(2, 64), wq, scale)
    with torch.inference_mode():
        assert torch.isfinite(w8a16_matmul(t(2, 64, grad=False), wq, scale)).all()


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mixtral-8x7b", "seamless-m4t-large-v2"])
def test_train_step_on_card_matches_cpu(cuda, arch):
    """Two step_fn steps of a tiny fp32 config (remat, xent_chunk, the
    capacity MoE) on the card and on the CPU from the same parameters, the
    flash backward launched on the card only. After each step: the losses
    within 1e-4 relative; AdamW's m within 1e-3 of each leaf's max |m| and
    v (quadratic in g) within 2e-3 of its max; and on each side the new
    parameters equal to AdamW recomputed in float64 from the parameters
    before the step and that side's moments, within 1e-5 of lr x (1 +
    |update|) plus two fp32 ulps. The parameters are not held against the
    CPU's directly: AdamW's first update is nearly sign(g) times lr, so an
    element whose gradient sits near 0 may move by +-lr on either side."""
    from repro_torch.data.pipeline import DataConfig, synthesize_batch
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    from repro_torch.models.params import tree_leaves
    from repro_torch.training.train_step import TrainConfig, make_train_step
    cfg = tiny_config(arch)
    model = build_model(cfg)
    base = model.init_params(0, device="cpu")
    tcfg = TrainConfig(xent_chunk=8)
    init_fn, step_fn = make_train_step(model, tcfg)
    got = {}
    for dev in ("cpu", "cuda"):
        p = map_tree(lambda x: x.to(dev, copy=True), base)
        state = init_fn(p)
        n0 = flash_attention_bwd_cuda.launches
        steps = []
        for step in range(2):
            data = synthesize_batch(DataConfig(vocab=cfg.vocab, batch=2, seq_len=32), step)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
            if cfg.encoder is not None:
                batch["frames"] = torch.from_numpy(np.random.default_rng(step).standard_normal(
                    (2, cfg.encoder.cross_attn_memory, cfg.d_model)).astype(np.float32)).to(dev)
            before = [t.clone() for t in tree_leaves(p)]
            p, state, met = step_fn(p, state, batch)
            opt = state[0]
            m, v = tree_leaves(opt.m), tree_leaves(opt.v)
            assert _adamw_step_err(before, tree_leaves(p), m, v, lr=float(met["lr"]),
                                   step=int(opt.step), weight_decay=tcfg.weight_decay) <= 1.0
            # copies: the next step updates the moments in place
            steps.append((float(met["loss"]), [t.to("cpu", copy=True) for t in m],
                          [t.to("cpu", copy=True) for t in v]))
        assert (flash_attention_bwd_cuda.launches > n0) == (dev == "cuda")
        got[dev] = steps
    for (loss_c, m_c, v_c), (loss, m, v) in zip(got["cuda"], got["cpu"]):
        np.testing.assert_allclose(loss_c, loss, rtol=1e-4)
        for a, b in zip(m_c, m):
            assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())
        for a, b in zip(v_c, v):
            assert float((a - b).abs().max()) <= 2e-3 * float(b.abs().max())


def _adamw_step_err(before, after, m, v, *, lr, step, weight_decay, b1=0.9, b2=0.95, eps=1e-8):
    """The worst |new parameter - AdamW's| over its tolerance (1e-5 of lr x
    (1 + |update|) plus two fp32 ulps), AdamW (the optimizer's defaults)
    recomputed in float64 from the parameters before the step and the
    moments after it."""
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    worst = 0.0
    for p0, p1, mm, vv in zip(before, after, m, v):
        p0, p1, mm, vv = (t.double() for t in (p0, p1, mm, vv))
        delta = (mm / bc1) / (torch.sqrt(vv / bc2) + eps) + weight_decay * p0
        want = p0 - lr * delta
        tol = 1e-5 * lr * (1 + delta.abs()) + 2.0 ** -22 * torch.maximum(p0.abs(), want.abs())
        worst = max(worst, float(((p1 - want).abs() / tol).max()))
    return worst


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ps,D,window,softcap", [(4, 16, 0, 0.0), (8, 16, 9, 0.0),
                                                 (16, 128, 0, 30.0), (16, 128, 40, 0.0),
                                                 (16, 64, 0, 0.0), (16, 96, 40, 0.0)])
def test_paged_decode_kernel_matches_plain(cuda, dtype, ps, D, window, softcap):
    """Ragged lengths (one of them 0, one past a split boundary), GQA group 4."""
    rng = np.random.default_rng(ps + D)
    B, H, Hkv, P, maxp = 4, 8, 2, 40, 9
    q = torch.from_numpy(rng.standard_normal((B, H, D)).astype(np.float32)).to(cuda, dtype)
    kp, vp = (torch.from_numpy(rng.standard_normal((P, ps, Hkv, D)).astype(np.float32))
              .to(cuda, dtype) for _ in range(2))
    pt = torch.from_numpy(rng.integers(1, P, (B, maxp)).astype(np.int32)).to(cuda)
    lengths = torch.tensor([1, 0, 2 * ps + 3, maxp * ps], dtype=torch.int32, device=cuda)
    kw = dict(scale=D ** -0.5, softcap=softcap, window=window)
    n0 = paged_attention_cuda.launches
    out = paged_attention(q, kp, vp, pt, lengths, **kw)
    torch.cuda.synchronize()
    assert paged_attention_cuda.launches == n0 + 1
    plain = paged_attention_reference(q, kp, vp, pt, lengths, **kw)
    # tests/test_kernels_paged.py's tolerances: fp32 2e-5, bf16 3e-2
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(out.float(), plain.float(), atol=tol, rtol=tol)
    assert not out[1].any(), "a length-0 row must give zeros"


@pytest.mark.parametrize("q_dtype,kv_dtype", [(torch.float32, torch.float32),
                                              (torch.bfloat16, torch.bfloat16),
                                              (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("H,Hkv,window,softcap", [(32, 2, 0, 0.0), (8, 2, 33, 0.0),
                                                  (32, 8, 128, 50.0), (40, 2, 0, 0.0),
                                                  (32, 1, 0, 0.0)])
def test_paged_decode_split_route(cuda, q_dtype, kv_dtype, H, Hkv, window, softcap):
    """Paged decode on the chunked kernel's split path in decode mode: G up
    to 32 (G = 20 and 32 in the split block's 32-row class, which a chunked
    call's plan no longer names), lengths at a split boundary, 0 and the
    pool row's capacity, fp32 q over a bf16 pool, bit-equal repeats; the
    chunked counters stay put. Up to SPLIT_MAX_ROWS the chunked plan at C =
    1 names the same grid."""
    rng = np.random.default_rng(H + window)
    B, D, ps, maxp = 5, 128, 16, 12
    P = B * maxp + 1
    q = torch.from_numpy(rng.standard_normal((B, H, D)).astype(np.float32)).to(cuda, q_dtype)
    kp, vp = (torch.from_numpy(rng.standard_normal((P, ps, Hkv, D)).astype(np.float32))
              .to(cuda, kv_dtype) for _ in range(2))
    pt = torch.from_numpy(rng.permutation(P - 1)[:B * maxp].reshape(B, maxp).astype(np.int32)
                          + 1).to(cuda)
    lengths = torch.tensor([32, 0, 64, 97, maxp * ps], dtype=torch.int32, device=cuda)
    kw = dict(scale=D ** -0.5, softcap=softcap, window=window)
    plan = _split_plan(B, Hkv, ps, maxp, _sm_count(torch.cuda.current_device()))
    assert plan.path == "split" and plan.grid == (plan.splits, Hkv, B)
    if H // Hkv <= SPLIT_MAX_ROWS:
        assert attn_plan_for(q[:, None], kp, pt) == plan
    n0, c0 = paged_attention_cuda.launches, dict(chunked_prefill_cuda.launches_by_path)
    a = paged_attention(q, kp, vp, pt, lengths, **kw)
    b = paged_attention(q, kp, vp, pt, lengths, **kw)
    torch.cuda.synchronize()
    assert paged_attention_cuda.launches == n0 + 2
    assert chunked_prefill_cuda.launches_by_path == c0
    assert torch.equal(a, b) and a.dtype == q_dtype
    plain = paged_attention_reference(q, kp, vp, pt, lengths, **kw)
    tol = 2e-5 if (q_dtype, kv_dtype) == (torch.float32, torch.float32) else 3e-2
    torch.testing.assert_close(a.float(), plain.float(), atol=tol, rtol=tol)
    assert not a[1].any(), "a length-0 row must give zeros"


def test_paged_decode_cuda_tensor_goes_to_kernel_or_raises(cuda, monkeypatch):
    """A group past the split path's 32 folded rows, or a pool off 16-byte
    alignment, raises; nothing reaches the plain version."""
    from repro_torch.kernels.paged_attention import ops

    def plain(*args, **kw):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(ops, "paged_attention_reference", plain)
    rng = np.random.default_rng(3)
    kp, vp = (torch.from_numpy(rng.standard_normal((9, 16, 1, 16)).astype(np.float32)).to(cuda)
              for _ in range(2))
    pt = torch.arange(1, 9, dtype=torch.int32, device=cuda).reshape(2, 4)
    lengths = torch.tensor([5, 40], dtype=torch.int32, device=cuda)
    n0 = paged_attention_cuda.launches
    with pytest.raises(ValueError, match="split path"):
        paged_attention(torch.zeros((2, 33, 16), device=cuda), kp, vp, pt, lengths)
    flat = torch.empty(kp.numel() + 1, device=cuda)
    kp_off = flat[1:].view(kp.shape).copy_(kp)
    with pytest.raises(ValueError, match="aligned"):
        paged_attention(torch.zeros((2, 32, 16), device=cuda), kp_off, vp, pt, lengths)
    assert paged_attention_cuda.launches == n0
    out = paged_attention(torch.ones((2, 32, 16), device=cuda), kp, vp, pt, lengths)
    torch.cuda.synchronize()
    assert paged_attention_cuda.launches == n0 + 1 and torch.isfinite(out).all()


@pytest.mark.parametrize("name", ["gemma2-27b", "mixtral-8x7b"])
def test_generation_path_on_card_matches_cpu(cuda, name):
    """forward, prefill and decode_step (dense ring and paged pool) on the
    card (flash and paged decode kernels) against the CPU, fp32."""
    model = build_model(tiny_config(name))
    params = model.init_params(0, device="cpu")
    B, S, gen, ps = 2, 20, 4, 4
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (B, S + gen))
                            .astype(np.int32))
    maxp = (S + gen) // ps
    pt = torch.arange(B * maxp, dtype=torch.int32).reshape(B, maxp) + 1
    logits = {}
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else map_tree(lambda t: t.to(cuda), params)
        t = toks.to(dev)
        f0, p0 = flash_attention_cuda.launches, paged_attention_cuda.launches
        full, _ = model.forward(p, {"tokens": t}, RunCtx())
        dense = model.init_cache(B, S + gen, device=dev)
        paged = model.init_cache(B, S + gen, kind="paged", page_size=ps,
                                 num_pages=B * maxp + 1, device=dev)
        lg, dense = model.prefill(p, {"tokens": t[:, :S]}, dense, RunCtx())
        # the paged pool gets the prompt as one decode_chunk pack
        starts = torch.zeros(B, dtype=torch.int32, device=dev)
        nvalid = torch.full((B,), S, dtype=torch.int32, device=dev)
        model.decode_chunk(p, t[:, :S], paged, starts, nvalid,
                           torch.arange(B, dtype=torch.int32, device=dev),
                           torch.ones(B, dtype=torch.bool, device=dev), RunCtx(), pt.to(dev))
        outs = [full, lg]
        for i in range(gen):
            pos = torch.full((B,), S + i, dtype=torch.int32, device=dev)
            ld, dense = model.decode_step(p, t[:, S + i:S + i + 1], dense, pos, RunCtx())
            lp, paged = model.decode_step(p, t[:, S + i:S + i + 1], paged, pos, RunCtx(),
                                          page_table=pt.to(dev), lengths=pos + 1)
            outs += [ld, lp]
        launched = (flash_attention_cuda.launches - f0, paged_attention_cuda.launches - p0)
        assert (min(launched) > 0) == (dev == "cuda"), launched
        logits[dev] = [o.float().cpu() for o in outs]
    for a, b in zip(logits["cpu"], logits["cuda"]):
        torch.testing.assert_close(b, a, atol=2e-3, rtol=0)


@pytest.mark.parametrize("name", ["seamless-m4t-large-v2", "phi-3-vision-4.2b"])
def test_enc_dec_and_vlm_paths_on_card_match_cpu(cuda, name):
    """The enc-dec and VLM paths at their head dims (16 x 64, 32 x 96) on a
    narrow width, fp32, card against CPU within 2e-3: ``decode_chunk`` over
    a first chunk, then a pack mixing another first chunk (frames, or a
    live patch prefix) with the first sequence's later chunk (prefix dead),
    then a decode sweep; ``forward``; ``prefill`` + 2 ``decode_step``s."""
    cfg = tiny_config(name)
    H, D = (16, 64) if cfg.encoder is not None else (32, 96)
    cfg = cfg.scaled(n_heads=H, n_kv_heads=H, head_dim=D, d_model=128)
    model = build_model(cfg)
    params = model.init_params(0, device="cpu")
    off = cfg.vision.n_patches if cfg.vision is not None else 0
    rng = np.random.default_rng(2)
    seq = torch.from_numpy(rng.integers(1, 256, (2, 14)).astype(np.int32))
    if cfg.encoder is not None:
        ext = {"frames": torch.from_numpy(rng.standard_normal(
            (2, cfg.encoder.cross_attn_memory, cfg.d_model)).astype(np.float32))}
    else:
        ext = {"patches": torch.from_numpy(rng.standard_normal(
            (2, off, cfg.vision.d_patch)).astype(np.float32))}
    ps, maxp = 4, -(-(off + 14) // 4)
    pt = torch.arange(2 * maxp, dtype=torch.int32).reshape(2, maxp) + 1
    z = torch.zeros(8, dtype=torch.int32)
    calls = [(torch.stack([seq[1, :8], z]), [0, 0], [8, 0], [1, 0], [1, None], [1, 1]),
             (torch.stack([seq[0, :8], torch.cat([seq[1, 8:12], z[:4]])]), [0, 8], [8, 4],
              [0, 1], [0, 1], [0, 1]),
             (torch.stack([seq[0, 8:9], seq[1, 12:13]]), [8, 12], [1, 1], [0, 1], [0, 1], None)]
    logits = {}
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else map_tree(lambda t: t.to(cuda), params)
        cache = model.init_cache(2, off + 14, kind="paged", page_size=ps,
                                 num_pages=2 * maxp + 1, device=dev)
        outs = []
        for tok, st, nv, slots, rows, ext_rows in calls:
            st, nv = torch.tensor(st, dtype=torch.int32), torch.tensor(nv, dtype=torch.int32)
            rows_pt = torch.stack([pt[r] if r is not None else torch.zeros_like(pt[0])
                                   for r in rows])
            kw = {} if ext_rows is None else {k: v[ext_rows].to(dev) for k, v in ext.items()}
            lg, cache = model.decode_chunk(p, tok.to(dev), cache, st.to(dev), nv.to(dev),
                                           torch.tensor(slots, dtype=torch.int32).to(dev),
                                           ((st == 0) & (nv > 0)).to(dev), RunCtx(),
                                           rows_pt.to(dev), **kw)
            outs.append(lg[nv.to(dev) > 0])
        batch = dict(tokens=seq.to(dev), **{k: v.to(dev) for k, v in ext.items()})
        outs.append(model.forward(p, batch, RunCtx())[0])
        M = cfg.encoder.cross_attn_memory if cfg.encoder is not None else 0
        dense = model.init_cache(2, off + 14, memory_len=M, device=dev)
        lg, dense = model.prefill(p, dict(batch, tokens=batch["tokens"][:, :10]), dense, RunCtx())
        outs.append(lg)
        for i in range(2):
            pos = torch.full((2,), off + 10 + i, dtype=torch.int32, device=dev)
            lg, dense = model.decode_step(p, batch["tokens"][:, 10 + i:11 + i], dense, pos,
                                          RunCtx())
            outs.append(lg)
        logits[dev] = [o.float().cpu() for o in outs]
    for a, b in zip(logits["cpu"], logits["cuda"]):
        torch.testing.assert_close(b, a, atol=2e-3, rtol=0)


def test_engine_on_card_matches_cpu(cuda):
    """On the card the engine runs both CUDA kernels and gives the CPU's
    greedy streams (fp32 on both sides), through preemption."""
    model = build_model(tiny_config("mixtral-8x7b"))
    params = model.init_params(0, device="cpu")
    r = np.random.default_rng(0)
    prompts = [r.integers(1, 256, 10).astype(np.int32) for _ in range(5)]
    outs = []
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else map_tree(lambda t: t.to(cuda), params)
        eng = InferenceEngine(model, p, EngineConfig(
            max_slots=3, page_size=8, num_pages=10, max_seq=64, prefill_chunk=16,
            greedy=True, device=dev))
        reqs = [Request(req_id=f"g{i}", prompt_tokens=q, max_new_tokens=20)
                for i, q in enumerate(prompts)]
        a0, g0 = chunked_prefill_cuda.launches, gmm_tiles_cuda.launches
        eng.generate(reqs)
        eng.allocator.check_invariants()
        assert eng.scheduler.n_preemptions > 0
        launched = (chunked_prefill_cuda.launches - a0, gmm_tiles_cuda.launches - g0)
        assert (min(launched) > 0) == (dev == "cuda"), launched
        outs.append([q.generated for q in reqs])
    assert outs[0] == outs[1]


# the cases of tests/test_kernels_ssd.py and tests/test_mamba.py, the tiny
# configs' widths (P 16, N 16, chunk 16), jamba's (P 64, N 16) with groups,
# and full-width mamba2 shapes: the engine's prefill pack of 2 x 128 tokens
# (one half-padded chunk of 256) and a 1024-token prefill from carried states
SSD_CASES = [
    # B, L, H, P, N, G, chunk, init_state, ragged rows (nvalid)
    (2, 32, 3, 8, 4, 3, 8, False, None),
    (1, 24, 2, 16, 8, 2, 8, False, None),
    (1, 16, 1, 4, 2, 1, 16, False, None),
    (2, 27, 2, 8, 4, 2, 8, False, None),
    (2, 17, 3, 4, 5, 3, 4, True, None),
    (1, 16, 2, 3, 4, 2, 4, True, None),
    (2, 40, 8, 16, 16, 1, 16, True, [40, 13]),
    (1, 130, 128, 64, 16, 1, 256, True, None),
    (2, 128, 64, 64, 128, 1, 256, True, [128, 100]),
    (1, 1024, 64, 64, 128, 1, 256, True, None),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_kernel_matches_plain(cuda, dtype, case):
    """y and the final state of the kernel against the plain version on the
    same inputs; ragged rows have dt = 0 past their live tokens (padded
    tokens must leave the state untouched). bf16 launches the mma path and
    fp32 the tiled one, through launches_by_path; repeats at full width
    (P 64) are bit-equal."""
    B, L, H, P, N, G, chunk, with_state, nvalid = case
    rng = np.random.default_rng(L + H + P + N)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (B, L, H)).astype(np.float32)
    if nvalid is not None:
        dt[np.arange(L)[None, :] >= np.asarray(nvalid)[:, None]] = 0.0
    A = -rng.uniform(0.5, 2.0, (H,)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, L, G, N)).astype(np.float32) for _ in range(2))
    s0 = rng.standard_normal((B, H, P, N)).astype(np.float32) if with_state else None
    t = {k: torch.from_numpy(v).to(cuda) for k, v in
         dict(x=x, dt=dt, A=A, B_=Bm, C=Cm).items()}
    for k in ("x", "B_", "C"):
        t[k] = t[k].to(dtype)
    init = torch.from_numpy(s0).to(cuda) if with_state else None
    n0, p0 = ssd_scan_cuda.launches, dict(ssd_scan_cuda.launches_by_path)
    y, s = ssd_chunked(**t, chunk=chunk, init_state=init)
    torch.cuda.synchronize()
    assert ssd_scan_cuda.launches == n0 + 1 and y.dtype == s.dtype == torch.float32
    path = "mma" if dtype == torch.bfloat16 else "tiled"
    assert ssd_scan_plan_for(t["x"], t["B_"]).path == path
    assert ssd_scan_cuda.launches_by_path == dict(p0, **{path: p0[path] + 1})
    if P == 64:
        y2, s2 = ssd_chunked(**t, chunk=chunk, init_state=init)
        assert torch.equal(y, y2) and torch.equal(s, s2)
    rep = H // G
    y_ref, s_ref = ssd_reference(t["x"], t["dt"], t["A"], t["B_"].repeat_interleave(rep, 2),
                                 t["C"].repeat_interleave(rep, 2), chunk, init_state=init)
    # fp32 math on the same inputs on both sides: reduction order only
    # (tests/test_mamba.py's 1e-4, relative to outputs of size up to ~30)
    torch.testing.assert_close(y, y_ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s, s_ref, atol=1e-4, rtol=1e-4)
    if nvalid is not None:         # the state of a ragged row is its live tokens' state
        b, n = 1, nvalid[1]
        _, s1 = ssd_chunked(t["x"][b:b + 1, :n], t["dt"][b:b + 1, :n], t["A"],
                            t["B_"][b:b + 1, :n], t["C"][b:b + 1, :n], chunk,
                            init_state=None if init is None else init[b:b + 1])
        torch.testing.assert_close(s[b:b + 1], s1, atol=1e-4, rtol=1e-4)
    out = ssd_scan(t["x"], t["dt"], t["A"], t["B_"].repeat_interleave(rep, 2),
                   t["C"].repeat_interleave(rep, 2), chunk)
    assert out.dtype == dtype
    plain = ssd_reference(t["x"], t["dt"], t["A"], t["B_"].repeat_interleave(rep, 2),
                          t["C"].repeat_interleave(rep, 2), chunk)[0]
    # tests/test_kernels_ssd.py's tolerances: fp32 1e-4, bf16 5e-2
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(out.float(), plain, atol=tol, rtol=tol)


# the SSD backward: the edge cases above (ragged L, groups, P 3 / N 4, a
# carried state, a padded row), full widths with groups over 3 tiles, and
# mamba2's and jamba's training shapes (4 x 512 tokens)
SSD_BWD_CASES = [
    # B, L, H, P, N, G, init_state, ragged rows (nvalid), a gradient into the final state
    (2, 32, 3, 8, 4, 3, False, None, False),
    (2, 27, 2, 8, 4, 2, False, None, True),
    (2, 17, 3, 4, 5, 3, True, None, True),
    (1, 16, 2, 3, 4, 2, True, None, False),
    (2, 40, 8, 16, 16, 1, True, [40, 13], True),
    (2, 150, 4, 64, 128, 2, True, [150, 70], True),
    (4, 512, 64, 64, 128, 1, False, None, False),
    (4, 512, 128, 64, 16, 1, False, None, False),
]


def _ssd_bwd_inputs(cuda, dtype, case):
    B, L, H, P, N, G, with_state, nvalid, dfin = case
    rng = np.random.default_rng(L + H + P + N)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (B, L, H)).astype(np.float32)
    if nvalid is not None:
        dt[np.arange(L)[None, :] >= np.asarray(nvalid)[:, None]] = 0.0
    A = -rng.uniform(0.5, 2.0, (H,)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, L, G, N)).astype(np.float32) for _ in range(2))
    s0 = rng.standard_normal((B, H, P, N)).astype(np.float32) if with_state else None
    dy = rng.standard_normal((B, L, H, P)).astype(np.float32)
    d_final = rng.standard_normal((B, H, P, N)).astype(np.float32) if dfin else None
    f = [None if a is None else torch.from_numpy(a).to(cuda)
         for a in (x, dt, A, Bm, Cm, s0, dy, d_final)]
    for i in (0, 3, 4):
        f[i] = f[i].to(dtype)
    return f


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SSD_BWD_CASES)
def test_ssd_bwd_kernel_matches_plain(cuda, dtype, case):
    """The forward's tile entry states against ssd_reference's (y unchanged
    by writing them); the backward kernel against ssd_reference_bwd on the
    same inputs, states and cotangents: each gradient within 1e-4 of its
    max |plain grad| (fp32-like rounding for both dtypes: bf16 takes the
    mma path's hi + lo parts; dx, dB and dC in bf16 for bf16 inputs may
    also differ by their own rounding, 2^-8 |g|); one launch a call, on
    the path its plan names (fp32 tiled, bf16 mma); repeats bit-equal."""
    from repro_torch.kernels.ssd_scan import ssd_reference_bwd, ssd_scan_bwd_cuda
    from repro_torch.kernels.ssd_scan.kernel import bwd_plan_for
    x, dt, A, Bm, Cm, s0, dy, d_final = _ssd_bwd_inputs(cuda, dtype, case)
    path = "mma" if dtype == torch.bfloat16 else "tiled"
    assert bwd_plan_for(x, Bm)["path"] == path
    rep = x.shape[2] // Bm.shape[2]
    y, _, st = ssd_scan_cuda(x, dt, A, Bm, Cm, init_state=s0, states=True)
    assert torch.equal(y, ssd_scan_cuda(x, dt, A, Bm, Cm, init_state=s0)[0])
    _, _, st_ref = ssd_reference(x, dt, A, Bm.repeat_interleave(rep, 2),
                                 Cm.repeat_interleave(rep, 2), 64, init_state=s0, states=True)
    torch.testing.assert_close(st, st_ref, atol=2e-3, rtol=1e-4)
    n0, p0 = ssd_scan_bwd_cuda.launches, dict(ssd_scan_bwd_cuda.launches_by_path)
    got = ssd_scan_bwd_cuda(x, dt, A, Bm, Cm, st, dy, d_final, need_init=s0 is not None)
    again = ssd_scan_bwd_cuda(x, dt, A, Bm, Cm, st, dy, d_final, need_init=s0 is not None)
    torch.cuda.synchronize()
    assert ssd_scan_bwd_cuda.launches == n0 + 2
    assert ssd_scan_bwd_cuda.launches_by_path == dict(p0, **{path: p0[path] + 2})
    want = ssd_reference_bwd(x, dt, A, Bm, Cm, s0, st, dy, d_final)
    for i, (g, a, w) in enumerate(zip(got, again, want)):
        if w is None:
            assert g is None and a is None
            continue
        assert g.dtype == (dtype if i in (0, 3, 4) else torch.float32) and g.shape == w.shape
        assert torch.equal(g, a)
        diff = (g.float() - w).abs()
        if g.dtype == torch.bfloat16:
            diff = (diff - 2.0 ** -8 * w.abs()).clamp_min(0)
        assert float(diff.max()) <= 1e-4 * float(w.abs().max()), i


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_bwd_through_autograd(cuda, dtype):
    """ssd_chunked on CUDA tensors that need a gradient is SSDScan: the
    forward writes the tiles' entry states (serving's call writes none),
    the backward kernel launches once and gives the direct call's
    gradients, and a gradient nobody asks for is not computed."""
    from repro_torch.kernels.ssd_scan import ops, ssd_scan_bwd_cuda
    x, dt, A, Bm, Cm, s0, dy, d_final = _ssd_bwd_inputs(cuda, dtype,
                                                        (2, 150, 4, 64, 128, 2, True, None, True))
    calls, asked = [], []
    fwd, bwd = ops.ssd_scan_cuda, ops.ssd_scan_bwd_cuda

    def spy(*args, **kw):
        calls.append(kw.get("states", False))
        return fwd(*args, **kw)

    def bwd_spy(*args, **kw):
        asked.append(kw)
        return bwd(*args, **kw)

    ops.ssd_scan_cuda, ops.ssd_scan_bwd_cuda = spy, bwd_spy
    try:
        with torch.inference_mode():
            ssd_chunked(x, dt, A, Bm, Cm, 256, init_state=s0)
        leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm, s0)]
        n0 = ssd_scan_bwd_cuda.launches
        y, s = ssd_chunked(*leaves[:5], 256, init_state=leaves[5])
        got = torch.autograd.grad((y * dy).sum() + (s * d_final).sum(), leaves)
        assert ssd_scan_bwd_cuda.launches == n0 + 1 and calls == [False, True]
        only_x = x.clone().requires_grad_()
        (gx,) = torch.autograd.grad((ssd_chunked(only_x, dt, A, Bm, Cm, 256)[0] * dy).sum(),
                                    only_x)
        assert asked[-1] == dict(need_x=True, need_dt=False, need_A=False, need_BC=False,
                                 need_init=False)
    finally:
        ops.ssd_scan_cuda, ops.ssd_scan_bwd_cuda = fwd, bwd
    _, _, st = fwd(x, dt, A, Bm, Cm, init_state=s0, states=True)
    want = bwd(x, dt, A, Bm, Cm, st, dy, d_final)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    _, _, st0 = fwd(x, dt, A, Bm, Cm, states=True)
    assert torch.equal(gx, bwd(x, dt, A, Bm, Cm, st0, dy, need_init=False)[0])


@pytest.mark.parametrize("name", ["mamba2-1.3b", "jamba-v0.1-52b"])
def test_ssm_loss_backward_on_card_matches_cpu(cuda, name):
    """A tiny fp32 config's loss and gradients (remat, the capacity MoE) on
    the card against the CPU's from the same parameters: the loss within
    1e-4 relative, every leaf within 1e-3 of its max |g|; the SSD forward
    and backward kernels launched on the card (under remat each layer's
    recompute writes the states, then one backward), never on the CPU."""
    from repro_torch.data.pipeline import DataConfig, synthesize_batch
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda
    from repro_torch.models.params import tree_leaves, tree_unflatten
    cfg = tiny_config(name)
    model = build_model(cfg)
    base = model.init_params(0, device="cpu")
    data = synthesize_batch(DataConfig(vocab=cfg.vocab, batch=2, seq_len=80), 0)
    ctx = RunCtx(mode="train", moe_strategy="capacity", remat=True)
    got = {}
    for dev in ("cpu", "cuda"):
        p = map_tree(lambda t: t.to(dev, copy=True), base)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
        leaves = [t.detach().requires_grad_() for t in tree_leaves(p)]
        n0, b0 = ssd_scan_cuda.launches, ssd_scan_bwd_cuda.launches
        loss, _ = model.loss(tree_unflatten(p, leaves), batch, ctx)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        ran = (ssd_scan_cuda.launches - n0, ssd_scan_bwd_cuda.launches - b0)
        assert (min(ran) > 0) == (dev == "cuda"), ran
        got[dev] = (float(loss.detach()), [g.cpu() for g in grads])
    np.testing.assert_allclose(got["cuda"][0], got["cpu"][0], rtol=1e-4)
    for a, b in zip(got["cuda"][1], got["cpu"][1]):
        assert float((a - b).abs().max()) <= 1e-3 * max(float(b.abs().max()), 1e-30)


def test_ssd_cuda_tensor_goes_to_kernel_or_raises(cuda):
    """A CUDA tensor the kernel cannot take raises; none falls back to the
    plain version."""
    rng = np.random.default_rng(0)

    def case(P=8, N=4, B=1, L=8, H=2):
        return [torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (
            rng.standard_normal((B, L, H, P)), rng.uniform(0.01, 0.2, (B, L, H)),
            -rng.uniform(0.5, 2.0, (H,)), rng.standard_normal((B, L, H, N)),
            rng.standard_normal((B, L, H, N)))]
    n0 = ssd_scan_cuda.launches
    ssd_scan(*case(), 8)
    assert ssd_scan_cuda.launches == n0 + 1
    for bad in (dict(P=80), dict(N=160)):
        with pytest.raises(ValueError, match="ssd_scan_cuda"):
            ssd_scan(*case(**bad), 8)
    x, dt, A, B_, C = case()
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, B_, C, 8)
    with pytest.raises(ValueError, match="dtype"):
        ssd_scan(x.half(), dt, A, B_.half(), C.half(), 8)
    assert ssd_scan_cuda.launches == n0 + 1


@pytest.mark.parametrize("name", ["mamba2-1.3b", "jamba-v0.1-52b"])
def test_ssm_paths_on_card_match_cpu(cuda, name):
    """forward, prefill + decode_step over the dense cache, and a
    decode_chunk pack (first chunks, a ragged row, a padding row on a spare
    slot) then a decode sweep, on the card (SSD kernel) against the CPU,
    fp32."""
    model = build_model(tiny_config(name))
    params = model.init_params(0, device="cpu")
    B, S, gen, ps = 2, 37, 4, 4
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (B, S + gen))
                            .astype(np.int32))
    maxp = (S + gen + ps - 1) // ps
    pt = torch.arange(B * maxp, dtype=torch.int32).reshape(B, maxp) + 1
    logits = {}
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else map_tree(lambda t: t.to(cuda), params)
        t = toks.to(dev)
        n0 = ssd_scan_cuda.launches
        full, _ = model.forward(p, {"tokens": t}, RunCtx())
        dense = model.init_cache(B, S + gen, device=dev)
        lg, dense = model.prefill(p, {"tokens": t[:, :S]}, dense, RunCtx())
        outs = [full, lg]
        for i in range(gen):
            pos = torch.full((B,), S + i, dtype=torch.int32, device=dev)
            ld, dense = model.decode_step(p, t[:, S + i:S + i + 1], dense, pos, RunCtx())
            outs.append(ld)
        # the engine's path: rows on slots 2 / 0 of 3, row 1 ragged, a
        # padding row on spare slot 1, then a decode sweep over all slots
        paged = model.init_cache(3, S + gen, kind="paged", page_size=ps,
                                 num_pages=B * maxp + 1, device=dev)
        tok = torch.zeros((3, S), dtype=torch.int32, device=dev)
        tok[:2] = t[:, :S]
        rows = torch.zeros((3, maxp), dtype=torch.int32)
        rows[:2] = pt

        def arr(v, dt=torch.int32):
            return torch.tensor(v, dtype=dt, device=dev)
        lc, paged = model.decode_chunk(p, tok, paged, arr([0, 0, 0]), arr([S, 30, 0]),
                                       arr([2, 0, 1]), arr([True, True, False], torch.bool),
                                       RunCtx(), rows.to(dev))
        outs.append(lc[:2])
        sweep = torch.zeros((3, maxp), dtype=torch.int32)
        sweep[2], sweep[0] = pt[0], pt[1]
        ls, paged = model.decode_chunk(
            p, torch.stack([t[1, 30:31], t[1, 30:31], t[0, S:S + 1]]), paged,
            arr([30, 0, S]), arr([1, 0, 1]), arr([0, 1, 2]), arr([False] * 3, torch.bool),
            RunCtx(), sweep.to(dev))
        outs.append(ls[[0, 2]])
        assert (ssd_scan_cuda.launches - n0 > 0) == (dev == "cuda")
        logits[dev] = [o.float().cpu() for o in outs]
    for a, b in zip(logits["cpu"], logits["cuda"]):
        torch.testing.assert_close(b, a, atol=2e-3, rtol=0)
    # on the card, the engine's path agrees with forward at the same positions
    card = logits["cuda"]
    torch.testing.assert_close(card[-2][0], card[0][0, S - 1], atol=2e-3, rtol=0)
    torch.testing.assert_close(card[-2][1], card[0][1, 29], atol=2e-3, rtol=0)
    torch.testing.assert_close(card[-1][0], card[0][1, 30], atol=2e-3, rtol=0)
    torch.testing.assert_close(card[-1][1], card[0][0, S], atol=2e-3, rtol=0)


@pytest.mark.parametrize("name", ["mamba2-1.3b", "jamba-v0.1-52b"])
def test_ssm_engine_on_card_matches_cpu(cuda, name):
    """The engine on the card runs the SSD kernel and gives the CPU's greedy
    streams (fp32 on both sides), through preemption."""
    model = build_model(tiny_config(name))
    params = model.init_params(0, device="cpu")
    r = np.random.default_rng(7)
    prompts = [r.integers(1, 256, n).astype(np.int32) for n in (19, 7, 12, 10)]
    outs = []
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else map_tree(lambda t: t.to(cuda), params)
        eng = InferenceEngine(model, p, EngineConfig(
            max_slots=3, page_size=8, num_pages=8, max_seq=64, prefill_chunk=8,
            greedy=True, device=dev))
        reqs = [Request(req_id=f"s{i}", prompt_tokens=q, max_new_tokens=10)
                for i, q in enumerate(prompts)]
        n0 = ssd_scan_cuda.launches
        eng.generate(reqs)
        eng.allocator.check_invariants()
        assert eng.scheduler.n_preemptions > 0
        assert (ssd_scan_cuda.launches - n0 > 0) == (dev == "cuda")
        outs.append([q.generated for q in reqs])
    assert outs[0] == outs[1]


# w8a16: the CPU tests' shapes with the per-output-channel scale (the TPU
# kernel's function), ragged M / N / K edges with the int8 tree's row scale
# per input row (G = 1) or per (input row, head) (G = heads), both scales,
# no scale, and the transposed-stride weight of the tied head
W8A16_CASES = [
    # M, K, N, col_scale, row-scale groups (0: none), transposed weight
    (16, 64, 32, True, 0, False),
    (32, 128, 64, True, 0, False),
    (8, 32, 16, True, 0, False),
    (5, 100, 130, False, 1, False),
    (70, 96, 128, False, 4, False),
    (3, 256, 4096, False, 32, False),
    (67, 40, 72, True, 2, False),
    (9, 33, 50, False, 0, False),
    (4, 160, 300, True, 0, True),
    # the edges of the three paths (kernel.py's _plan): the last streaming
    # M and the first tensor-core / tiled one, k-major past 16 rows (aligned
    # and ragged K), ragged N and K on the tensor-core path, wk's 8 groups
    # of 128 at N = 1024 at decode and at prefill, split-K decode and prefill
    (16, 256, 512, False, 4, False),
    (17, 256, 512, False, 4, False),
    (40, 160, 300, True, 0, True),
    (33, 100, 72, True, 0, True),
    (100, 33, 50, False, 1, False),
    (4, 512, 1024, False, 8, False),
    (80, 512, 1024, False, 8, False),
    (1, 4096, 256, False, 2, False),
    (70, 600, 136, False, 4, False),      # tensor cores with K split in two, ragged
]


def _w8a16_operands(cuda, dtype, case):
    M, K, N, with_col, G, transposed = case
    rng = np.random.default_rng(M + K + N)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(cuda, dtype)
    q = torch.from_numpy(rng.integers(-127, 128, (N, K) if transposed else (K, N))
                         .astype(np.int8)).to(cuda)
    if transposed:
        q = q.T                                    # strides (1, K), as embed.q.T
    col = (torch.from_numpy(rng.uniform(0.001, 0.02, N).astype(np.float32)).to(cuda)
           if with_col else None)
    row = (torch.from_numpy(rng.uniform(0.001, 0.02, (K, G)).astype(np.float32)).to(cuda)
           if G else None)
    return x, q, col, row


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", W8A16_CASES)
def test_w8a16_kernel_matches_plain(cuda, dtype, case):
    x, q, col, row = _w8a16_operands(cuda, dtype, case)
    if col is None and row is None:
        x = x / 64                                 # keep the outputs of size ~1
    n0 = w8a16_matmul_cuda.launches
    out = w8a16_matmul(x, q, col, row_scale=row)
    torch.cuda.synchronize()
    assert w8a16_matmul_cuda.launches == n0 + 1 and out.dtype == dtype
    plain = w8a16_matmul_reference(x, q, col, row)
    # tests/test_kernels_quant.py's 1e-3 in fp32 (reduction order only);
    # bf16 as tests/test_kernels_gmm.py: one rounding of outputs of size ~1
    tol = 1e-3 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(out.float(), plain.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", W8A16_CASES)
def test_w8a16_reaches_planned_path(cuda, dtype, case):
    """Each call launches the kernel its plan names (streaming at M <= 16,
    tensor cores for bf16 above, the fp32 tiled kernel for fp32 above), and
    a second call gives the same bits: the split-K partial sums are added
    in a fixed order, with no atomics."""
    x, q, col, row = _w8a16_operands(cuda, dtype, case)
    plan = plan_for(x, q)
    want = ("stream_k" if is_k_major(q) else "stream_n") if x.shape[0] <= 16 else \
        ("mma" if dtype == torch.bfloat16 else "tiled")
    assert plan.path == want
    before = dict(w8a16_matmul_cuda.launches_by_path)
    a = w8a16_matmul(x, q, col, row_scale=row)
    b = w8a16_matmul(x, q, col, row_scale=row)
    torch.cuda.synchronize()
    after = w8a16_matmul_cuda.launches_by_path
    assert {p: after[p] - before[p] for p in after} == {p: 2 * (p == want) for p in after}
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,N,G", [(4, 4096, 32), (4, 1024, 8), (4, 32000, 1), (256, 4096, 32)])
def test_w8a16_full_width_bit_equal_repeats(cuda, dtype, M, N, G):
    """mixtral's wq, wk and head at decode (split K over >= 2 blocks a SM)
    and wq over a prefill pack: two calls give the same bits, and the result
    is within the phase's tolerance of the plain version (fp32: reduction
    order; bf16: one rounding of outputs of size < 8, 2^-5)."""
    K = 4096
    rng = np.random.default_rng(N + M)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(cuda, dtype)
    w = quantize_leaf(torch.from_numpy(
        (rng.standard_normal((K, G, N // G)) * K ** -0.5).astype(np.float32)).to(cuda))
    q, row = w.q.reshape(K, N), w.scale.reshape(K, G)
    if M <= 16:
        assert plan_for(x, q).splits > 1
    a = w8a16_matmul(x, q, row_scale=row)
    b = w8a16_matmul(x, q, row_scale=row)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    tol = 1e-3 if dtype == torch.float32 else 2 ** -5
    assert float((a.float() - w8a16_matmul_reference(x, q, None, row).float()).abs().max()) <= tol


def test_w8a16_cuda_tensor_goes_to_kernel_or_raises(cuda):
    """Operands the kernel cannot take raise; none falls back to the plain
    version."""
    x = torch.randn((4, 64), device=cuda)
    q = torch.randint(-127, 128, (64, 96), dtype=torch.int8, device=cuda)
    n0 = w8a16_matmul_cuda.launches
    with pytest.raises(ValueError, match="int8"):
        w8a16_matmul(x, q.float())
    with pytest.raises(ValueError, match="G dividing"):
        w8a16_matmul(x, q, row_scale=torch.ones((64, 5), device=cuda))
    with pytest.raises(ValueError, match="dtype"):
        w8a16_matmul(x.half(), q)
    assert w8a16_matmul_cuda.launches == n0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sizes,K,N", [([8, 8, 8, 8], 16, 24), ([0, 70, 0, 1], 40, 72),
                                       ([1, 1, 1, 1, 129], 64, 130)])
def test_gmm_int8_kernel_matches_plain(cuda, dtype, sizes, K, N):
    """int8 experts with their scale per (expert, input row) through the
    grouped matmul, against the plain version on the same QuantizedLinear."""
    rng = np.random.default_rng(len(sizes) + K)
    gs = torch.tensor(sizes, device=cuda)
    M, E = int(gs.sum()), len(sizes)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(cuda, dtype)
    w = quantize_leaf(torch.from_numpy(rng.standard_normal((E, K, N)).astype(np.float32))
                      .to(cuda))
    n0 = gmm_tiles_cuda.launches
    out = gmm(x, w, gs)
    torch.cuda.synchronize()
    assert gmm_tiles_cuda.launches == n0 + 1 and out.dtype == dtype
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(out.float(), gmm_reference(x, w, gs).float(), atol=tol, rtol=tol)


# the edges of gmm's three paths (kernels/moe_gmm/kernel.py's _plan): empty
# experts, all rows on one expert, M = 1, 16 (the last streaming M), 17 (the
# first tensor-core / tiled one), 512 with 300 rows on one expert, ragged K
# and N (scalar loads), a split-K tensor-core call
GMM_PATH_CASES = [
    # group sizes, K, N
    ([0, 1, 0, 0], 64, 256),
    ([0, 0, 16, 0], 64, 256),
    ([3, 0, 5, 0, 8], 96, 512),
    ([0, 17, 0], 64, 256),
    ([300, 100, 0, 50, 62], 128, 384),
    ([2, 0, 3], 40, 130),
    ([0, 20, 9], 40, 130),
    ([5, 12], 1024, 256),
    ([30, 0, 11], 2048, 256),
]


def _gmm_operands(cuda, dtype, int8, sizes, K, N):
    rng = np.random.default_rng(sum(sizes) + K + N)
    gs = torch.tensor(sizes, device=cuda)
    M, E = int(gs.sum()), len(sizes)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(cuda, dtype)
    w = torch.from_numpy((rng.standard_normal((E, K, N)) * K ** -0.5).astype(np.float32))
    w = quantize_leaf(w.to(cuda)) if int8 else w.to(cuda, dtype)
    return x, w, gs


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", GMM_PATH_CASES)
def test_gmm_reaches_planned_path(cuda, dtype, int8, case):
    """Each call launches the kernel its plan names (streaming at M <= 16,
    tensor cores for bf16 x above, the fp32 tiled kernel for fp32 x above),
    within the tolerances of test_gmm_kernel_matches_plain, and a second
    call gives the same bits: the split-K partial sums are added in a fixed
    order, with no atomics."""
    sizes, K, N = case
    x, w, gs = _gmm_operands(cuda, dtype, int8, sizes, K, N)
    M = x.shape[0]
    want = "stream" if M <= 16 else ("mma" if dtype == torch.bfloat16 else "tiled")
    assert gmm_plan_for(M, x, w.q if int8 else w).path == want
    before = dict(gmm_tiles_cuda.launches_by_path)
    n0 = gmm_tiles_cuda.launches
    a = gmm(x, w, gs)
    b = gmm(x, w, gs)
    torch.cuda.synchronize()
    after = gmm_tiles_cuda.launches_by_path
    assert {p: after[p] - before[p] for p in after} == {p: 2 * (p == want) for p in after}
    assert gmm_tiles_cuda.launches == n0 + 2 and a.dtype == dtype
    assert torch.equal(a, b)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(a.float(), gmm_reference(x, w, gs).float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("tokens,K,N", [(4, 4096, 14336), (8, 14336, 4096),
                                        (256, 4096, 14336), (256, 14336, 4096)])
def test_gmm_full_width_bit_equal_repeats(cuda, int8, tokens, K, N):
    """mixtral's expert matmuls in bf16 at decode (the engine's 4 tokens, 8
    tokens: split K) and over a prefill pack of 256 tokens, top-2 over 8
    experts: two calls give the same bits, within chip_smoke.py's phase-2
    tolerance of the plain version (one rounding of outputs of size < 8)."""
    g = torch.Generator(device=cuda).manual_seed(tokens + K)
    e = torch.topk(torch.randn((tokens, 8), generator=g, device=cuda), 2, dim=-1).indices
    gs = torch.bincount(e.reshape(-1), minlength=8)
    x = torch.randn((2 * tokens, K), generator=g, device=cuda).bfloat16()
    w = torch.randn((8, K, N), generator=g, device=cuda).mul_(K ** -0.5)
    w = quantize_leaf(w) if int8 else w.bfloat16()
    M = x.shape[0]
    plan = gmm_plan_for(M, x, w.q if int8 else w)
    assert plan.path == ("stream" if M <= 16 else "mma")
    if M <= 16:
        assert plan.splits > 1
    a = gmm(x, w, gs)
    b = gmm(x, w, gs)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    tol = 2 ** -5 if int8 else 3e-2
    assert float((a.float() - gmm_reference(x, w, gs).float()).abs().max()) <= tol


def test_gmm_cuda_tensor_goes_to_kernel_or_raises(cuda):
    """Operands the kernel cannot take raise; none falls back to the plain
    version."""
    gs = torch.tensor([3, 0, 5], device=cuda)
    x = torch.randn((8, 64), device=cuda)
    w = torch.randn((3, 64, 32), device=cuda)
    dst, te, tr, Mp = tile_layout(gs, 8, block_m_for(8))
    xp = x.new_zeros((Mp, 64))
    xp[dst] = x
    n0 = gmm_tiles_cuda.launches
    with pytest.raises(ValueError, match="dtype"):
        gmm(x.half(), w, gs)
    with pytest.raises(ValueError, match="w_scale"):
        gmm_tiles_cuda(xp, w.to(torch.int8), te, tr, block_m_for(8), rows=8)
    with pytest.raises(ValueError, match="block_m"):
        gmm_tiles_cuda(xp, w, te, tr, 64, rows=8)
    with pytest.raises(ValueError, match="rows"):
        gmm_tiles_cuda(xp[:-1], w, te, tr, block_m_for(8), rows=8)
    assert gmm_tiles_cuda.launches == n0
    out = gmm_tiles_cuda(xp, w, te, tr, block_m_for(8), rows=8)
    torch.cuda.synchronize()
    assert gmm_tiles_cuda.launches == n0 + 1
    torch.testing.assert_close(out[dst], gmm_reference(x, w, gs), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["mixtral-8x7b", "gemma2-27b", "mamba2-1.3b"])
def test_int8_paths_on_card_match_cpu(cuda, name):
    """The int8 tree of a tiny model widened to d_model 256 (every
    projection quantized; gemma2's tied head and mamba2's tied head read the
    int8 embedding transposed): forward, prefill + decode_step and a
    decode_chunk pack then a decode sweep, on the card (w8a16 and int8
    gmm kernels) against the CPU, fp32."""
    model = build_model(tiny_config(name).scaled(d_model=256))
    params = quantize_params_int8(model.init_params(0, device="cpu"))
    B, S, gen, ps = 2, 20, 3, 4
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (B, S + gen))
                            .astype(np.int32))
    maxp = (S + gen + ps - 1) // ps
    pt = torch.arange(B * maxp, dtype=torch.int32).reshape(B, maxp) + 1
    logits = {}
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else map_tree(lambda t: t.to(cuda), params)
        t = toks.to(dev)
        n0 = w8a16_matmul_cuda.launches
        full, _ = model.forward(p, {"tokens": t}, RunCtx())
        dense = model.init_cache(B, S + gen, device=dev)
        lg, dense = model.prefill(p, {"tokens": t[:, :S]}, dense, RunCtx())
        outs = [full, lg]
        for i in range(gen):
            pos = torch.full((B,), S + i, dtype=torch.int32, device=dev)
            ld, dense = model.decode_step(p, t[:, S + i:S + i + 1], dense, pos, RunCtx())
            outs.append(ld)
        paged = model.init_cache(B, S + gen, kind="paged", page_size=ps,
                                 num_pages=B * maxp + 1, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        nv = torch.tensor([S, S - 7], **i32)
        lc, paged = model.decode_chunk(p, t[:, :S], paged, torch.zeros(B, **i32), nv,
                                       torch.arange(B, **i32),
                                       torch.ones(B, dtype=torch.bool, device=dev), RunCtx(),
                                       pt.to(dev))
        nxt = t[torch.arange(B, device=dev), nv.long()][:, None]
        ls, paged = model.decode_chunk(p, nxt, paged, nv, torch.ones(B, **i32),
                                       torch.arange(B, **i32),
                                       torch.zeros(B, dtype=torch.bool, device=dev), RunCtx(),
                                       pt.to(dev))
        outs += [lc, ls]
        assert (w8a16_matmul_cuda.launches - n0 > 0) == (dev == "cuda")
        logits[dev] = [o.float().cpu() for o in outs]
    for a, b in zip(logits["cpu"], logits["cuda"]):
        torch.testing.assert_close(b, a, atol=2e-3, rtol=0)


def test_int8_engine_on_card_matches_cpu(cuda):
    """The engine on the int8 tiny mixtral (d_model 256) runs the w8a16 and
    int8 gmm kernels on the card and gives the CPU's greedy streams, through
    preemption."""
    model = build_model(tiny_config("mixtral-8x7b").scaled(d_model=256))
    params = quantize_params_int8(model.init_params(0, device="cpu"))
    r = np.random.default_rng(0)
    prompts = [r.integers(1, 256, 10).astype(np.int32) for _ in range(5)]
    outs = []
    for dev in ("cpu", "cuda"):
        p = params if dev == "cpu" else map_tree(lambda t: t.to(cuda), params)
        eng = InferenceEngine(model, p, EngineConfig(
            max_slots=3, page_size=8, num_pages=10, max_seq=64, prefill_chunk=16,
            greedy=True, device=dev))
        reqs = [Request(req_id=f"q{i}", prompt_tokens=q, max_new_tokens=20)
                for i, q in enumerate(prompts)]
        w0, g0 = w8a16_matmul_cuda.launches, gmm_tiles_cuda.launches
        eng.generate(reqs)
        eng.allocator.check_invariants()
        assert eng.scheduler.n_preemptions > 0
        launched = (w8a16_matmul_cuda.launches - w0, gmm_tiles_cuda.launches - g0)
        assert (min(launched) > 0) == (dev == "cuda"), launched
        outs.append([q.generated for q in reqs])
    assert outs[0] == outs[1]
