"""Port's int8 weight-only serving (paper §4.1) vs the JAX package: the
w8a16 matmul's plain version against JAX's Pallas kernel in interpret mode,
tests/test_kernels_quant.py's quantization bounds and round trips, the int8
tree bit-equal to JAX's ``quantize_params_int8``, ``init_params_int8``
equal to quantizing ``init_params``, the row-scale forms the model hands the
kernel, and the int8 model and engine against the JAX model and engine on
``dequantize_tree(quantize_params_int8(p), float32)``. The CUDA kernels
against their plain versions are in test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.quant.quantize as jax_quant_mod
import repro_torch.quant.quantize as quant_mod
from repro.configs import tiny_config as jax_tiny_config
from repro.core.engine import EngineConfig as JaxEngineConfig
from repro.core.engine import InferenceEngine as JaxInferenceEngine
from repro.core.metrics import Request as JaxRequest
from repro.kernels.quant_matmul import quantize_int8 as jax_quantize_int8
from repro.kernels.quant_matmul import w8a16_matmul as jax_w8a16_matmul
from repro.models import RunCtx as JaxRunCtx
from repro.models import build_model as jax_build_model
from repro.models import common as jax_common
from repro.quant import dequantize_tree as jax_dequantize_tree
from repro.quant import quantize_params_int8 as jax_quantize_params_int8
from repro.quant.quantize import fp8_cast_tree as jax_fp8_cast_tree
from repro.quant.quantize import kv_quantize as jax_kv_quantize
from repro_torch.configs import tiny_config
from repro_torch.core import EngineConfig, InferenceEngine, Request
from repro_torch.kernels.quant_matmul import (quantize_int8, w8a16_matmul, w8a16_matmul_cuda,
                                              w8a16_matmul_reference)
from repro_torch.kernels.quant_matmul.kernel import (GRID_LIMITS, KMAJOR_BLOCK_N, MMA_TILE,
                                                     RESIDENT, STREAM_BLOCK_N, TILED_TILE,
                                                     XS_FLOATS, _plan, is_k_major, split_ranges)
from repro_torch.models import RunCtx, build_model
from repro_torch.models.common import linear, rmsnorm
from repro_torch.models.params import init_params, init_params_int8, params_from_numpy
from repro_torch.quant import (QuantizedLinear, dequantize_tree, fp8_cast_tree, kv_dequantize,
                               kv_quantize, quantize_leaf, quantize_params_int8)

# fp32 on both sides over the same dequantized weights: reduction order only
LOGIT_TOL = 1e-4
JCTX = JaxRunCtx(attn_backend="xla", moe_strategy="dropless", block_q=8, block_kv=8)
CTX = RunCtx()
ARCHS = ["mixtral-8x7b", "qwen2.5-3b", "gemma2-27b", "mamba2-1.3b", "jamba-v0.1-52b"]
WIDE = 256      # d_model at which every projection crosses the 1 << 14 threshold
# the quantized leaves at WIDE with the reference's threshold: every projection
# kind of the family, the embedding and the untied head
ATTN = {"attn/wq", "attn/wk", "attn/wv", "attn/wo"}
MLP = {"mlp/wi", "mlp/wg", "mlp/wo"}
MOE = {"moe/wg", "moe/wu", "moe/wd"}
SSM = {"ssm/in_proj", "ssm/out_proj"}
QUANTIZED = {"mixtral-8x7b": ATTN | MOE | {"embed/w", "lm_head/w"},
             "qwen2.5-3b": ATTN | MLP | {"embed/w", "lm_head/w"},
             "gemma2-27b": ATTN | MLP | {"embed/w"},
             "mamba2-1.3b": SSM | {"embed/w"},
             "jamba-v0.1-52b": ATTN | MLP | MOE | SSM | {"embed/w", "lm_head/w"}}
# and some of the leaves read outside a matmul, once the threshold is 1
EVERY_LEAF = {"mixtral-8x7b": {"layers/ln1", "layers/ln2", "moe/router"},
              "qwen2.5-3b": {"layers/ln1", "attn/bq", "attn/bk", "attn/bv"},
              "gemma2-27b": {"layers/ln1", "layers/ln2"},
              "mamba2-1.3b": {"layers/ln1", "ssm/conv_w", "ssm/conv_b", "ssm/A_log", "ssm/D",
                              "ssm/dt_bias", "ssm/norm"},
              "jamba-v0.1-52b": {"layers/ln1", "moe/router", "ssm/conv_w", "ssm/norm"}}


def _t(a):
    return torch.from_numpy(np.array(a))


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


def _quantized_paths(tree, path=""):
    """'<sublayer>/<leaf>' (or '<top>/w') of every QuantizedLinear."""
    if isinstance(tree, QuantizedLinear) or hasattr(tree, "q"):
        yield "/".join(path.strip("/").split("/")[-2:])
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _quantized_paths(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _quantized_paths(v, path)


def _models(name, min_size=None, monkeypatch=None):
    """The JAX model on the dequantized fp32 tree and the port's model on
    the bridged int8 tree. ``min_size`` lowers the quantization threshold of
    both packages (as at full depth, where norms, routers and convs cross
    it)."""
    if min_size is not None:
        monkeypatch.setattr(jax_quant_mod, "_QUANT_MIN_SIZE", min_size)
        monkeypatch.setattr(quant_mod, "_QUANT_MIN_SIZE", min_size)
    jcfg = jax_tiny_config(name).scaled(d_model=WIDE)
    jmodel = jax_build_model(jcfg)
    jq = jax_quantize_params_int8(jmodel.init_params(jax.random.PRNGKey(0)))
    jp = jax_dequantize_tree(jq, jnp.float32)
    tq = params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu")
    return jmodel, jp, build_model(tiny_config(name).scaled(d_model=WIDE)), tq


# ---------------------------------------------------------------- the kernel's function
@pytest.mark.parametrize("M,K,N,bm,bn,bk", [
    (16, 64, 32, 8, 16, 32), (32, 128, 64, 16, 32, 64), (8, 32, 16, 8, 16, 16),
])
def test_w8a16_matches_jax_kernel(rng, M, K, N, bm, bn, bk):
    """tests/test_kernels_quant.py's shapes: the port's op (plain version on
    the CPU) against JAX's Pallas kernel in interpret mode, and the port's
    quantize_int8 against JAX's, bit for bit."""
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    jwq, jsc = jax_quantize_int8(jnp.asarray(w))
    ref = jax_w8a16_matmul(jnp.asarray(x), jwq, jsc, backend="pallas", interpret=True,
                           block_m=bm, block_n=bn, block_k=bk)
    wq, sc = quantize_int8(_t(w))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))
    out = w8a16_matmul(_t(x), wq, sc)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3, rtol=1e-3)


def test_quantization_error_bound(rng):
    w = _t(rng.standard_normal((128, 256)).astype(np.float32))
    x = _t(rng.standard_normal((4, 128)).astype(np.float32))
    wq, sc = quantize_int8(w)
    exact = x @ w
    quant = w8a16_matmul_reference(x, wq, sc)
    rel = float((exact - quant).abs().max() / exact.abs().max())
    assert rel < 0.05, rel


def test_params_tree_quantization(rng):
    tree = {"big": _t(rng.standard_normal((128, 256)).astype(np.float32)),
            "small": torch.ones(8)}
    q = quantize_params_int8(tree)
    assert q["big"].q.dtype == torch.int8 and q["big"].scale.shape == (128, 1)
    assert q["small"] is tree["small"]                # small leaves untouched
    back = dequantize_tree(q, torch.float32)
    assert float((back["big"] - tree["big"]).abs().max()) < 0.05


def test_kv_quant_roundtrip(rng):
    kv = rng.standard_normal((3, 7, 2, 16)).astype(np.float32)
    q, s = kv_quantize(_t(kv))
    jq, js = jax_kv_quantize(jnp.asarray(kv))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert float((kv_dequantize(q, s) - _t(kv)).abs().max()) < 0.05


def test_dequantize_and_fp8_trees_match_jax(rng):
    """``dequantize_tree`` (bf16 by default, as the reference) and the fp8
    storage cast give JAX's values."""
    tree = {"w": rng.standard_normal((64, 300)).astype(np.float32),
            "b": rng.standard_normal((300,)).astype(np.float32)}
    jq = jax_quantize_params_int8(jax.tree.map(jnp.asarray, tree))
    tq = quantize_params_int8({k: _t(v) for k, v in tree.items()})
    for jd, td in ((jax_dequantize_tree(jq), dequantize_tree(tq)),
                   (jax_fp8_cast_tree(jq), fp8_cast_tree(tq))):
        for k in tree:
            a, b = jax.tree.leaves(jd[k]), jax.tree.leaves(td[k])
            assert len(a) == len(b)
            for x, y in zip(a, b):
                assert str(y.dtype).split(".")[-1] == str(x.dtype)
                np.testing.assert_array_equal(y.float().numpy(), np.asarray(x, np.float32))


# ---------------------------------------------------------------- the int8 tree
@pytest.mark.parametrize("name", ARCHS)
def test_quantized_tree_matches_jax(name):
    """The port's quantize_params_int8 of the bridged tree is JAX's: the same
    quantized leaves (every projection kind of the family), q bit-equal,
    scale equal; the bridge keeps q int8 and scale fp32 whatever the
    dtype."""
    jp = jax_build_model(jax_tiny_config(name).scaled(d_model=WIDE)).init_params(
        jax.random.PRNGKey(0))
    jq = jax.tree.map(np.asarray, jax_quantize_params_int8(jp))
    ours = quantize_params_int8(params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"))
    bridged = params_from_numpy(jq, device="cpu", dtype=torch.bfloat16)
    assert set(_quantized_paths(ours)) == set(_quantized_paths(jq)) == QUANTIZED[name]
    jl, tl, bl = jax.tree.leaves(jq), jax.tree.leaves(ours), jax.tree.leaves(bridged)
    assert len(jl) == len(tl) == len(bl)
    for a, b, c in zip(jl, tl, bl):
        np.testing.assert_array_equal(b.numpy(), a)
        if a.dtype == np.int8:
            assert b.dtype == c.dtype == torch.int8 and torch.equal(b, c)
    for ql in jax.tree.leaves(bridged, is_leaf=lambda t: isinstance(t, QuantizedLinear)):
        if isinstance(ql, QuantizedLinear):
            assert ql.scale.dtype == torch.float32 and ql.scale.shape == (*ql.q.shape[:-1], 1)


@pytest.mark.parametrize("name,dtype,min_size", [
    ("mixtral-8x7b", torch.float32, None), ("jamba-v0.1-52b", torch.bfloat16, None),
    ("mamba2-1.3b", torch.bfloat16, 1)])
def test_init_params_int8_matches_quantized_init(monkeypatch, name, dtype, min_size):
    """init_params_int8 equals quantize_params_int8(init_params(...)) leaf
    for leaf, bit for bit, in fp32 and bf16; with the threshold at 1 the
    ones / zeros / A_log / dt_bias leaves are quantized too."""
    if min_size is not None:
        monkeypatch.setattr(quant_mod, "_QUANT_MIN_SIZE", min_size)
    cfg = tiny_config(name).scaled(d_model=WIDE)
    ref = quantize_params_int8(init_params(cfg, 3, device="cpu", dtype=dtype))
    ours = init_params_int8(cfg, 3, device="cpu", dtype=dtype)
    assert set(_quantized_paths(ours)) == set(_quantized_paths(ref))
    assert set(_quantized_paths(ours)) >= (
        {"ssm/norm", "ssm/A_log", "ssm/conv_b", "layers/ln1"} if min_size else QUANTIZED[name])
    a, b = jax.tree.leaves(ref), jax.tree.leaves(ours)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ---------------------------------------------------------------- what the model hands the kernel
@pytest.mark.parametrize("form", ["rows", "heads", "transposed"])
def test_w8a16_row_scale_forms(rng, form):
    """The three forms the model uses, against x @ the dequantized weight:
    a (K, N) projection (row scale, G = 1), wq flattened to (d, H * hd)
    (row scale per head, G = H) through ``linear``, and the head over a tied
    embedding (its transpose through the strides, col scale)."""
    d, H, hd, V = 64, 4, 16, 48
    x = _t(rng.standard_normal((3, 5, d)).astype(np.float32))
    if form == "transposed":
        emb = quantize_leaf(_t(rng.standard_normal((V, 300)).astype(np.float32)))
        x = _t(rng.standard_normal((7, 300)).astype(np.float32))
        out = w8a16_matmul(x, emb.q.T, emb.scale[:, 0])
        ref = x @ dequantize_tree({"w": emb}, torch.float32)["w"].T
    else:
        shape = (d, 3 * d) if form == "rows" else (d, H, hd)
        w = quantize_leaf(_t(rng.standard_normal(shape).astype(np.float32)))
        out = linear(x, w)
        ref = torch.tensordot(x, dequantize_tree({"w": w}, torch.float32)["w"], dims=1)
        assert w.scale.reshape(d, -1).shape[1] == (1 if form == "rows" else H)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)


def test_linear_over_two_input_dims(rng):
    """wo (H, hd, d): an einsum over (H, hd) on a plain tensor; one row scale
    per (head, hd) input row on an int8 leaf."""
    o = _t(rng.standard_normal((2, 3, 4, 16)).astype(np.float32))
    wo = _t(rng.standard_normal((4, 16, 64)).astype(np.float32))
    torch.testing.assert_close(linear(o, wo, n_in=2), torch.einsum("bshk,hkd->bsd", o, wo))
    q = quantize_leaf(wo)
    assert q.scale.shape == (4, 16, 1)
    ref = torch.einsum("bshk,hkd->bsd", o, dequantize_tree({"w": q}, torch.float32)["w"])
    torch.testing.assert_close(linear(o, q, n_in=2), ref, atol=1e-5, rtol=1e-5)


def test_rmsnorm_on_quantized_norm_leaf(rng):
    """At full depth the stacked (R, d) norms cross the threshold: one
    repeat of such a leaf, int8 with a scale (1,), against JAX's rmsnorm on
    the dequantized weight."""
    ln = rng.uniform(0.5, 1.5, (4, 4096)).astype(np.float32)
    jq = jax_quantize_params_int8({"ln": jnp.asarray(ln)})
    q = params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu")["ln"]
    assert isinstance(q, QuantizedLinear) and q.scale.shape == (4, 1)
    x = rng.standard_normal((2, 3, 4096)).astype(np.float32)
    ref = jax_common.rmsnorm(jnp.asarray(x), jax_dequantize_tree(jq, jnp.float32)["ln"][1], 1e-6)
    out = rmsnorm(_t(x), QuantizedLinear(q.q[1], q.scale[1]), 1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------- the int8 model, end to end
@pytest.mark.parametrize("min_size", [None, 1], ids=["projections", "every_leaf"])
@pytest.mark.parametrize("name", ARCHS)
def test_int8_model_matches_jax(monkeypatch, name, min_size):
    """forward, prefill + decode_step over the dense cache and decode_chunk
    (a pack of two first chunks, one ragged, then a decode sweep) of the
    port's model on the int8 tree against the JAX model on its dequantized
    fp32 tree. ``every_leaf`` quantizes every >= 2-D leaf (norms, router,
    conv, biases, SSM scalars), as the reference's threshold does at full
    depth."""
    jmodel, jp, model, tq = _models(name, min_size, monkeypatch)
    got = set(_quantized_paths(tq))
    assert got >= QUANTIZED[name] | (EVERY_LEAF[name] if min_size else set())
    B, S, gen = 2, 20, 3
    toks = np.random.default_rng(1).integers(0, 256, (B, S + gen)).astype(np.int32)
    jl, _ = jmodel.forward(jp, {"tokens": jnp.asarray(toks)}, JCTX)
    tl, _ = model.forward(tq, {"tokens": _t(toks)}, CTX)
    assert tl.shape == (B, S + gen, 256) and torch.isfinite(tl).all()
    assert _err(tl, jl) < LOGIT_TOL
    jd = jmodel.init_cache(B, S + gen, jnp.float32, kind="dense")
    td = model.init_cache(B, S + gen, device="cpu")
    jlg, jd = jmodel.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])}, jd, JCTX)
    tlg, td = model.prefill(tq, {"tokens": _t(toks[:, :S])}, td, CTX)
    assert _err(tlg, jlg) < LOGIT_TOL
    for i in range(gen):
        pos = np.full((B,), S + i, np.int32)
        tok = toks[:, S + i:S + i + 1]
        jlg, jd = jmodel.decode_step(jp, jnp.asarray(tok), jd, jnp.asarray(pos), JCTX)
        tlg, td = model.decode_step(tq, _t(tok), td, _t(pos), CTX)
        assert _err(tlg, jlg) < LOGIT_TOL, i
    ps, maxp = 4, 6
    pt = np.array([[1 + b * maxp + i for i in range(maxp)] for b in range(B)], np.int32)
    jc = jmodel.init_cache(B, S + gen, jnp.float32, kind="paged", page_size=ps,
                           num_pages=B * maxp + 1)
    tc = model.init_cache(B, S + gen, kind="paged", page_size=ps, num_pages=B * maxp + 1,
                          device="cpu")
    nv = np.array([S, S - 7], np.int32)
    calls = [(toks[:, :S], np.zeros(B, np.int32), nv, np.ones(B, bool)),
             (toks[np.arange(B), nv][:, None], nv, np.ones(B, np.int32), np.zeros(B, bool))]
    for tok, st, n, first in calls:
        slots = np.arange(B, dtype=np.int32)
        jlg, jc = jmodel.decode_chunk(jp, jnp.asarray(tok), jc, jnp.asarray(st), jnp.asarray(n),
                                      jnp.asarray(slots), jnp.asarray(first), JCTX,
                                      jnp.asarray(pt))
        tlg, tc = model.decode_chunk(tq, _t(tok), tc, _t(st), _t(n), _t(slots), _t(first), CTX,
                                     _t(pt))
        assert _err(tlg, jlg) < LOGIT_TOL


def test_int8_engine_matches_jax():
    """The port's engine on the int8 tiny mixtral gives the JAX engine's
    greedy streams on the dequantized tree, through a preemption."""
    jmodel, jp, model, tq = _models("mixtral-8x7b")
    kw = dict(max_slots=3, page_size=8, num_pages=10, max_seq=64, prefill_chunk=16,
              greedy=True)
    je = JaxInferenceEngine(jmodel, jp, JaxEngineConfig(**kw))
    te = InferenceEngine(model, tq, EngineConfig(device="cpu", **kw))
    r = np.random.default_rng(0)
    prompts = [r.integers(1, 256, 10).astype(np.int32) for _ in range(5)]
    jr = [JaxRequest(req_id=f"r{i}", prompt_tokens=p, max_new_tokens=20)
          for i, p in enumerate(prompts)]
    tr = [Request(req_id=f"r{i}", prompt_tokens=p, max_new_tokens=20)
          for i, p in enumerate(prompts)]
    je.generate(jr)
    te.generate(tr)
    te.allocator.check_invariants()
    assert te.scheduler.n_preemptions == je.scheduler.n_preemptions > 0
    for a, b in zip(jr, tr):
        assert b.finished and len(b.generated) == 20
        assert b.generated == a.generated, b.req_id


def test_cuda_wrapper_rejects_cpu_tensors():
    """The kernel wrapper never computes on the CPU: it raises before it
    loads or builds anything."""
    with pytest.raises(ValueError, match="CUDA"):
        w8a16_matmul_cuda(torch.zeros((4, 8)), torch.zeros((8, 16), dtype=torch.int8))


# mixtral-8x7b's w8a16 shapes (K, N, k-major): wq / wo, wk / wv, the n-major
# lm_head, and the tied head read through the embedding's transpose
# (qwen2.5-3b's vocab at mixtral's width)
PLAN_SHAPES = {"wq": (4096, 4096, False), "wk": (4096, 1024, False),
               "head": (4096, 32000, False), "tied_head": (4096, 151936, True)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("M", [1, 4, 16, 17, 256])
@pytest.mark.parametrize("shape", list(PLAN_SHAPES))
def test_w8a16_plan(shape, M, dtype):
    """The kernel and grid the wrapper picks, on an H100's 132 SMs: M <= 16
    streams (n- or k-major by the weight's strides), above it bf16 takes
    the tensor cores and fp32 the tiled kernel; the split ranges cover K
    once (and, streaming, each fits the staging buffer); the grid covers
    the output, stays within CUDA's limits and, at decode, runs >= 2
    blocks a SM and no more than one wave of resident blocks unless the
    staging or that minimum needs more."""
    K, N, k_major = PLAN_SHAPES[shape]
    plan = _plan(M, K, N, dtype, k_major, 132)
    assert all(1 <= g <= lim for g, lim in zip(plan.grid, GRID_LIMITS))
    if M > 16 and dtype == torch.float32:
        assert plan.path == "tiled" and plan.splits == 1
        assert plan.grid == (-(-N // TILED_TILE[1]), -(-M // TILED_TILE[0]), 1)
        return
    if M > 16:
        # tensor cores: K split only while the tiles leave SMs idle
        nb, mb, splits = plan.grid
        assert plan.path == "mma" and splits == plan.splits
        assert (nb, mb) == (-(-N // MMA_TILE[1]), -(-M // MMA_TILE[0]))
        assert splits == 1 or (nb * mb * splits <= 132 and K // splits >= 256)
    else:
        assert plan.path == ("stream_k" if k_major else "stream_n")
        nb, splits, mb = plan.grid
        assert splits == plan.splits and mb * plan.rows >= M and (mb - 1) * plan.rows < M
        assert nb * (KMAJOR_BLOCK_N if k_major else STREAM_BLOCK_N) >= N
        assert nb * splits * mb >= 2 * 132
        fit = -(-(-(-K // 16)) // (XS_FLOATS // (plan.rows * 16)))   # x's staging needs
        if splits > max(fit, -(-2 * 132 // (nb * mb))):
            assert nb * splits * mb <= RESIDENT[plan.path] * 132
        assert max(b - a for a, b in split_ranges(K, splits)) * plan.rows <= XS_FLOATS
    ranges = split_ranges(K, splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    assert all(a < b for a, b in ranges) and all(
        ranges[i][1] == ranges[i + 1][0] for i in range(splits - 1))


def test_w8a16_k_major_test():
    """The transposed tied embedding is k-major; a projection and its
    contiguous copy are not."""
    q = torch.zeros((64, 32), dtype=torch.int8)
    assert is_k_major(q.T) and not is_k_major(q) and not is_k_major(q.T.contiguous())
