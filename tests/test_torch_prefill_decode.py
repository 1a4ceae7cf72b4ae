"""Port's generation path (``LM.forward``, ``prefill``, ``decode_step`` over
dense ring and paged caches) vs the JAX package on the same weights, on tiny
mixtral (MoE), qwen2.5 (dense, QKV bias), gemma2 (alternating sliding
window / global layers, softcaps, tied scaled embeddings), yi, phi3-mini,
dbrx, deepseek-moe, seamless-m4t (frames through the encoder, cross
attention over the cross cache) and phi-3-vision (a patch prefix, positions
offset by it), as tests/test_prefill_decode.py builds their batches; then the serving
invariants of tests/test_prefill_decode.py run on the port: prefill + decode
== forward, paged == dense decode, and gemma2's ring buffer with W <
context == forward."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import tiny_config as jax_tiny_config
from repro.models import RunCtx as JaxRunCtx
from repro.models import build_model as jax_build_model
from repro_torch.configs import tiny_config
from repro_torch.models import RunCtx, build_model
from repro_torch.models.params import params_from_numpy

# attention and softmax in fp32 on both sides; the differences are
# reduction order only (tests/test_prefill_decode.py's bound)
LOGIT_ATOL = 2e-3
ARCHS = ["mixtral-8x7b", "qwen2.5-3b", "gemma2-27b", "yi-6b", "phi3-mini-3.8b", "dbrx-132b",
         "deepseek-moe-16b", "seamless-m4t-large-v2", "phi-3-vision-4.2b"]
JCTX = JaxRunCtx(attn_backend="xla", moe_strategy="dropless", block_q=8, block_kv=8)
CTX = RunCtx()


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _models(name, seed=0, **kw):
    jmodel = jax_build_model(jax_tiny_config(name, **kw))
    jp = jmodel.init_params(jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jmodel, jp, build_model(tiny_config(name, **kw)), tp


def _batch(cfg, toks, r):
    """tests/test_prefill_decode.py:26-32: the tokens, 12 frames for an
    enc-dec config, n_patches patches for a VLM (drawn after the tokens).
    Returns (numpy batch, the text offset, the cross memory length)."""
    batch = {"tokens": toks}
    if cfg.encoder is not None:
        batch["frames"] = r.standard_normal((toks.shape[0], 12, cfg.d_model)).astype(np.float32)
    if cfg.vision is not None:
        batch["patches"] = r.standard_normal(
            (toks.shape[0], cfg.vision.n_patches, cfg.vision.d_patch)).astype(np.float32)
    offset = cfg.vision.n_patches if cfg.vision is not None else 0
    return batch, offset, 12 if cfg.encoder is not None else 0


def _prefix(batch, S):
    """The batch with its first S tokens (frames and patches whole)."""
    return dict(batch, tokens=batch["tokens"][:, :S])


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


def _page_table(B, maxp):
    return np.array([[1 + b * maxp + i for i in range(maxp)] for b in range(B)], np.int32)


def _fill_pool_from_ring(paged, dense, pt):
    """Copy every position the rings hold into its row's page and slot, as
    tests/test_prefill_decode.py:61-73 does (a local layer's ring holds only
    the last W positions, all that its window can see)."""
    for pg, dg in zip(paged["groups"], dense["groups"]):
        for pc, dc in zip(pg, dg):
            slot_pos = dc["attn"]["slot_pos"][0]                      # (B, W)
            ps = pc["attn"]["kp"].shape[2]
            for pool, ring in (("kp", "k"), ("vp", "v")):
                for b, row in enumerate(slot_pos.tolist()):
                    for w, pos in enumerate(row):
                        if pos >= 0:
                            pc["attn"][pool][:, pt[b, pos // ps], pos % ps] = (
                                dc["attn"][ring][:, b, w])


@pytest.mark.parametrize("name", ARCHS)
def test_generation_path_matches_jax(name):
    """forward at every position, prefill's last logits, then decode_step
    over the dense ring and over the paged pool, each against the JAX
    function on the same weights and tokens."""
    jmodel, jp, model, tp = _models(name)
    B, S, gen, ps = 2, 20, 4, 4
    r = np.random.default_rng(1)
    toks = r.integers(0, 256, (B, S + gen)).astype(np.int32)
    batch, offset, mem = _batch(model.cfg, toks, r)
    jl, jaux = jmodel.forward(jp, {k: jnp.asarray(v) for k, v in batch.items()}, JCTX)
    tl, taux = model.forward(tp, {k: _t(v) for k, v in batch.items()}, CTX)
    assert tl.shape == (B, S + gen + offset, model.cfg.vocab) and torch.isfinite(tl).all()
    assert _err(tl, jl) < LOGIT_ATOL
    assert abs(float(taux) - float(jaux)) < 1e-4

    L = S + gen + offset
    maxp = (L + ps - 1) // ps
    pt = _page_table(B, maxp)
    jd = jmodel.init_cache(B, L, jnp.float32, kind="dense", memory_len=mem)
    td = model.init_cache(B, L, memory_len=mem, device="cpu")
    jpg = jmodel.init_cache(B, L, jnp.float32, kind="paged", page_size=ps,
                            num_pages=B * maxp + 1, memory_len=mem)
    tpg = model.init_cache(B, L, kind="paged", page_size=ps, num_pages=B * maxp + 1,
                           memory_len=mem, device="cpu")
    jlg, jd = jmodel.prefill(jp, {k: jnp.asarray(v) for k, v in _prefix(batch, S).items()}, jd,
                             JCTX)
    tlg, td = model.prefill(tp, {k: _t(v) for k, v in _prefix(batch, S).items()}, td, CTX)
    assert _err(tlg, jlg) < LOGIT_ATOL
    # both pools (and cross caches) start from the prompt's KV as the port's
    # rings (and dense cross cache) hold it
    _fill_pool_from_ring(tpg, td, pt)
    for jg, tg, dg in zip(jpg["groups"], tpg["groups"], td["groups"]):
        for jc, tc, dc in zip(jg, tg, dg):
            for pool in ("kp", "vp"):
                jc["attn"][pool] = jnp.asarray(tc["attn"][pool].numpy())
            for k in ("ck", "cv") if "cross" in dc else ():
                tc["cross"][k].copy_(dc["cross"][k])
                jc["cross"][k] = jnp.asarray(dc["cross"][k].numpy())
    for i in range(gen):
        pos = np.full((B,), S + i + offset, np.int32)
        tok = toks[:, S + i:S + i + 1]
        jl_d, jd = jmodel.decode_step(jp, jnp.asarray(tok), jd, jnp.asarray(pos), JCTX)
        tl_d, td = model.decode_step(tp, _t(tok), td, _t(pos), CTX)
        jl_p, jpg = jmodel.decode_step(jp, jnp.asarray(tok), jpg, jnp.asarray(pos), JCTX,
                                       page_table=jnp.asarray(pt), lengths=jnp.asarray(pos + 1))
        tl_p, tpg = model.decode_step(tp, _t(tok), tpg, _t(pos), CTX, page_table=_t(pt),
                                      lengths=_t(pos + 1))
        assert _err(tl_d, jl_d) < LOGIT_ATOL, i
        assert _err(tl_p, jl_p) < LOGIT_ATOL, i


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_decode_matches_forward(name):
    """tests/test_prefill_decode.py:18-45 on the port."""
    _, _, model, tp = _models(name)
    B, S, gen = 2, 20, 6
    r = np.random.default_rng(1)
    batch, offset, mem = _batch(model.cfg, r.integers(0, 256, (B, S + gen)).astype(np.int32), r)
    batch = {k: _t(v) for k, v in batch.items()}
    toks = batch["tokens"]
    full, _ = model.forward(tp, batch, CTX)
    cache = model.init_cache(B, S + gen + offset, memory_len=mem, device="cpu")
    lg, cache = model.prefill(tp, _prefix(batch, S), cache, CTX)
    errs = [_err(lg, full[:, S - 1 + offset])]
    for i in range(gen):
        pos = torch.full((B,), S + i + offset, dtype=torch.int32)
        lg, cache = model.decode_step(tp, toks[:, S + i:S + i + 1], cache, pos, CTX)
        errs.append(_err(lg, full[:, S + i + offset]))
    assert max(errs) < LOGIT_ATOL, errs


def test_prefill_last_pos_of_right_padded_prompts():
    """Right-padded prompts with last_pos = length - 1 give each prompt's own
    last logits (causal: padding after a position never reaches it)."""
    _, _, model, tp = _models("qwen2.5-3b")
    r = np.random.default_rng(2)
    lens = [7, 12]
    toks = np.zeros((2, 12), np.int32)
    for b, n in enumerate(lens):
        toks[b, :n] = r.integers(1, 256, n)
    cache = model.init_cache(2, 16, device="cpu")
    lg, _ = model.prefill(tp, {"tokens": _t(toks)}, cache, CTX,
                          last_pos=_t(np.asarray(lens) - 1))
    for b, n in enumerate(lens):
        one = model.init_cache(1, 16, device="cpu")
        ref, _ = model.prefill(tp, {"tokens": _t(toks[b:b + 1, :n])}, one, CTX)
        assert _err(lg[b:b + 1], ref) < 1e-4


def test_paged_equals_dense_decode():
    """tests/test_prefill_decode.py:48-81 on the port: the pool filled from
    the ring, then decode over each cache agrees within 1e-4."""
    _, _, model, tp = _models("qwen2.5-3b", seed=1)
    B, S, gen, W, ps = 2, 24, 6, 32, 8
    toks = _t(np.random.default_rng(1).integers(0, 256, (B, S + gen)).astype(np.int32))
    dense = model.init_cache(B, W, device="cpu")
    _, dense = model.prefill(tp, {"tokens": toks[:, :S]}, dense, CTX)
    maxp = W // ps
    pt = np.array([[b * maxp + i for i in range(maxp)] for b in range(B)], np.int32)
    paged = model.init_cache(B, W, kind="paged", page_size=ps, num_pages=B * maxp + 1,
                             device="cpu")
    _fill_pool_from_ring(paged, dense, pt)
    errs = []
    for i in range(gen):
        pos = torch.full((B,), S + i, dtype=torch.int32)
        ld, dense = model.decode_step(tp, toks[:, S + i:S + i + 1], dense, pos, CTX)
        lp, paged = model.decode_step(tp, toks[:, S + i:S + i + 1], paged, pos, CTX,
                                      page_table=_t(pt), lengths=pos + 1)
        errs.append(_err(ld, lp))
    assert max(errs) < 1e-4, errs


@pytest.mark.parametrize("prompt", [1, 24])
def test_sliding_window_ring_buffer_decode(prompt):
    """tests/test_prefill_decode.py:84-103 on the port: gemma2's local
    layers hold a ring of W = 16 < context; decoding token by token after a
    prompt of 1 token (the reference's case) or of 24 > W tokens (the ring
    keeps the last W) matches the full forward."""
    _, _, model, tp = _models("gemma2-27b", seed=2, seq_len=64)
    assert 0 < model.cfg.sliding_window < 24
    B, S = 1, 40
    toks = _t(np.random.default_rng(3).integers(0, 256, (B, S)).astype(np.int32))
    full, _ = model.forward(tp, {"tokens": toks}, CTX)
    cache = model.init_cache(B, S, device="cpu")
    ring = cache["groups"][0][0]["attn"]["k"]                 # the first "L" layer
    assert ring.shape[2] == model.cfg.sliding_window
    lg, cache = model.prefill(tp, {"tokens": toks[:, :prompt]}, cache, CTX)
    errs = [_err(lg, full[:, prompt - 1])]
    for i in range(prompt, S):
        pos = torch.full((B,), i, dtype=torch.int32)
        lg, cache = model.decode_step(tp, toks[:, i:i + 1], cache, pos, CTX)
        errs.append(_err(lg, full[:, i]))
    assert max(errs) < LOGIT_ATOL, max(errs)


def test_cache_kinds():
    model = build_model(tiny_config("gemma2-27b"))
    d = model.init_cache(3, 40, torch.bfloat16, device="cpu")
    (loc, glob), = d["groups"]
    assert loc["attn"]["k"].shape == (2, 3, 16, 2, 16) and loc["attn"]["k"].dtype == torch.bfloat16
    assert glob["attn"]["v"].shape == (2, 3, 40, 2, 16)
    assert (glob["attn"]["slot_pos"] == -1).all()
    p = model.init_cache(3, 40, kind="paged", page_size=8, num_pages=11, device="cpu")
    assert p["groups"][0][1]["attn"]["kp"].shape == (2, 11, 8, 2, 16)
    with pytest.raises(ValueError, match="kind"):
        model.init_cache(3, 40, kind="ring", device="cpu")
