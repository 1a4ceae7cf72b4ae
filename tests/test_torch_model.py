"""Port's model path vs the JAX package on the same weights: primitives,
the weight bridge, the seeded init, and ``LM.decode_chunk`` logits on tiny
mixtral (MoE), qwen2.5 (dense, QKV bias), yi (dense GQA), phi3-mini (dense
MHA), dbrx (16 experts top-4) and deepseek-moe (a dense first layer, shared
experts), seamless-m4t (enc-dec) and phi-3-vision (VLM) over ragged
multi-row prefill packs with padding rows and a decode sweep after them,
and with ``all_logits`` over a speculative verify sweep; packs with a first
chunk carry the enc-dec frames or the VLM patches."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import tiny_config as jax_tiny_config
from repro.models import RunCtx as JaxRunCtx
from repro.models import build_model as jax_build_model
from repro.models import common as jax_common
from repro_torch.configs import get_config, tiny_config
from repro_torch.models import RunCtx, build_model, common
from repro_torch.models.params import count_params_analytic, init_params, params_from_numpy

# as tests/test_chunked_prefill.py: attention and softmax in f32 on both
# sides; the differences are reduction order only
LOGIT_ATOL = 2e-3
PRIM_TOL = 1e-5
ARCHS = ["mixtral-8x7b", "qwen2.5-3b", "yi-6b", "phi3-mini-3.8b", "dbrx-132b",
         "deepseek-moe-16b", "seamless-m4t-large-v2", "phi-3-vision-4.2b"]


def _jax_model(name):
    model = jax_build_model(jax_tiny_config(name))
    return model, model.init_params(jax.random.PRNGKey(0))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _extras(cfg, first, seed=5):
    """A pack's frames (B, cross_attn_memory, d) for an enc-dec config and
    patches (B, n_patches, d_patch) for a VLM, when a row carries a first
    chunk (as the engine passes them); {} otherwise. Returns the JAX and
    the torch keyword arguments."""
    if not np.asarray(first).any():
        return {}, {}
    r = np.random.default_rng(seed)
    B, ext = len(first), {}
    if cfg.encoder is not None:
        ext["frames"] = r.standard_normal((B, cfg.encoder.cross_attn_memory, cfg.d_model))
    if cfg.vision is not None:
        ext["patches"] = r.standard_normal((B, cfg.vision.n_patches, cfg.vision.d_patch))
    ext = {k: v.astype(np.float32) for k, v in ext.items()}
    return {k: jnp.asarray(v) for k, v in ext.items()}, {k: _t(v) for k, v in ext.items()}


# ---------------------------------------------------------------- primitives
def test_rmsnorm():
    r = np.random.default_rng(0)
    x = r.standard_normal((2, 5, 64)).astype(np.float32)
    w = r.standard_normal(64).astype(np.float32)
    ref = jax_common.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    np.testing.assert_allclose(common.rmsnorm(_t(x), _t(w), 1e-6).numpy(), np.asarray(ref),
                               atol=PRIM_TOL, rtol=PRIM_TOL)


@pytest.mark.parametrize("batched", [False, True])
def test_rope(batched):
    r = np.random.default_rng(1)
    x = r.standard_normal((2, 6, 4, 16)).astype(np.float32)
    pos = (r.integers(0, 500, (2, 6)) if batched else np.arange(3, 9)).astype(np.int32)
    ref = jax_common.rope(jnp.asarray(x), jnp.asarray(pos), 1_000_000.0)
    np.testing.assert_allclose(common.rope(_t(x), _t(pos), 1_000_000.0).numpy(),
                               np.asarray(ref), atol=PRIM_TOL, rtol=PRIM_TOL)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_dense_mlp(act):
    r = np.random.default_rng(2)
    x = r.standard_normal((2, 3, 16)).astype(np.float32)
    p = {k: (r.standard_normal(s) / 4).astype(np.float32)
         for k, s in (("wi", (16, 40)), ("wg", (16, 40)), ("wo", (40, 16)))}
    ref = jax_common.dense_mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), act)
    out = common.dense_mlp({k: _t(v) for k, v in p.items()}, _t(x), act)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=PRIM_TOL, rtol=PRIM_TOL)


# ---------------------------------------------------------------- params
@pytest.mark.parametrize("name", ARCHS)
def test_bridge_round_trip(name):
    """JAX init -> params_from_numpy: same tree, every leaf equal."""
    _, jp = _jax_model(name)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jl, jdef = jax.tree.flatten(jp)
    tl, tdef = jax.tree.flatten(tp)
    assert jdef == tdef
    for a, b in zip(jl, tl):
        assert b.dtype == torch.float32 and b.device.type == "cpu"
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    bf = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu", dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in jax.tree.leaves(bf))


@pytest.mark.parametrize("name", ARCHS)
def test_init_follows_reference(name):
    """Same tree and shapes as the JAX init, the reference's distributions,
    and the same numbers again when the seed is repeated."""
    cfg = tiny_config(name)
    _, jp = _jax_model(name)
    tp = init_params(cfg, 7, device="cpu")
    assert jax.tree.structure(jax.tree.map(np.asarray, jp)) == jax.tree.structure(tp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
        assert tuple(a.shape) == tuple(b.shape)
    assert (tp["final_norm"]["w"] == 1).all()
    assert abs(float(tp["embed"]["w"].std()) - 0.02) < 2e-3
    wq = tp["groups"][0]["layers"][0]["attn"]["wq"]
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    again = init_params(cfg, 7, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(again)))
    n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jp))
    assert count_params_analytic(cfg) == cfg.param_count() == n


def test_full_config_counts():
    """The port's full mixtral config is the reference's (46.7B params)."""
    from repro.configs import get_config as jax_get_config
    for name in ARCHS:
        assert get_config(name).param_count() == jax_get_config(name).param_count()
        assert (get_config(name).active_param_count()
                == jax_get_config(name).active_param_count())


# ---------------------------------------------------------------- decode_chunk
def _packs():
    """(tokens, starts, nvalid, page rows) per call: two ragged prefill packs
    over 3 rows (row 2 is padding in the first), then a decode sweep over 4
    slots (slot 3 idle)."""
    r = np.random.default_rng(4)
    prompts = [r.integers(1, 256, n) for n in (11, 5, 9)]
    packs = []
    C = 8
    fed = [0, 0, 0]
    for grant in ([8, 5, 0], [3, 0, 8]):
        tok = np.zeros((3, C), np.int32)
        st = np.zeros(3, np.int32)
        for b, n in enumerate(grant):
            tok[b, :n] = prompts[b][fed[b]:fed[b] + n]
            st[b] = fed[b] if n else 0
        packs.append((tok, st, np.asarray(grant, np.int32), [0, 1, 2]))
        fed = [f + n for f, n in zip(fed, grant)]
    dec = np.asarray([[7], [9], [11], [0]], np.int32)
    packs.append((dec, np.asarray(fed + [0], np.int32), np.asarray([1, 1, 1, 0], np.int32),
                  [0, 1, 2, None]))
    return packs


@pytest.mark.parametrize("name", ARCHS)
def test_decode_chunk_matches_jax(name):
    jmodel, jp = _jax_model(name)
    model = build_model(tiny_config(name))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    ps, num_pages, maxp = 4, 64, 8
    rows = np.array([[1 + b * maxp + i for i in range(maxp)] for b in range(3)], np.int32)
    jcache = jmodel.init_cache(4, 64, jnp.float32, kind="paged", page_size=ps,
                               num_pages=num_pages)
    tcache = model.init_cache(4, 64, kind="paged", page_size=ps, num_pages=num_pages,
                              device="cpu")
    jctx = JaxRunCtx(attn_backend="xla", moe_strategy="dropless")
    for tok, st, nv, row_ids in _packs():
        B = tok.shape[0]
        pt = np.stack([rows[i] if i is not None else np.zeros(maxp, np.int32)
                       for i in row_ids])
        jext, text = _extras(model.cfg, (st == 0) & (nv > 0))
        lg_ref, jcache = jmodel.decode_chunk(
            jp, jnp.asarray(tok), jcache, jnp.asarray(st), jnp.asarray(nv),
            jnp.arange(B, dtype=jnp.int32), jnp.asarray(st == 0), jctx, jnp.asarray(pt), **jext)
        lg, tcache = model.decode_chunk(tp, _t(tok), tcache, _t(st), _t(nv),
                                        _t(np.arange(B, dtype=np.int32)), _t(st == 0), RunCtx(),
                                        _t(pt), **text)
        live = nv > 0
        assert lg.shape == (B, model.cfg.vocab) and torch.isfinite(lg).all()
        err = np.abs(lg.numpy()[live] - np.asarray(lg_ref)[live]).max()
        assert err < LOGIT_ATOL, err
    # the pools agree too, page for page (page 0 is the null page)
    for jg, tg in zip(jcache["groups"], tcache["groups"]):
        for jc, tc in zip(jg, tg):
            for k in ("kp", "vp"):
                np.testing.assert_allclose(tc["attn"][k][:, 1:].numpy(),
                                           np.asarray(jc["attn"][k])[:, 1:], atol=1e-4)


@pytest.mark.parametrize("name", ARCHS + ["gemma2-27b"])
def test_decode_chunk_all_logits_matches_jax(name):
    """A ragged prefill pack, then a verify sweep at C = 5 over 4 slots whose
    rows feed 5, 2, 0 (inactive, null page) and 1 tokens: with
    ``all_logits`` the port's (B, C, vocab) logits are within LOGIT_ATOL of
    JAX's at every valid position, finite at every position, and the last
    valid position's row equals the default call's logits."""
    jmodel, jp = _jax_model(name)
    model = build_model(tiny_config(name))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    ps, num_pages, maxp, B, C = 4, 64, 8, 4, 5
    rows = np.array([[1 + b * maxp + i for i in range(maxp)] for b in range(B)], np.int32)
    r = np.random.default_rng(6)
    plens = [11, 6, 0, 9]
    pack = np.zeros((B, 11), np.int32)
    for b, n in enumerate(plens):
        pack[b, :n] = r.integers(1, 256, n)
    verify = r.integers(1, 256, (B, C)).astype(np.int32)
    nv_pack, nv_verify = np.asarray(plens, np.int32), np.asarray([5, 2, 0, 1], np.int32)
    st_verify = np.where(nv_verify > 0, nv_pack, 0).astype(np.int32)
    pt_verify = np.where((nv_verify > 0)[:, None], rows, 0).astype(np.int32)
    jcache = jmodel.init_cache(B, 64, jnp.float32, kind="paged", page_size=ps,
                               num_pages=num_pages)
    tcache = model.init_cache(B, 64, kind="paged", page_size=ps, num_pages=num_pages,
                              device="cpu")
    jctx = JaxRunCtx(attn_backend="xla", moe_strategy="dropless")
    slots, first = np.arange(B, dtype=np.int32), np.ones(B, bool)
    calls = [(pack, np.zeros(B, np.int32), nv_pack, first, rows, False),
             (verify, st_verify, nv_verify, ~first, pt_verify, True)]
    for tok, st, nv, fi, pt, all_logits in calls:
        jext, text = _extras(model.cfg, fi & (nv > 0))
        lg_ref, jcache = jmodel.decode_chunk(
            jp, jnp.asarray(tok), jcache, jnp.asarray(st), jnp.asarray(nv), jnp.asarray(slots),
            jnp.asarray(fi), jctx, jnp.asarray(pt), all_logits=all_logits, **jext)
        if all_logits:
            before = [t.clone() for g in tcache["groups"] for c in g for t in c["attn"].values()]
        lg, tcache = model.decode_chunk(tp, _t(tok), tcache, _t(st), _t(nv), _t(slots), _t(fi),
                                        RunCtx(), _t(pt), all_logits=all_logits, **text)
    assert lg.shape == (B, C, model.cfg.vocab) and torch.isfinite(lg).all()
    valid = np.arange(C)[None, :] < nv_verify[:, None]
    err = np.abs(lg.numpy()[valid] - np.asarray(lg_ref)[valid]).max()
    assert err < LOGIT_ATOL, err
    # the default call on the same pools (restored) gives the last valid row
    after = [t for g in tcache["groups"] for c in g for t in c["attn"].values()]
    for a, b in zip(after, before):
        a.copy_(b)
    last, _ = model.decode_chunk(tp, _t(verify), tcache, _t(st_verify), _t(nv_verify),
                                 _t(slots), _t(~first), RunCtx(), _t(pt_verify))
    for b in np.flatnonzero(nv_verify):
        torch.testing.assert_close(last[b], lg[b, nv_verify[b] - 1], atol=1e-5, rtol=0)
