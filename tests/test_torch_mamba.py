"""Port's SSM and hybrid families vs the JAX package on the same weights:
``mamba_sublayer`` in every mode (train, prefill, decode, and the serving
chunk with slots / first / ragged nvalid, multi-token and one-token), then
tiny mamba2 (SSD only) and tiny jamba (mamba + attention, MoE on every other
layer) through ``forward``, ``prefill`` + ``decode_step`` and
``decode_chunk``, each within LOGIT_ATOL; prefill + decode == forward on the
port; and the SSM parameter tree, init and counts."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import tiny_config as jax_tiny_config
from repro.models import RunCtx as JaxRunCtx
from repro.models import build_model as jax_build_model
from repro.models.mamba import mamba_sublayer as jax_mamba_sublayer
from repro_torch.configs import get_config, tiny_config
from repro_torch.models import RunCtx, build_model
from repro_torch.models.mamba import mamba_sublayer
from repro_torch.models.params import count_params_analytic, init_params, params_from_numpy

# fp32 on both sides; the differences are reduction order only (the
# reference's chunked-vs-dense bound, tests/test_chunked_prefill.py:20)
LOGIT_ATOL = 2e-3
SUB_TOL = 1e-4      # one sublayer: tests/test_mamba.py's bound
ARCHS = ["mamba2-1.3b", "jamba-v0.1-52b"]
JCTX = JaxRunCtx(attn_backend="xla", moe_strategy="dropless", block_q=8, block_kv=8)
CTX = RunCtx()


def _t(a):
    return torch.from_numpy(np.array(a))


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    jmodel = jax_build_model(jax_tiny_config(request.param))
    jp = jmodel.init_params(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jmodel, jp, build_model(tiny_config(request.param)), tp


# ---------------------------------------------------------------- sublayer
def _sublayer_case(mode):
    """h, the layer's cache (or None) and the chunk pack for one mode."""
    cfg = tiny_config("mamba2-1.3b")
    ssm = cfg.ssm
    r = np.random.default_rng(len(mode))
    S = {"train": 21, "prefill": 21, "decode": 1, "chunk": 12, "chunk1": 1}[mode]
    B = 3
    rows = 4 if mode.startswith("chunk") else B          # slot pool vs batch rows
    h = r.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    cache = None
    if mode != "train":
        conv_dim = cfg.d_inner + 2 * ssm.n_groups * ssm.d_state
        cache = {"state": r.standard_normal((rows, cfg.ssm_heads, ssm.head_dim, ssm.d_state)),
                 "conv": r.standard_normal((rows, conv_dim, ssm.d_conv - 1))}
        cache = {k: v.astype(np.float32) for k, v in cache.items()}
    chunk = None
    if mode.startswith("chunk"):
        chunk = {"slots": np.asarray([2, 0, 3], np.int32),
                 "nvalid": np.asarray([7, S, 0] if S > 1 else [1, 1, 0], np.int32),
                 "first": np.asarray([True, False, False])}
    return cfg, h, cache, chunk


@pytest.mark.parametrize("mode", ["train", "prefill", "decode", "chunk", "chunk1"])
def test_mamba_sublayer_matches_jax(mode):
    """Outputs at every live position and the cache afterwards (the port
    writes it in place; the reference returns a new one). In chunk mode
    row 0 starts its sequence (``first``), row 1 continues from its slot's
    state, row 2 is a padding row whose slot must keep its state."""
    cfg, h, cache, chunk = _sublayer_case(mode)
    jcfg = jax_tiny_config("mamba2-1.3b")
    jp = jax_build_model(jcfg).init_params(jax.random.PRNGKey(1))
    jlayer = jax.tree.map(lambda a: a[0], jp["groups"][0]["layers"][0]["ssm"])
    tlayer = params_from_numpy(jax.tree.map(np.asarray, jlayer), device="cpu")
    jctx = JCTX.with_mode("chunk" if mode.startswith("chunk") else mode)
    ctx = CTX.with_mode("chunk" if mode.startswith("chunk") else mode)
    jcache = None if cache is None else {k: jnp.asarray(v) for k, v in cache.items()}
    jchunk = None if chunk is None else {k: jnp.asarray(v) for k, v in chunk.items()}
    ref, jnew = jax_mamba_sublayer(jlayer, jnp.asarray(h), jcfg, jctx, cache=jcache,
                                   chunk=jchunk)
    tcache = None if cache is None else {k: _t(v) for k, v in cache.items()}
    tchunk = None if chunk is None else {k: _t(v) for k, v in chunk.items()}
    out = mamba_sublayer(tlayer, _t(h), cfg, ctx, tcache, tchunk)
    assert out.shape == h.shape
    if chunk is None:
        assert _err(out, ref) < SUB_TOL
    else:
        for b, n in enumerate(chunk["nvalid"][:2]):       # row 2 has no live token
            assert _err(out[b, :n], np.asarray(ref)[b, :n]) < SUB_TOL, b
    if cache is not None:
        for k in ("state", "conv"):
            assert _err(tcache[k], jnew[k]) < SUB_TOL, k
    if chunk is not None:                                 # the padding row's slot 3
        for k in ("state", "conv"):
            np.testing.assert_array_equal(tcache[k][3].numpy(), cache[k][3])


# ---------------------------------------------------------------- model paths
def test_generation_path_matches_jax(models):
    """forward at every position, prefill's last logits, then decode_step
    over the dense cache, each against the JAX function."""
    jmodel, jp, model, tp = models
    B, S, gen = 2, 37, 4          # 37: a ragged tail after two SSD chunks of 16
    toks = np.random.default_rng(1).integers(0, 256, (B, S + gen)).astype(np.int32)
    jl, _ = jmodel.forward(jp, {"tokens": jnp.asarray(toks)}, JCTX)
    tl, _ = model.forward(tp, {"tokens": _t(toks)}, CTX)
    assert tl.shape == (B, S + gen, 256) and torch.isfinite(tl).all()
    assert _err(tl, jl) < LOGIT_ATOL
    jd = jmodel.init_cache(B, S + gen, jnp.float32, kind="dense")
    td = model.init_cache(B, S + gen, device="cpu")
    jlg, jd = jmodel.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])}, jd, JCTX)
    tlg, td = model.prefill(tp, {"tokens": _t(toks[:, :S])}, td, CTX)
    assert _err(tlg, jlg) < LOGIT_ATOL
    for i in range(gen):
        pos = np.full((B,), S + i, np.int32)
        tok = toks[:, S + i:S + i + 1]
        jlg, jd = jmodel.decode_step(jp, jnp.asarray(tok), jd, jnp.asarray(pos), JCTX)
        tlg, td = model.decode_step(tp, _t(tok), td, _t(pos), CTX)
        assert _err(tlg, jlg) < LOGIT_ATOL, i


def test_prefill_decode_matches_forward(models):
    """tests/test_prefill_decode.py:18-45 on the port's SSM and hybrid
    models."""
    _, _, model, tp = models
    B, S, gen = 2, 20, 6
    toks = _t(np.random.default_rng(2).integers(0, 256, (B, S + gen)).astype(np.int32))
    full, _ = model.forward(tp, {"tokens": toks}, CTX)
    cache = model.init_cache(B, S + gen, device="cpu")
    lg, cache = model.prefill(tp, {"tokens": toks[:, :S]}, cache, CTX)
    errs = [_err(lg, full[:, S - 1])]
    for i in range(gen):
        pos = torch.full((B,), S + i, dtype=torch.int32)
        lg, cache = model.decode_step(tp, toks[:, S + i:S + i + 1], cache, pos, CTX)
        errs.append(_err(lg, full[:, S + i]))
    assert max(errs) < LOGIT_ATOL, errs


def _packs():
    """(tokens, starts, nvalid, slots, first) per call, as the engine packs
    them: prompts of 11 / 5 / 9 tokens on slots 2 / 0 / 1, prefill chunks of
    8 over 3 rows (padding rows on spare slots, one of them a running slot),
    then a decode sweep over the 4 slots (slot 3 idle)."""
    r = np.random.default_rng(4)
    prompts = {2: r.integers(1, 256, 11), 0: r.integers(1, 256, 5), 1: r.integers(1, 256, 9)}
    fed = {0: 0, 1: 0, 2: 0}
    packs = []
    for grant in ([(2, 8), (0, 5), (3, 0)], [(2, 3), (1, 8), (0, 0)], [(1, 1), (3, 0), (0, 0)]):
        tok = np.zeros((3, 8), np.int32)
        st, nv, sl = (np.zeros(3, np.int32) for _ in range(3))
        fi = np.zeros(3, bool)
        for i, (s, n) in enumerate(grant):
            sl[i], nv[i] = s, n
            if n:
                tok[i, :n] = prompts[s][fed[s]:fed[s] + n]
                st[i], fi[i] = fed[s], fed[s] == 0
                fed[s] += n
        packs.append((tok, st, nv, sl, fi))
    packs.append((np.asarray([[7], [9], [11], [0]], np.int32),
                  np.asarray([fed[0], fed[1], fed[2], 0], np.int32),
                  np.asarray([1, 1, 1, 0], np.int32), np.arange(4, dtype=np.int32),
                  np.zeros(4, bool)))
    return packs


def test_decode_chunk_matches_jax(models):
    """Logits of every live row, then the SSM states and KV pools, against
    the JAX ``decode_chunk`` over the same packs."""
    jmodel, jp, model, tp = models
    ps, maxp, num_pages = 4, 4, 17
    slot_pages = np.array([[1 + s * maxp + i for i in range(maxp)] for s in range(4)], np.int32)
    jcache = jmodel.init_cache(4, 16, jnp.float32, kind="paged", page_size=ps,
                               num_pages=num_pages)
    tcache = model.init_cache(4, 16, kind="paged", page_size=ps, num_pages=num_pages,
                              device="cpu")
    for tok, st, nv, sl, fi in _packs():
        pt = np.where(nv[:, None] > 0, slot_pages[sl], 0).astype(np.int32)
        jlg, jcache = jmodel.decode_chunk(
            jp, jnp.asarray(tok), jcache, jnp.asarray(st), jnp.asarray(nv), jnp.asarray(sl),
            jnp.asarray(fi), JCTX, jnp.asarray(pt))
        tlg, tcache = model.decode_chunk(tp, _t(tok), tcache, _t(st), _t(nv), _t(sl), _t(fi),
                                         CTX, _t(pt))
        live = nv > 0
        assert torch.isfinite(tlg).all()
        assert _err(tlg.numpy()[live], np.asarray(jlg)[live]) < LOGIT_ATOL
    for jg, tg in zip(jcache["groups"], tcache["groups"]):
        for jc, tc in zip(jg, tg):
            for part, leaves in tc.items():
                for k, v in leaves.items():
                    ref = np.asarray(jc[part][k])
                    if k in ("kp", "vp"):                  # page 0 is the null page
                        v, ref = v[:, 1:], ref[:, 1:]
                    assert _err(v, ref) < SUB_TOL, (part, k)


# ---------------------------------------------------------------- params
@pytest.mark.parametrize("name", ARCHS)
def test_ssm_params_follow_reference(name):
    """The bridge carries every SSM leaf across unchanged; the seeded init
    has the reference's tree, shapes and SSM distributions; the full
    configs count the reference's parameters (mamba2 1.34B, jamba 51.5B)."""
    cfg = tiny_config(name)
    jp = jax_build_model(jax_tiny_config(name)).init_params(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jl, jdef = jax.tree.flatten(jp)
    tl, tdef = jax.tree.flatten(tp)
    assert jdef == tdef
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    ours = init_params(cfg, 3, device="cpu")
    assert jax.tree.structure(jax.tree.map(np.asarray, jp)) == jax.tree.structure(ours)
    for a, b in zip(jl, jax.tree.leaves(ours)):
        assert tuple(a.shape) == tuple(b.shape)
    ssm = ours["groups"][0]["layers"][0]["ssm"]
    A = torch.exp(ssm["A_log"])
    assert (A >= 1).all() and (A <= 16).all()
    dt = torch.nn.functional.softplus(ssm["dt_bias"])
    assert (dt >= 1e-3 - 1e-6).all() and (dt <= 1e-1 + 1e-6).all()
    assert (ssm["D"] == 1).all() and (ssm["conv_b"] == 0).all()
    assert count_params_analytic(cfg) == sum(int(np.prod(a.shape)) for a in jl)
    full, jfull = get_config(name), jax_get_config(name)
    assert full.param_count() == jfull.param_count()
    assert full.active_param_count() == jfull.active_param_count()
