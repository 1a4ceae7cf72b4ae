"""Port's enc-dec (seamless-m4t) and VLM (phi-3-vision) paths vs the JAX
package on the same weights and inputs, all in fp32 on the tiny configs:
the cross attention ("X") and encoder ("E") sublayers in every mode;
``forward`` over all 11 archs (tests/test_arch_smoke.py's batches);
``decode_chunk`` over a pack with a first chunk and frames / patches, a
pack that mixes one request's first chunk (patch prefix live) with another's
later chunk, a decode sweep and a verify sweep with ``all_logits``; the
engine's ``_row_extras`` (frames cropped and zero-padded to the cross
memory); and the engines' greedy streams over multi-chunk prompts, under
preemption and with speculation on, with the same ``extras``. Logits within
1e-4, caches within 1e-5, streams and counters equal."""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import tiny_config as jax_tiny_config
from repro.core.engine import EngineConfig as JaxEngineConfig
from repro.core.engine import InferenceEngine as JaxInferenceEngine
from repro.core.metrics import Request as JaxRequest
from repro.models import RunCtx as JaxRunCtx
from repro.models import build_model as jax_build_model
from repro.models.attention import attention_sublayer as jax_sublayer
from repro_torch.configs import ALL_ARCHS, tiny_config
from repro_torch.core import EngineConfig, InferenceEngine, Request
from repro_torch.models import RunCtx, build_model, transformer
from repro_torch.models.attention import attention_sublayer
from repro_torch.models.params import params_from_numpy

SEAMLESS, VISION = "seamless-m4t-large-v2", "phi-3-vision-4.2b"
LOGIT_ATOL = 1e-4        # fp32 on both sides: reduction order only
SUB_ATOL = 1e-5          # one sublayer's output and the caches it writes
JCTX = JaxRunCtx(attn_backend="xla", moe_strategy="dropless", block_q=8, block_kv=8)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _pair(name):
    jmodel = jax_build_model(jax_tiny_config(name))
    jp = jmodel.init_params(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jmodel, jp, build_model(tiny_config(name)), tp


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


# ---------------------------------------------------------------- sublayers
X_MODES = ["train", "prefill", "decode", "chunk_memory", "chunk_cache"]


@pytest.mark.parametrize("kind,mode", [*(("X", m) for m in X_MODES),
                                       ("E", "train"), ("E", "prefill"), ("E", "chunk")])
def test_sublayer_matches_jax(kind, mode):
    """One cross attention or encoder sublayer of tiny seamless: outputs at
    every live row and every cache it writes, against JAX's
    ``attention_sublayer``. chunk_memory: a pack with memory writes the
    keys and values at the slots of rows with a live token (slot 0's row
    feeds none and keeps its values); chunk_cache: a pack without memory
    reads the slots."""
    jmodel, jp, model, tp = _pair(SEAMLESS)
    jcfg, cfg = jmodel.cfg, model.cfg
    group = jp["groups"] if kind == "X" else jp["encoder"]["groups"]
    jlayer = jax.tree.map(lambda a: a[0], group[0]["layers"][0]["cross" if kind == "X" else "attn"])
    tlayer = params_from_numpy(jax.tree.map(np.asarray, jlayer), device="cpu")
    r = np.random.default_rng(len(mode) + (kind == "X"))
    Hkv, hd, d, M = cfg.n_kv_heads, cfg.head_dim, cfg.d_model, 7
    B, S = (3, 5) if mode.startswith("chunk") else ((2, 1) if mode == "decode" else (2, 6))
    h = r.standard_normal((B, S, d)).astype(np.float32)
    memory = r.standard_normal((B, M, d)).astype(np.float32)
    jmode = "chunk" if mode.startswith("chunk") else mode
    jargs, targs = {}, {}
    cache = None
    if kind == "E":
        pos = np.arange(S, dtype=np.int32)
        jargs["positions"], targs["positions"] = jnp.asarray(pos), _t(pos)
    elif mode == "prefill":
        cache = {"ck": np.zeros((B, M, Hkv, hd), np.float32),
                 "cv": np.zeros((B, M, Hkv, hd), np.float32)}
    elif mode == "decode":
        cache = {k: r.standard_normal((B, M, Hkv, hd)).astype(np.float32) for k in ("ck", "cv")}
    elif mode.startswith("chunk"):
        cache = {k: r.standard_normal((4, M, Hkv, hd)).astype(np.float32) for k in ("ck", "cv")}
        slots, nvalid = np.asarray([2, 0, 3], np.int32), np.asarray([5, 0, 3], np.int32)
        jargs["chunk"] = {"slots": jnp.asarray(slots), "nvalid": jnp.asarray(nvalid)}
        targs["chunk"] = {"slots": _t(slots), "nvalid": _t(nvalid)}
    if kind == "X" and mode != "decode" and mode != "chunk_cache":
        jargs["memory"], targs["memory"] = jnp.asarray(memory), _t(memory)
    if cache is not None:
        jargs["cache"] = {k: jnp.asarray(v) for k, v in cache.items()}
        targs["cache"] = {k: _t(v) for k, v in cache.items()}
    jout, jcache = jax_sublayer(jlayer, jnp.asarray(h), JCTX.with_mode(jmode), jcfg, kind,
                                **jargs)
    tout = attention_sublayer(tlayer, _t(h), RunCtx(mode=jmode), cfg, kind, **targs)
    assert tout.shape == (B, S, d) and torch.isfinite(tout).all()
    live = np.asarray([5, 0, 3]) > 0 if mode.startswith("chunk") else np.ones(B, bool)
    _close(tout.numpy()[live], np.asarray(jout)[live], SUB_ATOL)
    if cache is not None:
        for k in ("ck", "cv"):
            _close(targs["cache"][k].numpy(), jcache[k], SUB_ATOL)
        if mode == "chunk_memory":       # slot 1 is no row's, slot 0's row feeds nothing
            for k in ("ck", "cv"):
                np.testing.assert_array_equal(targs["cache"][k][:2].numpy(), cache[k][:2])


# ---------------------------------------------------------------- forward
def _batch(cfg, B=2, S=24, seed=0):
    """tests/test_arch_smoke.py's batch: tokens, 12 frames for enc-dec,
    n_patches patches for a VLM."""
    r = np.random.default_rng(seed)
    batch = {"tokens": r.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.encoder is not None:
        batch["frames"] = r.standard_normal((B, 12, cfg.d_model)).astype(np.float32)
    if cfg.vision is not None:
        batch["patches"] = r.standard_normal(
            (B, cfg.vision.n_patches, cfg.vision.d_patch)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_forward_matches_jax(arch):
    """Every arch of the reference: logits of shape (B, S + n_patches,
    vocab), finite, within 1e-4 of the JAX forward (dropless MoE), and the
    same MoE aux loss."""
    jmodel, jp, model, tp = _pair(arch)
    cfg = model.cfg
    batch = _batch(cfg)
    jl, jaux = jmodel.forward(jp, {k: jnp.asarray(v) for k, v in batch.items()}, JCTX)
    tl, taux = model.forward(tp, {k: _t(v) for k, v in batch.items()}, RunCtx())
    S_out = batch["tokens"].shape[1] + (cfg.vision.n_patches if cfg.vision else 0)
    assert tl.shape == (2, S_out, cfg.vocab) and torch.isfinite(tl).all()
    _close(tl.numpy(), jl, LOGIT_ATOL)
    assert abs(float(taux) - float(jaux)) < 1e-4


# ---------------------------------------------------------------- decode_chunk
def _extras(cfg, rows, seed):
    """frames (B, cross_attn_memory, d) / patches (B, n_patches, d_patch) for
    a pack: row i gets request rows[i]'s (None: zeros), as _row_extras
    builds them."""
    out = {}
    r = np.random.default_rng(seed)
    if cfg.encoder is not None:
        per = r.standard_normal((3, cfg.encoder.cross_attn_memory, cfg.d_model))
        out["frames"] = np.stack([per[i] if i is not None else np.zeros_like(per[0])
                                  for i in rows]).astype(np.float32)
    if cfg.vision is not None:
        per = r.standard_normal((3, cfg.vision.n_patches, cfg.vision.d_patch))
        out["patches"] = np.stack([per[i] if i is not None else np.zeros_like(per[0])
                                   for i in rows]).astype(np.float32)
    return out


@pytest.mark.parametrize("arch", [SEAMLESS, VISION])
def test_decode_chunk_matches_jax(arch):
    """Four calls on one pool of pages of 4 over 4 slots: a pack of request
    0's and 1's first chunks (and a padding row) with their frames /
    patches; a pack that mixes request 0's second chunk (starts 8) with
    request 2's first (starts 0); a decode sweep with slot 3 idle; a verify
    sweep of 3 tokens with ``all_logits``. Live rows' logits within 1e-4 of
    JAX's at each call; the KV pools (past the null page) and cross caches
    within 1e-5 after them."""
    jmodel, jp, model, tp = _pair(arch)
    cfg = model.cfg
    ps, num_pages, maxp, nslots = 4, 48, 11, 4
    rows = np.array([[1 + b * maxp + i for i in range(maxp)] for b in range(nslots)], np.int32)
    r = np.random.default_rng(8)
    prompts = [r.integers(1, 256, n).astype(np.int32) for n in (11, 5, 8)]
    jcache = jmodel.init_cache(nslots, 64, jnp.float32, kind="paged", page_size=ps,
                               num_pages=num_pages)
    tcache = model.init_cache(nslots, 64, kind="paged", page_size=ps, num_pages=num_pages,
                              device="cpu")
    jctx = JaxRunCtx(attn_backend="xla", moe_strategy="dropless")
    C = 8
    # each row's (request, first token, tokens) or None, the rows' slots and
    # whose frames / patches they carry
    calls = [([(0, 0, 8), (1, 0, 5), None], [0, 1, 3], [0, 1, None]),
             ([(0, 8, 3), (2, 0, 8), None], [0, 2, 3], [0, 2, None])]
    for grant, slots, ext_rows in calls:
        tok = np.zeros((3, C), np.int32)
        st, nv = np.zeros(3, np.int32), np.zeros(3, np.int32)
        for b, g in enumerate(grant):
            if g is not None:
                q, s0, n = g
                tok[b, :n], st[b], nv[b] = prompts[q][s0:s0 + n], s0, n
        pt = np.stack([rows[s] if nv[b] else np.zeros(maxp, np.int32)
                       for b, s in enumerate(slots)])
        ext = _extras(cfg, ext_rows, seed=3)
        args = (tok, st, nv, np.asarray(slots, np.int32), (st == 0) & (nv > 0))
        lg_ref, jcache = jmodel.decode_chunk(
            jp, *map(jnp.asarray, args[:1]), jcache, *map(jnp.asarray, args[1:]), jctx,
            jnp.asarray(pt), **{k: jnp.asarray(v) for k, v in ext.items()})
        lg, tcache = model.decode_chunk(tp, _t(tok), tcache, *map(_t, args[1:]), RunCtx(),
                                        _t(pt), **{k: _t(v) for k, v in ext.items()})
        assert lg.shape == (3, cfg.vocab) and torch.isfinite(lg).all()
        _close(lg.numpy()[nv > 0], np.asarray(lg_ref)[nv > 0], LOGIT_ATOL)
    # decode sweep then verify sweep, no extras: cross attention reads the
    # slots, positions carry the patch offset
    fed = [11, 5, 8, 0]
    r2 = np.random.default_rng(9)
    for width, all_logits in ((1, False), (3, True)):
        tok = r2.integers(1, 256, (nslots, width)).astype(np.int32)
        nv = np.asarray([width, width, 1, 0], np.int32)
        st = np.asarray(fed, np.int32)
        pt = np.where((nv > 0)[:, None], rows, 0).astype(np.int32)
        args = (st, nv, np.arange(nslots, dtype=np.int32), np.zeros(nslots, bool))
        lg_ref, jcache = jmodel.decode_chunk(jp, jnp.asarray(tok), jcache,
                                             *map(jnp.asarray, args), jctx, jnp.asarray(pt),
                                             all_logits=all_logits)
        lg, tcache = model.decode_chunk(tp, _t(tok), tcache, *map(_t, args), RunCtx(), _t(pt),
                                        all_logits=all_logits)
        if all_logits:
            assert lg.shape == (nslots, width, cfg.vocab) and torch.isfinite(lg).all()
            valid = np.arange(width)[None, :] < nv[:, None]
            _close(lg.numpy()[valid], np.asarray(lg_ref)[valid], LOGIT_ATOL)
        else:
            _close(lg.numpy()[nv > 0], np.asarray(lg_ref)[nv > 0], LOGIT_ATOL)
        fed = [f + n for f, n in zip(fed, nv)]
    for jg, tg in zip(jcache["groups"], tcache["groups"]):
        for jc, tc in zip(jg, tg):
            for k in ("kp", "vp"):
                _close(tc["attn"][k][:, 1:].numpy(), np.asarray(jc["attn"][k])[:, 1:], SUB_ATOL)
            for k in ("ck", "cv") if "cross" in tc else ():
                _close(tc["cross"][k].numpy(), jc["cross"][k], SUB_ATOL)


def test_patch_prefix_rows_of_a_mixed_pack(monkeypatch):
    """The attention kernel reads a row's first query position and takes
    its queries as consecutive. In a VLM pack every row carries the patch
    prefix, live only where starts == 0; the pack's ``q_positions`` must
    put every live column j of row b at starts[b] + j, the position its KV
    was written at, on a first-chunk row and on a later-chunk row alike."""
    _, _, model, tp = _pair(VISION)
    cfg = model.cfg
    n = cfg.vision.n_patches
    seen = {}

    def spy(p, h, ctx, cfg_, kind, cache=None, positions=None, page_table=None, lengths=None,
            valid=None, memory=None, chunk=None, layout=None):
        seen.setdefault("args", (positions.clone(), valid.clone(), chunk["q_positions"].clone()))
        return attention_sublayer(p, h, ctx, cfg_, kind, cache, positions, page_table, lengths,
                                  valid, memory=memory, chunk=chunk, layout=layout)

    cache = model.init_cache(2, 64, kind="paged", page_size=4, num_pages=40, device="cpu")
    tok = torch.ones((2, 6), dtype=torch.int32)
    starts = torch.tensor([0, 9], dtype=torch.int32)
    nvalid = torch.tensor([6, 4], dtype=torch.int32)
    pt = torch.arange(1, 33, dtype=torch.int32).reshape(2, 16)
    patches = torch.zeros((2, n, cfg.vision.d_patch))
    monkeypatch.setattr(transformer, "attention_sublayer", spy)
    model.decode_chunk(tp, tok, cache, starts, nvalid, torch.arange(2), starts == 0, RunCtx(),
                       pt, patches=patches)
    positions, valid, q_positions = seen["args"]
    assert q_positions.shape == positions.shape == (2, n + 6)
    assert valid[0, :n + 6].all() and not valid[1, :n].any() and valid[1, n:n + 4].all()
    torch.testing.assert_close(q_positions[valid], positions[valid])
    assert (q_positions == starts[:, None] + torch.arange(n + 6)[None]).all()


# ---------------------------------------------------------------- engine
def _grant(req_id):
    return (types.SimpleNamespace(request=types.SimpleNamespace(req_id=req_id)), 4)


@pytest.mark.parametrize("arch", [SEAMLESS, VISION])
def test_row_extras_crop_and_pad(arch):
    """Frames longer than the cross memory are cropped to it, shorter ones
    zero-padded; patches are copied; a row without extras is zeros; the
    port's pack equals the JAX engine's."""
    jmodel, jp, model, tp = _pair(arch)
    cfg = model.cfg
    kw = dict(max_slots=4, page_size=8, num_pages=16, max_seq=64)
    je = JaxInferenceEngine(jmodel, jp, JaxEngineConfig(prefill_chunk=8, **kw))
    te = InferenceEngine(model, tp, EngineConfig(prefill_chunk=8, device="cpu", **kw))
    r = np.random.default_rng(2)
    M = cfg.encoder.cross_attn_memory if cfg.encoder else 0
    for e in (je, te):
        if cfg.encoder is not None:
            e.extras[("a", "frames")] = r.standard_normal((1, M + 9, cfg.d_model))
            e.extras[("b", "frames")] = r.standard_normal((1, M - 20, cfg.d_model))
        if cfg.vision is not None:
            e.extras[("a", "patches")] = r.standard_normal(
                (1, cfg.vision.n_patches, cfg.vision.d_patch))
        r = np.random.default_rng(2)        # the same arrays for both engines
    grants = [_grant("a"), _grant("b"), _grant("c")]
    want = je._row_extras(grants, 4)
    got = te._row_extras(grants, 4)
    for w, g, key in zip(want, got, ("frames", "patches")):
        assert (w is None) == (g is None) == ((cfg.encoder if key == "frames" else cfg.vision)
                                              is None)
        if g is None:
            continue
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert not g[2:].any()
    if cfg.encoder is not None:
        fr, src = got[0], te.extras[("b", "frames")][0]
        np.testing.assert_array_equal(fr[0].numpy(), te.extras[("a", "frames")][0][:M]
                                      .astype(np.float32))
        np.testing.assert_array_equal(fr[1, :M - 20].numpy(), src.astype(np.float32))
        assert not fr[1, M - 20:].any()


CASES = {
    # multi-chunk prompts under the token budget: packs of first and later chunks
    "multi_chunk": dict(kw=dict(max_slots=3, num_pages=64, prefill_chunk=8, token_budget=20),
                        lens=(19, 7, 26, 11, 9), max_new=6),
    # 9 usable pages for 3 slots of 30 tokens (plus a patch prefix): preemption
    "preempt": dict(kw=dict(max_slots=3, num_pages=10, prefill_chunk=16),
                    lens=(10, 10, 10, 10, 10), max_new=20),
    "spec": dict(kw=dict(max_slots=3, num_pages=64, prefill_chunk=8, enable_speculative=True,
                         spec_k=2), lens=(14, 20, 9), max_new=12),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", [SEAMLESS, VISION])
def test_engine_streams_match_jax(arch, case, monkeypatch):
    """The port's engine and the JAX engine, same weights, requests and
    extras (frames of 20-45 frames against a memory of 32, or patches),
    greedy: equal token streams, preemptions, drafted and accepted counts,
    and per-step token counts; the prefix cache stays off though asked for;
    the allocator's invariants hold, every page is free again and the
    extras are dropped. The VLM's multi-chunk run packs a first chunk beside
    a later one."""
    jmodel, jp, model, tp = _pair(arch)
    cfg = model.cfg
    spec = CASES[case]
    kw = dict(page_size=8, max_seq=96, greedy=True, enable_prefix_cache=True, **spec["kw"])
    je = JaxInferenceEngine(jmodel, jp, JaxEngineConfig(**kw))
    te = InferenceEngine(model, tp, EngineConfig(device="cpu", **kw))
    assert te.prefix_cache is None and je.prefix_cache is None
    r = np.random.default_rng(len(case))
    if case == "spec":          # repeating prompts, so prompt lookup finds drafts
        motif = r.integers(1, 256, 5)
        prompts = [np.resize(np.roll(motif, i), n).astype(np.int32)
                   for i, n in enumerate(spec["lens"])]
    else:
        prompts = [r.integers(1, 256, n).astype(np.int32) for n in spec["lens"]]
    for i in range(len(prompts)):
        if cfg.encoder is not None:
            frames = r.standard_normal((1, 20 + 5 * i, cfg.d_model)).astype(np.float32)
            je.extras[(f"r{i}", "frames")] = te.extras[(f"r{i}", "frames")] = frames
        if cfg.vision is not None:
            patches = r.standard_normal((1, cfg.vision.n_patches, cfg.vision.d_patch))
            je.extras[(f"r{i}", "patches")] = te.extras[(f"r{i}", "patches")] = patches
    packs = []
    run = te._run

    def record(tokens, starts, nvalid, slots, first, page_table, spec=False, frames=None,
               patches=None):
        if patches is not None:
            live = nvalid > 0
            packs.append((bool((live & (starts == 0)).any()), bool((live & (starts > 0)).any())))
        return run(tokens, starts, nvalid, slots, first, page_table, spec=spec, frames=frames,
                   patches=patches)

    monkeypatch.setattr(te, "_run", record)
    jr = [JaxRequest(req_id=f"r{i}", prompt_tokens=p, max_new_tokens=spec["max_new"])
          for i, p in enumerate(prompts)]
    tr = [Request(req_id=f"r{i}", prompt_tokens=p, max_new_tokens=spec["max_new"])
          for i, p in enumerate(prompts)]
    je.generate(jr)
    te.generate(tr)
    for a, b in zip(jr, tr):
        assert a.finished and b.finished and len(b.generated) == spec["max_new"]
        assert b.generated == a.generated, (b.req_id, b.generated, a.generated)
    te.allocator.check_invariants()
    assert te.allocator.free_pages == te.cfg.num_pages - 1
    assert not te.extras and not je.extras
    assert te.scheduler.n_preemptions == je.scheduler.n_preemptions
    assert (te.scheduler.n_preemptions > 0) == (case == "preempt")
    assert list(te.iter_token_counts) == list(je.iter_token_counts)
    ts, js = te.stats(), je.stats()
    for k in ("decode_tokens", "spec_steps", "drafted_tokens", "accepted_tokens"):
        assert ts[k] == js[k], k
    if case == "spec":
        assert ts["drafted_tokens"] > 0 and ts["accepted_tokens"] > 0
    if cfg.vision is not None and case == "multi_chunk":
        assert (True, True) in packs, packs
