"""Speculative decoding on the port (tests/test_speculative.py's checks),
against the JAX package on the CPU with inputs made from a numpy seed:
prompt-lookup drafting, ``target_probs``, the greedy verify rule on the same
logits, the sampled verify rule in distribution (the two frameworks'
generators differ), ``decode_chunk(all_logits=True)`` through the int8
heads, and the port's engine against the JAX engine with
speculation on (tiny mixtral: greedy streams and drafted / accepted counts
equal at 64 pages, under preemption, with a warm prefix hit, on the int8
tree, and with drafts rejected across a page boundary). Then the port on
its own: speculation off and on give the same greedy streams, a degraded
engine drafts nothing, SSM and hybrid models keep speculation off, the
counters reach ``stats()`` and the step records, and the knobs reach an
engine built by the serving launcher."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import tiny_config as jax_tiny_config
from repro.core import spec as jax_spec
from repro.core.engine import EngineConfig as JaxEngineConfig
from repro.core.engine import InferenceEngine as JaxInferenceEngine
from repro.core.metrics import Request as JaxRequest
from repro.models import RunCtx as JaxRunCtx
from repro.models import build_model as jax_build_model
from repro.quant import dequantize_tree as jax_dequantize_tree
from repro.quant import quantize_params_int8 as jax_quantize_params_int8
from repro_torch.configs import tiny_config
from repro_torch.core import (EngineConfig, InferenceEngine, PromptLookupDraft, Request,
                              Tracer, target_probs, verify_draft)
from repro_torch.launch.serve import build_fleet
from repro_torch.models import RunCtx, build_model
from repro_torch.models.params import params_from_numpy

NAME = "mixtral-8x7b"
PROB_TOL = 1e-6          # target_probs: fp32 softmax of the same logits on both sides
DIST_TOL = 0.035         # sampled verify: the reference's bound over 4000 draws
WIDE = 256               # d_model at which every projection is int8 (test_torch_quant.py)
INT8_TOL = 1e-4          # int8 tree vs JAX on its dequantized tree, fp32 (test_torch_quant.py)
JCTX = JaxRunCtx(attn_backend="xla", moe_strategy="dropless")
CTX = RunCtx()


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------ draft source
def test_prompt_lookup_matches_reference():
    """200 seeded histories over a small vocabulary (so suffixes recur), at
    random n-gram bounds and draft lengths: the same proposals."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        L = int(rng.integers(0, 40))
        hist = rng.integers(0, int(rng.integers(2, 8)), L).tolist()
        lo = int(rng.integers(1, 3))
        hi = lo + int(rng.integers(0, 3))
        k = int(rng.integers(0, 7))
        ours = PromptLookupDraft(hi, lo).propose(hist, k)
        assert ours == jax_spec.PromptLookupDraft(hi, lo).propose(hist, k), (hist, lo, hi, k)
        assert ours == PromptLookupDraft(hi, lo).propose(np.asarray(hist, np.int32), k)


def test_prompt_lookup_continues_cycle():
    ds = PromptLookupDraft(ngram_max=3, ngram_min=1)
    assert ds.propose([1, 2, 3, 1, 2, 3, 1, 2], 5) == [3, 1, 2, 3, 1]


def test_prompt_lookup_extends_runs_periodically():
    assert PromptLookupDraft().propose([7, 7, 7, 7], 4) == [7, 7, 7, 7]


def test_prompt_lookup_prefers_most_recent_match():
    # [9, 1] occurs twice; the draft continues the most recent occurrence
    assert PromptLookupDraft(3, 1).propose([9, 1, 5, 9, 1, 7, 9, 1], 3)[0] == 7


def test_prompt_lookup_no_match_and_empty_inputs():
    ds = PromptLookupDraft()
    assert ds.propose([1, 2, 3, 4], 4) == []
    assert ds.propose([1, 2, 3, 4], 0) == []
    assert ds.propose([1], 4) == []
    assert ds.propose([], 4) == []


def test_prompt_lookup_longer_ngram_wins():
    # the 2-gram [5, 6] matches at position 0 -> 8; the 1-gram [6] alone
    # (position 4) would have drafted 9
    assert PromptLookupDraft(ngram_max=2, ngram_min=1).propose([5, 6, 8, 2, 6, 9, 5, 6], 1) == [8]


# ------------------------------------------------------------ verify rule
@pytest.mark.parametrize("temp,top_p", [(0.7, 0.9), (1.0, 1.0), (0.3, 0.2)])
def test_target_probs_matches_jax(temp, top_p):
    logits = (np.random.default_rng(1).standard_normal((4, 3, 50)) * 3).astype(np.float32)
    ours = target_probs(_t(logits), temp, top_p).numpy()
    ref = np.asarray(jax_spec.target_probs(jnp.asarray(logits), temp, top_p))
    np.testing.assert_allclose(ours, ref, atol=PROB_TOL, rtol=0)
    np.testing.assert_allclose(ours.sum(-1), 1.0, atol=1e-5)


def _mk_logits(rows, V=16):
    """Per-position argmax token ids -> (1, C, V) logits."""
    logits = np.full((1, len(rows), V), -3.0, np.float32)
    for j, t in enumerate(rows):
        logits[0, j, t] = 5.0
    return logits


def _both_greedy(logits, tokens, nvalid):
    ours = verify_draft(_t(logits), _t(tokens), _t(nvalid), torch.Generator(), 0.7, 0.9, True)
    ref = jax_spec.verify_draft(jnp.asarray(logits), jnp.asarray(tokens), jnp.asarray(nvalid),
                                jax.random.PRNGKey(0), 0.7, 0.9, greedy=True)
    assert all(o.dtype == torch.int32 for o in ours)
    return [o.numpy() for o in ours], [np.asarray(r) for r in ref]


@pytest.mark.parametrize("fed,nvalid,n_acc,out", [
    ([9, 4, 5], 3, 2, 6),    # every draft accepted: the bonus token
    ([9, 4, 7], 3, 1, 5),    # d2 != argmax 5: the correction
    ([9, 4, 5], 1, 0, 4),    # no drafts fed: padding columns do not count
])
def test_verify_greedy_cases(fed, nvalid, n_acc, out):
    ours, ref = _both_greedy(_mk_logits([4, 5, 6]), np.asarray([fed], np.int32),
                             np.asarray([nvalid], np.int32))
    assert (int(ours[0][0]), int(ours[1][0])) == (n_acc, out)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("C", [2, 3, 5])
def test_verify_greedy_matches_jax(C):
    """Random logits at each ladder width; each row's drafts follow the
    argmax for a random prefix, then one random token; nvalid from 0
    (inactive row) to C: the same (n_acc, out) as JAX's."""
    rng = np.random.default_rng(C)
    M, V = 12, 32
    logits = rng.standard_normal((M, C, V)).astype(np.float32)
    arg = logits.argmax(-1)
    tokens = rng.integers(0, V, (M, C)).astype(np.int32)
    nvalid = rng.integers(0, C + 1, M).astype(np.int32)
    for m in range(M):
        good = int(rng.integers(0, C))
        tokens[m, 1:1 + good] = arg[m, :good]
    ours, ref = _both_greedy(logits, tokens, nvalid)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    assert (ours[0] <= np.maximum(nvalid - 1, 0)).all() and ours[0].max() > 0


def test_verify_rejection_sampling_matches_target_distribution():
    """Committing [draft if accepted else the residual sample] reproduces the
    target distribution (tests/test_speculative.py's check): the marginal of
    the first committed token over 4000 draws, for an in-nucleus and a
    usually zero-mass draft."""
    rng = np.random.default_rng(1)
    V, temp, top_p, n = 12, 0.9, 0.8, 4000
    row = (rng.standard_normal((1, 2, V)) * 2.0).astype(np.float32)
    p_target = target_probs(_t(row[:, 0]), temp, top_p).numpy()[0]
    np.testing.assert_allclose(
        p_target, np.asarray(jax_spec.target_probs(jnp.asarray(row[:, 0]), temp, top_p))[0],
        atol=PROB_TOL)
    gen = torch.Generator().manual_seed(0)
    for draft_tok in (int(np.argsort(p_target)[-2]), int(np.argmin(p_target))):
        logits = _t(np.repeat(row, n, axis=0))
        tokens = torch.tensor([[3, draft_tok]] * n, dtype=torch.int32)
        n_acc, out = verify_draft(logits, tokens, torch.full((n,), 2, dtype=torch.int32), gen,
                                  temp, top_p, greedy=False)
        toks = torch.where(n_acc >= 1, tokens[:, 1], out).numpy()
        emp = np.bincount(toks, minlength=V) / n
        assert np.abs(emp - p_target).max() < DIST_TOL, (emp, p_target)


@pytest.mark.parametrize("name", ["mixtral-8x7b", "gemma2-27b"])
def test_all_logits_on_int8_heads(name):
    """``decode_chunk(all_logits=True)`` on the int8 tree, through the untied
    head's ``linear`` (mixtral) and the tied embedding's transpose with the
    logit softcap (gemma2) on (B, C, d) input: within INT8_TOL of the JAX
    model on the dequantized tree at every valid position of a C = 5 verify
    sweep whose rows feed 5, 2 and 0 tokens."""
    jmodel = jax_build_model(jax_tiny_config(name).scaled(d_model=WIDE))
    jq = jax_quantize_params_int8(jmodel.init_params(jax.random.PRNGKey(0)))
    jp = jax_dequantize_tree(jq, jnp.float32)
    tq = params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu")
    model = build_model(tiny_config(name).scaled(d_model=WIDE))
    B, C, ps, maxp = 3, 5, 4, 6
    toks = np.random.default_rng(2).integers(1, 256, (B, 9 + C)).astype(np.int32)
    pt = np.array([[1 + b * maxp + i for i in range(maxp)] for b in range(B)], np.int32)
    jc = jmodel.init_cache(B, 32, jnp.float32, kind="paged", page_size=ps,
                           num_pages=B * maxp + 1)
    tc = model.init_cache(B, 32, kind="paged", page_size=ps, num_pages=B * maxp + 1,
                          device="cpu")
    slots = np.arange(B, dtype=np.int32)
    nv = np.array([5, 2, 0], np.int32)
    calls = [(toks[:, :9], np.zeros(B, np.int32), np.full(B, 9, np.int32), np.ones(B, bool),
              False),
             (toks[:, 9:], np.where(nv > 0, 9, 0).astype(np.int32), nv, np.zeros(B, bool),
              True)]
    for tok, st, n, first, all_logits in calls:
        jl, jc = jmodel.decode_chunk(jp, jnp.asarray(tok), jc, jnp.asarray(st), jnp.asarray(n),
                                     jnp.asarray(slots), jnp.asarray(first), JCTX,
                                     jnp.asarray(pt), all_logits=all_logits)
        tl, tc = model.decode_chunk(tq, _t(tok), tc, _t(st), _t(n), _t(slots), _t(first), CTX,
                                    _t(pt), all_logits=all_logits)
    valid = np.arange(C)[None, :] < nv[:, None]
    assert tl.shape == (B, C, 256) and torch.isfinite(tl).all()
    assert np.abs(tl.numpy()[valid] - np.asarray(jl)[valid]).max() < INT8_TOL


# ------------------------------------------------------------ engine vs JAX
def _repetitive_prompts(vocab: int, n: int, seed: int = 3):
    """Extractive / boilerplate-shaped prompts (tests/test_speculative.py's)."""
    rng = np.random.default_rng(seed)
    prompts = []
    for i in range(n):
        if i % 2 == 0:
            passage = rng.integers(1, vocab, 12)
            query = rng.integers(1, vocab, 4)
            prompts.append(np.concatenate([passage, query, passage]).astype(np.int32))
        else:
            prompts.append(np.tile(rng.integers(1, vocab, 4), 7).astype(np.int32))
    return prompts


@pytest.fixture(scope="module")
def models():
    jmodel = jax_build_model(jax_tiny_config(NAME))
    jp = jmodel.init_params(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jmodel, jp, build_model(tiny_config(NAME)), tp


@pytest.fixture(scope="module")
def int8_models():
    """The JAX model on the dequantized fp32 tree, the port's on the int8
    tree (tests/test_torch_quant.py's pairing), at d_model 256."""
    jmodel = jax_build_model(jax_tiny_config(NAME).scaled(d_model=WIDE))
    jq = jax_quantize_params_int8(jmodel.init_params(jax.random.PRNGKey(0)))
    tq = params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu")
    return (jmodel, jax_dequantize_tree(jq, jnp.float32),
            build_model(tiny_config(NAME).scaled(d_model=WIDE)), tq)


BASE = dict(max_slots=4, page_size=4, num_pages=64, max_seq=128, prefill_chunk=8,
            greedy=True, enable_speculative=True, spec_k=4)


def _engines(models, **kw):
    jmodel, jp, model, tp = models
    cfg = dict(BASE, **kw)
    return (JaxInferenceEngine(jmodel, jp, JaxEngineConfig(**cfg)),
            InferenceEngine(model, tp, EngineConfig(device="cpu", **cfg)))


def _serve(je, te, prompts, max_new, tag="r"):
    jr = [JaxRequest(req_id=f"{tag}{i}", prompt_tokens=p, max_new_tokens=max_new)
          for i, p in enumerate(prompts)]
    tr = [Request(req_id=f"{tag}{i}", prompt_tokens=p, max_new_tokens=max_new)
          for i, p in enumerate(prompts)]
    je.generate(jr)
    te.generate(tr)
    for a, b in zip(jr, tr):
        assert a.finished and b.finished and len(b.generated) == max_new
        assert b.generated == a.generated, (b.req_id, b.generated, a.generated)
    return tr


def _same_counts(je, te):
    for k in ("spec_steps", "drafted_tokens", "accepted_tokens", "decode_tokens"):
        assert getattr(te, k) == getattr(je, k), (k, getattr(te, k), getattr(je, k))
    assert te.scheduler.n_preemptions == je.scheduler.n_preemptions
    assert list(te.iter_token_counts) == list(je.iter_token_counts)
    assert te.drafted_tokens > 0 and 0 < te.accepted_tokens < te.drafted_tokens
    te.allocator.check_invariants()
    assert not te.allocator._ref, "pages leaked after all requests done"


@pytest.mark.parametrize("case", ["pages64", "preemption"])
def test_greedy_streams_and_counts_match_jax(models, case):
    """64 pages, then 24 pages with a budget of 24 tokens: speculative
    growth, preemption and rollback in step with the JAX engine."""
    kw = {} if case == "pages64" else dict(num_pages=24, token_budget=24)
    je, te = _engines(models, **kw)
    _serve(je, te, _repetitive_prompts(256, 6, seed=3 if case == "pages64" else 5), 24)
    _same_counts(je, te)
    assert (te.scheduler.n_preemptions > 0) == (case == "preemption")


def test_warm_prefix_hit_matches_jax(models):
    """A trie seeded by one request of 6 whole pages, then five sharing its
    4-page prefix, one of them the whole seed prompt again (its last token
    is written into a registered page: copy-on-write). Drafts grow, write
    and roll back past the shared pages; the same streams, counts and COW
    copies as the JAX engine."""
    je, te = _engines(models)
    rng = np.random.default_rng(9)
    shared = rng.integers(1, 256, 16).astype(np.int32)
    seed = np.concatenate([shared, rng.integers(1, 256, 8).astype(np.int32)])
    prompts = [seed.copy()] + [np.concatenate([shared, rng.integers(1, 256, 6).astype(np.int32)])
                               for _ in range(4)]
    _serve(je, te, [seed], 2, tag="seed")
    _serve(je, te, prompts, 20, tag="warm")
    _same_counts(je, te)
    st, js = te.stats(), je.stats()
    assert st["prefix_hit_pages"] > 0 and st["cow_copies"] > 0
    for k in ("prefix_hit_pages", "cow_copies", "prefix_cached_tokens"):
        assert st[k] == js[k], k


def test_int8_engine_matches_jax(int8_models):
    """The port's engine on the int8 tree (the head and projections through
    the w8a16 matmul at M * C rows) against the JAX engine on the
    dequantized tree, under preemption."""
    je, te = _engines(int8_models, num_pages=24, token_budget=24)
    _serve(je, te, _repetitive_prompts(256, 6, seed=5), 16)
    _same_counts(je, te)
    assert te.scheduler.n_preemptions > 0


def test_rejection_across_page_boundary_matches_jax(models):
    """Pages of 4 with drafts of up to 4 tokens: a rejected draft that had
    grown a page gives it back (``shrink_to_tokens`` drops it), and the
    stream goes on to write over the rejected KV, equal to the JAX engine's."""
    je, te = _engines(models)
    dropped = []
    shrink = te.scheduler.shrink_to_tokens

    def recording(slot, n_tokens):
        n = shrink(slot, n_tokens)
        st = te.scheduler.running[slot]
        dropped.append((n, len(st.request.generated) < st.request.max_new_tokens))
        return n

    te.scheduler.shrink_to_tokens = recording
    _serve(je, te, _repetitive_prompts(256, 6, seed=11), 24)
    _same_counts(je, te)
    assert any(n > 0 and going_on for n, going_on in dropped), dropped


# ------------------------------------------------------------ the port alone
def _port_gen(model, params, prompts, max_new=24, **kw):
    eng = InferenceEngine(model, params, EngineConfig(device="cpu", **dict(BASE, **kw)))
    reqs = [Request(req_id=f"p{i}", prompt_tokens=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    eng.generate(reqs)
    assert all(r.finished and len(r.generated) == max_new for r in reqs)
    eng.allocator.check_invariants()
    assert not eng.allocator._ref
    return eng, [r.generated for r in reqs]


def test_spec_off_and_on_streams_identical(models):
    _, _, model, tp = models
    prompts = _repetitive_prompts(256, 6)
    _, base = _port_gen(model, tp, prompts, enable_speculative=False)
    eng, spec = _port_gen(model, tp, prompts)
    assert base == spec
    assert eng.spec_steps > 0 and eng.drafted_tokens > 0 and eng.accepted_tokens > 0
    # the step records carry each step's share of the counters
    recs = list(eng.step_records)
    assert sum(r.drafted_tokens for r in recs) == eng.drafted_tokens
    assert sum(r.accepted_tokens for r in recs) == eng.accepted_tokens


def test_degraded_drafts_nothing(models):
    """The brown-out flag (set by the replica's ``set_degraded``) keeps the
    engine on plain decode sweeps, with the same streams."""
    _, _, model, tp = models
    prompts = _repetitive_prompts(256, 4)
    eng = InferenceEngine(model, tp, EngineConfig(device="cpu", **BASE))
    eng.degraded = True
    reqs = [Request(req_id=f"d{i}", prompt_tokens=p, max_new_tokens=16)
            for i, p in enumerate(prompts)]
    eng.generate(reqs)
    assert eng.spec_on and eng.spec_steps == 0 and eng.drafted_tokens == 0
    _, ref = _port_gen(model, tp, prompts, max_new=16, enable_speculative=False)
    assert [r.generated for r in reqs] == ref


def test_sampled_mode_runs_and_counts(models):
    """Sampled requests take the rejection-sampling verify path."""
    _, _, model, tp = models
    eng, outs = _port_gen(model, tp, _repetitive_prompts(256, 4), max_new=16, greedy=False,
                          temperature=0.7, top_p=0.9)
    assert eng.drafted_tokens > 0 and eng.spec_steps > 0
    assert all(0 <= t < 256 for o in outs for t in o)


@pytest.mark.parametrize("name", ["mamba2-1.3b", "jamba-v0.1-52b"])
def test_ssm_arch_gates_speculation_off(name):
    """Rollback is a KV-length decrement, unsound for SSM state: SSM and
    hybrid models keep speculation off and decode as usual."""
    model = build_model(tiny_config(name))
    params = model.init_params(0, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [np.tile(rng.integers(1, 256, 4), 4).astype(np.int32) for _ in range(2)]
    eng, _ = _port_gen(model, params, prompts, max_new=8, max_slots=2, num_pages=64,
                       max_seq=64)
    assert not eng.spec_on and eng.draft_source is None
    assert eng.drafted_tokens == 0 and eng.spec_steps == 0


def test_stats_and_spans_surface_spec_counters(models):
    """``stats()`` carries the counters, and the tracer's merged
    ``spec_verify`` spans sum to them (every drafted token went through a
    verify row that carried its draft)."""
    _, _, model, tp = models
    tracer = Tracer()
    eng = InferenceEngine(model, tp, EngineConfig(device="cpu", **BASE), tracer=tracer)
    reqs = [Request(req_id=f"t{i}", prompt_tokens=p, max_new_tokens=24)
            for i, p in enumerate(_repetitive_prompts(256, 4))]
    eng.generate(reqs)
    s = eng.stats()
    assert s["spec_steps"] == eng.spec_steps > 0
    assert 0 < s["spec_acceptance_rate"] <= 1
    assert s["accepted_tokens"] <= s["drafted_tokens"]
    assert s["spec_acceptance_rate"] == s["accepted_tokens"] / s["drafted_tokens"]
    spans = [sp for r in reqs for sp in tracer.peek(r.req_id) if sp.name == "spec_verify"]
    assert sum(sp.attrs["drafted"] for sp in spans) == eng.drafted_tokens
    assert sum(sp.attrs["accepted"] for sp in spans) == eng.accepted_tokens


def test_width_ladder():
    """C = 1 + k for k in {1, 2, 4, ..., kmax}: 2 / 3 / 5 at the default k = 4."""
    model = build_model(tiny_config(NAME))
    params = model.init_params(0, device="cpu")
    widths = {k: InferenceEngine(model, params, EngineConfig(
        device="cpu", enable_speculative=True, spec_k=k, num_pages=16))._spec_widths
        for k in (1, 3, 4, 8)}
    assert widths == {1: [2], 3: [2, 3, 4], 4: [2, 3, 5], 8: [2, 3, 5, 9]}
    assert InferenceEngine(model, params, EngineConfig(device="cpu", num_pages=16,
                                                       enable_speculative=True,
                                                       spec_k=0)).spec_on is False


def test_serving_launcher_passes_spec_knobs():
    """``build_fleet``'s engine arguments reach each replica's engine, and
    the replica's brown-out toggle reaches its drafting flag."""
    cfg, fleet = build_fleet(NAME, 2, engine_kwargs=dict(enable_speculative=True, spec_k=3),
                             device="cpu")
    try:
        for rep in fleet:
            assert rep.engine.spec_on and rep.engine.spec_kmax == 3
            rep.set_degraded(True)
            assert rep.engine.degraded
    finally:
        for rep in fleet:
            rep.stop()
