"""Port's serving engine vs the JAX ``InferenceEngine`` on tiny mixtral with
the same weights and requests: identical greedy token streams through
page-pressure preemption, multi-chunk prefill under the token budget and a
warm shared-prefix hit (the copy-on-write path), allocator invariants
afterwards. Each other decoder-only attention config (gemma2, qwen2.5, yi,
phi3-mini, dbrx, deepseek-moe) runs the greedy streams at 64 pages, and
gemma2, whose sliding window and softcaps meet chunk and page boundaries,
the multi-chunk and warm-prefix cases too. The same on tiny mamba2 and jamba
(slot-pooled SSM state, first-chunk resets, preemption), whose engines keep
the prefix cache off. Sampling is compared in distribution, because the two
frameworks' generators differ. Then the port's engine against the port's
own pure-model loop (``prefill`` + ``decode_step``), as tests/test_engine.py
holds the JAX engine."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import tiny_config as jax_tiny_config
from repro.core.engine import EngineConfig as JaxEngineConfig
from repro.core.engine import InferenceEngine as JaxInferenceEngine
from repro.core.engine import sample_tokens as jax_sample_tokens
from repro.core.metrics import Request as JaxRequest
from repro.models import build_model as jax_build_model
from repro_torch.configs import tiny_config
from repro_torch.core import EngineConfig, InferenceEngine, Request, sample_tokens
from repro_torch.models import RunCtx, build_model
from repro_torch.models.params import params_from_numpy

NAME = "mixtral-8x7b"
# the other decoder-only attention configs, each on the 64-page greedy case
OTHERS = ["gemma2-27b", "qwen2.5-3b", "yi-6b", "phi3-mini-3.8b", "dbrx-132b",
          "deepseek-moe-16b"]
WINDOWED = "gemma2-27b"


@functools.lru_cache(maxsize=None)
def _pair(name):
    jmodel = jax_build_model(jax_tiny_config(name))
    jp = jmodel.init_params(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jmodel, jp, build_model(tiny_config(name)), tp


@pytest.fixture(scope="module")
def models():
    return _pair(NAME)


def _engines(models, **kw):
    jmodel, jp, model, tp = models
    chunk = kw.pop("prefill_chunk")
    je = JaxInferenceEngine(jmodel, jp, JaxEngineConfig(prefill_chunk=chunk, **kw))
    te = InferenceEngine(model, tp, EngineConfig(prefill_chunk=chunk, device="cpu", **kw))
    return je, te


def _serve(je, te, prompts, max_new):
    jr = [JaxRequest(req_id=f"r{i}", prompt_tokens=p, max_new_tokens=max_new)
          for i, p in enumerate(prompts)]
    tr = [Request(req_id=f"r{i}", prompt_tokens=p, max_new_tokens=max_new)
          for i, p in enumerate(prompts)]
    je.generate(jr)
    te.generate(tr)
    for a, b in zip(jr, tr):
        assert a.finished and b.finished
        assert len(b.generated) == max_new
        assert b.generated == a.generated, (b.req_id, b.generated, a.generated)
    return tr


@pytest.mark.parametrize("arch,num_pages,max_new", [
    pytest.param(NAME, 10, 20, id="10-20"), pytest.param(NAME, 64, 12, id="64-12"),
    *(pytest.param(n, 64, 12, id=f"{n}-64-12") for n in OTHERS)])
def test_greedy_streams_match_jax(arch, num_pages, max_new):
    """num_pages=10 holds 9 usable pages for 3 slots of 30 tokens: the
    scheduler must preempt and resume."""
    je, te = _engines(_pair(arch), max_slots=3, page_size=8, num_pages=num_pages, max_seq=64,
                      prefill_chunk=16, greedy=True)
    r = np.random.default_rng(0)
    prompts = [r.integers(1, 256, 10).astype(np.int32) for _ in range(5)]
    _serve(je, te, prompts, max_new)
    te.allocator.check_invariants()
    assert te.scheduler.n_preemptions == je.scheduler.n_preemptions
    assert (te.scheduler.n_preemptions > 0) == (num_pages == 10)
    assert te.stats()["decode_tokens"] == je.stats()["decode_tokens"]


def test_multi_chunk_prefill_under_budget_matches_jax(models):
    """Prompts longer than the chunk prefill over several iterations while
    other slots decode, within the token budget."""
    _check_multi_chunk(models)


def test_multi_chunk_prefill_under_budget_matches_jax_windowed():
    """The same on gemma2, whose window of 16 the 19- and 26-token prompts
    cross inside a chunk."""
    _check_multi_chunk(_pair(WINDOWED))


def _check_multi_chunk(pair):
    je, te = _engines(pair, max_slots=3, page_size=8, num_pages=64, max_seq=64,
                      prefill_chunk=8, token_budget=12, greedy=True)
    r = np.random.default_rng(3)
    prompts = [r.integers(1, 256, n).astype(np.int32) for n in (19, 7, 26, 11)]
    _serve(je, te, prompts, 10)
    te.allocator.check_invariants()
    assert max(te.iter_token_counts) <= 12
    assert list(te.iter_token_counts) == list(je.iter_token_counts)


def test_warm_prefix_hit_matches_jax(models):
    """A second wave sharing a prompt prefix with the first hits the prefix
    cache; the request repeating a whole prompt writes into a cached page
    and so goes through copy-on-write."""
    _check_warm_prefix(models)


def test_warm_prefix_hit_matches_jax_windowed():
    """The same on gemma2: the 24-token prompt's window of 16 starts inside
    the shared prefix pages."""
    _check_warm_prefix(_pair(WINDOWED))


def _check_warm_prefix(pair):
    je, te = _engines(pair, max_slots=2, page_size=8, num_pages=48, max_seq=64,
                      prefill_chunk=8, greedy=True)
    r = np.random.default_rng(5)
    prefix = r.integers(1, 256, 16).astype(np.int32)
    a = np.concatenate([prefix, r.integers(1, 256, 8).astype(np.int32)])
    b = np.concatenate([prefix, r.integers(1, 256, 5).astype(np.int32)])
    _serve(je, te, [a], 6)
    _serve(je, te, [a.copy(), b], 6)
    te.allocator.check_invariants()
    st, js = te.stats(), je.stats()
    assert st["prefix_hit_pages"] > 0 and st["cow_copies"] > 0
    for k in ("prefix_hit_pages", "cow_copies", "prefix_cached_tokens"):
        assert st[k] == js[k], k


@pytest.fixture(scope="module", params=["mamba2-1.3b", "jamba-v0.1-52b"])
def ssm_models(request):
    jmodel = jax_build_model(jax_tiny_config(request.param))
    jp = jmodel.init_params(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jmodel, jp, build_model(tiny_config(request.param)), tp


@pytest.mark.parametrize("num_pages", [8, 64])
def test_ssm_greedy_streams_match_jax(ssm_models, num_pages):
    """Prompts longer than the prefill chunk, so later chunks continue from
    the slot's carried state; num_pages=8 holds 7 usable pages for 3 slots
    of up to 34 tokens: the scheduler preempts, and a resumed request
    restarts its state from its first chunk."""
    je, te = _engines(ssm_models, max_slots=3, page_size=8, num_pages=num_pages, max_seq=64,
                      prefill_chunk=8, greedy=True)
    assert te.prefix_cache is None and je.prefix_cache is None
    r = np.random.default_rng(7)
    prompts = [r.integers(1, 256, n).astype(np.int32) for n in (19, 7, 12, 10)]
    _serve(je, te, prompts, 10)
    te.allocator.check_invariants()
    assert te.scheduler.n_preemptions == je.scheduler.n_preemptions
    assert (te.scheduler.n_preemptions > 0) == (num_pages == 8)


def test_prefix_cache_gated_off_for_ssm():
    """tests/test_prefix_cache.py::test_prefix_cache_gated_off_for_ssm on
    the port: a page does not hold an SSM layer's state, so no prefix is
    shared."""
    model = build_model(tiny_config("mamba2-1.3b"))
    eng = InferenceEngine(model, model.init_params(0, device="cpu"), EngineConfig(
        max_slots=2, page_size=8, num_pages=16, max_seq=32, greedy=True, device="cpu"))
    assert eng.prefix_cache is None
    assert eng.scheduler.prefix_cache is None


def test_sampled_mode_completes(models):
    _, te = _engines(models, max_slots=2, page_size=8, num_pages=32, max_seq=64,
                     prefill_chunk=8, greedy=False, temperature=0.8, top_p=0.9)
    r = np.random.default_rng(6)
    reqs = [Request(req_id=f"s{i}", prompt_tokens=r.integers(1, 256, 7).astype(np.int32),
                    max_new_tokens=6) for i in range(3)]
    te.generate(reqs)
    assert all(q.finished and len(q.generated) == 6 for q in reqs)
    assert all(0 <= t < 256 for q in reqs for t in q.generated)
    te.allocator.check_invariants()


def test_sampling_top_p_mass():
    """Every sampled token lies in the smallest set of tokens whose
    cumulative probability reaches top_p (tests/test_engine.py's check)."""
    r = np.random.default_rng(0)
    logits = torch.from_numpy((r.standard_normal((64, 32)) * 3).astype(np.float32))
    top_p, temp = 0.7, 0.8
    gen = torch.Generator().manual_seed(0)
    toks = sample_tokens(logits, gen, temp, top_p, False)
    assert toks.dtype == torch.int32
    p = torch.softmax(logits / temp, dim=-1).numpy()
    for i, t in enumerate(toks.tolist()):
        order = np.argsort(-p[i])
        keep = np.cumsum(p[i][order]) - p[i][order] < top_p
        assert t in set(order[keep].tolist())


def test_sampling_distribution_matches_jax():
    """4000 draws from one row: the port's and the JAX sampler's token
    frequencies both match the renormalised nucleus within 0.03."""
    r = np.random.default_rng(1)
    row = (r.standard_normal(12) * 2).astype(np.float32)
    temp, top_p, n = 0.9, 0.8, 4000
    p = np.exp(row / temp - (row / temp).max())
    p /= p.sum()
    order = np.argsort(-p)
    keep = order[np.cumsum(p[order]) - p[order] < top_p]
    target = np.zeros_like(p)
    target[keep] = p[keep] / p[keep].sum()
    logits = np.tile(row, (n, 1))
    gen = torch.Generator().manual_seed(2)
    ours = sample_tokens(torch.from_numpy(logits), gen, temp, top_p, False).numpy()
    theirs = np.asarray(jax_sample_tokens(jnp.asarray(logits), jax.random.PRNGKey(2),
                                          temp, top_p, False))
    for toks in (ours, theirs):
        freq = np.bincount(toks, minlength=len(row)) / n
        assert np.abs(freq - target).max() < 0.03, (freq, target)


def test_sampling_greedy_is_argmax():
    logits = torch.from_numpy(np.random.default_rng(1).standard_normal((8, 16)).astype(np.float32))
    toks = sample_tokens(logits, torch.Generator(), 0.5, 0.7, True)
    np.testing.assert_array_equal(toks.numpy(), logits.argmax(-1).numpy())


def test_speculative_not_ported(models):
    """Named for the refusal it once checked: ``enable_speculative`` now
    builds an engine with speculation on. The width ladder, drafting and
    verify are tests/test_torch_speculative.py's."""
    _, _, model, tp = models
    eng = InferenceEngine(model, tp, EngineConfig(device="cpu", enable_speculative=True))
    assert eng.spec_on


def _ref_greedy(model, params, prompt, n):
    """The pure-model reference of tests/test_engine.py:24-32 on the port:
    prefill over a dense ring cache, then one decode_step per token."""
    cache = model.init_cache(1, 128, device="cpu")
    lg, cache = model.prefill(params, {"tokens": torch.from_numpy(prompt)[None]}, cache,
                              RunCtx())
    out = [int(lg[0].argmax())]
    for i in range(n - 1):
        lg, cache = model.decode_step(params, torch.tensor([[out[-1]]]), cache,
                                      torch.tensor([len(prompt) + i], dtype=torch.int32),
                                      RunCtx())
        out.append(int(lg[0].argmax()))
    return out


@pytest.mark.parametrize("num_pages", [10, 64])
def test_engine_matches_model_reference(num_pages):
    """tests/test_engine.py:35-49 on the port (tiny qwen2.5): the engine's
    chunked paged path and the model's flash-prefill + ring-decode path give
    the same greedy streams, with 10 pages (9 usable, just enough for 3
    slots of 22 tokens) and with 64."""
    model = build_model(tiny_config("qwen2.5-3b"))
    params = model.init_params(0, device="cpu")
    r = np.random.default_rng(0)
    prompts = [r.integers(1, model.cfg.vocab, 10).astype(np.int32) for _ in range(5)]
    eng = InferenceEngine(model, params, EngineConfig(
        max_slots=3, page_size=8, num_pages=num_pages, max_seq=64, greedy=True, device="cpu"))
    reqs = [Request(req_id=f"x{i}", prompt_tokens=p, max_new_tokens=12)
            for i, p in enumerate(prompts)]
    eng.generate(reqs)
    eng.allocator.check_invariants()
    for req, p in zip(reqs, prompts):
        assert req.finished
        assert req.generated == _ref_greedy(model, params, p, 12)
