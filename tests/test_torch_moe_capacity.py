"""The port's capacity MoE strategy (the training path) against the JAX
package's, mirroring tests/test_moe.py without shard_map: the router, the
capacity layer with and without dropped assignments, the dispatch / combine
identity, capacity == dropless when nothing is dropped, and the strategy
knob. fp32, tolerance 1e-5 (the two differ in the order of their sums)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import tiny_config as jax_tiny_config
from repro.models import RunCtx as JaxRunCtx
from repro.models import moe as jax_moe
from repro_torch.configs import tiny_config
from repro_torch.models import RunCtx
from repro_torch.models import moe
from repro_torch.quant import quantize_leaf

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny tensors: one intra-op thread, so the suite's parallel workers do
    not oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layer(name, seed=0, T=24, factor=None):
    """A MoE layer's parameters (one repeat of the tiny config) and T
    tokens, as numpy; the port's and the reference's configs, with the
    capacity factor replaced when given."""
    cfg, jcfg = tiny_config(name), jax_tiny_config(name)
    if factor is not None:
        cfg = cfg.scaled(moe=dataclasses.replace(cfg.moe, capacity_factor=factor))
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=factor))
    r = np.random.default_rng(seed)
    d, E, f = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_expert or cfg.d_ff
    p = {"router": r.standard_normal((d, E)) * 0.5, "wg": r.standard_normal((E, d, f)) * 0.1,
         "wu": r.standard_normal((E, d, f)) * 0.1, "wd": r.standard_normal((E, f, d)) * 0.1}
    if cfg.moe.num_shared_experts:
        fs = f * cfg.moe.num_shared_experts
        p["shared"] = {"wi": r.standard_normal((d, fs)) * 0.1, "wg": r.standard_normal((d, fs)) * 0.1,
                       "wo": r.standard_normal((fs, d)) * 0.1}
    p = {k: ({kk: vv.astype(np.float32) for kk, vv in v.items()} if isinstance(v, dict)
             else v.astype(np.float32)) for k, v in p.items()}
    xf = r.standard_normal((T, d)).astype(np.float32)
    return cfg, jcfg, p, xf


def _torch(p):
    return {k: (_torch(v) if isinstance(v, dict) else torch.from_numpy(v)) for k, v in p.items()}


def _jax(p):
    return {k: (_jax(v) if isinstance(v, dict) else jnp.asarray(v)) for k, v in p.items()}


@pytest.mark.parametrize("name,factor", [("mixtral-8x7b", None), ("mixtral-8x7b", 0.5),
                                         ("dbrx-132b", None), ("deepseek-moe-16b", 0.75)])
def test_capacity_matches_reference(name, factor):
    """moe_capacity on the same weights and tokens: output and aux loss.
    Factor 0.5 / 0.75 makes the buffers too small, so assignments drop."""
    cfg, jcfg, p, xf = _layer(name, T=40, factor=factor)
    y, aux = moe.moe_capacity(_torch(p), torch.from_numpy(xf), cfg, RunCtx())
    jy, jaux = jax_moe.moe_capacity(_jax(p), jnp.asarray(xf), jcfg,
                                    JaxRunCtx(moe_strategy="capacity"))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), atol=TOL)
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    cap = moe._round_up(max(int(np.ceil(40 * K / E * cfg.moe.capacity_factor)), 8), 8)
    _, topi, _ = moe.router_topk(torch.from_numpy(xf), torch.from_numpy(p["router"]), K)
    _, (_, _, keep) = moe.capacity_dispatch(torch.from_numpy(xf), topi, E, cap)
    assert bool((~keep).any()) == (factor is not None)


def test_router_matches_reference():
    r = np.random.default_rng(1)
    xf, w = r.standard_normal((33, 16)).astype(np.float32), r.standard_normal((16, 6)).astype(np.float32)
    topw, topi, aux = moe.router_topk(torch.from_numpy(xf), torch.from_numpy(w), 2)
    jw, ji, jaux = jax_moe.router_topk(jnp.asarray(xf), jnp.asarray(w), 2)
    np.testing.assert_allclose(topw.numpy(), np.asarray(jw), atol=TOL)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(float(aux), float(jaux), atol=TOL)


def test_dispatch_matches_reference():
    """The same slots, trash rows and keep mask as the reference's scatter."""
    r = np.random.default_rng(2)
    xf = r.standard_normal((30, 4)).astype(np.float32)
    topi = r.integers(0, 5, (30, 2))
    ebuf, (e, p, keep) = moe.capacity_dispatch(torch.from_numpy(xf), torch.from_numpy(topi), 5, 8)
    jbuf, (je, jp, jkeep) = jax_moe.capacity_dispatch(jnp.asarray(xf), jnp.asarray(topi, jnp.int32),
                                                      5, 8)
    np.testing.assert_array_equal(ebuf.numpy(), np.asarray(jbuf))
    for a, b in ((e, je), (p, jp), (keep, jkeep)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (~keep).any()


@settings(max_examples=15, deadline=None)
@given(st.integers(1, 40), st.integers(2, 6), st.integers(1, 3), st.integers(2, 16))
def test_capacity_dispatch_combine_identity(T, E, K, cap):
    """With the identity as every expert, dispatch + combine returns
    sum_k w_k x for the assignments that fit; dropped ones add 0."""
    K = min(K, E)
    r = np.random.default_rng(T + E + K + cap)
    xf = torch.from_numpy(r.standard_normal((T, 4)).astype(np.float32))
    topi = torch.from_numpy(r.integers(0, E, (T, K)))
    topw = torch.ones((T, K)) / K
    ebuf, info = moe.capacity_dispatch(xf, topi, E, cap)
    y = moe.capacity_combine(ebuf, info, topw)
    keep = info[2].reshape(T, K).numpy()
    expect = (xf.numpy()[:, None, :] * keep[:, :, None]).sum(1) / K
    np.testing.assert_allclose(y.numpy(), expect, atol=TOL)


@pytest.mark.parametrize("name", ["mixtral-8x7b", "deepseek-moe-16b"])
def test_capacity_equals_dropless_when_nothing_drops(name):
    """A capacity factor of E / K leaves room for every assignment: the two
    strategies then compute the same layer."""
    cfg, _, p, xf = _layer(name, T=16)
    cfg = cfg.scaled(moe=dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.num_experts
                                             / cfg.moe.top_k))
    h = torch.from_numpy(xf)[None]
    yc, ac = moe.moe_sublayer(_torch(p), h, cfg, RunCtx(moe_strategy="capacity"))
    yd, ad = moe.moe_sublayer(_torch(p), h, cfg, RunCtx(moe_strategy="dropless"))
    np.testing.assert_allclose(yc.numpy(), yd.numpy(), atol=TOL, rtol=TOL)
    assert float(ac) == float(ad)


def test_strategy_knob():
    """The port's default stays dropless (its engine's); a shard_map
    strategy without a mesh runs capacity, as the reference's
    (``repro/models/moe.py:241``); an unknown strategy and capacity on an
    int8 tree raise."""
    assert RunCtx().moe_strategy == "dropless" and RunCtx().remat is False
    cfg, _, p, xf = _layer("mixtral-8x7b", T=8)
    h = torch.from_numpy(xf)[None]
    yc, ac = moe.moe_sublayer(_torch(p), h, cfg, RunCtx(moe_strategy="capacity"))
    for strategy in ("tp_shardmap", "ep_shardmap"):
        y, a = moe.moe_sublayer(_torch(p), h, cfg, RunCtx(moe_strategy=strategy))
        assert torch.equal(y, yc) and float(a) == float(ac)
    with pytest.raises(ValueError, match="moe_strategy"):
        moe.moe_sublayer(_torch(p), h, cfg, RunCtx(moe_strategy="expert_choice"))
    q = dict(_torch(p), wg=quantize_leaf(torch.from_numpy(p["wg"])))
    with pytest.raises(NotImplementedError, match="int8"):
        moe.moe_sublayer(q, h, cfg, RunCtx(moe_strategy="capacity"))
