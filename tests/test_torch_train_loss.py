"""``LM.loss`` of the port against the JAX package's, on tiny fp32 configs
with parameters carried over by ``params_from_numpy``: the loss on all 11
archs (the reference with ``attn_backend="xla"``, ``moe_strategy=
"capacity"``), within 1e-5; the chunked cross-entropy and remat on the
port's side. The gradients against ``jax.grad`` are in
test_torch_train_grads.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import tiny_config as jax_tiny_config
from repro.models import RunCtx as JaxRunCtx
from repro.models import build_model as jax_build_model
from repro_torch.configs import ALL_ARCHS, tiny_config
from repro_torch.models import RunCtx, build_model
from repro_torch.models.params import params_from_numpy, tree_leaves, tree_unflatten

LOSS_TOL = 1e-5
JAX_CTX = JaxRunCtx(mode="train", attn_backend="xla", moe_strategy="capacity")
CTX = RunCtx(mode="train", moe_strategy="capacity")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny tensors: one intra-op thread, so the suite's parallel workers do
    not oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def train_batch(cfg, B=2, S=24, seed=0):
    """Tokens and labels (a few masked with -1), with frames for an enc-dec
    config and patches for a VLM, as numpy."""
    r = np.random.default_rng(seed)
    b = {"tokens": r.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "labels": r.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    b["labels"][0, :3] = -1
    if cfg.encoder is not None:
        b["frames"] = r.standard_normal((B, cfg.encoder.cross_attn_memory,
                                         cfg.d_model)).astype(np.float32)
    if cfg.vision is not None:
        b["patches"] = r.standard_normal((B, cfg.vision.n_patches,
                                          cfg.vision.d_patch)).astype(np.float32)
    return b


def pair(name):
    """(JAX model, JAX params, port model, port params on the CPU)."""
    jm = jax_build_model(jax_tiny_config(name))
    jp = jm.init_params(jax.random.PRNGKey(0))
    return jm, jp, build_model(tiny_config(name)), params_from_numpy(
        jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_loss_matches_jax(arch):
    jm, jp, model, params = pair(arch)
    b = train_batch(model.cfg)
    jl, jmet = jax.jit(lambda p, bb: jm.loss(p, bb, JAX_CTX))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    loss, met = model.loss(params, tb, CTX)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss), float(jl), atol=LOSS_TOL, rtol=LOSS_TOL)
    np.testing.assert_allclose(float(met["xent"]), float(jmet["xent"]), atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(float(met["aux"]), float(jmet["aux"]), atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    # the chunked cross-entropy (7 does not divide 24: a padded last chunk)
    chunked, _ = model.loss(params, tb, CTX, xent_chunk=7)
    np.testing.assert_allclose(float(chunked), float(loss), atol=LOSS_TOL)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mixtral-8x7b"])
def test_chunked_xent_and_remat_give_the_same_gradients(arch):
    """``xent_chunk`` (each chunk recomputed in the backward) and
    ``ctx.remat`` (each layer recomputed) change what is kept, not what is
    computed: the full loss's gradients, as tests/test_checkpoint_train.py
    holds the reference's (1e-4), and remat's within 1e-6."""
    _, _, model, params = pair(arch)
    tb = {k: torch.from_numpy(v) for k, v in train_batch(model.cfg).items()}

    def grads(ctx, **kw):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        loss, _ = model.loss(tree_unflatten(params, leaves), tb, ctx, **kw)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    l0, g0 = grads(CTX)
    l1, g1 = grads(CTX, xent_chunk=7)
    l2, g2 = grads(RunCtx(mode="train", moe_strategy="capacity", remat=True))
    assert abs(l0 - l1) < 1e-4 and abs(l0 - l2) < 1e-6
    assert max(float((a - b).abs().max()) for a, b in zip(g0, g1)) < 1e-4
    for a, b in zip(g0, g2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6 * max(1.0, float(a.abs().max())))
