"""The port's training gradients (autograd through ``LM.loss``) against
``jax.grad`` of the JAX package's loss on the same tiny fp32 parameters:
every leaf within 1e-4 of its max |g|, on qwen2.5-3b (dense, QKV bias),
mixtral-8x7b (the capacity MoE), gemma2-27b (window and softcap),
jamba-v0.1-52b (the plain SSD scan and MoE), mamba2-1.3b (SSD layers only)
and seamless-m4t-large-v2 (encoder and cross attention); with remat on, as
the trainer runs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.models import RunCtx
from repro_torch.models.params import tree_leaves, tree_unflatten
from test_torch_train_loss import JAX_CTX, one_thread, pair, train_batch  # noqa: F401

GRAD_TOL = 1e-4


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mixtral-8x7b", "gemma2-27b",
                                  "jamba-v0.1-52b", "mamba2-1.3b", "seamless-m4t-large-v2"])
def test_grads_match_jax(arch):
    jm, jp, model, params = pair(arch)
    b = train_batch(model.cfg)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jg = jax.jit(jax.grad(lambda p: jm.loss(p, jb, JAX_CTX)[0]))(jp)
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    loss, _ = model.loss(tree_unflatten(params, leaves), {k: torch.from_numpy(v)
                                                          for k, v in b.items()},
                         RunCtx(mode="train", moe_strategy="capacity", remat=True))
    grads = torch.autograd.grad(loss, leaves)
    want = jax.tree.leaves(jg)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g.numpy() - w).max()) <= GRAD_TOL * scale
