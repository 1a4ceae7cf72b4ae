"""Port's flash attention vs the JAX package: the plain PyTorch version (what
the op runs on CPU tensors) against the JAX Pallas kernel in interpret mode
and the JAX masked-softmax oracle, on the cases of tests/test_kernels_flash.py,
at their fp32 tolerance 2e-5 (the paths differ in reduction order only).
The CUDA kernel against the plain version is in test_torch_cuda.py (the
card's machine has no JAX)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention import mha_reference as jax_reference
from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_cuda,
                                                 mha_reference)

TOL = 2e-5
CASES = [
    # B, Sq, Skv, H, Hkv, D, causal, window, softcap, q_offset
    (2, 64, 64, 4, 2, 16, True, 0, 0.0, 0),
    (1, 128, 128, 8, 8, 32, True, 0, 0.0, 0),       # MHA
    (2, 64, 64, 4, 1, 16, True, 0, 0.0, 0),         # MQA
    (1, 96, 96, 4, 2, 64, True, 32, 0.0, 0),        # sliding window
    (1, 64, 64, 4, 4, 16, True, 0, 50.0, 0),        # softcap (gemma2)
    (2, 32, 96, 2, 2, 16, True, 0, 0.0, 64),        # chunked-prefill offset
    (2, 48, 48, 4, 2, 16, False, 0, 0.0, 0),        # encoder (non-causal)
    (1, 80, 80, 4, 2, 16, True, 16, 30.0, 0),       # window + softcap
]


def _inputs(seed, B, Sq, Skv, H, Hkv, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax(case):
    B, Sq, Skv, H, Hkv, D, causal, window, softcap, qoff = case
    q, k, v = _inputs(sum(case[:6]), B, Sq, Skv, H, Hkv, D)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=qoff)
    port = flash_attention(*map(torch.from_numpy, (q, k, v)), **kw).numpy()
    jq = [jnp.asarray(a) for a in (q, k, v)]
    ref = np.asarray(jax_reference(*jq, **kw))
    pal = np.asarray(jax_flash(*jq, block_q=16, block_kv=32, backend="pallas", interpret=True,
                               **kw))
    assert port.shape == (B, Sq, H, D) and np.isfinite(port).all()
    np.testing.assert_allclose(port, ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(port, pal, atol=TOL, rtol=TOL)


def test_ragged_block_sizes():
    """Sq / Skv of no block multiple (the kernel masks the edges itself)."""
    q, k, v = _inputs(3, 1, 50, 70, 4, 2, 16)
    port = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=False).numpy()
    jq = [jnp.asarray(a) for a in (q, k, v)]
    pal = np.asarray(jax_flash(*jq, causal=False, block_q=16, block_kv=32, backend="pallas",
                               interpret=True))
    np.testing.assert_allclose(port, pal, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(port, np.asarray(jax_reference(*jq, causal=False)),
                               atol=TOL, rtol=TOL)


def test_reference_lengths_and_empty_rows():
    """``lengths`` masks kv positions; a row that sees no key (length 0, or
    a window that ends before the first key) gives zeros, not NaN."""
    q, k, v = _inputs(4, 3, 12, 12, 4, 2, 16)
    lengths = np.asarray([12, 5, 0], np.int32)
    kw = dict(causal=True, window=4, q_offset=2)
    port = mha_reference(*map(torch.from_numpy, (q, k, v)), lengths=torch.from_numpy(lengths),
                         **kw).numpy()
    ref = np.asarray(jax_reference(*[jnp.asarray(a) for a in (q, k, v)],
                                   lengths=jnp.asarray(lengths), **kw))
    assert np.isfinite(port).all() and not port[2].any()
    np.testing.assert_allclose(port, ref, atol=TOL, rtol=TOL)
    # q_offset beyond the window: row 0 at position 2 sees keys 0-2 only
    np.testing.assert_allclose(port[:, 0], ref[:, 0], atol=TOL, rtol=TOL)


def test_plain_bf16_keeps_dtype():
    q, k, v = _inputs(5, 2, 33, 33, 4, 2, 16)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    out = flash_attention(*[a.bfloat16() for a in t], window=8, softcap=50.0)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 33, 4, 16)
    full = flash_attention(*[a.bfloat16().float() for a in t], window=8, softcap=50.0)
    np.testing.assert_allclose(out.float().numpy(), full.numpy(), atol=2e-2, rtol=2e-2)


def test_cuda_wrapper_rejects_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _inputs(6, 1, 8, 8, 2, 1, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v, causal=True, scale=0.25)
