"""Port's paged attention vs the JAX package. Chunked prefill: the plain
PyTorch version against the JAX Pallas kernel (interpret mode), the JAX
gather reference and a brute-force numpy oracle, at 1e-5. Decode (one query
token per row): the plain version against the JAX Pallas kernel and
reference on the sweep of tests/test_kernels_paged.py, at its tolerances
(2e-5 fp32, 3e-2 bf16). All fp32 paths differ in reduction order only. The
CUDA kernels against the plain versions are in test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import (chunked_prefill_attention as jax_attention,
                                           chunked_prefill_reference as jax_reference)
from repro.kernels.paged_attention import paged_attention as jax_paged
from repro.kernels.paged_attention import paged_attention_reference as jax_paged_reference
from repro_torch.kernels.paged_attention import (chunked_prefill_attention,
                                                 chunked_prefill_cuda,
                                                 chunked_prefill_reference, paged_attention,
                                                 paged_attention_cuda,
                                                 paged_attention_reference)

TOL = 1e-5


def _case(seed, *, ps, B=4, C=8, H=4, Hkv=2, D=16, maxp=8, starts=(5, 0, 13, 0),
          nvalid=(8, 6, 3, 0)):
    """Row 3 is idle (length 0): it must give zeros, not NaN."""
    rng = np.random.default_rng(seed)
    P = B * maxp + 1
    kp = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, ps, Hkv, D)).astype(np.float32)
    pt = np.array([[1 + b * maxp + i for i in range(maxp)] for b in range(B)], np.int32)
    starts = np.asarray(starts[:B], np.int32)
    nvalid = np.asarray(nvalid[:B], np.int32)
    lengths = (starts + nvalid).astype(np.int32)
    q = rng.standard_normal((B, C, H, D)).astype(np.float32)
    qpos = (starts[:, None] + np.arange(C)[None]).astype(np.int32)
    return q, kp, vp, pt, lengths, qpos, nvalid


def _oracle(q, kp, vp, pt, lengths, qpos, *, window, softcap):
    B, C, H, D = q.shape
    ps, Hkv = kp.shape[1], kp.shape[2]
    maxp = pt.shape[1]
    kg = kp[pt].reshape(B, maxp * ps, Hkv, D)
    vg = vp[pt].reshape(B, maxp * ps, Hkv, D)
    out = np.zeros_like(q)
    kv = np.arange(maxp * ps)
    for b in range(B):
        for i in range(C):
            p_abs = int(qpos[b, i])
            for h in range(H):
                hk = h // (H // Hkv)
                s = (kg[b, :, hk] @ q[b, i, h]) * (D ** -0.5)
                if softcap > 0:
                    s = softcap * np.tanh(s / softcap)
                m = (kv < lengths[b]) & (kv <= p_abs)
                if window > 0:
                    m &= kv > p_abs - window
                s = np.where(m, s, -1e30)
                w = np.where(m, np.exp(s - s.max()), 0.0)
                if w.sum() > 0:
                    w /= w.sum()
                out[b, i, h] = w @ vg[b, :, hk]
    return out


@pytest.mark.parametrize("ps,window,softcap", [(4, 0, 0.0), (4, 5, 0.0), (8, 0, 2.0),
                                               (16, 3, 2.0)])
def test_plain_matches_jax_and_oracle(ps, window, softcap):
    q, kp, vp, pt, lengths, qpos, nvalid = _case(ps, ps=ps)
    kw = dict(scale=q.shape[-1] ** -0.5, softcap=softcap, window=window)
    port = chunked_prefill_attention(*map(torch.from_numpy, (q, kp, vp, pt, lengths, qpos)),
                                     **kw).numpy()
    direct = chunked_prefill_reference(*map(torch.from_numpy, (q, kp, vp, pt, lengths, qpos)),
                                       **kw).numpy()
    jq = [jnp.asarray(a) for a in (q, kp, vp, pt, lengths, qpos)]
    ref = np.asarray(jax_reference(*jq, **kw))
    pal = np.asarray(jax_attention(*jq, backend="pallas", interpret=True, **kw))
    oracle = _oracle(q, kp, vp, pt, lengths, qpos, window=window, softcap=softcap)

    np.testing.assert_array_equal(port, direct)
    assert np.isfinite(port).all()
    np.testing.assert_allclose(port, ref, atol=TOL, rtol=0)
    for b, n in enumerate(nvalid):           # live positions of each row
        np.testing.assert_allclose(port[b, :n], pal[b, :n], atol=TOL, rtol=0)
        np.testing.assert_allclose(port[b, :n], oracle[b, :n], atol=TOL, rtol=0)
    assert not port[3].any(), "a length-0 row must give zeros"


def test_plain_keeps_q_dtype_and_bf16_pool():
    q, kp, vp, pt, lengths, qpos, _ = _case(1, ps=8)
    args = [torch.from_numpy(a) for a in (q, kp, vp, pt, lengths, qpos)]
    args[1], args[2] = args[1].bfloat16(), args[2].bfloat16()
    out = chunked_prefill_attention(*args)
    assert out.dtype == torch.float32 and out.shape == q.shape
    full = chunked_prefill_attention(args[0], args[1].float(), args[2].float(), *args[3:])
    np.testing.assert_array_equal(out.numpy(), full.numpy())


def test_cuda_wrapper_rejects_cpu_tensors():
    q, kp, vp, pt, lengths, qpos, _ = _case(2, ps=4)
    t = [torch.from_numpy(a) for a in (q, kp, vp, pt, lengths, qpos[:, 0].copy())]
    with pytest.raises(ValueError, match="CUDA"):
        chunked_prefill_cuda(*t, scale=0.25)


# ---------------------------------------------------------------- decode
def _decode_case(seed, *, H, Hkv, D, ps, B=3, P=24, maxp=5, lengths=None, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(dtype)
    kp = rng.standard_normal((P, ps, Hkv, D)).astype(dtype)
    vp = rng.standard_normal((P, ps, Hkv, D)).astype(dtype)
    pt = rng.integers(1, P, (B, maxp)).astype(np.int32)
    if lengths is None:
        lengths = [1, ps * 2 + 3, maxp * ps]
    return q, kp, vp, pt, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("H,Hkv,D", [(8, 2, 16), (4, 4, 32), (8, 1, 64)])
@pytest.mark.parametrize("page_size", [4, 8])
@pytest.mark.parametrize("window", [0, 9])
def test_decode_plain_matches_jax(H, Hkv, D, page_size, window):
    args = _decode_case(H * D + page_size + window, H=H, Hkv=Hkv, D=D, ps=page_size)
    port = paged_attention(*map(torch.from_numpy, args), window=window).numpy()
    direct = paged_attention_reference(*map(torch.from_numpy, args), window=window).numpy()
    jargs = [jnp.asarray(a) for a in args]
    ref = np.asarray(jax_paged_reference(*jargs, window=window))
    pal = np.asarray(jax_paged(*jargs, window=window, backend="pallas", interpret=True))
    np.testing.assert_array_equal(port, direct)
    np.testing.assert_allclose(port, ref, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(port, pal, atol=2e-5, rtol=2e-5)


def test_decode_plain_bf16():
    q, kp, vp, pt, lengths = _decode_case(7, H=4, Hkv=2, D=32, ps=8, B=2, P=16, maxp=4,
                                          lengths=[7, 30])
    jargs = [jnp.asarray(q, jnp.bfloat16), jnp.asarray(kp, jnp.bfloat16),
             jnp.asarray(vp, jnp.bfloat16), jnp.asarray(pt), jnp.asarray(lengths)]
    pal = np.asarray(jax_paged(*jargs, backend="pallas", interpret=True), np.float32)
    t = [torch.from_numpy(a) for a in (q, kp, vp, pt, lengths)]
    out = paged_attention(t[0].bfloat16(), t[1].bfloat16(), t[2].bfloat16(), t[3], t[4])
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), pal, atol=3e-2, rtol=3e-2)


def test_decode_plain_softcap():
    args = _decode_case(8, H=4, Hkv=2, D=16, ps=4, B=2, P=8, maxp=3, lengths=[5, 12])
    port = paged_attention(*map(torch.from_numpy, args), softcap=30.0).numpy()
    pal = np.asarray(jax_paged(*[jnp.asarray(a) for a in args], softcap=30.0,
                               backend="pallas", interpret=True))
    np.testing.assert_allclose(port, pal, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("window", [0, 3])
def test_decode_length_zero_gives_zeros(window):
    args = _decode_case(9, H=4, Hkv=2, D=16, ps=4, lengths=[0, 6, 0])
    port = paged_attention(*map(torch.from_numpy, args), window=window).numpy()
    ref = np.asarray(jax_paged_reference(*[jnp.asarray(a) for a in args], window=window))
    assert np.isfinite(port).all() and not port[0].any() and not port[2].any()
    np.testing.assert_allclose(port, ref, atol=2e-5, rtol=2e-5)


def test_decode_cuda_wrapper_rejects_cpu_tensors():
    t = [torch.from_numpy(a) for a in _decode_case(10, H=4, Hkv=2, D=16, ps=4)]
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_cuda(*t, scale=0.25)
