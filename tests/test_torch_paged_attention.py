"""Port's chunked paged attention vs the JAX package: the plain PyTorch
version against the JAX Pallas kernel (interpret mode), the JAX gather
reference and a brute-force numpy oracle, at 1e-5 (all fp32; the paths
differ in reduction order only). The CUDA kernel against the plain version
is in test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import (chunked_prefill_attention as jax_attention,
                                           chunked_prefill_reference as jax_reference)
from repro_torch.kernels.paged_attention import (chunked_prefill_attention,
                                                 chunked_prefill_cuda,
                                                 chunked_prefill_reference)

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
