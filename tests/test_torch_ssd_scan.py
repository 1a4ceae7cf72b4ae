"""Port's SSD chunk scan (plain version, as the CPU path of the ops) vs the
JAX package on the same numpy inputs: ``ssd_scan`` against the Pallas
kernel in interpret mode on tests/test_kernels_ssd.py's cases, and
``ssd_chunked`` with a carried ``init_state`` against the reference's
``ssd_chunked``, y and final state, including the half-then-half
continuation. Then the properties the kernel relies on: B / C read per
group, and padded tokens (dt = 0) leaving the state untouched."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.models.mamba import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_reference, ssd_scan, ssd_scan_cuda

TOL = 1e-4        # tests/test_kernels_ssd.py and tests/test_mamba.py (fp32)
BF16_TOL = 5e-2   # tests/test_kernels_ssd.py (bf16 inputs, fp32 math)


def _inputs(seed, Bb, L, H, P, N, G=None):
    """x, dt, A, B_, C as numpy (B_ / C over G groups, H by default)."""
    r = np.random.default_rng(seed)
    G = G or H
    return (r.standard_normal((Bb, L, H, P)).astype(np.float32),
            r.uniform(0.01, 0.2, (Bb, L, H)).astype(np.float32),
            -r.uniform(0.5, 2.0, (H,)).astype(np.float32),
            r.standard_normal((Bb, L, G, N)).astype(np.float32),
            r.standard_normal((Bb, L, G, N)).astype(np.float32))


def _t(*arrs, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


@pytest.mark.parametrize("Bb,L,H,P,N,Q", [
    (2, 32, 3, 8, 4, 8),
    (1, 24, 2, 16, 8, 8),
    (1, 16, 1, 4, 2, 16),     # single chunk
    (2, 27, 2, 8, 4, 8),      # ragged length
])
def test_ssd_scan_matches_pallas(Bb, L, H, P, N, Q):
    x, dt, A, B_, C = _inputs(L, Bb, L, H, P, N)
    ref = jax_ssd_scan(*map(jnp.asarray, (x, dt, A, B_, C)), Q, backend="pallas",
                       interpret=True)
    out = ssd_scan(*_t(x, dt, A, B_, C), Q)
    assert out.dtype == torch.float32 and out.shape == (Bb, L, H, P)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


def test_ssd_scan_bf16_matches_pallas():
    x, dt, A, B_, C = _inputs(5, 1, 16, 2, 8, 4)
    bf = jnp.bfloat16
    ref = jax_ssd_scan(jnp.asarray(x, bf), jnp.asarray(dt), jnp.asarray(A),
                       jnp.asarray(B_, bf), jnp.asarray(C, bf), 8, backend="pallas",
                       interpret=True)
    xb, Bb_, Cb = _t(x, B_, C, dtype=torch.bfloat16)
    out = ssd_scan(xb, *_t(dt, A), Bb_, Cb, 8)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("L,chunk", [(16, 4), (17, 4), (32, 8), (8, 16), (40, 16)])
def test_ssd_chunked_with_state_matches_jax(L, chunk):
    x, dt, A, B_, C = _inputs(L + chunk, 2, L, 3, 4, 5)
    s0 = np.random.default_rng(7).standard_normal((2, 3, 4, 5)).astype(np.float32)
    y_ref, s_ref = jax_ssd_chunked(*map(jnp.asarray, (x, dt, A, B_, C)), chunk,
                                   init_state=jnp.asarray(s0))
    y, s = ssd_chunked(*_t(x, dt, A, B_, C), chunk, init_state=torch.from_numpy(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=TOL, rtol=TOL)


def test_half_then_half_continuation_matches_jax():
    """tests/test_mamba.py::test_init_state_continuation on the port, against
    the JAX full-sequence scan."""
    x, dt, A, B_, C = _inputs(11, 1, 16, 2, 3, 4)
    y_full, s_full = jax_ssd_chunked(*map(jnp.asarray, (x, dt, A, B_, C)), 4)
    tx, tdt, tA, tB, tC = _t(x, dt, A, B_, C)
    h = 8
    y1, s1 = ssd_chunked(tx[:, :h], tdt[:, :h], tA, tB[:, :h], tC[:, :h], 4)
    y2, s2 = ssd_chunked(tx[:, h:], tdt[:, h:], tA, tB[:, h:], tC[:, h:], 4, init_state=s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), np.asarray(y_full), atol=TOL)
    np.testing.assert_allclose(s2.numpy(), np.asarray(s_full), atol=TOL)


@pytest.mark.parametrize("G", [1, 2])
def test_grouped_b_c_equal_the_repeated_layout(G):
    """B_ / C given per group (G < H) give the scan over the reference's
    layout, where each group is repeated over its H // G heads."""
    x, dt, A, B_, C = _inputs(G, 2, 20, 4, 8, 6, G=G)
    tx, tdt, tA, tB, tC = _t(x, dt, A, B_, C)
    y, s = ssd_chunked(tx, tdt, tA, tB, tC, 8)
    rep = 4 // G
    y_ref, s_ref = ssd_reference(tx, tdt, tA, tB.repeat_interleave(rep, 2),
                                 tC.repeat_interleave(rep, 2), 8)
    torch.testing.assert_close(y, y_ref, atol=1e-6, rtol=0)
    torch.testing.assert_close(s, s_ref, atol=1e-6, rtol=0)


def test_padded_tokens_leave_the_state_untouched():
    """The engine's ragged rows: dt = 0 past a row's live tokens, garbage x /
    B / C there. The final state and the live outputs equal the scan of the
    live tokens alone."""
    x, dt, A, B_, C = _inputs(3, 2, 24, 2, 8, 4)
    nvalid = [24, 9]
    s0 = np.random.default_rng(4).standard_normal((2, 2, 8, 4)).astype(np.float32)
    tx, tdt, tA, tB, tC, ts0 = _t(x, dt, A, B_, C, s0)
    live = torch.arange(24)[None, :, None] < torch.tensor(nvalid)[:, None, None]
    y, s = ssd_chunked(tx, torch.where(live, tdt, 0.0), tA, tB, tC, 16, init_state=ts0)
    for b, n in enumerate(nvalid):
        sl = slice(b, b + 1)
        y1, s1 = ssd_chunked(tx[sl, :n], tdt[sl, :n], tA, tB[sl, :n], tC[sl, :n], 16,
                             init_state=ts0[sl])
        torch.testing.assert_close(y[sl, :n], y1, atol=1e-5, rtol=0)
        torch.testing.assert_close(s[sl], s1, atol=1e-5, rtol=0)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper takes CUDA tensors only; the ops reach it only
    for CUDA tensors (no fallback in either direction)."""
    x, dt, A, B_, C = _t(*_inputs(0, 1, 8, 2, 4, 4))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_cuda(x, dt, A, B_, C)
    with pytest.raises(ValueError, match="chunk"):
        ssd_chunked(x, dt, A, B_, C, 0)
