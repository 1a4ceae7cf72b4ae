"""Plain PyTorch version of the Mamba2 SSD chunk scan (arXiv:2405.21060):
the reference's ``repro.models.mamba.ssd_chunked``, with its ``init_state``
and returned final state. The reference's ``lax.scan`` over chunks is a
Python loop here. The CPU path of ``ops.ssd_chunked`` / ``ops.ssd_scan``
and the yardstick the CUDA kernel is held against on the card."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd_reference(x, dt, A, B_, C, chunk: int, init_state=None):
    """x (B,L,H,P); dt (B,L,H) post-softplus; A (H,) negative; B_/C (B,L,H,N);
    init_state (B,H,P,N) or None (zeros). All math in fp32.
    Returns (y (B,L,H,P) fp32, final_state (B,H,P,N) fp32)."""
    Bb, L, H, Pd = x.shape
    N = B_.shape[-1]
    pad = (-L) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    Lp = L + pad
    nc, Q = Lp // chunk, chunk

    f32 = torch.float32
    xc = x.reshape(Bb, nc, Q, H, Pd).to(f32)
    dtc = dt.reshape(Bb, nc, Q, H).to(f32)
    Bc = B_.reshape(Bb, nc, Q, H, N).to(f32)
    Cc = C.reshape(Bb, nc, Q, H, N).to(f32)

    dA = dtc * A.to(f32)[None, None, None, :]             # (B,nc,Q,H) <= 0
    cum = torch.cumsum(dA, dim=2)                         # inclusive

    # within-chunk (quadratic) term; the decay is taken only where j <= i
    # (above the diagonal its exponent is positive and may overflow)
    CB = torch.einsum("bcihn,bcjhn->bchij", Cc, Bc)        # (B,nc,H,Q,Q)
    cum_h = cum.permute(0, 1, 3, 2)                       # (B,nc,H,Q)
    ii = torch.arange(Q, device=x.device)
    causal = ii[:, None] >= ii[None, :]
    diff = torch.where(causal, cum_h[..., :, None] - cum_h[..., None, :], -torch.inf)
    M = CB * torch.exp(diff) * dtc.permute(0, 1, 3, 2)[..., None, :]
    y_diag = torch.einsum("bchij,bcjhp->bcihp", M, xc)

    # per-chunk input states and the cross-chunk recurrence
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)        # (B,nc,Q,H)
    S_c = torch.einsum("bcjh,bcjhn,bcjhp->bchpn", decay_out * dtc, Bc, xc)  # (B,nc,H,P,N)
    T_c = torch.exp(cum[:, :, -1, :])                     # (B,nc,H)

    s = (torch.zeros((Bb, H, Pd, N), dtype=f32, device=x.device) if init_state is None
         else init_state.to(f32))
    prev = []
    for c in range(nc):                                   # state BEFORE each chunk
        prev.append(s)
        s = s * T_c[:, c, :, None, None] + S_c[:, c]
    prev_states = torch.stack(prev, 1)                    # (B,nc,H,P,N)

    y_off = torch.einsum("bcihn,bchpn->bcihp", Cc, prev_states) * torch.exp(cum)[..., None]
    y = (y_diag + y_off).reshape(Bb, Lp, H, Pd)[:, :L]
    return y, s
