"""Plain PyTorch versions of the Mamba2 SSD chunk scan (arXiv:2405.21060)
and of its gradient.

``ssd_reference`` is the reference's ``repro.models.mamba.ssd_chunked``,
with its ``init_state`` and returned final state; the reference's
``lax.scan`` over chunks is a Python loop here. It is the CPU path of
``ops.ssd_chunked`` / ``ops.ssd_scan`` (autograd differentiates it there)
and the yardstick the forward kernel is held against on the card.

``ssd_reference_bwd`` is the gradient the reference takes by XLA autodiff of
``ssd_chunked``, written out with the backward kernel's formulas
(``csrc/ssd_scan_bwd.cu``) from the per-tile entry states the forward
kernel writes: the yardstick of the backward kernel on the card."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd_reference(x, dt, A, B_, C, chunk: int, init_state=None, states: bool = False):
    """x (B,L,H,P); dt (B,L,H) post-softplus; A (H,) negative; B_/C (B,L,H,N);
    init_state (B,H,P,N) or None (zeros). All math in fp32.
    Returns (y (B,L,H,P) fp32, final_state (B,H,P,N) fp32), and with
    ``states`` also the state entering each chunk (B, ceil(L/chunk), H, P, N)
    fp32: at chunk = 64 the forward kernel's per-tile entry states."""
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
    return (y, s, prev_states) if states else (y, s)


def ssd_reference_bwd(x, dt, A, B_, C, init_state, states, dy, d_final, tile: int = 64):
    """The gradients of ``ssd_reference``'s (y, final_state) with respect to
    (x, dt, A, B_, C, init_state), given dy (B,L,H,P) and d_final (B,H,P,N)
    (None: zeros) and ``states`` (B, ceil(L/tile), H, P, N), the state
    entering each tile of ``tile`` tokens. x (B,L,H,P); dt (B,L,H); A (H,);
    B_ / C (B,L,G,N) with G dividing H (head h reads group h // (H // G));
    init_state only sets d_init_state's presence (the states carry it).

    Per tile and (row, head), with a_i the inclusive cumulative sum of dt A,
    L_ij = e^{a_i - a_j} (j <= i, else 0), S the entry state, dS' the
    gradient into the exit state and D_ij = dy_i . x_j:
      dx_j  = dt_j sum_{i>=j} (C_i.B_j) L_ij dy_i + dt_j e^{a_Q-a_j} dS' B_j
      dC_i  = sum_{j<=i} L_ij dt_j D_ij B_j + e^{a_i} S^T dy_i
      dB_j  = dt_j sum_{i>=j} L_ij D_ij C_i + dt_j e^{a_Q-a_j} dS'^T x_j
      da_i  = sum_j R_ij - sum_k R_ki + e^{a_i} dy_i.(S C_i) - s_i, with
              R_ij = (C_i.B_j) L_ij dt_j D_ij, s_j = dt_j e^{a_Q-a_j} x_j^T dS' B_j;
              da_Q also gains sum_j s_j + e^{a_Q} <dS', S>
      ddt_j = sum_{i>=j} (C_i.B_j) L_ij D_ij + e^{a_Q-a_j} x_j^T dS' B_j
              + A sum_{i>=j} da_i;   dA = sum_j dt_j sum_{i>=j} da_i
      dS (into the tile before) = e^{a_Q} dS' + sum_i e^{a_i} dy_i (x) C_i.
    dB and dC sum over the heads of a group. Tokens past L are zeros with
    dt = 0 and get no gradient. Returns (dx, ddt, dA, dB, dC, d_init_state
    or None), all fp32."""
    f32 = torch.float32
    Bb, L, H, Pd = x.shape
    G, N = B_.shape[2], B_.shape[3]
    rep = H // G
    pad = (-L) % tile
    nt, Q = (L + pad) // tile, tile

    def tiles(t, *inner):
        t = t.to(f32)
        if pad:
            t = F.pad(t, (0, 0) * len(inner) + (0, pad))
        return t.reshape(Bb, nt, Q, *inner)

    xc, dyc = tiles(x, H, Pd), tiles(dy, H, Pd)
    Bc = tiles(B_.repeat_interleave(rep, 2), H, N)
    Cc = tiles(C.repeat_interleave(rep, 2), H, N)
    dtc = tiles(dt[..., None], H, 1)[..., 0].permute(0, 1, 3, 2)   # (B,nt,H,Q): dt_j
    S = states.to(f32)

    a = torch.cumsum(dtc * A.to(f32)[None, None, :, None], dim=-1)  # (B,nt,H,Q)
    aQ = a[..., -1]                                                 # (B,nt,H)
    ii = torch.arange(Q, device=x.device)
    causal = ii[:, None] >= ii[None, :]
    Lm = torch.where(causal, torch.exp(torch.where(causal, a[..., :, None] - a[..., None, :],
                                                   0.0)), 0.0)      # (B,nt,H,Q,Q) [i, j]
    CB = torch.einsum("bcihn,bcjhn->bchij", Cc, Bc)
    D = torch.einsum("bcihp,bcjhp->bchij", dyc, xc)
    Gm = CB * Lm                                   # (C_i.B_j) L_ij
    M2 = Lm * dtc[..., None, :] * D                # L_ij dt_j D_ij
    R = Gm * dtc[..., None, :] * D
    ecum = torch.exp(a)                            # e^{a_i}
    w = torch.exp(aQ[..., None] - a)               # e^{a_Q - a_j}

    # the gradient into each tile's exit state, walking the tiles backwards
    dS = (torch.zeros((Bb, H, Pd, N), dtype=f32, device=x.device) if d_final is None
          else d_final.to(f32))
    exits = [None] * nt
    for c in reversed(range(nt)):
        exits[c] = dS
        dS = (torch.exp(aQ[:, c])[..., None, None] * dS
              + torch.einsum("bhi,bihp,bihn->bhpn", ecum[:, c], dyc[:, c], Cc[:, c]))
    dSx = torch.stack(exits, 1)                    # (B,nt,H,P,N)

    U = torch.einsum("bchpn,bcjhn->bchjp", dSx, Bc)            # dS' B_j
    dx = dtc[..., None] * (torch.einsum("bchij,bcihp->bchjp", Gm, dyc) + w[..., None] * U)
    V = torch.einsum("bchpn,bcihp->bchin", S, dyc)             # S^T dy_i
    dC = torch.einsum("bchij,bcjhn->bchin", M2, Bc) + ecum[..., None] * V
    Wx = torch.einsum("bchpn,bcjhp->bchjn", dSx, xc)           # dS'^T x_j
    dB = torch.einsum("bchij,bcihn->bchjn", M2, Cc) + (dtc * w)[..., None] * Wx
    xU = torch.einsum("bcjhp,bchjp->bchj", xc, U)              # x_j^T dS' B_j
    s = dtc * w * xU
    da = (R.sum(-1) - R.sum(-2) + ecum * torch.einsum("bcihn,bchin->bchi", Cc, V) - s)
    last = s.sum(-1) + torch.exp(aQ) * torch.einsum("bchpn,bchpn->bch", dSx, S)
    da = torch.cat([da[..., :-1], (da[..., -1] + last)[..., None]], -1)
    suffix = torch.flip(torch.cumsum(torch.flip(da, [-1]), -1), [-1])   # sum_{i>=j} da_i
    ddt = (Gm * D).sum(-2) + w * xU + A.to(f32)[None, None, :, None] * suffix
    dA = (dtc * suffix).sum((0, 1, 3))

    def untile(t):               # (B,nt,H,Q,*) -> (B,L,H,*)
        t = t.movedim(3, 2).reshape(Bb, nt * Q, H, *t.shape[4:])
        return t[:, :L]

    dBg = untile(dB).reshape(Bb, L, G, rep, N).sum(3)
    dCg = untile(dC).reshape(Bb, L, G, rep, N).sum(3)
    return (untile(dx), untile(ddt[..., None])[..., 0], dA, dBg, dCg,
            dS if init_state is not None else None)
