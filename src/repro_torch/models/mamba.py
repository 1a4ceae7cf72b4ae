"""Mamba2 layer via SSD (state-space duality, arXiv:2405.21060), as the
reference's ``repro.models.mamba``.

Train / forward, prefill and the serving engine's multi-token chunks run the
chunked scan through ``kernels.ssd_scan.ops.ssd_chunked`` (the CUDA kernel on
the card, the plain version on the CPU). Decode, and a serving chunk of one
token, is the O(1) state update in plain PyTorch, as in the reference.

Cache per layer: {"state": (B, H, P, N) fp32, "conv": (B, conv_dim, d_conv-1)}.
It is written in place, as the rest of the port writes its caches; the
reference returns a new one. The depthwise convolution runs in fp32 through
``F.conv1d``; on the card cuDNN may use TF32 for it unless
``torch.backends.cudnn.allow_tf32`` is off.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import ssd_chunked
from repro_torch.models.common import RunCtx, dequant, linear, rmsnorm


def _split_proj(zxbcdt, cfg: ModelConfig):
    d_in = cfg.d_inner
    GN = cfg.ssm.n_groups * cfg.ssm.d_state
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:2 * d_in + 2 * GN]
    dt = zxbcdt[..., 2 * d_in + 2 * GN:]
    return z, xbc, dt


def _conv_carry(xbc, conv_state, conv_w, conv_b):
    """Causal depthwise conv continuing from a carried tail. xbc (B,S,C);
    conv_state (B,C,K-1) holds the K-1 inputs preceding the chunk (zeros at
    sequence start). Returns (out (B,S,C), window (B, K-1+S, C)): the window
    is reused by the caller to slice the next carry at a ragged boundary."""
    C = xbc.shape[-1]
    window = torch.cat([conv_state.transpose(1, 2).to(xbc.dtype), xbc], dim=1)
    out = F.conv1d(window.transpose(1, 2).float(), conv_w.float()[:, None, :], groups=C)
    # (B,S,C) row-major: the scan reads x / B / C as rows of this output
    out = out.transpose(1, 2).contiguous() + conv_b.float()[None, None, :]
    return F.silu(out).to(xbc.dtype), window


def _conv_full(xbc, conv_w, conv_b):
    """Causal depthwise conv over the sequence from zeros. xbc (B,S,C);
    conv_w (C, K)."""
    B, _, C = xbc.shape
    zeros = xbc.new_zeros((B, C, conv_w.shape[-1] - 1))
    return _conv_carry(xbc, zeros, conv_w, conv_b)[0]


def _conv_step(xbc_new, conv_state, conv_w, conv_b):
    """xbc_new (B,1,C); conv_state (B,C,K-1). Returns (out (B,1,C), new_state)."""
    window = torch.cat([conv_state.to(xbc_new.dtype), xbc_new.transpose(1, 2)], dim=-1)
    out = torch.sum(window.float() * conv_w.float()[None], dim=-1)
    out = F.silu(out + conv_b.float()[None]).to(xbc_new.dtype)
    return out[:, None, :], window[..., 1:]


def _ssm_decode_update(xbc_c, dt1, A, p, state, cfg: ModelConfig):
    """One-token SSD state update. xbc_c (B,1,conv_dim) post-conv; dt1 (B,H);
    state (B,H,P,N) fp32. Returns (y (B,1,d_inner) fp32, new_state fp32)."""
    d_in, H, Pd = cfg.d_inner, cfg.ssm_heads, cfg.ssm.head_dim
    G, N = cfg.ssm.n_groups, cfg.ssm.d_state
    B = xbc_c.shape[0]
    xh = xbc_c[:, 0, :d_in].reshape(B, H, Pd).float()
    Bm = xbc_c[:, 0, d_in:d_in + G * N].reshape(B, G, N).float()
    Cm = xbc_c[:, 0, d_in + G * N:].reshape(B, G, N).float()
    Bm = Bm.repeat_interleave(H // G, dim=1)              # (B,H,N)
    Cm = Cm.repeat_interleave(H // G, dim=1)
    dA = torch.exp(dt1 * A[None, :])                      # (B,H)
    state = state * dA[..., None, None] + torch.einsum("bh,bhn,bhp->bhpn", dt1, Bm, xh)
    y = torch.einsum("bhn,bhpn->bhp", Cm, state)          # (B,H,P)
    y = y + p["D"].float()[None, :, None] * xh
    return y.reshape(B, 1, d_in), state


def _heads(xbc_c, cfg: ModelConfig):
    """Views of the conv output: x (B,S,H,P) and B / C per group (B,S,G,N),
    never repeated over heads (the scan reads head h's group itself)."""
    d_in, H, Pd = cfg.d_inner, cfg.ssm_heads, cfg.ssm.head_dim
    G, N = cfg.ssm.n_groups, cfg.ssm.d_state
    B, S, _ = xbc_c.shape
    xh = xbc_c[..., :d_in].reshape(B, S, H, Pd)
    Bm = xbc_c[..., d_in:d_in + G * N].reshape(B, S, G, N)
    Cm = xbc_c[..., d_in + G * N:].reshape(B, S, G, N)
    return xh, Bm, Cm


def mamba_sublayer(
    p: Dict[str, Any],
    h,                      # normed (B, S, d)
    cfg: ModelConfig,
    ctx: RunCtx,
    cache: Optional[Dict[str, Any]] = None,
    chunk: Optional[Dict[str, Any]] = None,
):
    """Returns the sublayer's output (B, S, d); the cache, if any, is
    updated in place. ``chunk`` (mode "chunk") holds the engine's ``slots``
    (B,) distinct cache rows, ``nvalid`` (B,) live tokens per row and
    ``first`` (B,) bool, True on a sequence's first chunk."""
    ssm = cfg.ssm
    d_in, K = cfg.d_inner, ssm.d_conv
    B, S, _ = h.shape
    # every leaf but the two projections is read outside a matmul
    p = {k: v if k.endswith("_proj") else dequant(v, h.dtype) for k, v in p.items()}

    zxbcdt = linear(h, p["in_proj"])
    z, xbc, dt_raw = _split_proj(zxbcdt, cfg)
    A = -torch.exp(p["A_log"].float())                    # (H,)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())

    if ctx.mode == "chunk":
        # serving chunk over the slot-pooled cache: rows map to engine slots,
        # first chunks start from zero state, ragged tails are masked via dt
        # (dt == 0 => exp(dt*A) == 1 and zero input: the state is untouched).
        slots, nvalid, first = chunk["slots"].long(), chunk["nvalid"], chunk["first"]
        row_valid = nvalid > 0
        s_orig = cache["state"][slots]
        c_orig = cache["conv"][slots]
        s0 = torch.where(first[:, None, None, None], 0.0, s_orig.float())
        c0 = torch.where(first[:, None, None], torch.zeros_like(c_orig), c_orig)
        if S == 1:                                        # decode: O(1) update
            xbc_c, conv_new = _conv_step(xbc, c0, p["conv_w"], p["conv_b"])
            y, state_new = _ssm_decode_update(xbc_c, dt[:, 0], A, p, s0, cfg)
        else:
            xbc_c, window = _conv_carry(xbc, c0, p["conv_w"], p["conv_b"])
            xh, Bm, Cm = _heads(xbc_c, cfg)
            live = torch.arange(S, device=h.device)[None, :, None] < nvalid[:, None, None]
            dtm = torch.where(live, dt, 0.0)
            y, state_new = ssd_chunked(xh, dtm, A, Bm, Cm, ssm.chunk_size, init_state=s0)
            y = y + p["D"].float()[None, None, :, None] * xh.float()
            y = y.reshape(B, S, d_in)
            # next carry: the K-1 inputs preceding each row's ragged end
            idx = nvalid.long()[:, None] + torch.arange(K - 1, device=h.device)[None]
            conv_new = torch.gather(window, 1, idx[..., None].expand(-1, -1, window.shape[-1])
                                    ).transpose(1, 2)
        # write back every row (slots are distinct); idle rows keep their old state
        cache["state"][slots] = torch.where(row_valid[:, None, None, None],
                                            state_new.to(cache["state"].dtype), s_orig)
        cache["conv"][slots] = torch.where(row_valid[:, None, None],
                                           conv_new.to(cache["conv"].dtype), c_orig)
    elif ctx.mode == "decode":
        xbc_c, new_conv = _conv_step(xbc, cache["conv"], p["conv_w"], p["conv_b"])
        y, state = _ssm_decode_update(xbc_c, dt[:, 0], A, p, cache["state"].float(), cfg)
        cache["state"].copy_(state)
        cache["conv"].copy_(new_conv)
    else:
        xbc_c = _conv_full(xbc, p["conv_w"], p["conv_b"])
        xh, Bm, Cm = _heads(xbc_c, cfg)
        init_state = cache["state"] if (cache is not None and ctx.mode == "prefill") else None
        y, final_state = ssd_chunked(xh, dt, A, Bm, Cm, ssm.chunk_size, init_state=init_state)
        y = y + p["D"].float()[None, None, :, None] * xh.float()
        y = y.reshape(B, S, d_in)
        if cache is not None:                             # prefill: hand off state
            tail = xbc[:, -(K - 1):, :]
            if S < K - 1:
                tail = F.pad(tail, (0, 0, K - 1 - S, 0))
            cache["state"].copy_(final_state)
            cache["conv"].copy_(tail.transpose(1, 2))

    # gated RMSNorm + out projection
    y = rmsnorm((y * F.silu(z.float())).to(h.dtype), p["norm"], cfg.rms_eps)
    return linear(y, p["out_proj"])
