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

Under a mesh (``layout`` given) the layer holds the shards of the
reference's ``ssm_proj`` / ``conv_dim`` / ``ssm_heads`` / ``ssm_inner``
rules, each a contiguous block of its own dimension (so a block of
``in_proj``'s columns does not line up with z | x | B | C | dt): the rank
projects its columns of ``in_proj`` and all-gathers the full projection;
runs the depthwise conv on its channels (its ``conv`` cache holds theirs)
and all-gathers the conv's output; scans its heads (with its ``state``
cache, ``A_log`` / ``D`` / ``dt_bias``) against the whole B / C; then the
gated norm over its block of d_inner, the sum of squares psum'd, and
``out_proj`` row-split with a psum (under the sequence-parallel rule a
reduce-scatter onto the rank's part of the sequence, the layer having read
the whole sequence: the conv and the scan need it). A dimension its rule
leaves whole is computed whole, with no collective.

Under grad (training under a mesh) every collective's backward is its
transpose (``distributed.collectives``): the all-gathers after ``in_proj``
and the conv reduce-scatter the ranks' shares of their cotangents, so a
rank's B / C groups, which get only its heads' part of dB / dC, are summed
there; a leaf kept whole (``conv_w`` / ``conv_b`` where the conv is whole,
``norm`` where d_inner is, ``A_log`` / ``D`` / ``dt_bias`` where the heads
are) gets on each rank the share its own heads or channels give, which the
train step's reduction sums once. The SSD backward runs on the rank's H / t
heads against their groups (on the card ``kernels.ssd_scan.ops.SSDScan``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import all_gather, psum
from repro_torch.distributed.sharding import shard_start
from repro_torch.kernels.ssd_scan import ssd_chunked
from repro_torch.models.common import RunCtx, dequant, linear, rmsnorm, row_linear


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


@dataclass(frozen=True)
class _Shard:
    """This rank's blocks of the layer's dimensions under a mesh (whole on
    one process): in_proj's columns split on ``proj``, the conv channels
    [c0, c0 + nc) on ``conv``, the SSD heads [h0, h0 + nh) on ``heads``,
    d_inner [i0, i0 + ni) on ``inner`` (the norm and out_proj's rows); and
    the first engine slot of its rows of the slot-pooled cache
    (``slot0``: its batch block); ``seq``, the stream's sequence split
    under the sequence-parallel rule (the output goes to the rank's part).
    """
    mesh: Any = None
    proj: Any = None
    conv: Any = None
    heads: Any = None
    inner: Any = None
    c0: int = 0
    nc: int = 0
    h0: int = 0
    nh: int = 0
    i0: int = 0
    ni: int = 0
    slot0: int = 0
    seq: Any = None

    @staticmethod
    def of(cfg: ModelConfig, layout=None, cache=None) -> "_Shard":
        ssm = cfg.ssm
        conv_dim = cfg.d_inner + 2 * ssm.n_groups * ssm.d_state
        if layout is None:
            return _Shard(nc=conv_dim, nh=cfg.ssm_heads, ni=cfg.d_inner)
        mesh, ps = layout.mesh, layout.p["ssm"]       # each spec's repeat dim leads
        conv, heads, inner = ps["conv_w"][1], ps["A_log"][1], ps["norm"][1]
        slot0 = 0
        if cache is not None:
            batch = layout.c["ssm"]["state"][1]
            slot0 = shard_start(cache["state"].shape[0] * mesh.count(batch), batch, mesh)
        return _Shard(mesh, ps["in_proj"][2], conv, heads, inner,
                      shard_start(conv_dim, conv, mesh), conv_dim // mesh.count(conv),
                      shard_start(cfg.ssm_heads, heads, mesh),
                      cfg.ssm_heads // mesh.count(heads),
                      shard_start(cfg.d_inner, inner, mesh), cfg.d_inner // mesh.count(inner),
                      slot0, layout.seq)

    def gather(self, t, axis):
        """``t`` (last dim this rank's block on ``axis``) all-gathered over
        it: the whole last dim."""
        return t if axis is None else all_gather(t, self.mesh, axis, dim=-1)


def _ssm_decode_update(xh, Bm, Cm, dt1, A, D, state):
    """One-token SSD state update of the heads of xh (B,H,P) fp32 reading
    B / C (B,G,N) of their groups; dt1 (B,H); A / D (H,); state (B,H,P,N)
    fp32. Returns (y (B,H,P) fp32, new_state fp32)."""
    H, G = xh.shape[1], Bm.shape[1]
    Bm = Bm.float().repeat_interleave(H // G, dim=1)      # (B,H,N)
    Cm = Cm.float().repeat_interleave(H // G, dim=1)
    dA = torch.exp(dt1 * A[None, :])                      # (B,H)
    state = state * dA[..., None, None] + torch.einsum("bh,bhn,bhp->bhpn", dt1, Bm, xh)
    y = torch.einsum("bhn,bhpn->bhp", Cm, state)          # (B,H,P)
    y = y + D.float()[None, :, None] * xh
    return y, state


def _heads(xbc_c, cfg: ModelConfig, sh: _Shard):
    """Views of the (whole) conv output: x of the rank's heads (B,S,nh,P)
    and B / C of their groups (B,S,g,N), never repeated over heads (the
    scan reads head h's group itself)."""
    d_in, H, Pd = cfg.d_inner, cfg.ssm_heads, cfg.ssm.head_dim
    G, N = cfg.ssm.n_groups, cfg.ssm.d_state
    B, S, _ = xbc_c.shape
    xh = xbc_c[..., :d_in].reshape(B, S, H, Pd)[:, :, sh.h0:sh.h0 + sh.nh]
    hpg = H // G
    g = slice(sh.h0 // hpg, (sh.h0 + sh.nh - 1) // hpg + 1)
    Bm = xbc_c[..., d_in:d_in + G * N].reshape(B, S, G, N)[:, :, g]
    Cm = xbc_c[..., d_in + G * N:].reshape(B, S, G, N)[:, :, g]
    return xh, Bm, Cm


def _gated_out(y, z, p, cfg: ModelConfig, sh: _Shard, dtype):
    """The gated RMSNorm and out_proj of y (B,S,nh P) fp32, the rank's
    heads: taken to its block of d_inner, normed over the whole d_inner
    (the sum of squares psum'd over the block's axis) and row-projected."""
    if sh.heads != sh.inner:                          # the heads' block is not the norm's
        y = sh.gather(y, sh.heads)[..., sh.i0:sh.i0 + sh.ni]
    g = (y * F.silu(z[..., sh.i0:sh.i0 + sh.ni].float())).to(dtype)
    if sh.inner is None:
        return row_linear(rmsnorm(g, p["norm"], cfg.rms_eps), p["out_proj"], sh.mesh, seq=sh.seq)
    x = g.float()
    ss = psum(torch.sum(torch.square(x), dim=-1, keepdim=True), sh.mesh, sh.inner)
    x = (x * torch.rsqrt(ss / cfg.d_inner + cfg.rms_eps) * p["norm"].float()).to(dtype)
    return row_linear(x, p["out_proj"], sh.mesh, sh.inner, seq=sh.seq)


def mamba_sublayer(
    p: Dict[str, Any],
    h,                      # normed (B, S, d)
    cfg: ModelConfig,
    ctx: RunCtx,
    cache: Optional[Dict[str, Any]] = None,
    chunk: Optional[Dict[str, Any]] = None,
    layout=None,
):
    """Returns the sublayer's output (B, S, d); the cache, if any, is
    updated in place. ``chunk`` (mode "chunk") holds the engine's ``slots``
    (B,) distinct cache rows, ``nvalid`` (B,) live tokens per row and
    ``first`` (B,) bool, True on a sequence's first chunk. ``layout``: the
    call's Layout at this layer under a mesh (the module's note); h and
    the chunk's rows are then this rank's, and so are its slots' cache
    rows."""
    ssm = cfg.ssm
    K = ssm.d_conv
    B, S, _ = h.shape
    sh = _Shard.of(cfg, layout, cache)
    # every leaf but the two projections is read outside a matmul
    p = {k: v if k.endswith("_proj") else dequant(v, h.dtype) for k, v in p.items()}

    zxbcdt = sh.gather(linear(h, p["in_proj"]), sh.proj)
    z, xbc, dt_raw = _split_proj(zxbcdt, cfg)
    xbc = xbc[..., sh.c0:sh.c0 + sh.nc]                   # the rank's conv channels
    A = -torch.exp(p["A_log"].float())                    # (nh,)
    dt = F.softplus(dt_raw[..., sh.h0:sh.h0 + sh.nh].float() + p["dt_bias"].float())

    if ctx.mode == "chunk":
        # serving chunk over the slot-pooled cache: rows map to engine slots,
        # first chunks start from zero state, ragged tails are masked via dt
        # (dt == 0 => exp(dt*A) == 1 and zero input: the state is untouched).
        slots, nvalid, first = chunk["slots"].long() - sh.slot0, chunk["nvalid"], chunk["first"]
        row_valid = nvalid > 0
        s_orig = cache["state"][slots]
        c_orig = cache["conv"][slots]
        s0 = torch.where(first[:, None, None, None], 0.0, s_orig.float())
        c0 = torch.where(first[:, None, None], torch.zeros_like(c_orig), c_orig)
        if S == 1:                                        # decode: O(1) update
            xbc_c, conv_new = _conv_step(xbc, c0, p["conv_w"], p["conv_b"])
            xh, Bm, Cm = _heads(sh.gather(xbc_c, sh.conv), cfg, sh)
            y, state_new = _ssm_decode_update(xh[:, 0].float(), Bm[:, 0], Cm[:, 0], dt[:, 0], A,
                                              p["D"], s0)
            y = y[:, None]
        else:
            xbc_c, window = _conv_carry(xbc, c0, p["conv_w"], p["conv_b"])
            xh, Bm, Cm = _heads(sh.gather(xbc_c, sh.conv), cfg, sh)
            live = torch.arange(S, device=h.device)[None, :, None] < nvalid[:, None, None]
            dtm = torch.where(live, dt, 0.0)
            y, state_new = ssd_chunked(xh, dtm, A, Bm, Cm, ssm.chunk_size, init_state=s0)
            y = y + p["D"].float()[None, None, :, None] * xh.float()
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
        xh, Bm, Cm = _heads(sh.gather(xbc_c, sh.conv), cfg, sh)
        y, state = _ssm_decode_update(xh[:, 0].float(), Bm[:, 0], Cm[:, 0], dt[:, 0], A, p["D"],
                                      cache["state"].float())
        y = y[:, None]
        cache["state"].copy_(state)
        cache["conv"].copy_(new_conv)
    else:
        xbc_c = _conv_full(xbc, p["conv_w"], p["conv_b"])
        xh, Bm, Cm = _heads(sh.gather(xbc_c, sh.conv), cfg, sh)
        init_state = cache["state"] if (cache is not None and ctx.mode == "prefill") else None
        y, final_state = ssd_chunked(xh, dt, A, Bm, Cm, ssm.chunk_size, init_state=init_state)
        y = y + p["D"].float()[None, None, :, None] * xh.float()
        if cache is not None:                             # prefill: hand off state
            tail = xbc[:, -(K - 1):, :]
            if S < K - 1:
                tail = F.pad(tail, (0, 0, K - 1 - S, 0))
            cache["state"].copy_(final_state)
            cache["conv"].copy_(tail.transpose(1, 2))

    return _gated_out(y.reshape(B, S, sh.nh * ssm.head_dim), z, p, cfg, sh, h.dtype)
