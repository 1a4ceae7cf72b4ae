"""The LM for the dense, MoE, SSM (mamba2) and hybrid (jamba) families: the
teacher-forced ``forward``, the generation API ``prefill`` + ``decode_step``
over dense ring or paged caches, and the serving path ``decode_chunk`` over
the paged KV pool and the slot-pooled SSM state.

Repeated layers keep their parameters stacked on a leading repeat axis, as
in the reference, and run as a plain Python loop over repeats and pattern
positions (the reference scans). The parameter tree may be the int8 one of
``quant.quantize_params_int8`` / ``params.init_params_int8``: each layer
reads its leaves through ``linear`` and ``dequant``, so the model computes
what it computes on ``dequantize_tree`` of that tree, with the large
matmuls on int8 weights in the w8a16 and grouped matmul kernels. Caches
are updated in place: ``prefill``, ``decode_step`` and ``decode_chunk``
return the cache they were given. The enc-dec and VLM families and the
training ``loss`` come with later slices.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.quant_matmul import w8a16_matmul
from repro_torch.models import params as params_lib
from repro_torch.models.attention import attention_sublayer
from repro_torch.models.common import (QuantizedLinear, RunCtx, dense_mlp, dequant, linear,
                                       resolve_device, rmsnorm)
from repro_torch.models.mamba import mamba_sublayer
from repro_torch.models.moe import moe_sublayer


class LM:
    def __init__(self, cfg: ModelConfig):
        if cfg.encoder is not None or cfg.vision is not None:
            raise NotImplementedError(f"{cfg.name}: the enc-dec and VLM paths are not ported yet")
        self.cfg = cfg

    # ------------------------------------------------------------------ params
    def param_specs(self):
        return params_lib.param_specs(self.cfg)

    def init_params(self, seed: int = 0, *, device: Optional[Union[str, torch.device]] = None,
                    dtype: torch.dtype = torch.float32):
        return params_lib.init_params(self.cfg, seed, device=device, dtype=dtype)

    # ------------------------------------------------------------------ layers
    def _apply_layer(self, p, x, c, *, kind: str, ctx: RunCtx, positions, page_table=None,
                     lengths=None, valid=None, chunk=None):
        """Returns (x, aux): aux is the MoE load-balance loss (0.0 without MoE)."""
        cfg = self.cfg
        aux = 0.0
        h = rmsnorm(x, p["ln1"], cfg.rms_eps)
        if kind == "M":
            x = x + mamba_sublayer(p["ssm"], h, cfg, ctx, c["ssm"] if c else None, chunk)
        else:
            x = x + attention_sublayer(p["attn"], h, ctx, cfg, kind, c["attn"] if c else None,
                                       positions, page_table, lengths, valid)
        if "moe" in p:
            h2 = rmsnorm(x, p["ln2"], cfg.rms_eps)
            mo, aux = moe_sublayer(p["moe"], h2, cfg, ctx)
            x = x + mo
        elif "mlp" in p:
            h2 = rmsnorm(x, p["ln2"], cfg.rms_eps)
            x = x + dense_mlp(p["mlp"], h2, cfg.act)
        return x, aux

    def _run_groups(self, groups_params, x, cache, *, ctx: RunCtx, **kw):
        """Every layer in order: groups, then repeats, then pattern
        positions. The cache (None for ``forward``) is updated in place.
        Returns (x, aux summed over layers)."""
        aux_total = 0.0
        for gi, g in enumerate(self.cfg.layer_groups):
            gp = groups_params[gi]["layers"]
            gc = cache["groups"][gi] if cache is not None else None
            for r in range(g.repeats):
                for pos, kind in enumerate(g.pattern):
                    # the r-th repeat of the stacked params / caches (views)
                    p_r = params_lib.map_tree(lambda t: t[r], gp[pos])
                    c_r = params_lib.map_tree(lambda t: t[r], gc[pos]) if gc else None
                    x, aux = self._apply_layer(p_r, x, c_r, kind=kind, ctx=ctx, **kw)
                    aux_total = aux_total + aux
        return x, aux_total

    # ------------------------------------------------------------------ embed
    def _embed(self, params, tokens):
        """Rows of the embedding table. An int8 table's rows are gathered,
        then dequantized to the model's dtype: that of the final norm, a 1-D
        leaf that quantization never takes."""
        cfg = self.cfg
        w, tok = params["embed"]["w"], tokens.long()
        if isinstance(w, QuantizedLinear):
            x = dequant(QuantizedLinear(w.q[tok], w.scale[tok]), params["final_norm"]["w"].dtype)
        else:
            x = w[tok]
        if cfg.scale_embedding:
            x = x * (cfg.d_model ** 0.5)
        return x

    def _head(self, params, x):
        """Logits from an lm_head (K, V) or the tied embedding (V, K). On
        int8 leaves the w8a16 matmul computes them: with lm_head's scale
        per input row, or with the embedding's per-row scale as the scale
        per output column of its transpose (read through its strides)."""
        cfg = self.cfg
        w = params["embed"]["w"] if cfg.tie_embeddings else params["lm_head"]["w"]
        if not isinstance(w, QuantizedLinear):
            logits = x @ (w.T if cfg.tie_embeddings else w).to(x.dtype)
        elif cfg.tie_embeddings:
            logits = w8a16_matmul(x.reshape(-1, x.shape[-1]), w.q.T, w.scale[:, 0])
            logits = logits.reshape(*x.shape[:-1], -1)
        else:
            logits = linear(x, w)
        if cfg.logit_softcap > 0:
            logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
        return logits

    # ------------------------------------------------------------------ api
    def forward(self, params, batch, ctx: RunCtx):
        """Teacher-forced full-sequence logits through flash attention and
        the SSD scan. batch {"tokens": (B, S)}. Returns (logits (B, S, vocab), aux), aux the
        MoE load-balance loss summed over layers (0.0 without MoE)."""
        x = self._embed(params, batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)
        x, aux = self._run_groups(params["groups"], x, None, ctx=ctx, positions=positions)
        x = rmsnorm(x, params["final_norm"]["w"], self.cfg.rms_eps)
        return self._head(params, x), aux

    def prefill(self, params, batch, cache, ctx: RunCtx, last_pos=None):
        """Full-sequence pass through flash attention and the SSD scan that
        also fills the dense ring cache and the SSM states. ``last_pos`` (B,)
        selects the logits position (the true prompt end when prompts are
        right-padded); defaults to the final position. Right padding is
        sound for attention layers only: in an SSM layer the padding tokens
        advance the carried state. Returns (last_logits (B, vocab), cache),
        the cache written in place."""
        ctx = ctx.with_mode("prefill")
        x = self._embed(params, batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)
        x, _ = self._run_groups(params["groups"], x, cache, ctx=ctx, positions=positions)
        x = rmsnorm(x, params["final_norm"]["w"], self.cfg.rms_eps)
        if last_pos is None:
            last = x[:, -1:]
        else:
            last = x[torch.arange(x.shape[0], device=x.device), last_pos.long()][:, None]
        return self._head(params, last)[:, 0], cache

    def decode_step(self, params, tokens, cache, positions, ctx: RunCtx,
                    page_table=None, lengths=None):
        """tokens (B,1); positions (B,) absolute position of the new token.
        Over a dense cache the ring is read; over a paged cache (``kp`` /
        ``vp`` pools) ``page_table`` (B, max_pages) maps each row's pages and
        ``lengths`` (B,) counts its entries, the new token's included
        (default positions + 1). Returns (logits (B, vocab), cache), the
        cache written in place."""
        ctx = ctx.with_mode("decode")
        x = self._embed(params, tokens)
        if lengths is None:
            lengths = positions + 1
        x, _ = self._run_groups(params["groups"], x, cache, ctx=ctx, positions=positions,
                                page_table=page_table, lengths=lengths)
        x = rmsnorm(x, params["final_norm"]["w"], self.cfg.rms_eps)
        return self._head(params, x)[:, 0], cache

    def decode_chunk(self, params, tokens, cache, starts, nvalid, slots, first, ctx: RunCtx,
                     page_table):
        """Unified serving iteration over a paged cache: each batch row
        feeds a chunk of up to C tokens of one sequence — C == 1 is decode,
        C > 1 is a prefill chunk. KV goes straight into the paged pool.

        tokens (B, C); starts (B,) absolute position of each row's first
        token; nvalid (B,) live tokens per row (0 = inactive row); slots
        (B,) engine slot per row, the row of the slot-pooled SSM state (must
        be distinct); first (B,) True on a sequence's first chunk (resets
        the SSM and conv state); page_table (B, max_pages). Returns (logits
        (B, vocab) at each row's last valid position, cache) — the cache's
        pools and SSM states updated in place.
        """
        ctx = ctx.with_mode("chunk")
        B, C = tokens.shape
        x = self._embed(params, tokens)
        ar = torch.arange(C, device=tokens.device)
        positions = starts.long()[:, None] + ar[None, :]
        valid = ar[None, :] < nvalid[:, None]
        lengths = starts + nvalid
        pack = {"slots": slots, "nvalid": nvalid, "first": first}
        x, _ = self._run_groups(params["groups"], x, cache, ctx=ctx, positions=positions,
                                page_table=page_table, lengths=lengths, valid=valid, chunk=pack)
        x = rmsnorm(x, params["final_norm"]["w"], self.cfg.rms_eps)
        last = torch.clamp(nvalid.long(), min=1) - 1
        x_last = x[torch.arange(B, device=x.device), last]
        return self._head(params, x_last[:, None])[:, 0], cache

    # ------------------------------------------------------------------ cache
    def init_cache(self, B: int, max_seq: int, dtype: torch.dtype = torch.float32, *,
                   kind: str = "dense", page_size: int = 16, num_pages: int = 0,
                   device: Optional[Union[str, torch.device]] = None) -> Dict[str, Any]:
        """The cache tree {"groups": [[{"attn": {...}} or {"ssm": {...}} per
        pattern position]]}, every leaf stacked per group on the repeat axis
        R, as the reference's.

        kind="dense": per-layer ring buffers "k" / "v" (R, B, W, Hkv, hd) and
                      "slot_pos" (R, B, W) int32 (-1 = empty), W = min(max_seq,
                      window) on local ("L") layers and max_seq elsewhere.
        kind="paged": per-layer physical page pools "kp" / "vp" (R, num_pages,
                      page_size, Hkv, hd); the caller supplies page_table /
                      lengths (max_seq is not used).
        SSM ("M") layers hold, under either kind, one state per batch row
        (engine slot): "state" (R, B, H, P, N) fp32 and "conv" (R, B,
        conv_dim, d_conv - 1) in ``dtype``.
        """
        if kind not in ("dense", "paged"):
            raise ValueError(f"cache kind {kind!r}: 'dense' or 'paged'")
        dev = resolve_device(device)
        cfg = self.cfg
        Hkv, hd = cfg.n_kv_heads, cfg.head_dim
        groups_cache: List[Any] = []
        for g in cfg.layer_groups:
            R = g.repeats
            per_pos = []
            for k in g.pattern:
                if k == "M":
                    ssm = cfg.ssm
                    conv_dim = cfg.d_inner + 2 * ssm.n_groups * ssm.d_state
                    per_pos.append({"ssm": {
                        "state": torch.zeros((R, B, cfg.ssm_heads, ssm.head_dim, ssm.d_state),
                                             dtype=torch.float32, device=dev),
                        "conv": torch.zeros((R, B, conv_dim, ssm.d_conv - 1), dtype=dtype,
                                            device=dev)}})
                    continue
                if kind == "paged":
                    shape = (R, num_pages, page_size, Hkv, hd)
                    c = {"kp": torch.zeros(shape, dtype=dtype, device=dev),
                         "vp": torch.zeros(shape, dtype=dtype, device=dev)}
                else:
                    W = (min(max_seq, cfg.sliding_window)
                         if (k == "L" and cfg.sliding_window) else max_seq)
                    c = {"k": torch.zeros((R, B, W, Hkv, hd), dtype=dtype, device=dev),
                         "v": torch.zeros((R, B, W, Hkv, hd), dtype=dtype, device=dev),
                         "slot_pos": torch.full((R, B, W), -1, dtype=torch.int32, device=dev)}
                per_pos.append({"attn": c})
            groups_cache.append(per_pos)
        return {"groups": groups_cache}


def build_model(cfg: ModelConfig) -> LM:
    return LM(cfg)
