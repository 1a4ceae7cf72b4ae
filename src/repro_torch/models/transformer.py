"""The LM for the dense and MoE families, serving path: ``decode_chunk``
over the paged KV pool.

Repeated layers keep their parameters stacked on a leading repeat axis, as
in the reference, and run as a plain Python loop over repeats and pattern
positions (the reference scans). The SSM, enc-dec and VLM families and the
forward / prefill / decode_step paths come with later slices.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import params as params_lib
from repro_torch.models.attention import attention_sublayer
from repro_torch.models.common import RunCtx, dense_mlp, resolve_device, rmsnorm
from repro_torch.models.moe import moe_sublayer


class LM:
    def __init__(self, cfg: ModelConfig):
        if (cfg.encoder is not None or cfg.vision is not None
                or any("M" in g.pattern for g in cfg.layer_groups)):
            raise NotImplementedError(
                f"{cfg.name}: the SSM, enc-dec and VLM chunk paths are not ported yet")
        self.cfg = cfg

    # ------------------------------------------------------------------ params
    def param_specs(self):
        return params_lib.param_specs(self.cfg)

    def init_params(self, seed: int = 0, *, device: Optional[Union[str, torch.device]] = None,
                    dtype: torch.dtype = torch.float32):
        return params_lib.init_params(self.cfg, seed, device=device, dtype=dtype)

    # ------------------------------------------------------------------ layers
    def _apply_layer(self, p, x, c, *, kind: str, ctx: RunCtx, positions, page_table,
                     lengths, valid):
        cfg = self.cfg
        h = rmsnorm(x, p["ln1"], cfg.rms_eps)
        x = x + attention_sublayer(p["attn"], h, ctx, cfg, kind, c["attn"], positions,
                                   page_table, lengths, valid)
        if "moe" in p:
            h2 = rmsnorm(x, p["ln2"], cfg.rms_eps)
            mo, _ = moe_sublayer(p["moe"], h2, cfg, ctx)
            x = x + mo
        elif "mlp" in p:
            h2 = rmsnorm(x, p["ln2"], cfg.rms_eps)
            x = x + dense_mlp(p["mlp"], h2, cfg.act)
        return x

    def _run_groups(self, groups_params, x, cache, *, ctx: RunCtx, **kw):
        """Every layer in order: groups, then repeats, then pattern
        positions. The cache's pools are updated in place."""
        for gi, g in enumerate(self.cfg.layer_groups):
            gp = groups_params[gi]["layers"]
            gc = cache["groups"][gi]
            for r in range(g.repeats):
                for pos, kind in enumerate(g.pattern):
                    # the r-th repeat of the stacked params / pools (views)
                    p_r, c_r = (params_lib.map_tree(lambda t: t[r], tree)
                                for tree in (gp[pos], gc[pos]))
                    x = self._apply_layer(p_r, x, c_r, kind=kind, ctx=ctx, **kw)
        return x

    # ------------------------------------------------------------------ embed
    def _embed(self, params, tokens):
        cfg = self.cfg
        x = params["embed"]["w"][tokens.long()]
        if cfg.scale_embedding:
            x = x * (cfg.d_model ** 0.5)
        return x

    def _head(self, params, x):
        cfg = self.cfg
        w = params["embed"]["w"].T if cfg.tie_embeddings else params["lm_head"]["w"]
        logits = x @ w.to(x.dtype)
        if cfg.logit_softcap > 0:
            logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
        return logits

    # ------------------------------------------------------------------ api
    def decode_chunk(self, params, tokens, cache, starts, nvalid, ctx: RunCtx, page_table):
        """Unified serving iteration over a paged cache: each batch row
        feeds a chunk of up to C tokens of one sequence — C == 1 is decode,
        C > 1 is a prefill chunk. KV goes straight into the paged pool.

        tokens (B, C); starts (B,) absolute position of each row's first
        token; nvalid (B,) live tokens per row (0 = inactive row);
        page_table (B, max_pages). Returns (logits (B, vocab) at each row's
        last valid position, cache) — the cache's pools updated in place.
        """
        B, C = tokens.shape
        x = self._embed(params, tokens)
        ar = torch.arange(C, device=tokens.device)
        positions = starts.long()[:, None] + ar[None, :]
        valid = ar[None, :] < nvalid[:, None]
        lengths = starts + nvalid
        x = self._run_groups(params["groups"], x, cache, ctx=ctx, positions=positions,
                             page_table=page_table, lengths=lengths, valid=valid)
        x = rmsnorm(x, params["final_norm"]["w"], self.cfg.rms_eps)
        last = torch.clamp(nvalid.long(), min=1) - 1
        x_last = x[torch.arange(B, device=x.device), last]
        return self._head(params, x_last[:, None])[:, 0], cache

    # ------------------------------------------------------------------ cache
    def init_cache(self, num_pages: int, page_size: int = 16,
                   dtype: torch.dtype = torch.float32, *,
                   device: Optional[Union[str, torch.device]] = None) -> Dict[str, Any]:
        """The paged cache (the reference's ``kind="paged"``): per-layer
        physical page pools, stacked per group on the repeat axis,
        {"groups": [[{"attn": {"kp", "vp"}} per pattern position]]}, each
        pool (R, num_pages, page_size, Hkv, hd). The engine supplies
        page_table / lengths. The dense ring caches come with the
        prefill / decode_step slice."""
        dev = resolve_device(device)
        cfg = self.cfg
        groups_cache: List[Any] = []
        for g in cfg.layer_groups:
            shape = (g.repeats, num_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
            groups_cache.append([
                {"attn": {"kp": torch.zeros(shape, dtype=dtype, device=dev),
                          "vp": torch.zeros(shape, dtype=dtype, device=dev)}}
                for _ in g.pattern])
        return {"groups": groups_cache}


def build_model(cfg: ModelConfig) -> LM:
    return LM(cfg)
