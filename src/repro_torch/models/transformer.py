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
return the cache they were given.

The enc-dec family (seamless) runs a bidirectional encoder over stub frame
embeddings (``_encode``) and a cross attention sublayer in every decoder
layer; the VLM family (phi-3-vision) projects stub patch embeddings into a
prefix of the sequence (``_patch_prefix``), so text token i sits at
position ``n_patches + i``.

``loss`` is the training objective, the reference's: masked next-token
cross-entropy (labels below 0 are masked; a VLM's patch positions are
dropped) plus ``aux_weight`` times the MoE load-balance loss, optionally
with the head and logsumexp run one sequence chunk at a time
(``xent_chunk``), each chunk recomputed in the backward, so only one
chunk's fp32 logits live at a time. With ``ctx.remat`` each layer runs
under ``torch.utils.checkpoint`` and is recomputed in the backward.

Under a mesh (``ctx.mesh``, inside ``use_sharding(mesh, rules)``) each rank
holds the shards ``param_partition_specs`` gives it and a cache from
``init_cache`` (its ``cache_partition_specs`` shards). ``prefill`` /
``decode_step`` / ``decode_chunk`` / ``forward`` take the global batch,
keep this rank's rows where the rules split the batch on data, and return
the global logits: the embedding is a masked lookup of the rank's vocab
rows plus a psum, the head gives the rank's vocab columns, all-gathered;
attention and the MLP split on the tensor axis (one psum each; where the
tensor axis outgrows the kv heads, the reference's ``kv_seq`` layout:
``models.attention``), the mamba layers on the ``ssm_*`` / ``conv_dim``
rules (``models.mamba``), the MoE runs a shard_map strategy. An enc-dec
batch's frames and a VLM's patches are taken at the rank's rows: the
encoder runs its layers on the layout of its own parameters (heads on the
tensor axis, the MLP row-split), the memory is whole on each rank's rows,
and the cross keys and values go to the rank's shard of the cross cache
(``ck`` / ``cv``: the rows of its batch block, its kv heads); the vision
projector runs on the rank's rows. Every family serves so; int8 trees
raise (ROADMAP Queue 1 item 3 (c)).

``loss`` runs under a mesh too, for every family and layout that serves,
with the train rules (``make_rules("train", ...)``: FSDP, every leaf's
``embed`` dim split on the data axis, the encoder's and the vision
projector's too). Each layer
all-gathers its leaves over data just before use, inside its remat region
(the gathered copy is freed after it and gathered again in the recompute),
and the gather's backward reduce-scatters their gradients; the embedding,
the final norm and the head gather theirs the same way. The rank's rows of
the batch give a log-likelihood sum and a mask count, each psum'd over the
batch axes; the loss is their quotient plus ``aux_weight`` times the MoE aux
of the rank's own data shard (pmean'd over ep and tp only, the reference's
``check_rep=False`` output), so ranks of different data shards report
different losses, as the reference's devices do. Its gradient is the
rank's share (``distributed.collectives``' convention): the train step
reduces the shares (``training.train_step.reduce_grads``), and the aux
term then enters as its mean over the data shards, as in the reference.
A leaf a layout keeps whole on the tensor axis (``wk`` / ``wv`` under
``kv_seq``, a mamba layer's conv, norm or SSD scalars where their
dimension does not split) is held alike there, and each rank's gradient of
it is the share its own heads or channels give: the reduction sums them
once over that axis.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Any, Dict, List, Optional, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerGroup, ModelConfig
from repro_torch.distributed.collectives import all_gather, psum, shared_out
from repro_torch.distributed.sharding import PartitionSpec, constrain
from repro_torch.kernels.quant_matmul import w8a16_matmul
from repro_torch.models import params as params_lib
from repro_torch.models.attention import attention_sublayer
from repro_torch.models.common import (Layout, QuantizedLinear, RunCtx, dense_mlp, dequant,
                                       linear, resolve_device, rmsnorm)
from repro_torch.models.mamba import mamba_sublayer
from repro_torch.models.moe import moe_sublayer


class ShardedCache(dict):
    """One rank's cache under a mesh (``LM.init_cache`` inside
    ``use_sharding``): the tree of its local shards, and ``specs``, the
    ``cache_partition_specs`` of the global cache they are shards of."""

    def __init__(self, tree, specs):
        super().__init__(tree)
        self.specs = specs


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def _fsdp_gather(tree, fspecs, mesh, lead: int = 0):
    """``tree`` with each leaf all-gathered on the dims its FSDP spec
    splits (``fspecs`` mirrors ``tree``: a PartitionSpec a leaf, None where
    whole). ``lead``: the specs' leading dims the leaves lack (a layer's
    leaves lose the repeat dim)."""
    specs = []
    params_lib.map_tree(specs.append, fspecs, is_leaf=_is_spec)
    it = iter(specs)

    def leaf(t):
        for i, ax in enumerate(next(it)[lead:]):
            if ax is not None:
                t = all_gather(t, mesh, ax, dim=i)
        return t
    return params_lib.map_tree(leaf, tree)


class LM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self._pspecs = {}

    # ------------------------------------------------------------------ mesh
    def _mesh_pspecs(self, mesh, rules):
        """(the global parameter specs under (mesh, rules), each leaf's
        shard shape, the specs the layers see once the FSDP dims are
        gathered, the FSDP specs: each leaf's ``embed`` entries alone, None
        when no leaf has one), after checking the slice runs there: a
        rank's query heads, where the kv heads do not split with them, must
        be whole GQA groups or the part of one. Cached with the mesh and
        rules themselves, so their ids stay theirs."""
        from repro_torch.distributed import sharding
        key = (id(mesh), id(rules))
        if key not in self._pspecs:
            specs = self.param_specs()
            pspecs = sharding.param_partition_specs(specs, mesh, rules)
            cfg = self.cfg
            for g in pspecs["groups"]:
                for lay in g["layers"]:
                    if "attn" not in lay or lay["attn"]["wq"][2] == lay["attn"]["wk"][2]:
                        continue
                    Hq, group = cfg.n_heads // mesh.count(lay["attn"]["wq"][2]), (
                        cfg.n_heads // cfg.n_kv_heads)
                    if lay["attn"]["wk"][2] is not None or (Hq % group and group % Hq):
                        raise NotImplementedError(
                            f"{cfg.name}: query heads split on {lay['attn']['wq'][2]!r} "
                            f"({Hq} a rank), its {cfg.n_kv_heads} kv heads on "
                            f"{lay['attn']['wk'][2]!r}: a rank's heads must be whole groups "
                            f"of {group} or the part of one")
            shards = []
            params_lib.map_tree(lambda s: shards.append((s, sharding.local_shape(
                s.shape, sharding.partition_spec(s.shape, s.logical, mesh, rules), mesh))),
                specs, is_leaf=lambda x: isinstance(x, params_lib.ParamSpec))

            def embed_entries(keep):
                """pspecs with the entries of ``embed`` dims kept (or dropped)."""
                it = iter(shards)
                return params_lib.map_tree(lambda ps: PartitionSpec(*(
                    e if (name == "embed") == keep else None
                    for e, name in zip(ps, next(it)[0].logical))), pspecs, is_leaf=_is_spec)
            fsdp, entries = embed_entries(True), []
            params_lib.map_tree(entries.extend, fsdp, is_leaf=_is_spec)
            self._pspecs[key] = (mesh, rules, pspecs, shards, embed_entries(False),
                                 fsdp if any(e is not None for e in entries) else None)
        return self._pspecs[key][2:]

    def _layout(self, params, ctx: RunCtx, B: int, cache=None, **glob) -> Optional[Layout]:
        """The call's Layout on this rank (None without a mesh), after
        checking that the parameters and the cache are this rank's shards.
        ``glob``: the call's global per-row inputs a pool write needs."""
        if ctx.mesh is None:
            return None
        from repro_torch.distributed import sharding
        mesh, rules = sharding.active()
        if mesh is not ctx.mesh or rules is None:
            raise ValueError("under a mesh, run inside use_sharding(ctx.mesh, rules)")
        pspecs, shards, gathered, fsdp = self._mesh_pspecs(mesh, rules)
        local = []
        params_lib.map_tree(local.append, params, is_leaf=lambda x: isinstance(x, QuantizedLinear))
        for (s, want), t in zip(shards, local):
            if isinstance(t, QuantizedLinear):
                raise NotImplementedError("int8 weight trees under a mesh are not in the port "
                                          "yet (ROADMAP Queue 1 item 3 (c))")
            if tuple(t.shape) != want:
                raise ValueError(f"a parameter of {s.shape} {s.logical} is held as "
                                 f"{tuple(t.shape)}, not this rank's shard {want}")
        if cache is not None and not isinstance(cache, ShardedCache):
            raise ValueError("under a mesh the cache comes from init_cache inside use_sharding")
        batch = sharding.partition_spec((B,), ("batch",), mesh, rules)[0]
        n = B // mesh.count(batch)
        k = mesh.index(batch) if batch else 0
        return Layout(mesh=mesh, params=gathered, fsdp=fsdp,
                      cache=cache.specs if cache is not None else None, batch=batch, B=B,
                      rows=slice(k * n, (k + 1) * n), glob=glob)

    @staticmethod
    def _check_slots(cache, layout, slots) -> None:
        """Under a batch split of the slot-pooled caches (the SSM states,
        the cross keys and values) each rank holds its block of the slots'
        rows: a pack row's slot must lie in its rank's block."""
        for gc, gs in zip(cache["groups"], layout.cache["groups"]):
            for c, s in zip(gc, gs):
                for name, leaf in (("ssm", "state"), ("cross", "ck")):
                    if name not in c or s[name][leaf][1] is None:
                        continue
                    n = c[name][leaf].shape[1]
                    lo = layout.mesh.index(s[name][leaf][1]) * n
                    if bool(((slots < lo) | (slots >= lo + n)).any()):
                        raise ValueError(f"decode_chunk under a batch split: this rank's rows "
                                         f"{layout.rows} hold slots {slots.tolist()}, its block "
                                         f"of the {name} cache is slots [{lo}, {lo + n})")
                    return

    # ------------------------------------------------------------------ params
    def param_specs(self):
        return params_lib.param_specs(self.cfg)

    def init_params(self, seed: int = 0, *, device: Optional[Union[str, torch.device]] = None,
                    dtype: torch.dtype = torch.float32, mesh=None, rules=None):
        return params_lib.init_params(self.cfg, seed, device=device, dtype=dtype, mesh=mesh,
                                      rules=rules)

    # ------------------------------------------------------------------ layers
    def _apply_layer(self, p, x, c, *, kind: str, ctx: RunCtx, positions, page_table=None,
                     lengths=None, valid=None, chunk=None, memory=None, layout=None):
        """Returns (x, aux): aux is the MoE load-balance loss (0.0 without MoE)."""
        cfg = self.cfg
        aux = 0.0
        h = rmsnorm(x, p["ln1"], cfg.rms_eps)
        if kind == "M":
            x = x + mamba_sublayer(p["ssm"], h, cfg, ctx, c["ssm"] if c else None, chunk,
                                   layout=layout)
        else:
            x = x + attention_sublayer(p["attn"], h, ctx, cfg, kind, c["attn"] if c else None,
                                       positions, page_table, lengths, valid, chunk=chunk,
                                       layout=layout)
        if "cross" in p:
            hx = rmsnorm(x, p["ln_x"], cfg.rms_eps)
            x = x + attention_sublayer(p["cross"], hx, ctx, cfg, "X", c["cross"] if c else None,
                                       memory=memory, chunk=chunk, layout=layout)
        if "moe" in p:
            h2 = rmsnorm(x, p["ln2"], cfg.rms_eps)
            mo, aux = moe_sublayer(p["moe"], h2, cfg, ctx,
                                   batch_axes=layout.batch if layout is not None else None)
            x = x + mo
        elif "mlp" in p:
            h2 = rmsnorm(x, p["ln2"], cfg.rms_eps)
            if layout is None:
                x = x + dense_mlp(p["mlp"], h2, cfg.act)
            else:
                x = x + dense_mlp(p["mlp"], h2, cfg.act, layout.mesh, layout.p["mlp"]["wo"][1])
        return x, aux

    def _run_groups(self, groups_params, x, cache, *, ctx: RunCtx, layer_groups=None,
                    layout=None, **kw):
        """Every layer in order: groups (the config's, unless
        ``layer_groups`` names others), then repeats, then pattern
        positions. The cache (None for ``forward``) is updated in place.
        Returns (x, aux summed over layers)."""
        aux_total = 0.0
        remat = ctx.remat and torch.is_grad_enabled()
        for gi, g in enumerate(layer_groups or self.cfg.layer_groups):
            gp = groups_params[gi]["layers"]
            gc = cache["groups"][gi] if cache is not None else None
            # each stacked leaf split into its repeats once (views): under
            # autograd one node whose backward stacks the repeats' gradients
            # once, where a view per repeat would scatter each into a zeroed
            # leaf-sized gradient (quadratic in the depth)
            reps = [[t.unbind(0) for t in params_lib.tree_leaves(p)] for p in gp]
            for r in range(g.repeats):
                for pos, kind in enumerate(g.pattern):
                    # the r-th repeat of the stacked params / caches (views)
                    p_r = params_lib.tree_unflatten(gp[pos], [u[r] for u in reps[pos]])
                    c_r = params_lib.map_tree(lambda t: t[r], gc[pos]) if gc else None
                    lay = None
                    if layout is not None:     # this layer's specs (the repeat dim leads)
                        lay = replace(layout, p=layout.params["groups"][gi]["layers"][pos],
                                      c=layout.cache["groups"][gi][pos] if gc else None,
                                      f=(layout.fsdp["groups"][gi]["layers"][pos]
                                         if layout.fsdp is not None else None))

                    def layer(x, p_r=p_r, c_r=c_r, kind=kind, lay=lay):
                        if lay is not None and lay.f is not None:   # FSDP: the whole leaves
                            p_r = _fsdp_gather(p_r, lay.f, lay.mesh, lead=1)
                        return self._apply_layer(p_r, x, c_r, kind=kind, ctx=ctx, layout=lay,
                                                 **kw)
                    if remat:      # nothing random inside: no RNG state to keep
                        x, aux = checkpoint(layer, x, use_reentrant=False,
                                            preserve_rng_state=False)
                    else:
                        x, aux = layer(x)
                    aux_total = aux_total + aux
        return x, aux_total

    # ------------------------------------------------------------------ embed
    @staticmethod
    def _top(params, name: str, layout=None):
        """``params[name]["w"]``, gathered over its FSDP dims under a mesh
        with the train rules."""
        w = params[name]["w"]
        if layout is None or layout.fsdp is None:
            return w
        return _fsdp_gather(w, layout.fsdp[name]["w"], layout.mesh)

    def _embed(self, params, tokens, layout=None):
        """Rows of the embedding table. An int8 table's rows are gathered,
        then dequantized to the model's dtype: that of the final norm, a 1-D
        leaf that quantization never takes. Under a mesh with the table's
        vocab split, each rank looks up the tokens among its rows (zeros
        elsewhere) and a psum gathers them."""
        cfg = self.cfg
        w, tok = self._top(params, "embed", layout), tokens.long()
        ax = layout.params["embed"]["w"][0] if layout is not None else None
        if ax is not None:
            V_l = w.shape[0]
            loc = tok - layout.mesh.index(ax) * V_l
            mine = (loc >= 0) & (loc < V_l)
            x = psum(w[loc.clamp(0, V_l - 1)] * mine[..., None].to(w.dtype), layout.mesh, ax)
        elif isinstance(w, QuantizedLinear):
            x = dequant(QuantizedLinear(w.q[tok], w.scale[tok]), params["final_norm"]["w"].dtype)
        else:
            x = w[tok]
        if cfg.scale_embedding:
            x = x * (cfg.d_model ** 0.5)
        if layout is not None:                    # the reference's shard_act on the embedding
            constrain(x, ("batch", "seq", None), (layout.B, *x.shape[1:]))
        return x

    def _patch_prefix(self, params, patches, dtype, layout=None):
        """The VLM prefix: stub patch embeddings (B, n_patches, d_patch)
        through the vision projector -> (B, n_patches, d) in ``dtype``.
        Under a mesh ``patches`` are the rank's rows, and the train rules'
        FSDP dims of the projector are gathered first."""
        p = params["vision_proj"]
        if layout is not None and layout.fsdp is not None:
            p = _fsdp_gather(p, layout.fsdp["vision_proj"], layout.mesh)
        return linear(patches.to(dtype), p["w"]) + dequant(p["b"], dtype)

    def _embed_batch(self, params, batch, layout=None):
        """Token embeddings (of the rank's rows under a mesh), after the
        patch prefix where the config has a vision frontend and the batch
        carries ``patches``. Returns (x, offset): offset is the number of
        prefix positions before the first text token."""
        rows = (lambda t: t) if layout is None else layout.local_rows
        x = self._embed(params, rows(batch["tokens"]), layout)
        if self.cfg.vision is None or "patches" not in batch:
            return x, 0
        prefix = self._patch_prefix(params, rows(batch["patches"]), x.dtype, layout)
        return torch.cat([prefix, x], dim=1), prefix.shape[1]

    def _encode(self, params, frames, ctx: RunCtx, layout=None):
        """The enc-dec encoder over stub frame embeddings (B, M, d): its
        layers (kind "E": bidirectional flash attention, RoPE at arange(M))
        and final norm -> the memory (B, M, d). Under a mesh ``frames`` are
        the rank's rows and the encoder runs on the layout of its own
        parameters: heads split on the tensor axis as the decoder's, the
        MLP row-split with a psum, FSDP-gathered under the train rules."""
        enc = params["encoder"]
        if layout is not None:
            layout = replace(layout, params=layout.params["encoder"], cache=None,
                             fsdp=layout.fsdp["encoder"] if layout.fsdp is not None else None)
        x, _ = self._run_groups(enc["groups"], frames, None, ctx=ctx,
                                layer_groups=(LayerGroup("E", self.cfg.encoder.n_layers),),
                                positions=torch.arange(frames.shape[1], device=frames.device),
                                layout=layout)
        return rmsnorm(x, self._top(enc, "final_norm", layout), self.cfg.rms_eps)

    def _memory(self, params, batch, dtype, ctx: RunCtx, layout=None):
        """The encoder memory of an enc-dec batch (its ``frames``, the
        rank's rows under a mesh), else None."""
        if self.cfg.encoder is None:
            return None
        frames = batch["frames"] if layout is None else layout.local_rows(batch["frames"])
        return self._encode(params, frames.to(dtype), ctx, layout)

    def _head(self, params, x, layout=None):
        """Logits from an lm_head (K, V) or the tied embedding (V, K). On
        int8 leaves the w8a16 matmul computes them: with lm_head's scale
        per input row, or with the embedding's per-row scale as the scale
        per output column of its transpose (read through its strides).
        Under a mesh: the global logits, every rank's vocab columns and
        rows all-gathered."""
        if layout is None:
            return self._head_local(params, x)
        return layout.gather_rows(self._head_vocab(params, x, layout))

    def _head_weight(self, params, layout=None):
        return self._top(params, "embed" if self.cfg.tie_embeddings else "lm_head", layout)

    def _head_vocab(self, params, x, layout, w=None):
        """The logits of this rank's rows ``x`` over the whole vocab: its
        vocab columns, all-gathered over the axis that splits them. ``w``:
        the head's gathered weight (default: gathered here)."""
        logits = self._head_local(params, x, self._head_weight(params, layout) if w is None else w)
        spec = (layout.params["embed"]["w"][0] if self.cfg.tie_embeddings
                else layout.params["lm_head"]["w"][1])
        return logits if spec is None else all_gather(logits, layout.mesh, spec, dim=-1)

    def _head_local(self, params, x, w=None):
        cfg = self.cfg
        w = self._head_weight(params) if w is None else w
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
    def _features(self, params, batch, ctx: RunCtx, layout=None):
        """The final-normed features (B, S', d) of a full-sequence pass and
        the summed MoE aux loss (0.0 without MoE)."""
        x, _ = self._embed_batch(params, batch, layout)
        memory = self._memory(params, batch, x.dtype, ctx, layout)
        positions = torch.arange(x.shape[1], device=x.device)
        x, aux = self._run_groups(params["groups"], x, None, ctx=ctx, positions=positions,
                                  memory=memory, layout=layout)
        return rmsnorm(x, self._top(params, "final_norm", layout), self.cfg.rms_eps), aux

    def forward(self, params, batch, ctx: RunCtx):
        """Teacher-forced full-sequence logits through flash attention and
        the SSD scan. batch {"tokens": (B, S)}, with "frames" (B, M, d) for
        an enc-dec config and "patches" (B, n_patches, d_patch) for a VLM.
        Returns (logits (B, S', vocab), aux): S' counts the patch prefix
        positions too; aux is the MoE load-balance loss summed over layers
        (0.0 without MoE)."""
        layout = self._layout(params, ctx, batch["tokens"].shape[0])
        x, aux = self._features(params, batch, ctx, layout)
        return self._head(params, x, layout), aux

    def loss(self, params, batch, ctx: RunCtx, aux_weight: float = 0.01, xent_chunk: int = 0):
        """The training loss of ``batch`` ({"tokens", "labels"} (B, S), with
        "frames" / "patches" as ``forward``): the mean next-token
        cross-entropy over labels >= 0, plus ``aux_weight`` times the MoE
        aux loss. ``xent_chunk`` > 0 runs the head and logsumexp on
        ``xent_chunk`` positions at a time, each chunk under
        ``torch.utils.checkpoint``, so the (B, S, vocab) fp32 logits never
        exist at once. Returns (loss, {"xent", "aux"}), fp32 scalars.

        Under a mesh (the module's note): ``batch`` is the global batch, of
        which the rank takes its rows; the loss and xent are the global
        ones, aux the rank's data shard's, and the gradient is the rank's
        share (``training.train_step.reduce_grads`` sums the shares)."""
        layout = self._layout(params, ctx, batch["labels"].shape[0])
        labels = batch["labels"].long()
        if layout is not None:
            labels = layout.local_rows(labels)
            head_w = self._head_weight(params, layout)        # gathered once, not per chunk
        mask = (labels >= 0).float()
        labels_safe = labels.clamp_min(0)
        S = labels.shape[1]

        def chunk_ll(x, lab, m):
            logits = (self._head(params, x) if layout is None
                      else self._head_vocab(params, x, layout, head_w)).float()
            ll = logits.gather(-1, lab[..., None])[..., 0] - torch.logsumexp(logits, dim=-1)
            return torch.sum(ll * m)

        x, aux = self._features(params, batch, ctx, layout)
        x = x[:, x.shape[1] - S:]                              # drop patch positions
        if xent_chunk <= 0:
            ll_sum = chunk_ll(x, labels_safe, mask)
        else:
            C = xent_chunk
            pad = (-S) % C
            if pad:
                x = F.pad(x, (0, 0, 0, pad))
                labels_safe = F.pad(labels_safe, (0, pad))
                mask_p = F.pad(mask, (0, pad))
            else:
                mask_p = mask
            ll_sum = 0.0
            for i in range(0, x.shape[1], C):
                args = (x[:, i:i + C], labels_safe[:, i:i + C], mask_p[:, i:i + C])
                ll_sum = ll_sum + (checkpoint(chunk_ll, *args, use_reentrant=False,
                                              preserve_rng_state=False)
                                   if torch.is_grad_enabled() else chunk_ll(*args))
        count = mask.sum()
        if layout is not None and layout.batch is not None:
            ll_sum, count = psum(ll_sum, layout.mesh, layout.batch), psum(count, layout.mesh,
                                                                          layout.batch)
        xent = -ll_sum / torch.clamp_min(count, 1.0)
        aux = torch.as_tensor(aux, dtype=torch.float32, device=xent.device)
        total = xent + aux_weight * aux
        if layout is not None:                     # every rank computes it: shares of its gradient
            total = shared_out(total, layout.mesh)
        return total, {"xent": xent, "aux": aux}

    def prefill(self, params, batch, cache, ctx: RunCtx, last_pos=None):
        """Full-sequence pass through flash attention and the SSD scan that
        also fills the dense ring cache, the SSM states and, for an enc-dec
        config, the cross cache (from ``batch["frames"]``; the cache's
        memory_len must be M). ``last_pos`` (B,) selects the logits position
        among the text tokens (the true prompt end when prompts are
        right-padded; a patch prefix is added to it); defaults to the final
        position. Right padding is sound for attention layers only: in an
        SSM layer the padding tokens advance the carried state. Returns
        (last_logits (B, vocab), cache), the cache written in place."""
        ctx = ctx.with_mode("prefill")
        layout = self._layout(params, ctx, batch["tokens"].shape[0], cache)
        if layout is not None:
            last_pos = layout.local_rows(last_pos)
        x, offset = self._embed_batch(params, batch, layout)
        memory = self._memory(params, batch, x.dtype, ctx, layout)
        positions = torch.arange(x.shape[1], device=x.device)
        x, _ = self._run_groups(params["groups"], x, cache, ctx=ctx, positions=positions,
                                memory=memory, layout=layout)
        x = rmsnorm(x, params["final_norm"]["w"], self.cfg.rms_eps)
        if last_pos is None:
            last = x[:, -1:]
        else:
            last = x[torch.arange(x.shape[0], device=x.device), last_pos.long() + offset][:, None]
        return self._head(params, last, layout)[:, 0], cache

    def decode_step(self, params, tokens, cache, positions, ctx: RunCtx,
                    page_table=None, lengths=None):
        """tokens (B,1); positions (B,) absolute position of the new token.
        Over a dense cache the ring is read; over a paged cache (``kp`` /
        ``vp`` pools) ``page_table`` (B, max_pages) maps each row's pages and
        ``lengths`` (B,) counts its entries, the new token's included
        (default positions + 1). Positions count a VLM's patch prefix; an
        enc-dec config's cross attention reads the cross cache that prefill
        filled. Returns (logits (B, vocab), cache), the cache written in
        place."""
        ctx = ctx.with_mode("decode")
        if lengths is None:
            lengths = positions + 1
        layout = self._layout(params, ctx, tokens.shape[0], cache, positions=positions,
                              page_table=page_table)
        if layout is not None:
            tokens, positions, page_table, lengths = (
                layout.local_rows(t) for t in (tokens, positions, page_table, lengths))
        x = self._embed(params, tokens, layout)
        x, _ = self._run_groups(params["groups"], x, cache, ctx=ctx, positions=positions,
                                page_table=page_table, lengths=lengths, layout=layout)
        x = rmsnorm(x, params["final_norm"]["w"], self.cfg.rms_eps)
        return self._head(params, x, layout)[:, 0], cache

    def decode_chunk(self, params, tokens, cache, starts, nvalid, slots, first, ctx: RunCtx,
                     page_table, frames=None, patches=None, all_logits: bool = False):
        """Unified serving iteration over a paged cache: each batch row
        feeds a chunk of up to C tokens of one sequence — C == 1 is decode,
        C > 1 is a prefill chunk. KV goes straight into the paged pool.

        tokens (B, C); starts (B,) absolute position of each row's first
        token, before a VLM's patch offset; nvalid (B,) live tokens per row
        (0 = inactive row); slots (B,) engine slot per row, the row of the
        slot-pooled SSM state and cross cache (must be distinct); first (B,)
        True on a sequence's first chunk (resets the SSM and conv state);
        page_table (B, max_pages). ``frames`` (B, M, d): an enc-dec pack's
        raw encoder frames, encoded here, their cross keys and values
        written at the slots of rows that feed a token; without them cross
        attention reads the slots' cache. ``patches`` (B, n_patches,
        d_patch): a VLM pack's patch embeddings, whose projection is
        prefixed to every row and live on rows with starts == 0 (its KV
        takes positions [0, n_patches) there; on the other rows the prefix
        columns write to the null page and their outputs are dropped).
        Returns (logits (B, vocab) at each row's last valid position, cache)
        — the cache's pools, SSM states and cross cache updated in place.
        With ``all_logits`` the head runs on every text position instead,
        (B, C, vocab): the verify step of speculative decoding, where
        position j scores the token fed at index j + 1 (positions at or past
        a row's nvalid are padding).
        """
        cfg = self.cfg
        if cfg.vision is not None and any("M" in g.pattern for g in cfg.layer_groups):
            # the SSM chunk masking follows nvalid over the token axis and
            # would take a patch prefix for live tokens (no config has both)
            raise NotImplementedError("chunk mode: a vision patch prefix with SSM layers")
        ctx = ctx.with_mode("chunk")
        B, C = tokens.shape
        offset = cfg.vision.n_patches if cfg.vision is not None else 0
        ar = torch.arange(C, device=tokens.device)
        starts = starts.long()
        positions = offset + starts[:, None] + ar[None, :]
        valid = ar[None, :] < nvalid[:, None]
        n_prefix, q_positions = 0, None
        if cfg.vision is not None and patches is not None:
            n_prefix = patches.shape[1]
            live = ((starts == 0) & (nvalid > 0))[:, None]
            ap = torch.arange(n_prefix, device=tokens.device)
            positions = torch.cat([ap[None, :].expand(B, -1), positions], dim=1)
            valid = torch.cat([live.expand(B, n_prefix), valid], dim=1)
            # every live column j of row b sits at starts[b] + j: the
            # prefix's on rows with starts == 0, the text's (offset ==
            # n_prefix) on all rows. The attention kernel takes that affine
            # form; it differs only on the dead prefix columns.
            q_positions = starts[:, None] + torch.arange(n_prefix + C,
                                                         device=tokens.device)[None, :]
        layout = self._layout(params, ctx, B, cache, positions=positions, page_table=page_table,
                              valid=valid)
        if layout is not None:
            (tokens, starts, nvalid, slots, first, page_table, positions, valid, q_positions,
             frames, patches) = (layout.local_rows(t) for t in (
                 tokens, starts, nvalid, slots, first, page_table, positions, valid, q_positions,
                 frames, patches))
            B = tokens.shape[0]
            self._check_slots(cache, layout, slots)
        x = self._embed(params, tokens, layout)
        pack = {"slots": slots, "nvalid": nvalid, "first": first}
        if n_prefix:
            x = torch.cat([self._patch_prefix(params, patches, x.dtype, layout), x], dim=1)
            pack["q_positions"] = q_positions
        lengths = offset + starts + nvalid
        memory = None
        if cfg.encoder is not None and frames is not None:
            memory = self._encode(params, frames.to(x.dtype), ctx, layout)
        x, _ = self._run_groups(params["groups"], x, cache, ctx=ctx, positions=positions,
                                page_table=page_table, lengths=lengths, valid=valid, chunk=pack,
                                memory=memory, layout=layout)
        x = rmsnorm(x, params["final_norm"]["w"], cfg.rms_eps)
        if all_logits:
            return self._head(params, x[:, n_prefix:], layout), cache
        last = n_prefix + torch.clamp(nvalid.long(), min=1) - 1
        x_last = x[torch.arange(B, device=x.device), last]
        return self._head(params, x_last[:, None], layout)[:, 0], cache

    # ------------------------------------------------------------------ cache
    def init_cache(self, B: int, max_seq: int, dtype: torch.dtype = torch.float32, *,
                   kind: str = "dense", page_size: int = 16, num_pages: int = 0,
                   memory_len: int = 0,
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
        conv_dim, d_conv - 1) in ``dtype``. An enc-dec config's layers also
        hold, under either kind, "cross": "ck" / "cv" (R, B, M, Hkv, hd), M =
        ``memory_len`` or the config's cross_attn_memory.

        Inside ``use_sharding(mesh, rules)``: this rank's ``ShardedCache``,
        each leaf its shard by ``cache_partition_specs`` of the global cache.
        """
        if kind not in ("dense", "paged"):
            raise ValueError(f"cache kind {kind!r}: 'dense' or 'paged'")
        from repro_torch.distributed import sharding
        mesh, rules = sharding.active()
        if mesh is not None and rules is not None:
            self._mesh_pspecs(mesh, rules)
            with sharding.use_sharding(None, None):       # the global cache's shapes
                whole = self.init_cache(B, max_seq, dtype, kind=kind, page_size=page_size,
                                        num_pages=num_pages, memory_len=memory_len,
                                        device="meta")
            specs = sharding.cache_partition_specs(whole, mesh, rules)
            dev = resolve_device(device)
            leaves = []
            params_lib.map_tree(leaves.append, specs,
                                is_leaf=lambda x: isinstance(x, sharding.PartitionSpec))
            it = iter(leaves)

            def local(t):                                  # slot_pos (int32) starts at -1
                shape = sharding.local_shape(tuple(t.shape), next(it), mesh)
                return torch.full(shape, -1 if t.dtype == torch.int32 else 0, dtype=t.dtype,
                                  device=dev)
            return ShardedCache(params_lib.map_tree(local, whole), specs)
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
                entry = {"attn": c}
                if cfg.family == "encdec":
                    M = memory_len or cfg.encoder.cross_attn_memory
                    entry["cross"] = {
                        "ck": torch.zeros((R, B, M, Hkv, hd), dtype=dtype, device=dev),
                        "cv": torch.zeros((R, B, M, Hkv, hd), dtype=dtype, device=dev)}
                per_pos.append(entry)
            groups_cache.append(per_pos)
        return {"groups": groups_cache}


def build_model(cfg: ModelConfig) -> LM:
    return LM(cfg)
