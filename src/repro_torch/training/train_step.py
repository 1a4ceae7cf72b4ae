"""Training step factory (the reference's ``repro.training.train_step``):
loss -> gradients (autograd over the parameter tree's leaves, optionally
accumulated over microbatches in fp32) -> optional int8 gradient
compression with error feedback -> AdamW at the cosine schedule's lr.

On the card the attention gradient comes from the flash attention backward
kernel; the kernels without a backward (the SSD scan, the grouped and w8a16
matmuls, paged attention) raise if the loss would need one, so the step
trains the attention families (dense and MoE, through the capacity
strategy, enc-dec and VLM) there, and every family on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from repro_torch.distributed.collectives import (compress_grads_with_feedback,
                                                 decompress_grads, zeros_error_like)
from repro_torch.models.common import RunCtx
from repro_torch.models.params import tree_leaves, tree_unflatten
from repro_torch.training.optimizer import adamw_init, adamw_update, cosine_schedule


@dataclass(frozen=True)
class TrainConfig:
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    aux_weight: float = 0.01
    grad_compression: bool = False     # int8 + error feedback
    remat: bool = True
    xent_chunk: int = 0                # >0: sequence-chunked cross-entropy
    microbatches: int = 1              # >1: gradient accumulation (memory)


def make_train_step(model, tcfg: TrainConfig, ctx: Optional[RunCtx] = None
                    ) -> Tuple[Callable, Callable]:
    """Returns (init_fn(params) -> state, step_fn(params, state, batch) ->
    (params, state, metrics)); state = (AdamWState, error feedback tree or
    None). ``step_fn`` updates the parameters and the optimizer state in
    place and returns them; ``batch`` holds tensors on the parameters'
    device; metrics ``loss``, ``xent``, ``aux`` and ``lr`` are 0-d fp32
    tensors."""
    ctx = ctx or RunCtx(mode="train", moe_strategy="capacity", remat=tcfg.remat)

    def init_fn(params):
        err = zeros_error_like(params) if tcfg.grad_compression else None
        return (adamw_init(params), err)

    def loss_and_grads(leaves, params_g, batch):
        loss, metrics = model.loss(params_g, batch, ctx, aux_weight=tcfg.aux_weight,
                                   xent_chunk=tcfg.xent_chunk)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss does not reach (none in the configs) gets a zero gradient
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def step_fn(params, state, batch):
        opt_state, err = state
        # aliases of the leaves that autograd tracks (same storage, no copy)
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        params_g = tree_unflatten(params, leaves)
        nm = tcfg.microbatches
        if nm <= 1:
            loss, metrics, grads = loss_and_grads(leaves, params_g, batch)
        else:
            # gradient accumulation: the activation working set shrinks nm x;
            # grads accumulate in a params-sized fp32 buffer
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            ms = []
            for i in range(nm):
                b_i = {k: v.reshape(nm, v.shape[0] // nm, *v.shape[1:])[i]
                       for k, v in batch.items()}
                l, m, g = loss_and_grads(leaves, params_g, b_i)
                for a, x in zip(grads, g):
                    a.add_(x.float() / nm)
                loss = loss + l / nm
                ms.append(m)
            metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        del leaves, params_g
        grads = tree_unflatten(params, grads)
        if tcfg.grad_compression:
            qtree, err = compress_grads_with_feedback(grads, err)
            grads = decompress_grads(qtree)
        lr = cosine_schedule(opt_state.step + 1, peak_lr=tcfg.peak_lr, warmup=tcfg.warmup,
                             total=tcfg.total_steps)
        with torch.no_grad():
            params, opt_state = adamw_update(grads, opt_state, params, lr=lr,
                                             weight_decay=tcfg.weight_decay,
                                             grad_clip=tcfg.grad_clip)
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["lr"] = lr
        return params, (opt_state, err), metrics

    return init_fn, step_fn
