#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, in phases; any failure
exits non-zero and no phase's failure is caught.

  1. print the card's name and power limit; build the five CUDA sources of
     src/repro_torch/csrc (the six TPU kernels' ports: paged decode is the
     chunked attention source's split path in decode mode) with nvcc for
     sm_90a (one nvcc per source, in parallel) and print what ptxas reports
     (registers, spills).
  2. each kernel against its plain PyTorch version on the card: the small
     edge cases of the CPU tests, and the main paths' shapes at full
     Mixtral width (the SSD scan at mamba2's and jamba's, with a
     4096-token mamba2 prefill; chunked attention also at a verify width
     of 4 tokens and over a 4096-key context), in fp32 and
     bf16, and in bf16 at phase 8's shapes (chunked attention's 64- and
     32-row decode sweeps and its prefill pack over a 1024-page pool, gmm
     at 64 and 32 tokens), with the kernel's device time (its launch wrapper alone), the
     public op's time as a caller sees it (host work included), the plain
     version's and a PyTorch yardstick's times (the yardstick, SDPA or a
     plain matmul on float weights, is never called by the port; no single
     PyTorch call computes the SSD scan), beside the card's lower bound for
     the same work. The grouped matmul also on int8 experts; the w8a16
     matmul with the per-output-channel scale, the int8 tree's row scales
     and a transposed weight at the edges of its three kernels, then at
     mixtral's decode wq / wk / wo / head and prefill wq shapes. Chunked
     attention, flash attention, paged decode, the grouped matmul, the
     w8a16 matmul and the SSD scan print with each case the kernel, split
     count or column block and grid their plans chose, and call it twice
     for bit-equal results.
  3. full-width mixtral-8x7b at depth 2 in fp32, on the card and again on
     the CPU (plain versions), on the same two sequences of 20 tokens: the
     engine's ``decode_chunk`` (a pack of their first 16 / 11 tokens, then
     a decode sweep), ``forward`` at every position, ``prefill`` of the
     first 16 then 4 ``decode_step``s over the dense ring, and the same 4
     over the paged pool filled from the ring. Card vs CPU within
     LOGIT_ATOL with the same argmax; on the card, every path's logits also
     within LOGIT_ATOL of ``forward``'s at the same position. The same
     again on ``quantize_params_int8`` of those weights (w8a16 and the int8
     grouped matmul on the card). Then the same for mamba2 at depth 2, full
     width: ``forward``, ``prefill`` + 4 ``decode_step``s, and a
     ``decode_chunk`` pack whose ``first`` rows reset garbage states, then
     a decode sweep.
  4. the serving path: mixtral-8x7b at full width, depth cut from 32 to 8
     layers, random bf16 weights from a seed, ``InferenceEngine.generate``
     on 4 requests (prompts of 100-300 tokens, 32 new tokens, greedy,
     page_size 16). Every request must finish, the allocator invariants
     hold, and both kernels' launch counters (set to 0 just before) must
     be > 0, by the planned paths only (gmm: stream and mma; chunked
     attention: split and mma; neither tiled). Prints tok/s, TTFT and TBT.
  5. the model's generation path on phase 4's weights: ``LM.prefill`` of
     the same 4 prompts (right-padded to 297, flash attention), then
     GEN_STEPS = 32 greedy ``decode_step``s over the paged pool (paged
     decode kernel), so 33 tokens per request. The flash and paged decode
     launch counters (set to 0 just before) must be > 0, flash's by its
     planned path only (bf16: mma, never tiled). Prints prefill
     ms, decode step ms, tok/s, and how many leading tokens of each greedy
     stream equal phase 4's (printed only: bf16 near-ties may split two
     different kernels; phase 3 holds the fp32 agreement).
  6. mamba2-1.3b at full width and depth (48 layers), random bf16 weights
     from a seed, through ``InferenceEngine.generate`` as in phase 4 (every
     request finishes, allocator invariants, the SSD kernel's launch counter
     > 0, all on its ``mma`` path), then its generation API on the same
     weights (again ``mma`` only): ``prefill`` of each
     prompt at its own length, 32 batched ``decode_step``s, and how many
     leading tokens equal the engine's stream (printed only).
  7. mixtral-8x7b at full width and full depth (32 layers) on int8 weights
     (``init_params_int8`` of a bf16 init, ~47 GB: the bf16 model, ~93 GB,
     does not fit on one card): phase 4's serving run (the w8a16, grouped
     matmul and chunked attention launch counters > 0; weights' GB, init
     seconds and peak memory printed), then phase 5's generation API on the
     same weights; where a generation stream leaves the engine's, both
     paths' top-2 logits at the first diverging token (printed only).
  8. (run between phases 5 and 6, on phase 4's weights) the serving stack:
     client -> gateway (``scale_gateway_config``: binary frames, pooled
     connections) -> least-loaded router -> replica threads -> engines
     (page_size 16, 1024 pages, max_seq 2080, prefill chunk 128, greedy,
     bf16 KV). 64 requests of ``sample_workload(WorkloadSpec(n_requests=64,
     vocab=32000, seed=0))`` (OpenOrca-like lengths) at concurrency 64, 32
     new tokens each, after one warm-up request a replica: on one replica
     of 64 slots, then on two of 32 sharing the weights. Every request
     finishes with 32 tokens, no replica fails over, every replica served,
     every page is free again, the Figure-4 t-stamps are ordered, and the
     chunked attention and gmm launches (counters set to 0 just before)
     took exactly the paths their plans name for the two call shapes. An
     exception in a replica thread is re-raised here. Prints tok/s, TTFT
     and TBT p50/p99, TTFT's legs, each replica's step times and peak
     memory. Then a manual failover: two replicas, 16 requests, r0 failed
     after 64 token events; every request finishes (streams against the
     unfailed run printed only).
  9. a ``kernels`` JSON line (with each kernel's launches behind the stack
     as ``stack_launches``), then ``{"ok": true, "device": {...}}`` last.

Run on the card from the repository root:  python3 chip_smoke.py
Options: --out FILE writes every measurement as JSON; --profile adds
torch.profiler windows over short serving runs, over decode steps of the
generation paths and over a run of each stack layout (kernel time by name,
the device's busy share, and the stack's device and wall time a step).
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.float32: 67e12,        # fp32 outside the tensor cores
              torch.bfloat16: 989e12}      # dense bf16 tensor cores
LOGIT_ATOL = 2e-3                  # the repo's chunked-vs-dense logit bound
SERVE_LAYERS = 8                   # depth cut: 32 -> 8 layers (~23.7 GB bf16)
GEN_STEPS = 32                     # greedy decode_steps of phase 5
SLEEP_CYCLES = 200_000_000         # ~0.1-0.2 s of SM clock: time to enqueue 10 calls
STACK_REQUESTS = 64                # phase 8: concurrent requests of the OpenOrca-like mix
STACK_NEW = 32                     # new tokens a request
STACK_LAYOUTS = ((1, 64), (2, 32))  # (replicas, max_slots a replica) on one card
STACK_FAILOVER = (16, 64)          # failover run: requests, token events before the failure
STACK_PAGES, STACK_MAX_SEQ = 1024, 2080   # a replica's pool; the longest prompt + 32
STACK_PACK = (2, 128)              # the engine's prefill pack at 64 and at 32 slots


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def cuda_ms(fn, iters: int = 10, flush=None, queued: bool = True) -> float:
    """Mean time of one call of ``fn``: CUDA events around each of ``iters``
    calls, with ``flush`` (a buffer larger than L2) rewritten before each so
    every call starts with a cold L2, as in a real step.

    queued: a sleep kernel goes ahead of the calls, so the host enqueues
    them all before the device reaches them and the events time the device
    work alone, without the host's dispatch between launches (fails if the
    host fell behind). Without it (for a function that synchronises inside,
    or to measure an op as a caller sees it) each call is timed on its own
    and the device waits for the host's dispatch within it."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(iters)]
    if queued:
        torch.cuda._sleep(SLEEP_CYCLES)
        slept = torch.cuda.Event()
        slept.record()
    for a, b in ev:
        if flush is not None:
            flush.zero_()
        a.record()
        fn()
        b.record()
        if not queued:
            b.synchronize()
    if queued:
        assert not slept.query(), "the host fell behind the device: raise SLEEP_CYCLES"
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in ev) / iters


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# ------------------------------------------------------------------ phase 2
def attention_case(dev, *, B, C, H, Hkv, D, ps, maxp, num_pages, starts, nvalid, dtype,
                   window=0, softcap=0.0, seed=0, used_only=False):
    """Random q and pool. Every page-table entry gets a distinct pool page,
    or, with ``used_only``, only those below the row's length, the rest
    page 0 as the engine leaves them (a pool smaller than B * maxp)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, C, H, D), generator=g, device=dev).to(dtype)
    kp = torch.randn((num_pages, ps, Hkv, D), generator=g, device=dev).to(dtype)
    vp = torch.randn((num_pages, ps, Hkv, D), generator=g, device=dev).to(dtype)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    lengths = st + torch.tensor(nvalid, dtype=torch.int32, device=dev)
    if used_only:
        need = (lengths + ps - 1) // ps
        perm = torch.randperm(num_pages - 1, generator=g, device=dev)[:int(need.sum())] + 1
        used = torch.arange(maxp, device=dev)[None] < need[:, None]
        pt = torch.zeros((B, maxp), dtype=torch.int32, device=dev)
        pt[used] = perm.to(torch.int32)
    else:
        perm = torch.randperm(num_pages - 1, generator=g, device=dev)[:B * maxp] + 1
        pt = perm.reshape(B, maxp).to(torch.int32)
    qpos = st[:, None] + torch.arange(C, device=dev, dtype=torch.int32)[None]
    return q, kp, vp, pt, lengths, qpos, dict(scale=D ** -0.5, softcap=softcap, window=window)


def attention_bound(q, kp, lengths, qpos, dtype, window=0):
    """Bytes: q and out once; K and V once at each position some query of
    the row can see (below the row's length and its last query's position,
    within the window), and the page ids of those positions' pages.
    Operations: 4*D per visible (query head, key) pair."""
    B, C, H, D = q.shape
    ps, Hkv = kp.shape[1], kp.shape[2]
    L, pos = lengths.long().cpu(), qpos.long().cpu()
    hi = torch.minimum(L, pos[:, -1] + 1)
    lo = (pos[:, 0] - window + 1).clamp_min(0) if window else torch.zeros_like(hi)
    keys = (hi - lo).clamp_min(0)
    pages = torch.where(keys > 0, (hi + ps - 1) // ps - lo // ps, 0)
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * keys.sum().item() * Hkv * D * kp.element_size() + 4 * pages.sum().item())
    q_lo = (pos - window + 1).clamp_min(0) if window else torch.zeros_like(pos)
    vis = (torch.minimum(pos + 1, L[:, None]) - q_lo).clamp_min(0).sum().item()
    return bound_ms(nbytes, 4.0 * D * H * vis, dtype)


def sdpa_call(q, kp, vp, pt, lengths, qpos, scale, window=0):
    """The PyTorch yardstick: scaled_dot_product_attention over the gathered
    KV (the gather is done once, outside the timed call)."""
    import torch.nn.functional as F
    B, C, H, D = q.shape
    ps, Hkv = kp.shape[1], kp.shape[2]
    G = H // Hkv
    L = pt.shape[1] * ps
    k = kp[pt.long()].reshape(B, L, Hkv, D).repeat_interleave(G, 2).transpose(1, 2)
    v = vp[pt.long()].reshape(B, L, Hkv, D).repeat_interleave(G, 2).transpose(1, 2)
    kv = torch.arange(L, device=q.device)
    mask = (kv[None, None] < lengths[:, None, None]) & (kv[None, None] <= qpos[:, :, None])
    if window:
        mask &= kv[None, None] > qpos[:, :, None] - window
    qt = q.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=mask[:, None], scale=scale)


def run_attention(dev, flush, results):
    from repro_torch.kernels.paged_attention import (chunked_prefill_attention,
                                                     chunked_prefill_cuda,
                                                     chunked_prefill_reference)
    from repro_torch.kernels.paged_attention.kernel import plan_for
    # small edge cases of the CPU tests: mid-page starts, ragged lengths, an
    # idle (length 0) row, windows, softcap, head_dim 16, page sizes 4/8/16;
    # chunks of 8 (16 folded rows: the split kernel) and 24 (48 rows: bf16
    # on the tensor cores, fp32 on the tiles)
    for C in (8, 24):
        for dtype in (torch.float32, torch.bfloat16):
            for ps, window, softcap in ((4, 0, 0.0), (8, 5, 0.0), (16, 3, 2.0)):
                args = attention_case(dev, B=4, C=C, H=4, Hkv=2, D=16, ps=ps, maxp=8,
                                      num_pages=33, starts=[5, 0, 13, 0], nvalid=[8, 6, 3, 0],
                                      dtype=dtype, window=window, softcap=softcap, seed=ps)
                *t, kw = args
                out = chunked_prefill_attention(*t, **kw)
                plain = chunked_prefill_reference(*t, **kw)
                err = max_err(out, plain)
                tol = 1e-5 if dtype == torch.float32 else 1e-2
                assert err <= tol and not out[3].any() and torch.isfinite(out).all(), \
                    f"attention edge case C={C} ps={ps} w={window} {dtype}: err {err} > {tol}"
                assert torch.equal(out, chunked_prefill_attention(*t, **kw)), \
                    f"attention edge case C={C} ps={ps} w={window} {dtype}: a repeat gave other bits"
                plan = plan_for(t[0], t[1], t[3])
                log(f"  attention edge C={C} ps={ps} window={window} softcap={softcap} "
                    f"{str(dtype)[6:]} ({plan.path}, splits={plan.splits}, grid={plan.grid}): "
                    f"max_abs_err={err:.3g} (tol {tol}), repeat bit-equal")
    # serving-path shapes at full Mixtral width: the decode sweep, a verify
    # width of 4 tokens, the decode sweep over a long context (~4096 visible
    # keys a row, 256 pages), the prefill pack
    shapes = {
        "decode": dict(B=4, C=1, starts=[131, 219, 299, 166], nvalid=[1, 1, 1, 1]),
        "decode C=4": dict(B=4, C=4, starts=[128, 216, 296, 163], nvalid=[4, 4, 4, 4]),
        "decode long": dict(B=4, C=1, starts=[4000, 4095, 3900, 4050], nvalid=[1, 1, 1, 1],
                            maxp=256, num_pages=1040),
        "prefill": dict(B=2, C=128, starts=[0, 128], nvalid=[128, 100]),
    }
    dtypes = {name: (torch.float32, torch.bfloat16) for name in shapes}
    # phase 8's shapes, bf16 as it serves: its decode sweeps (64 and 32
    # slots, the rows at the workload's prompt lengths + 31, their last
    # step) and its prefill pack (a first chunk, and the last, partial chunk
    # of the longest prompt), over a replica's pool with only the pages a
    # row holds in its page table
    from repro_torch.data.workload import WorkloadSpec, sample_workload
    plens = [len(p) for p in sample_workload(WorkloadSpec(n_requests=STACK_REQUESTS,
                                                          vocab=32000, seed=0))[0]]
    stack = dict(maxp=-(-STACK_MAX_SEQ // 16), num_pages=STACK_PAGES, used_only=True)
    for _, slots in STACK_LAYOUTS:
        shapes[f"stack decode B={slots}"] = dict(
            stack, B=slots, C=1, starts=[n + STACK_NEW - 2 for n in plens[:slots]],
            nvalid=[1] * slots)
    last = max(plens)
    rows, chunk = STACK_PACK
    shapes["stack prefill pack"] = dict(
        stack, B=rows, C=chunk, starts=[0, (last - 1) // chunk * chunk],
        nvalid=[chunk, last - (last - 1) // chunk * chunk])
    dtypes.update({name: (torch.bfloat16,) for name in shapes if name.startswith("stack")})
    # fp32: reduction order only; bf16: one rounding of outputs |o| < 4
    tols = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    for name, sh in shapes.items():
        sh = dict(dict(maxp=32, num_pages=256), **sh)
        for dtype in dtypes[name]:
            *t, kw = attention_case(dev, H=32, Hkv=8, D=128, ps=16, dtype=dtype, seed=1, **sh)
            q, kp, vp, pt, lengths, qpos = t
            plan = plan_for(q, kp, pt)
            out = chunked_prefill_attention(*t, **kw)
            plain = chunked_prefill_reference(*t, **kw)
            err = max_err(out, plain)
            assert err <= tols[dtype], f"attention {name} {dtype}: err {err} > {tols[dtype]}"
            assert torch.equal(out, chunked_prefill_attention(*t, **kw)), \
                f"attention {name} {dtype}: a repeat gave other bits"
            del out, plain
            starts = qpos[:, 0].contiguous()
            # the kernel alone (its launch wrapper on int32 inputs made here),
            # then the public op as the model calls it, host work included
            ms = cuda_ms(lambda: chunked_prefill_cuda(q, kp, vp, pt, lengths, starts, **kw),
                         flush=flush)
            op_ms = cuda_ms(lambda: chunked_prefill_attention(*t, **kw), flush=flush,
                            queued=False)
            plain_ms = cuda_ms(lambda: chunked_prefill_reference(*t, **kw), flush=flush)
            library_ms = cuda_ms(sdpa_call(*t, kw["scale"]), flush=flush)
            bms, by = attention_bound(q, kp, lengths, qpos, dtype, kw["window"])
            row = dict(kernel="chunked_prefill_attention", case=name, dtype=str(dtype)[6:],
                       shape=f"q{tuple(q.shape)} pool{tuple(kp.shape)} lengths "
                             + (f"{lengths.tolist()}" if q.shape[0] <= 4 else
                                f"{int(lengths.min())}..{int(lengths.max())} "
                                f"(sum {int(lengths.sum())})"),
                       path=plan.path, splits=plan.splits, grid=list(plan.grid),
                       max_abs_err=err, ms=ms, op_ms=op_ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=bms, bound_by=by)
            results.append(row)
            log(f"  attention {name} {row['dtype']} {row['shape']} path={plan.path} "
                f"splits={plan.splits} grid={plan.grid}: kernel_ms={ms:.4f} op_ms={op_ms:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} bound_ms={bms:.6f} "
                f"({by}) max_abs_err={err:.3g}, repeat bit-equal")
            del q, kp, vp, pt, lengths, qpos, t
            torch.cuda.empty_cache()


def flash_bound(q, k, dtype, *, causal, window, q_offset=0):
    """Bytes: q, k, v and out once each. Operations: 4*D per visible
    (query head, key) pair (causal and window counted per row)."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    qpos = torch.arange(Sq, dtype=torch.int64) + q_offset
    hi = torch.clamp(qpos + 1, max=Skv) if causal else torch.full_like(qpos, Skv)
    lo = (qpos - window + 1).clamp_min(0) if window else torch.zeros_like(qpos)
    pairs = B * H * (hi - lo).clamp_min(0).sum().item()
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return bound_ms(nbytes, 4.0 * D * pairs, dtype)


def run_flash(dev, flush, results):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_cuda,
                                                     mha_reference)
    from repro_torch.kernels.flash_attention.kernel import plan_for
    # small edge cases of the CPU tests (head_dim 16): GQA / MQA, window,
    # softcap, q_offset, non-causal, ragged Sq / Skv of no tile multiple
    tols = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # tests/test_kernels_flash.py
    for dtype in (torch.float32, torch.bfloat16):
        for B, Sq, Skv, H, Hkv, causal, window, softcap, qoff in (
                (2, 64, 64, 4, 1, True, 0, 0.0, 0), (1, 80, 80, 4, 2, True, 16, 30.0, 0),
                (2, 32, 96, 2, 2, True, 0, 0.0, 64), (1, 50, 70, 4, 2, False, 0, 0.0, 0)):
            g = torch.Generator(device=dev).manual_seed(Sq + Skv)
            q = torch.randn((B, Sq, H, 16), generator=g, device=dev).to(dtype)
            k, v = (torch.randn((B, Skv, Hkv, 16), generator=g, device=dev).to(dtype)
                    for _ in range(2))
            kw = dict(causal=causal, window=window, softcap=softcap, q_offset=qoff)
            out = flash_attention(q, k, v, **kw)
            err = max_err(out, mha_reference(q, k, v, **kw))
            assert err <= tols[dtype] and torch.isfinite(out).all(), \
                f"flash edge case {Sq}x{Skv} {kw} {dtype}: err {err} > {tols[dtype]}"
            assert torch.equal(out, flash_attention(q, k, v, **kw)), \
                f"flash edge case {Sq}x{Skv} {kw} {dtype}: a repeat gave other bits"
            plan = plan_for(q, k)
            log(f"  flash edge Sq={Sq} Skv={Skv} H={H}/{Hkv} {kw} {str(dtype)[6:]} "
                f"({plan.path}, grid={plan.grid}): max_abs_err={err:.3g} (tol {tols[dtype]}), "
                f"repeat bit-equal")
    # the generation path's prefill at full width: 4 prompts right-padded to
    # 297 tokens, Mixtral's heads (causal); then gemma2's heads with its
    # window (cut to 128 to bite at 297 tokens) and attention softcap
    for name, Hkv, window, softcap in (("prefill", 8, 0, 0.0), ("prefill window", 16, 128, 50.0)):
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device=dev).manual_seed(7)
            q = torch.randn((4, 297, 32, 128), generator=g, device=dev).to(dtype)
            k, v = (torch.randn((4, 297, Hkv, 128), generator=g, device=dev).to(dtype)
                    for _ in range(2))
            kw = dict(causal=True, window=window, softcap=softcap, scale=128 ** -0.5)
            plan = plan_for(q, k)
            out = flash_attention(q, k, v, **kw)
            plain = mha_reference(q, k, v, **kw)
            err = max_err(out, plain)
            assert err <= tols[dtype], f"flash {name} {dtype}: err {err} > {tols[dtype]}"
            assert torch.equal(out, flash_attention(q, k, v, **kw)), \
                f"flash {name} {dtype}: a repeat gave other bits"
            del out, plain
            ms = cuda_ms(lambda: flash_attention_cuda(q, k, v, **kw), flush=flush)
            op_ms = cuda_ms(lambda: flash_attention(q, k, v, **kw), flush=flush, queued=False)
            plain_ms = cuda_ms(lambda: mha_reference(q, k, v, **kw), flush=flush)
            # yardstick: SDPA on K/V repeated to the 32 query heads (made
            # once, outside the timed call), the same mask as a boolean
            G = 32 // Hkv
            qt = q.transpose(1, 2)
            kt, vt = (t.repeat_interleave(G, 2).transpose(1, 2) for t in (k, v))
            i = torch.arange(297, device=dev)
            mask = (i[None, :] <= i[:, None]) & ((i[None, :] > i[:, None] - window)
                                                 if window else True)
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=kw["scale"]), flush=flush)
            bms, by = flash_bound(q, k, dtype, causal=True, window=window)
            row = dict(kernel="flash_attention", case=name, dtype=str(dtype)[6:],
                       shape=f"q{tuple(q.shape)} kv{tuple(k.shape)} causal window={window} "
                             f"softcap={softcap}",
                       path=plan.path, grid=list(plan.grid),
                       max_abs_err=err, ms=ms, op_ms=op_ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=bms, bound_by=by)
            results.append(row)
            log(f"  flash {name} {row['dtype']} {row['shape']} path={plan.path} "
                f"grid={plan.grid}: kernel_ms={ms:.4f} op_ms={op_ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms={library_ms:.4f} bound_ms={bms:.6f} ({by}) max_abs_err={err:.3g}, "
                f"repeat bit-equal")
            del q, k, v, qt, kt, vt
            torch.cuda.empty_cache()


def run_paged_decode(dev, flush, results):
    from repro_torch.kernels.paged_attention import (paged_attention, paged_attention_cuda,
                                                     paged_attention_reference)
    from repro_torch.kernels.paged_attention.kernel import plan_for
    tols = {torch.float32: 2e-5, torch.bfloat16: 3e-2}   # tests/test_kernels_paged.py
    # small edge cases: page sizes 4 / 8 / 16, head_dim 16, a length-0 row,
    # windows, softcap
    for dtype in (torch.float32, torch.bfloat16):
        for ps, window, softcap in ((4, 0, 0.0), (8, 9, 0.0), (16, 3, 30.0)):
            *t, kw = attention_case(dev, B=4, C=1, H=8, Hkv=2, D=16, ps=ps, maxp=8,
                                    num_pages=33, starts=[0, 0, 2 * ps + 2, 8 * ps - 1],
                                    nvalid=[1, 0, 1, 1], dtype=dtype, window=window,
                                    softcap=softcap, seed=ps)
            q, kp, vp, pt, lengths, _ = t
            out = paged_attention(q[:, 0], kp, vp, pt, lengths, **kw)
            err = max_err(out, paged_attention_reference(q[:, 0], kp, vp, pt, lengths, **kw))
            assert err <= tols[dtype] and not out[1].any() and torch.isfinite(out).all(), \
                f"paged decode edge case ps={ps} w={window} {dtype}: err {err} > {tols[dtype]}"
            assert torch.equal(out, paged_attention(q[:, 0], kp, vp, pt, lengths, **kw)), \
                f"paged decode edge case ps={ps} w={window} {dtype}: a repeat gave other bits"
            plan = plan_for(q, kp, pt)
            log(f"  paged decode edge ps={ps} window={window} softcap={softcap} "
                f"{str(dtype)[6:]} ({plan.path}, splits={plan.splits}): max_abs_err={err:.3g} "
                f"(tol {tols[dtype]}), length-0 row zeros, repeat bit-equal")
    # the generation path's decode at full Mixtral width (row 1's decode
    # shape), and the same with a window and softcap
    for name, window, softcap in (("decode", 0, 0.0), ("decode window", 128, 50.0)):
        for dtype in (torch.float32, torch.bfloat16):
            *t, kw = attention_case(dev, B=4, C=1, H=32, Hkv=8, D=128, ps=16, maxp=32,
                                    num_pages=256, starts=[131, 219, 299, 166],
                                    nvalid=[1, 1, 1, 1], dtype=dtype, window=window,
                                    softcap=softcap, seed=1)
            q4, kp, vp, pt, lengths, qpos = t
            q = q4[:, 0].contiguous()
            plan = plan_for(q4, kp, pt)
            out = paged_attention(q, kp, vp, pt, lengths, **kw)
            err = max_err(out, paged_attention_reference(q, kp, vp, pt, lengths, **kw))
            assert err <= tols[dtype], f"paged decode {name} {dtype}: err {err} > {tols[dtype]}"
            assert torch.equal(out, paged_attention(q, kp, vp, pt, lengths, **kw)), \
                f"paged decode {name} {dtype}: a repeat gave other bits"
            ms = cuda_ms(lambda: paged_attention_cuda(q, kp, vp, pt, lengths, **kw), flush=flush)
            op_ms = cuda_ms(lambda: paged_attention(q, kp, vp, pt, lengths, **kw), flush=flush,
                            queued=False)
            plain_ms = cuda_ms(lambda: paged_attention_reference(q, kp, vp, pt, lengths, **kw),
                               flush=flush)
            library_ms = cuda_ms(sdpa_call(q4, kp, vp, pt, lengths, qpos, kw["scale"], window),
                                 flush=flush)
            bms, by = attention_bound(q4, kp, lengths, qpos, dtype, window)
            row = dict(kernel="paged_attention", case=name, dtype=str(dtype)[6:],
                       shape=f"q{tuple(q.shape)} pool{tuple(kp.shape)} lengths "
                             f"{lengths.tolist()} window={window} softcap={softcap}",
                       path=plan.path, splits=plan.splits, grid=list(plan.grid),
                       max_abs_err=err, ms=ms, op_ms=op_ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=bms, bound_by=by)
            results.append(row)
            log(f"  paged {name} {row['dtype']} path={plan.path} splits={plan.splits} "
                f"grid={plan.grid}: kernel_ms={ms:.4f} op_ms={op_ms:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} bound_ms={bms:.6f} "
                f"({by}) max_abs_err={err:.3g}, repeat bit-equal")


def gmm_case(dev, *, tokens, E, K, N, dtype, seed=0):
    """Rows of ``tokens`` tokens routed top-2 by a random router, sorted by
    expert; weights scaled like the model's LeCun init (outputs ~ N(0,1))."""
    g = torch.Generator(device=dev).manual_seed(seed)
    logits = torch.randn((tokens, E), generator=g, device=dev)
    e = torch.topk(logits, 2, dim=-1).indices.reshape(-1)
    order = torch.argsort(e, stable=True)
    gs = torch.bincount(e, minlength=E)
    x = torch.randn((2 * tokens, K), generator=g, device=dev)[order].to(dtype)
    w = torch.empty((E, K, N), device=dev, dtype=dtype)
    for i in range(E):
        w[i] = (torch.randn((K, N), generator=g, device=dev) * K ** -0.5).to(dtype)
    return x, w, gs


def run_gmm(dev, flush, results):
    from repro_torch.kernels.moe_gmm import gmm, gmm_reference
    from repro_torch.kernels.moe_gmm.kernel import plan_for
    from repro_torch.quant import quantize_leaf
    for dtype in (torch.float32, torch.bfloat16):
        # the CPU tests' cases (unit weights: outputs of size ~sqrt(K)),
        # then the edges of the three paths with weights scaled like the
        # model's init (outputs ~ N(0, 1)): one row, 16 on one expert (the
        # last streaming M), 17 (the first tensor-core / tiled one), 512
        # with 300 on one expert; ragged K and N
        for sizes, K, N, scaled in (([8, 8, 8, 8], 16, 24, False), ([0, 32, 0, 1], 16, 24, False),
                                    ([33], 16, 24, False), ([1, 1, 1, 1, 29], 16, 24, False),
                                    ([0, 70, 0, 1], 40, 130, False), ([0, 1, 0, 0], 40, 130, True),
                                    ([0, 0, 16], 48, 272, True), ([17, 0, 0], 48, 272, True),
                                    ([300, 100, 50, 62], 200, 130, True)):
            g = torch.Generator(device=dev).manual_seed(len(sizes))
            gs = torch.tensor(sizes, device=dev)
            x = torch.randn((int(gs.sum()), K), generator=g, device=dev).to(dtype)
            w = torch.randn((len(sizes), K, N), generator=g, device=dev)
            w = (w * K ** -0.5 if scaled else w).to(dtype)
            tol = 1e-4 if dtype == torch.float32 else 5e-2
            # the float experts, then the same experts in int8
            errs = []
            for wk in (w, quantize_leaf(w)):
                out = gmm(x, wk, gs)
                errs.append(max_err(out, gmm_reference(x, wk, gs)))
                assert torch.equal(out, gmm(x, wk, gs)), \
                    f"gmm edge case {sizes} {dtype}: a repeat gave other bits"
            assert max(errs) <= tol, f"gmm edge case {sizes} {dtype}: err {errs} > {tol}"
            path = plan_for(int(gs.sum()), x, w).path
            log(f"  gmm edge sizes={sizes} K={K} N={N} {str(dtype)[6:]} ({path}): "
                f"max_abs_err={errs[0]:.3g}, int8 experts {errs[1]:.3g} (tol {tol}), "
                f"repeats bit-equal")
    # fp32: reduction order over K; bf16: one rounding of outputs |o| < 5.
    # Then the same cases on int8 experts (scale per expert and input row,
    # as the int8 tree has them) against the plain version on the same
    # QuantizedLinear; the yardstick stays torch.matmul on the x-dtype
    # weights. In bf16 the two round fp32 sums taken in different orders,
    # so an output may land one bf16 step away: 2^-5 for |o| < 8
    tols = {(False, torch.float32): 1e-3, (False, torch.bfloat16): 3e-2,
            (True, torch.float32): 1e-3, (True, torch.bfloat16): 2 ** -5}
    # tokens: the engine's decode sweep (4 slots), 8 tokens, a prefill pack
    for int8 in (False, True):
        for tokens in (4, 8, 256):
            for K, N in ((4096, 14336), (14336, 4096)):
                for dtype in (torch.float32, torch.bfloat16):
                    run_gmm_case(dev, flush, results, tokens=tokens, K=K, N=N, dtype=dtype,
                                 int8=int8, tol=tols[int8, dtype])
    # phase 8's decode sweeps (64 and 32 slots), bf16 as it serves; its
    # prefill pack (256 tokens) is the case above
    for _, tokens in STACK_LAYOUTS:
        for K, N in ((4096, 14336), (14336, 4096)):
            run_gmm_case(dev, flush, results, tokens=tokens, K=K, N=N, dtype=torch.bfloat16,
                         int8=False, tol=tols[False, torch.bfloat16])


def run_gmm_case(dev, flush, results, *, tokens, K, N, dtype, int8, tol):
    from repro_torch.kernels.moe_gmm import gmm, gmm_reference, gmm_tiles_cuda, tile_layout
    from repro_torch.kernels.moe_gmm.kernel import block_m_for, plan_for
    from repro_torch.quant import quantize_leaf
    x, w, gs = gmm_case(dev, tokens=tokens, E=8, K=K, N=N, dtype=dtype, seed=tokens)
    wk = quantize_leaf(w) if int8 else w
    M = x.shape[0]
    out = gmm(x, wk, gs)
    err = max_err(out, gmm_reference(x, wk, gs))
    kind = " int8" if int8 else ""
    assert err <= tol, f"gmm{kind} {tokens} tok {K}->{N} {dtype}: err {err}"
    assert torch.equal(out, gmm(x, wk, gs)), \
        f"gmm{kind} {tokens} tok {K}->{N} {dtype}: a repeat gave other bits"
    bm = block_m_for(M)
    dst, te, tr, Mp = tile_layout(gs, M, bm)
    x_pad = x.new_empty((Mp, x.shape[1]))
    x_pad[dst] = x
    wq = wk.q if int8 else w
    plan = plan_for(M, x_pad, wq)
    # the kernel alone on the padded layout made here, then the
    # public op (layout, scatter, kernel, gather) as a caller sees it
    scale = wk.scale.reshape(wk.q.shape[:2]) if int8 else None
    ms = cuda_ms(lambda: gmm_tiles_cuda(x_pad, wq, te, tr, bm, w_scale=scale, rows=M),
                 flush=flush)
    op_ms = cuda_ms(lambda: gmm(x, wk, gs), flush=flush, queued=False)
    # the plain version reads the group sizes back to the host
    plain_ms = cuda_ms(lambda: gmm_reference(x, wk, gs), flush=flush, queued=False)
    bounds = np.concatenate([[0], np.cumsum(gs.tolist())])
    parts = [(i, int(bounds[i]), int(bounds[i + 1])) for i in range(8)
             if bounds[i + 1] > bounds[i]]
    lib_ms = cuda_ms(lambda: [torch.matmul(x[a:b], w[i]) for i, a, b in parts], flush=flush)
    active = len(parts)
    es = x.element_size()
    wbytes = active * K * (N + 4) if int8 else active * K * N * es
    nbytes = (M * K + M * N) * es + wbytes + gs.numel() * gs.element_size()
    bms, by = bound_ms(nbytes, 2.0 * M * K * N, dtype)
    row = dict(kernel="moe_gmm", case=f"{tokens}tok {K}->{N}{kind}", dtype=str(dtype)[6:],
               shape=f"x({M},{K}) w(8,{K},{N}){kind} experts_active={active}",
               path=plan.path, splits=plan.splits, grid=list(plan.grid),
               max_abs_err=err, ms=ms, op_ms=op_ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=bms, bound_by=by)
    results.append(row)
    log(f"  gmm{kind} {tokens} tokens top-2 K={K} N={N} {row['dtype']} path={plan.path} "
        f"splits={plan.splits} grid={plan.grid}: kernel_ms={ms:.4f} op_ms={op_ms:.4f} "
        f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={bms:.4f} ({by}) max_abs_err={err:.3g}, "
        f"repeat bit-equal")
    del x, w, wk, x_pad, out
    torch.cuda.empty_cache()


def w8a16_case(dev, *, M, K, N, G, dtype, seed=0):
    """x (M, K) and a (K, N) weight scaled like the model's LeCun init,
    quantized as the int8 tree quantizes a leaf: over its last axis, so one
    scale per input row (G = 1) or, for a (K, G, N / G) leaf such as wq,
    per (input row, head). Returns x, the weight in x's dtype (the
    yardstick's), q (K, N) int8 and the row scale (K, G)."""
    from repro_torch.quant import quantize_leaf
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=dev).to(dtype)
    w = torch.randn((K, N), generator=g, device=dev) * K ** -0.5
    ql = quantize_leaf(w.reshape(K, G, N // G))
    return x, w.to(dtype), ql.q.reshape(K, N), ql.scale.reshape(K, G)


def w8a16_bound(M, K, N, G, dtype):
    """Bytes: x and out once in x's dtype, the int8 weights and the fp32
    row scales (K, G) once. Operations: 2 M K N at the dtype's peak."""
    es = torch.finfo(dtype).bits // 8
    nbytes = M * K * es + K * N + 4 * K * G + M * N * es
    return bound_ms(nbytes, 2.0 * M * K * N, dtype)


def run_w8a16(dev, flush, results):
    from repro_torch.kernels.quant_matmul import (w8a16_matmul, w8a16_matmul_cuda,
                                                  w8a16_matmul_reference)
    from repro_torch.kernels.quant_matmul.kernel import plan_for
    from repro_torch.kernels.quant_matmul.ops import quantize_int8
    # small edge cases: the CPU tests' shapes with the per-output-channel
    # scale (the TPU kernel's own function); ragged M / N / K with the row
    # scale per input row and per head; the transposed-stride weight of a
    # tied head with its col scale; the edges of the three kernels (the
    # last streaming M and the first tensor-core one, k-major past 16 rows,
    # ragged N and K on the tensor cores, 8 groups of 128 at N = 1024)
    tols = {torch.float32: 1e-3, torch.bfloat16: 5e-2}   # tests/test_kernels_quant.py / _gmm
    for dtype in (torch.float32, torch.bfloat16):
        for M, K, N, form in ((16, 64, 32, "col"), (32, 128, 64, "col"), (8, 32, 16, "col"),
                              (5, 100, 130, "rows"), (70, 96, 128, "heads"),
                              (4, 160, 300, "transposed"), (16, 256, 512, "heads"),
                              (17, 256, 512, "heads"), (40, 160, 300, "transposed"),
                              (100, 33, 50, "rows"), (4, 512, 1024, "heads8"),
                              (80, 512, 1024, "heads8")):
            g = torch.Generator(device=dev).manual_seed(M + K + N)
            x = torch.randn((M, K), generator=g, device=dev).to(dtype)
            w = torch.randn((N, K) if form == "transposed" else (K, N), generator=g, device=dev)
            if form in ("col", "transposed"):
                q, col = quantize_int8(w, axis=1 if form == "transposed" else 0)
                q = q.T if form == "transposed" else q        # strides (1, K)
                row = None
            else:
                col = None
                G = {"rows": 1, "heads": 4, "heads8": 8}[form]
                _, _, q, row = w8a16_case(dev, M=M, K=K, N=N, G=G, dtype=dtype, seed=M)
            out = w8a16_matmul(x, q, col, row_scale=row)
            err = max_err(out, w8a16_matmul_reference(x, q, col, row))
            assert err <= tols[dtype] and out.dtype == dtype and torch.isfinite(out).all(), \
                f"w8a16 edge case {M}x{K}x{N} {form} {dtype}: err {err} > {tols[dtype]}"
            assert torch.equal(out, w8a16_matmul(x, q, col, row_scale=row)), \
                f"w8a16 edge case {M}x{K}x{N} {form} {dtype}: a repeat gave other bits"
            log(f"  w8a16 edge M={M} K={K} N={N} {form} {str(dtype)[6:]} "
                f"({plan_for(x, q).path}): max_abs_err={err:.3g} (tol {tols[dtype]})")
    # full-width mixtral shapes: at decode (4 rows) wq (row scale per head of
    # 128), wk / wv (8 heads of 128), wo (one scale per input row) and the
    # head (lm_head (4096, 32000), one per row); wq over a prefill pack of
    # 256 rows
    for name, M, N, G in (("decode wq", 4, 4096, 32), ("decode wk", 4, 1024, 8),
                          ("decode wo", 4, 4096, 1), ("decode head", 4, 32000, 1),
                          ("prefill wq", 256, 4096, 32)):
        K = 4096
        for dtype in (torch.float32, torch.bfloat16):
            x, w, q, row = w8a16_case(dev, M=M, K=K, N=N, G=G, dtype=dtype, seed=M + N)
            plan = plan_for(x, q)
            out = w8a16_matmul(x, q, row_scale=row)
            err = max_err(out, w8a16_matmul_reference(x, q, None, row))
            # fp32: reduction order over K; bf16: the kernel and the plain
            # version round fp32 sums taken in different orders (and the
            # tensor-core path takes q * row_scale as two bf16 parts, within
            # 2^-14), so an output may land one bf16 step away: 2^-5 for
            # |o| < 8
            tol = 1e-3 if dtype == torch.float32 else 2 ** -5
            assert err <= tol, f"w8a16 {name} {dtype}: err {err} > {tol}"
            assert torch.equal(out, w8a16_matmul(x, q, row_scale=row)), \
                f"w8a16 {name} {dtype}: a repeat gave other bits"
            ms = cuda_ms(lambda: w8a16_matmul_cuda(x, q, None, row), flush=flush)
            op_ms = cuda_ms(lambda: w8a16_matmul(x, q, row_scale=row), flush=flush,
                            queued=False)
            plain_ms = cuda_ms(lambda: w8a16_matmul_reference(x, q, None, row), flush=flush)
            library_ms = cuda_ms(lambda: torch.matmul(x, w), flush=flush)
            bms, by = w8a16_bound(M, K, N, G, dtype)
            row_ = dict(kernel="w8a16_matmul", case=name, dtype=str(dtype)[6:],
                        shape=f"x({M},{K}) q({K},{N}) int8 row_scale({K},{G})",
                        path=plan.path, splits=plan.splits, grid=list(plan.grid),
                        max_abs_err=err, ms=ms, op_ms=op_ms, plain_ms=plain_ms,
                        library_ms=library_ms, bound_ms=bms, bound_by=by)
            results.append(row_)
            log(f"  w8a16 {name} {row_['dtype']} {row_['shape']} path={plan.path} "
                f"splits={plan.splits} grid={plan.grid}: kernel_ms={ms:.4f} "
                f"op_ms={op_ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
                f"(torch.matmul on the {str(dtype)[6:]} weights) bound_ms={bms:.6f} ({by}) "
                f"max_abs_err={err:.3g}, repeat bit-equal")
            del x, w, q, row, out
            torch.cuda.empty_cache()


def ssd_case(dev, *, B, L, H, P, N, G, dtype, init=False, nvalid=None, seed=0):
    """SSD scan inputs made on the card: x / B / C in ``dtype``, dt and A in
    fp32 (dt = 0 past each row's nvalid live tokens, as the engine masks a
    ragged pack), an fp32 initial state when ``init``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((B, L, H, P), generator=g, device=dev).to(dtype)
    dt = torch.rand((B, L, H), generator=g, device=dev) * 0.19 + 0.01
    if nvalid is not None:
        live = torch.arange(L, device=dev)[None, :] < torch.tensor(nvalid, device=dev)[:, None]
        dt = torch.where(live[..., None], dt, 0.0)
    A = -(torch.rand((H,), generator=g, device=dev) * 1.5 + 0.5)
    Bm, Cm = (torch.randn((B, L, G, N), generator=g, device=dev).to(dtype) for _ in range(2))
    s0 = torch.randn((B, H, P, N), generator=g, device=dev) if init else None
    return x, dt, A, Bm, Cm, s0


def ssd_bound(x, Bm, init, dtype):
    """Bytes: x, dt, A, B, C and the initial state read once; y and the final
    state (fp32) written once. Operations: the chunked algorithm at the
    kernel's 64-token tiles over all L tokens: per (row, head) and tile of
    n tokens, 2(N+P) per causal pair (C.B and M.x) and 4NP per token (the
    state read out and the state update)."""
    B, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    es = x.element_size()
    nbytes = (B * L * H * P * es + B * L * H * 4 + H * 4 + 2 * B * L * G * N * es
              + (B * H * P * N * 4 if init else 0) + B * L * H * P * 4 + B * H * P * N * 4)
    tiles = [min(64, L - t0) for t0 in range(0, L, 64)]
    flops = B * H * sum(n * (n + 1) / 2 * 2 * (N + P) + 4 * n * N * P for n in tiles)
    return bound_ms(nbytes, flops, dtype)


def run_ssd(dev, flush, results):
    from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_reference, ssd_scan, ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.kernel import plan_for
    # small edge cases of the CPU and card tests: tests/test_kernels_ssd.py's
    # shapes (ragged L), tests/test_mamba.py's (P 4 / N 5, P 3 / N 4, chunk 4)
    # with a carried state, the tiny configs' widths with groups and a ragged
    # row whose padded tokens must leave the state untouched
    for dtype in (torch.float32, torch.bfloat16):
        for B, L, H, P, N, G, chunk, init, nvalid in (
                (2, 32, 3, 8, 4, 3, 8, False, None), (1, 24, 2, 16, 8, 2, 8, False, None),
                (2, 27, 2, 8, 4, 2, 8, False, None), (2, 17, 3, 4, 5, 3, 4, True, None),
                (1, 16, 2, 3, 4, 2, 4, True, None), (2, 40, 8, 16, 16, 1, 16, True, [40, 13])):
            x, dt, A, Bm, Cm, s0 = ssd_case(dev, B=B, L=L, H=H, P=P, N=N, G=G, dtype=dtype,
                                            init=init, nvalid=nvalid, seed=L)
            y, s = ssd_chunked(x, dt, A, Bm, Cm, chunk, init_state=s0)
            rep = H // G
            Br, Cr = Bm.repeat_interleave(rep, 2), Cm.repeat_interleave(rep, 2)
            y_ref, s_ref = ssd_reference(x, dt, A, Br, Cr, chunk, init_state=s0)
            # fp32 math on the same inputs: reduction order only
            err = max(max_err(y, y_ref), max_err(s, s_ref))
            out = ssd_scan(x, dt, A, Br, Cr, chunk)
            plain = ssd_reference(x, dt, A, Br, Cr, chunk)[0]
            scan_err = max_err(out, plain)
            # tests/test_kernels_ssd.py's atol = rtol: fp32 1e-4, bf16 5e-2
            # (ssd_scan rounds y to bf16)
            tol = 1e-4 if dtype == torch.float32 else 5e-2
            scan_ok = bool(((out.float() - plain).abs() <= tol * (1 + plain.abs())).all())
            assert err <= 1e-4 and scan_ok and out.dtype == dtype and torch.isfinite(y).all(), \
                f"ssd edge case L={L} H={H} P={P} N={N} {dtype}: err {err} / {scan_err}"
            plan = plan_for(x, Bm)
            log(f"  ssd edge L={L} H={H}/{G} P={P} N={N} chunk={chunk} init={init} "
                f"nvalid={nvalid} {str(dtype)[6:]} path={plan.path} pb={plan.pb} "
                f"grid={plan.grid}: max_abs_err y/state={err:.3g} (tol 1e-4), "
                f"ssd_scan out={scan_err:.3g} (atol = rtol {tol})")
    # full-width shapes: mamba2's prefill of one 297-token prompt and of a
    # 4096-token one, the engine's prefill pack (2 rows of 128 tokens, one
    # ragged, from carried states; one half-padded SSD chunk of 256),
    # jamba's 128 heads with N 16
    for name, sh in (
            ("mamba2 prefill", dict(B=1, L=297, H=64, P=64, N=128, G=1)),
            ("mamba2 prefill 4096", dict(B=1, L=4096, H=64, P=64, N=128, G=1)),
            ("mamba2 pack", dict(B=2, L=128, H=64, P=64, N=128, G=1, init=True,
                                 nvalid=[128, 100])),
            ("jamba pack", dict(B=2, L=128, H=128, P=64, N=16, G=1, init=True,
                                nvalid=[128, 100]))):
        for dtype in (torch.float32, torch.bfloat16):
            x, dt, A, Bm, Cm, s0 = ssd_case(dev, dtype=dtype, seed=3, **sh)
            H = x.shape[2]
            plan = plan_for(x, Bm)
            y, s = ssd_chunked(x, dt, A, Bm, Cm, 256, init_state=s0)
            Br, Cr = Bm.expand(-1, -1, H, -1), Cm.expand(-1, -1, H, -1)
            y_ref, s_ref = ssd_reference(x, dt, A, Br, Cr, 256, init_state=s0)
            err = max(max_err(y, y_ref), max_err(s, s_ref))
            # fp32 on both sides over 64-token tiles vs 256-token chunks:
            # reduction order only, on outputs of size up to ~40
            assert err <= 2e-3 and torch.isfinite(y).all(), f"ssd {name} {dtype}: err {err}"
            y2, s2 = ssd_chunked(x, dt, A, Bm, Cm, 256, init_state=s0)
            assert torch.equal(y, y2) and torch.equal(s, s2), f"ssd {name} {dtype}: repeat differs"
            del y, s, y_ref, s_ref, y2, s2
            ms = cuda_ms(lambda: ssd_scan_cuda(x, dt, A, Bm, Cm, init_state=s0), flush=flush)
            op_ms = cuda_ms(lambda: ssd_chunked(x, dt, A, Bm, Cm, 256, init_state=s0),
                            flush=flush, queued=False)
            plain_ms = cuda_ms(lambda: ssd_reference(x, dt, A, Br, Cr, 256, init_state=s0),
                               flush=flush)
            bms, by = ssd_bound(x, Bm, s0 is not None, dtype)
            row = dict(kernel="ssd_scan", case=name, dtype=str(dtype)[6:], path=plan.path,
                       pb=plan.pb, grid=plan.grid,
                       shape=f"x{tuple(x.shape)} B/C{tuple(Bm.shape)} d_state "
                             f"{Bm.shape[-1]} init_state={s0 is not None} "
                             f"nvalid={sh.get('nvalid')}",
                       max_abs_err=err, ms=ms, op_ms=op_ms, plain_ms=plain_ms,
                       library_ms=None, bound_ms=bms, bound_by=by)
            results.append(row)
            log(f"  ssd {name} {row['dtype']} {row['shape']} path={plan.path} pb={plan.pb} "
                f"grid={plan.grid}: kernel_ms={ms:.4f} op_ms={op_ms:.4f} plain_ms={plain_ms:.4f} "
                f"library_ms=none (no single PyTorch call) bound_ms={bms:.6f} ({by}) "
                f"max_abs_err={err:.3g}, repeat bit-equal")
            del x, Bm, Cm, Br, Cr
            torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 3/4
def mixtral(n_layers: int):
    from repro_torch.configs import LayerGroup, get_config
    cfg = get_config("mixtral-8x7b")
    if n_layers == cfg.n_layers:
        return cfg
    return cfg.scaled(name=f"mixtral-8x7b-{n_layers}L", n_layers=n_layers,
                      layer_groups=(LayerGroup("A", n_layers, moe_mask="1"),))


def fill_pool_from_ring(paged, dense, pt, ps):
    """Copy each row's ring buffer (slot == position: the ring is at least
    as long as the sequence) into its pages pt[b, :W // ps]."""
    for pg, dg in zip(paged["groups"], dense["groups"]):
        for pc, dc in zip(pg, dg):
            for pool, ring in (("kp", "k"), ("vp", "v")):
                src = dc["attn"][ring]                               # (R, B, W, Hkv, hd)
                R, B, W = src.shape[:3]
                for b in range(B):
                    pc["attn"][pool][:, pt[b, :W // ps].long()] = (
                        src[:, b].reshape(R, W // ps, ps, *src.shape[3:]))


def run_card_vs_cpu(dev, int8: bool = False):
    """Every model path at depth 2, full width, fp32, on the card and on the
    CPU, on the same tokens: returns the worst card-vs-CPU and cross-path
    logit differences. With ``int8`` the weights are quantize_params_int8
    of the same fp32 weights (projections, experts, router, embedding and
    head int8): on the card the projections and the head run the w8a16
    kernel and the experts the int8 grouped matmul."""
    from repro_torch.kernels.moe_gmm import gmm_tiles_cuda
    from repro_torch.kernels.quant_matmul import w8a16_matmul_cuda
    from repro_torch.models import RunCtx, build_model
    from repro_torch.models.params import map_tree
    from repro_torch.quant import quantize_params_int8
    model = build_model(mixtral(2))
    params = model.init_params(0, device=dev, dtype=torch.float32)
    if int8:
        params = quantize_params_int8(params)
    cpu_params = map_tree(lambda t: t.cpu(), params)
    n0 = (w8a16_matmul_cuda.launches, gmm_tiles_cuda.launches)
    rng = np.random.default_rng(0)
    ps, maxp, C, gen = 16, 2, 16, 4
    seq = rng.integers(1, 32000, (2, C + gen)).astype(np.int32)
    pt = np.stack([np.arange(1, 1 + maxp), np.arange(1 + maxp, 1 + 2 * maxp)]).astype(np.int32)
    # decode_chunk: a pack of 16 / 11 prompt tokens, then a decode sweep
    # feeding each row its next token (positions 16 and 11)
    calls = [(seq[:, :C], np.array([0, 0], np.int32), np.array([16, 11], np.int32)),
             (np.array([[seq[0, 16]], [seq[1, 11]]], np.int32), np.array([16, 11], np.int32),
              np.array([1, 1], np.int32))]
    logits = {}
    for key, where, p in (("card", dev, params), ("cpu", "cpu", cpu_params)):
        out = {}
        with torch.inference_mode():
            cache = model.init_cache(2, C + gen, kind="paged", page_size=ps,
                                     num_pages=2 * maxp + 1, device=where)
            t_pt = torch.from_numpy(pt).to(where)
            for i, (tok, st, nv) in enumerate(calls):
                t = [torch.from_numpy(a).to(where) for a in (tok, st, nv, np.arange(2), st == 0)]
                lg, cache = model.decode_chunk(p, t[0], cache, *t[1:], RunCtx(), t_pt)
                out[f"decode_chunk {i}"] = lg
            tokens = torch.from_numpy(seq).to(where)
            out["forward"], _ = model.forward(p, {"tokens": tokens}, RunCtx())
            dense = model.init_cache(2, maxp * ps, device=where)
            out["prefill"], dense = model.prefill(p, {"tokens": tokens[:, :C]}, dense, RunCtx())
            paged = model.init_cache(2, C + gen, kind="paged", page_size=ps,
                                     num_pages=2 * maxp + 1, device=where)
            fill_pool_from_ring(paged, dense, t_pt, ps)
            for i in range(gen):
                pos = torch.full((2,), C + i, dtype=torch.int32, device=where)
                tok = tokens[:, C + i:C + i + 1]
                out[f"decode_step dense {i}"], dense = model.decode_step(
                    p, tok, dense, pos, RunCtx())
                out[f"decode_step paged {i}"], paged = model.decode_step(
                    p, tok, paged, pos, RunCtx(), page_table=t_pt, lengths=pos + 1)
        logits[key] = {k: v.float().cpu() for k, v in out.items()}
        if key == "card":
            launched = (w8a16_matmul_cuda.launches - n0[0], gmm_tiles_cuda.launches - n0[1])
    assert launched[1] > 0 and (launched[0] > 0) == int8, f"launches on the card: {launched}"
    worst = 0.0
    for k, a in logits["card"].items():
        b = logits["cpu"][k]
        assert torch.isfinite(a).all() and a.shape[-1] == 32000, k
        err = max_err(a, b)
        worst = max(worst, err)
        assert err < LOGIT_ATOL, f"{k}: card vs CPU logits differ by {err}"
        assert torch.equal(a.argmax(-1), b.argmax(-1)), f"{k}: argmax differs"
    # on the card, every path against forward's logits at the same position
    card, fwd = logits["card"], logits["card"]["forward"]
    pairs = [(card["decode_chunk 0"][0], fwd[0, 15]), (card["decode_chunk 0"][1], fwd[1, 10]),
             (card["decode_chunk 1"][0], fwd[0, 16]), (card["decode_chunk 1"][1], fwd[1, 11]),
             (card["prefill"], fwd[:, C - 1])]
    for i in range(gen):
        pairs += [(card[f"decode_step {kind} {i}"], fwd[:, C + i]) for kind in ("dense", "paged")]
    cross = max(max_err(a, b) for a, b in pairs)
    assert cross < LOGIT_ATOL, f"paths disagree with forward on the card by {cross}"
    kind = "int8 weights (w8a16 launches {}, gmm {})".format(*launched) if int8 else "fp32"
    log(f"  depth-2 full-width {kind}, card vs CPU: decode_chunk (pack of 27 tokens, then a "
        f"decode sweep), forward (2 x 20 tokens), prefill (2 x 16) + 4 decode_steps over the "
        f"dense ring and over the paged pool: max |dlogit| = {worst:.3g} < {LOGIT_ATOL}, "
        f"argmax equal")
    log(f"  on the card, decode_chunk / prefill / decode_step vs forward at the same "
        f"positions: max |dlogit| = {cross:.3g} < {LOGIT_ATOL}")
    return worst, cross


def mamba2(n_layers: int):
    from repro_torch.configs import LayerGroup, get_config
    cfg = get_config("mamba2-1.3b")
    if n_layers == cfg.n_layers:
        return cfg
    return cfg.scaled(name=f"mamba2-1.3b-{n_layers}L", n_layers=n_layers,
                      layer_groups=(LayerGroup("M", n_layers),))


def run_mamba_card_vs_cpu(dev):
    """mamba2 at depth 2, full width, fp32, on the card and on the CPU, on
    the same two sequences of 154 tokens: ``forward``; ``prefill`` of the
    first 150 then 4 ``decode_step``s over the dense cache; the engine's
    ``decode_chunk``, a pack of 150 / 97 tokens on slots 2 / 0 whose states
    hold garbage (``first`` must reset them), then a decode sweep over the
    3 slots (slot 1 idle). Returns the worst card-vs-CPU and cross-path
    logit differences."""
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda
    from repro_torch.models import RunCtx, build_model
    from repro_torch.models.params import map_tree
    model = build_model(mamba2(2))
    params = model.init_params(0, device=dev, dtype=torch.float32)
    cpu_params = map_tree(lambda t: t.cpu(), params)
    V = model.cfg.vocab
    rng = np.random.default_rng(2)
    C, gen, n1 = 150, 4, 97
    seq = rng.integers(1, V, (2, C + gen)).astype(np.int32)
    pack = np.zeros((2, C), np.int32)
    pack[0], pack[1, :n1] = seq[0, :C], seq[1, :n1]
    calls = [(pack, [0, 0], [C, n1], [2, 0], [True, True]),
             (np.array([[seq[1, n1]], [0], [seq[0, C]]], np.int32), [n1, 0, C], [1, 0, 1],
              [0, 1, 2], [False, False, False])]
    logits, launched = {}, 0
    for key, where, p in (("card", dev, params), ("cpu", "cpu", cpu_params)):
        out = {}
        n0 = ssd_scan_cuda.launches
        with torch.inference_mode():
            cache = model.init_cache(3, C + gen, kind="paged", device=where)
            g = torch.Generator().manual_seed(5)
            for c in cache["groups"][0]:                  # garbage states: first resets them
                for leaf in c["ssm"].values():
                    leaf.copy_(torch.randn(leaf.shape, generator=g))
            pt = torch.zeros((3, 1), dtype=torch.int32, device=where)
            for i, (tok, st, nv, sl, fi) in enumerate(calls):
                t = [torch.tensor(np.asarray(a), device=where) for a in (tok, st, nv, sl, fi)]
                lg, cache = model.decode_chunk(p, t[0], cache, *t[1:], RunCtx(), pt[:len(tok)])
                out[f"decode_chunk {i}"] = lg
            tokens = torch.from_numpy(seq).to(where)
            out["forward"], _ = model.forward(p, {"tokens": tokens}, RunCtx())
            dense = model.init_cache(2, C + gen, device=where)
            out["prefill"], dense = model.prefill(p, {"tokens": tokens[:, :C]}, dense, RunCtx())
            for i in range(gen):
                pos = torch.full((2,), C + i, dtype=torch.int32, device=where)
                out[f"decode_step {i}"], dense = model.decode_step(
                    p, tokens[:, C + i:C + i + 1], dense, pos, RunCtx())
        if key == "card":
            launched = ssd_scan_cuda.launches - n0
        logits[key] = {k: v.float().cpu() for k, v in out.items()}
    assert launched > 0, "the SSD kernel never ran on the card"
    worst = 0.0
    for k, a in logits["card"].items():
        b = logits["cpu"][k]
        assert torch.isfinite(a).all() and a.shape[-1] == V, k
        err = max_err(a, b)
        worst = max(worst, err)
        assert err < LOGIT_ATOL, f"mamba2 {k}: card vs CPU logits differ by {err}"
        assert torch.equal(a.argmax(-1), b.argmax(-1)), f"mamba2 {k}: argmax differs"
    card, fwd = logits["card"], logits["card"]["forward"]
    pairs = [(card["decode_chunk 0"][0], fwd[0, C - 1]),
             (card["decode_chunk 0"][1], fwd[1, n1 - 1]),
             (card["decode_chunk 1"][0], fwd[1, n1]), (card["decode_chunk 1"][2], fwd[0, C]),
             (card["prefill"], fwd[:, C - 1])]
    pairs += [(card[f"decode_step {i}"], fwd[:, C + i]) for i in range(gen)]
    cross = max(max_err(a, b) for a, b in pairs)
    assert cross < LOGIT_ATOL, f"mamba2 paths disagree with forward on the card by {cross}"
    cfg = model.cfg
    log(f"  mamba2 depth-2 fp32 (d_model {cfg.d_model}, {cfg.ssm_heads} SSD heads of "
        f"{cfg.ssm.head_dim}, d_state {cfg.ssm.d_state}, vocab {V}), card vs CPU: forward (2 x {C + gen} tokens), prefill (2 x {C}) + {gen} "
        f"decode_steps, decode_chunk (a pack of {C} / {n1} tokens over garbage states reset by "
        f"first, then a decode sweep): max |dlogit| = {worst:.3g} < {LOGIT_ATOL}, argmax "
        f"equal; SSD kernel launches on the card: {launched}")
    log(f"  on the card, decode_chunk / prefill / decode_step vs forward at the same "
        f"positions: max |dlogit| = {cross:.3g} < {LOGIT_ATOL}")
    return worst, cross


def prompts(rng, n=4):
    lens = [113, 178, 241, 297][:n]
    return [rng.integers(1, 32000, L).astype(np.int32) for L in lens]


def depth_note(cfg) -> str:
    return ("full depth, 32 layers" if cfg.n_layers == 32
            else f"depth cut 32 -> {cfg.n_layers} layers")


def build_mixtral(dev, n_layers: int, int8: bool):
    """Full-width mixtral-8x7b at ``n_layers``, random weights from seed 0:
    bf16, or (``int8``) ``init_params_int8`` of the same bf16 init, which
    holds one repeat of a leaf in float at a time. Peak memory counts from
    here."""
    from repro_torch.models import build_model
    from repro_torch.models.params import init_params_int8, map_tree
    cfg = mixtral(n_layers)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if int8:
        params = init_params_int8(cfg, 0, device=dev, dtype=torch.bfloat16)
    else:
        params = model.init_params(0, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    sizes = []
    map_tree(lambda t: sizes.append(t.numel() * t.element_size()), params)
    info = dict(config=cfg.name, layers=cfg.n_layers, weights="int8" if int8 else "bf16",
                weights_gb=sum(sizes) / 1e9, init_s=init_s,
                init_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"  {cfg.name}: full width (d_model 4096, 32 heads / 8 kv, 8 experts top-2, "
        f"d_expert 14336), {depth_note(cfg)}, random "
        f"{'int8 (init_params_int8 of bf16)' if int8 else 'bf16'} weights from seed 0: "
        f"{info['weights_gb']:.2f} GB, init {init_s:.1f} s, peak device memory "
        f"{info['init_peak_gb']:.2f} GB")
    return model, params, info


def run_serving(dev, profile: bool, model, params, *, int8: bool = False,
                profile_tokens: int = 8):
    """InferenceEngine.generate on 4 requests x 32 greedy tokens; every
    request finishes, the allocator invariants hold, and the path's kernels
    (w8a16 too on int8 weights) launched."""
    from repro_torch.core import EngineConfig, InferenceEngine, Request, request_metrics
    from repro_torch.kernels.moe_gmm import gmm_tiles_cuda
    from repro_torch.kernels.paged_attention import chunked_prefill_cuda
    from repro_torch.kernels.quant_matmul import w8a16_matmul_cuda
    cfg = model.cfg
    ecfg = EngineConfig(max_slots=4, page_size=16, num_pages=160, max_seq=512,
                        prefill_chunk=128, greedy=True, cache_dtype=torch.bfloat16,
                        device=str(dev))
    eng = InferenceEngine(model, params, ecfg)
    rng = np.random.default_rng(1)
    # warm-up request: cuBLAS handles and allocator pools, not measured
    eng.generate([Request(req_id="warm", prompt_tokens=prompts(rng, 1)[0][:40],
                          max_new_tokens=2)])
    reqs = [Request(req_id=f"r{i}", prompt_tokens=p, max_new_tokens=32)
            for i, p in enumerate(prompts(rng))]
    eng.step_records.clear()
    # the engine's logits rows stay on the device, by reference, for the
    # streams' comparison with the generation API (no copy, no sync)
    records, chunk_call = [], model.decode_chunk

    def recorded(*args):
        out = chunk_call(*args)
        records.append((args[3], args[4], out[0]))          # starts, nvalid, logits
        return out

    model.decode_chunk = recorded
    for fn in (chunked_prefill_cuda, gmm_tiles_cuda, w8a16_matmul_cuda):
        fn.launches = 0
        fn.launches_by_path = dict.fromkeys(fn.launches_by_path, 0)
    t0 = time.perf_counter()
    eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del model.decode_chunk
    launches = {"chunked_prefill_attention": chunked_prefill_cuda.launches,
                "moe_gmm": gmm_tiles_cuda.launches, "w8a16_matmul": w8a16_matmul_cuda.launches}
    assert all(r.finished and len(r.generated) == 32 for r in reqs), "a request did not finish"
    eng.allocator.check_invariants()
    assert launches["chunked_prefill_attention"] > 0 and launches["moe_gmm"] > 0 \
        and (launches["w8a16_matmul"] > 0) == int8, \
        f"a kernel never ran on the serving path: {launches}"
    # bf16 activations: decode sweeps (<= 4 rows x top-2) stream, prefill
    # packs take the tensor cores
    gmm_paths = gmm_tiles_cuda.launches_by_path
    assert gmm_paths["stream"] > 0 and gmm_paths["mma"] > 0 and gmm_paths["tiled"] == 0, \
        f"the serving run's gmm calls left their planned paths: {gmm_paths}"
    # bf16 q and pool: decode sweeps (4 folded rows a KV head) split, prefill
    # packs take the tensor cores
    attn_paths = chunked_prefill_cuda.launches_by_path
    assert attn_paths["split"] > 0 and attn_paths["mma"] > 0 and attn_paths["tiled"] == 0, \
        f"the serving run's attention calls left their planned paths: {attn_paths}"
    ms = [request_metrics(r) for r in reqs]
    n_tok = sum(m.n_tokens for m in ms)
    recs = list(eng.step_records)
    dec = [r.duration for r in recs if r.prefill_rows == 0 and r.decode_rows > 0]
    pre = [r.duration for r in recs if r.prefill_rows > 0]
    serve = dict(
        config=cfg.name, layers=cfg.n_layers, requests=len(reqs),
        prompt_tokens=[len(r.prompt_tokens) for r in reqs], new_tokens=32,
        wall_s=wall, tok_s=n_tok / wall, steps=len(recs),
        ttft_ms=[m.ttft * 1e3 for m in ms], tbt_ms=[m.tbt * 1e3 for m in ms],
        decode_step_ms_mean=1e3 * float(np.mean(dec)) if dec else None,
        prefill_step_ms_mean=1e3 * float(np.mean(pre)) if pre else None,
        decode_steps=len(dec), prefill_steps=len(pre), launches=launches,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"  served {len(reqs)} requests x 32 new tokens (prompts {serve['prompt_tokens']}) "
        f"in {wall:.3f} s over {len(recs)} steps: {serve['tok_s']:.2f} tok/s, "
        f"TTFT ms {[round(x, 2) for x in serve['ttft_ms']]}, "
        f"TBT ms {[round(x, 3) for x in serve['tbt_ms']]}, decode step "
        f"{serve['decode_step_ms_mean']:.3f} ms, prefill step "
        f"{serve['prefill_step_ms_mean']:.3f} ms, peak device memory "
        f"{serve['peak_mem_gb']:.2f} GB ({depth_note(cfg)})")
    log(f"  launches on the serving run: {launches}, gmm by path "
        f"{gmm_tiles_cuda.launches_by_path}, chunked attention by path {attn_paths}"
        + (f", w8a16 by path {w8a16_matmul_cuda.launches_by_path}" if int8 else ""))
    serve["gmm_launches_by_path"] = dict(gmm_tiles_cuda.launches_by_path)
    serve["attention_launches_by_path"] = dict(attn_paths)
    if int8:
        serve["w8a16_launches_by_path"] = dict(w8a16_matmul_cuda.launches_by_path)
    # logits row of request b's token t: the call whose row ends at its
    # prompt length + t (the prompts' ranges do not overlap)
    lens = [len(r.prompt_tokens) for r in reqs]
    eng_logits = {}
    for st, nv, lg in records:
        for i, (s0, n) in enumerate(zip(st.tolist(), nv.tolist())):
            for b, L in enumerate(lens):
                if n > 0 and L <= s0 + n < L + 32:
                    eng_logits[(b, s0 + n - L)] = lg[i]
    del records
    if profile:
        preqs = [Request(req_id=f"p{i}", prompt_tokens=p, max_new_tokens=profile_tokens)
                 for i, p in enumerate(prompts(rng))]
        serve["profile"] = profile_window(lambda: eng.generate(preqs),
                                          f"4 requests x {profile_tokens} tokens")
    streams = [(r.prompt_tokens, list(r.generated)) for r in reqs]
    return serve, launches, streams, eng_logits


def run_generation(dev, model, params, streams, profile: bool, eng_logits=None):
    """Phases 5 and 7: LM.prefill of the serving run's prompts (right-padded,
    flash attention), then GEN_STEPS greedy decode_steps over the paged pool
    (paged decode kernel), on the serving run's weights. With the engine's
    logits rows, where a greedy stream leaves the engine's, the first
    diverging token's top-2 logits on both paths."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.moe_gmm import gmm_tiles_cuda
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.kernels.quant_matmul import w8a16_matmul_cuda
    from repro_torch.models import RunCtx
    counted = (flash_attention_cuda, paged_attention_cuda, gmm_tiles_cuda, w8a16_matmul_cuda)
    ps = 16
    lens = [len(p) for p, _ in streams]
    B, S = len(lens), max(lens)
    maxp = -(-(S + GEN_STEPS) // ps)
    toks = np.zeros((B, S), np.int32)
    for b, (p, _) in enumerate(streams):
        toks[b, :len(p)] = p
    tokens = torch.from_numpy(toks).to(dev)
    last = torch.tensor(lens, dtype=torch.int64, device=dev) - 1
    pt = (torch.arange(B * maxp, dtype=torch.int32, device=dev).reshape(B, maxp) + 1)
    ctx = RunCtx()

    def generate(n_steps):
        """Prefill into a ring, copy it into the pool, decode n_steps."""
        dense = model.init_cache(B, maxp * ps, torch.bfloat16, device=dev)
        paged = model.init_cache(B, maxp * ps, torch.bfloat16, kind="paged", page_size=ps,
                                 num_pages=B * maxp + 1, device=dev)
        out, times, logits = [], [], []
        t0 = time.perf_counter()
        lg, dense = model.prefill(params, {"tokens": tokens}, dense, ctx, last_pos=last)
        logits.append(lg)
        nxt = lg.argmax(-1)
        fill_pool_from_ring(paged, dense, pt, ps)
        del dense
        out.append(nxt.cpu())
        times.append(time.perf_counter() - t0)
        pos = last.to(torch.int32) + 1
        for _ in range(n_steps):
            t0 = time.perf_counter()
            lg, paged = model.decode_step(params, nxt[:, None].to(torch.int32), paged, pos, ctx,
                                          page_table=pt, lengths=pos + 1)
            logits.append(lg)
            nxt = lg.argmax(-1)
            out.append(nxt.cpu())             # reads the token back, as a server must
            times.append(time.perf_counter() - t0)
            pos = pos + 1
        return torch.stack(out, 1), times, logits

    with torch.inference_mode():
        generate(2)                           # warm-up: allocator pools, cuBLAS handles
        torch.cuda.synchronize()
        for fn in counted:
            fn.launches = 0
        for fn in (gmm_tiles_cuda, flash_attention_cuda):
            fn.launches_by_path = dict.fromkeys(fn.launches_by_path, 0)
        gen, times, gen_logits = generate(GEN_STEPS)
        torch.cuda.synchronize()
        launches = {"flash_attention": flash_attention_cuda.launches,
                    "paged_attention": paged_attention_cuda.launches,
                    "moe_gmm": gmm_tiles_cuda.launches,
                    "w8a16_matmul": w8a16_matmul_cuda.launches}
    assert launches["flash_attention"] > 0 and launches["paged_attention"] > 0, \
        f"a kernel never ran on the generation path: {launches}"
    flash_paths = dict(flash_attention_cuda.launches_by_path)
    assert flash_paths["mma"] == launches["flash_attention"], \
        f"flash attention left its planned path (bf16: mma): {flash_paths}"
    assert gen.shape == (B, GEN_STEPS + 1) and ((gen >= 0) & (gen < 32000)).all()
    prefill_ms, step_ms = 1e3 * times[0], 1e3 * float(np.mean(times[1:]))
    total = sum(times)
    agree = []
    for b, (_, eng) in enumerate(streams):
        n = 0
        while n < len(eng) and int(gen[b, n]) == eng[n]:
            n += 1
        agree.append(n)
    res = dict(layers=model.cfg.n_layers, prompt_tokens=lens, padded_to=S, new_tokens=GEN_STEPS,
               prefill_ms=prefill_ms, decode_step_ms_mean=step_ms,
               decode_tok_s=B / (step_ms / 1e3), tok_s=B * (GEN_STEPS + 1) / total,
               launches=launches, leading_tokens_equal_engine=agree,
               gmm_launches_by_path=dict(gmm_tiles_cuda.launches_by_path),
               flash_launches_by_path=flash_paths)
    log(f"  prefill of {B} prompts {lens} right-padded to {S} tokens: {prefill_ms:.3f} ms "
        f"(ring copied into the pool included); {GEN_STEPS} decode_steps over the paged "
        f"pool: {step_ms:.3f} ms per step, {res['decode_tok_s']:.2f} tok/s in decode, "
        f"{res['tok_s']:.2f} tok/s over the whole generation ({depth_note(model.cfg)})")
    log(f"  launches on the generation run: {launches}, gmm by path "
        f"{res['gmm_launches_by_path']}, flash attention by path {flash_paths} (paged decode: "
        f"the split path only)")
    log(f"  leading greedy tokens equal to the engine's stream on the same weights, per "
        f"request: {agree} of its 32 (printed only: bf16 near-ties may split two different "
        f"kernels)")
    if eng_logits is not None:
        res["divergence"] = divergence_report(streams, gen_logits, eng_logits, agree)
    del gen_logits
    if profile:
        with torch.inference_mode():
            res["profile"] = profile_window(lambda: generate(8),
                                            "prefill + 8 decode_steps of the generation path")
    return res, launches


def divergence_report(streams, gen_logits, eng_logits, agree):
    """For each request whose generation stream leaves the engine's: the
    first diverging token, and on each path the top-2 tokens, their logits,
    the margin between them and one bf16 step at the top logit (the logits
    are bf16), and the largest gap between the two paths' logit rows at that
    position. The contexts are equal up to that token, so the rows compare
    like with like, and that gap is how far the two paths' bf16 rounding
    (their kernels' orders of summation over every layer) moves a logit
    there. A margin above it on either path is no rounding tie: a fault of
    one path."""
    import math
    report = []
    for b, (_, eng) in enumerate(streams):
        t = agree[b]
        if t >= len(eng):
            continue
        rows = {"generation": gen_logits[t][b].float(), "engine": eng_logits[(b, t)].float()}
        entry = dict(request=b, token=t, max_abs_logit_gap=float(
            (rows["generation"] - rows["engine"]).abs().max()))
        for name, lg in rows.items():
            v, i = torch.topk(lg, 2)
            top = float(v[0])
            step = 2.0 ** (math.floor(math.log2(abs(top))) - 7) if top else 0.0
            entry[name] = dict(top2=[int(i[0]), int(i[1])],
                               top2_logits=[float(v[0]), float(v[1])],
                               margin=float(v[0] - v[1]), bf16_step=step)
        entry["within_rounding"] = all(entry[p]["margin"] <= entry["max_abs_logit_gap"]
                                       for p in rows)
        report.append(entry)
        g, e = entry["generation"], entry["engine"]
        log(f"  request {b} leaves the engine's stream at token {t}: generation top-2 "
            f"{g['top2']} logits {g['top2_logits']} margin {g['margin']:.6g}; engine top-2 "
            f"{e['top2']} logits {e['top2_logits']} margin {e['margin']:.6g}; one bf16 step "
            f"{g['bf16_step']:.6g} / {e['bf16_step']:.6g}; largest gap between the two rows "
            f"{entry['max_abs_logit_gap']:.6g}; "
            + ("both margins within the gap: a tie within the paths' bf16 rounding"
               if entry["within_rounding"] else "a margin above the gap: not a rounding tie"))
    if not report:
        log("  every generation stream equals the engine's over its 32 tokens")
    return report


def copy_cache_row(dst, src, b):
    """dst's batch row b <- src's row 0, leaf by leaf (leaves are (R, B, ...))."""
    if isinstance(dst, dict):
        for k in dst:
            copy_cache_row(dst[k], src[k], b)
    elif isinstance(dst, list):
        for d, s in zip(dst, src):
            copy_cache_row(d, s, b)
    else:
        dst[:, b] = src[:, 0]


def run_mamba(dev, profile: bool):
    """Phase 6: full-depth mamba2 in bf16 through the engine, then the
    generation API on the same weights."""
    from repro_torch.core import EngineConfig, InferenceEngine, Request, request_metrics
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda
    from repro_torch.models import RunCtx, build_model
    from repro_torch.models.params import map_tree
    cfg = mamba2(48)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(0, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    sizes = []
    map_tree(lambda t: sizes.append(t.numel() * t.element_size()), params)
    log(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, d_inner {cfg.d_inner}, "
        f"{cfg.ssm_heads} SSD heads of {cfg.ssm.head_dim}, d_state {cfg.ssm.d_state}, chunk "
        f"{cfg.ssm.chunk_size}, vocab {cfg.vocab}; random bf16 weights from seed 0: "
        f"{sum(sizes) / 1e9:.2f} GB, init {time.perf_counter() - t0:.1f} s")
    ecfg = EngineConfig(max_slots=4, page_size=16, num_pages=160, max_seq=512,
                        prefill_chunk=128, greedy=True, cache_dtype=torch.bfloat16,
                        device=str(dev))
    eng = InferenceEngine(model, params, ecfg)
    assert eng.prefix_cache is None
    rng = np.random.default_rng(1)
    # warm-up request: cuBLAS handles and allocator pools, not measured
    eng.generate([Request(req_id="warm", prompt_tokens=prompts(rng, 1)[0][:40],
                          max_new_tokens=2)])
    ps = prompts(rng)
    reqs = [Request(req_id=f"m{i}", prompt_tokens=p, max_new_tokens=32)
            for i, p in enumerate(ps)]
    eng.step_records.clear()
    torch.cuda.reset_peak_memory_stats()
    ssd_scan_cuda.launches = 0
    ssd_scan_cuda.launches_by_path = dict.fromkeys(ssd_scan_cuda.launches_by_path, 0)
    t0 = time.perf_counter()
    eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ssd_scan_cuda.launches
    by_path = dict(ssd_scan_cuda.launches_by_path)
    assert all(r.finished and len(r.generated) == 32 for r in reqs), "a request did not finish"
    eng.allocator.check_invariants()
    assert launches > 0, "the SSD kernel never ran on the mamba2 serving path"
    assert by_path == dict.fromkeys(by_path, 0) | {"mma": launches}, \
        f"bf16 SSD launches off the mma path: {by_path}"
    ms = [request_metrics(r) for r in reqs]
    n_tok = sum(m.n_tokens for m in ms)
    recs = list(eng.step_records)
    dec = [r.duration for r in recs if r.prefill_rows == 0 and r.decode_rows > 0]
    pre = [r.duration for r in recs if r.prefill_rows > 0]
    serve = dict(
        config=cfg.name, layers=cfg.n_layers, requests=len(reqs),
        prompt_tokens=[len(r.prompt_tokens) for r in reqs], new_tokens=32,
        wall_s=wall, tok_s=n_tok / wall, steps=len(recs),
        ttft_ms=[m.ttft * 1e3 for m in ms], tbt_ms=[m.tbt * 1e3 for m in ms],
        decode_step_ms_mean=1e3 * float(np.mean(dec)) if dec else None,
        prefill_step_ms_mean=1e3 * float(np.mean(pre)) if pre else None,
        decode_steps=len(dec), prefill_steps=len(pre), launches={"ssd_scan": launches},
        launches_by_path={"ssd_scan": by_path}, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"  served {len(reqs)} requests x 32 new tokens (prompts {serve['prompt_tokens']}) "
        f"in {wall:.3f} s over {len(recs)} steps: {serve['tok_s']:.2f} tok/s, "
        f"TTFT ms {[round(x, 2) for x in serve['ttft_ms']]}, "
        f"TBT ms {[round(x, 3) for x in serve['tbt_ms']]}, decode step "
        f"{serve['decode_step_ms_mean']:.3f} ms, prefill-pack step "
        f"{serve['prefill_step_ms_mean']:.3f} ms, peak device memory "
        f"{serve['peak_mem_gb']:.2f} GB; ssd_scan launches {launches} by path {by_path}")
    if profile:
        preqs = [Request(req_id=f"q{i}", prompt_tokens=p, max_new_tokens=8)
                 for i, p in enumerate(ps)]
        serve["profile"] = profile_window(lambda: eng.generate(preqs),
                                          "mamba2 engine, 4 requests x 8 tokens")
    streams = [list(r.generated) for r in reqs]
    del eng
    torch.cuda.empty_cache()

    # the generation API: each prompt prefilled at its own length (right
    # padding would advance the SSM states), its cache row copied into one
    # batch of 4, then GEN_STEPS batched decode_steps
    lens = [len(p) for p in ps]
    B, ctx = len(ps), RunCtx()

    def generate(n_steps):
        max_seq = max(lens) + n_steps + 1
        cache = model.init_cache(B, max_seq, torch.bfloat16, device=dev)
        out, times, firsts = [], [], []
        t0 = time.perf_counter()
        for b, p in enumerate(ps):
            one = model.init_cache(1, max_seq, torch.bfloat16, device=dev)
            lg, one = model.prefill(params, {"tokens": torch.from_numpy(p)[None].to(dev)}, one,
                                    ctx)
            copy_cache_row(cache, one, b)
            firsts.append(lg.argmax(-1))
        nxt = torch.cat(firsts)
        out.append(nxt.cpu())
        times.append(time.perf_counter() - t0)
        pos = torch.tensor(lens, dtype=torch.int32, device=dev)
        for _ in range(n_steps):
            t0 = time.perf_counter()
            lg, cache = model.decode_step(params, nxt[:, None].to(torch.int32), cache, pos, ctx)
            nxt = lg.argmax(-1)
            out.append(nxt.cpu())             # reads the token back, as a server must
            times.append(time.perf_counter() - t0)
            pos = pos + 1
        return torch.stack(out, 1), times

    with torch.inference_mode():
        generate(2)                           # warm-up
        torch.cuda.synchronize()
        n0, p0 = ssd_scan_cuda.launches, dict(ssd_scan_cuda.launches_by_path)
        gen, times = generate(GEN_STEPS)
        torch.cuda.synchronize()
        gen_launches = ssd_scan_cuda.launches - n0
        gen_by_path = {k: v - p0[k] for k, v in ssd_scan_cuda.launches_by_path.items()}
    assert gen_launches > 0, "the SSD kernel never ran on the mamba2 generation path"
    assert gen_by_path == dict.fromkeys(gen_by_path, 0) | {"mma": gen_launches}, \
        f"bf16 SSD launches off the mma path: {gen_by_path}"
    assert gen.shape == (B, GEN_STEPS + 1) and ((gen >= 0) & (gen < cfg.vocab)).all()
    agree = []
    for b, eng_stream in enumerate(streams):
        n = 0
        while n < len(eng_stream) and int(gen[b, n]) == eng_stream[n]:
            n += 1
        agree.append(n)
    prefill_ms, step_ms = 1e3 * times[0], 1e3 * float(np.mean(times[1:]))
    generation = dict(prompt_tokens=lens, new_tokens=GEN_STEPS, prefill_ms=prefill_ms,
                      decode_step_ms_mean=step_ms, decode_tok_s=B / (step_ms / 1e3),
                      tok_s=B * (GEN_STEPS + 1) / sum(times),
                      launches={"ssd_scan": gen_launches},
                      launches_by_path={"ssd_scan": gen_by_path},
                      leading_tokens_equal_engine=agree)
    log(f"  generation API: prefill of the {B} prompts {lens} one by one at their own "
        f"lengths: {prefill_ms:.3f} ms in all; {GEN_STEPS} batched decode_steps: "
        f"{step_ms:.3f} ms per step, {generation['decode_tok_s']:.2f} tok/s in decode; "
        f"ssd_scan launches {gen_launches} by path {gen_by_path}")
    log(f"  leading greedy tokens equal to the engine's stream, per request: {agree} of its 32 "
        f"(printed only: bf16 near-ties may split the chunked and the whole-prompt scan)")
    if profile:
        with torch.inference_mode():
            generation["profile"] = profile_window(
                lambda: generate(8), "mamba2 prefill of 4 prompts + 8 decode_steps")
    return serve, generation


# ------------------------------------------------------------------ phase 8

def pct(values, q: float) -> float:
    return float(np.percentile(values, q))


def stack_plans(dev, cfg, slots: int, chunk_rows: int, chunk: int, ps: int, maxp: int):
    """The paths the two kernels' plans name for an engine's two call
    shapes: the decode sweep (slots, 1) and the prefill pack (chunk_rows,
    chunk); gmm sees top_k rows a token."""
    from repro_torch.kernels.moe_gmm import kernel as gk
    from repro_torch.kernels.paged_attention import kernel as ak
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    bf = torch.bfloat16
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    attn = {ak._plan(B, C, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, ps, maxp, bf, bf,
                     n_sm).path for B, C in ((slots, 1), (chunk_rows, chunk))}
    gmm = {gk._plan(T * k, K, N, E, bf, bf, n_sm).path
           for T in (slots, chunk_rows * chunk)
           for K, N in ((cfg.d_model, cfg.moe.d_expert), (cfg.moe.d_expert, cfg.d_model))}
    return attn, gmm


def run_stack(dev, model, params, profile: bool):
    """Phase 8: the serving stack (client -> gateway -> router -> replica
    threads -> engines) on phase 4's weights. 64 requests of the
    OpenOrca-like mix at concurrency 64, 32 greedy tokens each, on one
    replica of 64 slots and on two of 32 sharing the weights; then a manual
    failover under 16 requests. Nothing here is caught: an exception in a
    replica thread is re-raised once its run ends."""
    import asyncio
    from repro_torch.core import (EngineConfig, Gateway, InferenceEngine, Replica,
                                  ReplicaRouter, RouterConfig, request_metrics,
                                  scale_gateway_config)
    from repro_torch.core.client import merge_engine_timestamps, run_workload
    from repro_torch.data.workload import WorkloadSpec, sample_workload
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.moe_gmm import gmm_tiles_cuda
    from repro_torch.kernels.paged_attention import chunked_prefill_cuda, paged_attention_cuda
    from repro_torch.kernels.quant_matmul import w8a16_matmul_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda
    counted = {"chunked_prefill_attention": chunked_prefill_cuda, "moe_gmm": gmm_tiles_cuda,
               "flash_attention": flash_attention_cuda, "paged_attention": paged_attention_cuda,
               "ssd_scan": ssd_scan_cuda, "w8a16_matmul": w8a16_matmul_cuda}
    cfg = model.cfg
    spec = WorkloadSpec(n_requests=STACK_REQUESTS, vocab=cfg.vocab, seed=0)
    prompts, _ = sample_workload(spec)
    warm_prompt = np.arange(1, 41, dtype=np.int32)

    def fleet(n_replicas: int, slots: int):
        """Started replicas over one set of weights; each thread's target is
        wrapped so that its exception is kept for the main thread."""
        errors, reps = [], []
        for i in range(n_replicas):
            eng = InferenceEngine(model, params, EngineConfig(
                max_slots=slots, page_size=16, num_pages=STACK_PAGES, max_seq=STACK_MAX_SEQ,
                prefill_chunk=STACK_PACK[1], greedy=True, cache_dtype=torch.bfloat16,
                device=str(dev)))
            rep = Replica(f"r{i}", eng)

            def guarded(loop=rep._loop, rid=rep.replica_id):
                try:
                    loop()
                except BaseException as e:
                    errors.append((rid, e))
                    raise

            rep._loop = guarded
            reps.append(rep.start())
        return reps, errors

    def serve(n_replicas: int, slots: int, batch, *, fail_after=None, profile_what=None):
        """One gateway over a fresh fleet: a warm-up request for each replica
        (a thread's first matmul creates its cuBLAS handle), then ``batch``
        at full concurrency with the kernels' counters set to 0 just before
        and read just after."""
        reps, errors = fleet(n_replicas, slots)
        router = ReplicaRouter(reps, RouterConfig(policy="least_loaded"))
        gw = Gateway(router, scale_gateway_config())
        router.start_monitor()
        out = dict(replicas=n_replicas, max_slots=slots)
        try:
            async def drive():
                await run_workload(gw, [warm_prompt] * n_replicas, concurrency=n_replicas,
                                   max_new_tokens=2, timeout_s=120)
                gw.requests.clear()
                for r in reps:
                    r.engine.step_records.clear()
                    r.total_completed = 0
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()

                async def killer():
                    while sum(r.n_generated for r in gw.requests.values()) < fail_after:
                        await asyncio.sleep(0.0005)
                    with reps[0]._lock:
                        out["failed_inflight"] = sorted(reps[0]._inflight)
                    t = time.perf_counter()
                    router.handle_failure(reps[0], reason="manual")
                    out["handle_failure_ms"] = 1e3 * (time.perf_counter() - t)

                for fn in counted.values():
                    fn.launches = 0
                    if hasattr(fn, "launches_by_path"):
                        fn.launches_by_path = dict.fromkeys(fn.launches_by_path, 0)
                run = run_workload(gw, batch, concurrency=len(batch),
                                   max_new_tokens=STACK_NEW, timeout_s=300)
                if fail_after is None:
                    return await run
                res, _ = await asyncio.gather(run, killer())
                return res

            def once():
                res = asyncio.run(drive())
                torch.cuda.synchronize()
                return res

            if profile_what is not None:
                holder = []
                out["profile"] = profile_window(lambda: holder.append(once()), profile_what)
                res = holder[0]
            else:
                res = once()
            out["launches"] = {k: fn.launches for k, fn in counted.items()}
            out["launches_by_path"] = {
                "chunked_prefill_attention": dict(chunked_prefill_cuda.launches_by_path),
                "moe_gmm": dict(gmm_tiles_cuda.launches_by_path)}
            out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        finally:
            router.stop_monitor()
            for r in reps:
                r.stop()
        if errors:
            rid, e = errors[0]
            raise RuntimeError(f"replica {rid}'s serving thread raised") from e
        merge_engine_timestamps(res.requests, gw)
        return res, router, reps, out

    def check(res, reps, n):
        assert len(res.requests) == n
        bad = [(r.req_id, r.error, r.n_generated) for r in res.requests
               if not (r.finished and r.error is None and r.n_generated == STACK_NEW)]
        assert not bad, f"requests that did not finish with {STACK_NEW} tokens: {bad}"
        for r in res.requests:
            assert r.t0 <= r.t1 <= r.t2 <= r.t4 <= r.t5 <= r.t6, f"{r.req_id}: t-stamps out of order"
            assert r.t2 <= r.t3 <= r.t6, f"{r.req_id}: t-stamps out of order"
        assert all(r.total_completed > 0 for r in reps if r.healthy), \
            f"a replica served nothing: {[(r.replica_id, r.total_completed) for r in reps]}"
        for r in reps:
            a = r.engine.allocator
            a.check_invariants()
            assert a.free_pages == a.num_pages - 1 and a.live_pages == 0, \
                f"{r.replica_id}: {a.free_pages} free pages of {a.num_pages - 1} after the run"

    layouts = []
    streams = {}
    for n_replicas, slots in STACK_LAYOUTS:
        wall0 = time.perf_counter()
        res, router, reps, out = serve(n_replicas, slots, prompts)
        check(res, reps, STACK_REQUESTS)
        assert router.failover_events == [] and router.auto_failovers == 0, \
            f"a replica failed over during the run: {router.failover_events}"
        eng0 = reps[0].engine
        # phase 2 held both kernels against their plain versions at these shapes
        assert (eng0.chunk_rows, eng0.chunk) == STACK_PACK, (eng0.chunk_rows, eng0.chunk)
        attn_plan, gmm_plan = stack_plans(dev, cfg, slots, eng0.chunk_rows, eng0.chunk, 16,
                                          eng0.cfg.max_pages_per_seq)
        used = {k: {p for p, n in v.items() if n > 0} for k, v in out["launches_by_path"].items()}
        assert out["launches"]["chunked_prefill_attention"] > 0 and out["launches"]["moe_gmm"] > 0, \
            f"a kernel never ran behind the stack: {out['launches']}"
        assert used["chunked_prefill_attention"] == attn_plan and used["moe_gmm"] == gmm_plan, \
            f"the stack's kernel calls left their planned paths: {out['launches_by_path']}, " \
            f"planned attention {sorted(attn_plan)}, gmm {sorted(gmm_plan)}"
        ms = [request_metrics(r) for r in res.requests]
        wall = res.t_end - res.t_start
        ttft = [m.ttft_user * 1e3 for m in ms]
        tbt = [m.tbt * 1e3 for m in ms]
        # the user-side TTFT t5 - t0 in four legs: client -> gateway (t1 -
        # t0), gateway admission + route + replica inbox + engine queue (t2 -
        # t1), engine to the first token (t4 - t2), first token back to the
        # client (t5 - t4)
        legs = {"client_to_gateway": [r.t1 - r.t0 for r in res.requests],
                "gateway_route_queue": [r.t2 - r.t1 for r in res.requests],
                "engine_first_token": [r.t4 - r.t2 for r in res.requests],
                "token_return": [r.t5 - r.t4 for r in res.requests]}
        total = sum(r.t5 - r.t0 for r in res.requests)
        out.update(
            wall_s=wall, tok_s=sum(m.n_tokens for m in ms) / wall,
            ttft_ms_p50=pct(ttft, 50), ttft_ms_p99=pct(ttft, 99),
            tbt_ms_p50=pct(tbt, 50), tbt_ms_p99=pct(tbt, 99),
            ttft_leg_ms_p50={k: 1e3 * pct(v, 50) for k, v in legs.items()},
            ttft_share={k: sum(v) / total for k, v in legs.items()},
            served={r.replica_id: r.total_completed for r in reps},
            preemptions=sum(r.engine.scheduler.n_preemptions for r in reps),
            planned_paths={"chunked_prefill_attention": sorted(attn_plan),
                           "moe_gmm": sorted(gmm_plan)},
            phase_s=time.perf_counter() - wall0)
        per = []
        for r in reps:
            recs = list(r.engine.step_records)
            dec = [x.duration for x in recs if x.prefill_rows == 0 and x.decode_rows > 0]
            pre = [x.duration for x in recs if x.prefill_rows > 0]
            per.append(dict(replica=r.replica_id, steps=len(recs),
                            decode_steps=len(dec), prefill_steps=len(pre),
                            decode_step_ms_mean=1e3 * float(np.mean(dec)) if dec else None,
                            prefill_step_ms_mean=1e3 * float(np.mean(pre)) if pre else None))
        out["per_replica"] = per
        layouts.append(out)
        streams[n_replicas] = {r.req_id: list(r.generated) for r in res.requests}
        log(f"  {n_replicas} x {slots} slots: {STACK_REQUESTS} requests x {STACK_NEW} tokens "
            f"at concurrency {STACK_REQUESTS} in {wall:.3f} s: {out['tok_s']:.2f} tok/s, TTFT "
            f"p50/p99 {out['ttft_ms_p50']:.1f} / {out['ttft_ms_p99']:.1f} ms, TBT p50/p99 "
            f"{out['tbt_ms_p50']:.2f} / {out['tbt_ms_p99']:.2f} ms, served {out['served']}, "
            f"preemptions {out['preemptions']}, peak device memory {out['peak_mem_gb']:.2f} GB")
        log("    TTFT legs p50 ms " + ", ".join(
            f"{k} {v:.2f}" for k, v in out["ttft_leg_ms_p50"].items()) + "; share of TTFT "
            + ", ".join(f"{k} {100 * v:.1f}%" for k, v in out["ttft_share"].items()))
        for p in per:
            log(f"    {p['replica']}: {p['steps']} steps, decode step "
                f"{p['decode_step_ms_mean'] or float('nan'):.3f} ms x{p['decode_steps']}, "
                f"prefill-pack step {p['prefill_step_ms_mean'] or float('nan'):.3f} ms "
                f"x{p['prefill_steps']}")
        log(f"    launches {out['launches']}, by path {out['launches_by_path']} (planned: "
            f"attention {sorted(attn_plan)}, gmm {sorted(gmm_plan)})")
        torch.cuda.empty_cache()

    n_fail, after = STACK_FAILOVER
    res, router, reps, fo = serve(2, 32, prompts[:n_fail], fail_after=after)
    check(res, reps, n_fail)
    (ev,) = router.failover_events
    assert ev.reason == "manual" and router.auto_failovers == 0 and not reps[0].healthy
    assert 0 < ev.n_requests <= len(fo["failed_inflight"]), \
        f"the failure moved {ev.n_requests} requests of {fo['failed_inflight']}"
    # the stall a moved request's user saw: its longest gap between two
    # tokens (the kill, the re-dispatch and the re-prefill on r1)
    moved = [r for r in res.requests if r.req_id in fo["failed_inflight"]]
    stall = [1e3 * float(np.max(np.diff(r.token_times))) for r in moved]
    others = [1e3 * float(np.median(np.diff(r.token_times))) for r in res.requests
              if r.req_id not in fo["failed_inflight"]]
    ref = streams[2]
    equal = sum(r.generated == ref[r.req_id] for r in res.requests)
    fo.update(requests=n_fail, after_token_events=after, redispatched=ev.n_requests,
              heartbeat_gap_ms=1e3 * ev.latency_s, moved_max_token_gap_ms=stall,
              unmoved_median_token_gap_ms=float(np.median(others)) if others else None,
              streams_equal_unfailed=equal)
    log(f"  failover: r0 failed by hand after {after} token events with "
        f"{len(fo['failed_inflight'])} requests in flight, re-dispatched to r1 by "
        f"handle_failure in {fo['handle_failure_ms']:.1f} ms (r0's last step began "
        f"{1e3 * ev.latency_s:.1f} ms before); the moved requests' longest gap between two "
        f"tokens {max(stall):.1f} ms (the others' median gap "
        f"{fo['unmoved_median_token_gap_ms'] or float('nan'):.2f} ms); all {n_fail} finished; "
        f"streams equal to the unfailed 2 x 32 run's: {equal} of {n_fail} (printed only: a "
        f"bf16 re-prefill can split a near-tie)")
    stack = dict(config=cfg.name, layers=cfg.n_layers, requests=STACK_REQUESTS,
                 new_tokens=STACK_NEW, prompt_tokens=[len(p) for p in prompts],
                 workload="sample_workload(WorkloadSpec(n_requests=64, vocab=32000, seed=0))",
                 gateway="scale", policy="least_loaded", layouts=layouts, failover=fo)
    if profile:
        # both layouts on the full batch, each in its own window: the device
        # time a step against each replica's wall time a step (step_records,
        # the token readback's wait included) says whether the 2 x 32 steps
        # grew on the host or on the device (the window also holds the warm-up)
        stack["profile"] = []
        for n_replicas, slots in STACK_LAYOUTS:
            _, _, reps, prof = serve(
                n_replicas, slots, prompts,
                profile_what=f"{n_replicas} x {slots} slots, {STACK_REQUESTS} requests x "
                             f"{STACK_NEW} tokens")
            w = prof["profile"]
            steps = {r.replica_id: [x.duration for x in r.engine.step_records] for r in reps}
            n_steps = sum(len(v) for v in steps.values())
            w.update(layout=f"{n_replicas}x{slots}", steps=n_steps,
                     device_ms_per_step=w["device_busy_ms"] / n_steps,
                     replica_step_ms_mean={k: 1e3 * float(np.mean(v)) for k, v in steps.items()},
                     replica_in_step_share={k: 1e3 * sum(v) / w["wall_ms"]
                                            for k, v in steps.items()})
            log(f"    {n_replicas} x {slots}: {n_steps} engine steps, device "
                f"{w['device_ms_per_step']:.3f} ms a step; each replica's wall ms a step "
                + ", ".join(f"{k} {v:.3f}" for k, v in w["replica_step_ms_mean"].items())
                + ", share of the window inside step() "
                + ", ".join(f"{k} {100 * v:.1f}%" for k, v in w["replica_in_step_share"].items()))
            stack["profile"].append(w)
    # the kernels line takes the 1 x 64 run's counts: one replica thread, so
    # the wrappers' plain += counted every launch
    return stack, layouts[0]["launches"]


def profile_window(fn, what: str):
    """torch.profiler over one call of ``fn``: device time by kernel name
    and the device's busy share of the window."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        # device-side events only: the host ops that launched them report
        # the same time again
        if e.device_type != DeviceType.CUDA:
            continue
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = getattr(e, "self_cuda_time_total", 0.0)
        if dt > 0:
            rows.append((e.key, dt / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    log(f"  profile window ({what}): wall {wall * 1e3:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / (wall * 1e3):.1f}%); top kernels by device time:")
    for k, t, n in rows[:12]:
        log(f"    {t:10.3f} ms  x{n:<6d} {k[:90]}")
    # the port's own kernels (csrc/: anonymous namespaces, no ATen types in
    # their signatures), wherever they rank: each one's share of the busy time
    port = [(k, t, n) for k, t, n in rows
            if k.split("(anonymous namespace)::")[0] in ("", "void ") and "at::" not in k]
    log("  the port's kernels, share of busy time: " + "; ".join(
        f"{k.split('::')[1].split('(')[0]} {t:.3f} ms x{n} ({100 * t / busy_ms:.2f}%)"
        for k, t, n in port))
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy_ms,
                top=[dict(name=k, ms=t, count=n) for k, t, n in rows[:25]],
                port=[dict(name=k, ms=t, count=n) for k, t, n in port])


# ------------------------------------------------------------------ main
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="write every measurement to this JSON file")
    ap.add_argument("--profile", action="store_true",
                    help="add torch.profiler windows over short serving runs and over "
                         "the generation paths")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build as kbuild

    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 phases in full fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    t_start = time.perf_counter()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    log("phase 1: build the CUDA kernels (nvcc, sm_90a, one process per source)")
    t0 = time.perf_counter()
    logs = kbuild.build()
    for name in kbuild.KERNELS:
        kbuild.load_library(name)
        lines = [ln.strip() for ln in logs.get(name, "").splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"  {name}: {kbuild.library_path(name).name}"
            + ("" if name in logs else " (already built)"))
        for ln in lines:
            log(f"    {ln}")
    log(f"  built in {time.perf_counter() - t0:.1f} s")

    log("phase 2: kernels vs plain versions on the card")
    flush = torch.empty(64 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)  # > 50 MB L2
    t0 = time.perf_counter()
    results = []
    run_attention(dev, flush, results)
    run_gmm(dev, flush, results)
    run_flash(dev, flush, results)
    run_paged_decode(dev, flush, results)
    run_ssd(dev, flush, results)
    run_w8a16(dev, flush, results)
    del flush
    log(f"  phase 2 took {time.perf_counter() - t0:.1f} s")

    log("phase 3: every model path at depth 2, full width, fp32, card vs CPU")
    t0 = time.perf_counter()
    e2e_err, cross_err = run_card_vs_cpu(dev)
    torch.cuda.empty_cache()
    int8_err, int8_cross = run_card_vs_cpu(dev, int8=True)
    torch.cuda.empty_cache()
    mamba_err, mamba_cross = run_mamba_card_vs_cpu(dev)
    torch.cuda.empty_cache()
    log(f"  phase 3 took {time.perf_counter() - t0:.1f} s")

    log("phase 4: serving run")
    t0 = time.perf_counter()
    model, params, info = build_mixtral(dev, SERVE_LAYERS, int8=False)
    serve, launches, streams, _ = run_serving(dev, args.profile, model, params)
    serve.update(info)
    log(f"  phase 4 took {time.perf_counter() - t0:.1f} s")

    log("phase 5: generation path (prefill + decode_step) on phase 4's weights")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    generation, gen_launches = run_generation(dev, model, params, streams, args.profile)
    launches.update(flash_attention=gen_launches["flash_attention"],
                    paged_attention=gen_launches["paged_attention"])
    log(f"  phase 5 took {time.perf_counter() - t0:.1f} s")

    log("phase 8: the serving stack (client -> gateway -> router -> replicas) on phase 4's "
        "weights, 64 concurrent requests")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    stack, stack_launches = run_stack(dev, model, params, args.profile)
    del model, params
    log(f"  phase 8 took {time.perf_counter() - t0:.1f} s")

    log("phase 6: full-depth mamba2 serving (bf16), then its generation API")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    mamba_serve, mamba_generation = run_mamba(dev, args.profile)
    launches["ssd_scan"] = mamba_serve["launches"]["ssd_scan"]
    log(f"  phase 6 took {time.perf_counter() - t0:.1f} s")

    log("phase 7: full-depth mixtral-8x7b on int8 weights: serving run, then the "
        "generation API")
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    model, params, info = build_mixtral(dev, 32, int8=True)
    int8_serve, int8_launches, streams, eng_logits = run_serving(
        dev, args.profile, model, params, int8=True, profile_tokens=4)
    int8_serve.update(info)
    int8_generation, _ = run_generation(dev, model, params, streams, profile=False,
                                        eng_logits=eng_logits)
    del eng_logits
    del model, params
    launches["w8a16_matmul"] = int8_launches["w8a16_matmul"]
    log(f"  phase 7 took {time.perf_counter() - t0:.1f} s")

    kernels = []
    for name, route_src, replaces, case in (
            ("chunked_prefill_attention", "src/repro_torch/csrc/chunked_prefill.cu",
             "src/repro/kernels/paged_attention/kernel.py:232", "decode"),
            ("moe_gmm", "src/repro_torch/csrc/moe_gmm.cu",
             "src/repro/kernels/moe_gmm/kernel.py:29", "8tok 4096->14336"),
            ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:112", "prefill"),
            ("paged_attention", "src/repro_torch/csrc/chunked_prefill.cu",
             "src/repro/kernels/paged_attention/kernel.py:107", "decode"),
            ("ssd_scan", "src/repro_torch/csrc/ssd_scan.cu",
             "src/repro/kernels/ssd_scan/kernel.py:65", "mamba2 pack"),
            ("w8a16_matmul", "src/repro_torch/csrc/quant_matmul.cu",
             "src/repro/kernels/quant_matmul/kernel.py:40", "decode wq")):
        row = next(r for r in results if r["kernel"] == name and r["case"] == case
                   and r["dtype"] == "bfloat16")
        kernels.append(dict(name=name, route="cuda", source=route_src, replaces=replaces,
                            launches=launches[name], max_abs_err=row["max_abs_err"],
                            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                            bound_by=row["bound_by"], library_ms=row["library_ms"],
                            stack_launches=stack_launches[name],
                            shape=f"{case} bf16: {row['shape']}"))
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(dict(card=card, cases=results, e2e_max_abs_logit=e2e_err,
                                       cross_path_max_abs_logit=cross_err,
                                       mamba_e2e_max_abs_logit=mamba_err,
                                       mamba_cross_path_max_abs_logit=mamba_cross,
                                       int8_e2e_max_abs_logit=int8_err,
                                       int8_cross_path_max_abs_logit=int8_cross, serve=serve,
                                       generation=generation, mamba_serve=mamba_serve,
                                       mamba_generation=mamba_generation,
                                       int8_serve=int8_serve, int8_generation=int8_generation,
                                       stack=stack, kernels=kernels),
                                  indent=1))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(f"card: {card}")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
