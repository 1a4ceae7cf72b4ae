#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, in phases; any failure
exits non-zero and no phase's failure is caught.

  1. print the card's name and power limit; build the seven CUDA sources of
     src/repro_torch/csrc (the six TPU kernels' ports: paged decode is the
     chunked attention source's split path in decode mode; and the flash
     and SSD backwards) with nvcc for
     sm_90a (one nvcc per source, in parallel) and print what ptxas reports
     (registers, spills).
  2. each kernel against its plain PyTorch version on the card: the small
     edge cases of the CPU tests, and the main paths' shapes at full
     Mixtral width (the SSD scan at mamba2's and jamba's, with a
     4096-token mamba2 prefill; chunked attention also at a verify width
     of 4 tokens and over a 4096-key context), in fp32 and
     bf16, and in bf16 at the shapes the later phases serve: phase 8's
     (chunked attention's 64- and 32-row decode sweeps and its prefill pack
     over a 1024-page pool, gmm at 64 and 32 tokens), phase 9's (every
     ``decode_chunk`` shape of 1, 8 and 32 slots: decode and verify sweeps
     at C = 1, 2, 3 and 5 and the pack, for attention and for gmm at B * C
     tokens), the generation API's prefill (gmm at 4 x 297 tokens), and
     phase 7's (int8 experts at its speculative run's B * C tokens and its
     prefill, w8a16 projections and head at its B * C rows), and in fp32
     and bf16 at phase 11's (MHA at head dims 64 and 96: chunked attention's
     decode sweeps and packs over the two engines' pools, phi-3-vision's
     pack of 576 patch columns + 128 tokens a row; flash attention over
     seamless-m4t's 1024-frame encoder, its cross attention at 1, 128 and
     297 queries against 1024 keys, and both prefills; paged decode at both
     generation APIs' last step), and in fp32 and bf16 at phase 13's
     ranks' (chunked attention's packs, flash's prefills and paged decode
     at a rank's heads; chunked and paged at qwen2.5-3b's tensor-4 ranks
     through ``q_head0`` 0, 4, 8 and 12: 4 heads of a group of 8 over the
     whole 2-head pool; the SSD scan at mamba2's 64 / 4 and jamba's 128 /
     2 heads), with the kernel's device time (its launch wrapper alone), the
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
     for bit-equal results. The flash backward (the training path's) in
     fp32 (``tiled``) and bf16 (``mma``, its GQA subsets and grids
     printed): the forward's row logsumexp against the plain one, then
     dq / dk / dv against ``mha_reference_bwd`` on the same inputs
     (relative to the plain version's max |grad|: fp32 1e-4, bf16 5e-2 and
     1e-2 at the training shapes), zero dq on rows that see no key,
     twice for bit-equal results, on the CPU tests' edge cases and at
     phase 12's shapes (qwen2.5-3b and mixtral at 4 x 512 tokens), phase
     14 (c)'s ranks' (2 x 512 tokens, qwen2.5-3b's heads at tensor 2,
     mixtral's; the forward's rows too), phase 14 (a) / (b)'s fp32 calls
     (32 tokens a row, checked only),
     seamless-m4t's encoder and gemma2-27b's window and softcap, timed
     beside its bound, its plain version and SDPA's backward. The SSD
     backward (the training path's) in fp32 and bf16: the forward's tile
     entry states against ``ssd_reference``'s (y unchanged by writing
     them), then dx / ddt / dA / dB / dC / d(init_state) against
     ``ssd_reference_bwd`` on the same inputs, states and cotangents (each
     within 1e-4 of its max |plain grad|; bf16's dx / dB / dC may also
     differ by their own rounding), twice for bit-equal results, on the
     forward's edge cases and at mamba2's and jamba's training shapes (4 x
     512 tokens), timed beside its bound and its plain version. The grouped
     matmul also at deepseek-moe-16b's routed experts (64 of 2048 -> 1408,
     top-6).
  3. full-width mixtral-8x7b at depth 2 in fp32, on the card, on two
     sequences of 22 tokens: the engine's ``decode_chunk`` (a pack of their
     first 16 / 11 tokens, a decode sweep, then a speculative verify sweep
     with ``all_logits`` at C = 5 over rows feeding 5 / 2 tokens, compared
     at every valid position), ``forward`` at every position, ``prefill``
     of the first 16 then 4 ``decode_step``s over the dense ring, and the
     same 4 over the paged pool filled from the ring; each against
     ``forward`` on the CPU (plain versions, the same weights) at the same
     positions within LOGIT_ATOL with the same argmax, and against the
     card's own ``forward`` within LOGIT_ATOL. The CPU runs ``forward``
     alone: its other paths equal its forward by the CPU tests, and running
     each of them took most of the phase. The same again on
     ``quantize_params_int8`` of those weights (w8a16 and the int8 grouped
     matmul on the card). Then the same for mamba2 at depth 2, full width:
     ``forward``, ``prefill`` + 4 ``decode_step``s, and a ``decode_chunk``
     pack whose ``first`` rows reset garbage states, then a decode sweep.
     Then yi-6b, phi3-mini-3.8b, deepseek-moe-16b and qwen2.5-3b at depth 2
     and dbrx-132b at depth 1, full width, fp32: ``decode_chunk`` on the
     card (a pack, a decode sweep, a verify sweep with ``all_logits``)
     against the CPU's ``forward`` within LOGIT_ATOL with the same argmax,
     the MoE configs through the grouped matmul.
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
     paths' top-2 logits at the first diverging token (printed only); then
     phase 9's runs at 8 slots and 32 new tokens (the w8a16 head and
     projections at M * C rows; its launches too must be > 0).
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
  9. (run after phase 8, on phase 4's weights) speculative serving: 1, 8
     and 32 requests of ``sample_workload(WorkloadSpec(...,
     extractive_frac=0.5, boilerplate_frac=0.5, seed=0))`` (the extractive
     / boilerplate mix prompt-lookup drafts from) at ``max_slots`` 1, 8 and
     32, 64 greedy tokens each, once with speculation off and once with
     ``spec_k`` = 4. Every request finishes, the allocator invariants hold
     and every page is free again; the engine drafted and ran verify
     sweeps; chunked attention launched in sweeps of C = 2, 3 and 5; gmm
     and chunked attention took exactly the paths their plans name for the
     run's call shapes. Prints tok/s and wall time off and on, the
     acceptance rate, steps, ms a verify sweep against a plain decode
     sweep, and how many leading tokens of each stream equal the run
     without speculation (printed only).
 11. (run after phase 9, phase 4's weights freed) enc-dec and VLM at full
     width and depth, random bf16 weights from a seed, pages of 16, packs
     of 2 x 128, greedy, bf16 KV: (a) seamless-m4t-large-v2 (24 encoder +
     24 decoder layers) through ``InferenceEngine.generate`` on phase 4's 4
     prompts x 32 new tokens, each request with seeded frames of 300, 640,
     1024 and 1536 frames in ``engine.extras`` (padded, exact and cropped
     to the 1024-frame memory), then its generation API (``prefill`` with
     the frames, 32 ``decode_step``s over the paged pool); (b)
     phi-3-vision-4.2b (32 layers) the same with 576 seeded patches a
     request, whose packs must mix one request's first chunk (patch prefix
     live) with another's later chunk; (c) both at depth 2 (encoder 2),
     full width, fp32, card vs CPU on a first-chunk pack, that mixed pack,
     a decode sweep, ``forward`` and ``prefill`` + 4 ``decode_step``s,
     within LOGIT_ATOL with the same argmax. Every request finishes, the
     allocator invariants hold, every page is free and the extras dropped;
     chunked attention launched on split and mma only (head dims 64, 96),
     flash (the encoder, cross attention, the prefills) on mma only, paged
     decode on the generation APIs. Prints tok/s, TTFT, TBT, the encoder's
     ms a pack with a first row, peak memory and weights' GB.
 12. (run after phase 7) training on the card through
     ``training.trainer.train``: (a) qwen2.5-3b at full width, depth cut
     36 -> 18 layers (room for phase 13 in the run's time; random bf16
     weights from seed 0), 4 x 512 tokens
     of the synthetic corpus a step, remat, xent_chunk 128, peak lr 1e-3
     after 2 warmup steps: 8 steps; then a run that checkpoints at step 4
     (~20 GB: bf16 parameters and fp32 moments) and crashes at step 6,
     and a resume from that checkpoint, its checkpointer stubbed so it
     writes none (the card's machine allows 45 GiB of disk writes a call); every loss finite, the
     mean of steps 6-8 below step 1's, the resumed losses within 2e-2 of
     the uninterrupted run's; step ms, tokens/s, peak memory and 6 N
     tokens / step time against the bf16 peak printed. (b) mixtral-8x7b at
     full width, depth 2, the capacity MoE, 4 steps at peak lr 1e-4:
     losses finite and falling; aux and the dropped assignments printed.
     Flash attention and its backward launched on their planned paths
     only (``mma`` both); chunked / paged attention, gmm, SSD and
     w8a16 never. (c) qwen2.5-3b at depth 2 and mixtral at depth 1, full
     width, fp32, card vs CPU on 2 x 32 tokens: the loss within 1e-4
     relative, every gradient leaf within 1e-3 of its max |g|, and one
     ``step_fn`` with 2 microbatches and int8 gradients (qwen): its loss
     within 1e-4, AdamW's m / v within 1e-3 / 2e-3 of each leaf's max
     plus one int8 step, and the card's parameters equal to AdamW
     recomputed in float64 from them (1e-5 of lr, two ulps). (d)
     mamba2-1.3b at full width and depth (48 layers, 1.34 B parameters,
     random bf16 weights from seed 0), (a)'s corpus, batch, remat and
     schedule, 8 steps, no checkpoint: every loss finite, the mean of steps
     6-8 below step 1's; step ms, tokens/s and peak memory printed; the SSD
     forward (``mma``) and backward launched on their planned paths only,
     no other kernel of the port. (e) mamba2 and jamba-v0.1-52b (a mamba
     layer with a dense MLP, then one with the 16-expert MoE) at depth 2,
     full width, fp32, card vs CPU as (c) without the step, the SSD
     kernels launched on the card.
 13. (run after phase 9, on phase 5's prompts and logits, once phase 4's
     model is freed) distributed serving
     (``launch.mesh``, ``distributed.sharding``, the shard_map MoE
     strategies): (a) NCCL at world 1 in this process: mixtral at depth 2,
     full width, fp32, ep_shardmap on the (1, 1, 1) mesh, prefill + 4
     decode_steps over the paged pool within LOGIT_ATOL of the unsharded
     capacity run on the card, argmax equal; (b) four ranks spawned on the
     one card over gloo (NCCL puts no two ranks of a communicator on one
     device; gloo takes CUDA tensors through the host), each drawing only
     its shards of the same seeded weights: the same model and paths plus a
     decode_chunk pack on meshes (data, expert, tensor) = (1, 2, 2)
     ep_shardmap and (1, 1, 4) tp_shardmap, capacity factor E / K (no
     token dropped, asserted), rank 0's gathered logits within LOGIT_ATOL of
     the unsharded run, argmax equal; (c) the same ranks on phase 4's
     8-layer bf16 mixtral at (1, 2, 2) ep_shardmap, teacher-forced with
     the first DIST_C_STEPS = 8 of phase 5's greedy tokens: every logit
     row within DIST_BF16_RTOL of its max |logit| of phase 5's, each
     argmax flip a
     tie; prefill ms, decode step ms, tok/s, each rank's parameter bytes
     (equal to its specs' shard sum) and peak memory, and the kernels'
     launches (rank 0) printed; flash attention, paged decode and (b)'s
     chunked attention launched, gmm never (the shard_map strategies run
     their experts as batched matmuls). (d)-(f) the same ranks, fp32, full
     width, each prompt cut to its first 80 tokens (no padding: an SSM's
     state would run through it), teacher-forced with seeded tokens:
     prefill into the dense ring, 2 decode_steps over it, 4 over the paged
     pool, a decode_chunk pack, each against the unsharded card run within
     LOGIT_ATOL, argmax equal: (d) qwen2.5-3b at depth 2 on (1, 1, 4),
     where the tensor axis outgrows its 2 kv heads (the reference's kv_seq
     layout: the ring split on the sequence over tensor, the pool whole,
     each rank's 4 query heads reading one kv head through the kernels'
     q_head0); (e) mamba2-1.3b at depth 2 on (1, 1, 4) (in_proj's 8512
     columns, the 4352 conv channels, 64 SSD heads and d_inner all split);
     (f) jamba-v0.1-52b cut to 5 layers (MMMMA: mamba, GQA attention and
     two 16-expert MoE layers; 28.6 GB) on (1, 2, 2) ep_shardmap; each
     model's kernels launched (flash, paged and chunked attention where it
     has attention, the SSD scan where it has mamba layers, gmm never);
     prefill, decode step and pack ms and peak memory printed. (g), (h) the
     enc-dec and VLM families the same way, fp32, full width, 2 decoder
     layers, with seeded extras: prefill into the dense ring (and cross
     cache), 2 decode_steps over it, a decode_chunk pack of the prompts
     with the same extras into a fresh pool, 4 decode_steps over that pool,
     each against the unsharded card run within LOGIT_ATOL, argmax equal:
     (g) seamless-m4t-large-v2 (2 encoder layers over 64 frames a row) on
     (2, 1, 2) (a rank's rows of the batch and of the cross cache, its 8
     heads of 16); (h) phi-3-vision-4.2b (576 patches a row ahead of each
     prompt) on (1, 1, 4) (8 heads of 32); flash, paged and chunked
     attention launched. Any rank's failure or a rank not done within 300 s
     fails.
 14. (run after phase 9, once phase 4's model is freed) distributed
     training (the train rules: FSDP on the data axis; TP / EP backward
     through the differentiable collectives; the gradient reduction and
     its int8 form; every family): (a) NCCL at world 1 in this process: qwen2.5-3b at
     depth 2, full width, fp32, on the (1, 1, 1) train mesh, 4 x 32
     tokens: ``LM.loss`` and its gradient, then one ``step_fn`` (2
     microbatches, int8 gradients), against the unsharded step on the card:
     the loss within 1e-5 relative, every gradient leaf within 1e-4 of its
     max |g|, m / v and the parameters as phase 12 (c) holds them. (b) four
     gloo ranks on the one card, fp32, each drawing its shards of the same
     seeded weights: qwen2.5-3b at depth 2 on (data, expert, tensor) = (2,
     1, 2) (the same step) and mixtral-8x7b at depth 1 on (2, 2, 1)
     ep_shardmap (one batch; capacity factor E / K, no token dropped,
     asserted), against the unsharded step on the card (mixtral's with each
     data shard's MoE aux, the reference's semantics under a data split),
     computed first by the parent, which keeps a seeded sample of each
     leaf's gradient, m and v by global position on the host and frees the
     card before the spawn: each sampled element within phase 12 (c)'s
     bounds, each rank's loss (mixtral's: the whole batch's xent plus its
     shard's aux) within 1e-4, each rank's parameters against AdamW on its
     own moments, and its parameter, moment and error-feedback bytes equal
     to its specs' shard sums. (d) the layouts training under a mesh once
     refused, held the same way: qwen2.5-3b at depth 2 on (1, 1, 4) (kv_seq:
     its 2 kv heads whole on every tensor rank) and mamba2-1.3b at depth 2
     on (1, 1, 2), qwen's step; jamba-v0.1-52b's first two layers (a mamba
     layer with a dense MLP, then one with the 16-expert MoE) on (1, 2, 2)
     ep_shardmap, its loss and reduced gradient alone (its fp32 step would
     not fit: 4 copies of the 11.3 GB MoE layer on the ranks); the SSD scan
     and its backward launched for both mamba models. (e) seamless-m4t-
     large-v2 (2 encoder and 2 decoder layers, 64 frames a row) and
     phi-3-vision-4.2b (2 layers, 576 patches a row) on (2, 1, 2), qwen's
     step. Each case's step ms and peak device memory per rank printed.
     (c) the same ranks in bf16 at full width:
     qwen2.5-3b at depth 4 on (2, 1, 2) and mixtral-8x7b at depth 1 on (2,
     2, 1) (depth 2 fits but doubles the phase's longest part: see
     DIST_TRAIN_BF16), phase 12 (a)'s corpus, 4 x 512 tokens a step, remat,
     xent_chunk 128, peak lr 1e-4, 2 steps, no checkpoint: every rank's
     losses finite and falling;
     step ms, tokens/s, each rank's peak memory and bytes and rank 0's
     launches printed; flash attention and its backward on ``mma`` only, no
     other kernel. Any rank's failure or a rank not done within 300 s fails.
 15. (run after phase 12) the dry-run's memory proof
     (``launch.dryrun``): rank 0's share of mixtral-8x7b ``decode_32k`` on
     the single-pod (16, 16) mesh with the MoE on tp (the paper's model and
     the cell the reference's fig8 (b) reads), in bf16 and on the int8
     tree: first walked on ``meta`` (its collectives, FLOPs, bytes and
     roofline terms), then drawn on the card from a seeded generator and
     run through one step under the same recorder, the mesh placed at rank
     0 (one card holds one rank, so its collectives stand in for their
     results). The card's allocation after the inputs are placed equals
     the walk's ``memory.argument_bytes`` within 1%, the logits are finite
     and of the global batch's shape, and the card's collective log equals
     the meta walk's entry for entry. The bf16 cell launches none of the
     port's kernels (its dense-ring decode attention is the reference's
     plain einsum, its experts batched matmuls, its head a matmul); the int8
     cell launches the w8a16 matmul 4 L + 1 and the int8 grouped matmul 3 L
     times a step (L = 32 layers) and nothing else, at shapes phase 2 holds
     (``dryrun_shapes``). Prints the peak allocation, the median of
     DRYRUN_STEPS more steps, and the walk's ``memory_floor_s`` and
     ``bound_s`` beside them.
 10. every call shape of chunked attention, gmm, w8a16, flash attention,
     the SSD scan and both backwards in phases 4-9, 11, 12 (a, b, d), 13,
     14 and 15 (recorded at the public ops, on rank 0 in phases 13 and 14)
     must be one phase 2 held against the plain version; then
     a ``kernels`` JSON line (with each kernel's launches behind the stack
     as ``stack_launches``, in the speculative runs as ``spec_launches``,
     in phase 11 as ``encdec_launches`` / ``vlm_launches``, in phase 12
     as ``train_launches``, in phase 13 (rank 0, (a) to (f)) as
     ``dist_launches``, in phase 14 (rank 0, (a) + (b) + (c)) as
     ``dist_train_launches`` and in phase 15 as ``dryrun_launches``; the
     flash and SSD backwards' ``launches``
     are phase 12's), then ``{"ok": true, "device": {...}}`` last.

Run on the card from the repository root:  python3 chip_smoke.py
Options: --out FILE writes every measurement as JSON; --profile skips
phase 3 (card vs CPU checks only, which the run without options makes)
and adds torch.profiler windows over short serving runs, over decode steps of the
generation paths, over a short run of each stack layout (8 requests x 8
tokens), over a speculative run at each slot count, over a short serving
run of each phase-11 family, over one qwen2.5-3b and one mamba2-1.3b
train step and over one step of each phase-15 cell (kernel time by name, the device's busy share, and the stack's
device and wall time a step).
"""
from __future__ import annotations

import argparse
import contextlib
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
SLEEP_CYCLES = 200_000_000         # ~0.1-0.2 s of SM clock: the most a timing waits to enqueue
SLEEP_MIN_CYCLES = 10_000_000      # ~5 ms: the least
SM_HZ = 1.98e9                     # the H100 SXM's top SM clock: a sleep lasts >= cycles / SM_HZ
STACK_REQUESTS = 64                # phase 8: concurrent requests of the OpenOrca-like mix
STACK_NEW = 32                     # new tokens a request
STACK_LAYOUTS = ((1, 64), (2, 32))  # (replicas, max_slots a replica) on one card
STACK_FAILOVER = (16, 64)          # failover run: requests, token events before the failure
STACK_PAGES, STACK_MAX_SEQ = 1024, 2080   # a replica's pool; the longest prompt + 32
STACK_PACK = (2, 128)              # the engine's prefill pack at 64 and at 32 slots
STACK_PROFILE = (8, 8)             # --profile: each layout's window, requests x new tokens
VERIFY_WIDTHS = (2, 3, 5)          # the verify sweep's chunk widths at spec_k = 4
SPEC_SLOTS = (1, 8, 32)            # phase 9: max_slots of each run, as many requests
SPEC_NEW = 64                      # new tokens a request
INT8_SPEC_SLOTS = 8                # phase 7's speculative run: max_slots, as many requests
PROMPT_LENS = (113, 178, 241, 297)  # phases 4-7 and 11: the serving and generation prompts
# phase 11: the enc-dec and VLM engines (4 slots, pages of 16, packs of 2 x 128)
MM_SEAMLESS, MM_VISION = "seamless-m4t-large-v2", "phi-3-vision-4.2b"
# phase 13 (d)-(h): each prompt's first tokens, no padding (two of the SSD
# scan's 64-token tiles); (f)'s MoE layers move (E, T, d) fp32 buffers
# through the host (capacity factor E / K), 4 x 113 tokens took 5-8 s a
# prefill
DIST_PROMPT = 80
DIST_FRAMES = 64                   # phases 13 (g) and 14 (e): seamless's frames a row
MM_SLOTS = 4
MM_MAX_SEQ = {MM_SEAMLESS: 512, MM_VISION: 1024}   # VLM: 576 patches + 297 + 32 fit
MM_FRAMES = (300, 640, 1024, 1536)  # each request's frames: padded / exact / cropped to 1024
# phase 15: the dry-run's cell on the card (rank 0 of the single-pod mesh, MoE on tp)
DRYRUN_ARCH, DRYRUN_SHAPE, DRYRUN_MESH = "mixtral-8x7b", "decode_32k", (16, 16)
DRYRUN_STEPS = 3                   # timed steps after the recorded one
DRYRUN_ALLOC_RTOL = 0.01           # the caching allocator's rounding of the placed inputs


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
    host fell behind). The sleep lasts eight times the host's time to
    enqueue the calls, from its time for the second warm-up call, within
    [SLEEP_MIN_CYCLES, SLEEP_CYCLES]; the garbage collector waits until the
    calls are enqueued. Without it (for a function that
    synchronises inside, or to measure an op as a caller sees it) each
    call is timed on its own and the device waits for the host's dispatch
    within it."""
    fn()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(iters)]
    if queued:
        gc.disable()
        torch.cuda._sleep(int(min(SLEEP_CYCLES,
                                  max(SLEEP_MIN_CYCLES, 8 * (iters + 1) * host_s * SM_HZ))))
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
        behind = slept.query()
        gc.enable()
        assert not behind, "the host fell behind the device: raise SLEEP_MIN_CYCLES"
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in ev) / iters


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# ------------------------------------------------------------ call shapes
# Phase 2 adds the shape of every call it holds against the plain version
# to CHECKED. Phases 4 to 9 and 11 run under ``served_shapes``, which adds
# the shape of every call the serving paths make to chunked attention, the
# grouped matmul, the w8a16 matmul and flash attention to SERVED. The script
# fails if a served shape was never checked.
CHECKED = {k: set() for k in ("chunked_prefill_attention", "moe_gmm", "w8a16_matmul",
                              "flash_attention", "flash_attention_bwd", "ssd_scan",
                              "ssd_scan_bwd")}
SERVED = {k: set() for k in CHECKED}


def attention_key(q, kp, pt, q_head0: int = 0, group: int = 0) -> tuple:
    """(B, C, H, Hkv, D, page size, pages a row, q dtype, KV dtype, the
    heads' fold (G, kv0): ``head_fold`` of q's heads over the pool)"""
    from repro_torch.kernels.paged_attention.kernel import head_fold
    B, C, H, D = q.shape
    return (B, C, H, kp.shape[2], D, kp.shape[1], pt.shape[1], str(q.dtype)[6:],
            str(kp.dtype)[6:], head_fold(H, kp.shape[2], q_head0, group))


def flash_key(q, k, causal, window, softcap) -> tuple:
    """(B, Sq, Skv, H, Hkv, D, causal, window, softcap, dtype)"""
    B, Sq, H, D = q.shape
    return (B, Sq, k.shape[1], H, k.shape[2], D, bool(causal), int(window), float(softcap),
            str(q.dtype)[6:])


def ssd_key(x, B_, init: bool) -> tuple:
    """(B, L, H, P, N, G, a carried state, dtype)"""
    return (*x.shape, B_.shape[3], B_.shape[2], init, str(x.dtype)[6:])


def gmm_key(rows: int, K: int, N: int, dtype, int8: bool) -> tuple:
    return (rows, K, N, str(dtype)[6:], int8)


def w8a16_key(x, w_q, col_scale, row_scale) -> tuple:
    """(M, K, N, row-scale groups or 0, a column scale, k-major weight, dtype)"""
    from repro_torch.kernels.quant_matmul.kernel import is_k_major
    return (*x.shape, w_q.shape[1], 0 if row_scale is None else row_scale.shape[1],
            col_scale is not None, is_k_major(w_q), str(x.dtype)[6:])


@contextlib.contextmanager
def served_shapes():
    """While open, the public ops' calls of chunked attention, the grouped
    matmul, the w8a16 matmul, flash attention, the SSD scan and both
    backwards add their shapes to SERVED and go on to the kernel's wrapper
    unchanged (which counts the launch)."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.moe_gmm import ops as gops
    from repro_torch.kernels.paged_attention import ops as aops
    from repro_torch.kernels.quant_matmul import ops as wops
    from repro_torch.kernels.ssd_scan import ops as sops
    attn, gmm, w8 = aops.chunked_prefill_cuda, gops.gmm_tiles_cuda, wops.w8a16_matmul_cuda
    flash, flash_bwd = fops.flash_attention_cuda, fops.flash_attention_bwd_cuda
    ssd, ssd_bwd = sops.ssd_scan_cuda, sops.ssd_scan_bwd_cuda

    def attn_rec(q, kp, vp, pt, *args, **kw):
        SERVED["chunked_prefill_attention"].add(attention_key(q, kp, pt, kw.get("q_head0", 0),
                                                              kw.get("group", 0)))
        return attn(q, kp, vp, pt, *args, **kw)

    def gmm_rec(xb, w, *args, w_scale=None, rows=None, **kw):
        SERVED["moe_gmm"].add(gmm_key(rows, xb.shape[1], w.shape[2], xb.dtype,
                                      w_scale is not None))
        return gmm(xb, w, *args, w_scale=w_scale, rows=rows, **kw)

    def w8_rec(x, w_q, col_scale=None, row_scale=None):
        SERVED["w8a16_matmul"].add(w8a16_key(x, w_q, col_scale, row_scale))
        return w8(x, w_q, col_scale, row_scale)

    def flash_rec(q, k, v, *, causal, window=0, softcap=0.0, **kw):
        SERVED["flash_attention"].add(flash_key(q, k, causal, window, softcap))
        return flash(q, k, v, causal=causal, window=window, softcap=softcap, **kw)

    def flash_bwd_rec(q, k, v, out, dout, lse, *, causal, window=0, softcap=0.0, **kw):
        SERVED["flash_attention_bwd"].add(flash_key(q, k, causal, window, softcap))
        return flash_bwd(q, k, v, out, dout, lse, causal=causal, window=window, softcap=softcap,
                         **kw)

    def ssd_rec(x, dt, A, B_, C, init_state=None, **kw):
        SERVED["ssd_scan"].add(ssd_key(x, B_, init_state is not None))
        return ssd(x, dt, A, B_, C, init_state=init_state, **kw)

    def ssd_bwd_rec(x, dt, A, B_, C, states, dy, d_final=None, **kw):
        # the forward's key: a carried state's gradient is asked for only with one
        SERVED["ssd_scan_bwd"].add(ssd_key(x, B_, kw.get("need_init", True)))
        return ssd_bwd(x, dt, A, B_, C, states, dy, d_final, **kw)

    aops.chunked_prefill_cuda, gops.gmm_tiles_cuda, wops.w8a16_matmul_cuda = \
        attn_rec, gmm_rec, w8_rec
    fops.flash_attention_cuda, fops.flash_attention_bwd_cuda = flash_rec, flash_bwd_rec
    sops.ssd_scan_cuda, sops.ssd_scan_bwd_cuda = ssd_rec, ssd_bwd_rec
    try:
        yield
    finally:
        aops.chunked_prefill_cuda, gops.gmm_tiles_cuda, wops.w8a16_matmul_cuda = attn, gmm, w8
        fops.flash_attention_cuda, fops.flash_attention_bwd_cuda = flash, flash_bwd
        sops.ssd_scan_cuda, sops.ssd_scan_bwd_cuda = ssd, ssd_bwd


# ------------------------------------------------------------------ phase 2
def attention_case(dev, *, B, C, H, Hkv, D, ps, maxp, num_pages, starts, nvalid, dtype,
                   window=0, softcap=0.0, seed=0, used_only=False, fold=None):
    """Random q and pool. Every page-table entry gets a distinct pool page,
    or, with ``used_only``, only those below the row's length, the rest
    page 0 as the engine leaves them (a pool smaller than B * maxp).
    ``fold`` (q_head0, group): q's H heads are a rank's of a config with
    that GQA group, over the whole pool of Hkv kv heads."""
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
    kw = dict(scale=D ** -0.5, softcap=softcap, window=window)
    if fold is not None:
        kw.update(q_head0=fold[0], group=fold[1])
    return q, kp, vp, pt, lengths, qpos, kw


def attention_bound(q, kp, lengths, qpos, dtype, window=0, q_head0=0, group=0):
    """Bytes: q and out once; K and V once at each position some query of
    the row can see (below the row's length and its last query's position,
    within the window), of the kv heads q's heads read, and the page ids of
    those positions' pages. Operations: 4*D per visible (query head, key)
    pair."""
    from repro_torch.kernels.paged_attention.kernel import head_fold
    B, C, H, D = q.shape
    ps = kp.shape[1]
    Hkv = H // head_fold(H, kp.shape[2], q_head0, group)[0]   # the kv heads read
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


def sdpa_call(q, kp, vp, pt, lengths, qpos, scale, window=0, q_head0=0, group=0):
    """The PyTorch yardstick: scaled_dot_product_attention over the gathered
    KV, each query head's kv head (q_head0 / group: as the kernels take
    them) repeated to it (the gather is done once, outside the timed
    call)."""
    import torch.nn.functional as F
    B, C, H, D = q.shape
    ps, Hkv = kp.shape[1], kp.shape[2]
    idx = (q_head0 + torch.arange(H, device=q.device)) // (group or H // Hkv)
    L = pt.shape[1] * ps
    k = kp[pt.long()].reshape(B, L, Hkv, D)[:, :, idx].transpose(1, 2)
    v = vp[pt.long()].reshape(B, L, Hkv, D)[:, :, idx].transpose(1, 2)
    kv = torch.arange(L, device=q.device)
    mask = (kv[None, None] < lengths[:, None, None]) & (kv[None, None] <= qpos[:, :, None])
    if window:
        mask &= kv[None, None] > qpos[:, :, None] - window
    qt = q.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=mask[:, None], scale=scale)


def stack_attention_shapes() -> dict:
    """Phase 8's shapes, bf16 as it serves: its decode sweeps (64 and 32
    slots, the rows at the workload's prompt lengths + 31, their last step)
    and its prefill pack (a first chunk, and the last, partial chunk of the
    longest prompt), over a replica's pool with only the pages a row holds
    in its page table."""
    from repro_torch.data.workload import WorkloadSpec, sample_workload
    plens = [len(p) for p in sample_workload(WorkloadSpec(n_requests=STACK_REQUESTS,
                                                          vocab=32000, seed=0))[0]]
    stack = dict(maxp=-(-STACK_MAX_SEQ // 16), num_pages=STACK_PAGES, used_only=True)
    shapes = {}
    for _, slots in STACK_LAYOUTS:
        shapes[f"stack decode B={slots}"] = dict(
            stack, B=slots, C=1, starts=[n + STACK_NEW - 2 for n in plens[:slots]],
            nvalid=[1] * slots)
    shapes["stack prefill pack"] = dict(stack, **pack_rows(max(plens), *STACK_PACK))
    return shapes


def pack_rows(last: int, rows: int, chunk: int) -> dict:
    """A prefill pack of ``rows`` chunks: first chunks, then the last,
    partial chunk of a prompt of ``last`` tokens."""
    tail = (last - 1) // chunk * chunk
    return dict(B=rows, C=chunk, starts=[0] * (rows - 1) + [tail],
                nvalid=[chunk] * (rows - 1) + [last - tail])


def spec_workload():
    """Phase 9's prompts (the extractive / boilerplate mix; phase 7's
    speculative run serves the first INT8_SPEC_SLOTS) and the max_seq of
    every engine of phases 9 and 7's speculative run."""
    from repro_torch.data.workload import WorkloadSpec, sample_workload
    prompts, _ = sample_workload(WorkloadSpec(
        n_requests=max(SPEC_SLOTS), vocab=32000, extractive_frac=0.5,
        boilerplate_frac=0.5, seed=0))
    return prompts, -(-(max(len(p) for p in prompts) + SPEC_NEW + 1) // 16) * 16


def spec_call_shapes(slots: int) -> list:
    """The (B, C) shapes of ``decode_chunk`` in a phase-9 engine of
    ``slots`` slots, speculation on or off: the decode sweep, the verify
    sweeps at the ladder's widths (every slot a row), the prefill pack."""
    return ([(slots, C) for C in (1,) + VERIFY_WIDTHS]
            + [(min(slots, STACK_PACK[0]), STACK_PACK[1])])


def spec_attention_shapes() -> dict:
    """Phases 9 and 7's speculative shapes, bf16 as they serve: every
    ``spec_call_shapes`` of 1, 8 and 32 slots over the engines' 1024-page
    pool and max_seq, a sweep's rows at the workload's prompt lengths + 31
    (every row feeding C tokens), the pack's last row the last chunk of the
    longest prompt, only a row's own pages in its page table."""
    prompts, max_seq = spec_workload()
    plens = [len(p) for p in prompts]
    pool = dict(maxp=max_seq // 16, num_pages=STACK_PAGES, used_only=True)
    shapes = {}
    for slots in SPEC_SLOTS:
        lens = plens[:slots]
        for B, C in spec_call_shapes(slots):
            rows = (pack_rows(max(lens), B, C) if C == STACK_PACK[1] else
                    dict(B=B, C=C, starts=[n + SPEC_NEW // 2 - C for n in lens],
                         nvalid=[C] * B))
            shapes.setdefault(f"spec B={B} C={C}", dict(pool, **rows))
    return shapes


def mm_attention_shapes() -> dict:
    """Phase 11's chunked attention shapes, bf16 as it serves, over each
    engine's pool (4 slots of max_seq, every row's pages its own; MHA, head
    dim 64 or 96): the decode sweep (the prompts + 31), the prefill pack
    (first chunks, then the last, partial chunk of the longest prompt) and,
    for the VLM, the pack with a patch prefix: 576 + 128 columns a row, a
    later chunk (its queries from its text start, the prefix columns dead)
    beside a first chunk (queries from 0, the prefix live). A VLM row's
    text positions start at 576."""
    shapes = {}
    for name, H, D, off in ((MM_SEAMLESS, 16, 64, 0), (MM_VISION, 32, 96, 576)):
        maxp = MM_MAX_SEQ[name] // 16
        pool = dict(H=H, Hkv=H, D=D, maxp=maxp, num_pages=MM_SLOTS * maxp + 1)
        shapes[f"{name} decode"] = dict(pool, B=MM_SLOTS, C=1,
                                        starts=[off + n + 30 for n in PROMPT_LENS],
                                        nvalid=[1] * MM_SLOTS)
        pack = pack_rows(max(PROMPT_LENS), *STACK_PACK)
        shapes[f"{name} pack"] = dict(pool, **dict(pack, starts=[off + s for s in pack["starts"]]))
        if off:
            C = off + STACK_PACK[1]
            shapes[f"{name} prefixed pack"] = dict(pool, B=2, C=C, starts=[128, 0],
                                                   nvalid=[off + 50, C])
    return shapes


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
                CHECKED["chunked_prefill_attention"].add(attention_key(t[0], t[1], t[3]))
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
    shapes.update(mm_attention_shapes())       # fp32 and bf16 at phase 11's shapes
    # phase 13 (b)'s decode_chunk pack of the prompts, unsharded and on the
    # ranks of tensor 2 and tensor 4 (their heads; pools of 21 pages a row)
    maxp13 = -(-(max(PROMPT_LENS) + GEN_STEPS) // 16)
    for tp, (H, Hkv) in ((1, (32, 8)), (2, (16, 4)), (4, (8, 2))):
        shapes[f"pack tensor {tp}"] = dict(B=4, C=max(PROMPT_LENS), H=H, Hkv=Hkv,
                                           starts=[0] * 4, nvalid=list(PROMPT_LENS),
                                           maxp=maxp13, num_pages=4 * maxp13 + 1)
    # phase 13 (d) / (f)'s packs of DIST_PROMPT-token prompts: unsharded
    # (the parent's runs the ranks are held against), qwen2.5-3b's ranks at
    # tensor 4 (4 heads of a group of 8 over the whole 2-head pool: each
    # rank's q_head0) and jamba's at (1, 2, 2) (16 over 4)
    maxp_d = -(-(DIST_PROMPT + GEN_STEPS) // 16)
    new = dict(B=4, C=DIST_PROMPT, starts=[0] * 4, nvalid=[DIST_PROMPT] * 4, maxp=maxp_d,
               num_pages=4 * maxp_d + 1)
    shapes["pack qwen2.5-3b"] = dict(new, H=16, Hkv=2)
    for h0 in (0, 4, 8, 12):
        shapes[f"pack qwen2.5-3b tensor 4 q_head0 {h0}"] = dict(new, H=4, Hkv=2, fold=(h0, 8))
    shapes["pack jamba"] = dict(new, H=32, Hkv=8)
    shapes["pack jamba (1, 2, 2)"] = dict(new, H=16, Hkv=4)
    # phase 13 (i) / (j)'s mixtral ranks at tensor 4 (8 heads over 2)
    shapes["pack mixtral tensor 4"] = dict(new, H=8, Hkv=2)
    dtypes = {name: (torch.float32, torch.bfloat16) for name in shapes}
    # phase 13 (g) / (h)'s packs, fp32 as they serve: seamless (MHA, head dim
    # 64) unsharded and a rank's 2 rows and 8 heads at (2, 1, 2);
    # phi-3-vision (head dim 96) unsharded and a rank's 8 heads at (1, 1, 4),
    # 576 patches ahead of each prompt
    for arch, D, cuts in ((MM_SEAMLESS, 64, ((4, 16), (2, 8))),
                          (MM_VISION, 96, ((4, 32), (4, 8)))):
        cfg = mm_config(arch, 2)
        maxp = dist_mm_pages(cfg)
        C = (cfg.vision.n_patches if cfg.vision is not None else 0) + DIST_PROMPT
        for B, H in cuts:
            name = f"pack {arch} {H} heads"
            shapes[name] = dict(B=B, C=C, H=H, Hkv=H, D=D, starts=[0] * B, nvalid=[C] * B,
                                maxp=maxp, num_pages=B * maxp + 1)
            dtypes[name] = (torch.float32,)
    served = dict(stack_attention_shapes(), **spec_attention_shapes())
    shapes.update(served)
    dtypes.update({name: (torch.bfloat16,) for name in served})
    # fp32: reduction order only; bf16: one rounding of outputs |o| < 4
    tols = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    for name, sh in shapes.items():
        sh = dict(dict(maxp=32, num_pages=256, H=32, Hkv=8, D=128), **sh)
        for dtype in dtypes[name]:
            *t, kw = attention_case(dev, ps=16, dtype=dtype, seed=1, **sh)
            q, kp, vp, pt, lengths, qpos = t
            fold = {k: kw[k] for k in ("q_head0", "group") if k in kw}
            plan = plan_for(q, kp, pt, **fold)
            out = chunked_prefill_attention(*t, **kw)
            plain = chunked_prefill_reference(*t, **kw)
            err = max_err(out, plain)
            assert err <= tols[dtype], f"attention {name} {dtype}: err {err} > {tols[dtype]}"
            CHECKED["chunked_prefill_attention"].add(attention_key(q, kp, pt, **fold))
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
            library_ms = cuda_ms(sdpa_call(*t, kw["scale"], **fold), flush=flush)
            bms, by = attention_bound(q, kp, lengths, qpos, dtype, kw["window"], **fold)
            row = dict(kernel="chunked_prefill_attention", case=name, dtype=str(dtype)[6:],
                       shape=f"q{tuple(q.shape)} pool{tuple(kp.shape)} "
                             + "".join(f"{k}={v} " for k, v in fold.items()) + "lengths "
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
    # window (cut to 128 to bite at 297 tokens) and attention softcap; then
    # phase 11's calls (MHA): seamless-m4t's encoder over 1024 frames (the
    # engine's 2-row pack, the generation API's 4 prompts), its cross
    # attention against the 1024-frame memory (a pack, a decode sweep, the
    # prefill) and its decoder's prefill; phi-3-vision's prefill of 576
    # patches + 297 tokens
    full = [("prefill", 4, 297, 297, 32, 8, 128, True, 0, 0.0),
            ("prefill window", 4, 297, 297, 32, 16, 128, True, 128, 50.0),
            # phase 13's ranks: the heads of tensor 2 and tensor 4
            ("prefill tensor 2", 4, 297, 297, 16, 4, 128, True, 0, 0.0),
            ("prefill tensor 4", 4, 297, 297, 8, 2, 128, True, 0, 0.0),
            # phase 13 (d) / (f) over DIST_PROMPT tokens: unsharded, qwen2.5-3b's 4
            # heads at tensor 4 with the one kv head they read, jamba's at (1, 2, 2)
            ("qwen2.5-3b prefill", 4, DIST_PROMPT, DIST_PROMPT, 16, 2, 128, True, 0, 0.0),
            ("qwen2.5-3b prefill tensor 4", 4, DIST_PROMPT, DIST_PROMPT, 4, 1, 128, True, 0,
             0.0),
            ("jamba prefill", 4, DIST_PROMPT, DIST_PROMPT, 32, 8, 128, True, 0, 0.0),
            ("jamba prefill (1, 2, 2)", 4, DIST_PROMPT, DIST_PROMPT, 16, 4, 128, True, 0, 0.0),
            # phase 13 (i) / (j)'s mixtral ranks at tensor 4 over DIST_PROMPT tokens
            ("mixtral prefill tensor 4", 4, DIST_PROMPT, DIST_PROMPT, 8, 2, 128, True, 0, 0.0),
            # phase 14 (c)'s ranks: a data rank's 2 rows of 512 tokens,
            # qwen2.5-3b's heads at tensor 2, mixtral's whole at (2, 2, 1)
            ("qwen2.5-3b train tensor 2", 2, 512, 512, 8, 1, 128, True, 0, 0.0),
            ("mixtral train (2, 2, 1)", 2, 512, 512, 32, 8, 128, True, 0, 0.0),
            (f"{MM_SEAMLESS} encoder pack", 2, 1024, 1024, 16, 16, 64, False, 0, 0.0),
            (f"{MM_SEAMLESS} encoder prefill", 4, 1024, 1024, 16, 16, 64, False, 0, 0.0),
            (f"{MM_SEAMLESS} cross pack", 2, 128, 1024, 16, 16, 64, False, 0, 0.0),
            (f"{MM_SEAMLESS} cross decode", 4, 1, 1024, 16, 16, 64, False, 0, 0.0),
            (f"{MM_SEAMLESS} cross prefill", 4, 297, 1024, 16, 16, 64, False, 0, 0.0),
            (f"{MM_SEAMLESS} prefill", 4, 297, 297, 16, 16, 64, True, 0, 0.0),
            (f"{MM_VISION} prefill", 4, 576 + 297, 576 + 297, 32, 32, 96, True, 0, 0.0)]
    for name, B, Sq, Skv, H, Hkv, D, causal, window, softcap in full:
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device=dev).manual_seed(7)
            q = torch.randn((B, Sq, H, D), generator=g, device=dev).to(dtype)
            k, v = (torch.randn((B, Skv, Hkv, D), generator=g, device=dev).to(dtype)
                    for _ in range(2))
            kw = dict(causal=causal, window=window, softcap=softcap, scale=D ** -0.5)
            plan = plan_for(q, k)
            out = flash_attention(q, k, v, **kw)
            plain = mha_reference(q, k, v, **kw)
            err = max_err(out, plain)
            assert err <= tols[dtype], f"flash {name} {dtype}: err {err} > {tols[dtype]}"
            assert torch.equal(out, flash_attention(q, k, v, **kw)), \
                f"flash {name} {dtype}: a repeat gave other bits"
            CHECKED["flash_attention"].add(flash_key(q, k, causal, window, softcap))
            del out, plain
            ms = cuda_ms(lambda: flash_attention_cuda(q, k, v, **kw), flush=flush)
            op_ms = cuda_ms(lambda: flash_attention(q, k, v, **kw), flush=flush, queued=False)
            plain_ms = cuda_ms(lambda: mha_reference(q, k, v, **kw), flush=flush)
            # yardstick: SDPA on K/V repeated to the query heads (made once,
            # outside the timed call), the same mask as a boolean
            G = H // Hkv
            qt = q.transpose(1, 2)
            kt, vt = (t.repeat_interleave(G, 2).transpose(1, 2) for t in (k, v))
            i, j = torch.arange(Sq, device=dev)[:, None], torch.arange(Skv, device=dev)[None]
            mask = None
            if causal or window:
                mask = torch.ones((Sq, Skv), dtype=torch.bool, device=dev)
                mask = mask & (j <= i) if causal else mask
                mask = mask & (j > i - window) if window else mask
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=kw["scale"]), flush=flush)
            bms, by = flash_bound(q, k, dtype, causal=causal, window=window)
            row = dict(kernel="flash_attention", case=name, dtype=str(dtype)[6:],
                       shape=f"q{tuple(q.shape)} kv{tuple(k.shape)} "
                             f"{'causal' if causal else 'not causal'} window={window} "
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


# the flash backward's cases: (name, B, Sq, Skv, H, Hkv, D, causal, window,
# softcap, q_offset). The CPU tests' edge cases (head dims 16 / 64 / 96 /
# 128, G 1 / 4 / 8, window, softcap, q_offset, Sq != Skv, rows with no
# visible key), then the training shapes: phase 12's (qwen2.5-3b and
# mixtral-8x7b at 4 x 512 tokens), seamless-m4t's encoder (not causal, D 64)
# and gemma2-27b's heads with its softcap and a window (cut to 128 to bite
# at 512 tokens)
FLASH_BWD_EDGE = [("edge", 2, 64, 64, 4, 1, 16, True, 0, 0.0, 0),
                  ("edge", 1, 80, 80, 4, 2, 16, True, 16, 30.0, 0),
                  ("edge", 2, 32, 96, 2, 2, 16, True, 0, 0.0, 64),
                  ("edge", 1, 50, 70, 4, 2, 16, False, 0, 0.0, 0),
                  ("edge", 1, 40, 40, 8, 1, 64, True, 8, 0.0, 20),
                  ("edge", 2, 9, 130, 4, 4, 64, False, 0, 0.0, 0),
                  ("edge", 1, 70, 70, 8, 2, 96, True, 0, 0.0, 0),
                  ("edge", 1, 33, 100, 8, 1, 128, True, 0, 20.0, 67)]
# phase 14 (a) / (b)'s fp32 calls, 32 tokens a row, checked like the edge
# cases: qwen2.5-3b's heads whole and at tensor 2, its microbatches, and
# mixtral's, over 4 rows, 2 (a data rank's, a microbatch) and 1
FLASH_BWD_EDGE += [("edge", B, 32, 32, H, Hkv, 128, True, 0, 0.0, 0)
                   for B, H, Hkv in ((4, 16, 2), (2, 16, 2), (2, 8, 1), (1, 8, 1), (4, 32, 8),
                                     (2, 32, 8))]
# phase 14 (d): qwen2.5-3b's microbatch at (1, 1, 4), a rank's 4 query heads
# with the one kv head they read (kv_seq). (e), a microbatch of 2 rows of 32
# tokens, unsharded and a rank's 1 row at (2, 1, 2): seamless's decoder,
# encoder (DIST_FRAMES frames) and cross attention (MHA, head dim 64),
# phi-3-vision's 576 patches + 32 tokens (head dim 96). Phase 13 (g) / (h),
# forward only (checked with the backward here): seamless at (2, 1, 2) (a
# rank's 2 rows) and unsharded, the decoder's prefill of DIST_PROMPT
# tokens, the encoder over DIST_FRAMES frames, the cross attention of
# the prompt and of one token; phi-3-vision's prefill of 576 patches +
# DIST_PROMPT tokens at (1, 1, 4) and unsharded
FLASH_BWD_EDGE += [("edge", 2, 32, 32, 4, 1, 128, True, 0, 0.0, 0)]
FLASH_BWD_EDGE += [("edge", B, Sq, Skv, H, H, 64, causal, 0, 0.0, 0)
                   for B, H in ((2, 16), (1, 8))
                   for Sq, Skv, causal in ((32, 32, True), (DIST_FRAMES, DIST_FRAMES, False),
                                           (32, DIST_FRAMES, False))]
FLASH_BWD_EDGE += [("edge", B, 576 + 32, 576 + 32, H, H, 96, True, 0, 0.0, 0)
                   for B, H in ((2, 32), (1, 16))]
FLASH_BWD_EDGE += [("edge", B, Sq, Skv, H, H, 64, causal, 0, 0.0, 0)
                   for B, H in ((4, 16), (2, 8))
                   for Sq, Skv, causal in ((DIST_PROMPT, DIST_PROMPT, True),
                                           (DIST_FRAMES, DIST_FRAMES, False),
                                           (DIST_PROMPT, DIST_FRAMES, False),
                                           (1, DIST_FRAMES, False))]
FLASH_BWD_EDGE += [("edge", 4, 576 + DIST_PROMPT, 576 + DIST_PROMPT, H, H, 96, True, 0, 0.0, 0)
                   for H in (32, 8)]
FLASH_BWD_FULL = [("qwen2.5-3b train", 4, 512, 512, 16, 2, 128, True, 0, 0.0, 0),
                  ("mixtral train", 4, 512, 512, 32, 8, 128, True, 0, 0.0, 0),
                  # phase 14 (c)'s ranks (run_flash's rows of the same names)
                  ("qwen2.5-3b train tensor 2", 2, 512, 512, 8, 1, 128, True, 0, 0.0, 0),
                  ("mixtral train (2, 2, 1)", 2, 512, 512, 32, 8, 128, True, 0, 0.0, 0),
                  (f"{MM_SEAMLESS} encoder", 2, 1024, 1024, 16, 16, 64, False, 0, 0.0, 0),
                  ("gemma2-27b window softcap", 4, 512, 512, 32, 16, 128, True, 128, 50.0, 0)]
FLASH_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}   # relative to max |plain grad|
# the bf16 (mma) path at the training shapes: P and dS as hi + lo parts keep
# it near fp32 (PR 24's tiled path: 2.5e-3), so a tighter gate than the
# bf16 one above
FLASH_BWD_FULL_BF16_TOL = 1e-2
LSE_TOL = 1e-4                                                 # absolute, natural-log units


def flash_bwd_bound(q, k, dtype, *, causal, window, q_offset=0):
    """Bytes: q, k, v, out, dO and lse read once, dq, dk and dv written once
    (four q-sized tensors, four k-sized ones and the fp32 lse). Operations:
    2.5 times the forward's 4*D per visible (query head, key) pair."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    qpos = torch.arange(Sq, dtype=torch.int64) + q_offset
    hi = torch.clamp(qpos + 1, max=Skv) if causal else torch.full_like(qpos, Skv)
    lo = (qpos - window + 1).clamp_min(0) if window else torch.zeros_like(qpos)
    pairs = B * H * (hi - lo).clamp_min(0).sum().item()
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() + 4 * B * H * Sq
    return bound_ms(nbytes, 2.5 * 4.0 * D * pairs, dtype)


def run_flash_bwd(dev, flush, results):
    """Phase 2 for the flash backward: each case's forward (with its row
    logsumexp) against mha_reference / mha_reference_lse, then the backward
    kernel against mha_reference_bwd on the same (q, k, v, out, dO, lse),
    called twice for bit-equal results; at the training shapes its time
    beside the plain version's, SDPA's backward on K/V repeated to the query
    heads (timed only) and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda, mha_reference,
                                                     mha_reference_bwd, mha_reference_lse)
    from repro_torch.kernels.flash_attention.kernel import bwd_plan
    fwd_tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}    # run_flash's
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, B, Sq, Skv, H, Hkv, D, causal, window, softcap, qoff in (FLASH_BWD_EDGE
                                                                       + FLASH_BWD_FULL):
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device=dev).manual_seed(Sq + Skv + D)
            q, do = (torch.randn((B, Sq, H, D), generator=g, device=dev).to(dtype)
                     for _ in range(2))
            k, v = (torch.randn((B, Skv, Hkv, D), generator=g, device=dev).to(dtype)
                    for _ in range(2))
            kw = dict(causal=causal, window=window, softcap=softcap, q_offset=qoff,
                      scale=D ** -0.5)
            out, lse = flash_attention_cuda(q, k, v, lse=True, **kw)
            fwd_err = max_err(out, mha_reference(q, k, v, **kw))
            plse = mha_reference_lse(q, k, **kw)
            live = torch.isfinite(plse)
            assert torch.equal(live, torch.isfinite(lse)), f"flash bwd {name}: lse's -inf rows"
            lse_err = max_err(lse[live], plse[live]) if live.any() else 0.0
            assert fwd_err <= fwd_tol[dtype] and lse_err <= LSE_TOL, \
                f"flash bwd {name} {dtype}: forward err {fwd_err}, lse err {lse_err}"
            grads = flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw)
            plain = mha_reference_bwd(q, k, v, out, do, lse, **kw)
            abs_err = max(max_err(a, b) for a, b in zip(grads, plain))
            errs = [max_err(a, b) / max(float(b.float().abs().max()), 1e-30)
                    for a, b in zip(grads, plain)]
            tol = (FLASH_BWD_FULL_BF16_TOL if name != "edge" and dtype == torch.bfloat16
                   else FLASH_BWD_TOL[dtype])
            assert all(torch.isfinite(t).all() for t in grads) and max(errs) <= tol, \
                f"flash bwd {name} {(B, Sq, Skv, H, Hkv, D)} {kw} {dtype}: rel errs {errs}"
            dead = ~live[:, 0]                  # (B, Sq): a row's heads see the same keys
            assert not grads[0][dead].any(), f"flash bwd {name} {dtype}: a row that sees no " \
                                             f"key got a nonzero dq"
            again = flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw)
            assert all(torch.equal(a, b) for a, b in zip(grads, again)), \
                f"flash bwd {name} {dtype}: a repeat gave other bits"
            key = flash_key(q, k, causal, window, softcap)
            CHECKED["flash_attention"].add(key)
            CHECKED["flash_attention_bwd"].add(key)
            del grads, plain, again
            shape = (f"q{tuple(q.shape)} kv{tuple(k.shape)} "
                     f"{'causal' if causal else 'not causal'} window={window} "
                     f"softcap={softcap} q_offset={qoff}")
            plan = bwd_plan(B, Sq, Skv, H, Hkv, D, dtype, n_sm)
            assert plan["path"] == ("mma" if dtype == torch.bfloat16 else "tiled"), plan
            where = (f"{plan['path']}, splits {plan['splits']}, grids "
                     f"{ {k_: list(g_) for k_, g_ in plan['grids'].items()} }")
            if name == "edge":
                log(f"  flash bwd edge {shape} {str(dtype)[6:]} ({where}): rel errs "
                    f"dq {errs[0]:.3g} dk {errs[1]:.3g} dv {errs[2]:.3g} (tol {tol}), lse err "
                    f"{lse_err:.3g}, {int(dead.sum())} rows see no key, repeat bit-equal")
                continue
            ms = cuda_ms(lambda: flash_attention_bwd_cuda(q, k, v, out, do, lse, **kw),
                         flush=flush)
            plain_ms = cuda_ms(lambda: mha_reference_bwd(q, k, v, out, do, lse, **kw),
                               flush=flush)
            # yardstick: SDPA's backward on K/V repeated to the query heads
            # (the forward run once, outside the timed call)
            G = H // Hkv
            qt = q.transpose(1, 2).detach().requires_grad_()
            kt, vt = (t.repeat_interleave(G, 2).transpose(1, 2).detach().requires_grad_()
                      for t in (k, v))
            mask = None
            if window:
                i, j = torch.arange(Sq, device=dev)[:, None], torch.arange(Skv, device=dev)[None]
                mask = (j <= i) & (j > i - window)
            o_sdpa = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                    is_causal=causal and mask is None,
                                                    scale=kw["scale"])
            do_t = do.transpose(1, 2)
            library_ms = cuda_ms(lambda: torch.autograd.grad(o_sdpa, (qt, kt, vt), do_t,
                                                             retain_graph=True), flush=flush)
            bms, by = flash_bwd_bound(q, k, dtype, causal=causal, window=window, q_offset=qoff)
            row = dict(kernel="flash_attention_bwd", case=name, dtype=str(dtype)[6:],
                       shape=shape, path=plan["path"], splits=plan["splits"],
                       grids=plan["grids"],
                       max_abs_err=abs_err, rel_errs=errs, lse_err=lse_err, ms=ms,
                       plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=bms, bound_by=by)
            results.append(row)
            log(f"  flash bwd {name} {row['dtype']} {shape} ({where}): "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
                f"bound_ms={bms:.6f} ({by}) rel errs dq {errs[0]:.3g} dk {errs[1]:.3g} "
                f"dv {errs[2]:.3g} (tol {tol}), lse err {lse_err:.3g}, repeat bit-equal")
            del q, k, v, do, out, lse, qt, kt, vt, o_sdpa, do_t
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
    # shape), and the same with a window and softcap; then phase 11's
    # generation paths (MHA, head dims 64 and 96; the VLM's positions after
    # its 576 patches), their last step over pools of 4 x ceil((prefix + 297
    # + 32) / 16) pages
    mix = dict(H=32, Hkv=8, D=128, maxp=32, num_pages=256, starts=[131, 219, 299, 166])
    mm = {name: dict(H=H, Hkv=H, D=D, maxp=maxp, num_pages=4 * maxp + 1,
                     starts=[off + n + GEN_STEPS - 2 for n in PROMPT_LENS])
          for name, H, D, off in ((MM_SEAMLESS, 16, 64, 0), (MM_VISION, 32, 96, 576))
          for maxp in [-(-(off + max(PROMPT_LENS) + GEN_STEPS) // 16)]}
    # phase 13's ranks: the heads of tensor 2 and tensor 4 over the
    # generation path's pool
    maxp13 = -(-(max(PROMPT_LENS) + GEN_STEPS) // 16)
    tps = {f"decode tensor {tp}": dict(H=H, Hkv=Hkv, D=128, maxp=maxp13, num_pages=4 * maxp13 + 1,
                                       starts=[n + GEN_STEPS - 2 for n in PROMPT_LENS])
           for tp, H, Hkv in ((2, 16, 4), (4, 8, 2))}
    # phase 13 (d)'s ranks: qwen2.5-3b's 4 heads of a group of 8 at tensor
    # 4 over the whole 2-head pool (each rank's q_head0), its last paged step
    maxp_d = -(-(DIST_PROMPT + GEN_STEPS) // 16)
    for h0 in (0, 4, 8, 12):
        tps[f"decode qwen2.5-3b tensor 4 q_head0 {h0}"] = dict(
            H=4, Hkv=2, D=128, maxp=maxp_d, num_pages=4 * maxp_d + 1, fold=(h0, 8),
            starts=[DIST_PROMPT + DIST_RING_STEPS + DIST_STEPS - 1] * 4)
    for name, window, softcap, sh in (("decode", 0, 0.0, mix), ("decode window", 128, 50.0, mix),
                                      *((n, 0, 0.0, sh) for n, sh in tps.items()),
                                      *((f"{n} decode", 0, 0.0, sh) for n, sh in mm.items())):
        for dtype in (torch.float32, torch.bfloat16):
            *t, kw = attention_case(dev, B=4, C=1, ps=16, nvalid=[1, 1, 1, 1], dtype=dtype,
                                    window=window, softcap=softcap, seed=1, **sh)
            q4, kp, vp, pt, lengths, qpos = t
            q = q4[:, 0].contiguous()
            fold = {k: kw[k] for k in ("q_head0", "group") if k in kw}
            plan = plan_for(q4, kp, pt, **fold)
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
            library_ms = cuda_ms(sdpa_call(q4, kp, vp, pt, lengths, qpos, kw["scale"], window,
                                           **fold), flush=flush)
            bms, by = attention_bound(q4, kp, lengths, qpos, dtype, window, **fold)
            row = dict(kernel="paged_attention", case=name, dtype=str(dtype)[6:],
                       shape=f"q{tuple(q.shape)} pool{tuple(kp.shape)} "
                             + "".join(f"{k}={v} " for k, v in fold.items()) + "lengths "
                             f"{lengths.tolist()} window={window} softcap={softcap}",
                       path=plan.path, splits=plan.splits, grid=list(plan.grid),
                       max_abs_err=err, ms=ms, op_ms=op_ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=bms, bound_by=by)
            results.append(row)
            log(f"  paged {name} {row['dtype']} path={plan.path} splits={plan.splits} "
                f"grid={plan.grid}: kernel_ms={ms:.4f} op_ms={op_ms:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} bound_ms={bms:.6f} "
                f"({by}) max_abs_err={err:.3g}, repeat bit-equal")


def gmm_case(dev, *, tokens, E, K, N, dtype, seed=0, top_k=2):
    """Rows of ``tokens`` tokens routed top-k by a random router, sorted by
    expert; weights scaled like the model's LeCun init (outputs ~ N(0,1))."""
    g = torch.Generator(device=dev).manual_seed(seed)
    logits = torch.randn((tokens, E), generator=g, device=dev)
    e = torch.topk(logits, top_k, dim=-1).indices.reshape(-1)
    order = torch.argsort(e, stable=True)
    gs = torch.bincount(e, minlength=E)
    x = torch.randn((top_k * tokens, K), generator=g, device=dev)[order].to(dtype)
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
                CHECKED["moe_gmm"].add(gmm_key(x.shape[0], K, N, dtype, wk is not w))
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
    # the other token counts of the bf16 main paths (a call routes B * C
    # tokens, a row's padded positions too): phase 8's decode sweeps (64
    # and 32 slots), phase 9's decode_chunk calls at 1 / 8 / 32 slots, the
    # generation API's prefill (4 prompts padded to the longest: phases 5
    # and 7); on int8 experts phase 7's speculative run and its prefill
    gen = len(PROMPT_LENS) * max(PROMPT_LENS)
    spec = {B * C for slots in SPEC_SLOTS for B, C in spec_call_shapes(slots)}
    int8_spec = {B * C for B, C in spec_call_shapes(INT8_SPEC_SLOTS)}
    served = ({(T, False) for T in spec | {slots for _, slots in STACK_LAYOUTS} | {gen}}
              | {(T, True) for T in int8_spec | {gen}})
    for tokens, int8 in sorted(served - {(T, i) for T in (4, 8, 256) for i in (False, True)}):
        for K, N in ((4096, 14336), (14336, 4096)):
            run_gmm_case(dev, flush, results, tokens=tokens, K=K, N=N, dtype=torch.bfloat16,
                         int8=int8, tol=tols[int8, torch.bfloat16])
    # deepseek-moe-16b's routed experts (64 of width 1408, top-6), the MoE
    # phase 3 runs on the card: 2 tokens (12 rows: stream) and a 256-token
    # prefill (1536 rows: mma / tiled)
    for tokens in (2, 256):
        for K, N in ((2048, 1408), (1408, 2048)):
            for dtype in (torch.float32, torch.bfloat16):
                run_gmm_case(dev, flush, results, tokens=tokens, K=K, N=N, dtype=dtype,
                             int8=False, tol=tols[False, dtype], E=64, top_k=6)
    # phase 13 (i)'s ranks: their int8 experts over the capacity buffers,
    # each expert's cap rows one group, in the dtype each mesh serves
    for rows, K, N, dtype, E in sorted(dist_int8_shapes()["gmm"], key=str):
        run_gmm_case(dev, flush, results, tokens=0, K=K, N=N, dtype=dtype, int8=True,
                     tol=tols[True, dtype], E=E, buffers=rows // E)
    # phase 15's rank 0 of (16, 16): its int8 experts' capacity buffers
    for rows, K, N, E in sorted(dryrun_shapes()["gmm"]):
        run_gmm_case(dev, flush, results, tokens=0, K=K, N=N, dtype=torch.bfloat16, int8=True,
                     tol=tols[True, torch.bfloat16], E=E, buffers=rows // E)


def run_gmm_case(dev, flush, results, *, tokens, K, N, dtype, int8, tol, E=8, top_k=2,
                 buffers=0):
    """One grouped matmul case: ``tokens`` routed top-k, or with
    ``buffers`` every expert's capacity buffer of that many rows a group
    (the shard_map strategies' layout)."""
    from repro_torch.kernels.moe_gmm import gmm, gmm_reference, gmm_tiles_cuda, tile_layout
    from repro_torch.kernels.moe_gmm.kernel import block_m_for, plan_for
    from repro_torch.quant import quantize_leaf
    if buffers:
        g = torch.Generator(device=dev).manual_seed(buffers)
        x = torch.randn((E * buffers, K), generator=g, device=dev).to(dtype)
        w = (torch.randn((E, K, N), generator=g, device=dev) * K ** -0.5).to(dtype)
        gs = torch.full((E,), buffers, dtype=torch.int64, device=dev)
    else:
        x, w, gs = gmm_case(dev, tokens=tokens, E=E, K=K, N=N, dtype=dtype, seed=tokens,
                            top_k=top_k)
    wk = quantize_leaf(w) if int8 else w
    M = x.shape[0]
    out = gmm(x, wk, gs)
    err = max_err(out, gmm_reference(x, wk, gs))
    kind = " int8" if int8 else ""
    assert err <= tol, f"gmm{kind} {tokens} tok {K}->{N} {dtype}: err {err}"
    CHECKED["moe_gmm"].add(gmm_key(M, K, N, dtype, int8))
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
    parts = [(i, int(bounds[i]), int(bounds[i + 1])) for i in range(E)
             if bounds[i + 1] > bounds[i]]
    # one matmul an active expert: past 16 of them the host's dispatch
    # outruns the queue, so each call is timed alone
    if buffers:        # one batched matmul over the buffers, as the float experts run
        lib_ms = cuda_ms(lambda: torch.bmm(x.view(E, buffers, K), w), flush=flush)
    else:
        lib_ms = cuda_ms(lambda: [torch.matmul(x[a:b], w[i]) for i, a, b in parts], flush=flush,
                         queued=len(parts) <= 16)
    active = len(parts)
    es = x.element_size()
    wbytes = active * K * (N + 4) if int8 else active * K * N * es
    nbytes = (M * K + M * N) * es + wbytes + gs.numel() * gs.element_size()
    bms, by = bound_ms(nbytes, 2.0 * M * K * N, dtype)
    experts = f" E{E}" if E != 8 else ""
    case = (f"rank buffers {E}x{buffers} {K}->{N}{kind}" if buffers else
            f"{tokens}tok {K}->{N}{kind}{experts}")
    routing = f"{E} buffers of {buffers} rows" if buffers else f"top-{top_k}"
    row = dict(kernel="moe_gmm", case=case, dtype=str(dtype)[6:],
               shape=f"x({M},{K}) w({E},{K},{N}){kind} {routing} experts_active={active}",
               path=plan.path, splits=plan.splits, grid=list(plan.grid),
               max_abs_err=err, ms=ms, op_ms=op_ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=bms, bound_by=by)
    results.append(row)
    log(f"  gmm{kind} {case} {routing} K={K} N={N} {row['dtype']} "
        f"path={plan.path} "
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
            CHECKED["w8a16_matmul"].add(w8a16_key(x, q, col, row))
            assert torch.equal(out, w8a16_matmul(x, q, col, row_scale=row)), \
                f"w8a16 edge case {M}x{K}x{N} {form} {dtype}: a repeat gave other bits"
            log(f"  w8a16 edge M={M} K={K} N={N} {form} {str(dtype)[6:]} "
                f"({plan_for(x, q).path}): max_abs_err={err:.3g} (tol {tols[dtype]})")
    # full-width mixtral shapes: at decode (4 rows) wq (row scale per head of
    # 128), wk / wv (8 heads of 128), wo (one scale per input row) and the
    # head (lm_head (4096, 32000), one per row); wq over a prefill pack of
    # 256 rows. Then, bf16 as it serves, phase 7's other row counts: the
    # projections at its speculative run's B * C rows (decode and verify
    # sweeps of 8 slots, the pack) and at the generation API's prefill (4
    # prompts padded to the longest), the head at the sweeps' B * C rows
    # and at the pack's B (its rows' last positions)
    proj = (("wq", 4096, 32), ("wk", 1024, 8), ("wo", 4096, 1))
    both = (torch.float32, torch.bfloat16)
    cases = [(f"decode {n}", 4, N, G, both) for n, N, G in proj + (("head", 32000, 1),)]
    cases.append(("prefill wq", 256, 4096, 32, both))
    shapes = spec_call_shapes(INT8_SPEC_SLOTS)
    rows = {B * C for B, C in shapes} | {len(PROMPT_LENS) * max(PROMPT_LENS)}
    head_rows = {B if C == STACK_PACK[1] else B * C for B, C in shapes}
    cases += [(f"{n} M={M}", M, N, G, (torch.bfloat16,)) for M in sorted(rows)
              for n, N, G in proj if (n, M) != ("wq", 256)]
    cases += [(f"head M={M}", M, 32000, 1, (torch.bfloat16,)) for M in sorted(head_rows)]
    # phase 13 (i)'s ranks: the int8 tree's projections and head at a rank's
    # heads and vocab columns, in the dtype each mesh serves
    cases += [(f"rank {str(dtype)[6:]} K={K} N={N} M={M}", M, N, G, (dtype,), K)
              for M, K, N, G, dtype in sorted(dist_int8_shapes()["w8a16"], key=str)]
    # phase 15's rank 0 of (16, 16): its projections, kv heads and head
    cases += [(f"dryrun K={K} N={N} M={M}", M, N, G, (torch.bfloat16,), K)
              for M, K, N, G in sorted(dryrun_shapes()["w8a16"])]
    for name, M, N, G, dtypes, *k in cases:
        K = k[0] if k else 4096
        for dtype in dtypes:
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
            CHECKED["w8a16_matmul"].add(w8a16_key(x, q, None, row))
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
    # phase 6's generation API: each prompt prefilled alone at its own
    # length from the cache's state
    for L in PROMPT_LENS:
        x, dt, A, Bm, Cm, s0 = ssd_case(dev, B=1, L=L, H=64, P=64, N=128, G=1,
                                        dtype=torch.bfloat16, init=True, seed=L)
        y, s = ssd_chunked(x, dt, A, Bm, Cm, 256, init_state=s0)
        Br, Cr = Bm.expand(-1, -1, 64, -1), Cm.expand(-1, -1, 64, -1)
        y_ref, s_ref = ssd_reference(x, dt, A, Br, Cr, 256, init_state=s0)
        err = max(max_err(y, y_ref), max_err(s, s_ref))
        y2, s2 = ssd_chunked(x, dt, A, Bm, Cm, 256, init_state=s0)
        assert err <= 2e-3 and torch.equal(y, y2) and torch.equal(s, s2), \
            f"ssd generation prefill L={L}: err {err} or a repeat differs"
        CHECKED["ssd_scan"].add(ssd_key(x, Bm, s0 is not None))
        log(f"  ssd mamba2 generation prefill x{tuple(x.shape)} init_state=True bfloat16: "
            f"max_abs_err {err:.3g}, repeat bit-equal")
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
                                nvalid=[128, 100])),
            # phase 13 (e) / (f): the prefill and the pack of DIST_PROMPT-token
            # prompts (from a state), unsharded and at the ranks' mamba2 64 / 4
            # heads and jamba 128 / 2
            ("mamba2 4 prompts", dict(B=4, L=DIST_PROMPT, H=64, P=64, N=128, G=1, init=True)),
            ("mamba2 tensor 4", dict(B=4, L=DIST_PROMPT, H=16, P=64, N=128, G=1, init=True)),
            ("jamba 4 prompts", dict(B=4, L=DIST_PROMPT, H=128, P=64, N=16, G=1, init=True)),
            ("jamba tensor 2", dict(B=4, L=DIST_PROMPT, H=64, P=64, N=16, G=1, init=True))):
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
            CHECKED["ssd_scan"].add(ssd_key(x, Bm, s0 is not None))
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


# the SSD backward's cases: (name, B, L, H, P, N, G, init, nvalid, d_final).
# run_ssd's edge cases (ragged L, P 3 / N 4, groups, a carried state, a
# padded row), some with a gradient into the final state, then the
# training shapes: mamba2-1.3b's and jamba's SSD layers at phase 12's 4 x
# 512 tokens
SSD_BWD_EDGE = [("edge", 2, 32, 3, 8, 4, 3, False, None, False),
                ("edge", 1, 24, 2, 16, 8, 2, False, None, True),
                ("edge", 2, 27, 2, 8, 4, 2, False, None, False),
                ("edge", 2, 17, 3, 4, 5, 3, True, None, True),
                ("edge", 1, 16, 2, 3, 4, 2, True, None, False),
                ("edge", 2, 40, 8, 16, 16, 1, True, [40, 13], True),
                ("edge", 2, 150, 4, 64, 128, 2, True, [150, 70], True),
                # phase 14 (d)'s fp32 calls, 32 tokens a row: mamba2-1.3b
                # unsharded (a microbatch of 2 rows) and its heads at tensor 2;
                # jamba unsharded (4 rows) and its heads at (1, 2, 2)
                ("edge", 2, 32, 64, 64, 128, 1, False, None, False),
                ("edge", 2, 32, 32, 64, 128, 1, False, None, False),
                ("edge", 4, 32, 128, 64, 16, 1, False, None, False),
                ("edge", 4, 32, 64, 64, 16, 1, False, None, False)]
SSD_BWD_FULL = [("mamba2 train", 4, 512, 64, 64, 128, 1, False, None, False),
                ("jamba train", 4, 512, 128, 64, 16, 1, False, None, False)]
# relative to each gradient's max |plain grad|: the kernel's math is fp32
# for both dtypes; dx, dB and dC come back in bf16 for bf16 inputs, so
# there each element may also differ by its own rounding (2^-8 |g|)
SSD_BWD_TOL = 1e-4
BF16_ROUNDING = 2.0 ** -8


def ssd_bwd_bound(x, Bm, init, dtype):
    """Bytes: x, dt, A, B, C, the tiles' entry states, dy and (with a
    carried state) d_final read once; dx, ddt, dA, dB, dC and d_init written
    once. Operations: per (row, head) and tile of n tokens, (6N + 4P) per
    causal pair (C.B, dy.x, dx, dC and dB) and 8NP per token (dS' B, S^T dy,
    dS'^T x and the carried gradient), plus 2NP for <dS', S>."""
    B, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    es = x.element_size()
    tiles = [min(64, L - t0) for t0 in range(0, L, 64)]
    nbytes = (2 * B * L * H * P * es + 2 * B * L * H * 4 + 2 * H * 4 + 4 * B * L * G * N * es
              + len(tiles) * B * H * P * N * 4 + B * L * H * P * 4
              + (2 * B * H * P * N * 4 if init else 0))
    flops = B * H * sum(n * (n + 1) / 2 * (6 * N + 4 * P) + 8 * n * N * P + 2 * N * P
                        for n in tiles)
    return bound_ms(nbytes, flops, dtype)


def run_ssd_bwd(dev, flush, results):
    """Phase 2 for the SSD backward: each case's forward with its tiles'
    entry states (y and the states against ssd_reference at 64-token
    chunks, y bit-equal to the serving call's), then ssd_scan_bwd_cuda
    against ssd_reference_bwd on the same inputs, states and cotangents,
    each gradient relative to its max |plain grad|, called twice for
    bit-equal results, on the path its plan names (fp32 tiled, bf16 mma);
    at the training shapes its time (the wrapper's partial sums included,
    and timed apart) beside the plain version's and the bound."""
    from repro_torch.kernels.ssd_scan import (ssd_reference, ssd_reference_bwd,
                                              ssd_scan_bwd_cuda, ssd_scan_cuda)
    from repro_torch.kernels.ssd_scan.kernel import bwd_plan_for, bwd_sums
    names = ("dx", "ddt", "dA", "dB", "dC", "d_init")
    for name, B, L, H, P, N, G, init, nvalid, dfin in SSD_BWD_EDGE + SSD_BWD_FULL:
        for dtype in (torch.float32, torch.bfloat16):
            x, dt, A, Bm, Cm, s0 = ssd_case(dev, B=B, L=L, H=H, P=P, N=N, G=G, dtype=dtype,
                                            init=init, nvalid=nvalid, seed=L + P)
            g = torch.Generator(device=dev).manual_seed(L + N)
            dy = torch.randn((B, L, H, P), generator=g, device=dev)
            d_final = torch.randn((B, H, P, N), generator=g, device=dev) if dfin else None
            y, fin, st = ssd_scan_cuda(x, dt, A, Bm, Cm, init_state=s0, states=True)
            y_serve, _ = ssd_scan_cuda(x, dt, A, Bm, Cm, init_state=s0)
            assert torch.equal(y, y_serve), f"ssd bwd {name}: writing the states changed y"
            rep = H // G
            Br, Cr = Bm.repeat_interleave(rep, 2), Cm.repeat_interleave(rep, 2)
            y_ref, _, st_ref = ssd_reference(x, dt, A, Br, Cr, 64, init_state=s0, states=True)
            fwd_err = max(max_err(y, y_ref), max_err(st, st_ref))
            # run_ssd's bound at 64-token chunks: fp32 math, reduction order only
            assert fwd_err <= 2e-3, f"ssd bwd {name} {dtype}: forward / states err {fwd_err}"
            del y, y_serve, y_ref, st_ref, Br, Cr
            args = (x, dt, A, Bm, Cm, st, dy, d_final)
            plan = bwd_plan_for(x, Bm)
            want_path = "mma" if dtype == torch.bfloat16 else "tiled"
            assert plan["path"] == want_path, f"ssd bwd {name} {dtype}: plan {plan}"
            n0 = ssd_scan_bwd_cuda.launches_by_path[want_path]
            grads = ssd_scan_bwd_cuda(*args, need_init=init)
            assert ssd_scan_bwd_cuda.launches_by_path[want_path] == n0 + 1, \
                f"ssd bwd {name} {dtype}: not launched on {want_path}"
            plain = ssd_reference_bwd(x, dt, A, Bm, Cm, s0, st, dy, d_final)
            errs, abs_err = {}, 0.0
            for k, a, b in zip(names, grads, plain):
                if b is None:
                    assert a is None, f"ssd bwd {name}: {k} without an initial state"
                    continue
                assert a.shape == b.shape and torch.isfinite(a).all(), f"ssd bwd {name}: {k}"
                want = torch.float32 if k in ("ddt", "dA", "d_init") else dtype
                assert a.dtype == want, f"ssd bwd {name}: {k} is {a.dtype}, expected {want}"
                diff = (a.float() - b).abs()
                abs_err = max(abs_err, float(diff.max()))
                if a.dtype == torch.bfloat16:
                    diff = (diff - BF16_ROUNDING * b.abs()).clamp_min(0)
                errs[k] = float(diff.max()) / max(float(b.abs().max()), 1e-30)
            assert max(errs.values()) <= SSD_BWD_TOL, \
                f"ssd bwd {name} {(B, L, H, P, N, G)} {dtype}: rel errs {errs}"
            again = ssd_scan_bwd_cuda(*args, need_init=init)
            assert all(a is None and b is None or torch.equal(a, b)
                       for a, b in zip(grads, again)), f"ssd bwd {name} {dtype}: repeat differs"
            del grads, plain, again
            where = (f"{plan['path']}, hb {plan['hb']}, grid {list(plan['grid'])}, "
                     f"{plan['threads']} threads, {plan['tiles']} tiles, {plan['smem']} B shared, "
                     f"dB / dC partials {list(plan['partials']['dB'])}, "
                     f"{plan['group_sum']} a group summed")
            shape = (f"x{tuple(x.shape)} B/C{tuple(Bm.shape)} init_state={init} "
                     f"nvalid={nvalid} d_final={dfin}")
            rel = " ".join(f"{k} {v:.3g}" for k, v in errs.items())
            key = ssd_key(x, Bm, s0 is not None)
            CHECKED["ssd_scan"].add(key)
            CHECKED["ssd_scan_bwd"].add(key)
            if name == "edge":
                log(f"  ssd bwd edge {shape} {str(dtype)[6:]} ({where}): forward / states err "
                    f"{fwd_err:.3g}, rel errs {rel} (tol {SSD_BWD_TOL}), repeat bit-equal")
                continue
            ms = cuda_ms(lambda: ssd_scan_bwd_cuda(*args, need_init=init), flush=flush)
            # the wrapper's fixed-order sums alone, on partials of the plan's shapes
            parts = [torch.randn(plan["partials"][k], device=dev) for k in ("dB", "dC", "dA")]
            sum_ms = cuda_ms(lambda: bwd_sums(plan, *parts, dtype), flush=flush)
            del parts
            # the plain version's many small ops outrun the queue: each call timed alone
            plain_ms = cuda_ms(lambda: ssd_reference_bwd(x, dt, A, Bm, Cm, s0, st, dy, d_final),
                               flush=flush, queued=False)
            bms, by = ssd_bwd_bound(x, Bm, init, dtype)
            row = dict(kernel="ssd_scan_bwd", case=name, dtype=str(dtype)[6:], shape=shape,
                       path=plan["path"], hb=plan["hb"], grid=plan["grid"],
                       max_abs_err=abs_err, rel_errs=errs, fwd_err=fwd_err, ms=ms,
                       sum_ms=sum_ms, plain_ms=plain_ms, library_ms=None, bound_ms=bms,
                       bound_by=by)
            results.append(row)
            log(f"  ssd bwd {name} {row['dtype']} {shape} ({where}): kernel_ms={ms:.4f} "
                f"(of which the wrapper's partial sums {sum_ms:.4f}) "
                f"plain_ms={plain_ms:.4f} library_ms=none (no single PyTorch call) "
                f"bound_ms={bms:.6f} ({by}) rel errs {rel} (tol {SSD_BWD_TOL}), forward / states "
                f"err {fwd_err:.3g}, repeat bit-equal")
            del x, Bm, Cm, dy, st, args
            torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 3/4
def depth_cut(cfg, n_layers: int):
    """``cfg`` cut to its first ``n_layers`` layers, each keeping its kind
    and its MoE mark (deepseek's dense first layer, jamba's mamba layers);
    ``cfg`` itself at its full depth."""
    from repro_torch.configs import LayerGroup
    if n_layers == cfg.n_layers:
        return cfg
    groups, left = [], n_layers
    for g in cfg.layer_groups:
        if left <= 0:
            break
        reps = min(g.repeats, left // len(g.pattern))
        if reps:
            groups.append(LayerGroup(g.pattern, reps, g.moe_mask))
            left -= reps * len(g.pattern)
        if 0 < left < len(g.pattern) and reps < g.repeats:
            groups.append(LayerGroup(g.pattern[:left], 1,
                                     g.moe_mask[:left] if g.moe_mask else None))
            left = 0
    return cfg.scaled(name=f"{cfg.name}-{n_layers}L", n_layers=n_layers,
                      layer_groups=tuple(groups))


def mixtral(n_layers: int):
    from repro_torch.configs import get_config
    return depth_cut(get_config("mixtral-8x7b"), n_layers)


def fill_pool_from_ring(paged, dense, pt, ps):
    """Copy each row's ring buffer (slot == position: the ring is at least
    as long as the sequence) into its pages pt[b, :W // ps], and an SSM
    layer's state and conv row for row."""
    for pg, dg in zip(paged["groups"], dense["groups"]):
        for pc, dc in zip(pg, dg):
            if "ssm" in dc:
                for name in ("state", "conv"):
                    pc["ssm"][name].copy_(dc["ssm"][name])
                continue
            for pool, ring in (("kp", "k"), ("vp", "v")):
                src = dc["attn"][ring]                               # (R, B, W, Hkv, hd)
                R, B, W = src.shape[:3]
                for b in range(B):
                    pc["attn"][pool][:, pt[b, :W // ps].long()] = (
                        src[:, b].reshape(R, W // ps, ps, *src.shape[3:]))


def run_card_vs_cpu(dev, int8: bool = False):
    """Every model path at depth 2, full width, fp32, on the card, against
    ``forward`` on the CPU from the same weights and tokens at the same
    positions (the CPU runs ``forward`` alone: its other paths equal its
    forward within LOGIT_ATOL by the CPU tests, and running each of them on
    the CPU took most of phase 3), and against the card's own ``forward``:
    returns the worst card-vs-CPU and cross-path logit differences. With
    ``int8`` the weights are quantize_params_int8
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
    W = VERIFY_WIDTHS[-1]
    seq = rng.integers(1, 32000, (2, C + gen + 2)).astype(np.int32)
    pt = np.stack([np.arange(1, 1 + maxp), np.arange(1 + maxp, 1 + 2 * maxp)]).astype(np.int32)
    # decode_chunk: a pack of 16 / 11 prompt tokens, then a decode sweep
    # feeding each row its next token (positions 16 and 11), then a verify
    # sweep with all_logits at C = 5 whose rows feed 5 / 2 tokens
    # (positions 17-21 and 12-13; row 1's last 3 columns are padding)
    verify = np.zeros((2, W), np.int32)
    verify[0], verify[1, :2] = seq[0, 17:17 + W], seq[1, 12:14]
    vstarts, vnvalid = np.array([17, 12], np.int32), np.array([W, 2], np.int32)
    vvalid = torch.from_numpy(np.arange(W)[None, :] < vnvalid[:, None])
    calls = [(seq[:, :C], np.array([0, 0], np.int32), np.array([16, 11], np.int32)),
             (np.array([[seq[0, 16]], [seq[1, 11]]], np.int32), np.array([16, 11], np.int32),
              np.array([1, 1], np.int32)),
             (verify, vstarts, vnvalid)]
    logits = {}
    for key, where, p in (("card", dev, params), ("cpu", "cpu", cpu_params)):
        out = {}
        with torch.inference_mode():
            tokens = torch.from_numpy(seq).to(where)
            out["forward"], _ = model.forward(p, {"tokens": tokens}, RunCtx())
        if key == "cpu":
            logits[key] = {"forward": out["forward"].float()}
            continue
        with torch.inference_mode():
            cache = model.init_cache(2, C + gen, kind="paged", page_size=ps,
                                     num_pages=2 * maxp + 1, device=where)
            t_pt = torch.from_numpy(pt).to(where)
            for i, (tok, st, nv) in enumerate(calls):
                t = [torch.from_numpy(a).to(where) for a in (tok, st, nv, np.arange(2), st == 0)]
                all_logits = tok is verify
                lg, cache = model.decode_chunk(p, t[0], cache, *t[1:], RunCtx(), t_pt,
                                               all_logits=all_logits)
                if all_logits:
                    # padding positions too must be finite; the valid ones are compared
                    assert lg.shape == (2, W, 32000) and torch.isfinite(lg).all(), \
                        f"decode_chunk(all_logits=True) on {key}: shape {tuple(lg.shape)}"
                    out["decode_chunk all_logits"] = lg[vvalid.to(where)]
                else:
                    out[f"decode_chunk {i}"] = lg
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
        launched = (w8a16_matmul_cuda.launches - n0[0], gmm_tiles_cuda.launches - n0[1])
    assert launched[1] > 0 and (launched[0] > 0) == int8, f"launches on the card: {launched}"
    card = logits["card"]

    def beside(fwd):
        """(path, the card's logits, ``fwd``'s at the same positions)."""
        pairs = [("forward", card["forward"], fwd),
                 ("decode_chunk 0", card["decode_chunk 0"],
                  torch.stack([fwd[0, 15], fwd[1, 10]])),
                 ("decode_chunk 1", card["decode_chunk 1"],
                  torch.stack([fwd[0, 16], fwd[1, 11]])),
                 ("prefill", card["prefill"], fwd[:, C - 1]),
                 ("decode_chunk all_logits", card["decode_chunk all_logits"],
                  torch.cat([fwd[0, 17:17 + W], fwd[1, 12:14]]))]
        for i in range(gen):
            pairs += [(f"decode_step {kind} {i}", card[f"decode_step {kind} {i}"], fwd[:, C + i])
                      for kind in ("dense", "paged")]
        return pairs
    worst = 0.0
    for k, a, b in beside(logits["cpu"]["forward"]):
        assert torch.isfinite(a).all() and a.shape[-1] == 32000, k
        err = max_err(a, b)
        worst = max(worst, err)
        assert err < LOGIT_ATOL, f"{k}: card vs CPU logits differ by {err}"
        assert torch.equal(a.argmax(-1), b.argmax(-1)), f"{k}: argmax differs"
    # on the card, every path against forward's logits at the same position
    cross = max(max_err(a, b) for _, a, b in beside(card["forward"])[1:])
    assert cross < LOGIT_ATOL, f"paths disagree with forward on the card by {cross}"
    kind = "int8 weights (w8a16 launches {}, gmm {})".format(*launched) if int8 else "fp32"
    log(f"  depth-2 full-width {kind}, on the card against the CPU's forward (2 x "
        f"{C + gen + 2} tokens) at the same positions: decode_chunk (pack of 27 tokens, a "
        f"decode sweep, then a verify sweep with all_logits at C = {W} over rows feeding "
        f"{W} / 2 tokens), forward, prefill (2 x 16) + 4 decode_steps over the dense ring and "
        f"over the paged pool: max |dlogit| = {worst:.3g} < {LOGIT_ATOL}, argmax equal at "
        f"every valid position")
    log(f"  on the card, decode_chunk (all_logits too) / prefill / decode_step vs forward at "
        f"the same positions: max |dlogit| = {cross:.3g} < {LOGIT_ATOL}")
    return worst, cross


# phase 3's other decoder-only configs, card vs CPU through decode_chunk at
# full width in fp32: (name, depth). deepseek's first layer is dense, so
# depth 2 is the least that reaches its MoE; dbrx at depth 1 (16 experts of
# 6144 x 10752: ~18 GB in fp32 on each side)
DECODE_CHUNK_CONFIGS = (("yi-6b", 2), ("phi3-mini-3.8b", 2), ("deepseek-moe-16b", 2),
                        ("qwen2.5-3b", 2), ("dbrx-132b", 1))


def run_decode_chunk_card_vs_cpu(dev, name: str, n_layers: int):
    """``name`` at full width, depth ``n_layers``, fp32, from the same
    weights: ``decode_chunk`` on the card over the paged pool on a pack of
    16 / 11 prompt tokens, a decode sweep, then a verify sweep with
    all_logits at C = 5 whose rows feed 5 / 2 tokens, against ``forward``
    on the CPU at the same positions (every valid one; the CPU runs
    ``forward`` alone, as ``run_card_vs_cpu``'s), within LOGIT_ATOL with
    the same argmax; a MoE config's grouped matmul launched on the card.
    Returns the worst logit difference."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_gmm import gmm_tiles_cuda
    from repro_torch.kernels.paged_attention import chunked_prefill_cuda
    from repro_torch.models import RunCtx, build_model
    from repro_torch.models.params import map_tree
    cfg = depth_cut(get_config(name), n_layers)
    model = build_model(cfg)
    params = model.init_params(0, device=dev, dtype=torch.float32)
    cpu_params = map_tree(lambda t: t.cpu(), params)
    V, W, ps, maxp = cfg.vocab, VERIFY_WIDTHS[-1], 16, 2
    seq = np.random.default_rng(4).integers(1, V, (2, 24)).astype(np.int32)
    verify = np.zeros((2, W), np.int32)
    verify[0], verify[1, :2] = seq[0, 17:17 + W], seq[1, 12:14]
    vvalid = np.arange(W)[None, :] < np.array([W, 2])[:, None]
    calls = [(seq[:, :16], [0, 0], [16, 11]),
             (np.array([[seq[0, 16]], [seq[1, 11]]], np.int32), [16, 11], [1, 1]),
             (verify, [17, 12], [W, 2])]
    pt = np.stack([np.arange(1, 1 + maxp), np.arange(1 + maxp, 1 + 2 * maxp)]).astype(np.int32)
    n0 = (gmm_tiles_cuda.launches, chunked_prefill_cuda.launches)
    out = []
    with torch.inference_mode():
        cache = model.init_cache(2, 24, kind="paged", page_size=ps, num_pages=2 * maxp + 1,
                                 device=dev)
        t_pt = torch.from_numpy(pt).to(dev)
        for tok, st, nv in calls:
            st, nv = np.asarray(st, np.int32), np.asarray(nv, np.int32)
            t = [torch.from_numpy(a).to(dev) for a in (tok, st, nv, np.arange(2), st == 0)]
            lg, cache = model.decode_chunk(params, t[0], cache, *t[1:], RunCtx(), t_pt,
                                           all_logits=tok is verify)
            out.append(lg[torch.from_numpy(vvalid).to(dev)] if tok is verify else lg)
        launched = (gmm_tiles_cuda.launches - n0[0], chunked_prefill_cuda.launches - n0[1])
        fwd, _ = model.forward(cpu_params, {"tokens": torch.from_numpy(seq)}, RunCtx())
    moe = any("1" in (g.moe_mask or "") for g in cfg.layer_groups)
    assert launched[1] > 0 and (launched[0] > 0) == moe, f"{cfg.name}: launches {launched}"
    want = [torch.stack([fwd[0, 15], fwd[1, 10]]), torch.stack([fwd[0, 16], fwd[1, 11]]),
            torch.cat([fwd[0, 17:17 + W], fwd[1, 12:14]])]
    worst = 0.0
    for i, (a, b) in enumerate(zip(out, want)):
        a, b = a.float().cpu(), b.float()
        assert torch.isfinite(a).all() and a.shape[-1] == V, f"{cfg.name} call {i}"
        err = max_err(a, b)
        worst = max(worst, err)
        assert err < LOGIT_ATOL, f"{cfg.name} decode_chunk call {i}: card vs CPU {err}"
        assert torch.equal(a.argmax(-1), b.argmax(-1)), f"{cfg.name} call {i}: argmax differs"
    log(f"  {cfg.name} (full width, depth {n_layers}, fp32, d_model {cfg.d_model}, vocab {V}), "
        f"on the card against the CPU's forward at the same positions: decode_chunk pack of "
        f"16 / 11 tokens, a decode sweep, a verify sweep with all_logits at C = {W}: max "
        f"|dlogit| = {worst:.3g} < {LOGIT_ATOL}, argmax equal; "
        f"on the card chunked attention {launched[1]} launches, gmm {launched[0]}")
    del model, params, cpu_params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return worst


def mamba2(n_layers: int):
    from repro_torch.configs import get_config
    return depth_cut(get_config("mamba2-1.3b"), n_layers)


def run_mamba_card_vs_cpu(dev):
    """mamba2 at depth 2, full width, fp32, on the same two sequences of 154
    tokens: on the card ``forward``; ``prefill`` of the first 150 then 4
    ``decode_step``s over the dense cache; the engine's ``decode_chunk``, a
    pack of 150 / 97 tokens on slots 2 / 0 whose states hold garbage
    (``first`` must reset them), then a decode sweep over the 3 slots (slot
    1 idle); each against ``forward`` on the CPU at the same positions (the
    CPU runs ``forward`` alone, as ``run_card_vs_cpu``'s) and against the
    card's own. Returns the worst card-vs-CPU and cross-path logit
    differences."""
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
            tokens = torch.from_numpy(seq).to(where)
            out["forward"], _ = model.forward(p, {"tokens": tokens}, RunCtx())
            if key == "card":
                cache = model.init_cache(3, C + gen, kind="paged", device=where)
                g = torch.Generator().manual_seed(5)
                for c in cache["groups"][0]:              # garbage states: first resets them
                    for leaf in c["ssm"].values():
                        leaf.copy_(torch.randn(leaf.shape, generator=g))
                pt = torch.zeros((3, 1), dtype=torch.int32, device=where)
                for i, (tok, st, nv, sl, fi) in enumerate(calls):
                    t = [torch.tensor(np.asarray(a), device=where) for a in (tok, st, nv, sl, fi)]
                    lg, cache = model.decode_chunk(p, t[0], cache, *t[1:], RunCtx(),
                                                   pt[:len(tok)])
                    out[f"decode_chunk {i}"] = lg
                dense = model.init_cache(2, C + gen, device=where)
                out["prefill"], dense = model.prefill(p, {"tokens": tokens[:, :C]}, dense,
                                                      RunCtx())
                for i in range(gen):
                    pos = torch.full((2,), C + i, dtype=torch.int32, device=where)
                    out[f"decode_step {i}"], dense = model.decode_step(
                        p, tokens[:, C + i:C + i + 1], dense, pos, RunCtx())
                launched = ssd_scan_cuda.launches - n0
        logits[key] = {k: v.float().cpu() for k, v in out.items()}
    assert launched > 0, "the SSD kernel never ran on the card"
    card = logits["card"]

    def beside(fwd):
        """(path, the card's logits, ``fwd``'s at the same positions)."""
        return ([("forward", card["forward"], fwd),
                 ("decode_chunk 0", card["decode_chunk 0"],
                  torch.stack([fwd[0, C - 1], fwd[1, n1 - 1]])),
                 ("decode_chunk 1", card["decode_chunk 1"][[0, 2]],
                  torch.stack([fwd[1, n1], fwd[0, C]])),
                 ("prefill", card["prefill"], fwd[:, C - 1])]
                + [(f"decode_step {i}", card[f"decode_step {i}"], fwd[:, C + i])
                   for i in range(gen)])
    worst = 0.0
    for k, a, b in beside(logits["cpu"]["forward"]):
        assert torch.isfinite(a).all() and a.shape[-1] == V, k
        err = max_err(a, b)
        worst = max(worst, err)
        assert err < LOGIT_ATOL, f"mamba2 {k}: card vs CPU logits differ by {err}"
        assert torch.equal(a.argmax(-1), b.argmax(-1)), f"mamba2 {k}: argmax differs"
    cross = max(max_err(a, b) for _, a, b in beside(card["forward"])[1:])
    assert cross < LOGIT_ATOL, f"mamba2 paths disagree with forward on the card by {cross}"
    cfg = model.cfg
    log(f"  mamba2 depth-2 fp32 (d_model {cfg.d_model}, {cfg.ssm_heads} SSD heads of "
        f"{cfg.ssm.head_dim}, d_state {cfg.ssm.d_state}, vocab {V}), on the card against the "
        f"CPU's forward (2 x {C + gen} tokens) at the same positions: forward, prefill (2 x {C}) + {gen} "
        f"decode_steps, decode_chunk (a pack of {C} / {n1} tokens over garbage states reset by "
        f"first, then a decode sweep): max |dlogit| = {worst:.3g} < {LOGIT_ATOL}, argmax "
        f"equal; SSD kernel launches on the card: {launched}")
    log(f"  on the card, decode_chunk / prefill / decode_step vs forward at the same "
        f"positions: max |dlogit| = {cross:.3g} < {LOGIT_ATOL}")
    return worst, cross


def prompts(rng, n=4):
    return [rng.integers(1, 32000, L).astype(np.int32) for L in PROMPT_LENS[:n]]


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

    def recorded(*args, **kw):
        out = chunk_call(*args, **kw)
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


def run_generation(dev, model, params, streams, profile: bool, eng_logits=None,
                   keep: bool = False):
    """Phases 5 and 7: LM.prefill of the serving run's prompts (right-padded,
    flash attention), then GEN_STEPS greedy decode_steps over the paged pool
    (paged decode kernel), on the serving run's weights. With the engine's
    logits rows, where a greedy stream leaves the engine's, the first
    diverging token's top-2 logits on both paths. With ``keep``, also
    returns the greedy tokens (B, GEN_STEPS + 1) and each step's logits (on
    the host), which phase 13 (c) is held against."""
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
    kept = (gen, [lg.cpu() for lg in gen_logits]) if keep else None
    del gen_logits
    if profile:
        with torch.inference_mode():
            res["profile"] = profile_window(lambda: generate(8),
                                            "prefill + 8 decode_steps of the generation path")
    return (res, launches, kept) if keep else (res, launches)


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


# ------------------------------------------------------------------ phase 13
# distributed serving. (a) runs in this process over NCCL at world 1; (b)
# and (c) on four ranks spawned on the one card over gloo (NCCL puts no two
# ranks of one communicator on one device; gloo takes the CUDA tensors
# through the host, ``distributed.collectives``).
DIST_AXES = ("data", "expert", "tensor")
DIST_MESHES = (("ep", (1, 2, 2), "ep_shardmap"), ("tp", (1, 1, 4), "tp_shardmap"))
DIST_DEPTH = 2              # (a), (b): mixtral-8x7b at depth 2, fp32, full width
DIST_STEPS = 4              # (a), (b): decode_steps over the paged pool
DIST_TIMEOUT_S = 300        # the spawned ranks' deadline
DIST_A_BACKEND = "nccl"     # (a): a multi-card machine's backend
# (d), (e), (f): the layouts where the tensor axis outgrows the kv heads
# (kv_seq) and the mamba layers' (ssm_* / conv_dim), at full width, fp32:
# (name, arch, depth, mesh, MoE strategy). jamba's 5 layers MMMMA hold
# mamba layers, its GQA attention and two 16-expert MoE layers (28.6 GB in
# fp32: the unsharded run, then four ranks of 8.7 GB each, fit the card)
DIST_LAYOUTS = (("d", "qwen2.5-3b", 2, (1, 1, 4), "tp_shardmap"),
                ("e", "mamba2-1.3b", 2, (1, 1, 4), "tp_shardmap"),
                ("f", "jamba-v0.1-52b", 5, (1, 2, 2), "ep_shardmap"))
DIST_RING_STEPS = 2         # (d)-(f): decode_steps over the dense ring before the pool's
# (g), (h): the enc-dec and VLM families at full width, fp32, 2 decoder
# layers (seamless: and 2 encoder layers over DIST_FRAMES frames a row;
# phi-3-vision: 576 patches a row ahead of the prompt): (name, arch, mesh)
DIST_MM = (("g", "seamless-m4t-large-v2", (2, 1, 2)), ("h", "phi-3-vision-4.2b", (1, 1, 4)))
# (i): the int8 tree under a mesh (paper §4.1 on the TP / EP shards):
# mixtral-8x7b at full width and depth DIST_DEPTH, each rank's shards from
# ``init_params_int8(mesh=)``: (name, mesh, MoE strategy, activations)
DIST_INT8 = (("i fp32", (1, 1, 4), "tp_shardmap", torch.float32),
             ("i bf16", (1, 2, 2), "ep_shardmap", torch.bfloat16))
# (j): the sequence-parallel rule (``make_rules(seq_shard=True)``) on cases
# built above, fp32 on DIST_PROMPT-token prompts (which tensor 4 divides):
# (name, arch, depth, mesh, MoE strategy, the unsharded run held against)
DIST_SEQ = (("j mixtral", "mixtral-8x7b", DIST_DEPTH, (1, 1, 4), "tp_shardmap", "j mixtral"),
            ("j qwen", "qwen2.5-3b", 2, (1, 1, 4), "tp_shardmap", "d"))
# (c): decode_steps, teacher-forced with the first of phase 5's tokens
DIST_C_STEPS = 8                   # 8 of phase 5's tokens: room in the run for phase 15
# (c): each logit row against phase 5's at the same context, relative to the
# row's max |logit|: phase 5 holds no bf16 bound of its own, and a missing
# psum or a wrong shard moves logits by their own size
DIST_BF16_RTOL = 1e-1


def dist_config(n_layers: int, arch: str = "mixtral-8x7b"):
    """``arch`` at ``n_layers``, an MoE's capacity factor E / K: no token
    drops."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = mixtral(n_layers) if arch == "mixtral-8x7b" else depth_cut(get_config(arch), n_layers)
    if cfg.moe is None:
        return cfg
    return cfg.scaled(moe=dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.num_experts
                                              / cfg.moe.top_k))


def dist_rules(strategy: str, seq_shard: bool = False):
    from repro_torch.distributed.sharding import make_rules
    return make_rules("serve", moe="ep" if strategy == "ep_shardmap" else "tp",
                      tensor_axis="tensor", expert_axis="expert", seq_shard=seq_shard)


def dist_int8_shapes() -> dict:
    """(i)'s calls of the w8a16 and grouped matmuls on a rank, as the model
    makes them over DIST_PROMPT-token prompts: {"w8a16": {(M, K, N, G,
    dtype)}, "gmm": {(rows, K, N, dtype, experts)}}. w8a16: wq / wk / wv /
    wo at the prefill's and the pack's B x DIST_PROMPT rows and a decode
    step's B, the head (its vocab columns) at B rows (each call's last
    positions); gmm: the rank's capacity buffers, every expert's ``cap``
    rows a group (the MoE's capacity formulas at those token counts)."""
    import math
    cfg = dist_config(DIST_DEPTH)
    m, d, hd = cfg.moe, cfg.d_model, cfg.head_dim
    fe, K, cf = m.d_expert or cfg.d_ff, m.top_k, m.capacity_factor
    B = len(PROMPT_LENS)
    up = lambda x, k: -(-x // k) * k  # noqa: E731
    out = {"w8a16": set(), "gmm": set()}
    for _, (_, ep, tp), strategy, dtype in DIST_INT8:
        H, Hkv = (n // tp if n % tp == 0 else n for n in (cfg.n_heads, cfg.n_kv_heads))
        for T in (B * DIST_PROMPT, B):
            out["w8a16"] |= {(T, d, H * hd, H, dtype), (T, d, Hkv * hd, Hkv, dtype),
                             (T, H * hd, d, 1, dtype)}
            if strategy == "ep_shardmap":
                E = m.num_experts // ep
                cap_s = up(max(math.ceil(T * K * cf / ep), 4), 4)
                cap = up(max(math.ceil(ep * cap_s / E * cf), 8), 8)
            else:
                E = m.num_experts
                cap = up(max(math.ceil(T * K / E * cf), 8), 8)
            out["gmm"] |= {(E * cap, d, fe // tp, dtype, E), (E * cap, fe // tp, d, dtype, E)}
        out["w8a16"].add((B, d, cfg.vocab // tp, 1, dtype))
    return out


def dryrun_shapes() -> dict:
    """Phase 15's calls of the w8a16 and grouped matmuls on rank 0 of the
    (16, 16) mesh at ``decode_32k`` on the int8 tree (the MoE on tp):
    {"w8a16": {(M, K, N, G)}, "gmm": {(rows, K, N, experts)}}, bf16. At the
    rank's B rows: wq at its heads (a scale per head), wk / wv whole (the
    kv_seq layout: 8 kv heads do not split over 16), wo's rows of its heads,
    the head's vocab columns; the grouped matmul over every expert's
    capacity buffer of ``cap`` rows, the FFN split on the tensor axis."""
    import math
    from repro_torch.configs import SHAPES, get_config
    cfg, shape = get_config(DRYRUN_ARCH), SHAPES[DRYRUN_SHAPE]
    data, tp = DRYRUN_MESH
    m, d, hd = cfg.moe, cfg.d_model, cfg.head_dim
    B, E, fe = shape.global_batch // data, m.num_experts, (m.d_expert or cfg.d_ff) // tp
    H = cfg.n_heads // tp
    Hkv = cfg.n_kv_heads // tp if cfg.n_kv_heads % tp == 0 else cfg.n_kv_heads
    cap = -(-max(math.ceil(B * m.top_k / E * m.capacity_factor), 8) // 8) * 8
    return {"w8a16": {(B, d, H * hd, H), (B, d, Hkv * hd, Hkv), (B, H * hd, d, 1),
                      (B, d, cfg.vocab // tp, 1)},
            "gmm": {(E * cap, d, fe, E), (E * cap, fe, d, E)}}


def run_dryrun_proof(dev, profile: bool = False) -> tuple:
    """Phase 15 (the module's note). Returns ({"bf16" / "int8": numbers},
    the int8 cell's launches by kernel). ``profile``: one more step of each
    cell under torch.profiler (``dryrun.profile_step``)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    cfg, shape = get_config(DRYRUN_ARCH), SHAPES[DRYRUN_SHAPE]
    mesh = Mesh(DRYRUN_MESH, ("data", "model"))
    L = cfg.n_layers
    out, all_launches = {}, {}
    for quant in ("none", "int8"):
        name = "int8" if quant == "int8" else "bf16"
        t0 = time.perf_counter()
        meta = dryrun.build_cell(cfg, shape, mesh, moe_mode="tp", quant=quant, device="meta")
        mw = dryrun.walk(meta)
        costs = dryrun.cell_costs(meta, mw)
        walk_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        cell = dryrun.build_cell(cfg, shape, mesh, moe_mode="tp", quant=quant, device="cuda")
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t0
        placed = torch.cuda.memory_allocated() - base
        assert abs(placed - meta.argument_bytes) <= DRYRUN_ALLOC_RTOL * meta.argument_bytes, \
            f"phase 15 {name}: {placed} bytes placed, the walk's argument_bytes " \
            f"{meta.argument_bytes}"
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t0 = time.perf_counter()
        cw = dryrun.walk(cell, count=False)
        first_s = time.perf_counter() - t0
        logits = cw.out[0]
        assert tuple(logits.shape) == (shape.global_batch, cfg.vocab) and bool(
            torch.isfinite(logits.float()).all()), f"phase 15 {name}: logits {logits.shape}"
        assert cw.log == mw.log, \
            f"phase 15 {name}: the card's collectives differ from the meta walk's"
        steps = dryrun.card_steps(cell, DRYRUN_STEPS)
        launches, _ = read_launches()
        prof = None
        if profile:
            prof = dryrun.profile_step(cell)
            log(f"  {name} profiled step: wall {prof['wall_ms']:.1f} ms, device busy "
                f"{prof['device_busy_ms']:.2f} ms, {prof['aten_ops']} aten ops; top: "
                + ", ".join(f"{r['name'][:40]} {r['ms']:.3f}" for r in prof["top"][:6]))
        runs = 1 + DRYRUN_STEPS
        want = ({"w8a16_matmul": runs * (4 * L + 1), "moe_gmm": runs * 3 * L}
                if quant == "int8" else {})
        got = {k: n for k, n in launches.items() if n}
        assert got == want, f"phase 15 {name}: launches {got}, expected {want}"
        all_launches = {k: all_launches.get(k, 0) + n for k, n in launches.items()}
        r = costs["roofline"]
        out[name] = dict(
            arch=DRYRUN_ARCH, shape=DRYRUN_SHAPE, mesh=list(DRYRUN_MESH), rank=0, moe="tp",
            argument_bytes=meta.argument_bytes, sizes=meta.sizes, placed_bytes=placed,
            temp_bytes_meta=mw.temp_bytes, max_allocated_bytes=steps["max_allocated_bytes"],
            step_ms_median=steps["step_s_median"] * 1e3, steps=DRYRUN_STEPS,
            first_step_s=first_s, draw_s=draw_s, meta_walk_s=walk_s,
            memory_floor_ms=r["memory_floor_s"] * 1e3, bound_ms=r["bound_s"] * 1e3,
            dominant=r["dominant"], flops=costs["cost"]["flops"],
            bytes_accessed=costs["cost"]["bytes_accessed"], collectives=len(mw.log),
            launches=got, profile=prof)
        sizes_gb = {k: n / 1e9 for k, n in meta.sizes.items()}
        log(f"  {name}: placed {placed / 1e9:.3f} GB (walk's argument_bytes "
            f"{meta.argument_bytes / 1e9:.3f} GB; params {sizes_gb['params_local_bytes']:.3f}"
            f" + cache {sizes_gb['cache_local_bytes']:.3f}), peak "
            f"{steps['max_allocated_bytes'] / 1e9:.3f} GB (meta temp_bytes "
            f"{mw.temp_bytes / 1e9:.3f} GB), step {out[name]['step_ms_median']:.3f} ms median of "
            f"{DRYRUN_STEPS} against memory_floor {out[name]['memory_floor_ms']:.3f} ms and "
            f"bound {out[name]['bound_ms']:.3f} ms ({r['dominant']}); logits finite; "
            f"{len(mw.log)} collectives equal the meta walk's; launches {got}; meta walk "
            f"{walk_s:.1f} s, draw {draw_s:.1f} s, first step {first_s:.1f} s")
        del meta, mw, cell, cw, logits
        gc.collect()
        torch.cuda.empty_cache()
    return out, all_launches


@contextlib.contextmanager
def unrecorded():
    """Calls that check the card and serve nothing (a mesh case's unsharded
    reference run): their call shapes leave SERVED as it was."""
    saved = {k: set(v) for k, v in SERVED.items()}
    try:
        yield
    finally:
        for k, v in saved.items():
            SERVED[k] = v


@contextlib.contextmanager
def counting_reduce_scatters():
    """While open, counts the sequence-parallel rule's reduce-scatters
    (``distributed.collectives.reduce_scatter``) in ``.n``."""
    from repro_torch.distributed import collectives
    real = collectives.reduce_scatter

    class Count:
        n = 0
    count = Count()

    def counted(*args, **kw):
        count.n += 1
        return real(*args, **kw)
    collectives.reduce_scatter = counted
    try:
        yield count
    finally:
        collectives.reduce_scatter = real


def dist_ctx(strategy: str, mesh=None):
    from repro_torch.models import RunCtx
    if mesh is None:
        return RunCtx(moe_strategy="capacity")
    return RunCtx(moe_strategy=strategy, mesh=mesh, ep_axis="expert", tp_axis="tensor")


def whole_rings(dense, mesh):
    """The dense cache's rings with every slot and row on this rank: its k
    / v shards gathered over the axes its specs split the sequence and the
    batch on (``dense`` itself without a mesh); an SSM layer's state and
    conv as they are (a paged cache of as many rows holds the same shards
    of them)."""
    if mesh is None:
        return dense
    from repro_torch.distributed.collectives import all_gather

    def gather(t, spec):
        for dim in (2, 1):                       # (R, B, W, Hkv, hd): seq, then batch
            if spec[dim] is not None:
                t = all_gather(t, mesh, spec[dim], dim=dim)
        return t
    return {"groups": [[{"attn": {n: gather(c["attn"][n], s["attn"][n]) for n in ("k", "v")}}
                        if "attn" in c else c for c, s in zip(gc, gs)]
                       for gc, gs in zip(dense["groups"], dense.specs["groups"])]}


def dist_generate(dev, model, params, ctx, tokens, lens, steps: int, feed=None, timed=False):
    """prefill of ``tokens`` (B, S) right-padded (``lens``) into a dense
    ring, the rings copied into a paged pool of ceil((S + GEN_STEPS) / 16)
    pages a row, then ``steps`` decode_steps over it, each feeding
    ``feed[:, t]`` (teacher forcing) or the greedy token. Under a mesh
    (inside ``use_sharding``) the caches are the rank's shards. Returns
    (fed tokens (B, steps + 1), each call's logits, wall seconds of each
    call when ``timed``)."""
    ps = 16
    B, S = tokens.shape
    maxp = -(-(S + GEN_STEPS) // ps)
    pt = torch.arange(B * maxp, dtype=torch.int32, device=dev).reshape(B, maxp) + 1
    last = torch.tensor(lens, dtype=torch.int64, device=dev) - 1
    dtype = params["final_norm"]["w"].dtype
    times, logits = [], []

    def tick():
        if timed:
            torch.cuda.synchronize()
        return time.perf_counter()
    t0 = tick()
    dense = model.init_cache(B, maxp * ps, dtype, device=dev)
    lg, dense = model.prefill(params, {"tokens": tokens}, dense, ctx, last_pos=last)
    paged = model.init_cache(B, maxp * ps, dtype, kind="paged", page_size=ps,
                             num_pages=B * maxp + 1, device=dev)
    fill_pool_from_ring(paged, whole_rings(dense, ctx.mesh), pt, ps)
    del dense
    logits.append(lg)
    times.append(tick() - t0)
    nxt = lg.argmax(-1) if feed is None else feed[:, 0].to(dev)
    fed = [nxt]
    pos = last.to(torch.int32) + 1
    for t in range(steps):
        t0 = tick()
        lg, paged = model.decode_step(params, nxt[:, None].to(torch.int32), paged, pos, ctx,
                                      page_table=pt, lengths=pos + 1)
        logits.append(lg)
        times.append(tick() - t0)
        nxt = lg.argmax(-1) if feed is None else feed[:, t + 1].to(dev)
        fed.append(nxt)
        pos = pos + 1
    return torch.stack(fed, 1).cpu(), logits, times


def dist_pack(dev, model, params, ctx, tokens, lens):
    """One ``decode_chunk`` pack of the prompts (every row a first chunk)
    into a fresh pool: the logits at each row's last prompt token."""
    ps = 16
    B, S = tokens.shape
    maxp = -(-(S + GEN_STEPS) // ps)
    pt = torch.arange(B * maxp, dtype=torch.int32, device=dev).reshape(B, maxp) + 1
    dtype = params["final_norm"]["w"].dtype
    pool = model.init_cache(B, maxp * ps, dtype, kind="paged", page_size=ps,
                            num_pages=B * maxp + 1, device=dev)
    lg, _ = model.decode_chunk(params, tokens, pool, torch.zeros(B, dtype=torch.int32, device=dev),
                               torch.tensor(lens, dtype=torch.int32, device=dev),
                               torch.arange(B, dtype=torch.int32, device=dev),
                               torch.ones(B, dtype=torch.bool, device=dev), ctx, pt)
    return lg


def dist_paths(dev, model, params, ctx, tokens, feed, timed=False):
    """(d)-(f)'s paths on prompts of one length (B, S), teacher-forced with
    ``feed`` (B, DIST_RING_STEPS + DIST_STEPS): ``prefill`` into a dense
    ring, DIST_RING_STEPS ``decode_step``s over it, the rings and SSM states
    copied into a paged pool, DIST_STEPS ``decode_step``s over the pool;
    then a ``decode_chunk`` pack of the prompts into a fresh pool. Under a
    mesh (inside ``use_sharding``) the caches are the rank's shards.
    Returns ({path: logits}, wall seconds of each call when ``timed``)."""
    ps = 16
    B, S = tokens.shape
    maxp = -(-(S + GEN_STEPS) // ps)
    pt = torch.arange(B * maxp, dtype=torch.int32, device=dev).reshape(B, maxp) + 1
    dtype = params["final_norm"]["w"].dtype
    out, secs = {}, {}

    def tick():
        if timed:
            torch.cuda.synchronize()
        return time.perf_counter()
    t0 = tick()
    dense = model.init_cache(B, maxp * ps, dtype, device=dev)
    out["prefill"], dense = model.prefill(params, {"tokens": tokens}, dense, ctx)
    secs["prefill"] = tick() - t0
    pos = torch.full((B,), S, dtype=torch.int32, device=dev)
    for i in range(DIST_RING_STEPS):
        t0 = tick()
        out[f"ring{i}"], dense = model.decode_step(params, feed[:, i:i + 1], dense, pos, ctx)
        secs.setdefault("ring", []).append(tick() - t0)
        pos = pos + 1
    paged = model.init_cache(B, maxp * ps, dtype, kind="paged", page_size=ps,
                             num_pages=B * maxp + 1, device=dev)
    fill_pool_from_ring(paged, whole_rings(dense, ctx.mesh), pt, ps)
    del dense
    for i in range(DIST_STEPS):
        t0 = tick()
        j = DIST_RING_STEPS + i
        out[f"paged{i}"], paged = model.decode_step(params, feed[:, j:j + 1], paged, pos, ctx,
                                                    page_table=pt, lengths=pos + 1)
        secs.setdefault("paged", []).append(tick() - t0)
        pos = pos + 1
    del paged
    t0 = tick()
    out["pack"] = dist_pack(dev, model, params, ctx, tokens, [S] * B)
    secs["pack"] = tick() - t0
    return out, secs


def dist_mm_pages(cfg) -> int:
    """(g) / (h)'s pages a row: the patch prefix, the prompt and every decode
    step, 16 positions a page."""
    off = cfg.vision.n_patches if cfg.vision is not None else 0
    return -(-(off + DIST_PROMPT + DIST_RING_STEPS + DIST_STEPS) // 16)


def dist_mm_extras(cfg, B: int) -> dict:
    """(g) / (h)'s seeded frames (B, DIST_FRAMES, d) or patches (B,
    n_patches, d_patch), fp32 on the host."""
    g = torch.Generator().manual_seed(17)
    if cfg.encoder is not None:
        return {"frames": torch.randn((B, DIST_FRAMES, cfg.d_model), generator=g)}
    return {"patches": torch.randn((B, cfg.vision.n_patches, cfg.vision.d_patch), generator=g)}


def dist_mm_paths(dev, model, params, ctx, tokens, feed, ext, timed=False):
    """(g) / (h)'s paths on prompts (B, S) with the batch's ``ext`` (frames
    or patches), teacher-forced with ``feed`` (B, DIST_RING_STEPS +
    DIST_STEPS): ``prefill`` into a dense ring (and cross cache),
    DIST_RING_STEPS ``decode_step``s over it; a ``decode_chunk`` pack of the
    prompts with the same extras into a fresh pool (every row a first
    chunk: the encoder runs and the cross keys and values go to the rows'
    slots, or the patch prefix takes positions [0, 576)), then DIST_STEPS
    ``decode_step``s over that pool (positions past the patch prefix).
    Returns ({path: logits}, wall seconds of each call when ``timed``)."""
    ps, cfg = 16, model.cfg
    B, S = tokens.shape
    maxp = dist_mm_pages(cfg)
    off = cfg.vision.n_patches if cfg.vision is not None else 0
    M = DIST_FRAMES if cfg.encoder is not None else 0
    pt = torch.arange(B * maxp, dtype=torch.int32, device=dev).reshape(B, maxp) + 1
    dtype = params["final_norm"]["w"].dtype
    ext = {k: v.to(dev) for k, v in ext.items()}
    out, secs = {}, {}

    def tick():
        if timed:
            torch.cuda.synchronize()
        return time.perf_counter()
    t0 = tick()
    dense = model.init_cache(B, maxp * ps, dtype, memory_len=M, device=dev)
    out["prefill"], dense = model.prefill(params, {"tokens": tokens, **ext}, dense, ctx)
    secs["prefill"] = tick() - t0
    pos = torch.full((B,), off + S, dtype=torch.int32, device=dev)
    for i in range(DIST_RING_STEPS):
        t0 = tick()
        out[f"ring{i}"], dense = model.decode_step(params, feed[:, i:i + 1], dense, pos, ctx)
        secs.setdefault("ring", []).append(tick() - t0)
        pos = pos + 1
    del dense
    pool = model.init_cache(B, maxp * ps, dtype, kind="paged", page_size=ps,
                            num_pages=B * maxp + 1, memory_len=M, device=dev)
    t0 = tick()
    out["pack"], pool = model.decode_chunk(
        params, tokens, pool, torch.zeros(B, dtype=torch.int32, device=dev),
        torch.full((B,), S, dtype=torch.int32, device=dev),
        torch.arange(B, dtype=torch.int32, device=dev),
        torch.ones(B, dtype=torch.bool, device=dev), ctx, pt, **ext)
    secs["pack"] = tick() - t0
    pos = torch.full((B,), off + S, dtype=torch.int32, device=dev)
    for i in range(DIST_STEPS):
        t0 = tick()
        j = DIST_RING_STEPS + i
        out[f"paged{i}"], pool = model.decode_step(params, feed[:, j:j + 1], pool, pos, ctx,
                                                   page_table=pt, lengths=pos + 1)
        secs.setdefault("paged", []).append(tick() - t0)
        pos = pos + 1
    return out, secs


def padded_prompts(dev, streams):
    lens = [len(p) for p, _ in streams]
    toks = np.zeros((len(lens), max(lens)), np.int32)
    for b, (p, _) in enumerate(streams):
        toks[b, :len(p)] = p
    return torch.from_numpy(toks).to(dev), lens


def spec_bytes(model, mesh, rules, nbytes: int, int8: bool = False) -> int:
    """What the rank's shards of the parameters weigh by their specs, at
    ``nbytes`` an element; ``int8``: the int8 tree's (``param_partition_specs
    (..., quant="int8")``: q one byte an element and its fp32 scale by its
    own spec; a leaf the quantization leaves at ``nbytes``)."""
    from repro_torch.distributed.sharding import (PartitionSpec, local_shape,
                                                  param_partition_specs)
    from repro_torch.models.params import ParamSpec, map_tree
    from repro_torch.quant.quantize import QuantizedLinear
    specs = []
    map_tree(specs.append, model.param_specs(), is_leaf=lambda x: isinstance(x, ParamSpec))
    parts = []
    map_tree(parts.append, param_partition_specs(model.param_specs(), mesh, rules,
                                                 quant="int8" if int8 else "none"),
             is_leaf=lambda x: isinstance(x, (QuantizedLinear, PartitionSpec)))
    total = 0
    for s, ps in zip(specs, parts):
        if isinstance(ps, QuantizedLinear):
            total += int(np.prod(local_shape(s.shape, ps.q, mesh))) + 4 * int(np.prod(
                local_shape(s.shape[:-1] + (1,), ps.scale, mesh)))
        else:
            total += nbytes * int(np.prod(local_shape(s.shape, ps, mesh)))
    return total


def tensor_bytes(tree) -> int:
    from repro_torch.models.params import map_tree
    sizes = []
    map_tree(lambda t: sizes.append(t.numel() * t.element_size()), tree)
    return sum(sizes)


def dist_rank(rank: int, world: int, job: dict):
    """One spawned rank of phase 13 (b) and (c), on cuda:0 with gloo. Both
    meshes of (b) are bound at once (two sets of subgroups). Rank 0 zeroes
    the kernels' counters before each path and reads them after, and
    records the path's call shapes. Returns what the parent checks."""
    from repro_torch.distributed.sharding import use_sharding
    from repro_torch.kernels import build as kbuild
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.models.moe import count_drops
    from repro_torch.models.params import init_params_int8
    if job.get("hook"):
        job["hook"]()                              # the CPU rehearsal's stubs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(job["device"])
    torch.cuda.set_device(dev)
    for name in ("flash_attention", "chunked_prefill", "quant_matmul", "moe_gmm"):
        kbuild.load_library(name)                  # built by phase 1; the build lock guards it
    meshes = {shape: Mesh(shape, DIST_AXES).bind()
              for shape in sorted({m[1] for m in DIST_MESHES} | {m[2] for m in DIST_MM})}
    tokens, lens = job["tokens"].to(dev), job["lens"]
    out = {"rank": rank, "b": {}}
    recording = served_shapes if rank == 0 else contextlib.nullcontext
    with torch.inference_mode():
        # (b) fp32 depth 2 on both meshes, teacher-forced with the card's
        # unsharded greedy tokens
        model = build_model(dist_config(DIST_DEPTH))
        for name, shape, strategy in DIST_MESHES:
            mesh, rules = meshes[shape], dist_rules(strategy)
            ctx = dist_ctx(strategy, mesh)
            with use_sharding(mesh, rules):
                params = model.init_params(0, device=dev, dtype=torch.float32, mesh=mesh,
                                           rules=rules)
                zero_launches()
                with recording(), count_drops() as drops:
                    _, logits, _ = dist_generate(dev, model, params, ctx, tokens, lens,
                                                 DIST_STEPS, feed=job["b_fed"])
                    pack = dist_pack(dev, model, params, ctx, tokens, lens)
                torch.cuda.synchronize()
                out["b"][name] = dict(logits=[lg.cpu() for lg in logits], pack=pack.cpu(),
                                      drops=drops.total(), launches=read_launches()[0],
                                      param_bytes=tensor_bytes(params),
                                      spec_bytes=spec_bytes(model, mesh, rules, 4))
            del params
            torch.cuda.empty_cache()
        # (c) bf16 at SERVE_LAYERS on the ep mesh, phase 4's seed, teacher-
        # forced with phase 5's greedy tokens
        model = build_model(dist_config(SERVE_LAYERS))
        _, shape, strategy = DIST_MESHES[0]
        mesh, rules = meshes[shape], dist_rules(strategy)
        ctx = dist_ctx(strategy, mesh)
        torch.cuda.reset_peak_memory_stats()
        with use_sharding(mesh, rules):
            t0 = time.perf_counter()
            params = model.init_params(0, device=dev, dtype=torch.bfloat16, mesh=mesh,
                                       rules=rules)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            # warm-up (allocator, the groups' first collectives) on the
            # prompts' first 16 tokens: the whole prefill takes ~10 s here
            dist_generate(dev, model, params, ctx, tokens[:, :16], [16] * len(lens), 2,
                          feed=job["c_fed"])
            torch.cuda.synchronize()
            zero_launches()
            with recording(), count_drops() as drops:
                _, logits, times = dist_generate(dev, model, params, ctx, tokens, lens,
                                                 DIST_C_STEPS, feed=job["c_fed"], timed=True)
            torch.cuda.synchronize()
            out["c"] = dict(logits=[lg.cpu() for lg in logits], times=times,
                            drops=drops.total(), launches=read_launches()[0],
                            paths=read_launches()[1], init_s=init_s,
                            param_bytes=tensor_bytes(params),
                            spec_bytes=spec_bytes(model, mesh, rules, 2),
                            peak_bytes=torch.cuda.max_memory_allocated())
        del params, model
        gc.collect()
        torch.cuda.empty_cache()
        # (d)-(f): the kv_seq and mamba layouts, fp32, teacher-forced with
        # the parent's tokens
        out["layouts"] = {}
        for key, arch, depth, shape, strategy in DIST_LAYOUTS:
            model = build_model(dist_config(depth, arch))
            mesh, rules = meshes[shape], dist_rules(strategy)
            ctx = dist_ctx(strategy, mesh)
            torch.cuda.reset_peak_memory_stats()
            with use_sharding(mesh, rules):
                params = model.init_params(0, device=dev, dtype=torch.float32, mesh=mesh,
                                           rules=rules)
                zero_launches()
                with recording(), count_drops() as drops:
                    logits, secs = dist_paths(dev, model, params, ctx, job["d_tokens"].to(dev),
                                              job["d_feed"].to(dev), timed=True)
                torch.cuda.synchronize()
                out["layouts"][key] = dict(
                    logits={k: v.cpu() for k, v in logits.items()}, secs=secs,
                    drops=drops.total(), launches=read_launches(),
                    param_bytes=tensor_bytes(params), spec_bytes=spec_bytes(model, mesh, rules, 4),
                    peak_bytes=torch.cuda.max_memory_allocated())
            del params, model, logits
            gc.collect()
            torch.cuda.empty_cache()
        # (g), (h): the enc-dec and VLM families, fp32, with the parent's
        # frames / patches, teacher-forced with its tokens
        for key, arch, shape in DIST_MM:
            model = build_model(mm_config(arch, 2))
            mesh, rules = meshes[shape], dist_rules("tp_shardmap")
            ctx = dist_ctx("tp_shardmap", mesh)
            torch.cuda.reset_peak_memory_stats()
            with use_sharding(mesh, rules):
                params = model.init_params(0, device=dev, dtype=torch.float32, mesh=mesh,
                                           rules=rules)
                zero_launches()
                with recording():
                    logits, secs = dist_mm_paths(dev, model, params, ctx,
                                                 job["d_tokens"].to(dev), job["d_feed"].to(dev),
                                                 job["mm_extras"][key], timed=True)
                torch.cuda.synchronize()
                out["layouts"][key] = dict(
                    logits={k: v.cpu() for k, v in logits.items()}, secs=secs, drops=0,
                    launches=read_launches(), param_bytes=tensor_bytes(params),
                    spec_bytes=spec_bytes(model, mesh, rules, 4),
                    peak_bytes=torch.cuda.max_memory_allocated())
            del params, model, logits
            gc.collect()
            torch.cuda.empty_cache()
        # (i): the int8 tree, each rank's shards from init_params_int8(mesh=)
        # (each repeat quantized whole, then sliced), teacher-forced with the
        # parent's tokens: fp32 activations on (1, 1, 4), bf16 on (1, 2, 2)
        model = build_model(dist_config(DIST_DEPTH))
        for key, shape, strategy, dtype in DIST_INT8:
            mesh, rules = meshes[shape], dist_rules(strategy)
            ctx = dist_ctx(strategy, mesh)
            torch.cuda.reset_peak_memory_stats()
            with use_sharding(mesh, rules):
                params = init_params_int8(model.cfg, 0, device=dev, dtype=dtype, mesh=mesh,
                                          rules=rules)
                zero_launches()
                with recording(), count_drops() as drops:
                    logits, secs = dist_paths(dev, model, params, ctx, job["d_tokens"].to(dev),
                                              job["d_feed"].to(dev), timed=True)
                torch.cuda.synchronize()
                out["layouts"][key] = dict(
                    logits={k: v.cpu() for k, v in logits.items()}, secs=secs,
                    drops=drops.total(), launches=read_launches(),
                    param_bytes=tensor_bytes(params),
                    spec_bytes=spec_bytes(model, mesh, rules, dtype.itemsize, int8=True),
                    peak_bytes=torch.cuda.max_memory_allocated())
            del params, logits
            gc.collect()
            torch.cuda.empty_cache()
        del model
        # (j): the sequence-parallel rule on (b)'s mixtral and (d)'s qwen2.5-3b
        # at (1, 1, 4), over DIST_PROMPT-token prompts
        for key, arch, depth, shape, strategy, _ in DIST_SEQ:
            model = build_model(dist_config(depth, arch))
            mesh, rules = meshes[shape], dist_rules(strategy, seq_shard=True)
            ctx = dist_ctx(strategy, mesh)
            torch.cuda.reset_peak_memory_stats()
            with use_sharding(mesh, rules):
                params = model.init_params(0, device=dev, dtype=torch.float32, mesh=mesh,
                                           rules=rules)
                zero_launches()
                with recording(), count_drops() as drops, counting_reduce_scatters() as rs:
                    logits, secs = dist_paths(dev, model, params, ctx, job["d_tokens"].to(dev),
                                              job["d_feed"].to(dev), timed=True)
                torch.cuda.synchronize()
                out["layouts"][key] = dict(
                    logits={k: v.cpu() for k, v in logits.items()}, secs=secs,
                    drops=drops.total(), launches=read_launches(), reduce_scatters=rs.n,
                    param_bytes=tensor_bytes(params), spec_bytes=spec_bytes(model, mesh, rules, 4),
                    peak_bytes=torch.cuda.max_memory_allocated())
            del params, model, logits
            gc.collect()
            torch.cuda.empty_cache()
    if rank == 0:
        out["served"] = {k: sorted(v) for k, v in SERVED.items()}
    return out


def bf16_held(logits, ref, what: str):
    """Each logit row within DIST_BF16_RTOL of the row's max |logit| of
    ``ref``'s (the same contexts, teacher-forced), each argmax flip a tie:
    each path's top-2 margin within the rows' largest gap. Returns (the
    worst relative error, the flips)."""
    worst, flips = 0.0, []
    for t, (a, b) in enumerate(zip(logits, ref)):
        a, b = a.float(), b.float()
        worst = max(worst, float(((a - b).abs().amax(-1) / b.abs().amax(-1)).max()))
        for row in torch.nonzero(a.argmax(-1) != b.argmax(-1)).flatten().tolist():
            gap = float((a[row] - b[row]).abs().max())
            margins = [float(v[0] - v[1]) for v in (torch.topk(a[row], 2)[0],
                                                    torch.topk(b[row], 2)[0])]
            flips.append(dict(request=row, token=t, gap=gap, margins=margins,
                              tie=max(margins) <= gap))
    assert worst < DIST_BF16_RTOL, f"{what}: logits differ from the reference by {worst:.3g} of max"
    assert all(f["tie"] for f in flips), f"{what}: an argmax flip is no tie: {flips}"
    return worst, flips


def run_distributed(dev, streams, gen_tokens, gen_logits, hook=None):
    """Phase 13. (a) NCCL, world 1, in this process: mixtral at depth 2,
    fp32, ep_shardmap on the (1, 1, 1) mesh, prefill + DIST_STEPS
    decode_steps over the paged pool against the unsharded capacity run on
    the card within LOGIT_ATOL, argmax equal. (b) four gloo ranks, the same
    model on (1, 2, 2) ep_shardmap and (1, 1, 4) tp_shardmap: the same
    paths and a decode_chunk pack, rank 0's gathered logits against the
    unsharded run within LOGIT_ATOL, argmax equal, no token dropped. (c)
    the same ranks, the SERVE_LAYERS mixtral in bf16 (phase 4's seed, each
    rank drawing its own shards) on (1, 2, 2) ep_shardmap, teacher-forced
    with phase 5's greedy tokens: every logit row within DIST_BF16_RTOL of
    the row's max |logit| of phase 5's, each argmax flip a tie (each
    path's top-2 margin within the rows' largest gap, as
    ``divergence_report`` reads it). (d)-(f) the same ranks, fp32 at full
    width (DIST_LAYOUTS): qwen2.5-3b at depth 2 on (1, 1, 4), whose 2 kv
    heads the tensor axis outgrows (the kv_seq layout: the ring split on
    the sequence over tensor, the pool whole); mamba2-1.3b at depth 2 on
    (1, 1, 4) (in_proj, conv channels, SSD heads and d_inner all split);
    jamba at 5 layers (MMMMA: mamba, attention and the MoE) on (1, 2, 2)
    ep_shardmap; the prompts cut to DIST_PROMPT tokens, teacher-forced with
    seeded tokens: ``dist_paths``' prefill, ring and pool decode_steps and
    pack, rank 0's gathered logits against the unsharded card run within
    LOGIT_ATOL, argmax equal, each model's kernels launched. (g), (h)
    (DIST_MM): seamless-m4t-large-v2 (2 encoder and 2 decoder layers) on
    (2, 1, 2) and phi-3-vision-4.2b (2 layers) on (1, 1, 4), fp32, with
    the parent's seeded frames / patches: ``dist_mm_paths``' prefill, ring
    decode_steps, pack and pool decode_steps, held the same way. ``hook``
    (a module-level callable) runs first in each rank: the CPU rehearsal's
    stubs."""
    import datetime
    import tempfile

    import torch.distributed as dist
    from repro_torch.distributed.ranks import spawn_ranks
    from repro_torch.distributed.sharding import use_sharding
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import RunCtx, build_model
    from repro_torch.models.moe import count_drops
    res = {}
    tokens, lens = padded_prompts(dev, streams)
    store = Path(tempfile.mkdtemp(prefix="chip_smoke_dist_"))
    # the unsharded card run, which (a) and (b) are held against
    model = build_model(dist_config(DIST_DEPTH))
    params = model.init_params(0, device=dev, dtype=torch.float32)
    with torch.inference_mode():
        b_fed, ref_logits, _ = dist_generate(dev, model, params, dist_ctx("capacity"), tokens,
                                             lens, DIST_STEPS)
        ref_pack = dist_pack(dev, model, params, dist_ctx("capacity"), tokens, lens).cpu()
    ref_logits = [lg.cpu() for lg in ref_logits]

    def held(logits, name):
        errs = [max_err(a, b) for a, b in zip(logits, ref_logits)]
        assert len(errs) == DIST_STEPS + 1 and max(errs) < LOGIT_ATOL, \
            f"{name}: logits differ from the unsharded run by {errs}"
        flips = [i for i, (a, b) in enumerate(zip(logits, ref_logits))
                 if not torch.equal(a.argmax(-1), b.argmax(-1))]
        assert not flips, f"{name}: greedy tokens differ from the unsharded run at calls {flips}"
        return max(errs)

    # (a) NCCL at world 1: every shard is the whole tree, the same tensors
    t0 = time.perf_counter()
    dist.init_process_group(DIST_A_BACKEND, store=dist.FileStore(str(store / "nccl"), 1), rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = Mesh((1, 1, 1), DIST_AXES).bind()
        zero_launches()
        with use_sharding(mesh, dist_rules("ep_shardmap")), torch.inference_mode(), \
                count_drops() as drops:
            _, logits, _ = dist_generate(dev, model, params, dist_ctx("ep_shardmap", mesh),
                                         tokens, lens, DIST_STEPS, feed=b_fed)
        torch.cuda.synchronize()
        a_launches = read_launches()[0]
    finally:
        dist.destroy_process_group()
    assert a_launches["flash_attention"] > 0 and a_launches["paged_attention"] > 0, a_launches
    assert drops.total() == 0, f"(a) dropped {drops.total()} assignments"
    res["a"] = dict(max_abs_logit=held([lg.cpu() for lg in logits], "(a) NCCL world 1"),
                    launches=a_launches, seconds=time.perf_counter() - t0)
    log(f"  (a) NCCL, world 1, mesh (1, 1, 1), ep_shardmap, {model.cfg.name} fp32: prefill + "
        f"{DIST_STEPS} decode_steps within {res['a']['max_abs_logit']:.3g} of the unsharded "
        f"capacity run (< {LOGIT_ATOL}), argmax equal; launches {a_launches}")

    # the unsharded card runs (d)-(j) are held against; (i)'s int8 trees and
    # (j)'s mixtral over DIST_PROMPT tokens check the card and serve nothing
    d_tokens = tokens[:, :DIST_PROMPT].cpu()
    d_feed = torch.randint(1, 32000, (len(lens), DIST_RING_STEPS + DIST_STEPS),
                           generator=torch.Generator().manual_seed(13), dtype=torch.int32)
    layout_ref = {}
    with torch.inference_mode(), unrecorded():
        logits, _ = dist_paths(dev, model, params, dist_ctx("capacity"), d_tokens.to(dev),
                               d_feed.to(dev))
    layout_ref["j mixtral"] = {k: v.cpu() for k, v in logits.items()}
    del model, params, logits
    gc.collect()
    torch.cuda.empty_cache()
    for key, _, _, dtype in DIST_INT8:
        from repro_torch.models.params import init_params_int8
        model = build_model(dist_config(DIST_DEPTH))
        params = init_params_int8(model.cfg, 0, device=dev, dtype=dtype)
        with torch.inference_mode(), unrecorded():
            logits, _ = dist_paths(dev, model, params, RunCtx(moe_strategy="dropless"),
                                   d_tokens.to(dev), d_feed.to(dev))
        layout_ref[key] = {k: v.cpu() for k, v in logits.items()}
        del model, params, logits
        gc.collect()
        torch.cuda.empty_cache()
    for key, arch, depth, _, _ in DIST_LAYOUTS:
        model = build_model(dist_config(depth, arch))
        params = model.init_params(0, device=dev, dtype=torch.float32)
        with torch.inference_mode():
            logits, _ = dist_paths(dev, model, params, dist_ctx("capacity"), d_tokens.to(dev),
                                   d_feed.to(dev))
        layout_ref[key] = {k: v.cpu() for k, v in logits.items()}
        del model, params, logits
        gc.collect()
        torch.cuda.empty_cache()
    mm_extras = {}
    for key, arch, _ in DIST_MM:
        model = build_model(mm_config(arch, 2))
        params = model.init_params(0, device=dev, dtype=torch.float32)
        mm_extras[key] = dist_mm_extras(model.cfg, len(lens))
        with torch.inference_mode():
            logits, _ = dist_mm_paths(dev, model, params, dist_ctx("capacity"),
                                      d_tokens.to(dev), d_feed.to(dev), mm_extras[key])
        layout_ref[key] = {k: v.cpu() for k, v in logits.items()}
        del model, params, logits
        gc.collect()
        torch.cuda.empty_cache()

    # (b) and (c): four gloo ranks
    t0 = time.perf_counter()
    job = dict(tokens=tokens.cpu(), lens=lens, b_fed=b_fed, c_fed=gen_tokens, device=str(dev),
               hook=hook, d_tokens=d_tokens, d_feed=d_feed, mm_extras=mm_extras)
    outs = spawn_ranks(dist_rank, 4, (job,), store_dir=store / "ranks", backend="gloo",
                       timeout_s=DIST_TIMEOUT_S)
    res["ranks_s"] = time.perf_counter() - t0
    r0 = outs[0]
    for name, shape, strategy in DIST_MESHES:
        b = r0["b"][name]
        err = held(b["logits"], f"(b) {strategy} {shape}")
        pack_err = max_err(b["pack"], ref_pack)
        assert pack_err < LOGIT_ATOL and torch.equal(b["pack"].argmax(-1), ref_pack.argmax(-1)), \
            f"(b) {strategy} {shape}: the decode_chunk pack differs by {pack_err}"
        for o in outs:
            ob = o["b"][name]
            assert ob["drops"] == 0, f"(b) rank {o['rank']} dropped {ob['drops']} assignments"
            assert ob["param_bytes"] == ob["spec_bytes"], (o["rank"], name, ob)
        for k in ("flash_attention", "paged_attention", "chunked_prefill_attention"):
            assert b["launches"][k] > 0, f"(b) {name}: {k} never launched: {b['launches']}"
        assert b["launches"]["moe_gmm"] == 0, b["launches"]
        res[f"b_{name}"] = dict(max_abs_logit=err, pack_max_abs_logit=pack_err,
                                launches=b["launches"],
                                param_bytes=[o["b"][name]["param_bytes"] for o in outs])
        log(f"  (b) gloo, 4 ranks, mesh {shape}, {strategy}, {dist_config(DIST_DEPTH).name} "
            f"fp32: prefill + {DIST_STEPS} decode_steps within {err:.3g} and the decode_chunk "
            f"pack within {pack_err:.3g} of the unsharded run (< {LOGIT_ATOL}), argmax equal, "
            f"no token dropped; rank 0 launches {b['launches']}; parameter bytes per rank "
            f"{res[f'b_{name}']['param_bytes']} (each its specs' shard sum)")
    c = r0["c"]
    worst, flips = bf16_held(c["logits"], gen_logits, "(c) against phase 5's")
    for o in outs:
        assert o["c"]["drops"] == 0 and o["c"]["param_bytes"] == o["c"]["spec_bytes"], \
            (o["rank"], o["c"]["drops"], o["c"]["param_bytes"], o["c"]["spec_bytes"])
    for k in ("flash_attention", "paged_attention"):
        assert c["launches"][k] > 0, f"(c): {k} never launched: {c['launches']}"
    assert c["launches"]["moe_gmm"] == 0, c["launches"]
    B = len(lens)
    prefill_ms, step_ms = 1e3 * c["times"][0], 1e3 * float(np.mean(c["times"][1:]))
    res["c"] = dict(layers=SERVE_LAYERS, mesh=list(DIST_MESHES[0][1]), strategy="ep_shardmap",
                    max_rel_logit=worst, argmax_flips=flips,
                    prefill_ms=prefill_ms, decode_step_ms_mean=step_ms,
                    decode_tok_s=B / (step_ms / 1e3),
                    tok_s=B * (DIST_C_STEPS + 1) / sum(c["times"]), init_s=c["init_s"],
                    launches=c["launches"], launches_by_path=c["paths"],
                    param_bytes=[o["c"]["param_bytes"] for o in outs],
                    peak_bytes=[o["c"]["peak_bytes"] for o in outs])
    log(f"  (c) gloo, 4 ranks, mesh (1, 2, 2), ep_shardmap, {dist_config(SERVE_LAYERS).name} "
        f"bf16, teacher-forced with phase 5's tokens: every logit row within {worst:.3g} of "
        f"its max |logit| of phase 5's (< {DIST_BF16_RTOL}), {len(flips)} argmax flips, each a "
        f"rounding tie; no token dropped")
    log(f"  (c) prefill of {B} prompts {lens}: {prefill_ms:.3f} ms; {DIST_C_STEPS} decode_steps: "
        f"{step_ms:.3f} ms a step, {res['c']['decode_tok_s']:.2f} tok/s in decode, "
        f"{res['c']['tok_s']:.2f} tok/s over the generation (4 ranks on one card, gloo through "
        f"the host); each rank's init {c['init_s']:.1f} s (rank 0)")
    log(f"  (c) parameter GB per rank {[round(x / 1e9, 3) for x in res['c']['param_bytes']]} "
        f"(each its specs' shard sum), peak device GB per rank "
        f"{[round(x / 1e9, 3) for x in res['c']['peak_bytes']]}; rank 0 launches "
        f"{c['launches']}, by path {c['paths']}")
    layouts = ([(key, dist_config(depth, arch), shape, strategy)
                for key, arch, depth, shape, strategy in DIST_LAYOUTS]
               + [(key, mm_config(arch, 2), shape, "tp_shardmap") for key, arch, shape in DIST_MM])
    for key, cfg, shape, strategy in layouts:
        lay, ref = r0["layouts"][key], layout_ref[key]
        what = f"({key}) {cfg.name} {shape} {strategy}"
        errs = {p: max_err(lay["logits"][p], ref[p]) for p in ref}
        assert set(lay["logits"]) == set(ref) and max(errs.values()) < LOGIT_ATOL, \
            f"{what}: logits differ from the unsharded run by {errs}"
        flips = [p for p in ref if not torch.equal(lay["logits"][p].argmax(-1), ref[p].argmax(-1))]
        assert not flips, f"{what}: greedy tokens differ from the unsharded run at {flips}"
        for o in outs:
            ol = o["layouts"][key]
            assert ol["drops"] == 0 and ol["param_bytes"] == ol["spec_bytes"], \
                (o["rank"], key, ol["drops"], ol["param_bytes"], ol["spec_bytes"])
        launched, kinds = lay["launches"][0], "".join(g.pattern for g in cfg.layer_groups)
        for k, want in (("flash_attention", "A" in kinds), ("paged_attention", "A" in kinds),
                        ("chunked_prefill_attention", "A" in kinds), ("ssd_scan", "M" in kinds),
                        ("moe_gmm", False)):
            assert (launched[k] > 0) == want, f"{what}: {k} launched {launched[k]}: {launched}"
        secs = lay["secs"]
        res[key] = dict(config=cfg.name, layers=cfg.n_layers, mesh=list(shape), strategy=strategy,
                        dtype="float32", prompt=DIST_PROMPT, max_abs_logit=max(errs.values()),
                        max_abs_logit_by_path=errs, launches=launched,
                        launches_by_path=lay["launches"][1],
                        prefill_ms=1e3 * secs["prefill"],
                        ring_step_ms=1e3 * float(np.mean(secs["ring"])),
                        decode_step_ms=1e3 * float(np.mean(secs["paged"])),
                        pack_ms=1e3 * secs["pack"],
                        param_bytes=[o["layouts"][key]["param_bytes"] for o in outs],
                        peak_bytes=[o["layouts"][key]["peak_bytes"] for o in outs])
        extra = ("" if cfg.encoder is None and cfg.vision is None else
                 f" ({DIST_FRAMES} frames a row)" if cfg.encoder is not None else
                 f" ({cfg.vision.n_patches} patches a row)")
        log(f"  ({key}) gloo, 4 ranks, mesh {shape}, {strategy}, {cfg.name} fp32, {B} prompts of "
            f"{DIST_PROMPT} tokens{extra}: prefill, {DIST_RING_STEPS} ring and {DIST_STEPS} pool "
            f"decode_steps and the decode_chunk pack within {max(errs.values()):.3g} of the "
            f"unsharded run (< {LOGIT_ATOL}), argmax equal, no token dropped; rank 0 launches "
            f"{ {k: v for k, v in launched.items() if v} }")
        log(f"  ({key}) prefill {res[key]['prefill_ms']:.3f} ms, ring decode_step "
            f"{res[key]['ring_step_ms']:.3f} ms, pool decode_step {res[key]['decode_step_ms']:.3f} "
            f"ms, pack {res[key]['pack_ms']:.3f} ms (rank 0, 4 ranks on one card, gloo through "
            f"the host); parameter GB per rank "
            f"{[round(x / 1e9, 3) for x in res[key]['param_bytes']]} (each its specs' shard "
            f"sum), peak device GB per rank {[round(x / 1e9, 3) for x in res[key]['peak_bytes']]}")
    # (i): the int8 trees against the card's unsharded int8 runs
    cfg = dist_config(DIST_DEPTH)
    for key, shape, strategy, dtype in DIST_INT8:
        lay, ref = r0["layouts"][key], layout_ref[key]
        what = f"({key}) {cfg.name} int8 {shape} {strategy}"
        assert set(lay["logits"]) == set(ref), what
        if dtype == torch.float32:
            errs = {p: max_err(lay["logits"][p], ref[p]) for p in ref}
            assert max(errs.values()) < LOGIT_ATOL, \
                f"{what}: logits differ from the unsharded int8 run by {errs}"
            flips = [p for p in ref
                     if not torch.equal(lay["logits"][p].argmax(-1), ref[p].argmax(-1))]
            assert not flips, f"{what}: greedy tokens differ from the unsharded run at {flips}"
            err = max(errs.values())
        else:
            err, flips = bf16_held([lay["logits"][p] for p in ref], list(ref.values()), what)
        for o in outs:
            ol = o["layouts"][key]
            assert ol["drops"] == 0 and ol["param_bytes"] == ol["spec_bytes"], \
                (o["rank"], key, ol["drops"], ol["param_bytes"], ol["spec_bytes"])
        launched = lay["launches"][0]
        for k in ("flash_attention", "paged_attention", "chunked_prefill_attention",
                  "w8a16_matmul", "moe_gmm"):
            assert launched[k] > 0, f"{what}: {k} never launched: {launched}"
        secs = lay["secs"]
        res[key] = dict(config=cfg.name, layers=cfg.n_layers, mesh=list(shape), strategy=strategy,
                        weights="int8", dtype=str(dtype)[6:], prompt=DIST_PROMPT,
                        max_logit_err=err, err_kind="abs" if dtype == torch.float32 else
                        "rel to the row's max |logit|", argmax_flips=flips,
                        launches=launched, launches_by_path=lay["launches"][1],
                        prefill_ms=1e3 * secs["prefill"],
                        ring_step_ms=1e3 * float(np.mean(secs["ring"])),
                        decode_step_ms=1e3 * float(np.mean(secs["paged"])),
                        pack_ms=1e3 * secs["pack"],
                        param_bytes=[o["layouts"][key]["param_bytes"] for o in outs],
                        peak_bytes=[o["layouts"][key]["peak_bytes"] for o in outs])
        log(f"  ({key}) gloo, 4 ranks, mesh {shape}, {strategy}, {cfg.name} int8 weights "
            f"(init_params_int8(mesh=)), {str(dtype)[6:]} activations, {B} prompts of "
            f"{DIST_PROMPT} tokens: prefill, {DIST_RING_STEPS} ring and {DIST_STEPS} pool "
            f"decode_steps and the decode_chunk pack within {err:.3g} "
            + (f"(< {LOGIT_ATOL}) of the unsharded int8 run, argmax equal" if not flips and
               dtype == torch.float32 else
               f"of each row's max |logit| (< {DIST_BF16_RTOL}) of the unsharded int8 run, "
               f"{len(flips)} argmax flips, each a tie")
            + f", no token dropped; rank 0 launches {launched}, by path {lay['launches'][1]}")
        log(f"  ({key}) prefill {res[key]['prefill_ms']:.3f} ms, ring decode_step "
            f"{res[key]['ring_step_ms']:.3f} ms, pool decode_step {res[key]['decode_step_ms']:.3f} "
            f"ms, pack {res[key]['pack_ms']:.3f} ms (rank 0); int8 parameter GB per rank "
            f"{[round(x / 1e9, 3) for x in res[key]['param_bytes']]} (each its int8 specs' "
            f"shard sum), peak device GB per rank "
            f"{[round(x / 1e9, 3) for x in res[key]['peak_bytes']]}")
    # (j): the sequence-parallel rule against the unsharded runs
    for key, arch, depth, shape, strategy, base in DIST_SEQ:
        cfg = dist_config(depth, arch)
        lay, ref = r0["layouts"][key], layout_ref[base]
        what = f"({key}) {cfg.name} {shape} {strategy} seq_shard"
        errs = {p: max_err(lay["logits"][p], ref[p]) for p in ref}
        assert set(lay["logits"]) == set(ref) and max(errs.values()) < LOGIT_ATOL, \
            f"{what}: logits differ from the unsharded run by {errs}"
        flips = [p for p in ref if not torch.equal(lay["logits"][p].argmax(-1), ref[p].argmax(-1))]
        assert not flips, f"{what}: greedy tokens differ from the unsharded run at {flips}"
        for o in outs:
            ol = o["layouts"][key]
            assert ol["drops"] == 0 and ol["param_bytes"] == ol["spec_bytes"], \
                (o["rank"], key, ol["drops"], ol["param_bytes"], ol["spec_bytes"])
            assert ol["reduce_scatters"] > 0, f"{what}: rank {o['rank']} reduce-scattered nothing"
        launched = lay["launches"][0]
        for k in ("flash_attention", "paged_attention", "chunked_prefill_attention"):
            assert launched[k] > 0, f"{what}: {k} never launched: {launched}"
        secs = lay["secs"]
        res[key] = dict(config=cfg.name, layers=cfg.n_layers, mesh=list(shape), strategy=strategy,
                        dtype="float32", prompt=DIST_PROMPT, seq_shard=True,
                        max_abs_logit=max(errs.values()), max_abs_logit_by_path=errs,
                        reduce_scatters=[o["layouts"][key]["reduce_scatters"] for o in outs],
                        launches=launched, launches_by_path=lay["launches"][1],
                        prefill_ms=1e3 * secs["prefill"],
                        ring_step_ms=1e3 * float(np.mean(secs["ring"])),
                        decode_step_ms=1e3 * float(np.mean(secs["paged"])),
                        pack_ms=1e3 * secs["pack"],
                        param_bytes=[o["layouts"][key]["param_bytes"] for o in outs],
                        peak_bytes=[o["layouts"][key]["peak_bytes"] for o in outs])
        log(f"  ({key}) gloo, 4 ranks, mesh {shape}, {strategy}, {cfg.name} fp32 under "
            f"make_rules(seq_shard=True), {B} prompts of {DIST_PROMPT} tokens: every path within "
            f"{max(errs.values()):.3g} of the unsharded run (< {LOGIT_ATOL}), argmax equal; "
            f"reduce-scatters per rank {res[key]['reduce_scatters']}; prefill "
            f"{res[key]['prefill_ms']:.3f} ms, ring decode_step {res[key]['ring_step_ms']:.3f} ms, "
            f"pool decode_step {res[key]['decode_step_ms']:.3f} ms, pack "
            f"{res[key]['pack_ms']:.3f} ms (rank 0); peak device GB per rank "
            f"{[round(x / 1e9, 3) for x in res[key]['peak_bytes']]}")
    for k, v in r0["served"].items():
        SERVED[k].update(tuple(x) for x in v)
    res["launches"] = {k: res["a"]["launches"][k] + sum(res[f"b_{n}"]["launches"][k]
                                                         for n, _, _ in DIST_MESHES)
                       + c["launches"][k] + sum(res[key]["launches"][k]
                                                for key, *_ in (DIST_LAYOUTS + DIST_MM
                                                                + DIST_INT8 + DIST_SEQ))
                       for k in c["launches"]}
    return res


# ------------------------------------------------------------------ phase 9
def spec_plans(dev, cfg, shapes, ps: int, maxp: int):
    """The paths chunked attention's and gmm's plans name for the
    ``decode_chunk`` call shapes (B, C) of a run, bf16 (gmm sees top_k rows
    a token: padded positions of a verify row are routed too)."""
    from repro_torch.kernels.moe_gmm import kernel as gk
    from repro_torch.kernels.paged_attention import kernel as ak
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    bf = torch.bfloat16
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    attn = {ak._plan(B, C, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, ps, maxp, bf, bf,
                     n_sm).path for B, C in shapes}
    gmm = {gk._plan(B * C * k, K, N, E, bf, bf, n_sm).path for B, C in shapes
           for K, N in ((cfg.d_model, cfg.moe.d_expert), (cfg.moe.d_expert, cfg.d_model))}
    return attn, gmm


def run_spec(dev, model, params, *, slots_list=SPEC_SLOTS, new_tokens: int = SPEC_NEW,
             int8: bool = False, profile: bool = False):
    """Phase 9 (and phase 7's speculative run): greedy serving of the
    extractive / boilerplate mix (``sample_workload(WorkloadSpec(...,
    extractive_frac=0.5, boilerplate_frac=0.5, seed=0))``, the first
    ``slots`` prompts) at each ``max_slots`` with as many requests, once
    with speculation off and once with ``spec_k`` = 4. Every request
    finishes, the allocator invariants hold and every page is free again;
    with speculation the engine ran verify sweeps and drafted, chunked
    attention launched inside ``decode_chunk`` calls of every width that
    ran (C = 2, 3 and 5 over the runs), and the chunked attention and gmm
    launches (and w8a16's on ``int8`` weights; counters set to 0 just
    before each run) took exactly the paths their plans name for the run's
    call shapes. Prints tok/s and wall time off and on, the acceptance
    rate, steps, ms a verify sweep against a plain decode sweep, and how
    many leading tokens of each stream equal the run without speculation
    (printed only: bf16 near-ties can split two kernel paths)."""
    from repro_torch.core import EngineConfig, InferenceEngine, Request
    from repro_torch.kernels.moe_gmm import gmm_tiles_cuda
    from repro_torch.kernels.paged_attention import chunked_prefill_cuda
    from repro_torch.kernels.quant_matmul import w8a16_matmul_cuda
    counted = {"chunked_prefill_attention": chunked_prefill_cuda, "moe_gmm": gmm_tiles_cuda,
               "w8a16_matmul": w8a16_matmul_cuda}
    cfg = model.cfg
    prompts, max_seq = spec_workload()
    totals = dict.fromkeys(counted, 0)
    runs, widths_seen = [], set()
    for slots in slots_list:
        batch = prompts[:slots]
        pair = {}
        for spec in (False, True):
            eng = InferenceEngine(model, params, EngineConfig(
                max_slots=slots, page_size=16, num_pages=STACK_PAGES, max_seq=max_seq,
                prefill_chunk=STACK_PACK[1], greedy=True, cache_dtype=torch.bfloat16,
                enable_speculative=spec, spec_k=4, device=str(dev)))
            # warm-up request: allocator pools and cuBLAS handles, not measured
            eng.generate([Request(req_id="warm", prompt_tokens=batch[0][:40],
                                  max_new_tokens=8)])
            eng.step_records.clear()
            spec0 = (eng.spec_steps, eng.drafted_tokens, eng.accepted_tokens)
            # each decode_chunk call's shape and the attention launches inside it
            shapes, launched_at, chunk_call = set(), {}, model.decode_chunk

            def recorded(*args, **kw):
                n0 = chunked_prefill_cuda.launches
                out = chunk_call(*args, **kw)
                B, C = args[1].shape
                shapes.add((B, C))
                launched_at[C] = launched_at.get(C, 0) + chunked_prefill_cuda.launches - n0
                return out

            reqs = [Request(req_id=f"{'s' if spec else 'b'}{slots}-{i}", prompt_tokens=p,
                            max_new_tokens=new_tokens) for i, p in enumerate(batch)]
            model.decode_chunk = recorded
            for fn in counted.values():
                fn.launches = 0
                fn.launches_by_path = dict.fromkeys(fn.launches_by_path, 0)
            try:
                t0 = time.perf_counter()
                eng.generate(reqs)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                del model.decode_chunk
            launches = {k: fn.launches for k, fn in counted.items()}
            by_path = {k: dict(fn.launches_by_path) for k, fn in counted.items()}
            bad = [(r.req_id, len(r.generated)) for r in reqs
                   if not (r.finished and len(r.generated) == new_tokens)]
            assert not bad, f"spec={spec} slots={slots}: requests that did not finish: {bad}"
            a = eng.allocator
            a.check_invariants()
            assert a.free_pages == a.num_pages - 1 and a.live_pages == 0, \
                f"spec={spec} slots={slots}: {a.free_pages} free pages of {a.num_pages - 1}"
            steps = (eng.spec_steps - spec0[0], eng.drafted_tokens - spec0[1],
                     eng.accepted_tokens - spec0[2])
            if spec:
                assert steps[0] > 0 and steps[1] > 0, \
                    f"slots={slots}: the engine never drafted (spec_steps, drafted) {steps[:2]}"
                for C, n in launched_at.items():
                    if C in VERIFY_WIDTHS:
                        assert n > 0, f"slots={slots}: no attention launch in a C={C} sweep"
                widths_seen |= {C for C in launched_at if C in VERIFY_WIDTHS}
                for k in counted:
                    totals[k] += launches[k]
            assert launches["chunked_prefill_attention"] > 0 and launches["moe_gmm"] > 0 \
                and (launches["w8a16_matmul"] > 0) == int8, \
                f"spec={spec} slots={slots}: a kernel never ran: {launches}"
            attn_plan, gmm_plan = spec_plans(dev, cfg, shapes, 16, eng.cfg.max_pages_per_seq)
            used = {k: {p for p, n in v.items() if n > 0} for k, v in by_path.items()}
            assert used["chunked_prefill_attention"] == attn_plan \
                and used["moe_gmm"] == gmm_plan, \
                f"spec={spec} slots={slots}: launches left their planned paths: {by_path}, " \
                f"planned attention {sorted(attn_plan)}, gmm {sorted(gmm_plan)} for call " \
                f"shapes {sorted(shapes)}"
            recs = list(eng.step_records)
            verify = [x.duration for x in recs if x.prefill_rows == 0 and x.drafted_tokens > 0]
            plain = [x.duration for x in recs
                     if x.prefill_rows == 0 and x.decode_rows > 0 and x.drafted_tokens == 0]
            n_tok = sum(len(r.generated) for r in reqs)
            pair[spec] = dict(
                spec=spec, wall_s=wall, tok_s=n_tok / wall, steps=len(recs),
                spec_steps=steps[0], drafted_tokens=steps[1], accepted_tokens=steps[2],
                acceptance_rate=steps[2] / steps[1] if steps[1] else None,
                verify_sweep_ms_mean=1e3 * float(np.mean(verify)) if verify else None,
                verify_sweeps=len(verify),
                decode_sweep_ms_mean=1e3 * float(np.mean(plain)) if plain else None,
                decode_sweeps=len(plain), call_shapes=sorted(shapes),
                attention_launches_by_width=dict(sorted(launched_at.items())),
                launches=launches, launches_by_path=by_path,
                streams=[list(r.generated) for r in reqs])
            if spec and profile:
                preqs = [Request(req_id=f"p{slots}-{i}", prompt_tokens=p, max_new_tokens=16)
                         for i, p in enumerate(batch)]
                pair[spec]["profile"] = profile_window(
                    lambda: eng.generate(preqs),
                    f"speculative, {slots} slots, {slots} requests x 16 tokens")
            del eng
            torch.cuda.empty_cache()
        off, on = pair[False], pair[True]
        lead = []
        for x, y in zip(off["streams"], on["streams"]):
            n = next((i for i, (u, v) in enumerate(zip(x, y)) if u != v), len(x))
            lead.append(n)
        run = dict(slots=slots, requests=len(batch), new_tokens=new_tokens,
                   prompt_tokens=[len(p) for p in batch], off=off, on=on,
                   speedup=on["tok_s"] / off["tok_s"], leading_equal=lead,
                   streams_equal=sum(n == new_tokens for n in lead))
        for d in (off, on):
            del d["streams"]
        runs.append(run)
        fmt = (lambda v: "n/a" if v is None else f"{v:.3f}")
        log(f"  {slots} slots x {len(batch)} requests x {new_tokens} tokens ({cfg.name}, "
            f"{'int8' if int8 else 'bf16'}): spec off {off['tok_s']:.2f} tok/s in "
            f"{off['wall_s']:.3f} s over {off['steps']} steps; spec_k=4 {on['tok_s']:.2f} "
            f"tok/s in {on['wall_s']:.3f} s over {on['steps']} steps ({run['speedup']:.3f}x); "
            f"acceptance {on['accepted_tokens']} / {on['drafted_tokens']} = "
            f"{fmt(on['acceptance_rate'])}, {on['spec_steps']} verify sweeps")
        log(f"    ms a step: verify sweep {fmt(on['verify_sweep_ms_mean'])} "
            f"x{on['verify_sweeps']}, plain decode sweep with speculation on "
            f"{fmt(on['decode_sweep_ms_mean'])} x{on['decode_sweeps']}, off "
            f"{fmt(off['decode_sweep_ms_mean'])} x{off['decode_sweeps']}; call shapes "
            f"{on['call_shapes']}, attention launches by width "
            f"{on['attention_launches_by_width']}")
        log(f"    launches by path {on['launches_by_path']}")
        log(f"    leading tokens equal to the run without speculation: {lead} "
            f"({run['streams_equal']} of {len(batch)} streams equal; printed only)")
    return dict(config=cfg.name, layers=cfg.n_layers, weights="int8" if int8 else "bf16",
                workload="the first %d of sample_workload(WorkloadSpec(n_requests=%d, "
                         "vocab=32000, extractive_frac=0.5, boilerplate_frac=0.5, seed=0))"
                         % (max(slots_list), len(prompts)),
                max_seq=max_seq, runs=runs, widths_seen=sorted(widths_seen)), totals


# ------------------------------------------------------------------ phase 11
def mm_config(name: str, n_layers: int = 0):
    """seamless-m4t-large-v2 or phi-3-vision-4.2b at full width: full depth,
    or decoder (and encoder) cut to ``n_layers``."""
    import dataclasses

    from repro_torch.configs import LayerGroup, get_config
    cfg = get_config(name)
    if not n_layers:
        return cfg
    enc = dataclasses.replace(cfg.encoder, n_layers=n_layers) if cfg.encoder else None
    return cfg.scaled(name=f"{name}-{n_layers}L", n_layers=n_layers, encoder=enc,
                      layer_groups=(LayerGroup("A", n_layers),))


def mm_extras(cfg, n: int = MM_SLOTS, seed: int = 3) -> list:
    """Each request's stub frontend output from a seed, as a caller puts it
    in ``engine.extras``: ("frames", (1, MM_FRAMES[i], d_model)) or
    ("patches", (1, n_patches, d_patch)), fp32."""
    rng = np.random.default_rng(seed)
    if cfg.encoder is not None:
        return [("frames", rng.standard_normal((1, MM_FRAMES[i], cfg.d_model), np.float32))
                for i in range(n)]
    return [("patches", rng.standard_normal((1, cfg.vision.n_patches, cfg.vision.d_patch),
                                            np.float32)) for _ in range(n)]


def mm_batch_extras(cfg, extras: list, dev) -> dict:
    """A batch's frames (B, cross_attn_memory, d), each request's cropped or
    zero-padded as the engine's ``_row_extras`` does, or patches (B,
    n_patches, d_patch), on ``dev``."""
    if cfg.encoder is not None:
        M = cfg.encoder.cross_attn_memory
        fr = np.zeros((len(extras), M, cfg.d_model), np.float32)
        for i, (_, v) in enumerate(extras):
            fr[i, :min(M, v.shape[1])] = v[0, :M]
        return {"frames": torch.from_numpy(fr).to(dev)}
    return {"patches": torch.from_numpy(np.concatenate([v for _, v in extras])).to(dev)}


def copy_cross(dst, src):
    """The cross caches of ``src`` (prefill's dense cache) into ``dst``."""
    for dg, sg in zip(dst["groups"], src["groups"]):
        for dc, sc in zip(dg, sg):
            for k in ("ck", "cv") if "cross" in sc else ():
                dc["cross"][k].copy_(sc["cross"][k])


def build_mm(dev, name: str):
    """Full-width, full-depth ``name``, random bf16 weights from seed 0."""
    from repro_torch.models import build_model
    from repro_torch.models.params import map_tree
    cfg = mm_config(name)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(0, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    sizes = []
    map_tree(lambda t: sizes.append(t.numel() * t.element_size()), params)
    depth = (f"{cfg.encoder.n_layers} encoder + {cfg.n_layers} decoder layers" if cfg.encoder
             else f"{cfg.n_layers} layers, {cfg.vision.n_patches} patches of "
                  f"{cfg.vision.d_patch}")
    info = dict(config=cfg.name, layers=cfg.n_layers, weights="bf16",
                weights_gb=sum(sizes) / 1e9, init_s=init_s,
                init_peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"  {cfg.name}: full width (d_model {cfg.d_model}, {cfg.n_heads} heads of "
        f"{cfg.head_dim}, vocab {cfg.vocab}), full depth ({depth}), random bf16 weights from "
        f"seed 0: {info['weights_gb']:.2f} GB, init {init_s:.1f} s")
    return model, params, info


def run_mm_serving(dev, profile: bool, model, params):
    """Phase 11 (a) / (b): InferenceEngine.generate on 4 requests x 32 greedy
    tokens with each request's frames or patches in ``engine.extras``;
    every request finishes, the allocator invariants hold, every page is
    free again and the extras are dropped; chunked attention launched on
    its split (decode) and mma (packs) paths only, flash attention (the
    encoder and cross attention) on mma only. The VLM's run must pack a
    first chunk beside a later one."""
    from repro_torch.core import EngineConfig, InferenceEngine, Request, request_metrics
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.paged_attention import chunked_prefill_cuda
    cfg = model.cfg
    max_seq = MM_MAX_SEQ[cfg.name]
    ecfg = EngineConfig(max_slots=MM_SLOTS, page_size=16,
                        num_pages=MM_SLOTS * max_seq // 16 + 1, max_seq=max_seq,
                        prefill_chunk=STACK_PACK[1], greedy=True, cache_dtype=torch.bfloat16,
                        device=str(dev))
    eng = InferenceEngine(model, params, ecfg)
    assert eng.chunk_rows == STACK_PACK[0] and eng.prefix_cache is None
    rng = np.random.default_rng(1)
    extras = mm_extras(cfg)
    # warm-up request: cuBLAS handles and allocator pools, not measured
    eng.extras[("warm", extras[0][0])] = extras[0][1]
    eng.generate([Request(req_id="warm", prompt_tokens=prompts(rng, 1)[0][:40],
                          max_new_tokens=2)])
    reqs = [Request(req_id=f"r{i}", prompt_tokens=p, max_new_tokens=32)
            for i, p in enumerate(prompts(rng))]
    for r, (key, v) in zip(reqs, extras):
        eng.extras[(r.req_id, key)] = v
    eng.step_records.clear()
    packs, enc_events = [], []
    chunk_call, encode = model.decode_chunk, model._encode

    def recorded(*args, **kw):
        if kw.get("frames") is not None or kw.get("patches") is not None:
            live = args[4] > 0          # a pack's (first-chunk row, later-chunk row) flags
            packs.append((bool((live & (args[3] == 0)).any()),
                          bool((live & (args[3] > 0)).any())))
        return chunk_call(*args, **kw)

    def timed_encode(*args, **kw):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = encode(*args, **kw)
        b.record()
        enc_events.append((a, b))
        return out

    model.decode_chunk, model._encode = recorded, timed_encode
    for fn in (chunked_prefill_cuda, flash_attention_cuda):
        fn.launches = 0
        fn.launches_by_path = dict.fromkeys(fn.launches_by_path, 0)
    t0 = time.perf_counter()
    eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del model.decode_chunk, model._encode
    launches = {"chunked_prefill_attention": chunked_prefill_cuda.launches,
                "flash_attention": flash_attention_cuda.launches}
    attn_paths = dict(chunked_prefill_cuda.launches_by_path)
    flash_paths = dict(flash_attention_cuda.launches_by_path)
    assert all(r.finished and len(r.generated) == 32 for r in reqs), "a request did not finish"
    eng.allocator.check_invariants()
    assert eng.allocator.free_pages == ecfg.num_pages - 1, "pages still held after the run"
    assert not eng.extras, f"extras not dropped: {sorted(eng.extras)}"
    assert attn_paths["split"] > 0 and attn_paths["mma"] > 0 and attn_paths["tiled"] == 0, \
        f"{cfg.name}: chunked attention left its planned paths: {attn_paths}"
    if cfg.encoder is not None:
        assert flash_paths["mma"] > 0 and flash_paths["mma"] == launches["flash_attention"], \
            f"{cfg.name}: the encoder / cross attention left flash's mma path: {flash_paths}"
    mixed = sum(a and b for a, b in packs)
    if cfg.vision is not None:
        assert mixed > 0, f"no pack mixed a first chunk with a later one: {packs}"
    enc_ms = [a.elapsed_time(b) for a, b in enc_events]
    ms = [request_metrics(r) for r in reqs]
    n_tok = sum(m.n_tokens for m in ms)
    recs = list(eng.step_records)
    dec = [r.duration for r in recs if r.prefill_rows == 0 and r.decode_rows > 0]
    pre = [r.duration for r in recs if r.prefill_rows > 0]
    serve = dict(
        config=cfg.name, layers=cfg.n_layers, requests=len(reqs),
        prompt_tokens=[len(r.prompt_tokens) for r in reqs], new_tokens=32,
        extras=[list(v.shape) for _, v in extras], wall_s=wall, tok_s=n_tok / wall,
        steps=len(recs), ttft_ms=[m.ttft * 1e3 for m in ms], tbt_ms=[m.tbt * 1e3 for m in ms],
        decode_step_ms_mean=1e3 * float(np.mean(dec)) if dec else None,
        prefill_step_ms_mean=1e3 * float(np.mean(pre)) if pre else None,
        encoder_ms=enc_ms, packs_with_extras=len(packs), mixed_packs=mixed,
        launches=launches, attention_launches_by_path=attn_paths,
        flash_launches_by_path=flash_paths, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"  served {len(reqs)} requests x 32 new tokens (prompts {serve['prompt_tokens']}, "
        f"extras {serve['extras']}) in {wall:.3f} s over {len(recs)} steps: "
        f"{serve['tok_s']:.2f} tok/s, TTFT ms {[round(x, 2) for x in serve['ttft_ms']]}, "
        f"TBT ms {[round(x, 3) for x in serve['tbt_ms']]}, decode step "
        f"{serve['decode_step_ms_mean']:.3f} ms, prefill step "
        f"{serve['prefill_step_ms_mean']:.3f} ms, peak device memory "
        f"{serve['peak_mem_gb']:.2f} GB")
    if cfg.encoder is not None:
        log(f"  the encoder over the {len(enc_ms)} packs with a first row (2 rows x "
            f"{cfg.encoder.cross_attn_memory} frames, CUDA events around it): ms "
            f"{[round(x, 3) for x in enc_ms]}")
    else:
        log(f"  {len(packs)} packs carried the patch prefix; {mixed} of them mixed a first "
            f"chunk (starts 0, prefix live) with a later chunk (starts > 0, prefix dead)")
    log(f"  launches on the serving run: {launches}, chunked attention by path {attn_paths} "
        f"(head dim {cfg.head_dim}), flash by path {flash_paths}")
    if profile:     # short: the profiler's cost grows with these models' many small ops
        preqs = [Request(req_id=f"p{i}", prompt_tokens=p, max_new_tokens=2)
                 for i, p in enumerate(prompts(rng, 2))]
        for r, (key, v) in zip(preqs, extras):
            eng.extras[(r.req_id, key)] = v
        serve["profile"] = profile_window(lambda: eng.generate(preqs),
                                          f"{cfg.name}: 2 requests x 2 tokens")
    streams = [(r.prompt_tokens, list(r.generated)) for r in reqs]
    return serve, launches, streams, extras


def run_mm_generation(dev, model, params, streams, extras):
    """Phase 11's generation API: ``prefill`` of the serving run's prompts
    (right-padded) with their frames or patches into the dense cache, copied
    into the paged pool (the cross cache too), then GEN_STEPS greedy
    ``decode_step``s over it (paged decode; cross attention reads the cross
    cache). Flash attention (the encoder, cross attention, the prefill) on
    mma only, and paged decode, launched."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.models import RunCtx
    cfg = model.cfg
    ps, off = 16, cfg.vision.n_patches if cfg.vision is not None else 0
    M = cfg.encoder.cross_attn_memory if cfg.encoder is not None else 0
    lens = [len(p) for p, _ in streams]
    B, S = len(lens), max(lens)
    maxp = -(-(off + S + GEN_STEPS) // ps)
    toks = np.zeros((B, S), np.int32)
    for b, (p, _) in enumerate(streams):
        toks[b, :len(p)] = p
    batch = dict(tokens=torch.from_numpy(toks).to(dev), **mm_batch_extras(cfg, extras, dev))
    last = torch.tensor(lens, dtype=torch.int64, device=dev) - 1
    pt = (torch.arange(B * maxp, dtype=torch.int32, device=dev).reshape(B, maxp) + 1)
    ctx = RunCtx()

    def generate(n_steps):
        dense = model.init_cache(B, maxp * ps, torch.bfloat16, memory_len=M, device=dev)
        paged = model.init_cache(B, maxp * ps, torch.bfloat16, kind="paged", page_size=ps,
                                 num_pages=B * maxp + 1, memory_len=M, device=dev)
        out, times = [], []
        t0 = time.perf_counter()
        lg, dense = model.prefill(params, batch, dense, ctx, last_pos=last)
        nxt = lg.argmax(-1)
        fill_pool_from_ring(paged, dense, pt, ps)
        copy_cross(paged, dense)
        del dense
        out.append(nxt.cpu())
        times.append(time.perf_counter() - t0)
        pos = last.to(torch.int32) + 1 + off
        for _ in range(n_steps):
            t0 = time.perf_counter()
            lg, paged = model.decode_step(params, nxt[:, None].to(torch.int32), paged, pos, ctx,
                                          page_table=pt, lengths=pos + 1)
            nxt = lg.argmax(-1)
            out.append(nxt.cpu())
            times.append(time.perf_counter() - t0)
            pos = pos + 1
        return torch.stack(out, 1), times

    with torch.inference_mode():
        generate(2)
        torch.cuda.synchronize()
        for fn in (flash_attention_cuda, paged_attention_cuda):
            fn.launches = 0
        flash_attention_cuda.launches_by_path = dict.fromkeys(
            flash_attention_cuda.launches_by_path, 0)
        gen, times = generate(GEN_STEPS)
        torch.cuda.synchronize()
    launches = {"flash_attention": flash_attention_cuda.launches,
                "paged_attention": paged_attention_cuda.launches}
    flash_paths = dict(flash_attention_cuda.launches_by_path)
    assert launches["flash_attention"] > 0 and launches["paged_attention"] > 0, \
        f"{cfg.name}: a kernel never ran on the generation path: {launches}"
    assert flash_paths["mma"] == launches["flash_attention"], \
        f"{cfg.name}: flash attention left its planned path (bf16: mma): {flash_paths}"
    assert gen.shape == (B, GEN_STEPS + 1) and ((gen >= 0) & (gen < cfg.vocab)).all()
    prefill_ms, step_ms = 1e3 * times[0], 1e3 * float(np.mean(times[1:]))
    agree = []
    for b, (_, eng) in enumerate(streams):
        n = 0
        while n < len(eng) and int(gen[b, n]) == eng[n]:
            n += 1
        agree.append(n)
    res = dict(prompt_tokens=lens, padded_to=S, prefix=off, memory=M, new_tokens=GEN_STEPS,
               prefill_ms=prefill_ms, decode_step_ms_mean=step_ms,
               decode_tok_s=B / (step_ms / 1e3), tok_s=B * (GEN_STEPS + 1) / sum(times),
               launches=launches, flash_launches_by_path=flash_paths,
               leading_tokens_equal_engine=agree)
    log(f"  generation API: prefill of {B} prompts {lens} right-padded to {S} "
        + (f"after {off} patches " if off else f"with {M} frames each ")
        + f"{prefill_ms:.3f} ms (copy into the pool included); {GEN_STEPS} decode_steps over "
        f"the paged pool: {step_ms:.3f} ms per step, {res['decode_tok_s']:.2f} tok/s in "
        f"decode; launches {launches}, flash by path {flash_paths}; leading greedy tokens "
        f"equal to the engine's stream: {agree} of 32 (printed only)")
    return res, launches


def run_mm_card_vs_cpu(dev, name: str):
    """Phase 11 (c): ``name`` at depth 2 (encoder depth 2 too), full width,
    fp32, on the card and on the CPU, on the same inputs: ``decode_chunk``
    over a pack of sequence 1's first 16 tokens, then a pack that mixes
    sequence 0's first chunk (16 tokens) with sequence 1's later chunk
    (starts 16, 5 tokens) with their frames / patches, then a decode sweep;
    ``forward``; ``prefill`` of 16 tokens + 4 ``decode_step``s over the dense
    cache. Card vs CPU within LOGIT_ATOL with the same argmax; on the card
    the paths' logits also within LOGIT_ATOL of ``forward``'s at the same
    positions. Returns (card vs CPU, card paths vs forward)."""
    from repro_torch.models import RunCtx, build_model
    from repro_torch.models.params import map_tree
    cfg = mm_config(name, 2)
    model = build_model(cfg)
    params = model.init_params(0, device=dev, dtype=torch.float32)
    cpu_params = map_tree(lambda t: t.cpu(), params)
    off = cfg.vision.n_patches if cfg.vision is not None else 0
    rng = np.random.default_rng(0)
    ps, C, gen, n = 16, 16, 4, 22
    seq = rng.integers(1, 32000, (2, n)).astype(np.int32)
    extras = mm_extras(cfg, 2, seed=4)
    maxp = -(-(off + n) // ps)
    pt = np.stack([np.arange(1, 1 + maxp), np.arange(1 + maxp, 1 + 2 * maxp)]).astype(np.int32)
    pad = np.zeros((1, C), np.int32)
    # (tokens, starts, nvalid, slots, page-table rows, the rows' extras or None)
    calls = [(np.concatenate([seq[1:, :C], pad]), [0, 0], [C, 0], [1, 0], [1, 0], [1, None]),
             (np.stack([seq[0, :C], np.r_[seq[1, C:C + 5], [0] * (C - 5)]]), [0, C], [C, 5],
              [0, 1], [0, 1], [0, 1]),
             (np.array([[seq[0, C]], [seq[1, C + 5]]], np.int32), [C, C + 5], [1, 1], [0, 1],
              [0, 1], None)]
    logits = {}
    for key, where, p in (("card", dev, params), ("cpu", "cpu", cpu_params)):
        out = {}
        with torch.inference_mode():
            cache = model.init_cache(2, off + n, kind="paged", page_size=ps,
                                     num_pages=2 * maxp + 1, device=where)
            for i, (tok, st, nv, slots, rows, ext) in enumerate(calls):
                st, nv = np.asarray(st, np.int32), np.asarray(nv, np.int32)
                t = [torch.from_numpy(a).to(where)
                     for a in (tok, st, nv, np.asarray(slots, np.int32), (st == 0) & (nv > 0),
                               np.where(nv[:, None] > 0, pt[rows], 0).astype(np.int32))]
                kw = {}
                if ext is not None:
                    kw = mm_batch_extras(cfg, [extras[j] if j is not None else
                                               (extras[0][0], 0 * extras[0][1]) for j in ext],
                                         where)
                lg, cache = model.decode_chunk(p, *t[:1], cache, *t[1:5], RunCtx(), t[5], **kw)
                out[f"decode_chunk {i}"] = lg[torch.from_numpy(nv > 0).to(where)]
            batch = dict(tokens=torch.from_numpy(seq).to(where),
                         **mm_batch_extras(cfg, extras, where))
            out["forward"], _ = model.forward(p, batch, RunCtx())
            M = cfg.encoder.cross_attn_memory if cfg.encoder is not None else 0
            dense = model.init_cache(2, off + n, memory_len=M, device=where)
            out["prefill"], dense = model.prefill(p, dict(batch, tokens=batch["tokens"][:, :C]),
                                                  dense, RunCtx())
            for i in range(gen):
                pos = torch.full((2,), off + C + i, dtype=torch.int32, device=where)
                out[f"decode_step {i}"], dense = model.decode_step(
                    p, batch["tokens"][:, C + i:C + i + 1], dense, pos, RunCtx())
        logits[key] = {k: v.float().cpu() for k, v in out.items()}
    worst = 0.0
    for k, a in logits["card"].items():
        b = logits["cpu"][k]
        assert torch.isfinite(a).all() and a.shape[-1] == cfg.vocab, k
        err = max_err(a, b)
        worst = max(worst, err)
        assert err < LOGIT_ATOL, f"{name} {k}: card vs CPU logits differ by {err}"
        assert torch.equal(a.argmax(-1), b.argmax(-1)), f"{name} {k}: argmax differs"
    card, fwd = logits["card"], logits["card"]["forward"]
    pairs = [(card["decode_chunk 0"][0], fwd[1, off + C - 1]),
             (card["decode_chunk 1"][0], fwd[0, off + C - 1]),
             (card["decode_chunk 1"][1], fwd[1, off + C + 4]),
             (card["decode_chunk 2"][0], fwd[0, off + C]),
             (card["decode_chunk 2"][1], fwd[1, off + C + 5]),
             (card["prefill"], fwd[:, off + C - 1])]
    pairs += [(card[f"decode_step {i}"], fwd[:, off + C + i]) for i in range(gen)]
    cross = max(max_err(a, b) for a, b in pairs)
    assert cross < LOGIT_ATOL, f"{name}: paths disagree with forward on the card by {cross}"
    log(f"  {name} depth 2 (encoder 2), full width, fp32, card vs CPU: decode_chunk (a first "
        f"chunk; a pack mixing a first chunk with a later one, "
        + ("frames" if cfg.encoder is not None else f"{off}-patch prefix")
        + f"; a decode sweep), forward, prefill + {gen} decode_steps: max |dlogit| = "
        f"{worst:.3g} < {LOGIT_ATOL}, argmax equal; on the card vs forward at the same "
        f"positions: {cross:.3g}")
    return worst, cross


# ------------------------------------------------------------------ phase 12
TRAIN_ARCH = "qwen2.5-3b"          # the reference launcher's default arch
# (a)'s depth: 36 -> 18 layers, so the crash run's checkpoint and the
# resume's read of it (75 s of a 600 s run at 36 layers) make room for
# phase 13. At 9 layers (PR 30) the loss did not fall over the 8 steps at
# lr 1e-3 (12.13 -> a mean of 13.41 over steps 6-8 on an H100)
TRAIN_LAYERS = 18
TRAIN_BATCH, TRAIN_SEQ = 4, 512
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_CRASH_AT = 8, 4, 6
# a full-width qwen2.5-3b checkpoint (bf16 parameters, fp32 moments) is 34.0
# GB, and the card's machine ends a call once 45 GiB were written to its
# disk, deleted files included: so phase 12 writes one, the crash run's
# (step 4); the uninterrupted run has no checkpoint directory, and the
# resume's checkpointer is stubbed
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 2, 4
# (b)'s peak lr: at 1e-3 (a's) AdamW's first, sign-like updates of the
# random full-width experts send mixtral's loss up (10.78 -> 18.82 at step
# 2 on an H100); (a)'s qwen falls at 1e-3 over 8 steps
MOE_TRAIN_LR = 1e-4
# (a): the resumed run's losses against the uninterrupted run's, absolute:
# the card's atomic sums (the embedding backward's) are order-dependent, so
# the two runs' states at step 4 need not be bit-equal
RESUME_TOL = 2e-2
TRAIN_LOSS_RTOL = 1e-4             # (c): card vs CPU loss, relative
TRAIN_GRAD_TOL = 1e-3              # (c): each leaf against its max |g|
# (c)'s step: AdamW's m against the CPU's within TRAIN_GRAD_TOL of its max,
# v (quadratic in g) within twice that, each plus one step of the leaf's
# int8 gradient quantizer (an element on a rounding boundary may round
# either way: m moves by max|m| / 127, v by at most 253 / 127**2 of max v);
# and the card's new parameters against AdamW recomputed in float64 from
# the card's own moments, within ADAMW_RTOL of lr x (1 + |update|) plus
# two fp32 ulps of the parameter
ADAMW_RTOL = 1e-5


def adamw_step_err(before, after, m, v, *, lr: float, step: int, weight_decay: float,
                   b1=0.9, b2=0.95, eps=1e-8) -> float:
    """The worst |new parameter - AdamW's| over its tolerance (see
    ADAMW_RTOL): AdamW (the optimizer's defaults) recomputed in float64
    from the parameters before the step and the moments after it, so a
    skipped, sign-flipped or mis-scaled step fails where the moments
    agree."""
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    worst = 0.0
    for leaves in zip(before, after, m, v):
        p0, p1, mm, vv = (t.reshape(-1) for t in leaves)
        for i in range(0, p0.numel(), 1 << 24):       # bounded float64 temporaries
            a, b, c, d = (t[i:i + (1 << 24)].double() for t in (p0, p1, mm, vv))
            delta = (c / bc1) / (torch.sqrt(d / bc2) + eps) + weight_decay * a
            want = a - lr * delta
            tol = (ADAMW_RTOL * lr * (1 + delta.abs())
                   + 2.0 ** -22 * torch.maximum(a.abs(), want.abs()))
            worst = max(worst, float(((b - want).abs() / tol).max()))
    return worst


def train_config(**kw):
    from repro_torch.training.train_step import TrainConfig
    return TrainConfig(**{**dict(peak_lr=1e-3, warmup=2, remat=True, xent_chunk=128), **kw})


def kernel_wrappers() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda, flash_attention_cuda
    from repro_torch.kernels.moe_gmm import gmm_tiles_cuda
    from repro_torch.kernels.paged_attention import chunked_prefill_cuda, paged_attention_cuda
    from repro_torch.kernels.quant_matmul import w8a16_matmul_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda, ssd_scan_cuda
    return {"chunked_prefill_attention": chunked_prefill_cuda, "moe_gmm": gmm_tiles_cuda,
            "flash_attention": flash_attention_cuda,
            "flash_attention_bwd": flash_attention_bwd_cuda,
            "paged_attention": paged_attention_cuda, "ssd_scan": ssd_scan_cuda,
            "ssd_scan_bwd": ssd_scan_bwd_cuda, "w8a16_matmul": w8a16_matmul_cuda}


def zero_launches() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0
        if hasattr(fn, "launches_by_path"):
            fn.launches_by_path = dict.fromkeys(fn.launches_by_path, 0)


def read_launches() -> tuple:
    fns = kernel_wrappers()
    return ({k: fn.launches for k, fn in fns.items()},
            {k: dict(fn.launches_by_path) for k, fn in fns.items()
             if hasattr(fn, "launches_by_path")})


def run_training(dev, profile: bool = False):
    """Phase 12 (a) and (b): the trainer (``training.trainer.train``) on the
    card; with ``profile``, a torch.profiler window over one more qwen2.5-3b
    step after the uninterrupted run. Returns (results, launches of both,
    their paths)."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import latest_step
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.params import count_params_analytic
    from repro_torch.data.pipeline import synthesize_batch
    from repro_torch.training import trainer as trainer_mod
    from repro_torch.training.train_step import make_train_step
    from repro_torch.training.trainer import CrashForTest, TrainerConfig, train

    tokens = TRAIN_BATCH * TRAIN_SEQ
    zero_launches()
    res = {}

    # (a) qwen2.5-3b at full width, TRAIN_LAYERS deep: an uninterrupted
    # run, a run that checkpoints at step 4 and crashes at step 6, and a
    # resume from it
    cfg = depth_cut(get_config(TRAIN_ARCH), TRAIN_LAYERS)
    model = build_model(cfg)
    n_params = count_params_analytic(cfg)
    dcfg = DataConfig(vocab=cfg.vocab, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    tcfg = train_config()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    checkpointer = trainer_mod.AsyncCheckpointer

    class NoSaves:
        """The trainer's checkpointer with its saves dropped."""
        def __init__(self, directory, keep=3):
            pass

        def save(self, step, tree, extra_meta=None):
            pass

        def wait(self):
            pass

    def run(rcfg, window=False):
        gc.collect()
        torch.cuda.empty_cache()
        params = model.init_params(0, device=dev, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            out = train(model, dcfg, tcfg, rcfg, params=params)
            if window:
                _, step_fn = make_train_step(model, tcfg)
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in synthesize_batch(dcfg, rcfg.steps).items()}
                out["profile"] = profile_window(
                    lambda: step_fn(out["params"], out["state"], batch),
                    f"one {cfg.name} train step")
            del out["params"], out["state"]          # the next run needs the memory
        except CrashForTest as crash:
            out = dict(crashed=True, losses=crash.losses, step_seconds=crash.step_seconds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        del params
        return out, wall, peak

    try:
        full, wall_a, peak_a = run(TrainerConfig(steps=TRAIN_STEPS), window=profile)
        crashed, wall_b, _ = run(TrainerConfig(steps=TRAIN_STEPS, ckpt_dir=str(root),
                                               ckpt_every=TRAIN_CKPT_EVERY,
                                               crash_at=TRAIN_CRASH_AT))
        assert crashed.get("crashed") and len(crashed["losses"]) == TRAIN_CRASH_AT, \
            "the run with crash_at did not crash there"
        assert latest_step(str(root)) == TRAIN_CKPT_EVERY
        ckpt_gb = sum(f.stat().st_size for f in (root / f"step_{TRAIN_CKPT_EVERY:08d}").iterdir()
                      ) / 1e9
        # the resume writes nothing: the trainer's checkpointer is stubbed
        trainer_mod.AsyncCheckpointer = NoSaves
        try:
            resumed, wall_c, _ = run(TrainerConfig(steps=TRAIN_STEPS, ckpt_dir=str(root),
                                                   ckpt_every=TRAIN_CKPT_EVERY))
        finally:
            trainer_mod.AsyncCheckpointer = checkpointer
        assert latest_step(str(root)) == TRAIN_CKPT_EVERY
    finally:
        shutil.rmtree(root, ignore_errors=True)
    losses = full["losses"]
    assert all(np.isfinite(losses)) and all(np.isfinite(resumed["losses"])), "a loss is not finite"
    assert np.mean(losses[5:8]) < losses[0], f"{TRAIN_ARCH}: the loss did not fall: {losses}"
    assert resumed["start"] == TRAIN_CKPT_EVERY, f"resumed at step {resumed['start']}"
    resume_err = max(abs(a - b) for a, b in zip(resumed["losses"], losses[TRAIN_CKPT_EVERY:]))
    assert resume_err <= RESUME_TOL, \
        f"resumed losses {resumed['losses']} vs {losses[TRAIN_CKPT_EVERY:]}: {resume_err}"
    step_s = float(np.median(full["step_seconds"][1:]))
    share = 6.0 * n_params * tokens / step_s / PEAK_FLOPS[torch.bfloat16]
    # the crash run's and the resume's time outside their steps: the
    # checkpoint's host copy and write, and its read and copy back
    ckpt_s = wall_b - sum(crashed["step_seconds"])
    restore_s = wall_c - sum(resumed["step_seconds"])
    res["qwen"] = dict(config=cfg.name, params=n_params, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                       steps=TRAIN_STEPS, losses=losses, resumed_losses=resumed["losses"],
                       resume_max_abs_err=resume_err, step_seconds=full["step_seconds"],
                       step_ms_median=1e3 * step_s, tokens_per_s=tokens / step_s,
                       peak_gb=peak_a, bf16_peak_share=share, ckpt_gb=ckpt_gb,
                       wall_s=dict(uninterrupted=wall_a, crashed=wall_b, resumed=wall_c),
                       save_s=ckpt_s, restore_s=restore_s, metrics=full["metrics"],
                       profile=full.get("profile"))
    log(f"  (a) {cfg.name} full width, depth cut 36 -> {cfg.n_layers} layers "
        f"({n_params / 1e9:.2f} B "
        f"params), random bf16 weights from seed 0, {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step, "
        f"remat, xent_chunk 128: losses {[round(x, 4) for x in losses]}; step "
        f"{1e3 * step_s:.1f} ms (median of steps 2-{TRAIN_STEPS}), {tokens / step_s:.0f} tok/s, "
        f"peak {peak_a:.2f} GB, 6 N tokens / step time = {100 * share:.1f}% of the bf16 peak "
        f"(printed only); the run checkpointing at step {TRAIN_CKPT_EVERY} ({ckpt_gb:.1f} GB) "
        f"and crashing at step {TRAIN_CRASH_AT}: {wall_b:.1f} s, {ckpt_s:.1f} s of it outside "
        f"the steps; the resume from step {resumed['start']}: {wall_c:.1f} s, {restore_s:.1f} s "
        f"of it outside the steps; resumed losses "
        f"{[round(x, 4) for x in resumed['losses']]}, max |diff| {resume_err:.3g} <= "
        f"{RESUME_TOL}")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # (b) mixtral-8x7b at full width, depth cut, the capacity MoE
    cfg = mixtral(MOE_TRAIN_LAYERS)
    model = build_model(cfg)
    dropped = []
    dispatch = moe_mod.capacity_dispatch

    def counted(xf, topi, E, cap):
        ebuf, info = dispatch(xf, topi, E, cap)
        dropped.append((int((~info[2]).sum()), info[2].numel(), cap))
        return ebuf, info

    moe_mod.capacity_dispatch = counted
    try:
        params = model.init_params(0, device=dev, dtype=torch.bfloat16)
        torch.cuda.reset_peak_memory_stats()
        out = train(model, DataConfig(vocab=cfg.vocab, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ),
                    train_config(peak_lr=MOE_TRAIN_LR), TrainerConfig(steps=MOE_TRAIN_STEPS),
                    params=params)
        peak_b = torch.cuda.max_memory_allocated() / 1e9
    finally:
        moe_mod.capacity_dispatch = dispatch
    del params
    moe_losses = out["losses"]
    assert all(np.isfinite(moe_losses)) and moe_losses[-1] < moe_losses[0], \
        f"{cfg.name}: losses not finite and falling: {moe_losses}"
    # remat: each step routes every layer twice (the forward and its
    # recompute), the same way; the forward's calls come first
    per_step = [dropped[i * 2 * cfg.n_layers:i * 2 * cfg.n_layers + cfg.n_layers]
                for i in range(MOE_TRAIN_STEPS)]
    n_moe = count_params_analytic(cfg)
    res["mixtral"] = dict(config=cfg.name, layers=cfg.n_layers, params=n_moe, losses=moe_losses,
                          aux=[m["aux"] for m in out["metrics"]], dropped=per_step,
                          step_seconds=out["step_seconds"], peak_gb=peak_b)
    log(f"  (b) {cfg.name}: full width, {depth_note(cfg)}, {n_moe / 1e9:.2f} B params, random "
        f"bf16 weights, capacity MoE (factor {cfg.moe.capacity_factor}), peak lr "
        f"{MOE_TRAIN_LR}: losses "
        f"{[round(x, 4) for x in moe_losses]}, aux {[round(a, 4) for a in res['mixtral']['aux']]}, "
        f"assignments dropped by layer (of {per_step[0][0][1]}, capacity {per_step[0][0][2]} "
        f"an expert) {[[d for d, _, _ in s] for s in per_step]}; step "
        f"{1e3 * float(np.median(out['step_seconds'][1:])):.1f} ms, peak {peak_b:.2f} GB")
    del model, out
    gc.collect()
    torch.cuda.empty_cache()
    launches, paths = read_launches()
    assert launches["flash_attention"] > 0 and launches["flash_attention_bwd"] > 0, \
        f"flash attention or its backward never ran on the training path: {launches}"
    assert paths["flash_attention"]["mma"] == launches["flash_attention"] and \
        paths["flash_attention_bwd"]["mma"] == launches["flash_attention_bwd"], \
        f"flash attention left its planned paths (bf16: mma; backward: mma): {paths}"
    idle = {k: n for k, n in launches.items()
            if k not in ("flash_attention", "flash_attention_bwd")}
    assert not any(idle.values()), f"training reached a kernel it must not: {idle}"
    log(f"  training launches: {launches}, flash by path {paths['flash_attention']}, backward "
        f"{paths['flash_attention_bwd']}")
    return res, launches, paths


MAMBA_TRAIN_ARCH = "mamba2-1.3b"


def run_mamba_training(dev, profile: bool = False):
    """Phase 12 (d): mamba2-1.3b at full width and depth through
    ``training.trainer.train``, phase 12 (a)'s corpus, batch, remat and
    schedule, TRAIN_STEPS steps and no checkpoint (the card's machine ends
    a call after 45 GiB of disk writes, and (a) writes one). Every loss
    finite and the mean of steps 6-8 below step 1's; the SSD forward
    and backward launched on their ``mma`` paths only, no
    other kernel of the port. With ``profile``, a torch.profiler window
    over one more step. Returns (results, launches, their paths)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, synthesize_batch
    from repro_torch.models import build_model
    from repro_torch.models.params import count_params_analytic
    from repro_torch.training.train_step import make_train_step
    from repro_torch.training.trainer import TrainerConfig, train
    cfg = get_config(MAMBA_TRAIN_ARCH)
    model = build_model(cfg)
    n_params = count_params_analytic(cfg)
    dcfg = DataConfig(vocab=cfg.vocab, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)
    tcfg = train_config()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    gc.collect()
    torch.cuda.empty_cache()
    params = model.init_params(0, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    out = train(model, dcfg, tcfg, TrainerConfig(steps=TRAIN_STEPS), params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches, paths = read_launches()
    losses = out["losses"]
    assert all(np.isfinite(losses)), f"{cfg.name}: a loss is not finite: {losses}"
    assert np.mean(losses[5:8]) < losses[0], f"{cfg.name}: the loss did not fall: {losses}"
    assert launches["ssd_scan"] > 0 and launches["ssd_scan_bwd"] > 0, \
        f"the SSD scan or its backward never ran on the training path: {launches}"
    assert paths["ssd_scan"]["mma"] == launches["ssd_scan"] and \
        paths["ssd_scan_bwd"]["mma"] == launches["ssd_scan_bwd"], \
        f"the SSD kernels left their planned paths (bf16: forward and backward mma): {paths}"
    idle = {k: n for k, n in launches.items() if k not in ("ssd_scan", "ssd_scan_bwd")}
    assert not any(idle.values()), f"mamba2 training reached a kernel it must not: {idle}"
    step_s = float(np.median(out["step_seconds"][1:]))
    share = 6.0 * n_params * tokens / step_s / PEAK_FLOPS[torch.bfloat16]
    res = dict(config=cfg.name, layers=cfg.n_layers, params=n_params, batch=TRAIN_BATCH,
               seq=TRAIN_SEQ, steps=TRAIN_STEPS, losses=losses,
               step_seconds=out["step_seconds"], step_ms_median=1e3 * step_s,
               tokens_per_s=tokens / step_s, peak_gb=peak, bf16_peak_share=share, wall_s=wall,
               launches=launches, launches_by_path={k: paths[k] for k in ("ssd_scan",
                                                                          "ssd_scan_bwd")})
    log(f"  (d) {cfg.name} full width and depth ({cfg.n_layers} layers, {n_params / 1e9:.2f} B "
        f"params), random bf16 weights from seed 0, {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step, "
        f"remat, no checkpoint: losses {[round(x, 4) for x in losses]}; step "
        f"{1e3 * step_s:.1f} ms (median of steps 2-{TRAIN_STEPS}), {tokens / step_s:.0f} tok/s, "
        f"peak {peak:.2f} GB, 6 N tokens / step time = {100 * share:.1f}% of the bf16 peak "
        f"(printed only); SSD launches {launches['ssd_scan']} forward (by path "
        f"{paths['ssd_scan']}), {launches['ssd_scan_bwd']} backward (by path "
        f"{paths['ssd_scan_bwd']})")
    if profile:
        _, step_fn = make_train_step(model, tcfg)
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in synthesize_batch(dcfg, TRAIN_STEPS).items()}
        res["profile"] = profile_window(lambda: step_fn(out["params"], out["state"], batch),
                                        f"one {cfg.name} train step")
    del out, params, model
    gc.collect()
    torch.cuda.empty_cache()
    return res, launches, paths


def train_card_vs_cpu(dev, cfg, step: bool):
    """Phase 12 (c): ``cfg`` (full width, depth cut) in fp32 on the card and
    on the CPU, same weights and 2 x 32 tokens: the loss within
    TRAIN_LOSS_RTOL, every gradient leaf within TRAIN_GRAD_TOL of its max
    |g|; with ``step``, one ``step_fn`` with 2 microbatches and int8 gradient
    compression: its loss within TRAIN_LOSS_RTOL, AdamW's moments against
    the CPU's and the card's parameters against AdamW on the card's own
    moments (see ADAMW_RTOL). The parameters are not held against the
    CPU's directly: AdamW's first update is nearly sign(g) times lr, so an
    element whose gradient sits near 0 (or on an int8 rounding boundary)
    may move by +-lr on either side. Returns the worst errors."""
    from repro_torch.data.pipeline import DataConfig, synthesize_batch
    from repro_torch.models import RunCtx, build_model
    from repro_torch.models.params import map_tree, tree_leaves, tree_unflatten
    from repro_torch.training.train_step import TrainConfig, make_train_step
    model = build_model(cfg)
    params = model.init_params(0, device=dev, dtype=torch.float32)
    cpu_params = map_tree(lambda t: t.to("cpu", copy=True), params)
    data = synthesize_batch(DataConfig(vocab=cfg.vocab, batch=2, seq_len=32), 0)
    ctx = RunCtx(mode="train", moe_strategy="capacity", remat=True)
    got = {}
    for key, where, p in (("card", dev, params), ("cpu", "cpu", cpu_params)):
        batch = {k: torch.from_numpy(v).to(where) for k, v in data.items()}
        leaves = [t.detach().requires_grad_() for t in tree_leaves(p)]
        n0, _ = read_launches()
        loss, _ = model.loss(tree_unflatten(p, leaves), batch, ctx)
        grads = torch.autograd.grad(loss, leaves)
        n1, _ = read_launches()
        launched = {k: n1[k] - n0[k] for k in n1 if n1[k] > n0[k]}
        assert bool(launched) == (key == "card"), f"{cfg.name} on the {key}: {launched}"
        got[key] = (float(loss.detach()), [g.cpu() for g in grads])
        if key == "card":
            card_launched = launched
        del leaves, grads
    if "M" in "".join(g.pattern for g in cfg.layer_groups):
        assert card_launched.get("ssd_scan", 0) > 0 and card_launched.get("ssd_scan_bwd", 0) > 0, \
            f"{cfg.name}: the SSD kernels did not run on the card: {card_launched}"
    loss_err = abs(got["card"][0] - got["cpu"][0]) / abs(got["cpu"][0])
    grad_err = max(max_err(a, b) / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(got["card"][1], got["cpu"][1]))
    assert loss_err <= TRAIN_LOSS_RTOL, f"{cfg.name}: loss card vs CPU rel err {loss_err}"
    assert grad_err <= TRAIN_GRAD_TOL, f"{cfg.name}: gradients card vs CPU rel err {grad_err}"
    del got
    out = dict(loss_rel_err=loss_err, grad_rel_err=grad_err, card_launches=card_launched)
    msg = (f"  {cfg.name}: fp32, full width, depth {cfg.n_layers}, card vs CPU on 2 x 32 "
           f"tokens: loss rel err {loss_err:.3g} <= {TRAIN_LOSS_RTOL}, worst gradient leaf "
           f"{grad_err:.3g} of its max |g| <= {TRAIN_GRAD_TOL}; the card's launches "
           f"{card_launched}")
    if step:
        tcfg = TrainConfig(microbatches=2, grad_compression=True, xent_chunk=16)
        init_fn, step_fn = make_train_step(model, tcfg)
        new = {}
        for key, where, p in (("card", dev, params), ("cpu", "cpu", cpu_params)):
            batch = {k: torch.from_numpy(v).to(where) for k, v in data.items()}
            before = [t.clone() for t in tree_leaves(p)] if key == "card" else None
            p, (opt, _), metrics = step_fn(p, init_fn(p), batch)
            lr = float(metrics["lr"])
            if before is not None:
                adamw_err = adamw_step_err(before, tree_leaves(p), tree_leaves(opt.m),
                                           tree_leaves(opt.v), lr=lr, step=int(opt.step),
                                           weight_decay=tcfg.weight_decay)
                del before
            new[key] = (float(metrics["loss"]), lr, [t.cpu() for t in tree_leaves(opt.m)],
                        [t.cpu() for t in tree_leaves(opt.v)])
            del opt
        step_loss = abs(new["card"][0] - new["cpu"][0]) / abs(new["cpu"][0])
        lr = new["cpu"][1]
        moment_err = max(max(max_err(a, b) / ((TRAIN_GRAD_TOL + 1 / 127) * float(b.abs().max())
                                               + 1e-30)
                             for a, b in zip(new["card"][2], new["cpu"][2])),
                         max(max_err(a, b) / ((2 * TRAIN_GRAD_TOL + 253 / 127 ** 2)
                                              * float(b.abs().max()) + 1e-30)
                             for a, b in zip(new["card"][3], new["cpu"][3])))
        assert step_loss <= TRAIN_LOSS_RTOL and moment_err <= 1.0 and adamw_err <= 1.0, (
            f"{cfg.name}: step_fn card vs CPU: loss {step_loss}, moments at {moment_err} of "
            f"their bound; the card's parameters at {adamw_err} of AdamW's tolerance")
        out.update(step_loss_rel_err=step_loss, moment_err_of_bound=moment_err,
                   adamw_err_of_tol=adamw_err)
        msg += (f"; step_fn (2 microbatches, int8 gradients with error feedback, "
                f"xent_chunk 16, lr {lr:.3g}): loss rel err {step_loss:.3g}, AdamW's m / v "
                f"against the CPU's at {moment_err:.3g} of their bound, the card's parameters "
                f"against AdamW in float64 on its own moments at {adamw_err:.3g} of the "
                f"tolerance")
    log(msg)
    del params, cpu_params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------------ phase 14
# distributed training, on phase 13's machinery: (a) NCCL at world 1 in
# this process; (b) and (c) on four gloo ranks spawned on the one card.
# (a) / (b) hold one step against the unsharded one on the card in fp32;
# (c) trains in bf16 at full width for a few steps.
DIST_TRAIN_QWEN = 2                # (a), (b): qwen2.5-3b's depth
DIST_TRAIN_MOE = 1                 # (b): mixtral-8x7b's depth
DIST_TRAIN_BATCH, DIST_TRAIN_SEQ = 4, 32   # (a), (b): 2 rows a data rank, 1 a microbatch
DIST_TRAIN_SAMPLE = 4096           # (b): elements of each leaf held against the card's step
# (c): (name, arch, depth, mesh, MoE strategy, peak lr). Phase 12 (b)'s lr
# for both: at phase 12 (a)'s 1e-3 a 4-step qwen2.5-3b run on the CPU
# rehearsal went 12.40, 11.00, 16.68, 10.69 (random full-width weights).
# mixtral at depth 1: at depth 2 it fits (17.45 GB peak a rank) but took
# 53.3 s of a 144.6 s phase 14 (13.3 s a step: each rank's 1.41 GB of
# gathered bf16 experts a layer goes card -> host -> gloo -> host -> card
# in the forward, remat's recompute and the backward's reduce-scatter)
DIST_TRAIN_BF16 = (("qwen", TRAIN_ARCH, 4, (2, 1, 2), "tp_shardmap", MOE_TRAIN_LR),
                   ("mixtral", "mixtral-8x7b", 1, (2, 2, 1), "ep_shardmap", MOE_TRAIN_LR))
DIST_TRAIN_STEPS = 2
# (f): the sequence-parallel rule (``make_rules("train", seq_shard=True)``)
# on a case of (d): its name -> the case whose unsharded step it is held
# against
DIST_TRAIN_SEQ_OF = {"qwen kv_seq seq": "qwen kv_seq"}
DIST_TRAIN_TIMEOUT_S = 300
DIST_TRAIN_A_LOSS_RTOL = 1e-5      # (a): the mesh's step against the unsharded one, relative
DIST_TRAIN_A_GRAD_TOL = 1e-4       # (a): each leaf against its max |g|


def dist_train_rules(strategy: str, seq_shard: bool = False):
    from repro_torch.distributed.sharding import make_rules
    return make_rules("train", moe="ep" if strategy == "ep_shardmap" else "tp",
                      tensor_axis="tensor", expert_axis="expert", seq_shard=seq_shard)


def dist_train_ctx(strategy: str, mesh=None, remat: bool = True):
    from repro_torch.models import RunCtx
    if mesh is None:
        return RunCtx(mode="train", moe_strategy="capacity", remat=remat)
    return RunCtx(mode="train", mesh=mesh, moe_strategy=strategy, ep_axis="expert",
                  tp_axis="tensor", remat=remat)


def dist_train_cases():
    """(b), (d) and (e)'s checks: (name, config, mesh, MoE strategy, train
    config, data-split aux, a whole step (else the loss and its gradient)).
    (b): qwen2.5-3b with 2 microbatches and int8 gradients (the mesh's step
    is the unsharded one), mixtral-8x7b with the MoE aux of each data shard
    (the reference's semantics under a data split). (d), the layouts
    training under a mesh once refused, qwen's step: qwen2.5-3b on (1, 1, 4)
    (kv_seq: its 2 kv heads whole on every tensor rank), mamba2-1.3b on (1,
    1, 2) (in_proj, conv channels, SSD heads and d_inner split), jamba's
    first two layers on (1, 2, 2) ep_shardmap (a mamba layer with a dense
    MLP, then one with the 16-expert MoE), its loss and gradient alone: its
    fp32 step would hold 4 copies of its 11.3 GB MoE layer on the ranks
    and 4 of the whole 14.7 GB in the parent. (e) seamless (2 encoder and 2
    decoder layers, DIST_FRAMES frames a row) and phi-3-vision (2 layers,
    576 patches a row) on (2, 1, 2), qwen's step. (f) (d)'s qwen2.5-3b on (1,
    1, 4) under the sequence-parallel rule (DIST_TRAIN_SEQ_OF: held against
    (d)'s unsharded step), where kv_seq and seq meet."""
    from repro_torch.configs import get_config
    from repro_torch.training.train_step import TrainConfig
    both = TrainConfig(microbatches=2, grad_compression=True, xent_chunk=16)
    qwen = depth_cut(get_config(TRAIN_ARCH), DIST_TRAIN_QWEN)
    return (("qwen", qwen, (2, 1, 2), "tp_shardmap", both, False, True),
            ("mixtral", dist_config(DIST_TRAIN_MOE), (2, 2, 1), "ep_shardmap",
             TrainConfig(xent_chunk=16), True, True),
            ("qwen kv_seq", qwen, (1, 1, 4), "tp_shardmap", both, False, True),
            ("mamba2", mamba2(2), (1, 1, 2), "tp_shardmap", both, False, True),
            ("jamba", dist_config(2, "jamba-v0.1-52b"), (1, 2, 2), "ep_shardmap",
             TrainConfig(xent_chunk=16), False, False),
            ("seamless", mm_config(MM_SEAMLESS, 2), (2, 1, 2), "tp_shardmap", both, False, True),
            ("phi-3-vision", mm_config(MM_VISION, 2), (2, 1, 2), "tp_shardmap", both, False,
             True),
            ("qwen kv_seq seq", qwen, (1, 1, 4), "tp_shardmap", both, False, True))


def dist_train_batch(cfg, dev):
    """phase 12 (a)'s corpus, DIST_TRAIN_BATCH rows of DIST_TRAIN_SEQ
    tokens; seeded frames (DIST_FRAMES a row) for an enc-dec config and
    patches for a VLM."""
    from repro_torch.data.pipeline import DataConfig, synthesize_batch
    data = synthesize_batch(DataConfig(vocab=cfg.vocab, batch=DIST_TRAIN_BATCH,
                                       seq_len=DIST_TRAIN_SEQ), 0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    g = torch.Generator().manual_seed(16)
    if cfg.encoder is not None:
        batch["frames"] = torch.randn((DIST_TRAIN_BATCH, DIST_FRAMES, cfg.d_model),
                                      generator=g).to(dev)
    if cfg.vision is not None:
        batch["patches"] = torch.randn((DIST_TRAIN_BATCH, cfg.vision.n_patches,
                                        cfg.vision.d_patch), generator=g).to(dev)
    return batch


def split_aux_loss(model, params, batch, tcfg, data: int):
    """The loss a data split of ``data`` ranks trains, unsharded: the whole
    batch's cross-entropy plus ``aux_weight`` times the mean over the data
    shards of each shard's MoE aux (the reference's gradient under a data
    split). Returns (that loss, the xent, each shard's aux)."""
    ctx = dist_train_ctx("capacity")
    _, met = model.loss(params, batch, ctx, aux_weight=tcfg.aux_weight,
                        xent_chunk=tcfg.xent_chunk)
    n = batch["tokens"].shape[0] // data
    auxes = [model.loss(params, {k: v[d * n:(d + 1) * n] for k, v in batch.items()}, ctx,
                        aux_weight=tcfg.aux_weight, xent_chunk=tcfg.xent_chunk)[1]["aux"]
             for d in range(data)]
    return met["xent"] + tcfg.aux_weight * torch.stack(auxes).mean(), met["xent"], auxes


@contextlib.contextmanager
def adamw_input(seen: list):
    """While open, each ``adamw_update`` call of the train step appends the
    leaves of the gradient it takes to ``seen``: the reduced gradient,
    after the microbatches and the int8 round trip."""
    from repro_torch.models.params import tree_leaves
    from repro_torch.training import train_step as ts
    real = ts.adamw_update

    def spy(grads, *args, **kw):
        seen.append(tree_leaves(grads))
        return real(grads, *args, **kw)
    ts.adamw_update = spy
    try:
        yield seen
    finally:
        ts.adamw_update = real


def unsharded_train_step(model, params, batch, tcfg, data_aux: int = 0, step: bool = True):
    """One step on the card without a mesh, the parameters updated in
    place: (the step's loss, the gradient AdamW took, m, v). ``data_aux``:
    the loss is ``split_aux_loss`` over that many data shards (AdamW on its
    gradient, as ``step_fn`` without microbatches or compression), and the
    loss returned is (xent, each shard's aux). Without ``step``: (the loss,
    its gradient, None, None), the parameters untouched."""
    from repro_torch.models.params import tree_leaves, tree_unflatten
    from repro_torch.training.optimizer import adamw_init, adamw_update, cosine_schedule
    from repro_torch.training.train_step import make_train_step
    ctx = dist_train_ctx("capacity")
    if not step:
        assert not data_aux, "the data-split aux is held through a step"
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        loss, _ = model.loss(tree_unflatten(params, leaves), batch, ctx,
                             aux_weight=tcfg.aux_weight, xent_chunk=tcfg.xent_chunk)
        return float(loss), list(torch.autograd.grad(loss, leaves)), None, None
    if data_aux:
        assert tcfg.microbatches == 1 and not tcfg.grad_compression, tcfg
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        loss, xent, auxes = split_aux_loss(model, tree_unflatten(params, leaves), batch, tcfg,
                                           data_aux)
        grads = list(torch.autograd.grad(loss, leaves))
        del leaves
        lr = cosine_schedule(1, peak_lr=tcfg.peak_lr, warmup=tcfg.warmup, total=tcfg.total_steps)
        with torch.no_grad():
            _, opt = adamw_update(tree_unflatten(params, grads), adamw_init(params), params,
                                  lr=lr, weight_decay=tcfg.weight_decay, grad_clip=tcfg.grad_clip)
        return (float(xent), [float(a) for a in auxes]), grads, opt.m, opt.v
    init_fn, step_fn = make_train_step(model, tcfg, ctx)
    with adamw_input([]) as seen:
        params, (opt, _), met = step_fn(params, init_fn(params), batch)
    return float(met["loss"]), seen[0], opt.m, opt.v


def sample_leaves(trees: dict, seed: int) -> dict:
    """A seeded sample of each leaf's elements, by global flat position
    (each leaf's largest |value| of the first tree among them): {"idx":
    [positions a leaf], "shape": [...], name: [values a leaf], "max_" +
    name: [each leaf's max |value|]}, on the host."""
    from repro_torch.models.params import tree_leaves
    first = next(iter(trees))
    ref = [t for t in (trees[first] if isinstance(trees[first], (list, tuple))
                       else tree_leaves(trees[first]))]
    g = torch.Generator().manual_seed(seed)
    out = {"idx": [], "shape": [tuple(t.shape) for t in ref]}
    for t in ref:
        # drawn with replacement (a permutation of a 470 M-element leaf
        # takes seconds on the host), then made unique
        idx = torch.randint(t.numel(), (DIST_TRAIN_SAMPLE,), generator=g)
        top = int(t.detach().abs().reshape(-1).argmax())
        out["idx"].append(torch.unique(torch.cat([idx, torch.tensor([top])])))
    for name, tree in trees.items():
        leaves = tree if isinstance(tree, (list, tuple)) else tree_leaves(tree)
        out[name] = [t.detach().reshape(-1)[i.to(t.device)].cpu()
                     for t, i in zip(leaves, out["idx"])]
        out["max_" + name] = [float(t.detach().abs().max()) for t in leaves]
    return out


def local_sample(leaves, specs, mesh, sample) -> list:
    """The rank's values at the sample's global positions that fall in its
    shards: per leaf (the sample's indices held here, their values)."""
    from repro_torch.distributed.sharding import shard_slices
    out = []
    for t, spec, idx, shape in zip(leaves, specs, sample["idx"], sample["shape"]):
        coords = np.stack(np.unravel_index(idx.numpy(), shape))
        sl = shard_slices(shape, spec, mesh)
        lo = np.array([s.start for s in sl])[:, None]
        hi = np.array([s.stop for s in sl])[:, None]
        mine = np.all((coords >= lo) & (coords < hi), axis=0)
        local = np.ravel_multi_index(tuple(coords[:, mine] - lo), tuple((hi - lo)[:, 0]))
        vals = t.detach().reshape(-1)[torch.from_numpy(local).to(t.device)].cpu()
        out.append((np.nonzero(mine)[0], vals))
    return out


def dist_train_check(dev, mesh, name, cfg, strategy, tcfg, data_aux, sample, step=True):
    """(b), (d) or (e) on one rank: its shards of the seeded fp32 weights
    and one ``step_fn`` on the global batch; the step's loss, the sample's
    positions it holds of the gradient AdamW took, of m and of v, the worst
    AdamW recompute on its shards, and its trees' bytes against its
    specs'; the step's wall ms and the rank's peak device bytes. Without
    ``step``: the loss and its reduced gradient alone."""
    from repro_torch.distributed.sharding import use_sharding
    from repro_torch.models import build_model
    from repro_torch.models.moe import count_drops
    from repro_torch.models.params import tree_leaves, tree_unflatten
    from repro_torch.training.train_step import (make_train_step, mesh_specs, reduce_grads,
                                                spec_leaves)
    model = build_model(cfg)
    rules = dist_train_rules(strategy, seq_shard=name in DIST_TRAIN_SEQ_OF)
    # no remat: the recompute would gather every leaf once more through the
    # host, and (c) trains with it
    ctx = dist_train_ctx(strategy, mesh, remat=False)
    batch = dist_train_batch(cfg, dev)
    torch.cuda.reset_peak_memory_stats()
    with use_sharding(mesh, rules), count_drops() as drops, adamw_input([]) as seen, \
            counting_reduce_scatters() as rs:
        tree = mesh_specs(model, ctx)[1]
        specs = spec_leaves(tree)
        params = model.init_params(0, device=dev, dtype=torch.float32, mesh=mesh, rules=rules)
        torch.cuda.synchronize()
        if not step:
            t0 = time.perf_counter()
            leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
            loss, met = model.loss(tree_unflatten(params, leaves), batch, ctx,
                                   aux_weight=tcfg.aux_weight, xent_chunk=tcfg.xent_chunk)
            grads = reduce_grads(list(torch.autograd.grad(loss, leaves)), mesh, tree)
            torch.cuda.synchronize()
            del leaves
            return dict(loss=float(loss), aux=float(met["aux"]), drops=drops.total(),
                        reduce_scatters=rs.n, grads=local_sample(grads, specs, mesh, sample),
                        ms=1e3 * (time.perf_counter() - t0),
                        peak_bytes=torch.cuda.max_memory_allocated(),
                        bytes={"params": tensor_bytes(params)},
                        spec_bytes=spec_bytes(model, mesh, rules, 4))
        before = [t.clone() for t in tree_leaves(params)]
        init_fn, step_fn = make_train_step(model, tcfg, ctx)
        t0 = time.perf_counter()
        params, (opt, err), met = step_fn(params, init_fn(params), batch)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
    return dict(loss=float(met["loss"]), aux=float(met["aux"]), lr=float(met["lr"]),
                ms=ms, peak_bytes=torch.cuda.max_memory_allocated(), reduce_scatters=rs.n,
                drops=drops.total(), grads=local_sample(seen[0], specs, mesh, sample),
                m=local_sample(tree_leaves(opt.m), specs, mesh, sample),
                v=local_sample(tree_leaves(opt.v), specs, mesh, sample),
                adamw=adamw_step_err(before, tree_leaves(params), tree_leaves(opt.m),
                                     tree_leaves(opt.v), lr=float(met["lr"]),
                                     step=int(opt.step), weight_decay=tcfg.weight_decay),
                bytes={k: tensor_bytes(t) for k, t in (("params", params), ("m", opt.m),
                                                        ("v", opt.v), ("err", err))
                       if t is not None},
                spec_bytes=spec_bytes(model, mesh, rules, 4))


def dist_train_rank(rank: int, world: int, job: dict):
    """One spawned rank of phase 14 (b) and (c), on cuda:0 with gloo. Rank
    0 zeroes the kernels' counters before (b) and before (c) and reads them
    after each, and records the call shapes. Returns what the parent
    checks."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.distributed.sharding import use_sharding
    from repro_torch.kernels import build as kbuild
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.models.moe import count_drops
    from repro_torch.training.trainer import TrainerConfig, train
    if job.get("hook"):
        job["hook"]()                              # the CPU rehearsal's stubs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(job["device"])
    torch.cuda.set_device(dev)
    for name in ("flash_attention", "flash_attention_bwd"):
        kbuild.load_library(name)                  # built by phase 1; the build lock guards it
    # a mesh of fewer ranks than the world binds the first ones; the
    # others skip its cases
    meshes = {}
    for shape in sorted({c[2] for c in dist_train_cases()} | {c[3] for c in DIST_TRAIN_BF16}):
        meshes[shape] = Mesh(shape, DIST_AXES).bind(ranks=range(int(np.prod(shape))))
    out = {"rank": rank, "b": {}, "c": {}}
    recording = served_shapes if rank == 0 else contextlib.nullcontext
    with recording():
        for name, cfg, shape, strategy, tcfg, data_aux, step in dist_train_cases():
            if meshes[shape].rank < 0:
                continue
            zero_launches()
            t0 = time.perf_counter()
            out["b"][name] = dist_train_check(dev, meshes[shape], name, cfg, strategy, tcfg,
                                              data_aux, job["samples"][name], step)
            out["b"][name]["seconds"] = time.perf_counter() - t0
            out["b"][name]["launches"] = read_launches()
            gc.collect()
            torch.cuda.empty_cache()
        for name, arch, depth, shape, strategy, lr in DIST_TRAIN_BF16:
            cfg = (depth_cut(get_config(arch), depth) if name == "qwen" else dist_config(depth))
            model = build_model(cfg)
            mesh, rules = meshes[shape], dist_train_rules(strategy)
            torch.cuda.reset_peak_memory_stats()
            zero_launches()
            t0 = time.perf_counter()
            with use_sharding(mesh, rules), count_drops() as drops:
                params = model.init_params(0, device=dev, dtype=torch.bfloat16, mesh=mesh,
                                           rules=rules)
                run = train(model, DataConfig(vocab=cfg.vocab, batch=TRAIN_BATCH,
                                              seq_len=TRAIN_SEQ),
                            train_config(peak_lr=lr), TrainerConfig(steps=DIST_TRAIN_STEPS),
                            params=params, ctx=dist_train_ctx(strategy, mesh))
                torch.cuda.synchronize()
            opt, _ = run["state"]
            out["c"][name] = dict(
                layers=cfg.n_layers, losses=run["losses"], aux=[m["aux"] for m in run["metrics"]],
                seconds=time.perf_counter() - t0,
                step_seconds=run["step_seconds"], drops=drops.total(),
                peak_bytes=torch.cuda.max_memory_allocated(),
                bytes={"params": tensor_bytes(run["params"]), "m": tensor_bytes(opt.m),
                       "v": tensor_bytes(opt.v)},
                spec_bytes={"params": spec_bytes(model, mesh, rules, 2),
                            "m": spec_bytes(model, mesh, rules, 4)},
                launches=read_launches())
            del run, params, opt, model
            gc.collect()
            torch.cuda.empty_cache()
    if rank == 0:
        out["served"] = {k: sorted(v) for k, v in SERVED.items()}
    return out


def run_dist_training(dev, hook=None):
    """Phase 14. (a) NCCL, world 1, in this process: qwen2.5-3b at depth 2,
    fp32, on the (1, 1, 1) train mesh: one ``step_fn`` (2 microbatches,
    int8 gradients) against the unsharded step on the card (its loss within
    1e-5 relative, each leaf of the gradient AdamW took within 1e-4 of its
    max |g|, m / v and the parameters as phase 12 (c) holds them). (b) four
    gloo ranks, fp32: qwen2.5-3b at depth 2 on
    (2, 1, 2) (FSDP + TP, the same step) and mixtral-8x7b at depth 1 on (2,
    2, 1) ``ep_shardmap`` (FSDP + EP, capacity factor E / K: no token drops)
    against the unsharded step (for mixtral with each data shard's aux,
    ``split_aux_loss``), on a seeded sample of each leaf of the gradient
    AdamW took, m and v, within phase 12 (c)'s bounds (qwen's int8 gradient
    with one quantum more: a rounding flip); each rank's loss (mixtral's:
    the whole batch's xent plus its data shard's aux); each rank's
    parameters against AdamW on its own moments; its parameter and moment
    bytes its specs' shard sums. (d), (e): the rest of ``dist_train_cases``
    held the same way (jamba's loss and gradient alone), each on the first
    ranks its mesh binds: the kv_seq layout, the mamba layers (the SSD scan
    and its backward launched), the enc-dec and VLM families. (c) the same
    ranks in bf16 at full width
    (DIST_TRAIN_BF16: qwen2.5-3b at depth 4 on (2, 1, 2), mixtral-8x7b at
    depth 1 on (2, 2, 1)), phase 12 (a)'s corpus, DIST_TRAIN_STEPS steps, no
    checkpoint: losses finite and
    falling, flash forward and backward on their ``mma`` path only, no
    other kernel. ``hook`` (a module-level callable) runs first in each
    rank: the CPU rehearsal's stubs."""
    import datetime
    import tempfile

    import torch.distributed as dist
    from repro_torch.distributed.ranks import spawn_ranks
    from repro_torch.distributed.sharding import use_sharding
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.training.train_step import make_train_step
    res = {}
    store = Path(tempfile.mkdtemp(prefix="chip_smoke_dist_train_"))
    cases = dist_train_cases()
    samples = {}

    def moment_err(got, want):
        """The worst of m's and v's errors over phase 12 (c)'s bounds."""
        return max(max(max_err(a, b) / ((TRAIN_GRAD_TOL + 1 / 127) * float(b.abs().max())
                                         + 1e-30) for a, b in zip(got[0], want[0])),
                   max(max_err(a, b) / ((2 * TRAIN_GRAD_TOL + 253 / 127 ** 2)
                                        * float(b.abs().max()) + 1e-30)
                       for a, b in zip(got[1], want[1])))

    # the unsharded steps on the card, which (a), (b), (d) and (e) are held
    # against
    t0 = time.perf_counter()
    name, cfg, _, strategy, tcfg, _, _ = cases[0]
    model = build_model(cfg)
    batch = dist_train_batch(cfg, dev)
    params = model.init_params(0, device=dev, dtype=torch.float32)
    ref_loss, ref_grads, ref_m, ref_v = unsharded_train_step(model, params, batch, tcfg)
    del params

    # (a) NCCL at world 1 on the (1, 1, 1) train mesh: every shard whole
    dist.init_process_group(DIST_A_BACKEND, store=dist.FileStore(str(store / "nccl"), 1),
                            rank=0, world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = Mesh((1, 1, 1), DIST_AXES).bind()
        rules = dist_train_rules(strategy)
        ctx = dist_train_ctx(strategy, mesh)
        zero_launches()
        with use_sharding(mesh, rules), adamw_input([]) as seen:
            params = model.init_params(0, device=dev, dtype=torch.float32, mesh=mesh,
                                       rules=rules)
            before = [t.clone() for t in tree_leaves(params)]
            init_fn, step_fn = make_train_step(model, tcfg, ctx)
            params, (opt, _), met = step_fn(params, init_fn(params), batch)
            torch.cuda.synchronize()
        a_launches = read_launches()
    finally:
        dist.destroy_process_group()
    loss_err = abs(float(met["loss"]) - ref_loss) / abs(ref_loss)
    grad_err = max(max_err(a, b) / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(seen[0], ref_grads))
    del seen
    mom = moment_err((tree_leaves(opt.m), tree_leaves(opt.v)),
                     (tree_leaves(ref_m), tree_leaves(ref_v)))
    adamw = adamw_step_err(before, tree_leaves(params), tree_leaves(opt.m), tree_leaves(opt.v),
                           lr=float(met["lr"]), step=int(opt.step),
                           weight_decay=tcfg.weight_decay)
    del before, params, opt
    assert loss_err <= DIST_TRAIN_A_LOSS_RTOL, \
        f"(a) loss rel err {loss_err} > {DIST_TRAIN_A_LOSS_RTOL}"
    assert grad_err <= DIST_TRAIN_A_GRAD_TOL, f"(a) gradient rel err {grad_err}"
    assert mom <= 1.0 and adamw <= 1.0, f"(a) moments at {mom}, parameters at {adamw} of bound"
    assert a_launches[0]["flash_attention"] > 0 and a_launches[0]["flash_attention_bwd"] > 0, \
        a_launches
    res["a"] = dict(loss_rel_err=loss_err, grad_rel_err=grad_err,
                    moment_err_of_bound=mom, adamw_err_of_tol=adamw, launches=a_launches[0],
                    seconds=time.perf_counter() - t0)
    log(f"  (a) NCCL, world 1, train mesh (1, 1, 1), {cfg.name} fp32, {DIST_TRAIN_BATCH} x "
        f"{DIST_TRAIN_SEQ} tokens, one step_fn (2 microbatches, int8 gradients) against the "
        f"unsharded one: loss rel err {loss_err:.3g}, every leaf of the gradient AdamW took "
        f"within {grad_err:.3g} of its max |g| (<= {DIST_TRAIN_A_GRAD_TOL}), m / v at "
        f"{mom:.3g} of phase 12 (c)'s bound, parameters at {adamw:.3g} of AdamW's tolerance; "
        f"launches {a_launches[0]}")
    samples[name] = sample_leaves({"g": ref_grads, "m": ref_m, "v": ref_v}, seed=14)
    expect = {name: dict(loss=ref_loss)}
    del model, batch, ref_grads, ref_m, ref_v
    gc.collect()
    torch.cuda.empty_cache()

    # (b)'s mixtral (the unsharded step of the data-split loss), (d), (e);
    # (f) is held against its case's
    for seed, (name, cfg, shape, strategy, tcfg, data_aux, step) in enumerate(cases[1:], 15):
        if name in DIST_TRAIN_SEQ_OF:
            continue
        model = build_model(cfg)
        batch = dist_train_batch(cfg, dev)
        params = model.init_params(0, device=dev, dtype=torch.float32)
        loss, grads, m, v = unsharded_train_step(model, params, batch, tcfg,
                                                 data_aux=shape[0] if data_aux else 0, step=step)
        samples[name] = sample_leaves({"g": grads, "m": m, "v": v} if step else {"g": grads},
                                      seed=seed)
        if data_aux:
            expect[name] = dict(xent=loss[0], auxes=loss[1], aux_weight=tcfg.aux_weight)
        else:
            expect[name] = dict(loss=loss)
        del model, batch, params, grads, m, v
        gc.collect()
        torch.cuda.empty_cache()
    for name, base in DIST_TRAIN_SEQ_OF.items():
        samples[name], expect[name] = samples[base], expect[base]
    res["reference_s"] = time.perf_counter() - t0

    # (b) and (c): four gloo ranks
    t0 = time.perf_counter()
    job = dict(samples=samples, device=str(dev), hook=hook)
    outs = spawn_ranks(dist_train_rank, 4, (job,), store_dir=store / "ranks", backend="gloo",
                       timeout_s=DIST_TRAIN_TIMEOUT_S)
    res["ranks_s"] = time.perf_counter() - t0
    b_launches = {k: 0 for k in outs[0]["b"]["qwen"]["launches"][0]}
    for name, cfg, shape, strategy, tcfg, data_aux, step in cases:
        smp, e = samples[name], expect[name]
        worst = dict(g=0.0, m=0.0, v=0.0, loss=0.0)
        bounds = dict(g=TRAIN_GRAD_TOL + (1 / 127 if tcfg.grad_compression else 0.0),
                      m=TRAIN_GRAD_TOL + 1 / 127, v=2 * TRAIN_GRAD_TOL + 253 / 127 ** 2)
        covered = [np.zeros(len(i), bool) for i in smp["idx"]]
        held = [o for o in outs if name in o["b"]]        # the ranks of the case's mesh
        assert len(held) == int(np.prod(shape)), f"{name}: {len(held)} ranks of {shape}"
        for o in held:
            b = o["b"][name]
            if data_aux:       # the whole batch's xent plus the rank's data shard's aux
                d = np.unravel_index(o["rank"], shape)[0]
                want = e["xent"] + e["aux_weight"] * e["auxes"][d]
            else:
                want = e["loss"]
            worst["loss"] = max(worst["loss"], abs(b["loss"] - want) / abs(want))
            for key, name_ in (("grads", "g"), ("m", "m"), ("v", "v"))[:3 if step else 1]:
                for i, (pos, vals) in enumerate(b[key]):
                    ref = smp[name_][i][pos]
                    top = max(smp["max_" + name_][i], 1e-30)
                    worst[name_] = max(worst[name_], float((vals - ref).abs().max() / top
                                                           / bounds[name_]) if len(pos) else 0.0)
                    if key == "grads":
                        covered[i][pos] = True
            assert b["drops"] == 0, f"(b) {name} rank {o['rank']} dropped {b['drops']}"
            assert not step or b["adamw"] <= 1.0, \
                f"(b) {name} rank {o['rank']}: parameters at {b['adamw']}"
            assert all(n == b["spec_bytes"] for n in b["bytes"].values()), (o["rank"], b)
            assert (b["reduce_scatters"] > 0) == (name in DIST_TRAIN_SEQ_OF), \
                f"(b) {name} rank {o['rank']}: {b['reduce_scatters']} reduce-scatters"
        assert all(c.all() for c in covered), f"(b) {name}: a sampled position no rank holds"
        assert worst["loss"] <= TRAIN_LOSS_RTOL, f"(b) {name}: loss rel err {worst['loss']}"
        assert max(worst["g"], worst["m"], worst["v"]) <= 1.0, f"(b) {name}: {worst}"
        # rank 0's launches in this case: the attention layers' flash
        # forward and backward, the mamba layers' SSD scan and backward
        launched, kinds = outs[0]["b"][name]["launches"][0], "".join(
            g.pattern for g in cfg.layer_groups)
        for k, want in (("flash_attention", "A" in kinds), ("flash_attention_bwd", "A" in kinds),
                        ("ssd_scan", "M" in kinds), ("ssd_scan_bwd", "M" in kinds)):
            assert (launched[k] > 0) == want, f"(b) {name}: {k} launched {launched[k]}"
        b_launches = {k: n + launched[k] for k, n in b_launches.items()}
        tag = ("b" if name in ("qwen", "mixtral") else "e" if cfg.encoder or cfg.vision
               else "f" if name in DIST_TRAIN_SEQ_OF else "d")
        res[f"b_{name}"] = dict(
            part=tag, config=cfg.name, mesh=list(shape), strategy=strategy, step=step,
            worst_of_bound=worst, max_rel_grad=worst["g"] * bounds["g"],
            adamw=[o["b"][name]["adamw"] for o in held] if step else None,
            seconds=held[0]["b"][name]["seconds"], step_ms=[o["b"][name]["ms"] for o in held],
            peak_bytes=[o["b"][name]["peak_bytes"] for o in held],
            losses=[o["b"][name]["loss"] for o in held], launches=launched,
            bytes=[o["b"][name]["bytes"] for o in held],
            reduce_scatters=[o["b"][name]["reduce_scatters"] for o in held])
        what = ("one step_fn, " + ("2 microbatches, int8 gradients" if tcfg.microbatches > 1
                                   else "one batch") if step else "the loss and its gradient")
        log(f"  ({tag}) gloo, {len(held)} ranks, mesh {shape}, {strategy}, {cfg.name} fp32"
            f"{' under make_rules(seq_shard=True)' if tag == 'f' else ''}, "
            f"{what}{', the data-split aux' if data_aux else ''}: each rank's loss within "
            f"{worst['loss']:.3g} of {'xent + its shard aux' if data_aux else 'the unsharded'} "
            f"({res[f'b_{name}']['losses']}), the sampled gradient"
            + (f" / m / v at {worst['g']:.3g} / {worst['m']:.3g} / {worst['v']:.3g} of phase 12 "
               f"(c)'s bounds, parameters at <= {max(res[f'b_{name}']['adamw']):.3g} of AdamW's "
               f"tolerance" if step else f" at {worst['g']:.3g} of phase 12 (c)'s bound")
            + f" (max rel gradient err {res[f'b_{name}']['max_rel_grad']:.3g}); "
            f"{'step' if step else 'loss + backward'} ms per rank "
            f"{[round(x, 1) for x in res[f'b_{name}']['step_ms']]}, peak device GB per rank "
            f"{[round(x / 1e9, 3) for x in res[f'b_{name}']['peak_bytes']]}; bytes per rank "
            f"{res[f'b_{name}']['bytes']} (each its specs' shard sum); rank 0 launches "
            f"{ {k: v for k, v in launched.items() if v} }")
    r0 = outs[0]
    res["launches"] = {k: a_launches[0][k] + b_launches[k] for k in b_launches}
    for name, arch, depth, shape, strategy, lr in DIST_TRAIN_BF16:
        c = r0["c"][name]
        for o in outs:
            oc = o["c"][name]
            assert all(np.isfinite(oc["losses"])) and oc["losses"][-1] < oc["losses"][0], \
                f"(c) {name} rank {o['rank']}: losses {oc['losses']}"
            assert oc["drops"] == 0, f"(c) {name} rank {o['rank']} dropped {oc['drops']}"
            assert oc["bytes"]["params"] == oc["spec_bytes"]["params"] and \
                oc["bytes"]["m"] == oc["bytes"]["v"] == oc["spec_bytes"]["m"], (o["rank"], oc)
        launches, paths = c["launches"]
        assert launches["flash_attention"] > 0 and launches["flash_attention_bwd"] > 0, launches
        assert paths["flash_attention"]["mma"] == launches["flash_attention"] and \
            paths["flash_attention_bwd"]["mma"] == launches["flash_attention_bwd"], paths
        idle = {k: n for k, n in launches.items()
                if k not in ("flash_attention", "flash_attention_bwd")}
        assert not any(idle.values()), f"(c) {name} reached a kernel it must not: {idle}"
        step_s = float(np.median(c["step_seconds"][1:]))
        tokens = TRAIN_BATCH * TRAIN_SEQ
        res[f"c_{name}"] = dict(
            layers=c["layers"], mesh=list(shape), strategy=strategy, losses=c["losses"],
            seconds=c["seconds"],
            aux=c["aux"], rank_losses=[o["c"][name]["losses"] for o in outs],
            step_seconds=c["step_seconds"], step_ms_median=1e3 * step_s,
            tokens_per_s=tokens / step_s, peak_bytes=[o["c"][name]["peak_bytes"] for o in outs],
            bytes=[o["c"][name]["bytes"] for o in outs], launches=launches,
            launches_by_path={k: paths[k] for k in ("flash_attention", "flash_attention_bwd")})
        res["launches"] = {k: res["launches"][k] + launches[k] for k in launches}
        log(f"  (c) gloo, 4 ranks, mesh {shape}, {strategy}, {arch} bf16, full width, "
            f"{c['layers']} layers, {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step, remat, "
            f"xent_chunk 128, peak lr {lr}: rank 0's losses {[round(x, 4) for x in c['losses']]}"
            f" (every rank's finite and falling); step {1e3 * step_s:.1f} ms (median of steps "
            f"2-{DIST_TRAIN_STEPS}), {tokens / step_s:.0f} tok/s (4 ranks on one card, gloo "
            f"through the host); peak device GB per rank "
            f"{[round(x / 1e9, 3) for x in res[f'c_{name}']['peak_bytes']]}; parameter / m GB "
            f"per rank {[(round(b['params'] / 1e9, 3), round(b['m'] / 1e9, 3)) for b in res[f'c_{name}']['bytes']]}"
            f" (each its specs' shard sum); rank 0 launches {launches}, flash by path "
            f"{paths['flash_attention']}, backward {paths['flash_attention_bwd']}")
    for k, v in r0["served"].items():
        SERVED[k].update(tuple(x) for x in v)
    return res


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

    def serve(n_replicas: int, slots: int, batch, *, fail_after=None, profile_what=None,
              new_tokens: int = STACK_NEW):
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
                                   max_new_tokens=new_tokens, timeout_s=300)
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
        # both layouts on a short run (the first STACK_PROFILE[0] requests,
        # STACK_PROFILE[1] tokens each; the full batch's windows took 126 s
        # of the script's time), each in its own window: the device time a
        # step against each replica's wall time a step (step_records, the
        # token readback's wait included) says whether the 2 x 32 steps grew
        # on the host or on the device (the window also holds the warm-up)
        stack["profile"] = []
        n_req, n_new = STACK_PROFILE
        for n_replicas, slots in STACK_LAYOUTS:
            _, _, reps, prof = serve(
                n_replicas, slots, prompts[:n_req], new_tokens=n_new,
                profile_what=f"{n_replicas} x {slots} slots, {n_req} requests x {n_new} tokens")
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


def device_time_by_name(prof, device=None) -> list:
    """(name, ms, count) of the device-side events (kernels, copies, sets)
    of a finished profile, largest first: the host ops that launched them
    report the same time again. Summed straight from the trace's events:
    ``key_averages()`` first builds an event tree in Python, ~100x slower
    (1.8 s for 20k events on the CPU), and took most of a window's cost."""
    from torch.autograd import DeviceType
    device = DeviceType.CUDA if device is None else device
    acc = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == device and e.duration_ns() > 0:
            ms, n = acc.get(e.name(), (0.0, 0))
            acc[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    return sorted(((k, ms, n) for k, (ms, n) in acc.items()), key=lambda r: -r[1])


def profile_window(fn, what: str):
    """torch.profiler over one call of ``fn``: device time by kernel name
    and the device's busy share of the window."""
    from torch.profiler import ProfilerActivity, profile
    # device activity only: the window reads the kernels' device time, and
    # host op events (one per op of the models' many small ones) would only
    # lengthen the trace and its post-processing
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_time_by_name(prof)
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
                    help="add torch.profiler windows over short serving runs, the "
                         "generation paths and train steps; skip phase 3's card vs CPU checks")
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
    run_flash_bwd(dev, flush, results)
    run_paged_decode(dev, flush, results)
    run_ssd(dev, flush, results)
    run_ssd_bwd(dev, flush, results)
    run_w8a16(dev, flush, results)
    del flush
    log(f"  phase 2 took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    if args.profile:
        # no window here: the logit checks, whose CPU side took 78-105 s of
        # the script's 600, are the run without options'
        log("phase 3: skipped under --profile (card vs CPU checks only; the run without "
            "options makes them)")
        e2e_err = cross_err = int8_err = int8_cross = mamba_err = mamba_cross = None
        configs_err = {}
    else:
        log("phase 3: every model path at depth 2, full width, fp32, card vs CPU")
        e2e_err, cross_err = run_card_vs_cpu(dev)
        torch.cuda.empty_cache()
        int8_err, int8_cross = run_card_vs_cpu(dev, int8=True)
        torch.cuda.empty_cache()
        mamba_err, mamba_cross = run_mamba_card_vs_cpu(dev)
        torch.cuda.empty_cache()
        configs_err = {name: run_decode_chunk_card_vs_cpu(dev, name, n)
                       for name, n in DECODE_CHUNK_CONFIGS}
    log(f"  phase 3 took {time.perf_counter() - t0:.1f} s")

    # every main path from here on records its kernels' call shapes
    recording = contextlib.ExitStack()
    recording.enter_context(served_shapes())

    log("phase 4: serving run")
    t0 = time.perf_counter()
    model, params, info = build_mixtral(dev, SERVE_LAYERS, int8=False)
    serve, launches, streams, _ = run_serving(dev, args.profile, model, params)
    serve.update(info)
    log(f"  phase 4 took {time.perf_counter() - t0:.1f} s")

    log("phase 5: generation path (prefill + decode_step) on phase 4's weights")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    generation, gen_launches, (gen_tokens, gen_logits) = run_generation(
        dev, model, params, streams, args.profile, keep=True)
    launches.update(flash_attention=gen_launches["flash_attention"],
                    paged_attention=gen_launches["paged_attention"])
    log(f"  phase 5 took {time.perf_counter() - t0:.1f} s")

    log("phase 8: the serving stack (client -> gateway -> router -> replicas) on phase 4's "
        "weights, 64 concurrent requests")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    stack, stack_launches = run_stack(dev, model, params, args.profile)
    log(f"  phase 8 took {time.perf_counter() - t0:.1f} s")

    log("phase 9: speculative serving (prompt-lookup drafts, verify at C = 2 / 3 / 5) on "
        "phase 4's weights, spec off and on at 1, 8 and 32 slots")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    spec, spec_launches = run_spec(dev, model, params, profile=args.profile)
    assert set(spec["widths_seen"]) == set(VERIFY_WIDTHS), \
        f"the verify sweeps ran at widths {spec['widths_seen']}, not all of {VERIFY_WIDTHS}"
    del model, params
    log(f"  phase 9 took {time.perf_counter() - t0:.1f} s")

    # after phase 9: phase 4's 8-layer bf16 model (23.7 GB) is freed, so (f)'s
    # 28.6 GB fp32 jamba and its four ranks have the card
    log("phase 13: distributed serving: (a) NCCL at world 1, (b) four gloo ranks on mixtral "
        f"depth {DIST_DEPTH} fp32 on meshes (1, 2, 2) ep_shardmap and (1, 1, 4) tp_shardmap, "
        f"(c) the same ranks on phase 4's {SERVE_LAYERS}-layer bf16 mixtral, (1, 2, 2); "
        + ", ".join(f"({k}) {a} depth {n} fp32 on {m} {st}" for k, a, n, m, st in DIST_LAYOUTS)
        + ", " + ", ".join(f"({k}) {a} depth 2 fp32 on {m}" for k, a, m in DIST_MM)
        + f", (i) mixtral-8x7b depth {DIST_DEPTH} int8 on "
        + ", ".join(f"{m} {st} {str(dt)[6:]}" for _, m, st, dt in DIST_INT8)
        + ", (j) make_rules(seq_shard=True): "
        + ", ".join(f"{a} depth {n} fp32 on {m}" for _, a, n, m, _, _ in DIST_SEQ))
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    distributed = run_distributed(dev, streams, gen_tokens, gen_logits)
    del gen_tokens, gen_logits
    distributed["seconds"] = time.perf_counter() - t0
    log(f"  phase 13 took {distributed['seconds']:.1f} s")

    log(f"phase 14: distributed training: (a) NCCL at world 1, {TRAIN_ARCH} depth "
        f"{DIST_TRAIN_QWEN} fp32 on the (1, 1, 1) train mesh; (b) four gloo ranks in fp32, "
        f"{TRAIN_ARCH} depth {DIST_TRAIN_QWEN} on (2, 1, 2) (FSDP + TP, 2 microbatches, int8 "
        f"gradients) and mixtral-8x7b depth {DIST_TRAIN_MOE} on (2, 2, 1) ep_shardmap (FSDP + "
        f"EP, the data-split aux); (d) / (e) / (f: make_rules(seq_shard=True)) the same ranks "
        f"in fp32: "
        + ", ".join(f"{c.name} on {m}" for _, c, m, *_ in dist_train_cases()[2:])
        + "; (c) the same ranks in bf16: "
        + ", ".join(f"{a} depth {n} on {m}" for _, a, n, m, _, _ in DIST_TRAIN_BF16)
        + f", {DIST_TRAIN_STEPS} steps")
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    dist_training = run_dist_training(dev)
    dist_training["seconds"] = time.perf_counter() - t0
    log(f"  phase 14 took {dist_training['seconds']:.1f} s")

    log(f"phase 11: enc-dec ({MM_SEAMLESS}) and VLM ({MM_VISION}) at full width and depth: "
        f"serving with frames / patches, the generation API, then card vs CPU at depth 2")
    t0 = time.perf_counter()
    mm, mm_launches = {}, {}
    for name in (MM_SEAMLESS, MM_VISION):
        gc.collect()
        torch.cuda.empty_cache()
        model, params, info = build_mm(dev, name)
        mm_serve, serve_launches, streams, extras = run_mm_serving(dev, args.profile, model,
                                                                   params)
        mm_gen, gen_launches = run_mm_generation(dev, model, params, streams, extras)
        mm_launches[name] = {k: serve_launches.get(k, 0) + gen_launches.get(k, 0)
                             for k in set(serve_launches) | set(gen_launches)}
        mm[name] = dict(info, serve=mm_serve, generation=mm_gen)
        del model, params, extras
    gc.collect()
    torch.cuda.empty_cache()
    recording.close()            # (c)'s fp32 depth-2 calls check the card; they serve nothing
    mm_checks = {name: run_mm_card_vs_cpu(dev, name) for name in (MM_SEAMLESS, MM_VISION)}
    recording = contextlib.ExitStack()
    recording.enter_context(served_shapes())
    torch.cuda.empty_cache()
    log(f"  phase 11 took {time.perf_counter() - t0:.1f} s")

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
    # the int8 head and projections at M * C rows of the verify sweeps
    int8_spec, int8_spec_launches = run_spec(dev, model, params,
                                             slots_list=(INT8_SPEC_SLOTS,), new_tokens=32,
                                             int8=True)
    spec_launches["w8a16_matmul"] = int8_spec_launches["w8a16_matmul"]
    del model, params
    launches["w8a16_matmul"] = int8_launches["w8a16_matmul"]
    log(f"  phase 7 took {time.perf_counter() - t0:.1f} s")

    log(f"phase 12: training on the card: {TRAIN_ARCH} at full width, {TRAIN_LAYERS} layers "
        f"(checkpoints, "
        f"a crash, a resume), mixtral-8x7b at depth {MOE_TRAIN_LAYERS} with the capacity MoE, "
        f"{MAMBA_TRAIN_ARCH} at full width and depth, then card vs CPU in fp32")
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    training, train_launches, train_paths = run_training(dev, args.profile)
    training["mamba2"], ssm_launches, _ = run_mamba_training(dev, args.profile)
    train_launches = {k: n + ssm_launches[k] for k, n in train_launches.items()}
    launches["flash_attention_bwd"] = train_launches["flash_attention_bwd"]
    launches["ssd_scan_bwd"] = train_launches["ssd_scan_bwd"]
    recording.close()            # (c)'s and (e)'s fp32 calls check the card; they train nothing
    from repro_torch.configs import get_config
    qwen2 = depth_cut(get_config(TRAIN_ARCH), 2)
    log("  (c) card vs CPU:")
    training["card_vs_cpu"] = {qwen2.name: train_card_vs_cpu(dev, qwen2, step=True),
                               mixtral(1).name: train_card_vs_cpu(dev, mixtral(1), step=False)}
    # (e) the SSM family: jamba at depth 2 is a mamba layer with a dense MLP,
    # then one with the 16-expert MoE
    log("  (e) card vs CPU, the SSM family:")
    for cfg in (mamba2(2), depth_cut(get_config("jamba-v0.1-52b"), 2)):
        training["card_vs_cpu"][cfg.name] = train_card_vs_cpu(dev, cfg, step=False)
    if args.profile:
        bwd_ms = sum(w["ms"] for w in training["mamba2"]["profile"]["port"]
                     if "ssd_bwd" in w["name"])
        log(f"  the SSD backward kernel's share of the profiled mamba2 step: {bwd_ms:.2f} ms of "
            f"{training['mamba2']['profile']['device_busy_ms']:.1f} ms busy")
    log(f"  phase 12 took {time.perf_counter() - t0:.1f} s")

    log(f"phase 15: the dry-run's memory proof: rank 0 of {DRYRUN_MESH} {DRYRUN_ARCH} "
        f"{DRYRUN_SHAPE} (MoE on tp), bf16 and int8, walked on meta, then run on the card")
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    with served_shapes():
        dryrun_proof, dryrun_launches = run_dryrun_proof(dev, args.profile)
    log(f"  phase 15 took {time.perf_counter() - t0:.1f} s")

    unchecked = {k: sorted(SERVED[k] - CHECKED[k]) for k in SERVED}
    log("call shapes of the main paths (phases 4-9, 11-15) against phase 2's: "
        + "; ".join(f"{k} {len(SERVED[k])} served, {len(CHECKED[k])} checked"
                    for k in SERVED))
    assert not any(unchecked.values()), \
        f"main-path call shapes phase 2 never held against the plain version: {unchecked}"

    kernels = []
    for name, route_src, replaces, case in (
            ("chunked_prefill_attention", "src/repro_torch/csrc/chunked_prefill.cu",
             "src/repro/kernels/paged_attention/kernel.py:232", "decode"),
            ("moe_gmm", "src/repro_torch/csrc/moe_gmm.cu",
             "src/repro/kernels/moe_gmm/kernel.py:29", "8tok 4096->14336"),
            ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:112", "prefill"),
            # no TPU kernel of its own: the gradient of row 4's, which the
            # reference takes by XLA autodiff of mha_chunked
            ("flash_attention_bwd", "src/repro_torch/csrc/flash_attention_bwd.cu",
             "src/repro/kernels/flash_attention/kernel.py:112", "qwen2.5-3b train"),
            ("paged_attention", "src/repro_torch/csrc/chunked_prefill.cu",
             "src/repro/kernels/paged_attention/kernel.py:107", "decode"),
            ("ssd_scan", "src/repro_torch/csrc/ssd_scan.cu",
             "src/repro/kernels/ssd_scan/kernel.py:65", "mamba2 pack"),
            # no TPU kernel of its own: the gradient of row 5's, which the
            # reference takes by XLA autodiff of its plain ssd_chunked
            ("ssd_scan_bwd", "src/repro_torch/csrc/ssd_scan_bwd.cu",
             "src/repro/kernels/ssd_scan/kernel.py:65", "mamba2 train"),
            ("w8a16_matmul", "src/repro_torch/csrc/quant_matmul.cu",
             "src/repro/kernels/quant_matmul/kernel.py:40", "decode wq")):
        row = next(r for r in results if r["kernel"] == name and r["case"] == case
                   and r["dtype"] == "bfloat16")
        # phase 13 (i)'s rank shapes: the int8 tree's projections, head and
        # expert buffers on a rank of (1, 1, 4) (fp32) and (1, 2, 2) (bf16)
        rank_rows = [{k: r[k] for k in ("case", "dtype", "shape", "path", "max_abs_err", "ms",
                                        "plain_ms", "bound_ms", "bound_by", "library_ms")}
                     for r in results if r["kernel"] == name and r["case"].startswith("rank ")]
        extra = {"mesh_int8_rows": rank_rows} if rank_rows else {}
        kernels.append(dict(name=name, route="cuda", source=route_src, replaces=replaces,
                            launches=launches[name], max_abs_err=row["max_abs_err"],
                            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                            bound_by=row["bound_by"], library_ms=row["library_ms"],
                            stack_launches=stack_launches.get(name, 0),
                            spec_launches=spec_launches.get(name, 0),
                            encdec_launches=mm_launches[MM_SEAMLESS].get(name, 0),
                            vlm_launches=mm_launches[MM_VISION].get(name, 0),
                            train_launches=train_launches[name],
                            dist_launches=distributed["launches"][name],
                            dist_train_launches=dist_training["launches"][name],
                            dryrun_launches=dryrun_launches[name],
                            shape=f"{case} bf16: {row['shape']}", **extra))
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(dict(card=card, cases=results, e2e_max_abs_logit=e2e_err,
                                       cross_path_max_abs_logit=cross_err,
                                       mamba_e2e_max_abs_logit=mamba_err,
                                       mamba_cross_path_max_abs_logit=mamba_cross,
                                       configs_e2e_max_abs_logit=configs_err,
                                       int8_e2e_max_abs_logit=int8_err,
                                       int8_cross_path_max_abs_logit=int8_cross, serve=serve,
                                       generation=generation, mamba_serve=mamba_serve,
                                       mamba_generation=mamba_generation,
                                       int8_serve=int8_serve, int8_generation=int8_generation,
                                       stack=stack, spec=spec, int8_spec=int8_spec,
                                       encdec_vlm=mm, encdec_vlm_card_vs_cpu=mm_checks,
                                       training=training, distributed=distributed,
                                       dist_training=dist_training, dryrun=dryrun_proof,
                                       served_shapes={k: sorted(v) for k, v in SERVED.items()},
                                       kernels=kernels),
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
