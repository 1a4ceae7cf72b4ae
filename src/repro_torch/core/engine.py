"""The inference engine: one chunked iteration over fixed shapes, paged KV,
continuous batching with a per-iteration token budget, temperature/top-p
sampling.

Design (as the reference's ``repro.core.engine``):
  - prefill and decode are ONE model path (``LM.decode_chunk``): every batch
    row feeds a chunk of tokens of one sequence whose KV is written straight
    into the paged pool. Decode is a chunk of 1.
  - two fixed call shapes: (chunk_rows, prefill_chunk) for the prefill pack
    and (max_slots, 1) for the decode sweep.
  - each ``step()`` is a token-budget iteration (Sarathi-style): all pending
    decode tokens plus up to ``token_budget - n_decode`` prefill-chunk
    tokens. Long prompts prefill over several iterations.
  - the scheduler's max-utilization policy pauses requests under page
    pressure; a paused, partially-prefilled slot resumes from chunk 0 with
    its generated tokens intact.

SSM and hybrid models keep one recurrent state per slot: each pack row
names its slot and whether it carries the sequence's first chunk (which
resets that state). The prefix cache is off for them, since a page does not
capture an SSM layer's state.

On the card the attention, expert matmuls and SSD scan run the port's CUDA
kernels. The engine runs on ``cuda`` unless ``EngineConfig.device`` says
otherwise. Speculative decoding, fault injection and the enc-dec / VLM
serving paths of the reference come with later slices.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.kv_cache import PagedAllocator, PrefixCache
from repro_torch.core.metrics import Request, now
from repro_torch.core.observability import Tracer
from repro_torch.core.scheduler import ContinuousBatchScheduler, SlotState
from repro_torch.core.timeline import StepRecord
from repro_torch.models import LM, RunCtx
from repro_torch.models.common import resolve_device
from repro_torch.quant.quantize import QuantizedLinear


@dataclass
class EngineConfig:
    max_slots: int = 8
    page_size: int = 16
    num_pages: int = 512
    max_seq: int = 512
    prefill_chunk: int = 32           # chunked-prefill size
    token_budget: int = 0             # per-iteration token cap (0: slots+2*chunk)
    temperature: float = 0.5
    top_p: float = 0.7
    greedy: bool = False
    scheduler: str = "max_utilization"
    enable_prefix_cache: bool = True  # shared-prefix KV reuse
    enable_speculative: bool = False  # not ported yet: True raises
    eos_id: int = -1                  # -1: no EOS (length-controlled)
    profile_steps: bool = True        # keep one StepRecord per iteration in a
                                      # bounded ring
    step_records_cap: int = 4096      # ring-buffer capacity for step records
    cache_dtype: torch.dtype = torch.float32
    device: Optional[str] = None      # None: cuda (raises without a card)
    seed: int = 0

    @property
    def max_pages_per_seq(self) -> int:
        return (self.max_seq + self.page_size - 1) // self.page_size


@dataclass
class TokenEvent:
    request: Request
    token: int                 # -1: terminal no-token event (rejected request)
    t_emit: float
    finished: bool


def sample_tokens(logits, generator: torch.Generator, temperature: float, top_p: float,
                  greedy: bool):
    """logits (B, V) -> (B,) int32. Nucleus sampling with temperature, by
    the Gumbel-max trick over the kept tokens."""
    if greedy or temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits.float() / temperature
    sl, si = torch.sort(scaled, dim=-1, descending=True)
    p = torch.softmax(sl, dim=-1)
    keep = (torch.cumsum(p, dim=-1) - p) < top_p             # first always kept
    sl = torch.where(keep, sl, torch.full_like(sl, -torch.inf))
    u = torch.rand(sl.shape, generator=generator, device=sl.device)
    g = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    choice = torch.argmax(sl + g, dim=-1)
    return torch.gather(si, 1, choice[:, None])[:, 0].to(torch.int32)


class InferenceEngine:
    """Single-replica engine."""

    def __init__(self, model: LM, params, cfg: EngineConfig, ctx: Optional[RunCtx] = None,
                 tracer: Optional[Tracer] = None):
        if cfg.enable_speculative:
            raise NotImplementedError("speculative decoding is not ported yet")
        self.device = resolve_device(cfg.device)
        embed = params["embed"]["w"]
        wdev = (embed.q if isinstance(embed, QuantizedLinear) else embed).device
        if wdev.type != self.device.type or self.device.index not in (None, wdev.index):
            raise ValueError(f"params are on {wdev}, the engine runs on {self.device}")
        self.model = model
        self.params = params
        self.cfg = cfg
        self.tracer = tracer
        self.ctx = ctx or RunCtx()
        self.chunk = min(cfg.prefill_chunk, cfg.max_seq)
        self.token_budget = max(cfg.token_budget or (cfg.max_slots + 2 * self.chunk),
                                cfg.max_slots + 1)
        self.chunk_rows = max(1, min(self.token_budget // self.chunk, cfg.max_slots))
        self.allocator = PagedAllocator(cfg.num_pages, cfg.page_size, cfg.max_pages_per_seq)
        # prefix sharing is only sound when a page fully captures a token
        # range's state: an SSM layer carries recurrent state instead
        has_ssm = any("M" in g.pattern for g in model.cfg.layer_groups)
        self.prefix_cache = (PrefixCache(self.allocator)
                             if cfg.enable_prefix_cache and not has_ssm else None)
        self.scheduler = ContinuousBatchScheduler(
            cfg.max_slots, self.allocator, policy=cfg.scheduler, max_seq=cfg.max_seq,
            prefix_cache=self.prefix_cache, tracer=tracer)
        self.cache = model.init_cache(
            cfg.max_slots, cfg.max_seq, cfg.cache_dtype, kind="paged",
            page_size=cfg.page_size, num_pages=cfg.num_pages, device=self.device)
        self.page_table = np.zeros((cfg.max_slots, cfg.max_pages_per_seq), np.int32)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(cfg.seed)
        self.steps = 0
        self.decode_tokens = 0
        self.prefill_tokens = 0
        self.deadline_exceeded = 0        # requests cancelled past deadline
        self.prefix_cached_tokens = 0     # prefill tokens skipped via cache hits
        self.iter_token_counts: deque = deque(maxlen=4096)
        # iteration profiler: one StepRecord per step() in a bounded ring;
        # per-step row counts set by _step as it packs
        self.step_records: deque = deque(maxlen=cfg.step_records_cap)
        self._last_admitted = 0
        self._last_prefill_rows = 0
        self._last_decode_rows = 0

    # ------------------------------------------------------------- model call
    def _run(self, tokens, starts, nvalid, slots, first, page_table) -> np.ndarray:
        """One fused iteration over a packed batch of per-sequence chunks
        (decode == chunk of 1). Returns the next token per row (0 for
        inactive rows) on the host."""
        tk, st, nv, sl, fi, pt = (torch.from_numpy(a).to(self.device)
                                  for a in (tokens, starts, nvalid, slots, first, page_table))
        with torch.inference_mode():
            logits, self.cache = self.model.decode_chunk(
                self.params, tk, self.cache, st, nv, sl, fi, self.ctx, pt)
            nxt = sample_tokens(logits, self._gen, self.cfg.temperature, self.cfg.top_p,
                                self.cfg.greedy)
            nxt = torch.where(nv > 0, nxt, 0)
        return nxt.cpu().numpy()

    def _copy_pages(self, src: List[int], dst: List[int]) -> None:
        """Device-side page copy (the COW step): kp/vp[:, dst] = kp/vp[:, src]
        across every attention layer, in place on the pools (SSM layers hold
        no pages)."""
        si = torch.tensor(src, dtype=torch.long, device=self.device)
        di = torch.tensor(dst, dtype=torch.long, device=self.device)
        for group in self.cache["groups"]:
            for c in group:
                for pool in c.get("attn", {}).values():
                    pool.index_copy_(1, di, pool.index_select(1, si))

    def _apply_copies(self, copies: List[Tuple[int, int]]) -> None:
        """Run queued COW page copies before the write that needed them.
        Copies are applied in order; a batch holds at most one copy per
        destination page so the gather-then-scatter semantics of a single
        call can never race two writes to one page."""
        while copies:
            batch, rest, seen = [], [], set()
            for s, d in copies:
                (rest if d in seen else batch).append((s, d))
                seen.add(d)
            self._copy_pages([s for s, _ in batch], [d for _, d in batch])
            copies = rest

    def _register_prefix(self, st: SlotState) -> None:
        """Insert the slot's newly completed full prompt pages into the
        prefix trie (content is final once fed: later writes to shared or
        cached pages always go through COW)."""
        if self.prefix_cache is None:
            return
        nb = min(st.fed, len(st.request.prompt_tokens)) // self.cfg.page_size
        if nb > st.registered_blocks:
            self.prefix_cache.insert(st.all_tokens,
                                     self.allocator.owned(st.slot), nb)
            st.registered_blocks = nb

    # ------------------------------------------------------------- helpers
    def submit(self, request: Request) -> None:
        self.scheduler.add(request)

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    # ------------------------------------------------------------- step
    def step(self) -> List[TokenEvent]:
        """One token-budget iteration: admissions, the prefill chunk pack,
        then one decode sweep — at most ``token_budget`` tokens total.
        With ``profile_steps`` each iteration leaves one :class:`StepRecord`
        in the ``step_records`` ring buffer."""
        if not self.cfg.profile_steps:
            return self._step()
        t0 = now()
        preempt0 = self.scheduler.n_preemptions
        cow0 = self.allocator.cow_copies
        prefill0, decode0 = self.prefill_tokens, self.decode_tokens
        # no device fence needed: every model call ends by reading its
        # sampled tokens back to the host
        events = self._step()
        alloc = self.allocator
        self.step_records.append(StepRecord(
            step=self.steps, t0=t0, t1=now(), budget=self.token_budget,
            tokens_packed=self.iter_token_counts[-1] if self.iter_token_counts else 0,
            n_admitted=self._last_admitted,
            prefill_rows=self._last_prefill_rows,
            prefill_tokens=self.prefill_tokens - prefill0,
            decode_rows=self._last_decode_rows,
            decode_tokens=self.decode_tokens - decode0,
            drafted_tokens=0, accepted_tokens=0,      # no speculative decoding yet
            occupancy=len(self.scheduler.running),
            max_slots=self.cfg.max_slots,
            queue_depth=len(self.scheduler.waiting),
            kv_free_pages=alloc.free_pages,
            kv_total_pages=alloc.num_pages - 1,   # page 0 is the null page
            preemptions=self.scheduler.n_preemptions - preempt0,
            cow_pages=alloc.cow_copies - cow0))
        return events

    def _step(self) -> List[TokenEvent]:
        cfg = self.cfg
        tr = self.tracer
        events: List[TokenEvent] = []
        self.steps += 1
        iter_tokens = 0
        self._last_admitted = self._last_prefill_rows = self._last_decode_rows = 0

        # deadline sweep: cancel requests past their absolute cutoff before
        # planning, so an expired request frees its pages this iteration
        for slot, req in self.scheduler.expire_deadlines(now()):
            if slot is not None:
                self.page_table[slot] = 0
            t_exp = now()
            req.error = "deadline_exceeded"
            req.finished = True
            req.t3 = req.t3 or t_exp
            self.deadline_exceeded += 1
            if tr:
                tr.event(req.req_id, "deadline_exceeded", slot=slot)
            events.append(TokenEvent(req, -1, t_exp, True))

        plan = self.scheduler.plan_iteration(self.token_budget, self.chunk,
                                             self.chunk_rows)
        self._last_admitted = len(plan.admit)
        for st in plan.admit:
            r = st.request
            if r.t2 == 0.0:
                r.t2 = now()
            st.admitted_at = now()
            self.prefix_cached_tokens += st.cached_tokens
            if tr:
                tr.end(r.req_id, "queue", cached_tokens=st.cached_tokens,
                       resumed=bool(r.generated))
            if st.feed_len >= cfg.max_seq:
                # prompt can never fit max_seq: fail fast with zero tokens;
                # the terminal event tells consumers the request is over
                self._finish(st)
                events.append(TokenEvent(r, -1, now(), True))

        # ---- prefill chunk pack: grow pages, detach shared pages (COW),
        # then one fixed-shape call
        grants: List[Tuple[SlotState, int]] = []
        copies: List[Tuple[int, int]] = []
        for st, n in plan.prefill:
            if st.slot not in self.scheduler.running:      # preempted by an earlier grow
                continue
            if not self.scheduler.grow_for_tokens(st.slot, st.fed + n):
                continue                                   # pages exhausted: slot waits
            if self.prefix_cache is not None:
                # the chunk writes kv positions [fed, fed+n): any shared or
                # trie-registered page in that range must be detached first.
                # On failure the slot waits, but pairs for blocks already
                # detached stay queued in ``copies``.
                lo = st.fed // cfg.page_size
                hi = (st.fed + n - 1) // cfg.page_size
                n_cow = len(copies)
                writable = self.scheduler.make_writable(st.slot, lo, hi, copies)
                if tr and len(copies) > n_cow:
                    tr.event(st.request.req_id, "cow",
                             n_pages=len(copies) - n_cow)
                if not writable:
                    continue                               # no page for the copy: wait
            grants.append((st, n))
        grants = [(st, n) for st, n in grants if st.slot in self.scheduler.running]
        if copies:
            self._apply_copies(copies)                     # before the chunk writes
        if grants:
            t_pack0 = now()
            self._last_prefill_rows = len(grants)
            B, C = self.chunk_rows, self.chunk
            tokens = np.zeros((B, C), np.int32)
            starts = np.zeros((B,), np.int32)
            nvalid = np.zeros((B,), np.int32)
            slots = np.zeros((B,), np.int32)
            first = np.zeros((B,), bool)
            pt = np.zeros((B, cfg.max_pages_per_seq), np.int32)
            for i, (st, n) in enumerate(grants):
                tokens[i, :n] = st.all_tokens[st.fed:st.fed + n]
                starts[i] = st.fed
                nvalid[i] = n
                slots[i] = st.slot
                first[i] = st.fed == 0
                row = self.allocator.page_table_row(st.slot)
                self.page_table[st.slot] = row
                pt[i] = row
            # padding rows need distinct (unused) slots: their masked SSM
            # state writes must never collide with a live row's slot
            used = set(slots[:len(grants)].tolist())
            spare = [s for s in range(cfg.max_slots) if s not in used]
            for i in range(len(grants), B):
                slots[i] = spare.pop()
            nxt = self._run(tokens, starts, nvalid, slots, first, pt)
            t_emit = now()
            for i, (st, n) in enumerate(grants):
                st.fed += n
                iter_tokens += n
                self.prefill_tokens += n
                if tr:
                    tr.add(st.request.req_id, "prefill_chunk", t_pack0, t_emit,
                           n_tokens=n, fed=st.fed, rows=len(grants))
                self._register_prefix(st)
                if st.prefilling:
                    continue                               # more chunks to go
                if st.request.generated:                   # resumed mid-decode
                    st.last_token = st.all_tokens[-1]
                    continue
                tok = int(nxt[i])                          # first generated token
                st.last_token = tok
                st.all_tokens.append(tok)
                st.request.generated.append(tok)
                fin = self._check_finished(st, tok)
                events.append(TokenEvent(st.request, tok, t_emit, fin))
                if fin:
                    self._finish(st)

        # ---- decode sweep: the plan's decode-ready set plus slots whose feed
        # completed this iteration (same-step decode, budgeted as grant n+1)
        def _live(st):
            return self.scheduler.running.get(st.slot) is st
        decode_sts = [st for st in plan.decode if _live(st) and st.last_token >= 0]
        decode_sts += [st for st, _ in grants
                       if _live(st) and not st.prefilling and st.last_token >= 0]
        dec_copies: List[Tuple[int, int]] = []
        for st in list(decode_sts):
            if st.slot not in self.scheduler.running:      # preempted by an earlier grow
                decode_sts.remove(st)
                continue
            if not self.scheduler.grow_for_decode(st.slot):
                decode_sts.remove(st)                      # paused/unschedulable
                continue
            if self.prefix_cache is not None:
                blk = st.fed // cfg.page_size
                n_cow = len(dec_copies)
                writable = self.scheduler.make_writable(st.slot, blk, blk, dec_copies)
                if tr and len(dec_copies) > n_cow:
                    tr.event(st.request.req_id, "cow",
                             n_pages=len(dec_copies) - n_cow)
                if not writable:
                    decode_sts.remove(st)
                    continue
            self.page_table[st.slot] = self.allocator.page_table_row(st.slot)
        decode_sts = [st for st in decode_sts if st.slot in self.scheduler.running]
        if dec_copies:
            self._apply_copies(dec_copies)                 # before the decode writes
        if not decode_sts:
            self.iter_token_counts.append(iter_tokens)
            return events

        M = cfg.max_slots
        # inactive slots must point at the reserved null page 0: a stale row
        # would alias pages freed and reallocated to another sequence.
        for s in range(M):
            if s not in self.scheduler.running:
                self.page_table[s] = 0
        self._last_decode_rows = len(decode_sts)
        t_dec0 = now()
        tokens = np.zeros((M, 1), np.int32)
        starts = np.zeros((M,), np.int32)
        nvalid = np.zeros((M,), np.int32)
        for st in decode_sts:
            tokens[st.slot, 0] = st.last_token
            starts[st.slot] = st.fed
            nvalid[st.slot] = 1
        nxt = self._run(tokens, starts, nvalid, np.arange(M, dtype=np.int32),
                        np.zeros((M,), bool), self.page_table)
        t_emit = now()
        self.decode_tokens += len(decode_sts)
        iter_tokens += len(decode_sts)

        for st in decode_sts:
            st.fed += 1
            tok = int(nxt[st.slot])
            st.last_token = tok
            st.all_tokens.append(tok)
            st.request.generated.append(tok)
            if tr:
                # consecutive decode iterations coalesce into one span per
                # decode run (broken by preemption/prefill spans)
                tr.add(st.request.req_id, "decode", t_dec0, t_emit,
                       merge=True, n_iters=1, tokens=1)
            fin = self._check_finished(st, tok)
            events.append(TokenEvent(st.request, tok, t_emit, fin))
            if fin:
                self._finish(st)
        self.iter_token_counts.append(iter_tokens)
        return events

    def _check_finished(self, st: SlotState, tok: int) -> bool:
        r = st.request
        if len(r.generated) >= r.max_new_tokens:
            return True
        if self.cfg.eos_id >= 0 and tok == self.cfg.eos_id:
            return True
        if st.fed + 1 >= self.cfg.max_seq:
            return True                   # kv budget
        return False

    def _finish(self, st: SlotState) -> None:
        st.request.finished = True
        st.request.t3 = now()
        self.scheduler.finish(st.slot)

    def stats(self) -> Dict[str, float]:
        """Cumulative engine counters (prefix cache, COW, eviction) for the
        observability sink and benchmark extras."""
        pc = self.prefix_cache
        return {
            "steps": float(self.steps),
            "prefill_tokens": float(self.prefill_tokens),
            "decode_tokens": float(self.decode_tokens),
            "prefix_cached_tokens": float(self.prefix_cached_tokens),
            "prefix_hit_pages": float(pc.hit_pages if pc else 0),
            "prefix_miss_pages": float(pc.miss_pages if pc else 0),
            "prefix_hit_rate": pc.hit_rate() if pc else 0.0,
            "prefix_nodes": float(len(pc) if pc else 0),
            "cow_copies": float(self.allocator.cow_copies),
            "evicted_pages": float(self.allocator.evicted_pages),
            "retired_pages": float(self.allocator.retired_pages),
            "preemptions": float(self.scheduler.n_preemptions),
            "deadline_exceeded": float(self.deadline_exceeded),
            "kv_utilization": self.allocator.utilization(),
        }

    def cancel(self, req_id: str) -> bool:
        """Drop a request (hedging loser / client disconnect). Frees its slot."""
        if self.tracer:
            self.tracer.discard(req_id)
        for i, r in enumerate(self.scheduler.waiting):
            if r.req_id == req_id:
                del self.scheduler.waiting[i]
                return True
        for slot, st in list(self.scheduler.running.items()):
            if st.request.req_id == req_id:
                self.scheduler.finish(slot)
                self.page_table[slot] = 0
                return True
        return False

    # ------------------------------------------------------------- sync api
    def generate(self, requests: List[Request], max_steps: int = 100_000) -> List[Request]:
        """Blocking helper for tests/benchmarks without the gateway stack."""
        for r in requests:
            r.t0 = r.t0 or now()
            r.t1 = r.t1 or now()
            self.submit(r)
        steps = 0
        while self.has_work() and steps < max_steps:
            for ev in self.step():
                if ev.request.t4 == 0.0:
                    ev.request.t4 = ev.t_emit
                    ev.request.t5 = now()
                if ev.finished:
                    ev.request.t6 = now()
            steps += 1
        return requests
