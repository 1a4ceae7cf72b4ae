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

Enc-dec and VLM requests carry their stub frontend's output in
``engine.extras[(req_id, "frames" | "patches")]`` ((1, T, d_model) frames,
(1, n_patches, d_patch) patches). A pack with a first chunk passes every
row's frames (cropped or zero-padded to ``cross_attn_memory``) or patches
to ``decode_chunk``; the encoder's keys and values then live in the slot's
cross cache, the patch prefix's KV in the slot's first pages. A VLM's
prefix shifts every KV position by ``n_patches`` (``pos_offset``), which
every page and max_seq check counts. The prefix cache is off for both
families: a page captures neither the cross KV nor the shifted positions.

Speculative decoding (``enable_speculative``) runs on the same chunk path:
a slot's decode row feeds [last_token, d_1 .. d_k], prompt-lookup drafts of
its own history (``core.spec``), the head scores every fed position and
``verify_draft`` keeps the accepted prefix plus one token; the KV of
rejected drafts is rolled back by truncating the slot's page tail. It is
off for SSM and hybrid models, whose recurrent state cannot be rolled back.

On the card the attention, expert matmuls and SSD scan run the port's CUDA
kernels. The engine runs on ``cuda`` unless ``EngineConfig.device`` says
otherwise. The fault injector's per-step hook, the host-overhead knob and the
step fence are the reference's.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.kv_cache import PagedAllocator, PrefixCache
from repro_torch.core.metrics import Request, now
from repro_torch.core.observability import Tracer
from repro_torch.core.scheduler import ContinuousBatchScheduler, SlotState
from repro_torch.core.spec import PromptLookupDraft, gumbel, verify_draft
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
    enable_speculative: bool = False  # prompt-lookup drafting + multi-token
                                      # verify on the chunk path (off for
                                      # ssm/hybrid: conv + recurrent carry
                                      # advance on every fed token and
                                      # cannot be rolled back per position)
    spec_k: int = 4                   # max draft tokens per slot per step
    spec_ngram_max: int = 3           # prompt-lookup suffix n-gram bounds
    spec_ngram_min: int = 1
    eos_id: int = -1                  # -1: no EOS (length-controlled)
    host_overhead_s: float = 0.0      # baseline-engine emulation knob (benchmarks)
    profile_steps: bool = True        # keep one StepRecord per iteration in a
                                      # bounded ring
    profile_fence: bool = False       # synchronize the device before timestamping
                                      # each step (true device wall time; off
                                      # by default: it serializes dispatch)
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
    choice = torch.argmax(sl + gumbel(sl.shape, generator, sl.device), dim=-1)
    return torch.gather(si, 1, choice[:, None])[:, 0].to(torch.int32)


class InferenceEngine:
    """Single-replica engine. Thread-safety is owned by core.replica."""

    def __init__(self, model: LM, params, cfg: EngineConfig, ctx: Optional[RunCtx] = None,
                 tracer: Optional[Tracer] = None):
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
        cfgm = model.cfg
        self.pos_offset = cfgm.vision.n_patches if cfgm.vision is not None else 0
        self.chunk = min(cfg.prefill_chunk, cfg.max_seq)
        self.token_budget = max(cfg.token_budget or (cfg.max_slots + 2 * self.chunk),
                                cfg.max_slots + 1)
        self.chunk_rows = max(1, min(self.token_budget // self.chunk, cfg.max_slots))
        self.allocator = PagedAllocator(cfg.num_pages, cfg.page_size, cfg.max_pages_per_seq)
        # prefix sharing is only sound when a page fully captures a token
        # range's state: an SSM layer carries recurrent state, an enc-dec
        # model cross KV, and a VLM's patch prefix shifts the KV positions
        has_ssm = any("M" in g.pattern for g in cfgm.layer_groups)
        prefix_ok = (cfg.enable_prefix_cache and not has_ssm
                     and cfgm.encoder is None and cfgm.vision is None)
        self.prefix_cache = PrefixCache(self.allocator) if prefix_ok else None
        # speculative decoding rolls KV back by a pure length decrement:
        # sound for paged attention (pages are append-only and masked by
        # ``lengths``), unsound for an SSM layer's conv + recurrent carry
        self.spec_on = cfg.enable_speculative and cfg.spec_k > 0 and not has_ssm
        self.spec_kmax = cfg.spec_k
        self.draft_source = (PromptLookupDraft(cfg.spec_ngram_max, cfg.spec_ngram_min)
                             if self.spec_on else None)
        # the verify sweep's width ladder, C = 1 + k for k in {1, 2, 4, ...,
        # kmax}: a sweep takes the narrowest width that holds its longest
        # draft, so its compute (M * C whatever the rows' drafts) follows
        # the drafts' volume instead of always paying 1 + kmax
        self._spec_widths: List[int] = []
        if self.spec_on:
            k = 1
            while k < self.spec_kmax:
                self._spec_widths.append(1 + k)
                k *= 2
            self._spec_widths.append(1 + self.spec_kmax)
        self.scheduler = ContinuousBatchScheduler(
            cfg.max_slots, self.allocator, policy=cfg.scheduler, max_seq=cfg.max_seq,
            kv_extra=self.pos_offset, prefix_cache=self.prefix_cache, tracer=tracer)
        self.cache = model.init_cache(
            cfg.max_slots, cfg.max_seq, cfg.cache_dtype, kind="paged",
            page_size=cfg.page_size, num_pages=cfg.num_pages, device=self.device)
        self.page_table = np.zeros((cfg.max_slots, cfg.max_pages_per_seq), np.int32)
        self.extras: Dict[Tuple[str, str], Any] = {}   # frames / patches per request
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(cfg.seed)
        # resilience hooks: a FaultInjector evaluated at the top of every step
        # (None costs one attribute check), the replica id it matches fault
        # events against, and the brown-out flag that disables speculative
        # drafting while set
        self.injector = None
        self.fault_key: Optional[str] = None
        self.degraded = False
        self.steps = 0
        self.decode_tokens = 0
        self.prefill_tokens = 0
        self.deadline_exceeded = 0        # requests cancelled past deadline
        self.spec_steps = 0               # iterations that ran the verify sweep
        self.drafted_tokens = 0           # draft tokens fed through verify
        self.accepted_tokens = 0          # draft tokens accepted (committed)
        self.prefix_cached_tokens = 0     # prefill tokens skipped via cache hits
        self.iter_token_counts: deque = deque(maxlen=4096)
        # iteration profiler: one StepRecord per step() in a bounded ring;
        # per-step row counts set by _step as it packs
        self.step_records: deque = deque(maxlen=cfg.step_records_cap)
        self._last_admitted = 0
        self._last_prefill_rows = 0
        self._last_decode_rows = 0

    # ------------------------------------------------------------- model call
    def _run(self, tokens, starts, nvalid, slots, first, page_table,
             spec: bool = False, frames=None, patches=None) -> np.ndarray:
        """One fused iteration over a packed batch of per-sequence chunks
        (decode == chunk of 1), with a pack's ``frames`` / ``patches``
        (``_row_extras``). Returns the next token per row (0 for inactive
        rows) on the host. With ``spec`` (the speculative decode
        sweep) every row fed [last_token, d_1 .. d_k], the head scores every
        fed position and ``verify_draft`` turns the logits into the accepted
        prefix's length and the token to commit after it: returns (2, rows),
        (n_acc, next token), in one readback."""
        tk, st, nv, sl, fi, pt = (torch.from_numpy(a).to(self.device)
                                  for a in (tokens, starts, nvalid, slots, first, page_table))
        cfg = self.cfg
        with torch.inference_mode():
            logits, self.cache = self.model.decode_chunk(
                self.params, tk, self.cache, st, nv, sl, fi, self.ctx, pt, frames=frames,
                patches=patches, all_logits=spec)
            if spec:
                n_acc, nxt = verify_draft(logits, tk, nv, self._gen, cfg.temperature,
                                          cfg.top_p, cfg.greedy)
            else:
                nxt = sample_tokens(logits, self._gen, cfg.temperature, cfg.top_p, cfg.greedy)
            nxt = torch.where(nv > 0, nxt, 0)
            if spec:
                nxt = torch.stack([n_acc, nxt])
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

    def _row_extras(self, grants, B: int):
        """A pack's encoder frames (B, cross_attn_memory, d_model), each row's
        cropped or zero-padded, and vision patches (B, n_patches, d_patch),
        on the device; zeros on rows whose request has none. (None, None)
        parts for a config without that frontend."""
        cfgm = self.model.cfg
        frames = patches = None
        if cfgm.encoder is not None:
            M = cfgm.encoder.cross_attn_memory
            fr = np.zeros((B, M, cfgm.d_model), np.float32)
            for i, (st, _) in enumerate(grants):
                v = self.extras.get((st.request.req_id, "frames"))
                if v is not None:
                    v = np.asarray(v)[0]
                    m = min(M, v.shape[0])
                    fr[i, :m] = v[:m]
            frames = torch.from_numpy(fr).to(self.device)
        if cfgm.vision is not None:
            pa = np.zeros((B, cfgm.vision.n_patches, cfgm.vision.d_patch), np.float32)
            for i, (st, _) in enumerate(grants):
                v = self.extras.get((st.request.req_id, "patches"))
                if v is not None:
                    pa[i] = np.asarray(v)[0]
            patches = torch.from_numpy(pa).to(self.device)
        return frames, patches

    # ------------------------------------------------------------- step
    def step(self) -> List[TokenEvent]:
        """One token-budget iteration: admissions, the prefill chunk pack,
        then one decode sweep — at most ``token_budget`` tokens total.
        With ``profile_steps`` each iteration leaves one :class:`StepRecord`
        in the ``step_records`` ring buffer."""
        if self.injector is not None:
            self.injector.on_engine_step(self)
        if not self.cfg.profile_steps:
            return self._step()
        t0 = now()
        preempt0 = self.scheduler.n_preemptions
        cow0 = self.allocator.cow_copies
        prefill0, decode0 = self.prefill_tokens, self.decode_tokens
        drafted0, accepted0 = self.drafted_tokens, self.accepted_tokens
        # every model call ends by reading its sampled tokens back to the
        # host; the fence also waits for queued work such as COW copies
        events = self._step()
        if self.cfg.profile_fence and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        alloc = self.allocator
        self.step_records.append(StepRecord(
            step=self.steps, t0=t0, t1=now(), budget=self.token_budget,
            tokens_packed=self.iter_token_counts[-1] if self.iter_token_counts else 0,
            n_admitted=self._last_admitted,
            prefill_rows=self._last_prefill_rows,
            prefill_tokens=self.prefill_tokens - prefill0,
            decode_rows=self._last_decode_rows,
            decode_tokens=self.decode_tokens - decode0,
            drafted_tokens=self.drafted_tokens - drafted0,
            accepted_tokens=self.accepted_tokens - accepted0,
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
        if cfg.host_overhead_s > 0:
            time.sleep(cfg.host_overhead_s)
        self.steps += 1
        iter_tokens = 0
        self._last_admitted = self._last_prefill_rows = self._last_decode_rows = 0

        # deadline sweep: cancel requests past their absolute cutoff before
        # planning, so an expired request frees its pages this iteration
        for slot, req in self.scheduler.expire_deadlines(now()):
            if slot is not None:
                self.page_table[slot] = 0
            self._drop_extras(req.req_id)
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
            st.spec_k = self.spec_kmax if self.spec_on else 0
            self.prefix_cached_tokens += st.cached_tokens
            if tr:
                tr.end(r.req_id, "queue", cached_tokens=st.cached_tokens,
                       resumed=bool(r.generated))
            if st.feed_len + self.pos_offset >= cfg.max_seq:
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
                lo = (self.pos_offset + st.fed) // cfg.page_size
                hi = (self.pos_offset + st.fed + n - 1) // cfg.page_size
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
            # frames and patches matter only on a row's first chunk (the
            # cross KV persists in the slot, the prefix KV in its pages):
            # a pack without one skips the encoder and the prefix
            frames, patches = self._row_extras(grants, B) if first.any() else (None, None)
            nxt = self._run(tokens, starts, nvalid, slots, first, pt, frames=frames,
                            patches=patches)
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
        # prompt-lookup drafting for slots the plan granted draft tokens:
        # match the slot's recent suffix against its own prompt+output
        # history; cap so the draft tail never runs past max_seq
        drafts: Dict[int, List[int]] = {}
        if self.spec_on and not self.degraded:             # brown-out: no drafting
            for st in decode_sts:
                g = min(plan.draft.get(st.slot, 0), cfg.max_seq - 1 - self.pos_offset - st.fed)
                if g > 0:
                    d = self.draft_source.propose(st.all_tokens, g)
                    if d:
                        drafts[st.slot] = d
        dec_copies: List[Tuple[int, int]] = []
        for st in list(decode_sts):
            if st.slot not in self.scheduler.running:      # preempted by an earlier grow
                decode_sts.remove(st)
                continue
            k_i = len(drafts.get(st.slot, ()))
            grown = self.scheduler.grow_for_tokens(st.slot, st.fed + 1 + k_i)
            if not grown and k_i:
                drafts.pop(st.slot, None)                  # retry draft-free
                k_i = 0
                grown = self.scheduler.grow_for_decode(st.slot)
            if not grown:
                decode_sts.remove(st)                      # paused/unschedulable
                continue
            if self.prefix_cache is not None:
                # the row writes kv positions [fed, fed + k_i]: a draft can
                # reach into a shared or registered page past the first
                lo = (self.pos_offset + st.fed) // cfg.page_size
                hi = (self.pos_offset + st.fed + k_i) // cfg.page_size
                n_cow = len(dec_copies)
                writable = self.scheduler.make_writable(st.slot, lo, hi, dec_copies)
                if tr and len(dec_copies) > n_cow:
                    tr.event(st.request.req_id, "cow",
                             n_pages=len(dec_copies) - n_cow)
                if not writable:
                    decode_sts.remove(st)
                    continue
            self.page_table[st.slot] = self.allocator.page_table_row(st.slot)
        decode_sts = [st for st in decode_sts if st.slot in self.scheduler.running]
        live = {st.slot for st in decode_sts}
        drafts = {s: d for s, d in drafts.items() if s in live}
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
        if drafts:
            iter_tokens = self._spec_sweep(decode_sts, drafts, events, iter_tokens)
            self.iter_token_counts.append(iter_tokens)
            return events
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
                # decode run (broken by preemption/spec/prefill spans)
                tr.add(st.request.req_id, "decode", t_dec0, t_emit,
                       merge=True, n_iters=1, tokens=1)
            fin = self._check_finished(st, tok)
            events.append(TokenEvent(st.request, tok, t_emit, fin))
            if fin:
                self._finish(st)
        self.iter_token_counts.append(iter_tokens)
        return events

    def _spec_sweep(self, decode_sts: List[SlotState], drafts: Dict[int, List[int]],
                    events: List[TokenEvent], iter_tokens: int) -> int:
        """One speculative decode iteration over all decode-ready slots
        (draft-free slots ride along as rows of one valid token). Feeds
        [last_token, d_1 .. d_k] per row, commits the accepted prefix plus
        the bonus/corrected token, and rolls rejected KV back by truncating
        the slot's page tail (pages are append-only; positions at or past
        ``fed`` are never read and are overwritten by the next write)."""
        cfg = self.cfg
        tr = self.tracer
        t_sw0 = now()
        M = cfg.max_slots
        kcap = max(len(d) for d in drafts.values())
        C = next(w for w in self._spec_widths if w >= 1 + kcap)
        tokens = np.zeros((M, C), np.int32)
        starts = np.zeros((M,), np.int32)
        nvalid = np.zeros((M,), np.int32)
        for st in decode_sts:
            d = drafts.get(st.slot, [])
            tokens[st.slot, 0] = st.last_token
            tokens[st.slot, 1:1 + len(d)] = d
            starts[st.slot] = st.fed
            nvalid[st.slot] = 1 + len(d)
        n_acc, out = self._run(tokens, starts, nvalid, np.arange(M, dtype=np.int32),
                               np.zeros((M,), bool), self.page_table, spec=True)
        t_emit = now()
        self.spec_steps += 1
        for st in decode_sts:
            d = drafts.get(st.slot, [])
            k_i = len(d)
            na = int(n_acc[st.slot])
            committed = d[:na] + [int(out[st.slot])]
            iter_tokens += 1 + k_i         # all fed tokens count, rejected too
            self.drafted_tokens += k_i
            self.accepted_tokens += na
            if k_i:
                # adapt k additively: +1 on full acceptance, -1 only when
                # the whole draft was rejected, hold on partial acceptance
                # (it still amortizes the sweep); a slot that keeps drafting
                # garbage shrinks toward k = 1, which narrows the sweep too
                if na == k_i:
                    st.spec_k = min(self.spec_kmax, st.spec_k + 1)
                elif na == 0:
                    st.spec_k = max(1, st.spec_k - 1)
            fin = False
            n_committed = 0
            for tok in committed:
                st.fed += 1                # commits the KV of the PREVIOUS token
                st.last_token = tok
                st.all_tokens.append(tok)
                st.request.generated.append(tok)
                self.decode_tokens += 1
                n_committed += 1
                fin = self._check_finished(st, tok)
                events.append(TokenEvent(st.request, tok, t_emit, fin))
                if fin:
                    self._finish(st)       # frees every page, rollback included
                    break
            if tr:
                if k_i:
                    tr.add(st.request.req_id, "spec_verify", t_sw0, t_emit,
                           merge=True, n_iters=1, drafted=k_i, accepted=na,
                           tokens=n_committed)
                else:                      # draft-free row riding the sweep
                    tr.add(st.request.req_id, "decode", t_sw0, t_emit,
                           merge=True, n_iters=1, tokens=n_committed)
            if not fin and na < k_i:
                # roll the rejected tail back: keep pages through the next
                # decode write (position fed), drop pages grown only for
                # rejected drafts. Never touches registered prompt blocks:
                # they precede fed by construction
                # (pos_offset counted here and again as the scheduler's
                # kv_extra, as the reference does: a VLM slot keeps up to
                # one prefix's worth of pages more)
                self.scheduler.shrink_to_tokens(st.slot, self.pos_offset + st.fed + 1)
        return iter_tokens

    def _check_finished(self, st: SlotState, tok: int) -> bool:
        r = st.request
        if len(r.generated) >= r.max_new_tokens:
            return True
        if self.cfg.eos_id >= 0 and tok == self.cfg.eos_id:
            return True
        if st.fed + 1 + self.pos_offset >= self.cfg.max_seq:
            return True                   # kv budget, a vision prefix included
        return False

    def _drop_extras(self, req_id: str) -> None:
        self.extras.pop((req_id, "frames"), None)
        self.extras.pop((req_id, "patches"), None)

    def _finish(self, st: SlotState) -> None:
        st.request.finished = True
        st.request.t3 = now()
        self.scheduler.finish(st.slot)
        self._drop_extras(st.request.req_id)

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
            "spec_steps": float(self.spec_steps),
            "drafted_tokens": float(self.drafted_tokens),
            "accepted_tokens": float(self.accepted_tokens),
            "spec_acceptance_rate": (self.accepted_tokens / self.drafted_tokens
                                     if self.drafted_tokens else 0.0),
        }

    def cancel(self, req_id: str) -> bool:
        """Drop a request (hedging loser / client disconnect). Frees its slot."""
        if self.tracer:
            self.tracer.discard(req_id)
        for i, r in enumerate(self.scheduler.waiting):
            if r.req_id == req_id:
                del self.scheduler.waiting[i]
                self._drop_extras(req_id)
                return True
        for slot, st in list(self.scheduler.running.items()):
            if st.request.req_id == req_id:
                self.scheduler.finish(slot)
                self.page_table[slot] = 0
                self._drop_extras(req_id)
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
