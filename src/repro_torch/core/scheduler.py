"""Iteration-level (continuous) batching scheduler with the paper's
max-utilization policy and Sarathi-style token-budget iterations.

Policies:
  max_utilization  admit whenever a slot is free and the first prefill chunk
                   fits in free pages — maximize tokens-in-flight per
                   iteration; if pages run out mid-decode or mid-prefill,
                   PAUSE (preempt) the most recently admitted request,
                   freeing its pages; it re-enters the head of the waiting
                   queue and is re-prefilled later (the paper's "pausing
                   requests if KV cache size limit is reached").
  conservative     admit only if prompt + max_new_tokens worth of pages is
                   free — no preemption can ever be needed.
  static           classic static batching (the HF-endpoint baseline, Fig 2):
                   admit a batch only when the engine is idle, never refill
                   slots until every sequence in the batch finishes.

Token-budget iterations (``plan_iteration``, DESIGN.md §2): every engine
step packs all pending decode tokens plus prefill *chunks* up to a fixed
per-iteration token budget. Long prompts prefill over several iterations
(tracked by ``SlotState.fed`` vs ``SlotState.feed_len``), so an admitted
prompt never stalls running decodes for its full length — the
chunked-prefill fix for TTFT/TPOT interference.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.core.kv_cache import OutOfPages, PagedAllocator, PrefixCache
from repro_torch.core.metrics import Request
from repro_torch.core.observability import Tracer


@dataclass
class SlotState:
    slot: int
    request: Request
    all_tokens: List[int]          # prompt + generated
    fed: int = 0                   # tokens whose KV is in the cache
    feed_len: int = 0              # tokens to feed before decoding can start
    last_token: int = -1           # sampled but not yet fed
    admitted_at: float = 0.0
    order: int = 0                 # admission sequence number (preemption victim choice)
    cached_tokens: int = 0         # prefix-cache hit: tokens whose prefill was skipped
    registered_blocks: int = 0     # prompt pages already inserted into the prefix trie
    spec_k: int = 0                # draft-token allowance (engine-adapted; 0 = no drafting)

    @property
    def prefilling(self) -> bool:
        return self.fed < self.feed_len


@dataclass
class Decisions:
    admit: List[SlotState] = field(default_factory=list)


@dataclass
class IterationPlan:
    """One token-budget iteration: freshly admitted slots, prefill-chunk
    grants (slot, n_tokens), the decode-ready set, and per-slot draft-token
    grants (speculative decoding; slot -> extra tokens the decode row may
    feed this iteration). Token accounting: sum of grant costs + len(decode)
    + sum(draft grants) <= budget, where a prefill grant that completes a
    slot's feed costs n+1 (the slot decodes in the same iteration)."""
    admit: List[SlotState] = field(default_factory=list)
    prefill: List[Tuple[SlotState, int]] = field(default_factory=list)
    decode: List[SlotState] = field(default_factory=list)
    draft: Dict[int, int] = field(default_factory=dict)


class ContinuousBatchScheduler:
    def __init__(self, max_slots: int, allocator: PagedAllocator,
                 policy: str = "max_utilization", max_seq: int = 4096,
                 kv_extra: int = 0, prefix_cache: Optional[PrefixCache] = None,
                 tracer: Optional[Tracer] = None):
        assert policy in ("max_utilization", "conservative", "static")
        # prefix sharing assumes token position == kv position; a kv prefix
        # (VLM patches) shifts every page, so the two are mutually exclusive
        assert prefix_cache is None or kv_extra == 0
        self.max_slots = max_slots
        self.allocator = allocator
        self.policy = policy
        self.max_seq = max_seq
        self.kv_extra = kv_extra       # per-seq kv prefix (e.g. VLM patches)
        self.prefix_cache = prefix_cache
        self.tracer = tracer
        self.waiting: Deque[Request] = deque()
        self.running: Dict[int, SlotState] = {}
        self._order = 0
        self.n_preemptions = 0

    # ------------------------------------------------------------------
    def add(self, request: Request, *, front: bool = False) -> None:
        if self.tracer:
            # one queue span per wait (re-opened on preempt re-queue);
            # closed by the engine at admission
            self.tracer.begin(request.req_id, "queue", requeued=front)
        if front:
            self.waiting.appendleft(request)
        else:
            self.waiting.append(request)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def free_slots(self) -> List[int]:
        return [s for s in range(self.max_slots) if s not in self.running]

    # ------------------------------------------------------------------
    def _pages_for(self, req: Request, restored: int, chunk: int = 0) -> int:
        prompt_len = len(req.prompt_tokens) + restored
        if self.policy == "conservative":
            need = prompt_len + req.max_new_tokens
        elif chunk > 0:
            # chunked admission: only the first chunk (or whole short prompt
            # + one decode token) must fit now; later chunks grow page by
            # page with preemption backpressure.
            need = min(prompt_len + 1, chunk)
        else:
            need = prompt_len + 1          # max utilization: prompt + headroom
        return self.allocator.pages_needed(self.kv_extra + need)

    def schedule(self, chunk: int = 0) -> Decisions:
        d = Decisions()
        if self.policy == "static" and self.running:
            return d                        # static: wait for the whole batch
        free = self.free_slots()
        pending_pages = 0                  # pages this round's admissions will take
        while self.waiting and free:
            req = self.waiting[0]
            restored = max(len(req.generated) - 1, 0)
            all_tokens = list(map(int, req.prompt_tokens)) + list(req.generated)
            feed_len = len(all_tokens) - (1 if req.generated else 0)
            # prefix-cache probe: leading full pages whose KV already exists
            # cost nothing beyond a page-table entry; at least one token is
            # always left to feed so the chunk call yields last-token logits.
            shared: List[int] = []
            n_cached = 0
            if self.prefix_cache is not None and feed_len > 0:
                shared = self.prefix_cache.lookup(
                    all_tokens[:feed_len],
                    record=False)[: self.allocator.max_pages_per_seq]
                if shared:
                    n_cached = min(len(shared) * self.allocator.page_size,
                                   feed_len - 1)
            revive = 0
            if shared:
                # only the uncached remainder needs fresh pages now
                if self.policy == "conservative":
                    tokens_now = feed_len + req.max_new_tokens
                elif chunk > 0:
                    tokens_now = min(feed_len + 1, n_cached + chunk)
                else:
                    tokens_now = feed_len + 1
                need = max(self.allocator.pages_needed(tokens_now) - len(shared), 0)
                # reviving a retired shared page consumes LRU capacity that
                # free_pages still counts as allocatable — bill it as demand,
                # or admission over-commits and leans on OutOfPages/preemption
                revive = sum(1 for p in shared if self.allocator.retired(p))
            else:
                need = self._pages_for(req, restored, chunk)
            if need + revive + pending_pages > self.allocator.free_pages:
                break
            # revived pages leave free_pages at the share() below; only the
            # fresh-page demand carries forward to later candidates
            pending_pages += need
            if self.prefix_cache is not None and feed_len > 0:
                self.prefix_cache.record_probe(feed_len, len(shared))
            self.waiting.popleft()
            slot = free.pop(0)
            st = SlotState(slot=slot, request=req, all_tokens=all_tokens,
                           feed_len=feed_len, fed=n_cached,
                           cached_tokens=n_cached,
                           registered_blocks=len(shared), order=self._order)
            if shared:
                self.allocator.share(slot, shared)
            self._order += 1
            self.running[slot] = st
            d.admit.append(st)
        return d

    # ------------------------------------------------------------------
    def plan_iteration(self, budget: int, chunk: int,
                       max_chunk_rows: int) -> IterationPlan:
        """Pack one engine iteration: every decode-ready slot contributes its
        pending token; the remaining budget is granted to prefilling slots as
        chunks of up to ``chunk`` tokens (at most ``max_chunk_rows`` rows,
        the fixed shape of the engine's chunk call), oldest first."""
        plan = IterationPlan()
        plan.admit = self.schedule(chunk=chunk).admit
        plan.decode = [st for st in self.running.values()
                       if not st.prefilling and st.last_token >= 0]
        spent = len(plan.decode)
        # speculative draft grants: after every decode slot's guaranteed
        # token, leftover budget buys draft tokens (oldest slot first) up to
        # each slot's adaptive allowance. Draft tokens compete with prefill
        # chunks for the same budget — a draft the verify step rejects was
        # still fed through the model.
        for st in sorted(plan.decode, key=lambda s: s.order):
            if st.spec_k <= 0:
                continue
            g = min(st.spec_k, budget - spent)
            if g <= 0:
                break
            plan.draft[st.slot] = g
            spent += g
        prefilling = sorted((st for st in self.running.values() if st.prefilling),
                            key=lambda st: st.order)
        for st in prefilling:
            if len(plan.prefill) >= max_chunk_rows:
                break
            left = budget - spent
            if left <= 0:
                break
            n = min(chunk, st.feed_len - st.fed, left)
            completes = n == st.feed_len - st.fed
            if completes and n + 1 > left:
                n -= 1                     # leave room for the same-step decode
                completes = False
            if n <= 0:
                break
            plan.prefill.append((st, n))
            spent += n + (1 if completes else 0)
        return plan

    # ------------------------------------------------------------------
    def expire_deadlines(self, t: float) -> List[Tuple[Optional[int], Request]]:
        """Deadline-exceeded cancellation (DESIGN.md §5): drop every waiting
        or running request whose ``deadline_at`` has passed. Running slots go
        through ``finish`` so their pages are freed with full refcount
        semantics (shared prefix pages decref, COW-detached pages return to
        the free list). Returns ``(slot, request)`` pairs — ``slot`` is None
        for requests still in the waiting queue — so the engine can emit the
        terminal events and clear its page-table rows."""
        out: List[Tuple[Optional[int], Request]] = []
        for i in reversed(range(len(self.waiting))):
            r = self.waiting[i]
            if r.deadline_at and t > r.deadline_at:
                del self.waiting[i]
                if self.tracer:
                    self.tracer.end(r.req_id, "queue", expired=True)
                out.append((None, r))
        for slot, st in list(self.running.items()):
            r = st.request
            if r.deadline_at and t > r.deadline_at:
                self.finish(slot)
                out.append((slot, r))
        return out

    # ------------------------------------------------------------------
    def preempt_one(self, protect: Optional[int] = None) -> Optional[int]:
        """Pause the most recently admitted running request (vLLM-style
        latest-first victim), freeing its pages. Returns the freed slot."""
        victims = [st for st in self.running.values() if st.slot != protect]
        if not victims:
            return None
        victim = max(victims, key=lambda st: st.order)
        victim.request.preemptions += 1
        self.n_preemptions += 1
        if self.tracer:
            self.tracer.event(victim.request.req_id, "preempt",
                              fed=victim.fed, order=victim.order)
        self.allocator.free(victim.slot)
        del self.running[victim.slot]
        self.add(victim.request, front=True)
        return victim.slot

    def finish(self, slot: int) -> None:
        self.allocator.free(slot)
        del self.running[slot]

    def grow_for_tokens(self, slot: int, n_tokens: int) -> bool:
        """Ensure slot owns pages covering ``n_tokens`` kv entries (plus the
        kv_extra prefix); preempt others if the policy allows. Returns False
        if the slot itself must pause."""
        st = self.running[slot]
        while True:
            try:
                self.allocator.allocate(slot, self.kv_extra + n_tokens)
                return True
            except OutOfPages:
                if self.policy != "max_utilization":
                    return False
                if self.preempt_one(protect=slot) is None:
                    return False

    def grow_for_decode(self, slot: int) -> bool:
        """Ensure slot has a page for one more token; preempt others if the
        policy allows. Returns False if the slot itself must pause."""
        return self.grow_for_tokens(slot, self.running[slot].fed + 1)

    def shrink_to_tokens(self, slot: int, n_tokens: int) -> int:
        """Rollback partner of ``grow_for_tokens``: drop pages past those
        covering ``n_tokens`` kv entries (plus the kv_extra prefix). Used
        after speculative verify rejects draft tokens, so pages grown for a
        rejected tail never sit idle under page pressure."""
        keep = self.allocator.pages_needed(self.kv_extra + n_tokens)
        return self.allocator.truncate(slot, keep)

    def make_writable(self, slot: int, first_block: int, last_block: int,
                      copies: List[Tuple[int, int]]) -> bool:
        """Copy-on-write entry point: detach any shared/cached pages in the
        slot's logical range [first_block, last_block] onto fresh pages
        (preempting under page pressure, like growth). The (src, dst) device
        page copies are appended to ``copies`` — including pairs from blocks
        detached before an ``OutOfPages``, which the caller MUST still apply
        even on failure (those blocks already point at fresh pages holding
        garbage). Returns False if the slot itself must pause: the range is
        not fully exclusive and must not be written."""
        while True:
            try:
                self.allocator.ensure_exclusive(slot, first_block, last_block,
                                                copies=copies)
                return True
            except OutOfPages:
                if self.policy != "max_utilization":
                    return False
                if self.preempt_one(protect=slot) is None:
                    return False
