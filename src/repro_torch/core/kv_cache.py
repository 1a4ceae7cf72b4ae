"""Paged KV cache management (host side): the PagedAttention resource model
with refcounted pages, copy-on-write, and an automatic prefix cache.

The device side is a global physical page pool per layer (see
``LM.init_cache(kind="paged")`` and the Pallas paged_attention kernel); this
module owns the *allocator*: free-page list, per-slot page tables, refcounts,
the LRU pool of retired-but-cached pages, and the capacity queries the
scheduler's max-utilization policy needs.

Page lifecycle (DESIGN.md §2):

    free ──allocate──▶ exclusive (ref 1) ──share──▶ shared (ref > 1)
      ▲                    │  ▲                        │
      │                    │  └────── COW copy ◀───────┘  (write to a shared
      │              free(slot), not cached               or cached page)
      │                    │
      │                    ▼        free(slot), cached
      └──evict (LRU)── retired (ref 0, content kept, reusable via the trie)

A page whose refcount drops to 0 is only returned to the free list if the
prefix cache holds no node for it; otherwise it is *retired* to an LRU pool,
where its contents stay valid and a later request with the same prompt
prefix can revive it with a pure page-table update (no prefill). Retired
pages are reclaimed (LRU order) before ``OutOfPages``/preemption fires, so
the prefix cache multiplies effective pool capacity instead of consuming it.

Invariants (property-tested in tests/test_kv_cache.py):
  - referenced + free + retired == total - 1 (page 0 reserved)
  - sum of refcounts == sum of per-slot ownership counts
  - a page with refcount > 1 (or registered in the trie) is never written:
    writers must call ``ensure_exclusive`` first (copy-on-write)
  - eviction only ever takes refcount-0 pages
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


class OutOfPages(Exception):
    pass


@dataclass
class PagedAllocator:
    num_pages: int
    page_size: int
    max_pages_per_seq: int

    def __post_init__(self):
        # page 0 is reserved as the "null" page so uninitialized page-table
        # entries never alias a live page
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self._owned: Dict[int, List[int]] = {}
        self._ref: Dict[int, int] = {}
        # retired pages: refcount 0 but still holding prefix-cache content;
        # ordered oldest-first so popitem(last=False) is the LRU victim
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        # pages the prefix cache holds a node for (content must not mutate)
        self._cached: set = set()
        # artificially held pages (fault injection: simulated page pressure),
        # keyed by hold name; excluded from the free list until released
        self._held: Dict[str, List[int]] = {}
        # called with the page id when a retired page is reclaimed, so the
        # prefix cache can drop its node
        self.on_evict: Optional[Callable[[int], None]] = None
        self.evicted_pages = 0
        self.cow_copies = 0

    # ---------------- queries ----------------
    @property
    def free_pages(self) -> int:
        """Allocatable capacity: the free list plus reclaimable retired pages."""
        return len(self._free) + len(self._lru)

    @property
    def used_pages(self) -> int:
        return (self.num_pages - 1) - self.free_pages

    @property
    def retired_pages(self) -> int:
        return len(self._lru)

    @property
    def live_pages(self) -> int:
        """Pages currently referenced by at least one slot. Zero when every
        sequence has finished — the leak check the chaos benchmarks gate on
        (retired prefix-cache pages are refcount-0 and do not count)."""
        return len(self._ref)

    def pages_needed(self, n_tokens: int) -> int:
        return (n_tokens + self.page_size - 1) // self.page_size

    def can_allocate(self, slot: int, n_tokens: int) -> bool:
        have = len(self._owned.get(slot, []))
        need = self.pages_needed(n_tokens) - have
        if have + max(need, 0) > self.max_pages_per_seq:
            return False
        return need <= self.free_pages

    def utilization(self) -> float:
        return self.used_pages / max(self.num_pages - 1, 1)

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def retired(self, page: int) -> bool:
        """True if the page sits in the LRU pool: its content is reusable but
        reviving it consumes capacity that ``free_pages`` counts."""
        return page in self._lru

    def owned(self, slot: int) -> List[int]:
        return list(self._owned.get(slot, []))

    # ---------------- mutations ----------------
    def _take_page(self) -> int:
        """Pop a writable page: free list first, then evict the LRU retired
        page (its prefix-cache node is dropped via ``on_evict``)."""
        if self._free:
            return self._free.pop()
        if self._lru:
            page, _ = self._lru.popitem(last=False)
            self._cached.discard(page)
            self.evicted_pages += 1
            if self.on_evict is not None:
                self.on_evict(page)
            return page
        raise OutOfPages("pool exhausted")

    def _decref(self, page: int) -> None:
        self._ref[page] -= 1
        if self._ref[page] == 0:
            del self._ref[page]
            if page in self._cached:
                self._lru[page] = None     # retire: content stays reusable
            else:
                self._free.append(page)

    def allocate(self, slot: int, n_tokens: int) -> List[int]:
        """Ensure `slot` owns enough pages for n_tokens; returns newly added."""
        owned = self._owned.setdefault(slot, [])
        need = self.pages_needed(n_tokens) - len(owned)
        if need > self.free_pages:
            raise OutOfPages(f"slot {slot}: need {need}, free {self.free_pages}")
        if len(owned) + max(need, 0) > self.max_pages_per_seq:
            raise OutOfPages(f"slot {slot}: exceeds max_pages_per_seq")
        new = [self._take_page() for _ in range(max(need, 0))]
        for p in new:
            self._ref[p] = 1
        owned.extend(new)
        return new

    def share(self, slot: int, pages: Sequence[int]) -> None:
        """Map existing physical pages into ``slot``'s table (prefix-cache
        hit): each page's refcount rises; retired pages are revived out of
        the LRU pool. Must form the slot's leading pages (called once, at
        admission, before any allocate)."""
        owned = self._owned.setdefault(slot, [])
        assert not owned, "share() must precede allocate() for a slot"
        if len(pages) > self.max_pages_per_seq:
            raise OutOfPages(f"slot {slot}: exceeds max_pages_per_seq")
        for p in pages:
            if p in self._ref:
                self._ref[p] += 1
            else:
                self._lru.pop(p, None)     # revive retired page
                self._ref[p] = 1
            owned.append(p)

    def ensure_exclusive(self, slot: int, first_block: int, last_block: int,
                         copies: Optional[List[Tuple[int, int]]] = None
                         ) -> List[Tuple[int, int]]:
        """Copy-on-write: make the slot's logical pages [first_block,
        last_block] safe to write. A page that is shared (refcount > 1) or
        registered in the prefix cache is replaced by a fresh page; the
        returned (src, dst) pairs must be applied as device-side page copies
        BEFORE the write lands. Never mutates a page with refcount > 1.

        Pairs are appended to ``copies`` when given, so they survive an
        ``OutOfPages`` raised partway through the range: blocks detached
        before the abort already point at fresh pages holding garbage, and a
        retrying caller (scheduler.make_writable) must still apply their
        device copies — dropping them would leave uninitialized KV where
        cached prefix content was expected."""
        if copies is None:
            copies = []
        owned = self._owned.get(slot, [])
        for i in range(max(first_block, 0), min(last_block + 1, len(owned))):
            p = owned[i]
            if self._ref[p] > 1 or p in self._cached:
                dst = self._take_page()    # before decref: dst must not be p
                self._ref[dst] = 1
                self._decref(p)
                owned[i] = dst
                copies.append((p, dst))
                self.cow_copies += 1
        return copies

    def free(self, slot: int) -> int:
        """Drop the slot's references. Pages reaching refcount 0 go back to
        the free list, or retire to the LRU pool if the prefix cache still
        points at them."""
        owned = self._owned.pop(slot, [])
        for p in owned:
            self._decref(p)
        return len(owned)

    def truncate(self, slot: int, n_pages: int) -> int:
        """Release the slot's trailing pages beyond its first ``n_pages``
        (speculative-decode rollback: pages grown for rejected draft tokens
        go straight back). Each dropped page is decref'd — a shared page
        loses one reference, a trie-registered page retires to the LRU pool
        with its content intact, an exclusive uncached page returns to the
        free list. Returns the number of pages dropped."""
        owned = self._owned.get(slot, [])
        dropped = 0
        while len(owned) > max(n_pages, 0):
            self._decref(owned.pop())
            dropped += 1
        return dropped

    # ---------------- fault-injection holds ----------------
    def hold(self, n_pages: int, key: str = "fault") -> int:
        """Artificial page pressure (fault injection): move up to ``n_pages``
        pages from the free list into the named hold, where ``free_pages``
        no longer counts them. Only truly free pages are taken — never
        retired (prefix-cache) pages, so injected pressure squeezes capacity
        without silently wiping cached content. Returns the count held."""
        bucket = self._held.setdefault(key, [])
        take = min(max(n_pages, 0), len(self._free))
        for _ in range(take):
            bucket.append(self._free.pop())
        return take

    def held_pages(self, key: str = "fault") -> int:
        return len(self._held.get(key, ()))

    def release_hold(self, key: str = "fault") -> int:
        """Return a named hold's pages to the free list."""
        bucket = self._held.pop(key, [])
        self._free.extend(bucket)
        return len(bucket)

    # ---------------- prefix-cache hooks ----------------
    def mark_cached(self, page: int) -> None:
        self._cached.add(page)

    def unmark_cached(self, page: int) -> None:
        self._cached.discard(page)
        if page in self._lru:               # retired with no node left: free it
            del self._lru[page]
            self._free.append(page)

    # ---------------- page-table export ----------------
    def page_table_row(self, slot: int) -> np.ndarray:
        row = np.zeros(self.max_pages_per_seq, np.int32)
        owned = self._owned.get(slot, [])
        row[: len(owned)] = owned
        return row

    def check_invariants(self) -> None:
        refs = self._ref
        assert all(r >= 1 for r in refs.values()), "zero/negative refcount kept"
        own_counts: Dict[int, int] = {}
        for pages in self._owned.values():
            for p in pages:
                own_counts[p] = own_counts.get(p, 0) + 1
        assert own_counts == dict(refs), "refcounts != ownership counts"
        live, free, lru = set(refs), set(self._free), set(self._lru)
        held = {p for pages in self._held.values() for p in pages}
        assert live.isdisjoint(free) and live.isdisjoint(lru), \
            "page both referenced and free/retired"
        assert free.isdisjoint(lru), "page both free and retired"
        assert held.isdisjoint(live | free | lru), "held page escaped the hold"
        assert len(live) + len(free) + len(lru) + len(held) \
            == self.num_pages - 1, "page leak"
        assert 0 not in live | free | lru | held, "null page escaped"
        assert self._cached <= live | lru, "cached page neither live nor retired"


# ---------------------------------------------------------------------------
# Prefix cache: a trie over full pages of prompt tokens, with each node's
# path materialized as a chained block hash (hash_i = H(hash_{i-1}, block_i)),
# so lookup is a dict walk — one probe per page — and eviction is O(1).
# ---------------------------------------------------------------------------

_ROOT_HASH = 0


def block_hash(prev: int, tokens: Sequence[int]) -> int:
    """Chained content hash of one full page of tokens: blake2b-64 over the
    parent hash and the token bytes. A strong content hash (vLLM moved the
    same way) keeps collisions — accidental, or deliberate prefix-cache
    poisoning in multi-tenant use — from mapping two different prefixes to
    one trie node and silently serving the wrong KV pages."""
    data = np.asarray(tokens, dtype=np.int64).tobytes()
    h = hashlib.blake2b(prev.to_bytes(8, "little") + data, digest_size=8)
    return int.from_bytes(h.digest(), "little")


class PrefixCache:
    """Maps chained token-block hashes to physical pages whose KV content is
    the attention state of exactly that prompt prefix. Nodes hold *weak*
    references: registering a page does not pin it — when its refcount drops
    to 0 the allocator retires it to the LRU pool instead of freeing, and
    reclaiming it from the LRU drops the node (``allocator.on_evict``)."""

    def __init__(self, allocator: PagedAllocator):
        self.allocator = allocator
        self.page_size = allocator.page_size
        self._nodes: Dict[int, int] = {}       # chain hash -> physical page
        self._page_hash: Dict[int, int] = {}   # physical page -> chain hash
        allocator.on_evict = self._on_evict
        self.hit_pages = 0
        self.miss_pages = 0

    def __len__(self) -> int:
        return len(self._nodes)

    def _on_evict(self, page: int) -> None:
        h = self._page_hash.pop(page, None)
        if h is not None:
            self._nodes.pop(h, None)

    # ---------------- lookup / insert ----------------
    def lookup(self, tokens: Sequence[int], *, record: bool = True) -> List[int]:
        """Physical pages covering the longest cached prefix of full token
        blocks. Descendant pages of a missing node are unreachable by
        construction (their chain hash includes the missing ancestor).

        ``record=False`` probes without touching the hit/miss counters — for
        speculative callers (the scheduler re-probes the head-of-queue
        request every scheduling step) that count via ``record_probe`` only
        when the request is actually admitted."""
        ps = self.page_size
        pages: List[int] = []
        h = _ROOT_HASH
        n_blocks = len(tokens) // ps
        for b in range(n_blocks):
            h = block_hash(h, tokens[b * ps:(b + 1) * ps])
            page = self._nodes.get(h)
            if page is None:
                break
            pages.append(page)
        if record:
            self.hit_pages += len(pages)
            self.miss_pages += n_blocks - len(pages)
        return pages

    def record_probe(self, n_tokens: int, hit_pages: int) -> None:
        """Count one admitted request's probe outcome toward the hit-rate
        stats (pairs with ``lookup(..., record=False)``)."""
        self.hit_pages += hit_pages
        self.miss_pages += max(n_tokens // self.page_size - hit_pages, 0)

    def insert(self, tokens: Sequence[int], pages: Sequence[int],
               n_blocks: int) -> int:
        """Register the first ``n_blocks`` full pages of ``tokens`` as cached
        content held in ``pages`` (the owning slot's physical pages, in
        logical order). Existing nodes win — a second slot that prefilled the
        same prefix concurrently keeps its pages private. Returns the number
        of nodes added."""
        ps = self.page_size
        added = 0
        h = _ROOT_HASH
        for b in range(min(n_blocks, len(pages), len(tokens) // ps)):
            h = block_hash(h, tokens[b * ps:(b + 1) * ps])
            if h in self._nodes:
                continue
            page = pages[b]
            if page in self._page_hash:        # page already backs another node
                continue
            self._nodes[h] = page
            self._page_hash[page] = h
            self.allocator.mark_cached(page)
            added += 1
        return added

    def drop(self, page: int) -> None:
        """Explicitly unregister a page (testing / manual invalidation)."""
        self._on_evict(page)
        self.allocator.unmark_cached(page)

    def hit_rate(self) -> float:
        total = self.hit_pages + self.miss_pages
        return self.hit_pages / total if total else 0.0
