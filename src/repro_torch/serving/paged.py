"""Host-side bookkeeping for the paged KV cache: page allocator + prefix
registry (a copy of ``repro/serving/paged.py``; the port imports nothing of
the reference package).

The device side (``models/layers.init_paged_attn_cache`` /
``paged_decode_attention`` and the CUDA kernel behind
``kernels/flash_attention``) sees only two things: per-layer page *pools*
``(num_pages, page_size, KVH, hd)`` and one int32 *page table*
``(max_batch, pages_per_seq)`` mapping each slot's logical page index to a
physical page.  Everything about who owns which page lives here, on the
host; the device side only reads the table.

Ownership rules (the engine is the only writer):

* Physical page 0 is the **null page**: never allocated, permanently
  refcounted.  Free slots point their whole table row at it, so the one
  compiled decode step can scatter "writes" from dead slots harmlessly.
* A page with ``refcount == 1`` is privately owned by one sequence and may
  be written in place (decode appends, prefill scatter).
* A page with ``refcount > 1`` is **shared read-only** (prefix sharing).
  Writers must copy it to a fresh page first — copy-on-write.  The engine
  enforces this via ``ServingEngine._ensure_private`` before every write.
* ``release`` returns the pages whose refcount hit zero; the engine must
  evict any registry entry referencing them before they can be reused
  (``PrefixRegistry.evict``), otherwise a future match would alias
  recycled memory.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

NULL_PAGE = 0


class PoolExhausted(RuntimeError):
    """Raised when an allocation cannot be satisfied.  Admission treats this
    as back-pressure (the request stays queued); mid-decode COW treats it as
    a transient fault (the affected slot quarantines to the retry path —
    see ``ServingEngine._publish_table``)."""


class PageAuditError(AssertionError):
    """The allocator's books diverged from the live page references — a
    leak, a double-free, or a stale free-list entry.  An AssertionError
    subclass on purpose: an audit failure is an engine-invariant bug, not
    an operational condition to be retried."""


class PageAllocator:
    """Fixed pool of ``num_pages`` KV pages with refcounts and a free list.

    Page 0 is reserved as the null page.  ``alloc`` hands out pages at
    refcount 1; ``retain`` implements sharing (+1); ``release`` drops one
    reference per page and recycles pages that hit zero.
    """

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(f"need >= 2 pages (1 null + 1 usable), got {num_pages}")
        self.num_pages = num_pages
        self.refcount = np.zeros((num_pages,), np.int32)
        self.refcount[NULL_PAGE] = 1  # permanently held
        # LIFO free list, lowest ids first out (stable tests, warm reuse)
        self._free: List[int] = list(range(num_pages - 1, 0, -1))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - 1 - len(self._free)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> List[int]:
        if not self.can_alloc(n):
            raise PoolExhausted(
                f"need {n} pages, {len(self._free)} free of {self.num_pages}")
        pages = [self._free.pop() for _ in range(n)]
        self.refcount[pages] = 1
        return pages

    def retain(self, pages: Sequence[int]):
        for p in pages:
            if p == NULL_PAGE or self.refcount[p] <= 0:
                raise ValueError(f"retain of unowned page {p}")
            self.refcount[p] += 1

    def release(self, pages: Sequence[int]) -> List[int]:
        """Drop one reference per page; returns the pages that became free."""
        freed = []
        for p in pages:
            if p == NULL_PAGE:
                continue
            if self.refcount[p] <= 0:
                raise ValueError(f"release of unowned page {p}")
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self._free.append(p)
                freed.append(p)
        return freed

    def audit(self, live_refs: Sequence[int]):
        """Assert the books balance against ``live_refs`` — every live
        page reference, one entry per (owner, page) pair, e.g. the engine's
        flattened slot→pages mapping.  Checks, in order:

        * no live reference names the null page or an unallocated page;
        * every page's refcount equals its live reference count (a
          shortfall is a leak — the allocator thinks someone still owns
          the page; an excess is a use-after-free in the making);
        * the free list has no duplicates, never contains the null page,
          and is exactly the set of zero-refcount pages.

        Raises ``PageAuditError`` with the first divergence; cheap enough
        (O(num_pages + refs)) to run after every engine tick under test.
        """
        expected = np.zeros_like(self.refcount)
        expected[NULL_PAGE] = 1  # permanently held by the allocator itself
        for p in live_refs:
            if p == NULL_PAGE:
                raise PageAuditError("null page appears as an owned reference")
            if not (0 < p < self.num_pages):
                raise PageAuditError(f"live reference to invalid page {p}")
            expected[p] += 1
        bad = np.nonzero(self.refcount != expected)[0]
        if bad.size:
            p = int(bad[0])
            kind = "leaked" if self.refcount[p] > expected[p] else "over-shared"
            raise PageAuditError(
                f"page {p} {kind}: refcount {int(self.refcount[p])} != "
                f"{int(expected[p])} live references "
                f"({bad.size} page(s) diverge)")
        free = set(self._free)
        if len(free) != len(self._free):
            raise PageAuditError("free list contains duplicates")
        if NULL_PAGE in free:
            raise PageAuditError("null page on the free list")
        zero = {int(p) for p in np.nonzero(self.refcount == 0)[0]}
        if free != zero:
            raise PageAuditError(
                f"free list {sorted(free)} != zero-refcount pages "
                f"{sorted(zero)}")


class PrefixRegistry:
    """Maps prompt-token prefixes to the physical pages holding their KV.

    Entries are *weak*: they hold no refcount of their own, so they are only
    valid while some live sequence still references the pages.  The engine
    calls ``evict(freed)`` whenever pages return to the free list, which
    drops every entry touching them — sharing therefore happens between
    temporally-overlapping requests (same system prompt burst, speculative
    drafts), and the pool can never be pinned by a cold registry.
    """

    def __init__(self):
        self._entries: Dict[Tuple[int, ...], List[int]] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def register(self, tokens: Sequence[int], pages: Sequence[int]):
        key = tuple(int(t) for t in tokens)
        if key:
            self._entries[key] = list(pages)

    def match(self, tokens: Sequence[int]) -> Tuple[int, List[int]]:
        """Longest registered prefix of ``tokens``.  Returns
        (matched_token_count, pages covering those tokens) — ([], 0) if no
        entry matches."""
        toks = tuple(int(t) for t in tokens)
        best_key: Tuple[int, ...] = ()
        for key in self._entries:
            if len(key) > len(best_key) and toks[: len(key)] == key:
                best_key = key
        if not best_key:
            return 0, []
        return len(best_key), list(self._entries[best_key])

    def evict(self, freed_pages: Sequence[int]):
        if not freed_pages:
            return
        freed = set(freed_pages)
        dead = [k for k, pages in self._entries.items() if freed.intersection(pages)]
        for k in dead:
            del self._entries[k]
