"""Host-side page allocator for the paged KV cache (a numpy-only copy of
``repro.serving.pages``).

The device side (``models/cache.py``'s ``PagedBackend(managed=True)``)
stores K/V in a pool of fixed-size pages plus a per-slot block table; this
module owns the *host* bookkeeping that decides which physical pages each
admitted request maps to:

  * a free list of physical page ids (page 0 is a permanent trash page —
    never allocated, the target of every unmapped block-table entry, so
    writes from inactive rows land somewhere harmless),
  * per-page refcounts (copy-on-write prefix sharing means a page can back
    several slots at once),
  * a prefix map ``{(page_index, prompt_token_prefix): page_id}`` so two
    requests whose prompts agree on every token covered by a page share
    one physical copy, and
  * a reclaim queue (LRU) of zero-refcount pages that still hold a cached
    prefix — they stay reusable for future prompt hits until the pool
    needs the space (vLLM-style cache hold).

Everything here is plain Python over numpy outputs, so the allocator is
cheap to call per admission and easy to property-test.

Safety argument for sizing: ``plan_admit`` maps exactly
``ceil((prefix + prompt_len + max_new + block_k) / page_size)`` pages.
Admission prefill may write junk K/V for padded prompt positions beyond
that bound; those land on the trash page, and their ``pos`` entries are
never visible (``pos >= length + k`` forever), so the plan is exact, not
conservative.  Decode writes stay inside the mapped range by construction
(text length is monotone and capped at ``prompt_len + max_new``).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np


class PagePoolExhausted(RuntimeError):
    """Raised by ``plan_admit`` when the pool cannot cover a new request.

    The scheduler treats this as back-pressure: the request goes back to
    the queue and admission pauses until ``release`` frees pages.
    """


class PageAllocator:
    """Free-list page allocator with refcounts and CoW prefix sharing.

    Parameters
    ----------
    num_pages : total physical pages in the pool *including* the trash
        page 0 — so ``num_pages - 1`` pages are allocatable.
    page_size : tokens per page.
    pages_per_row : block-table width P (pages addressable per slot).
    prefix_len : model prefix tokens (meta tokens) occupying positions
        ``0..prefix_len-1`` of every row.  They are identical across
        requests, so pages fully covered by ``prefix_len + prompt`` can be
        shared whenever the *prompt* tokens under them agree.
    """

    def __init__(self, num_pages: int, page_size: int, pages_per_row: int,
                 *, prefix_len: int = 0):
        if num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is reserved)")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.pages_per_row = int(pages_per_row)
        self.prefix_len = int(prefix_len)
        # page 0 reserved; hand out low ids first (stable, test-friendly)
        self.free: List[int] = list(range(num_pages - 1, 0, -1))
        self.refcount: Dict[int, int] = {}
        # (page_index, prompt-token prefix tuple) -> physical page
        self.prefix_map: Dict[Tuple, int] = {}
        self.page_key: Dict[int, Tuple] = {}
        # zero-ref pages still holding a cached prefix, oldest first
        self.reclaimable: "OrderedDict[int, None]" = OrderedDict()
        # slot -> list of mapped physical pages
        self.slot_pages: Dict[int, List[int]] = {}
        self.cow_hits = 0  # pages mapped from the prefix cache, not written

    # -- internals ----------------------------------------------------------

    def _grab_page(self) -> Optional[int]:
        """A writable page: free list first, then evict the LRU cached
        prefix.  Returns None when the pool is truly exhausted."""
        if self.free:
            return self.free.pop()
        if self.reclaimable:
            page, _ = self.reclaimable.popitem(last=False)
            key = self.page_key.pop(page)
            del self.prefix_map[key]
            return page
        return None

    def _incref(self, page: int) -> None:
        self.refcount[page] = self.refcount.get(page, 0) + 1

    def _decref(self, page: int) -> None:
        n = self.refcount.get(page, 0)
        if n <= 0:
            raise RuntimeError(f"double free of page {page}")
        if n == 1:
            del self.refcount[page]
            if page in self.page_key:
                self.reclaimable[page] = None  # keep the cached prefix
            else:
                self.free.append(page)
        else:
            self.refcount[page] = n - 1

    # -- public API ---------------------------------------------------------

    def pages_needed(self, prompt_len: int, max_new: int,
                     block_k: int = 0) -> int:
        span = self.prefix_len + prompt_len + max_new + block_k
        return -(-span // self.page_size)

    def plan_admit(self, slot: int, prompt_tokens, prompt_len: int,
                   max_new: int, block_k: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Map pages for one admission.

        Returns ``(tbl_row, write_mask)``: the slot's block-table row
        ((P,) int32, trash page 0 beyond the mapped range) and a (P,) bool
        mask of pages the admit prefill must scatter into (False for CoW
        prefix hits — their bytes already exist — and for unmapped tail
        pages).  Raises :class:`PagePoolExhausted` (after rolling back any
        partial mappings) when the pool cannot supply the pages.
        """
        if slot in self.slot_pages:
            raise RuntimeError(f"slot {slot} already holds pages")
        ps, P = self.page_size, self.pages_per_row
        n_alloc = self.pages_needed(prompt_len, max_new, block_k)
        if n_alloc > P:
            raise ValueError(
                f"request needs {n_alloc} pages but rows address only {P}")
        if n_alloc > self.num_pages - 1:
            # not back-pressure: even a drained pool can never satisfy this
            raise ValueError(
                f"request needs {n_alloc} pages but the pool only has "
                f"{self.num_pages - 1} allocatable pages: raise "
                f"EngineConfig.page_pool_pages to at least {n_alloc + 1}")
        prompt = tuple(int(t) for t in np.asarray(prompt_tokens).reshape(-1)
                       [:prompt_len])

        tbl_row = np.zeros((P,), np.int32)
        write_mask = np.zeros((P,), bool)
        mapped: List[int] = []
        fresh_keys: List[int] = []  # prefixes registered by THIS plan
        hits = 0
        for i in range(n_alloc):
            key = None
            # shareable iff entirely covered by prefix + real prompt tokens
            if (i + 1) * ps <= self.prefix_len + prompt_len:
                key = (i, prompt[:(i + 1) * ps - self.prefix_len])
            if key is not None and key in self.prefix_map:
                page = self.prefix_map[key]
                self.reclaimable.pop(page, None)  # back in active use
                self._incref(page)
                tbl_row[i] = page
                mapped.append(page)
                hits += 1
                continue  # write_mask stays False: bytes already on device
            page = self._grab_page()
            if page is None:
                # Roll back this plan entirely.  Prefixes registered by
                # THIS plan must be unregistered first: the admit prefill
                # never ran, so their bytes don't exist device-side — left
                # registered they would satisfy a later plan as a CoW hit
                # (write_mask False) and serve garbage KV.
                for p in fresh_keys:
                    del self.prefix_map[self.page_key.pop(p)]
                for p in mapped:
                    self._decref(p)
                raise PagePoolExhausted(
                    f"page pool exhausted admitting slot {slot}: needed "
                    f"{n_alloc} pages, {len(mapped)} mapped before running "
                    f"out (pool={self.num_pages - 1} allocatable)")
            self._incref(page)
            if key is not None:  # future identical prefixes share this page
                self.prefix_map[key] = page
                self.page_key[page] = key
                fresh_keys.append(page)
            tbl_row[i] = page
            write_mask[i] = True
            mapped.append(page)
        self.slot_pages[slot] = mapped
        self.cow_hits += hits
        return tbl_row, write_mask

    def release(self, slot: int) -> int:
        """Return all of a slot's pages (on harvest/evict).  Shared pages
        just drop a reference; cached prefixes become reclaimable rather
        than free.  Returns the number of pages released."""
        pages = self.slot_pages.pop(slot, None)
        if pages is None:
            return 0
        for p in pages:
            self._decref(p)
        return len(pages)

    # -- introspection (tests, bench) ---------------------------------------

    def live_pages(self) -> int:
        """Pages currently referenced by at least one slot."""
        return len(self.refcount)

    def available_pages(self) -> int:
        """Pages a new admission could draw on (free + reclaimable)."""
        return len(self.free) + len(self.reclaimable)

    def check_invariants(self) -> None:
        """Internal-consistency assertions (used by property tests)."""
        allp = set(self.free) | set(self.refcount) | set(self.reclaimable)
        assert 0 not in allp, "trash page 0 leaked into the pool"
        assert len(self.free) + len(self.refcount) + len(self.reclaimable) \
            == self.num_pages - 1, "pages lost or duplicated"
        assert not (set(self.free) & set(self.refcount))
        assert not (set(self.free) & set(self.reclaimable))
        assert not (set(self.refcount) & set(self.reclaimable))
        for key, page in self.prefix_map.items():
            assert self.page_key.get(page) == key
        held = [p for pages in self.slot_pages.values() for p in pages]
        counts: Dict[int, int] = {}
        for p in held:
            counts[p] = counts.get(p, 0) + 1
        assert counts == self.refcount, "refcounts out of sync with slots"
