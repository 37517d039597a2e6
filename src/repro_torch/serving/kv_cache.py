"""Paged KV cache manager (vLLM-style block tables, host-side bookkeeping).

The page *pool* is device memory (torch tensors, shaped (L, NP, page, KH, hd));
this class owns the free list and per-sequence block tables. Token writes and
attention reads happen in the backend's step functions, which receive the
pool plus padded block-table / length arrays built here. (Host-side copy of
the JAX package's allocator, unchanged in behaviour: the port imports
nothing from ``repro``.)

Prefix caching (``enable_prefix_cache=True``) adds three mechanisms on top of
the plain allocator:

* **Content-addressed pages** — every *full* page of a committed prompt is
  registered under a chain hash ``h_i = H(h_{i-1}, tokens_in_page_i)``, so a
  later prompt sharing the same token prefix maps to the same page chain.
* **Copy-on-write reference counts** — matched pages are shared (refcount
  incremented), including with still-running sequences. Any write into a page
  with refcount > 1 must first go through :meth:`writable_page`, which hands
  the caller a private copy target (the backend performs the device copy).
* **LRU free list** — freeing a sequence does not destroy its registered
  pages; they park in an LRU "cached-free" list and can be resurrected by a
  later hash hit. Fresh allocations draw from the never-cached free list
  first and only then evict the least-recently-used cached page (dropping its
  hash registration).

Invariants (checked by tests/test_prefix_cache.py):
  * page 0 is the trash page: never allocated, never hashed;
  * every other page is in exactly one of {referenced (ref>0), LRU
    cached-free, plain free};
  * ``free_pages`` counts plain free + LRU pages (both are claimable);
  * a partial (not-full) page is never registered, so it is only shared in
    the page-aligned full-prefix case handled by :meth:`writable_page`.

Tensor-parallel serving shards the page *pool* along the kv-head axis, but
this allocator stays a single host-side copy: page ids, block tables,
refcounts, and the prefix index are identical on every shard by
construction (each shard's pool slice is indexed by the SAME tables). When
shards run in separate host processes the allocator must be driven with an
identical operation sequence on each — :meth:`snapshot` captures the full
allocator state so tests can assert replicas never diverge under
admit/free/preempt/COW churn (tests/test_tp_mesh.py).
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np


class OutOfPages(RuntimeError):
    pass


class PagedKVCache:
    def __init__(self, num_pages: int, page_size: int, *,
                 enable_prefix_cache: bool = False):
        self.num_pages = num_pages
        self.page_size = page_size
        self.enable_prefix_cache = enable_prefix_cache
        # page 0 is reserved as the trash page: inactive batch slots in the
        # jitted decode step write there (masked reads make it harmless)
        self._free = list(range(num_pages - 1, 0, -1))
        self._tables: dict[str, list[int]] = {}
        self._lens: dict[str, int] = {}
        self._ref: dict[int, int] = {}            # page -> refcount (>0 only)
        # prefix-cache state (all empty when disabled)
        self._hash_of: dict[int, object] = {}     # page -> chain hash
        self._page_of: dict[object, int] = {}     # chain hash -> page
        self._lru: OrderedDict[int, None] = OrderedDict()  # freed cached pages
        self.stats = {"hit_tokens": 0, "miss_tokens": 0, "hit_pages": 0,
                      "evictions": 0, "cow_copies": 0, "resurrections": 0}
        # bumped on every block-table mutation (allocate/append/COW/free);
        # the fused decode path caches device-side tables keyed on this
        self.table_version = 0

    # -- capacity ------------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free) + len(self._lru)

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def can_allocate(self, n_tokens: int) -> bool:
        # conservative: assumes no prefix hit
        return self.pages_needed(n_tokens) <= self.free_pages

    # -- page hashing ----------------------------------------------------------
    def page_hashes(self, tokens: list[int]) -> list[object]:
        """Chain hash per FULL page of ``tokens`` (partial tail excluded)."""
        out = []
        h = None
        for i in range(len(tokens) // self.page_size):
            chunk = tuple(tokens[i * self.page_size:(i + 1) * self.page_size])
            h = hash((h, chunk))
            out.append(h)
        return out

    # -- internal page acquisition ---------------------------------------------
    def _take_page(self) -> int:
        """Claim a writable page: prefer never-cached free pages, then evict
        the least-recently-used cached-free page (its hash dies with it)."""
        if self._free:
            p = self._free.pop()
        elif self._lru:
            p, _ = self._lru.popitem(last=False)       # oldest first
            self._drop_registration(p)
            self.stats["evictions"] += 1
        else:
            raise OutOfPages("page pool exhausted")
        self._ref[p] = 1
        return p

    def _drop_registration(self, page: int) -> None:
        h = self._hash_of.pop(page, None)
        if h is not None and self._page_of.get(h) == page:
            del self._page_of[h]

    def _release_page(self, page: int) -> None:
        self._ref[page] -= 1
        if self._ref[page] > 0:
            return
        del self._ref[page]
        if page in self._hash_of:
            self._lru[page] = None                     # park, resurrectable
            self._lru.move_to_end(page)
        else:
            self._free.append(page)

    # -- lifecycle -----------------------------------------------------------
    def allocate(self, seq_id: str, n_tokens: int) -> list[int]:
        """Plain allocation (no prefix matching)."""
        need = self.pages_needed(max(n_tokens, 1))
        if need > self.free_pages:
            raise OutOfPages(f"{seq_id}: need {need} pages, "
                             f"{self.free_pages} free")
        pages = [self._take_page() for _ in range(need)]
        self._tables[seq_id] = pages
        self._lens[seq_id] = n_tokens
        self.table_version += 1
        return pages

    def allocate_with_prefix(self, seq_id: str,
                             tokens: list[int]) -> tuple[list[int], int]:
        """Allocate pages for a full prompt, reusing the longest cached page
        chain. Returns ``(pages, n_cached)``: the sequence's block table and
        how many leading tokens are already computed in shared pages.

        At least one token is always left to compute (its logits seed
        sampling), so a page-aligned full hit reports ``len(tokens) - 1``
        cached tokens; the recomputed final token's KV write then lands in a
        shared page and is COW'd by the backend via :meth:`writable_page`.
        """
        if not self.enable_prefix_cache:
            pages = self.allocate(seq_id, len(tokens))
            self.stats["miss_tokens"] += len(tokens)
            return pages, 0
        hashes = self.page_hashes(tokens)
        matched: list[int] = []
        for h in hashes:
            p = self._page_of.get(h)
            if p is None:
                break
            matched.append(p)
        n_cached = min(len(matched) * self.page_size, max(len(tokens) - 1, 0))
        need_total = self.pages_needed(max(len(tokens), 1))
        n_fresh = need_total - len(matched)
        if n_fresh > len(self._free) + len(self._lru) - sum(
                1 for p in matched if p in self._lru):
            # matched LRU pages are about to be pinned; they no longer count
            # as claimable when sizing the fresh allocation
            raise OutOfPages(f"{seq_id}: need {n_fresh} fresh pages")
        for p in matched:                              # pin shared pages
            if p in self._lru:
                del self._lru[p]
                self._ref[p] = 1
                self.stats["resurrections"] += 1
            else:
                self._ref[p] += 1
        fresh = [self._take_page() for _ in range(n_fresh)]
        self._tables[seq_id] = matched + fresh
        self._lens[seq_id] = len(tokens)
        self.table_version += 1
        self.stats["hit_tokens"] += n_cached
        self.stats["miss_tokens"] += len(tokens) - n_cached
        self.stats["hit_pages"] += len(matched)
        return self._tables[seq_id], n_cached

    def commit_prefix(self, seq_id: str, tokens: list[int]) -> None:
        """Register the sequence's freshly computed full pages in the content
        index (call once prefill has actually written them)."""
        if not self.enable_prefix_cache:
            return
        table = self._tables[seq_id]
        for i, h in enumerate(self.page_hashes(tokens)):
            p = table[i]
            if p in self._hash_of:
                continue                               # already registered
            if h in self._page_of:
                continue                               # a twin won the race
            self._hash_of[p] = h
            self._page_of[h] = p

    def writable_page(self, seq_id: str, token_pos: int):
        """Ensure the page holding ``token_pos`` is privately owned before a
        KV write. Returns ``None`` if already exclusive, else ``(src, dst)``:
        the caller MUST copy device page ``src`` -> ``dst`` (copy-on-write);
        the block table is already updated to ``dst``.
        """
        idx = token_pos // self.page_size
        table = self._tables[seq_id]
        if idx >= len(table):
            return None            # page not allocated yet (nothing shared)
        src = table[idx]
        if self._ref.get(src, 0) <= 1:
            return None
        dst = self._take_page()
        table[idx] = dst
        self.table_version += 1
        self._ref[src] -= 1                            # still >0: others own it
        self.stats["cow_copies"] += 1
        return src, dst

    def ensure_slot(self, seq_id: str) -> None:
        """Make sure a page exists for the NEXT token position (call before
        the decode step writes at position ``len``)."""
        n = self._lens[seq_id] + 1
        if self.pages_needed(n) > len(self._tables[seq_id]):
            if not self.free_pages:
                raise OutOfPages(f"{seq_id}: pool exhausted on append")
            self._tables[seq_id].append(self._take_page())
            self.table_version += 1

    def advance(self, seq_id: str) -> None:
        self._lens[seq_id] += 1

    def advance_n(self, seq_id: str, n: int) -> None:
        """Advance a sequence's length by ``n`` tokens (multi-step decode
        sync: the device loop already wrote their KV)."""
        self._lens[seq_id] += n

    def rollback_to(self, seq_id: str, length: int) -> None:
        """Truncate-on-reject (speculative decoding): shrink a sequence's
        logical length back to ``length``. Pages stay allocated — positions
        past ``length`` are write headroom again and are rewritten before the
        length ever crosses them, so no device-side cleanup is needed. Bumps
        ``table_version`` so device-resident length vectors are re-uploaded.
        """
        cur = self._lens[seq_id]
        assert 0 <= length <= cur, \
            f"{seq_id}: rollback to {length} from {cur}"
        if length != cur:
            self._lens[seq_id] = length
            self.table_version += 1

    def ensure_capacity(self, seq_id: str, ahead: int) -> int:
        """Append pages until the block table covers ``ahead`` tokens past
        the current length (best effort: stops early when the pool runs
        dry rather than raising). Returns how many tokens of write headroom
        the table actually covers — the multi-step decode loop clamps its
        step count to the minimum across sequences."""
        cur = self._lens[seq_id]
        table = self._tables[seq_id]
        while len(table) * self.page_size < cur + ahead and self.free_pages:
            table.append(self._take_page())
            self.table_version += 1
        return min(ahead, len(table) * self.page_size - cur)

    def append_token(self, seq_id: str) -> None:
        """ensure_slot + advance (single-sequence convenience)."""
        self.ensure_slot(seq_id)
        self.advance(seq_id)

    def free(self, seq_id: str) -> None:
        for p in reversed(self._tables.pop(seq_id, [])):
            self._release_page(p)
        self._lens.pop(seq_id, None)
        self.table_version += 1

    def length(self, seq_id: str) -> int:
        return self._lens[seq_id]

    def pages_held(self, seq_id: str) -> int:
        """Block-table size (committed pages + decode headroom)."""
        return len(self._tables[seq_id])

    def ref_count(self, page: int) -> int:
        return self._ref.get(page, 0)

    @property
    def cached_free_pages(self) -> int:
        return len(self._lru)

    def hit_rate(self) -> float:
        tot = self.stats["hit_tokens"] + self.stats["miss_tokens"]
        return self.stats["hit_tokens"] / tot if tot else 0.0

    def snapshot(self) -> dict:
        """Canonical, comparable copy of the full allocator state (block
        tables, lengths, refcounts, free/LRU lists, prefix registrations,
        version). Two allocator replicas driven by the same op sequence
        must produce equal snapshots — the per-shard consistency contract
        of tensor-parallel serving."""
        return {
            "tables": {s: tuple(t) for s, t in self._tables.items()},
            "lens": dict(self._lens),
            "ref": dict(self._ref),
            "free": tuple(self._free),
            "lru": tuple(self._lru.keys()),
            "hash_of": dict(self._hash_of),
            "page_of": dict(self._page_of),
            "table_version": self.table_version,
        }

    # -- device-facing views ---------------------------------------------------
    def table_array(self, seq_ids: list[str], max_pages: int) -> np.ndarray:
        """(B, max_pages) int32, padded with page 0 (masked by lens)."""
        out = np.zeros((len(seq_ids), max_pages), np.int32)
        for i, sid in enumerate(seq_ids):
            t = self._tables.get(sid, [])
            out[i, :len(t)] = t
        return out

    def lens_array(self, seq_ids: list[str]) -> np.ndarray:
        return np.array([self._lens.get(s, 0) for s in seq_ids], np.int32)
