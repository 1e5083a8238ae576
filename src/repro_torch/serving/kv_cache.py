"""Paged KV page-pool metadata: prefix trie + refcounted page allocator.

The paged KV layout is ONE global tensor of fixed-size pages per layer,
``(L, n_pages, page_size, Hkv, hd)``, plus per-slot page tables
``(L, B, max_pages)`` mapping logical page slots to physical pages
(-1 = unmapped) and per-slot write cursors.  The device tensors live in the
engine cache dict under the ``"paged"`` key; the *metadata* lives here, as
host code:

- :class:`PagePool` — refcounted page allocator: ``alloc`` / ``share`` /
  ``deref`` / copy-on-write ``cow``, page-budget reservations so lazily
  allocated decode pages can never fail mid-flight, and LRU eviction of
  prefix-cache pages nobody references under pressure;
- :class:`PrefixTrie` — a token-hash prefix trie at page granularity:
  admitted prompts are chunked into ``page_size``-token pieces and walked
  against the trie, so N requests sharing a course prompt map onto the
  SAME already-prefilled physical pages (prefill once, decode against
  shared pages until divergence).  Full pages of every admitted prompt are
  inserted back, each holding one trie refcount that keeps the page warm
  until evicted.

Refcount discipline: a page's count is (#slot tables referencing it) +
(1 if a trie node retains it).  ``refcount == 1`` with trie retention
means "cached but unreferenced" — the evictable set.  Because a slot that
shares a page also shares all its trie ancestors, non-evictable nodes are
closed under ancestry, so evicting LRU *leaves* always makes progress.

A copy of ``repro.serving.kv_cache`` (which holds no device code for this
layout), kept here so the port imports nothing of the JAX package.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class _TrieNode:
    __slots__ = ("chunk", "page", "parent", "children", "last_used",
                 "lru_prev", "lru_next", "in_lru")

    def __init__(self, chunk: Tuple[int, ...], page: int, parent):
        self.chunk = chunk
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_TrieNode"] = {}
        self.last_used = 0
        # intrusive LRU hooks: nodes that are BOTH leaves and unpinned
        # (refcount == 1, trie-only) sit on the trie's eviction list
        self.lru_prev: Optional["_TrieNode"] = None
        self.lru_next: Optional["_TrieNode"] = None
        self.in_lru = False


class PrefixTrie:
    """Token-hash prefix trie at page granularity.

    Each node maps one ``page_size``-token chunk (keyed by its token tuple —
    the dict hash is the "token hash", tuple equality guards collisions) to
    the physical page holding that chunk's prefilled KV.  ``match`` walks the
    longest chain of full-page chunks; ``insert`` extends the chain with
    newly prefilled pages.

    **O(1) eviction.**  Eviction candidates (leaf nodes whose page only the
    trie references) live on an intrusive doubly-linked list in LRU order,
    so ``evict_lru_leaf`` pops the head instead of scanning every leaf.
    The list is maintained on every event that changes candidacy or
    recency: ``match``/``insert`` touches re-stamp a node and move it to
    the MRU tail; :class:`PagePool` reports pin transitions
    (:meth:`note_pinned` when a slot shares an evictable page,
    :meth:`note_unpinned` when the last slot reference drops); eviction
    itself may expose the evicted node's parent as a new leaf, which enters
    the list with a FRESH stamp (a release counts as a use — the parent was
    in service at least as recently as the child).  Every stamp comes from
    one monotonic clock, one tick per touch, so timestamps are unique and
    the list order equals ascending ``last_used`` (``check_lru`` asserts
    it).
    """

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.root: Dict[Tuple[int, ...], _TrieNode] = {}
        self._clock = itertools.count(1)
        self.n_nodes = 0
        self._page_node: Dict[int, _TrieNode] = {}
        self._lru_head: Optional[_TrieNode] = None
        self._lru_tail: Optional[_TrieNode] = None

    # -- intrusive LRU list ---------------------------------------------------
    def _lru_unlink(self, node: _TrieNode) -> None:
        if not node.in_lru:
            return
        if node.lru_prev is not None:
            node.lru_prev.lru_next = node.lru_next
        else:
            self._lru_head = node.lru_next
        if node.lru_next is not None:
            node.lru_next.lru_prev = node.lru_prev
        else:
            self._lru_tail = node.lru_prev
        node.lru_prev = node.lru_next = None
        node.in_lru = False

    def _lru_append(self, node: _TrieNode) -> None:
        """Append at the MRU tail (caller has just stamped ``last_used``)."""
        assert not node.in_lru
        node.lru_prev = self._lru_tail
        node.lru_next = None
        if self._lru_tail is not None:
            self._lru_tail.lru_next = node
        else:
            self._lru_head = node
        self._lru_tail = node
        node.in_lru = True

    def _touch(self, node: _TrieNode) -> None:
        node.last_used = next(self._clock)
        if node.in_lru:
            self._lru_unlink(node)
            self._lru_append(node)

    def note_unpinned(self, page: int) -> None:
        """PagePool hook: ``page``'s last slot reference dropped (refcount
        back to trie-only) — its node becomes an eviction candidate if it is
        a leaf."""
        node = self._page_node.get(page)
        if node is not None and not node.children and not node.in_lru:
            node.last_used = next(self._clock)
            self._lru_append(node)

    def note_pinned(self, page: int) -> None:
        """PagePool hook: a slot took a reference on ``page`` — it leaves
        the eviction list (if on it) until unpinned again."""
        node = self._page_node.get(page)
        if node is not None:
            self._lru_unlink(node)

    # -- trie ops -------------------------------------------------------------
    def _chunks(self, tokens: Sequence[int]) -> List[Tuple[int, ...]]:
        P = self.page_size
        return [tuple(tokens[i:i + P]) for i in range(0, len(tokens) // P * P, P)]

    def match(self, tokens: Sequence[int]) -> List[int]:
        """Physical pages of the longest fully-cached page-aligned prefix."""
        pages: List[int] = []
        level = self.root
        for chunk in self._chunks(tokens):
            node = level.get(chunk)
            if node is None:
                break
            self._touch(node)
            pages.append(node.page)
            level = node.children
        return pages

    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> List[int]:
        """Record ``pages`` as the chain for tokens' full-page chunks.
        Returns the pages NEWLY retained (the caller owes each one trie
        refcount); chunks already present are only LRU-touched."""
        chunks = self._chunks(tokens)
        assert len(pages) >= len(chunks)
        newly: List[int] = []
        level, parent = self.root, None
        for chunk, page in zip(chunks, pages):
            node = level.get(chunk)
            if node is None:
                node = _TrieNode(chunk, int(page), parent)
                level[chunk] = node
                self.n_nodes += 1
                self._page_node[node.page] = node
                newly.append(int(page))
                if parent is not None:
                    # the parent just gained a child: no longer a leaf
                    self._lru_unlink(parent)
            self._touch(node)
            level, parent = node.children, node
        return newly

    def _leaves(self):
        stack = list(self.root.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            else:
                yield node

    def evict_lru_leaf(self, evictable) -> Optional[int]:
        """Remove the least-recently-used leaf whose page satisfies
        ``evictable(page)`` (i.e. only the trie still references it).
        Returns the page, or None when nothing qualifies.

        O(1): pops the head of the intrusive candidate list (the predicate
        walk is a defensive no-op while the pin/unpin notifications hold
        the membership invariant)."""
        node = self._lru_head
        while node is not None and not evictable(node.page):
            node = node.lru_next
        if node is None:
            return None
        self._lru_unlink(node)
        siblings = node.parent.children if node.parent is not None else self.root
        del siblings[node.chunk]
        self.n_nodes -= 1
        del self._page_node[node.page]
        parent = node.parent
        if (parent is not None and not parent.children and not parent.in_lru
                and evictable(parent.page)):
            # eviction exposed a new leaf; it enters with a fresh stamp —
            # its chain was in service at least as recently as the child
            parent.last_used = next(self._clock)
            self._lru_append(parent)
        return node.page

    def check_lru(self, evictable) -> None:
        """Invariants: list membership == {evictable leaves}, order ==
        ascending ``last_used``."""
        listed = []
        node = self._lru_head
        while node is not None:
            listed.append(node)
            assert not node.children, "non-leaf on the eviction list"
            assert node.in_lru
            node = node.lru_next
        stamps = [n.last_used for n in listed]
        assert stamps == sorted(stamps) and len(set(stamps)) == len(stamps)
        expect = {leaf.page for leaf in self._leaves() if evictable(leaf.page)}
        assert {n.page for n in listed} == expect


class PagePool:
    """Refcounted allocator over ``n_pages`` physical KV pages.

    A page's refcount = #slot page-table references + (1 if a
    :class:`PrefixTrie` node retains it).  The pool guarantees that a slot
    admitted under :meth:`try_admit` can lazily :meth:`alloc_reserved` its
    remaining pages at any later decode step without failure: admission
    reserves budget against ``n_pages`` minus pinned (non-evictable, in-use)
    pages, and allocation falls back to evicting LRU unreferenced prefix
    pages from the trie when the free list runs dry.
    """

    def __init__(self, n_pages: int, page_size: int,
                 trie: Optional[PrefixTrie] = None, sentinel: bool = False):
        assert n_pages > (1 if sentinel else 0) and page_size > 0
        self.n_pages = n_pages
        self.page_size = page_size
        self.trie = trie
        self.refcount = np.zeros(n_pages, np.int32)
        self.in_trie = np.zeros(n_pages, bool)
        self.free: List[int] = list(range(n_pages - 1, -1, -1))
        # ``sentinel`` permanently pins page 0 as the trash page: idle decode
        # slots and clamped unmapped table entries read/write it, so it may
        # never be handed to a request (its refcount never reaches 0)
        if sentinel:
            self.free.remove(0)
            self.refcount[0] = 1
        self.reserved = 0
        # telemetry
        self.n_allocs = 0
        self.n_evictions = 0
        self.n_cow = 0
        self.n_shared = 0

    # -- accounting ----------------------------------------------------------
    def used(self) -> int:
        return self.n_pages - len(self.free)

    def evictable(self) -> int:
        """Pages only the trie references — reclaimable under pressure."""
        return int(((self.refcount == 1) & self.in_trie).sum())

    def headroom(self) -> int:
        """Pages available to new reservations: total minus hard-pinned
        (slot-referenced) pages minus already-promised reservations."""
        pinned = self.used() - self.evictable()
        return self.n_pages - pinned - self.reserved

    # -- admission -----------------------------------------------------------
    def try_admit(self, n_new: int, shared: Sequence[int] = ()) -> bool:
        """Reserve ``n_new`` future pages and take one slot reference on each
        page in ``shared`` (trie-matched prefix pages), atomically.

        Sharing a page that was evictable pins it, shrinking headroom by one
        — both costs are checked together so a granted admission can never
        strand a later ``alloc_reserved``.
        """
        shared = list(shared)
        pins = sum(1 for p in shared if self.refcount[p] == 1 and self.in_trie[p])
        if n_new + pins > self.headroom():
            return False
        for p in shared:
            assert self.refcount[p] > 0, "sharing a free page"
            if (self.refcount[p] == 1 and self.in_trie[p]
                    and self.trie is not None):
                self.trie.note_pinned(p)       # leaves the eviction list
            self.refcount[p] += 1
        self.n_shared += len(shared)
        self.reserved += n_new
        return True

    def cancel_reservation(self, n: int) -> None:
        assert 0 <= n <= self.reserved
        self.reserved -= n

    # -- page ops ------------------------------------------------------------
    def _take_free(self) -> int:
        if not self.free:
            assert self.trie is not None, "pool exhausted and no trie to evict"
            page = self.trie.evict_lru_leaf(
                lambda p: self.refcount[p] == 1 and self.in_trie[p])
            assert page is not None, "pool exhausted (reservation bug)"
            self.n_evictions += 1
            self.in_trie[page] = False
            self._deref(page)
            assert self.free, "eviction failed to free a page"
        page = self.free.pop()
        assert self.refcount[page] == 0
        self.refcount[page] = 1
        self.n_allocs += 1
        return page

    def alloc_reserved(self) -> int:
        """Allocate one page against an outstanding reservation (never fails
        while the admission-time invariant holds)."""
        assert self.reserved > 0, "alloc without reservation"
        self.reserved -= 1
        return self._take_free()

    def cow(self) -> int:
        """Copy-on-write target: a fresh page (against reservation) whose
        contents the caller copies from the shared source page on device
        before the first write."""
        self.n_cow += 1
        return self.alloc_reserved()

    def retain_in_trie(self, page: int) -> None:
        """Add the trie's retention reference (page stays warm after every
        slot drops it, until LRU-evicted)."""
        assert self.refcount[page] > 0 and not self.in_trie[page]
        self.refcount[page] += 1
        self.in_trie[page] = True

    def _deref(self, page: int) -> None:
        assert self.refcount[page] > 0, f"double free of page {page}"
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            assert not self.in_trie[page]
            self.free.append(page)
        elif (self.refcount[page] == 1 and self.in_trie[page]
                and self.trie is not None):
            self.trie.note_unpinned(page)      # joins the eviction list

    def release(self, pages: Sequence[int], unused_reservation: int = 0) -> None:
        """Drop one slot reference from each page (slot teardown) and return
        any reservation the slot never consumed."""
        for p in pages:
            self._deref(int(p))
        self.cancel_reservation(unused_reservation)

    def check(self) -> None:
        """Internal consistency."""
        assert len(self.free) == int((self.refcount == 0).sum())
        assert not self.in_trie[self.refcount == 0].any()
        assert self.reserved >= 0
        assert self.used() - self.evictable() + self.reserved <= self.n_pages
        if self.trie is not None:
            self.trie.check_lru(
                lambda p: self.refcount[p] == 1 and self.in_trie[p])
