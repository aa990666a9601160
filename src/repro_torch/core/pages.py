"""Paged KV plane: the block table as a first-class control word (copy of
``repro/core/pages.py``, which is pure numpy; the port imports nothing of
the reference, so it keeps its own copy).

The decode cache's full-attention KV no longer lives in contiguous per-slot
``max_len`` stripes but in a shared pool of fixed-size physical pages.  Each
slot owns a **block table** row — an int32 ``(max_pages,)`` vector of physical
page ids — and that row rides the same scalar-prefetch path as
``DecodePlan``/``TreePlan``: the flash-decode ``index_map`` composes the
existing per-token length clamp with one more prefetched lookup
(``page = table[b, pos // page_size]; row = page * page_size + pos %
page_size``).  This is the paper's Agile PE Assignment applied to memory:
binding logical cache positions to physical rows is a runtime control-plane
decision, not a static allocation.

Everything here is **host-side numpy** — the allocator state is a control
word, mutated between launches and shipped to the device as a replicated
int32 table.  Three pieces:

* :class:`PageTable` — the pool bookkeeping: block-table rows per slot,
  per-page refcounts, and a deterministic lowest-id-first free list (a heap),
  so identical admission sequences produce identical physical layouts —
  the property checkpoint/restore and the fabric's byte-identity oracle
  rest on.
* :class:`PrefixTrie` — cross-request prefix sharing at full-page
  granularity: a trie keyed on hashes of ``page_size``-token prompt chunks
  maps identical prefixes to shared refcounted pages.  Shared pages are
  read-only by construction (generation writes land at positions >= the
  prompt length, i.e. in privately allocated pages); copy-on-write
  (:meth:`PageTable.ensure_writable`) is the guarded escape hatch for any
  future divergent write.  When the pool is exhausted the allocator evicts
  trie-only pages (refcount 1, oldest inserted first).
* :func:`commit_maps` — the pointer-rewired tree commit: instead of a
  row-compaction launch, the accepted root path becomes a pair of
  ``(dst, src)`` absolute-position maps (``-1`` = no move) that the NEXT
  decode launch applies as a fused gather-then-scatter before its own
  writes.  Accepted nodes live within the boundary page (``T <= page_size``
  in every assigned config), so full-page pointer rewiring degenerates to
  row moves inside that page — and no separate commit launch ever runs.

All snapshot forms are JSON-pure (python ints/lists only) so they ride the
fabric's checkpoint ledger unchanged.
"""
from __future__ import annotations

import hashlib
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class PoolExhausted(RuntimeError):
    """The page pool has no free page and nothing could be evicted."""


def _chunk_key(chunk: np.ndarray) -> str:
    """Deterministic hash key for one page_size-token prompt chunk."""
    return hashlib.blake2b(
        np.asarray(chunk, np.int64).tobytes(), digest_size=8
    ).hexdigest()


class PageTable:
    """Block tables + refcounted page pool with deterministic allocation.

    ``table[b, i]`` is the physical page backing slot ``b``'s logical page
    ``i`` (covering absolute positions ``[i*page_size, (i+1)*page_size)``),
    or ``-1`` when unallocated.  One table serves every layer: physical page
    ``p`` maps to rows ``[p*page_size, (p+1)*page_size)`` of each layer's
    flat KV pool.

    Allocation is lowest-free-id-first (a heap), so a replayed admission
    sequence reproduces the exact physical layout — the determinism the
    fabric's crash → re-warm byte-identity oracle relies on.
    """

    def __init__(self, slots: int, max_pages: int, num_pages: int, page_size: int):
        self.slots = int(slots)
        self.max_pages = int(max_pages)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.table = np.full((slots, max_pages), -1, np.int32)
        self.refcounts = np.zeros((num_pages,), np.int32)
        self._free: List[int] = list(range(num_pages))
        heapq.heapify(self._free)

    # -- allocation ----------------------------------------------------
    def alloc(self, evict=None) -> int:
        """Pop the lowest free page id (refcount 1).  When the pool is dry,
        ``evict()`` (if given) is called repeatedly to free trie-held pages;
        raises :class:`PoolExhausted` once nothing more can be evicted."""
        while not self._free:
            if evict is None or not evict():
                raise PoolExhausted(
                    f"page pool exhausted ({self.num_pages} pages of "
                    f"{self.page_size} rows)"
                )
        page = heapq.heappop(self._free)
        self.refcounts[page] = 1
        return page

    def adopt(self, b: int, idx: int, page: int) -> None:
        """Point slot ``b``'s logical page ``idx`` at an existing (shared)
        physical page, taking a reference."""
        assert self.table[b, idx] < 0, "logical page already bound"
        self.table[b, idx] = page
        self.refcounts[page] += 1

    def ensure(self, b: int, upto_pos: int, evict=None) -> int:
        """Allocate pages so slot ``b`` covers positions ``[0, upto_pos)``;
        returns the number of pages newly allocated."""
        need = min(-(-int(upto_pos) // self.page_size), self.max_pages)
        fresh = 0
        for idx in range(need):
            if self.table[b, idx] < 0:
                self.table[b, idx] = self.alloc(evict)
                fresh += 1
        return fresh

    def incref(self, page: int) -> None:
        self.refcounts[page] += 1

    def decref(self, page: int) -> None:
        self.refcounts[page] -= 1
        assert self.refcounts[page] >= 0, "refcount underflow"
        if self.refcounts[page] == 0:
            heapq.heappush(self._free, int(page))

    def ensure_writable(self, b: int, idx: int, evict=None) -> Optional[int]:
        """Copy-on-write: if slot ``b``'s logical page ``idx`` is shared
        (refcount > 1), rebind it to a fresh page and return the old physical
        page id (the caller must copy its rows); returns ``None`` when the
        page was already private."""
        page = int(self.table[b, idx])
        assert page >= 0, "ensure_writable on an unallocated logical page"
        if self.refcounts[page] <= 1:
            return None
        fresh = self.alloc(evict)
        self.table[b, idx] = fresh
        self.decref(page)
        return page

    def free_slot(self, b: int) -> None:
        """Drop every reference slot ``b`` holds (request retirement)."""
        for idx in range(self.max_pages):
            page = int(self.table[b, idx])
            if page >= 0:
                self.decref(page)
        self.table[b, :] = -1

    # -- telemetry -----------------------------------------------------
    def allocated_pages(self) -> int:
        return self.num_pages - len(self._free)

    def occupancy(self) -> float:
        """Fraction of the physical pool in use."""
        return self.allocated_pages() / max(self.num_pages, 1)

    def fragmentation(self, lengths: Sequence[int]) -> float:
        """Internal fragmentation: the fraction of slot-allocated rows not
        yet holding data (``1 - used_rows / allocated_rows``, counted
        per-slot so shared pages weigh once per referencing slot)."""
        alloc_rows = int((self.table >= 0).sum()) * self.page_size
        used_rows = int(sum(min(int(l), self.max_pages * self.page_size)
                            for l in lengths))
        if alloc_rows == 0:
            return 0.0
        return 1.0 - used_rows / alloc_rows

    # -- persistence ---------------------------------------------------
    def snapshot(self) -> dict:
        return {
            "slots": self.slots,
            "max_pages": self.max_pages,
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "table": [[int(v) for v in row] for row in self.table],
            "refcounts": [int(v) for v in self.refcounts],
            "free": sorted(int(v) for v in self._free),
        }

    @classmethod
    def from_snapshot(cls, snap: dict) -> "PageTable":
        pt = cls(snap["slots"], snap["max_pages"], snap["num_pages"],
                 snap["page_size"])
        pt.table = np.asarray(snap["table"], np.int32).reshape(
            pt.slots, pt.max_pages
        )
        pt.refcounts = np.asarray(snap["refcounts"], np.int32)
        pt._free = list(snap["free"])
        heapq.heapify(pt._free)
        return pt


class _TrieNode:
    __slots__ = ("page", "children", "parent", "key", "order")

    def __init__(self, page: int, parent: Optional["_TrieNode"], key: str,
                 order: int):
        self.page = page
        self.children: Dict[str, _TrieNode] = {}
        self.parent = parent
        self.key = key
        self.order = order


class PrefixTrie:
    """Prompt-prefix → shared-page map at full-page granularity.

    Each trie node owns one physical page (the trie holds a reference) and is
    keyed by the hash of one ``page_size``-token prompt chunk; a path from the
    root spells a prompt prefix in whole pages.  ``probe`` walks the longest
    matching full-page prefix and hands the caller references to the matched
    pages; ``insert`` publishes a freshly admitted prompt's full pages for
    future requests.  ``evict_one`` reclaims the oldest trie-only leaf
    (refcount 1 — no live slot reads it) when the pool runs dry.
    """

    def __init__(self, page_size: int):
        self.page_size = int(page_size)
        self._root = _TrieNode(-1, None, "", -1)
        self._order = 0
        self.nodes = 0

    def _chunks(self, tokens: np.ndarray):
        toks = np.asarray(tokens)
        for i in range(len(toks) // self.page_size):
            yield toks[i * self.page_size : (i + 1) * self.page_size]

    def probe(self, tokens: np.ndarray, pager: PageTable) -> List[int]:
        """Longest full-page prefix match; increfs and returns the matched
        physical pages (the caller binds them into a block-table row)."""
        node, pages = self._root, []
        for chunk in self._chunks(tokens):
            child = node.children.get(_chunk_key(chunk))
            if child is None:
                break
            pager.incref(child.page)
            pages.append(child.page)
            node = child
        return pages

    def insert(self, tokens: np.ndarray, pages: Sequence[int],
               pager: PageTable) -> int:
        """Publish the full-page prefix of ``tokens`` (backed by ``pages``,
        one physical id per full page); the trie takes one reference per
        newly created node.  Returns the number of nodes created."""
        node, created = self._root, 0
        for i, chunk in enumerate(self._chunks(tokens)):
            if i >= len(pages):
                break
            key = _chunk_key(chunk)
            child = node.children.get(key)
            if child is None:
                child = _TrieNode(int(pages[i]), node, key, self._order)
                self._order += 1
                node.children[key] = child
                pager.incref(child.page)
                self.nodes += 1
                created += 1
            node = child
        return created

    def _leaves(self):
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                yield n

    def evict_one(self, pager: PageTable) -> bool:
        """Drop the oldest-inserted leaf whose page only the trie still
        references; returns False when nothing is evictable."""
        victim = None
        for leaf in self._leaves():
            if pager.refcounts[leaf.page] == 1 and (
                victim is None or leaf.order < victim.order
            ):
                victim = leaf
        if victim is None:
            return False
        del victim.parent.children[victim.key]
        pager.decref(victim.page)
        self.nodes -= 1
        return True

    # -- persistence ---------------------------------------------------
    def snapshot(self) -> dict:
        out = []

        def walk(node, path):
            for key, child in node.children.items():
                out.append({"path": path + [key], "page": int(child.page),
                            "order": int(child.order)})
                walk(child, path + [key])

        walk(self._root, [])
        return {"page_size": self.page_size, "nodes": out,
                "order": self._order}

    @classmethod
    def from_snapshot(cls, snap: dict) -> "PrefixTrie":
        trie = cls(snap["page_size"])
        for rec in sorted(snap["nodes"], key=lambda r: len(r["path"])):
            node = trie._root
            for key in rec["path"][:-1]:
                node = node.children[key]
            child = _TrieNode(rec["page"], node, rec["path"][-1], rec["order"])
            node.children[rec["path"][-1]] = child
            trie.nodes += 1
        trie._order = snap["order"]
        return trie


def commit_maps(
    lengths: np.ndarray,
    paths: np.ndarray,
    accepts: np.ndarray,
    width: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pointer-rewired tree commit as ``(dst, src)`` absolute-position maps.

    For slot ``b`` with pre-accept committed length ``L`` and accepted root
    path ``paths[b, :accepts[b]]`` (node indices into the draft tree), the
    accepted node at draft row ``L + paths[b, i]`` must become committed row
    ``L + i``.  Entries where the node already sits in place (``paths[b, i]
    == i``) — and every entry past ``accepts[b]`` — are ``-1`` (no move).
    The NEXT decode launch applies the maps as a fused gather-then-scatter
    before its own writes, so no separate commit launch exists on the paged
    path.  ``lengths`` must be the lengths BEFORE accepting this launch.
    """
    B = len(lengths)
    dst = np.full((B, width), -1, np.int32)
    src = np.full((B, width), -1, np.int32)
    for b in range(B):
        L = int(lengths[b])
        for i in range(int(accepts[b])):
            p = int(paths[b, i])
            if p != i:
                dst[b, i] = L + i
                src[b, i] = L + p
    return dst, src
