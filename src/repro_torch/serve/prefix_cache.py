"""Radix-tree KV prefix cache over a refcounted paged KV pool
(DESIGN.md §9–§10).

Algorithm 2's block prompts are dominated by *repeated* content: the
instruction header and the left-table block are byte-identical across
every right-table block paired with the same left block
(``core.prompts.block_prompt_shared_prefix``), yet a cache-less engine
re-prefills each prompt from token zero.  This module interns token-ID
prefixes so the engine can skip the shared part:

* :class:`PagedKVPool` — a block-granular (``page_size`` tokens) pool of
  refcounted K/V pages, one pair of device arrays shaped
  ``(layers, n_pages, page_size, kv_heads, head_dim)``.  Since the
  paged-KV refactor (DESIGN.md §10) this is the **single** KV store of a
  paged engine: live decode state and cached prefixes are the same
  pages, shared by reference count.  A page with ``refs == 1`` has one
  exclusive writer; a page with ``refs > 1`` is read-only (copy-on-write
  via :meth:`copy_page`).  The dense (non-paged) engine still uses a
  private pool with copy-out/copy-in semantics (§9) — same class, the
  pages just never end up shared with decode rows.
* :class:`RadixPrefixCache` — a radix tree whose edges are page-aligned
  token-ID runs; each node holds a reference on the pages of its edge.
  ``match`` walks the longest cached prefix (whole pages only) and
  *locks* the deepest node touched (node-level ref count) so eviction
  cannot free pages between lookup and the moment the engine takes its
  own page references (paged) or finishes the gather (dense);
  ``insert`` interns newly *computed* pages by copy (dense), while
  ``insert_refs`` interns a prefilled row's own pages **by reference**
  — zero copies, the tree just bumps the pool refcounts (paged).
  Eviction is LRU over *unreferenced leaves* and releases the node's
  page references; pages survive as long as a live row still holds
  them.

The cache stores token IDs, not text: two prompts share cached work iff
their token sequences share page-aligned prefixes, which is exactly the
property the canonical block-prompt layout guarantees.

Ported from ``repro.serve.prefix_cache``: the host logic (refcounts, the
radix tree, LRU eviction) is unchanged; the pool's storage is a pair of
torch tensors on the engine's device, written in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models import layers


class PagedKVPool:
    """Fixed-capacity pool of refcounted KV pages.

    Shapes are bound lazily from the first prefilled cache the engine
    hands over (``bind``), so the pool needs no config introspection —
    it inherits layer count, head layout, and cache dtype from the real
    thing.

    Reference counting: :meth:`alloc` hands out pages with ``refs == 1``
    (one exclusive writer); :meth:`incref` shares a page read-only;
    :meth:`decref` releases one reference and returns the page to the
    free list when the count drains to zero.  :meth:`writable` is the
    single-writer check the engine's append path and the churn property
    test rely on; :meth:`copy_page` is the copy-on-write escape hatch
    for appending into a shared partial page.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 1 or page_size < 1:
            raise ValueError(f"need n_pages, page_size >= 1, got {n_pages}, {page_size}")
        self.n_pages = n_pages
        self.page_size = page_size
        self.k: Optional[torch.Tensor] = None  # (layers, n_pages, page, KV, hd)
        self.v: Optional[torch.Tensor] = None
        self.refs = np.zeros(n_pages, np.int32)
        self.peak_pages = 0  # high-water mark of allocated pages
        self._free: List[int] = list(range(n_pages))

    @property
    def bound(self) -> bool:
        return self.k is not None

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def allocated_pages(self) -> int:
        return self.n_pages - len(self._free)

    def bind(self, k_template: torch.Tensor, v_template: torch.Tensor) -> None:
        """Allocate storage matching a prefilled cache leaf
        ``(layers, batch, seq, KV, hd)``, on its device."""
        if self.bound:
            return
        layers, _, _, kv, hd = k_template.shape
        shape = (layers, self.n_pages, self.page_size, kv, hd)
        self.k = torch.zeros(shape, dtype=k_template.dtype,
                             device=k_template.device)
        self.v = torch.zeros(shape, dtype=v_template.dtype,
                             device=v_template.device)

    # ------------------------------------------------------------------
    # Reference counting
    # ------------------------------------------------------------------
    def alloc(self, n: int) -> Optional[List[int]]:
        """Take ``n`` pages off the free list (each with ``refs == 1``,
        i.e. one exclusive writer), or None if unavailable."""
        if n > len(self._free):
            return None
        taken, self._free = self._free[:n], self._free[n:]
        for p in taken:
            self.refs[p] = 1
        self.peak_pages = max(self.peak_pages, self.allocated_pages)
        return taken

    def incref(self, pages: Sequence[int]) -> None:
        """Add one (read-only) reference to each page."""
        for p in pages:
            if self.refs[p] <= 0:
                raise ValueError(f"incref of free page {p}")
            self.refs[p] += 1

    def decref(self, pages: Sequence[int]) -> None:
        """Drop one reference per page; pages reaching zero are freed."""
        for p in pages:
            if self.refs[p] <= 0:
                raise ValueError(f"decref of free page {p}")
            self.refs[p] -= 1
            if self.refs[p] == 0:
                self._free.append(p)

    def free(self, pages: Sequence[int]) -> None:
        """Alias of :meth:`decref` (legacy single-owner callers)."""
        self.decref(pages)

    def writable(self, page: int) -> bool:
        """True iff ``page`` has exactly one owner (safe to write)."""
        return self.refs[page] == 1

    def copy_page(self, src: int) -> Optional[int]:
        """Copy-on-write: clone ``src`` into a fresh exclusive page and
        release the caller's reference on ``src``.  Returns the new page
        id, or None if the pool is exhausted."""
        got = self.alloc(1)
        if got is None:
            return None
        dst = got[0]
        if self.bound:
            self.k[:, dst] = self.k[:, src]
            self.v[:, dst] = self.v[:, src]
        self.decref([src])
        return dst

    # ------------------------------------------------------------------
    # Page payload I/O
    # ------------------------------------------------------------------
    def write(self, page_ids: Sequence[int], k_pages: torch.Tensor,
              v_pages: torch.Tensor) -> None:
        """Copy ``(layers, n, page, KV, hd)`` blocks into ``page_ids``, in
        place (the JAX pool donates its buffer to a jitted scatter for
        the same effect)."""
        ids = torch.as_tensor(np.asarray(list(page_ids), np.int64),
                              device=self.k.device)
        self.k[:, ids] = layers.to_cache(k_pages, self.k.dtype)
        self.v[:, ids] = layers.to_cache(v_pages, self.v.dtype)

    def gather(self, page_ids: np.ndarray
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``page_ids`` (B, n) int32 → K/V ``(layers, B, n·page, KV, hd)``.

        Rows with fewer valid pages are padded with page 0; the caller
        masks them via ``prefix_len``.
        """
        ids = torch.as_tensor(np.asarray(page_ids, np.int64),
                              device=self.k.device)
        k = self.k[:, ids]  # (layers, B, n, page, KV, hd)
        v = self.v[:, ids]
        L, B, n, p, KV, hd = k.shape
        return (k.reshape(L, B, n * p, KV, hd), v.reshape(L, B, n * p, KV, hd))


@dataclasses.dataclass(eq=False)
class _Node:
    """One radix edge: a page-aligned token run and the pages backing it."""

    key: Tuple[int, ...]                      # edge label ((len % page) == 0)
    pages: List[int]                          # len(key) // page page ids
    parent: Optional["_Node"]
    children: Dict[Tuple[int, ...], "_Node"] = dataclasses.field(
        default_factory=dict)                 # keyed by the child's first page
    refs: int = 0                             # live match locks on this node
    tick: int = 0                             # LRU stamp


@dataclasses.dataclass
class PrefixMatch:
    """Result of a longest-prefix lookup.  ``release`` MUST be called once
    the pages have been consumed (gathered into a slot cache, or
    referenced into a paged row's page table)."""

    pages: List[int]
    length: int               # matched tokens (multiple of page_size)
    _locked: Optional[_Node]
    _cache: "RadixPrefixCache"

    def release(self) -> None:
        if self._locked is not None:
            self._locked.refs -= 1
            self._locked = None


@dataclasses.dataclass
class PrefixCacheStats:
    lookups: int = 0
    hit_tokens: int = 0        # tokens served from cache
    miss_tokens: int = 0       # looked-up tokens that had to be computed
    inserted_pages: int = 0
    evicted_pages: int = 0
    shared_pages: int = 0      # pages interned by reference (zero-copy)

    def summary(self) -> dict:
        total = self.hit_tokens + self.miss_tokens
        return {
            "lookups": self.lookups,
            "hit_tokens": self.hit_tokens,
            "miss_tokens": self.miss_tokens,
            "hit_rate": self.hit_tokens / total if total else 0.0,
            "inserted_pages": self.inserted_pages,
            "evicted_pages": self.evicted_pages,
            "shared_pages": self.shared_pages,
        }


class RadixPrefixCache:
    """Block-granular radix tree of cached prompt prefixes.

    All tree state lives on the host; only page payloads live on device
    (in the :class:`PagedKVPool`).  Two interning modes share the tree:

    * **copy mode** (:meth:`insert`, dense engine §9) — the tree owns a
      private pool; new pages are allocated and written with copies of
      slot-cache slices.  Locking protocol: ``match`` bumps the ref
      count of the deepest node it used; the engine releases after the
      chunked prefill has *copied* those pages into the slot cache.
    * **zero-copy mode** (:meth:`insert_refs`, paged engine §10) — the
      pool is *shared* with live decode state; interning merely
      increfs the prefilled row's own pages.  On a hit the engine
      increfs the matched pages into the new row's page table while the
      match lock is held — no page payload ever moves.
    """

    def __init__(self, n_pages: int, page_size: int = 16,
                 pool: Optional[PagedKVPool] = None):
        self.page_size = page_size
        self.pool = pool if pool is not None else PagedKVPool(n_pages, page_size)
        if self.pool.page_size != page_size:
            raise ValueError(
                f"pool page_size {self.pool.page_size} != tree page_size {page_size}")
        self.root = _Node(key=(), pages=[], parent=None)
        self.stats = PrefixCacheStats()
        self._tick = 0

    # ------------------------------------------------------------------
    def _next_tick(self) -> int:
        self._tick += 1
        return self._tick

    def _aligned(self, n: int) -> int:
        return (n // self.page_size) * self.page_size

    def _common_pages(self, a: Sequence[int], b: Sequence[int]) -> int:
        """Length (in tokens, page-aligned) of the common prefix of two
        page-aligned runs."""
        p = self.page_size
        n = min(len(a), len(b))
        match = 0
        for lo in range(0, self._aligned(n), p):
            if tuple(a[lo:lo + p]) != tuple(b[lo:lo + p]):
                break
            match = lo + p
        return match

    # ------------------------------------------------------------------
    def match(self, ids: Sequence[int], limit: Optional[int] = None) -> PrefixMatch:
        """Longest cached page-aligned prefix of ``ids[:limit]``.

        Returns a locked :class:`PrefixMatch`; the lock pins the deepest
        node (and, transitively, every ancestor — interior nodes are never
        leaves while they have descendants) against eviction until
        :meth:`PrefixMatch.release`.
        """
        n = self._aligned(len(ids) if limit is None else min(len(ids), limit))
        self.stats.lookups += 1
        tick = self._next_tick()
        node, matched, pages = self.root, 0, []
        while matched < n:
            first = tuple(ids[matched:matched + self.page_size])
            child = node.children.get(first)
            if child is None:
                break
            want = ids[matched:matched + min(len(child.key), n - matched)]
            common = self._common_pages(child.key, want)
            if common == 0:
                break
            child.tick = tick
            pages += child.pages[: common // self.page_size]
            matched += common
            node = child
            if common < len(child.key):
                break  # stopped mid-edge: the edge's node still owns the pages
        locked = None
        if node is not self.root:
            node.refs += 1
            locked = node
        self.stats.hit_tokens += matched
        self.stats.miss_tokens += max(n - matched, 0)
        return PrefixMatch(pages=pages, length=matched, _locked=locked,
                           _cache=self)

    # ------------------------------------------------------------------
    def insert(self, ids: Sequence[int], k_source, v_source) -> int:
        """Intern every full page of ``ids`` by copy; returns pages newly
        cached.

        ``k_source(start, stop)`` / ``v_source(start, stop)`` return the
        ``(layers, stop-start, KV, hd)`` cache block for token positions
        ``[start, stop)`` — the dense engine passes slot-cache slices, so
        the pool stores *copies* and never aliases live decode state.
        """
        return self._insert_impl(ids, sources=(k_source, v_source), pages=None)

    def insert_refs(self, ids: Sequence[int], page_ids: Sequence[int]) -> int:
        """Intern every full page of ``ids`` **by reference** (zero-copy).

        ``page_ids`` are the prefilled row's own pool pages, one per full
        page of ``ids`` — already holding the K/V payload.  Tree segments
        not yet present simply incref the corresponding row pages;
        segments already interned are left as-is (the row keeps its own
        pages, the tree keeps its earlier ones — refcounts make both
        safe).  Returns the number of pages newly shared into the tree.
        """
        if len(page_ids) < self._aligned(len(ids)) // self.page_size:
            raise ValueError("insert_refs needs one page id per full page")
        return self._insert_impl(ids, sources=None, pages=list(page_ids))

    def _insert_impl(self, ids: Sequence[int], sources, pages) -> int:
        n = self._aligned(len(ids))
        node, matched = self.root, 0
        tick = self._next_tick()
        while matched < n:
            first = tuple(ids[matched:matched + self.page_size])
            child = node.children.get(first)
            if child is None:
                return self._attach(node, ids, matched, n, sources, pages)
            want = ids[matched:matched + min(len(child.key), n - matched)]
            common = self._common_pages(child.key, want)
            child.tick = tick
            if common < len(child.key):
                if matched + common >= n:
                    return 0  # fully covered by the edge's own prefix
                # diverged (or ran out) mid-edge: split at the common page
                child = self._split(node, child, common)
                matched += common
                node = child
                return self._attach(node, ids, matched, n, sources, pages)
            matched += common
            node = child
        return 0  # already fully interned

    def _split(self, parent: _Node, child: _Node, at: int) -> _Node:
        """Split ``child``'s edge after ``at`` tokens; returns the new
        interior node owning the first ``at`` tokens."""
        p = self.page_size
        head = _Node(key=tuple(child.key[:at]), pages=child.pages[: at // p],
                     parent=parent, tick=child.tick)
        child.key = tuple(child.key[at:])
        child.pages = child.pages[at // p:]
        child.parent = head
        head.children[tuple(child.key[:p])] = child
        parent.children[tuple(head.key[:p])] = head
        return head

    def _attach(self, node: _Node, ids: Sequence[int], start: int, stop: int,
                sources, pages) -> int:
        n_pages = (stop - start) // self.page_size
        if n_pages <= 0:
            return 0
        if pages is not None:
            # zero-copy: share the row's own pages into the tree
            new_pages = pages[start // self.page_size : stop // self.page_size]
            self.pool.incref(new_pages)
            self.stats.shared_pages += n_pages
        else:
            k_source, v_source = sources
            new_pages = self._alloc_evicting(n_pages)
            if new_pages is None:
                return 0  # pool exhausted by locked/live prefixes — skip caching
            self.pool.write(new_pages,
                            self._paged(k_source(start, stop), n_pages),
                            self._paged(v_source(start, stop), n_pages))
        leaf = _Node(key=tuple(ids[start:stop]), pages=new_pages, parent=node,
                     tick=self._next_tick())
        node.children[tuple(leaf.key[: self.page_size])] = leaf
        self.stats.inserted_pages += n_pages
        return n_pages

    def _paged(self, block: torch.Tensor, n_pages: int) -> torch.Tensor:
        """(layers, n·page, KV, hd) → (layers, n, page, KV, hd)."""
        L, _, KV, hd = block.shape
        return block.reshape(L, n_pages, self.page_size, KV, hd)

    # ------------------------------------------------------------------
    def _alloc_evicting(self, n: int) -> Optional[List[int]]:
        while self.pool.free_pages < n:
            if not self._evict_one():
                return None
        return self.pool.alloc(n)

    def _evict_one(self) -> bool:
        """Drop the least-recently-used unreferenced leaf; False if none.

        The node's page references are released — in zero-copy mode a
        page still held by a live decode row survives in the pool (only
        the tree's share is reclaimed), which is exactly what makes
        aliasing safe.
        """
        victim: Optional[_Node] = None
        stack = [self.root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if (node is not self.root and not node.children and node.refs == 0
                    and (victim is None or node.tick < victim.tick)):
                victim = node
        if victim is None:
            return False
        self.pool.decref(victim.pages)
        self.stats.evicted_pages += len(victim.pages)
        assert victim.parent is not None
        del victim.parent.children[tuple(victim.key[: self.page_size])]
        return True

    # ------------------------------------------------------------------
    def cached_tokens(self) -> int:
        """Total tokens currently interned (for tests / introspection)."""
        total, stack = 0, [self.root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            total += len(node.key)
        return total

    def tree_pages(self) -> List[int]:
        """All page ids currently referenced by the tree (introspection)."""
        out, stack = [], [self.root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            out.extend(node.pages)
        return out
