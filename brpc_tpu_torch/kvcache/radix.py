"""Radix/prefix tree mapping token prefixes to cached KV pages.

A copy of ``brpc_tpu/kvcache/radix.py`` (without its fault site).  Keyed at PAGE granularity: every edge is one page's
worth of tokens, so a node is one cached page and a longest-prefix
match returns whole shared pages.

Refcount contract with the :class:`~brpc_tpu_torch.kvcache.pages.PagePool`:
the tree holds ONE ref on every page it retains, so an evictable page
has ``refs == 1`` and eviction never frees a page a live or forked
sequence still references.  Eviction is LRU by leaf, ordered by a
logical clock bumped on every match, so seeded runs replay.  The tree
lock is the named ``kvcache.radix``.
"""
from __future__ import annotations

import itertools
from typing import Optional, Sequence

from ..butil.lockprof import InstrumentedLock


class _Node:
    __slots__ = ("chunk", "page", "children", "parent", "last_used")

    def __init__(self, chunk: tuple, page, parent: Optional["_Node"]):
        self.chunk = chunk
        self.page = page
        self.children: dict[tuple, _Node] = {}
        self.parent = parent
        self.last_used = 0


class RadixTree:
    """Prefix tree of cached KV pages (one page per node)."""

    def __init__(self, pagepool, *, name: str = "kv"):
        self.pagepool = pagepool
        self.page_tokens = pagepool.page_tokens
        self.name = name
        self._mu = InstrumentedLock("kvcache.radix")
        self._root = _Node((), None, None)
        self._clock = itertools.count(1)
        self._nodes = 0

    def _chunks(self, tokens: Sequence[int],
                max_chunks: Optional[int] = None):
        pt = self.page_tokens
        n = len(tokens) // pt
        if max_chunks is not None:
            n = min(n, max_chunks)
        return [tuple(int(t) for t in tokens[i * pt:(i + 1) * pt])
                for i in range(n)]

    def match(self, tokens: Sequence[int], *,
              max_chunks: Optional[int] = None) -> list:
        """Longest cached prefix of `tokens`, in whole pages (bumps LRU
        on the path; takes no refs)."""
        with self._mu:
            node = self._root
            pages = []
            now = next(self._clock)
            for chunk in self._chunks(tokens, max_chunks):
                child = node.children.get(chunk)
                if child is None:
                    break
                child.last_used = now
                pages.append(child.page)
                node = child
            return pages

    def insert(self, tokens: Sequence[int], pages: Sequence) -> int:
        """Cache `tokens`' full-page chunks backed by `pages` (one per
        chunk).  The tree refs each page it newly retains; chunks already
        cached keep their page.  Returns the pages newly retained."""
        chunks = self._chunks(tokens, max_chunks=len(pages))
        retained = 0
        with self._mu:
            node = self._root
            now = next(self._clock)
            for chunk, page in zip(chunks, pages):
                child = node.children.get(chunk)
                if child is None:
                    self.pagepool.ref(page)
                    child = _Node(chunk, page, node)
                    node.children[chunk] = child
                    self._nodes += 1
                    retained += 1
                child.last_used = now
                node = child
        return retained

    def evict(self, min_pages: int, span=None) -> int:
        """Free at least `min_pages` cached pages, LRU leaves first; only
        tree-only pages (refs == 1) are candidates.  Returns pages freed
        (fewer when the tree runs out of evictable leaves).  ``span``
        (the rpcz span of whoever forced the eviction) gets the freed
        page ids."""
        freed = 0
        while freed < min_pages:
            with self._mu:
                victims = []
                stack = [self._root]
                while stack:
                    n = stack.pop()
                    for c in n.children.values():
                        if c.children:
                            stack.append(c)
                        elif c.page.refs == 1:
                            victims.append(c)
                victims.sort(key=lambda v: v.last_used)
                victims = victims[: min_pages - freed]
                for v in victims:
                    del v.parent.children[v.chunk]
                self._nodes -= len(victims)
                pages = [v.page for v in victims]
            if not pages:
                break
            if span is not None and getattr(span, "trace_id", 0):
                pids = [p.pid for p in pages[:8]]
                span.annotate(
                    f"kv evict: freed {len(pages)} LRU cached pages "
                    f"(pids {pids}{'...' if len(pages) > 8 else ''})")
            # unref outside _mu: it may release whole blocks
            for page in pages:
                self.pagepool.unref(page)
            freed += len(pages)
        return freed

    def evict_all(self) -> int:
        return self.evict(1 << 30)

    def node_count(self) -> int:
        with self._mu:
            return self._nodes

    def evictable_pages(self) -> int:
        """Tree-only pages (``refs == 1``): all of them can be evicted,
        leaves first, since a live sequence that holds a page also
        holds every page above it."""
        with self._mu:
            n, stack = 0, [self._root]
            while stack:
                node = stack.pop()
                for c in node.children.values():
                    n += c.page.refs == 1
                    stack.append(c)
            return n

    def cached_tokens(self) -> int:
        with self._mu:
            return self._nodes * self.page_tokens
