"""KVCacheStore: the engine-facing paged KV cache.

Port of ``brpc_tpu/kvcache/store.py`` in its vector-KV mode, the mode a
real model runs: pages hold the packed K/V vectors the runner writes
through :meth:`KVCacheStore.write_kv`.  The lifecycle the engine drives:

  admit(prompt)  -> a KVSeq whose longest cached prefix is served by
                    SHARED pages; only the suffix is prefilled;
  extend(seq, t) -> one generated token appended (a new page at page
                    boundaries, copy-on-write of a shared tail page);
  write_kv(...)  -> K/V rows written into the seq's pages, copying a
                    shared target page first; ``final=True`` advances
                    the materialisation cursor ``kv_filled``;
  fork(seq)      -> a second sequence sharing every page;
  speculate(seq, draft) / rollback(seq, keep) / commit_draft(seq, upto)
                 -> draft leases for speculative decoding: a draft is
                    appended without advancing ``kv_filled``, a rejected
                    tail returns its pages, an accepted prefix commits
                    (vector KV: by ``write_kv_batch`` of its real rows);
  retire(seq)    -> full, materialised page chunks are offered to the
                    radix tree, every seq ref drops;
  detach(seq)    -> crash recovery: retire a live sequence committing its
                    full pages to the tree, and pin them (a RecoveryPin)
                    until the request is re-admitted;
  import_prefix(tokens, payloads) / acquire_pages(tokens)
                 -> the KV migration plane's two ends: a peer's raw
                    pages spliced as committed radix nodes (all or
                    nothing), and a committed prefix's full pages pinned
                    for export.

Streaming commit (``commit_live_pages=True``): every page a live
sequence fills with real K/V (``kv_filled`` passes its end) joins the
radix tree at once instead of at retire, so a standby's page shipper can
export a generation's finished pages while it still decodes.

K/V rows arrive as tensors on the store's device and stay there: the
reference ships host numpy rows, this store writes device rows in place.
When the page pool is exhausted the store evicts LRU radix leaves and
retries, so pressure degrades the hit rate, never correctness.

Telemetry: the counters are ``kvcache_<name>_*`` bvars (an attribute
such as ``store.hit_tokens`` reads its value), the store lock is the
named ``kvcache.store`` (an RLock inside), and a sequence's owning
rpcz span (``admit(..., span=)``, the engine's decode span) gets the
KV events: prefix hit or miss, copy-on-write, page-alloc retries under
pressure and the evictions they forced, detach.
"""
from __future__ import annotations

import itertools
import re
import threading
from typing import Sequence

from .. import fault, rpcz
from ..butil.lockprof import InstrumentedLock
from ..bvar import Adder, PassiveStatus, exposed_variables, find_exposed
from .pages import KVPage, PagePool
from .radix import RadixTree

_seq_ids = itertools.count(1)


class _Count:
    """A counter attribute backed by a bvar ``Adder`` in ``_<name>``:
    reading it gives the Adder's value."""

    def __set_name__(self, owner, name):
        self.attr = "_" + name

    def __get__(self, obj, cls=None):
        return self if obj is None else getattr(obj, self.attr).get_value()


class MissingShippedPrefix(ValueError):
    """An incremental migration import (``import_prefix(have > 0)``)
    found the peer's already-shipped prefix chunks evicted: the peer
    must fall back to a full send."""


class RecoveryPin:
    """The refs :meth:`KVCacheStore.detach` takes on a crashed
    sequence's committed prefix pages.  While held, pressure eviction
    cannot free that prefix; ``release()`` (idempotent) drops them once
    the request has been re-admitted, whose admission takes its own
    refs on the pages it matches."""

    __slots__ = ("_store", "_pages", "tokens")

    def __init__(self, store, pages, tokens: int):
        self._store = store
        self._pages = list(pages)
        self.tokens = tokens          # committed prefix length pinned

    def release(self) -> None:
        pages, self._pages = self._pages, []
        if pages:
            self._store.release(pages)

    def __len__(self) -> int:
        return len(self._pages)


class KVSeq:
    """One sequence's view of the cache: its tokens and the page table
    covering them.  ``prefill_from`` is where compute must start;
    ``kv_filled`` is how many leading positions hold real K/V."""

    __slots__ = ("seq_id", "tokens", "pages", "prefill_from", "retired",
                 "kv_filled", "committed_full", "span")

    def __init__(self):
        self.seq_id = next(_seq_ids)
        self.tokens: list[int] = []
        self.pages: list[KVPage] = []
        self.prefill_from = 0
        self.retired = False
        self.kv_filled = 0
        # full pages already committed live (commit_live_pages): each
        # boundary commits only the new chunk
        self.committed_full = 0
        # the owning generation's rpcz span: KV events annotate it
        self.span = rpcz.NULL_SPAN

    @property
    def prefix_hit_tokens(self) -> int:
        return self.prefill_from

    def page_ids(self) -> list[int]:
        return [p.pid for p in self.pages]


class KVCacheStore:
    """Paged KV cache with radix prefix reuse (see the module
    docstring).  ``device`` defaults to ``cuda``."""

    hit_tokens = _Count()
    prompt_tokens = _Count()
    evictions = _Count()
    cow = _Count()
    admitted = _Count()
    retired = _Count()
    forks = _Count()
    speculated = _Count()        # draft tokens appended
    rolled_back = _Count()       # draft pages released
    detached = _Count()          # sequences handed over by detach()
    imported = _Count()          # migrated pages the tree retained

    def __init__(self, pool=None, device=None, *, page_bytes: int = 1024,
                 page_tokens: int = 16, max_blocks: int = 8,
                 commit_live_pages: bool = False, name: str = "kv"):
        self.pagepool = PagePool(pool, device, page_bytes=page_bytes,
                                 page_tokens=page_tokens,
                                 max_blocks=max_blocks, name=name)
        self.device = self.pagepool.device
        self.radix = RadixTree(self.pagepool, name=name)
        self.page_tokens = self.pagepool.page_tokens
        self.commit_live_pages = bool(commit_live_pages)
        self.name = name
        self._mu = InstrumentedLock("kvcache.store", threading.RLock())
        self._live = 0
        safe = re.sub(r"\W", "_", name)
        # the EXACT names exposed here, so close() hides only this
        # store's
        pre = set(exposed_variables(f"kvcache_{safe}*"))
        self._hit_tokens = Adder(f"kvcache_{safe}_hit_tokens")
        self._prompt_tokens = Adder(f"kvcache_{safe}_prompt_tokens")
        self._evictions = Adder(f"kvcache_{safe}_evictions")
        self._cow = Adder(f"kvcache_{safe}_cow_forks")
        self._admitted = Adder(f"kvcache_{safe}_admitted")
        self._retired = Adder(f"kvcache_{safe}_retired")
        self._forks = Adder(f"kvcache_{safe}_forks")
        self._speculated = Adder(f"kvcache_{safe}_speculated_tokens")
        self._rolled_back = Adder(f"kvcache_{safe}_rolled_back_pages")
        self._detached = Adder(f"kvcache_{safe}_detached")
        self._imported = Adder(f"kvcache_{safe}_imported_pages")
        PassiveStatus(self.hit_rate).expose(f"kvcache_{safe}_hit_rate")
        PassiveStatus(self.pagepool.pages_in_use).expose(
            f"kvcache_{safe}_pages_in_use")
        PassiveStatus(self.radix.node_count).expose(
            f"kvcache_{safe}_radix_nodes")
        self._bvar_names = [n for n in exposed_variables(f"kvcache_{safe}*")
                            if n not in pre]
        from . import _register_store
        _register_store(self)

    # ---- lifecycle ----

    def admit(self, prompt: Sequence[int], *, span=None) -> KVSeq:
        """Start a sequence for `prompt`: its longest cached prefix
        (capped at len(prompt)-1, so one position always computes) is
        shared, fresh pages cover the suffix.  ``span`` (an rpcz span)
        becomes the sequence's owning span."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        with self._mu:
            max_chunks = (len(prompt) - 1) // self.page_tokens
            shared = self.radix.match(prompt, max_chunks=max_chunks)
            seq = KVSeq()
            if span is not None:
                seq.span = span
            for p in shared:
                self.pagepool.ref(p)
                seq.pages.append(p)
            hit = len(shared) * self.page_tokens
            seq.tokens = prompt[:hit]
            seq.prefill_from = hit
            seq.kv_filled = hit
            if seq.span is not rpcz.NULL_SPAN:
                seq.span.annotate(
                    f"kv admit: prefix_hit={hit}/{len(prompt)} tokens "
                    f"({len(shared)} shared pages)" if hit else
                    f"kv admit: prefix miss ({len(prompt)} tokens "
                    f"uncached)")
            try:
                self._append_run(seq, prompt[hit:])
            except BaseException:
                # a failed admit must not leak the refs already taken
                for p in seq.pages:
                    self.pagepool.unref(p)
                raise
            self._hit_tokens.add(hit)
            self._prompt_tokens.add(len(prompt))
            self._admitted.add(1)
            self._live += 1
        return seq

    def extend(self, seq: KVSeq, token: int) -> None:
        """Append one generated token to `seq`."""
        with self._mu:
            if seq.retired:
                raise RuntimeError(f"extend on retired seq {seq.seq_id}")
            self._append_run(seq, [int(token)])

    def write_kv(self, seq: KVSeq, pos: int, rows, *,
                 final: bool = True) -> None:
        """Write K/V ``rows`` (``[n, kv_bytes_per_token]`` bytes, or f32
        rows of that size, on any device) into `seq`'s pages at
        positions ``[pos, pos + n)``, which must already be appended.  A
        shared target page is copied first.  ``final=False`` leaves
        ``kv_filled`` alone: a multi-pass writer (the runner's per-layer
        prefill) passes it until its last pass, so a half-written slot
        is never cached."""
        failures = self.write_kv_batch([(seq, pos, rows)], final=final)
        if failures:
            raise failures[0][1]

    def write_kv_batch(self, writes, *, final: bool = True) -> list:
        """Write many ``(seq, pos, rows)`` as ONE page-pool batch.  A
        write whose checks or copy-on-write fail is skipped and reported;
        the others still land.  Returns ``[(index, exception), ...]``."""
        staged = []
        failures: list = []
        with self._mu:
            for wi, (seq, pos, rows) in enumerate(writes):
                try:
                    rows = self.pagepool.as_rows(rows)
                    n = rows.shape[0]
                    if seq.retired:
                        raise RuntimeError(
                            f"write_kv on retired seq {seq.seq_id}")
                    if pos < 0 or pos + n > len(seq.tokens):
                        raise ValueError(
                            f"write_kv [{pos},{pos + n}) exceeds "
                            f"appended tokens ({len(seq.tokens)})")
                    runs = []
                    idx = 0
                    while idx < n:
                        p = pos + idx
                        pi = p // self.page_tokens
                        slot = p % self.page_tokens
                        page = seq.pages[pi]
                        if page.refs > 1:
                            page = self._copy_on_write(seq, pi, "KV write")
                        k = min(self.page_tokens - slot, n - idx)
                        runs.append((page, slot, rows[idx:idx + k]))
                        idx += k
                except Exception as e:
                    failures.append((wi, e))
                    continue
                staged.append((wi, seq, pos, n, runs))
            if not staged:
                return failures
            try:
                self.pagepool.write_slots_batch(
                    [r for *_, runs in staged for r in runs])
            except Exception as e:
                failures.extend((wi, e) for wi, *_ in staged)
                return failures
            if final:
                for _, seq, pos, n, _ in staged:
                    seq.kv_filled = max(seq.kv_filled, pos + n)
                    self._commit_live(seq)
        return failures

    def fork(self, seq: KVSeq) -> KVSeq:
        """A second sequence sharing every page of `seq`; the two diverge
        through copy-on-write."""
        with self._mu:
            if seq.retired:
                raise RuntimeError(f"fork on retired seq {seq.seq_id}")
            child = KVSeq()
            child.tokens = list(seq.tokens)
            child.prefill_from = len(seq.tokens)
            child.kv_filled = min(seq.kv_filled, len(seq.tokens))
            for p in seq.pages:
                self.pagepool.ref(p)
                child.pages.append(p)
            self._forks.add(1)
            self._live += 1
            return child

    # ---- draft leases (speculative decoding) ----

    def speculate(self, seq: KVSeq, tokens: Sequence[int]) -> None:
        """Append DRAFT tokens to `seq`: pages are allocated (a shared
        tail copied first) exactly as :meth:`extend` does, but
        ``kv_filled`` holds, so an unverified draft is never cached at
        :meth:`retire`.  Pair with :meth:`rollback` (reject) and
        ``write_kv_batch`` of the verified rows (accept)."""
        if not tokens:
            return
        with self._mu:
            if seq.retired:
                raise RuntimeError(f"speculate on retired seq {seq.seq_id}")
            self._append_run(seq, tokens)
            self._speculated.add(len(tokens))

    def rollback(self, seq: KVSeq, keep_tokens: int) -> int:
        """Reject a draft tail: truncate `seq` to its first
        `keep_tokens` tokens and release the pages past the boundary.
        Never cuts below ``kv_filled``: real K/V is not un-written by a
        rejected draft.  Returns the pages released."""
        keep = int(keep_tokens)
        with self._mu:
            if seq.retired:
                raise RuntimeError(f"rollback on retired seq {seq.seq_id}")
            if keep > len(seq.tokens):
                raise ValueError(
                    f"rollback to {keep} > {len(seq.tokens)} tokens")
            if keep < seq.kv_filled:
                raise ValueError(
                    f"rollback to {keep} would cut the materialised "
                    f"prefix (kv_filled={seq.kv_filled})")
            del seq.tokens[keep:]
            need = -(-keep // self.page_tokens)
            dropped, seq.pages = seq.pages[need:], seq.pages[:need]
            for p in dropped:
                self.pagepool.unref(p)
            self._rolled_back.add(len(dropped))
            return len(dropped)

    def commit_draft(self, seq: KVSeq, upto: int) -> None:
        """Advance ``kv_filled`` to `upto` tokens.  Only for slots whose
        real K/V is already in place: the engine commits verified rows
        through ``write_kv_batch`` (``final=True``) instead, since the
        draft append writes no bytes."""
        upto = int(upto)
        with self._mu:
            if seq.retired:
                raise RuntimeError(
                    f"commit_draft on retired seq {seq.seq_id}")
            if upto > len(seq.tokens):
                raise ValueError(
                    f"commit_draft to {upto} > {len(seq.tokens)} tokens")
            if upto > seq.kv_filled:
                seq.kv_filled = upto
                self._commit_live(seq)

    def retire(self, seq: KVSeq, *, cache: bool = True) -> None:
        """End a sequence.  With ``cache=True`` its full materialised
        page chunks go to the radix tree.  Idle blocks return to the
        block pool."""
        with self._mu:
            if seq.retired:
                return
            seq.retired = True
            if cache:
                nfull = self._cacheable_full(seq)
                if nfull:
                    self.radix.insert(seq.tokens[:nfull * self.page_tokens],
                                      seq.pages[:nfull])
            for p in seq.pages:
                self.pagepool.unref(p)
            seq.pages = []
            self._retired.add(1)
            self._live -= 1

    def detach(self, seq: KVSeq) -> RecoveryPin:
        """Crash recovery's hand-over: atomically commit a LIVE
        sequence's full, materialised pages to the radix tree, take a
        recovery ref on the pages the tree now holds, and retire the
        sequence.  The next ``admit`` of ``seq.tokens + ...`` hits the
        committed prefix (only the uncommitted tail re-decodes), and the
        pin keeps eviction off it until then.  One critical section:
        eviction cannot strike between the commit and the pin.  The pin
        counts pages, never the blocks that hold them."""
        with self._mu:
            if seq.retired:
                return RecoveryPin(self, [], 0)
            nfull = self._cacheable_full(seq)
            pinned: list = []
            if nfull:
                toks = seq.tokens[:nfull * self.page_tokens]
                self.radix.insert(toks, seq.pages[:nfull])
                # pin the pages the TREE holds (an already-cached chunk
                # keeps the tree's page, not this seq's copy): those are
                # the ones a re-admission matches
                pinned = self.radix.match(toks, max_chunks=nfull)
                for p in pinned:
                    self.pagepool.ref(p)
            seq.retired = True
            for p in seq.pages:
                self.pagepool.unref(p)
            seq.pages = []
            self._detached.add(1)
            self._retired.add(1)
            self._live -= 1
            if seq.span is not rpcz.NULL_SPAN:
                seq.span.annotate(
                    f"kv detach: {nfull} full pages committed to the "
                    f"radix tree, {len(pinned)} pinned for recovery "
                    f"({len(pinned) * self.page_tokens} tokens)")
            return RecoveryPin(self, pinned, len(pinned) * self.page_tokens)

    def import_prefix(self, tokens: Sequence[int], payloads, *,
                      have: int = 0, span=None) -> int:
        """The migration splice: install `payloads` -- one raw page of
        K/V bytes per full-page chunk of `tokens` past the first `have`
        (``[n, page_bytes]`` uint8: an array, a tensor or a list of
        rows), exported by a peer store -- as COMMITTED radix nodes, so
        the next ``admit`` of a prompt opening with `tokens` prefix-hits
        state this store never computed.  ``have`` is the incremental
        offset: the peer believes the first `have` chunks are already
        here; if eviction dropped any, :class:`MissingShippedPrefix`.

        All or nothing: pages are allocated and spliced first, then the
        whole chain is inserted under the store lock (the `have` check
        atomic with the insert); any failure (pressure with a dry tree,
        a bad payload, ``fault.MIGRATE_SPLICE``) returns every fresh page
        to the pool.  Chunks the tree already holds keep their pages.
        Returns the pages the tree newly retained."""
        tokens = [int(t) for t in tokens]
        nfull = len(tokens) // self.page_tokens
        have = int(have)
        n = len(payloads)
        if have < 0 or have >= nfull or nfull == 0 or n != nfull - have:
            raise ValueError(
                f"import_prefix: {n} payload pages for chunks "
                f"{have}..{nfull} ({len(tokens)} tokens at "
                f"{self.page_tokens}/page)")
        # one host-to-device copy for the whole migration; each page is
        # then a device-to-device copy
        payloads = self.pagepool.as_pages(payloads)
        fresh: list = []
        try:
            for i in range(n):
                if fault.ENABLED and fault.hit(
                        fault.MIGRATE_SPLICE, store=self.name,
                        page=have + i) is not None:
                    raise MemoryError("injected migration splice failure")
                page = self._alloc_page(span)
                fresh.append(page)
                self.pagepool.write_raw(page, payloads[i])
            with self._mu:
                pre: list = []
                if have:
                    # the peer skipped these as already shipped; between
                    # its last send and now eviction may have dropped them
                    pre = self.radix.match(tokens, max_chunks=have)
                    if len(pre) < have:
                        raise MissingShippedPrefix(
                            f"incremental import expected {have} resident "
                            f"chunks, found {len(pre)}")
                retained = self.radix.insert(
                    tokens[:nfull * self.page_tokens], list(pre) + fresh)
        except BaseException:
            # rollback: the tree never saw a partial chain
            for page in fresh:
                self.pagepool.unref(page)
            raise
        # drop the allocation refs: retained pages live on the tree's
        for page in fresh:
            self.pagepool.unref(page)
        self._imported.add(retained)
        if span is not None and span is not rpcz.NULL_SPAN:
            span.annotate(
                f"kv import: {retained}/{n} migrated pages spliced as "
                f"committed radix nodes (chunks {have}..{nfull}, "
                f"{nfull * self.page_tokens} tokens)")
        return retained

    # ---- internals (caller holds _mu) ----

    def _cacheable_full(self, seq: KVSeq) -> int:
        """Full pages eligible for the radix tree: bounded by the
        materialised prefix (the last generated token's slot holds no
        K/V until it is stepped)."""
        return min(len(seq.tokens), seq.kv_filled) // self.page_tokens

    def _commit_live(self, seq: KVSeq) -> None:
        """Streaming commit: every newly filled page joins the radix tree
        (the tree takes its own ref; the sequence keeps its), capped at
        the materialised prefix."""
        if not self.commit_live_pages:
            return
        nfull = self._cacheable_full(seq)
        if nfull > seq.committed_full:
            self.radix.insert(seq.tokens[:nfull * self.page_tokens],
                              seq.pages[:nfull])
            seq.committed_full = nfull

    def _copy_on_write(self, seq: KVSeq, pi: int, before: str) -> KVPage:
        """Replace seq's shared page ``pi`` by a private copy, ahead of
        a `before` into it ("write": an append's tail page; "KV write":
        a write_kv target)."""
        shared = seq.pages[pi]
        if seq.span is not rpcz.NULL_SPAN:
            tail = "tail " if before == "write" else ""
            seq.span.annotate(f"kv cow: {tail}page {shared.pid} shared "
                              f"(refs={shared.refs}), copied before "
                              f"{before}")
        fresh = self._alloc_page(seq.span)
        try:
            self.pagepool.copy_page(fresh, shared)
        except BaseException:
            self.pagepool.unref(fresh)
            raise
        seq.pages[pi] = fresh
        self.pagepool.unref(shared)
        self._cow.add(1)
        return fresh

    def _append_run(self, seq: KVSeq, tokens: Sequence[int]) -> None:
        """Append tokens page by page: a fresh page at each boundary, a
        copy of a shared tail before the first write into it.  The K/V
        bytes come later, from write_kv."""
        idx, n = 0, len(tokens)
        while idx < n:
            slot = len(seq.tokens) % self.page_tokens
            if slot == 0:
                seq.pages.append(self._alloc_page(seq.span))
            elif seq.pages[-1].refs > 1:
                self._copy_on_write(seq, len(seq.pages) - 1, "write")
            k = min(self.page_tokens - slot, n - idx)
            seq.tokens.extend(int(t) for t in tokens[idx:idx + k])
            idx += k

    def _alloc_page(self, span=None) -> KVPage:
        """Allocate a page, evicting one block's worth of LRU radix
        leaves and retrying while eviction frees anything.  ``span``
        (the allocating sequence's) gets one annotation per retry."""
        while True:
            try:
                return self.pagepool.alloc_page()
            except MemoryError:
                freed = self.radix.evict(self.pagepool.pages_per_block,
                                         span=span)
                self._evictions.add(freed)
                if span is not None and span is not rpcz.NULL_SPAN:
                    span.annotate(
                        f"kv page_alloc retry: pool exhausted, evicted "
                        f"{freed} LRU cached pages")
                if freed == 0:
                    raise

    # ---- probes / maintenance ----

    def probe(self, tokens: Sequence[int]) -> int:
        """Prefix-hit length in TOKENS that admitting `tokens` would get
        (advisory: nothing is pinned)."""
        tokens = [int(t) for t in tokens]
        if not tokens:
            return 0
        max_chunks = (len(tokens) - 1) // self.page_tokens
        return len(self.radix.match(tokens, max_chunks=max_chunks)) \
            * self.page_tokens

    def acquire_prefix(self, tokens: Sequence[int], *,
                       full_pages: bool = False) -> tuple:
        """Like :meth:`probe`, but refs every matched page so eviction
        cannot free it; ``full_pages=True`` lifts the one-token cap.
        Returns ``(hit_tokens, pages)``; hand `pages` to :meth:`release`."""
        tokens = [int(t) for t in tokens]
        if not tokens:
            return 0, []
        with self._mu:
            max_chunks = (len(tokens) if full_pages
                          else len(tokens) - 1) // self.page_tokens
            pages = self.radix.match(tokens, max_chunks=max_chunks)
            for p in pages:
                self.pagepool.ref(p)
            return len(pages) * self.page_tokens, list(pages)

    def acquire_pages(self, tokens: Sequence[int]) -> tuple:
        """``acquire_prefix(tokens, full_pages=True)``: the migration
        export's pin, covering a final exactly-full page too."""
        return self.acquire_prefix(tokens, full_pages=True)

    def release(self, pages) -> None:
        """Drop the refs taken by :meth:`acquire_prefix`."""
        with self._mu:
            for p in pages:
                self.pagepool.unref(p)

    def evict_pages(self, n: int) -> int:
        """Evict up to `n` LRU cached pages; returns pages freed."""
        with self._mu:
            freed = self.radix.evict(n)
            self._evictions.add(freed)
        return freed

    def clear(self) -> int:
        """Evict every cached (tree-only) page; once every sequence has
        retired this returns the block pool to its baseline."""
        with self._mu:
            freed = self.radix.evict_all()
            self._evictions.add(freed)
        return freed

    def close(self) -> None:
        """Drop the cache and hide this store's variables (their bound
        methods would keep it alive in the registry)."""
        self.clear()
        for n in self._bvar_names:
            v = find_exposed(n)
            if v is not None:
                v.hide()

    def hit_rate(self) -> float:
        seen = self.prompt_tokens
        return round(self.hit_tokens / seen, 4) if seen else 0.0

    def stats(self) -> dict:
        with self._mu:
            return {
                "page_tokens": self.page_tokens,
                "live_seqs": self._live,
                "hit_rate": self.hit_rate(),
                "hit_tokens": self.hit_tokens,
                "prompt_tokens": self.prompt_tokens,
                "admitted": self.admitted,
                "retired": self.retired,
                "detached": self.detached,
                "imported_pages": self.imported,
                "forks": self.forks,
                "speculated_tokens": self.speculated,
                "rolled_back_pages": self.rolled_back,
                "cow_forks": self.cow,
                "evictions": self.evictions,
                "radix_nodes": self.radix.node_count(),
                "cached_tokens": self.radix.cached_tokens(),
                "pages": self.pagepool.stats(),
            }
