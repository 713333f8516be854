"""Fixed-size, refcounted KV pages carved from leased device blocks.

Port of ``brpc_tpu/kvcache/pages.py``.  The :class:`PagePool` leases
whole blocks of one size class from the
:class:`~brpc_tpu_torch.ici.block_pool.BlockPool` and carves each into
``pages_per_block`` pages; every page carries a refcount (sequences
share pages copy-on-write, the radix tree holds one ref per cached
page), and a block whose pages are all free returns to the block pool.

Page layout, byte for byte the reference's: ``page_tokens`` slots of
``kv_bytes_per_token`` bytes, each slot one token's packed K/V,
``[n_layers, 2, n_kv_heads, head_dim]`` f32 little-endian.  A page read
out of either package (``read_raw``) writes into the other
(``write_raw``) unchanged.

ARENA.  A block is row ``slot`` of its class's persistent device tensor,
so a page's FLAT arena index is ``slot * pages_per_block + index`` --
stable for the block's whole lease -- and :meth:`arena` is a view of the
class tensor as ``[BLOCKS_PER_CLASS * pages_per_block, page_bytes]``:
the same memory on every call, never a restacked copy.  Pages sit at a
uniform stride of ``block_class / pages_per_block`` bytes, so
``pages_per_block`` is the largest power of two that fits (the
reference packs ``block_class // page_bytes``; the two agree whenever
that is a power of two, as for every configuration the repo runs).

WRITES are in place: ``index_put_`` / ``copy_`` into the class tensor
on the caller's current stream, each under the named lock
``kvcache.pool_io`` (the reference's ``_io_mu``), so writers on two
threads never interleave their launches.  The decode engine's thread
is the arena's one reader (admission, prefill, the step's attention
and its K/V write all run on it, in stream order), so no lock orders a
kernel's read against a write.  The page table's lock is the named
``kvcache.pool``.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from ..butil.lockprof import InstrumentedLock

from ..ici.block_pool import (BLOCK_CLASSES, BLOCKS_PER_CLASS,
                                           get_block_pool)
from ..device import resolve_device

_page_ids = itertools.count(1)


class KVPage:
    """One page: a (block, index) cell plus a refcount.  Identity is the
    stable integer ``pid``, which the engine's page tables carry."""

    __slots__ = ("pid", "block", "index", "refs")

    def __init__(self, block, index: int):
        self.pid = next(_page_ids)
        self.block = block
        self.index = index
        self.refs = 0

    def __repr__(self):
        return f"<KVPage {self.pid} blk={self.block.slot} " \
               f"idx={self.index} refs={self.refs}>"


class PagePool:
    """Carves block-pool blocks into refcounted KV pages.  ``max_blocks``
    bounds the blocks this pool holds at once: the pool's own pressure
    signal, raised before the shared block pool runs dry."""

    def __init__(self, pool=None, device=None, *, page_bytes: int = 1024,
                 page_tokens: int = 16, max_blocks: int = 8,
                 name: str = "kv"):
        if pool is None:
            pool = get_block_pool(device)
        elif device is not None and resolve_device(device) != pool.device:
            raise ValueError(f"pool lives on {pool.device}, not {device}")
        if page_bytes % page_tokens:
            raise ValueError("page_bytes must be a multiple of page_tokens")
        self.kv_bytes_per_token = page_bytes // page_tokens
        if self.kv_bytes_per_token % 4:
            raise ValueError("a token slot holds f32 values: "
                             "kv_bytes_per_token must be a multiple of 4")
        self.pool = pool
        self.device = pool.device
        self.page_bytes = int(page_bytes)
        self.page_tokens = int(page_tokens)
        self.block_class = next(
            (c for c in BLOCK_CLASSES if c >= page_bytes), None)
        if self.block_class is None:
            raise ValueError(f"page_bytes {page_bytes} exceeds the largest "
                             f"block class {BLOCK_CLASSES[-1]}")
        fit = self.block_class // self.page_bytes
        self.pages_per_block = 1 << (fit.bit_length() - 1)
        self.page_stride = self.block_class // self.pages_per_block
        self.max_blocks = int(max_blocks)
        self.name = name
        self._mu = InstrumentedLock("kvcache.pool")
        self._io_mu = InstrumentedLock("kvcache.pool_io")
        self._blocks: dict[int, tuple] = {}     # block slot -> (block, pages)
        self._free: list[KVPage] = []
        self._pid_flat: dict[int, int] = {}     # pid -> flat arena index
        self.page_allocs = 0
        self.page_frees = 0
        self.block_leases = 0
        self.block_releases = 0
        self.batch_splices = 0

    # ---- allocation / refcounting ----

    def alloc_page(self) -> KVPage:
        """A fresh exclusive page (refs=1).  Leases and carves a new block
        when the free list is dry; MemoryError at ``max_blocks``."""
        with self._mu:
            if not self._free:
                if len(self._blocks) >= self.max_blocks:
                    raise MemoryError(
                        f"KV page pool at max_blocks={self.max_blocks} "
                        f"({self.pages_per_block} pages/block)")
                block = self.pool.alloc(self.block_class)
                self.block_leases += 1
                pages = [KVPage(block, i)
                         for i in range(self.pages_per_block)]
                self._blocks[block.slot] = (block, pages)
                for p in pages:
                    self._pid_flat[p.pid] = \
                        block.slot * self.pages_per_block + p.index
                self._free.extend(reversed(pages))
            page = self._free.pop()
            page.refs = 1
            self.page_allocs += 1
            return page

    def ref(self, page: KVPage) -> None:
        with self._mu:
            if page.refs <= 0:
                raise RuntimeError(f"ref on dead page {page}")
            page.refs += 1

    def refs(self, page: KVPage) -> int:
        with self._mu:
            return page.refs

    def unref(self, page: KVPage) -> None:
        """Drop one reference; at zero the page joins the free list, and
        a block whose pages are all free returns to the block pool."""
        release = None
        with self._mu:
            if page.refs <= 0:
                raise RuntimeError(f"unref on dead page {page} "
                                   f"(double free?)")
            page.refs -= 1
            if page.refs:
                return
            self.page_frees += 1
            slot = page.block.slot
            entry = self._blocks.get(slot)
            if entry is None:
                raise RuntimeError(f"page {page} has no block entry")
            block, pages = entry
            if all(p.refs == 0 for p in pages):
                del self._blocks[slot]
                self._free = [p for p in self._free if p.block.slot != slot]
                for p in pages:
                    self._pid_flat.pop(p.pid, None)
                self.block_releases += 1
                release = block
            else:
                self._free.append(page)
        if release is not None:
            release.free()

    # ---- the arena ----

    def arena(self) -> torch.Tensor:
        """Every page of this pool's block class as ONE uint8 view
        ``[BLOCKS_PER_CLASS * pages_per_block, page_bytes]`` of the class's
        persistent device tensor (see the module docstring).  Rows of
        blocks this pool does not hold are never named by its tables."""
        buf = self.pool.class_buffer(self.block_class)
        return buf.view(BLOCKS_PER_CLASS * self.pages_per_block,
                        self.page_stride)[:, :self.page_bytes]

    def flat_ids(self, pids) -> list:
        """Page ids -> flat arena indices; -1 and dead pids map to -1."""
        with self._mu:
            return [self._pid_flat.get(int(p), -1) for p in pids]

    def _flat(self, page: KVPage) -> int:
        return page.block.slot * self.pages_per_block + page.index

    # ---- page I/O (in place; see the module docstring) ----

    def as_rows(self, rows) -> torch.Tensor:
        """``rows`` (a tensor or array: uint8 ``[n, kv_bytes_per_token]``,
        or any dtype whose bytes per leading row make one slot) as uint8
        ``[n, kv_bytes_per_token]`` on this pool's device."""
        t = rows if isinstance(rows, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(rows))
        if t.dtype != torch.uint8:
            t = t.contiguous().reshape(t.shape[0], -1).view(torch.uint8)
        if t.dim() != 2 or t.shape[1] != self.kv_bytes_per_token:
            raise ValueError(f"KV rows must be [n, {self.kv_bytes_per_token}]"
                             f" bytes, got {tuple(t.shape)} {t.dtype}")
        return t.to(self.device)

    def write(self, page: KVPage, slot: int, tokens) -> None:
        """Write token ids into consecutive slots of `page` from `slot`:
        each slot's first 4 bytes the id (int32 little-endian), the rest
        zero -- the reference's token-id stand-in payload, for tests and
        tools that need recognisable page contents without a model."""
        n = len(tokens)
        if slot < 0 or slot + n > self.page_tokens:
            raise ValueError(f"write [{slot},{slot + n}) exceeds "
                             f"page_tokens={self.page_tokens}")
        rows = np.zeros((n, self.kv_bytes_per_token), np.uint8)
        rows[:, :4] = np.asarray(tokens, "<i4").view(np.uint8).reshape(n, 4)
        self.write_slots_batch([(page, slot, rows)])

    def read(self, page: KVPage, count: int | None = None) -> np.ndarray:
        """The token ids in `page`'s first `count` slots (default all):
        the inverse of :meth:`write` (a host read; tests and tools)."""
        count = self.page_tokens if count is None else int(count)
        raw = self.read_raw(page)[:count * self.kv_bytes_per_token]
        return raw.reshape(count, self.kv_bytes_per_token)[:, :4] \
            .copy().view("<i4").ravel()

    def write_slots(self, page: KVPage, slot: int, rows) -> None:
        """Write per-token K/V payloads into consecutive slots of `page`
        starting at `slot`."""
        self.write_slots_batch([(page, slot, rows)])

    def write_slots_batch(self, runs) -> None:
        """Write many ``(page, slot, rows)`` runs as ONE indexed store
        into the arena (the decode step's one K/V write across every
        slot).  All runs are validated before any byte lands."""
        idx, payload = [], []
        for page, slot, rows in runs:
            rows = self.as_rows(rows)
            n = rows.shape[0]
            if slot < 0 or slot + n > self.page_tokens:
                raise ValueError(f"write_slots [{slot},{slot + n}) exceeds "
                                 f"page_tokens={self.page_tokens}")
            flat = self._flat(page)
            idx.extend((flat, slot + i) for i in range(n))
            payload.append(rows)
        if not idx:
            return
        ix = torch.tensor(idx, dtype=torch.int64).t().to(self.device)
        slots = self.arena().view(-1, self.page_tokens,
                                  self.kv_bytes_per_token)
        rows = torch.cat(payload)
        with self._io_mu:
            slots.index_put_((ix[0], ix[1]), rows)
            self.batch_splices += 1

    def page_slice(self, page: KVPage) -> torch.Tensor:
        """A device copy of the page's bytes (uint8[page_bytes]): the
        export payload, unaffected by later writes to the page."""
        return self.arena()[self._flat(page)].clone()

    def stack_pages(self, pages) -> torch.Tensor:
        """The pages' bytes as ONE device tensor ``[n, page_bytes]``:
        one gather from the arena (the migration export's page stack,
        copied to the host once for the whole migration)."""
        idx = torch.tensor([self._flat(p) for p in pages],
                           dtype=torch.int64).to(self.device)
        return self.arena().index_select(0, idx)

    def read_raw(self, page: KVPage) -> np.ndarray:
        """Host copy of the page's raw bytes."""
        return self.arena()[self._flat(page)].cpu().numpy()

    def as_pages(self, data) -> torch.Tensor:
        """``data`` (a tensor or array of ``n`` whole pages of raw
        bytes) as uint8 ``[n, page_bytes]`` on this pool's device, in
        one copy."""
        t = data
        if not isinstance(t, torch.Tensor):
            a = np.ascontiguousarray(data, np.uint8)
            # a wire payload is a read-only view: torch needs its own copy
            t = torch.from_numpy(a if a.flags.writeable else a.copy())
        if t.dtype != torch.uint8 or t.numel() % self.page_bytes:
            raise ValueError(f"raw pages are {tuple(t.shape)} x {t.dtype},"
                             f" page_bytes={self.page_bytes} uint8")
        return t.reshape(-1, self.page_bytes).to(self.device)

    def write_raw(self, page: KVPage, data) -> None:
        """Write a whole page of raw bytes into `page`, bit-exact."""
        t = data if isinstance(data, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(data, np.uint8))
        t = t.reshape(-1)
        if t.dtype != torch.uint8 or t.shape[0] != self.page_bytes:
            raise ValueError(f"raw page payload is {t.shape[0]} x {t.dtype},"
                             f" page_bytes={self.page_bytes} uint8")
        dst = self.arena()[self._flat(page)]
        with self._io_mu:
            dst.copy_(t)

    def copy_page(self, dst: KVPage, src: KVPage) -> None:
        """Device-to-device page copy: the copy half of copy-on-write."""
        arena = self.arena()
        d, s = arena[self._flat(dst)], arena[self._flat(src)]
        with self._io_mu:
            d.copy_(s)

    # ---- introspection / invariants ----

    def blocks_leased(self) -> int:
        with self._mu:
            return len(self._blocks)

    def pages_in_use(self) -> int:
        """Pages with at least one ref (the occupancy bvar)."""
        with self._mu:
            return sum(1 for _, pages in self._blocks.values()
                       for p in pages if p.refs > 0)

    def assert_consistent(self) -> None:
        """Free-listed pages have no refs, every page belongs to a live
        block, and every idle page of a live block is on the free list."""
        with self._mu:
            for p in self._free:
                if p.refs != 0 or p.block.slot not in self._blocks:
                    raise AssertionError(f"bad free-list page {p}")
            free_ids = {p.pid for p in self._free}
            for _, pages in self._blocks.values():
                for p in pages:
                    if p.refs < 0 or (p.refs == 0 and p.pid not in free_ids):
                        raise AssertionError(f"idle page off the free "
                                             f"list: {p}")

    def stats(self) -> dict:
        with self._mu:
            total = len(self._blocks) * self.pages_per_block
            in_use = sum(1 for _, pages in self._blocks.values()
                         for p in pages if p.refs > 0)
            return {
                "page_bytes": self.page_bytes,
                "page_tokens": self.page_tokens,
                "pages_per_block": self.pages_per_block,
                "blocks_leased": len(self._blocks),
                "max_blocks": self.max_blocks,
                "pages_total": total,
                "pages_in_use": in_use,
                "pages_free": total - in_use,
                "page_allocs": self.page_allocs,
                "page_frees": self.page_frees,
                "batch_splices": self.batch_splices,
                "block_leases": self.block_leases,
                "block_releases": self.block_releases,
            }
