"""The port's block pool, page pool, radix tree and KV store.

Held against the JAX package where the two must agree byte for byte
(page bytes cross both ways between a ``brpc_tpu`` store's ``read_raw``
and a ``brpc_tpu_torch`` store's ``write_raw``), and against the store
contract of ``tests/test_paged_attention.py`` elsewhere: copy-on-write
isolation, radix evict and re-admit, the ``kv_filled`` caching cap,
stable arena rows.  Everything runs on ``device="cpu"``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu.models import runner as jax_runner
from brpc_tpu.ops.attention import local_attention as jax_local
from brpc_tpu_torch.ici.block_pool import (BLOCK_CLASSES, BLOCKS_PER_CLASS,
                                           BlockPool, get_block_pool)
from brpc_tpu_torch.kvcache import KVCacheStore, PagePool
from brpc_tpu_torch.models.runner import TransformerConfig, make_store_for
from brpc_tpu_torch.ops.paged_attention import arena_kv_view, paged_attention

CPU = "cpu"
CFG = TransformerConfig(n_layers=1, n_kv_heads=2, head_dim=8, n_heads=4)


@pytest.fixture
def store(request):
    s = make_store_for(CFG, page_tokens=4, max_blocks=8, device=CPU,
                       name=request.node.name)
    yield s
    s.clear()
    assert s.pagepool.blocks_leased() == 0, "pool not back at baseline"


def _rows_for(rng, cfg, n):
    """n random packed K/V slot payloads: (float view, uint8 rows)."""
    f = rng.standard_normal(
        (n, cfg.n_layers, 2, cfg.n_kv_heads, cfg.head_dim)
    ).astype(np.float32)
    return f, f.reshape(n, -1).view(np.uint8)


def _attend_seq(store, cfg, seq, q, length):
    """Port paged attention for one seq through the REAL arena (layer 0)."""
    kv = arena_kv_view(store.pagepool.arena(), store.page_tokens,
                       cfg.n_layers, cfg.n_kv_heads, cfg.head_dim)
    flat = store.pagepool.flat_ids(seq.page_ids())
    tables = np.full((1, 8), -1, np.int32)
    tables[0, :len(flat)] = flat
    out = paged_attention(torch.from_numpy(q[None]), kv[:, :, 0, 0],
                          kv[:, :, 0, 1], torch.from_numpy(tables),
                          torch.tensor([length], dtype=torch.int32))
    return out.numpy()[0]


def _dense_from(f_rows, q, length):
    """The JAX package's local attention over the first `length` rows."""
    o = jax_local(jnp.asarray(q[None, None]),
                  jnp.asarray(f_rows[None, :length, 0, 0]),
                  jnp.asarray(f_rows[None, :length, 0, 1]))
    return np.asarray(o)[0, 0]


# ---- page bytes: both packages, one layout ----------------------------------

@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_page_bytes_round_trip_between_packages(direction):
    """A page written by one package's store reads back (read_raw) and
    imports into the other's (write_raw) byte-identical, and both
    packages' arena views read the same floats from it."""
    cfg_j = jax_runner.TransformerConfig(n_layers=2)
    cfg_t = TransformerConfig(n_layers=2)
    rng = np.random.default_rng(19)
    f, rows = _rows_for(rng, cfg_t, 4)
    js = jax_runner.make_store_for(cfg_j, page_tokens=4, max_blocks=4,
                                   name=f"t_torch_rt_{direction}")
    ts = make_store_for(cfg_t, page_tokens=4, max_blocks=4, device=CPU,
                        name=f"t_torch_rt_{direction}")
    try:
        prompt = [3, 1, 4, 1]
        jseq, tseq = js.admit(prompt), ts.admit(prompt)
        if direction == "jax_to_port":
            js.write_kv(jseq, 0, rows)
            raw = js.pagepool.read_raw(jseq.pages[0])
            ts.pagepool.write_raw(tseq.pages[0], raw)
            back = ts.pagepool.read_raw(tseq.pages[0])
        else:
            ts.write_kv(tseq, 0, torch.from_numpy(f))
            raw = ts.pagepool.read_raw(tseq.pages[0])
            js.pagepool.write_raw(jseq.pages[0], raw)
            back = js.pagepool.read_raw(jseq.pages[0])
        np.testing.assert_array_equal(back, raw)
        np.testing.assert_array_equal(raw, rows.reshape(-1))
        flat = ts.pagepool.flat_ids([tseq.pages[0].pid])[0]
        view = arena_kv_view(ts.pagepool.arena(), 4, 2, cfg_t.n_kv_heads,
                             cfg_t.head_dim)
        np.testing.assert_array_equal(view[flat].numpy(), f)
        js.retire(jseq, cache=False)
        ts.retire(tseq, cache=False)
    finally:
        js.clear()
        js.close()
        ts.clear()


# ---- draft leases: both packages, one sequence of calls ---------------------

def test_draft_leases_match_reference_store():
    """speculate -> rollback -> commit on a reference store and a port
    store: the same tokens, page counts, released-page counts and
    kv_filled at every step, the same committed page bytes, and a
    rollback below kv_filled raises in both.  A draft is never cached:
    only materialised full pages reach the radix tree."""
    cfg_j = jax_runner.TransformerConfig(n_layers=1, n_kv_heads=2,
                                         head_dim=8, n_heads=4)
    rng = np.random.default_rng(41)
    f, rows = _rows_for(rng, CFG, 16)
    js = jax_runner.make_store_for(cfg_j, page_tokens=4, max_blocks=4,
                                   name="t_torch_draft_jax")
    ts = make_store_for(CFG, page_tokens=4, max_blocks=4, device=CPU,
                        name="t_torch_draft_port")

    def drive(store, seq, rows_of):
        seen = []

        def note(released=None):
            seen.append((list(seq.tokens), len(seq.pages), released,
                         seq.kv_filled))

        store.write_kv(seq, 0, rows_of(0, 6))
        store.speculate(seq, [2, 6, 5, 3, 5])        # 11 tokens, 3 pages
        note()
        note(store.rollback(seq, 8))                 # keep 2 drafts
        store.write_kv_batch([(seq, 6, rows_of(6, 8))])
        note()
        store.speculate(seq, [8, 9, 7, 9, 3])        # crosses a page
        note()
        note(store.rollback(seq, 10))
        store.write_kv_batch([(seq, 8, rows_of(8, 10))], final=False)
        note()
        store.commit_draft(seq, 10)
        note()
        with pytest.raises(ValueError):
            store.rollback(seq, 9)                   # below kv_filled
        with pytest.raises(ValueError):
            store.rollback(seq, 11)                  # past the tokens
        store.speculate(seq, [1, 1])                 # an unverified tail
        note()
        page_bytes = [np.asarray(store.pagepool.read_raw(p))
                      for p in seq.pages]
        st = store.stats()
        counters = (st["speculated_tokens"], st["rolled_back_pages"])
        store.retire(seq, cache=True)
        return seen, page_bytes, counters, store.probe(seq.tokens + [0])

    prompt = [3, 1, 4, 1, 5, 9]
    try:
        jres = drive(js, js.admit(prompt), lambda a, b: rows[a:b])
        tres = drive(ts, ts.admit(prompt),
                     lambda a, b: torch.from_numpy(f[a:b]))
        assert tres[0] == jres[0]
        assert tres[2] == jres[2] == (12, 2)
        # cached: the two full materialised pages, never the draft's
        assert tres[3] == jres[3] == 8
        # the committed slots 0..9, byte for byte
        kvb = CFG.kv_bytes_per_token
        tslots, jslots = (np.concatenate(r[1]).reshape(-1, kvb)[:10]
                          for r in (tres, jres))
        np.testing.assert_array_equal(tslots, jslots)
        np.testing.assert_array_equal(tslots, rows[:10])
    finally:
        js.clear()
        js.close()
        ts.clear()
    assert ts.pagepool.blocks_leased() == 0


# ---- crash recovery: detach and RecoveryPin --------------------------------

def test_detach_matches_reference_store():
    """The counterpart of test_kvcache.py's detach test, both packages
    through one sequence of calls: a LIVE sequence's full materialised
    pages land in the radix tree with a recovery pin; a re-admission
    hits them; eviction cannot free them while pinned; the released pin
    (idempotent) leaves them ordinarily evictable; detach of a retired
    sequence is an empty pin.  The same radix contents, pinned counts
    and hits in both, and the pin counts pages, never blocks."""
    cfg_j = jax_runner.TransformerConfig(n_layers=1, n_kv_heads=2,
                                         head_dim=8, n_heads=4)
    rng = np.random.default_rng(43)
    f, rows = _rows_for(rng, CFG, 12)
    js = jax_runner.make_store_for(cfg_j, page_tokens=4, max_blocks=4,
                                   name="t_torch_detach_jax")
    ts = make_store_for(CFG, page_tokens=4, max_blocks=4, device=CPU,
                        name="t_torch_detach_port")
    probes = [list(range(10)) + [99], list(range(4)) + [7, 7],
              list(range(8)), [5, 5, 5, 5, 5]]

    def drive(store, rows_of):
        seen = []
        seq = store.admit(list(range(10)))       # 2 full pages + a tail
        store.write_kv(seq, 0, rows_of(0, 10))
        pin = store.detach(seq)
        seen.append((seq.retired, seq.pages, len(pin), pin.tokens,
                     store.radix.node_count(),
                     [store.probe(p) for p in probes]))
        re = store.admit(list(range(10)) + [99])
        seen.append(re.prefix_hit_tokens)
        store.retire(re, cache=False)
        seen.append(store.evict_pages(1 << 20))  # pinned: nothing freed
        seen.append(store.radix.node_count())
        pin.release()
        pin.release()                            # idempotent
        seen.append(store.evict_pages(1 << 20))
        seen.append(store.pagepool.blocks_leased())
        seen.append(len(store.detach(re)))       # retired: empty pin
        seen.append(store.stats()["detached"])
        return seen

    try:
        jres = drive(js, lambda a, b: rows[a:b])
        tres = drive(ts, lambda a, b: torch.from_numpy(f[a:b]))
        assert tres == jres
        assert tres[0][:4] == (True, [], 2, 8)
        assert tres[1:8] == [8, 0, 2, 2, 0, 0, 1]
    finally:
        js.clear()
        js.close()
        ts.clear()
    assert ts.pagepool.blocks_leased() == 0


# ---- the arena --------------------------------------------------------------

def test_arena_is_one_persistent_view(store):
    """arena() returns the same memory every call, and a K/V write lands
    in place, visible through an arena taken before it."""
    rng = np.random.default_rng(2)
    seq = store.admit([1, 2, 3, 4, 5])
    before = store.pagepool.arena()
    f, _ = _rows_for(rng, CFG, 5)
    store.write_kv(seq, 0, torch.from_numpy(f))
    after = store.pagepool.arena()
    assert after.data_ptr() == before.data_ptr()
    assert after.shape == (BLOCKS_PER_CLASS * store.pagepool.pages_per_block,
                           store.pagepool.page_bytes)
    flat = store.pagepool.flat_ids(seq.page_ids())
    view = arena_kv_view(before, 4, 1, 2, 8)
    np.testing.assert_array_equal(view[flat[1], 0].numpy(), f[4])
    store.retire(seq, cache=False)


def test_arena_rows_stable_across_block_churn():
    """A page's flat index holds while it lives; a released block's row
    is recycled for the next lease."""
    pool = PagePool(page_bytes=8192, page_tokens=4, max_blocks=4,
                    device=CPU, name="t_torch_rows")
    assert pool.pages_per_block == 1
    a, b = pool.alloc_page(), pool.alloc_page()
    fa, fb = pool.flat_ids([a.pid])[0], pool.flat_ids([b.pid])[0]
    assert fa != fb
    pool.write_slots(a, 0, np.full((1, 2048), 7, np.uint8))
    assert pool.arena()[fa, 0] == 7
    pool.unref(b)
    assert pool.flat_ids([a.pid])[0] == fa
    assert pool.flat_ids([b.pid]) == [-1]
    c = pool.alloc_page()
    assert pool.flat_ids([c.pid])[0] == fb, "freed row not recycled"
    assert pool.arena()[fa, 0] == 7
    pool.unref(c)
    pool.unref(a)
    assert pool.blocks_leased() == 0
    pool.assert_consistent()


@pytest.mark.parametrize("page_bytes,ppb,stride", [
    (1024, 8, 1024), (1536, 4, 2048), (3072, 2, 4096), (8192, 1, 8192),
    (512 * 1024, 4, 512 * 1024)])
def test_pages_tile_blocks_at_a_uniform_stride(page_bytes, ppb, stride):
    pool = PagePool(page_bytes=page_bytes, page_tokens=4, max_blocks=2,
                    device=CPU, name="t_torch_ppb")
    assert (pool.pages_per_block, pool.page_stride) == (ppb, stride)
    pages = [pool.alloc_page() for _ in range(ppb + 1)]   # two blocks
    for i, p in enumerate(pages):
        pool.write_raw(p, np.full(page_bytes, i + 1, np.uint8))
    for i, p in enumerate(pages):
        assert (pool.read_raw(p) == i + 1).all()
    for p in pages:
        pool.unref(p)
    assert pool.blocks_leased() == 0


def test_page_pool_rejects_bad_geometry():
    with pytest.raises(ValueError):
        PagePool(page_bytes=24, page_tokens=4, device=CPU)   # 6-byte slots
    with pytest.raises(ValueError):
        PagePool(page_bytes=4 * BLOCK_CLASSES[-1], page_tokens=4,
                 device=CPU)


def test_write_slots_batch_one_store_many_pages():
    """Runs across several pages land in one batch; a bad run fails the
    batch before any byte lands."""
    pool = PagePool(page_bytes=64, page_tokens=4, max_blocks=1,
                    device=CPU, name="t_torch_batch")
    a, b = pool.alloc_page(), pool.alloc_page()
    ra = np.arange(32, dtype=np.uint8).reshape(2, 16)
    rb = np.full((3, 16), 9, np.uint8)
    pool.write_slots_batch([(a, 2, ra), (b, 0, torch.from_numpy(rb))])
    assert pool.batch_splices == 1
    np.testing.assert_array_equal(pool.read_raw(a)[32:], ra.reshape(-1))
    np.testing.assert_array_equal(pool.read_raw(b)[:48], rb.reshape(-1))
    snap = pool.read_raw(a).copy()
    with pytest.raises(ValueError):
        pool.write_slots_batch([(a, 0, np.zeros((1, 16), np.uint8)),
                                (b, 3, np.zeros((2, 16), np.uint8))])
    np.testing.assert_array_equal(pool.read_raw(a), snap)
    with pytest.raises(ValueError):
        pool.write_slots(a, 0, np.zeros((1, 12), np.uint8))
    pool.unref(a)
    pool.unref(b)


def test_page_slice_is_a_snapshot_and_copy_page_is_exact():
    pool = PagePool(page_bytes=64, page_tokens=4, max_blocks=1,
                    device=CPU, name="t_torch_slice")
    a, b = pool.alloc_page(), pool.alloc_page()
    pool.write_raw(a, np.arange(64, dtype=np.uint8))
    snap = pool.page_slice(a)
    pool.copy_page(b, a)
    pool.write_raw(a, np.zeros(64, np.uint8))
    np.testing.assert_array_equal(snap.numpy(), np.arange(64))
    np.testing.assert_array_equal(pool.read_raw(b), np.arange(64))
    pool.unref(a)
    pool.unref(b)


# ---- the store over real pages ----------------------------------------------

def test_cow_fork_isolates_and_matches_dense(store):
    """K/V written through write_kv reads back through the arena; a
    forked child's divergent tail page never perturbs the parent."""
    rng = np.random.default_rng(23)
    prompt = list(range(100, 110))                 # 2.5 pages
    seq = store.admit(prompt)
    f, rows = _rows_for(rng, CFG, len(prompt))
    store.write_kv(seq, 0, rows)
    q = rng.standard_normal((CFG.n_heads, CFG.head_dim)).astype(np.float32)
    np.testing.assert_allclose(_attend_seq(store, CFG, seq, q, 10),
                               _dense_from(f, q, 10), atol=1e-5)
    child = store.fork(seq)
    store.extend(child, 999)
    fc, rc = _rows_for(rng, CFG, 1)
    store.write_kv(child, 10, torch.from_numpy(rc))
    assert store.cow >= 1, "divergent tail write did not copy"
    assert child.pages[-1].pid != seq.pages[-1].pid
    np.testing.assert_allclose(_attend_seq(store, CFG, seq, q, 10),
                               _dense_from(f, q, 10), atol=1e-5)
    np.testing.assert_allclose(
        _attend_seq(store, CFG, child, q, 11),
        _dense_from(np.concatenate([f, fc]), q, 11), atol=1e-5)
    store.retire(child, cache=False)
    store.retire(seq, cache=False)


def test_radix_evict_readmit(store):
    """A retired prefix hits on re-admit and attends through the shared
    pages; after eviction the re-admit misses and rewrites fresh pages."""
    rng = np.random.default_rng(31)
    prompt = list(range(50, 58))                   # 2 full pages
    seq = store.admit(prompt)
    f, rows = _rows_for(rng, CFG, len(prompt))
    store.write_kv(seq, 0, rows)
    assert seq.kv_filled == 8
    store.retire(seq, cache=True)
    q = rng.standard_normal((CFG.n_heads, CFG.head_dim)).astype(np.float32)
    seq2 = store.admit(prompt + [1234])
    assert seq2.prefix_hit_tokens == 8
    store.write_kv(seq2, 8, _rows_for(rng, CFG, 1)[1])
    np.testing.assert_allclose(_attend_seq(store, CFG, seq2, q, 8),
                               _dense_from(f, q, 8), atol=1e-5)
    store.retire(seq2, cache=False)
    assert store.clear() > 0
    seq3 = store.admit(prompt + [1234])
    assert seq3.prefix_hit_tokens == 0
    f3, rows3 = _rows_for(rng, CFG, 9)
    store.write_kv(seq3, 0, rows3)
    np.testing.assert_allclose(_attend_seq(store, CFG, seq3, q, 9),
                               _dense_from(f3, q, 9), atol=1e-5)
    store.retire(seq3, cache=False)


def test_caching_capped_at_materialized_boundary(store):
    rng = np.random.default_rng(41)
    prompt = list(range(70, 78))
    seq = store.admit(prompt)
    store.write_kv(seq, 0, _rows_for(rng, CFG, 7)[1])   # one slot short
    assert seq.kv_filled == 7
    store.retire(seq, cache=True)
    assert store.probe(prompt + [1]) == 4


def test_write_kv_final_false_defers_materialization(store):
    prompt = list(range(10, 18))
    seq = store.admit(prompt)
    rows = torch.ones((8, CFG.kv_bytes_per_token), dtype=torch.uint8)
    store.write_kv(seq, 0, rows, final=False)
    assert seq.kv_filled == 0
    store.write_kv(seq, 0, rows)
    assert seq.kv_filled == 8
    store.retire(seq, cache=True)
    assert store.probe(prompt + [1]) == 8


def test_write_kv_batch_isolates_failures(store):
    """A bad write is reported and skipped; its batch-mates land."""
    rng = np.random.default_rng(3)
    a, b = store.admit([1, 2, 3]), store.admit([4, 5, 6])
    fa, ra = _rows_for(rng, CFG, 1)
    fails = store.write_kv_batch([(a, 0, ra), (b, 5, ra),
                                  (b, 0, np.zeros((1, 3), np.uint8))])
    assert [i for i, _ in fails] == [1, 2]
    assert all(isinstance(e, ValueError) for _, e in fails)
    assert a.kv_filled == 1 and b.kv_filled == 0
    np.testing.assert_array_equal(
        store.pagepool.read_raw(a.pages[0])[:CFG.kv_bytes_per_token],
        ra.reshape(-1))
    store.retire(a, cache=False)
    store.retire(b, cache=False)
    with pytest.raises(RuntimeError):
        store.write_kv(a, 0, ra)


def test_acquire_prefix_pins_against_eviction(store):
    rng = np.random.default_rng(8)
    prompt = list(range(20, 28))
    seq = store.admit(prompt)
    store.write_kv(seq, 0, _rows_for(rng, CFG, 8)[1])
    store.retire(seq, cache=True)
    hit, pages = store.acquire_prefix(prompt, full_pages=True)
    assert hit == 8 and len(pages) == 2
    assert store.evict_pages(10) == 0, "evicted a pinned page"
    store.release(pages)
    assert store.evict_pages(10) == 2
    assert store.stats()["evictions"] == 2


def test_pool_pressure_evicts_lru_and_retries():
    """At max_blocks the store evicts cached leaves and retries instead
    of failing; with nothing evictable the admit raises MemoryError."""
    rng = np.random.default_rng(4)
    s = make_store_for(CFG, page_tokens=4, max_blocks=1, device=CPU,
                       name="t_torch_pressure")
    try:
        ppb = s.pagepool.pages_per_block         # 8 pages per block
        old = list(range(ppb * 4))
        seq = s.admit(old)
        s.write_kv(seq, 0, _rows_for(rng, CFG, len(old))[1])
        s.retire(seq, cache=True)
        assert s.probe(old + [0]) == len(old)
        fresh = s.admit([900 + i for i in range(8)])
        assert s.stats()["evictions"] >= 2
        with pytest.raises(MemoryError):
            s.admit([700 + i for i in range(ppb * 4)])
        s.retire(fresh, cache=False)
    finally:
        s.clear()
    assert s.pagepool.blocks_leased() == 0


def test_stats_and_hit_rate(store):
    seq = store.admit([1, 2, 3, 4, 5])
    st = store.stats()
    assert st["admitted"] == 1 and st["live_seqs"] == 1
    assert st["pages"]["pages_in_use"] == 2
    store.retire(seq)
    assert store.stats()["live_seqs"] == 0
    assert store.hit_rate() == 0.0


# ---- the block pool and the device rule -------------------------------------

def test_block_pool_exact_classes_and_exhaustion():
    pool = BlockPool(CPU)
    blocks = [pool.alloc(BLOCK_CLASSES[0]) for _ in range(BLOCKS_PER_CLASS)]
    with pytest.raises(MemoryError):
        pool.alloc(BLOCK_CLASSES[0])
    with pytest.raises(ValueError):
        pool.alloc(1000)
    assert blocks[0].view().shape == (BLOCK_CLASSES[0],)
    assert blocks[0].view().data_ptr() == \
        pool.class_buffer(BLOCK_CLASSES[0])[blocks[0].slot].data_ptr()
    for b in blocks:
        b.free()
    assert pool.stats()["classes"][str(BLOCK_CLASSES[0])]["free"] \
        == BLOCKS_PER_CLASS


def test_entry_points_default_to_cuda():
    """No device -> cuda: a machine without a card raises instead of
    falling back to the CPU; one with a card gets the card."""
    if torch.cuda.is_available():
        assert get_block_pool().device.type == "cuda"
        return
    with pytest.raises(RuntimeError):
        get_block_pool()
    with pytest.raises(RuntimeError):
        make_store_for(CFG)
    with pytest.raises(RuntimeError):
        KVCacheStore(page_bytes=1024, page_tokens=4)
