"""The port's KV migration plane (``brpc_tpu_torch/migrate/plane.py``,
the store's ``import_prefix``/``acquire_pages``/``commit_live_pages``,
the balancer's ``migrate_on_rebalance``, ``Serving.Generate``'s
``prefix_fetcher``) held against the JAX package's.

Counterparts of ``tests/test_migrate.py`` on port stores holding REAL
K/V (``TransformerConfig()``, a ``TransformerRunner`` per store, the
JAX package's parameters through ``params_from_jax``; the port's store
has no token-id stand-in mode): raw page IO, the final full page in
``acquire_pages``, the round trip with a prefix hit, the no-op, the
three fault sites, the geometry and fingerprint refusals, the offer
table at 0 after a burst, incremental shipping, the rebalance push, a
failing hook, spans linked by ``migrated_from``, the live commit, the
frame codec and the frame-then-legacy negotiation.  Across packages
(ROADMAP item 5's gate): ``chunk_fingerprints`` and the Offer frame
fields are byte-equal, and a prefix migrates from a reference replica
into a port store and from a port replica into a reference store, the
page bytes equal to the source's and the receiving engine's greedy
tokens equal to the JAX package's dense forward with a prefix hit.

Tolerances: page bytes and greedy tokens are exact.  Streams are held to
the port's ``dense_generate`` where only port code runs (that oracle
equals the JAX package's, ``test_torch_runner.py``), and to the JAX
package's teacher-forced ``dense_forward`` where a stream crosses
packages.  Fault sites are named by ``fault.MIGRATE_SEND`` and siblings.
"""
import functools
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from brpc_tpu import rpc as ref_rpc
from brpc_tpu.migrate import plane as RP
from brpc_tpu.models import runner as R
from brpc_tpu.serving import DecodeEngine as RefEngine
from brpc_tpu_torch import errors, fault, rpc, rpcz
from brpc_tpu_torch.butil.endpoint import str2endpoint
from brpc_tpu_torch.ici import dcn
from brpc_tpu_torch.migrate import (MIGRATE_SERVICE, MigrateService,
                                    PageMigrator, chunk_fingerprints,
                                    make_prefix_fetcher, migration_snapshot,
                                    rebalance_pusher, register_migration)
from brpc_tpu_torch.migrate import plane as P
from brpc_tpu_torch.migrate.disagg import _TokenCollector
from brpc_tpu_torch.models import runner as T
from brpc_tpu_torch.policy.load_balancer import PrefixAffinityLB, ServerNode
from brpc_tpu_torch.rpc import tensorframe as tf
from brpc_tpu_torch.serving import DecodeEngine
from brpc_tpu_torch.serving.service import register_serving

from test_torch_runner import JCFG, JPARAMS, TCFG, _tparams

CPU = "cpu"
PT = 4
PB = PT * TCFG.kv_bytes_per_token
PARAMS = _tparams()
NEW = 4


def mk_store(name, **kw):
    kw.setdefault("max_blocks", 8)
    return T.make_store_for(TCFG, page_tokens=PT, device=CPU, name=name,
                            **kw)


def runner_for(store):
    return T.TransformerRunner(PARAMS, TCFG, store=store, device=CPU)


def commit(store, runner, prompt):
    """The prompt's K/V written by the runner and its full pages
    committed to the store's radix tree."""
    seq = store.admit(prompt)
    T.run_prefill(runner, seq, prompt)
    store.retire(seq, cache=True)


def generate(engine, prompt, n=NEW):
    toks, errs, ev = [], [], threading.Event()
    engine.submit(prompt, n, toks.append,
                  lambda e: (errs.append(e), ev.set()))
    assert ev.wait(60) and errs == [None], errs
    return toks


@functools.cache
def port_oracle(prompt: tuple, n=NEW) -> list:
    return T.dense_generate(PARAMS, TCFG, list(prompt), n, device=CPU)


# the JAX package's dense forward with its plain attention
# (use_flash=False), jitted: the flash kernel's interpret mode and eager
# dispatch cost seconds
_jax_dense = jax.jit(lambda p, t, pos: R.dense_forward(
    p, JCFG, t, pos, use_flash=False))


@functools.cache
def _jax_picks(seq: tuple) -> list:
    logits = _jax_dense(JPARAMS, jnp.asarray([seq], jnp.int32),
                        jnp.arange(len(seq), dtype=jnp.int32)[None])
    return np.asarray(jnp.argmax(logits, axis=-1))[0].tolist()


def assert_jax_greedy(prompt, stream):
    """Teacher-forced over prompt + stream[:-1], the JAX package's dense
    forward picks every streamed token (greedy decoding's definition)."""
    picks = _jax_picks(tuple(prompt) + tuple(stream[:-1]))
    assert picks[len(prompt) - 1:] == list(stream)


def pages_of(store, prompt):
    hit, pages = store.acquire_pages(prompt)
    raw = [store.pagepool.read_raw(p).tobytes() for p in pages]
    store.release(pages)
    return raw


def prompt_at(base, n=13):
    return [(base + 7 * j) % TCFG.vocab for j in range(n)]


@pytest.fixture(scope="module")
def dest():
    """A port replica: a store, its runner and engine, and a port server
    with the migration splice."""
    store = mk_store("mig_dst", max_blocks=16)
    eng = DecodeEngine(runner=runner_for(store), store=store, num_slots=2,
                       prefill_buckets=(16,), device=CPU, name="mig_dst")
    srv = rpc.Server(enable_dcn=True, dcn_device=CPU)
    svc = register_migration(srv, store)
    srv.start("127.0.0.1", 0)
    yield {"store": store, "engine": eng, "server": srv, "svc": svc,
           "addr": f"127.0.0.1:{srv.port}"}
    srv.stop()
    srv.join()
    eng.close()
    store.close()


@pytest.fixture()
def dst(dest):
    fault.clear()
    yield dest
    fault.clear()
    dest["store"].clear()
    assert dest["store"].pagepool.blocks_leased() == 0


@pytest.fixture()
def src():
    store = mk_store("mig_src")
    yield store, runner_for(store)
    store.clear()
    store.pagepool.assert_consistent()
    assert store.pagepool.blocks_leased() == 0
    store.close()


# ---------------------------------------------------------------------------
# page IO and export pins
# ---------------------------------------------------------------------------

def test_raw_page_io_round_trip():
    store = mk_store("mig_raw")
    try:
        commit(store, runner_for(store), prompt_at(1, 4))
        _, (page,) = store.acquire_pages(prompt_at(1, 4))
        assert store.pagepool.refs(page) == 2          # tree + this pin
        raw = store.pagepool.read_raw(page)
        assert raw.shape == (PB,) and raw.dtype == np.uint8
        fresh = store.pagepool.alloc_page()
        store.pagepool.write_raw(fresh, raw)
        assert store.pagepool.read_raw(fresh).tobytes() == raw.tobytes()
        store.pagepool.write(fresh, 1, [11, 12])
        assert store.pagepool.read(fresh, 3)[1:].tolist() == [11, 12]
        with pytest.raises(ValueError):
            store.pagepool.write_raw(fresh, raw[:-1])
        store.pagepool.unref(fresh)
        store.release([page])
    finally:
        store.clear()
        store.close()


def test_acquire_pages_covers_final_full_page(src):
    store, runner = src
    prompt = prompt_at(900, 8)                     # exactly 2 full pages
    commit(store, runner, prompt)
    hit_admit, pages_admit = store.acquire_prefix(prompt)
    hit_exp, pages_exp = store.acquire_pages(prompt)
    assert hit_admit == PT and len(pages_admit) == 1
    assert hit_exp == 2 * PT and len(pages_exp) == 2
    store.release(pages_admit)
    store.release(pages_exp)


# ---------------------------------------------------------------------------
# the round trip
# ---------------------------------------------------------------------------

def test_migrate_round_trip_dest_prefix_hits(dst, src):
    store, runner = src
    prompt = prompt_at(100)                        # 13 tokens: 3 pages
    commit(store, runner, prompt)
    in_use0 = store.pagepool.pages_in_use()
    m = PageMigrator(store, name="rt_migrator")
    fb0 = P.migrate_fallback.get_value()
    assert m.migrate(prompt, dst["addr"]) == 3
    assert store.pagepool.pages_in_use() == in_use0   # pins released
    assert P.migrate_fallback.get_value() == fb0 + 1
    assert m.stats()["routes"][dst["addr"]]["zero_copy"] == 0
    d = dst["store"]
    assert pages_of(d, prompt) == pages_of(store, prompt)
    assert d.stats()["imported_pages"] == 3
    h0 = d.hit_tokens
    assert generate(dst["engine"], prompt) == port_oracle(tuple(prompt))
    assert d.hit_tokens - h0 == 3 * PT
    # idempotent: chunks already cached keep the tree's pages
    nodes = d.radix.node_count()
    m2 = PageMigrator(store, name="rt_migrator2")
    assert m2.migrate(prompt, dst["addr"]) == 3
    assert d.radix.node_count() == nodes
    d.pagepool.assert_consistent()


def test_migrate_nothing_committed_is_noop(dst, src):
    store, _ = src
    m = PageMigrator(store, name="noop_migrator")
    assert m.migrate(prompt_at(5, 8), dst["addr"]) == 0
    assert dst["store"].radix.node_count() == 0


# ---------------------------------------------------------------------------
# fault sites
# ---------------------------------------------------------------------------

def test_migrate_send_fault_releases_pins(dst, src):
    store, runner = src
    prompt = prompt_at(200, 12)
    commit(store, runner, prompt)
    in_use0 = store.pagepool.pages_in_use()
    m = PageMigrator(store, name="send_migrator")
    plan = fault.FaultPlan(7).on(fault.MIGRATE_SEND, fault.ERROR, times=1)
    with fault.injected(plan):
        with pytest.raises(errors.RpcError):
            m.migrate(prompt, dst["addr"])
    assert plan.injected[fault.MIGRATE_SEND] == 1
    assert store.pagepool.pages_in_use() == in_use0
    assert dst["store"].radix.node_count() == 0
    assert m.migrate(prompt, dst["addr"]) == 3


def test_migrate_recv_fault_definite_error_dest_untouched(dst, src):
    store, runner = src
    prompt = prompt_at(300, 12)
    commit(store, runner, prompt)
    m = PageMigrator(store, name="recv_migrator")
    # one lost Offer is absorbed by the channel's retry (the push is
    # idempotent)
    plan = fault.FaultPlan(8).on(fault.MIGRATE_RECV, fault.ERROR, times=1)
    with fault.injected(plan):
        assert m.migrate(prompt, dst["addr"]) == 3
    assert plan.injected[fault.MIGRATE_RECV] == 1
    dst["store"].clear()
    # a persistent loss exhausts the retries into a definite error (a
    # fresh migrator: m's incremental cache would skip the send)
    m2 = PageMigrator(store, name="recv_migrator2")
    plan = fault.FaultPlan(8).on(fault.MIGRATE_RECV, fault.ERROR, times=-1)
    with fault.injected(plan):
        with pytest.raises(errors.RpcError) as ei:
            m2.migrate(prompt, dst["addr"])
    assert ei.value.code == errors.EINTERNAL
    assert dst["store"].radix.node_count() == 0
    assert dst["store"].pagepool.blocks_leased() == 0


def test_migrate_splice_fault_full_rollback(dst, src):
    """A fault after the first page landed rolls the whole import back;
    the destination then admits cold and a clean retry lands."""
    store, runner = src
    prompt = prompt_at(400, 12)
    commit(store, runner, prompt)
    d = dst["store"]
    in_use0 = d.pagepool.pages_in_use()
    m = PageMigrator(store, name="splice_migrator")
    rb0 = P.migrate_rollbacks.get_value()
    plan = fault.FaultPlan(9).on(fault.MIGRATE_SPLICE, fault.ERROR,
                                 times=-1, after=1)
    with fault.injected(plan):
        with pytest.raises(errors.RpcError) as ei:
            m.migrate(prompt, dst["addr"])
    assert ei.value.code == errors.EINTERNAL
    assert plan.injected[fault.MIGRATE_SPLICE] >= 1
    assert P.migrate_rollbacks.get_value() > rb0
    assert d.radix.node_count() == 0 and d.probe(prompt + [1]) == 0
    assert d.pagepool.pages_in_use() == in_use0
    d.pagepool.assert_consistent()
    store.pagepool.assert_consistent()
    assert m.migrate(prompt, dst["addr"]) == 3


# ---------------------------------------------------------------------------
# integrity refusals
# ---------------------------------------------------------------------------

def test_geometry_mismatch_refused(src):
    other = T.make_store_for(TCFG, page_tokens=8, max_blocks=8, device=CPU,
                             name="mig_geo")
    srv = rpc.Server(enable_dcn=True, dcn_device=CPU)
    register_migration(srv, other)
    srv.start("127.0.0.1", 0)
    store, runner = src
    prompt = prompt_at(500, 12)
    commit(store, runner, prompt)
    try:
        with pytest.raises(errors.RpcError) as ei:
            PageMigrator(store, name="geo_migrator").migrate(
                prompt, f"127.0.0.1:{srv.port}")
        assert ei.value.code == errors.EREQUEST
        assert "geometry" in ei.value.text
        assert other.radix.node_count() == 0
    finally:
        srv.stop()
        srv.join()
        other.close()


def test_fingerprint_mismatch_refused(dst):
    prompt = prompt_at(600, 8)
    payload = np.zeros((2, PB), np.uint8)
    hdr = {"tokens": prompt, "page_tokens": PT, "page_bytes": PB,
           "fingerprints": [1, 2], "src": "tamper"}
    ch = rpc.Channel(dst["addr"], timeout_ms=5000)
    with pytest.raises(errors.RpcError) as ei:
        ch.call_sync(MIGRATE_SERVICE, "Offer",
                     dcn._pack_envelope(hdr, [payload]),
                     serializer="raw", response_serializer="raw")
    assert ei.value.code == errors.EREQUEST
    assert dst["store"].radix.node_count() == 0
    hdr["fingerprints"] = chunk_fingerprints(prompt, PT)
    out = ch.call_sync(MIGRATE_SERVICE, "Offer",
                       dcn._pack_envelope(hdr, [payload]),
                       serializer="raw", response_serializer="raw")
    assert dcn._unpack_envelope(bytes(out))[0]["imported"] == 2


# ---------------------------------------------------------------------------
# the offer table, incremental shipping
# ---------------------------------------------------------------------------

def test_offer_table_zero_after_migration_burst(dst, src):
    """Host-serialized (the port has no fabric): 8 migrations, each
    counted as a fallback, none as zero-copy, no offer left pinned."""
    store, runner = src
    m = PageMigrator(store, name="burst_migrator")
    zc0 = P.migrate_zero_copy.get_value()
    fb0 = P.migrate_fallback.get_value()
    prompts = [prompt_at(700 + 31 * i, 12) for i in range(8)]
    for p in prompts:
        commit(store, runner, p)
        assert m.migrate(p, dst["addr"]) == 3
    assert dcn.live_offer_count() == 0
    assert P.migrate_fallback.get_value() == fb0 + 8
    assert P.migrate_zero_copy.get_value() == zc0
    for p in prompts:
        assert dst["store"].probe(p + [1]) == 12


def test_incremental_shipping_sends_only_new_chunks(dst, src):
    store, runner = src
    m = PageMigrator(store, name="incr_migrator")
    shared = prompt_at(950, 8)                     # 2 full pages
    commit(store, runner, shared + [1])
    addr = dst["addr"]
    assert m.migrate(shared, addr) == 2
    route = m.routes[addr]
    assert route["pages"] == 2
    longer = shared + prompt_at(960, 5)            # +1 full page
    commit(store, runner, longer)
    assert m.migrate(longer, addr) == 3 and route["pages"] == 3
    assert dst["store"].probe(longer + [9]) == 12
    other = shared + prompt_at(970, 5)
    commit(store, runner, other)
    assert m.migrate(other, addr) == 3 and route["pages"] == 4
    assert m.migrate(longer, addr) == 3 and route["pages"] == 4
    # the destination evicts everything: the stale incremental send is
    # refused and the migrator recovers with one full send
    dst["store"].clear()
    newer = shared + prompt_at(980, 5)
    commit(store, runner, newer)
    assert m.migrate(newer, addr) == 3
    assert dst["store"].probe(newer + [9]) == 12


# ---------------------------------------------------------------------------
# migrate on rebalance
# ---------------------------------------------------------------------------

def test_rebalance_pushes_warm_pages_to_new_owner():
    """Adding a replica remaps tracked prefixes; the hook asks each old
    owner to push its pages and the new owner prefix-hits them.  The
    prompts are picked on a scratch ring over the same ports, so the
    test holds moved and unmoved prefixes whatever the ports are."""
    stores, servers, eps = [], [], []
    try:
        for i in range(3):
            st = mk_store(f"rb{i}")
            srv = rpc.Server(enable_dcn=True, dcn_device=CPU)
            register_migration(srv, st)
            srv.start("127.0.0.1", 0)
            stores.append(st)
            servers.append(srv)
            eps.append(str2endpoint(f"127.0.0.1:{srv.port}"))
        before, after = PrefixAffinityLB(), PrefixAffinityLB()
        before.reset_servers([ServerNode(e) for e in eps[:2]])
        after.reset_servers([ServerNode(e) for e in eps])
        moved, kept = [], []
        for g in range(200):
            p = prompt_at(3 * g + 1)
            same = before.select_for_prompt(p) == after.select_for_prompt(p)
            (kept if same else moved).append(p)
            if len(moved) >= 3 and len(kept) >= 1:
                break
        prompts = moved[:3] + kept[:1]
        lb = PrefixAffinityLB()
        lb.migrate_on_rebalance(rebalance_pusher())
        lb.add_server(ServerNode(eps[0]))
        lb.add_server(ServerNode(eps[1]))
        runners = [runner_for(st) for st in stores]
        for p in prompts:
            i = eps.index(lb.select_for_prompt(p))
            commit(stores[i], runners[i], p)
        lb.add_server(ServerNode(eps[2]))
        assert lb.join_migrations(30)
        assert lb.remaps == 3 and lb.remap_failures == 0
        assert lb.remap_migrations == 3
        for p in prompts[:3]:
            assert lb.select_for_prompt(p) == eps[2]
            assert stores[2].probe(p + [7]) == 12, \
                "remapped prefix not warm at the new owner"
        assert stores[2].probe(prompts[3] + [7]) == 0
    finally:
        for srv in servers:
            srv.stop()
            srv.join()
        for st in stores:
            st.close()


def test_rebalance_hook_failure_degrades_not_blocks():
    lb = PrefixAffinityLB()

    def bad_hook(tokens, old_ep, new_ep):
        raise RuntimeError("owner gone")

    lb.migrate_on_rebalance(bad_hook)
    e1, e2, e3 = (str2endpoint(f"10.0.0.{i}:80") for i in (1, 2, 3))
    lb.add_server(ServerNode(e1))
    lb.add_server(ServerNode(e2))
    for g in range(16):
        lb.select_for_prompt([3000 * g + j for j in range(8)])
    lb.add_server(ServerNode(e3))
    assert lb.join_migrations(10)
    assert lb.remaps > 0
    assert lb.remap_failures == lb.remaps
    assert lb.remap_migrations == 0
    lb.migrate_on_rebalance(None)
    assert not lb._routed


# ---------------------------------------------------------------------------
# observability
# ---------------------------------------------------------------------------

def test_migration_spans_join_trace_with_migrated_from(dst, src):
    store, runner = src
    prompt = prompt_at(800, 12)
    commit(store, runner, prompt)
    was = (rpcz.enabled(), rpcz.sample_rate())
    rpcz.set_enabled(True, 1.0)
    try:
        root = rpcz.new_span("client", "Test", "Migrate")
        rpcz.set_current_span(root)
        p0 = P.migrate_pages.get_value()
        n0 = P.splice_recorder().count()
        try:
            assert PageMigrator(store, name="trace_migrator").migrate(
                prompt, dst["addr"]) == 3
        finally:
            rpcz.set_current_span(None)
            rpcz.submit(root)
        assert P.migrate_pages.get_value() == p0 + 3
        assert P.splice_recorder().count() == n0 + 1
        spans = rpcz.recent_spans(2048, root.trace_id)
        offers = [s for s in spans
                  if s.kind == "migrate" and s.method == "Offer"]
        splices = [s for s in spans
                   if s.kind == "migrate" and s.method == "Splice"]
        assert offers and splices, [(s.kind, s.method) for s in spans]
        assert splices[0].trace_id == root.trace_id
        assert splices[0].migrated_from == offers[0].span_id
        assert "migrated_from=span" in rpcz.format_trace(spans)
    finally:
        rpcz.set_enabled(*was)


def test_migration_snapshot_counts_routes(dst, src):
    store, runner = src
    prompt = prompt_at(850, 12)
    commit(store, runner, prompt)
    ok0 = P.migrations_ok.get_value()
    m = PageMigrator(store, name="snap_migrator")   # registered weakly
    assert m.migrate(prompt, dst["addr"]) == 3
    snap = migration_snapshot()
    assert snap["counters"]["migrations_ok"] == ok0 + 1
    assert snap["counters"]["live_offers"] == 0
    assert snap["counters"]["zero_copy"] == 0
    route = snap["outbound"]["snap_migrator"]["routes"][dst["addr"]]
    assert route["migrations"] == 1 and route["pages"] == 3
    assert any(s["inbound"].get("mig_src", {}).get("pages", 0) >= 3
               for s in snap["inbound"])


# ---------------------------------------------------------------------------
# the streaming live commit
# ---------------------------------------------------------------------------

def test_commit_live_pages_exposes_filled_pages_mid_generation():
    store = mk_store("live_commit", commit_live_pages=True)
    runner = runner_for(store)
    try:
        prompt = prompt_at(11, 5)                  # 1 full page + tail
        seq = store.admit(prompt)
        T.run_prefill(runner, seq, prompt)
        assert store.probe(prompt[:4] + [9]) == PT, "not committed live"
        row = np.zeros((1, TCFG.kv_bytes_per_token), np.uint8)
        for t in (6, 7, 8):
            store.extend(seq, t)
        # appended but not written: the page holds no K/V yet
        assert store.probe(prompt + [6, 7, 8, 1]) == PT
        for pos in (5, 6):
            store.write_kv(seq, pos, row)
        assert store.probe(prompt + [6, 7, 8, 1]) == PT
        store.write_kv(seq, 7, row)                # fills the 2nd page
        hit, pages = store.acquire_pages(prompt + [6, 7, 8])
        assert hit == 2 * PT and len(pages) == 2
        store.release(pages)
        store.evict_pages(64)                      # the seq still holds them
        assert store.probe(prompt[:4] + [9]) == PT
        store.retire(seq, cache=False)
        store.clear()
        store.pagepool.assert_consistent()
        assert store.pagepool.blocks_leased() == 0
    finally:
        store.close()


# ---------------------------------------------------------------------------
# the Offer wire
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pt", (4, 16))
def test_chunk_fingerprints_equal_reference(pt):
    rng = np.random.default_rng(pt)
    toks = rng.integers(0, 2**40, 5 * pt + 3).tolist()
    assert chunk_fingerprints(toks, pt) == RP.chunk_fingerprints(toks, pt)


def test_offer_envelope_frame_codec_byte_identical():
    header = {"tokens": list(range(100, 108)),
              "fingerprints": [12345, 2**63 + 17], "refcounts": [2, 1],
              "page_tokens": PT, "page_bytes": PB, "src": "127.0.0.1:5555",
              "trace_id": 987654321, "span_id": 42}
    arrays = [np.arange(2 * PB, dtype=np.uint8)]
    legacy = dcn._unpack_envelope(dcn._pack_envelope(header, arrays))
    fields = P._envelope_frame_fields(header, arrays)
    wire = tf.encode_frame(fields)
    assert wire == tf.encode_frame(RP._envelope_frame_fields(header, arrays))
    hdr, got = P._frame_envelope(tf.decode_frame(wire))
    assert hdr == legacy[0] and hdr["fingerprints"][1] == 2**63 + 17
    assert [a.tobytes() for a in got] == [a.tobytes() for a in legacy[1]]
    zc = dict(header, ticket=7, specs=[[PB, "uint8"]])
    lh, la = dcn._unpack_envelope(dcn._pack_envelope(zc, []))
    fh, fa = P._frame_envelope(tf.decode_frame(tf.encode_frame(
        P._envelope_frame_fields(zc, []))))
    assert fh == lh and fa == [] and la == []


def test_offer_wire_negotiation_frame_then_sticky_legacy(dst, src):
    class _OldMigrate(MigrateService):
        OfferT = None       # an old peer: no binary method

    store, runner = src
    prompt = prompt_at(720, 8)
    commit(store, runner, prompt)
    old = mk_store("mig_old")
    old_srv = rpc.Server(enable_dcn=True, dcn_device=CPU)
    old_srv.add_service(_OldMigrate(old))
    old_srv.start("127.0.0.1", 0)
    old_addr = f"127.0.0.1:{old_srv.port}"
    try:
        m = PageMigrator(store, name="neg_migrator")
        assert m.migrate(prompt, dst["addr"]) == 2
        assert m.stats()["wire_modes"][dst["addr"]] == "frame"
        assert m.migrate(prompt, old_addr) == 2
        st = m.stats()
        assert st["wire_modes"][old_addr] == "legacy"
        assert st["negotiation_fallbacks"] == 1
        assert pages_of(old, prompt) == pages_of(store, prompt) == \
            pages_of(dst["store"], prompt)
        m2 = PageMigrator(store, name="neg_migrator2")
        m2._wire_mode[old_addr] = "legacy"
        old.clear()
        assert m2.migrate(prompt, old_addr) == 2
        assert m2.stats()["negotiation_fallbacks"] == 0
    finally:
        old_srv.stop()
        old_srv.join()
        old.clear()
        old.close()


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

XPROMPT = prompt_at(40)        # 13 tokens: 3 full pages at 4 per page


def test_reference_replica_prefix_migrates_into_port_store(dst):
    """A prefix computed by the JAX package's runner ships from a
    reference PageMigrator into a port store: bytes equal, and the port
    engine decodes the JAX package's greedy tokens from a prefix hit."""
    rstore = R.make_store_for(JCFG, page_tokens=PT, max_blocks=8,
                              name="xref_src")
    try:
        rrun = R.TransformerRunner(JPARAMS, JCFG, store=rstore)
        seq = rstore.admit(XPROMPT)
        R.run_prefill(rrun, seq, XPROMPT)
        rstore.retire(seq, cache=True)
        m = RP.PageMigrator(rstore, name="xref_migrator")
        assert m.migrate(XPROMPT, dst["addr"]) == 3
        _, rpages = rstore.acquire_pages(XPROMPT)
        want = [rstore.pagepool.read_raw(p).tobytes() for p in rpages]
        rstore.release(rpages)
        d = dst["store"]
        assert pages_of(d, XPROMPT) == want
        h0 = d.hit_tokens
        stream = generate(dst["engine"], XPROMPT)
        assert d.hit_tokens - h0 == 3 * PT
        assert_jax_greedy(XPROMPT, stream)
    finally:
        rstore.clear()
        rstore.close()


def test_port_replica_prefix_migrates_into_reference_store(src):
    """And back: a port prefix ships into a reference store behind a
    reference server; the reference engine decodes the JAX package's
    greedy tokens from a prefix hit."""
    store, runner = src
    commit(store, runner, XPROMPT)
    rstore = R.make_store_for(JCFG, page_tokens=PT, max_blocks=8,
                              name="xref_dst")
    reng = RefEngine(runner=R.TransformerRunner(JPARAMS, JCFG, store=rstore),
                     store=rstore, num_slots=2, max_pages_per_slot=8,
                     prefill_buckets=(16,), name="xref_dst")
    rsrv = ref_rpc.Server(enable_dcn=True)
    RP.register_migration(rsrv, rstore)
    rsrv.start("127.0.0.1", 0)
    try:
        m = PageMigrator(store, name="xport_migrator")
        assert m.migrate(XPROMPT, f"127.0.0.1:{rsrv.port}") == 3
        assert m.stats()["wire_modes"] == {
            f"127.0.0.1:{rsrv.port}": "frame"}
        _, rpages = rstore.acquire_pages(XPROMPT)
        got = [rstore.pagepool.read_raw(p).tobytes() for p in rpages]
        rstore.release(rpages)
        assert got == pages_of(store, XPROMPT)
        h0 = rstore.hit_tokens.get_value()
        stream = generate(reng, XPROMPT)
        assert rstore.hit_tokens.get_value() - h0 == 3 * PT
        assert_jax_greedy(XPROMPT, stream)
        assert stream == port_oracle(tuple(XPROMPT))
    finally:
        reng.close()
        rsrv.stop()
        rsrv.join()
        rstore.clear()
        rstore.close()


# ---------------------------------------------------------------------------
# the pull-based prefix fetch
# ---------------------------------------------------------------------------

def _rpc_generate(addr, prompt, holders):
    col = _TokenCollector()
    cntl = rpc.Controller(timeout_ms=30_000)
    rpc.stream_create(cntl, col)
    resp = rpc.Channel(addr, timeout_ms=30_000).call_sync(
        "Serving", "Generate", {"prompt": prompt, "max_new_tokens": NEW,
                                "prefix_holders": holders},
        serializer="json", cntl=cntl)
    assert col.done.wait(30) and col.error is None
    return resp, col.tokens


def test_prefix_fetch_warms_a_cold_replica(dst, src):
    """A cold replica told who holds the prompt's prefix fetches it
    (PushTo from the holder into its own splice), then hits; with the
    fetch failing (``fault.PREFIX_FETCH``) it recomputes, same tokens."""
    store, runner = src
    prompt, other = prompt_at(60), prompt_at(61)
    for p in (prompt, other):
        commit(store, runner, p)
        assert PageMigrator(store, name="fetch_seed").migrate(
            p, dst["addr"]) == 3
    cold = mk_store("mig_cold")
    eng = DecodeEngine(runner=runner_for(cold), store=cold, num_slots=2,
                       prefill_buckets=(16,), device=CPU, name="mig_cold")
    srv = rpc.Server(enable_dcn=True, dcn_device=CPU)
    register_migration(srv, cold)
    svc = register_serving(srv, engine=eng)
    srv.start("127.0.0.1", 0)
    addr = f"127.0.0.1:{srv.port}"
    svc.prefix_fetcher = make_prefix_fetcher(
        PageMigrator(cold, name="cold_fetcher"), addr)
    try:
        resp, toks = _rpc_generate(addr, prompt, [addr, dst["addr"]])
        assert resp["prefix_hit"] == 12 and toks == port_oracle(
            tuple(prompt))
        assert svc.prefix_fetches == 1 and svc.prefix_fetched_pages == 3
        plan = fault.FaultPlan(3).on(fault.PREFIX_FETCH, fault.ERROR,
                                     times=-1)
        with fault.injected(plan):
            resp, toks = _rpc_generate(addr, other, [dst["addr"]])
        assert plan.injected[fault.PREFIX_FETCH] == 1
        assert resp["prefix_hit"] == 0
        assert toks == port_oracle(tuple(other))
        assert svc.prefix_fetches == 1
    finally:
        srv.stop()
        srv.join()
        eng.close()
        cold.clear()
        assert cold.pagepool.blocks_leased() == 0
        cold.close()


def test_prefix_fetch_burst_beyond_executor_workers(dst, src):
    """More fetching Generates at once than the process has executor
    workers (cores + 1, at least 4), holder and fetcher in one process:
    each handler's fetch waits on the holder's PushTo, which waits on
    this process's own OfferT.  With the fetch and the push off the
    executor, every one fetches and hits; none falls back to recompute
    after a timed-out push."""
    store, runner = src
    n = max((os.cpu_count() or 1) + 1, 4) + 1
    prompts = [prompt_at(70 + i) for i in range(n)]
    for p in prompts:
        commit(store, runner, p)
        assert PageMigrator(store, name="burst_seed").migrate(
            p, dst["addr"]) == 3
    cold = mk_store("mig_burst")
    eng = DecodeEngine(runner=runner_for(cold), store=cold, num_slots=2,
                       prefill_buckets=(16,), device=CPU, name="mig_burst")
    srv = rpc.Server(enable_dcn=True, dcn_device=CPU)
    register_migration(srv, cold)
    svc = register_serving(srv, engine=eng)
    srv.start("127.0.0.1", 0)
    addr = f"127.0.0.1:{srv.port}"
    svc.prefix_fetcher = make_prefix_fetcher(
        PageMigrator(cold, name="burst_fetcher"), addr)
    out = [None] * n

    def one(i):
        out[i] = _rpc_generate(addr, prompts[i], [dst["addr"]])

    try:
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert svc.prefix_fetches == n and svc.prefix_fetched_pages == 3 * n
        for p, (resp, toks) in zip(prompts, out):
            assert resp["prefix_hit"] == 12
            assert toks == port_oracle(tuple(p))
    finally:
        srv.stop()
        srv.join()
        eng.close()
        cold.clear()
        assert cold.pagepool.blocks_leased() == 0
        cold.close()
