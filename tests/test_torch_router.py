"""The port's cluster front door held against the JAX package's.

Counterparts of ``tests/test_router.py`` over ``brpc_tpu_torch.serving``
(routing, shed-at-router with its ``retry_after_s`` backoff, resumable
sessions, replica kill with buddy page shipping, router restart, the
gradient's order, fault sites, ``rpc_press --cluster``, the progress
deadline, stream leaks, N-way placement, the ``_cluster`` floor push and
its epoch fence, the pull-based prefix fetch).  The replicas run the
reference tests' step function through ``LegacyFnRunner`` over
harness-mode stores, and every stream is held to the same ``_expected``.

Then the two packages together: a JAX router in front of port replicas
and the reverse (one bit-exact generation and one replica-kill resume
each), fingerprints and catalog snapshots, and ``/cluster``'s
timing-free fields; ``router_proc.run_router`` in this process over a
WAL; and the whole slice: a port router in front of two port replicas
serving ``TransformerConfig()`` on the CPU, every stream equal to the
JAX package's jitted dense oracle.
"""
import http.client
import io
import json
import threading
import time

import numpy as np
import pytest

from brpc_tpu_torch import errors, fault, rpc
from brpc_tpu_torch.ici.block_pool import BlockPool
from brpc_tpu_torch.kvcache import KVCacheStore
from brpc_tpu_torch.migrate import register_migration
from brpc_tpu_torch.serving import (ClusterRouter, DecodeEngine,
                                    ReplicaHandle, RouterClient,
                                    SessionTable, register_router,
                                    register_serving)

from testutil import wait_until

CPU = "cpu"
PT = 4          # page tokens: small so short prompts cross boundaries


def _reset_policy(health_check, circuit_breaker):
    health_check.reset_all()
    b = circuit_breaker.global_breaker()
    with b._mu:
        b._short.clear()
        b._long.clear()
        b._isolation_count.clear()
        b._recovering_until.clear()


@pytest.fixture(autouse=True)
def _hygiene():
    """Never leak fault plans, broken endpoints or breaker state (the
    JAX package's too: the cross-package tests use its router)."""
    from brpc_tpu_torch.policy import circuit_breaker, health_check
    fault.clear()
    yield
    fault.clear()
    _reset_policy(health_check, circuit_breaker)
    from brpc_tpu.policy import circuit_breaker as jcb
    from brpc_tpu.policy import health_check as jhc
    _reset_policy(jhc, jcb)


def _expected(prompt, n):
    last, pos, out = prompt[-1], len(prompt), []
    for _ in range(n):
        last = (last * 7 + pos) % 997
        out.append(last)
        pos += 1
    return out


def _step_fn(delay_s=0.0):
    """Position-dependent step (a bit-exactness probe); optionally slow,
    so a kill can land mid-generation."""
    def step(tokens, positions, pages=None):
        if delay_s:
            time.sleep(delay_s)
        return (np.asarray(tokens) * 7 + np.asarray(positions)) % 997
    return step


def _harness_store(name, max_blocks=64):
    # a block pool each: replicas live side by side in this process
    return KVCacheStore(BlockPool(CPU), page_tokens=PT, page_bytes=256,
                        max_blocks=max_blocks, name=f"{name}_store",
                        commit_live_pages=True, vector_kv=False)


class _Replica:
    """One in-process serving replica: store + engine + server with the
    Serving and _kvmig services (and _cluster with ``control=True``)."""

    def __init__(self, name, *, delay_s=0.0, num_slots=4, max_blocks=64,
                 control=False):
        self.name = name
        self.store = _harness_store(name, max_blocks)
        self.engine = DecodeEngine(_step_fn(delay_s), num_slots=num_slots,
                                   store=self.store, max_pages_per_slot=32,
                                   device=CPU, name=f"{name}_eng")
        self.server = rpc.Server(enable_dcn=True, dcn_device=CPU)
        register_serving(self.server, engine=self.engine)
        register_migration(self.server, self.store)
        self.ctrl = None
        if control:
            from brpc_tpu_torch.serving import register_cluster_control
            self.ctrl = register_cluster_control(
                self.server, engine=self.engine, store=self.store,
                name=name)
        self.server.start("127.0.0.1", 0)
        self.addr = f"127.0.0.1:{self.server.port}"

    def handle(self):
        return ReplicaHandle(self.addr, name=self.name, batcher=None,
                             engine=self.engine, store=self.store,
                             server=self.server)

    def kill(self):
        """Process-death analog: the server socket goes away and the
        engine stops; in-flight streams break mid-generation."""
        self.server.stop()
        self.server.join()
        self.engine.close(timeout_s=2.0)

    def close(self):
        try:
            self.engine.close(timeout_s=2.0)
        except Exception:
            pass
        try:
            self.server.stop()
            self.server.join()
        except Exception:
            pass
        self.store.clear()
        self.store.close()


def _router_server(router):
    srv = rpc.Server()
    register_router(srv, router)
    srv.start("127.0.0.1", 0)
    return srv, f"127.0.0.1:{srv.port}"


def _stop(srv):
    srv.stop()
    srv.join()


@pytest.fixture()
def cluster():
    """Two live replicas + a router server, buddy replication on."""
    reps = [_Replica("tcl_a", delay_s=0.004),
            _Replica("tcl_b", delay_s=0.004)]
    table = SessionTable()
    router = ClusterRouter([r.handle() for r in reps], sessions=table,
                           page_tokens=PT, replicate_sessions=True,
                           quarantine_after=1, name="tcl_router",
                           check_interval_s=0.02)
    rsrv, raddr = _router_server(router)
    yield reps, router, table, raddr
    router.close(timeout_s=3.0)
    _stop(rsrv)
    for r in reps:
        r.close()


def test_generate_through_router_bit_exact(cluster):
    reps, router, table, raddr = cluster
    cli = RouterClient(raddr)
    prompt = list(range(50, 63))
    out = cli.generate(prompt, 6, timeout_s=20)
    assert out["error"] is None
    assert out["tokens"] == _expected(prompt, 6)
    assert out["cursor"] == 6
    s = table.get(out["session_id"])
    assert s is not None and s.state == "finished"
    assert router.stats()["forwards"] >= 1
    assert router.stats()["sessions"]["finished"] >= 1


def test_prefix_affinity_repeat_prompts_stick(cluster):
    reps, router, table, raddr = cluster
    cli = RouterClient(raddr)
    prompt = [7, 8, 9, 10, 11]
    replicas_used = set()
    for _ in range(3):
        out = cli.generate(prompt, 3, timeout_s=20)
        assert out["error"] is None
        replicas_used.add(table.get(out["session_id"]).replica)
    assert len(replicas_used) == 1, \
        f"repeat prefix bounced across replicas: {replicas_used}"


def test_shed_at_router_has_retry_after(cluster):
    reps, router, table, raddr = cluster
    router._ladder.level = 1          # synthetic overload
    try:
        cli = RouterClient(raddr, shed_retries=0)
        with pytest.raises(errors.RpcError) as ei:
            cli.generate([1, 2, 3], 4, timeout_s=10)
        assert ei.value.code == errors.ELIMIT
        assert "retry_after_s=" in ei.value.text
        assert router.shed_total.get_value() >= 1
        assert router.stats()["gradient_fired"]["shed_at_router"] >= 1
    finally:
        router._ladder.level = 0


def test_shed_backoff_retries_after_hint_not_hammering(cluster):
    """A shed client sleeps at least the hinted delay between attempts
    (bounded, jittered) and succeeds once the overload clears."""
    from brpc_tpu_torch.serving.router import parse_retry_after_s
    reps, router, table, raddr = cluster
    # the floor pins the synthetic overload against the tick's own
    # hysteresis: only clear() ends the plateau
    router._ladder.floor = 1
    router._ladder.level = 1
    hint = router.retry_after_s()
    assert parse_retry_after_s(f"shed; retry_after_s={hint}") == hint
    cli = RouterClient(raddr, shed_retries=4)

    def clear():
        time.sleep(hint * 1.5)
        router._ladder.floor = 0
        router._ladder.level = 0

    t = threading.Thread(target=clear)
    t0 = time.monotonic()
    t.start()
    try:
        out = cli.generate([1, 2, 3], 4, timeout_s=30)
    finally:
        t.join(10)
        router._ladder.floor = 0
        router._ladder.level = 0
    elapsed = time.monotonic() - t0
    assert out["error"] is None
    assert out["tokens"] == _expected([1, 2, 3], 4)
    assert cli.backoffs, "client never backed off"
    assert all(slept >= hinted >= hint
               for hinted, slept in cli.backoffs)
    sheds = router.shed_total.get_value()
    assert 1 <= sheds <= 3, f"client hammered the router: {sheds} sheds"
    assert len(cli.backoffs) == sheds
    assert elapsed >= hint


def test_shed_retries_zero_surfaces_elimit_immediately(cluster):
    reps, router, table, raddr = cluster
    router._ladder.level = 1
    try:
        cli = RouterClient(raddr, shed_retries=0)
        t0 = time.monotonic()
        with pytest.raises(errors.RpcError) as ei:
            cli.generate([1, 2, 3], 4, timeout_s=10)
        assert ei.value.code == errors.ELIMIT
        assert time.monotonic() - t0 < router.retry_after_s()
        assert cli.backoffs == []
    finally:
        router._ladder.level = 0


def test_shed_backoff_bounded_by_caller_deadline(cluster):
    """Under a sustained overload, ``generate(timeout_s=N)`` with N below
    the hint surfaces the shed at once instead of sleeping past N."""
    reps, router, table, raddr = cluster
    router._ladder.floor = 1
    router._ladder.level = 1
    hint = router.retry_after_s()
    try:
        cli = RouterClient(raddr, shed_retries=3)
        budget = min(0.5, hint / 2)
        t0 = time.monotonic()
        with pytest.raises(errors.RpcError) as ei:
            cli.generate([1, 2, 3], 4, timeout_s=budget)
        elapsed = time.monotonic() - t0
        assert ei.value.code == errors.ELIMIT
        assert cli.backoffs == []
        assert elapsed < hint, \
            f"client slept {elapsed:.1f}s past its {budget}s budget"
    finally:
        router._ladder.floor = 0
        router._ladder.level = 0


def test_client_drop_reconnect_replays_exactly_once(cluster):
    reps, router, table, raddr = cluster
    cli = RouterClient(raddr)
    prompt = list(range(20, 29))
    budget = 10
    gen = cli.start(prompt, budget)
    assert gen.wait_tokens(3, timeout_s=10)
    sid, cursor = gen.session_id, gen.cursor
    seen = gen.tokens
    gen.drop()                         # the client dies; the session
    s = table.get(sid)                 # keeps decoding
    assert wait_until(lambda: s.state in ("finished", "failed"), 10)
    assert s.state == "finished"
    out = cli.resume_wait(sid, cursor, timeout_s=10)
    assert out["error"] is None
    assert seen[:cursor] + out["tokens"] == _expected(prompt, budget)
    assert router.replays_total.get_value() >= len(out["tokens"])
    out2 = cli.resume_wait(sid, budget - 2, timeout_s=10)
    assert out2["tokens"] == _expected(prompt, budget)[-2:]


def test_replica_kill_client_drop_resume_bit_exact(cluster):
    """The serving replica is killed mid-decode AND the client drops; on
    reconnect the stream resumes bit-exact through the survivor, riding
    the buddy page shipping so re_decoded_tokens < total."""
    reps, router, table, raddr = cluster
    cli = RouterClient(raddr)
    prompt = list(range(100, 113))      # 13 tokens: 3 full pages
    budget = 12
    gen = cli.start(prompt, budget)
    assert gen.wait_tokens(4, timeout_s=10)
    sid = gen.session_id
    s = table.get(sid)
    assert wait_until(lambda: s.replicated_pages > 0, 10), \
        "no pages were replicated to the ring buddy"
    serving = s.replica
    victim = next(r for r in reps
                  if str(r.handle().endpoint) == serving
                  or r.addr == serving)
    survivor = next(r for r in reps if r is not victim)
    cursor = gen.cursor
    seen = gen.tokens
    gen.drop()
    victim.kill()
    assert wait_until(lambda: s.state in ("finished", "failed"), 20)
    assert s.state == "finished", f"session failed: E{s.error_code}"
    assert s.resumes >= 1
    out = cli.resume_wait(sid, cursor, timeout_s=10)
    assert out["error"] is None
    assert seen[:cursor] + out["tokens"] == _expected(prompt, budget), \
        "resumed stream is not bit-exact"
    total = len(prompt) + budget
    assert 0 < s.re_decoded_tokens < total, (s.re_decoded_tokens, total)
    assert s.re_decoded_tokens <= total - PT, \
        "no committed page was skipped on resume"
    from brpc_tpu_torch.policy.health_check import is_broken
    from brpc_tpu_torch.policy.load_balancer import prefix_fingerprint
    victim_ep = victim.handle().endpoint
    assert is_broken(victim_ep)
    remapped = router._lb.select_server(
        request_code=prefix_fingerprint(prompt))
    assert remapped != victim_ep
    assert wait_until(
        lambda: survivor.store.stats()["live_seqs"] == 0, 10)


def test_router_restart_adopts_sessions_and_resumes():
    reps = [_Replica("trr_a", delay_s=0.004),
            _Replica("trr_b", delay_s=0.004)]
    table = SessionTable()
    r1 = ClusterRouter([r.handle() for r in reps], sessions=table,
                       page_tokens=PT, name="trr_router1",
                       check_interval_s=0.02)
    srv1, addr1 = _router_server(r1)
    cli1 = RouterClient(addr1)
    prompt = list(range(40, 49))
    budget = 10
    sid = None
    try:
        gen = cli1.start(prompt, budget)
        assert gen.wait_tokens(3, timeout_s=10)
        sid, cursor = gen.session_id, gen.cursor
        seen = gen.tokens
        gen.drop()
        r1.close(timeout_s=3.0)        # the router "dies"
        _stop(srv1)
        s = table.get(sid)
        assert s.state == "suspended"
        r2 = ClusterRouter([r.handle() for r in reps], sessions=table,
                           page_tokens=PT, name="trr_router2",
                           check_interval_s=0.02)
        srv2, addr2 = _router_server(r2)
        try:
            out = RouterClient(addr2).resume_wait(sid, cursor,
                                                  timeout_s=15)
            assert out["error"] is None
            assert seen[:cursor] + out["tokens"] == \
                _expected(prompt, budget)
            assert s.state == "finished"
        finally:
            r2.close(timeout_s=3.0)
            _stop(srv2)
    finally:
        if sid and table.get(sid) and table.get(sid).state == "running":
            table.get(sid).finish(None)
        r1.close(timeout_s=1.0)
        for r in reps:
            r.close()


class TestGradientOrdering:
    def _mk(self):
        rep = _Replica("tgrad_a")
        # cached pages in the replica's radix for level 4 to evict
        seq = rep.store.admit(list(range(300, 300 + 4 * PT)) + [1])
        rep.store.retire(seq, cache=True)
        router = ClusterRouter([rep.handle()], page_tokens=PT,
                               auto_tick=False, hysteresis_ticks=2,
                               name="tgrad_router")
        return rep, router

    def test_ramp_fires_in_order_and_de_escalates_in_reverse(self):
        rep, router = self._mk()
        try:
            ramp = {1: 0.85, 2: 0.90, 3: 0.95, 4: 0.99}
            pressures = {"sessions_ratio": 0.0}
            router._pressures = lambda: dict(pressures)

            def try_admit():
                try:
                    s = router.open_session([1, 2, 3], 1)
                    s.finish(None)      # don't actually decode
                    return True
                except errors.RpcError as e:
                    assert e.code == errors.ELIMIT
                    return False

            evict0 = rep.store.evictions
            first_fired = []
            router._tick()
            assert try_admit()
            assert rep.engine.degraded_clamp is None
            for lvl in (1, 2, 3, 4):
                pressures["sessions_ratio"] = ramp[lvl]
                router._tick()
                assert router.level == lvl
                shed = not try_admit()
                if shed and "shed_at_router" not in first_fired:
                    first_fired.append("shed_at_router")
                if router.gradient_fired["brownout_at_batcher"]\
                        .get_value() and \
                        "brownout_at_batcher" not in first_fired:
                    first_fired.append("brownout_at_batcher")
                if rep.engine.degraded_clamp is not None and \
                        "clamp_at_engine" not in first_fired:
                    first_fired.append("clamp_at_engine")
                if rep.store.evictions > evict0 and \
                        "evict_at_store" not in first_fired:
                    first_fired.append("evict_at_store")
            assert first_fired == ["shed_at_router",
                                   "brownout_at_batcher",
                                   "clamp_at_engine",
                                   "evict_at_store"], first_fired
            fired = router.stats()["gradient_fired"]
            assert fired["brownout_at_batcher"] == 1
            assert fired["clamp_at_engine"] == 1
            assert fired["evict_at_store"] == 1
            # de-escalation: reverse order, one level per window
            pressures["sessions_ratio"] = 0.0
            order_down = []
            evict_hi = rep.store.evictions
            for expect_lvl in (3, 2, 1, 0):
                for _ in range(router._ladder.hysteresis_ticks):
                    router._tick()
                assert router.level == expect_lvl, \
                    (router.level, expect_lvl)
                if expect_lvl == 3:
                    assert rep.store.evictions == evict_hi
                    assert rep.engine.degraded_clamp is not None
                    order_down.append("evict_stopped")
                elif expect_lvl == 2:
                    assert rep.engine.degraded_clamp is None
                    order_down.append("clamp_cleared")
                elif expect_lvl == 1:
                    assert not try_admit()
                    order_down.append("brownout_cleared")
                else:
                    assert try_admit()
                    order_down.append("shed_stopped")
            assert order_down == ["evict_stopped", "clamp_cleared",
                                  "brownout_cleared", "shed_stopped"]
        finally:
            router.close(timeout_s=1.0)
            rep.close()

    def test_supervisor_floor_follows_cluster_level(self):
        """A replica WITH a supervisor follows the cluster gradient
        through its level floor (cluster level N => local floor N-1)."""
        from brpc_tpu_torch.serving import EngineSupervisor
        store = _harness_store("tgrad_sup", max_blocks=32)
        calm = ({"queue_delay_us": float("inf"), "pool_ratio": 9.9,
                 "queue_depth": 1e9},) * 3
        sup = EngineSupervisor(
            lambda: DecodeEngine(_step_fn(), num_slots=2, store=store,
                                 max_pages_per_slot=16, device=CPU,
                                 name="tgrad_sup_eng"),
            store=store, ladder=calm, check_interval_s=30.0,
            hysteresis_ticks=1, name="tgrad_sup")
        srv = rpc.Server()
        register_serving(srv, engine=sup)
        srv.start("127.0.0.1", 0)
        handle = ReplicaHandle(f"127.0.0.1:{srv.port}", supervisor=sup,
                               store=store)
        router = ClusterRouter([handle], auto_tick=False,
                               hysteresis_ticks=1,
                               name="tgrad_sup_router")
        try:
            pressures = {"sessions_ratio": 0.99}     # level 4
            router._pressures = lambda: dict(pressures)
            router._tick()
            assert router.level == 4
            sup._update_degradation()
            assert sup.level == 3      # floor = cluster level - 1
            pressures["sessions_ratio"] = 0.0
            router._tick()             # hysteresis 1: a level a tick
            sup._update_degradation()
            assert sup.level == max(0, router.level - 1)
            for _ in range(8):
                router._tick()
            assert router.level == 0
            for _ in range(3):
                sup._update_degradation()
            assert sup.level == 0
        finally:
            router.close(timeout_s=1.0)
            sup.close(timeout_s=2.0)
            _stop(srv)
            store.clear()
            store.close()


def _fill_cache(store):
    """Retire one-page prompts until the radix tree holds all of the
    pool but one page (each admission takes two pages; one more would
    evict); returns the pool's capacity and the last prompt."""
    st = store.pagepool.stats()
    cap = st["max_blocks"] * st["pages_per_block"]
    i = 0
    while store.pagepool.pages_in_use() + 2 <= cap:
        i += 1
        store.retire(store.admit([7000 + i] * PT + [1]), cache=True)
    return cap, [7000 + i] * PT


def test_warm_cache_is_not_pool_pressure():
    """A replica whose pool is full of cached radix pages is not under
    pressure: only pages live sequences hold count, so the default
    ladder admits over a warm replica.  The JAX package counts every
    cached page and sheds there (ROADMAP "Faults in the reference")."""
    from brpc_tpu.kvcache import KVCacheStore as JKVCacheStore
    from brpc_tpu.serving import ReplicaHandle as JReplicaHandle
    rep = _Replica("warm_pool", max_blocks=2)
    router = None
    jstore = JKVCacheStore(page_tokens=PT, page_bytes=256, max_blocks=2,
                           name="warm_pool_jax", commit_live_pages=True)
    try:
        cap, last = _fill_cache(rep.store)
        assert rep.store.pagepool.pages_in_use() == cap - 1
        assert rep.handle().pressures()["pool_ratio"] == 0.0
        router = ClusterRouter([rep.handle()], page_tokens=PT,
                               auto_tick=False, hysteresis_ticks=1,
                               name="warm_pool_router")
        router._tick()
        assert router._pressures()["replica_pool_ratio"] == 0.0
        assert router.level == 0
        # a live sequence's pages do count, a shared cached one too
        seq = rep.store.admit(last + list(range(3 * PT)))
        assert seq.prefix_hit_tokens == PT
        assert rep.handle().pressures()["pool_ratio"] == 4 / cap
        rep.store.retire(seq, cache=False)
        # the reference: the same warm pool reads as full
        assert _fill_cache(jstore)[0] == cap
        jp = JReplicaHandle(rep.addr, store=jstore).pressures()
        assert jp["pool_ratio"] == (cap - 1) / cap
    finally:
        if router is not None:
            router.close(timeout_s=1.0)
        rep.close()
        jstore.clear()
        jstore.close()


def test_fault_sites_shed_and_reroute():
    """router.admit fails the admission definitively; router.forward
    fails the first forward and the session re-routes."""
    reps = [_Replica("tfs_a"), _Replica("tfs_b")]
    router = ClusterRouter([r.handle() for r in reps], page_tokens=PT,
                           auto_tick=False, name="tfs_router")
    try:
        plan = fault.FaultPlan(seed=11)
        plan.on(fault.ROUTER_ADMIT, fault.ERROR, times=1)
        with fault.injected(plan):
            with pytest.raises(errors.RpcError):
                router.open_session([1, 2, 3], 2)
        assert plan.injected.get(fault.ROUTER_ADMIT) == 1
        plan2 = fault.FaultPlan(seed=12)
        plan2.on(fault.ROUTER_FORWARD, fault.ERROR, times=1)
        with fault.injected(plan2):
            s = router.open_session([9, 9, 9, 9], 4)
            assert wait_until(
                lambda: s.state in ("finished", "failed"), 15)
        assert s.state == "finished"
        assert s.emitted == _expected([9, 9, 9, 9], 4)
        assert plan2.injected.get(fault.ROUTER_FORWARD) == 1
        assert s.resumes >= 1
    finally:
        router.close(timeout_s=2.0)
        for r in reps:
            r.close()


def test_press_cluster_mode():
    """``rpc_press --cluster N`` drives generations through an
    in-process cluster and reports generations/s, TTFT percentiles, the
    resume count and the per-level fire counts."""
    from brpc_tpu_torch.tools.rpc_press import run_cluster_press
    out = io.StringIO()
    summary = run_cluster_press(
        2, {"prompt": [3, 1, 4, 1, 5], "max_new_tokens": 4},
        duration_s=0.8, threads=2, timeout_ms=8000, device=CPU, out=out)
    assert summary["generations_ok"] > 0
    assert summary["generations_per_s"] > 0
    assert summary["ttft_p99_us"] > 0
    assert summary["errors"] == 0
    assert "resumes" in summary
    assert set(summary["shed_counts"]) == {
        "shed_at_router", "brownout_at_batcher", "clamp_at_engine",
        "evict_at_store"}
    assert json.loads(out.getvalue())


def _prompt_routed_to(router, ep, length):
    from brpc_tpu_torch.policy.load_balancer import prefix_fingerprint
    for base in range(40, 400):
        cand = [base + j for j in range(length)]
        if router._lb.select_server(request_code=prefix_fingerprint(
                cand, router.chunk_tokens)) == ep:
            return cand
    return None


def test_wedged_replica_progress_deadline_failover():
    """A replica whose server accepts the forward but never emits nor
    closes reads as a failover at the progress deadline; the session
    completes bit-exact on the healthy replica."""
    from brpc_tpu_torch.rpc.service import Service, method

    held = []                      # keep the wedged server streams alive

    class _WedgedServing(Service):
        NAME = "Serving"

        @method(request="json", response="json")
        def Generate(self, cntl, req):
            held.append(cntl.accept_stream())
            return {"accepted": True}

    wsrv = rpc.Server()
    wsrv.add_service(_WedgedServing())
    wsrv.start("127.0.0.1", 0)
    waddr = f"127.0.0.1:{wsrv.port}"
    healthy = _Replica("twedge_ok", delay_s=0.002)
    router = ClusterRouter(
        [ReplicaHandle(waddr, name="wedged"), healthy.handle()],
        page_tokens=PT, name="twedge_router",
        progress_timeout_s=0.5, auto_tick=False)
    try:
        prompt = _prompt_routed_to(router, router._ep_by_name[waddr], 9)
        assert prompt is not None
        t0 = time.monotonic()
        s = router.open_session(prompt, 5)
        assert wait_until(
            lambda: s.state in ("finished", "failed"), 20), \
            "session hung on the wedged replica"
        assert s.state == "finished"
        assert s.emitted == _expected(prompt, 5)
        assert s.resumes >= 1
        assert time.monotonic() - t0 < 15
    finally:
        router.close(timeout_s=2.0)
        _stop(wsrv)
        healthy.close()


def test_no_stream_leak_on_shed_or_dead_replica():
    """Streams made before a forward/Generate RPC that FAILS are closed:
    (a) a client shed with ELIMIT, (b) a session whose first forward
    lands on a dead replica before failing over."""
    from brpc_tpu_torch.rpc.stream import StreamRegistry

    reg = StreamRegistry.instance()
    healthy = _Replica("tleak_ok", delay_s=0.002)
    dead_addr = "127.0.0.1:1"
    router = ClusterRouter(
        [ReplicaHandle(dead_addr, name="dead"), healthy.handle()],
        page_tokens=PT, name="tleak_router", auto_tick=False)
    rsrv, raddr = _router_server(router)
    cli = RouterClient(raddr)
    try:
        baseline = reg.count()
        router._ladder.level = 1
        with pytest.raises(errors.RpcError):
            cli.generate([1, 2, 3], 2, timeout_s=5)
        router._ladder.level = 0
        assert wait_until(lambda: reg.count() <= baseline, 5), \
            f"shed leaked streams: {reg.count()} > {baseline}"
        prompt = _prompt_routed_to(router, router._ep_by_name[dead_addr],
                                   7)
        assert prompt is not None
        out = cli.generate(prompt, 3, timeout_s=20)
        assert out["error"] is None
        assert out["tokens"] == _expected(prompt, 3)
        assert wait_until(lambda: reg.count() <= baseline, 5), \
            f"dead-replica forward leaked: {reg.count()} > {baseline}"
    finally:
        router.close(timeout_s=2.0)
        _stop(rsrv)
        healthy.close()


def test_generate_attach_failure_cancels_session(cluster):
    """Admission succeeds but the Generate ATTACH fails: the router
    cancels the session instead of decoding its budget for nobody."""
    reps, router, table, raddr = cluster
    cli = RouterClient(raddr)
    plan = fault.FaultPlan(seed=5)
    plan.on(fault.ROUTER_RESUME, fault.ERROR, times=1)
    with fault.injected(plan):
        # the channel retries the failed Generate: a fresh session
        out = cli.generate([11, 12, 13, 14], 6, timeout_s=10)
    assert out["error"] is None
    assert out["tokens"] == _expected([11, 12, 13, 14], 6)
    assert plan.injected.get(fault.ROUTER_RESUME) == 1
    assert wait_until(lambda: table.live_count() == 0, 10), \
        "orphaned session still live after attach failure"
    counts = table.counts()
    assert counts["failed"] == 1 and counts["finished"] == 1


def test_attach_after_close_raises_elogoff():
    healthy = _Replica("tclose_ok", delay_s=0.002)
    router = ClusterRouter([healthy.handle()], page_tokens=PT,
                           name="tclose_router", auto_tick=False)
    try:
        s = router.open_session([1, 2, 3, 4], 3)
        assert wait_until(
            lambda: s.state in ("finished", "failed"), 15)
        router.close(timeout_s=2.0)
        with pytest.raises(errors.RpcError) as ei:
            router.attach(s.sid, 0, lambda t: None)
        assert ei.value.code == errors.ELOGOFF
    finally:
        router.close(timeout_s=1.0)
        healthy.close()


def test_placement_n_way_distinct_healthy_first():
    """``placement`` returns n DISTINCT endpoints, owner first, healthy
    before broken."""
    from brpc_tpu_torch.butil.endpoint import str2endpoint
    from brpc_tpu_torch.policy import health_check as hc
    from brpc_tpu_torch.policy.load_balancer import (ConsistentHashLB,
                                                     ServerNode)
    lb = ConsistentHashLB()
    eps = [str2endpoint(f"10.0.0.{i}:80") for i in range(1, 6)]
    for ep in eps:
        lb.add_server(ServerNode(ep))
    fp = 0xDEADBEEF
    place = lb.placement(fp, 3)
    assert len(place) == 3 and len(set(place)) == 3
    assert place[0] == lb.select_server(request_code=fp)
    hc.mark_broken(place[0], hold_s=60.0)
    try:
        place2 = lb.placement(fp, 3)
        assert place[0] not in place2
        assert len(place2) == 3 and len(set(place2)) == 3
        for ep in eps[1:]:
            hc.mark_broken(ep, hold_s=60.0)
        place3 = lb.placement(fp, 3)
        assert len(place3) == 3 and len(set(place3)) == 3
    finally:
        hc.reset_all()


def test_three_way_buddy_ship_and_ownership_directory():
    """replication_factor=3: a page-crossing generation ships its
    committed pages to TWO ring buddies, the directory records owner and
    acked buddies, and every holder can serve the prefix."""
    reps = [_Replica(f"tnway_{i}", delay_s=0.002) for i in range(3)]
    router = ClusterRouter([r.handle() for r in reps], page_tokens=PT,
                           replicate_sessions=True,
                           replication_factor=3, name="tnway_router",
                           check_interval_s=0.02)
    try:
        prompt = list(range(70, 83))        # 13 + 6 tokens = 4 pages
        s = router.open_session(prompt, 6)
        got = []
        router.attach(s.sid, 0, got.append)
        assert wait_until(lambda: s.state == "finished", 20)
        assert got == _expected(prompt, 6)
        assert wait_until(lambda: s.replicated_pages > 0, 10), \
            "no buddy received pages"
        rows = router.placements()
        assert rows, "ownership directory is empty"
        row = rows[-1]
        assert row["owner"] == s.replica
        assert len(row["buddies"]) == 2, row
        by_addr = {r.addr: r for r in reps}
        toks = prompt + got
        for holder in [row["owner"]] + row["buddies"]:
            assert by_addr[holder].store.probe(toks) >= 2 * PT, holder
        st = router.stats()
        assert st["replication_factor"] == 3
        assert st["placements"], "placements missing from stats()"
    finally:
        router.close(timeout_s=3.0)
        for r in reps:
            r.close()


def test_attach_ahead_of_record_suppresses_redelivery():
    """A cursor ahead of the record is legal while the session can still
    decode: the gap is re-decoded but not re-delivered.  On a terminal
    session it is a client error."""
    table = SessionTable()
    s = table.new_session([1, 2, 3], 10)
    for t in (7, 8, 9):
        s.append(t)
    got = []
    replayed = s.attach(5, got.append, lambda err: None)
    assert replayed == 0 and got == []
    s.append(40)
    s.append(50)
    assert got == []
    s.append(60)
    assert got == [60]
    s.finish(None)
    with pytest.raises(errors.RpcError) as ei:
        s.attach(99, lambda t: None)
    assert ei.value.code == errors.EREQUEST


def test_remote_floor_push_applies_level_over_the_wire():
    """An address-only replica gets the router's level through the
    _cluster SetFloor push, applies it by the in-process policy, and its
    pressure report feeds the router's gradient back."""
    rep = _Replica("twire_a", delay_s=0.002, control=True)
    router = ClusterRouter([rep.addr], page_tokens=PT,
                           name="twire_router", auto_tick=False, epoch=5)
    try:
        router._push_floor(3)
        assert rep.ctrl.level == 3 and rep.ctrl.epoch == 5
        assert rep.ctrl.applied == 1
        assert rep.engine.degraded_clamp == router.clamp_new_tokens
        rows = router.remote_floor_table()
        assert len(rows) == 1
        assert rows[0]["acked_level"] == 3
        assert rows[0]["epoch"] == 5
        assert rows[0]["ack_age_s"] is not None
        assert router.floor_pushes == 1
        p = router._pressures()
        assert p["replica_pool_ratio"] >= 0.0
        st = router._remote_floor[router.replicas[0].endpoint]
        assert st["pressures"], "no pressure report rode the ack"
        router._push_floor(0)
        assert rep.ctrl.level == 0
        assert rep.engine.degraded_clamp is None
    finally:
        router.close(timeout_s=2.0)
        rep.close()


def test_epoch_fence_refuses_superseded_router():
    """The replica latches the highest epoch it has seen and refuses a
    SetFloor carrying a lower one (EREQUEST, 'stale epoch')."""
    rep = _Replica("tfence_a", delay_s=0.002, control=True)
    new_router = ClusterRouter([rep.addr], page_tokens=PT,
                               name="tfence_new", auto_tick=False,
                               epoch=7)
    old_router = ClusterRouter([rep.addr], page_tokens=PT,
                               name="tfence_old", auto_tick=False,
                               epoch=6)
    try:
        new_router._push_floor(2)
        assert rep.ctrl.epoch == 7 and rep.ctrl.level == 2
        old_router._push_floor(4)           # superseded: refused
        assert rep.ctrl.level == 2, "stale push moved the floor"
        assert rep.ctrl.refusals == 1
        assert old_router.floor_push_refused == 1
        assert old_router.remote_floor_table()[0]["refused"] == 1
        with pytest.raises(errors.RpcError) as ei:
            rpc.Channel(rep.addr, timeout_ms=2000).call_sync(
                "_cluster", "SetFloor",
                {"epoch": 1, "level": 4, "router": "zombie"},
                serializer="tensorframe",
                response_serializer="tensorframe")
        assert ei.value.code == errors.EREQUEST
        assert "stale epoch" in (ei.value.text or "")
    finally:
        new_router.close(timeout_s=2.0)
        old_router.close(timeout_s=2.0)
        rep.close()


class _Drain:
    def __init__(self):
        self.done = threading.Event()

    def on_received_messages(self, stream, messages):
        for m in messages:
            if json.loads(bytes(m)).get("done") is not None:
                self.done.set()

    def on_closed(self, stream):
        self.done.set()

    def on_idle_timeout(self, stream):
        pass


def _generate_drained(addr, req):
    from brpc_tpu_torch.rpc.controller import Controller
    from brpc_tpu_torch.rpc.stream import stream_create
    d = _Drain()
    cntl = Controller(timeout_ms=10_000)
    stream_create(cntl, d)
    resp = rpc.Channel(addr, timeout_ms=10_000).call_sync(
        "Serving", "Generate", req, serializer="json", cntl=cntl)
    assert d.done.wait(10)
    return resp


def test_prefix_fetch_pulls_pages_from_named_holder():
    """A Generate carrying prefix_holders on a COLD replica fetches the
    committed prefix from the named owner instead of recomputing."""
    from brpc_tpu_torch.migrate import make_prefix_fetcher
    warm = _Replica("tpf_warm", delay_s=0.002, control=True)
    cold = _Replica("tpf_cold", delay_s=0.002, control=True)
    for rep in (warm, cold):
        svc = rep.server.services["Serving"]
        svc.prefix_fetcher = make_prefix_fetcher(
            rep.server.services["_kvmig"].migrator, rep.addr)
    try:
        prompt = list(range(30, 42))        # 12 tokens = 3 full pages
        _generate_drained(warm.addr, {"prompt": prompt,
                                      "max_new_tokens": 4})
        assert wait_until(lambda: warm.store.probe(prompt) >= 2 * PT, 10)
        assert cold.store.probe(prompt) == 0
        resp = _generate_drained(cold.addr, {
            "prompt": prompt, "max_new_tokens": 4,
            "prefix_holders": [warm.addr]})
        assert resp["prefix_hit"] >= 2 * PT, resp
        assert cold.store.probe(prompt) >= 2 * PT
        svc = cold.server.services["Serving"]
        assert svc.prefix_fetches == 1
        assert svc.prefix_fetched_pages >= 2
    finally:
        warm.close()
        cold.close()


def test_control_and_page_planes_feed_no_circuit_breaker():
    """Floor pushes and telemetry pulls (router to replica) and page
    pushes (replica to its buddy) ride channels that feed no circuit
    breaker: their latency (a pull snapshots every bvar of the process,
    a push carries pages) is not the request path's, and read as its
    degradation it would isolate a healthy replica and move its
    prefixes.  A forward still feeds it."""
    from brpc_tpu_torch.policy.circuit_breaker import global_breaker
    from brpc_tpu_torch.tools.rpc_press import (spin_up_replicas,
                                                tear_down_replicas)
    # a paced step and a 24-token budget: the session still decodes
    # when its pages ship (a finished session ships nothing)
    replicas = spin_up_replicas(2, page_tokens=PT, page_bytes=256,
                                step_delay_s=0.004, commit_live_pages=True,
                                name_prefix="tcb", device=CPU)
    router = ClusterRouter([a for *_, a in replicas], page_tokens=PT,
                           auto_tick=False, replicate_sessions=True,
                           name="tcb_router")
    b = global_breaker()
    try:
        eps = [h.endpoint for h in router.replicas]
        for _ in range(3):
            router._tick()
        # a pull per replica at the first tick, more when the ticks
        # straddle the 0.25 s pull interval
        assert router.collector.stats()["pulls"] >= 2
        assert router.floor_pushes == 6
        assert not any(ep in b._short or ep in b._long for ep in eps)
        s = router.open_session(list(range(30, 43)), 24)
        assert wait_until(lambda: s.state == "finished", 15)
        assert wait_until(lambda: s.replicated_pages > 0, 10)
        owner = router._ep_by_name[s.replica]
        buddy = next(ep for ep in eps if ep != owner)
        assert owner in b._short, "the forward fed no breaker"
        assert buddy not in b._short and buddy not in b._long
    finally:
        router.close(timeout_s=2.0)
        tear_down_replicas(replicas)


# ---------------------------------------------------------------------------
# the step-function runner over a harness store
# ---------------------------------------------------------------------------

def test_legacy_fn_runner_protocols():
    """A 3-arg step function gets the page tables (numpy int32), a 2-arg
    one does not; a vector-KV store refuses a step function."""
    from brpc_tpu_torch.models import LegacyFnRunner
    seen = []

    def step3(tokens, positions, pages):
        seen.append((tokens.dtype, positions.dtype, pages.dtype,
                     pages.shape))
        return (tokens * 7 + positions) % 997

    store = _harness_store("tlegacy")
    assert LegacyFnRunner(step3, store=store).wants_pages
    assert not LegacyFnRunner(_step_fn(), store=store).wants_pages
    eng = DecodeEngine(step3, num_slots=2, store=store,
                       max_pages_per_slot=8, device=CPU, name="tlegacy")
    try:
        got, ev = [], threading.Event()
        eng.submit([5, 6, 7], 4, got.append, lambda e: ev.set())
        assert ev.wait(10)
        assert got == _expected([5, 6, 7], 4)
        assert seen[0] == (np.dtype(np.int32),) * 3 + ((2, 8),)
    finally:
        eng.close()
        store.clear()
    vec = KVCacheStore(BlockPool(CPU), page_tokens=PT, page_bytes=256,
                       name="tlegacy_vec")
    with pytest.raises(ValueError, match="harness-mode"):
        DecodeEngine(step3, store=vec, device=CPU, name="tlegacy_vec")
    vec.close()
    store.close()


# ---------------------------------------------------------------------------
# the two packages together
# ---------------------------------------------------------------------------

def _packages():
    import brpc_tpu as jbrpc
    import brpc_tpu.serving as jserving
    from brpc_tpu.tools import rpc_press as jpress

    import brpc_tpu_torch.serving as pserving
    from brpc_tpu_torch.tools import rpc_press as ppress
    return {"jax": (jbrpc.Server, jserving, jpress, {}),
            "port": (rpc.Server, pserving, ppress, {"device": CPU})}


@pytest.mark.parametrize("router_pkg,replica_pkg",
                         [("jax", "port"), ("port", "jax")])
def test_router_of_one_package_in_front_of_replicas_of_the_other(
        router_pkg, replica_pkg):
    """One bit-exact generation, then a replica killed mid-decode with
    the client dropped: the session resumes bit-exact on the survivor
    after pages crossed to it (re_decoded_tokens < total)."""
    pk = _packages()
    server_cls, serving, _, _ = pk[router_pkg]
    _, _, press, kw = pk[replica_pkg]
    replicas = press.spin_up_replicas(
        2, page_tokens=PT, page_bytes=256, step_delay_s=0.004,
        commit_live_pages=True, name_prefix=f"tx_{router_pkg}", **kw)
    addrs = [a for *_, a in replicas]
    router = serving.ClusterRouter(
        addrs, page_tokens=PT, replicate_sessions=True,
        quarantine_after=1, check_interval_s=0.02,
        name=f"tx_{router_pkg}_router")
    rsrv = server_cls()
    serving.register_router(rsrv, router)
    rsrv.start("127.0.0.1", 0)
    cli = serving.RouterClient(f"127.0.0.1:{rsrv.port}")
    try:
        prompt = list(range(50, 63))
        out = cli.generate(prompt, 6, timeout_s=20)
        assert out["error"] is None
        assert out["tokens"] == _expected(prompt, 6)

        # a budget that outlasts the wait for the buddy's pages, so the
        # kill lands mid-decode even on a loaded machine
        prompt = list(range(100, 113))
        budget = 48
        gen = cli.start(prompt, budget)
        assert gen.wait_tokens(4, timeout_s=10)
        s = router.sessions.get(gen.session_id)
        assert wait_until(lambda: s.replicated_pages > 0, 10)
        victim = next(r for r in replicas if r[3] == s.replica)
        cursor, seen = gen.cursor, gen.tokens
        gen.drop()
        _store, eng, srv, _addr = victim
        srv.stop()
        srv.join()
        eng.close(timeout_s=2.0)
        assert wait_until(lambda: s.state in ("finished", "failed"), 20)
        assert s.state == "finished", f"session failed: E{s.error_code}"
        assert s.resumes >= 1
        res = cli.resume_wait(gen.session_id, cursor, timeout_s=10)
        assert res["error"] is None
        assert seen[:cursor] + res["tokens"] == _expected(prompt, budget)
        assert 0 < s.re_decoded_tokens < len(prompt) + budget
    finally:
        router.close(timeout_s=3.0)
        rsrv.stop()
        rsrv.join()
        press.tear_down_replicas(replicas)


def test_fingerprints_and_catalog_snapshots_equal_across_packages():
    import brpc_tpu.serving.modelplane as J
    import brpc_tpu_torch.serving.modelplane as P
    rng = np.random.default_rng(13)
    for model in (None, "default", "m", "m@v2", "other"):
        for n in (1, 15, 16, 17, 48):
            toks = rng.integers(0, 50000, n).tolist()
            assert P.model_fingerprint(model, toks) == \
                J.model_fingerprint(model, toks), (model, n)
    assert P.deployment_key("m", "v2") == J.deployment_key("m", "v2")
    assert P.split_deployment_key("m@v2") == J.split_deployment_key("m@v2")

    def build(mod):
        deps = mod.ReplicaDeployments("r0")
        deps.deploy("m@v1", weight=95)
        deps.deploy("m@v2", weight=5)
        deps.deploy("solo", state=mod.WARM)
        deps.note_generation("m@v1")
        deps.drain("solo")
        cat = mod.ModelCatalog()
        cat.note("10.0.0.1:80", deps.snapshot())
        cat.note("10.0.0.2:80", mod.parse_deployments(
            mod.publish_deployments(deps)))
        cat.note("10.0.0.3:80", [{"model": "m@v2", "weight": 7},
                                 {"bad": 1}])
        canary = mod.CanarySplit()
        picks = [canary.pick("m", cat.version_weights("m"))
                 for _ in range(40)]
        met = mod.ModelMetrics()
        for i in range(10):
            met.note_open("m@v1")
            met.note_ttft("m@v1", 0.001 * (i + 1))
            met.note_itl("m@v1", 0.0005 * (i + 1))
        met.note_shed("m@v2")
        met.note_finish("m@v1", 0)
        met.note_finish("m@v1", 2004)
        return {"deps": deps.snapshot(), "catalog": cat.snapshot(),
                "keys": cat.keys(), "resolve": cat.resolve("m"),
                "for_new": cat.replicas_for("solo"),
                "for_all": cat.replicas_for("solo", for_new=False),
                "weights": cat.version_weights("m"), "picks": picks,
                "canary": canary.snapshot(), "metrics": met.snapshot(),
                "published": mod.publish_deployments(deps)}

    assert build(P) == build(J)


def _http_json(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        assert r.status == 200, (path, r.status)
        return json.loads(r.read())
    finally:
        conn.close()


def test_cluster_page_timing_free_fields_equal_reference():
    """The same router state in both packages: ``/cluster`` on each
    package's console renders equal fields (session ids and the WAL's
    timings aside)."""
    pk = _packages()
    pages = {}
    for name, (server_cls, serving, _, _) in pk.items():
        router = serving.ClusterRouter(
            ["127.0.0.1:1", "127.0.0.1:2"], page_tokens=PT,
            auto_tick=False, telemetry_collect=False, epoch=3,
            name="tcluster_page")
        srv = server_cls()
        srv.start("127.0.0.1", 0)
        try:
            t = router.sessions
            a = t.new_session([1, 2, 3], 4)
            for tok in (5, 6):
                a.append(tok)
            a.finish(None)
            b = t.new_session([4, 5], 8)
            b.append(9)
            router._ladder.level = 2
            router._apply_level(2)
            router._note_placement(0xABC, owner="127.0.0.1:1",
                                   buddies=["127.0.0.1:2"])
            page = _http_json(srv.port, "/cluster")
            pages[name] = page["routers"]["tcluster_page"]
            b.finish(None)
        finally:
            router.close(timeout_s=1.0)
            srv.stop()
            srv.join()
    for page in pages.values():
        for row in page["session_rows"]:
            row.pop("session_id")
    # the ladder's level display names (the training arbiter's, not
    # ported yet): empty here
    assert pages["jax"]["ladder"].pop("level_names") == []
    assert pages["port"] == pages["jax"]


# ---------------------------------------------------------------------------
# router_proc, in this process
# ---------------------------------------------------------------------------

def test_router_proc_run_router_adopts_the_wal(tmp_path):
    """``run_router`` over a WAL: a generation, then the router closes
    mid-generation and a second ``run_router`` over the same WAL adopts
    the session at a higher epoch; the client resumes from its cursor
    and sees each token exactly once."""
    from brpc_tpu_torch.serving.router_proc import run_router
    from brpc_tpu_torch.tools.rpc_press import (spin_up_replicas,
                                                tear_down_replicas)
    replicas = spin_up_replicas(2, page_tokens=PT, page_bytes=256,
                                step_delay_s=0.004, commit_live_pages=True,
                                name_prefix="tproc", device=CPU)
    cfg = {"wal": str(tmp_path / "sessions.wal"),
           "replicas": [a for *_, a in replicas], "page_tokens": PT,
           "check_interval_s": 0.02, "name": "tproc_router"}
    r1, s1 = run_router(cfg)
    r2 = s2 = None
    try:
        cli = RouterClient(f"127.0.0.1:{s1.port}")
        out = cli.generate([3, 1, 4, 1, 5], 5, timeout_s=20)
        assert out["tokens"] == _expected([3, 1, 4, 1, 5], 5)
        prompt = list(range(60, 69))
        budget = 14
        gen = cli.start(prompt, budget)
        assert gen.wait_tokens(3, timeout_s=10)
        sid, cursor, seen = gen.session_id, gen.cursor, gen.tokens
        gen.drop()
        e1 = r1.epoch
        r1.close(timeout_s=3.0)
        r1.sessions.close()
        _stop(s1)
        r2, s2 = run_router(cfg)
        assert r2.epoch > e1
        assert r2.sessions.replay_stats["live"] >= 1
        res = RouterClient(f"127.0.0.1:{s2.port}").resume_wait(
            sid, cursor, timeout_s=15)
        assert res["error"] is None
        assert seen[:cursor] + res["tokens"] == _expected(prompt, budget)
    finally:
        for r, srv in ((r1, s1), (r2, s2)):
            if r is not None:
                r.close(timeout_s=2.0)
                r.sessions.close()
                _stop(srv)
        tear_down_replicas(replicas)


# ---------------------------------------------------------------------------
# the whole slice: transformer replicas behind the router
# ---------------------------------------------------------------------------

def test_routed_transformer_streams_equal_jax_oracle():
    """A port router in front of two port replicas, each a
    ``TransformerRunner`` at ``TransformerConfig()`` on the CPU: every
    routed greedy stream equals the JAX package's jitted dense oracle,
    and a repeated prompt lands on the same replica."""
    from brpc_tpu_torch.models import runner as T
    from brpc_tpu_torch.serving import (register_cluster_control,
                                        register_telemetry)
    from test_torch_runner import NEW, PROMPTS, TCFG, _tparams, jax_oracle
    params = _tparams()
    reps = []
    for i in range(2):
        store = T.make_store_for(TCFG, page_tokens=PT, max_blocks=16,
                                 pool=BlockPool(CPU), device=CPU,
                                 commit_live_pages=True,
                                 name=f"tslice_{i}")
        eng = DecodeEngine(
            runner=T.TransformerRunner(params, TCFG, store=store,
                                       device=CPU, name=f"tslice_{i}"),
            store=store, num_slots=4, max_pages_per_slot=16,
            prefill_buckets=(16, 64), device=CPU, name=f"tslice_{i}")
        srv = rpc.Server(enable_dcn=True, dcn_device=CPU)
        register_serving(srv, engine=eng)
        register_migration(srv, store)
        register_cluster_control(srv, engine=eng, store=store)
        register_telemetry(srv, name=f"tslice_{i}")
        srv.start("127.0.0.1", 0)
        reps.append((store, eng, srv, f"127.0.0.1:{srv.port}"))
    router = ClusterRouter(
        [ReplicaHandle(a, engine=e, store=st, server=sv)
         for st, e, sv, a in reps],
        page_tokens=PT, replicate_sessions=True, name="tslice_router",
        check_interval_s=0.02)
    rsrv, raddr = _router_server(router)
    try:
        cli = RouterClient(raddr)
        gens = [cli.start(p, NEW) for p in PROMPTS]
        for g in gens:
            assert g.wait(30) and g.error is None
        for p, g in zip(PROMPTS, gens):
            assert g.tokens == jax_oracle(tuple(p), NEW), p
        first = router.sessions.get(gens[0].session_id).replica
        again = cli.generate(PROMPTS[0], NEW, timeout_s=30)
        assert again["tokens"] == jax_oracle(tuple(PROMPTS[0]), NEW)
        assert router.sessions.get(again["session_id"]).replica == first
    finally:
        router.close(timeout_s=3.0)
        _stop(rsrv)
        for store, eng, srv, _ in reps:
            eng.close()
            _stop(srv)
            store.clear()
            store.close()
