"""The port's cluster channel held against the JAX package's.

  * counterparts of ``tests/test_connection_types.py`` (single, pooled,
    short, pooled across a server restart);
  * counterparts of ``tests/test_channel_matrix.py``'s retry and backup
    cases, both ways: a port client against a JAX-package server and a
    JAX-package client against a port server;
  * a ``list://`` cluster of port servers: rr spreads, every call end
    feeds the port's circuit breaker, a failing replica is isolated and
    routed around, a request code routes consistently, a backup request
    lands on the other replica, and a ``file://`` list reloads;
  * each transport fault site fires and the call takes the JAX
    package's path: a refused connect retries onto the other replica, a
    reset or overcrowded write retries, a dropped message runs into the
    deadline, a dropped or duplicated stream frame and a lost feedback
    frame leave the stream whole.

Sites are named through the port's ``fault`` constants.  Every test
resets both packages' health checks and leaves no probe or naming
thread running.
"""
import collections
import os
import sys
import tempfile
import threading
import time

import pytest

import brpc_tpu as ref
from brpc_tpu.policy import health_check as RHC
import brpc_tpu_torch.rpc as rpc
from brpc_tpu_torch import errors, fault
from brpc_tpu_torch.butil.endpoint import str2endpoint
from brpc_tpu_torch.policy import circuit_breaker as CB
from brpc_tpu_torch.policy import health_check as HC
from brpc_tpu_torch.policy import naming as NS
from brpc_tpu_torch.rpc import meta as M
from brpc_tpu_torch.rpc.channel import SocketMap

from testutil import wait_until

PKG = {"port": rpc, "ref": ref}
# (client package, server package): each backup and retry case runs both
WAYS = [("port", "ref"), ("ref", "port")]


def _policy_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(("health-check-", "ns-"))]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    before = set(_policy_threads())
    monkeypatch.setattr(HC, "health_check_interval_s", 0.02)
    monkeypatch.setattr(RHC, "health_check_interval_s", 0.02)
    fault.clear()
    servers = []
    yield servers
    fault.clear()
    for srv in servers:
        srv.stop()
        srv.join()

    def retired():
        # a client socket may fail (and mark its endpoint) just after
        # its server stopped: reset until no probe is left
        HC.reset_all()
        RHC.reset_all()
        time.sleep(0.05)
        return not (set(_policy_threads()) - before)

    assert wait_until(retired, timeout=5.0), \
        set(_policy_threads()) - before


def _service(mod, tag, *, fail_code=0, calls=None, lazy_s=0.0):
    class Node(mod.Service):
        NAME = "Node"

        @mod.method(request="json", response="json")
        def Q(self, cntl, req):
            if calls is not None:
                calls.append(tag)
            if lazy_s and (calls is None or len(calls) == 1):
                time.sleep(lazy_s)       # the first attempt dawdles
            if fail_code:
                cntl.set_failed(fail_code, f"{tag} down")
                return None
            return {"tag": tag, "got": req}

        @mod.method(request="json", response="json")
        def Slow(self, cntl, req):
            time.sleep(req["s"])
            return {"tag": tag}

        @mod.method(request="json", response="json")
        def Fields(self, cntl, req):
            cntl.response_user_fields = {"seen": "yes"}
            return {"tag": tag}

        @mod.method(request="json", response="json")
        def Sink(self, cntl, req):
            got = self.sunk = []
            done = self.sunk_closed = threading.Event()

            class H(mod.StreamHandler):
                def on_received_messages(self, stream, msgs):
                    got.extend(bytes(m) for m in msgs)

                def on_closed(self, stream):
                    done.set()

            cntl.accept_stream(H(), max_buf_size=req["buf"])
            return {}

    return Node()


def _start(servers, mod, tag, **kw):
    s = mod.Server(has_builtin_services=False) if mod is ref \
        else mod.Server()
    svc = _service(mod, tag, **kw)
    s.add_service(svc)
    s.start("127.0.0.1", 0)
    s.svc = svc
    servers.append(s)
    return s


def _addr(s):
    return f"127.0.0.1:{s.port}"


# ---- connection types (tests/test_connection_types.py) -------------------

class TestConnectionTypes:
    def test_single_reuses_one_connection(self, _clean):
        srv = _start(_clean, rpc, "a")
        before = srv.connection_count
        ch = rpc.Channel(_addr(srv), timeout_ms=5000,
                         connection_type="single")
        for i in range(10):
            assert ch.call_sync("Node", "Q", {"i": i},
                                serializer="json")["got"] == {"i": i}
        assert srv.connection_count - before <= 1

    def test_pooled_checkout_and_return(self, _clean):
        srv = _start(_clean, rpc, "a")
        ch = rpc.Channel(_addr(srv), timeout_ms=5000,
                         connection_type="pooled")
        ep, smap = str2endpoint(_addr(srv)), SocketMap.instance()
        for i in range(5):
            assert ch.call_sync("Node", "Q", {"i": i},
                                serializer="json")["got"] == {"i": i}
        assert smap.pooled_count(ep) == 1
        n, errs = 8, []
        barrier = threading.Barrier(n)

        def worker(i):
            try:
                barrier.wait(5)
                assert ch.call_sync("Node", "Q", {"i": i},
                                    serializer="json")["got"] == {"i": i}
            except Exception as e:
                errs.append(e)

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
        [t.start() for t in ts]
        [t.join(10) for t in ts]
        assert not errs, errs
        assert 1 <= smap.pooled_count(ep) <= n
        smap.drop(ep)
        assert smap.pooled_count(ep) == 0

    def test_short_closes_after_call(self, _clean):
        srv = _start(_clean, rpc, "a")
        ch = rpc.Channel(_addr(srv), timeout_ms=5000,
                         connection_type="short")
        ep = str2endpoint(_addr(srv))
        for i in range(3):
            assert ch.call_sync("Node", "Q", {"i": i},
                                serializer="json")["got"] == {"i": i}
        # deliberate closes must NOT mark the endpoint broken
        assert not HC.is_broken(ep)
        assert SocketMap.instance().pooled_count(ep) == 0

    def test_pooled_recovers_from_server_restart(self, _clean):
        srv = _start(_clean, rpc, "a")
        port = srv.port
        ch = rpc.Channel(f"127.0.0.1:{port}", timeout_ms=2000,
                         connection_type="pooled", max_retry=3)
        assert ch.call_sync("Node", "Q", {"a": 1},
                            serializer="json")["got"] == {"a": 1}
        srv.stop()
        srv.join()
        _clean.remove(srv)
        # the pooled connection is dead; a new server on the same port
        # must be reachable (dead free-list entries are skipped)
        srv2 = rpc.Server()
        srv2.add_service(_service(rpc, "b"))
        srv2.start("127.0.0.1", port)
        _clean.append(srv2)
        assert ch.call_sync("Node", "Q", {"b": 2},
                            serializer="json") == {"tag": "b",
                                                   "got": {"b": 2}}


# ---- retry and backup, both ways (tests/test_channel_matrix.py) ----------

@pytest.mark.parametrize("client,side", WAYS)
class TestRetryBackup:
    def test_no_retry_on_application_error(self, _clean, client, side):
        calls = []
        srv = _start(_clean, PKG[side], "s", fail_code=1234, calls=calls)
        mod = PKG[client]
        ch = mod.Channel(_addr(srv), options=mod.ChannelOptions(
            timeout_ms=2000, max_retry=3))
        with pytest.raises(Exception) as ei:
            ch.call_sync("Node", "Q", {}, serializer="json")
        assert ei.value.code == 1234
        assert len(calls) == 1

    def test_connection_refused_retries_then_fails(self, _clean, client,
                                                   side):
        mod = PKG[client]
        ch = mod.Channel("127.0.0.1:1", options=mod.ChannelOptions(
            timeout_ms=2000, max_retry=2))
        with pytest.raises(Exception) as ei:
            ch.call_sync("Node", "Q", {}, serializer="json")
        assert ei.value.code in (errors.ECONNREFUSED, errors.EFAILEDSOCKET)

    def test_custom_retry_policy_consulted(self, _clean, client, side):
        mod = PKG[client]
        consulted = []
        base = rpc.RetryPolicy if client == "port" \
            else ref.rpc.channel.RetryPolicy

        class Never(base):
            def do_retry(self, cntl):
                consulted.append(cntl.error_code)
                return False

        ch = mod.Channel("127.0.0.1:1", options=mod.ChannelOptions(
            timeout_ms=2000, max_retry=3, retry_policy=Never()))
        with pytest.raises(Exception):
            ch.call_sync("Node", "Q", {}, serializer="json")
        assert len(consulted) == 1   # failed once, the policy said stop

    def test_backup_fires_and_first_response_wins(self, _clean, client,
                                                  side):
        calls = []
        srv = _start(_clean, PKG[side], "lazy", calls=calls, lazy_s=0.6)
        mod = PKG[client]
        ch = mod.Channel(_addr(srv), options=mod.ChannelOptions(
            timeout_ms=5000, backup_request_ms=50))
        cntl = mod.Controller()
        t0 = time.monotonic()
        out = ch.call_sync("Node", "Q", {}, serializer="json", cntl=cntl)
        assert time.monotonic() - t0 < 0.5    # did not wait for the first
        assert out["tag"] == "lazy" and len(calls) >= 2
        assert cntl.retried_count == 1

    def test_backup_lands_on_the_other_replica(self, _clean, client, side):
        calls = []
        slow = _start(_clean, PKG[side], "slow", calls=calls, lazy_s=0.5)
        fast = _start(_clean, PKG[side], "fast")
        mod = PKG[client]
        ch = mod.Channel(f"list://{_addr(slow)},{_addr(fast)}",
                         options=mod.ChannelOptions(
                             timeout_ms=5000, backup_request_ms=30,
                             load_balancer="rr"))
        cntl = mod.Controller()
        out = ch.call_sync("Node", "Q", {}, serializer="json", cntl=cntl)
        assert out["tag"] == "fast" and calls == ["slow"]
        assert cntl.retried_count == 1 and cntl.remote_side == _addr(fast)


def test_max_retry_zero_disables_backups(_clean):
    calls = []
    srv = _start(_clean, rpc, "lazy", calls=calls, lazy_s=0.2)
    ch = rpc.Channel(_addr(srv), timeout_ms=5000, backup_request_ms=20,
                     max_retry=0)
    cntl = rpc.Controller()
    assert ch.call_sync("Node", "Q", {}, serializer="json",
                        cntl=cntl)["tag"] == "lazy"
    assert calls == ["lazy"] and cntl.retried_count == 0


# ---- a list:// cluster of port servers -----------------------------------

class TestCluster:
    def test_rr_spreads_and_feeds_the_breaker(self, _clean):
        servers = [_start(_clean, rpc, f"n{i}") for i in range(3)]
        eps = [str2endpoint(_addr(s)) for s in servers]
        cb = CB.global_breaker()
        before = {ep: cb._short[ep].samples if ep in cb._short else 0
                  for ep in eps}
        ch = rpc.Channel("list://" + ",".join(map(_addr, servers)),
                         timeout_ms=5000, load_balancer="rr")
        tags = [ch.call_sync("Node", "Q", {}, serializer="json")["tag"]
                for _ in range(30)]
        assert sorted(set(tags)) == ["n0", "n1", "n2"]
        assert all(tags.count(t) == 10 for t in set(tags))
        for ep in eps:
            assert cb._short[ep].samples - before[ep] == 10
        for ep in eps:
            cb.reset(ep)

    def test_failing_replica_is_isolated_and_routed_around(
            self, _clean, monkeypatch):
        # a long hold: the isolation outlasts the calls below
        monkeypatch.setattr(CB.CircuitBreaker, "BASE_HOLD_S", 5.0)
        bad = _start(_clean, rpc, "bad", fail_code=1234)
        good = _start(_clean, rpc, "good")
        bad_ep = str2endpoint(_addr(bad))
        ch = rpc.Channel(f"list://{_addr(bad)},{_addr(good)}",
                         timeout_ms=5000, load_balancer="rr")
        fails = 0
        for _ in range(200):
            try:
                ch.call_sync("Node", "Q", {}, serializer="json")
            except errors.RpcError as e:
                assert e.code == 1234
                fails += 1
            if HC.is_broken(bad_ep):
                break
        assert HC.is_broken(bad_ep), f"never isolated ({fails} failures)"
        assert fails >= CB.CircuitBreaker.MIN_SAMPLES
        for _ in range(10):
            assert ch.call_sync("Node", "Q", {},
                                serializer="json")["tag"] == "good"
        CB.global_breaker().reset(bad_ep)

    @pytest.mark.parametrize("client", ["port", "ref"])
    def test_breaker_isolates_by_endpoint_not_method(self, _clean, client):
        """Both packages' breakers: after a baseline of 40 fast calls of
        one method, the first 100 ms call of another method on the same
        server trips latency isolation (the long window is mature, the
        short one already has its samples)."""
        mod = PKG[client]
        hc = HC if client == "port" else RHC
        parse = str2endpoint if client == "port" \
            else ref.butil.endpoint.str2endpoint
        srv = _start(_clean, PKG[client], "m")
        ep = parse(_addr(srv))
        ch = mod.Channel(f"list://{_addr(srv)}", timeout_ms=5000)
        for _ in range(40):
            ch.call_sync("Node", "Q", {}, serializer="json")
        assert not hc.is_broken(ep)
        ch.call_sync("Node", "Slow", {"s": 0.1}, serializer="json")
        assert hc.is_broken(ep)
        breaker = CB.global_breaker() if client == "port" \
            else ref.policy.circuit_breaker.global_breaker()
        breaker.reset(ep)

    def test_request_code_routes_consistently(self, _clean):
        servers = [_start(_clean, rpc, f"n{i}") for i in range(3)]
        ch = rpc.Channel("list://" + ",".join(map(_addr, servers)),
                         timeout_ms=5000, load_balancer="c_murmurhash")
        seen = {}
        for code in range(12):
            for _ in range(2):
                cntl = rpc.Controller()
                cntl.request_code = code
                tag = ch.call_sync("Node", "Q", {}, serializer="json",
                                   cntl=cntl)["tag"]
                assert seen.setdefault(code, tag) == tag
        assert len(set(seen.values())) > 1

    def test_empty_cluster_fails_with_enodata(self, _clean):
        ch = rpc.Channel("list://", timeout_ms=1000)
        with pytest.raises(errors.RpcError) as ei:
            ch.call_sync("Node", "Q", {}, serializer="json")
        assert ei.value.code == errors.ENODATA

    def test_file_naming_reloads(self, _clean, monkeypatch):
        monkeypatch.setattr(NS.FileNamingService, "interval_s", 0.05)
        a = _start(_clean, rpc, "a")
        b = _start(_clean, rpc, "b")
        fd, path = tempfile.mkstemp(suffix=".list")
        with os.fdopen(fd, "w") as f:
            f.write(f"# one replica\n{_addr(a)}\n")
        ch = rpc.Channel(f"file://{path}", timeout_ms=5000)
        try:
            assert ch.call_sync("Node", "Q", {},
                                serializer="json")["tag"] == "a"
            with open(path + ".tmp", "w") as f:
                f.write(f"{_addr(b)} 2\n")
            os.replace(path + ".tmp", path)
            assert wait_until(lambda: ch.call_sync(
                "Node", "Q", {}, serializer="json")["tag"] == "b",
                timeout=5.0)
            assert [n.weight for n in ch._lb.servers()] == [2]
        finally:
            ch.close()
            ch._ns_thread.join(5)
            os.unlink(path)


# ---- the transport fault sites -------------------------------------------

class TestFaultSites:
    def test_refused_connect_retries_onto_the_other_replica(self, _clean):
        s0 = _start(_clean, rpc, "n0")
        s1 = _start(_clean, rpc, "n1")
        ch = rpc.Channel(f"list://{_addr(s0)},{_addr(s1)}",
                         timeout_ms=5000, load_balancer="rr")
        plan = fault.FaultPlan(1).on(
            fault.CONNECT, fault.REFUSE, times=1,
            match=lambda ctx: ctx.get("port") == s0.port)
        cntl = rpc.Controller()
        with fault.injected(plan):
            out = ch.call_sync("Node", "Q", {}, serializer="json",
                               cntl=cntl)
        assert plan.injected == {fault.CONNECT: 1}
        assert out["tag"] == "n1" and cntl.retried_count == 1

    @pytest.mark.parametrize("kind", [fault.RESET, fault.OVERCROWD,
                                      fault.PARTIAL])
    def test_failed_write_retries(self, _clean, kind):
        srv = _start(_clean, rpc, "a")
        ch = rpc.Channel(_addr(srv), timeout_ms=5000)
        assert ch.call_sync("Node", "Q", {}, serializer="json")
        plan = fault.FaultPlan(2).on(fault.SEND, kind, times=1)
        cntl = rpc.Controller()
        with fault.injected(plan):
            out = ch.call_sync("Node", "Q", {"k": 1}, serializer="json",
                               cntl=cntl)
        assert plan.injected == {fault.SEND: 1}
        assert out == {"tag": "a", "got": {"k": 1}}
        assert cntl.retried_count == 1

    def test_dropped_message_runs_into_the_deadline(self, _clean):
        srv = _start(_clean, rpc, "a")
        ch = rpc.Channel(_addr(srv), timeout_ms=300, max_retry=0)
        plan = fault.FaultPlan(3).on(fault.RECV, fault.DROP, times=1)
        cntl = rpc.Controller()
        cntl.user_fields = {"k": "v"}    # a full meta: the Python path
        with fault.injected(plan):
            with pytest.raises(errors.RpcError) as ei:
                ch.call_sync("Node", "Fields", {}, serializer="json",
                             cntl=cntl)
        assert ei.value.code == errors.ERPCTIMEDOUT
        assert plan.injected == {fault.RECV: 1}
        assert ch.call_sync("Node", "Fields", {},
                            serializer="json") == {"tag": "a"}

    def _stream_through(self, servers, plan, n=20, size=100, bursts=1,
                        before_close=None):
        """``bursts`` bursts of n messages of ``size`` bytes under
        ``plan``, each written once the server has read the previous
        one, the writer's window larger than all of them, the reader
        acknowledging every 200 bytes: the server must receive each
        once, in order.  ``before_close(stream)`` runs once every burst
        is read, before the writer closes (a closed stream leaves the
        registry, and feedback still in flight to it is dropped).
        Returns the writer's stream."""
        srv = _start(servers, rpc, "sink")
        ch = rpc.Channel(_addr(srv), timeout_ms=5000)
        msgs = [bytes([i]) * size for i in range(n)]
        with fault.injected(plan):
            cntl = rpc.Controller()
            s = rpc.stream_create(cntl, None,
                                  max_buf_size=2 * bursts * n * size)
            ch.call_sync("Node", "Sink", {"buf": 400}, serializer="json",
                         cntl=cntl)
            for b in range(1, bursts + 1):
                for m in msgs:
                    s.write(m, timeout_s=5.0)
                assert srv.svc.sunk_closed.wait(0.01) is False
                assert wait_until(lambda: len(srv.svc.sunk) == b * n,
                                  timeout=10)
            if before_close is not None:
                before_close(s)
            s.close()
            assert srv.svc.sunk_closed.wait(10)
        assert srv.svc.sunk == msgs * bursts
        return s

    def test_duplicated_data_frame_is_delivered_once(self, _clean):
        plan = fault.FaultPlan(4).on(
            fault.FRAME, fault.DUP, times=1,
            match=lambda ctx: ctx["msg_type"] == M.MSG_STREAM_DATA)
        self._stream_through(_clean, plan)
        assert plan.injected == {fault.FRAME: 1}

    def test_dropped_feedback_frame_is_counted(self, _clean):
        from brpc_tpu_torch.bvar import find_exposed
        c0 = (find_exposed("fault_injected_stream_frame") or
              fault._counter(fault.FRAME)).get_value()
        plan = fault.FaultPlan(5).on(
            fault.FRAME, fault.DROP, times=1,
            match=lambda ctx: ctx["msg_type"] == M.MSG_STREAM_FEEDBACK)

        def credit_returned(s):
            # a later feedback arrived (on the client's IO thread); the
            # second burst makes one certain, as for the lost feedback
            # below
            assert wait_until(lambda: s._remote_consumed > 0, timeout=5)

        self._stream_through(_clean, plan, bursts=2,
                             before_close=credit_returned)
        assert plan.injected == {fault.FRAME: 1}
        assert find_exposed("fault_injected_stream_frame").get_value() \
            == c0 + 1

    def test_lost_feedback_returns_credit_at_the_next(self, _clean):
        """The first burst's reads send at least one feedback, the one
        dropped; a reader late to its first delivery reads the rest of
        a burst in one batch and sends no other.  A second burst,
        written once the first is read, sends the next feedback, and
        the writer waits for it before it closes."""
        plan = fault.FaultPlan(6).on(fault.FEEDBACK, fault.DROP, times=1)

        def credit_returned(s):
            # the next feedback arrived (read on the client's IO thread)
            assert wait_until(lambda: s._remote_consumed > 0, timeout=5)

        self._stream_through(_clean, plan, bursts=2,
                             before_close=credit_returned)
        assert plan.injected == {fault.FEEDBACK: 1}


# ---- exactly once under racing backups and retries ------------------------

def test_claim_backup_and_claim_retry_take_distinct_attempts():
    """Backups and retries racing on one controller: every successful
    claim takes its own attempt number, under a short switch interval."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    cntl = rpc.Controller()
    wins = []

    def claim(k):
        for _ in range(500):
            if k % 2:
                wins.append(cntl.claim_backup())
            else:
                wins.append(cntl.claim_retry(cntl.current_attempt))

    try:
        ts = [threading.Thread(target=claim, args=(k,)) for k in range(8)]
        [t.start() for t in ts]
        [t.join(30) for t in ts]
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert cntl.current_attempt == sum(wins) == cntl.retried_count


def test_backups_racing_retries_complete_each_call_once(_clean):
    """More caller threads than cores, a 1 ms backup on every call and
    seeded resets of 3% of the writes (each reset fails every call on
    the shared connection): every call completes exactly once, a
    success with its own response, a failure with a transport error
    once its attempts are spent, and none waits out its deadline (two
    attempts of one call binding one socket out of order must not hide
    the live attempt from the socket's failure)."""
    srv = _start(_clean, rpc, "a")
    ch = rpc.Channel(_addr(srv), timeout_ms=10_000, backup_request_ms=1,
                     max_retry=3)
    n_threads, per = 2 * (os.cpu_count() or 4), 8
    done = collections.Counter()
    bad, ok = [], []
    mu = threading.Lock()

    def caller(k):
        for i in range(per):
            key = f"{k}.{i}"
            ev = threading.Event()

            def on_done(cntl, key=key, ev=ev):
                with mu:
                    done[key] += 1
                    if not cntl.failed() and \
                            cntl.response["got"] == {"k": key}:
                        ok.append(key)
                    elif cntl.error_code not in (errors.EFAILEDSOCKET,
                                                 errors.ECONNREFUSED):
                        bad.append((key, cntl.error_code, cntl.response))
                ev.set()

            ch.call("Node", "Q", {"k": key}, serializer="json",
                    done=on_done)
            ev.wait(15)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    plan = fault.FaultPlan(8).on(fault.SEND, fault.RESET, times=-1,
                                 prob=0.03)
    try:
        with fault.injected(plan):
            ts = [threading.Thread(target=caller, args=(k,))
                  for k in range(n_threads)]
            [t.start() for t in ts]
            [t.join(60) for t in ts]
            assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    time.sleep(0.1)                   # a late stale completion would land
    assert not bad, bad[:3]
    assert len(done) == n_threads * per and set(done.values()) == {1}
    assert plan.injected.get(fault.SEND, 0) > 0
    assert len(ok) > len(done) // 2
