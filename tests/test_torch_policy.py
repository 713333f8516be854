"""The port's client policies held against the JAX package's.

  * balancer parity: rr, wrr, c_murmurhash, c_md5, c_ketama and
    prefix_affinity over the same weighted server list pick the same
    endpoint for the same seeded request codes and exclude sets, and the
    consistent-hash rings are equal point for point (IPv6 and unix
    endpoints included); random, wr and la draw alike under one
    ``random`` seed; ``prefix_fingerprint`` is the reference's;
  * breaker parity: one seeded sequence of call results gives the same
    isolation decision, isolation count and hold at every step, and
    ``admit`` agrees under a seeded clock and ramp;
    ``ClusterRecoverPolicy.can_isolate`` gives the same table;
  * counterparts of ``tests/test_policy.py``'s balancer, naming, health
    check, breaker and ketama cases;
  * package separation: a port verdict never reaches the JAX package's
    health check or breaker, nor the reverse.

Endpoints are compared across packages by ``str()``: the two ``EndPoint``
classes differ.  Every test leaves no health-check probe or naming
thread behind.
"""
import collections
import os
import random
import socket
import tempfile
import threading

import numpy as np
import pytest

from brpc_tpu.butil import endpoint as REP
from brpc_tpu.policy import circuit_breaker as RCB
from brpc_tpu.policy import cluster_recover_policy as RCR
from brpc_tpu.policy import health_check as RHC
from brpc_tpu.policy import load_balancer as RLB
from brpc_tpu_torch.butil.endpoint import EndPoint, str2endpoint
from brpc_tpu_torch.policy import circuit_breaker as CB
from brpc_tpu_torch.policy import cluster_recover_policy as CR
from brpc_tpu_torch.policy import health_check as HC
from brpc_tpu_torch.policy import load_balancer as LB
from brpc_tpu_torch.policy import naming as NS

from testutil import wait_until

SEEDS = range(3)
# one weighted server list for both packages (parsed by each package)
SERVERS = (("10.1.0.1:8000", 1), ("10.1.0.2:8000", 3), ("10.1.0.3:8001", 2),
           ("10.1.0.4:9000", 1))
RING_SERVERS = SERVERS + (("[::1]:8000", 2), ("unix:/tmp/replica.sock", 1))


def _policy_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(("health-check-", "ns-"))]


@pytest.fixture(autouse=True)
def _clean_policy_state(monkeypatch):
    """A fast probe for this file, and after each test: both packages'
    health checks reset and every probe or naming thread the test
    started gone (bounded wait)."""
    before = set(_policy_threads())
    monkeypatch.setattr(HC, "health_check_interval_s", 0.02)
    monkeypatch.setattr(RHC, "health_check_interval_s", 0.02)
    yield
    HC.reset_all()
    RHC.reset_all()
    ok = wait_until(lambda: not (set(_policy_threads()) - before),
                    timeout=5.0)
    assert ok, f"threads left running: {set(_policy_threads()) - before}"


def _nodes(mod, parse, servers=SERVERS):
    return [mod.ServerNode(parse(a), w) for a, w in servers]


def _pair(name, servers=SERVERS):
    ref = RLB.create_load_balancer(name)
    ref.reset_servers(_nodes(RLB, REP.str2endpoint, servers))
    port = LB.create_load_balancer(name)
    port.reset_servers(_nodes(LB, str2endpoint, servers))
    return ref, port


def _requests(seed, n=200, servers=SERVERS):
    """Seeded (request code, exclude-set addresses) pairs; codes include
    negatives (hash()-derived codes are)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        code = int(rng.integers(-2**63, 2**63 - 1))
        k = int(rng.integers(0, 3))
        excl = sorted({servers[int(i)][0]
                       for i in rng.integers(0, len(servers), k)})
        out.append((code, excl))
    return out


def _picks(lb, parse, reqs):
    return [str(lb.select_server(exclude={parse(a) for a in excl},
                                 request_code=code))
            for code, excl in reqs]


class TestBalancerParity:
    @pytest.mark.parametrize("name", ["rr", "wrr", "c_murmurhash", "c_md5",
                                      "c_ketama", "prefix_affinity"])
    @pytest.mark.parametrize("seed", SEEDS)
    def test_same_picks(self, name, seed):
        ref, port = _pair(name)
        reqs = _requests(seed)
        assert _picks(port, str2endpoint, reqs) == \
            _picks(ref, REP.str2endpoint, reqs)

    @pytest.mark.parametrize("name", ["c_murmurhash", "c_md5", "c_ketama",
                                      "prefix_affinity"])
    def test_ring_equal_point_for_point(self, name):
        ref, port = _pair(name, RING_SERVERS)
        assert [(k, str(ep)) for k, ep in port._ring] == \
            [(k, str(ep)) for k, ep in ref._ring]
        reqs = _requests(7, servers=RING_SERVERS)
        assert _picks(port, str2endpoint, reqs) == \
            _picks(ref, REP.str2endpoint, reqs)

    @pytest.mark.parametrize("name", ["random", "wr"])
    @pytest.mark.parametrize("seed", SEEDS)
    def test_random_draws_alike_under_one_seed(self, name, seed):
        ref, port = _pair(name)
        reqs = _requests(seed, n=100)
        random.seed(seed)
        want = _picks(ref, REP.str2endpoint, reqs)
        random.seed(seed)
        assert _picks(port, str2endpoint, reqs) == want

    @pytest.mark.parametrize("seed", SEEDS)
    def test_la_draws_alike_under_one_seed(self, seed):
        """la's weights follow its feedback: the same seeded latencies
        and errors, fed to both, give the same draws."""
        ref, port = _pair("la")
        rng = np.random.default_rng(seed)
        fb = [(int(rng.integers(0, 4)) == 0, int(rng.integers(50, 50_000)))
              for _ in range(150)]

        def run(lb):
            random.seed(seed)
            out = []
            for err, lat in fb:
                ep = lb.select_server()
                out.append(str(ep))
                lb.feedback(ep, 1009 if err else 0, lat)
            return out

        assert run(port) == run(ref)

    @pytest.mark.parametrize("seed", SEEDS)
    def test_prefix_fingerprint(self, seed):
        rng = np.random.default_rng(seed)
        for n in (0, 1, 15, 16, 17, 200):
            prompt = rng.integers(0, 2**31, n).tolist()
            for chunk in (4, 16):
                assert LB.prefix_fingerprint(prompt, chunk) == \
                    RLB.prefix_fingerprint(prompt, chunk)

    def test_select_for_prompt_and_placement(self):
        ref, port = _pair("prefix_affinity", RING_SERVERS)
        rng = np.random.default_rng(3)
        for _ in range(50):
            p = rng.integers(0, 32768, 40).tolist()
            assert str(port.select_for_prompt(p)) == \
                str(ref.select_for_prompt(p))
            code = LB.prefix_fingerprint(p)
            assert [str(e) for e in port.placement(code, 3)] == \
                [str(e) for e in ref.placement(code, 3)]

    def test_migration_on_rebalance_is_not_ported(self):
        """Ported since the KV migration slice (the name is the earlier
        check's): a ring change fires the hook for the same remapped
        prefixes, old and new owners in both packages."""
        ref, port = _pair("prefix_affinity", RING_SERVERS[:2])
        calls = {"ref": [], "port": []}
        for key, lb in (("ref", ref), ("port", port)):
            lb.migrate_on_rebalance(
                lambda t, o, n, key=key: calls[key].append(
                    (tuple(t), str(o), str(n))))
        rng = np.random.default_rng(4)
        for _ in range(32):
            p = rng.integers(0, 32768, 20).tolist()
            assert str(port.select_for_prompt(p)) == \
                str(ref.select_for_prompt(p))
        ref.add_server(_nodes(RLB, REP.str2endpoint, RING_SERVERS[2:3])[0])
        port.add_server(_nodes(LB, str2endpoint, RING_SERVERS[2:3])[0])
        assert ref.join_migrations(10) and port.join_migrations(10)
        assert calls["port"] and sorted(calls["port"]) == \
            sorted(calls["ref"])
        assert port.remaps == ref.remaps == len(calls["port"])
        assert port.remap_migrations == port.remaps


def _breaker_trace(mod, hc, seq, ep):
    """Feed ``seq`` to a fresh breaker of ``mod``; return per step the
    isolation decision, the isolation count and the hold.  The breaker's
    mark goes to a list, not to the health check."""
    cb = mod.CircuitBreaker()
    marks = []
    cb.mark_as_broken = lambda e: marks.append(e)
    out = []
    for code, lat in seq:
        n = len(marks)
        cb.on_call_end(ep, code, lat)
        out.append((len(marks) > n, cb.isolation_count(ep),
                    cb._hold_s(ep)))
    return out


class TestBreakerParity:
    @pytest.mark.parametrize("seed", SEEDS)
    @pytest.mark.parametrize("shape", ["errors", "latency"])
    def test_same_decisions(self, seed, shape):
        rng = np.random.default_rng(seed)
        seq = []
        for i in range(400):
            if shape == "errors":
                # bursts of failures over a healthy baseline
                bad = (i // 40) % 2 == 1 and rng.random() < 0.7
                seq.append((1009 if bad else 0,
                            int(rng.integers(100, 2000))))
            else:
                # a healthy baseline, then a replica 5-8x slower
                slow = i >= 120 and (i // 60) % 2 == 0
                base = int(rng.integers(800, 1200))
                seq.append((0, base * (int(rng.integers(5, 9)) if slow
                                       else 1)))
        got = _breaker_trace(CB, HC, seq, EndPoint("10.2.0.1", 1))
        want = _breaker_trace(RCB, RHC, seq, REP.EndPoint("10.2.0.1", 1))
        assert got == want
        assert any(step[0] for step in got), "the sequence never isolated"

    @pytest.mark.parametrize("seed", SEEDS)
    def test_admit_agrees_under_a_seeded_ramp(self, seed, monkeypatch):
        """``on_revived`` then ``admit`` at seeded instants across the
        ramp, under one ``random`` seed: the same verdicts."""
        rng = np.random.default_rng(seed)
        instants = np.sort(rng.uniform(0.0, 3.5, 60)).tolist()

        class Clock:
            now = 1000.0

            @classmethod
            def monotonic(cls):
                return cls.now

        def run(mod, ep):
            monkeypatch.setattr(mod, "time", Clock)
            cb = mod.CircuitBreaker()
            Clock.now = 1000.0
            cb.on_revived(ep)
            random.seed(seed)
            out = []
            for t in instants:
                Clock.now = 1000.0 + t
                out.append(cb.admit(ep))
            return out

        got = run(CB, EndPoint("10.2.0.2", 2))
        want = run(RCB, REP.EndPoint("10.2.0.2", 2))
        assert got == want
        assert not all(got) and any(got)

    def test_cluster_recover_table(self):
        cases = [(mw, r) for mw in (0, 1, 2, 3) for r in (0.0, 0.3, 0.5)]
        got, want = [], []
        for mw, r in cases:
            p, q = CR.ClusterRecoverPolicy(mw, r), \
                RCR.ClusterRecoverPolicy(mw, r)
            for total in range(0, 7):
                for healthy in range(0, total + 1):
                    got.append((p.can_isolate(total, healthy),
                                p.in_recovery()))
                    want.append((q.can_isolate(total, healthy),
                                 q.in_recovery()))
        assert got == want

    def test_cluster_guard_vetoes_the_last_healthy_server(self):
        lb = LB.create_load_balancer("rr")
        eps = [EndPoint("10.2.0.9", p) for p in (1, 2)]
        lb.reset_servers([LB.ServerNode(e) for e in eps])
        guard = CR._ChannelClusterGuard(CR.ClusterRecoverPolicy(1), lb)
        assert guard.can_isolate(eps[0])
        HC._broken[eps[0]] = 0.0       # one already isolated
        try:
            assert not guard.can_isolate(eps[1])
            assert guard.can_isolate(eps[0])   # re-isolating is free
        finally:
            HC.reset(eps[0])


# ---- counterparts of tests/test_policy.py --------------------------------

def _pnodes(*ports, weight=1):
    return [LB.ServerNode(EndPoint("10.0.0.1", p), weight) for p in ports]


class TestLoadBalancers:
    def test_rr_uniform(self):
        lb = LB.create_load_balancer("rr")
        lb.reset_servers(_pnodes(1, 2, 3))
        picks = collections.Counter(str(lb.select_server())
                                    for _ in range(300))
        assert all(c == 100 for c in picks.values())

    def test_wrr_respects_weights(self):
        lb = LB.create_load_balancer("wrr")
        lb.reset_servers([LB.ServerNode(EndPoint("h", 1), 3),
                          LB.ServerNode(EndPoint("h", 2), 1)])
        picks = collections.Counter(lb.select_server().port
                                    for _ in range(400))
        assert picks[1] == 300 and picks[2] == 100

    def test_consistent_hash_sticky(self):
        lb = LB.create_load_balancer("c_murmurhash")
        lb.reset_servers(_pnodes(1, 2, 3, 4, 5))
        ep1 = lb.select_server(request_code=12345)
        for _ in range(10):
            assert lb.select_server(request_code=12345) == ep1
        keys = list(range(2000))
        before = {k: lb.select_server(request_code=k) for k in keys}
        lb.remove_server(before[0])
        moved = sum(1 for k in keys
                    if lb.select_server(request_code=k) != before[k])
        assert moved < len(keys) * 0.5  # only keys of the removed node move

    @pytest.mark.parametrize("seed", SEEDS)
    def test_la_shifts_from_slow_server(self, seed):
        """The reference's bound (fast picked more than 3x the slow one
        after 200 fed calls), under seeded draws."""
        random.seed(seed)
        lb = LB.create_load_balancer("la")
        lb.reset_servers(_pnodes(1, 2))
        fast, slow = EndPoint("10.0.0.1", 1), EndPoint("10.0.0.1", 2)
        for _ in range(200):
            ep = lb.select_server()
            lb.feedback(ep, 0, 100 if ep == fast else 100_000)
        picks = collections.Counter(str(lb.select_server())
                                    for _ in range(200))
        assert picks[str(fast)] > picks[str(slow)] * 3

    def test_exclude(self):
        lb = LB.create_load_balancer("rr")
        lb.reset_servers(_pnodes(1, 2))
        only = {lb.select_server(exclude={EndPoint("10.0.0.1", 1)})
                for _ in range(10)}
        assert only == {EndPoint("10.0.0.1", 2)}

    def test_unknown_balancer_and_excluded_servers(self):
        with pytest.raises(KeyError):
            LB.create_load_balancer("nope")
        ex = LB.ExcludedServers(capacity=3)
        for i in range(10):
            ex.add(EndPoint("10.0.0.%d" % i, 80))
        assert len(ex) == 3 and EndPoint("10.0.0.0", 80) in ex
        assert EndPoint("10.0.0.9", 80) not in ex.as_set()


class TestNaming:
    def test_list_ns(self):
        nodes = NS.ListNamingService("a:1,b:2(5)").get_servers()
        assert nodes[0].endpoint == EndPoint("a", 1)
        assert nodes[1].weight == 5

    def test_list_ns_tags_match_the_reference(self):
        from brpc_tpu.policy.naming import ListNamingService as RList
        param = "a:1 0/2,b:2(3) 1/2,[::1]:7,unix:/tmp/s.sock"
        got = [(str(n.endpoint), n.weight, n.tag)
               for n in NS.ListNamingService(param).get_servers()]
        want = [(str(n.endpoint), n.weight, n.tag)
                for n in RList(param).get_servers()]
        assert got == want

    def test_file_ns(self):
        with tempfile.NamedTemporaryFile("w", suffix=".list",
                                         delete=False) as f:
            f.write("# cluster\nhost1:100\nhost2:200 7\nhost3:300 0/2\n")
            path = f.name
        try:
            nodes = NS.FileNamingService(path).get_servers()
            assert len(nodes) == 3
            assert nodes[1].weight == 7 and nodes[2].tag == "0/2"
        finally:
            os.unlink(path)

    def test_start_naming_service_pushes_to_lb(self):
        lb = LB.create_load_balancer("rr")
        t = NS.start_naming_service("list://x:1,y:2", lb)
        assert lb.server_count() == 2
        t.stop()
        t.join(5)

    def test_dns_ns_resolves_localhost(self):
        nodes = NS.DnsNamingService("localhost:81").get_servers()
        assert nodes and all(n.endpoint.port == 81 for n in nodes)

    @pytest.mark.parametrize("scheme,item", [
        ("remotefile", "item 6"), ("discovery", "item 6"),
        ("consul", "item 6"), ("nacos", "item 6"), ("ici", "item 9")])
    def test_later_schemes_raise_naming_their_item(self, scheme, item):
        lb = LB.create_load_balancer("rr")
        with pytest.raises(NotImplementedError, match=item):
            NS.start_naming_service(f"{scheme}://x", lb)


class TestHealthCheck:
    def test_mark_and_revive(self):
        srv = socket.socket()
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        ep = EndPoint("127.0.0.1", srv.getsockname()[1])
        try:
            HC.mark_broken(ep)
            assert HC.is_broken(ep) and ep in HC.broken_endpoints()
            assert wait_until(lambda: not HC.is_broken(ep), timeout=5.0), \
                "probe did not revive"
        finally:
            srv.close()

    def test_hold_delays_revival_and_revival_starts_the_ramp(self):
        srv = socket.socket()
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        ep = EndPoint("127.0.0.1", srv.getsockname()[1])
        cb = CB.global_breaker()
        try:
            HC.mark_broken(ep, hold_s=0.3)
            assert not wait_until(lambda: not HC.is_broken(ep),
                                  timeout=0.15)
            assert wait_until(lambda: not HC.is_broken(ep), timeout=5.0)
            assert ep in cb._recovering_until
        finally:
            cb.reset(ep)
            srv.close()

    def test_reset_all_retires_probes(self):
        ep = EndPoint("127.0.0.1", 1)     # nothing listens: never revives
        HC.mark_broken(ep)
        assert HC.is_broken(ep) and HC.probe_threads()
        HC.reset_all()
        assert not HC.is_broken(ep)
        assert wait_until(lambda: not HC.probe_threads(), timeout=5.0)

    def test_non_tcp_endpoints_are_never_marked(self):
        ep = str2endpoint("unix:/tmp/none.sock")
        HC.mark_broken(ep)
        assert not HC.is_broken(ep)


class TestCircuitBreaker:
    def test_isolates_after_errors(self):
        cb = CB.CircuitBreaker()
        ep = EndPoint("10.9.9.9", 1)
        for _ in range(40):
            cb.on_call_end(ep, 500)
        # isolation marks broken through the port's health check
        assert HC.is_broken(ep)
        HC.reset(ep)

    def test_latency_isolation_without_errors(self):
        cb = CB.CircuitBreaker()
        marks = []
        cb.mark_as_broken = marks.append
        ep = EndPoint("10.9.9.9", 2)
        for _ in range(40):
            cb.on_call_end(ep, 0, 1000)
        assert not marks
        first = None
        for i in range(20):
            cb.on_call_end(ep, 0, 6000)
            if marks and first is None:
                first = i
        # the short EMA crosses 4x the frozen 1 ms baseline at the third
        # 6 ms sample (0.7 decay)
        assert first == 2
        assert set(marks) == {ep}


class TestKetamaLB:
    def _lb(self, n=4):
        lb = LB.create_load_balancer("c_ketama")
        assert isinstance(lb, LB.KetamaLB)
        lb.reset_servers([LB.ServerNode(str2endpoint(f"10.0.0.{i}:80"))
                          for i in range(n)])
        return lb

    def test_stable_mapping(self):
        lb = self._lb()
        picks = {code: lb.select_server(request_code=code)
                 for code in range(200)}
        for code, ep in picks.items():
            assert lb.select_server(request_code=code) == ep

    def test_ring_density(self):
        """160 points per unit weight (40 md5 groups x 4 u32 splits)."""
        assert len(self._lb(n=3)._ring) == 3 * 160

    def test_minimal_remap_on_removal(self):
        lb = self._lb(n=4)
        before = {c: lb.select_server(request_code=c) for c in range(400)}
        lb.remove_server(str2endpoint("10.0.0.3:80"))
        moved = sum(1 for c in range(400)
                    if before[c] != lb.select_server(request_code=c)
                    and str(before[c]) != "10.0.0.3:80")
        assert moved == 0, f"{moved} keys moved off surviving servers"

    def test_distribution_roughly_even(self):
        lb = self._lb(n=4)
        counts = collections.Counter(lb.select_server(request_code=c)
                                     for c in range(4000))
        assert len(counts) == 4
        assert min(counts.values()) > 4000 / 4 * 0.5   # no starved server


def test_circuit_breaker_hold_never_overflows():
    """Thousands of isolations must not overflow the exponential hold,
    and the mark path goes through."""
    cb = CB.CircuitBreaker()
    ep = EndPoint("127.0.0.1", 65001)
    with cb._mu:
        cb._isolation_count[ep] = 5000
    assert cb._hold_s(ep) == cb.MAX_HOLD_S
    cb.mark_as_broken(ep)
    assert HC.is_broken(ep)


class TestPackageSeparation:
    def test_health_check_tables_are_separate(self):
        # nothing listens on port 1: neither probe revives its endpoint
        HC.mark_broken(EndPoint("127.0.0.1", 1))
        assert HC.is_broken(EndPoint("127.0.0.1", 1))
        assert not RHC.is_broken(REP.EndPoint("127.0.0.1", 1))
        HC.reset_all()
        RHC.mark_broken(REP.EndPoint("127.0.0.1", 1))
        assert RHC.is_broken(REP.EndPoint("127.0.0.1", 1))
        assert not HC.is_broken(EndPoint("127.0.0.1", 1))

    def test_breakers_are_separate(self):
        ep = EndPoint("10.3.0.3", 3)
        CB.global_breaker().on_socket_failed(ep)
        try:
            assert CB.global_breaker() is not RCB.global_breaker()
            assert CB.global_breaker().isolation_count(ep) >= 1
            assert RCB.global_breaker().isolation_count(
                REP.EndPoint("10.3.0.3", 3)) == 0
        finally:
            with CB.global_breaker()._mu:
                CB.global_breaker()._isolation_count.pop(ep, None)
