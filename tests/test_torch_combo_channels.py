"""The port's combo channels held against the JAX package's.

  * counterparts of every case in ``tests/test_combo_channels.py`` and
    ``tests/test_combo_matrix.py`` (ParallelChannel broadcast, mapper,
    merger, skip and fail limit; SelectiveChannel failover;
    PartitionChannel over tagged servers), except the collective
    lowering's case, which the port does not have;
  * ``DynamicPartitionChannel`` as in ``tests/test_dynpart_auth_mongo.py``;
  * ``PartitionChannel.call_partitioned`` rotating a failed partition
    onto its other replica;
  * a port ``ParallelChannel`` and ``PartitionChannel`` over one port
    server and one JAX-package server: the merged result equals the JAX
    package's ``ParallelChannel`` over the same two.

Every test stops its servers and naming threads and resets both
packages' health checks.
"""
import os
import tempfile
import threading
import time

import pytest

import brpc_tpu as ref
from brpc_tpu.policy import health_check as RHC
import brpc_tpu_torch.rpc as rpc
from brpc_tpu_torch import errors
from brpc_tpu_torch.policy import health_check as HC
from brpc_tpu_torch.rpc.combo_channels import (CallMapper, ParallelChannel,
                                               ResponseMerger,
                                               SelectiveChannel, SubCall)

from testutil import wait_until


def _policy_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(("health-check-", "ns-"))]


@pytest.fixture(autouse=True)
def servers(monkeypatch):
    before = set(_policy_threads())
    monkeypatch.setattr(HC, "health_check_interval_s", 0.02)
    monkeypatch.setattr(RHC, "health_check_interval_s", 0.02)
    started = []
    yield started
    for srv in started:
        srv.stop()
        srv.join()

    def retired():
        HC.reset_all()
        RHC.reset_all()
        time.sleep(0.05)
        return not (set(_policy_threads()) - before)

    assert wait_until(retired, timeout=5.0), \
        set(_policy_threads()) - before


def _node(mod, tag, fail=False, calls=None, code=None):
    class Node(mod.Service):
        NAME = "Node"

        @mod.method(request="json", response="json")
        def Q(self, cntl, req):
            if calls is not None:
                calls.append(tag)
            if fail:
                # 1234 is outside the retry policy: the inner Channel does
                # not retry it, so `calls` counts the combo layer's tries
                cntl.set_failed(code or 1234, f"{tag} down")
                return None
            return {"tag": tag, "part": tag, "got": req}

        @mod.method(request="raw", response="raw")
        def Which(self, cntl, req):
            return tag.encode()

    return Node()


def _srv(started, tag, mod=rpc, **kw):
    s = mod.Server(has_builtin_services=False) if mod is ref \
        else mod.Server()
    s.add_service(_node(mod, tag, **kw))
    s.start("127.0.0.1", 0)
    started.append(s)
    return s


def _ch(s, mod=rpc, **kw):
    return mod.Channel(f"127.0.0.1:{s.port}", timeout_ms=5000, **kw)


# ---- tests/test_combo_channels.py ----------------------------------------

class TestParallelChannel:
    def test_broadcast_and_merge(self, servers):
        ss = [_srv(servers, f"p{i}") for i in range(3)]
        pc = rpc.ParallelChannel()
        for s in ss:
            pc.add_channel(_ch(s))
        resp = pc.call_sync("Node", "Q", {"k": 1}, serializer="json")
        assert sorted(r["part"] for r in resp) == ["p0", "p1", "p2"]
        assert all(r["got"] == {"k": 1} for r in resp)

    def test_call_mapper_slices_request(self, servers):
        ss = [_srv(servers, f"p{i}") for i in range(2)]

        class Slicer(rpc.CallMapper):
            def map(self, i, n, request):
                return rpc.SubCall({"slice": request["items"][i::n]})

        pc = rpc.ParallelChannel(call_mapper=Slicer())
        for s in ss:
            pc.add_channel(_ch(s))
        resp = pc.call_sync("Node", "Q", {"items": [0, 1, 2, 3]},
                            serializer="json")
        assert sorted(tuple(r["got"]["slice"]) for r in resp) == \
            [(0, 2), (1, 3)]

    def test_fail_limit(self, servers):
        ok, bad = _srv(servers, "ok"), _srv(servers, "bad", fail=True,
                                             code=errors.EINTERNAL)
        strict = rpc.ParallelChannel(fail_limit=0)
        strict.add_channel(_ch(ok)).add_channel(_ch(bad))
        with pytest.raises(errors.RpcError) as ei:
            strict.call_sync("Node", "Q", {}, serializer="json")
        assert ei.value.code == errors.ETOOMANYFAILS
        tolerant = rpc.ParallelChannel(fail_limit=1)
        tolerant.add_channel(_ch(ok)).add_channel(_ch(bad))
        resp = tolerant.call_sync("Node", "Q", {}, serializer="json")
        assert len(resp) == 1 and resp[0]["part"] == "ok"


class TestSelectiveChannel:
    def test_skips_dead_subchannel(self, servers):
        alive = _srv(servers, "alive")
        sc = rpc.SelectiveChannel(max_retry=3)
        sc.add_channel(rpc.Channel("127.0.0.1:1", timeout_ms=400,
                                   max_retry=0))
        sc.add_channel(_ch(alive))
        for _ in range(4):
            assert sc.call_sync("Node", "Q", {},
                                serializer="json")["part"] == "alive"


class TestPartitionChannel:
    def test_partition_fanout(self, servers):
        ss = [_srv(servers, f"shard{i}") for i in range(2)]
        with tempfile.NamedTemporaryFile("w", suffix=".list",
                                         delete=False) as f:
            f.write(f"127.0.0.1:{ss[0].port} 0/2\n")
            f.write(f"127.0.0.1:{ss[1].port} 1/2\n")
            path = f.name

        class KeyMapper(rpc.CallMapper):
            def map(self, i, n, request):
                return rpc.SubCall({"partition": i,
                                    "keys": request["keys"][i::n]})

        pc = rpc.PartitionChannel(2, call_mapper=KeyMapper())
        try:
            pc.init(f"file://{path}",
                    options=rpc.ChannelOptions(timeout_ms=5000))
            resp = pc.call_sync("Node", "Q", {"keys": list(range(6))},
                                serializer="json")
            assert len(resp) == 2
            assert sorted(r["part"] for r in resp) == ["shard0", "shard1"]
            assert sorted(r["got"]["partition"] for r in resp) == [0, 1]
        finally:
            pc.close()
            os.unlink(path)

    def test_call_partitioned_rotates_to_the_other_replica(self, servers):
        calls = []
        p0 = _srv(servers, "p0")
        bad = _srv(servers, "p1-bad", fail=True, code=errors.EINTERNAL,
                   calls=calls)
        good = _srv(servers, "p1-good", calls=calls)
        pc = rpc.PartitionChannel(2, lb="rr")
        pc.add_partition(0, _ch(p0, max_retry=0))
        pc.add_partition(1, _ch(bad, max_retry=0))
        pc.add_partition(1, _ch(good, max_retry=0))
        retried = []
        out = pc.call_partitioned(
            "Node", "Q", {0: {"k": 0}, 1: {"k": 1}}, timeout_ms=5000,
            on_retry=lambda idx, e: retried.append((idx, e.code)))
        assert out[0]["tag"] == "p0" and out[1]["tag"] == "p1-good"
        assert calls == ["p1-bad", "p1-good"]
        assert retried == [(1, errors.EINTERNAL)]


# ---- tests/test_combo_matrix.py ------------------------------------------

class SkipIndex(CallMapper):
    def __init__(self, skip_i):
        self.skip_i = skip_i

    def map(self, i, n, request):
        return SubCall(skip=True) if i == self.skip_i else SubCall(request)


class TagFold(ResponseMerger):
    def merge(self, responses):
        return {"tags": sorted(r["tag"] for r in responses if r)}


class TestParallelMapperMerger:
    def test_mapper_skip_excludes_subchannel(self, servers):
        calls = []
        ss = [_srv(servers, f"n{i}", calls=calls) for i in range(3)]
        pc = ParallelChannel(call_mapper=SkipIndex(1))
        for s in ss:
            pc.add_channel(_ch(s))
        out = pc.call_sync("Node", "Q", {"x": 1}, serializer="json")
        assert sorted(r["tag"] for r in out if r is not None) == \
            ["n0", "n2"]
        assert "n1" not in calls          # never contacted

    def test_custom_merger_folds(self, servers):
        ss = [_srv(servers, f"n{i}") for i in range(3)]
        pc = ParallelChannel(response_merger=TagFold())
        for s in ss:
            pc.add_channel(_ch(s))
        assert pc.call_sync("Node", "Q", {}, serializer="json") == \
            {"tags": ["n0", "n1", "n2"]}

    def test_fail_limit_exceeded_raises(self, servers):
        ss = [_srv(servers, "ok0"), _srv(servers, "bad1", fail=True),
              _srv(servers, "bad2", fail=True)]
        pc = ParallelChannel(fail_limit=1)
        for s in ss:
            pc.add_channel(_ch(s))
        with pytest.raises(errors.RpcError):
            pc.call_sync("Node", "Q", {}, serializer="json")

    def test_all_subchannels_dead(self, servers):
        pc = ParallelChannel(fail_limit=0)
        for port in (1, 2):
            pc.add_channel(rpc.Channel(f"127.0.0.1:{port}",
                                       timeout_ms=1500))
        with pytest.raises(errors.RpcError):
            pc.call_sync("Node", "Q", {}, serializer="json")


class TestSelectiveFailover:
    def test_failover_skips_failed_subchannel(self, servers):
        calls = []
        bad = _srv(servers, "bad", fail=True, calls=calls)
        good = _srv(servers, "good", calls=calls)
        sc = SelectiveChannel(max_retry=2)
        sc.add_channel(_ch(bad)).add_channel(_ch(good))
        cntl = rpc.Controller()
        out = sc.call_sync("Node", "Q", {}, serializer="json", cntl=cntl)
        assert out["tag"] == "good"
        assert cntl.retried_count == 1
        assert cntl.error_code == 0       # reset after the winner

    def test_each_subchannel_tried_once(self, servers):
        calls = []
        ss = [_srv(servers, f"b{i}", fail=True, calls=calls)
              for i in range(3)]
        sc = SelectiveChannel(max_retry=10)   # more than channels
        for s in ss:
            sc.add_channel(_ch(s))
        with pytest.raises(errors.RpcError):
            sc.call_sync("Node", "Q", {}, serializer="json")
        assert sorted(calls) == ["b0", "b1", "b2"]  # no double-tries

    def test_empty_selective_raises_enodata(self, servers):
        with pytest.raises(errors.RpcError) as ei:
            SelectiveChannel().call_sync("Node", "Q", {}, serializer="json")
        assert ei.value.code == errors.ENODATA

    def test_lb_mode_routes_by_request_code_and_skips_broken(self,
                                                             servers):
        from brpc_tpu_torch.policy.load_balancer import create_load_balancer
        ss = [_srv(servers, f"r{i}") for i in range(3)]
        sc = SelectiveChannel(lb=create_load_balancer("prefix_affinity"))
        for s in ss:
            sc.add_channel(_ch(s))
        cntl = rpc.Controller()
        cntl.request_code = 99
        owner = sc.call_sync("Node", "Q", {}, serializer="json",
                             cntl=cntl)["tag"]
        idx, _, ep = sc.pick(request_code=99)
        assert f"r{idx}" == owner
        HC._broken[ep] = 0.0           # quarantined, without a probe
        try:
            cntl = rpc.Controller()
            cntl.request_code = 99
            assert sc.call_sync("Node", "Q", {}, serializer="json",
                                cntl=cntl)["tag"] != owner
        finally:
            HC.reset(ep)


class TestParallelConcurrency:
    def test_concurrent_fanouts(self, servers):
        ss = [_srv(servers, f"n{i}") for i in range(3)]
        pc = ParallelChannel()
        for s in ss:
            pc.add_channel(_ch(s))
        results, errs = [], []

        def worker():
            try:
                for _ in range(20):
                    out = pc.call_sync("Node", "Q", {}, serializer="json")
                    results.append(len([r for r in out if r]))
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        ts = [threading.Thread(target=worker) for _ in range(4)]
        [t.start() for t in ts]
        [t.join(30) for t in ts]
        assert not errs, errs[:2]
        assert len(results) == 80 and all(n == 3 for n in results)


# ---- tests/test_dynpart_auth_mongo.py ------------------------------------

def test_dynamic_partition_channel(servers):
    """Two schemes (2-way and 4-way) behind one list naming service;
    calls fan out over exactly one scheme's partitions, weighted by
    capacity."""
    nodes = []
    for scheme, cnt in (("two", 2), ("four", 4)):
        for idx in range(cnt):
            s = _srv(servers, f"{scheme}:{idx}")
            nodes.append(f"127.0.0.1:{s.port} {idx}/{cnt}")

    class Concat(rpc.ResponseMerger):
        def merge(self, results):
            return b",".join(sorted(results))

    dyn = rpc.DynamicPartitionChannel(response_merger=Concat())
    dyn.init("list://" + ",".join(nodes))
    try:
        assert dyn.scheme_counts == {2: 2, 4: 4}
        seen = set()
        for _ in range(40):
            labels = dyn.call_sync("Node", "Which", b"").decode().split(",")
            schemes = {lab.split(":")[0] for lab in labels}
            assert len(schemes) == 1, labels
            sch = schemes.pop()
            assert len(labels) == (2 if sch == "two" else 4)
            seen.add(sch)
        assert seen == {"two", "four"}
    finally:
        dyn.stop()


# ---- one port server and one JAX-package server, both fan-outs -----------

class Halves(CallMapper):
    def map(self, i, n, request):
        return SubCall({"rows": request["rows"][i::n]})


class InOrder(ResponseMerger):
    """Interleave the halves back into the request's row order."""

    def merge(self, responses):
        halves = [r["got"]["rows"] for r in responses]
        out = []
        for k in range(max(len(h) for h in halves)):
            out.extend(h[k] for h in halves if k < len(h))
        return out


def _mixed(servers):
    mine = _srv(servers, "port")
    theirs = _srv(servers, "ref", mod=ref)
    return mine, theirs


def _reference_result(mine, theirs, rows):
    from brpc_tpu.rpc.combo_channels import CallMapper as RMapper
    from brpc_tpu.rpc.combo_channels import ResponseMerger as RMerger
    from brpc_tpu.rpc.combo_channels import SubCall as RSub

    class RHalves(RMapper):
        def map(self, i, n, request):
            return RSub({"rows": request["rows"][i::n]})

    class RInOrder(RMerger):
        merge = InOrder.merge

    pc = ref.ParallelChannel(call_mapper=RHalves(),
                             response_merger=RInOrder())
    pc.add_channel(_ch(mine, mod=ref)).add_channel(_ch(theirs, mod=ref))
    return pc.call_sync("Node", "Q", {"rows": rows}, serializer="json")


def test_parallel_over_a_port_and_a_reference_server(servers):
    mine, theirs = _mixed(servers)
    rows = [[i, i * i] for i in range(16)]
    pc = ParallelChannel(call_mapper=Halves(), response_merger=InOrder())
    pc.add_channel(_ch(mine)).add_channel(_ch(theirs))
    got = pc.call_sync("Node", "Q", {"rows": rows}, serializer="json")
    assert got == rows == _reference_result(mine, theirs, rows)


def test_partition_over_a_port_and_a_reference_server(servers):
    mine, theirs = _mixed(servers)
    rows = [[i, -i] for i in range(16)]
    pc = rpc.PartitionChannel(2)
    pc.add_partition(0, _ch(mine)).add_partition(1, _ch(theirs))
    out = pc.call_partitioned(
        "Node", "Q", {i: {"rows": rows[i::2]} for i in range(2)},
        timeout_ms=5000)
    assert [out[0]["tag"], out[1]["tag"]] == ["port", "ref"]
    merged = InOrder().merge([out[0], out[1]])
    assert merged == rows == _reference_result(mine, theirs, rows)
