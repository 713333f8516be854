"""The port's fleet telemetry plane held against the JAX package's.

Counterparts of ``tests/test_telemetry.py``'s ``TestTelemetryService``
and ``TestFleetCollector`` over ``brpc_tpu_torch.serving.telemetry``: the
bounded bvar snapshot, incremental ``Pull`` over the span cursor, the
one-trace ``Trace`` query, and the router-side collector's rings,
unsupported latch, tombstones and cross-replica aggregate.  Then one
``_telemetry`` Pull across the packages each way, and the pull into the
rings made while every native latency-recorder slot is live: the
reference's recorder then records nothing (its counterpart fails in
whole tier-1 runs); the port's keeps its cells in Python.
"""
import gc
import json
import os
import time

import pytest

from brpc_tpu_torch import errors, rpc, rpcz
from brpc_tpu_torch.bvar import recorder as recorder_mod
from brpc_tpu_torch.serving.telemetry import (FleetCollector,
                                              parse_spans_field,
                                              register_telemetry,
                                              telemetry_snapshot)


@pytest.fixture(autouse=True)
def _hygiene():
    from brpc_tpu_torch import fault
    fault.clear()
    yield
    rpcz.set_current_span(None)
    rpcz.set_enabled(False)
    fault.clear()


def _pull(ch, req):
    return ch.call_sync("_telemetry", "Pull", req,
                        serializer="tensorframe",
                        response_serializer="tensorframe")


@pytest.fixture()
def telemetry_server():
    srv = rpc.Server()
    svc = register_telemetry(srv, name="unit_replica")
    srv.start("127.0.0.1", 0)
    yield srv, svc
    srv.stop()
    srv.join()


class TestTelemetryService:
    def test_snapshot_carries_every_variable_family(self):
        from brpc_tpu_torch.bvar import Adder, LatencyRecorder
        a = Adder("telem_test_adder")
        a.add(7)
        rec = LatencyRecorder("telem_test_rec")
        rec.add(1000)
        try:
            snap = telemetry_snapshot(pattern="telem_test_*")
            assert snap["scalars"]["telem_test_adder"] == 7
            r = snap["recorders"]["telem_test_rec_latency"]
            assert r["count"] == 1 and r["max_us"] >= 1000
            assert "write_syscalls" in snap["syscalls"]
            assert snap["truncated"] is False
        finally:
            a.hide()
            rec.hide()

    def test_snapshot_truncation_is_deterministic(self):
        snap = telemetry_snapshot(max_vars=1)
        assert snap["truncated"] is True
        total = (len(snap["scalars"]) + len(snap["recorders"])
                 + len(snap["windows"]))
        assert total == 1

    def test_pull_is_incremental_over_the_span_cursor(self,
                                                       telemetry_server):
        srv, svc = telemetry_server
        rpcz.set_enabled(True, 1.0)
        ch = rpc.Channel(f"127.0.0.1:{srv.port}", timeout_ms=5000)
        # the span seq is process-wide: learn the current high-water mark
        base = int(_pull(ch, {"cursor": 0, "max_spans": 0})["cursor"])
        for i in range(3):
            rpcz.submit(rpcz.new_span("server", "Unit", f"m{i}"))
        rpcz.flush()
        r1 = _pull(ch, {"cursor": base})
        assert r1["name"] == "unit_replica"
        assert r1["pid"] == os.getpid()
        spans1 = parse_spans_field(r1["spans"])
        assert len(spans1) >= 3
        assert {x.method for x in spans1} >= {"m0", "m1", "m2"}
        snap = json.loads(r1["vars"])
        assert "scalars" in snap and "syscalls" in snap
        # from the returned cursor an already-pulled span never returns
        r2 = _pull(ch, {"cursor": int(r1["cursor"])})
        again = {x.span_id for x in parse_spans_field(r2["spans"])}
        assert not again & {x.span_id for x in spans1}
        assert int(r2["cursor"]) >= int(r1["cursor"])
        assert svc.stats()["pulls"] == 3

    def test_trace_query_returns_one_trace(self, telemetry_server):
        srv, _ = telemetry_server
        rpcz.set_enabled(True, 1.0)
        a = rpcz.new_span("server", "T", "a")
        rpcz.submit(a)
        rpcz.submit(rpcz.new_span("server", "T", "b"))
        rpcz.flush()
        ch = rpc.Channel(f"127.0.0.1:{srv.port}", timeout_ms=5000)
        r = ch.call_sync("_telemetry", "Trace", {"trace_id": a.trace_id},
                         serializer="tensorframe",
                         response_serializer="tensorframe")
        got = parse_spans_field(r["spans"])
        assert [s.trace_id for s in got] == [a.trace_id] * len(got)
        assert any(s.method == "a" for s in got)
        assert not any(s.method == "b" for s in got)
        with pytest.raises(errors.RpcError) as ei:
            ch.call_sync("_telemetry", "Trace", {},
                         serializer="tensorframe",
                         response_serializer="tensorframe")
        assert ei.value.code == errors.EREQUEST


class _FakeMetrics:
    """snapshot()-compatible stand-in for ModelMetrics."""

    def __init__(self):
        self.rows = {}

    def set(self, model, *, ttft_ms=None, itl_ms=None,
            finished=0, failed=0):
        self.rows[model] = {
            "ttft": {"p99_ms": ttft_ms}, "itl": {"p99_ms": itl_ms},
            "finished": finished, "failed": failed,
        }

    def snapshot(self):
        return dict(self.rows)


def _hold_native_slots():
    """Recorders holding every native slot still free (collected garbage
    first: a recorder freed mid-loop gives its slot back)."""
    gc.collect()
    hold = []
    while recorder_mod.native_slots_live() < recorder_mod.NATIVE_SLOTS:
        hold.append(recorder_mod.LatencyRecorder())
    return hold


class TestFleetCollector:
    def test_pull_merges_vars_and_spans_into_rings(self):
        rpcz.set_enabled(True, 1.0)
        from brpc_tpu_torch.bvar import LatencyRecorder
        rec = LatencyRecorder("telem_ring_rec")
        rec.add(500)
        srv = rpc.Server()
        register_telemetry(srv, name="ring_replica")
        srv.start("127.0.0.1", 0)
        addr = f"127.0.0.1:{srv.port}"
        c = FleetCollector("unit", var_filter="telem_ring_rec*")
        try:
            s = rpcz.new_span("server", "Ring", "m")
            rpcz.submit(s)
            rpcz.flush()
            assert c.pull(addr, rpc.Channel(addr, timeout_ms=5000)) is True
            st = c.replica_table()[0]
            assert st["name"] == "ring_replica"
            assert st["pulls"] == 1 and not st["tombstoned"]
            vals = c.window_values(addr, "",
                                   "telem_ring_rec_latency.p99_us", 60.0)
            # the bucketed percentile of one 500 us record
            assert vals and vals[-1] >= 400
            assert any(x.trace_id == s.trace_id
                       for x in c.fleet_spans(s.trace_id))
            assert c.stats()["pulls"] == 1
            assert c.stats()["pull_bytes"] > 0
        finally:
            c.close()
            rec.hide()
            srv.stop()
            srv.join()

    def test_telemetry_less_process_latches_unsupported_not_dead(self):
        srv = rpc.Server()   # no _telemetry registered
        srv.start("127.0.0.1", 0)
        addr = f"127.0.0.1:{srv.port}"
        c = FleetCollector("unit_unsup")
        try:
            ch = rpc.Channel(addr, timeout_ms=5000)
            assert c.pull(addr, ch) is False
            st = c.replica_table()[0]
            assert st["unsupported"] is True
            assert not st["tombstoned"] and st["errors"] == 0
            for _ in range(5):
                assert c.pull(addr, ch) is False
            assert c.replica_table()[0]["errors"] == 0
            assert c.stats()["pull_errors"] == 0
            assert not c.disruption_within(60.0)
        finally:
            c.close()
            srv.stop()
            srv.join()

    def test_dead_endpoint_tombstones_then_recovers(self):
        gone_srv = rpc.Server()
        gone_srv.start("127.0.0.1", 0)
        addr = f"127.0.0.1:{gone_srv.port}"
        gone_srv.stop()
        gone_srv.join()
        c = FleetCollector("unit_tomb")
        try:
            ch = rpc.Channel(addr, timeout_ms=300)
            for _ in range(FleetCollector.TOMBSTONE_AFTER):
                assert c.pull(addr, ch) is False
            st = c.replica_table()[0]
            assert st["tombstoned"] is True
            assert c.tombstoned() == [addr]
            assert c.disruption_within(60.0)
            assert c.stats()["tombstones"] == 1
            # the replica comes back on the same port: one good pull
            # clears the tombstone and stamps recover_t
            srv = rpc.Server()
            register_telemetry(srv, name="back")
            host, port = addr.split(":")
            srv.start(host, int(port))
            try:
                assert c.pull(addr, rpc.Channel(addr, timeout_ms=5000))
                assert not c.replica_table()[0]["tombstoned"]
                assert c.disruption_within(60.0)
                assert not c.disruption_within(
                    0.5, now=time.monotonic() + 100.0)
            finally:
                srv.stop()
                srv.join()
        finally:
            c.close()

    def test_note_dead_tombstones_immediately(self):
        c = FleetCollector("unit_dead")
        try:
            c.note_dead("10.0.0.1:1")
            assert c.tombstoned() == ["10.0.0.1:1"]
            assert c.disruption_within(60.0)
            c.note_dead("10.0.0.1:1")   # idempotent
            assert c.stats()["tombstones"] == 1
        finally:
            c.close()

    def test_values_across_excludes_tombstoned_series(self):
        c = FleetCollector("unit_excl")
        try:
            m = _FakeMetrics()
            m.set("m", itl_ms=10.0)
            c.sample_models(m, replica="r1:1")
            m.set("m", itl_ms=99.0)
            c.sample_models(m, replica="r2:2")
            assert sorted(c.values_across("m", "itl_p99_ms", 60.0)) == \
                [10.0, 99.0]
            c.note_dead("r2:2")
            assert c.values_across("m", "itl_p99_ms", 60.0) == [10.0]
        finally:
            c.close()


@pytest.mark.parametrize("collector_pkg", ["port", "jax"])
def test_pull_across_packages(collector_pkg):
    """One package's collector pulls the other's ``_telemetry``: the
    name, the pid, the scalar it exposes and a span it collected."""
    import brpc_tpu as jbrpc
    from brpc_tpu import rpcz as jrpcz
    from brpc_tpu.bvar.collector import Collector
    from brpc_tpu.bvar.reducer import Adder as JAdder
    from brpc_tpu.serving import telemetry as jtel
    from brpc_tpu_torch.bvar import Adder
    if collector_pkg == "port":
        # the JAX package serves
        srv = jbrpc.Server()
        jtel.register_telemetry(srv, name="jax_replica")
        a = JAdder("telem_x_adder")
        span_mod, collector = jrpcz, FleetCollector("unit_x_port")

        def flush():
            Collector.instance().flush(family="rpcz")

        def channel(addr):
            return rpc.Channel(addr, timeout_ms=5000)
    else:
        srv = rpc.Server()
        register_telemetry(srv, name="port_replica")
        a = Adder("telem_x_adder")
        span_mod, collector = rpcz, jtel.FleetCollector("unit_x_jax")
        flush = rpcz.flush

        def channel(addr):
            return jbrpc.Channel(addr, timeout_ms=5000)
    collector.var_filter = "telem_x_*"
    a.add(11)
    srv.start("127.0.0.1", 0)
    addr = f"127.0.0.1:{srv.port}"
    span_mod.set_enabled(True, 1.0)
    try:
        # the first pull ships the oldest spans and moves the cursor to
        # the high-water mark (the span seq is process-wide: a whole
        # run collected thousands before this test)
        assert collector.pull(addr, channel(addr)) is True
        s = span_mod.new_span("server", "Cross", "pull")
        span_mod.submit(s)
        flush()
        assert collector.pull(addr, channel(addr)) is True
        row = collector.replica_table()[0]
        assert row["name"] == ("jax_replica" if collector_pkg == "port"
                               else "port_replica")
        assert row["pid"] == os.getpid()
        snap = collector.last_snapshot(addr)
        assert snap["scalars"] == {"telem_x_adder": 11}
        assert any(x.method == "pull" for x in
                   collector.fleet_spans(s.trace_id))
    finally:
        span_mod.set_enabled(False)
        collector.close()
        a.hide()
        srv.stop()
        srv.join()


def test_latency_recorder_past_the_native_slots_raises():
    """With every native slot live a new recorder raises (the JAX
    package's gets one that records nothing); the last slot taken still
    records, and a slot given back can be taken again."""
    base = recorder_mod.native_slots_live()
    hold = _hold_native_slots()
    assert recorder_mod.native_slots_live() == recorder_mod.NATIVE_SLOTS
    with pytest.raises(RuntimeError, match="slots are live"):
        recorder_mod.LatencyRecorder()
    assert recorder_mod.native_slots_live() == recorder_mod.NATIVE_SLOTS
    hold[-1].add(500)
    assert hold[-1].snapshot() == (1, 500, 500)
    assert hold[-1].latency_percentile(0.99) >= 400
    hold.pop()
    again = recorder_mod.LatencyRecorder()
    del hold, again
    gc.collect()     # (may free other garbage recorders too)
    assert recorder_mod.native_slots_live() <= base
