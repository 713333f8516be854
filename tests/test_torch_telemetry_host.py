"""The port's host telemetry, held against the JAX package's.

  * ``bvar/collector.py``: counterparts of ``tests/test_collector.py``
    (speed limits against the reference's on the same injected clock;
    samples drained exactly once; a broken sample survives; rpcz spans
    through the collector with the native hot path off);
  * ``bvar/default_variables.py``: counterparts of
    ``tests/test_default_variables.py`` (the port's ``Server.start``
    exposes process health);
  * ``butil/stagetag.py``: nesting, and the thread-name map equal to the
    reference's;
  * ``butil/lockprof.py``: the ledger of an ``InstrumentedLock``, the
    lock under ``threading.Condition`` (plain and RLock inner), the
    lock-order witness -- it reports a seeded ABBA, and no violation
    over a supervised ``Serving.Generate`` with a ``fault.STEP`` crash;
  * ``butil/hostcpu.py``: an engine run fills the decode, prefill,
    emit and model buckets and counts its tokens;
  * parity: the engine's ``stats()`` holds every key of the reference's
    (but ``kv_bytes_per_slot`` and ``vector_kv``), and the exposed
    ``serving_<name>_*`` and ``kvcache_<name>_*`` variable names equal
    the reference's for the same engine and store names.
"""
import json
import os
import threading
import time

import pytest

from brpc_tpu.butil import stagetag as ref_stagetag
from brpc_tpu.bvar import collector as ref_collector
from brpc_tpu.bvar.variable import exposed_variables as ref_exposed
from brpc_tpu.models import runner as R
from brpc_tpu.serving import DecodeEngine as RefEngine
from brpc_tpu.serving.speculative import NGramProposer as RefNGram
import brpc_tpu_torch.rpc as rpc
from brpc_tpu_torch import fault, flags, rpcz
from brpc_tpu_torch.butil import hostcpu, lockprof, stagetag
from brpc_tpu_torch.butil.lockprof import InstrumentedLock
from brpc_tpu_torch.bvar import collector as port_collector
from brpc_tpu_torch.bvar import dump_exposed, exposed_variables, find_exposed
from brpc_tpu_torch.bvar.collector import (Collected, Collector,
                                           CollectorSpeedLimit)
from brpc_tpu_torch.bvar.default_variables import (_cpu_seconds, _fd_count,
                                                   _rss_bytes,
                                                   _thread_count,
                                                   expose_default_variables)
from brpc_tpu_torch.models import runner as T
from brpc_tpu_torch.policy import health_check
from brpc_tpu_torch.serving import (DecodeEngine, EngineSupervisor,
                                    NGramProposer, register_serving)

from test_torch_native_hotpath import StepEngine, _Sink
from test_torch_runner import JCFG, JPARAMS, TCFG, _tparams
from test_torch_tracing import CALM, _store

CPU = "cpu"


# ---------------------------------------------------------------------------
# the collector
# ---------------------------------------------------------------------------

class _Probe(Collected):
    def __init__(self, sink):
        self.sink = sink

    def dump_and_destroy(self):
        self.sink.append(threading.current_thread().name)


@pytest.fixture(autouse=True, scope="module")
def _retire_health_probes():
    """A client whose server this module stops marks that endpoint for
    the port's health check: retire the probes when the module ends."""
    yield
    time.sleep(0.1)      # a socket may fail just after its server stopped
    health_check.reset_all()


class TestCollector:
    @pytest.mark.parametrize("n", [5, 100])
    def test_flush_observes_prior_submissions(self, n):
        sink = []
        c = Collector.instance()
        for _ in range(n):
            c.submit(_Probe(sink))
        c.flush()
        assert len(sink) == n

    @pytest.mark.parametrize("rate,calls", [(50, [1] * 500),
                                            (100, [60, 60, 10])])
    def test_speed_limit_grants_equal_the_reference(self, rate, calls):
        """grab() and grab_n() from one fixed-window budget, with the
        window refilled after a second: the grants equal the
        reference's on the same injected clock."""
        def grants(mod):
            now = [50.0]
            limit = mod.CollectorSpeedLimit(f"t_tth_{rate}", rate,
                                            clock=lambda: now[0])
            out = [limit.grab_n(n) if n > 1 else int(limit.grab())
                   for n in calls]
            now[0] += 1.1                   # the window rolls over
            out.append(limit.grab_n(rate + 5))
            return out, limit.grabbed.get_value(), limit.denied.get_value()

        got = grants(port_collector)
        assert got == grants(ref_collector)
        out, grabbed, denied = got
        assert sum(out[:-1]) == rate and out[-1] == rate
        assert grabbed + denied == sum(calls) + rate + 5

    def test_speed_limit_window_refills(self):
        now = [5.0]
        limit = CollectorSpeedLimit("t_tth_refill", max_per_second=2,
                                    clock=lambda: now[0])
        assert limit.grab() and limit.grab()
        assert not limit.grab()
        now[0] += 1.1
        assert limit.grab()

    def test_broken_sample_does_not_kill_the_drainer(self):
        class Bad(Collected):
            def dump_and_destroy(self):
                raise RuntimeError("boom")

        sink = []
        c = Collector.instance()
        c.submit(Bad())
        c.submit(_Probe(sink))
        c.flush()
        assert len(sink) == 1

    def test_concurrent_submit_and_flush_exactly_once(self):
        sink = []
        c = Collector.instance()
        stop = time.monotonic() + 0.3
        counts = [0] * 4

        def producer(i):
            while time.monotonic() < stop:
                c.submit(_Probe(sink))
                counts[i] += 1

        ts = [threading.Thread(target=producer, args=(i,))
              for i in range(4)]
        [t.start() for t in ts]
        while time.monotonic() < stop:
            c.flush()
        [t.join(10) for t in ts]
        c.flush()
        assert len(sink) == sum(counts)
        assert not c._pending

    def test_rpcz_spans_flow_through_the_collector(self):
        was = flags.get_flag("native_hot_path_enabled")
        flags.set_flag("native_hot_path_enabled", False)
        rpcz.set_enabled(True)
        try:
            s = rpcz.new_span("server", "Svc", "M")
            rpcz.submit(s)
            assert any(x.span_id == s.span_id
                       for x in rpcz.recent_spans(limit=50))
        finally:
            rpcz.set_enabled(False)
            flags.set_flag("native_hot_path_enabled", was)


# ---------------------------------------------------------------------------
# process default variables
# ---------------------------------------------------------------------------

def test_raw_probes_are_sane():
    assert _cpu_seconds() > 0.0
    assert _rss_bytes() > 1 << 20
    assert _fd_count() >= 3
    assert _thread_count() >= 1


def test_default_variables_exposed_idempotent_and_dumped():
    expose_default_variables()
    expose_default_variables()              # a second call must not raise
    data = dump_exposed("process_*")
    for key in ("process_cpu_seconds", "process_memory_resident_bytes",
                "process_fd_count", "process_thread_count", "process_pid",
                "process_uptime_seconds"):
        assert key in data, f"{key} missing"
    assert data["process_memory_resident_bytes"] > 1 << 20
    assert data["process_pid"] == os.getpid()


def test_server_start_exposes_process_health():
    srv = rpc.Server()
    srv.start("127.0.0.1", 0)
    try:
        for key in ("process_cpu_usage", "process_memory_resident_bytes",
                    "process_fd_count"):
            assert find_exposed(key) is not None, key
    finally:
        srv.stop()
        srv.join()


# ---------------------------------------------------------------------------
# stage tags
# ---------------------------------------------------------------------------

def test_stagetag_explicit_override_nests_and_restores():
    base = stagetag.current_stage()
    with stagetag.stage("prefill"):
        assert stagetag.current_stage() == "prefill"
        with stagetag.stage("decode_step"):
            assert stagetag.current_stage() == "decode_step"
        assert stagetag.current_stage() == "prefill"
    assert stagetag.current_stage() == base


def test_stagetag_thread_name_map_equals_the_reference():
    names = ["serving-batcher-x", "serving-engine-e", "serving-emit-42",
             "serving-supervisor-s", "bvar-collector", "rpcz-spanq",
             "Dummy-3", "MainThread", "nonsense"]
    got = [stagetag.stage_of(0, n) for n in names]
    assert got == [ref_stagetag.stage_of(0, n) for n in names]
    assert got[:3] == ["batch_formation", "decode_step", "emit_fanout"]
    assert got[-1] == "other"


# ---------------------------------------------------------------------------
# the lock ledger and the lock-order witness
# ---------------------------------------------------------------------------

def test_instrumented_lock_records_wait_hold_and_holder_stage():
    lk = InstrumentedLock("t_tth.unit_lock")
    st = lk.stats
    a0, c0 = st.acquisitions.get_value(), st.contentions.get_value()
    w0 = st.wait_rec.count()
    with lk:
        pass
    assert st.acquisitions.get_value() == a0 + 1
    assert st.contentions.get_value() == c0
    entered = threading.Event()

    def holder():
        with lk:
            entered.set()
            time.sleep(0.05)

    t = threading.Thread(target=holder)
    t.start()
    assert entered.wait(5)
    with lk:
        pass
    t.join(5)
    assert st.contentions.get_value() == c0 + 1
    assert st.wait_rec.count() == w0 + 1
    assert st.wait_rec.max_latency() >= 20_000
    assert st.hold_rec.max_latency() >= 40_000
    assert st.last_holder_stage == "main"
    snap = lockprof.locks_snapshot()["t_tth.unit_lock"]
    assert snap["contention_ratio"] > 0 and snap["wait_total_us"] >= 20_000


@pytest.mark.parametrize("inner", ["lock", "rlock"])
def test_instrumented_lock_under_a_condition(inner):
    """wait/notify over the wrapper keeps Condition's semantics: the
    wait releases and restores the lock, a timed-out wait restores it
    too, and notify without the lock raises."""
    lk = InstrumentedLock(f"t_tth.cv_{inner}",
                          threading.RLock() if inner == "rlock" else None)
    cv = threading.Condition(lk)
    state = []

    def waiter():
        with cv:
            while not state:
                if not cv.wait(5):
                    return
            state.append("seen")

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cv:
        state.append("go")
        cv.notify()
    t.join(5)
    assert not t.is_alive() and state == ["go", "seen"]
    with cv:
        assert not cv.wait(0.01)
        assert lk._is_owned()
    assert not lk._is_owned()
    assert lk.acquire(blocking=False)
    lk.release()
    with pytest.raises(RuntimeError):
        cv.notify()


@pytest.fixture
def fresh_witness():
    lockprof.reset_witness()
    yield
    lockprof.reset_witness()


def test_witness_reports_a_seeded_abba(fresh_witness):
    a, b = InstrumentedLock("t_tth.wa"), InstrumentedLock("t_tth.wb")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    cycles = [v["cycle"] for v in lockprof.order_violations()]
    assert any(set(c) == {"t_tth.wa", "t_tth.wb"} for c in cycles)


def test_witness_silent_over_a_supervised_generate_with_a_crash(
        fresh_witness):
    """Server, supervisor, engine, store, emit rings and rpcz spans, a
    crash and its hand-off: no lock-order violation, and the serving
    path's named locks all recorded acquisitions."""
    assert lockprof.witness_enabled()
    rpcz.set_enabled(True)
    store = _store("t_tth_wit_kv", max_blocks=8)
    sup = EngineSupervisor(
        lambda: StepEngineOn(store, "t_tth_wit_eng"), store=store,
        heartbeat_deadline_s=5.0, check_interval_s=0.02, ladder=CALM,
        name="t_tth_wit_sup")
    srv = rpc.Server()
    register_serving(srv, engine=sup)
    srv.start("127.0.0.1", 0)
    try:
        done, msgs = threading.Event(), []

        class H(rpc.StreamHandler):
            def on_received_messages(self, stream, messages):
                msgs.extend(json.loads(m) for m in messages)
                if msgs and msgs[-1].get("done"):
                    done.set()

            def on_closed(self, stream):
                done.set()

        plan = fault.FaultPlan(5).on(fault.STEP, fault.ERROR, times=1,
                                     after=2)
        with fault.injected(plan):
            cntl = rpc.Controller()
            rpc.stream_create(cntl, H())
            rpc.Channel(f"127.0.0.1:{srv.port}").call_sync(
                "Serving", "Generate", {"prompt": [3, 1, 4, 1, 5],
                                        "max_new_tokens": 6},
                serializer="json", cntl=cntl)
            assert done.wait(30), "generation hung"
        assert msgs[-1] == {"done": True}
        assert len([m for m in msgs if "token" in m]) == 6
        assert sup.stats()["restarts"] == 1
    finally:
        rpcz.set_enabled(False)
        srv.stop()
        srv.join()
        sup.close()
        store.close()
    assert lockprof.order_violations() == [], lockprof.witness_report()
    snap = lockprof.locks_snapshot()
    for name in ("engine.slots", "engine.commit", "kvcache.store",
                 "kvcache.pool", "kvcache.pool_io", "kvcache.radix",
                 "supervisor.state", "supervisor.engine",
                 "supervisor.request", "supervisor.delivery",
                 "serving.request", "serving.registry", "rpcz.collect"):
        assert snap[name]["acquisitions"] > 0, name


def StepEngineOn(store, name):
    """A stand-in-runner engine on `store` (the supervisor's factory)."""
    from test_torch_native_hotpath import StepRunner
    return DecodeEngine(
        runner=StepRunner(lambda t, p: (t * 7 + p) % 997,
                          store.pagepool.kv_bytes_per_token),
        store=store, num_slots=2, max_pages_per_slot=32, device=CPU,
        name=name)


# ---------------------------------------------------------------------------
# host-CPU accounting
# ---------------------------------------------------------------------------

def test_hostcpu_buckets_fill_over_an_engine_run():
    before = hostcpu.snapshot()
    srv = StepEngine(lambda t, p: t + 1, "t_tth_hostcpu")
    try:
        sinks = [_Sink() for _ in range(2)]
        for k, s in enumerate(sinks):
            srv.engine.submit([10 * k + 1] * 5, 40, s.emit, s.on_done)
        for s in sinks:
            assert s.done.wait(30) and s.err is None
    finally:
        srv.close()
    after = hostcpu.snapshot()
    assert after["tokens"] - before["tokens"] == 80
    for stage in ("decode_step", "prefill", "emit_fanout", "model_compute"):
        assert after["per_stage_us"][stage] > \
            before["per_stage_us"][stage], stage
    assert after["host_us_per_token"] > 0


# ---------------------------------------------------------------------------
# parity with the reference: stats keys, variable names
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("draft", [False, True])
def test_stats_keys_and_variable_names_equal_the_reference(draft):
    name = f"t_tth_parity_{int(draft)}"
    kw = {"draft_len": 4} if draft else {}
    store = T.make_store_for(TCFG, page_tokens=4, max_blocks=4, device=CPU,
                             name=name)
    eng = DecodeEngine(runner=T.TransformerRunner(_tparams(), TCFG,
                                                  store=store, device=CPU),
                       store=store, num_slots=2, device=CPU, name=name,
                       draft_runner=NGramProposer() if draft else None,
                       **kw)
    rstore = R.make_store_for(JCFG, page_tokens=4, max_blocks=4, name=name)
    reng = RefEngine(runner=R.TransformerRunner(JPARAMS, JCFG, store=rstore),
                     num_slots=2, store=rstore, name=name,
                     draft_runner=RefNGram() if draft else None, **kw)
    try:
        want = set(reng.stats()) - {"kv_bytes_per_slot", "vector_kv"}
        assert want <= set(eng.stats()), want - set(eng.stats())
        for prefix in (f"serving_{name}_", f"kvcache_{name}_"):
            assert sorted(exposed_variables(prefix + "*")) == \
                sorted(ref_exposed(prefix + "*")), prefix
        for shared in ("serving_spec_accept_rate",
                       "serving_spec_proposed_tokens",
                       "serving_spec_accepted_tokens",
                       "serving_host_us_per_token",
                       "serving_tokens_total"):
            assert find_exposed(shared) is not None, shared
    finally:
        eng.close()
        store.close()
        reng.close()
        rstore.close()
    # closed components hide exactly what they exposed
    assert exposed_variables(f"serving_{name}_*") == {}
    assert exposed_variables(f"kvcache_{name}_*") == {}
