"""The port's generation tracing, held against the JAX package's.

Counterparts of ``tests/test_tracing.py``'s ``TestPerTraceSampling``,
``TestTimelineReconstruction``, ``TestWireTraceJoin`` (the port's server
and channel, and the JAX package's channel calling the port's server),
``TestGenerationTrace``, ``TestLatencyAccounting`` and
``TestCrashTraceContinuity``, on the port's ``rpcz``: sampling decided
once per trace and inherited; the span tree and its rendering; the
server span joining the wire's trace; decode, prefill, KV and batch
spans under the ingress span; TTFT and inter-token recorders; one trace
across a supervised crash.  The engines run a stand-in runner (a token
function, as the reference's tests do); crashes come from the port's
``fault.FaultPlan`` at ``fault.STEP``.

Beyond those: one ``Serving.Generate`` served by each package (its
server, engine and runner over the same weights) leaves the same
span-tree shape -- kinds, services, methods, parent links and
annotation names, not timestamps.
"""
import json
import threading
import time

import numpy as np
import pytest

import brpc_tpu as ref
from brpc_tpu import rpcz as ref_rpcz
from brpc_tpu.models import runner as R
from brpc_tpu.serving import DecodeEngine as RefEngine
from brpc_tpu.serving.service import register_serving as ref_register
import brpc_tpu_torch.rpc as rpc
from brpc_tpu_torch import errors, fault, rpcz
from brpc_tpu_torch import serving as serving_mod
from brpc_tpu_torch.kvcache import KVCacheStore
from brpc_tpu_torch.models import runner as T
from brpc_tpu_torch.policy import health_check
from brpc_tpu_torch.rpc import meta as M
from brpc_tpu_torch.serving import (DecodeEngine, DynamicBatcher,
                                    EngineSupervisor, register_serving)
from brpc_tpu_torch.serving.engine import latency_recorders

from test_torch_native_hotpath import StepRunner
from test_torch_runner import JCFG, JPARAMS, TCFG, _tparams

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _retire_health_probes():
    """A client whose server this module stops marks that endpoint for
    the port's health check: retire the probes when the module ends."""
    yield
    time.sleep(0.1)      # a socket may fail just after its server stopped
    health_check.reset_all()


@pytest.fixture(autouse=True)
def _rpcz_hygiene():
    """Every test leaves rpcz off and no current span installed."""
    fault.clear()
    yield
    rpcz.set_current_span(None)
    rpcz.set_enabled(False)
    fault.clear()


def _wait_spans(tid, want, tries=40):
    for _ in range(tries):
        spans = rpcz.recent_spans(limit=2048, trace_id=tid)
        if len(spans) >= want:
            return spans
        time.sleep(0.05)
    return rpcz.recent_spans(limit=2048, trace_id=tid)


# ---------------------------------------------------------------------------
# per-trace head sampling
# ---------------------------------------------------------------------------

class TestPerTraceSampling:
    def test_children_inherit_the_root_decision(self):
        rpcz.set_enabled(True, sample_rate=0.5)
        for _ in range(50):
            root = rpcz.new_span("server", "S", "m")
            rpcz.set_current_span(root)
            child = rpcz.child_span("batch", "S", "m")
            grandchild = rpcz.new_span(
                "decode", "S", "m", trace_id=child.trace_id,
                parent_span_id=child.span_id, sampled=child.sampled)
            rpcz.set_current_span(None)
            assert child.trace_id == root.trace_id
            assert child.sampled == root.sampled
            assert grandchild.sampled == root.sampled

    def test_no_partial_traces_at_any_rate(self):
        """A sampled trace arrives WHOLE; an unsampled one leaves
        nothing."""
        for rate in (0.5, 0.01):
            rpcz.set_enabled(True, sample_rate=rate)
            tids = []
            for _ in range(120):
                root = rpcz.new_span("server", "Samp", "m")
                rpcz.set_current_span(root)
                child = rpcz.child_span("batch", "Samp", "m")
                rpcz.set_current_span(None)
                rpcz.submit(child)
                rpcz.submit(root)
                tids.append(root.trace_id)
            per_trace = {}
            for s in rpcz.recent_spans(limit=2048):
                if s.trace_id in tids:
                    per_trace.setdefault(s.trace_id, []).append(s)
            for tid, group in per_trace.items():
                assert len(group) == 2, \
                    f"rate {rate}: trace {tid} collected with holes"

    def test_rate_half_keeps_some_and_drops_some(self):
        rpcz.set_enabled(True, sample_rate=0.5)
        decisions = [rpcz.new_span("server", "S", "m").sampled
                     for _ in range(200)]
        assert any(decisions) and not all(decisions)

    def test_sampled_bit_rides_the_meta_flags(self):
        from brpc_tpu.rpc import meta as ref_meta
        m = M.RpcMeta(msg_type=M.MSG_REQUEST, trace_id=7, span_id=3,
                      flags=M.FLAG_TRACE_SAMPLED)
        d = M.RpcMeta.decode(m.encode())
        assert d.flags & M.FLAG_TRACE_SAMPLED and d.trace_id == 7
        # the same bytes as the JAX package's meta
        assert m.encode() == ref_meta.RpcMeta(
            msg_type=ref_meta.MSG_REQUEST, trace_id=7, span_id=3,
            flags=ref_meta.FLAG_TRACE_SAMPLED).encode()
        m2 = M.RpcMeta(msg_type=M.MSG_REQUEST, trace_id=7, span_id=3)
        assert not (M.RpcMeta.decode(m2.encode()).flags
                    & M.FLAG_TRACE_SAMPLED)

    def test_server_span_inherits_wire_decision(self):
        rpcz.set_enabled(True)
        s_on = rpcz.new_span("server", "S", "m", trace_id=11,
                             parent_span_id=2, sampled=True)
        s_off = rpcz.new_span("server", "S", "m", trace_id=11,
                              parent_span_id=2, sampled=False)
        assert s_on.sampled is True and s_off.sampled is False


# ---------------------------------------------------------------------------
# timeline reconstruction
# ---------------------------------------------------------------------------

class TestTimelineReconstruction:
    def _spans(self, mod=rpcz):
        a = mod.Span(trace_id=1, span_id=1, kind="server", service="Svc",
                     method="Gen", start_us=1000, end_us=9000)
        b = mod.Span(trace_id=1, span_id=2, parent_span_id=1, kind="batch",
                     service="Serving", method="b", start_us=1500,
                     end_us=3000)
        c = mod.Span(trace_id=1, span_id=3, parent_span_id=2,
                     kind="decode", service="Serving", method="e",
                     start_us=1600, end_us=2800)
        d = mod.Span(trace_id=1, span_id=4, parent_span_id=1,
                     kind="prefill", service="Serving", method="e",
                     start_us=4000, end_us=5000)
        return a, b, c, d

    def test_tree_order_and_relative_offsets(self):
        a, b, c, d = self._spans()
        tree = rpcz.trace_tree([d, c, b, a])   # shuffled input
        assert [(dep, off, s.span_id) for dep, off, s in tree] == [
            (0, 0, 1), (1, 500, 2), (2, 600, 3), (1, 3000, 4)]

    def test_orphan_surfaces_as_extra_root(self):
        a, b, c, d = self._spans()
        orphan = rpcz.Span(trace_id=1, span_id=9, parent_span_id=777,
                           start_us=2000, end_us=2100)
        tree = rpcz.trace_tree([a, b, c, d, orphan])
        assert (0, 1000, orphan) in [(dep, off, s) for dep, off, s in tree]
        assert len(tree) == 5

    def test_format_trace_renders_links_and_annotations(self):
        rendered = []
        for mod in (rpcz, ref_rpcz):
            a, b, c, d = self._spans(mod)
            d.recovered_from = 3
            b.annotations = [(1700, "batch formed: queue_delay_us=200")]
            rendered.append(mod.format_trace([a, b, c, d]))
        txt = rendered[0]
        assert txt == rendered[1], "rendering differs from the reference"
        assert "trace 1 — 4 spans" in txt
        assert "+500us [batch] Serving.b" in txt
        assert "@+700us batch formed: queue_delay_us=200" in txt
        assert "recovered_from=span 3" in txt
        lines = txt.splitlines()
        b_line = next(ln for ln in lines if "[batch]" in ln)
        c_line = next(ln for ln in lines if "[decode]" in ln)
        assert (len(c_line) - len(c_line.lstrip())
                > len(b_line) - len(b_line.lstrip()))

    def test_slowest_traces_ranked_by_root_latency(self):
        fast = rpcz.Span(trace_id=1, span_id=1, start_us=0, end_us=100)
        slow = rpcz.Span(trace_id=2, span_id=2, start_us=0, end_us=900)
        mid = rpcz.Span(trace_id=3, span_id=3, start_us=0, end_us=500)
        ranked = rpcz.slowest_traces([fast, slow, mid], 2)
        assert [g[0].trace_id for g in ranked] == [2, 3]


# ---------------------------------------------------------------------------
# RPC ingress: the server span joins the caller's trace over the wire
# ---------------------------------------------------------------------------

class _Echo(rpc.Service):
    @rpc.method(request="json", response="json")
    def Say(self, cntl, req):
        return {"ok": True}


class TestWireTraceJoin:
    @pytest.mark.parametrize("client", ["port", "ref"])
    def test_server_span_joins_client_trace_and_sampling(self, client):
        rpcz.set_enabled(True)
        ref_rpcz.set_enabled(True)
        mod, cz = {"port": (rpc, rpcz), "ref": (ref, ref_rpcz)}[client]
        srv = rpc.Server()
        srv.add_service(_Echo())
        srv.start("127.0.0.1", 0)
        try:
            ch = mod.Channel(f"127.0.0.1:{srv.port}", timeout_ms=5000)
            root = cz.new_span("client", "press", "Say")
            cz.set_current_span(root)
            ch.call_sync("_Echo", "Say", {}, serializer="json")
            cz.set_current_span(None)
            spans = _wait_spans(root.trace_id, 1)
            server_span = next(s for s in spans if s.kind == "server")
            assert server_span.parent_span_id == root.span_id
            assert (server_span.service, server_span.method) == \
                ("_Echo", "Say")
            # an UNSAMPLED root's trace leaves nothing server-side
            unroot = cz.new_span("client", "press", "Say", sampled=False)
            cz.set_current_span(unroot)
            ch.call_sync("_Echo", "Say", {}, serializer="json")
            cz.set_current_span(None)
            time.sleep(0.2)
            assert rpcz.recent_spans(limit=2048,
                                     trace_id=unroot.trace_id) == []
        finally:
            ref_rpcz.set_current_span(None)
            ref_rpcz.set_enabled(False)
            srv.stop()
            srv.join()


# ---------------------------------------------------------------------------
# generation tracing through batcher / engine / kvcache
# ---------------------------------------------------------------------------

def _store(name, max_blocks=4):
    return KVCacheStore(device=CPU, page_bytes=256, page_tokens=4,
                        max_blocks=max_blocks, name=name)


def _engine(store, name):
    return DecodeEngine(
        runner=StepRunner(lambda t, p: (t * 7 + p) % 997,
                          store.pagepool.kv_bytes_per_token),
        store=store, num_slots=2, max_pages_per_slot=32, device=CPU,
        name=name)


def _materialize(store, tokens):
    """Admit `tokens`, write (zero) K/V for every position and retire
    the sequence into the radix tree."""
    seq = store.admit(tokens)
    store.write_kv(seq, 0, np.zeros((len(tokens),
                                     store.pagepool.kv_bytes_per_token),
                                    np.uint8))
    store.retire(seq, cache=True)


def _generate(target, prompt, n):
    ev = threading.Event()
    toks, errs = [], []
    target.submit(prompt, n, toks.append,
                  lambda e: (errs.append(e), ev.set()))
    assert ev.wait(30), "generation hung"
    return toks, errs


def _notes(span) -> str:
    return " | ".join(m for _, m in span.annotations)


class TestGenerationTrace:
    def test_decode_prefill_kv_spans_share_ingress_trace(self):
        rpcz.set_enabled(True)
        store = _store("t_ttr_gen_kv")
        eng = _engine(store, "t_ttr_gen_eng")
        try:
            shared = list(range(50, 58))        # two full pages
            # wave 1 commits the prefix into the radix tree on retire
            _generate(eng, shared + [1], 3)
            assert eng.join_idle(10)
            root = rpcz.new_span("server", "Serving", "Generate")
            rpcz.set_current_span(root)
            toks, errs = _generate(eng, shared + [2], 3)
            rpcz.set_current_span(None)
            rpcz.submit(root)
            assert errs == [None]
            spans = _wait_spans(root.trace_id, 3)
            by_kind = {s.kind: s for s in spans}
            assert {"server", "decode", "prefill"} <= set(by_kind), spans
            dec = by_kind["decode"]
            assert dec.parent_span_id == root.span_id
            assert by_kind["prefill"].parent_span_id == dec.span_id
            notes = _notes(dec)
            assert "kv admit: prefix_hit=8/9" in notes
            assert "first token: ttft_us=" in notes
            assert "retired: generated=3" in notes
            pre = _notes(by_kind["prefill"])
            assert "cached=8" in pre and "uncached=1" in pre
        finally:
            eng.close()
            store.close()

    def test_kv_cow_and_page_alloc_retry_annotations(self):
        rpcz.set_enabled(True)
        store = _store("t_ttr_kv_ann", max_blocks=1)
        try:
            # COW: the fork shares the partly filled tail page; the
            # child's next extend copies it, annotated on its span
            seq = store.admit([1, 2, 3, 4, 5, 6])
            child = store.fork(seq)
            child.span = rpcz.new_span("decode", "Serving", "t_kv")
            store.extend(child, 7)
            assert "kv cow: tail page" in _notes(child.span)
            store.retire(seq, cache=False)
            store.retire(child, cache=False)
            # page-alloc retry: the tree holds 4 pages, then a prompt
            # that fits only once they are evicted
            _materialize(store, list(range(100, 116)))
            span = rpcz.new_span("decode", "Serving", "t_kv2")
            cap = store.pagepool.max_blocks * store.pagepool.pages_per_block
            big = store.admit(list(range(200, 200 + (cap - 2) * 4)),
                              span=span)
            assert "kv page_alloc retry" in _notes(span)
            assert "kv evict" in _notes(span)
            store.retire(big, cache=False)
        finally:
            store.close()

    def test_batcher_span_queue_delay_shed_and_trim(self):
        rpcz.set_enabled(True)
        store = _store("t_ttr_b_kv")
        b = DynamicBatcher(lambda x, off: np.asarray(x).sum(axis=1),
                           max_batch_size=4, max_delay_us=500,
                           length_buckets=(16,), prefix_cache=store,
                           name="t_ttr_batch")
        try:
            _materialize(store, list(range(9, 17)) + [1])
            root = rpcz.new_span("server", "Serving", "Score")
            rpcz.set_current_span(root)
            out = b.submit_wait(
                np.asarray(list(range(9, 17)) + [2], np.float32),
                timeout_s=10.0)
            rpcz.set_current_span(None)
            rpcz.submit(root)
            assert out is not None
            spans = _wait_spans(root.trace_id, 2)
            batch = next(s for s in spans if s.kind == "batch")
            assert batch.parent_span_id == root.span_id
            notes = _notes(batch)
            assert "batch formed: queue_delay_us=" in notes
            assert "kv prefix trim: 8/9 tokens" in notes
            # shed: the brownout refuses the deadline-less lane, and the
            # span says why
            b.brownout = 1
            root2 = rpcz.new_span("server", "Serving", "Score")
            rpcz.set_current_span(root2)
            with pytest.raises(errors.RpcError):
                b.submit_wait(np.ones((4,), np.float32), timeout_s=5.0)
            rpcz.set_current_span(None)
            rpcz.submit(root2)
            shed = next(s for s in _wait_spans(root2.trace_id, 2)
                        if s.kind == "batch")
            assert shed.error_code == errors.ELIMIT
            assert "brownout" in _notes(shed)
        finally:
            b.close()
            store.close()


# ---------------------------------------------------------------------------
# TTFT / ITL accounting
# ---------------------------------------------------------------------------

class TestLatencyAccounting:
    def test_ttft_itl_recorders_and_generation_record(self):
        rec = latency_recorders()
        store = _store("t_ttr_lat_kv")
        eng = _engine(store, "t_ttr_lat_eng")
        try:
            ttft0, itl0 = rec["ttft"].count(), rec["itl"].count()
            n = 5
            toks, errs = _generate(eng, [3, 1, 4, 1, 5], n)
            assert errs == [None] and len(toks) == n
            assert rec["ttft"].count() == ttft0 + 1
            assert rec["itl"].count() == itl0 + n - 1   # n-1 gaps
            recs = [r for r in serving_mod.recent_generations(50)
                    if r.get("engine") == "t_ttr_lat_eng"]
            assert recs, "no generation record appended"
            r = recs[-1]
            assert (r["generated"], r["prompt_len"], r["error_code"]) == \
                (n, 5, 0)
            assert r["ttft_us"] >= 0
            snap = serving_mod.generations_snapshot(10)
            assert snap["aggregates"]["ttft_us"]["count"] >= 1
            assert any(g.get("engine") == "t_ttr_lat_eng"
                       for g in snap["recent"])
        finally:
            eng.close()
            store.close()


# ---------------------------------------------------------------------------
# trace continuity across crash recovery
# ---------------------------------------------------------------------------

CALM = ({"queue_delay_us": float("inf"), "pool_ratio": 9.9,
         "queue_depth": 1e9},) * 3


class TestCrashTraceContinuity:
    def test_recovered_attempt_same_trace_with_link(self):
        rpcz.set_enabled(True)
        store = _store("t_ttr_cr_kv", max_blocks=8)
        sup = EngineSupervisor(lambda: _engine(store, "t_ttr_cr_eng"),
                               store=store, heartbeat_deadline_s=5.0,
                               check_interval_s=0.02, ladder=CALM,
                               name="t_ttr_cr_sup")
        try:
            shared = list(range(70, 78))
            plan = fault.FaultPlan(11).on(fault.STEP, fault.ERROR,
                                          times=1, after=2)
            with fault.injected(plan):
                toks, errs = _generate(sup, shared + [9], 6)
            assert errs == [None]
            assert sup.stats()["restarts"] == 1
            gens = {}
            for s in rpcz.recent_spans(limit=2048):
                if s.kind == "generation" and s.method == "t_ttr_cr_sup":
                    gens.setdefault(s.trace_id, []).append(s)
            linked = None
            for tid, group in gens.items():
                group.sort(key=lambda s: s.span_id)
                if len(group) >= 2 and \
                        group[1].recovered_from == group[0].span_id:
                    linked = (tid, group)
            assert linked, f"no recovered_from-linked trace: {gens}"
            tid, group = linked
            notes = _notes(group[1])
            assert "resume_cursor=" in notes
            assert "re_decoded_tokens=" in notes
            # the trace holds BOTH decode attempts: the pre-crash one
            # closed at the takeover, the resumed one at retirement
            decode = [s for s in rpcz.recent_spans(limit=2048,
                                                   trace_id=tid)
                      if s.kind == "decode"]
            assert len(decode) >= 2, decode
            assert any(s.error_code == errors.ELOGOFF for s in decode)
        finally:
            sup.close()
            store.close()


# ---------------------------------------------------------------------------
# one Serving.Generate, each package: the same span-tree shape
# ---------------------------------------------------------------------------

def _shape(cz, tid):
    """The trace's tree as (depth, kind, service, method, parent kind,
    annotation names) rows, in tree order."""
    spans = cz.recent_spans(limit=2048, trace_id=tid)
    by_id = {s.span_id: s for s in spans}
    return [(depth, s.kind, s.service, s.method,
             by_id[s.parent_span_id].kind if s.parent_span_id in by_id
             else None,
             tuple(m.split(":")[0] for _, m in s.annotations))
            for depth, _, s in cz.trace_tree(spans)]


def _traced_generate(mod, cz, port, prompt, n):
    """Serving.Generate under a client root span of `cz`; returns the
    root's trace id once the stream has ended."""
    done = threading.Event()
    toks = []

    class H(mod.StreamHandler):
        def on_received_messages(self, stream, messages):
            for m in messages:
                d = json.loads(m)
                if "token" in d:
                    toks.append(d["token"])
                elif d.get("done"):
                    done.set()

        def on_closed(self, stream):
            done.set()

    cntl = mod.Controller()
    mod.stream_create(cntl, H())
    root = cz.new_span("client", "Serving", "Generate")
    cz.set_current_span(root)
    try:
        mod.Channel(f"127.0.0.1:{port}", timeout_ms=30_000).call_sync(
            "Serving", "Generate", {"prompt": prompt, "max_new_tokens": n},
            serializer="json", cntl=cntl)
    finally:
        cz.set_current_span(None)
    assert done.wait(60), "generation hung"
    cz.submit(root)
    return root.trace_id, toks


def test_generate_span_tree_shape_equals_reference():
    prompt, n = [12, 42, 55, 79, 61, 33, 20, 88, 94], 4
    rpcz.set_enabled(True)
    ref_rpcz.set_enabled(True)
    store = T.make_store_for(TCFG, page_tokens=4, max_blocks=16, device=CPU,
                             name="t_ttr_shape")
    eng = DecodeEngine(runner=T.TransformerRunner(_tparams(), TCFG,
                                                  store=store, device=CPU),
                       store=store, num_slots=2, max_pages_per_slot=24,
                       prefill_buckets=(8, 16), device=CPU,
                       name="t_ttr_shape")
    srv = rpc.Server()
    register_serving(srv, engine=eng)
    srv.start("127.0.0.1", 0)
    rstore = R.make_store_for(JCFG, page_tokens=4, max_blocks=16,
                              name="t_ttr_shape_ref_kv")
    reng = RefEngine(runner=R.TransformerRunner(JPARAMS, JCFG, store=rstore),
                     num_slots=2, store=rstore, max_pages_per_slot=24,
                     prefill_buckets=(8, 16), name="t_ttr_shape")
    rsrv = ref.Server(has_builtin_services=False)
    ref_register(rsrv, engine=reng, http_generate_path=None)
    rsrv.start("127.0.0.1", 0)
    try:
        tid, toks = _traced_generate(rpc, rpcz, srv.port, prompt, n)
        rtid, rtoks = _traced_generate(ref, ref_rpcz, rsrv.port, prompt, n)
        assert toks == rtoks and len(toks) == n
        assert eng.join_idle(10) and reng.join_idle(10)
        shape = _shape(rpcz, tid)
        assert [row[1] for row in shape] == \
            ["client", "server", "decode", "prefill"], shape
        assert shape == _shape(ref_rpcz, rtid)
    finally:
        ref_rpcz.set_enabled(False)
        srv.stop()
        srv.join()
        eng.close()
        store.clear()
        rsrv.stop()
        rsrv.join()
        reng.close()
        rstore.clear()
        rstore.close()
