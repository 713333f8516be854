"""The port's request dumps (``rpc/rpc_dump.py``), ``tools/rpc_replay.py``
and the rpcz span database, held against the JAX package's.

  * a dump holds one record a request: the wire meta (which decodes, in
    either package, to the service and method called) and the body as
    it arrived (compressed, attachment and all);
  * ``.rdump`` files cross both ways: captured by either package's
    server, replayed by either package's ``run_replay`` against either
    package's server, with 0 errors, and the target sees the same
    requests;
  * ``rpc_dump_ratio`` keeps one request in N; rotation keeps
    ``rpc_dump_max_files`` files of ``rpc_dump_max_requests_in_one_file``
    records, the newest; with the flag off the dispatch never reaches
    the sampler;
  * a captured streaming ``Serving.Generate`` (configuration (a))
    replays without its client stream, and a port server answers it as
    a JAX-package server does;
  * span segments written by either package load in the other with
    equal fields; segments rotate and the oldest are pruned;
    ``/rpcz?trace_id=`` and ``load_disk_spans`` find a trace the
    in-memory store lost, and the ``rpcz_database_dir`` flag on
    ``/flags`` switches the database.
"""
import http.client
import io
import json
import os
import threading
import time

import pytest

import brpc_tpu as ref
from brpc_tpu import flags as ref_flags
from brpc_tpu import rpcz as ref_rpcz
from brpc_tpu.models import runner as R
from brpc_tpu.rpc import meta as RM
from brpc_tpu.rpc.rpc_dump import RpcDumper as RefDumper
from brpc_tpu.serving import DecodeEngine as RefEngine
from brpc_tpu.serving.service import register_serving as ref_register
from brpc_tpu.tools import rpc_replay as ref_replay
import brpc_tpu_torch.rpc as rpc
from brpc_tpu_torch import flags, rpcz
from brpc_tpu_torch.butil.endpoint import str2endpoint
from brpc_tpu_torch.models import runner as T
from brpc_tpu_torch.policy import health_check
from brpc_tpu_torch.rpc import meta as PM
from brpc_tpu_torch.rpc import rpc_dump
from brpc_tpu_torch.serving import DecodeEngine, register_serving
from brpc_tpu_torch.tools import rpc_replay

from testutil import wait_until
from test_torch_runner import JCFG, JPARAMS, NEW, PROMPTS, TCFG, _tparams

PKG = {"port": rpc, "ref": ref}
FLAGS = {"port": flags, "ref": ref_flags}
DUMPER = {"port": rpc_dump.RpcDumper, "ref": RefDumper}
REPLAY = {"port": rpc_replay, "ref": ref_replay}
DUMP_FLAGS = ("rpc_dump", "rpc_dump_dir", "rpc_dump_ratio",
              "rpc_dump_max_files", "rpc_dump_max_requests_in_one_file")


@pytest.fixture(autouse=True, scope="module")
def _retire_health_probes():
    yield
    time.sleep(0.1)      # a socket may fail just after its server stopped
    health_check.reset_all()


def _recorder(mod):
    """An echo service for either package that records each request as
    its handler saw it."""

    class Rec(mod.Service):
        @mod.method(request="json", response="json")
        def Echo(self, cntl, req):
            seen.append(("Echo", req, bytes(cntl.request_attachment)))
            return {"msg": req["msg"]}

        @mod.method(request="raw", response="raw")
        def Raw(self, cntl, req):
            seen.append(("Raw", bytes(req), bytes(cntl.request_attachment)))
            return bytes(req)[::-1]

    seen = []
    svc = Rec()
    svc.seen = seen
    return svc


@pytest.fixture(scope="module")
def servers():
    out = {}
    for name, mod in PKG.items():
        srv = mod.Server() if name == "port" else \
            mod.Server(has_builtin_services=False)
        svc = _recorder(mod)
        srv.add_service(svc)
        srv.start("127.0.0.1", 0)
        out[name] = (srv, svc)
    yield out
    for srv, _ in out.values():
        srv.stop()
        srv.join()


@pytest.fixture
def dump(tmp_path):
    """Each package dumping into its own directory under tmp_path (off
    until a test sets ``rpc_dump``); everything restored after."""
    saved = {n: {f: m.get_flag(f) for f in DUMP_FLAGS}
             for n, m in FLAGS.items()}
    for n, m in FLAGS.items():
        m.set_flag("rpc_dump_dir", str(tmp_path / n), force=True)
    yield tmp_path
    for n, m in FLAGS.items():
        m.set_flag("rpc_dump", False, force=True)
        DUMPER[n].instance().close()
        for f, v in saved[n].items():
            m.set_flag(f, v, force=True)


def _capture(which, enable=True):
    FLAGS[which].set_flag("rpc_dump", enable, force=True)


def _stop_capture(which):
    FLAGS[which].set_flag("rpc_dump", False, force=True)
    DUMPER[which].instance().close()


def _calls(srv, n, client="port"):
    """n requests of three shapes from ``client``'s channel: plain json,
    raw with gzip and an attachment, json with zlib; returns what each
    handler must see."""
    mod = PKG[client]
    ch = mod.Channel(f"127.0.0.1:{srv.port}", timeout_ms=10_000)
    want = []
    for i in range(n):
        kind = i % 3
        if kind == 1:
            cntl = mod.Controller()
            cntl.compress_type = RM.COMPRESS_GZIP
            cntl.request_attachment = f"att{i}".encode()
            body = bytes(range(i, i + 40)) * 3
            ch.call_sync("Rec", "Raw", body, serializer="raw", cntl=cntl)
            want.append(("Raw", body, f"att{i}".encode()))
        else:
            cntl = mod.Controller()
            if kind == 2:
                cntl.compress_type = RM.COMPRESS_ZLIB
            req = {"msg": f"m{i}" * (i + 1)}
            ch.call_sync("Rec", "Echo", req, serializer="json", cntl=cntl)
            want.append(("Echo", req, b""))
    return want


@pytest.mark.parametrize("which", ["port", "ref"])
def test_dump_holds_one_record_per_request_with_its_wire_meta(
        servers, dump, which):
    srv, svc = servers[which]
    _capture(which)
    want = _calls(srv, 6, client="ref" if which == "port" else "port")
    _stop_capture(which)
    recs = rpc_replay.load_records(str(dump / which))
    assert recs == ref_replay.load_records(str(dump / which))
    assert len(recs) == len(want)
    for (meta_bytes, body), (method, _, att) in zip(recs, want):
        for M in (PM, RM):
            meta = M.RpcMeta.decode(meta_bytes)
            assert (meta.service, meta.method) == ("Rec", method)
            assert meta.msg_type == M.MSG_REQUEST
            assert meta.attachment_size == len(att)
        if att:
            assert body.endswith(att)


@pytest.mark.parametrize("target", ["port", "ref"])
@pytest.mark.parametrize("tool", ["port", "ref"])
@pytest.mark.parametrize("which", ["port", "ref"])
def test_rdump_replays_across_packages(servers, dump, which, tool, target):
    """Captured by ``which``'s server, replayed by ``tool``'s
    ``run_replay`` against ``target``'s server: 0 errors, and the target
    sees the captured requests (pipelined, so in any order)."""
    _capture(which)
    want = _calls(servers[which][0], 6)
    _stop_capture(which)
    tsrv, tsvc = servers[target]
    tsvc.seen.clear()
    out = io.StringIO()
    summary = REPLAY[tool].run_replay(f"127.0.0.1:{tsrv.port}",
                                      str(dump / which), out=out)
    assert summary["replayed"] == len(want) and summary["errors"] == 0
    assert json.loads(out.getvalue())["errors"] == 0
    assert _same(tsvc.seen, want)


def _same(seen, want):
    """The same requests, in any order."""
    return sorted(map(repr, seen)) == sorted(map(repr, want))


def test_replay_cli_prints_its_summary(servers, dump, capsys):
    _capture("port")
    _calls(servers["port"][0], 3)
    _stop_capture("port")
    rpc_replay.main(["--server", f"127.0.0.1:{servers['port'][0].port}",
                     "--dir", str(dump / "port"), "--times", "2"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["replayed"] == 6 and summary["errors"] == 0
    empty = io.StringIO()
    assert rpc_replay.run_replay("127.0.0.1:1", str(dump / "none"),
                                 out=empty) == {"replayed": 0, "errors": 0}
    assert "no records found" in empty.getvalue()


def test_replay_to_a_dead_server_counts_errors(servers, dump):
    _capture("port")
    _calls(servers["port"][0], 2)
    _stop_capture("port")
    summary = rpc_replay.run_replay("127.0.0.1:1", str(dump / "port"),
                                    timeout_ms=2000, out=io.StringIO())
    assert summary["replayed"] == 0 and summary["errors"] == 2


def test_ratio_keeps_one_request_in_n(servers, dump):
    flags.set_flag("rpc_dump_ratio", 3, force=True)
    _capture("port")
    want = _calls(servers["port"][0], 9)
    _stop_capture("port")
    recs = rpc_replay.load_records(str(dump / "port"))
    assert len(recs) == 3
    got = [PM.RpcMeta.decode(m).method for m, _ in recs]
    k = [w[0] for w in want].index(got[0])
    assert got == [want[k][0], want[k + 3][0], want[k + 6][0]]


def test_rotation_keeps_the_newest_files(servers, dump):
    flags.set_flag("rpc_dump_max_requests_in_one_file", 2, force=True)
    flags.set_flag("rpc_dump_max_files", 2, force=True)
    _capture("port")
    srv, svc = servers["port"]
    _calls(srv, 7)
    _stop_capture("port")
    files = sorted(os.listdir(dump / "port"))
    assert len(files) == 2 and all(f.endswith(".rdump") for f in files)
    # 7 records, 2 a file: the newest two files hold the last 3, in order
    svc.seen.clear()
    summary = rpc_replay.run_replay(f"127.0.0.1:{srv.port}",
                                    str(dump / "port"), out=io.StringIO())
    assert summary["errors"] == 0
    assert _same(svc.seen, _expected(7)[4:])


def _expected(n):
    """What _calls(n) makes the handler see, without calling."""
    out = []
    for i in range(n):
        if i % 3 == 1:
            out.append(("Raw", bytes(range(i, i + 40)) * 3,
                        f"att{i}".encode()))
        else:
            out.append(("Echo", {"msg": f"m{i}" * (i + 1)}, b""))
    return out


def test_flag_off_never_reaches_the_sampler(servers, dump, monkeypatch):
    hits = []
    monkeypatch.setattr(rpc_dump.RpcDumper, "sample",
                        lambda self, *a: hits.append(a))
    _calls(servers["port"][0], 3)
    assert hits == []
    _capture("port")
    _calls(servers["port"][0], 3)
    assert len(hits) == 3


# ---------------------------------------------------------------------------
# a captured streaming Generate, replayed without its client stream
# ---------------------------------------------------------------------------

class _PortServing:
    def __init__(self, name):
        self.store = T.make_store_for(TCFG, page_tokens=4, max_blocks=16,
                                      device="cpu", name=name)
        self.engine = DecodeEngine(
            runner=T.TransformerRunner(_tparams(), TCFG, store=self.store,
                                       device="cpu", name=name),
            store=self.store, num_slots=2, max_pages_per_slot=24,
            prefill_buckets=(8, 16), device="cpu", name=name)
        self.server = rpc.Server()
        register_serving(self.server, engine=self.engine)
        self.server.start("127.0.0.1", 0)

    def close(self):
        self.server.stop()
        self.server.join()
        self.engine.close()
        self.store.clear()


class _RefServing:
    """The JAX package's engine at the same geometry as
    test_torch_serving_service.py's, so the two share their compiles."""

    def __init__(self, name):
        self.store = R.make_store_for(JCFG, page_tokens=4, max_blocks=16,
                                      name=name + "_kv")
        self.engine = RefEngine(
            runner=R.TransformerRunner(JPARAMS, JCFG, store=self.store,
                                       name=name),
            num_slots=2, store=self.store, max_pages_per_slot=24,
            prefill_buckets=(8, 16), name=name + "_eng")
        self.server = ref.Server(has_builtin_services=False)
        ref_register(self.server, engine=self.engine,
                     http_generate_path=None)
        self.server.start("127.0.0.1", 0)

    def close(self):
        self.server.stop()
        self.server.join()
        self.engine.close()
        self.store.clear()
        self.store.close()


def test_streaming_generate_replays_without_its_stream_as_reference(dump):
    prompt = list(PROMPTS[0])
    src = _PortServing("t_torch_dump_src")
    try:
        _capture("port")
        msgs, closed = [], threading.Event()

        class Collect(rpc.StreamHandler):
            def on_received_messages(self, stream, batch):
                msgs.extend(json.loads(m) for m in batch)

            def on_closed(self, stream):
                closed.set()

        cntl = rpc.Controller()
        rpc.stream_create(cntl, Collect())
        resp = rpc.Channel(f"127.0.0.1:{src.server.port}",
                           timeout_ms=30_000).call_sync(
            "Serving", "Generate", {"prompt": prompt, "max_new_tokens": NEW},
            serializer="json", cntl=cntl)
        assert resp["accepted"] and closed.wait(60), msgs
        _stop_capture("port")
        toks = [m["token"] for m in msgs if "token" in m]
        assert len(toks) == NEW and msgs[-1] == {"done": True}
    finally:
        src.close()
    (meta_bytes, body), = rpc_replay.load_records(str(dump / "port"))
    meta = PM.RpcMeta.decode(meta_bytes)
    assert (meta.service, meta.method) == ("Serving", "Generate")
    assert meta.stream_id != 0       # captured with its client stream
    answers = {}
    for name, cls in (("port", _PortServing), ("ref", _RefServing)):
        tgt = cls(f"t_torch_dump_{name}")
        try:
            c = rpc_replay.replay_one(
                str2endpoint(f"127.0.0.1:{tgt.server.port}"),
                meta_bytes, body, timeout_ms=30_000)
            c.join(5.0)     # past its 30 s deadline: 5 s more at most
            assert c.error_code == 0, c.error_text
            # the generation runs to its end on the target, its stream
            # frames finding no reader on the replaying side
            assert tgt.engine.join_idle(60)
            answers[name] = (c.response, tgt.engine.stats()["tokens"])
        finally:
            tgt.close()
    (pr, ptoks), (rr, rtoks) = answers["port"], answers["ref"]
    assert set(pr) == set(rr) == {"accepted", "req_id", "prefix_hit"}
    assert pr["accepted"] is rr["accepted"] is True
    assert pr["prefix_hit"] == rr["prefix_hit"] == 0
    assert ptoks == rtoks == NEW


# ---------------------------------------------------------------------------
# the span database
# ---------------------------------------------------------------------------

RZ = {"port": rpcz, "ref": ref_rpcz}


def _span_tree(mod, trace_id=None):
    """A client -> server -> child tree of spans in ``mod``'s rpcz."""
    root = mod.new_span("client", "Rec", "Echo", trace_id=trace_id or 0)
    kids = [mod.new_span("server", "Rec", "Echo", trace_id=root.trace_id,
                         parent_span_id=root.span_id)]
    kids.append(mod.new_span("decode", "Serving", "eng",
                             trace_id=root.trace_id,
                             parent_span_id=kids[0].span_id))
    kids[1].annotate("kv: 3 pages")
    kids[0].error_code = 1011
    kids[0].recovered_from = 17
    kids[1].migrated_from = 23
    for s in (root, *kids):
        s.remote_side = "127.0.0.1:1"
        s.request_size, s.response_size = 11, 22
        s.end_us = s.start_us + 5
    return [root, *kids]


def _fields(spans):
    keys = ("trace_id", "span_id", "parent_span_id", "service", "method",
            "remote_side", "start_us", "end_us", "request_size",
            "response_size", "error_code", "kind", "recovered_from",
            "migrated_from")
    return sorted((tuple(getattr(s, k) for k in keys)
                   + (tuple(map(tuple, s.annotations)),)) for s in spans)


@pytest.fixture
def span_dbs(tmp_path):
    """Tracing on in both packages, each with its own span database."""
    was = (rpcz.enabled(), ref_rpcz.enabled())
    for n, mod in RZ.items():
        mod.set_enabled(True)
        mod.set_database_dir(str(tmp_path / n))
    yield tmp_path
    for n, mod in RZ.items():
        mod.set_database_dir(None)
    rpcz.set_enabled(was[0])
    ref_rpcz.set_enabled(was[1])


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_span_segments_load_across_packages(span_dbs, writer):
    reader = "ref" if writer == "port" else "port"
    w, r = RZ[writer], RZ[reader]
    spans = _span_tree(w)
    for s in spans:
        w.submit(s)
    w.flush()
    got = w.load_disk_spans(100, spans[0].trace_id)
    assert _fields(got) == _fields(spans)
    # the reader points its database at the writer's segments
    r.set_database_dir(str(span_dbs / writer))
    theirs = r.load_disk_spans(100, spans[0].trace_id)
    assert _fields(theirs) == _fields(spans)
    assert [r.span_to_dict(s) for s in sorted(theirs, key=_key)] == \
        [w.span_to_dict(s) for s in sorted(got, key=_key)]
    assert [_fields([r.span_from_dict(w.span_to_dict(s))]) for s in spans] \
        == [_fields([s]) for s in spans]


def _key(s):
    return s.span_id


@pytest.mark.parametrize("which", ["port", "ref"])
def test_segments_rotate_and_prune(span_dbs, monkeypatch, which):
    """At a small rotation size every few spans open a new segment; the
    newest 4 segments are kept, and they load back in order."""
    mod = RZ[which]
    monkeypatch.setattr(mod, "_DB_ROTATE_BYTES", 600)
    mod.set_database_dir(str(span_dbs / f"rot_{which}"))
    tid = None
    spans = []
    for _ in range(8):
        tree = _span_tree(mod, tid)
        tid = tree[0].trace_id
        for s in tree:
            mod.submit(s)
            mod.flush()
            time.sleep(0.002)       # segment names are microsecond stamps
        spans += tree
    segs = sorted(os.listdir(span_dbs / f"rot_{which}"))
    assert len(segs) == 4 and all(f.startswith("spans-") for f in segs)
    got = mod.load_disk_spans(1000, tid)
    assert 0 < len(got) < len(spans)
    # what survived is the newest spans, oldest first
    assert [s.span_id for s in got] == \
        [s.span_id for s in spans[-len(got):]]
    assert mod.load_disk_spans(2, tid)[-1].span_id == spans[-1].span_id


def test_rpcz_trace_id_reads_the_database_after_the_store_lost_it(
        span_dbs, servers):
    srv = servers["port"][0]

    def get(path):
        c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
        c.request("GET", path)
        r = c.getresponse()
        body = r.read()
        c.close()
        return r.status, body.decode()

    # the console's /flags switches the database
    db = span_dbs / "flagged"
    assert get(f"/flags?setvalue=rpcz_database_dir&value={db}") \
        == (200, "ok\n")
    root = rpcz.new_span("client", "Rec", "Echo")
    rpcz.set_current_span(root)
    try:
        rpc.Channel(f"127.0.0.1:{srv.port}", timeout_ms=5000).call_sync(
            "Rec", "Echo", {"msg": "traced"}, serializer="json")
    finally:
        rpcz.set_current_span(None)
    rpcz.submit(root)
    tid = root.trace_id

    def tree():
        return sorted((s.kind, s.service, s.method, s.parent_span_id)
                      for s in rpcz.recent_spans(2048, tid))

    # the server submits its span after the response is out
    assert wait_until(lambda: any(k == "server" for k, *_ in tree()), 10)
    before = tree()
    status, page = get(f"/rpcz?trace_id={tid}")
    with rpcz._collect_lock:
        rpcz._collected.clear()      # the bounded store lost the trace
    assert rpcz.recent_spans(2048, tid) == []
    disk = sorted((s.kind, s.service, s.method, s.parent_span_id)
                  for s in rpcz.load_disk_spans(2048, tid))
    assert disk == before
    assert get(f"/rpcz?trace_id={tid}") == (status, page)
    assert os.listdir(db) and flags.get_flag("rpcz_database_dir") == str(db)
    assert get("/flags?setvalue=rpcz_database_dir&value=") == (200, "ok\n")
    assert rpcz.load_disk_spans(10, tid) == []
