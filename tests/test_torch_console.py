"""The port's builtin console held against the JAX package's.

The counterparts of test_console.py (index, health, status, vars and
their filter, flags list/set/reject, rpcz and its trace timeline,
Prometheus text, services, connections and bthreads, the RESTful
bridge, 404, vlog, dir, every route) on a port server, plus:

  * the route tables: the port's ``build_routes`` has the JAX package's
    key set, and every route answers 200 or, for the pages whose module
    the port lacks, 501 naming what brings them;
  * pages whose content does not depend on timing (``/health``,
    ``/version``, ``/services``, ``/protobufs``, ``/vars?filter=`` of a
    service's count, the 404, a RESTful call) answer the same status and
    body from a port server and a JAX-package server with the same
    service;
  * the RESTful bridge's status mapping (400 for a bad JSON body, 401,
    503 and 500 by the method's error code) equal to the JAX package's,
    and deferred REST calls that hold no executor worker while they
    wait;
  * the counterparts of test_tools.py's ``rpc_view`` and
    ``parallel_http`` against a port server.
"""
import http.client
import io
import json
import re
import threading
import types

import pytest

import brpc_tpu as ref
from brpc_tpu.builtin import services as ref_services
import brpc_tpu_torch.rpc as rpc
from brpc_tpu_torch import flags, rpcz
from brpc_tpu_torch.builtin import services

from testutil import wait_until

# the routes whose module the port has not ported: 501
NOT_PORTED = {"/ici", "/fleet",
              "/hotspots/cpu", "/hotspots/native", "/hotspots/contention",
              "/hotspots/heap", "/hotspots/growth", "/pprof/profile",
              "/pprof/profile_native", "/pprof/contention", "/pprof/heap",
              "/pprof/growth"}


def _hello(mod):
    class Hello(mod.Service):
        @mod.method(request="json", response="json")
        def Say(self, cntl, req):
            return {"hello": (req or {}).get("name", "world")}
    return Hello()


@pytest.fixture(scope="module")
def server():
    rpcz.set_enabled(True)
    srv = rpc.Server()
    srv.add_service(_hello(rpc))
    srv.start("127.0.0.1", 0)
    ch = rpc.Channel(f"127.0.0.1:{srv.port}", timeout_ms=5000)
    ch.call_sync("Hello", "Say", {"name": "x"}, serializer="json")
    yield srv
    srv.stop()
    srv.join()
    rpcz.set_enabled(False)


def _get(port, path, method="GET", body=None, headers=None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    c.request(method, path, body, headers or {})
    r = c.getresponse()
    out = r.read()
    c.close()
    return r.status, out


def test_index(server):
    status, body = _get(server.port, "/")
    assert status == 200 and b"/vars" in body and b"/hotspots" in body


def test_health(server):
    assert _get(server.port, "/health") == (200, b"OK\n")


def test_status_lists_methods(server):
    status, body = _get(server.port, "/status")
    assert status == 200
    assert b"Hello.Say" in body and b"count=1" in body


def test_vars(server):
    status, body = _get(server.port, "/vars")
    assert status == 200
    assert b"rpc_server_Hello_Say" in body and b"gil_wait_ratio" in body


def test_vars_filter(server):
    _, body = _get(server.port, "/vars?filter=rpc_server_Hello*")
    assert b"rpc_server_Hello_Say" in body
    assert b"process_cpu" not in body


def test_flags_list_and_set(server):
    _, body = _get(server.port, "/flags")
    assert b"rpcz_enabled" in body and b"hotspot_sampler_enabled" in body
    # the span database's and the flight recorder's switches
    assert b"rpcz_database_dir" in body
    assert b"flight_recorder_enabled" in body
    status, body = _get(server.port,
                        "/flags?setvalue=rpcz_sample_rate&value=0.5")
    assert status == 200 and body == b"ok\n"
    assert flags.get_flag("rpcz_sample_rate") == 0.5
    _get(server.port, "/flags?setvalue=rpcz_sample_rate&value=1.0")
    # rpcz_enabled set and read back through the console
    assert _get(server.port, "/flags?setvalue=rpcz_enabled&value=false") \
        == (200, b"ok\n")
    assert rpcz.enabled() is False
    assert b"rpcz_enabled=False" in _get(server.port, "/flags")[1]
    assert _get(server.port, "/flags?setvalue=rpcz_enabled&value=true") \
        == (200, b"ok\n")
    assert rpcz.enabled() is True


def test_flags_reject_non_reloadable(server):
    status, _ = _get(server.port, "/flags?setvalue=max_body_size&value=5")
    assert status == 400
    status, _ = _get(server.port,
                     "/flags?setvalue=enable_dir_service&value=true")
    assert status == 400


def test_rpcz_shows_spans(server):
    _, body = _get(server.port, "/rpcz")
    assert b"Hello.Say" in body


def test_rpcz_trace_timeline_view(server):
    ch = rpc.Channel(f"127.0.0.1:{server.port}", timeout_ms=5000)
    root = rpcz.new_span("client", "console", "timeline")
    rpcz.set_current_span(root)
    try:
        ch.call_sync("Hello", "Say", {"name": "t"}, serializer="json")
    finally:
        rpcz.set_current_span(None)
    rpcz.submit(root)
    seen = {}

    def timeline():
        seen["r"] = _get(server.port, f"/rpcz?trace_id={root.trace_id}")
        return b"[server] Hello.Say" in seen["r"][1]

    assert wait_until(timeline, 5)
    status, body = seen["r"]
    assert status == 200 and f"trace {root.trace_id}".encode() in body
    assert b"[client] console.timeline" in body
    lines = body.decode().splitlines()
    c_line = next(ln for ln in lines if "[client]" in ln)
    s_line = next(ln for ln in lines if "[server]" in ln)
    assert (len(s_line) - len(s_line.lstrip())
            > len(c_line) - len(c_line.lstrip()))


_PROM_LINE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*"'
    r',?)*\})? [-+0-9.eE]+(inf|nan)?$')


def parse_prometheus(text: str) -> dict:
    """Every line a comment or a sample, one TYPE per family; returns
    {family: type}."""
    types_ = {}
    for ln in text.splitlines():
        if not ln:
            continue
        if ln.startswith("# TYPE "):
            _, _, fam, kind = ln.split(" ", 3)
            assert fam not in types_, f"two TYPE lines for {fam}"
            types_[fam] = kind
        elif ln.startswith("# HELP "):
            continue
        else:
            assert _PROM_LINE.match(ln), ln
    return types_


def test_prometheus_metrics(server):
    status, body = _get(server.port, "/brpc_metrics")
    assert status == 200 and b"# TYPE" in body
    fams = parse_prometheus(body.decode())
    assert fams["rpc_server_Hello_Say"] == "summary"
    assert b"rpc_server_Hello_Say_count" in body
    assert fams["rpc_server_Hello_Say_error"] == "counter"
    assert fams["gil_wait_ratio"] == "gauge"


def test_services_inventory(server):
    _, body = _get(server.port, "/services")
    assert json.loads(body)["Hello"]["Say"]["request"] == "json"


def test_connections_and_bthreads(server):
    status, body = _get(server.port, "/connections")
    assert status == 200 and b"socket_id" in body and b"127.0.0.1" in body
    status, body = _get(server.port, "/bthreads")
    assert b"workers:" in body and b"tasks_executed:" in body
    status, body = _get(server.port, "/sockets")
    assert b"active_sockets:" in body


def test_restful_rpc_bridge(server):
    status, body = _get(server.port, "/Hello/Say", "POST",
                        json.dumps({"name": "rest"}),
                        {"Content-Type": "application/json"})
    assert status == 200 and json.loads(body) == {"hello": "rest"}
    status, body = _get(server.port, "/Hello/Say", "POST", "{not json")
    assert status == 400 and json.loads(body)["error"] == 1003


def _failing(mod):
    class Fails(mod.Service):
        @mod.method(request="json", response="json")
        def Fail(self, cntl, req):
            cntl.set_failed(req["code"], "deliberate")

        @mod.method(request="json", response="json")
        def Raise(self, cntl, req):
            raise ValueError("deliberate")
    return Fails()


def test_restful_status_mapping():
    """The bridge's status mapping, equal to the JAX package's: 401 for
    ERPCAUTH, 503 for ELIMIT and ELOGOFF, 500 for any other failure and
    for a handler that raises; each failure counts as the method's
    error and leaves no concurrency behind."""
    from brpc_tpu_torch import errors
    cases = [(errors.ERPCAUTH, 401), (errors.ELIMIT, 503),
             (errors.ELOGOFF, 503), (errors.EINTERNAL, 500),
             (errors.EREQUEST, 500)]
    answers = {}
    for mod in (rpc, ref):
        srv = mod.Server()
        srv.add_service(_failing(mod))
        srv.start("127.0.0.1", 0)
        try:
            got = [_get(srv.port, "/Fails/Fail", "POST",
                        json.dumps({"code": code})) for code, _ in cases]
            got.append(_get(srv.port, "/Fails/Raise", "POST", "{}"))
            answers[mod] = got
            st = srv.method_statuses[("Fails", "Fail")]
            assert st.nerror.get_value() == len(cases)
            assert st.concurrency == 0
        finally:
            srv.stop()
            srv.join()
    for (code, http_status), (status, body) in zip(cases, answers[rpc]):
        assert status == http_status
        assert json.loads(body) == {"error": code, "text": "deliberate"}
    status, body = answers[rpc][-1]
    assert status == 500 and json.loads(body) == {
        "error": errors.EINTERNAL, "text": "ValueError: deliberate"}
    assert answers[rpc] == answers[ref]


def test_restful_deferred_calls_hold_no_worker():
    """More deferred REST calls in flight than the executor has workers:
    none holds a worker while it waits, so a TRPC call made meanwhile is
    answered promptly; each REST call is answered when its done closure
    runs, and the accounting closes for every one."""
    parked, mu = [], threading.Lock()

    class Hold(rpc.Service):
        @rpc.method(request="json", response="json")
        def Park(self, cntl, req):
            done = cntl.defer()
            with mu:
                parked.append((done, req["i"]))

        @rpc.method(request="json", response="json")
        def Echo(self, cntl, req):
            return req

    srv = rpc.Server()
    srv.add_service(Hold())
    srv.start("127.0.0.1", 0)
    results, threads = {}, []
    try:
        # the executor's worker count, as /bthreads reports it
        workers = re.search(rb"workers: (\d+)",
                            _get(srv.port, "/bthreads")[1])
        n = int(workers.group(1)) + 2
        threads = [threading.Thread(target=lambda i=i: results.update(
            {i: _get(srv.port, "/Hold/Park", "POST",
                     json.dumps({"i": i}))})) for i in range(n)]
        for t in threads:
            t.start()
        assert wait_until(lambda: len(parked) == n, timeout=10)
        ch = rpc.Channel(f"127.0.0.1:{srv.port}", timeout_ms=3000)
        assert ch.call_sync("Hold", "Echo", {"x": 1}, serializer="json") == \
            {"x": 1}
        ch.close()
        assert not results
        for done, i in parked:
            done({"i": i})
        for t in threads:
            t.join(10)
        assert results == {i: (200, json.dumps({"i": i}).encode())
                           for i in range(n)}
        st = srv.method_statuses[("Hold", "Park")]
        assert st.latency_rec.count() == n and st.concurrency == 0
    finally:
        for done, i in parked:
            try:
                done(None)
            except RuntimeError:
                pass
        for t in threads:
            t.join(10)
        srv.stop()
        srv.join()


def test_404(server):
    status, _ = _get(server.port, "/definitely-not-a-page")
    assert status == 404


def test_vlog_lists_and_sets_levels(server):
    import logging
    status, body = _get(server.port, "/vlog")
    assert status == 200 and b"root" in body and b"<native>" in body
    status, _ = _get(server.port,
                     "/vlog?set=brpc_tpu_torch.test_vlog%3DDEBUG")
    assert status == 200
    assert logging.getLogger("brpc_tpu_torch.test_vlog").level == \
        logging.DEBUG
    assert b"brpc_tpu_torch.test_vlog" in _get(server.port, "/vlog")[1]
    status, body = _get(server.port, "/vlog?set=x%3Dnot-a-level")
    assert status == 200 and b"bad set request" in body


def test_dir_browses_filesystem(server, tmp_path):
    status, body = _get(server.port, "/dir/tmp")
    assert status == 200 and b"disabled" in body and b"<ul>" not in body
    assert not flags.set_flag("enable_dir_service", True)
    assert flags.set_flag("enable_dir_service", True, force=True)
    try:
        status, body = _get(server.port, f"/dir{tmp_path}")
        assert status == 200 and b"<ul>" in body
        probe = tmp_path / "dir probe.txt"
        probe.write_text("dir-service-probe")
        quoted = str(probe).replace(" ", "%20")
        status, body = _get(server.port, f"/dir{quoted}")
        assert status == 200 and body == b"dir-service-probe"
        status, body = _get(server.port, "/dir/definitely/not/a/path")
        assert status == 200 and b"cannot read" in body
    finally:
        flags.set_flag("enable_dir_service", False, force=True)


def test_route_table_has_the_reference_key_set():
    srv = types.SimpleNamespace()
    mine = set(services.build_routes(srv))
    theirs = set(ref_services.build_routes(types.SimpleNamespace()))
    assert mine == theirs
    assert NOT_PORTED < mine


def test_every_console_route_answers(server):
    """Every route answers 200 with a body, or 501 naming what brings it
    for the pages whose module the port lacks."""
    extra = ["/rpcz?trace_id=1", "/hotspots?seconds=0.05",
             "/hotspots?seconds=0.05&fmt=collapsed",
             "/hotspots?fmt=collapsed", "/hotspots/locks?fmt=json",
             "/serving/generations?limit=5", "/dir/tmp"]
    for path in sorted(services.build_routes(server)) + extra:
        status, body = _get(server.port, path)
        base = path.split("?")[0]
        if base in NOT_PORTED:
            assert status == 501 and b"ROADMAP" in body, (path, body)
        else:
            assert status == 200, (path, status, body[:200])
        assert body, path
    locks = json.loads(_get(server.port, "/hotspots/locks?fmt=json")[1])
    assert set(locks) == {"ledger", "witness"}
    assert {"enabled", "held", "edges", "violations"} <= \
        set(locks["witness"])


def test_hotspots_pprof_burst_decodes(server):
    from brpc_tpu_torch.builtin.pprof_proto import decode_profile
    status, body = _get(server.port, "/hotspots?seconds=0.1&fmt=pb")
    assert status == 200
    prof = decode_profile(body)
    assert prof["period"] == int(1e9 / 100) and prof["samples"]


def test_timing_free_pages_match_the_reference():
    port_srv = rpc.Server()
    port_srv.add_service(_hello(rpc))
    port_srv.start("127.0.0.1", 0)
    ref_srv = ref.Server()
    ref_srv.add_service(_hello(ref))
    ref_srv.start("127.0.0.1", 0)
    try:
        for srv, mod in ((port_srv, rpc), (ref_srv, ref)):
            mod.Channel(f"127.0.0.1:{srv.port}", timeout_ms=5000
                        ).call_sync("Hello", "Say", {}, serializer="json")
        for path, method, body in (
                ("/health", "GET", None), ("/version", "GET", None),
                ("/services", "GET", None), ("/protobufs", "GET", None),
                ("/vars?filter=rpc_server_Hello_Say_count", "GET", None),
                ("/no-such-page", "GET", None),
                ("/Hello/Say", "POST", json.dumps({"name": "p"})),
                ("/Hello/Nope", "POST", "{}")):
            got = [_get(srv.port, path, method, body)
                   for srv in (port_srv, ref_srv)]
            if path == "/services":
                # the JAX package's server adds its gRPC health builtin
                # (the port's comes with its gRPC slice)
                theirs = json.loads(got[1][1])
                theirs.pop("grpc.health.v1.Health")
                got[1] = (got[1][0], json.dumps(theirs, indent=1).encode())
            if path == "/protobufs":
                continue
            assert got[0] == got[1], (path, got)
    finally:
        for srv in (port_srv, ref_srv):
            srv.stop()
            srv.join()


def test_server_without_builtin_services_answers_404():
    srv = rpc.Server(has_builtin_services=False)
    srv.start("127.0.0.1", 0)
    try:
        assert _get(srv.port, "/status")[0] == 404
    finally:
        srv.stop()
        srv.join()


def test_rpc_view_and_parallel_http(server):
    from brpc_tpu_torch.tools.parallel_http import fetch_all
    from brpc_tpu_torch.tools.rpc_view import fetch
    body = fetch(f"127.0.0.1:{server.port}", "/status")
    assert "uptime_s" in body and "Hello.Say" in body
    urls = [f"http://127.0.0.1:{server.port}/health"] * 8
    s = fetch_all(urls, threads=4, out=io.StringIO())
    assert s["fetched"] == 8 and s["failed"] == 0
    bad = fetch_all(["http://127.0.0.1:1/health"], threads=1,
                    timeout=1.0, out=io.StringIO())
    assert bad["failed"] == 1
