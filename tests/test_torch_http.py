"""The port's HTTP/1.1 face held against the JAX package.

  * parser parity: the port's ``HttpRequest`` parses a seeded corpus (the
    valid requests of test_fuzz_parsers.py's HTTP target, their
    truncations, bit flips and random bytes) exactly as the JAX
    package's does -- the same method, path, query, headers and body, or
    the same exception type -- and ``http_response`` frames the same
    bytes over seeded statuses, bodies and headers; ``CaseIgnoredDict``,
    ``MRUCache`` and ``MultiDimension`` behave alike;
  * ``HttpChannel`` across packages: the counterparts of
    test_http_client.py, each in three directions (port client to JAX
    server, JAX client to port server, port to port);
  * HTTP naming: the counterparts of test_naming_http.py with a port
    server as the registry and port channels resolving through it.
"""
import json
import random
import threading
import time

import pytest

import brpc_tpu as ref
from brpc_tpu import errors as ref_errors
from brpc_tpu.builtin import router as ref_router
from brpc_tpu.butil import containers as ref_containers
from brpc_tpu.bvar import multi_dimension as ref_md
from brpc_tpu.bvar.reducer import Adder as RefAdder
import brpc_tpu_torch.rpc as rpc
from brpc_tpu_torch import errors
from brpc_tpu_torch.builtin import router
from brpc_tpu_torch.butil import containers
from brpc_tpu_torch.bvar import multi_dimension as md
from brpc_tpu_torch.bvar.reducer import Adder
from brpc_tpu_torch.policy import health_check
from brpc_tpu_torch.policy import naming as NS

SEED = 0xC0FFEE


@pytest.fixture(autouse=True, scope="module")
def _retire_health_probes():
    yield
    time.sleep(0.1)      # a socket may fail just after its server stopped
    health_check.reset_all()


# ---- parser parity ----------------------------------------------------------

def _corpus(valid, rng, rounds=300):
    """Random bytes, truncations and bit flips of valid requests (the
    shape of test_fuzz_parsers.py's corpora)."""
    for _ in range(rounds):
        yield rng.randbytes(rng.randrange(0, 64))
    for v in valid:
        for cut in range(0, len(v), max(1, len(v) // 8)):
            yield v[:cut]
        for _ in range(40):
            b = bytearray(v)
            i = rng.randrange(len(b))
            b[i] ^= 1 << rng.randrange(8)
            yield bytes(b)
        yield v


def _parsed(cls, data):
    try:
        r = cls(data)
        return ("ok", r.method, r.path, r.query, list(r.headers.items()),
                r.body)
    except Exception as e:
        return ("raised", type(e).__name__)


def test_http_request_parses_like_the_reference():
    valid = [
        b"GET /vars?x=1 HTTP/1.1\r\nHost: a\r\n\r\n",
        b"POST /svc/M HTTP/1.1\r\nContent-Length: 3\r\n"
        b"Content-Type: application/json\r\n\r\n{}1",
        b"GET / HTTP/1.0\r\nX-H: " + b"v" * 200 + b"\r\n\r\n",
        b"GET /serving/generate?prompt=1,2,3&max_new_tokens=4 HTTP/1.1"
        b"\r\nhOsT: b\r\nX-Dup: 1\r\nx-dup: 2\r\n\r\n",
    ]
    rng = random.Random(SEED + 41)
    n = 0
    for data in _corpus(valid, rng):
        mine, theirs = _parsed(router.HttpRequest, data), \
            _parsed(ref_router.HttpRequest, data)
        assert mine == theirs, data
        n += 1
    assert n >= 500


def test_http_response_frames_the_reference_bytes():
    rng = random.Random(SEED + 42)
    statuses = (200, 400, 404, 500, 302, 501, 503, 401)
    for _ in range(200):
        status = rng.choice(statuses)
        body = rng.randbytes(rng.randrange(0, 80))
        if rng.random() < 0.5:
            body = body.decode("latin1")
        ctype = rng.choice(["text/plain; charset=utf-8",
                            "application/json", "text/html"])
        extra = {f"X-{i}": str(rng.randrange(1000))
                 for i in range(rng.randrange(0, 3))} or None
        assert router.http_response(status, body, ctype, extra) == \
            ref_router.http_response(status, body, ctype, extra)


def test_containers_behave_like_the_reference():
    for mod in (containers, ref_containers):
        d = mod.CaseIgnoredDict({"Content-Type": "a"})
        d["X-Trace"] = "1"
        assert d["content-type"] == "a" and "x-trace" in d
        assert list(d) == ["Content-Type", "X-Trace"]
        del d["CONTENT-TYPE"]
        assert len(d) == 1 and d.copy()["x-TRACE"] == "1"
    rng = random.Random(SEED + 43)
    ops = [(rng.choice("gp"), rng.randrange(12)) for _ in range(400)]
    traces = []
    for mod in (containers, ref_containers):
        c = mod.MRUCache(capacity=5)
        out = []
        for op, k in ops:
            if op == "p":
                c.put(k, k * 10)
            else:
                out.append(c.get(k, -1))
        traces.append((out, c.hits, c.misses, len(c),
                       [k for k in range(12) if k in c]))
    assert traces[0] == traces[1]
    with pytest.raises(ValueError):
        containers.MRUCache(capacity=0)


def test_multi_dimension_like_the_reference():
    vals = []
    for mod, adder in ((md, Adder), (ref_md, RefAdder)):
        m = mod.MultiDimension(["method", "code"], adder)
        m.get_stats("Echo", 0).add(3)
        m.get_stats("Echo", 1).add(1)
        m.get_stats("Echo", 0).add(2)
        with pytest.raises(ValueError):
            m.get_stats("Echo")
        assert m.has_stats("Echo", "0") and m.count_stats() == 2
        m.delete_stats("Echo", 1)
        vals.append((m.labels, m.get_value(), m.count_stats()))
    assert vals[0] == vals[1] == (["method", "code"], {"Echo/0": 5}, 1)


# ---- HttpChannel in both directions ------------------------------------------

class _Pkg:
    """One package's server-side and client-side names."""

    def __init__(self, mod, errs, transport_mod):
        self.mod, self.errors, self.transport = mod, errs, transport_mod


def _port_pkg():
    from brpc_tpu_torch.rpc import transport
    return _Pkg(rpc, errors, transport)


def _ref_pkg():
    from brpc_tpu.rpc import transport
    return _Pkg(ref, ref_errors, transport)


def _start(pkg):
    mod = pkg.mod

    class Calc(mod.Service):
        @mod.method(request="json", response="json")
        def Add(self, cntl, req):
            return {"sum": req["a"] + req["b"]}

        @mod.method(request="json", response="json")
        def Fail(self, cntl, req):
            cntl.set_failed(pkg.errors.EINTERNAL, "deliberate")
            return None

    srv = mod.Server()
    srv.add_service(Calc())

    def chunked_handler(req):
        def writer(pa):
            def run():
                for i in range(5):
                    pa.write(f"part{i};")
                pa.close()
            threading.Thread(target=run, daemon=True).start()
        return mod.ProgressiveResponse(writer, content_type="text/plain")

    big = b"x" * 300_000

    def big_handler(req):
        def writer(pa):
            def run():
                pa.write(big)
                pa.write(b"END")
                pa.close()
            threading.Thread(target=run, daemon=True).start()
        return mod.ProgressiveResponse(writer)

    def dying_handler(req):
        def writer(pa):
            def run():
                pa.write(b"partial")
                # kill the connection without the terminal chunk
                pkg.transport.Transport.instance().close(pa._sid)
            threading.Thread(target=run, daemon=True).start()
        return mod.ProgressiveResponse(writer)

    srv.add_http_handler("/chunks", chunked_handler)
    srv.add_http_handler("/big", big_handler)
    srv.add_http_handler("/dies", dying_handler)
    srv.add_http_handler("/plain", lambda req: ("hello http", "text/plain"))
    srv.start("127.0.0.1", 0)
    return srv


@pytest.fixture(scope="module")
def servers():
    out = {"port": _start(_port_pkg()), "ref": _start(_ref_pkg())}
    yield out
    for srv in out.values():
        srv.stop()
        srv.join()


# (client package, server package)
DIRECTIONS = [("port", "ref"), ("ref", "port"), ("port", "port")]


def _client(servers, direction, **kw):
    cli, srv = direction
    mod = rpc if cli == "port" else ref
    return mod.HttpChannel(f"127.0.0.1:{servers[srv].port}", **kw), \
        (errors if cli == "port" else ref_errors)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_get_console_page(servers, direction):
    ch, _ = _client(servers, direction)
    r = ch.get("/status")
    assert r.ok and b"Calc.Add" in r.body
    r2 = ch.get("/vars")          # keep-alive: the same connection
    assert r2.ok
    ch.close()


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_custom_handler_and_headers(servers, direction):
    ch, _ = _client(servers, direction)
    r = ch.get("/plain")
    assert r.ok and r.body == b"hello http"
    assert "text/plain" in r.headers["content-type"]
    ch.close()


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_restful_call(servers, direction):
    ch, errs = _client(servers, direction)
    assert ch.call("Calc", "Add", {"a": 2, "b": 40}) == {"sum": 42}
    with pytest.raises(errs.RpcError) as ei:
        ch.call("Calc", "Fail", {})
    assert ei.value.code == errs.EINTERNAL
    with pytest.raises(errs.RpcError):
        ch.call("Nope", "Nothing", {})
    ch.close()


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_chunked_whole_message(servers, direction):
    ch, _ = _client(servers, direction, timeout_ms=5000)
    r = ch.get("/chunks")
    assert r.ok and r.body == b"part0;part1;part2;part3;part4;"
    ch.close()


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_streaming_reader(servers, direction):
    ch, _ = _client(servers, direction)
    got, done = [], threading.Event()
    reader = ch.request_stream("GET", "/chunks", on_data=got.append,
                               on_end=done.set)
    assert reader.wait(5.0) and done.is_set()
    assert b"".join(got) == b"part0;part1;part2;part3;part4;"
    assert reader.response is not None and reader.response.ok
    ch.close()


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_head_request(servers, direction):
    ch, _ = _client(servers, direction)
    r = ch.request("HEAD", "/plain")
    assert r.ok and r.body == b""
    assert int(r.headers["content-length"]) == len(b"hello http")
    ch.close()


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_large_split_chunks(servers, direction):
    """A chunk larger than one TCP segment reassembles, whole and
    streamed (raw mode delivers it in pieces)."""
    ch, _ = _client(servers, direction, timeout_ms=10000)
    r = ch.get("/big")
    assert r.ok and r.body == b"x" * 300_000 + b"END"
    got = []
    reader = ch.request_stream("GET", "/big", on_data=got.append)
    assert reader.wait(10) and reader.error is None
    assert b"".join(got) == b"x" * 300_000 + b"END"
    ch.close()


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_stream_reader_truncation_sets_error(servers, direction):
    ch, _ = _client(servers, direction)
    got = []
    reader = ch.request_stream("GET", "/dies", on_data=got.append)
    assert reader.wait(5)
    assert reader.error is not None
    ch.close()


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_timeout_and_reconnect(servers, direction):
    ch, _ = _client(servers, direction, timeout_ms=2000)
    assert ch.get("/plain").ok
    ch.close()           # sever the connection; the next one reconnects
    r = ch.get("/plain")
    assert r.ok and r.body == b"hello http"
    ch.close()


def test_parse_and_dechunk_match_the_reference():
    from brpc_tpu.rpc import http as ref_http
    from brpc_tpu_torch.rpc import http
    raw = (b"HTTP/1.1 200 OK\r\nTransfer-Encoding: chunked\r\n"
           b"X-A: 1\r\n\r\n5\r\nhello\r\n3;ext=1\r\nabc\r\n0\r\n\r\n")
    for mod in (http, ref_http):
        r = mod.parse_http_response(raw)
        assert (r.status, r.body, r.headers["x-a"]) == (200, b"helloabc",
                                                        "1")
        with pytest.raises(ValueError):
            mod._dechunk(b"5\r\nhel")
    assert http.build_request("POST", "/a", {"X": "1"}, b"{}", "h:1") == \
        ref_http.build_request("POST", "/a", {"X": "1"}, b"{}", "h:1")


# ---- HTTP naming with a port registry ----------------------------------------

class Echo(rpc.Service):
    @rpc.method(request="raw", response="raw")
    def Echo(self, cntl, req):
        return req


@pytest.fixture()
def backend():
    srv = rpc.Server()
    srv.add_service(Echo())
    srv.start("127.0.0.1", 0)
    yield srv
    srv.stop()
    srv.join()


def _registry_server(payload, content_type):
    reg_srv = rpc.Server()
    reg_srv.add_http_handler("/nodes", lambda req: (payload, content_type))
    reg_srv.start("127.0.0.1", 0)
    return reg_srv


def test_remotefile_naming(backend):
    reg_srv = _registry_server(
        f"# registry\n127.0.0.1:{backend.port} 3 0/1\n", "text/plain")
    try:
        ns = NS.RemoteFileNamingService(f"127.0.0.1:{reg_srv.port}/nodes")
        nodes = ns.get_servers()
        assert len(nodes) == 1 and nodes[0].endpoint.port == backend.port
        assert nodes[0].weight == 3 and nodes[0].tag == "0/1"
        ch = rpc.Channel(f"remotefile://127.0.0.1:{reg_srv.port}/nodes")
        assert ch.call_sync("Echo", "Echo", b"via-remotefile") == \
            b"via-remotefile"
        ch.close()      # stops its naming thread
    finally:
        reg_srv.stop()
        reg_srv.join()


@pytest.mark.parametrize("scheme", ["discovery", "consul", "nacos"])
@pytest.mark.parametrize("shape", ["bare", "objects", "wrapped"])
def test_discovery_json_naming(backend, shape, scheme):
    addr = f"127.0.0.1:{backend.port}"
    payload = {
        "bare": json.dumps([addr]),
        "objects": json.dumps([{"addr": addr, "weight": 2, "tag": "a"}]),
        "wrapped": json.dumps({"servers": [{"addr": addr}]}),
    }[shape]
    reg_srv = _registry_server(payload, "application/json")
    try:
        ns = NS.HttpJsonNamingService(f"127.0.0.1:{reg_srv.port}/nodes")
        nodes = ns.get_servers()
        assert len(nodes) == 1 and nodes[0].endpoint.port == backend.port
        if shape == "objects":
            assert nodes[0].weight == 2 and nodes[0].tag == "a"
        ch = rpc.Channel(f"{scheme}://127.0.0.1:{reg_srv.port}/nodes")
        assert ch.call_sync("Echo", "Echo", b"x") == b"x"
        ch.close()
    finally:
        reg_srv.stop()
        reg_srv.join()


def test_registry_outage_preserves_last_known_good(backend, monkeypatch):
    """A failed fetch raises, so the naming thread keeps the last list:
    calls keep working after the registry dies."""
    with pytest.raises(Exception):
        NS.HttpJsonNamingService("127.0.0.1:1/nodes").get_servers()
    with pytest.raises(Exception):
        NS.RemoteFileNamingService("127.0.0.1:1/nodes").get_servers()
    addr = f"127.0.0.1:{backend.port}"
    reg_srv = _registry_server(json.dumps([addr]), "application/json")
    monkeypatch.setattr(NS.HttpJsonNamingService, "interval_s", 0.2)
    from brpc_tpu_torch import flags
    flags.set_flag("naming_log_refresh_failures", False)
    ch = rpc.Channel(f"discovery://127.0.0.1:{reg_srv.port}/nodes")
    try:
        assert ch.call_sync("Echo", "Echo", b"1") == b"1"
        reg_srv.stop()
        reg_srv.join()
        time.sleep(0.6)   # several failed refreshes
        assert ch.call_sync("Echo", "Echo", b"2") == b"2"
    finally:
        ch.close()
        flags.set_flag("naming_log_refresh_failures", True)


def test_malformed_registry_entries_skipped(backend):
    addr = f"127.0.0.1:{backend.port}"
    payload = json.dumps([{"addr": addr, "weight": None},
                          {"addr": 123}, {"nope": 1}, addr])
    reg_srv = _registry_server(payload, "application/json")
    try:
        nodes = NS.HttpJsonNamingService(
            f"127.0.0.1:{reg_srv.port}/nodes").get_servers()
        assert len(nodes) == 2
        assert all(n.endpoint.port == backend.port for n in nodes)
    finally:
        reg_srv.stop()
        reg_srv.join()


def test_file_and_remotefile_parse_identically(tmp_path, backend):
    """The port's remotefile:// and file:// read one list alike, and as
    the JAX package's remotefile:// reads it from the same port
    registry."""
    from brpc_tpu.policy.naming import RemoteFileNamingService as RefRF
    text = f"127.0.0.1:{backend.port} 5 2/8\n127.0.0.1:{backend.port} t\n"
    p = tmp_path / "servers.txt"
    p.write_text(text)
    fnodes = NS.FileNamingService(str(p)).get_servers()
    reg_srv = _registry_server(text, "text/plain")
    try:
        param = f"127.0.0.1:{reg_srv.port}/nodes"
        rnodes = NS.RemoteFileNamingService(param).get_servers()
        key = [(str(n.endpoint), n.weight, n.tag) for n in fnodes]
        assert key == [(str(n.endpoint), n.weight, n.tag) for n in rnodes]
        assert key == [(str(n.endpoint), n.weight, n.tag)
                       for n in RefRF(param).get_servers()]
        assert fnodes[0].weight == 5 and fnodes[0].tag == "2/8"
        assert fnodes[1].tag == "t"
    finally:
        reg_srv.stop()
        reg_srv.join()
