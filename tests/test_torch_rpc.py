"""The port's TRPC front held against the JAX package's RPC layer.

  * the meta codec and the json/raw serializers produce the same bytes
    as ``brpc_tpu.rpc`` on seeded fields, and each side decodes the
    other's;
  * the wire works both ways in one process: a ``brpc_tpu`` Channel
    calls a port Server and a port Channel calls a ``brpc_tpu`` Server,
    unary and streamed, with ENOSERVICE/ENOMETHOD/EREQUEST carried
    through, user fields, attachments and compression intact;
  * the port's own contract: deadlines, connection refusal after the
    retry budget, deferred responses, bytes-only streams, and a server
    that stops with a stream still open.

Both native cores live in this process (the reference's is loaded by
the suite's conftest): the port builds its own into build/torch_core/.
"""
import json
import threading
import time

import numpy as np
import pytest
import torch

import brpc_tpu as ref
from brpc_tpu.rpc import meta as RM
from brpc_tpu.rpc import serialization as RS
import brpc_tpu_torch.rpc as rpc
from brpc_tpu_torch import errors
from brpc_tpu_torch.policy import health_check
from brpc_tpu_torch.rpc import meta as PM
from brpc_tpu_torch.rpc import serialization as PS
from brpc_tpu_torch.rpc.channel import CallManager
from brpc_tpu_torch.rpc.stream import StreamRegistry

from testutil import wait_until

SEEDS = range(6)


@pytest.fixture(autouse=True, scope="module")
def _retire_health_probes():
    """A client whose server this module stops marks that endpoint for
    the port's health check: retire the probes when the module ends."""
    yield
    time.sleep(0.1)      # a socket may fail just after its server stopped
    health_check.reset_all()


def _random_meta_fields(seed):
    rng = np.random.default_rng(seed)

    def word():
        return "".join(chr(int(c)) for c in
                       rng.integers(97, 123, int(rng.integers(1, 12))))

    def maybe(v):
        return v if rng.random() < 0.7 else type(v)()

    return dict(
        msg_type=int(rng.integers(0, 5)),
        correlation_id=int(rng.integers(0, 2**63)),
        attempt=int(rng.integers(0, 2**16)),
        flags=int(rng.integers(0, 2)),
        service=maybe(word()), method=maybe(word()),
        error_code=maybe(int(rng.integers(-5, 3000))),
        error_text=maybe(word()),
        compress_type=maybe(int(rng.integers(1, 5))),
        attachment_size=maybe(int(rng.integers(1, 2**40))),
        timeout_ms=maybe(int(rng.integers(1, 2**31))),
        trace_id=maybe(int(rng.integers(1, 2**63))),
        span_id=maybe(int(rng.integers(1, 2**63))),
        parent_span_id=maybe(int(rng.integers(1, 2**63))),
        content_type=maybe(rng.choice(["json", "raw"]).item()),
        stream_id=maybe(int(rng.integers(1, 2**63))),
        stream_offset=maybe(int(rng.integers(1, 2**63))),
        stream_seq=maybe(int(rng.integers(1, 2**63))),
        tensor_header=maybe(rng.bytes(int(rng.integers(1, 20)))),
        auth=maybe(rng.bytes(int(rng.integers(1, 20)))),
        user_fields={word(): word() for _ in range(int(rng.integers(0, 4)))},
    )


@pytest.mark.parametrize("seed", SEEDS)
def test_meta_bytes_equal_reference(seed):
    fields = _random_meta_fields(seed)
    mine = PM.RpcMeta(**fields).encode()
    theirs = RM.RpcMeta(**fields).encode()
    assert mine == theirs
    # each side decodes the other's bytes to the same fields
    back = PM.RpcMeta.decode(theirs)
    again = RM.RpcMeta.decode(mine)
    for k, v in fields.items():
        if k == "user_fields":
            v = {kk: vv.encode() for kk, vv in v.items()}
        assert getattr(back, k) == v, k
        assert getattr(again, k) == v, k


@pytest.mark.parametrize("seed", SEEDS)
def test_stream_data_fast_encoder_equals_reference(seed):
    rng = np.random.default_rng(seed)
    sid, seq = int(rng.integers(1, 2**63)), int(rng.integers(0, 3))
    fast = PM.RpcMeta.encode_stream_data(sid, seq)
    assert fast == RM.RpcMeta.encode_stream_data(sid, seq)
    assert fast == PM.RpcMeta(msg_type=PM.MSG_STREAM_DATA, stream_id=sid,
                              stream_seq=seq).encode()


def test_meta_constants_and_reserved_keys_equal_reference():
    names = [n for n in dir(RM) if n.isupper() and not n.startswith("_")]
    assert names and all(getattr(PM, n) == getattr(RM, n) for n in names)
    for key in RM.RESERVED_USER_FIELD_KEYS:
        with pytest.raises(ValueError):
            PM.normalize_user_fields({key: "x"})
    assert PM.normalize_user_fields({"k": 3, "b": b"\x00"}) == \
        RM.normalize_user_fields({"k": 3, "b": b"\x00"})


@pytest.mark.parametrize("seed", SEEDS)
def test_json_and_raw_bytes_equal_reference(seed):
    rng = np.random.default_rng(seed)
    obj = {"prompt": rng.integers(0, 128, int(rng.integers(1, 40))).tolist(),
           "max_new_tokens": int(rng.integers(1, 64)),
           "speculative": bool(rng.integers(0, 2)),
           "x": [float(v) for v in rng.standard_normal(3)],
           "s": "tokén"}
    for name in ("json", "raw"):
        p, r = PS.get_serializer(name), RS.get_serializer(name)
        payload = obj if name == "json" else rng.bytes(33)
        assert p.encode(payload) == r.encode(payload)
        body, hdr = r.encode(payload)
        assert p.decode(memoryview(body), hdr) == r.decode(body, hdr)


@pytest.mark.parametrize("ctype", [PM.COMPRESS_GZIP, PM.COMPRESS_ZLIB,
                                   PM.COMPRESS_SNAPPY])
def test_compression_decodes_the_reference_and_back(ctype):
    data = json.dumps({"prompt": list(range(300))}).encode() * 3
    assert PS.decompress(RS.compress(data, ctype), ctype) == data
    assert RS.decompress(PS.compress(data, ctype), ctype) == data
    if ctype == PM.COMPRESS_SNAPPY:
        # the same native codec, compiled twice
        assert PS.compress(data, ctype) == RS.compress(data, ctype)


# ---------------------------------------------------------------------------
# the wire, both ways
# ---------------------------------------------------------------------------

def _echo_service(mod, errs_mod):
    """The same service for either package: ``mod`` is ``brpc_tpu`` or
    ``brpc_tpu_torch.rpc``."""

    class Echo(mod.Service):
        @mod.method(request="json", response="json")
        def Echo(self, cntl, req):
            cntl.response_user_fields = {
                "seen": cntl.request_meta.user_fields.get("tag", b"")
                .decode() or "none"}
            cntl.response_attachment = cntl.request_attachment[::-1]
            return {"msg": req["msg"], "n": len(req["msg"])}

        @mod.method(request="raw", response="raw")
        def Raw(self, cntl, req):
            return bytes(req)[::-1]

        @mod.method(request="json", response="json")
        def Fail(self, cntl, req):
            cntl.set_failed(errs_mod.EREQUEST, "refused on purpose")

        @mod.method(request="json", response="json")
        def Count(self, cntl, req):
            s = cntl.accept_stream()

            def run():
                for i in range(req["n"]):
                    s.write(json.dumps({"i": i}).encode())
                s.close()

            threading.Thread(target=run, daemon=True).start()
            return {"streaming": req["n"]}

        @mod.method(request="json", response="json")
        def Sink(self, cntl, req):
            key = req["key"]
            self.sunk[key] = []

            class H(mod.StreamHandler):
                def on_received_messages(self, stream, msgs):
                    outer.sunk[key].extend(bytes(m).decode() for m in msgs)

                def on_closed(self, stream):
                    outer.sunk_closed.add(key)

            cntl.accept_stream(H())
            return {}

        @mod.method(request="json", response="json")
        def Later(self, cntl, req):
            done = cntl.defer()
            threading.Thread(target=lambda: done({"v": 2 * req["v"]}),
                             daemon=True).start()
            return None

    outer = Echo()
    outer.sunk, outer.sunk_closed = {}, set()
    return outer


@pytest.fixture(scope="module")
def servers():
    port = rpc.Server()
    port.add_service(_echo_service(rpc, errors))
    port.start("127.0.0.1", 0)
    theirs = ref.Server(has_builtin_services=False)
    theirs.add_service(_echo_service(ref, ref.errors))
    theirs.start("127.0.0.1", 0)
    yield {"port": port, "ref": theirs,
           "svc": {"port": port.services["Echo"],
                   "ref": theirs.services["Echo"]}}
    for server in (port, theirs):
        server.stop()
        server.join()


PAIRS = [("ref", "port"), ("port", "ref"), ("port", "port")]
CLIENT = {"ref": ref, "port": rpc}


def _channel(client, server):
    return CLIENT[client].Channel(f"127.0.0.1:{server.port}",
                                  timeout_ms=10_000)


@pytest.mark.parametrize("client,side", PAIRS)
def test_unary_both_ways(servers, client, side):
    ch = _channel(client, servers[side])
    mod = CLIENT[client]
    cntl = mod.Controller()
    cntl.user_fields = {"tag": "t1"}
    cntl.request_attachment = b"attach"
    resp = ch.call_sync("Echo", "Echo", {"msg": "héllo"},
                        serializer="json", cntl=cntl)
    assert resp == {"msg": "héllo", "n": 5}
    assert cntl.response_attachment == b"hcatta"
    assert cntl.response_user_fields == {"seen": b"t1"}
    assert ch.call_sync("Echo", "Raw", b"\x00abc\xff") == b"\xffcba\x00"
    # compressed both ways
    c2 = mod.Controller(compress_type=PM.COMPRESS_GZIP)
    assert ch.call_sync("Echo", "Echo", {"msg": "z" * 500},
                        serializer="json", cntl=c2)["n"] == 500


@pytest.mark.parametrize("client,side", PAIRS)
def test_error_codes_carried_both_ways(servers, client, side):
    ch = _channel(client, servers[side])
    codes = {}
    for name, (svc, meth, body, ser) in {
            "nosvc": ("Nope", "Echo", {"msg": ""}, "json"),
            "nomethod": ("Echo", "Nope", {"msg": ""}, "json"),
            "badjson": ("Echo", "Echo", b"{not json", "raw"),
            "failed": ("Echo", "Fail", {}, "json")}.items():
        with pytest.raises(Exception) as ei:
            ch.call_sync(svc, meth, body, serializer=ser)
        codes[name] = ei.value.code
    assert codes == {"nosvc": errors.ENOSERVICE,
                     "nomethod": errors.ENOMETHOD,
                     "badjson": errors.EREQUEST, "failed": errors.EREQUEST}


@pytest.mark.parametrize("client,side", PAIRS)
def test_server_stream_both_ways(servers, client, side):
    mod = CLIENT[client]
    got, closed = [], threading.Event()

    class H(mod.StreamHandler):
        def on_received_messages(self, stream, msgs):
            got.extend(json.loads(m)["i"] for m in msgs)

        def on_closed(self, stream):
            closed.set()

    cntl = mod.Controller()
    mod.stream_create(cntl, H(), max_buf_size=256)
    resp = _channel(client, servers[side]).call_sync(
        "Echo", "Count", {"n": 300}, serializer="json", cntl=cntl)
    assert resp == {"streaming": 300}
    assert closed.wait(30)
    assert got == list(range(300))     # in order, none lost, window 256 B


@pytest.mark.parametrize("client,side", PAIRS)
def test_client_stream_both_ways(servers, client, side):
    mod = CLIENT[client]
    cntl = mod.Controller()
    s = mod.stream_create(cntl)
    key = f"{client}-{side}"
    _channel(client, servers[side]).call_sync(
        "Echo", "Sink", {"key": key}, serializer="json", cntl=cntl)
    for i in range(50):
        s.write(f"m{i}".encode())
    s.close()
    svc = servers["svc"][side]
    assert wait_until(lambda: key in svc.sunk_closed, 30)
    assert svc.sunk[key] == [f"m{i}" for i in range(50)]


@pytest.mark.parametrize("client,side", PAIRS)
def test_deferred_response_both_ways(servers, client, side):
    ch = _channel(client, servers[side])
    assert ch.call_sync("Echo", "Later", {"v": 21},
                        serializer="json") == {"v": 42}
    res, ev = {}, threading.Event()
    ch.call("Echo", "Later", {"v": 5}, serializer="json",
            done=lambda c: (res.update(v=c.response, e=c.error_code),
                            ev.set()))
    assert ev.wait(20) and res == {"v": {"v": 10}, "e": 0}


def test_stream_write_refuses_a_tensor(servers):
    cntl = rpc.Controller()
    s = rpc.stream_create(cntl)
    with pytest.raises(TypeError, match="bytes"):
        s.write(torch.zeros(4))
    s.close()


def test_deadline_and_refused_connection():
    slow_release = threading.Event()

    class Slow(rpc.Service):
        @rpc.method(request="json", response="json")
        def Wait(self, cntl, req):
            done = cntl.defer()
            threading.Thread(
                target=lambda: (slow_release.wait(20), done({})),
                daemon=True).start()

    srv = rpc.Server()
    srv.add_service(Slow())
    srv.start("127.0.0.1", 0)
    try:
        ch = rpc.Channel(f"127.0.0.1:{srv.port}", timeout_ms=100)
        t0 = time.monotonic()
        with pytest.raises(errors.RpcError) as ei:
            ch.call_sync("Slow", "Wait", {}, serializer="json")
        assert ei.value.code == errors.ERPCTIMEDOUT
        assert time.monotonic() - t0 < 5
        # async: the native deadline timer completes the call
        cntl = ch.call("Slow", "Wait", {}, serializer="json")
        cntl.join(5.0)
        assert cntl.error_code == errors.ERPCTIMEDOUT
    finally:
        slow_release.set()
        srv.stop()
        srv.join()
    dead = rpc.Channel(f"127.0.0.1:{srv.port}", timeout_ms=2000, max_retry=2)
    cntl = rpc.Controller()
    with pytest.raises(errors.RpcError) as ei:
        dead.call_sync("Slow", "Wait", {}, serializer="json", cntl=cntl)
    assert ei.value.code in (errors.ECONNREFUSED, errors.EFAILEDSOCKET)
    assert cntl.retried_count == 2
    assert wait_until(lambda: CallManager.instance().pending_count() == 0,
                      30)


def test_server_join_closes_open_streams():
    """A server that stops while a stream it accepted is still open
    closes that stream on both sides; nothing hangs."""
    accepted = []

    class Hold(rpc.Service):
        @rpc.method(request="json", response="json")
        def Open(self, cntl, req):
            accepted.append(cntl.accept_stream())
            return {}

    srv = rpc.Server(graceful_quit_timeout_s=2.0)
    srv.add_service(Hold())
    srv.start("127.0.0.1", 0)
    closed = threading.Event()

    class H(rpc.StreamHandler):
        def on_closed(self, stream):
            closed.set()

    cntl = rpc.Controller()
    rpc.stream_create(cntl, H())
    rpc.Channel(f"127.0.0.1:{srv.port}", timeout_ms=5000).call_sync(
        "Hold", "Open", {}, serializer="json", cntl=cntl)
    srv.stop()
    srv.join()
    assert closed.wait(20), "the client's stream never learned"
    assert wait_until(lambda: accepted[0].closed, 30)
    with pytest.raises(errors.RpcError) as ei:
        accepted[0].write(b"late")
    assert ei.value.code == errors.EEOF
    assert wait_until(lambda: StreamRegistry.instance().get(
        accepted[0].stream_id) is None, 30)
