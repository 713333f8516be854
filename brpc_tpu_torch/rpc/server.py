"""Server -- service registry, TRPC dispatch and the HTTP console.

A trimmed copy of ``brpc_tpu/rpc/server.py``.  The request path: the
native core parses a frame and hands it to an executor thread (plain
requests pre-parsed through ``_fastrpc``) -> find the method -> decode
and decompress -> the handler -> encode, compress, write the response ->
:class:`MethodStatus` accounting (per-method latency recorder, error
and concurrency bvars: the ``/status`` page's data).  Kept:
``add_service``, ``start``/``stop``/``join``/``port``, deferred
responses (``cntl.defer()``), accepted streams, and one rpcz server
span per call: it joins the wire's trace (``trace_id``/``span_id`` of
the request meta) and inherits its sampling decision
(``FLAG_TRACE_SAMPLED``), and is the current span while the handler
runs, so the serving layers' spans nest under it.

HTTP requests on the same port go to the builtin console router
(``builtin/router.py``, installed at ``start`` unless
``has_builtin_services`` is off, when they get a 404): the console
pages, user handlers (:meth:`Server.add_http_handler`, e.g. the chunked
``/serving/generate``) and the RESTful bridge onto RPC methods
(:meth:`Server.invoke_restful`, through the same MethodStatus
accounting, inflight count and rpcz span as TRPC, and answered
asynchronously when the handler defers).  ``start`` exposes the process default
variables (cpu, rss, fds), starts the always-on stage-tagged sampler
(``builtin/sampler.py``; the last server to join stops it), and with
``enable_dcn`` registers the ``_dcn`` handshake service.  Left out
(ROADMAP): the other protocols on the port (gRPC, redis, memcache,
thrift, mongo), the ``grpc.health.v1.Health`` builtin and the RESTful
bridge's json2pb branch (both with the gRPC slice), auth,
interceptors, tag pools, ``rpc_dump``, the server and per-method
concurrency limiters and the rail.
"""
from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Optional

from .. import errors, rpcz
from ..bvar import Adder, LatencyRecorder, PassiveStatus
from ..bvar.default_variables import expose_default_variables
from . import meta as M
from .controller import Controller
from .serialization import compress, decompress
from .service import MethodSpec, Service
from .stream import StreamRegistry
from .transport import MSG_HTTP, MSG_TRPC, Transport

_log = logging.getLogger(__name__)


@dataclass
class ServerOptions:
    # the console router on the RPC port (off: HTTP gets a 404)
    has_builtin_services: bool = True
    # seconds join() waits for in-flight requests before closing
    # connections
    graceful_quit_timeout_s: float = 5.0
    # register the _dcn service (the topology handshake, ici/dcn.py) at
    # start; its Hello reports dcn_device (default cuda)
    enable_dcn: bool = False
    dcn_device: Optional[str] = None


class MethodStatus:
    """Per-method concurrency, latency and error counts, exposed as
    ``rpc_server_<Service>_<Method>_{latency,count,...}``,
    ``_error`` and ``_concurrency``: the ``/status`` page's data."""

    def __init__(self, full_name: str):
        safe = full_name.replace("/", "_").replace(".", "_")
        self.full_name = full_name
        self.latency_rec = LatencyRecorder(f"rpc_server_{safe}")
        self.nerror = Adder(f"rpc_server_{safe}_error")
        self._mu = threading.Lock()
        self._concurrency = 0
        PassiveStatus(lambda: self.concurrency).expose(
            f"rpc_server_{safe}_concurrency")

    def on_requested(self) -> None:
        with self._mu:
            self._concurrency += 1

    def on_responded(self, error_code: int, latency_us: int) -> None:
        with self._mu:
            self._concurrency = max(0, self._concurrency - 1)
        if error_code == 0:
            self.latency_rec.add(latency_us)
        else:
            self.nerror.add(1)

    @property
    def concurrency(self) -> int:
        return self._concurrency


class Server:
    def __init__(self, options: ServerOptions | None = None, **kw):
        self.options = options or ServerOptions(**kw)
        self._services: dict[str, Service] = {}
        self._methods: dict[tuple[str, str], MethodSpec] = {}
        self._method_status: dict[tuple[str, str], MethodStatus] = {}
        self._listen_sid: Optional[int] = None
        self._port: Optional[int] = None
        self._started = False
        self._stopping = False
        self._inflight = 0
        self._inflight_mu = threading.Lock()
        self._inflight_zero = threading.Event()
        self._inflight_zero.set()
        self._connections: set[int] = set()
        self._conn_mu = threading.Lock()
        self._start_time = time.time()
        # the console router, installed at start
        self._http_router = None
        # user HTTP handlers served beside the console pages
        self._http_handlers: dict[str, object] = {}

    def add_http_handler(self, path: str, fn) -> "Server":
        """Serve ``fn(req)`` at ``path`` on the console port; it may
        return str or bytes, ``(body, content_type)``, a whole HTTP/1.1
        response, or a ``ProgressiveResponse`` for chunked push."""
        self._http_handlers[path] = fn
        return self

    # ---- registry ----

    def add_service(self, service: Service) -> "Server":
        if self._started:
            raise RuntimeError("cannot add services after start")
        name = service.service_name()
        if name in self._services:
            raise ValueError(f"service {name!r} already added")
        self._services[name] = service
        for mname, spec in service.rpc_methods().items():
            self._methods[(name, mname)] = spec
            self._method_status[(name, mname)] = MethodStatus(
                f"{name}/{mname}")
        return self

    @property
    def services(self) -> dict[str, Service]:
        return dict(self._services)

    @property
    def method_statuses(self) -> dict[tuple[str, str], MethodStatus]:
        return dict(self._method_status)

    # ---- lifecycle ----

    def start(self, addr: str = "0.0.0.0", port: int = 0) -> "Server":
        if self._started:
            raise RuntimeError("already started")
        self._stopping = False
        if self.options.has_builtin_services:
            from ..builtin.router import HttpRouter
            self._http_router = HttpRouter(self)
        expose_default_variables()
        # the always-on stage-tagged sampler behind /hotspots
        # (flag-gated: hotspot_sampler_enabled, live on /flags)
        from ..builtin.sampler import HotspotSampler
        HotspotSampler.ensure_started()
        if self.options.enable_dcn:
            # added before the native registration loop below, so the
            # _dcn methods ride the same path as every other service
            from ..ici.dcn import DCN_SERVICE, DcnService
            if DCN_SERVICE not in self._services:
                self.add_service(DcnService(self.options.dcn_device))
        t = Transport.instance()
        self._listen_sid, self._port = t.listen_rpc(
            addr, port, self._on_message, self._on_conn_failed,
            on_request=self._on_fast_request)
        # the native method map: requests to these arrive pre-parsed;
        # anything else (stream metas, unknown methods) comes through
        # _on_message with a full Python decode
        for key in self._methods:
            _native_method_register(key)
        self._started = True
        self._start_time = time.time()
        _register_server(self)
        return self

    @property
    def port(self) -> Optional[int]:
        return self._port

    @property
    def running(self) -> bool:
        return self._started and not self._stopping

    def stop(self) -> None:
        """Stop accepting; in-flight requests drain in join()."""
        if not self._started or self._stopping:
            return
        self._stopping = True
        if self._listen_sid is not None:
            Transport.instance().close(self._listen_sid)

    def join(self) -> None:
        """Wait (up to ``graceful_quit_timeout_s``) for in-flight
        requests, then close every accepted connection; the streams
        riding them close with it."""
        if not self._started:
            return
        self._stopping = True
        with self._inflight_mu:
            if self._inflight == 0:
                self._inflight_zero.set()
            else:
                self._inflight_zero.clear()
        self._inflight_zero.wait(self.options.graceful_quit_timeout_s)
        with self._conn_mu:
            conns = list(self._connections)
        t = Transport.instance()
        for sid in conns:
            t.close(sid)
        for key in self._methods:
            _native_method_unregister(key)
        self._started = False
        if not _unregister_server(self):
            # no server of this process is left: its sampler goes too
            # (the JAX package's runs for the process's life; here a
            # test module that served leaves no sampling thread behind)
            from ..builtin.sampler import HotspotSampler
            HotspotSampler.instance().stop()

    # ---- stats for the console ----

    @property
    def uptime_s(self) -> float:
        return time.time() - self._start_time

    @property
    def connection_count(self) -> int:
        with self._conn_mu:
            return len(self._connections)

    def connections(self) -> list[int]:
        with self._conn_mu:
            return list(self._connections)

    # ---- dispatch ----

    def _on_conn_failed(self, sid: int, err: int) -> None:
        with self._conn_mu:
            self._connections.discard(sid)
        # streams accepted on this connection can neither send nor
        # receive any more: close them so their writers fail fast
        StreamRegistry.instance().on_socket_failed(sid)

    def _track_conn(self, sid: int) -> None:
        if sid in self._connections:  # GIL-safe read; hot path skips lock
            return
        with self._conn_mu:
            self._connections.add(sid)

    def _on_message(self, sid: int, kind: int, meta_bytes: bytes,
                    body) -> None:
        self._track_conn(sid)
        t = Transport.instance()
        if kind == MSG_HTTP:
            if self._http_router is not None:
                self._http_router.handle(sid, body.to_bytes())
            else:
                t.write_raw(sid, b"HTTP/1.1 404 Not Found\r\n"
                                 b"Content-Length: 0\r\n\r\n")
            return
        if kind != MSG_TRPC:
            # a protocol this server does not speak: close so the client
            # fails fast instead of waiting on its deadline
            t.close(sid)
            return
        try:
            meta = M.RpcMeta.decode(meta_bytes)
        except ValueError:
            return
        if meta.msg_type == M.MSG_REQUEST:
            self._process_request(sid, meta, body)
        elif meta.msg_type in (M.MSG_STREAM_DATA, M.MSG_STREAM_FEEDBACK,
                               M.MSG_STREAM_CLOSE):
            StreamRegistry.instance().on_frame(sid, meta, body)

    def _inflight_inc(self) -> None:
        with self._inflight_mu:
            self._inflight += 1

    def _inflight_dec(self) -> None:
        with self._inflight_mu:
            self._inflight -= 1
            if self._inflight == 0 and self._stopping:
                self._inflight_zero.set()

    def _on_fast_request(self, sid: int, cid: int, attempt: int,
                         service: str, method_name: str, compress_: int,
                         timeout_ms: int, content_type: str,
                         attachment_size: int, body) -> None:
        """A natively pre-parsed plain request (net/rpc.h fast path)."""
        self._track_conn(sid)
        meta = M.RpcMeta(msg_type=M.MSG_REQUEST, correlation_id=cid,
                         attempt=attempt, service=service,
                         method=method_name, compress_type=compress_,
                         timeout_ms=timeout_ms, content_type=content_type,
                         attachment_size=attachment_size)
        self._process_request(sid, meta, body)

    def _respond_error(self, sid: int, meta: M.RpcMeta, code: int,
                       text: str = "") -> None:
        Transport.instance().send_response(
            sid, meta.correlation_id, meta.attempt, code,
            text or errors.describe(code), "", b"")

    def _process_request(self, sid: int, meta: M.RpcMeta, body) -> None:
        start = time.monotonic()
        if self._stopping:
            self._respond_error(sid, meta, errors.ELOGOFF)
            return
        key = (meta.service, meta.method)
        spec = self._methods.get(key)
        if spec is None:
            if meta.service not in self._services:
                self._respond_error(sid, meta, errors.ENOSERVICE,
                                    f"unknown service {meta.service!r}")
            else:
                self._respond_error(sid, meta, errors.ENOMETHOD,
                                    f"unknown method {meta.method!r}")
            return
        status = self._method_status[key]
        status.on_requested()
        self._inflight_inc()
        span = rpcz.new_span("server", meta.service, meta.method,
                             trace_id=meta.trace_id,
                             parent_span_id=meta.span_id,
                             # a joined trace inherits the root's
                             # decision from the wire; a fresh trace
                             # decides here
                             sampled=bool(meta.flags
                                          & M.FLAG_TRACE_SAMPLED)
                             if meta.trace_id else None)
        cntl = Controller()
        cntl.is_server_side = True
        cntl.request_meta = meta
        cntl.peer_sid = sid
        cntl.trace_id = span.trace_id
        cntl.span_id = span.span_id
        # ---- decode ----
        try:
            # fast-path bodies are IOBuf-backed memoryviews (slicing
            # stays zero-copy); the generic path hands an IOBuf
            raw = body if isinstance(body, (bytes, memoryview)) \
                else body.to_bytes()
            att = meta.attachment_size
            payload = raw[: len(raw) - att] if att else raw
            cntl.request_attachment = bytes(raw[len(raw) - att:]) \
                if att else b""
            if meta.compress_type:
                payload = decompress(payload, meta.compress_type)
            request = spec.request_serializer.decode(payload,
                                                     meta.tensor_header)
            span.request_size = len(raw)
        except Exception as e:
            if isinstance(e, ValueError):
                # a malformed payload is bad input, not a server fault
                e = errors.RpcError(errors.EREQUEST,
                                    f"cannot decode request: {e}")
            self._complete(sid, meta, span, cntl, spec, status, start, None,
                           exc=e)
            return
        # ---- handler ----
        # the done closure is built only when the handler defers
        cntl._done_factory = lambda: _make_done(
            f"{meta.service}.{meta.method} cid={meta.correlation_id}",
            lambda response: self._complete(sid, meta, span, cntl, spec,
                                            status, start, response))
        traced = span is not rpcz.NULL_SPAN
        if traced:      # with rpcz off, no context-variable writes
            rpcz.set_current_span(span)
        try:
            response = spec.fn(cntl, request)
        except Exception as e:
            if cntl._deferred:
                # done() owns the response now; completing here would
                # race it
                _log.exception("deferred handler raised")
                return
            self._complete(sid, meta, span, cntl, spec, status, start, None,
                           exc=e)
            return
        finally:
            if traced:
                rpcz.set_current_span(None)
        if cntl._deferred:
            return
        self._complete(sid, meta, span, cntl, spec, status, start, response)

    def _complete(self, sid: int, meta: M.RpcMeta, span, cntl, spec,
                  status, start: float, response,
                  exc: Exception | None = None) -> None:
        """The response path, its accounting and the server span's
        submission, exactly once per accepted request."""
        cntl._done_factory = None
        error_code = 0
        t = Transport.instance()
        try:
            if exc is not None:
                raise exc
            if cntl.failed():
                error_code = cntl.error_code
                if cntl.response_user_fields:
                    err = M.RpcMeta(msg_type=M.MSG_RESPONSE,
                                    correlation_id=meta.correlation_id,
                                    attempt=meta.attempt,
                                    error_code=cntl.error_code,
                                    error_text=cntl.error_text or
                                    errors.describe(cntl.error_code))
                    err.user_fields.update(M.normalize_user_fields(
                        cntl.response_user_fields))
                    t.write_frame(sid, err.encode())
                else:
                    self._respond_error(sid, meta, cntl.error_code,
                                        cntl.error_text)
            else:
                res_ser = spec.response_serializer
                rbody, theader = res_ser.encode(response)
                if meta.compress_type:
                    rbody = compress(rbody, meta.compress_type)
                span.response_size = len(rbody)
                if (cntl._stream is None and not cntl.response_attachment
                        and not theader and not meta.compress_type
                        and not cntl.response_user_fields):
                    # plain response: packed and framed natively
                    rc = t.send_response(sid, meta.correlation_id,
                                         meta.attempt, 0, "", res_ser.name,
                                         rbody)
                else:
                    resp = M.RpcMeta(msg_type=M.MSG_RESPONSE,
                                     correlation_id=meta.correlation_id,
                                     attempt=meta.attempt,
                                     compress_type=meta.compress_type,
                                     content_type=res_ser.name,
                                     tensor_header=theader)
                    if cntl.response_user_fields:
                        resp.user_fields.update(M.normalize_user_fields(
                            cntl.response_user_fields))
                    if cntl._stream is not None:
                        # our local stream id and window (the settings
                        # exchange)
                        resp.stream_id = cntl._stream.stream_id
                        resp.user_fields[M.F_SBUF] = \
                            str(cntl._stream.max_buf_size)
                    if cntl.response_attachment:
                        resp.attachment_size = len(cntl.response_attachment)
                        rbody = rbody + cntl.response_attachment
                    rc = t.write_frame(sid, resp.encode(), rbody)
                if rc != 0:
                    # the frame was dropped (overcrowded or dead socket):
                    # the accounting must not claim success
                    error_code = errors.EOVERCROWDED if rc == -2 \
                        else errors.EFAILEDSOCKET
        except errors.RpcError as e:
            error_code = e.code
            self._respond_error(sid, meta, e.code, str(e))
        except Exception as e:
            error_code = errors.EINTERNAL
            self._respond_error(sid, meta, errors.EINTERNAL,
                                f"{type(e).__name__}: {e}")
        finally:
            self._account(span, status, start, error_code)

    def _account(self, span, status, start: float, error_code: int) -> None:
        """A finished request's MethodStatus, rpcz span and inflight
        count, on both wires."""
        status.on_responded(error_code,
                            int((time.monotonic() - start) * 1e6))
        span.error_code = error_code
        span.end_us = rpcz.now_us()
        rpcz.submit(span)
        self._inflight_dec()

    # ---- the RESTful bridge's entry (builtin/router.py) ----

    def invoke_restful(self, service: str, method_name: str, payload,
                       reply) -> None:
        """Call a method for the HTTP JSON bridge through the same gates
        as TRPC traffic (MethodStatus, the inflight count, an rpcz span)
        and answer through ``reply(error_code, error_text, result)``,
        exactly once.  A handler that defers (``cntl.defer()``, as
        Score's batcher does) is answered by its done closure, on the
        thread that completes it: no executor worker waits for it."""
        if self._stopping:
            reply(errors.ELOGOFF, errors.describe(errors.ELOGOFF), None)
            return
        key = (service, method_name)
        spec = self._methods.get(key)
        if spec is None:
            code = errors.ENOSERVICE if service not in self._services \
                else errors.ENOMETHOD
            reply(code, errors.describe(code), None)
            return
        status = self._method_status[key]
        status.on_requested()
        self._inflight_inc()
        start = time.monotonic()
        span = rpcz.new_span("server", service, method_name)
        span.annotate("protocol=http")
        cntl = Controller()
        cntl.is_server_side = True
        cntl.request_meta = M.RpcMeta(msg_type=M.MSG_REQUEST,
                                      service=service, method=method_name,
                                      content_type="json")
        cntl.trace_id = span.trace_id
        cntl.span_id = span.span_id

        def complete(result, exc=None):
            cntl._done_factory = None
            error_code = 0
            try:
                if exc is not None:
                    raise exc
                if cntl.failed():
                    error_code = cntl.error_code
                    reply(error_code, cntl.error_text
                          or errors.describe(error_code), None)
                else:
                    reply(0, "", result)
            except errors.RpcError as e:
                error_code = e.code
                reply(e.code, e.text, None)
            except Exception as e:
                error_code = errors.EINTERNAL
                reply(errors.EINTERNAL, f"{type(e).__name__}: {e}", None)
            finally:
                self._account(span, status, start, error_code)

        cntl._done_factory = lambda: _make_done(
            f"{service}.{method_name} (http)", complete)
        traced = span is not rpcz.NULL_SPAN
        if traced:
            rpcz.set_current_span(span)
        try:
            result = spec.fn(cntl, payload)
        except Exception as e:
            if cntl._deferred:
                _log.exception("deferred handler raised")
                return
            complete(None, e)
            return
        finally:
            if traced:
                rpcz.set_current_span(None)
        if not cntl._deferred:
            complete(result)


def _make_done(what: str, complete):
    """A deferred handler's done closure: ``complete(response)`` runs
    once; a second call raises."""
    fired = [False]
    fired_mu = threading.Lock()

    def done(response=None):
        with fired_mu:
            if fired[0]:
                raise RuntimeError(f"done() called twice for {what}")
            fired[0] = True
        complete(response)

    return done


# ---- the process's started servers (the sampler runs while any does) ----

_servers: set[int] = set()
_servers_mu = threading.Lock()


def _register_server(s: Server) -> None:
    with _servers_mu:
        _servers.add(id(s))


def _unregister_server(s: Server) -> int:
    """Forget ``s``; the number of servers still started."""
    with _servers_mu:
        _servers.discard(id(s))
        return len(_servers)


# process-wide refcounts for the native method registry (several servers
# may expose the same (service, method); the registry is global)
_native_reg: dict[tuple[str, str], int] = {}
_native_reg_mu = threading.Lock()


def _native_method_register(key: tuple[str, str]) -> None:
    with _native_reg_mu:
        n = _native_reg.get(key, 0)
        _native_reg[key] = n + 1
        if n == 0:
            Transport.instance().register_python_method(*key)


def _native_method_unregister(key: tuple[str, str]) -> None:
    with _native_reg_mu:
        n = _native_reg.get(key, 0)
        if n <= 1:
            _native_reg.pop(key, None)
            Transport.instance().unregister_method(*key)
        else:
            _native_reg[key] = n - 1
