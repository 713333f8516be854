"""Server -- service registry and TRPC dispatch.

A trimmed copy of ``brpc_tpu/rpc/server.py``.  The request path: the
native core parses a frame and hands it to an executor thread (plain
requests pre-parsed through ``_fastrpc``) -> find the method -> decode
and decompress -> the handler -> encode, compress, write the response
-> :class:`MethodStatus` accounting.  Kept: ``add_service``,
``start``/``stop``/``join``/``port``, deferred responses
(``cntl.defer()``), accepted streams, and one rpcz server span per
call: it joins the wire's trace (``trace_id``/``span_id`` of the
request meta) and inherits its sampling decision
(``FLAG_TRACE_SAMPLED``), and is the current span while the handler
runs, so the serving layers' spans nest under it.  ``start`` exposes
the process default variables (cpu, rss, fds), and with
``enable_dcn`` registers the ``_dcn`` handshake service.  Left out
(ROADMAP): the other protocols on the port (HTTP gets a 404), builtin
services and the console, auth, interceptors, limiters, tag pools,
``rpc_dump``, per-method bvar variables, the hotspot sampler and the
rail.
"""
from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Optional

from .. import errors, rpcz
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
    # seconds join() waits for in-flight requests before closing
    # connections
    graceful_quit_timeout_s: float = 5.0
    # register the _dcn service (the topology handshake, ici/dcn.py) at
    # start; its Hello reports dcn_device (default cuda)
    enable_dcn: bool = False
    dcn_device: Optional[str] = None


class MethodStatus:
    """Per-method concurrency, latency and error counts."""

    def __init__(self, full_name: str):
        self.full_name = full_name
        self._mu = threading.Lock()
        self.concurrency = 0
        self.count = 0            # answered without error
        self.nerror = 0
        self.latency_us_total = 0

    def on_requested(self) -> None:
        with self._mu:
            self.concurrency += 1

    def on_responded(self, error_code: int, latency_us: int) -> None:
        with self._mu:
            self.concurrency = max(0, self.concurrency - 1)
            if error_code == 0:
                self.count += 1
                self.latency_us_total += latency_us
            else:
                self.nerror += 1


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
        expose_default_variables()
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

    @property
    def connection_count(self) -> int:
        with self._conn_mu:
            return len(self._connections)

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
        cntl._done_factory = lambda: self._make_server_done(
            sid, meta, span, cntl, spec, status, start)
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

    def _make_server_done(self, sid, meta, span, cntl, spec, status, start):
        fired = [False]
        fired_mu = threading.Lock()

        def done(response=None):
            with fired_mu:
                if fired[0]:
                    raise RuntimeError(
                        f"done() called twice for {meta.service}."
                        f"{meta.method} cid={meta.correlation_id}")
                fired[0] = True
            self._complete(sid, meta, span, cntl, spec, status, start,
                           response)

        return done

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
            status.on_responded(error_code,
                                int((time.monotonic() - start) * 1e6))
            span.error_code = error_code
            span.end_us = rpcz.now_us()
            rpcz.submit(span)
            self._inflight_dec()


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
