"""Transport -- the Python hub over the port's native socket core.

A copy of the TRPC part of ``brpc_tpu/rpc/transport.py``.  It owns the
process-lifetime ctypes callbacks (native sockets keep raw pointers to
them), routes complete messages by socket id to the registered handler
(a client connection or a server), and wraps the native timer thread
for deadlines.  Plain requests and responses take the fast path: their
metas are packed and parsed natively and cross into Python through the
port's ``_fastrpc`` extension with no ctypes marshalling; every other
frame (streams, user fields, attachments) arrives at ``on_message``
with its meta bytes.  TLS, the h2/gRPC plane and fault sites are left
out.
"""
from __future__ import annotations

import ctypes
import logging
import threading
from typing import Callable, Optional

from .._core import lib
from .._core.lib import (ACCEPTED_CB, FAILED_CB, MESSAGE_CB, MSG_HTTP,
                         MSG_TRPC, RESPONSE_CB, TASK_CB, IOBuf)

__all__ = ["Transport", "MSG_HTTP", "MSG_TRPC"]

_log = logging.getLogger(__name__)


class Transport:
    _instance: Optional["Transport"] = None
    _instance_lock = threading.Lock()

    @classmethod
    def instance(cls) -> "Transport":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def __init__(self):
        self.core, self.fastrpc = lib.load()
        self._lock = threading.Lock()
        # sid -> (on_message(sid, kind, meta_bytes, body: IOBuf),
        #         on_failed(sid, err))
        self._handlers: dict[int, tuple[Callable, Callable]] = {}
        # sid -> fast-path handlers (natively pre-parsed metas)
        self._request_handlers: dict[int, Callable] = {}
        self._response_handlers: dict[int, Callable] = {}
        self._timer_lock = threading.Lock()
        self._timer_cbs: dict[int, Callable[[], None]] = {}
        self._timer_token = 1
        fastrpc = self.fastrpc

        @MESSAGE_CB
        def _on_message(sid, kind, meta, meta_len, body, user):
            buf = IOBuf(body)  # takes ownership, freed at GC
            m = ctypes.string_at(meta, meta_len) if meta_len else b""
            h = self._handlers.get(sid)
            if h is not None:
                try:
                    h[0](sid, kind, m, buf)
                except Exception:  # pragma: no cover - handler bug guard
                    _log.exception("message handler raised")

        @FAILED_CB
        def _on_failed(sid, err, user):
            with self._lock:
                h = self._handlers.pop(sid, None)
                self._request_handlers.pop(sid, None)
                self._response_handlers.pop(sid, None)
            if h is not None and h[1] is not None:
                try:
                    h[1](sid, err)
                except Exception:  # pragma: no cover
                    _log.exception("failure handler raised")

        @ACCEPTED_CB
        def _on_accepted(listener, conn, user):
            # accepted connections inherit the listener's handlers
            with self._lock:
                h = self._handlers.get(listener)
                if h is not None:
                    self._handlers[conn] = h
                rh = self._request_handlers.get(listener)
                if rh is not None:
                    self._request_handlers[conn] = rh

        # fast-path dispatchers (the _fastrpc extension: pre-parsed metas
        # arrive as flat args; the body is an IOBuf-backed read-only
        # memoryview that pins its blocks while referenced)
        def _on_request(sid, cid, attempt, service, method_, compress,
                        timeout_ms, content_type, attachment_size, body):
            h = self._request_handlers.get(sid)
            if h is None:
                # the listener went away mid-flight: answer EINTERNAL
                # rather than leave the caller to its deadline
                fastrpc.send_response(sid, cid, attempt, 2001,
                                      "no request handler", "", b"")
                return
            try:
                h(sid, cid, attempt, service, method_, compress,
                  timeout_ms, content_type, attachment_size, body)
            except Exception:  # pragma: no cover - handler bug guard
                _log.exception("request handler raised")
                try:
                    fastrpc.send_response(sid, cid, attempt, 2001,
                                          "python handler raised", "", b"")
                except Exception:
                    pass

        def _on_response(sid, cid, attempt, error_code, error_text, compress,
                         content_type, attachment_size, body):
            h = self._response_handlers.get(sid)
            if h is not None:
                try:
                    h(sid, cid, attempt, error_code, error_text, compress,
                      content_type, attachment_size, body)
                except Exception:  # pragma: no cover
                    _log.exception("response handler raised")

        @TASK_CB
        def _on_timer(arg):
            with self._timer_lock:
                fn = self._timer_cbs.pop(arg or 0, None)
            if fn is not None:
                try:
                    fn()
                except Exception:  # pragma: no cover
                    _log.exception("timer callback raised")

        fastrpc.set_request_handler(_on_request)
        fastrpc.set_response_handler(_on_response)
        self._cb_message = _on_message
        self._cb_failed = _on_failed
        self._cb_accepted = _on_accepted
        self._cb_timer = _on_timer
        self._cb_request = _on_request
        self._cb_response = _on_response

    # ---- sockets ----

    def listen_rpc(self, addr: str, port: int, on_message, on_failed=None,
                   on_request=None) -> tuple[int, int]:
        """Listen with the native unary fast path: TRPC requests whose
        meta parses natively and whose method is registered
        (:meth:`register_python_method`) arrive pre-parsed at
        ``on_request``; everything else at ``on_message``.  Returns
        ``(listener sid, bound port)``."""
        sid = ctypes.c_uint64()
        bound = ctypes.c_int()
        rc = self.core.brpc_listen_rpc(addr.encode(), port, self._cb_message,
                                       self._cb_failed, self._cb_accepted,
                                       None, ctypes.byref(sid),
                                       ctypes.byref(bound))
        if rc != 0:
            raise OSError(f"listen on {addr}:{port} failed")
        with self._lock:
            self._handlers[sid.value] = (on_message, on_failed)
            if on_request is not None:
                self._request_handlers[sid.value] = on_request
        return sid.value, bound.value

    def connect_rpc(self, host: str, port: int, on_message, on_failed=None,
                    on_response=None) -> int:
        """Connect with the natively pre-parsed response path."""
        sid = ctypes.c_uint64()
        rc = self.core.brpc_connect_rpc(
            host.encode(), port, self._cb_message, self._cb_failed,
            ctypes.cast(self.fastrpc.response_cb_ptr(), RESPONSE_CB), None,
            ctypes.byref(sid))
        if rc != 0:
            raise ConnectionError(f"connect to {host}:{port} failed")
        with self._lock:
            self._handlers[sid.value] = (on_message, on_failed)
            if on_response is not None:
                self._response_handlers[sid.value] = on_response
        return sid.value

    def register_python_method(self, service: str, method: str) -> None:
        self.core.brpc_register_python_method(service.encode(),
                                              method.encode())

    def unregister_method(self, service: str, method: str) -> None:
        self.core.brpc_unregister_method(service.encode(), method.encode())

    def send_request(self, sid: int, cid: int, attempt: int, service: str,
                     method: str, timeout_ms: int, compress: int,
                     content_type: str, body: bytes) -> int:
        """Pack and write a plain TRPC request frame natively."""
        return self.fastrpc.send_request(sid, cid, attempt, service, method,
                                         timeout_ms or 0, compress,
                                         content_type, body)

    def send_response(self, sid: int, cid: int, attempt: int,
                      error_code: int, error_text: str, content_type: str,
                      body: bytes) -> int:
        """Pack and write a plain TRPC response frame natively."""
        return self.fastrpc.send_response(sid, cid, attempt, error_code,
                                          error_text or "",
                                          content_type or "", body)

    def write_frame(self, sid: int, meta: bytes, body: bytes = b"") -> int:
        """Write one TRPC frame: 0, -1 (socket failed) or -2 (its write
        queue is overcrowded)."""
        return self.core.brpc_socket_write_frame(sid, meta, len(meta), body,
                                                 len(body), None)

    def write_raw(self, sid: int, data: bytes) -> int:
        return self.core.brpc_socket_write_raw(sid, data, len(data), None)

    def close(self, sid: int, err: int = 0) -> None:
        self.core.brpc_socket_set_failed(sid, err)

    # ---- timers (native TimerThread) ----

    def schedule(self, delay_s: float,
                 fn: Callable[[], None]) -> tuple[int, int]:
        """Run ``fn`` on the timer thread after ``delay_s``; returns the
        handle for :meth:`cancel`."""
        with self._timer_lock:
            token = self._timer_token
            self._timer_token += 1
            self._timer_cbs[token] = fn
        tid = self.core.brpc_timer_add(self._cb_timer, ctypes.c_void_p(token),
                                       int(delay_s * 1e6))
        return tid, token

    def cancel(self, timer: tuple[int, int]) -> bool:
        tid, token = timer
        ok = self.core.brpc_timer_cancel(tid) == 0
        with self._timer_lock:
            self._timer_cbs.pop(token, None)
        return ok
