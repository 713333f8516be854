"""Channel -- the client end of one server.

A trimmed copy of ``brpc_tpu/rpc/channel.py``: a channel to one
``host:port`` with ``call_sync``/``call_async``, a deadline per call, a
plain ``max_retry`` on connection errors, and streams riding a call
(``stream_create``).  Each call keeps the reference's exactly-once
state machine: a (correlation_id, attempt) version per attempt, so a
stale attempt, a late response or a racing socket failure can never
complete a call twice.  One multiplexed connection per endpoint
(``SocketMap``) carries every call.  A call made under a current
rpcz span carries its trace on the meta (the callee's server span
joins it).  Left out (ROADMAP): combo
channels, naming services, load balancing, the circuit breaker, health
checks, backup requests, pooled and short connections, TLS and the
tensor rail.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable

from .. import errors, rpcz
from ..butil.endpoint import EndPoint, str2endpoint
from . import meta as M
from .controller import Controller, OneShotEvent
from .serialization import compress, decompress, get_serializer
from .stream import StreamRegistry
from .transport import MSG_TRPC, Transport

_cid_counter = itertools.count(1)

# retried: connection errors and a server's internal error, never a
# missed deadline (the reference's default retry policy)
RETRYABLE = frozenset({errors.EFAILEDSOCKET, errors.EOVERCROWDED,
                       errors.EEOF, errors.ECONNREFUSED, errors.EINTERNAL})


@dataclass
class ChannelOptions:
    timeout_ms: int = 500
    max_retry: int = 3
    compress_type: int = M.COMPRESS_NONE


class SocketMap:
    """endpoint -> one shared connection (TRPC correlates by id, so one
    socket carries any number of calls in flight)."""

    _instance = None
    _instance_lock = threading.Lock()

    @classmethod
    def instance(cls) -> "SocketMap":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def __init__(self):
        self._lock = threading.Lock()
        self._conns: dict[EndPoint, int] = {}
        self._sid_to_ep: dict[int, EndPoint] = {}

    def get_connection(self, ep: EndPoint) -> int:
        with self._lock:
            sid = self._conns.get(ep)
        if sid is not None:
            return sid
        mgr = CallManager.instance()
        host = f"unix:{ep.host}" if ep.scheme == "unix" else ep.host
        sid = Transport.instance().connect_rpc(
            host, ep.port, mgr.on_message, self._on_socket_failed,
            on_response=mgr.on_fast_response)
        with self._lock:
            cur = self._conns.get(ep)
            if cur is None:
                self._conns[ep] = sid
                self._sid_to_ep[sid] = ep
        # never close while holding _lock: the native SetFailed may run
        # _on_socket_failed synchronously on this thread
        if cur is not None:
            Transport.instance().close(sid)
            return cur
        return sid

    def evict(self, ep: EndPoint, sid: int) -> None:
        """Forget ``ep``'s connection iff it is still ``sid`` (a write on
        it failed; its failure callback may still be in flight)."""
        with self._lock:
            if self._conns.get(ep) == sid:
                del self._conns[ep]

    def _on_socket_failed(self, sid: int, err: int) -> None:
        with self._lock:
            ep = self._sid_to_ep.pop(sid, None)
            if ep is not None and self._conns.get(ep) == sid:
                del self._conns[ep]
        CallManager.instance().on_socket_failed(sid, err)
        # streams riding the dead connection can never finish: close
        # them so their handlers learn now
        StreamRegistry.instance().on_socket_failed(sid)


class _CallState:
    __slots__ = ("cntl", "channel", "meta", "body", "done",
                 "deadline_timer", "sids", "sid_attempts")

    def __init__(self, cntl, channel, meta, body, done):
        self.cntl = cntl
        self.channel = channel
        self.meta = meta
        self.body = body
        self.done = done
        self.deadline_timer = None
        self.sids: set[int] = set()
        # sid -> the attempt that wrote on it: a failed socket retries
        # the call only if it still carries the CURRENT attempt
        self.sid_attempts: dict[int, int] = {}


class CallManager:
    """The pending-call table keyed by correlation id; completes calls
    exactly once across responses, deadlines, socket failures and
    retries."""

    _instance = None
    _instance_lock = threading.Lock()

    @classmethod
    def instance(cls) -> "CallManager":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: dict[int, _CallState] = {}
        self._by_sid: dict[int, set[int]] = {}

    def register(self, st: _CallState) -> None:
        with self._lock:
            self._pending[st.cntl.correlation_id] = st

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def bind_socket(self, cid: int, sid: int, attempt: int) -> None:
        with self._lock:
            st = self._pending.get(cid)
            if st is not None:
                st.sids.add(sid)
                st.sid_attempts[sid] = attempt
                self._by_sid.setdefault(sid, set()).add(cid)

    def _unregister(self, cid: int) -> None:
        with self._lock:
            st = self._pending.pop(cid, None)
            if st is not None:
                for sid in st.sids:
                    s = self._by_sid.get(sid)
                    if s is not None:
                        s.discard(cid)
                        if not s:
                            del self._by_sid[sid]

    # ---- events ----

    def on_message(self, sid: int, kind: int, meta_bytes: bytes,
                   body) -> None:
        if kind != MSG_TRPC:
            return
        try:
            meta = M.RpcMeta.decode(meta_bytes)
        except ValueError:
            return
        if meta.msg_type == M.MSG_RESPONSE:
            self._on_response(meta, body)
        elif meta.msg_type in (M.MSG_STREAM_DATA, M.MSG_STREAM_FEEDBACK,
                               M.MSG_STREAM_CLOSE):
            StreamRegistry.instance().on_frame(sid, meta, body)

    def on_fast_response(self, sid: int, cid: int, attempt: int,
                         error_code: int, error_text: str, compress_: int,
                         content_type: str, attachment_size: int,
                         body) -> None:
        """A natively pre-parsed plain response (cid, attempt, error,
        compression, content type, attachment size); anything richer
        arrives through on_message."""
        self._on_response(M.RpcMeta(
            msg_type=M.MSG_RESPONSE, correlation_id=cid, attempt=attempt,
            error_code=error_code, error_text=error_text,
            compress_type=compress_, content_type=content_type,
            attachment_size=attachment_size), body)

    def _on_response(self, meta: M.RpcMeta, body) -> None:
        with self._lock:
            st = self._pending.get(meta.correlation_id)
        if st is None:
            return          # a stale attempt after completion
        cntl = st.cntl
        if meta.error_code != 0:
            # only the current attempt may drive retry or completion;
            # success from any attempt wins
            if meta.attempt < cntl.current_attempt:
                return
            if meta.user_fields:
                cntl.response_user_fields = \
                    M.strip_reserved_user_fields(meta.user_fields)
            if not cntl.set_failed_if_current(meta.attempt, meta.error_code,
                                              meta.error_text):
                return
            if st.channel._should_retry(st, meta.attempt):
                return
            if cntl.current_attempt > meta.attempt or cntl.completed:
                return
            self._finish(st)
            return
        try:
            raw = body if isinstance(body, (bytes, memoryview)) \
                else body.to_bytes()
            att = meta.attachment_size
            payload = raw[: len(raw) - att] if att else raw
            cntl.response_attachment = bytes(raw[len(raw) - att:]) \
                if att else b""
            payload = decompress(payload, meta.compress_type)
            serializer = cntl._response_serializer or \
                get_serializer(meta.content_type or "raw")
            cntl.reset_for_retry()
            cntl.response = serializer.decode(payload, meta.tensor_header)
            if meta.user_fields:
                cntl.response_user_fields = \
                    M.strip_reserved_user_fields(meta.user_fields)
            if meta.stream_id and cntl._stream is not None:
                sbuf = meta.user_fields.get(M.F_SBUF)
                if sbuf:
                    cntl._stream.peer_buf_size = int(sbuf)
                cntl._stream.set_remote(meta.stream_id)
        except Exception as e:
            cntl.set_failed(errors.ERESPONSE, f"cannot decode response: {e}")
        self._finish(st)

    def on_socket_failed(self, sid: int, err: int) -> None:
        with self._lock:
            cids = list(self._by_sid.pop(sid, ()))
            states = [(self._pending[c],
                       self._pending[c].sid_attempts.get(sid, 0))
                      for c in cids if c in self._pending]
        for st, owner in states:
            # a socket carrying a stale attempt must not stomp the live
            # one; the versioned set_failed is the gate
            if not st.cntl.set_failed_if_current(
                    owner, errors.EFAILEDSOCKET,
                    f"socket failed (errno {err})"):
                continue
            if st.channel._should_retry(st, owner):
                continue
            if st.cntl.current_attempt == owner and not st.cntl.completed:
                self._finish(st)

    def on_deadline(self, cid: int) -> None:
        self._fail_pending(cid, errors.ERPCTIMEDOUT, "deadline exceeded",
                           cancel_deadline=False)

    def cancel(self, cid: int) -> bool:
        return self._fail_pending(cid, errors.ECANCELED, "canceled by caller")

    def _fail_pending(self, cid: int, code: int, text: str,
                      cancel_deadline: bool = True) -> bool:
        with self._lock:
            st = self._pending.get(cid)
        if st is None:
            return False
        return self._finish(st, cancel_deadline=cancel_deadline,
                            fail=(code, text))

    def _finish(self, st: _CallState, cancel_deadline: bool = True,
                fail: tuple[int, str] | None = None) -> bool:
        # the error applies only after winning the completion race
        if not st.cntl._try_complete():
            return False
        if fail is not None:
            st.cntl.set_failed(*fail)
        self._unregister(st.cntl.correlation_id)
        if cancel_deadline and st.deadline_timer is not None:
            Transport.instance().cancel(st.deadline_timer)
        cntl = st.cntl
        cntl.latency_us = int(time.monotonic() * 1e6) - cntl._start_us
        if st.done is not None:
            try:
                st.done(cntl)
            except Exception:  # pragma: no cover
                import logging
                logging.getLogger(__name__).exception("done raised")
        if cntl._done_event is not None:
            cntl._done_event.set()
        return True


class Channel:
    """Client channel to one server, ``"host:port"``, ``"[v6]:port"``
    or ``"unix:/path"``."""

    def __init__(self, address: str | EndPoint,
                 options: ChannelOptions | None = None, **kw):
        self.options = options or ChannelOptions(**kw)
        self._endpoint = address if isinstance(address, EndPoint) \
            else str2endpoint(address)
        if self._endpoint.is_ici:
            raise ValueError("ici:// endpoints need the ICI transport, "
                             "which this port does not have yet")

    def call(self, service: str, method_name: str, request: Any = b"",
             cntl: Controller | None = None,
             done: Callable[[Controller], None] | None = None,
             serializer: str = "raw", response_serializer: str | None = None,
             _sync_join: bool = False) -> Controller:
        """Issue an RPC and return its controller at once.  ``done(cntl)``
        runs on completion; without it ``cntl.join()`` waits."""
        cntl = cntl or Controller()
        opts = self.options
        if cntl.timeout_ms is None:
            cntl.timeout_ms = opts.timeout_ms
        if cntl.max_retry is None:
            cntl.max_retry = opts.max_retry
        cntl.correlation_id = next(_cid_counter)
        cntl._start_us = int(time.monotonic() * 1e6)
        if done is None:
            cntl._done_event = OneShotEvent()
        ser = get_serializer(serializer)
        body, tensor_header = ser.encode(request)
        body = compress(body, cntl.compress_type)
        meta = M.RpcMeta(msg_type=M.MSG_REQUEST,
                         correlation_id=cntl.correlation_id,
                         service=service, method=method_name,
                         compress_type=cntl.compress_type,
                         timeout_ms=cntl.timeout_ms or 0,
                         content_type=ser.name, tensor_header=tensor_header)
        if cntl.user_fields:
            meta.user_fields.update(M.normalize_user_fields(cntl.user_fields))
        if response_serializer:
            cntl._response_serializer = get_serializer(response_serializer)
        if cntl.request_attachment:
            meta.attachment_size = len(cntl.request_attachment)
            body = body + cntl.request_attachment
        stream = cntl._stream
        if stream is not None:
            meta.stream_id = stream.stream_id
            meta.user_fields[M.F_SBUF] = str(stream.max_buf_size)
        # the current trace rides the meta, the root's sampling decision
        # in a flag bit, so the callee keeps or drops the whole trace
        tid, psid, smp = rpcz.current_trace_ctx()
        meta.trace_id = cntl.trace_id = tid
        meta.span_id = cntl.span_id = psid
        if tid and smp:
            meta.flags |= M.FLAG_TRACE_SAMPLED
        st = _CallState(cntl, self, meta, body, done)
        mgr = CallManager.instance()
        mgr.register(st)
        if cntl.timeout_ms and cntl.timeout_ms > 0:
            if _sync_join:
                # the joining thread enforces the deadline itself
                cntl._sync_deadline = True
            else:
                cid = cntl.correlation_id
                st.deadline_timer = Transport.instance().schedule(
                    cntl.timeout_ms / 1e3, lambda: mgr.on_deadline(cid))
        self._issue(st)
        return cntl

    call_async = call

    def call_sync(self, service: str, method_name: str, request: Any = b"",
                  serializer: str = "raw", **kw) -> Any:
        """Issue an RPC, wait for it, raise ``RpcError`` if it failed,
        and return the decoded response."""
        cntl = self.call(service, method_name, request,
                         cntl=kw.pop("cntl", None), serializer=serializer,
                         _sync_join=True, **kw)
        cntl.join()
        cntl.raise_if_failed()
        return cntl.response

    def _issue(self, st: _CallState) -> None:
        """Send the current attempt; on an immediate failure walk the
        retry path."""
        cntl = st.cntl
        mgr = CallManager.instance()
        attempt = cntl.current_attempt
        ep = self._endpoint
        smap = SocketMap.instance()
        try:
            sid = smap.get_connection(ep)
        except (ConnectionError, OSError):
            if not cntl.set_failed_if_current(attempt, errors.ECONNREFUSED,
                                              f"cannot connect to {ep}"):
                return
            if self._should_retry(st, attempt):
                return
            if cntl.current_attempt == attempt and not cntl.completed:
                mgr._finish(st)
            return
        meta = st.meta
        meta.attempt = attempt
        mgr.bind_socket(cntl.correlation_id, sid, attempt)
        stream = cntl._stream
        if stream is not None and not stream.connected:
            stream.bind(sid)
        t = Transport.instance()
        if (not meta.trace_id and not meta.span_id and not meta.stream_id
                and not meta.tensor_header and not meta.user_fields
                and not meta.attachment_size):
            # a plain request: meta packed and framed natively
            rc = t.send_request(sid, meta.correlation_id, attempt,
                                meta.service, meta.method, meta.timeout_ms,
                                meta.compress_type, meta.content_type,
                                st.body)
        else:
            rc = t.write_frame(sid, meta.encode(), st.body)
        if rc == 0:
            return
        if rc == -2:
            # the socket's write queue is over its bound; the socket is
            # healthy, keep it
            cntl.set_failed_if_current(attempt, errors.EOVERCROWDED,
                                       "socket write queue overcrowded")
        else:
            cntl.set_failed_if_current(attempt, errors.EFAILEDSOCKET,
                                       "write failed")
            # the socket is dying: forget it now so the retry reconnects,
            # and make sure it is failed (may hand the call to the
            # failure callback's retry path synchronously)
            smap.evict(ep, sid)
            t.close(sid, 0)
        if cntl.current_attempt > attempt or cntl.completed:
            return
        if self._should_retry(st, attempt):
            return
        if cntl.current_attempt > attempt or cntl.completed:
            return
        mgr._finish(st)

    def _should_retry(self, st: _CallState, owner_attempt: int) -> bool:
        """Claim the next attempt and re-issue, if the error is
        retryable and the budget allows.  True when a retry started."""
        cntl = st.cntl
        if cntl.completed or cntl.current_attempt >= (cntl.max_retry or 0):
            return False
        if cntl.error_code not in RETRYABLE:
            return False
        if not cntl.claim_retry(owner_attempt):
            return False
        self._issue(st)
        return True
