"""Channel -- the client end of one server or of a cluster.

A copy of ``brpc_tpu/rpc/channel.py`` without TLS, authentication and
the tensor rail (ROADMAP Queue 1 items 6 and 8):

  * ``Channel(url, load_balancer=...)`` over a naming service
    (``list://``, ``file://``, ``dns://``) resolves a server per attempt
    through a load balancer; ``Channel("host:port")`` talks to one;
  * every call keeps the reference's exactly-once state machine: a
    (correlation_id, attempt) version per attempt, so a stale attempt,
    a late response or a racing socket failure can never complete a
    call twice;
  * retries follow a ``RetryPolicy`` onto a server not yet tried (exact
    exclusion), backup requests race a second attempt after
    ``backup_request_ms``, and one deadline covers the call;
  * every call's end feeds the balancer and the port's circuit breaker
    (through the ``ClusterRecoverPolicy`` guard), and a connection that
    fails marks its endpoint for the health check;
  * ``SocketMap`` keeps the connections: one multiplexed socket per
    endpoint (single), a free list per endpoint (pooled), or one per
    attempt (short).

A call made under a current rpcz span carries its trace on the meta
(the callee's server span joins it).  A stream rides the unary call
that creates it, so its server is chosen once, at that call; backup
requests apply to unary calls only.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

from .. import errors, rpcz
from ..butil.endpoint import EndPoint, str2endpoint
from . import meta as M
from .controller import Controller, OneShotEvent
from .serialization import compress, decompress, get_serializer
from .stream import StreamRegistry
from .transport import MSG_TRPC, Transport

_cid_counter = itertools.count(1)


@dataclass
class ChannelOptions:
    timeout_ms: int = 500
    max_retry: int = 3
    backup_request_ms: int = -1            # <0 disables
    connection_type: str = "single"        # single | pooled | short
    compress_type: int = M.COMPRESS_NONE
    load_balancer: str = ""                # "" = rr for a cluster url
    retry_policy: Optional[Any] = None
    # availability floor for circuit breaking (ClusterRecoverPolicy);
    # None = isolate freely (single-server channels have no cluster)
    cluster_recover_policy: Optional[Any] = None
    # feed each call's end to the global circuit breaker; off for a
    # control plane sharing a serving endpoint, whose slow calls (a
    # snapshot pull, a page push) would read as the endpoint's latency
    # degrading and isolate it from its data plane
    enable_circuit_breaker: bool = True


class RetryPolicy:
    """``do_retry(cntl)``: retry connection errors and a server's
    internal error, never a missed deadline."""

    RETRYABLE = {errors.EFAILEDSOCKET, errors.EOVERCROWDED, errors.EEOF,
                 errors.ECONNREFUSED, errors.EINTERNAL}

    def do_retry(self, cntl: Controller) -> bool:
        return cntl.error_code in self.RETRYABLE


DEFAULT_RETRY_POLICY = RetryPolicy()


class _ClientConn:
    __slots__ = ("sid", "endpoint")

    def __init__(self, sid: int, endpoint: EndPoint):
        self.sid = sid
        self.endpoint = endpoint


class SocketMap:
    """endpoint -> client connections, in three reuse schemes:

      * single: one shared multiplexed connection per endpoint (TRPC
        correlates by id, so one socket carries any number of calls);
      * pooled: a free list per endpoint; a call checks one out for its
        attempt and returns it at completion;
      * short: a fresh connection per attempt, closed at call end.

    All of them share one response handler (``CallManager``)."""

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
        self._conns: dict[EndPoint, _ClientConn] = {}
        self._sid_to_ep: dict[int, EndPoint] = {}
        self._pool: dict[EndPoint, list[_ClientConn]] = {}
        self._pooled_sids: dict[int, _ClientConn] = {}
        self._closing: set[int] = set()   # deliberate local closes

    def _connect(self, ep: EndPoint) -> _ClientConn:
        mgr = CallManager.instance()
        host = f"unix:{ep.host}" if ep.scheme == "unix" else ep.host
        sid = Transport.instance().connect_rpc(
            host, ep.port, mgr.on_message, self._on_socket_failed,
            on_response=mgr.on_fast_response)
        with self._lock:
            self._sid_to_ep[sid] = ep
        return _ClientConn(sid, ep)

    def get_connection(self, ep: EndPoint) -> _ClientConn:
        with self._lock:
            c = self._conns.get(ep)
        if c is not None:
            return c
        c = self._connect(ep)
        with self._lock:
            cur = self._conns.get(ep)
            if cur is None:
                self._conns[ep] = c
        # never close while holding _lock: the native SetFailed may run
        # _on_socket_failed synchronously on this thread
        if cur is not None:
            self.close_quietly(c.sid)     # lost the race: keep the other
            return cur
        return c

    # ---- pooled scheme ----

    def get_pooled(self, ep: EndPoint) -> _ClientConn:
        t = Transport.instance()
        while True:
            with self._lock:
                free = self._pool.get(ep)
                c = free.pop() if free else None
            if c is None:
                return self._connect(ep)
            if t.alive(c.sid):
                return c
            # died while idle in the pool; try the next one

    def return_pooled(self, c: _ClientConn) -> None:
        if not Transport.instance().alive(c.sid):
            return
        with self._lock:
            self._pooled_sids[c.sid] = c
            self._pool.setdefault(c.endpoint, []).append(c)

    # ---- short scheme ----

    def make_short(self, ep: EndPoint) -> _ClientConn:
        return self._connect(ep)

    def close_quietly(self, sid: int) -> None:
        """A deliberate local close, not a server failure: it skips the
        health check and the circuit breaker."""
        with self._lock:
            self._closing.add(sid)
        Transport.instance().close(sid)

    def _on_socket_failed(self, sid: int, err: int) -> None:
        with self._lock:
            deliberate = sid in self._closing
            self._closing.discard(sid)
            ep = self._sid_to_ep.pop(sid, None)
            c = self._conns.get(ep) if ep is not None else None
            if c is not None and c.sid == sid:
                del self._conns[ep]
            pc = self._pooled_sids.pop(sid, None)
            if pc is not None and ep is not None:
                free = self._pool.get(ep)
                if free and pc in free:
                    free.remove(pc)
        CallManager.instance().on_socket_failed(sid, err)
        # streams riding the dead connection can never finish: close
        # them so their handlers learn now
        StreamRegistry.instance().on_socket_failed(sid)
        if ep is not None and not deliberate:
            from ..policy.health_check import on_connection_failed
            on_connection_failed(ep)

    def evict(self, ep: EndPoint, sid: int) -> None:
        """Forget ``ep``'s single connection iff it is still ``sid`` (a
        write on it failed; its failure callback may still be in
        flight), so a retry reconnects instead of reusing it."""
        with self._lock:
            c = self._conns.get(ep)
            if c is not None and c.sid == sid:
                del self._conns[ep]

    def drop(self, ep: EndPoint) -> None:
        """Close every connection to ``ep`` (a server left the cluster)."""
        with self._lock:
            c = self._conns.pop(ep, None)
            free = self._pool.pop(ep, [])
            for fc in free:
                self._pooled_sids.pop(fc.sid, None)
        if c is not None:
            self.close_quietly(c.sid)
        for fc in free:
            self.close_quietly(fc.sid)

    def pooled_count(self, ep: EndPoint) -> int:
        with self._lock:
            return len(self._pool.get(ep, ()))


class _CallState:
    __slots__ = ("cntl", "channel", "meta", "body", "done",
                 "deadline_timer", "backup_timer", "sids", "sid_attempts",
                 "tried_servers", "pooled_conns", "short_conns")

    def __init__(self, cntl, channel, meta, body, done):
        self.cntl = cntl
        self.channel = channel
        self.meta = meta
        self.body = body
        self.done = done
        self.deadline_timer = None
        self.backup_timer = None
        self.sids: set[int] = set()
        # sid -> the attempt that wrote on it: a failed socket retries
        # the call only if it still carries the CURRENT attempt
        self.sid_attempts: dict[int, int] = {}
        # every server an attempt went to, in order: retries exclude
        # them, and the call's end feeds each to the balancer and breaker
        self.tried_servers: list[EndPoint] = []
        # connections this call checked out (pooled) or owns (short);
        # given back or closed at completion (late replies match by cid,
        # so recycling before a stale attempt answers is safe)
        self.pooled_conns: list[_ClientConn] = []
        self.short_conns: list[_ClientConn] = []


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
                # the newest attempt on the socket owns it: two attempts
                # of one call (a backup, a retry) may share a socket and
                # bind out of order, and a late bind of the older one
                # must not hide the live attempt from the socket's
                # failure (the call would wait out its deadline)
                st.sid_attempts[sid] = max(attempt,
                                           st.sid_attempts.get(sid, -1))
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
        t = Transport.instance()
        if cancel_deadline and st.deadline_timer is not None:
            t.cancel(st.deadline_timer)
        if st.backup_timer is not None:
            t.cancel(st.backup_timer)
        cntl = st.cntl
        cntl.latency_us = int(time.monotonic() * 1e6) - cntl._start_us
        if st.pooled_conns or st.short_conns:
            smap = SocketMap.instance()
            for c in st.pooled_conns:
                smap.return_pooled(c)
            for c in st.short_conns:
                smap.close_quietly(c.sid)
            st.pooled_conns.clear()
            st.short_conns.clear()
        st.channel._on_call_end(st)
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
    """Client channel to one server (``"host:port"``, ``"[v6]:port"``,
    ``"unix:/path"``) or to a cluster (``"list://..."``, ``"file://..."``,
    ``"dns://..."``, balanced by ``load_balancer``, ``rr`` by default)."""

    def __init__(self, address: str | EndPoint | None = None,
                 options: ChannelOptions | None = None, **kw):
        self.options = options or ChannelOptions(**kw)
        self._lb = None
        self._ns_thread = None
        self._endpoint: Optional[EndPoint] = None
        if address is not None:
            self.init(address, self.options.load_balancer)

    def init(self, address: str | EndPoint,
             load_balancer: str = "") -> "Channel":
        if isinstance(address, EndPoint):
            self._endpoint = address
        elif "://" in address:
            from ..policy.load_balancer import create_load_balancer
            from ..policy.naming import start_naming_service
            self._lb = create_load_balancer(load_balancer or "rr")
            self._ns_thread = start_naming_service(address, self._lb)
        else:
            self._endpoint = str2endpoint(address)
        if self._endpoint is not None and self._endpoint.is_ici:
            raise ValueError("ici:// endpoints need the ICI transport, "
                             "which this port does not have yet")
        return self

    def close(self) -> None:
        """Stop the naming service's refresher (a cluster channel over a
        periodically re-read source, such as ``file://``)."""
        if self._ns_thread is not None:
            self._ns_thread.stop()

    # ---- server selection ----

    def _select_server(self, st: _CallState) -> Optional[EndPoint]:
        if self._lb is not None:
            # exact exclusion of every server already tried, so a retry
            # never revisits a failed replica
            return self._lb.select_server(
                exclude=set(st.tried_servers),
                request_code=st.cntl.request_code)
        return self._endpoint

    def _on_call_end(self, st: _CallState) -> None:
        if not st.tried_servers:
            return
        # every select_server() gets exactly one feedback (la tracks
        # inflight); losing and failed attempts report as socket errors
        if self._lb is not None:
            for ep in st.tried_servers[:-1]:
                self._lb.feedback(ep, errors.EFAILEDSOCKET, 0)
            self._lb.feedback(st.tried_servers[-1], st.cntl.error_code,
                              st.cntl.latency_us)
        # the circuit breaker; the cluster guard lets the
        # ClusterRecoverPolicy veto an isolation that would leave too
        # few healthy servers
        if not self.options.enable_circuit_breaker:
            return
        from ..policy.circuit_breaker import global_breaker
        breaker = global_breaker()
        guard = self._cluster_guard()
        for ep in st.tried_servers[:-1]:
            if ep.scheme == "tcp":
                breaker.on_call_end(ep, errors.EFAILEDSOCKET, cluster=guard)
        last = st.tried_servers[-1]
        if last.scheme == "tcp":
            breaker.on_call_end(last, st.cntl.error_code,
                                latency_us=st.cntl.latency_us,
                                cluster=guard)

    def _cluster_guard(self):
        """The ClusterRecoverPolicy guard over this channel's servers
        (None for a single-server channel: it has no cluster)."""
        if self._lb is None:
            return None
        policy = self.options.cluster_recover_policy
        if policy is None:
            return None
        from ..policy.cluster_recover_policy import _ChannelClusterGuard
        return _ChannelClusterGuard(policy, self._lb)

    # ---- the call path ----

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
        if cntl.backup_request_ms is None:
            cntl.backup_request_ms = opts.backup_request_ms
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
        t = Transport.instance()
        if cntl.timeout_ms and cntl.timeout_ms > 0:
            if _sync_join:
                # the joining thread enforces the deadline itself
                cntl._sync_deadline = True
            else:
                cid = cntl.correlation_id
                st.deadline_timer = t.schedule(
                    cntl.timeout_ms / 1e3, lambda: mgr.on_deadline(cid))
        if (cntl.backup_request_ms and cntl.backup_request_ms > 0
                and stream is None):
            # a stream is bound to the attempt that carried it: no backup
            st.backup_timer = t.schedule(cntl.backup_request_ms / 1e3,
                                         lambda: self._issue_backup(st))
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
        """Send the current attempt to a server the balancer selects; on
        an immediate failure walk the retry path."""
        cntl = st.cntl
        mgr = CallManager.instance()
        # every failure below is versioned against the attempt THIS call
        # issues: a stale path (a concurrent retry owns a newer attempt)
        # can neither overwrite the live attempt's state nor finish it
        attempt = cntl.current_attempt
        ep = self._select_server(st)
        if ep is None:
            if cntl.set_failed_if_current(attempt, errors.ENODATA,
                                          "no available server"):
                mgr._finish(st)
            return
        st.tried_servers.append(ep)
        cntl.remote_side = str(ep)
        smap = SocketMap.instance()
        ctype = self.options.connection_type
        try:
            if ctype == "pooled":
                conn = smap.get_pooled(ep)
                st.pooled_conns.append(conn)
            elif ctype == "short":
                conn = smap.make_short(ep)
                st.short_conns.append(conn)
            else:
                conn = smap.get_connection(ep)
        except (ConnectionError, OSError):
            # the versioned set BEFORE the retry check (the retry policy
            # reads error_code); False means a newer attempt owns the call
            if not cntl.set_failed_if_current(attempt, errors.ECONNREFUSED,
                                              f"cannot connect to {ep}"):
                return
            if self._should_retry(st, attempt):
                return
            if cntl.current_attempt == attempt and not cntl.completed:
                mgr._finish(st)
            return
        sid = conn.sid
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
            if ctype == "single":
                # the socket is dying: forget it now so the retry
                # reconnects instead of burning every attempt on it
                smap.evict(ep, sid)
            # and make sure it is failed (may hand the call to the
            # failure callback's retry path synchronously)
            t.close(sid, 0)
        if cntl.current_attempt > attempt or cntl.completed:
            return
        if self._should_retry(st, attempt):
            return
        if cntl.current_attempt > attempt or cntl.completed:
            return
        mgr._finish(st)

    def _should_retry(self, st: _CallState, owner_attempt: int) -> bool:
        """Claim the next attempt and re-issue, if the retry policy
        agrees and the budget allows.  True when a retry started; of two
        failure paths racing to retry one attempt, exactly one wins."""
        cntl = st.cntl
        if cntl.completed or cntl.current_attempt >= (cntl.max_retry or 0):
            return False
        policy = self.options.retry_policy or DEFAULT_RETRY_POLICY
        if not policy.do_retry(cntl):
            return False
        if not cntl.claim_retry(owner_attempt):
            return False
        self._issue(st)
        return True

    def _issue_backup(self, st: _CallState) -> None:
        """The backup request: race a second attempt on another server;
        the first response wins.  ``max_retry=0`` disables it too."""
        cntl = st.cntl
        if cntl.completed:
            return
        if cntl.current_attempt >= (cntl.max_retry or 0):
            return
        if not cntl.claim_backup():
            return
        self._issue(st)


def control_channel(address: str, timeout_ms: int) -> Channel:
    """A channel for a control or page plane that shares its endpoint
    with a data plane: floor pushes, deploys, telemetry pulls, page
    pushes, DCN handshakes.  Its calls feed no circuit breaker: their
    latency says nothing of the endpoint's request path, and a slow one
    would isolate the endpoint from the data plane routed to it."""
    return Channel(address, timeout_ms=timeout_ms,
                   enable_circuit_breaker=False)
