"""Streaming RPC -- an ordered message pipe with a credit window.

A copy of the byte-message part of ``brpc_tpu/rpc/stream.py``, on the
same wire.  A stream rides an ordinary RPC (its settings in the request
and response metas, accepted by the server's handler), then DATA frames
flow under a sliding window: the writer blocks once ``produced -
remote_consumed`` would exceed its window, and the reader's CONSUMED
feedback frames advance it.  Frames arrive in order on one socket, but
the native core dispatches each parsed message onto its executor, so
handlers could run out of order: the writer numbers its frames
(``stream_seq``) and the reader reorders them and delivers them from
one drain loop at a time.

A writer's window is its own buffer (``max_buf_size``); the reader
acknowledges every half of the smaller of its buffer and the writer's,
which it learned in the settings exchange.  The window must hold the
largest message: a message larger than the window never goes out.

Messages are bytes.  A device tensor written to a stream raises
``TypeError``: the tensor rail, which moves device buffers under the
socket, belongs to the ICI transport slice.
"""
from __future__ import annotations

import itertools
import logging
import threading
import time
from typing import Optional

from .. import errors
from . import meta as M
from .transport import Transport

DEFAULT_BUF_SIZE = 2 * 1024 * 1024

_stream_ids = itertools.count(1)
_log = logging.getLogger(__name__)


class StreamHandler:
    """Receives a stream's messages (the reference's
    StreamInputHandler)."""

    def on_received_messages(self, stream: "Stream",
                             messages: list[bytes]) -> None:
        pass

    def on_closed(self, stream: "Stream") -> None:
        pass


class Stream:
    """Each side owns a local id (the registry key) and learns the
    peer's; outgoing frames are addressed to the peer's local id."""

    def __init__(self, stream_id: int, handler: Optional[StreamHandler],
                 max_buf_size: int = DEFAULT_BUF_SIZE):
        self.stream_id = stream_id               # local id
        self.remote_id: Optional[int] = None     # peer's local id
        self.handler = handler
        self.max_buf_size = max_buf_size
        # the peer's buffer, learned from the settings exchange: it bounds
        # our writes, and our feedback must fire before it fills
        self.peer_buf_size: Optional[int] = None
        self._sid: Optional[int] = None          # bound host connection
        self._mu = threading.Lock()
        self._window_cv = threading.Condition(self._mu)
        self._produced = 0
        self._remote_consumed = 0
        self._consumed_local = 0                 # receiver side
        self._last_feedback = 0
        self._pending: list[tuple[int, bytes]] = []   # writes before bind
        self._closed = False
        self._close_sent = False
        self._send_seq = 1
        self._recv_next = 1
        self._reorder: dict[int, tuple[bytes, int]] = {}
        self._reorder_bytes = 0
        self._close_seq: Optional[int] = None
        self._delivering = False

    # ---- binding (the RPC established the host connection) ----

    def bind(self, sid: int) -> None:
        with self._mu:
            self._sid = sid
        self._maybe_flush()

    def set_remote(self, remote_id: int) -> None:
        with self._mu:
            self.remote_id = remote_id
        self._maybe_flush()

    def _maybe_flush(self) -> None:
        with self._mu:
            if self._sid is None or self.remote_id is None:
                return
            pending, self._pending = self._pending, []
        for seq, payload in pending:
            self._send_data(payload, seq)

    @property
    def connected(self) -> bool:
        return self._sid is not None and self.remote_id is not None

    @property
    def closed(self) -> bool:
        return self._closed

    # ---- writer side ----

    def write(self, data, timeout_s: float | None = 10.0) -> None:
        """Write one message of bytes.  Blocks while the window is full;
        raises RpcError(EOVERCROWDED) when it stays full past
        ``timeout_s`` and RpcError(EEOF) once the stream closed."""
        if not isinstance(data, (bytes, bytearray, memoryview)):
            raise TypeError(
                f"stream write takes bytes, not {type(data).__name__}; "
                f"device tensors ride the tensor rail of the ICI "
                f"transport, which this port does not have yet")
        payload = bytes(data)
        nbytes = len(payload)
        if self._closed or self._close_sent:
            raise errors.RpcError(errors.EEOF, "stream closed")
        with self._window_cv:
            deadline = None if timeout_s is None \
                else time.monotonic() + timeout_s
            while (self._produced + nbytes - self._remote_consumed
                   > self.max_buf_size):
                if self._closed:
                    raise errors.RpcError(errors.EEOF, "stream closed")
                remaining = 1.0 if deadline is None \
                    else deadline - time.monotonic()
                if remaining <= 0:
                    raise errors.RpcError(
                        errors.EOVERCROWDED,
                        f"stream window full ({self.max_buf_size}B)")
                self._window_cv.wait(min(remaining, 1.0))
            self._produced += nbytes
            seq = self._send_seq
            self._send_seq += 1
            if self._sid is None or self.remote_id is None:
                self._pending.append((seq, payload))
                return
        self._send_data(payload, seq)

    def _send_data(self, data: bytes, seq: int) -> None:
        rc = Transport.instance().write_frame(
            self._sid, M.RpcMeta.encode_stream_data(self.remote_id, seq),
            data)
        if rc != 0:
            self._on_closed_internal()

    # ---- receiver side ----

    def _on_data(self, payload: bytes, seq: int) -> None:
        nbytes = len(payload)
        if seq == 0:
            # an unsequenced peer: deliver in arrival order
            self._deliver([payload])
            self._ack(nbytes)
            return
        with self._mu:
            if seq < self._recv_next or seq in self._reorder:
                return      # a replay of a delivered or parked seq
            self._reorder[seq] = (payload, nbytes)
            self._reorder_bytes += nbytes
            # a correct writer never has more unacked bytes in flight
            # than its window; a peer that does is violating the
            # protocol, and the buffer must not grow without bound
            window = max(self.max_buf_size, self.peer_buf_size or 0)
            overflow = self._reorder_bytes > 2 * window + (64 << 10)
        if overflow:
            _log.warning("stream %d: reorder buffer exceeded 2x the credit "
                         "window; closing (protocol violation)",
                         self.stream_id)
            if self._sid is not None and self.remote_id is not None:
                Transport.instance().write_frame(
                    self._sid, M.RpcMeta(msg_type=M.MSG_STREAM_CLOSE,
                                         stream_id=self.remote_id).encode())
            self._on_closed_internal()
            return
        self._drain()

    def _on_close_frame(self, seq: int) -> None:
        if seq == 0:
            self._on_closed_internal()
            return
        with self._mu:
            # min(): a duplicate CLOSE must not raise the latch
            if self._close_seq is None or seq < self._close_seq:
                self._close_seq = seq
        self._drain()

    def _deliver(self, messages: list) -> None:
        if self.handler is not None:
            try:
                self.handler.on_received_messages(self, messages)
            except Exception:
                # a raising handler must not wedge the drain loop
                _log.exception("stream handler raised")

    def _drain(self) -> None:
        """Deliver consecutive frames; one thread drains at a time."""
        with self._mu:
            if self._delivering:
                return
            self._delivering = True
        while True:
            with self._mu:
                ready, ready_bytes = [], 0
                while self._recv_next in self._reorder:
                    payload, nbytes = self._reorder.pop(self._recv_next)
                    self._reorder_bytes -= nbytes
                    ready.append(payload)
                    ready_bytes += nbytes
                    self._recv_next += 1
                close_now = (self._close_seq is not None
                             and self._recv_next >= self._close_seq)
                if not ready and not close_now:
                    self._delivering = False
                    return
            if ready:
                self._deliver(ready)
                self._ack(ready_bytes)
            if close_now:
                with self._mu:
                    self._delivering = False
                self._on_closed_internal()
                return

    def _ack(self, nbytes: int) -> None:
        with self._mu:
            self._consumed_local += nbytes
            threshold = min(self.max_buf_size,
                            self.peer_buf_size or self.max_buf_size) // 2
            send = (self._consumed_local - self._last_feedback
                    >= max(1, threshold))
            if send:
                self._last_feedback = self._consumed_local
        if send and self._sid is not None and self.remote_id is not None:
            meta = M.RpcMeta(msg_type=M.MSG_STREAM_FEEDBACK,
                             stream_id=self.remote_id,
                             stream_offset=self._consumed_local)
            Transport.instance().write_frame(self._sid, meta.encode())

    def _on_feedback(self, consumed: int) -> None:
        with self._window_cv:
            self._remote_consumed = max(self._remote_consumed, consumed)
            self._window_cv.notify_all()

    def _on_closed_internal(self) -> None:
        with self._window_cv:
            already = self._closed
            self._closed = True
            self._window_cv.notify_all()
        if not already and self.handler is not None:
            try:
                self.handler.on_closed(self)
            except Exception:
                _log.exception("stream on_closed raised")
        StreamRegistry.instance().remove(self.stream_id)

    def close(self) -> None:
        with self._mu:
            if self._closed or self._close_sent:
                return
            self._close_sent = True
            seq = self._send_seq
            self._send_seq += 1
            connected = self._sid is not None and self.remote_id is not None
        if connected:
            # a sequenced CLOSE: the peer closes only after delivering
            # every DATA frame written before it
            meta = M.RpcMeta(msg_type=M.MSG_STREAM_CLOSE,
                             stream_id=self.remote_id, stream_seq=seq)
            Transport.instance().write_frame(self._sid, meta.encode())
        self._on_closed_internal()


class StreamRegistry:
    """Local stream id -> Stream, for the frames that address them."""

    _instance = None
    _lock = threading.Lock()

    @classmethod
    def instance(cls) -> "StreamRegistry":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def __init__(self):
        self._streams: dict[int, Stream] = {}
        self._mu = threading.Lock()

    def register(self, stream: Stream) -> None:
        with self._mu:
            self._streams[stream.stream_id] = stream

    def get(self, stream_id: int) -> Optional[Stream]:
        with self._mu:
            return self._streams.get(stream_id)

    def remove(self, stream_id: int) -> None:
        with self._mu:
            self._streams.pop(stream_id, None)

    def on_socket_failed(self, sid: int) -> None:
        """The bound connection died: every stream riding it closes now,
        so its handler learns at socket speed (a dead peer sends no
        CLOSE frame)."""
        with self._mu:
            dead = [s for s in self._streams.values() if s._sid == sid]
        for s in dead:
            s._on_closed_internal()

    def on_frame(self, sid: int, meta: M.RpcMeta, body) -> None:
        # meta.stream_id addresses the RECEIVER's local stream
        s = self.get(meta.stream_id)
        if s is None:
            return
        if s._sid is None:
            s.bind(sid)
        if meta.msg_type == M.MSG_STREAM_DATA:
            if meta.tensor_header or meta.user_fields.get(M.F_TICKET):
                # a tensor message: this side cannot rebuild it, and a
                # lost message poisons the sequence
                _log.error("stream %d: tensor message received; the port "
                           "streams bytes only", s.stream_id)
                s._on_closed_internal()
                return
            s._on_data(body.to_bytes(), meta.stream_seq)
        elif meta.msg_type == M.MSG_STREAM_FEEDBACK:
            s._on_feedback(meta.stream_offset)
        elif meta.msg_type == M.MSG_STREAM_CLOSE:
            s._on_close_frame(meta.stream_seq)


def stream_create(cntl, handler: StreamHandler | None = None,
                  max_buf_size: int = DEFAULT_BUF_SIZE) -> Stream:
    """Client side: create a stream riding the next RPC issued with
    ``cntl``."""
    s = Stream(next(_stream_ids), handler, max_buf_size)
    StreamRegistry.instance().register(s)
    cntl._stream = s
    return s


def stream_accept(cntl, handler: StreamHandler | None = None,
                  max_buf_size: int = DEFAULT_BUF_SIZE) -> Stream:
    """Server side, inside a handler: accept the peer's stream."""
    meta = cntl.request_meta
    if meta is None or meta.stream_id == 0:
        raise errors.RpcError(errors.EREQUEST, "no stream attached")
    s = Stream(next(_stream_ids), handler, max_buf_size)
    s.set_remote(meta.stream_id)     # the client's local id
    sbuf = meta.user_fields.get(M.F_SBUF)
    if sbuf:
        s.peer_buf_size = int(sbuf)
    s.bind(cntl.peer_sid)
    StreamRegistry.instance().register(s)
    cntl._stream = s                 # the response meta carries our id
    return s
