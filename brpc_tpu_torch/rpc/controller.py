"""Controller -- per-RPC context and completion state.

A trimmed copy of ``brpc_tpu/rpc/controller.py``: options in (timeout,
retries, compression, attachment, user fields), results out (error
code and text, response, attachment), and the call's exactly-once
completion.  Retries are versioned by the (correlation_id, attempt)
pair under a completion lock, so a stale attempt can never complete a
call twice.  Left out with the features they serve: backup requests,
the load balancer's request code, rpcz trace ids, gRPC headers and
pooled session data.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional

from .. import errors
from . import meta as M


class OneShotEvent:
    """``threading.Event`` for exactly-once RPC completion: a
    pre-acquired lock that ``set()`` releases, so a waiter pays one
    acquire.  A benign double ``set()`` is absorbed."""

    __slots__ = ("_lock", "_flag")

    def __init__(self):
        self._lock = threading.Lock()
        self._lock.acquire()
        self._flag = False

    def set(self) -> None:
        if not self._flag:
            self._flag = True
            try:
                self._lock.release()
            except RuntimeError:   # benign double-set race
                pass

    def is_set(self) -> bool:
        return self._flag

    def wait(self, timeout: float | None = None) -> bool:
        if self._flag:
            return True
        if timeout is None:
            acquired = self._lock.acquire()
        else:
            acquired = self._lock.acquire(True, timeout)
        if acquired:
            try:
                self._lock.release()   # pass the baton to other waiters
            except RuntimeError:
                pass
        return self._flag


class Controller:
    def __init__(self, *, timeout_ms: Optional[int] = None,
                 max_retry: Optional[int] = None,
                 compress_type: int = M.COMPRESS_NONE):
        # ---- client-side options (None = inherit from ChannelOptions) ----
        self.timeout_ms = timeout_ms
        self.max_retry = max_retry
        self.compress_type = compress_type
        self.request_attachment: bytes = b""
        # opaque key/values riding the request meta; server handlers read
        # cntl.request_meta.user_fields (values arrive as bytes)
        self.user_fields: dict = {}
        # the response direction: handlers set it, the client reads it
        self.response_user_fields: dict = {}

        # ---- result state ----
        self.error_code: int = 0
        self.error_text: str = ""
        self.response: Any = None
        self.response_attachment: bytes = b""

        # ---- call bookkeeping ----
        self.correlation_id: int = 0
        # the rpcz trace this call belongs to (client: stamped from the
        # current span; server: the server span's)
        self.trace_id: int = 0
        self.span_id: int = 0
        self.current_attempt: int = 0
        self.retried_count: int = 0
        self.latency_us: int = 0
        self._start_us: int = 0
        self._sync_deadline = False
        self._response_serializer = None
        self._done_event: Optional[OneShotEvent] = None
        self._completed = False
        self._lock = threading.Lock()

        # ---- server-side state ----
        self.is_server_side = False
        self.request_meta: Optional[M.RpcMeta] = None
        self.peer_sid: int = 0
        # the stream riding this RPC (rpc/stream.py)
        self._stream = None
        # deferred completion: the response goes out when the handler's
        # done(response) runs, not when it returns
        self._server_done: Optional[Callable[[Any], None]] = None
        self._done_factory: Optional[Callable[[], Callable]] = None
        self._deferred = False

    def accept_stream(self, handler=None, max_buf_size: int | None = None):
        """Server handler: accept the stream the client attached."""
        from .stream import DEFAULT_BUF_SIZE, stream_accept
        return stream_accept(self, handler, max_buf_size or DEFAULT_BUF_SIZE)

    def defer(self) -> Callable[[Any], None]:
        """Server handler: switch this RPC to asynchronous completion.
        Returns a one-shot ``done(response)``; the handler's return value
        is then ignored and any thread may call ``done`` later."""
        with self._lock:
            if not self.is_server_side or (self._server_done is None
                                           and self._done_factory is None):
                raise RuntimeError("defer() is only valid inside a server "
                                   "handler invocation")
            self._deferred = True
            if self._server_done is None:
                factory, self._done_factory = self._done_factory, None
                self._server_done = factory()
            return self._server_done

    # ---- result api ----

    def failed(self) -> bool:
        return self.error_code != 0

    def set_failed(self, code: int, text: str = "") -> None:
        self.error_code = code
        self.error_text = text or errors.describe(code)

    def set_failed_if_current(self, attempt: int, code: int,
                              text: str = "") -> bool:
        """``set_failed`` iff the call is not completed and ``attempt``
        is still current, checked and set under the completion lock."""
        with self._lock:
            if self._completed or self.current_attempt != attempt:
                return False
            self.error_code = code
            self.error_text = text or errors.describe(code)
            return True

    def claim_retry(self, owner_attempt: int) -> bool:
        """Atomically claim the next attempt: succeeds iff the call is
        not completed and ``owner_attempt`` is current; of two failure
        paths racing to retry one attempt, exactly one wins."""
        with self._lock:
            if self._completed or self.current_attempt != owner_attempt:
                return False
            self.current_attempt += 1
            self.retried_count += 1
            self.error_code = 0
            self.error_text = ""
            self.response_user_fields = {}
            return True

    def reset_for_retry(self) -> None:
        with self._lock:
            if self._completed:
                return
            self.error_code = 0
            self.error_text = ""
            self.response_user_fields = {}

    # ---- completion (exactly once) ----

    def _try_complete(self) -> bool:
        """True for the winner; stale attempts and timeouts lose."""
        with self._lock:
            if self._completed:
                return False
            self._completed = True
            return True

    @property
    def completed(self) -> bool:
        return self._completed

    def join(self, extra_timeout_s: float = 5.0) -> None:
        """Block until the RPC completes.  With timeout_ms=0 (no
        deadline) this waits indefinitely."""
        if self._done_event is None:
            return
        if not self.timeout_ms or self.timeout_ms <= 0:
            self._done_event.wait()
            return
        if self._sync_deadline:
            # issued without a native deadline timer: this thread enforces
            # the deadline, measured from issue time
            elapsed = time.monotonic() - self._start_us / 1e6
            budget = max(0.0, self.timeout_ms / 1e3 - elapsed)
        else:
            budget = self.timeout_ms / 1e3 + extra_timeout_s
        if not self._done_event.wait(budget):
            from .channel import CallManager
            CallManager.instance().on_deadline(self.correlation_id)
            self._done_event.wait(1.0)

    def cancel(self) -> bool:
        """Fail this in-flight call with ECANCELED now; a late response
        is dropped as a stale attempt."""
        from .channel import CallManager
        return CallManager.instance().cancel(self.correlation_id)

    def raise_if_failed(self) -> None:
        if self.failed():
            raise errors.RpcError(self.error_code, self.error_text)
