"""ProgressiveAttachment -- server push after the response headers (a
copy of ``brpc_tpu/rpc/progressive.py``).

An HTTP handler returns a :class:`ProgressiveResponse`; the console
router sends ``Transfer-Encoding: chunked`` headers and calls the
writer with a :class:`ProgressiveAttachment` whose ``write``/``close``
emit chunks -- from any thread, any time after the handler returned.
``write`` returns -1 once the peer is gone and never raises, so a
producer learns of a dead client from the return code.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional

from .transport import Transport


class ProgressiveAttachment:
    def __init__(self, sid: int):
        self._sid = sid
        self._mu = threading.Lock()
        self._closed = False

    def write(self, data: bytes | str) -> int:
        """Emit one chunk; 0 on success, -1 once closed or failed."""
        if isinstance(data, str):
            data = data.encode()
        if not data:
            return 0
        with self._mu:
            if self._closed:
                return -1
            frame = b"%x\r\n%s\r\n" % (len(data), data)
            if Transport.instance().write_raw(self._sid, frame) != 0:
                self._closed = True
                return -1
            return 0

    def close(self) -> None:
        """Terminate the chunked body (the last-chunk marker)."""
        with self._mu:
            if self._closed:
                return
            self._closed = True
            Transport.instance().write_raw(self._sid, b"0\r\n\r\n")

    @property
    def closed(self) -> bool:
        return self._closed

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ProgressiveResponse:
    """Returned by an HTTP handler to switch the connection into chunked
    mode.  ``writer(pa)`` runs on the handler's thread; it may hand
    ``pa`` to another thread and return at once."""

    def __init__(self, writer: Callable[[ProgressiveAttachment], None],
                 content_type: str = "application/octet-stream",
                 status: int = 200,
                 extra_headers: Optional[dict] = None):
        self.writer = writer
        self.content_type = content_type
        self.status = status
        self.extra_headers = extra_headers or {}
